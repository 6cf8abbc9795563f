"""Stdout-safe status logging for launchers and benchmarks.

Progress text goes to stderr so machine-readable JSON on stdout is never
interleaved with human status lines; `set_quiet(True)` (the launchers'
`--quiet` flag) silences status output entirely. Result payloads that ARE
the program's output (final JSON) should keep using plain print/stdout.
"""
from __future__ import annotations

import sys

_QUIET = False


def set_quiet(quiet: bool) -> None:
    global _QUIET
    _QUIET = bool(quiet)


def quiet() -> bool:
    return _QUIET


def status(msg: str) -> None:
    """One progress line to stderr (suppressed under --quiet)."""
    if not _QUIET:
        print(msg, file=sys.stderr, flush=True)
