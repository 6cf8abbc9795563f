"""Build the port's CUDA C++ kernels from the sources in this package.

Route: `nvcc` by hand into a shared library with a plain C interface,
loaded with `ctypes` (no PyTorch headers, so a build takes seconds). Each
`csrc/<name>.cu` becomes `build/repro_torch_kernels/lib<name>_<hash>.so`
under the repository root, at first use; the hash covers the source and
the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is. A failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CUDA_SOURCES = ("magnitude_hist", "compact_blocks", "ef_topk", "ssd")

# nvcc's stderr per built source (ptxas register / shared-memory report)
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked at $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=CUDA_SOURCES) -> dict[str, Path]:
    """Compile every named source that has no current library, one `nvcc`
    per source, all started together. Returns {name: library path}."""
    out, procs = {}, {}
    for name in names:
        src, so = _target(name)
        out[name] = so
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, so)
    failed = []
    for name, (p, tmp, so) in procs.items():
        _, err = p.communicate()
        BUILD_LOG[name] = err
        if p.returncode != 0:
            failed.append(f"{name}: nvcc exited {p.returncode}\n{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build((name,))[name]))
        return lib


def check_cuda(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
