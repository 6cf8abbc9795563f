"""Pytree checkpointing (PyTorch port of `repro.checkpoint.ckpt`).

Layout per checkpoint, the reference's, so either package restores the
other's checkpoints:
  <dir>/step_<N>/
    manifest.json   structure string + array specs (path key, shape, dtype)
    arrays.npz      flat arrays, key = the leaf's path

A tree is nested dicts, lists and tuples; every other value is a leaf (a
torch tensor, a numpy array or a Python scalar). Path keys are those of
the reference: dict keys sorted at every level, list and tuple positions
by index, joined with "/"; None is an empty subtree, not a leaf. Tensors
are copied to the host before writing. bf16 and fp8 leaves are stored as
raw uint8 bytes with the true dtype in the manifest (numpy has no such
types without `ml_dtypes`) and are rebuilt with `torch.Tensor.view`.
The manifest's structure string is informative only: no loader parses
it. Writes are atomic (tmp dir + rename) so a crash mid-save never
corrupts the latest step. `CheckpointManager` adds retention,
latest-step discovery and an async (background-thread) save path so the
training loop never blocks on disk.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

# dtypes numpy cannot hold natively: stored as raw uint8 bytes
_EXT_DTYPES = {"bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn,
               "float8_e5m2": torch.float8_e5m2}
_EXT_NAMES = {v: k for k, v in _EXT_DTYPES.items()}


def _flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path key, leaf) pairs in the reference's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, sub in items:
        out.extend(_flatten_with_paths(
            sub, f"{prefix}/{name}" if prefix else name))
    return out


def _structure(tree) -> str:
    """A readable structure string for the manifest (never parsed)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _to_host(leaf) -> tuple[np.ndarray, str, list]:
    """(array as stored, true dtype name, shape) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        shape = list(t.shape)
        if t.dtype in _EXT_NAMES:
            raw = t.reshape(-1).view(torch.uint8)
            if t.dim():
                raw = raw.reshape(*shape[:-1], -1)
            return raw.numpy(), _EXT_NAMES[t.dtype], shape
        arr = t.numpy()
        return arr, str(arr.dtype), shape
    arr = np.asarray(leaf)
    if arr.dtype.name in _EXT_DTYPES:      # an ml_dtypes array
        return arr.view(np.uint8), arr.dtype.name, list(arr.shape)
    return arr, str(arr.dtype), list(arr.shape)


def _from_stored(arr: np.ndarray, dtype_name: str, shape):
    """A stored array back as its true dtype: numpy for native dtypes, a
    CPU torch tensor for bf16 and fp8."""
    if dtype_name in _EXT_DTYPES:
        raw = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1))
        return raw.view(_EXT_DTYPES[dtype_name]).reshape(shape)
    return arr


def _like_leaf(value, leaf):
    """`value` restored as the type, dtype and device of `leaf`."""
    if isinstance(leaf, torch.Tensor):
        t = value if isinstance(value, torch.Tensor) else \
            torch.from_numpy(np.array(value))
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if hasattr(leaf, "dtype"):
        want = np.asarray(leaf).dtype
        if value.dtype != want:
            value = value.astype(want)
    return value


def _rebuild(like, values: dict, prefix: str = ""):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], values,
                            f"{prefix}/{k}" if prefix else str(k))
                for k in like}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, values, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(like)]
        return out if isinstance(like, list) else tuple(out)
    return values[prefix]


def save_pytree(tree, directory: str) -> None:
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    manifest = {"keys": [], "treedef": _structure(tree)}
    for key, leaf in _flatten_with_paths(tree):
        arr, dtype_name, shape = _to_host(leaf)
        manifest["keys"].append(
            {"key": key, "shape": shape, "dtype": dtype_name})
        arrays[key] = arr
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def load_pytree(directory: str, like=None):
    """Restore. Without `like`: a flat {path key: array} dict (numpy
    arrays, CPU torch tensors for bf16/fp8 leaves). With `like`: its
    structure, each leaf restored as the type of `like`'s leaf — a tensor
    of that dtype on that device, or a numpy array of that dtype."""
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    meta = {e["key"]: e for e in manifest["keys"]}
    arrays = {k: _from_stored(v, meta[k]["dtype"], meta[k]["shape"])
              if k in meta else v for k, v in arrays.items()}
    if like is None:
        return arrays  # flat dict form
    values = {}
    for key, leaf in _flatten_with_paths(like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing key {key}")
        values[key] = _like_leaf(arrays[key], leaf)
    return _rebuild(like, values)


def _host_copy(tree):
    """The tree with every tensor copied to the host, so an async write
    never reads a buffer the caller goes on changing."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_host_copy(v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    """Retention + async save + latest-step restore."""

    def __init__(self, root: str, max_to_keep: int = 3,
                 async_save: bool = True):
        self.root = root
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree) -> None:
        if self.async_save:
            # snapshot to host synchronously (cheap vs disk), write in thread
            host_tree = _host_copy(tree)
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host_tree), daemon=True)
            self._thread.start()
        else:
            self._write(step, tree)

    def _write(self, step: int, tree) -> None:
        save_pytree(tree, self._dir(step))
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # --------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int | None = None, like=None):
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return load_pytree(self._dir(step), like=like)

    # ------------------------------------------------------------------ util
    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
