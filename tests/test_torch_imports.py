"""The port stands alone: no module of `repro_torch`, not `chip_smoke.py`
and no `examples/torch_*.py` imports `jax` or the reference package
`repro` — checked on the source (every import statement, also inside
functions) and by importing every module of the port in a fresh
interpreter."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


def _sources():
    pkg = os.path.join(SRC, "repro_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    ex = os.path.join(ROOT, "examples")
    for f in sorted(os.listdir(ex)):
        if f.startswith("torch_") and f.endswith(".py"):
            yield os.path.join(ex, f)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_repro():
    bad = [(os.path.relpath(p, ROOT), m) for p in _sources()
           for m in _imported(p)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def test_importing_every_module_loads_no_jax():
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]
    assert "repro_torch.models.transformer" in names
    assert "repro_torch.launch.serve" in names
    for mod in ("repro_torch.launch.mesh", "repro_torch.launch.dryrun",
                "repro_torch.dist.sharding", "repro_torch.dist.spmd"):
        assert mod in names
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_importing_the_mesh_modules_starts_no_process_group():
    """As the reference's `launch/mesh.py` promises: importing the mesh
    builders, the sharding rules and the dry run makes no process group
    (the dry run makes its fake one only when a cell runs)."""
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
            "import repro_torch.dist.sharding, repro_torch.dist.spmd\n"
            "assert not dist.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
