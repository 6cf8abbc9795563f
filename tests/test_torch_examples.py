"""Each `examples/torch_*.py` (the port's counterparts of the reference's
examples, at the reference's sizes) runs to exit 0 with `--device cpu`
in a subprocess; the four start at once."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = ("torch_quickstart", "torch_fedluck_vs_baselines",
            "torch_serve_decode", "torch_multipod_local_sgd")
# what each prints last, the reference example's own closing lines
LAST = {"torch_quickstart": "final accuracy:",
        "torch_fedluck_vs_baselines": "fedavg_topk",
        "torch_serve_decode": '"arch": "mamba2-780m"',
        "torch_multipod_local_sgd": '"comm_mb"'}


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", name + ".py"),
         "--device", "cpu"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for name in EXAMPLES}
    yield procs
    for p in procs.values():
        p.kill()


@pytest.mark.parametrize("name", EXAMPLES)
def test_torch_example_runs_on_the_cpu(runs, name):
    out, err = runs[name].communicate(timeout=400)
    assert runs[name].returncode == 0, err[-3000:]
    assert LAST[name] in out, out[-2000:]
