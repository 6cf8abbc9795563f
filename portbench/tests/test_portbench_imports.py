"""No run of the benchmark loads JAX or the JAX package, and the plain
references load nothing of the port: checked in fresh processes, by the
whole top-level name of every module in `sys.modules` ("repro_torch"
begins with "repro" and is another name)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench.tests.small_cells import FL, POD, ROOT

PRELUDE = f"""
import json, sys, time
sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'src')!r},
                {os.path.join(ROOT, 'portbench', 'tests')!r}]
"""
TOP = "json.dumps(sorted({n.split('.')[0] for n in sys.modules}))"


def top_level(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PRELUDE + code
                          + f"\nprint({TOP})"], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("workload", [FL[0], POD[0]])
def test_a_run_loads_no_jax(workload):
    names = top_level(f"""
from small_cells import small
from portbench.harness import main
cell = small({workload!r})
main.run(cell["name"], 1, 0.1, False, t_start=time.perf_counter(),
         cell=cell, device="cpu")
""")
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_reference_loads_nothing_of_the_port():
    names = top_level("""
from portbench.reference import cnn, compress, fl_sim, mamba2, pod_round
from portbench.reference import precision
from portbench.data import images, tokens
""")
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                        "benchmarks"}


def test_command_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", FL[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "cuda" in out.stderr


def test_forbidden_names_compare_whole():
    from portbench.harness.main import forbidden_modules
    assert forbidden_modules(["repro_torch.core", "reprox", "numpy"]) == []
    assert forbidden_modules(["repro.core", "jax._src", "flax"]) == \
        ["flax", "jax", "repro"]
