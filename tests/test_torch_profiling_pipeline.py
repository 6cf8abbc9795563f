"""The port's last modules: `obs.profiling.annotate` opens an NVTX range
beside its `record_function` region when profiling is on and CUDA is
available (torch.cuda.nvtx is stood in for here: this CPU build has no
card), and none when profiling is off; `data.sharded_batches` lays host
batches out on a 2-process gloo mesh, each rank its own rows and the
0-d leaves replicated, held against the reference's
`repro.data.sharded_batches` on a (2, 1) mesh of 2 XLA host devices (one
subprocess that sets XLA_FLAGS itself) on the same loader and seed:
each rank's local shard of every leaf equals the shard of the device at
its place in the mesh (exported from `repro_torch.data` as the reference
exports it)."""
import contextlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_util as D  # noqa: E402

from repro_torch.obs import profiling  # noqa: E402


@pytest.fixture
def nvtx(monkeypatch):
    """torch.cuda.nvtx.range recording its enters and exits, with CUDA
    reported available."""
    events = []

    @contextlib.contextmanager
    def fake_range(name):
        events.append(("push", name))
        yield
        events.append(("pop", name))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range", fake_range)
    yield events
    profiling.set_profiling(False)


def test_annotate_opens_and_closes_an_nvtx_range(nvtx):
    profiling.set_profiling(True)
    with torch.profiler.profile() as prof:
        with profiling.annotate("local_round"):
            assert nvtx == [("push", "local_round")]
            torch.ones(4).sum()
    assert nvtx == [("push", "local_round"), ("pop", "local_round")]
    # the torch.profiler region is still recorded beside it
    assert any(e.name == "local_round" for e in prof.events())


def test_annotate_opens_no_range_when_profiling_is_off(nvtx):
    profiling.set_profiling(False)
    ctx = profiling.annotate("local_round")
    with ctx:
        pass
    assert nvtx == [] and ctx is profiling.annotate("other")


SEED, BATCH, DRAWS = 3, 6, 2
_JAX_SIDE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, numpy as np
from jax.sharding import Mesh
sys.path.insert(0, sys.argv[2])
from torch_dist_util import _Rows
from repro.data import DataLoader, sharded_batches
seed, bs, draws = (int(a) for a in sys.argv[3:6])
mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
where = {d: i for i, d in enumerate(mesh.devices.flat)}
it = sharded_batches(DataLoader(_Rows(16), batch_size=bs, seed=seed), mesh)
out = {}
for i in range(draws):
    for k, v in next(it).items():
        for sh in v.addressable_shards:
            out[f"ref_{k}{i}/{where[sh.device]}"] = np.asarray(sh.data)
np.savez(sys.argv[1], **out)
"""


def _reference_shards(tmp_path) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    env.pop("XLA_FLAGS", None)
    out = tmp_path / "ref.npz"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_SIDE),
                        str(out), os.path.dirname(os.path.abspath(__file__)),
                        str(SEED), str(BATCH), str(DRAWS)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(out))


def test_sharded_batches_give_each_rank_its_rows(tmp_path):
    from repro_torch import data
    assert data.sharded_batches is data.pipeline.sharded_batches
    ref = _reference_shards(tmp_path)
    # the reference splits the rows over its devices and replicates the
    # scale on both
    assert ref["ref_x0/0"].shape == (BATCH // 2, 3)
    assert ref["ref_scale0/0"].shape == ref["ref_scale0/1"].shape == ()
    out = D.spawn("sharded_batch_case", 2, tmp_path,
                  {"seed": np.asarray(SEED), "batch": np.asarray(BATCH),
                   "draws": np.asarray(DRAWS), **ref})
    for i in range(DRAWS):       # rank 0 holds the first half of each
        np.testing.assert_array_equal(out[f"x{i}"], out[f"host{i}"][:3])
        np.testing.assert_array_equal(out[f"x{i}"], ref[f"ref_x{i}/0"])
    assert not np.array_equal(out["host0"], out["host1"])
