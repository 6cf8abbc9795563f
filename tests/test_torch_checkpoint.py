"""The port's checkpoints (`repro_torch.checkpoint`, `launch.train`'s FL
state) on the CPU.

Mirrors `tests/test_checkpoint.py` against the port, then holds the two
packages to one format: both write the same manifest `keys`, a bf16 leaf
round-trips bitwise in both directions, and an FL checkpoint written by
either package resumes in the other, landing within `atol 2e-4` of the
other package's uninterrupted run (the full-subset batch trick of
`tests/test_checkpoint.py` keeps the dynamics free of loader state).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as JCk  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.core.controller import DeviceProfile as JProfile  # noqa: E402
from repro.core.factor import Plan as JPlan  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import small as jsmall  # noqa: E402

from repro_torch.checkpoint import (CheckpointManager, load_pytree,  # noqa: E402
                                    save_pytree)
from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.core.controller import DeviceProfile as TProfile  # noqa: E402
from repro_torch.core.factor import Plan as TPlan  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402


@pytest.fixture
def tree():
    return {"params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _jax_tree():
    """`tree` in the reference's types."""
    return {"params": {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
                       "b": jnp.ones(4, jnp.bfloat16)},
            "step": jnp.asarray(7, jnp.int32)}


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


class TestSaveLoad:
    def test_roundtrip(self, tree, tmp_path):
        d = str(tmp_path / "ck")
        save_pytree(tree, d)
        back = load_pytree(d, like=tree)
        torch.testing.assert_close(back["params"]["w"], tree["params"]["w"])
        assert back["params"]["b"].dtype == torch.bfloat16
        assert torch.equal(back["params"]["b"], tree["params"]["b"])
        assert int(back["step"]) == 7

    def test_flat_form_and_numpy_leaves(self, tmp_path):
        d = str(tmp_path / "ck")
        save_pytree({"a": np.arange(3, dtype=np.int64),
                     "b": [np.float32(2.5), torch.zeros(2)], "c": None}, d)
        flat = load_pytree(d)
        assert sorted(flat) == ["a", "b/0", "b/1"]
        assert flat["a"].dtype == np.int64 and flat["b/0"] == 2.5

    def test_atomic_overwrite(self, tree, tmp_path):
        d = str(tmp_path / "ck")
        save_pytree(tree, d)
        save_pytree({**tree, "step": torch.tensor(8, dtype=torch.int32)}, d)
        assert int(load_pytree(d, like=tree)["step"]) == 8
        assert not os.path.exists(d + ".tmp")

    def test_missing_key_raises(self, tree, tmp_path):
        d = str(tmp_path / "ck")
        save_pytree({"params": tree["params"]}, d)
        with pytest.raises(KeyError):
            load_pytree(d, like=tree)


class TestManager:
    def test_retention_and_latest(self, tree, tmp_path):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=2,
                                async_save=False)
        for s in [10, 20, 30]:
            mgr.save(s, tree)
        assert mgr.steps() == [20, 30]
        assert mgr.latest_step() == 30

    def test_async_save_then_restore(self, tree, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(5, tree)
        tree["step"].fill_(9)          # the save took its own host copy
        mgr.wait()
        back = mgr.restore(like=tree)
        assert int(back["step"]) == 7

    def test_restore_empty_returns_none(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.restore() is None

    def test_restart_resumes_training(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        w = np.arange(5, dtype=np.float32)
        mgr.save(3, {"w": w, "round": np.asarray(3)})
        mgr2 = CheckpointManager(str(tmp_path))
        state = mgr2.restore(like={"w": w, "round": np.asarray(0)})
        assert int(state["round"]) == 3
        np.testing.assert_allclose(state["w"], w)


class TestAcrossPackages:
    def test_same_manifest_keys(self, tree, tmp_path):
        jd, td = str(tmp_path / "j"), str(tmp_path / "t")
        JCk.save_pytree(_jax_tree(), jd)
        save_pytree(tree, td)
        assert _manifest(jd)["keys"] == _manifest(td)["keys"]
        with np.load(os.path.join(jd, "arrays.npz")) as zj, \
                np.load(os.path.join(td, "arrays.npz")) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for k in zj.files:   # the stored arrays too, bf16 bytes included
                assert zj[k].dtype == zt[k].dtype
                assert np.array_equal(zj[k], zt[k])

    def test_bf16_leaf_bitwise_both_ways(self, tmp_path):
        bits = np.random.RandomState(0).randint(
            0, 2 ** 16, size=(3, 5)).astype(np.uint16)
        bits[0, :3] = [0x7FC1, 0xFF80, 0x8000]   # NaN payload, -Inf, -0
        jtree = {"x": jnp.asarray(bits.view(jnp.bfloat16))}
        ttree = {"x": torch.from_numpy(bits.view(np.int16)).view(
            torch.bfloat16)}
        # repro writes, the port reads
        JCk.save_pytree(jtree, str(tmp_path / "j"))
        got = load_pytree(str(tmp_path / "j"), like=ttree)["x"]
        assert got.dtype == torch.bfloat16 and got.shape == (3, 5)
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              bits)
        # the port writes, repro reads
        save_pytree(ttree, str(tmp_path / "t"))
        back = JCk.load_pytree(str(tmp_path / "t"), like=jtree)["x"]
        assert back.dtype == jnp.bfloat16
        assert np.array_equal(np.asarray(back).view(np.uint16), bits)


# ------------------------------------------------------------------ FL resume
KW = dict(num_samples=64, test_samples=32, batch_size=64)


@pytest.fixture(scope="module")
def weights():
    t = jsmall.make_task("mlp_fmnist", **KW)
    return jax.tree.map(np.asarray, t.init_fn(jax.random.PRNGKey(0)))


def _sim(pkg, weights, engine="batched"):
    """Two EF devices. batch_size >= client subset size -> every local
    batch is the full (order-permuted) subset, so the dynamics are
    loader-state-free and a resumed run is comparable to the
    uninterrupted one."""
    if pkg == "jax":
        S, Profile, Plan = JS, JProfile, JPlan
        task = jsmall.make_task("mlp_fmnist", **KW)
        task.init_fn = lambda key: weights
        extra = {}
    else:
        S, Profile, Plan = TS, TProfile, TPlan
        task = tsmall.make_task("mlp_fmnist", **KW)
        task.init_fn = lambda gen: tsmall.params_from_jax(weights)
        extra = {"device": "cpu"}
    specs = [S.DeviceSpec(Profile(i, 0.01 * (i + 1), 2.0 + i),
                          Plan(2, 0.1, 0.0, 0.02 * (i + 1) + 0.1 * (2.0 + i),
                               0), "topk", True)
             for i in range(2)]
    return S.AFLSimulator(task, specs, "periodic", round_period=1.0,
                          eta_l=0.05, seed=0, engine=engine, **extra)


def _uninterrupted(pkg, weights):
    sim = _sim(pkg, weights)
    sim.run(total_rounds=8, eval_every=0)
    return sim.model.w


PKG_TRAIN = {"jax": (jtrain, JCk.CheckpointManager),
             "torch": (ttrain, CheckpointManager)}


class TestFLResume:
    @pytest.mark.parametrize("engine", ["batched", "sequential"])
    def test_resume_with_error_feedback_matches_uninterrupted(
            self, weights, tmp_path, engine):
        sim_a = _sim("torch", weights, engine)
        sim_a.run(total_rounds=8, eval_every=0)

        sim_b = _sim("torch", weights, engine)
        sim_b.run(total_rounds=4, eval_every=0)
        state = ttrain.fl_ckpt_state(sim_b)
        assert np.abs(state["residuals"]).sum() > 0  # EF really defers
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(int(state["round"]), state)

        sim_c = _sim("torch", weights, engine)
        ttrain.restore_fl_state(sim_c, mgr.restore(mgr.latest_step()))
        assert sim_c.model.round == sim_b.model.round
        np.testing.assert_array_equal(sim_c.residual_snapshot()[1],
                                      state["residuals"])
        sim_c.run(total_rounds=8, eval_every=0)
        np.testing.assert_allclose(sim_c.model.w, sim_a.model.w,
                                   rtol=0, atol=2e-4)

        # restoring w/round but NOT the residuals diverges
        sim_d = _sim("torch", weights, engine)
        ttrain.restore_fl_state(sim_d, {"w": state["w"],
                                        "round": state["round"]})
        sim_d.run(total_rounds=8, eval_every=0)
        err_with = np.abs(sim_c.model.w - sim_a.model.w).max()
        err_without = np.abs(sim_d.model.w - sim_a.model.w).max()
        assert err_without > max(err_with * 10, 1e-6)

    @pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                               ("torch", "jax")])
    def test_checkpoint_resumes_across_packages(self, weights, tmp_path,
                                                writer, reader):
        """4 rounds in `writer`, saved by its CheckpointManager; `reader`
        restores with its own manager and `restore_fl_state`, runs to 8,
        and lands within atol 2e-4 of `writer`'s uninterrupted run."""
        wtrain, WMgr = PKG_TRAIN[writer]
        rtrain, RMgr = PKG_TRAIN[reader]
        sim_b = _sim(writer, weights)
        sim_b.run(total_rounds=4, eval_every=0)
        state = wtrain.fl_ckpt_state(sim_b)
        assert np.abs(state["residuals"]).sum() > 0
        WMgr(str(tmp_path), async_save=False).save(int(state["round"]),
                                                   state)

        mgr = RMgr(str(tmp_path))
        sim_c = _sim(reader, weights)
        rtrain.restore_fl_state(sim_c, mgr.restore(mgr.latest_step()))
        assert sim_c.model.round == 4
        np.testing.assert_array_equal(sim_c.residual_snapshot()[1],
                                      state["residuals"])
        sim_c.run(total_rounds=8, eval_every=0)
        np.testing.assert_allclose(sim_c.model.w,
                                   _uninterrupted(writer, weights),
                                   rtol=0, atol=2e-4)

    def test_cli_resume(self, tmp_path):
        """`run_fl --ckpt-dir` saves a checkpoint per segment; `--resume`
        continues from the latest, and its checkpoint reads back."""
        flags = ["--task", "mlp_micro", "--devices", "3", "--samples",
                 "600", "--test-samples", "100", "--error-feedback",
                 "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
                 "--device", "cpu", "--quiet"]
        ap = ttrain.build_parser()
        res = ttrain.run_fl(ap.parse_args(flags + ["--rounds", "2"]))
        assert res["rounds"] == 2
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.steps() == [2]
        res = ttrain.run_fl(ap.parse_args(flags + ["--rounds", "4",
                                                   "--resume"]))
        assert res["rounds"] == 4 and mgr.steps() == [2, 4]
        state = mgr.restore()
        assert int(state["round"]) == 4
        assert state["residuals"].shape == (3, state["w"].size)
