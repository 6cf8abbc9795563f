"""The port's partition rules (`repro_torch.dist.sharding`) against
`repro.dist.sharding`, leaf for leaf, on the host: no process group and
no device mesh. Both packages' rule functions read only the mesh's
{name: size} shape, so one namespace stands in for the mesh on both
sides.

Cases: every arch's smoke config; meshes (2, 4), (2, 2, 2), (16, 16) and
(2, 16, 16); the default layout (FSDP over `data`, TP over `model`) and
the dry run's dp layout (FSDP over the whole mesh as one tuple axis, no
TP); params, the momentum-SGD state, the inputs of every shape kind and
the decode cache in both cache dtypes. `placements` is checked against
the DTensor placements the specs mean (its round trip through
`distribute` runs on 8 processes in tests/test_torch_dist_steps.py).
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.dist import sharding as jshl  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import momentum_sgd as jmomentum  # noqa: E402

from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.dist import sharding as shl  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import momentum_sgd  # noqa: E402

MESHES = {
    "2x4": {"data": 2, "model": 4},
    "2x2x2": {"pod": 2, "data": 2, "model": 2},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def _mesh(shape: dict):
    return types.SimpleNamespace(shape=dict(shape),
                                 axis_names=tuple(shape),
                                 mesh_dim_names=tuple(shape))


def _jax_leaves(tree) -> dict:
    """{path: spec entries} of a reference spec tree."""
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(tree,
                                                          is_leaf=is_p):
        out[tuple(str(getattr(k, "key", k)) for k in path)] = tuple(spec)
    return out


def _port_leaves(tree) -> dict:
    return {path: tuple(spec) for path, spec in shl._with_paths(tree)}


def _meta_tree(spec_list) -> dict:
    out: dict = {}
    for path, shape in spec_list:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(shape, device="meta")
    return out


def _layout(mesh_shape: dict, layout: str) -> dict:
    if layout == "dp":
        return dict(fsdp_axis=tuple(a for a in ("pod", "data", "model")
                                    if a in mesh_shape), model_axis=None)
    return dict(fsdp_axis="data", model_axis="model")


def _models(arch, kv_dtype="compute"):
    jlm = JT.LM(jget_config(arch).smoke(), dtype=jnp.float32, remat=False,
                kv_dtype=kv_dtype)
    tlm = TT.LM(tget_config(arch).smoke(), dtype=torch.float32, remat=False,
                kv_dtype=kv_dtype)
    return jlm, tlm


@pytest.mark.parametrize("layout", ["tp", "dp"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_match_reference(arch, mesh_name, layout):
    shape = MESHES[mesh_name]
    mesh = _mesh(shape)
    jlm, tlm = _models(arch)
    jshapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    jp = jshl.param_specs(jshapes, mesh, **_layout(shape, layout))
    params = _meta_tree(tlm.param_spec())
    tp = shl.param_specs(params, mesh, **_layout(shape, layout))
    assert _port_leaves(tp) == _jax_leaves(jp)
    assert all(isinstance(s, shl.P) for _, s in shl._with_paths(tp))
    # the optimizer state mirrors the params; the step counter replicates
    jo = jshl.opt_state_specs(
        jax.eval_shape(jmomentum(0.01).init, jshapes), jp, mesh)
    to = shl.opt_state_specs(
        momentum_sgd(0.01).init(shl._map(
            lambda _, t: torch.empty(t.shape), params)), tp, mesh)
    assert _port_leaves(to) == _jax_leaves(jo)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch, mesh_name):
    shape = MESHES[mesh_name]
    mesh = _mesh(shape)
    baxes = tuple(a for a in ("pod", "data") if a in shape)
    jlm, tlm = _models(arch)
    jcfg, tcfg = jlm.cfg, tlm.cfg
    for sname in tcfg.shapes():
        jb = jshl.batch_specs(jcfg.input_specs(sname), mesh,
                              batch_axes=baxes)
        tb = shl.batch_specs(tcfg.input_specs(sname), mesh,
                             batch_axes=baxes)
        assert _port_leaves(tb) == _jax_leaves(jb), sname
    for kv in ("compute", "int8"):
        jlm, tlm = _models(arch, kv)
        for B, S in ((128, 32768), (4, 64), (3, 30)):
            jc = jshl.cache_specs(jlm.cache_specs(B, S), mesh,
                                  batch_axes=baxes)
            tc = shl.cache_specs(tlm.cache_specs(B, S), mesh,
                                 batch_axes=baxes)
            assert _port_leaves(tc) == _jax_leaves(jc), (kv, B, S)


def test_sequence_sharded_cache_and_dp_tuple_axis():
    """The two layouts the mesh path leans on: the KV cache's S dim on
    `model`, and the dp layout's one tensor dim over every mesh axis."""
    mesh = _mesh(MESHES["2x16x16"])
    tlm = TT.LM(tget_config("gemma3-4b"), dtype=torch.bfloat16)
    cs = shl.cache_specs(tlm.cache_specs(128, 32768), mesh,
                         batch_axes=("pod", "data"))
    assert cs["k"] == (None, ("pod", "data"), "model", None, None)
    ps = shl.param_specs(_meta_tree(tlm.param_spec()), mesh,
                         **_layout(mesh.shape, "dp"))
    assert ps["layers"]["wq"]["kernel"] == (None, ("pod", "data", "model"),
                                            None)


def test_strip_axes_matches_reference():
    P = jax.sharding.PartitionSpec
    for spec in ((None, "data", "model"), (("pod", "data"), None),
                 ("model", ("pod", "data", "model")), ()):
        for axes in (("data",), ("pod", "data"), ("model",)):
            from repro.dist.steps import _strip_axes
            assert tuple(shl.strip_axes(shl.P(*spec), axes)) == \
                tuple(_strip_axes(P(*spec), axes))


def test_placements_mean_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh({"pod": 2, "data": 2, "model": 2})
    assert shl.placements(shl.P(None, "data", "model"), mesh) == \
        (Replicate(), Shard(1), Shard(2))
    assert shl.placements(shl.P(("pod", "data", "model"), None), mesh) == \
        (Shard(0), Shard(0), Shard(0))
    assert shl.placements(shl.P("model", ("pod", "data")), mesh) == \
        (Shard(1), Shard(1), Shard(0))
    assert shl.placements(shl.P(None, None), mesh) == (Replicate(),) * 3
    # DTensor nests shards in mesh order: a tuple out of that order would
    # lay the dim out differently from the reference
    with pytest.raises(ValueError, match="mesh order"):
        shl.placements(shl.P(("data", "pod"), None), mesh)
    assert shl.local_shape((8, 12), shl.placements(
        shl.P(("pod", "data"), "model"), mesh),
        types.SimpleNamespace(size=lambda i: 2)) == (2, 6)
