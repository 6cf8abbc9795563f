"""Multi-pod dry run: trace one train, prefill or decode step of every
(arch × shape × mesh) cell on a fake 256- or 512-rank mesh, on one host
(PyTorch port of `repro.launch.dryrun`).

The reference lowers each cell with XLA on 512 placeholder devices and
reads XLA's memory and cost analyses. The port runs the step itself:
the default process group is the `fake` backend (`FakeStore`, world size
256 or 512, this process rank 0), the production `DeviceMesh` is built
on it, the LM is laid out by `dist.sharding`'s rules and one step runs
under `FakeTensorMode`, so no tensor holds data and every collective
returns at once. What rank 0 does is what every rank does (the program
is SPMD), and three dispatch-level counters read it:

  memory       live bytes of every tensor storage, each rounded up to the
               CUDA caching allocator's 512-byte granule: the arguments
               (params, optimizer state, batch or cache), the outputs the
               step makes, and the peak during the step. `temp_bytes` is
               the peak over the arguments. The kernels' fake versions
               (`kernels._common.kernel_op`) allocate only what the
               kernels do, never their plain versions' temporaries.
  flops        `torch.utils.flop_counter.FlopCounterMode`: matmuls,
               convolutions and attention (the CPU flash SDPA that the
               fake trace runs is counted by `_attn_flops`, as torch
               counts the CUDA ones: every score of the mask, forward
               and backward); elementwise work is not counted (XLA's
               `cost_analysis` counts it, so the numbers are not the
               reference's quantity).
  collectives  every c10d functional op, by kind and mesh axis: count,
               result bytes (the reference's per-device quantity) and
               wire bytes per device (ring: (n−1)/n of the gathered or
               scattered tensor, 2(n−1)/n for an all-reduce).

`parallelism` says how a cell runs its weights. The tp layout is the
reference's: each weight is gathered over `data` (FSDP) inside the layer
loop and keeps its `model` feature shard, the matmuls are
tensor-parallel over `model` (column- and row-parallel, the embedding
and the tied CE vocab-parallel) and train and prefill run Megatron
sequence parallelism over `model`, so only activations move over
`model`. The dp layout gathers each layer's weights whole over every
axis (the reference's `zero3_layer`).

The layers are a Python loop, so everything inside a layer is seen once
per layer: there is no scan body to extrapolate from (the reference's
1- and 2-layer auxiliary lowerings have no counterpart).

Roofline terms use the NVIDIA H100 SXM data sheet at 700 W (989 TFLOP/s
dense bf16, 3.35 TB/s HBM3, 450 GB/s NVLink per direction); the
reference's use TPU v5e peaks.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k \\
      --mesh single [--smoke]
  python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
  python -m repro_torch.launch.dryrun --sync-step --arch gemma3-4b
  python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k \\
      --mesh one --batch 2 --microbatch 2 --device cuda   # one card

`--mesh one` is a (1, 1) mesh of one rank (the cell `chip_smoke.py`
measures on the card). Results go to results/dryrun_torch/*.json; `--all`
runs each cell in a subprocess and tolerates per-cell failures.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

H100 = {"device": "NVIDIA H100 SXM data sheet, 700 W",
        "bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12,
        "nvlink_bytes_per_s": 450e9}

_KINDS = {"all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_reduce": "all-reduce", "all_to_all_single": "all-to-all"}
_GRANULE = 512


def _granule(n: int) -> int:
    return -(-n // _GRANULE) * _GRANULE


# -------------------------------------------------------------- the counters
def _tracker_mode():
    """A dispatch mode counting live storage bytes and c10d functional
    collectives (class made on first use: torch imports stay lazy)."""
    import torch
    from torch.multiprocessing.reductions import StorageWeakRef
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Tracker(TorchDispatchMode):
        def __init__(self, group_axes: dict):
            super().__init__()
            self.live: dict = {}          # storage cdata -> (ref, bytes)
            self.bytes = 0
            self.peak = 0
            self.group_axes = group_axes
            self.coll: list = []

        def add(self, t) -> int:
            """Count t's storage if it is new; returns the bytes added."""
            local = getattr(t, "_local_tensor", None)
            if local is not None:
                t = local
            if not isinstance(t, torch.Tensor) or t.is_meta:
                return 0
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                return 0
            n = _granule(st.nbytes())
            self.live[key] = (StorageWeakRef(st), n)
            self.bytes += n
            self.peak = max(self.peak, self.bytes)
            return n

        def sweep(self) -> None:
            dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
            for k in dead:
                self.bytes -= self.live.pop(k)[1]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.sweep()
            for t in tree_flatten(out)[0]:
                self.add(t)
            if func.namespace == "_c10d_functional":
                self._collective(func, args, out)
            return out

        def _collective(self, func, args, out) -> None:
            import torch.distributed as dist
            name = func.__name__.split(".")[0]
            kind = _KINDS.get(name)
            if kind is None:
                return
            group = args[-1]
            n = dist.distributed_c10d._resolve_process_group(group).size()
            nbytes = out.numel() * out.element_size()
            inb = args[0].numel() * args[0].element_size()
            wire = {"all-gather": (n - 1) / n * nbytes,
                    "reduce-scatter": (n - 1) / n * inb,
                    "all-reduce": 2 * (n - 1) / n * nbytes,
                    "all-to-all": (n - 1) / n * nbytes}[kind]
            self.coll.append((kind, self.group_axes.get(group, group),
                              nbytes, wire))

    return Tracker


def _schedule(coll) -> dict:
    out = {k: {"count": 0, "bytes": 0, "wire_bytes": 0.0}
           for k in _KINDS.values()}
    by_axis: dict = {}
    for kind, axis, nbytes, wire in coll:
        for d in (out[kind], by_axis.setdefault(f"{kind}@{axis}", {
                "count": 0, "bytes": 0, "wire_bytes": 0.0})):
            d["count"] += 1
            d["bytes"] += nbytes
            d["wire_bytes"] += wire
    out["total_bytes"] = sum(v["bytes"] for v in out.values()
                             if isinstance(v, dict))
    out["total_wire_bytes"] = sum(v["wire_bytes"] for v in out.values()
                                  if isinstance(v, dict))
    out["by_axis"] = by_axis
    return out


def _group_axes(mesh) -> dict:
    """{process-group name: mesh axis name} of `mesh`."""
    return {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}


def _dims(t) -> tuple:
    return tuple(t.shape) if hasattr(t, "shape") else tuple(t)


def _sdpa_fwd_flops(q, k, v, *args, **kwargs) -> int:
    """q·kᵀ and p·v of q [B, Hq, Sq, d], k/v [B, Hkv, Sk, d]."""
    (b, h, sq, dq), sk, dv = _dims(q), _dims(k)[2], _dims(v)[3]
    return 2 * b * h * sq * sk * (dq + dv)


def _sdpa_bwd_flops(grad_out, q, k, v, *args, **kwargs) -> int:
    """The scores recomputed, then dP, dV, dQ and dK."""
    (b, h, sq, dq), sk, dv = _dims(q), _dims(k)[2], _dims(v)[3]
    return 2 * b * h * sq * sk * (3 * dq + 2 * dv)


_sdpa_fwd_flops._get_raw = _sdpa_bwd_flops._get_raw = True


def _attn_flops() -> dict:
    """FlopCounterMode's `custom_mapping` for the CPU flash SDPA (absent
    from torch's table)."""
    import torch
    aten = torch.ops.aten
    return {aten._scaled_dot_product_flash_attention_for_cpu:
            _sdpa_fwd_flops,
            aten._scaled_dot_product_flash_attention_for_cpu_backward:
            _sdpa_bwd_flops}


def estimate(fn, args: tuple, mesh) -> dict:
    """Run fn(*args) once under the counters. `args` are fake tensors
    (made under the caller's `FakeTensorMode`); returns memory (bytes per
    device), matmul and attention FLOPs per device and the collective
    schedule."""
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import FlopCounterMode
    Tracker = _tracker_mode()
    tr = Tracker(_group_axes(mesh))
    for t in tree_flatten(args)[0]:
        tr.add(t)
    arg_bytes = tr.bytes
    flops = FlopCounterMode(display=False, custom_mapping=_attn_flops())
    with flops, tr:
        out = fn(*args)
        tr.sweep()
    arg_keys = {_storage_key(a) for a in tree_flatten(args)[0]}
    made = {}                      # the storages the step's outputs hold
    for t in tree_flatten(out)[0]:
        key = _storage_key(t)
        if key is not None and key not in arg_keys:
            made[key] = _granule(_storage(t).nbytes())
    out_bytes = sum(made.values())
    return {"memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes,
                       "temp_bytes": tr.peak - arg_bytes,
                       "peak_bytes": tr.peak},
            "flops_per_device": int(flops.get_total_flops()),
            "collectives": _schedule(tr.coll)}


def _storage(t):
    """The storage of a tensor, of a DTensor's local shard; else None."""
    t = getattr(t, "_local_tensor", t)
    return t.untyped_storage() if hasattr(t, "untyped_storage") else None


def _storage_key(t):
    st = _storage(t)
    return None if st is None else st._cdata


# ------------------------------------------------------------- process group
def fake_world(world_size: int) -> None:
    """Make the default process group the `fake` backend of
    `world_size` ranks (this process rank 0), unless one exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks exists; the cell needs {world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _mesh(mesh_kind: str, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_production_mesh
    if mesh_kind == "one":
        fake_world(1)
        return init_device_mesh(device_type, (1, 1),
                                mesh_dim_names=("data", "model"))
    fake_world(512 if mesh_kind == "multi" else 256)
    return make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_type=device_type)


# ------------------------------------------------------------- cell execution
def run_cell(arch: str, shape: str, mesh_kind: str, *, verbose: bool = True,
             step_override: str | None = None, zero3: bool = False,
             moe_local: bool = False, seq_parallel: bool = True,
             layout: str = "tp", microbatches: int = 1,
             kv_int8: bool = False, tag: str = "", smoke: bool = False,
             batch: int | None = None, seq: int | None = None,
             device: str = "cpu", overrides: dict | None = None) -> dict:
    """Trace one cell; the keyword arguments are the reference's variants
    plus `smoke` (the arch's smoke config), `batch` / `seq` and config
    field `overrides`, and the fake tensors' `device`."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.dist import sharding as shl
    from repro_torch.dist.steps import (make_decode_step, make_prefill_step,
                                        make_train_step)
    from repro_torch.launch.mesh import batch_axes_for
    from repro_torch.models.transformer import LM
    from repro_torch.optim import momentum_sgd

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    sinfo = dict(SHAPES[shape])
    if shape in cfg.skip_shapes or (
            sinfo["kind"] == "decode" and cfg.family == "audio"):
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "skipped", "reason": "shape not served by arch"}
    if batch:
        sinfo["batch"] = batch
    if seq:
        sinfo["seq"] = seq
    mesh = _mesh(mesh_kind, device)
    names = mesh.mesh_dim_names
    if layout == "dp":
        baxes = tuple(a for a in ("pod", "data", "model") if a in names)
        fsdp_axis, model_axis = baxes, None
    else:
        baxes = batch_axes_for(mesh)
        fsdp_axis, model_axis = "data", "model"
    kind = step_override or sinfo["kind"]
    B, S = sinfo["batch"], sinfo["seq"]
    n_bshards = math.prod(mesh.size(names.index(a)) for a in baxes)
    act_axes = baxes if B % n_bshards == 0 else None
    seq_axis = "model" if (seq_parallel and layout == "tp"
                           and kind in ("train", "prefill")) else None
    lm = LM(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
            remat=True, batch_axes=act_axes, act_seq_axis=seq_axis,
            kv_dtype=("int8" if kv_int8 else "compute"),
            zero3_layer=(layout == "dp"),
            moe_dispatch_axes=(act_axes if moe_local and act_axes
                               else None))
    meta = {path: torch.empty(shp, device="meta")
            for path, shp in lm.param_spec()}
    params_meta: dict = {}
    for path, t in meta.items():
        node = params_meta
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    pspec = shl.param_specs(params_meta, mesh, fsdp_axis=fsdp_axis,
                            model_axis=model_axis)
    if layout == "dp":
        lm = dataclasses.replace(lm, layer_param_specs=shl._map(
            lambda _, s: shl.P(*s[1:]), pspec["layers"]))
    batch_meta = cfg.input_specs(shape, batch=B, seq=S)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = shl.distribute(params_meta, pspec, mesh,
                                dtype=torch.bfloat16, device=device)
        bspec = shl.batch_specs(batch_meta, mesh, batch_axes=baxes)
        if kind == "train":
            opt = momentum_sgd(1e-2, momentum=0.9)
            state = opt.init(params)
            z3 = act_axes if zero3 and layout == "tp" and act_axes else None
            fn = make_train_step(lm, opt, pspec=pspec, zero3_axes=z3,
                                 microbatches=microbatches)
            args = (params, state, shl.distribute(batch_meta, bspec, mesh,
                                                  device=device))
        elif kind == "prefill":
            fn = make_prefill_step(lm)
            batch_meta.pop("labels", None)
            args = (params, shl.distribute(batch_meta, bspec, mesh,
                                           device=device))
        else:
            fn = make_decode_step(lm)
            cache = lm.cache_specs(B, S)
            cspec = shl.cache_specs(cache, mesh, batch_axes=baxes)
            token = {"t": torch.empty((B, 1), dtype=torch.int32,
                                      device="meta")}
            tok = shl.distribute(token, shl.batch_specs(token, mesh,
                                                        batch_axes=baxes),
                                 mesh, device=device)["t"]
            args = (params, shl.distribute(cache, cspec, mesh,
                                           device=device), tok, S - 1)
        est = estimate(fn, args, mesh)
    trace_s = time.perf_counter() - t0
    n_dev = mesh.size()
    cache_bytes = None
    if kind == "decode":        # this rank's share of the KV/SSM cache
        cache_bytes = sum(
            math.prod(shl.local_shape(c.shape, shl.placements(sp, mesh),
                                      mesh)) * c.element_size()
            for (_, c), (_, sp) in zip(shl._with_paths(cache),
                                       shl._with_paths(cspec)))
    coll = est["collectives"]
    flops = est["flops_per_device"]
    if layout == "tp":
        parallelism = "FSDP over data, tensor-parallel over model"
        if seq_axis:
            parallelism += ", sequence-parallel over model"
        if "pod" in names:
            parallelism += ", data-parallel over pod"
        if lm.moe_dispatch_axes and cfg.n_experts:
            parallelism += ", shard-local MoE dispatch"
    else:
        parallelism = f"FSDP over ({', '.join(baxes)})"
    res = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "kind": kind,
        "variant": {"zero3": zero3, "moe_local": moe_local,
                    "layout": layout, "seq_parallel": seq_parallel,
                    "kv_int8": kv_int8, "microbatches": microbatches,
                    "tag": tag, "smoke": smoke, "batch": B, "seq": S,
                    "n_layers": cfg.n_layers, "overrides": overrides},
        "status": "ok", "n_devices": n_dev, "trace_s": round(trace_s, 1),
        "parallelism": parallelism,
        "memory": est["memory"],
        "cost": {"matmul_flops_per_device": flops,
                 "collective_bytes_per_device": coll["total_bytes"],
                 "collective_wire_bytes_per_device":
                     coll["total_wire_bytes"]},
        "collectives": coll,
        "local_cache_bytes": cache_bytes,
        "roofline": {**H100,
                     "compute_s": flops / H100["bf16_flops_per_s"],
                     "collective_s": coll["total_wire_bytes"]
                     / H100["nvlink_bytes_per_s"],
                     "argument_read_s": est["memory"]["argument_bytes"]
                     / H100["hbm_bytes_per_s"]},
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if verbose:
        m = res["memory"]
        print(f"[{arch} × {shape} × {mesh_kind}] OK ({parallelism}) "
              f"trace={trace_s:.1f}s "
              f"peak/dev={m['peak_bytes'] / 2**30:.3f}GiB "
              f"flops/dev={flops:.3e} "
              f"coll/dev={coll['total_wire_bytes'] / 2**20:.1f}MiB")
        print("  collective schedule:",
              {k: v for k, v in coll["by_axis"].items()})
    return res


def run_sync_step(arch: str, *, rate: float = 0.01, smoke: bool = False,
                  verbose=True) -> dict:
    """Trace the FedLuck cross-pod sync (Eq. 6) across processes on the
    multi-pod mesh."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shl
    from repro_torch.dist.collectives import make_pod_sync

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    dim = cfg.param_count()
    # sharding-aligned 2D layout: n_blocks sharded over the 256 in-pod ranks
    n_blocks = 4096
    blk = -(-dim // n_blocks)
    dim_p = n_blocks * blk
    mesh = _mesh("multi", "cpu")
    n_pods = mesh.size(0)
    sync = make_pod_sync(mesh, dim_p, rate=rate, n_blocks=n_blocks)
    inpod = ("data", "model")
    with FakeTensorMode(allow_non_fake_inputs=True):
        p = shl.distribute({"x": torch.empty((n_blocks, blk),
                                             device="meta")},
                           {"x": shl.P(inpod, None)}, mesh, device="cpu")["x"]
        d, r = (shl.distribute({"x": torch.empty((n_pods, n_blocks, blk),
                                                 device="meta")},
                               {"x": shl.P("pod", inpod, None)}, mesh,
                               device="cpu")["x"] for _ in range(2))
        est = estimate(sync, (p, d, r), mesh)
    coll = est["collectives"]
    res = {"arch": arch, "kind": "fedluck_sync", "rate": rate, "dim": dim_p,
           "wire": sync.path, "status": "ok",
           "trace_s": round(time.perf_counter() - t0, 1),
           "collectives": coll, "memory": est["memory"],
           "matmul_flops_per_device": est["flops_per_device"],
           "bytes_per_device_model": sync.bytes_per_device}
    if verbose:
        print(f"[{arch} sync δ={rate}] coll/dev="
              f"{coll['total_bytes'] / 2**20:.2f}MiB {coll['by_axis']}")
    return res


# -------------------------------------------------------------- command line
def _result_path(arch, shape, mesh_kind, out_dir=RESULTS_DIR):
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "one"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--sync-step", action="store_true")
    ap.add_argument("--rate", type=float, default=0.01)
    ap.add_argument("--zero3", action="store_true")
    ap.add_argument("--moe-local", action="store_true")
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--layout", default="tp", choices=["tp", "dp"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--batch", type=int)
    ap.add_argument("--seq", type=int)
    ap.add_argument("--device", default="cpu",
                    help="device of the fake tensors (cuda on a card)")
    ap.add_argument("--out", help="result file (default: under "
                                  "results/dryrun_torch/)")
    args = ap.parse_args(argv)
    os.makedirs(RESULTS_DIR, exist_ok=True)

    def write(res, path):
        path = args.out or path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)

    if args.sync_step:
        res = run_sync_step(args.arch, rate=args.rate, smoke=args.smoke)
        write(res, os.path.join(RESULTS_DIR, f"{args.arch}__sync.json"))
        return

    if args.all:
        from repro_torch.configs import ARCH_IDS
        from repro_torch.configs.base import SHAPES
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        failures = []
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mk in meshes:
                    path = _result_path(arch, shape, mk)
                    if os.path.exists(path) and not args.force:
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape, "--mesh", mk]
                    if args.smoke:
                        cmd.append("--smoke")
                    print(f"--- {arch} × {shape} × {mk}", flush=True)
                    r = subprocess.run(cmd, capture_output=True, text=True,
                                       timeout=3600)
                    sys.stdout.write(r.stdout)
                    if r.returncode != 0:
                        failures.append((arch, shape, mk))
                        sys.stderr.write(r.stderr[-3000:])
        print("FAILURES:", failures if failures else "none")
        return

    try:
        res = run_cell(args.arch, args.shape, args.mesh, zero3=args.zero3,
                       moe_local=args.moe_local, layout=args.layout,
                       microbatches=args.microbatch, kv_int8=args.kv_int8,
                       seq_parallel=not args.no_seq_parallel, tag=args.tag,
                       smoke=args.smoke, batch=args.batch, seq=args.seq,
                       device=args.device)
    except Exception:
        traceback.print_exc()
        raise
    path = _result_path(args.arch, args.shape, args.mesh)
    if args.tag:
        path = path.replace(".json", f"__{args.tag}.json")
    write(res, path)


if __name__ == "__main__":
    main()
