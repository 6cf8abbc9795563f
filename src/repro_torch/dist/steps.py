"""Step builders for FedLuck's datacenter round (PyTorch port of the
local-round and pod-round builders in `repro.dist.steps`).

  make_local_round_step  FedLuck Alg. 1 device loop: k optimizer steps over
                         a stacked [k, B, ...] batch, returning the Eq. 4
                         pseudo-gradient delta = w0 − wk in fp32.
  make_pod_round_step    one full datacenter round: a local round per pod
                         feeding the Eq. 6 cross-pod sync from
                         `dist.collectives.make_pod_sync`, with wire bits
                         taken from the sync's actual payload shape.

`lm` is anything with `.loss(params, batch)` over a nested dict of
parameters. `local_round` is the one local-round loop of the port, shared
with `AFLSimulator`'s sequential engine: it runs on one flat fp32 leaf
buffer whose views are the parameters, and each step is one
`autograd.grad` for the flat gradient and one in-place `opt.update` on
the buffer — one `fused_momentum` launch for `momentum_sgd`.
`batched_local_round` is its counterpart for a chunk of B devices (the
simulator's batched engine): a stacked [B, d] buffer, `torch.func.vmap`
gradients (`batched_grad`), and one `opt.update` over the whole [B·d]
buffer per step. Both run in a "local_round" span with a
"local_round.step" span per optimizer step, and a pod round in a
"pod.round" span whose "pod.sync" span holds the call of the sync
(`obs.profiling` lists the spans). `capture_graph` records a call as
one CUDA graph, for the simulator's batched engine to replay.

  make_train_step        fwd/bwd/update of an `LM` on plain or DTensor
                         parameters (the reference's builder): an
                         optional ZeRO-3 redistribute of every param at
                         step start, and `microbatches=` gradient
                         accumulation in fp32.
  make_prefill_step /    thin inference wrappers of `LM.prefill` and
  make_decode_step       `LM.decode_step` (the cache layout work lives in
                         `sharding.cache_specs` and the LM's mesh path).

A train step updates in place, as `local_round` does: the parameters are
views of one flat local buffer (`sharding.distribute`, `LM.init`,
`transformer.params_from_jax`), the gradient is one flat buffer in the
same order (the fp32 accumulator itself when `microbatches > 1`), and the
optimizer updates the buffer once: one `fused_momentum` launch per rank
for `momentum_sgd`.
"""
from __future__ import annotations

import torch

from repro_torch.core import compression as C
from repro_torch.dist import sharding as shl
from repro_torch.obs.profiling import annotate


def local_round(loss_fn, opt, flat: torch.Tensor, spec, opt_state,
                batches):
    """One optimizer step per batch dict in `batches`, from the flat fp32
    params `flat` (left untouched) -> (opt_state_k, w_k flat, delta flat,
    per-step losses). delta = w0 − wk is the Eq. 4 pseudo-gradient;
    `opt_state`'s buffers are updated in place."""
    with annotate("local_round"):
        w = flat.detach().to(torch.float32).clone().requires_grad_(True)
        losses = []
        for batch in batches:
            with annotate("local_round.step"):
                tree = C.unflatten_pytree(w, spec)
                leaves = [leaf for _, leaf in C._leaves(tree)]
                loss = loss_fn(tree, batch)
                # the gradient of each leaf view, concatenated in flat
                # order: through the views to `w`, autograd would
                # zero-fill a [d] gradient per leaf and sum them
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
                grad = torch.cat([g.reshape(-1) for g in grads])
                _, opt_state = opt.update(grad, opt_state, w.detach())
                losses.append(loss.detach())
        w_k = w.detach()
        return opt_state, w_k, flat.to(torch.float32) - w_k, losses


def batched_grad(loss_fn, spec):
    """grad(W [B, d], batch of [B, ...] tensors) -> [B, d]: every row's
    gradient of `loss_fn` at its own parameters, by `vmap(grad(loss))`.

    Under vmap a convolution whose weights differ per row becomes one
    grouped convolution. On the H100, cuDNN's kernels for it take fp32
    gradients about 2e-4 from float64 (median row of cnn_fmnist), where
    its ungrouped kernels, which the sequential engine runs, and
    PyTorch's own kernels stay near 4e-7 (`launch.grad_accuracy`). So
    the gradients are taken with cuDNN off."""
    g = torch.func.vmap(torch.func.grad(
        lambda wr, b: loss_fn(C.unflatten_pytree(wr, spec), b)))

    def grad(w: torch.Tensor, batch: dict) -> torch.Tensor:
        with torch.backends.cudnn.flags(
                enabled=False, benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=torch.backends.cudnn.allow_tf32):
            return g(w, batch)

    return grad


def batched_local_round(loss_fn, opt, flat: torch.Tensor, spec, batches
                        ) -> torch.Tensor:
    """The local rounds of B devices from one global model at once: the
    counterpart of the reference's vmapped local round.

    `flat` is the [d] fp32 model (left untouched); `batches` holds one dict
    of [B, batch, ...] tensors per step. Each step takes every row's
    gradient with `vmap(grad(loss))` and applies `opt.update` ONCE over the
    contiguous [B·d] views of the stacked parameters and their optimizer
    state — one `fused_momentum` launch for `momentum_sgd`. The launch has
    no batching rule, so it stays outside vmap; the update is elementwise,
    so one launch serves every row. Returns g = W0 − Wk, [B, d] (Eq. 4),
    equal row by row to `local_round`'s delta on the row's batches."""
    with annotate("local_round"):
        w0 = flat.detach().to(torch.float32)
        rows = next(iter(batches[0].values())).shape[0]
        w = w0.repeat(rows, 1)          # a copy, also when rows == 1
        state = opt.init(w.view(-1))
        grad = batched_grad(loss_fn, spec)
        for batch in batches:
            with annotate("local_round.step"):
                _, state = opt.update(grad(w, batch).reshape(-1), state,
                                      w.view(-1))
        return w0 - w


def capture_graph(fn, pool) -> torch.cuda.CUDAGraph:
    """`fn()` captured as one CUDA graph, its temporaries in the graph
    memory pool `pool`; returns the graph, not yet run. Capture runs on
    `torch.cuda.graph`'s side stream, so `fn`'s lazy set-up (handles,
    Triton's JIT, autograd's device thread) must have run before, as an
    eager call of `fn` does.

    cuBLAS keeps a 32 MiB workspace per (handle, stream) for the life of
    the process, and a capture on a new stream would add one for each of
    the two threads that run GEMMs (the caller's and autograd's). So the
    workspaces are dropped before the capture (the default stream's come
    back on their next use) and after it: the capture stream's were
    allocated in `pool`, and the graph keeps their addresses, as scratch
    that nothing outside its own launches reads."""
    torch._C._cuda_clearCublasWorkspaces()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        fn()
    torch._C._cuda_clearCublasWorkspaces()
    return graph


def _steps(batches: dict, k: int) -> list[dict]:
    """[k, B, ...] stacked batches -> k per-step batch dicts."""
    return [{key: v[i] for key, v in batches.items()} for i in range(k)]


def make_local_round_step(lm, opt, k: int):
    """round(params, opt_state, batches) -> (params_k, opt_state_k, delta,
    mean_loss) where params is a nested dict of tensors, batches a dict of
    [k, B, ...] tensors and delta = w0 − wk (fp32, a dict shaped like
    params) is the Eq. 4 pseudo-gradient the caller compresses and ships.
    `params` is left as it is; `opt_state`'s buffers are updated in
    place."""

    def round_fn(params, opt_state, batches):
        flat, spec = C.flatten_pytree(params)
        s_k, w_k, delta, losses = local_round(lm.loss, opt, flat, spec,
                                              opt_state, _steps(batches, k))
        return (C.unflatten_pytree(w_k, spec), s_k,
                C.unflatten_pytree(delta, spec), torch.stack(losses).mean())

    return round_fn


def make_pod_round_step(lm, opt, k: int, sync, *, spec, dim: int,
                        n_blocks: int):
    """Compose per-pod local rounds and the cross-pod sync into one round.

    `sync` comes from `dist.collectives.make_pod_sync`; `spec` is the
    flatten spec of the params (`compression.flatten_pytree`); `dim` is the
    true flat dim (padded up to n_blocks · blk inside).

    step(params_blocked [nb, blk], opt_states (a list, one state per pod),
         batches (dict of pod-stacked [P, k, B, ...] tensors),
         residuals [P, nb, blk])
      -> (new_params_blocked, new_opt_states, new_residuals, mean_loss)

    The per-round communication cost is static — `step.wire_bits_per_pod`
    re-exports `sync.payload_bits_per_pod`, the bits one pod's update
    actually occupies on the wire.
    """

    def step(params_blocked, opt_states, batches, residuals):
        with annotate("pod.round"):
            if getattr(sync, "mesh", None) is not None:
                return _pod_round_across(lm, opt, k, sync, spec, dim,
                                         params_blocked, opt_states, batches,
                                         residuals)
            return _pod_round(lm, opt, k, sync, spec, dim, n_blocks,
                              params_blocked, opt_states, batches, residuals)

    step.wire_bits_per_pod = float(getattr(sync, "payload_bits_per_pod",
                                           0.0))
    return step


def _pod_round(lm, opt, k, sync, spec, dim, n_blocks, params_blocked,
               opt_states, batches, residuals):
    """The pod round with every pod on this process's one device."""
    nb, blk = params_blocked.shape
    if nb != n_blocks or nb * blk < dim:
        raise ValueError(f"params_blocked {tuple(params_blocked.shape)} "
                         f"does not hold {n_blocks} blocks of dim {dim}")
    n_pods = len(opt_states)
    dev = params_blocked.device
    flat = params_blocked.reshape(-1)[:dim]
    # the padded coordinates get a zero delta
    flat_deltas = torch.zeros((n_pods, nb * blk), dtype=torch.float32,
                              device=dev)
    new_states, losses = [], []
    for p in range(n_pods):
        pod_batches = {key: v[p] for key, v in batches.items()}
        s_k, _, delta, pod_losses = local_round(
            lm.loss, opt, flat, spec, opt_states[p], _steps(pod_batches, k))
        flat_deltas[p, :dim] = delta
        new_states.append(s_k)
        losses.append(torch.stack(pod_losses).mean())
    deltas = flat_deltas.view(n_pods, nb, blk)
    with annotate("pod.sync"):
        new_blocked, new_residuals = sync(params_blocked, deltas, residuals)
    return new_blocked, new_states, new_residuals, torch.stack(losses).mean()


def _pod_round_across(lm, opt, k, sync, spec, dim, params_blocked,
                      opt_states, batches, residuals):
    """The pod round with one process per (pod, in-pod shard): each
    process runs its pod's local round on the gathered model (the pod's
    in-pod processes run the same one), keeps its own blocks of the
    delta and enters the cross-process sync. `opt_states` holds one state
    per pod (only this process's pod's is used and replaced); the mean
    loss is averaged over the pods."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist import spmd
    mesh = sync.mesh
    names = mesh.mesh_dim_names
    nb, blk = params_blocked.shape
    full = params_blocked.redistribute(
        mesh, (Replicate(),) * mesh.ndim).to_local()
    pod = mesh.get_local_rank("pod") if "pod" in names else 0
    n_pods = residuals.shape[0]
    s_k, _, delta, losses = local_round(
        lm.loss, opt, full.reshape(-1)[:dim], spec, opt_states[pod],
        _steps({key: v[pod] for key, v in batches.items()}, k))
    padded = torch.zeros((1, nb * blk), dtype=torch.float32,
                         device=full.device)
    padded[0, :dim] = delta
    own = spmd.shard(padded.view(1, nb, blk), mesh,
                     [a for a in names if a != "pod"], 1)
    deltas = DTensor.from_local(own.contiguous(), mesh,
                                residuals.placements, run_check=False,
                                shape=tuple(residuals.shape),
                                stride=tuple(residuals.stride()))
    with annotate("pod.sync"):
        new_blocked, new_residuals = sync(params_blocked, deltas, residuals)
    new_states = list(opt_states)
    new_states[pod] = s_k
    loss = spmd.all_reduce(torch.stack(losses).mean(), mesh, ["pod"]) \
        / n_pods
    return new_blocked, new_states, new_residuals, loss


def _microbatches(batch: dict, n: int) -> list[dict]:
    """n equal microbatches of a batch dict along the batch dim. A
    DTensor leaf is split in its local shard (each rank's chunk i forms
    microbatch i): every microbatch holds B/n rows, so the accumulated
    mean is the full batch's, as in the reference's [n, B/n] split."""
    from torch.distributed.tensor import DTensor

    def split(t):
        if not isinstance(t, DTensor):
            if t.shape[0] % n:
                raise ValueError(f"batch {t.shape[0]} not divisible by "
                                 f"{n} microbatches")
            return t.chunk(n)
        loc = t.to_local()
        if loc.shape[0] % n:
            raise ValueError(f"local batch {loc.shape[0]} not divisible by "
                             f"{n} microbatches")
        shape = (t.shape[0] // n,) + tuple(t.shape[1:])
        return [DTensor.from_local(c, t.device_mesh, t.placements,
                                   run_check=False, shape=shape,
                                   stride=shl._contiguous_stride(shape))
                for c in loc.chunk(n)]

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _local_grads(loss, leaves) -> list[torch.Tensor]:
    """d loss / d leaf for every leaf, as local tensors in each leaf's
    own layout (a DTensor gradient left partial is summed first)."""
    from torch.distributed.tensor import DTensor
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    out = []
    for leaf, g in zip(leaves, grads):
        if isinstance(g, DTensor):
            if tuple(g.placements) != tuple(leaf.placements):
                g = g.redistribute(leaf.device_mesh, leaf.placements)
            g = g.to_local()
        out.append(g)
    return out


def make_train_step(lm, opt, *, microbatches: int = 1, pspec=None,
                    zero3_axes=None):
    """step(params, opt_state, batch) -> (params, opt_state, loss).

    `params` is a nested dict of tensors or of DTensors (`sharding.
    distribute`) whose local shards are views of one flat buffer; the
    step updates that buffer and `opt_state` in place and returns them.
    zero3_axes: mesh axes the params are additionally sharded over at
    rest; the step redistributes each param once up front to `pspec`
    with those axes stripped (the reference's `_strip_axes` +
    `with_sharding_constraint`), and the gradients return through it.
    microbatches: split the batch's leading dim into n chunks and
    accumulate loss and gradient in fp32 — the fp32 accumulator is the
    flat gradient buffer the optimizer reads."""
    if zero3_axes and pspec is None:
        raise ValueError("zero3_axes requires pspec")

    def step(params, opt_state, batch):
        flat = shl.flat_local(params)
        if flat is None:
            raise ValueError("make_train_step: the parameters must be views "
                             "of one flat buffer (sharding.distribute, "
                             "LM.init or params_from_jax lay them out so)")
        # gradient-tracking aliases of the parameters (same storage)
        run = shl._map(lambda _, t: t.detach().requires_grad_(True), params)
        leaves = [leaf for _, leaf in shl._with_paths(run)]
        if zero3_axes:
            spec_of = dict(shl._with_paths(pspec))

            def gather(path, t):
                spec = shl.strip_axes(spec_of[path], zero3_axes)
                return t.redistribute(t.device_mesh,
                                      shl.placements(spec, t.device_mesh))

            run = shl._map(gather, run)
        with annotate("train_step"):
            if microbatches <= 1:
                loss = lm.loss(run, batch)
                grad = torch.cat([g.reshape(-1)
                                  for g in _local_grads(loss, leaves)])
                loss = loss.detach()
            else:
                grad = torch.zeros(flat.numel(), dtype=torch.float32,
                                   device=flat.device)
                loss = torch.zeros((), dtype=torch.float32,
                                   device=flat.device)
                for mb in _microbatches(batch, microbatches):
                    l = lm.loss(run, mb)
                    pos = 0
                    for g in _local_grads(l, leaves):
                        n = g.numel()
                        grad[pos:pos + n].add_(g.reshape(-1))
                        pos += n
                    loss = loss + l.detach().to(torch.float32)
                    del l
                loss = loss / microbatches
                grad.div_(microbatches)
            _, opt_state = opt.update(grad, opt_state, flat)
        return params, opt_state, loss

    return step


def make_prefill_step(lm):
    """prefill(params, batch) -> (last-position logits [B,1,V], cache)."""
    def prefill(params, batch):
        with torch.no_grad():
            return lm.prefill(params, batch)
    return prefill


def make_decode_step(lm):
    """decode(params, cache, token [B,1], cur_index) -> (logits, cache).
    The cache may arrive sequence-sharded over `model`
    (`sharding.cache_specs`): the length-S attention reduction then runs
    flash-decoding style, one partial softmax per shard, and the cache is
    written in place, never gathered."""
    def decode(params, cache, token, cur_index: int):
        with torch.no_grad():
            return lm.decode_step(params, cache, token, cur_index)
    return decode
