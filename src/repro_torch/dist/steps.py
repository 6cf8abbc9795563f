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
buffer per step.

`make_train_step` and the prefill/decode builders are not ported: the
reference calls them only from its multi-device dry run; on one card
`LM.loss`, `LM.prefill` and `LM.decode_step` are called directly.
"""
from __future__ import annotations

import torch

from repro_torch.core import compression as C
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
            tree = C.unflatten_pytree(w, spec)
            leaves = [leaf for _, leaf in C._leaves(tree)]
            loss = loss_fn(tree, batch)
            # the gradient of each leaf view, concatenated in flat order:
            # through the views to `w`, autograd would zero-fill a [d]
            # gradient per leaf and sum them
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
    with annotate("batched_local_round"):
        w0 = flat.detach().to(torch.float32)
        rows = next(iter(batches[0].values())).shape[0]
        w = w0.repeat(rows, 1)          # a copy, also when rows == 1
        state = opt.init(w.view(-1))
        grad = batched_grad(loss_fn, spec)
        for batch in batches:
            _, state = opt.update(grad(w, batch).reshape(-1), state,
                                  w.view(-1))
        return w0 - w


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
                lm.loss, opt, flat, spec, opt_states[p],
                _steps(pod_batches, k))
            flat_deltas[p, :dim] = delta
            new_states.append(s_k)
            losses.append(torch.stack(pod_losses).mean())
        deltas = flat_deltas.view(n_pods, nb, blk)
        new_blocked, new_residuals = sync(params_blocked, deltas, residuals)
        return new_blocked, new_states, new_residuals, \
            torch.stack(losses).mean()

    step.wire_bits_per_pod = float(getattr(sync, "payload_bits_per_pod",
                                           0.0))
    return step
