"""Faults planted in the program under test, to show that the comparison
catches them (`portbench/calibrate.py`, `portbench/tests`). Each is a
callable that a driver applies to itself after building the program's
parts and before assembling the timed step; the benchmark's own runs
plant none.

  unchanged   every optimizer step returns its state unchanged (the
              momentum-SGD update is skipped)
  half_batch  the loss is the mean over the first half of each batch
  exchange    the exchange left out: the pod sync gets no delta from
              pods other than pod 0 (pod cells); the server's Eq. 6 takes
              only the first arrival of each aggregation, the mean over
              it alone (FL cells)
"""
from __future__ import annotations


def _wrap_loss(cell, fn):
    if hasattr(cell, "task"):                       # FL: the task's loss
        import dataclasses
        loss = cell.task.loss_fn
        cell.task = dataclasses.replace(
            cell.task, loss_fn=lambda p, b: fn(loss, p, b))
    else:                                           # pod: the LM's loss
        lm = cell.loss_of

        class Broken:
            def loss(self, p, b):
                return fn(lm.loss, p, b)
        cell.loss_of = Broken()


def unchanged(cell) -> None:
    from repro_torch.optim import optim
    update = optim.fused_momentum
    optim.fused_momentum = lambda w, mu, g, *, lr, momentum=0.9: (w, mu)
    cell.restores.append(lambda: setattr(optim, "fused_momentum", update))


def half_batch(cell) -> None:
    """Half of each batch's rows; of a one-row batch (the LM cells),
    half of its token positions."""
    def half(loss, p, b):
        n = next(iter(b.values())).shape[0]
        if n > 1:
            return loss(p, {k: v[:n // 2] for k, v in b.items()})
        return loss(p, {k: v[:, :v.shape[1] // 2] for k, v in b.items()})
    _wrap_loss(cell, half)


def exchange(cell) -> None:
    if hasattr(cell, "task"):                       # FL: the server
        cell.first_arrival_only = True
        return
    sync = cell.sync

    def alone(params, deltas, residuals):
        kept = deltas.clone()
        kept[1:] = 0.0
        return sync(params, kept, residuals)
    alone.path = sync.path
    alone.payload_bits_per_pod = sync.payload_bits_per_pod
    cell.sync = alone


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "exchange": exchange}
