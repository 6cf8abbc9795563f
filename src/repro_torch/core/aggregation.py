"""Server-side aggregation strategies (the paper's 4 baselines + FedLuck).

All strategies speak one protocol driven by the event simulator:

    on_arrival(t_now, arrival)  -> list[AggregationEvent]
    on_round_boundary(t_now)    -> list[AggregationEvent]

`Arrival` carries the compressed pseudo-gradient (flat fp32), the round tag
of the model it was computed against, and wire bits. An AggregationEvent
says "the global model changed; these devices should be handed the new
model now". Strategies mutate `GlobalModel` in place.

  PeriodicAggregator  — FedPer & FedLuck (Eq. 6, fixed round period T̃)
  BufferedAggregator  — FedBuff (aggregate every K arrivals)
  AsyncAggregator     — FedAsync (apply immediately, staleness-weighted)
  SyncAggregator      — FedAvg(+TopK) (barrier over all devices)

Every strategy optionally runs arrivals through an `UpdateSanitizer`
before admitting them (attach one via `_Base.sanitizer`): non-finite
payloads are rejected outright, over-norm updates are clipped, and
zombie updates past a staleness cap τ_max are dropped or down-weighted.
Wire bits are charged *before* sanitization — a rejected upload still
spent its bandwidth. Rejected devices are still released (a dropped
update must not deadlock its sender), and per-category drop counters
accumulate on the sanitizer for `History` surfacing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Union

import numpy as np


class SparseUpdate(NamedTuple):
    """Compact (values, indices) wire payload of a sparse pseudo-gradient —
    the same wire format the pod-sync compact path ships
    (dist.collectives): fixed-capacity value/index slots plus a kept-count
    header.

    The batched simulator engine pulls arrivals off-device in this form
    (k values + k int32 indices) instead of a dense d-length vector. Zero
    values are permitted (padding slots); indices must be unique so that
    scatter-add equals dense addition bitwise. `kept` is the header: the
    number of live (non-padding) slots, or None when the producer only
    knows it on device.
    """
    values: np.ndarray
    indices: np.ndarray
    dim: int
    kept: int | None = None

    def dense(self) -> np.ndarray:
        out = np.zeros((self.dim,), np.float32)
        np.add.at(out, self.indices, self.values)
        return out


Update = Union[np.ndarray, SparseUpdate]


def add_update(acc: np.ndarray, u: Update) -> None:
    """acc += u, scatter-adding sparse payloads (bitwise equal to the dense
    path: adding an explicit 0.0 never changes a float)."""
    if isinstance(u, SparseUpdate):
        np.add.at(acc, u.indices, u.values)
    else:
        acc += u


@dataclasses.dataclass
class Arrival:
    device_id: int
    update: Update           # dense (or compact sparse) compressed pseudo-grad
    model_round: int         # round tag the update was computed from
    wire_bits: float
    arrive_time: float


@dataclasses.dataclass
class AggregationEvent:
    time: float
    new_round: int
    release_to: list[int]    # device ids that receive the new global model
    staleness: dict[int, int]


class GlobalModel:
    """Flat fp32 global parameter vector + round counter."""

    def __init__(self, flat_params: np.ndarray, eta_g: float = 1.0):
        self.w = np.array(flat_params, dtype=np.float32, copy=True)
        self.eta_g = float(eta_g)
        self.round = 0

    def apply_mean(self, updates: list[Update], scale: float | None = None):
        """Eq. 6:  w ← w − η_g/|S| Σ g̃."""
        s = self.eta_g / len(updates) if scale is None else scale
        acc = np.zeros_like(self.w)
        for u in updates:
            add_update(acc, u)
        self.w -= s * acc
        self.round += 1


# ----------------------------------------------------------------- sanitizer
@dataclasses.dataclass
class SanitizerConfig:
    """Knobs for `UpdateSanitizer`.

    nonfinite_guard — reject updates containing NaN/Inf (corrupted wire
        payloads, diverged local training).
    clip_norm — L2 outlier guard: updates with ‖u‖₂ > clip_norm are
        rescaled to that norm (None disables). Note the norm is taken
        over the payload's stored values, so a sparse (values, indices)
        payload and its dense form can differ in the last float bit —
        keep clipping out of bitwise engine-equivalence comparisons.
    tau_max — staleness cap: arrivals with τ > tau_max are dropped
        (`stale_mode="drop"`) or scaled by 1/(1 + τ − τ_max)
        (`stale_mode="downweight"`). None disables.
    """
    nonfinite_guard: bool = True
    clip_norm: float | None = None
    tau_max: int | None = None
    stale_mode: str = "drop"          # drop | downweight


def _scaled(a: Arrival, w: float) -> Arrival:
    u = a.update
    if isinstance(u, SparseUpdate):
        u = SparseUpdate(u.values * np.float32(w), u.indices, u.dim, u.kept)
    else:
        u = u * np.float32(w)
    return dataclasses.replace(a, update=u)


class UpdateSanitizer:
    """Admission control for arrivals; counts what it rejects/reshapes."""

    def __init__(self, cfg: SanitizerConfig | None = None):
        self.cfg = cfg or SanitizerConfig()
        # sanitized_dropped counts outright rejections (a clipped or
        # down-weighted update is modified, not dropped)
        self.counts = {"sanitized_nonfinite": 0, "sanitized_stale": 0,
                       "sanitized_clipped": 0, "sanitized_dropped": 0}

    def admit(self, tau: int, a: Arrival) -> Arrival | None:
        """Admitted (possibly rescaled) arrival, or None when dropped."""
        cfg = self.cfg
        vals = a.update.values if isinstance(a.update, SparseUpdate) \
            else a.update
        if cfg.nonfinite_guard and not bool(np.all(np.isfinite(vals))):
            self.counts["sanitized_nonfinite"] += 1
            self.counts["sanitized_dropped"] += 1
            return None
        if cfg.tau_max is not None and tau > cfg.tau_max:
            self.counts["sanitized_stale"] += 1
            if cfg.stale_mode == "drop":
                self.counts["sanitized_dropped"] += 1
                return None
            a = _scaled(a, 1.0 / (1.0 + (tau - cfg.tau_max)))
            vals = a.update.values if isinstance(a.update, SparseUpdate) \
                else a.update
        if cfg.clip_norm is not None:
            nrm = float(np.linalg.norm(vals))
            if nrm > cfg.clip_norm:
                self.counts["sanitized_clipped"] += 1
                a = _scaled(a, cfg.clip_norm / nrm)
        return a


# --------------------------------------------------------------------- mixins
class _Base:
    def __init__(self, model: GlobalModel):
        self.model = model
        self.total_bits = 0.0
        self.staleness_log: list[int] = []
        self.sanitizer: UpdateSanitizer | None = None

    def _tau(self, a: Arrival) -> int:
        return max(0, self.model.round - a.model_round)

    def _admit(self, a: Arrival) -> Arrival | None:
        """Charge wire bits, then run the sanitizer (if any)."""
        self.total_bits += a.wire_bits
        if self.sanitizer is None:
            return a
        return self.sanitizer.admit(self._tau(a), a)

    def on_arrival(self, t_now: float, a: Arrival) -> list[AggregationEvent]:
        raise NotImplementedError

    def on_round_boundary(self, t_now: float) -> list[AggregationEvent]:
        return []


class PeriodicAggregator(_Base):
    """AFL with periodic aggregation (FedPer / FedLuck servers are identical;
    FedLuck differs only in the (k_i, δ_i) plans devices run with)."""

    def __init__(self, model: GlobalModel):
        super().__init__(model)
        self.buffer: list[Arrival] = []
        self.rejected: list[int] = []   # sanitizer-dropped senders to release

    def on_arrival(self, t_now, a):
        adm = self._admit(a)
        if adm is None:
            self.rejected.append(a.device_id)
            return []
        self.buffer.append(adm)
        return []

    def on_round_boundary(self, t_now):
        rejected, self.rejected = self.rejected, []
        if not self.buffer:
            self.model.round += 1  # empty round still advances the period
            return [AggregationEvent(t_now, self.model.round,
                                     sorted(set(rejected)), {})]
        # τ counts the round being FORMED: a device that trained on w^t and
        # lands in the aggregation producing w^{t+k} has τ = k = ⌈d_i/T̃⌉
        # (the equivalence the φ-solver relies on, paper Sec. 2.2).
        stale = {a.device_id: self._tau(a) + 1 for a in self.buffer}
        self.staleness_log.extend(stale.values())
        self.model.apply_mean([a.update for a in self.buffer])
        release = [a.device_id for a in self.buffer]
        release += sorted(set(rejected) - set(release))
        ev = AggregationEvent(t_now, self.model.round, release, stale)
        self.buffer = []
        return [ev]


class BufferedAggregator(_Base):
    """FedBuff: aggregate whenever `buffer_size` gradients are buffered."""

    def __init__(self, model: GlobalModel, buffer_size: int = 3):
        super().__init__(model)
        self.K = buffer_size
        self.buffer: list[Arrival] = []

    def on_arrival(self, t_now, a):
        adm = self._admit(a)
        if adm is None:
            return []   # simulator's buffered fallback restarts the sender
        self.buffer.append(adm)
        if len(self.buffer) < self.K:
            return []
        stale = {x.device_id: self._tau(x) for x in self.buffer}
        self.staleness_log.extend(stale.values())
        self.model.apply_mean([x.update for x in self.buffer])
        ev = AggregationEvent(t_now, self.model.round,
                              [x.device_id for x in self.buffer], stale)
        self.buffer = []
        return [ev]


class AsyncAggregator(_Base):
    """FedAsync: apply immediately with polynomial staleness weight
    s(τ) = (1+τ)^(-a)  (Xie et al. 2019)."""

    def __init__(self, model: GlobalModel, poly_a: float = 0.5,
                 mix_eta: float = 0.8):
        super().__init__(model)
        self.poly_a = poly_a
        self.mix_eta = mix_eta

    def on_arrival(self, t_now, a):
        a = self._admit(a)
        if a is None:
            return []   # simulator's buffered fallback restarts the sender
        tau = self._tau(a)
        self.staleness_log.append(tau)
        weight = self.mix_eta * (1.0 + tau) ** (-self.poly_a)
        if isinstance(a.update, SparseUpdate):
            np.subtract.at(self.model.w, a.update.indices,
                           (self.model.eta_g * weight) * a.update.values)
        else:
            self.model.w -= self.model.eta_g * weight * a.update
        self.model.round += 1
        return [AggregationEvent(t_now, self.model.round, [a.device_id],
                                 {a.device_id: tau})]


class SyncAggregator(_Base):
    """FedAvg(+TopK): barrier across all N devices; optional straggler
    deadline (ft: drop updates arriving > deadline after round start)."""

    def __init__(self, model: GlobalModel, num_devices: int,
                 deadline: float | None = None):
        super().__init__(model)
        self.N = num_devices
        self.deadline = deadline
        self.buffer: list[Arrival] = []
        self.rejected: list[int] = []
        self.round_start = 0.0
        self.expected: set[int] | None = None

    def begin_round(self, t_now: float, device_ids: list[int]):
        self.round_start = t_now
        self.expected = set(device_ids)

    def on_arrival(self, t_now, a):
        adm = self._admit(a)
        if adm is None:
            # sanitizer rejection: the update is dropped (bits were spent)
            # but the sender must still be released at the barrier or the
            # next round can never complete
            self.expected.discard(a.device_id)
            self.rejected.append(a.device_id)
        elif (self.deadline is not None
                and t_now - self.round_start > self.deadline):
            # straggler mitigation: too late, drop (bits were still spent)
            self.expected.discard(a.device_id)
        else:
            self.buffer.append(adm)
            self.expected.discard(a.device_id)
        if self.expected:
            return []
        stale = {x.device_id: self._tau(x) for x in self.buffer}
        self.staleness_log.extend(stale.values())
        if self.buffer:
            self.model.apply_mean([x.update for x in self.buffer])
        else:
            self.model.round += 1
        release = [x.device_id for x in self.buffer] + list(
            stale.keys() - {x.device_id for x in self.buffer})
        ev = AggregationEvent(t_now, self.model.round,
                              sorted({*release, *stale, *self.rejected}),
                              stale)
        self.buffer = []
        self.rejected = []
        return [ev]


def make_aggregator(name: str, model: GlobalModel, *, num_devices: int = 0,
                    **kw) -> _Base:
    name = name.lower()
    if name in ("periodic", "fedper", "fedluck"):
        return PeriodicAggregator(model)
    if name == "fedbuff":
        return BufferedAggregator(model, **kw)
    if name == "fedasync":
        return AsyncAggregator(model, **kw)
    if name in ("sync", "fedavg", "fedavg_topk"):
        return SyncAggregator(model, num_devices, **kw)
    raise ValueError(f"unknown aggregator {name}")
