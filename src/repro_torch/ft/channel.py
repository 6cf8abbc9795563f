"""Lossy uplink channel: packet loss, retry/backoff, bandwidth drift.

Models the device -> server upload path of the AFL simulator as an
unreliable channel. Three independent fault axes compose:

  * **Upload loss** — each transmission attempt is lost with probability
    `loss_prob` (a float, or a `{device_id: p}` dict for per-device
    links). The sender detects the loss after `RetryPolicy.timeout`
    seconds (exponential backoff per retry) and retransmits; every
    attempt is charged full upload time *and* full payload-shape wire
    bits, so the paper's Eq. 5 communication accounting stays honest
    under retries (`charge_wire` splits the overhead into `retx_bits`
    and `lost_bits` counters once the simulator knows the payload size).
    After `max_attempts` transmissions the update is dropped and the
    device gives up (it restarts a fresh local round on the current
    model).

  * **Bandwidth drift** — `BandwidthDrift` events multiply a device's β
    from `start` on (link congestion). Effective upload time of an
    attempt beginning at time s is `rate·β·beta_multiplier(device, s)`,
    so a retransmission that straddles a drift event pays the new price.
    Observed β feeds the FedLuck controller's drift-aware re-planner.

  * **Corruption** — with probability `corrupt_prob` a delivered payload
    arrives NaN-poisoned (bit flips in transit / a faulty sender). Only
    the aggregation-side sanitizer (`repro_torch.core.aggregation
    .UpdateSanitizer`) stands between a corrupted update and the global
    model — that interaction is exactly what the chaos tests exercise.

Determinism: every random draw comes from a per-device counter-based
stream seeded by (seed, device_id), and a device's cycles are totally
ordered in simulated time, so outcomes are independent of how the
simulator interleaves *other* devices' events. That is what keeps the
batched and sequential engines bitwise identical under channel faults.
A channel instance is stateful (streams + counters): build a fresh one
per run (or call `reset()`).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Timeout / exponential-backoff retransmission policy."""
    max_attempts: int = 4     # total transmissions, including the first
    timeout: float = 0.25     # seconds to detect a lost upload (base)
    backoff: float = 2.0      # timeout multiplier per successive retry

    def wait(self, attempt: int) -> float:
        """Detection + backoff wait after lost attempt #`attempt` (0-based)."""
        return self.timeout * self.backoff ** attempt


@dataclasses.dataclass(frozen=True)
class BandwidthDrift:
    """β multiplier applied to a device's link from `start` on."""
    device_id: int
    start: float
    beta_multiplier: float = 2.0


class LossyChannel:
    def __init__(self, *, loss_prob: float | dict = 0.0,
                 drift: list[BandwidthDrift] | None = None,
                 retry: RetryPolicy | None = None,
                 corrupt_prob: float | dict = 0.0, seed: int = 0):
        self.loss_prob = loss_prob
        self.corrupt_prob = corrupt_prob
        self.drift = sorted(drift or [], key=lambda d: d.start)
        self.retry = retry or RetryPolicy()
        self.seed = int(seed)
        # When a tracer is attached the simulator flips this on; `transmit`
        # then records each attempt's (start, end, lost) in `last_attempts`
        # so per-attempt retry spans can be emitted in simulated time. Off
        # by default — the hot path allocates nothing.
        self.trace_attempts = False
        self.last_attempts: list[tuple[float, float, bool]] = []
        self.reset()

    def reset(self) -> None:
        """Re-arm the per-device RNG streams and zero the counters."""
        self._streams: dict[int, np.random.RandomState] = {}
        self.counters = {"attempts": 0, "retries": 0, "delivered": 0,
                         "channel_dropped": 0, "corrupted": 0,
                         "retx_bits": 0.0, "lost_bits": 0.0}
        self.last_attempts = []

    # ------------------------------------------------------------- internals
    def _stream(self, device_id: int) -> np.random.RandomState:
        s = self._streams.get(device_id)
        if s is None:
            s = np.random.RandomState((self.seed * 1000003 + 977 * device_id
                                       + 12345) % (2 ** 31 - 1))
            self._streams[device_id] = s
        return s

    @staticmethod
    def _prob(p: float | dict, device_id: int) -> float:
        return float(p.get(device_id, 0.0)) if isinstance(p, dict) else float(p)

    # ------------------------------------------------------------------- api
    def beta_multiplier(self, device_id: int, t: float) -> float:
        """Product of all drift multipliers active for the device at t."""
        m = 1.0
        for d in self.drift:
            if d.start > t:
                break
            if d.device_id == device_id:
                m *= d.beta_multiplier
        return m

    def maybe_corrupt(self, device_id: int) -> bool:
        """Draw the per-cycle corruption coin (always first in the device's
        stream, before the transmission attempts, so draw order is fixed)."""
        p = self._prob(self.corrupt_prob, device_id)
        if p <= 0.0:
            return False
        hit = bool(self._stream(device_id).random_sample() < p)
        if hit:
            self.counters["corrupted"] += 1
        return hit

    def transmit(self, device_id: int, t_ready: float, base_upload: float
                 ) -> tuple[float | None, int, float]:
        """Simulate the retransmission loop for one upload.

        `base_upload` is the clean-link upload duration (rate·β seconds).
        Returns `(arrive_time, attempts, give_up_time)`: `arrive_time` is
        None when every attempt was lost, in which case `give_up_time` is
        when the sender stops retrying. All attempts consume simulated
        time; the caller charges `attempts ×` wire bits.
        """
        p = self._prob(self.loss_prob, device_id)
        trace = self.trace_attempts
        if trace:
            self.last_attempts = []
        s = t_ready
        for i in range(self.retry.max_attempts):
            dur = base_upload * self.beta_multiplier(device_id, s)
            self.counters["attempts"] += 1
            if i:
                self.counters["retries"] += 1
            lost = p > 0.0 and bool(
                self._stream(device_id).random_sample() < p)
            if trace:
                self.last_attempts.append((s, s + dur, lost))
            if not lost:
                self.counters["delivered"] += 1
                return s + dur, i + 1, s + dur
            s = s + dur + self.retry.wait(i)
        self.counters["channel_dropped"] += 1
        return None, self.retry.max_attempts, s

    def charge_wire(self, bits: float, attempts: int, delivered: bool
                    ) -> None:
        """Payload-shape wire accounting for one upload's transmissions.

        `transmit` resolves the retry schedule before the payload exists
        (it consumes only RNG streams); the simulator calls this once the
        payload size is known. Delivered uploads charge the retransmitted
        copies (attempts beyond the first) to `retx_bits`; uploads the
        channel dropped after max retries charge every attempt to
        `lost_bits`. Both engines call it at the same points, so the
        counters stay engine-identical."""
        if delivered:
            self.counters["retx_bits"] += float(bits) * (attempts - 1)
        else:
            self.counters["lost_bits"] += float(bits) * attempts
