"""Event-driven AFL simulator with a simulated wall clock (paper Sec 4.3).

PyTorch port of `repro.core.simulator`. Real training on a torch device,
simulated time: each device runs its k_i local momentum-SGD steps —
`fused_momentum` launches, in place on flat fp32 parameter buffers —
compresses the pseudo-gradient (Eq. 4) with its δ_i, and "uploads": the
upload lands on the simulated clock at  t + k_i·α_i + rate_i·β_i  (Eq. 5).
The server strategy decides when aggregation happens (periodic / buffered
/ async / sync) and the simulator hands fresh global models back to
devices.

Two engines share the same event semantics, as in the reference:

  engine="batched" (default) — start events that no aggregation can
  separate are drained from the heap together, grouped into plan-time
  buckets (same local k / compressor / top-k band / error feedback), split
  into exact power-of-two chunks, and each chunk runs as ONE local round
  over a stacked [B, d] parameter buffer (`dist.steps.
  batched_local_round`: `vmap(grad)` gradients and one `fused_momentum`
  launch per step for the whole chunk; a one-row chunk runs the
  sequential engine's `dist.steps.local_round`). Compression runs per
  row; EF residuals live in one [N+1, d] device stack whose chunk rows
  are gathered and written back in place (`index_copy_`), and sparse
  payloads come off the device as one compact (values, indices) pull per
  chunk. Mixed δ_i within a top-k band use `compression.topk_capped`.
  On a CUDA device each chunk shape's local round runs eagerly once,
  then replays as one CUDA graph (`_ChunkGraph`) over a drain-long arena
  of static tensors (`_Arena`).
  For a model without convolutions the engine is bitwise equal to the
  sequential one on the CPU. A vmapped convolution is a grouped one and
  rounds differently; where a max-pool window's two largest inputs are
  closer than that rounding, the engines route the window's gradient to
  different inputs (`launch.grad_accuracy` counts them), so for a CNN
  only the host-side results stay identical.

  engine="sequential" — one Python cycle per start event, one dense host
  pull per arrival, EF residuals kept on the device per device id.

The reference's engines are bitwise equal to each other, so the port's
event timeline, staleness, wire bits and fault counters are identical to
either of them, and the `engine.*` metrics are those of the reference's
engine of the same name.

Everything host-side is the reference's code: the event heap and its
drain, the fault models (crash windows, lossy channel with retries,
drift, corruption), the sanitizer, controller re-plans, the three
`wire_accounting` modes (payload / strict / analytic) and the tracer,
metrics and timer seams. The host RNG is consumed in the reference's
order — one `self.rng.randint` per cycle even when the compressor ignores
the key — so the same seed gives the same timeline.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import compression as C
from repro_torch.core.aggregation import (Arrival, GlobalModel,
                                          PeriodicAggregator, SanitizerConfig,
                                          SparseUpdate, SyncAggregator,
                                          UpdateSanitizer, make_aggregator)
from repro_torch.core import factor
from repro_torch.core.controller import DeviceProfile, FedLuckController
from repro_torch.core.factor import Plan
from repro_torch.dist.steps import (batched_local_round, capture_graph,
                                    local_round)
from repro_torch.kernels import ops
from repro_torch.obs.metrics import STALENESS_BUCKETS
from repro_torch.obs.profiling import PhaseTimers, annotate
from repro_torch.obs.trace import CONTROLLER_TRACK, SERVER_TRACK, device_track
from repro_torch.optim import momentum_sgd

# fixed metric bucket grids (no Date/random in hot paths — pure constants)
_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
_DENSITY_BUCKETS = (0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0)


# ----------------------------------------------------------------------- task
@dataclasses.dataclass
class TrainTask:
    """A trainable model + data, in plain-function form. Parameters are one
    flat fp32 vector; `spec` maps it to the model's nested dict of views
    (`compression.unflatten_pytree`)."""
    name: str
    init_fn: Callable[[torch.Generator], torch.Tensor]  # gen -> flat [d]
    loss_fn: Callable[[Any, dict], torch.Tensor]     # (params, batch) -> scalar
    acc_fn: Callable[[Any, dict], torch.Tensor]      # (params, batch) -> scalar
    dataset: Any                                     # train split (numpy)
    test_batch: dict                                 # held-out eval batch
    spec: list                                       # [(path, shape)]
    batch_size: int = 64

    @property
    def dim(self) -> int:
        return int(sum(int(np.prod(s)) if s else 1 for _, s in self.spec))


@dataclasses.dataclass
class DeviceSpec:
    """Static per-device simulation knobs."""
    profile: DeviceProfile
    plan: Plan
    compressor: str = "topk"      # topk | randk | qsgd | signsgd | none
    error_feedback: bool = False
    compressor_kwargs: dict = dataclasses.field(default_factory=dict)

    @property
    def rate(self) -> float:
        """Effective wire rate (fraction of a full fp32 gradient)."""
        if self.compressor in ("topk", "topk_threshold", "randk"):
            return self.plan.delta
        if self.compressor == "qsgd":
            # (log2(levels) + sign) bits per coordinate over fp32
            levels = int(self.compressor_kwargs.get("levels", 256))
            return (math.log2(levels) + 1.0) / 32.0
        if self.compressor == "signsgd":
            return 1.0 / 32.0
        return 1.0

    def _ckw_key(self) -> tuple:
        return tuple(sorted(self.compressor_kwargs.items()))


@dataclasses.dataclass
class Record:
    time: float
    round: int
    accuracy: float
    loss: float
    gbits: float
    mean_staleness: float
    drops: int = 0      # cumulative lost/dropped/sanitized updates so far
    # per-eval-window fault deltas: {counter: change since the previous
    # eval}, zero entries omitted — makes drops/retries/re-plans
    # attributable to a window (`drops` above stays cumulative for
    # back-compat). With metrics attached, also carries the window's
    # staleness bucket counts under "staleness_counts".
    window: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class History:
    records: list[Record] = dataclasses.field(default_factory=list)
    # final fault/resilience counters (crash losses, channel retries/drops,
    # sanitizer rejections, controller re-plans) — see
    # AFLSimulator.fault_counters
    counters: dict = dataclasses.field(default_factory=dict)

    def time_to_accuracy(self, target: float) -> float | None:
        for r in self.records:
            if r.accuracy >= target:
                return r.time
        return None

    def bits_to_accuracy(self, target: float) -> float | None:
        for r in self.records:
            if r.accuracy >= target:
                return r.gbits
        return None

    def final_accuracy(self, window: int = 3) -> float:
        if not self.records:
            return 0.0
        return float(np.mean([r.accuracy for r in self.records[-window:]]))


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


# Largest chunk a bucket dispatches at once. Chunks are exact binary
# decompositions of the bucket occupancy (10 -> 8+2), so no row is ever a
# padded duplicate, and each bucket meets at most log2(cap)+1 chunk shapes
# over a whole run.
_CHUNK_CAP = 16


def _chunk_sizes(n: int, cap: int = _CHUNK_CAP) -> list[int]:
    out, size = [], cap
    while n:
        while size > n:
            size >>= 1
        reps, n = divmod(n, size)
        out.extend([size] * reps)
    return out


# Compressors whose payload carries explicit indices → compact wire pull.
# Shared with the wire-bit accounting (compression.sparse_wire) so the
# charged shape and the shipped shape agree.
_SPARSE_WIRE = C.SPARSE_WIRE


def _device_array(v) -> np.ndarray:
    """A host array as the device holds it: floating arrays as float32, as
    JAX (x64 off) makes them; the synthetic images may be float64."""
    v = np.asarray(v)
    if np.issubdtype(v.dtype, np.floating):
        v = v.astype(np.float32)
    return v


class _Arena:
    """The chunk graphs' static tensors for one drain, in a memory pool of
    their own: the global model `w0` [d], one flat input buffer per batch
    key, room for `rows` device-steps of `batch` samples shaped as in
    `host` (one device's [k, batch, ...] arrays), and the graphs' output
    `out` [P, d]. A chunk's batches are staged into the inputs' leading
    elements and its graph writes its g = w0 − wk into `out[:B]`, so
    each chunk shape finds its tensors at the same addresses in every
    drain while the sizes stay the same. A drain never holds an
    aggregation or an evaluation, so the arena lives from its drain's
    start to its end; allocated again in the same order from the same
    pool, it gets the same addresses."""

    def __init__(self, pool, dim: int, rows: int, batch: int, P: int,
                 host: dict, device):
        with torch.cuda.use_mem_pool(pool):
            self.w0 = torch.empty(dim, dtype=torch.float32, device=device)
            self.inputs = {
                key: torch.empty(rows * batch * math.prod(v.shape[2:]),
                                 device=device, dtype=torch.from_numpy(
                                     _device_array(v[:0])).dtype)
                for key, v in sorted(host.items())}
            self.out = torch.empty((P, dim), dtype=torch.float32,
                                   device=device)

    def stage(self, host: dict) -> dict:
        """Host [k, B, ...] arrays -> views of the inputs, copied in."""
        out = {}
        for key, v in host.items():
            out[key] = self.inputs[key][:v.size].view(v.shape)
            out[key].copy_(torch.as_tensor(_device_array(v)))
        return out


class _ChunkGraph:
    """A chunk shape's local round, `round_fn(flat, steps) -> g [B, d]`,
    replayed as one CUDA graph: a `_bucket_fn` cache entry's on a CUDA
    device. Its first use runs eagerly, which is also the warm-up that
    capture needs; the second captures `round_fn` over that use's tensors
    (the drain's arena) and replays; later uses replay, and capture
    again where the tensors moved. `out()` gives the [B, d] view the
    graph writes g to. Nothing in the graph reads a number back to the
    host, and its temporaries live in the shared graph pool `pool` only
    while it runs, so graphs may replay in any order."""

    def __init__(self, round_fn: Callable, out: Callable, pool, metrics):
        self.round_fn, self.out, self.pool = round_fn, out, pool
        self.metrics = metrics
        self.uses, self.graph, self.ptrs = 0, None, None

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc()

    def __call__(self, flat: torch.Tensor, steps: list[dict]
                 ) -> torch.Tensor:
        self.uses += 1
        if self.uses == 1:
            return self.round_fn(flat, steps)
        out = self.out()
        ptrs = (flat.data_ptr(), out.data_ptr(),
                *(v.data_ptr() for step in steps for v in step.values()))
        if self.graph is None or ptrs != self.ptrs:
            self.graph = capture_graph(
                lambda: out.copy_(self.round_fn(flat, steps)), self.pool)
            self.ptrs = ptrs
            self._count("engine.graph_captures")
        with annotate("local_round"):
            self.graph.replay()
        self._count("engine.graph_replays")
        return out


# ------------------------------------------------------------------ simulator
class AFLSimulator:
    def __init__(self, task: TrainTask, devices: list[DeviceSpec],
                 strategy: str = "periodic", *, round_period: float = 1.0,
                 eta_l: float = 0.05, eta_g: float = 1.0,
                 momentum: float = 0.9, seed: int = 0,
                 client_indices: list[np.ndarray] | None = None,
                 failure_schedule=None, channel=None, stragglers=None,
                 controller: FedLuckController | None = None,
                 sanitizer=None, count_index_bits: bool = False,
                 wire_accounting: str = "payload",
                 strategy_kwargs: dict | None = None,
                 engine: str = "batched", prefetch: int = 0, tracer=None,
                 metrics=None, timers=None,
                 device: str | torch.device = "cuda"):
        if engine not in ("batched", "sequential"):
            raise ValueError(f"unknown engine {engine}")
        if wire_accounting not in ("payload", "strict", "analytic"):
            raise ValueError(f"unknown wire_accounting {wire_accounting!r}")
        self.device = resolve_device(device)
        self.task = task
        self.devices = {d.profile.device_id: d for d in devices}
        self.round_period = float(round_period)
        self.eta_l, self.eta_g, self.momentum = eta_l, eta_g, momentum
        # ---- fault models (all optional): see repro.core.simulator
        self.failure_schedule = failure_schedule
        self.channel = channel
        self._stragglers = list(stragglers or [])
        self.controller = controller
        self._crash_lost = 0
        # ---- observability, all optional and host-side only; emission
        # happens at the reference's seams, so both packages record the
        # same event lists on the same run
        self._tracer = tracer
        self._metrics = metrics
        self._timers = timers if timers is not None else (
            PhaseTimers() if metrics is not None else None)
        self._last_counters: dict = {}
        if tracer is not None and channel is not None:
            channel.trace_attempts = True
        self.count_index_bits = count_index_bits
        self._wire_mode = "strict" if count_index_bits else wire_accounting
        self.strategy_name = strategy
        self.rng = np.random.RandomState(seed)
        self.engine = engine
        self._batched = engine == "batched"
        self.events_processed = 0

        # ---- params / flat spec
        flat = task.init_fn(torch.Generator().manual_seed(seed))
        self.spec = task.spec
        self.dim = int(flat.shape[0])
        if self.dim != task.dim:
            raise ValueError(f"init_fn gave {self.dim} parameters, the "
                             f"task's spec has {task.dim}")
        self.model = GlobalModel(
            flat.detach().to("cpu", torch.float32).numpy(), eta_g=eta_g)
        skw = dict(strategy_kwargs or {})
        if strategy in ("sync", "fedavg", "fedavg_topk"):
            skw.setdefault("num_devices", len(devices))
        self.agg = make_aggregator(strategy, self.model, **skw)
        if sanitizer is not None:
            if isinstance(sanitizer, SanitizerConfig):
                sanitizer = UpdateSanitizer(sanitizer)
            self.agg.sanitizer = sanitizer

        # ---- per-client data (numpy streams, seeded as in the reference)
        from repro_torch.data.pipeline import DataLoader, StackedLoader
        n = len(task.dataset)
        if client_indices is None:
            from repro_torch.data.partition import iid_partition
            client_indices = iid_partition(n, len(devices), seed=seed)
        self.loaders = {
            did: DataLoader(task.dataset, idx, batch_size=task.batch_size,
                            seed=seed + 17 * did)
            for did, idx in zip(sorted(self.devices), client_indices)}

        # ---- device id <-> residual-stack row (row N is a spare row, as
        # in the reference)
        self._dids = sorted(self.devices)
        self._rowof = {did: i for i, did in enumerate(self._dids)}
        self._has_ef = any(s.error_feedback for s in devices)

        # ---- EF residuals: one [N+1, d] device stack (batched) or one
        # device tensor per device id (sequential). prefetch > 0 draws
        # per-step batches ahead on a thread; the draws, re-plans included,
        # are those of prefetch=0 (data.pipeline.StackedLoader)
        self._res_stack: torch.Tensor | None = None
        self._residuals: dict[int, torch.Tensor] = {}
        self._stacked = {}
        if self._batched:
            if self._has_ef:
                self._res_stack = torch.zeros(
                    (len(self._dids) + 1, self.dim), dtype=torch.float32,
                    device=self.device)
            self._stacked = {
                did: StackedLoader(self.loaders[did],
                                   self.devices[did].plan.k, prefetch)
                for did in self._dids}
            self._plan_buckets()
        else:
            self._residuals = {
                did: torch.zeros((self.dim,), dtype=torch.float32,
                                 device=self.device)
                for did in self._dids}
        self._compress_fns: dict[tuple, C.Compressor] = {}
        self._bucket_fns: dict[tuple, Callable] = {}
        # on a CUDA device the chunks' local rounds replay as CUDA graphs
        # (`_ChunkGraph`): the graphs' shared memory pool, and the pool of
        # the drain-long arena they read and write (`_Arena`)
        self._graph_pool = self._arena_pool = self._arena = None
        if self._batched and self.device.type == "cuda":
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._arena_pool = torch.cuda.MemPool()
        self._test_batch = self._to_device(task.test_batch)
        self._stal_ptr = 0   # staleness_log watermark for per-eval windows

    def close(self) -> None:
        """Stop prefetch threads (safe to call more than once)."""
        for sl in self._stacked.values():
            sl.close()

    def _phase(self, name: str):
        """The phase `name`: the span "sim.<name>", timed into the
        `PhaseTimers` under `name` when the simulator has them."""
        return annotate("sim." + name, self._timers, name)

    def _trace_down(self, did: int, t: float, recovery: float) -> None:
        """Device found down at cycle start: its outage window as a span."""
        tr = self._tracer
        if tr is not None:
            tr.span(device_track(did), "down", t, recovery)
        if self._metrics is not None:
            self._metrics.counter("sim.down_starts").inc()

    def _trace_agg_events(self, events) -> None:
        tr, m = self._tracer, self._metrics
        for ev in events:
            if tr is not None:
                tr.instant(SERVER_TRACK, "aggregate", ev.time,
                           round=ev.new_round, released=len(ev.release_to))
            if m is not None:
                m.counter("sim.aggregations").inc()

    def _trace_cycle(self, did: int, t: float, compute_end: float,
                     arrive, restart_at, attempts: int, corrupt: bool,
                     crashed: bool, give_up) -> None:
        """Spans/instants for one device cycle resolved by
        `_schedule_upload` — called at heap-pop time, as in the reference,
        so event order matches the reference's pop order exactly."""
        tr = self._tracer
        spec = self.devices[did]
        track = device_track(did)
        tr.span(track, "local_round", t, compute_end,
                k=spec.plan.k, delta=spec.plan.delta)
        if self.channel is not None and self.channel.trace_attempts:
            for i, (s0, s1, lost) in enumerate(self.channel.last_attempts):
                tr.span(track, "upload_retry" if i else "upload", s0, s1,
                        attempt=i, lost=lost)
        elif arrive is not None:
            tr.span(track, "upload", compute_end, arrive)
        if crashed:
            end = arrive if arrive is not None else give_up
            tr.instant(track, "crash_lost", min(end, restart_at),
                       restart=restart_at)
        elif arrive is None:
            tr.instant(track, "channel_dropped", give_up, attempts=attempts)
        elif corrupt:
            tr.instant(track, "corrupted", arrive)

    # ---------------------------------------------------------- device compute
    def _to_device(self, batch: dict) -> dict:
        """Host batch -> device tensors (`_device_array`)."""
        return {k: torch.as_tensor(_device_array(v)).to(self.device)
                for k, v in batch.items()}

    def _local_round(self, flat: torch.Tensor, batches: list[dict]
                     ) -> torch.Tensor:
        """flat params + k batches -> pseudo-gradient g = w0 − wk (Eq. 4):
        `dist.steps.local_round` with momentum-SGD whose mu starts at zero
        every cycle, so each step is one in-place `fused_momentum`
        launch."""
        opt = momentum_sgd(self.eta_l, self.momentum)
        _, _, g, _ = local_round(self.task.loss_fn, opt, flat, self.spec,
                                 opt.init(flat), batches)
        return g

    def _compressor_fn(self, spec_d: DeviceSpec) -> C.Compressor:
        key = (spec_d.compressor, float(spec_d.plan.delta),
               spec_d.error_feedback, spec_d._ckw_key())
        comp = self._compress_fns.get(key)
        if comp is None:
            if self._metrics is not None:
                self._metrics.counter("engine.compressor_compiles").inc()
            comp = self._compress_fns[key] = C.make_compressor(
                spec_d.compressor, spec_d.plan.delta,
                **spec_d.compressor_kwargs)
        return comp

    def _device_compute(self, did: int) -> tuple[np.ndarray, float]:
        """One local round + compression against the current global model.
        Always runs — even when the upload is already known to be lost —
        so the loader, host RNG, and EF residual advance exactly as in the
        reference."""
        spec = self.devices[did]
        k = spec.plan.k
        loader = self.loaders[did]
        with annotate("sim.stage"):
            batches = [self._to_device(loader.next()) for _ in range(k)]
            flat = torch.tensor(self.model.w, device=self.device)
        g = self._local_round(flat, batches)

        seed = self.rng.randint(0, 2 ** 31 - 1)   # consumed every cycle
        comp = self._compressor_fn(spec)
        gen = (torch.Generator(device=self.device).manual_seed(int(seed))
               if comp.needs_key else None)
        with annotate("sim.compress"):
            if spec.error_feedback:
                cc, self._residuals[did] = C.ef_compress(
                    comp, g, self._residuals[did], gen)
            else:
                cc = comp(g, gen)
            dense = cc.dense().to("cpu").numpy()
        return dense, cc.wire_bits

    # -------------------------------------------------- batched bucket engine
    def _bucket_key(self, s: DeviceSpec) -> tuple:
        """Plan-time bucket id. `topk` buckets by local k and a power-of-two
        band over k_i = δ_i·d (mixed δ_i within a band share one chunk
        through a per-row k under the band's cap); δ_i = 1 devices get a
        dedicated "full" band whose payload is the accumulator itself — no
        sort at all. Other compressors need one δ per bucket, so δ joins
        the key."""
        if s.compressor == "topk":
            keep = C.num_keep(self.dim, s.plan.delta)
            band = "full" if keep >= self.dim else _next_pow2(keep)
            return (s.plan.k, "topk", band, s.error_feedback, s._ckw_key())
        return (s.plan.k, s.compressor, float(s.plan.delta),
                s.error_feedback, s._ckw_key())

    def _plan_buckets(self) -> None:
        members: dict[tuple, list[int]] = {}
        for did in self._dids:
            members.setdefault(self._bucket_key(self.devices[did]),
                               []).append(did)
        self._bucket_kcap = {}
        # the arena's sizes (`_Arena`): the most per-step rows (k·B) and
        # devices (B) of any chunk the plan can form
        self._arena_rows = self._arena_P = 0
        for bkey, dids in members.items():
            if bkey[1] == "topk" and bkey[2] != "full":
                self._bucket_kcap[bkey] = max(
                    C.num_keep(self.dim, self.devices[d].plan.delta)
                    for d in dids)
            P = _chunk_sizes(len(dids))[0]
            self._arena_rows = max(self._arena_rows, bkey[0] * P)
            self._arena_P = max(self._arena_P, P)

    @staticmethod
    def _bucket_sparse(bkey: tuple) -> bool:
        """True when the bucket's payload is a (values, indices) pair.
        The full-rate topk band ships dense: its payload IS the
        pseudo-gradient, and an index vector would be a d-length iota."""
        return bkey[1] in _SPARSE_WIRE and bkey[2] != "full"

    def _bucket_fn(self, bkey: tuple, P: int) -> Callable:
        """The computation of a chunk of P same-bucket cycles:
        chunk(flat, res_rows | None, steps, seeds, krows) -> (payload,
        new_res_rows | None, [strict bits]). Cached per (bucket, P, k-cap)
        like the reference's jit cache, and each miss counts as
        `engine.bucket_compiles`: a re-plan can change which δ_i share a
        band, and a chunk built for the old (smaller) cap would truncate
        the new bucket's selection. On a CUDA device the entry's local
        round is a `_ChunkGraph`."""
        cache_key = (bkey, P, self._bucket_kcap.get(bkey))
        if cache_key in self._bucket_fns:
            return self._bucket_fns[cache_key]
        if self._metrics is not None:   # a new (bucket, chunk-shape) entry
            self._metrics.counter("engine.bucket_compiles").inc()
        _, name, delta, ef, ckw = bkey
        dim, dev, spec = self.dim, self.device, self.spec
        sparse = self._bucket_sparse(bkey)
        needs_key = False

        if name == "topk_threshold":
            # the kernel path, as the sequential engine runs it: two
            # magnitude_hist launches and one ef_topk launch over g + res,
            # which also writes the new residual
            kw, kcap = dict(ckw), C.num_keep(dim, delta)

            def row(g, res, gen, krow):
                cc, new_res = C.topk_threshold_ef(
                    g, torch.zeros_like(g) if res is None else res, delta,
                    **kw)
                return ops.compact_topk(cc.values, kcap), new_res, \
                    cc.wire_bits
        else:
            if name == "topk" and delta == "full":
                # top-d of d is the identity: ship the accumulator itself
                def compress(acc, gen, krow):
                    return acc, acc, C._f32(krow * 64.0)
            elif name == "topk":
                kcap = self._bucket_kcap[bkey]

                def compress(acc, gen, krow):
                    cc = C.topk_capped(acc, krow, k_cap=kcap)
                    return (cc.values, cc.indices), cc.dense(), cc.wire_bits
            else:
                comp = C.make_compressor(name, delta, **dict(ckw))
                needs_key = comp.needs_key

                def compress(acc, gen, krow):
                    cc = comp(acc, gen)
                    dense = cc.dense()
                    payload = (cc.values, cc.indices) if sparse else dense
                    return payload, dense, cc.wire_bits

            def row(g, res, gen, krow):
                acc = g if res is None else g + res   # ef_compress, inlined
                payload, dense, bits = compress(acc, gen, krow)
                return payload, None if res is None else acc - dense, bits

        def local(flat, steps):
            if P == 1:
                # one row batches nothing: the sequential engine's
                # autograd round, without vmap's host cost
                return self._local_round(
                    flat, [{key: v[0] for key, v in step.items()}
                           for step in steps])[None]
            return batched_local_round(
                self.task.loss_fn, momentum_sgd(self.eta_l, self.momentum),
                flat, spec, steps)

        if self._graph_pool is not None:
            local = _ChunkGraph(local, lambda: self._arena.out[:P],
                                self._graph_pool, self._metrics)

        def chunk(flat, res_rows, steps, seeds, krows):
            g = local(flat, steps)
            payloads, new_rows, bits = [], [], []
            with annotate("sim.compress"):
                for i in range(P):
                    gen = (torch.Generator(device=dev).manual_seed(
                        int(seeds[i])) if needs_key else None)
                    payload, new_res, b = row(
                        g[i], None if res_rows is None else res_rows[i],
                        gen, krows[i])
                    payloads.append(payload)
                    new_rows.append(new_res)
                    bits.append(b)
                if sparse:
                    payload = (torch.stack([p[0] for p in payloads]),
                               torch.stack([p[1] for p in payloads]))
                else:
                    payload = torch.stack(payloads)
                return payload, torch.stack(new_rows) if ef else None, bits

        self._bucket_fns[cache_key] = chunk
        return chunk

    # ------------------------------------------------------------- residual IO
    def residual_snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        """(device_ids, stacked [N, d] residuals) — checkpoint payload."""
        ids = np.asarray(self._dids, np.int64)
        if self._batched:
            if self._res_stack is None:
                stack = np.zeros((len(self._dids), self.dim), np.float32)
            else:
                stack = self._res_stack[:len(self._dids)].to(
                    "cpu", copy=True).numpy()
        else:
            stack = (torch.stack([self._residuals[d] for d in self._dids])
                     .to("cpu").numpy() if self._dids
                     else np.zeros((0, self.dim), np.float32))
        return ids, stack

    def load_residuals(self, ids: np.ndarray, stacked: np.ndarray) -> None:
        """Restore per-device EF residuals from a checkpoint payload."""
        if self._batched:
            if self._res_stack is None:
                self._res_stack = torch.zeros(
                    (len(self._dids) + 1, self.dim), dtype=torch.float32,
                    device=self.device)
            rows = torch.as_tensor([self._rowof[int(d)] for d in ids],
                                   dtype=torch.long, device=self.device)
            self._res_stack.index_copy_(0, rows, torch.as_tensor(
                np.asarray(stacked, np.float32)).to(self.device))
        else:
            for i, did in enumerate(np.asarray(ids).tolist()):
                self._residuals[int(did)] = torch.as_tensor(
                    np.asarray(stacked[i], np.float32)).to(self.device)

    def _alpha_mult(self, did: int, t: float) -> float:
        """Straggler-drift α multiplier active for a device at time t."""
        m = 1.0
        for s in self._stragglers:
            if s.device_id == did and s.start <= t:
                m *= s.alpha_multiplier
        return m

    def _cycle_span(self, did: int, t: float | None = None) -> float:
        spec = self.devices[did]
        a = spec.profile.alpha
        if t is not None:
            m = self._alpha_mult(did, t)
            if m != 1.0:
                a = a * m
        return spec.plan.k * a + spec.rate * spec.profile.beta

    # ----------------------------------------------------- fault-model helpers
    def _maybe_replan(self, did: int, t: float) -> None:
        """Feed observed α/β into the controller; apply a drift-triggered
        re-plan to the device (new k/δ; batched loader and buckets
        rebuilt). Called at cycle start in both engines, as in the
        reference, so the event timelines stay identical."""
        if self.controller is None:
            return
        spec = self.devices[did]
        beta_m = (self.channel.beta_multiplier(did, t)
                  if self.channel is not None else 1.0)
        obs = DeviceProfile(did, spec.profile.alpha * self._alpha_mult(did, t),
                            spec.profile.beta * beta_m,
                            spec.profile.bandwidth_bps)
        plan = self.controller.update_profile(obs)
        if plan.k == spec.plan.k and plan.delta == spec.plan.delta:
            return
        if self._tracer is not None:
            self._tracer.instant(CONTROLLER_TRACK, "replan", t, device=did,
                                 k_old=spec.plan.k, k_new=plan.k,
                                 delta_old=spec.plan.delta,
                                 delta_new=plan.delta)
        if self._metrics is not None:
            self._metrics.counter("sim.replans").inc()
        spec.plan = plan
        if self._batched:
            # the stacked loader's queue holds per-step batches, so the new
            # k applies from the next round with no prefetched data wasted
            self._stacked[did].set_k(plan.k)
            self._plan_buckets()

    def _schedule_upload(self, did: int, t: float
                         ) -> tuple[float | None, float | None, int, bool,
                                    bool | None]:
        """Host-side outcome of the cycle a device starts at time t:
        `(arrive_time, restart_at, attempts, corrupt, ch_delivered)`.
        `arrive_time` is None when the upload never lands (crash mid-flight
        or channel gave up after max retries) — then `restart_at` says when
        the device begins a fresh cycle. `ch_delivered` is the channel-level
        outcome (None without a channel) — the payload-bit charge for
        retransmitted/dropped attempts (`LossyChannel.charge_wire`) keys off
        it once the payload size is known. Consumes only the channel's
        per-device RNG stream, so it is computable at heap-pop time before
        any compute is dispatched."""
        spec = self.devices[did]
        corrupt = False
        ch_delivered = None
        compute_end = t + spec.plan.k * spec.profile.alpha \
            * self._alpha_mult(did, t)
        if self.channel is not None:
            corrupt = self.channel.maybe_corrupt(did)
            arrive, attempts, give_up = self.channel.transmit(
                did, compute_end, spec.rate * spec.profile.beta)
            ch_delivered = arrive is not None
        else:
            arrive, attempts, give_up = t + self._cycle_span(did, t), 1, None
        in_flight_end = arrive if arrive is not None else give_up
        crashed, restart_at = False, None
        if self.failure_schedule is not None:
            rec = self.failure_schedule.crash_recovery(did, t, in_flight_end)
            if rec is not None:   # an outage opened mid-flight: upload lost
                self._crash_lost += 1
                crashed, restart_at = True, max(rec, t + 1e-9)
        if not crashed and arrive is None:
            restart_at = give_up
        m = self._metrics
        if m is not None:
            m.counter("sim.cycles").inc()
            m.counter("sim.upload_attempts").inc(attempts)
            m.histogram("sim.local_k", _SIZE_BUCKETS).observe(spec.plan.k)
            m.histogram("sim.compression_density",
                        _DENSITY_BUCKETS).observe(spec.plan.delta)
        if self._tracer is not None:
            self._trace_cycle(did, t, compute_end, arrive, restart_at,
                              attempts, corrupt, crashed, give_up)
        if crashed or arrive is None:
            return None, restart_at, attempts, corrupt, ch_delivered
        return arrive, None, attempts, corrupt, ch_delivered

    @staticmethod
    def _poison(update):
        """Corrupted-in-transit payload: every shipped value becomes NaN.
        Only an aggregation-side sanitizer keeps this out of the model."""
        if isinstance(update, SparseUpdate):
            return SparseUpdate(np.full_like(update.values, np.nan),
                                update.indices, update.dim, update.kept)
        return np.full_like(np.asarray(update), np.nan)

    def fault_counters(self) -> dict:
        """Resilience telemetry: crash losses, channel attempt/retry/drop/
        corruption counts, sanitizer rejections, controller re-plans, plus
        the cross-category `drops_total` that `Record.drops` snapshots."""
        c = {"crash_lost": self._crash_lost}
        if self.channel is not None:
            c.update(self.channel.counters)
        san = getattr(self.agg, "sanitizer", None)
        if san is not None:
            c.update(san.counts)
        if self.controller is not None:
            c["replans"] = self.controller.replans
        c["drops_total"] = int(c["crash_lost"] + c.get("channel_dropped", 0)
                               + c.get("sanitized_dropped", 0))
        return c

    def _wire_bits(self, did: int, strict_bits) -> float:
        """Bits charged for one upload. "payload" (default) charges the
        compact wire shape — strict value/index bits plus the kept-count
        header when the payload ships sparse (the static rule the reference
        applies, so wire bits stay identical); "strict" drops the
        header; "analytic" is the paper's rate·d·32 estimate."""
        spec = self.devices[did]
        if self._wire_mode == "analytic":
            bits = spec.rate * self.dim * 32.0
            if self._metrics is not None:
                self._metrics.counter("sim.wire_payload_bits").inc(bits)
            return bits
        bits = float(strict_bits)
        header = 0.0
        if self._wire_mode == "payload" and C.sparse_wire(
                spec.compressor, self.dim, spec.plan.delta):
            header = float(C.HEADER_BITS)
        if self._metrics is not None:
            self._metrics.counter("sim.wire_payload_bits").inc(bits)
            if header:
                self._metrics.counter("sim.wire_header_bits").inc(header)
        return bits + header

    def _process_starts_batched(self, starts: list, push) -> None:
        """Run a drained batch of device cycles through bucketed chunk
        dispatches. `starts` is [(t, did, model_round, arrive, attempts,
        corrupt, ch_delivered)] in heap-pop order, with the upload outcome
        already resolved at drain time (`_schedule_upload`); arrivals are
        pushed back in that same order so heap tie-breaking (and the host
        RNG stream) match the sequential engine exactly. Lost cycles (crash
        or channel give-up: arrive is None) are still dispatched — their
        compute advances the loader, RNG, and EF residual exactly like the
        sequential engine — but land no arrival (their restart event was
        pushed during the drain).

        Two phases, as in the reference: dispatch every chunk of every
        bucket first (the card runs a chunk while the host stacks the next
        one's batches), then pull the payloads."""
        with annotate("sim.draw"):
            order = []
            for t, did, mr, arrive, attempts, corrupt, ch_del in starts:
                stacked = self._stacked[did].next()
                seed = self.rng.randint(0, 2 ** 31 - 1)
                order.append((t, did, mr, stacked, seed))

            buckets: dict[tuple, list] = {}
            for item in order:
                buckets.setdefault(self._bucket_key(self.devices[item[1]]),
                                   []).append(item)
            if self._metrics is not None:
                m = self._metrics
                m.histogram("engine.drain_size", _SIZE_BUCKETS).observe(
                    len(starts))
                m.gauge("engine.buckets").set(len(buckets))
                occ = m.histogram("engine.bucket_occupancy", _SIZE_BUCKETS)
                for items in buckets.values():
                    occ.observe(len(items))
            # one host->device model upload per drain: no aggregation lands
            # inside a drain, so every chunk reads the same global model
            if self._arena_pool is None:
                flat = torch.tensor(self.model.w, device=self.device)
            else:
                self._arena = _Arena(
                    self._arena_pool, self.dim, self._arena_rows,
                    max(ld.batch_size for ld in self.loaders.values()),
                    self._arena_P, order[0][3], self.device)
                flat = self._arena.w0
                flat.copy_(torch.from_numpy(self.model.w))
        pending = []
        chunk_hist = (self._metrics.histogram("engine.chunk_size",
                                              _SIZE_BUCKETS)
                      if self._metrics is not None else None)
        results: dict[int, tuple] = {}
        try:
            with self._phase("dispatch"):
                for bkey, items in buckets.items():
                    pos = 0
                    for size in _chunk_sizes(len(items)):
                        if chunk_hist is not None:
                            chunk_hist.observe(size)
                        pending.append(self._dispatch_chunk(
                            bkey, items[pos:pos + size], flat))
                        pos += size
            with self._phase("collect"):
                for rec in pending:
                    self._collect_chunk(rec, results)
        finally:
            # no payload aliases the arena: they are stacked copies
            self._arena = None

        with annotate("sim.schedule"):
            for t, did, mr, arrive, attempts, corrupt, ch_del in starts:
                update, bits = results[did]
                if self.channel is not None and ch_del is not None:
                    self.channel.charge_wire(bits, attempts, ch_del)
                if arrive is None:
                    continue   # upload lost; compute ran, restart queued
                if corrupt:
                    update = self._poison(update)
                push(arrive, "arrival",
                     Arrival(did, update, mr, bits * attempts, arrive))

    def _dispatch_chunk(self, bkey: tuple, items: list, flat: torch.Tensor):
        """Run one exact power-of-two chunk of same-bucket cycles; returns
        the record `_collect_chunk` pulls. The chunk's batches go to the
        device in one copy per array, as [k, B, ...] so each step's
        [B, ...] slice is contiguous; the chunk's residual rows are
        gathered and written back in place."""
        B = len(items)
        with annotate("sim.stage"):
            if B == 1:
                # no stacking: a [k, 1, ...] view of the loader's stack
                host = {key: v[:, None] for key, v in items[0][3].items()}
            else:
                host = {key: np.stack([it[3][key] for it in items], axis=1)
                        for key in items[0][3]}
            batches = (self._to_device(host) if self._arena is None
                       else self._arena.stage(host))
            k = next(iter(batches.values())).shape[0]
            steps = [{key: v[i] for key, v in batches.items()}
                     for i in range(k)]
            seeds = [it[4] for it in items]
            krows = [C.num_keep(self.dim, self.devices[it[1]].plan.delta)
                     for it in items]
            if bkey[3]:   # error feedback: the chunk's residual rows
                rows = torch.as_tensor([self._rowof[it[1]] for it in items],
                                       dtype=torch.long, device=self.device)
        fn = self._bucket_fn(bkey, B)
        if bkey[3]:
            payload, new_rows, bits = fn(
                flat, self._res_stack.index_select(0, rows), steps, seeds,
                krows)
            self._res_stack.index_copy_(0, rows, new_rows)
        else:
            payload, _, bits = fn(flat, None, steps, seeds, krows)
        return bkey, items, payload, bits

    def _collect_chunk(self, rec, results: dict) -> None:
        """One device-to-host copy per chunk: the dense rows, or the
        compact (values, indices) rows packed side by side as int32 bits."""
        bkey, items, payload, bits = rec
        if self._bucket_sparse(bkey):
            vals, idxs = payload
            kcap = vals.shape[1]
            host = torch.cat([vals.view(torch.int32), idxs], dim=1).to(
                "cpu").numpy()
            vals, idxs = host[:, :kcap].view(np.float32), host[:, kcap:]
            for i, it in enumerate(items):
                did = it[1]
                # kept-count header of the compact wire format; exact-k
                # compressors know it statically, threshold selection only
                # on device (header still charged via _wire_bits)
                kept = (C.num_keep(self.dim, self.devices[did].plan.delta)
                        if bkey[1] in ("topk", "randk") else None)
                results[did] = (SparseUpdate(vals[i], idxs[i], self.dim,
                                             kept),
                                self._wire_bits(did, bits[i]))
        else:
            dense = payload.to("cpu").numpy()
            for i, it in enumerate(items):
                did = it[1]
                results[did] = (dense[i], self._wire_bits(did, bits[i]))

    # -------------------------------------------------------------------- run
    def run(self, total_rounds: int = 50, eval_every: int = 1,
            max_sim_time: float = math.inf) -> History:
        hist = History()
        heap: list = []
        seq = 0

        def push(t, kind, payload):
            nonlocal seq
            heapq.heappush(heap, (t, seq, kind, payload))
            seq += 1

        periodic = isinstance(self.agg, PeriodicAggregator)
        syncb = isinstance(self.agg, SyncAggregator)
        if syncb:
            self.agg.begin_round(0.0, list(self.devices))

        # kick off every device at t=0 with the initial model
        for did in self.devices:
            push(0.0, "start", (did, self.model.round))
        if periodic:
            push(self.round_period, "boundary", 1)

        evals_done = 0
        last_t = 0.0
        while heap:
            # the event loop's own work runs in "sim.schedule" spans; the
            # phases (drain, dispatch, aggregate, eval) lie between them
            with annotate("sim.schedule"):
                t, _, kind, payload = heapq.heappop(heap)
                if t > max_sim_time or self.model.round >= total_rounds:
                    break
                last_t = t
                self.events_processed += 1

                if kind == "start" and self._batched:
                    # Drain every start that must precede the earliest
                    # possible completion of the drained set: no
                    # aggregation (= model change) can land in between, so
                    # the whole group reads the same global model. Each
                    # popped start resolves its upload outcome here, at pop
                    # time: down devices queue their recovery, lost uploads
                    # queue their restart at once (re-entering the heap so
                    # the drain sees them in exact sequential event order),
                    # and delivered uploads bound the horizon with their
                    # TRUE arrival time (retries included). A device
                    # appears only once per drain: buffered strategies can
                    # release it several times at one timestamp, and those
                    # cycles chain through its EF residual.
                    starts, seen, horizon = [], set(), math.inf
                    while True:
                        did, mr = payload
                        if self.failure_schedule is not None and \
                                self.failure_schedule.is_down(did, t):
                            rec = self.failure_schedule.recovery_time(did, t)
                            self._trace_down(did, t, rec)
                            push(rec, "start", (did, self.model.round))
                        else:
                            self._maybe_replan(did, t)
                            arrive, restart_at, attempts, corrupt, ch_del = \
                                self._schedule_upload(did, t)
                            if arrive is None:
                                push(restart_at, "start",
                                     (did, self.model.round))
                            else:
                                horizon = min(horizon, arrive)
                            seen.add(did)
                            starts.append(
                                (t, did, mr, arrive, attempts, corrupt,
                                 ch_del))
                        if not (heap and heap[0][2] == "start"
                                and heap[0][0] <= min(horizon, max_sim_time)
                                and heap[0][3][0] not in seen):
                            break
                        t, _, _, payload = heapq.heappop(heap)
                        last_t = t
                        self.events_processed += 1
                elif kind == "start":
                    did, mr = payload
                    down = self.failure_schedule is not None and \
                        self.failure_schedule.is_down(did, t)
                    if down:
                        rec = self.failure_schedule.recovery_time(did, t)
                        self._trace_down(did, t, rec)
                        push(rec, "start", (did, self.model.round))
                    else:
                        self._maybe_replan(did, t)
                        arrive, restart_at, attempts, corrupt, ch_del = \
                            self._schedule_upload(did, t)
                elif kind == "arrival":
                    a: Arrival = payload
                    tr = self._tracer
                    if tr is not None:
                        tr.instant(SERVER_TRACK, "arrival", t,
                                   device=a.device_id, round=a.model_round,
                                   bits=a.wire_bits)
                    if self._metrics is not None:
                        self._metrics.counter("sim.arrivals").inc()
                        self._metrics.counter("sim.wire_bits_arrived").inc(
                            a.wire_bits)
                    san = (getattr(self.agg, "sanitizer", None)
                           if tr is not None else None)
                    san_before = dict(san.counts) if san is not None \
                        else None

            if kind == "start":
                if self._batched:
                    if starts:
                        with self._phase("heap_drain"):
                            self._process_starts_batched(starts, push)
                    continue
                if down:
                    continue
                with self._phase("dispatch"):
                    update, strict_bits = self._device_compute(did)
                with annotate("sim.schedule"):
                    per_upload = self._wire_bits(did, strict_bits)
                    if self.channel is not None and ch_del is not None:
                        self.channel.charge_wire(per_upload, attempts, ch_del)
                    if arrive is None:  # crashed mid-flight / channel gave up
                        push(restart_at, "start", (did, self.model.round))
                    else:
                        if corrupt:
                            update = self._poison(update)
                        push(arrive, "arrival",
                             Arrival(did, update, mr, per_upload * attempts,
                                     arrive))

            elif kind == "arrival":
                with self._phase("aggregate"):
                    events = self.agg.on_arrival(t, a)
                with annotate("sim.schedule"):
                    if san_before is not None:
                        for cat, n in san.counts.items():
                            for _ in range(n - san_before[cat]):
                                tr.instant(SERVER_TRACK, cat, t,
                                           device=a.device_id)
                    self._trace_agg_events(events)
                    for ev in events:
                        for did in ev.release_to:
                            push(ev.time, "start", (did, self.model.round))
                        if syncb and ev.release_to:
                            self.agg.begin_round(ev.time, list(self.devices))
                    if not events and not periodic and not syncb:
                        # buffered strategy: device waits; FedBuff hands
                        # the *current* model back immediately so training
                        # continues
                        push(t, "start", (a.device_id, self.model.round))
                if events and eval_every and \
                        self.model.round >= evals_done * eval_every:
                    self._eval(hist, t)
                    evals_done += 1

            elif kind == "boundary":
                r = payload
                with self._phase("aggregate"):
                    events = self.agg.on_round_boundary(t)
                with annotate("sim.schedule"):
                    self._trace_agg_events(events)
                    for ev in events:
                        for did in ev.release_to:
                            push(ev.time, "start", (did, self.model.round))
                    push(t + self.round_period, "boundary", r + 1)
                if eval_every and self.model.round >= evals_done * eval_every:
                    self._eval(hist, t)
                    evals_done += 1

        # closing record: the break-event time when we stopped early, else
        # the LAST PROCESSED event time — never max_sim_time, which is inf
        # by default and would poison History.time_to_accuracy.
        self._eval(hist, t if heap else last_t)
        hist.counters = self.fault_counters()
        if self._metrics is not None:
            # overwrite rather than re-derive: faults.* must equal
            # History.counters EXACTLY
            self._metrics.merge_totals("faults.", hist.counters)
            self._metrics.gauge("sim.events_processed").set(
                self.events_processed)
            if self._timers is not None:
                self._timers.export_to(self._metrics)
        return hist

    def _eval(self, hist: History, t: float):
        with self._phase("eval"):
            with torch.no_grad():
                params = C.unflatten_pytree(
                    torch.tensor(self.model.w, device=self.device), self.spec)
                acc = self.task.acc_fn(params, self._test_batch)
                loss = self.task.loss_fn(params, self._test_batch)
            acc, loss = float(acc), float(loss)
        with annotate("sim.schedule"):
            # mean staleness over arrivals aggregated since the LAST eval:
            # a fixed last-N slice would mix entries across aggregation
            # rounds.
            window = self.agg.staleness_log[self._stal_ptr:]
            self._stal_ptr = len(self.agg.staleness_log)
            cnt = self.fault_counters()
            last = self._last_counters
            fault_window = {k: cnt[k] - last.get(k, 0)
                            for k in cnt if cnt[k] != last.get(k, 0)}
            self._last_counters = cnt
            if self._metrics is not None:
                h = self._metrics.histogram("sim.staleness",
                                            STALENESS_BUCKETS)
                before = list(h.counts)
                for s in window:
                    h.observe(s)
                fault_window["staleness_counts"] = [
                    a - b for a, b in zip(h.counts, before)]
            if self._tracer is not None:
                self._tracer.instant(SERVER_TRACK, "eval", t,
                                     round=int(self.model.round),
                                     accuracy=acc, loss=loss)
            hist.records.append(Record(
                time=float(t), round=int(self.model.round),
                accuracy=acc, loss=loss,
                gbits=self.agg.total_bits / 1e9,
                mean_staleness=float(np.mean(window)) if window else 0.0,
                drops=cnt["drops_total"], window=fault_window))


# ------------------------------------------------------------ device builders
def make_heterogeneous_devices(
        num: int, model_bits: float, *, base_alpha: float = 0.02,
        alpha_spread: float = 4.0, bw_range: tuple = (0.25e6, 2e6),
        seed: int = 0) -> list[DeviceProfile]:
    """Paper Sec 4.3: α ~ U[a, 4a]; bandwidth ~ U[0.25, 2] Mb/s."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(num):
        alpha = rng.uniform(base_alpha, base_alpha * alpha_spread)
        bw = rng.uniform(*bw_range)
        out.append(DeviceProfile.from_bandwidth(i, alpha, model_bits, bw))
    return out


def _snap_k(plan: Plan, p: DeviceProfile, round_period: float,
            k_grid, k_bounds, delta_bounds,
            fixed_delta: float | None = None) -> Plan:
    """Snap a solver-chosen k to the nearest grid value and re-optimize δ
    at the snapped k (or keep δ when it was fixed). Bounds the number of
    distinct local-round lengths a fleet runs, at a tiny φ cost."""
    lo, hi = int(k_bounds[0]), int(k_bounds[1])
    cand = sorted({min(max(int(g), lo), hi) for g in k_grid})
    k = min(cand, key=lambda g: (abs(g - plan.k), g))
    if k == plan.k:
        return plan
    if fixed_delta is not None:
        rt = k * p.alpha + fixed_delta * p.beta
        return Plan(k, float(fixed_delta),
                    float(factor.phi(k, fixed_delta, p.alpha, p.beta,
                                     round_period)),
                    rt, int(math.ceil(rt / round_period)))
    return factor.solve_plan_fixed_k(p.alpha, p.beta, round_period, k,
                                     delta_bounds=delta_bounds)


def plan_devices(profiles: list[DeviceProfile], method: str,
                 round_period: float, *, k_bounds=(1, 60),
                 delta_bounds=(1e-3, 1.0), fixed_k: int = 10,
                 fixed_delta: float = 0.1,
                 compressor_override: str | None = None,
                 error_feedback: bool = False,
                 compressor_kwargs: dict | None = None,
                 k_grid: list[int] | None = None,
                 controller: FedLuckController | None = None
                 ) -> list[DeviceSpec]:
    """Build DeviceSpecs for one of the 5 methods of the paper's Sec 4.

    `k_grid` (optional, methods that optimize k): snap each plan's k to the
    nearest grid value and re-solve δ at that k — see `_snap_k`.
    `controller` (optional, fedluck only): plan through a caller-owned
    controller instead of a throwaway — pass the same instance to
    `AFLSimulator(controller=...)` so mid-run drift re-plans start from the
    profiles that planned the fleet.
    """
    method = method.lower()
    ckw = dict(compressor_kwargs or {})
    specs = []
    if method == "fedluck":
        ctl = controller or FedLuckController(round_period, k_bounds,
                                              delta_bounds)
        for p in profiles:
            plan = ctl.register(p)
            if k_grid:
                plan = _snap_k(plan, p, round_period, k_grid, k_bounds,
                               delta_bounds)
            specs.append(DeviceSpec(p, plan, compressor_override or "topk",
                                    error_feedback, ckw))
    elif method == "opt_cr":   # fixed k, optimize δ (Tab. 2)
        ctl = FedLuckController(round_period, k_bounds, delta_bounds,
                                mode="fixed_k", fixed_k=fixed_k)
        for p in profiles:
            specs.append(DeviceSpec(p, ctl.register(p),
                                    compressor_override or "topk",
                                    error_feedback, ckw))
    elif method == "opt_lf":   # fixed δ, optimize k (Tab. 2)
        ctl = FedLuckController(round_period, k_bounds, delta_bounds,
                                mode="fixed_delta", fixed_delta=fixed_delta)
        for p in profiles:
            plan = ctl.register(p)
            if k_grid:
                plan = _snap_k(plan, p, round_period, k_grid, k_bounds,
                               delta_bounds, fixed_delta=fixed_delta)
            specs.append(DeviceSpec(p, plan,
                                    compressor_override or "topk",
                                    error_feedback, ckw))
    elif method in ("fedper", "fedavg_topk"):
        for p in profiles:
            plan = Plan(fixed_k, fixed_delta, 0.0,
                        fixed_k * p.alpha + fixed_delta * p.beta, 0)
            specs.append(DeviceSpec(p, plan, compressor_override or "topk",
                                    error_feedback, ckw))
    elif method in ("fedbuff", "fedasync"):   # no compression baselines
        for p in profiles:
            plan = Plan(fixed_k, 1.0, 0.0, fixed_k * p.alpha + p.beta, 0)
            specs.append(DeviceSpec(p, plan, compressor_override or "none",
                                    error_feedback, ckw))
    else:
        raise ValueError(f"unknown method {method}")
    return specs


STRATEGY_FOR_METHOD = {
    "fedluck": "periodic", "fedper": "periodic", "opt_cr": "periodic",
    "opt_lf": "periodic", "fedbuff": "fedbuff", "fedasync": "fedasync",
    "fedavg_topk": "sync",
}
