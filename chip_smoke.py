#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build    compile the CUDA C++ kernels from `src/repro_torch/kernels/csrc`
            (one nvcc per source, started together) and print the card's
            name and power limit;
2. kernels  hold each kernel against its plain PyTorch version on the card
            at d in {127, 40000, 1663370, 832512, 1665024} (the FL vector,
            a pod shard and the padded pod vector; f32, plus bf16) — exact
            counts for magnitude_hist, bitwise out/residual/nnz and
            conservation for ef_topk, rtol 2e-5 / atol 1e-6 for
            fused_momentum; magnitude_hist also exact on views at storage
            offsets 1-3, d in {1, 3, 4097}, NaN and +-Inf entries, 1 and
            1024 edges, ten calls back to back and a call on a second
            stream, and one call is one kernel on the card under
            torch.profiler; ef_topk also bitwise (NaN payloads included)
            on views at storage offsets 1-3, d in {1, 3, 4097}, NaN, +-Inf
            and +-0 entries, t in {0, inf}, every pairing of f32 and bf16
            g and r, ten calls back to back and a call on a second stream,
            and one call is one kernel on the card — and time kernel,
            plain version and yardstick PyTorch call at d = 1,663,370,
            magnitude_hist also at the pod shard d = 832,512 (CUDA events,
            median of 30 launches, L2 flushed before each);
3. cli      `run_fl(--task cnn_fmnist --method fedluck --error-feedback
            --rounds 3 --device cuda)` with the CLI's other defaults (10
            devices, 4000 samples; the batched engine): finite accuracy,
            positive gbits, one chunk row per cycle, and fused_momentum's
            wrapper calls == the sum of the k of the dispatched chunks
            that did not replay a captured CUDA graph
            (chunks counted by wrapping AFLSimulator._dispatch_chunk);
4. batched  cnn_fmnist at full width, `fedper` with error feedback: 10
            devices, k = 10, δ = 0.1, one topk bucket, a 15 s round period
            (every cycle, 3.3-13.5 s, lands within it, so each boundary
            releases all 10 devices: chunks 8 + 2 per drain, 3 drains);
            3 rounds on the batched and the sequential engine from
            the same seed, in turns (batched, sequential, sequential,
            batched): identical events with accuracy and loss taken out,
            identical engine-agnostic metrics, counters, records (time,
            round, gbits, staleness) and wire bits; after round 1 (one
            drain from the same model) accuracy within 0.02 and loss
            within rtol 1e-3, later rounds printed beside the sequential
            engine's own turn-to-turn spread; each chunk shape replays
            its CUDA graph in the third drain, and fused_momentum's
            wrapper calls == 10 x the chunks that did not replay a
            captured graph, fewer than the sequential run's; prints each
            wall.
            Before the runs, the gradients themselves
            (`launch.grad_accuracy.first_step_check`, 8 rows x 10 steps
            at full width): wherever the batched and the sequential
            engine's gradient paths take the same ReLU and max-pool
            decisions, their gradients agree within 1e-5 (relative, per
            row) and both lie within 1e-5 of float64; a decision they take
            differently is within 1e-5 of a tie in float64. Then
            a fedluck fleet with compressor_override="topk_threshold" and
            k_grid [1, 2, 4, 8, 16, 30], 2 rounds of the batched engine:
            ef_topk launches == cycles, magnitude_hist launches == 2 x
            cycles, fused_momentum == the k of the chunks that did not
            replay a captured graph, summed;
5. thresh   the same topk_threshold fleet without k_grid, 2 rounds of the
            sequential engine: ef_topk launches == cycles and
            magnitude_hist launches == 2 x cycles;
6. ckpt     the CLI on the card with --ckpt-dir (--ckpt-every 1, a 15 s
            round period so that uploads land in every segment) for 2
            rounds, then --resume to 3: both runs ship bits (gbits > 0),
            the resumed run starts at round 2 from the round-2
            checkpoint's model and residuals bitwise, its round moves the
            model, steps 2 and 3 are kept, and the saved residual stack
            and model read back bitwise equal to residual_snapshot() and
            to the stack on the card;
7. parity   a small run (mlp_micro, 4 devices, topk_threshold + EF) on the
            card and on the CPU (plain versions) from the same weights, on
            the sequential and on the batched engine: identical wire bits,
            counters and staleness, accuracy within 0.02 and loss within
            rtol 1e-3;
8. compact  compact_blocks bitwise (values, indices, counts, residual)
            against its plain version on nb x blk in {1x128, 8x64, 12x256}
            x budget in {1, 5, 32}, on blk in {100, 1000, 2048, 4096,
            10000} at budget 10 and budget = blk, on rows at a storage
            offset of 1 (not 16-byte aligned), on NaN and +-Inf entries
            within and past the budget, on the pod path's shard [813, 1024]
            at budget 10 (the path's threshold and t in {0, inf}), with the
            shard's threshold solve (both magnitude_hist passes at k = 8130)
            held to exact counts; timed at [813, 1024], budget 10 (runs
            inside the kernels phase);
9. pod      the multi-pod sync path (dist.steps.make_pod_round_step over
            dist.collectives.make_pod_sync, built by
            launch.profile_pod.build_pod_round): cnn_fmnist at full width, 4
            pods x 2 in-pod shards on the card, blk 1024 (nb 1626), δ 0.01
            (budget 10, `auto` -> compact), k = 5 momentum-SGD steps at
            batch 32 per pod, 3 rounds with EF carried. Per round: finite
            loss; launches compact_blocks 8, magnitude_hist 16,
            fused_momentum 20; kept + r' == delta + r bitwise; <= budget
            live entries per block; params' == params - mean(kept) at rtol
            1e-5; wire bits 2 x 68,292 x 8. Gate: the `reference` wire on
            the same deltas over the 3 carried rounds gives params within
            rtol 1e-5 / atol 1e-6 and bitwise residuals. Then one round at
            δ 0.3 resolves to `dense`: ef_topk 4, magnitude_hist 8
            launches. Prints the wall per round, local rounds vs sync;
10. podparity  mlp_micro, 2 pods x 2 shards, blk 64, δ 0.05, on the card
            and on the CPU from the same weights and batches: per-pod
            losses within rtol 1e-3; the card's deltas synced on the CPU
            give bitwise residuals and params within rtol 1e-5;
11. lm      the ten LM archs at their smoke configs, fp32, on the card and
            on the CPU from the same weights: loss within rtol 1e-4, the
            flat gradient within relative L2 1e-3, prefill and one-step
            decode logits within atol 1e-3; after 16 decode steps the
            compute cache's logits within atol 1e-3 and the int8 cache's
            within 1e-2 of the CPU's, and the int8 cache tracking the
            compute cache (corrcoef > 0.999, the same last greedy token
            up to near-ties within 0.05: `int8_tracks`);
12. serve   `launch.serve.serve()` on unreduced gemma3-4b (~3.9 B
            parameters) and mamba2-780m, random init on the card, fp32,
            4 requests at batch 2, prompt 16, gen 16 after a first call of
            2 x 2 tokens: tokens/s, wall and peak memory; decode at
            position 16 equals a prefill of 17 tokens (atol 2e-2);
            gemma3-4b's int8 cache tracks the compute cache over 16
            decode steps (`int8_tracks`);
13. datacenter  `launch.train.run_datacenter` on the unreduced mamba2-780m
            (2 pods, k 2, δ 0.01, 3 steps, batch 8): finite loss, comm_mb
            equal to the top-k payload formula, fused_momentum launches ==
            4 (the α probe) + 3 x 2 x 2 steps, SSD launches == 14 x 48
            layers x those 16 steps; the wall per round split into local
            rounds, compression and aggregation, and the peak memory; at
            full width on the card and on the CPU, the gradients of the
            loss with bf16 and with fp32 logits (loss within rtol 1e-4,
            relative L2 1e-3) and the first local round's delta at η_l
            0.05 and 0.005 (printed); the run at η_l 0.005 with a fixed
            batch's loss falling over its 3 rounds; then
            the smoke config on the card and on the CPU from the same
            weights: identical comm_mb, loss within rtol 1e-3.
14. train   the mesh layer's train path on a world-size-1 NCCL group
            (FileStore in a temporary directory) and a (1, 1) mesh:
            gemma3-4b at full width, 2 layers, fp32, S 4096, batch 4 —
            microbatches=4 against the full batch (loss rtol 1e-5, params
            rtol 1e-4 / atol 1e-6) and the DTensor step bitwise equal to
            the plain one, under deterministic algorithms; the prefill and
            decode builders on DTensor params bitwise equal to
            `LM.prefill` / `LM.decode_step` (unreduced, fp32, 2 x 16
            tokens, 4 steps); the real cell — unreduced gemma3-4b, bf16,
            remat, S 4096, batch 2 in 2 microbatches, 3 momentum-SGD
            steps: finite losses, fused_momentum == 3, the median step,
            the peak memory and `launch.dryrun`'s estimate of it (run in
            a subprocess meanwhile), whose ratio must lie in [0.8, 1.25];
            on the tp layout, whose one rank splits no weight;
15. meshserve serving on the mesh layer: unreduced gemma3-4b in bf16 on
            the (1, 1) mesh, tp layout, prefill of 2 x 16 tokens and 16
            greedy decode steps through `make_prefill_step` /
            `make_decode_step` with DTensor parameters; every step's
            logits bitwise equal to the one-device `LM`'s on the same
            parameters; tokens/s and peak of both;
16. podsync the cross-process pod sync on a (1, 1, 1) mesh of a
            world-size-1 NCCL group: cnn_fmnist's width in blocks of
            1024, compact wire at δ 0.01 and dense at δ 0.3, 3 EF rounds
            each, bitwise equal to the one-card sync (params, residuals,
            wire bits); launches per round magnitude_hist 2 +
            compact_blocks 1, and magnitude_hist 2 + ef_topk 1.
17. ssd     the chunked SSD kernels (`kernels/csrc/ssd.cu`) against
            their plain versions, fp32 with TF32 off: y, the final state
            and the gradients of xh, dtA, dt, B, C (and of the initial
            state where given) within relative L2 1e-4, at mamba2-780m's
            (1 x 2048, H 48, P 64, N 128, chunk 256) and granite's (S
            4096, H 64) widths, hymba's N 16, the smoke configs' P 32 and
            a ragged S 100 < chunk; one forward and backward is 14 kernels
            named ssd_* under torch.profiler; one mamba2-780m layer's
            `mamba2_train` forward and backward launches them 14 times;
            forward + backward timed at both main-path widths beside the
            bound and the plain version, and each ssd_* kernel's device
            ms beside its FMAs and its share of the fp32 bound.
Each of phases 11-17 prints its seconds beside the card's name and power
limit.

Kernel launch counts are set to 0 just before each main-path run and read
just after it; launches made to compare a kernel with its plain version
do not count. A wrapper counts its calls: a replayed CUDA graph
launches the kernels it holds without one. The `kernels` line reports
fused_momentum's launches from `cli` (its eager and captured rounds),
ef_topk's and magnitude_hist's from `batched`'s topk_threshold run
(the CLI's engine), compact_blocks' from `pod` and the SSD's from
`datacenter`'s run of the unreduced mamba2-780m; fused_momentum's
launches on the datacenter path and on the mesh train path, and the
cross-process sync's launches per round, are printed on lines of their
own; `meshserve` prints its counts (the serving path launches none of
the four). The line before the last is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# cuBLAS must know its workspace before the first handle is made for
# `torch.use_deterministic_algorithms` (the `train` phase's bitwise gate)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # fp32 outside the tensor cores
D_CNN = 1_663_370               # cnn_fmnist at the paper's width
# the pod path (`profile_pod.build_pod_round`): 4 pods x 2 in-pod shards,
# blocks of 1024, δ = 0.01; what it must resolve to, and rounds to drive
POD_NB, POD_NBL, POD_BLK, POD_BUDGET, POD_ROUNDS = 1626, 813, 1024, 10, 3
# the FL vector, a pod shard [813, 1024] and the padded pod vector
SIZES = (127, 40_000, D_CNN, POD_NBL * POD_BLK, POD_NB * POD_BLK)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ------------------------------------------------------------------ helpers
def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """Least time on an H100 SXM: the larger of bytes over the memory rate
    and operations over the fp32 rate, in ms, and which one binds."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = nops / H100_F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_hist_cases(torch, dev: str = "cuda") -> int:
    """magnitude_hist exact against its plain version where the one-launch,
    16-byte-load kernel has its own code paths: views at storage offsets
    1-3 (a scalar head), lengths 1, 3 and 4097 (a scalar tail), NaN and
    +-Inf entries (also in the head and tail), 1 and MAX_EDGES edges, ten
    calls back to back (the workspace resets) and a call on a second
    stream. On the card, one call puts exactly one kernel on the device
    (torch.profiler). Returns the number of calls checked."""
    from repro_torch.kernels import magnitude_hist as mh
    from repro_torch.kernels import ref
    from repro_torch.kernels.checks import check_hist, vec

    n = 0

    def exact(g, e, what):
        nonlocal n
        diff = (mh.magnitude_hist(g, e).long()
                - ref.ref_magnitude_hist(g, e).long()).abs().max().item()
        if diff:
            fail(f"magnitude_hist {what}: counts differ by {diff}")
        n += 1

    def spread(n_edges, top=30.0):
        """n_edges positive descending edges from `top` down by 2^-40."""
        j = torch.arange(n_edges, dtype=torch.float32, device=dev)
        return top * torch.exp2(-j * (40.0 / max(1, n_edges - 1)))

    dtypes = (torch.float32, torch.bfloat16)
    for dtype in dtypes:
        base = vec(40_003, 11, dev).to(dtype)
        for off in (1, 2, 3):
            g = base[off:off + 40_000]
            if g.storage_offset() != off:
                fail(f"view at offset {off} has storage_offset "
                     f"{g.storage_offset()}")
            check_hist(g, f"offset {off} {dtype}")
            n += 2
        for d in (1, 3, 4097):
            check_hist(vec(d, d, dev).to(dtype),
                       f"d={d} {dtype}")
            n += 2
        # non-finite entries, in the head, body and tail of an offset view
        g = vec(40_001, 12, dev)
        g[[1, 777, 30_001]] = math.nan
        g[[2, 4096, 40_000]] = math.inf
        g[[3, 39_999]] = -math.inf
        g = g.to(dtype)[1:]
        for e in (spread(49), spread(129)):
            exact(g, e, f"non-finite {dtype}")
        for ne in (1, mh.MAX_EDGES):
            exact(vec(40_000, 13, dev).to(dtype), spread(ne),
                  f"{ne} edges {dtype}")
    exact(vec(D_CNN, 14, dev), spread(mh.MAX_EDGES),
          f"{mh.MAX_EDGES} edges d={D_CNN}")
    # ten calls back to back, compared only after all are queued
    runs = []
    for i in range(10):
        g = vec(POD_NBL * POD_BLK + 97 * i, 20 + i, dev)
        e = spread((49, 129, 1, mh.MAX_EDGES, 7)[i % 5])
        runs.append((g, e, mh.magnitude_hist(g, e)))
    for i, (g, e, got) in enumerate(runs):
        if not torch.equal(got, ref.ref_magnitude_hist(g, e)):
            fail(f"magnitude_hist back-to-back call {i} differs")
        n += 1
    if dev != "cuda":
        return n
    g, e = vec(D_CNN, 15), spread(49)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = mh.magnitude_hist(g, e)
    torch.cuda.current_stream().wait_stream(side)
    if not torch.equal(got, ref.ref_magnitude_hist(g, e)):
        fail("magnitude_hist on a second stream differs")
    n += 1
    if len({k for k in mh._WORKSPACES.keys()
            if k[0] == g.device.index}) < 2:
        fail("the second stream did not get its own workspace")
    one_kernel(torch, "magnitude_hist", "hist_kernel",
               lambda: mh.magnitude_hist(g, e))
    return n


def one_kernel(torch, name: str, kernel: str, call) -> None:
    """Fails unless `call()` puts exactly one kernel, `kernel`, on the
    card (torch.profiler): no fill, no second kernel."""
    from repro_torch.obs.profiling import device_profile
    torch.cuda.synchronize()
    with device_profile() as prof:
        call()
        torch.cuda.synchronize()
    # "Activity Buffer Request" is the tracer's own bookkeeping, not work
    on_card = [ev.name for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.name != "Activity Buffer Request"]
    if len(on_card) != 1 or kernel not in on_card[0]:
        fail(f"one {name} call put {on_card} on the card")
    log(f"[kernels] one {name} call = one device kernel: {on_card}")


def check_ef_cases(torch, dev: str = "cuda") -> tuple[int, float]:
    """ef_topk bitwise against its plain version (`check_ef`: out and r'
    by bits, NaN payloads included, nnz equal) where the one-launch kernel
    has its own code paths: views at storage offsets 1-3 (out and r' are
    fresh, so the phases differ and the whole vector is scalars), lengths
    1, 3 and 4097 (a scalar tail), NaN, +-Inf and +-0 entries (also in the
    head and tail of an offset view), t in {0, inf} (also at the cnn
    width), every pairing of f32 and bf16 g and r, ten calls back to back
    (the workspace resets) and a call on a second stream. On the
    card, one call puts exactly one kernel on the device. Returns (calls
    checked, largest abs error over finite entries)."""
    from repro_torch.kernels import ef_topk as ef_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels.checks import bits_equal, check_ef, vec

    n, err = 0, 0.0

    def check(g, r, t, what):
        nonlocal n, err
        err = max(err, check_ef(g, r, t, what))
        n += 1

    def agrees(g, r, t, got) -> bool:
        want = ref.ref_ef_topk(g, r, torch.tensor(t, device=g.device))
        return (bits_equal(got[0], want[0]) and bits_equal(got[1], want[1])
                and int(got[2]) == int(want[2]))

    dtypes = (torch.float32, torch.bfloat16)
    for gd in dtypes:
        for rd in dtypes:
            tag = f"g {gd} r {rd}"
            g = vec(40_003, 31, dev).to(gd)
            r = (vec(40_003, 32, dev) * 0.1).to(rd)
            for off in (1, 2, 3):
                gv, rv = g[off:off + 40_000], r[off:off + 40_000]
                if gv.storage_offset() != off:
                    fail(f"view at offset {off} has storage_offset "
                         f"{gv.storage_offset()}")
                check(gv, rv, 1.0, f"offset {off} {tag}")
                check(gv, r[:40_000], 1.0, f"g at offset {off} {tag}")
            for d in (1, 3, 4097):
                check(vec(d, d, dev).to(gd), (vec(d, d + 1, dev) * 0.1).to(rd),
                      1.0, f"d={d} {tag}")
            # non-finite and signed-zero entries, also in the head and tail
            g = vec(40_001, 33, dev)
            r = vec(40_001, 34, dev) * 0.1
            g[[1, 777, 30_001]] = math.nan
            g[[2, 4096, 40_000]] = math.inf
            g[[3, 39_999]] = -math.inf
            r[[5, 4096]] = -math.inf      # at 4096 Inf + -Inf: NaN
            r[[6, 39_998]] = math.nan
            g[10] = r[10] = 0.0
            g[11] = r[11] = -0.0          # acc = -0: kept at t = 0
            g, r = g.to(gd), r.to(rd)
            for t in (1.0, 0.0, math.inf):
                check(g, r, t, f"non-finite t={t} {tag}")
                check(g[1:], r[1:], t, f"non-finite offset 1 t={t} {tag}")
    for t in (0.0, math.inf):
        check(vec(D_CNN, 35, dev), vec(D_CNN, 36, dev) * 0.1, t,
              f"d={D_CNN} t={t}")
    # ten calls back to back, compared only after all are queued
    runs = []
    for i in range(10):
        d = POD_NB * POD_BLK - 97 * i
        g = vec(d, 40 + i, dev).to(dtypes[i % 2])
        r = (vec(d, 50 + i, dev) * 0.1).to(dtypes[i // 2 % 2])
        t = (1.0, 0.5, 0.0, math.inf, 2.0)[i % 5]
        runs.append((g, r, t, ef_mod.ef_topk(g, r, t)))
    for i, (g, r, t, got) in enumerate(runs):
        if not agrees(g, r, t, got):
            fail(f"ef_topk back-to-back call {i} differs")
        n += 1
    if dev != "cuda":
        return n, err
    g, r = vec(D_CNN, 37), vec(D_CNN, 38) * 0.1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = ef_mod.ef_topk(g, r, 1.0)
    torch.cuda.current_stream().wait_stream(side)
    if not agrees(g, r, 1.0, got):
        fail("ef_topk on a second stream differs")
    n += 1
    if len({k for k in ef_mod._WORKSPACES.keys()
            if k[0] == g.device.index}) < 2:
        fail("the second stream did not get its own ef_topk workspace")
    t = torch.tensor(1.0, device=g.device)
    one_kernel(torch, "ef_topk", "ef_topk_kernel",
               lambda: ef_mod.ef_topk(g, r, t))
    return n, err


# ------------------------------------------------------------------- phases
def phase_build(torch) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f}s -> "
        f"{_build.BUILD_DIR}")
    for name, text in _build.BUILD_LOG.items():
        for line in text.strip().splitlines():
            log(f"[build] {name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(f"[card] {smi.stdout.strip()}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")


def phase_kernels(torch) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.ef_topk import ef_topk
    from repro_torch.kernels.fused_momentum import fused_momentum
    from repro_torch.kernels.checks import check_ef, check_hist, vec
    from repro_torch.kernels.magnitude_hist import magnitude_hist
    from repro_torch.obs.profiling import time_ms

    # magnitude_hist is held to exact counts (check_hist fails otherwise)
    err = {"magnitude_hist": 0.0, "ef_topk": 0.0, "fused_momentum": 0.0}
    for d in SIZES:
        for dtype in (torch.float32, torch.bfloat16):
            g = vec(d, d).to(dtype)
            r = (vec(d, d + 1) * 0.1).to(dtype)
            _, _, t = check_hist(g, f"d={d} {dtype}")
            # ef_topk: bitwise out / residual / nnz, and conservation
            err["ef_topk"] = max(err["ef_topk"],
                                 check_ef(g, r, t, f"d={d} {dtype}"))
            # fused_momentum: rtol 2e-5 / atol 1e-6 (the reference's own)
            w, gg = vec(d, d + 2).to(dtype), vec(d, d + 3)
            mu = vec(d, d + 4)
            rw, rmu = ref.ref_fused_momentum(w, mu, gg.to(dtype), lr=0.05,
                                             momentum=0.9)
            fused_momentum(w, mu, gg.to(dtype), lr=0.05, momentum=0.9)
            for a, b, what in ((w, rw, "w"), (mu, rmu, "mu")):
                a32, b32 = a.float(), b.float()
                e = (a32 - b32).abs().max().item()
                err["fused_momentum"] = max(err["fused_momentum"], e)
                if not torch.allclose(a32, b32, rtol=2e-5, atol=1e-6):
                    fail(f"fused_momentum {what} d={d} {dtype}: max abs "
                         f"err {e}")
    n_cases = check_hist_cases(torch)
    n_ef, e_ef = check_ef_cases(torch)
    err["ef_topk"] = max(err["ef_topk"], e_ef)
    torch.cuda.synchronize()
    log(f"[kernels] all three agree with their plain versions at d in "
        f"{SIZES}, f32 and bf16 inputs; magnitude_hist exact in {n_cases} "
        f"more calls (offset views, odd lengths, non-finite entries, 1 and "
        f"1024 edges, back to back, a second stream); ef_topk bitwise in "
        f"{n_ef} more calls (offset views, odd lengths, non-finite and "
        f"signed-zero entries, t in {{0, inf}}, mixed dtypes, back to back, "
        f"a second stream)")

    # timings at the cnn width, f32
    d = D_CNN
    g, r = vec(d, 1), vec(d, 2) * 0.1
    coarse, fine, t = check_hist(g, f"d={d} timed")
    w, mu = vec(d, 3), vec(d, 4)
    p = torch.nn.Parameter(w.clone())
    p.grad = g.clone()
    sgd = torch.optim.SGD([p], lr=0.05, momentum=0.9, fused=True)
    f4 = 4
    rows = {}
    ms = time_ms(lambda: magnitude_hist(g, coarse))
    ms_fine = time_ms(lambda: magnitude_hist(g, fine))
    rows["magnitude_hist"] = dict(
        ms=ms, plain_ms=time_ms(lambda: ref.ref_magnitude_hist(
            g, coarse)), library_ms=None,
        bound=bound(f4 * d + 2 * f4 * coarse.numel(),
                    d * (1 + math.log2(coarse.numel()))))
    log(f"[time] magnitude_hist fine pass (129 edges): {ms_fine:.6f} ms")
    shard = vec(POD_NBL * POD_BLK, 5)
    s_coarse, s_fine, _ = check_hist(shard, "pod shard timed",
                                     POD_NBL * POD_BUDGET)
    s_ms = [time_ms(lambda: magnitude_hist(shard, e))
            for e in (s_coarse, s_fine)]
    log(f"[time] magnitude_hist pod shard (d = {shard.numel()}): coarse "
        f"(49 edges) {s_ms[0]:.6f} ms, fine (129 edges) {s_ms[1]:.6f} ms, "
        f"bound {bound(f4 * shard.numel(), 0)[0]:.6f} ms")
    rows["ef_topk"] = dict(
        ms=time_ms(lambda: ef_topk(g, r, t)),
        plain_ms=time_ms(lambda: ref.ref_ef_topk(g, r, t)),
        library_ms=None, bound=bound(4 * f4 * d + 8, 4 * d))
    rows["fused_momentum"] = dict(
        ms=time_ms(lambda: fused_momentum(w, mu, g, lr=0.05,
                                                 momentum=0.9)),
        plain_ms=time_ms(lambda: ref.ref_fused_momentum(
            w, mu, g, lr=0.05, momentum=0.9)),
        library_ms=time_ms(sgd.step),
        bound=bound(5 * f4 * d, 4 * d))
    for name, row in rows.items():
        row["max_abs_err"] = err[name]
    rows["compact_blocks"] = phase_compact(torch)
    for name, row in rows.items():
        log(f"[time] {name}: kernel {row['ms']:.6f} ms, plain "
            f"{row['plain_ms']:.6f} ms, library {row['library_ms']}, bound "
            f"{row['bound'][0]:.6f} ms ({row['bound'][1]})")
    return rows


def phase_compact(torch, dev: str = "cuda") -> dict:
    """compact_blocks bitwise on the reference's sweep and the pod path's
    shard, then timed at the shard [813, 1024], budget 10."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.checks import check_compact, check_hist
    from repro_torch.kernels.compact_topk import compact_blocks
    from repro_torch.obs.profiling import time_ms
    import numpy as np

    def blocked(nb, blk, seed):
        rng = np.random.RandomState(seed)
        a = rng.randn(nb, blk).astype(np.float32) * np.exp(
            rng.randn(nb, blk)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    err, n = 0.0, 0
    for nb, blk in ((1, 128), (8, 64), (12, 256)):
        for budget in (1, 5, 32):
            acc = blocked(nb, blk, nb * blk + budget)
            t = acc.abs().median() * 2
            err = max(err, check_compact(acc, t, budget,
                                         f"{nb}x{blk} budget {budget}"))
            n += 1
    acc = blocked(POD_NBL, POD_BLK, 7)
    # the shard's threshold solve, as compact_shard_topk runs it
    _, _, t_path = check_hist(acc.reshape(-1),
                              f"{POD_NBL}x{POD_BLK} shard",
                              POD_NBL * POD_BUDGET)
    for name, t in (("path t", t_path), ("t=0", 0.0), ("t=inf", math.inf),
                    ("2x median", acc.abs().median() * 2)):
        err = max(err, check_compact(acc, t, POD_BUDGET,
                                     f"{POD_NBL}x{POD_BLK} {name}"))
        n += 1
    for t in (0.0, math.inf):
        err = max(err, check_compact(blocked(4, 64, 3), t, 8,
                                     f"4x64 t={t}"))
        n += 1
    # the redesigned kernel's own paths: blocks shorter than one
    # super-chunk of 1024 and several super-chunks long, budget = blk, rows
    # that are not 16-byte aligned (scalar loads), non-finite entries
    for blk in (100, 1000, 2048, 4096, 10_000):
        a = blocked(5, blk, blk)
        for budget in (10, blk):
            err = max(err, check_compact(a, a.abs().median() * 2,
                                         budget, f"5x{blk} budget {budget}"))
            n += 1
    for nb, blk in ((8, 1024), (5, 100), (3, 4096), (2, 10_000)):
        a = blocked(1, 1 + nb * blk, nb + blk).reshape(-1)[1:].view(nb, blk)
        err = max(err, check_compact(a, a.abs().median() * 2, 10,
                                     f"{nb}x{blk} at offset 1"))
        n += 1
    a = blocked(6, 1024, 9)
    t2 = a.abs().median() * 2
    a[:, 600], a[:, 700], a[:, 800] = math.inf, -math.inf, math.nan
    a[0, 0], a[1, 1], a[2, 2] = math.nan, math.inf, -math.inf
    for name, t in (("t=0", 0.0), ("2x median", t2), ("t=inf", math.inf)):
        err = max(err, check_compact(a, t, 10, f"non-finite {name}"))
        n += 1
    log(f"[compact] compact_blocks bitwise equal to its plain version in "
        f"{n} cases (max abs err {err}); the {POD_NBL}x{POD_BLK} shard's "
        f"magnitude_hist passes exact")
    if dev != "cuda":
        return {"max_abs_err": err}
    nbytes = 2 * 4 * acc.numel() + 8 * POD_NBL * POD_BUDGET + 4 * POD_NBL
    return dict(
        ms=time_ms(lambda: compact_blocks(acc, t_path,
                                                 budget=POD_BUDGET)),
        plain_ms=time_ms(lambda: ref.ref_compact_blocks(
            acc, t_path, POD_BUDGET)),
        library_ms=None, bound=bound(nbytes, 2 * acc.numel()),
        max_abs_err=err)


# the SSD kernels' shapes: (name, b, S, H, P, N, chunk, initial state);
# the main path's two widths, hymba's state of 16, the smoke configs' P 32
# and a ragged chunk (S < chunk: Q = S, no power of two)
SSD_CASES = (("mamba2-780m", 1, 2048, 48, 64, 128, 256, False),
             ("granite-4.0-h-micro", 1, 4096, 64, 64, 128, 256, False),
             ("hymba N 16", 1, 512, 50, 64, 16, 256, True),
             ("smoke P 32 N 16", 2, 64, 4, 32, 16, 256, True),
             ("ragged S 100", 2, 100, 3, 64, 128, 256, True))
# relative L2 error of each output against the plain version, both fp32
# with TF32 off: the kernels sum in another order (up to H·P = 4096 terms
# for dB and dC), and A's parallel cumulative sum rounds otherwise than
# torch.cumsum, which exp(A_q - A_s) carries into every decayed term; the
# H100's largest reading was 6.2e-6
SSD_TOL = 1e-4


def ssd_inputs(torch, b, S, H, P, N, init, dev, seed=0):
    """SSD inputs shaped as `mamba2_train` makes them: silu-range x, B and
    C, dt = softplus(...) and A = -exp(...) per head."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    dt = torch.nn.functional.softplus(rn(b, S, H) - 1.0)
    A = -torch.exp(rn(H) * 0.5)
    ins = [rn(b, S, H, P), dt * A, dt, rn(b, S, N), rn(b, S, N),
           rn(b, H, P, N) if init else None]
    return ins, rn(b, S, H, P), rn(b, H, P, N)


def ssd_kernel_fma(b, S, H, P, N, Q) -> dict[str, int]:
    """The multiply-adds of the SSD's forward and backward per kernel (the
    name a profiler key holds), counting the causal products' pairs (half
    of each Q x Q block): G (ssd_bmm, in each direction), the chunk states
    and dS from y_off (ssd_chunk_state, twice), y's and du's state and
    causal parts, dG, and dB's and dC's state parts and dG's products (one
    ssd_bwd_dbc launch)."""
    tri = S * (Q + 1) // 2                  # causal pairs over all chunks
    hspn, htp = H * S * P * N, H * tri * P
    return {k: b * v for k, v in (
        ("ssd_bmm", 2 * tri * N), ("ssd_chunk_state_kernel<true>", hspn),
        ("ssd_chunk_state_kernel<false>", hspn),
        ("ssd_chunk_scan_kernel", hspn + htp),
        ("ssd_chunk_scan_bwd_dx", hspn + htp), ("ssd_bwd_dcb", htp),
        ("ssd_bwd_dbc_kernel", 2 * hspn + 2 * tri * N))}


def ssd_work(b, S, H, P, N, Q) -> tuple[float, float]:
    """(bytes, FLOPs) of the SSD's forward and backward: x, dtA, dt, B, C
    and dy read once, y, the final state and the five gradients written
    once; `ssd_kernel_fma`'s multiply-adds but G's once (the backward
    recomputes it)."""
    fma = sum(ssd_kernel_fma(b, S, H, P, N, Q).values()) \
        - b * S * (Q + 1) // 2 * N
    io = 4 * b * (4 * S * H * P + 4 * S * H + 4 * S * N + H * P * N)
    return io, 2.0 * fma


def phase_ssd(torch, dev: str = "cuda") -> dict:
    """The SSD kernels (`kernels/ssd.py`) against their plain versions
    (forward and the five gradients, and the initial state's where one is
    given) at SSD_CASES' shapes, fp32 with TF32 off; their names as the
    trace shows them; `mamba2_train` through them (launch count); time
    forward + backward at the two main-path widths beside the bound and
    the plain version."""
    from repro_torch.kernels import ssd as K
    from repro_torch.models import mamba2 as M
    from repro_torch.obs.profiling import time_ms

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rel = lambda a, b: ((a.double() - b.double()).norm()
                        / b.double().norm().clamp_min(1e-30)).item()
    worst = 0.0
    for name, b, S, H, P, N, chunk, init in SSD_CASES:
        Q = min(chunk, S)
        ins, dy, dfin = ssd_inputs(torch, b, S, H, P, N, init, dev)
        leaves = [None if t is None else t.clone().requires_grad_(True)
                  for t in ins]
        y, fin = K.ssd(*leaves[:5], chunk=chunk, initial_state=leaves[5])
        torch.autograd.backward([y, fin], [dy, dfin])
        py, pfin, pA, pprev = K.ssd_fwd_plain(*ins, Q)
        pg = K.ssd_bwd_plain(ins[0], ins[2], ins[3], ins[4], pA, pprev,
                             pfin, py, dy, dfin, Q)
        got = {"y": y, "final": fin, "dx": leaves[0].grad,
               "d(dtA)": leaves[1].grad, "d(dt)": leaves[2].grad,
               "dB": leaves[3].grad, "dC": leaves[4].grad}
        want = {"y": py, "final": pfin, "dx": pg[0], "d(dtA)": pg[1],
                "d(dt)": pg[2], "dB": pg[3], "dC": pg[4]}
        if init:
            got["d(init)"], want["d(init)"] = leaves[5].grad, pg[5]
        errs = {k: rel(got[k], want[k]) for k in got}
        worst = max(worst, *errs.values())
        msg = (f"[ssd] {name} (b {b}, S {S}, H {H}, P {P}, N {N}, Q {Q}): "
               + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if not all(math.isfinite(v) and v <= SSD_TOL for v in errs.values()):
            fail(msg)
        log(msg)
    # the trace's kernel names (the benchmark's ssd_kernel_ms reads them)
    b, S, H, P, N, chunk, _ = SSD_CASES[0][1:]
    ins, dy, dfin = ssd_inputs(torch, b, S, H, P, N, False, dev, seed=1)
    leaves = [t.requires_grad_(True) for t in ins[:5]]

    def fwd_bwd():
        y, _ = K.ssd(*leaves, chunk=chunk)
        torch.autograd.grad(y, leaves, dy)

    fwd_bwd()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        # a kernel of no interest first: the trace can miss the first
        # launch after the profiler starts (it missed ssd_cumsum there)
        torch.zeros(1, device=dev)
        fwd_bwd()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type
             == torch.autograd.DeviceType.CUDA and "ssd_" in e.key]
    n_rows = sum(e.count for e in prof.key_averages() if e.key in names)
    if n_rows != 14:
        fail(f"[ssd] a forward and backward ran {n_rows} ssd_ kernels "
             f"({names}), not 14")
    log(f"[ssd] one forward + backward: {n_rows} kernels named ssd_*: "
        f"{sorted(names)}")
    # the main path: one mamba2-780m layer's mamba2_train, forward and
    # backward, through the kernels
    s = M.SSMSpec(1536, 3072, 48, 64, 128, 4)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = M.mamba2_init(gen, s, device=dev)
    x = torch.randn((1, 2048, 1536), device=dev, generator=gen,
                    requires_grad=True)
    K.ssd.launches = 0
    M.mamba2_train(p, s, x, dtype=torch.float32).square().mean().backward()
    torch.cuda.synchronize()
    launches = K.ssd.launches
    if launches != 14:
        fail(f"[ssd] mamba2_train launched {K.ssd.launches} SSD kernels, "
             f"not 5 forward + 9 backward")
    log(f"[ssd] mamba2_train (mamba2-780m layer, 1 x 2048) forward and "
        f"backward: {K.ssd.launches} SSD kernel launches")
    rows = {}
    for name, b, S, H, P, N, chunk, _ in SSD_CASES[:2]:
        ins, dy, _ = ssd_inputs(torch, b, S, H, P, N, False, dev, seed=2)
        leaves = [t.requires_grad_(True) for t in ins[:5]]
        Q = min(chunk, S)

        def fwd_bwd_at(leaves=leaves, dy=dy, chunk=chunk):
            y, _ = K.ssd(*leaves, chunk=chunk)
            torch.autograd.grad(y, leaves, dy)

        def plain(ins=ins, dy=dy, Q=Q):
            y, fin, A, prev = K.ssd_fwd_plain(*ins[:5], None, Q)
            K.ssd_bwd_plain(ins[0], ins[2], ins[3], ins[4], A, prev, fin,
                            y, dy, None, Q)

        with torch.no_grad():
            fwd_ms = time_ms(lambda: K.ssd(*ins[:5], chunk=chunk))
            plain_ms = time_ms(plain)
        # the kernels' own device time (time_ms also holds whatever host
        # time autograd and the launches take beyond it)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(5):
                fwd_bwd_at()
            torch.cuda.synchronize()
        per = {e.key: e.device_time_total / 5e3
               for e in prof.key_averages() if "ssd_" in e.key}
        device_ms = sum(per.values())
        fma = ssd_kernel_fma(b, S, H, P, N, Q)
        for key, ms in sorted(per.items(), key=lambda kv: -kv[1]):
            f = sum(v for k, v in fma.items() if k in key)
            kernel = re.search(r"ssd_\w+(<\w+>)?", key)[0]
            share = 2 * f / H100_F32_OPS_PER_S / ms * 1e5
            log(f"[ssd] {name} {kernel}: {ms:.5f} ms, "
                + (f"{f / 1e9:.3f} G FMA, {share:.1f}% of the fp32 bound"
                   if f else "no products"))
        row = dict(ms=time_ms(fwd_bwd_at), plain_ms=plain_ms,
                   library_ms=None, fwd_ms=fwd_ms, device_ms=device_ms,
                   bound=bound(*ssd_work(b, S, H, P, N, Q)))
        rows[name] = row
        log(f"[time] ssd {name}: forward + backward {row['ms']:.4f} ms "
            f"(forward {fwd_ms:.4f}; the kernels' device time "
            f"{device_ms:.4f}), bound {row['bound'][0]:.4f} ms "
            f"({row['bound'][1]}), plain {plain_ms:.4f} ms")
    log(f"[ssd] {time.perf_counter() - t0:.1f}s on {card(dev)}")
    return {"rows": rows, "launches": launches, "max_rel_l2": worst}


def _wrappers() -> dict:
    from repro_torch.kernels.compact_topk import compact_blocks
    from repro_torch.kernels.ef_topk import ef_topk
    from repro_torch.kernels.fused_momentum import fused_momentum
    from repro_torch.kernels.magnitude_hist import magnitude_hist
    from repro_torch.kernels.ssd import ssd
    return {"fused_momentum": fused_momentum, "ef_topk": ef_topk,
            "magnitude_hist": magnitude_hist,
            "compact_blocks": compact_blocks, "ssd": ssd}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


class ChunkCounter:
    """Counts the batched engine's chunk dispatches (their sizes and the
    sum of their local k) by wrapping AFLSimulator._dispatch_chunk, so a
    kernel's launch count is checked against chunks counted apart from
    the kernel wrappers. On the card a chunk shape's local round replays
    a CUDA graph from its second use on: the graph launches its steps'
    `fused_momentum` kernels without a call of the wrapper, which counts
    its calls (eager rounds, and the capture). `replayed` and
    `replayed_steps` count the chunks that replayed an already captured
    graph and their local k, read from the simulator's
    `engine.graph_captures` / `engine.graph_replays` (so with metrics)."""

    def __enter__(self):
        from repro_torch.core.simulator import AFLSimulator
        self._cls, self._real = AFLSimulator, AFLSimulator._dispatch_chunk
        self.sizes, self.steps = [], 0
        self.replayed = self.replayed_steps = 0

        def graphs(sim) -> tuple:
            c = (sim._metrics.snapshot()["counters"]
                 if sim._metrics is not None else {})
            return (c.get("engine.graph_captures", 0.0),
                    c.get("engine.graph_replays", 0.0))

        def dispatch(sim, bkey, items, flat):
            self.sizes.append(len(items))
            self.steps += bkey[0]          # the bucket's local k
            c0, r0 = graphs(sim)
            out = self._real(sim, bkey, items, flat)
            c1, r1 = graphs(sim)
            if r1 > r0 and c1 == c0:
                self.replayed += 1
                self.replayed_steps += bkey[0]
            return out
        AFLSimulator._dispatch_chunk = dispatch
        return self

    def __exit__(self, *exc):
        self._cls._dispatch_chunk = self._real


def _sync(torch, dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def phase_cli(torch, dev: str = "cuda") -> int:
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as tmp:
        mpath = os.path.join(tmp, "metrics.json")
        args = train.build_parser().parse_args(
            ["--task", "cnn_fmnist", "--method", "fedluck",
             "--error-feedback", "--rounds", "3", "--device", dev,
             "--quiet", "--metrics-out", mpath])
        with ChunkCounter() as chunks:
            t0 = time.perf_counter()
            reset_counts()
            res = train.run_fl(args)
            _sync(torch, dev)
            c = counts()
            wall = time.perf_counter() - t0
        with open(mpath) as f:
            metrics = json.load(f)
    local_k = metrics["histograms"]["sim.local_k"]
    log(f"[cli] {json.dumps(res)}")
    log(f"[cli] engine {metrics['engine']}, wall {wall:.3f}s, cycles "
        f"{local_k['count']}, chunks {len(chunks.sizes)} (sizes "
        f"{chunks.sizes}), sum of the chunks' k {chunks.steps}, replayed "
        f"{chunks.replayed} chunks of {chunks.replayed_steps} steps, "
        f"launches {c}")
    if not math.isfinite(res["final_accuracy"]) or res["gbits"] <= 0:
        fail(f"cli result not sane: {res}")
    if res["rounds"] != 3 or metrics["engine"] != "batched":
        fail(f"cli ran {res['rounds']} rounds on the {metrics['engine']} "
             f"engine, expected 3 on the batched one")
    if sum(chunks.sizes) != local_k["count"]:
        fail(f"chunks hold {sum(chunks.sizes)} rows for "
             f"{local_k['count']} cycles")
    if dev == "cuda" and (
            c["fused_momentum"] != chunks.steps - chunks.replayed_steps
            or c["fused_momentum"] == 0):
        fail(f"fused_momentum called {c['fused_momentum']} times, the "
             f"dispatched chunks' k sum to {chunks.steps}, "
             f"{chunks.replayed_steps} of them in {chunks.replayed} "
             f"replayed graphs")
    return c["fused_momentum"]


def _fleet(task_name: str, n: int, samples: int, k_max: int, compressor,
           method: str = "fedluck", k_grid=None):
    import torch
    from repro_torch.core.simulator import (make_heterogeneous_devices,
                                            plan_devices)
    from repro_torch.models.small import make_task
    task = make_task(task_name, num_samples=samples, test_samples=800,
                     batch_size=32)
    flat = task.init_fn(torch.Generator().manual_seed(0))
    profiles = make_heterogeneous_devices(n, flat.numel() * 32, seed=0)
    specs = plan_devices(profiles, method, 1.0, k_bounds=(1, k_max),
                         compressor_override=compressor, error_feedback=True,
                         k_grid=k_grid)
    return task, specs


def _strip(events) -> list:
    """Tracer events with the eval instants' accuracy and loss taken out."""
    return [(e.track, e.name, e.ph, e.ts, e.dur,
             tuple(a for a in e.args if a[0] not in ("accuracy", "loss")))
            for e in events]


def _same_host_results(a: dict, b: dict, what: str,
                       max_round: float = math.inf) -> None:
    """Fails unless two runs agree host-side exactly (events, counters,
    records, wire bits) and, in the records up to `max_round`, in
    accuracy and loss within 0.02 / rtol 1e-3."""
    if a["events"] != b["events"] or a["hist"].counters != b["hist"].counters:
        fail(f"{what}: events or counters differ")
    if a["sim"].agg.total_bits != b["sim"].agg.total_bits:
        fail(f"{what}: wire bits {a['sim'].agg.total_bits} vs "
             f"{b['sim'].agg.total_bits}")
    for x, y in zip(a["hist"].records, b["hist"].records):
        if (x.time, x.round, x.gbits, x.mean_staleness) != \
                (y.time, y.round, y.gbits, y.mean_staleness):
            fail(f"{what}: records differ: {x} vs {y}")
        if x.round <= max_round and (
                abs(x.accuracy - y.accuracy) > 0.02
                or abs(x.loss - y.loss) > 1e-3 * abs(y.loss) + 1e-6):
            fail(f"{what}: accuracy/loss differ: {x} vs {y}")
    if len(a["hist"].records) != len(b["hist"].records):
        fail(f"{what}: {len(a['hist'].records)} vs "
             f"{len(b['hist'].records)} records")


def _sim_run(torch, task, specs, engine: str, rounds: int, dev: str,
             **kw) -> dict:
    """One simulator run with a tracer and metrics; the launch counts and
    chunk counts of exactly this run, and its wall."""
    from repro_torch.core.simulator import AFLSimulator
    from repro_torch.obs import MetricsRegistry, Tracer
    tr, m = Tracer(), MetricsRegistry()
    sim = AFLSimulator(task, specs, "periodic", engine=engine, device=dev,
                       tracer=tr, metrics=m, **kw)
    with ChunkCounter() as chunks:
        _sync(torch, dev)
        reset_counts()
        t0 = time.perf_counter()
        hist = sim.run(total_rounds=rounds, eval_every=1)
        _sync(torch, dev)
        wall = time.perf_counter() - t0
        c = counts()
    sim.close()
    return dict(sim=sim, hist=hist, events=_strip(tr.events), metrics=m,
                wall=wall, launches=c, chunks=chunks,
                cycles=int(m.counter("sim.cycles").value))


def phase_batched(torch, dev: str = "cuda") -> dict:
    """The batched engine at full cnn width against the sequential one,
    then its topk_threshold buckets; returns the launch counts of the
    topk_threshold run."""
    import copy
    from repro_torch.launch.grad_accuracy import TIE, TOL, first_step_check
    chk = first_step_check(torch.device(dev))
    log(f"[batched] gradients, batched vs sequential path, 8 rows x 10 "
        f"steps: {json.dumps(chk)}")
    if not chk["ok"]:
        fail(f"the batched engine's gradients differ from the sequential "
             f"engine's beyond {TOL} where they take the same ReLU and pool "
             f"decisions, or decide differently {TIE} or more from a tie")
    task, specs = _fleet("cnn_fmnist", 10, 4000, 30, None, method="fedper")
    if {(s.plan.k, s.plan.delta, s.compressor) for s in specs} != \
            {(10, 0.1, "topk")}:
        fail("the fedper fleet is not k = 10, δ = 0.1, topk")
    runs = [_sim_run(torch, task, copy.deepcopy(specs), engine, 3, dev,
                     round_period=15.0)
            for engine in ("batched", "sequential", "sequential",
                           "batched")]
    seq = runs[1]
    for r in runs:
        log(f"[batched] {r['sim'].engine}: wall {r['wall']:.6f}s, cycles "
            f"{r['cycles']}, chunks {r['chunks'].sizes}, launches "
            f"{r['launches']}, final acc {r['hist'].records[-1].accuracy} "
            f"loss {r['hist'].records[-1].loss}")
    # Accuracy and loss are held to the tolerance after the first drain,
    # where both engines start from the same model; the gradients behind
    # it are held to fp32 above. Later rounds are printed: two equally
    # exact fp32 runs of this fleet (the sequential engine with cuDNN's
    # convolutions or PyTorch's own) already differ there by up to 0.039
    # in accuracy and 1.3e-3 in relative loss (`launch.grad_accuracy
    # --fleet-seeds 4` on the H100), as do two turns of the sequential
    # engine (cuDNN's nondeterministic kernels), so no gate there could
    # tell an engine fault from rounding.
    for i in (0, 2, 3):
        _same_host_results(runs[i], seq, f"batched run vs sequential "
                           f"(turn {i})", max_round=1)
        if runs[i]["metrics"].snapshot(engine_agnostic=True) != \
                seq["metrics"].snapshot(engine_agnostic=True):
            fail(f"turn {i}: engine-agnostic metrics differ")
    for b in (runs[0], runs[3]):
        ch = b["chunks"]
        sizes, fm = ch.sizes, b["launches"]["fused_momentum"]
        if sizes != [8, 2] * 3 or b["cycles"] != 30:
            fail(f"chunks {sizes} for {b['cycles']} cycles, expected 8 + 2 "
                 f"in each of 3 drains")
        # each chunk shape: eager in the first drain, captured and
        # replayed in the second, replayed in the third
        if dev == "cuda" and (
                ch.replayed != 2
                or fm != 10 * (len(sizes) - ch.replayed)
                or fm != ch.steps - ch.replayed_steps
                or fm >= seq["launches"]["fused_momentum"]):
            fail(f"batched fused_momentum calls {fm} for {len(sizes)} "
                 f"chunks, {ch.replayed} replayed (sequential "
                 f"{seq['launches']['fused_momentum']})")
    for i in (0, 2, 3):
        log(f"[batched] turn {i} vs turn 1, (round, Δacc, Δloss): " + str(
            [(x.round, x.accuracy - y.accuracy, x.loss - y.loss)
             for x, y in zip(runs[i]["hist"].records, seq["hist"].records)]))
    log(f"[batched] batched == sequential host-side in 3 turns; walls (s) "
        f"batched {runs[0]['wall']:.6f} / {runs[3]['wall']:.6f}, "
        f"sequential {runs[1]['wall']:.6f} / {runs[2]['wall']:.6f}")

    task, specs = _fleet("cnn_fmnist", 10, 4000, 30, "topk_threshold",
                         k_grid=[1, 2, 4, 8, 16, 30])
    th = _sim_run(torch, task, specs, "batched", 2, dev)
    c, r = th["launches"], th["hist"].records[-1]
    log(f"[batched] topk_threshold: wall {th['wall']:.6f}s, cycles "
        f"{th['cycles']}, chunks {th['chunks'].sizes}, acc {r.accuracy} "
        f"loss {r.loss}, launches {c}")
    if not (math.isfinite(r.accuracy) and math.isfinite(r.loss)):
        fail("batched topk_threshold run gave a non-finite result")
    if dev == "cuda" and (th["cycles"] == 0 or c["ef_topk"] != th["cycles"]
                          or c["magnitude_hist"] != 2 * th["cycles"]
                          or c["fused_momentum"] != th["chunks"].steps
                          - th["chunks"].replayed_steps):
        fail(f"batched topk_threshold launches {c} for {th['cycles']} "
             f"cycles, chunks' k {th['chunks'].steps}")
    return c


def phase_threshold(torch) -> dict:
    from repro_torch.core.simulator import AFLSimulator
    from repro_torch.obs import MetricsRegistry
    task, specs = _fleet("cnn_fmnist", 10, 4000, 30, "topk_threshold")
    m = MetricsRegistry()
    sim = AFLSimulator(task, specs, "periodic", engine="sequential",
                       device="cuda", metrics=m)
    t0 = time.perf_counter()
    reset_counts()
    h = sim.run(total_rounds=2, eval_every=1)
    torch.cuda.synchronize()
    c = counts()
    cycles = int(m.counter("sim.cycles").value)
    r = h.records[-1]
    log(f"[thresh] wall {time.perf_counter() - t0:.3f}s, cycles {cycles}, "
        f"acc {r.accuracy} loss {r.loss} gbits {r.gbits}, launches {c}")
    if not (math.isfinite(r.accuracy) and math.isfinite(r.loss)):
        fail("topk_threshold run gave a non-finite result")
    if cycles == 0 or c["ef_topk"] != cycles \
            or c["magnitude_hist"] != 2 * cycles:
        fail(f"topk_threshold launches {c} for {cycles} cycles")
    return c


def phase_ckpt(torch, dev: str = "cuda") -> None:
    """The CLI's checkpoint and resume on the card: 2 rounds saved round
    by round, then `--resume` to 3. A 15 s round period lets uploads land
    in every segment (each segment restarts the simulated clock)."""
    import numpy as np
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train

    seen = {}
    real_restore, real_state = train.restore_fl_state, train.fl_ckpt_state

    def restore(sim, state):
        real_restore(sim, state)
        seen["resumed_at"] = sim.model.round
        seen["restored"] = (np.array(sim.model.w), sim.residual_snapshot())

    def state(sim):
        seen["sim"] = sim
        return real_state(sim)

    with tempfile.TemporaryDirectory() as tmp:
        flags = ["--task", "cnn_fmnist", "--method", "fedluck",
                 "--error-feedback", "--device", dev, "--quiet",
                 "--round-period", "15", "--ckpt-dir", tmp,
                 "--ckpt-every", "1"]
        ap = train.build_parser()
        train.restore_fl_state, train.fl_ckpt_state = restore, state
        try:
            first = train.run_fl(ap.parse_args(flags + ["--rounds", "2"]))
            resumed = train.run_fl(ap.parse_args(
                flags + ["--rounds", "3", "--resume"]))
        finally:
            train.restore_fl_state, train.fl_ckpt_state = \
                real_restore, real_state
        mgr = CheckpointManager(tmp)
        steps, saved2, saved = mgr.steps(), mgr.restore(2), mgr.restore()
    sim = seen["sim"]
    ids, snap = sim.residual_snapshot()
    n = len(ids)
    log(f"[ckpt] first run {json.dumps(first)}")
    log(f"[ckpt] resumed at round {seen.get('resumed_at')}: "
        f"{json.dumps(resumed)}; steps kept {steps}")
    if first["rounds"] != 2 or resumed["rounds"] != 3 \
            or seen.get("resumed_at") != 2 or steps != [2, 3]:
        fail(f"checkpoint/resume: rounds {first['rounds']} then "
             f"{resumed['rounds']}, resumed at {seen.get('resumed_at')}, "
             f"steps {steps}")
    if not (first["gbits"] > 0 and resumed["gbits"] > 0
            and math.isfinite(resumed["final_accuracy"])):
        fail("a segment landed no upload or gave a non-finite result")
    w_back, (ids_back, res_back) = seen["restored"]
    if not (np.array_equal(w_back.view(np.uint32),
                           saved2["w"].view(np.uint32))
            and np.array_equal(ids_back, saved2["residual_ids"])
            and np.array_equal(res_back.view(np.uint32),
                               saved2["residuals"].view(np.uint32))):
        fail("the resumed run did not start from the round-2 checkpoint")
    if int(saved["round"]) != 3 or not np.array_equal(saved["residual_ids"],
                                                      ids):
        fail(f"saved round {saved['round']}, ids {saved['residual_ids']}")
    if not (np.array_equal(saved["residuals"].view(np.uint32),
                           snap.view(np.uint32))
            and np.array_equal(saved["w"].view(np.uint32),
                               np.asarray(sim.model.w).view(np.uint32))):
        fail("the saved residuals or model differ from the run's")
    on_card = sim._res_stack[:n]
    if on_card.device.type != dev or not torch.equal(
            torch.from_numpy(saved["residuals"]).to(dev).view(torch.int32),
            on_card.view(torch.int32)):
        fail("the saved residual stack differs from the stack on the card")
    moved = float(np.abs(saved["w"] - saved2["w"]).max())
    if not (np.abs(saved["residuals"]).sum() > 0 and moved > 0):
        fail(f"the resumed round moved the model by {moved} or left the "
             f"residuals all zero")
    log(f"[ckpt] resumed from the round-2 checkpoint bitwise; round 3 moved "
        f"the model by up to {moved:.3e}; residual stack [{n}, "
        f"{snap.shape[1]}] and model read back bitwise equal to "
        f"residual_snapshot() and the stack on {dev}")


def phase_parity(torch, dev: str = "cuda") -> None:
    def run(device, engine):
        task, specs = _fleet("mlp_micro", 4, 600, 8, "topk_threshold")
        return _sim_run(torch, task, specs, engine, 4, device, seed=3)

    for engine in ("sequential", "batched"):
        card, host = run(dev, engine), run("cpu", engine)
        _same_host_results(card, host, f"card vs CPU ({engine})")
        log(f"[parity] {engine}: card vs CPU {len(card['events'])} "
            f"identical events, final acc "
            f"{card['hist'].records[-1].accuracy} vs "
            f"{host['hist'].records[-1].accuracy}, loss "
            f"{card['hist'].records[-1].loss} vs "
            f"{host['hist'].records[-1].loss}")


def _padded(torch, flat, nb: int, blk: int):
    pb = torch.zeros(nb * blk, dtype=torch.float32, device=flat.device)
    pb[:flat.numel()] = flat
    return pb.view(nb, blk)


def phase_pod(torch, dev: str = "cuda") -> dict:
    """The 4-pod datacenter round at full cnn width; returns the launch
    counts of its 3 compact rounds."""
    from repro_torch.dist import collectives as col
    from repro_torch.kernels.checks import bits_equal
    from repro_torch.launch.profile_pod import (LOCAL_K, MESH, RATE,
                                                build_pod_round)

    pr = build_pod_round(dev)
    sync, nb = pr.sync, pr.n_blocks
    n_pods, n_shards = MESH["pod"], MESH["data"] * MESH["model"]
    if (pr.dim, nb, pr.params.shape[1]) != (D_CNN, POD_NB, POD_BLK):
        fail(f"pod layout: dim {pr.dim}, nb {nb}, blk {pr.params.shape[1]}")
    if sync.path != "compact" or sync.wire != col.CompactWire(
            POD_NBL, POD_BLK, POD_BUDGET):
        fail(f"pod sync resolved to {sync.path} {sync.wire}")
    if pr.step.wire_bits_per_pod != 2 * 68_292 * 8:
        fail(f"wire bits per pod {pr.step.wire_bits_per_pod}")
    pb0 = pb = pr.params
    states, res = pr.opt_states, pr.residuals
    outs, seen = [], []
    want = {"compact_blocks": n_pods * n_shards,
            "magnitude_hist": 2 * n_pods * n_shards,
            "fused_momentum": n_pods * LOCAL_K, "ef_topk": 0, "ssd": 0}
    batches = [pr.draw() for _ in range(POD_ROUNDS)]
    if dev == "cuda":
        torch.cuda.synchronize()
    reset_counts()
    before = counts()
    for rnd in range(POD_ROUNDS):
        t0 = time.perf_counter()
        new_pb, states, new_res, loss = pr.step(pb, states, batches[rnd], res)
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        now = counts()
        c = {key: now[key] - before[key] for key in now}
        before = now
        s0, s1 = pr.split.spans[-1]
        seen.append(pr.split.last_deltas)
        log(f"[pod] round {rnd}: loss {float(loss):.6f}, wall {wall:.6f}s "
            f"(local rounds {s0 - t0:.6f}s, sync {s1 - s0:.6f}s), "
            f"launches {c}")
        if not math.isfinite(float(loss)):
            fail(f"pod round {rnd}: loss {float(loss)}")
        if c != want:
            fail(f"pod round {rnd}: launches {c}, expected {want}")
        acc = seen[rnd] + res
        kept = acc - new_res
        if not bits_equal(kept + new_res, acc):
            fail(f"pod round {rnd}: kept + r' != delta + r")
        live = (kept != 0).sum(dim=-1)
        if int(live.max()) > POD_BUDGET:
            fail(f"pod round {rnd}: {int(live.max())} live entries in a "
                 f"block, budget {POD_BUDGET}")
        if not torch.allclose(new_pb, pb - kept.mean(dim=0), rtol=1e-5,
                              atol=1e-6):
            fail(f"pod round {rnd}: params' != params - mean(kept)")
        outs.append((new_pb, new_res))
        pb, res = new_pb, new_res
    launches = counts()

    # gate: the dense-carrier reference wire on the same deltas
    ref_sync = col.make_pod_sync(MESH, nb * POD_BLK, rate=RATE, n_blocks=nb,
                                 wire="reference")
    p_r, r_r = pb0, torch.zeros_like(res)
    for rnd, (p_c, r_c) in enumerate(outs):
        p_r, r_r = ref_sync(p_r, seen[rnd], r_r)
        if not torch.allclose(p_c, p_r, rtol=1e-5, atol=1e-6):
            fail(f"pod gate round {rnd}: compact params differ from the "
                 f"reference wire's (max abs "
                 f"{(p_c - p_r).abs().max().item()})")
        if not bits_equal(r_c, r_r):
            fail(f"pod gate round {rnd}: residuals differ from the "
                 f"reference wire's")
    log(f"[pod] gate: compact == reference wire over {POD_ROUNDS} carried "
        f"rounds (params rtol 1e-5, residuals bitwise)")

    # δ = 0.3 is above the crossover 1/P: `auto` resolves to dense
    dense = build_pod_round(dev, 0.3, task=pr.task)
    if dense.sync.path != "dense":
        fail(f"δ=0.3 resolved to {dense.sync.path}")
    dbatch = dense.draw()
    reset_counts()
    new_pb, _, new_res, loss = dense.step(pb, states, dbatch, res)
    if dev == "cuda":
        torch.cuda.synchronize()
    c = counts()
    dwant = {"compact_blocks": 0, "magnitude_hist": 2 * n_pods,
             "fused_momentum": n_pods * LOCAL_K, "ef_topk": n_pods,
             "ssd": 0}
    log(f"[pod] dense round: loss {float(loss):.6f}, launches {c}")
    if c != dwant or not math.isfinite(float(loss)) \
            or not bool(torch.isfinite(new_pb).all()):
        fail(f"dense round: launches {c} (expected {dwant}), loss "
             f"{float(loss)}")
    return launches


def phase_podparity(torch, dev: str = "cuda") -> None:
    """mlp_micro local rounds and syncs on the card against the CPU."""
    from repro_torch.core import compression as C
    from repro_torch.dist import collectives as col, steps
    from repro_torch.kernels.checks import bits_equal
    from repro_torch.launch.profile_pod import TaskLM, pod_batches, pod_blocks
    from repro_torch.models.small import make_task
    from repro_torch.optim import momentum_sgd

    mesh, blk, rate, k, n_pods = {"pod": 2, "data": 2, "model": 1}, 64, \
        0.05, 3, 2
    task = make_task("mlp_micro", num_samples=600, test_samples=16,
                     batch_size=16)
    flat = task.init_fn(torch.Generator().manual_seed(1))
    dim = flat.numel()
    nb = pod_blocks(dim, blk, mesh["data"] * mesh["model"])
    batches = pod_batches(task, n_pods, k, 16, 5, "cpu")()

    def local_rounds(device):
        opt = momentum_sgd(0.05)
        local = steps.make_local_round_step(TaskLM(task), opt, k)
        params = C.unflatten_pytree(flat.to(device), task.spec)
        deltas = torch.zeros((n_pods, nb * blk), device=device)
        losses = []
        for p in range(n_pods):
            _, _, delta, loss = local(params, opt.init(params),
                                      {key: v[p].to(device)
                                       for key, v in batches.items()})
            deltas[p, :dim] = C.flatten_pytree(delta)[0]
            losses.append(float(loss))
        return deltas.view(n_pods, nb, blk), losses

    d_card, l_card = local_rounds(dev)
    _, l_cpu = local_rounds("cpu")
    for a, b in zip(l_card, l_cpu):
        if abs(a - b) > 1e-3 * abs(b):
            fail(f"podparity: pod losses {l_card} (card) vs {l_cpu} (CPU)")
    sync = col.make_pod_sync(mesh, nb * blk, rate=rate, n_blocks=nb)
    if sync.path != "compact":
        fail(f"podparity sync resolved to {sync.path}")
    pb = _padded(torch, flat, nb, blk)
    pc, rc = pb.to(dev), torch.zeros((n_pods, nb, blk), device=dev)
    ph, rh = pb.clone(), torch.zeros((n_pods, nb, blk))
    for rnd in range(2):       # the second sync carries a live residual
        pc, rc = sync(pc, d_card, rc)
        ph, rh = sync(ph, d_card.cpu(), rh)
        if not bits_equal(rc.cpu(), rh):
            fail(f"podparity sync {rnd}: residuals differ card vs CPU")
        if not torch.allclose(pc.cpu(), ph, rtol=1e-5, atol=1e-6):
            fail(f"podparity sync {rnd}: params differ card vs CPU")
    log(f"[podparity] pod losses card {l_card} vs CPU {l_cpu}; the card's "
        f"deltas synced on card and CPU: bitwise residuals, params within "
        f"rtol 1e-5")



# ------------------------------------------------------------ the LM family
LM_ARCHS = ("gemma3-4b", "starcoder2-15b", "gemma3-27b", "stablelm-3b",
            "grok-1-314b", "qwen3-moe-30b-a3b", "hymba-1.5b", "hubert-xlarge",
            "mamba2-780m", "paligemma-3b")
SERVE_ARCHS = ("gemma3-4b", "mamba2-780m")   # unreduced in `serve`


def card(dev: str) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def _peak_gib(torch, dev: str) -> str:
    if dev != "cuda":
        return "not measured (cpu)"
    return f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"


def _reset_peak(torch, dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _lm_batch(torch, cfg, B: int, S: int, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    tok = lambda n: torch.randint(0, cfg.vocab, (B, n), generator=g)
    if cfg.frontend == "frames":
        return {"frames": torch.randn(B, S, cfg.frame_dim, generator=g),
                "labels": tok(S)}
    if cfg.frontend == "patches":
        return {"patches": torch.randn(B, cfg.n_patches, cfg.patch_dim,
                                       generator=g),
                "tokens": tok(S - cfg.n_patches),
                "labels": tok(S - cfg.n_patches)}
    return {"tokens": tok(S), "labels": tok(S)}


NEAR_TIE = 0.05     # logits: about the int8 cache's error at these sizes
INT8_ATOL = 1e-2    # int8 logits card vs CPU: a q or p code may round apart


def int8_tracks(torch, a, b) -> tuple[bool, str]:
    """Whether the int8 cache's logits `b` track the compute cache's `a`
    ([B, ..., V], the last position read): corrcoef > 0.999, and in every
    row the int8 greedy token is the compute cache's, or one whose compute
    logit is within NEAR_TIE of the row's best (a near-tie that the int8
    rounding may decide either way). The bound is fixed: it does not grow
    with the int8 logits' own error."""
    corr = float(torch.corrcoef(torch.stack([a.reshape(-1),
                                             b.reshape(-1)]))[0, 1])
    ok, parts = corr > 0.999, [f"corrcoef {corr:.7f}"]
    for ra, rb in zip(a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])):
        ia, ib = int(ra.argmax()), int(rb.argmax())
        short = float(ra[ia] - ra[ib])
        ok &= short <= NEAR_TIE
        parts.append(f"greedy compute/int8 {ia}/{ib} (compute logit "
                     f"{short:.4f} below the best)")
    return ok, "; ".join(parts)


def _lm_outputs(torch, lm, flat, spec, dev: str) -> dict:
    """Loss, flat gradient, prefill and one-step decode logits, and the
    last logits of 16 decode steps from an empty compute and int8 cache,
    of `lm` at the parameters `flat` moved to `dev`."""
    import dataclasses
    from repro_torch.core import compression as C
    from repro_torch.launch.serve import grow_cache
    cfg = lm.cfg
    w = flat.to(dev).clone().requires_grad_(True)
    batch = {k: v.to(dev) for k, v in _lm_batch(torch, cfg, 2, 64,
                                                 0).items()}
    loss = lm.loss(C.unflatten_pytree(w, spec), batch)
    (grad,) = torch.autograd.grad(loss, w)
    out = {"loss": float(loss.detach()), "grad": grad.cpu()}
    if cfg.frontend == "frames":
        return out
    params = C.unflatten_pytree(w.detach(), spec)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        pl, cache = lm.prefill(params, inputs)
        pos = cfg.n_patches + inputs["tokens"].shape[1] \
            if cfg.frontend == "patches" else inputs["tokens"].shape[1]
        nxt = inputs["tokens"][:, :1]
        dl, _ = lm.decode_step(params, grow_cache(cache, pos + 1), nxt, pos)
        out.update(prefill=pl.cpu(), decode=dl.cpu())
        tok = batch["labels"][:, :16]
        for kv in ("compute", "int8"):
            m = dataclasses.replace(lm, kv_dtype=kv)
            c = m.init_cache(2, 16, device=dev)
            for t in range(16):
                logits, c = m.decode_step(params, c, tok[:, t:t + 1], t)
            out[kv] = logits[:, -1].cpu()
    return out


def phase_lm(torch, dev: str = "cuda") -> None:
    """All ten archs at their smoke configs, fp32 (TF32 off), on the card
    and on the CPU from the same weights: loss within rtol 1e-4, the flat
    gradient within relative L2 1e-3, prefill and decode logits within
    atol 1e-3; after 16 decode steps from an empty cache, the compute
    cache's last logits within atol 1e-3 and the int8 cache's within
    INT8_ATOL of the CPU's (whose int8 decode the CPU tests hold to the
    reference), and on the card the int8 cache tracking the compute cache
    (`int8_tracks`: corrcoef > 0.999, the same last greedy token up to
    near-ties within NEAR_TIE)."""
    from repro_torch.configs import get_config
    from repro_torch.core import compression as C
    from repro_torch.models.transformer import LM
    t0 = time.perf_counter()
    for arch in LM_ARCHS:
        lm = LM(get_config(arch).smoke(), dtype=torch.float32, remat=False)
        flat, spec = C.flatten_pytree(
            lm.init(torch.Generator().manual_seed(0)))
        a = _lm_outputs(torch, lm, flat, spec, dev)
        b = _lm_outputs(torch, lm, flat, spec, "cpu")
        rel = float((a["grad"] - b["grad"]).norm() / b["grad"].norm())
        msg = (f"[lm] {arch}: loss {a['loss']:.7f} card vs {b['loss']:.7f} "
               f"CPU, gradient relative L2 {rel:.3e}")
        if abs(a["loss"] - b["loss"]) > 1e-4 * abs(b["loss"]) or rel > 1e-3:
            fail(msg)
        if "prefill" in a:
            errs = {k: float((a[k] - b[k]).abs().max())
                    for k in ("prefill", "decode", "compute", "int8")}
            tracks, how = int8_tracks(torch, a["compute"], a["int8"])
            msg += (f", max abs logits error prefill {errs['prefill']:.3e} "
                    f"decode {errs['decode']:.3e}; after 16 decode steps "
                    f"compute cache {errs['compute']:.3e}, int8 cache "
                    f"{errs['int8']:.3e}; int8 vs compute on the card {how}")
            if max(errs["prefill"], errs["decode"], errs["compute"]) > 1e-3 \
                    or errs["int8"] > INT8_ATOL or not tracks:
                fail(msg)
        log(msg)
    log(f"[lm] ten archs held card vs CPU in "
        f"{time.perf_counter() - t0:.1f}s on {card(dev)}")


def phase_serve(torch, dev: str = "cuda", configs=None) -> None:
    """`launch.serve.serve()` on unreduced gemma3-4b (34 layers, d_model
    2560, vocab 262144, ~3.9 B parameters) and mamba2-780m (48 layers,
    d_model 1536), randomly initialised on the card, fp32: 4 requests at
    batch 2, prompt 16, gen 16, with tokens/s, wall and peak memory.
    Gates: decode logits at position P equal a prefill of P + 1 tokens
    (atol 2e-2); for the attention arch, 16 decode steps with an int8 KV
    cache track the compute cache (`int8_tracks`: corrcoef > 0.999, the
    same last greedy token up to near-ties within NEAR_TIE)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import grow_cache, serve
    from repro_torch.models.transformer import LM
    configs = configs or [get_config(a) for a in SERVE_ARCHS]
    for cfg in configs:
        t0 = time.perf_counter()
        _reset_peak(torch, dev)
        lm = LM(cfg, dtype=torch.float32, remat=False)
        params = lm.init(torch.Generator(device=dev).manual_seed(0), dev)
        _sync(torch, dev)
        t_init = time.perf_counter() - t0
        # the first call pays one-time costs (library and kernel loading)
        first = serve(lm, params, requests=2, batch=2, prompt_len=16, gen=2,
                      seed=0)
        res = serve(lm, params, requests=4, batch=2, prompt_len=16, gen=16,
                    seed=0)
        peak = _peak_gib(torch, dev)
        log(f"[serve] {cfg.name} ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, vocab {cfg.vocab}): {res['tokens_per_s']:.3f} "
            f"tokens/s, wall {res['wall_s']:.6f}s for 4 requests x 16 "
            f"tokens after a first call of 2 x 2 tokens "
            f"({first['wall_s']:.6f}s; init {t_init:.1f}s), peak memory "
            f"{peak}, sample {res['served'][0][:8]} on {card(dev)}")
        g = torch.Generator().manual_seed(1)
        tok = torch.randint(0, cfg.vocab, (2, 17), generator=g).to(dev)
        with torch.no_grad():
            _, cache = lm.prefill(params, {"tokens": tok[:, :16]})
            dl, _ = lm.decode_step(params, grow_cache(cache, 17),
                                   tok[:, 16:], 16)
            fl, _ = lm.prefill(params, {"tokens": tok})
        err = float((dl - fl).abs().max())
        msg = (f"[serve] {cfg.name}: decode at position 16 vs a prefill of "
               f"17 tokens, max abs logits error {err:.3e}")
        if err > 2e-2 or not bool(torch.isfinite(dl).all()):
            fail(msg)
        if cfg.has_attention:
            last = {}
            with torch.no_grad():
                for kv in ("compute", "int8"):
                    m = dataclasses.replace(lm, kv_dtype=kv)
                    c = m.init_cache(2, 16, device=dev)
                    for t in range(16):
                        logits, c = m.decode_step(params, c,
                                                  tok[:, t:t + 1], t)
                    last[kv] = logits.cpu()
            tracks, how = int8_tracks(torch, last["compute"], last["int8"])
            msg += f"; 16 int8-cache decode steps vs the compute cache: {how}"
            if not tracks:
                fail(msg)
        log(msg + f" ({time.perf_counter() - t0:.1f}s)")
        del params
        _reset_peak(torch, dev)


def _dc_args(extra: list):
    from repro_torch.launch import train
    return train.build_parser().parse_args(
        ["--mode", "datacenter", "--pods", "2", "--local-k", "2",
         "--steps", "3", "--quiet"] + extra)


class _CpuDrawnInit:
    """`LM.init` drawn on the CPU from the generator's seed and moved to
    the device, so that a run on the card and a run on the CPU start from
    the same weights."""

    def __enter__(self):
        import torch
        from repro_torch.core import compression as C
        from repro_torch.models.transformer import LM
        self._real = real = LM.init

        def init(lm, gen, device=None):
            cpu_gen = torch.Generator().manual_seed(gen.initial_seed())
            flat, spec = C.flatten_pytree(real(lm, cpu_gen))
            return C.unflatten_pytree(flat.to(device), spec)
        LM.init = init
        return self

    def __exit__(self, *exc):
        from repro_torch.models.transformer import LM
        LM.init = self._real


def _dc_full_width_witness(torch, dev: str, cfg, k: int, loss: float,
                           flags: list) -> None:
    """Witnesses for the datacenter run at full width, where its loss
    grows at the CLI's η_l 0.05. (1) From the same weights and batches
    (batch 8, sequences of 64) on the card and on the CPU: the gradient
    of `LM.loss` (bf16 logits, as the reference) and of the same loss
    with fp32 logits, each within rtol 1e-4 in loss and relative L2 1e-3
    (the `lm` phase's gates), beside how far the card's own gradient
    moves under a rounding-size change of the weights; then the first
    local round (k steps of
    momentum SGD) at η_l 0.05 and 0.005, whose deltas w0 − wk are printed
    card vs CPU (a step too large for the curvature amplifies the first
    gradient's rounding). (2) The run at η_l 0.005: the loss of one fixed
    batch lower after its 3 rounds than at the initial weights."""
    import numpy as np
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import compression as C
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.dist.steps import make_local_round_step
    from repro_torch.launch import train
    from repro_torch.models.transformer import LM, _ce
    from repro_torch.optim import momentum_sgd
    t0 = time.perf_counter()
    eta = _dc_args([]).eta_l
    lm = LM(cfg, dtype=torch.float32, remat=False)

    def head32(params, batch):        # LM.loss with fp32 logits
        x, pos, prefix = lm._embed_inputs(params, batch)
        h, _ = lm._stack(params, x, positions=pos, prefix_len=prefix)
        return _ce(h @ params["embed"]["embedding"].T, batch["labels"])

    flat, spec = C.flatten_pytree(lm.init(torch.Generator().manual_seed(0)))
    steps = [_lm_batch(torch, cfg, 8, 64, 10 + i) for i in range(k)]
    batches = {key: torch.stack([b[key] for b in steps]) for key in steps[0]}
    # the weights scaled by 1 + 1e-7·N(0, 1), the size of fp32 rounding
    nudged = flat * (1 + 1e-7 * torch.randn(
        flat.shape, generator=torch.Generator().manual_seed(3)))
    for name, fn in (("LM.loss", lm.loss), ("fp32-logit loss", head32)):
        out = {}
        for where, w0 in ((dev, flat), ("cpu", flat), ("nudged", nudged)):
            at = dev if where == "nudged" else where
            w = w0.to(at, copy=True).requires_grad_(True)
            val = fn(C.unflatten_pytree(w, spec),
                     {key: v.to(at) for key, v in steps[0].items()})
            out[where] = (float(val.detach()),
                          torch.autograd.grad(val, w)[0].cpu())
            del w, val
        (lc, gc), (lh, gh) = out[dev], out["cpu"]
        rel = float((gc - gh).norm() / gh.norm())
        own = float((out["nudged"][1] - gc).norm() / gc.norm())
        msg = (f"[datacenter] {cfg.name} gradient of {name} at the initial "
               f"weights, card vs CPU: loss {lc:.7f} vs {lh:.7f}, "
               f"relative L2 {rel:.3e} (norm {float(gh.norm()):.6f}); the "
               f"card's own gradient moves by {own:.3e} when the weights "
               f"are scaled by 1 + 1e-7·N(0, 1)")
        if abs(lc - lh) > 1e-4 * abs(lh) or not rel <= 1e-3:
            fail(msg)
        log(msg)
        del out, gc, gh
    del nudged
    for rate in (eta, 0.005):
        opt = momentum_sgd(rate, momentum=0.9)
        out = {}
        for where in (dev, "cpu"):
            params = C.unflatten_pytree(flat.to(where), spec)
            _, _, delta, loss1 = make_local_round_step(lm, opt, k)(
                params, opt.init(params),
                {key: v.to(where) for key, v in batches.items()})
            out[where] = (float(loss1), C.flatten_pytree(delta)[0].cpu())
            del params, delta
        (lc, dc), (lh, dh) = out[dev], out["cpu"]
        rel = float((dc - dh).norm() / dh.norm())
        msg = (f"[datacenter] {cfg.name} first local round (k {k}, η_l "
               f"{rate}) card vs CPU: loss {lc:.7f} vs {lh:.7f}, delta norm "
               f"{float(dc.norm()):.6f} vs {float(dh.norm()):.6f}, relative "
               f"L2 {rel:.3e}")
        if not (math.isfinite(lc) and bool(torch.isfinite(dc).all())):
            fail(msg)
        log(msg)
        del out, dc, dh
    del flat
    _reset_peak(torch, dev)
    # (2) at η_l 0.005: the loss of one fixed batch (32 sequences of the
    # run's data) at the initial weights and at the run's last checkpoint
    ckdir = os.path.join(HERE, "build", "dc_witness")
    shutil.rmtree(ckdir, ignore_errors=True)
    low = train.run_datacenter(_dc_args(flags + [
        "--eta-l", "0.005", "--device", dev, "--ckpt-dir", ckdir,
        "--ckpt-every", "3"]), cfg=cfg)
    w3 = CheckpointManager(ckdir).restore(3)["w"]
    shutil.rmtree(ckdir)
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=65, num_samples=2048)
    fixed = {key: torch.from_numpy(v).long().to(dev)
             for key, v in ds.batch(np.arange(32)).items()}
    with torch.no_grad():
        p0 = lm.init(torch.Generator(device=dev).manual_seed(0), dev)
        _, spec = C.flatten_pytree(p0)
        l0 = float(lm.loss(p0, fixed))
        del p0
        l3 = float(lm.loss(C.unflatten_pytree(
            torch.from_numpy(w3).to(dev), spec), fixed))
    msg = (f"[datacenter] {cfg.name} at η_l 0.005, 3 rounds: loss of a "
           f"fixed batch {l0:.6f} at the initial weights, {l3:.6f} after "
           f"round 2; the run's round-2 loss {low['loss']:.6f} (at η_l "
           f"{eta}: {loss:.6f}) ({time.perf_counter() - t0:.1f}s on "
           f"{card(dev)})")
    if not l3 < l0:
        fail(msg)
    log(msg)
    _reset_peak(torch, dev)


def phase_datacenter(torch, dev: str = "cuda",
                     cfg=None) -> tuple[int, int]:
    """`launch.train.run_datacenter` on the unreduced mamba2-780m (48
    layers, d_model 1536, ~0.78 B parameters), 2 pods, --local-k 2
    --rate 0.01 --steps 3, and --batch-size 8 in place of the CLI's 32 (a
    short run that still moves every pod). Gates: finite loss; comm_mb
    equal to steps x pods x the payload bits of a top-k keeping
    round(0.01·d) coordinates (values and int32 indices, 64 bits each,
    rounded to fp32 as the reference does, plus the 32-bit count header);
    fused_momentum launches == the α probe's 4 steps + steps x pods x k,
    and SSD kernel launches == 14 (5 forward, 9 backward) x the Mamba-2
    layers x those steps (remat is off, so no forward runs twice).
    Prints the wall per round split into local rounds, compression and
    aggregation, and the peak memory. Then `_dc_full_width_witness`, and
    the smoke config on the card and on the CPU from the same weights:
    identical comm_mb, loss within rtol 1e-3. Returns the run's
    fused_momentum and SSD launches."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import compression as C
    from repro_torch.launch import train
    from repro_torch.models.transformer import LM, _mixer
    from repro_torch.obs.profiling import PhaseTimers
    cfg = cfg or get_config("mamba2-780m")
    n_ssd = sum(m in ("ssm", "parallel") for m in
                cfg.layer_mixers() or [_mixer(cfg)] * cfg.n_layers)
    steps, pods, k, rate = 3, 2, 2, 0.01
    d = sum(int(np.prod(s)) for _, s in LM(cfg).param_spec())
    kept = C.num_keep(d, rate)
    want_mb = steps * pods * (float(np.float32(kept * 64)) + 32) / 8e6
    timers = PhaseTimers()
    _reset_peak(torch, dev)
    t0 = time.perf_counter()
    reset_counts()
    res = train.run_datacenter(
        _dc_args(["--rate", str(rate), "--batch-size", "8", "--device",
                  dev]), cfg=cfg, timers=timers)
    _sync(torch, dev)
    c = counts()
    wall = time.perf_counter() - t0
    split = {name: timers.totals[name] / steps
             for name in ("local", "compress", "aggregate")}
    log(f"[datacenter] {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, d = {d}): {json.dumps(res)}; per round "
        f"{sum(split.values()):.6f}s (local rounds {split['local']:.6f}s, "
        f"compression {split['compress']:.6f}s, aggregation "
        f"{split['aggregate']:.6f}s), whole run with the α probe "
        f"{wall:.3f}s, peak memory {_peak_gib(torch, dev)}, launches {c} "
        f"on {card(dev)}")
    want_fm = 4 + steps * pods * k
    if not math.isfinite(res["loss"]) or res["comm_mb"] != want_mb:
        fail(f"datacenter: {res}, expected comm_mb {want_mb} (k {kept})")
    if dev == "cuda" and c["fused_momentum"] != want_fm:
        fail(f"datacenter: fused_momentum launched {c['fused_momentum']} "
             f"times, expected {want_fm}")
    want_ssd = 14 * n_ssd * want_fm
    if dev == "cuda" and c["ssd"] != want_ssd:
        fail(f"datacenter: SSD kernels launched {c['ssd']} times, expected "
             f"14 x {n_ssd} Mamba-2 layers x {want_fm} steps = {want_ssd}")
    fm, n_ssd_launches = c["fused_momentum"], c["ssd"]
    _reset_peak(torch, dev)
    _dc_full_width_witness(torch, dev, cfg, k, res["loss"],
                           ["--rate", str(rate), "--batch-size", "8"])

    smoke = ["--arch", "mamba2-780m", "--rate", "0.05"]
    with _CpuDrawnInit():
        on_card = train.run_datacenter(_dc_args(smoke + ["--device", dev]))
        on_cpu = train.run_datacenter(_dc_args(smoke + ["--device", "cpu"]))
    log(f"[datacenter] smoke parity: card {on_card} vs CPU {on_cpu}")
    if on_card["comm_mb"] != on_cpu["comm_mb"] or \
            abs(on_card["loss"] - on_cpu["loss"]) > 1e-3 * abs(on_cpu["loss"]):
        fail(f"datacenter parity: card {on_card} vs CPU {on_cpu}")
    return fm, n_ssd_launches

# ------------------------------------------------------------ the mesh layer
TRAIN_ARCH = "gemma3-4b"
TRAIN_S, TRAIN_B, TRAIN_MB = 4096, 4, 4           # exactness, 2 layers
CELL_B, CELL_MB, CELL_STEPS = 2, 2, 3              # the real cell
CELL_RATIO = (0.8, 1.25)                           # estimate / measured
CELL_LR, CELL_MOMENTUM = 1e-2, 0.9


class OneRankGroup:
    """A world-size-1 process group (NCCL on the card, gloo on the CPU)
    over a FileStore in a temporary directory, destroyed on exit."""

    def __init__(self, dev: str):
        self.dev = dev

    def __enter__(self):
        import torch.distributed as dist
        self.dir = tempfile.mkdtemp()
        dist.init_process_group(
            "nccl" if self.dev == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(self.dir, "store"), 1),
            rank=0, world_size=1)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        shutil.rmtree(self.dir, ignore_errors=True)


def _flat_params(torch, lm, src):
    """A copy of `src` (the LM's parameters, views of one flat buffer) as
    views of a new flat buffer."""
    from repro_torch.core import compression as C
    from repro_torch.dist import sharding as shl
    return C.unflatten_pytree(shl.flat_local(src).clone(),
                              lm.param_spec())


def _train(torch, lm, params, batch, mb: int, steps: int = 1):
    """`steps` momentum-SGD train steps; returns (losses, flat params)."""
    from repro_torch.dist import sharding as shl
    from repro_torch.dist.steps import make_train_step
    from repro_torch.optim import momentum_sgd
    opt = momentum_sgd(1e-2, momentum=0.9)
    state = opt.init(params)
    step = make_train_step(lm, opt, microbatches=mb)
    losses = []
    for _ in range(steps):
        _, state, loss = step(params, state, batch)
        losses.append(loss)
    return losses, shl.flat_local(params)


def _capturing(opt, keep: dict):
    """`opt` whose update, while `keep["on"]`, first keeps its inputs:
    copies of the parameters and the momentum (the kernel updates them in
    place) and the gradient itself (which it only reads)."""
    from repro_torch.optim import Optimizer

    def update(grads, state, params):
        if keep.get("on"):
            keep.update(w=params.detach().clone(), mu=state["mu"].clone(),
                        g=grads)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update, opt.name)


def _check_update(torch, keep: dict, w, mu, *, lr: float, momentum: float,
                  chunk: int = 1 << 28) -> tuple[bool, float, int]:
    """The kernel's in-place result (`w`, `mu`) against
    `ref_fused_momentum` on the kept inputs, over the whole flat d in
    chunks (rtol 2e-5 / atol 1e-6, the kernels phase's). Returns (ok,
    max abs error, elements that differ at all)."""
    from repro_torch.kernels.ref import ref_fused_momentum
    ok, err, n_diff = True, 0.0, 0
    for a in range(0, w.numel(), chunk):
        b = min(w.numel(), a + chunk)
        rw, rmu = ref_fused_momentum(keep["w"][a:b], keep["mu"][a:b],
                                     keep["g"][a:b], lr=lr,
                                     momentum=momentum)
        for got, want in ((w[a:b], rw), (mu[a:b], rmu)):
            got, want = got.to(torch.float32), want.to(torch.float32)
            ok = ok and bool(torch.allclose(got, want, rtol=2e-5,
                                            atol=1e-6))
            err = max(err, float((got - want).abs().max()))
            n_diff += int((got != want).sum())
    return ok, err, n_diff


def _estimate_cell(args: list) -> subprocess.Popen:
    """The dry run's estimator on the real cell, in a process of its own
    (its `fake` default process group and this one's NCCL group cannot
    share a process)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun"] + args,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def phase_train(torch, dev: str = "cuda", smoke: bool = False) -> int:
    """The mesh layer's train path (`dist.steps.make_train_step` on DTensor
    parameters laid out by `dist.sharding` on a (1, 1) mesh).

    1. gemma3-4b at full width (d_model 2560, 8/4 heads of 256, d_ff
       10240, vocab 262144), 2 layers, fp32, S 4096, batch 4: the step
       with microbatches=4 against the full-batch step from the same
       weights (loss rtol 1e-5, params rtol 1e-4 / atol 1e-6), and the
       DTensor step against the plain-tensor step, bitwise;
    2. `make_prefill_step` / `make_decode_step` on the DTensor params
       against `LM.prefill` / `LM.decode_step` on the plain ones, bitwise:
       unreduced gemma3-4b in fp32, 2 requests, prompt 16, 4 decode
       steps;
    3. the real cell: unreduced gemma3-4b (34 layers, ~3.9 B parameters),
       bf16 params and compute, remat, momentum SGD (lr 1e-2, momentum
       0.9), S 4096, batch 2 in 2 microbatches, 3 steps: finite losses,
       fused_momentum launches == 3; the median step, the peak memory and
       the dry run's estimate of the peak (`launch.dryrun --mesh one`, run
       meanwhile in a subprocess), whose ratio must lie in CELL_RATIO.
       A fourth step, after the counts and the peak are read, keeps the
       update's inputs (bf16 w, f32 mu, the f32 accumulator as g) and
       holds the kernel's in-place result over the whole d (~3.9e9, past
       2^31) against `ref_fused_momentum` at rtol 2e-5 / atol 1e-6.
    Returns the real cell's fused_momentum launches. `smoke` runs the
    arch's smoke config at S 64 (a CPU rehearsal)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shl
    from repro_torch.dist.steps import make_decode_step, make_prefill_step
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models.transformer import LM
    t0 = time.perf_counter()
    full = get_config(TRAIN_ARCH)
    if smoke:
        full = full.smoke()
    S = 64 if smoke else TRAIN_S
    est_file = os.path.join(tempfile.mkdtemp(), "estimate.json")
    est = _estimate_cell(
        ["--arch", TRAIN_ARCH, "--shape", "train_4k", "--mesh", "one",
         "--batch", str(CELL_B), "--seq", str(S), "--microbatch",
         str(CELL_MB), "--device", dev, "--out", est_file]
        + (["--smoke"] if smoke else []))
    f32 = torch.float32
    with OneRankGroup(dev):
        mesh = make_local_mesh(1, 1, device_type=dev)
        # 1. exactness at full width, depth 2
        cfg = dataclasses.replace(full, n_layers=2)
        lm = LM(cfg, dtype=f32, param_dtype=f32, remat=True)
        p0 = lm.init(torch.Generator(device=dev).manual_seed(0), dev)
        batch = {k: v.to(dev) for k, v in
                 _lm_batch(torch, cfg, TRAIN_B, S, 1).items()}
        reset_counts()
        # deterministic kernels (memory-efficient attention's backward
        # sums with atomics otherwise), so that equal means bitwise
        torch.use_deterministic_algorithms(True)
        try:
            la, pa = _train(torch, lm, _flat_params(torch, lm, p0), batch, 1)
            lb, pb = _train(torch, lm, _flat_params(torch, lm, p0), batch,
                            TRAIN_MB)
            lmm = dataclasses.replace(lm, batch_axes=("data",),
                                      act_seq_axis="model")
            dp = shl.distribute(p0, shl.param_specs(p0, mesh), mesh)
            lc, pc = _train(torch, lmm, dp, batch, 1)
        finally:
            torch.use_deterministic_algorithms(False)
        n_fm = counts()["fused_momentum"]
        la, lb, lc = float(la[0]), float(lb[0]), float(lc[0])
        mb_ok = abs(la - lb) <= 1e-5 * abs(la) and bool(torch.allclose(
            pa, pb, rtol=1e-4, atol=1e-6))
        dt_ok = la == lc and bool(torch.equal(pa, pc))
        msg = (f"[train] {cfg.name} x 2 layers fp32, S {S}, batch "
               f"{TRAIN_B}: loss {la:.7f}, microbatches={TRAIN_MB} "
               f"{lb:.7f} (params max abs diff "
               f"{float((pa - pb).abs().max()):.3e}), DTensor on the (1, 1) "
               f"mesh {lc:.7f} (params max abs diff "
               f"{float((pa - pc).abs().max()):.3e}, bitwise {dt_ok}); "
               f"fused_momentum launches {n_fm}")
        if not (mb_ok and dt_ok and math.isfinite(la)):
            fail(msg)
        if dev == "cuda" and n_fm != 3:
            fail(msg + " (expected 3: one per step)")
        log(msg)
        del p0, pa, pb, pc, dp, batch
        _reset_peak(torch, dev)

        # 2. the builders against the model, unreduced fp32
        lm = LM(full, dtype=f32, param_dtype=f32, remat=False)
        lmm = dataclasses.replace(lm, batch_axes=("data",),
                                  act_seq_axis="model")
        params = lm.init(torch.Generator(device=dev).manual_seed(2), dev)
        dp = shl.distribute(params, shl.param_specs(params, mesh), mesh)
        g = torch.Generator().manual_seed(3)
        tok = torch.randint(0, full.vocab, (2, 20), generator=g).to(dev)
        with torch.no_grad():
            pl, pcache = lm.prefill(params, {"tokens": tok[:, :16]})
            ql, qcache = make_prefill_step(lmm)(dp, {"tokens": tok[:, :16]})
            same = torch.equal(pl, ql.full_tensor()) and all(
                torch.equal(pcache[k], qcache[k].full_tensor())
                for k in pcache)
            pcache = grow_cache(pcache, 20)
            qcache = shl.distribute(
                grow_cache({k: v.full_tensor() for k, v in qcache.items()},
                           20),
                shl.cache_specs(pcache, mesh), mesh)
            decode = make_decode_step(lmm)
            for t in range(16, 20):
                dl, pcache = lm.decode_step(params, pcache, tok[:, t:t + 1],
                                            t)
                el, qcache = decode(dp, qcache, tok[:, t:t + 1], t)
                same = same and torch.equal(dl, el.full_tensor())
        msg = (f"[train] builders on the (1, 1) mesh vs the model, "
               f"{full.name} fp32 ({full.n_layers} layers): prefill 2 x 16 "
               f"and 4 decode steps bitwise {same}")
        if not same:
            fail(msg)
        log(msg)
        del params, dp, pcache, qcache
        _reset_peak(torch, dev)

        # 3. the real cell
        bf16 = torch.bfloat16
        lm = LM(full, dtype=bf16, param_dtype=bf16, remat=True,
                batch_axes=("data",), act_seq_axis="model")
        params = lm.init(torch.Generator(device=dev).manual_seed(4), dev)
        dp = shl.distribute(params, shl.param_specs(params, mesh), mesh)
        del params
        batch = {k: v.to(torch.int32) for k, v in
                 _lm_batch(torch, full, CELL_B, S, 5).items()}
        batch = shl.distribute({k: v.to(dev) for k, v in batch.items()},
                               shl.batch_specs(batch, mesh), mesh)
        from repro_torch.dist.steps import make_train_step
        from repro_torch.optim import momentum_sgd
        keep: dict = {}
        opt = _capturing(momentum_sgd(CELL_LR, momentum=CELL_MOMENTUM),
                         keep)
        state = opt.init(dp)
        step = make_train_step(lm, opt, microbatches=CELL_MB)
        _reset_peak(torch, dev)
        reset_counts()
        walls, losses = [], []
        for _ in range(CELL_STEPS):
            t1 = time.perf_counter()
            _, state, loss = step(dp, state, batch)
            _sync(torch, dev)
            walls.append(time.perf_counter() - t1)
            losses.append(float(loss))
        n_cell = counts()["fused_momentum"]
        peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
        peak_gib = _peak_gib(torch, dev)
        # the kernel at the cell's size and dtypes, on a fourth step
        t1 = time.perf_counter()
        keep["on"] = True
        step(dp, state, batch)
        keep["on"] = False
        fm_ok, fm_err, fm_diff = _check_update(
            torch, keep, shl.flat_local(dp), state["mu"], lr=CELL_LR,
            momentum=CELL_MOMENTUM)
        d = keep["w"].numel()
        fm_msg = (f"[train] fused_momentum in the cell's fourth step vs "
                  f"ref_fused_momentum over the whole d = {d} "
                  f"({keep['w'].dtype} w, {keep['mu'].dtype} mu, "
                  f"{keep['g'].dtype} g; "
                  f"{max(0, d - 2**31)} elements past 2^31): max abs err "
                  f"{fm_err:.3e}, {fm_diff} elements differ, within rtol "
                  f"2e-5 / atol 1e-6 {fm_ok} "
                  f"({time.perf_counter() - t1:.1f}s)")
        keep.clear()
        if not fm_ok or (dev == "cuda" and not smoke and d <= 2**31):
            fail(fm_msg)
        log(fm_msg)
        out, err = est.communicate(timeout=900)
        if est.returncode != 0:
            fail(f"[train] the dry-run estimator failed:\n{err[-3000:]}")
        with open(est_file) as f:
            estimate = json.load(f)["memory"]["peak_bytes"]
        ratio = estimate / peak if peak else None
        walls.sort()
        msg = (f"[train] {full.name} ({full.n_layers} layers) bf16, remat, "
               f"S {S}, batch {CELL_B} in {CELL_MB} microbatches, "
               f"{CELL_STEPS} steps: losses {losses}, median step "
               f"{walls[len(walls) // 2]:.6f}s (all {walls}), "
               f"fused_momentum launches {n_cell}, peak memory "
               f"{peak_gib} ({peak} bytes), dry-run estimate "
               f"{estimate} bytes ({estimate / 2**30:.3f} GiB), "
               f"estimate / measured {ratio} on {card(dev)} "
               f"({time.perf_counter() - t0:.1f}s)")
        if not all(math.isfinite(x) for x in losses):
            fail(msg)
        if dev == "cuda" and (n_cell != CELL_STEPS or not
                              CELL_RATIO[0] <= ratio <= CELL_RATIO[1]):
            fail(msg)
        log(msg)
        del dp, state, batch
        _reset_peak(torch, dev)
    return n_cell


MESH_B, MESH_PROMPT, MESH_GEN = 2, 16, 16          # meshserve


def _greedy(torch, prefill, decode, params, tokens, gen: int, grow,
            dev: str):
    """Prefill `tokens` [B, P], then `gen` greedy decode steps (each the
    argmax of the last logits). Returns (the gen + 1 logits [B, 1, V] as
    plain tensors, the prefill wall, the decode wall); `grow(cache,
    length)` pads the prefill's cache for the decode."""
    plain = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    B, P = tokens.shape
    _sync(torch, dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens})
    cache = grow(cache, P + gen)
    out = [plain(logits)]
    _sync(torch, dev)
    t1 = time.perf_counter()
    for t in range(P, P + gen):
        tok = out[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        logits, cache = decode(params, cache, tok, t)
        out.append(plain(logits))
    _sync(torch, dev)
    return out, t1 - t0, time.perf_counter() - t1


def _wall(torch, dev: str, fn, *args) -> float:
    """The wall time of one call of fn(*args), the card synchronized on
    both sides."""
    _sync(torch, dev)
    t0 = time.perf_counter()
    fn(*args)
    _sync(torch, dev)
    return time.perf_counter() - t0


def phase_meshserve(torch, dev: str = "cuda", smoke: bool = False) -> dict:
    """Serving on the mesh layer: unreduced gemma3-4b (34 layers, d_model
    2560, GQA 8/4 heads of 256, d_ff 10240, vocab 262144) in bf16 on a
    (1, 1) mesh of a world-size-1 NCCL group, tp layout (tensor-parallel
    over `model`, sequence-parallel prefill): `make_prefill_step` of
    MESH_PROMPT tokens, then MESH_GEN greedy `make_decode_step`s at batch
    MESH_B, with DTensor parameters. Gate: every step's logits bitwise
    equal to the one-device `LM` on the same parameters (greedy from its
    own logits). Prints tokens/s, the prefill walls (the first and a
    second one) and the peak of each path beside the card's name and
    power limit. Returns the kernel launch counts of the
    mesh run (the serving path launches none of the four). `smoke` runs
    the smoke config (a CPU rehearsal)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shl
    from repro_torch.dist.steps import make_decode_step, make_prefill_step
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models.transformer import LM
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    if smoke:
        cfg = cfg.smoke()
    bf16 = torch.bfloat16
    lm = LM(cfg, dtype=bf16, param_dtype=bf16, remat=False)
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (MESH_B, MESH_PROMPT),
                           generator=g).to(dev)
    with OneRankGroup(dev):
        mesh = make_local_mesh(1, 1, device_type=dev)
        lmm = dataclasses.replace(lm, batch_axes=("data",),
                                  act_seq_axis="model")
        params = lm.init(torch.Generator(device=dev).manual_seed(6), dev)
        _reset_peak(torch, dev)

        def grow_mesh(cache, n):
            full = grow_cache({k: v.full_tensor() for k, v in cache.items()},
                              n)
            return shl.distribute(full, shl.cache_specs(full, mesh), mesh)

        with torch.no_grad():
            one, one_pre, one_dec = _greedy(
                torch, lm.prefill, lm.decode_step, params, tokens, MESH_GEN,
                grow_cache, dev)
            one_pre2 = _wall(torch, dev, lm.prefill, params,
                             {"tokens": tokens})
        one_peak = _peak_gib(torch, dev)
        dp = shl.distribute(params, shl.param_specs(params, mesh), mesh)
        del params
        _reset_peak(torch, dev)
        reset_counts()
        prefill = make_prefill_step(lmm)
        got, pre, dec = _greedy(torch, prefill, make_decode_step(lmm), dp,
                                tokens, MESH_GEN, grow_mesh, dev)
        launched = counts()
        peak = _peak_gib(torch, dev)
        # a second prefill on each path: what the first one paid once
        # (the first collectives, allocator growth) drops out
        pre2 = _wall(torch, dev, prefill, dp, {"tokens": tokens})
        same = all(torch.equal(a, b) for a, b in zip(one, got))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        shape_ok = all(tuple(a.shape) == (MESH_B, 1, cfg.vocab) for a in got)
        toks = MESH_B * MESH_GEN
        msg = (f"[meshserve] {cfg.name} ({cfg.n_layers} layers) bf16 on the "
               f"(1, 1) mesh, tp layout: prefill {MESH_B} x {MESH_PROMPT} "
               f"then {MESH_GEN} greedy decode steps; logits of all "
               f"{MESH_GEN + 1} steps bitwise equal to the one-device LM "
               f"{same} (finite {finite}, shape {shape_ok}); mesh "
               f"{toks / dec:.3f} tokens/s (decode {dec:.6f}s, prefill "
               f"{pre:.6f}s, a second prefill {pre2:.6f}s), peak {peak}; "
               f"one device {toks / one_dec:.3f} tokens/s (decode "
               f"{one_dec:.6f}s, prefill {one_pre:.6f}s, a second prefill "
               f"{one_pre2:.6f}s), peak {one_peak}; launches {launched} on "
               f"{card(dev)} "
               f"({time.perf_counter() - t0:.1f}s)")
        if not (same and finite and shape_ok):
            fail(msg)
        log(msg)
        del dp
        _reset_peak(torch, dev)
    return launched


def phase_podsync(torch, dev: str = "cuda", d: int = D_CNN,
                  blk: int = 1024) -> dict:
    """The cross-process pod sync (`make_pod_sync` on a `DeviceMesh`) on a
    (pod, data, model) = (1, 1, 1) mesh: cnn_fmnist's width (d =
    1,663,370 in blocks of 1024), δ 0.01 on the compact wire and δ 0.3
    on the dense wire, 3 EF rounds each. Gate: params, residuals and the
    wire model bitwise equal to the one-card `make_pod_sync({"pod": 1,
    ...})`'s. Launches per round of the cross-process sync: magnitude_hist
    2 and compact_blocks 1 (compact), magnitude_hist 2 and ef_topk 1
    (dense). Returns the launches of its last compact round."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives as col
    from repro_torch.dist import sharding as shl
    from repro_torch.kernels.checks import vec
    t0 = time.perf_counter()
    nb = -(-d // blk)
    shape = {"pod": 1, "data": 1, "model": 1}
    last = {}
    with OneRankGroup(dev):
        mesh = init_device_mesh(dev, (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        pspec = {"x": shl.P(("data", "model"), None)}
        dspec = {"x": shl.P("pod", ("data", "model"), None)}
        put = lambda t, spec: shl.distribute({"x": t}, spec, mesh)["x"]
        for wire, rate, want in (("compact", 0.01, {"magnitude_hist": 2,
                                                    "compact_blocks": 1}),
                                 ("dense", 0.3, {"magnitude_hist": 2,
                                                 "ef_topk": 1})):
            one = col.make_pod_sync(shape, nb * blk, rate=rate, n_blocks=nb,
                                    wire=wire)
            acr = col.make_pod_sync(mesh, nb * blk, rate=rate, n_blocks=nb,
                                    wire=wire)
            same = (one.bytes_per_device, one.payload_bits_per_pod) == \
                (acr.bytes_per_device, acr.payload_bits_per_pod)
            p1 = vec(nb * blk, 40, dev).view(nb, blk) * 0.01
            r1 = torch.zeros((1, nb, blk), device=dev)
            p2, r2 = put(p1.clone(), pspec), put(r1.clone(), dspec)
            per_round = []
            for i in range(3):
                delta = (vec(nb * blk, 41 + i, dev) * 1e-3).view(1, nb, blk)
                p1, r1 = one(p1, delta, r1)
                dd = put(delta, dspec)
                _sync(torch, dev)
                reset_counts()
                p2, r2 = acr(p2, dd, r2)
                _sync(torch, dev)
                c = {k: v for k, v in counts().items() if v}
                per_round.append(c)
                same = same and torch.equal(p1, p2.full_tensor()) and \
                    torch.equal(r1, r2.full_tensor())
            msg = (f"[podsync] {wire} wire, δ {rate}, d {d} in {nb} blocks "
                   f"of {blk}: 3 EF rounds across processes vs one card "
                   f"bitwise {same} (params, residuals, wire bits "
                   f"{acr.payload_bits_per_pod}); launches per round "
                   f"{per_round}")
            if not same or (dev == "cuda" and any(c != want
                                                  for c in per_round)):
                fail(msg)
            log(msg)
            if wire == "compact":
                last = per_round[-1]
    log(f"[podsync] {time.perf_counter() - t0:.1f}s on {card(dev)}")
    return last


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels.checks import CheckFailed

    t0 = time.perf_counter()
    try:
        phase_build(torch)
        rows = phase_kernels(torch)
        fm = phase_cli(torch)
        bt = phase_batched(torch)
        phase_threshold(torch)
        phase_ckpt(torch)
        phase_parity(torch)
        pod = phase_pod(torch)
        phase_podparity(torch)
        phase_lm(torch)
        phase_serve(torch)
        dc_fm, dc_ssd = phase_datacenter(torch)
        train_fm = phase_train(torch)
        phase_meshserve(torch)
        sync = phase_podsync(torch)
        ssd = phase_ssd(torch)
    except CheckFailed as e:
        fail(str(e))
    log(f"[datacenter] fused_momentum launches on the datacenter path: "
        f"{dc_fm}; SSD kernel launches there: {dc_ssd}")
    log(f"[train] fused_momentum launches on the mesh train path: "
        f"{train_fm}; [podsync] launches per compact round across "
        f"processes: {sync}")
    launches = {"fused_momentum": fm, "ef_topk": bt["ef_topk"],
                "magnitude_hist": bt["magnitude_hist"],
                "compact_blocks": pod["compact_blocks"]}
    meta = {
        "fused_momentum": ("triton", "src/repro_torch/kernels/fused_momentum.py",
                           "src/repro/kernels/fused_momentum.py:46"),
        "ef_topk": ("cuda", "src/repro_torch/kernels/csrc/ef_topk.cu",
                    "src/repro/kernels/ef_topk.py:57"),
        "magnitude_hist": ("cuda",
                           "src/repro_torch/kernels/csrc/magnitude_hist.cu",
                           "src/repro/kernels/magnitude_hist.py:56"),
        "compact_blocks": ("cuda",
                           "src/repro_torch/kernels/csrc/compact_blocks.cu",
                           "src/repro/kernels/compact_topk.py:72"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": row["library_ms"]})
    row = ssd["rows"]["mamba2-780m"]
    kernels.append({
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu", "replaces": None,
        "launches": dc_ssd, "max_rel_l2": ssd["max_rel_l2"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
        "library_ms": None, "device_ms": row["device_ms"]})
    log(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
