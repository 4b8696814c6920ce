"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --launch-times SRC

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's main path on the card:

  1. the card's name and power limit, and the kernel build (``nvcc -Xptxas
     -v``: registers, shared memory and spills);
  2. the ``ds_estep`` kernels against their plain PyTorch version at the
     shapes the main path gives them and at edge shapes, each shape on its
     route and, where that is the task route, on the group route too
     (logp bit-equal, post within tolerance, zero-vote tasks exactly
     uniform, repeatable), a grid of class and vote counts, and an
     unaligned idx;
  3. the offline Dawid-Skene EM (full confusion, 20 iterations) on 2^20
     synthetic tasks, twice, bit for bit, every E-step on the task route,
     and against the CPU on a slice;
  4. the streaming labeling service (``skewed_adaptive5`` with the EM
     refresh every 40 ticks) for 1440 ticks x 256 replications through the
     front door (``scenarios.run`` on the registry spec, its config equal
     to ``get_stream_config``'s), then through ``run_stream`` on the same
     seed, bit for bit, its E-steps on the task route, and its first 8
     replications against a CPU run of the port with the same initial
     state and arrivals;
  5. timings: the launch floor (a one-element ``zero_()``); the ``ds_estep``
     routes in turns per call (CUDA events) and on the device
     (``torch.profiler``) beside the bound and the plain version, at the
     refresh, offline C4 and offline C8 shapes; the stream's ticks per
     second, and profiled windows of the
     offline EM (the E-step's share) and of the stream (kernels and device
     busy time per tick);
  6. the ``entropy_scores`` kernels against their plain version at the
     learner's widths, odd shapes, the LM vocab and the learning path's
     shapes, in float32 and bfloat16, with H in [0, log V], and the narrow
     route bit-equal to the old narrow kernel (``narrow_v1``) there and
     over a grid of widths, ragged N and unaligned bases;
  7. the hybrid-learning loop (``run_learning`` on the registry's
     ``hybrid_small`` spec) at 64
     replications x 10 rounds x 60 fit steps, on the workload's own
     dataset and on an MNIST-sized one, twice each, bit for bit, with one
     entropy launch per round and the curve invariants; its first 8
     replications against a CPU run of the port on the same draws; then
     the timings of phases 6-7: the entropy kernel per call and on the
     device beside its bound, its plain version and
     ``Categorical.entropy`` (the narrow route and ``narrow_v1`` in turns
     at the learning shapes), replications per second, and a profiled
     round (kernels per round, device idle share);
  8. the ``flash_attention`` kernel against its plain version: the
     reference tests' grid in float32 (FMA kernel) and bfloat16
     (tensor-core kernel), the encoder's full-width micro-batch (64, 10 / 1
     heads, 48 tokens, D = 256), the training shape (4 x 512 tokens), the
     model's window binding at 4096 tokens, a ragged head dim and rows that
     are not 16-byte aligned;
  9. both ``linear_scan`` routes' forward kernels (sequential, and
     chunked: chunks of the recurrence composed in order) against their
     plain versions, bit for bit: the reference tests' grid, the encoder's
     RG-LRU shape (64, 48, 2560), the training shape (4, 512, 2560),
     (2, 4096, 2560) and a ragged length, with and without h0; the chunked
     plain version within the scan's tolerance of the sequential one, and
     the wrapper on the route its shape gives;
 10. LM-featured hybrid learning through the full-width recurrentgemma-2b
     (2.89 B parameters, random weights from a seed): ``run_learning(
     "hybrid_small")`` with ``features.kind="lm"`` at 64 replications x 10
     rounds x 60 fit steps on 1500 + 500 tasks of 48 tokens (32
     micro-batches of 64), twice, bit for bit, with 8 flash and 18 scan
     launches per micro-batch; the kernels' forward against the plain
     versions' forward on the card; a reduced model on the card against
     the port on the CPU; tasks embedded per second, replications per
     second, the encoder's device idle share, and the kernels' times
     beside their bounds, their plain versions and (flash) SDPA, and both
     scan routes timed at the encoder's, the training and the long shape
     and over (B, S) at the model's width;
 11. the ``streaming_xent`` forward and backward kernels against their
     plain versions: the reference test's shapes in float32 and bfloat16,
     the training shape (2048, 256000) and ignored rows; loss, lse and
     dlogits, and their times beside the bounds, the plain versions and
     ``F.cross_entropy``;
 12. the ``flash_attention`` and both ``linear_scan`` routes' backward
     kernels against their plain backward versions at phases 8-9's shapes
     and the training shapes (4 x 512 tokens), with times beside SDPA's
     backward and the bounds, and a check that gradients reach every input
     on the card;
 13. training the full-width recurrentgemma-2b (2.89 B parameters from a
     seed) for 5 steps on a fixed 4 x 512-token batch with remat and AdamW
     through ``Trainer.run``, twice, bit for bit; the loss falls, the
     launch counts per step are as the model's layers give them (the
     scans on the chunked route); steps and tokens per second, peak
     memory, a profiled step, and the step profiled again with the scans
     on the sequential route and back; a reduced model
     on the card against the CPU; a crash, restore and continue at reduced
     size equal to a straight run;
 14. the learner-aware stream tick at phase 4's scale (1440 ticks x 256
     replications): (a) ``skewed_learner_fused`` (the learner fused into
     the posterior, uncertainty-first routing) with the EM refresh, (b)
     ``chance_hard`` (scored routing) with ``uncertain_learnable``
     admission (the learnability head), (c) ``stream_sharded`` (8 shards,
     pressure stealing) for 480 ticks and (d) the same at 20x its rate for
     480 ticks, where shards do steal ((b) also at 480 ticks); each twice,
     bit for bit in every integer
     output, conservation exact, (a)'s 216 E-steps on the task route,
     ``model_known > 0`` with the learner, as much stolen as donated, and
     the first 8 replications equal to a CPU run of the port on the same
     initial state and arrivals (else the first differing tick and state
     are named); ticks per second, and a profiled 80-tick window of (a)
     and (b);
 15. the scenario front door and the live serve path: (a) the registry
     smoke (``repro_torch.scenarios.smoke``) on the card, every (scenario,
     ported engine) pair, the pairs not ported yet listed as ``[TODO]``;
     (b) ``serve_tick`` driven directly for 2000 ticks on
     ``serve_default``, ``stream_sharded`` and ``chance_hard`` with
     ``uncertain_learnable`` admission, injections steering each shard's
     backlog near its capacity: each twice, bit for bit, conservation
     exact every tick, as much stolen as donated, the first 200 ticks equal
     to the port on the CPU (else the first differing tick and key are
     named); serve ticks per second and a profiled 80-tick window (kernels
     and host copies per tick, device idle share); (c) the HTTP server
     (``LabelServer``) on a loopback port: the launcher's smoke (4 clients
     x 8 tasks), then 16 clients x 64 waiting tasks on ``serve_default``,
     every one answered with conservation exact; answered tasks per
     second, p50 / p95 wall latency and the tick's cold / warm time.

It exits nonzero as soon as a phase fails, prints one ``{"kernels": ...}``
JSON line, and ends with ``{"ok": true, "device": ...}``. It imports only
torch, numpy and the port (``src/repro_torch``), and needs no network.

With ``--launch-times SRC`` it only prints the per-call times of
``ds_estep`` at the refresh shape and of ``entropy_scores`` at the learning
shapes through the package under SRC (another commit's ``src`` unpacked
beside this one, say), to compare two launch paths in turns in one run.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (data sheet)
H100_F32_FLOPS = 67e12              # H100 SXM float32, no tensor cores
H100_BF16_FLOPS = 989e12            # H100 SXM bfloat16 tensor cores, dense
# phases 10 and 13: the full-width model (a rehearsal on a small machine
# sets these to True)
EMBED_REDUCED = False
TRAIN_REDUCED = False


def fail(msg: str):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` calls, after two
    warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, n: int) -> float | None:
    """Device time of one ``fn()`` in ms, from a CUDA graph of ``n`` calls
    replayed back to back (no host time between launches), after two
    warm-up calls on a side stream; None if ``fn`` cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / (3 * n)
    except RuntimeError as exc:
        say(f"[time] CUDA graph capture failed: {str(exc)[:160]}")
        torch.cuda.synchronize()
        return None


def fmt_us(t_ms) -> str:
    return "not measured" if t_ms is None else f"{t_ms * 1e3:.2f} us"


def device_profile(fn):
    """Run ``fn()`` under ``torch.profiler`` and return ``(wall_s, kernels,
    busy_us, by_name)``: the host wall time (profiler on), the number of
    device kernels, their summed device time and that time per kernel
    name. ``kernels`` is 0 where the profiler sees no device activity."""
    wall, events = kernel_events(fn)
    by_name = {n: sum(t) for n, t in events.items()}
    return (wall, sum(len(t) for t in events.values()),
            sum(by_name.values()), by_name)


def kernel_events(fn, cpu: bool = True):
    """Run ``fn()`` under ``torch.profiler`` and return ``(wall_s, {kernel
    name: [device time of each recorded launch in us]})``, the host wall
    time with the profiler on. A window of long kernels can come back with
    fewer events than launches (seen on an H100), so a kernel's time is the
    mean over the events recorded, not the sum over the launches made.
    ``cpu=False`` records device activity only (a far smaller trace for
    windows of many small launches)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return wall, out


def mean_us(events, match):
    """The summed mean device time of the kernels whose name holds
    ``match`` (one launch of a wrapper may run several), and the number of
    events seen."""
    hits = {n: t for n, t in events.items() if match in n}
    return (sum(sum(t) / len(t) for t in hits.values()),
            sum(len(t) for t in hits.values()))


def launch_floor_us() -> float:
    """The device time of the smallest launch the card makes: a
    one-element ``zero_()``, by the profiler, averaged over 200 launches."""
    z = torch.zeros(1, device="cuda")

    def zeros():
        for _ in range(200):
            z.zero_()
    events = kernel_events(zeros)[1]
    times = [t for ts in events.values() for t in ts]
    return sum(times) / len(times) if times else float("nan")


def estep_bound_ms(B, R, C, T, V):
    """Least time for the E-step on an H100 SXM: every input read once and
    every output written once at the memory rate, or its float32 operations
    (V adds, one subtract, max, exp, sum and divide per class) at the
    float32 rate, whichever is larger."""
    nbytes = 4 * (B * T * V + B * R * C + 2 * B * T * C)
    flops = B * T * C * (V + 5)
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def entropy_bound_ms(N, V, elt):
    """Least time for the entropy of N rows of V logits on an H100 SXM: the
    logits read once and the N float32 entropies written once at the memory
    rate, or its ~5 float32 operations per logit (subtract, exp, add,
    fused multiply-add, max) at the float32 rate, whichever is larger."""
    nbytes = N * V * elt + 4 * N
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 5 * N * V / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def flash_bound_ms(B, Hq, Hkv, Sq, Sk, D, elt, causal, window):
    """Least time for attention on an H100 SXM: q, k, v read once and o
    written once at the memory rate, or the two products over the (q, k)
    pairs the masks keep (2 D multiply-adds each for q.k and p v) at the
    bfloat16 tensor-core rate, whichever is larger."""
    nbytes = elt * (2 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D)
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= k <= q
    if window > 0:
        keep &= q - k < window
    flops = 4 * D * int(keep.sum()) * B * Hq
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def scan_bound_ms(B, S, D, elt, h0):
    """Least time for the recurrence on an H100 SXM: a and b read once, h
    written once (h0 read once) at the memory rate, or its 2 float32
    operations per element at the float32 rate."""
    nbytes = 3 * B * S * D * elt + (4 * B * D if h0 else 0)
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2 * B * S * D / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def xent_bound_ms(N, V, elt, backward):
    """Least time for the cross entropy of N rows of V logits on an H100
    SXM. Forward: the logits and the targets read once, loss and lse
    written once; backward: the logits, targets, lse and loss gradient read
    once, dlogits written once; against ~4 float32 operations per logit
    (subtract, exp, add, max or multiply) at the float32 rate."""
    nbytes = N * V * elt * (2 if backward else 1) + 12 * N
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 4 * N * V / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def flash_bwd_bound_ms(B, Hq, Hkv, Sq, Sk, D, elt, causal, window):
    """Least time for attention's backward on an H100 SXM: q, o, do, k, v
    and lse read once, dq, dk and dv written once at the memory rate, or
    five products over the (q, k) pairs the masks keep (s = q k^T
    recomputed from lse, dp = do v^T, dv = p^T do, dq = ds k, dk = ds^T q;
    D multiply-adds each) at the bfloat16 tensor-core rate, whichever is
    larger."""
    nbytes = (elt * (4 * B * Hq * Sq * D + 4 * B * Hkv * Sk * D)
              + 4 * B * Hq * Sq)
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= k <= q
    if window > 0:
        keep &= q - k < window
    flops = 10 * D * int(keep.sum()) * B * Hq
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def scan_bwd_bound_ms(B, S, D, elt):
    """Least time for the recurrence's backward on an H100 SXM: a, h and g
    read once, da and db written once, h0 read and dh0 written once, at the
    memory rate, or its 3 float32 operations per element at the float32
    rate."""
    nbytes = 5 * B * S * D * elt + 8 * B * D
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 3 * B * S * D / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def make_estep_inputs(gen, B, W, C, T, V, dev):
    R = W * C + 1
    shape_r = (R, C) if B is None else (B, R, C)
    shape_i = (T, V) if B is None else (B, T, V)
    rows = torch.log(torch.rand(shape_r, generator=gen, device=dev) * 0.9
                     + 0.05)
    rows[..., R - 1, :] = 0.0
    idx = torch.randint(0, R, shape_i, generator=gen, device=dev,
                        dtype=torch.int32)
    return rows.contiguous(), idx.contiguous()


def best_call_us(fn, reps=500, runs=5) -> float:
    """Per-call time of ``fn()`` in us: CUDA events around ``reps``
    back-to-back calls, the fastest of ``runs`` runs (host work included,
    as a caller pays it)."""
    return 1e3 * min(cuda_ms(fn, reps) for _ in range(runs))


def flat_state(part) -> dict:
    """A run-state part (a dict of tensors, learners among them) as one flat
    dict of tensors; {} for None."""
    flat = {}
    for k, v in (part or {}).items():
        if torch.is_tensor(v):
            flat[k] = v
        else:
            flat.update({f"{k}.{f}": x for f, x in zip(v._fields, v)})
    return flat


def stream_learner_phase(card: str):
    """Phase 14: the learner-aware stream tick on the card (see the module
    docstring); fails at the first check that does not hold."""
    from repro_torch.kernels.ds_estep import ds_estep
    from repro_torch.labelstream import router
    from repro_torch.labelstream.arrivals import ArrivalConfig
    from repro_torch.labelstream.routing import RoutingConfig
    from repro_torch.scenarios import get_stream_config

    H, N, SEED, n8 = 1440, 256, 0, 8
    refresh = {"refresh_every": 40, "refresh_iters": 6}
    runs = [
        ("a", "skewed_learner_fused with the refresh",
         get_stream_config("skewed_learner_fused", refresh), H),
        # (b), (c) and (d) run a third of the horizon, to keep the smoke
        # run near half its time limit with phase 15 after them
        ("b", "chance_hard with uncertain_learnable admission, horizon cut "
         f"to {H // 3} ticks",
         get_stream_config("chance_hard", {"routing": RoutingConfig(
             enabled=True, admission="uncertain_learnable")}), H // 3),
        ("c", "stream_sharded (8 shards, pressure stealing), horizon cut "
         f"to {H // 3} ticks",
         get_stream_config("stream_sharded"), H // 3),
        # the registry's stream_sharded never builds a backlog, so nothing
        # is stolen; at 20x its rate shards do steal
        ("d", "stream_sharded at 20x its rate (stealing under load), "
         f"horizon cut to {H // 3} ticks",
         get_stream_config("stream_sharded", {"arrivals": ArrivalConfig(
             kind="poisson", rate=0.8)}), H // 3),
    ]
    tick_us = {}
    for label, what, cfg, h in runs:
        tag = f"[learner-stream {label}]"
        n_refresh = h // cfg.refresh_every if cfg.refresh_every else 0
        ds_estep.launches = ds_estep.task_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = router.run_stream(cfg, h, n_reps=N, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, task = ds_estep.launches, ds_estep.task_launches
        check(launches == task == n_refresh * cfg.refresh_iters,
              f"{tag} made {launches} E-step launches ({task} on the task "
              f"route), expected {n_refresh * cfg.refresh_iters}")
        total = lambda k: int(out[k].sum().item())
        lhs = total("arrived")
        rhs = (total("done_all") + total("backlog_end")
               + total("in_flight_end") + total("dropped"))
        say(f"{tag} {what}: {N} reps x {cfg.n_shards} shards x {h} ticks in "
            f"{secs:.2f} s ({h / secs:.1f} ticks/s, first run); ds_estep "
            f"launches {launches} (task route {task}); model_known "
            f"{total('model_known')}, stolen {total('stolen')}, donated "
            f"{total('donated')}; {card}")
        say(f"{tag} conservation: arrived {lhs} == done {total('done_all')} "
            f"+ backlog {total('backlog_end')} + in flight "
            f"{total('in_flight_end')} + dropped {total('dropped')}")
        check(lhs == rhs, f"{tag} conservation fails")
        check(total("stolen") == total("donated"),
              f"{tag} stolen {total('stolen')} != donated "
              f"{total('donated')}")
        if cfg.learner.enabled:
            check(total("model_known") > 0, f"{tag} model_known is 0")
        if label == "d":
            check(total("stolen") > 0, f"{tag} nothing was stolen")
        ints = lambda o: {
            **{k: v for k, v in o.items() if torch.is_tensor(v)
               and not v.is_floating_point()},
            **{f"series.{k}": v for k, v in o["series"].items()},
            **{f"per_shard.{k}": v for k, v in o["per_shard"].items()}}
        out2 = router.run_stream(cfg, h, n_reps=N, seed=SEED, device="cuda")
        first, second = ints(out), ints(out2)
        diff = [k for k in first if not torch.equal(first[k], second[k])]
        check(not diff, f"{tag} is not repeatable on the card: {diff}")
        say(f"{tag} second run with the same seed: every integer output "
            "equal")
        summ = router.stream_summary(cfg, out)
        say(f"{tag} summary " + json.dumps(summ, sort_keys=True))
        for k in ("sustained_rate", "accuracy", "mean_tis", "cost"):
            check(math.isfinite(summ[k]) and summ[k] > 0,
                  f"{tag} summary {k}={summ[k]}")

        # the first 8 replications against the port on the CPU, on the same
        # initial state and arrivals
        ws, banks, seeds = router.draw_init(cfg, N, SEED)
        sub = lambda d: {k: v[:n8] for k, v in d.items()}
        n_new, n_arr = router.draw_arrivals(cfg, h, N, seed=SEED,
                                            device="cuda")
        arr8 = (n_new[:, :n8].cpu(), n_arr[:, :n8].cpu())
        t0 = time.perf_counter()
        ref = router.run_stream(
            cfg, h, n_reps=n8, device="cpu",
            init=router.state_from_numpy(cfg, sub(ws), sub(banks),
                                         seeds[:n8], "cpu"),
            arrivals=arr8)
        cpu_s = time.perf_counter() - t0
        mine = {k: v[:n8].cpu() for k, v in first.items()}
        theirs = ints(ref)
        cpu_diff = [k for k in mine if not torch.equal(mine[k], theirs[k])]
        if cpu_diff:
            tick = h
            for k in ("finalized", "backlog", "in_flight"):
                neq = (mine[f"series.{k}"] != theirs[f"series.{k}"]).any(0)
                if neq.any():
                    tick = min(tick, int(neq.nonzero()[0]))
            say(f"{tag} card vs CPU (8 reps): integer outputs differ in "
                f"{cpu_diff}; first differing tick {tick}")
            if tick < h:
                # the cause: rerun both to that tick and name the state
                # that differs first
                warm = float(np.float32(0.3 * h * cfg.dt))
                st = {}
                for d in ("cuda", "cpu"):
                    init = router.state_from_numpy(
                        cfg, sub(ws), sub(banks), seeds[:n8], d)
                    _, st[d] = router._run_one(
                        cfg, tick + 1, init, warm, 1.0, None,
                        (arr8[0][:tick + 1], arr8[1][:tick + 1]))
                for part in ("ws", "win", "bl", "learner"):
                    a, b = (flat_state(st[d][part]) for d in ("cuda", "cpu"))
                    for k, va in a.items():
                        vb = b[k]
                        if not torch.equal(va.cpu(), vb):
                            dv = (va.cpu().double() - vb.double()).abs()
                            dv = dv[torch.isfinite(dv)]
                            say(f"{tag}   cause at tick {tick}: {part}.{k} "
                                f"differs (max |d| "
                                f"{dv.max().item() if dv.numel() else 'n/a'})")
            fail(f"{tag} card and CPU integer outputs differ")
        say(f"{tag} card vs CPU ({n8} reps, {h} ticks): every integer "
            f"output equal (CPU run {cpu_s:.1f} s)")
        tick_us[label] = 1e6 * secs / h

    # where a tick's time goes: 80 ticks of (a) and (b) under the profiler
    for label, _, cfg, _ in runs[:2]:
        Hp = 80
        wall, n_k, busy, by_name = device_profile(
            lambda: router.run_stream(cfg, Hp, n_reps=N, seed=SEED + 1,
                                      device="cuda"))
        if n_k:
            say(f"[profile] learner-stream {label}, {Hp} ticks: "
                f"{n_k / Hp:.0f} kernels per tick, device busy "
                f"{busy / Hp:.0f} us per tick; wall per tick "
                f"{wall / Hp * 1e6:.0f} us with the profiler on, "
                f"{tick_us[label]:.0f} us without: device idle "
                f"{(1 - busy / Hp / tick_us[label]) * 100:.1f}% of the "
                f"unprofiled tick; {card}")
            for name, us in sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:6]:
                say(f"[profile]   {us / Hp:8.1f} us/tick  {name[:90]}")
        else:
            say(f"[profile] learner-stream {label}: device time not "
                "measured (no device events)")


def serve_schedule(cfg, rng, backlog):
    """One tick's injections for phase 15(b): up to the per-tick maximum,
    each shard topped up toward a backlog target near its capacity (the
    whole backlog on even shards, seven eighths on odd ones, so that hot
    shards have work to donate)."""
    Q, M = cfg.backlog, cfg.max_arrivals_per_tick
    target = np.where(np.arange(cfg.n_shards) % 2 == 0, Q, Q - Q // 8)
    want = rng.integers(M // 2, M + 1, cfg.n_shards)
    return np.clip(np.minimum(want, target - backlog), 0, M)


def drive_serve(router, cfg, state, ticks: int, seed: int, sched=None):
    """``ticks`` serve ticks from ``state``: injections from
    :func:`serve_schedule` (seeded, steered by the backlog each tick
    reports) or replayed from ``sched``. Returns the host outputs of every
    tick, the schedule and the end state."""
    rng = np.random.default_rng(seed)
    S = cfg.n_shards
    base, backlog = np.zeros(S, np.int64), np.zeros(S, np.int64)
    outs, used = [], []
    for i in range(ticks):
        n = sched[i] if sched is not None else \
            serve_schedule(cfg, rng, backlog)
        state, out = router.serve_tick(cfg, state, n, base)
        host = router.serve_out_numpy(out)
        base += n
        backlog = host["backlog"]
        outs.append(host)
        used.append(n)
    return outs, np.stack(used), state


SERVE_INTS = ("fin", "uid", "label", "votes", "dropped", "backlog",
              "in_flight", "stolen", "donated")


def serve_phase(card: str):
    """Phase 15: the scenario front door and the live serve path on the
    card (see the module docstring); fails at the first check that does
    not hold. Returns the numbers PERF.md reports."""
    import asyncio

    from repro_torch.labelstream import router
    from repro_torch.launch import serve as launch_serve
    from repro_torch.obs import timing
    from repro_torch.scenarios import get_scenario, smoke, to_serve_config
    from repro_torch.serving.server import LabelServer, ServeClient

    # (a) the registry smoke, every (scenario, ported engine) pair
    t0 = time.perf_counter()
    rc = smoke.main(["--device", "cuda"])
    check(rc == 0, "[serve a] the registry smoke failed on the card")
    say(f"[serve a] registry smoke on the card passed in "
        f"{time.perf_counter() - t0:.1f} s; {card}")

    # (b) the serve tick, driven directly
    T, T_CPU, SEED = 2000, 200, 0
    runs = [("serve_default", None), ("stream_sharded", None),
            ("chance_hard", {"policy.admission.kind": "uncertain_learnable"})]
    found = {}
    for name, ov in runs:
        tag = f"[serve b {name}]"
        cfg = to_serve_config(get_scenario(name, ov))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, sched, end = drive_serve(
            router, cfg, router.serve_init(cfg, SEED, "cuda"), T, SEED)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs2, sched2, end2 = drive_serve(
            router, cfg, router.serve_init(cfg, SEED, "cuda"), T, SEED)
        torch.cuda.synchronize()
        secs2 = time.perf_counter() - t0
        check(np.array_equal(sched, sched2), f"{tag} the second run's "
              "schedule differs (its backlogs differ)")
        bad = [(i, k) for i, (a, b) in enumerate(zip(outs, outs2))
               for k in SERVE_INTS + ("conf", "tis")
               if not np.array_equal(a[k], b[k])]
        check(not bad, f"{tag} not repeatable on the card: first tick and "
              f"key {bad[:1]}")
        a, b = flat_state(end["ws"]), flat_state(end2["ws"])
        for part in ("win", "bl", "learner"):
            a.update({f"{part}.{k}": v
                      for k, v in flat_state(end[part]).items()})
            b.update({f"{part}.{k}": v
                      for k, v in flat_state(end2[part]).items()})
        check(all(torch.equal(a[k], b[k]) for k in a),
              f"{tag} end states differ between the two runs")
        inj = fin = drop = stolen = 0
        for n, o in zip(sched, outs):
            inj += int(n.sum())
            fin += int(o["fin"].sum())
            drop += int(o["dropped"].sum())
            stolen += int(o["stolen"].sum())
            check(inj == fin + drop + int(o["backlog"].sum())
                  + int(o["in_flight"].sum()), f"{tag} conservation fails")
            check(int(o["stolen"].sum()) == int(o["donated"].sum()),
                  f"{tag} stolen != donated")
        check(fin > 0, f"{tag} nothing finalized")
        # the first T_CPU ticks against the port on the CPU
        t1 = time.perf_counter()
        cpu, _, _ = drive_serve(router, cfg,
                                router.serve_init(cfg, SEED, "cpu"), T_CPU,
                                SEED, sched=sched)
        cpu_s = time.perf_counter() - t1
        first = next(((i, k) for i, (a, b) in enumerate(zip(outs, cpu))
                      for k in SERVE_INTS if not np.array_equal(a[k], b[k])),
                     None)
        check(first is None, f"{tag} card and CPU differ first at tick "
              f"{first and first[0]} in {first and first[1]}")
        dconf = max(float(np.abs(a["conf"] - b["conf"]).max())
                    for a, b in zip(outs, cpu))
        say(f"{tag} {cfg.n_shards} shards x window {cfg.window}, {T} ticks "
            f"in {secs:.2f} s ({T / secs:.1f} ticks/s, first run; "
            f"{T / secs2:.1f} the second); injected {inj}, finalized {fin}, "
            f"backlog {int(outs[-1]['backlog'].sum())}, in flight "
            f"{int(outs[-1]['in_flight'].sum())}, dropped {drop}, stolen = "
            f"donated = {stolen}; second run bit-equal; conservation exact "
            f"every tick; first {T_CPU} ticks equal the CPU in every integer "
            f"output (max |dconf| {dconf:.3g}; CPU {cpu_s:.1f} s); {card}")
        found[name] = dict(cfg=cfg, end=end, us=1e6 * secs2 / T,
                           ticks_per_s=T / secs, fin=fin, stolen=stolen)

    # where a serve tick's time goes: 80 ticks under the profiler, kernels
    # and host copies counted apart
    Hp = 80
    for name, r in found.items():
        wall, events = kernel_events(
            lambda: drive_serve(router, r["cfg"], r["end"], Hp, SEED + 1),
            cpu=False)
        if not events:
            say(f"[profile] serve {name}: device time not measured (no "
                "device events)")
            continue
        count = lambda pick: sum(len(v) for k, v in events.items()
                                 if pick(k))
        h2d = count(lambda k: "HtoD" in k)
        d2h = count(lambda k: "DtoH" in k)
        n_kern = count(lambda k: not k.startswith(("Memcpy", "Memset")))
        by_name = {k: sum(v) for k, v in events.items()}
        busy = sum(by_name.values())
        idle = (1 - busy / Hp / r["us"]) * 100
        r.update(kernels=n_kern / Hp, busy_us=busy / Hp, idle=idle,
                 h2d=h2d / Hp, d2h=d2h / Hp)
        say(f"[profile] serve {name}, {Hp} ticks: {n_kern / Hp:.0f} kernels "
            f"and {h2d / Hp:.2f} host-to-device / {d2h / Hp:.2f} "
            f"device-to-host copies per tick, device busy {busy / Hp:.0f} us "
            f"per tick; wall per tick {wall / Hp * 1e6:.0f} us with the "
            f"profiler on, {r['us']:.0f} us without: device idle "
            f"{idle:.1f}% of the unprofiled tick; {card}")
        for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
            say(f"[profile]   {us / Hp:8.1f} us/tick  {kname[:90]}")

    # (c) the HTTP server on the card
    timing.clear()
    res = asyncio.run(asyncio.wait_for(
        launch_serve.smoke("serve_default", device="cuda"), 120))
    say("[serve c] smoke " + json.dumps(res))
    check(res["ok"], "[serve c] the serve smoke failed on the card")

    n_clients, per_client = 16, 64

    async def load():
        srv = await LabelServer(get_scenario("serve_default"), seed=SEED,
                                port=0, tick_interval_s=0.0,
                                device="cuda").start()

        async def client():
            c = await ServeClient(srv.host, srv.port).connect()
            got = [await c.submit(wait=True, timeout_s=60.0)
                   for _ in range(per_client)]
            await c.aclose()
            return got

        t0 = time.perf_counter()
        got = await asyncio.gather(*[client() for _ in range(n_clients)])
        wall = time.perf_counter() - t0
        stats = srv.stats()
        await srv.close()
        return got, wall, stats, n_clients * per_client

    timing.clear()
    got, wall, stats, n = asyncio.run(asyncio.wait_for(load(), 300))
    done = sum(1 for out in got for st, r in out
               if st == 200 and r["status"] == "done")
    check(done == n and stats["answered"] == n and stats["conservation"],
          f"[serve c] {done}/{n} answered, stats {stats}")
    (row,) = stats["timing"]
    http = dict(tasks_per_s=n / wall, p50_s=stats["p50_latency_s"],
                p95_s=stats["p95_latency_s"], ticks=stats["ticks"],
                cold_s=row["cold_s"], warm_s=row["warm_s"], wall=wall)
    say(f"[serve c] {n_clients} clients x {per_client} wait=true tasks on "
        f"serve_default: {n} "
        f"answered in {wall:.2f} s ({n / wall:.1f} answered tasks/s), p50 "
        f"{stats['p50_latency_s'] * 1e3:.1f} ms, p95 "
        f"{stats['p95_latency_s'] * 1e3:.1f} ms wall over loopback; "
        f"{stats['ticks']} ticks; serve.tick cold {row['cold_s'] * 1e3:.1f} "
        f"ms, warm {row['warm_s'] * 1e3:.2f} ms; conservation exact; "
        f"{card}")
    return found, http


def launch_times(src: str):
    """``python3 chip_smoke.py --launch-times SRC``: the per-call times of
    ``ds_estep`` at the stream refresh's shape and of ``entropy_scores`` at
    the learning loop's two shapes, through the port's package under SRC
    (this checkout's ``src``, or another commit's), so that two commits'
    launch paths can be compared in turns in one run."""
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.kernels.ds_estep import ds_estep
    from repro_torch.kernels.uncertainty import entropy_scores
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows, idx = make_estep_inputs(gen, 512, 9, 2, 32, 5, dev)
    out = {"src": src, "ds_estep refresh": best_call_us(
        lambda: ds_estep(rows, idx))}
    for N, V in ((64 * 1500, 2), (64 * 3000, 10)):
        x = torch.randn((N, V), generator=gen, device=dev) * 3
        out[f"entropy ({N}, {V})"] = best_call_us(lambda: entropy_scores(x))
    print(json.dumps(out), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch reports no CUDA device; nothing to run",
              file=sys.stderr)
        sys.exit(2)
    if len(sys.argv) == 3 and sys.argv[1] == "--launch-times":
        launch_times(sys.argv[2])
        return
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.ds_estep import (
        ds_estep, estep_route, smem_budget, task_plan as estep_task_plan,
    )
    from repro_torch.kernels.ref import ds_estep_ref
    from repro_torch.core import simfast
    from repro_torch.data.datasets import mnist_like, train_test_split
    from repro_torch.kernels.ref import entropy_ref
    from repro_torch.kernels.uncertainty import entropy_route, entropy_scores
    from repro_torch.labelstream import aggregate, router
    from repro_torch.learning import linear
    from repro_torch import scenarios as scen
    from repro_torch.scenarios import (
        get_fast_config, get_learning_spec, get_stream_config, run_learning,
        spec_dataset,
    )
    from repro_torch.embed import bank as ebank
    from repro_torch.embed.corpus import make_tokens
    from repro_torch.embed import encoder as eenc
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.linear_scan import (
        ROUTES, linear_scan, scan_route,
    )
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import layers as mlayers
    from repro_torch.models import recurrent as mrec
    from repro_torch.device import full_fp32
    from repro_torch.models import model as mmodel
    from repro_torch.models.model import compute_params, forward
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.corpus import CorpusConfig, make_batch
    from repro_torch.kernels.ref import (
        attention_bwd_ref, xent_bwd_ref, xent_ref,
    )
    from repro_torch.kernels.xent import streaming_xent
    from repro_torch.models.stepfn import make_loss_fn
    from repro_torch.training.checkpoint import _flatten as ckpt_flatten
    from repro_torch.training.trainer import TrainConfig, Trainer
    kxent = importlib.import_module("repro_torch.kernels.xent")
    kflash = importlib.import_module("repro_torch.kernels.flash_attention")
    kscan = importlib.import_module("repro_torch.kernels.linear_scan")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card_kind = torch.cuda.get_device_name(0)

    # ---- phase 1: the card and the build --------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"{card_kind}, power limit unknown"
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build()
    say(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if line.strip() and "Compile time" not in line:
                say(f"[build:{name}] {line.strip()}")
    say(f"[build] ds_estep's group and wide kernels stage row tables up to "
        f"{smem_budget()} bytes in shared memory; the task route's "
        "placements (mode, rows staged, idx stages, shared memory bytes): "
        f"refresh {estep_task_plan(512, 19, 2, 32, 5)}, offline-C4 "
        f"{estep_task_plan(1, 4097, 4, 1 << 20, 5)}, offline-C8 "
        f"{estep_task_plan(1, 8193, 8, 1 << 20, 5)}")

    # ---- phase 2: kernel vs plain version --------------------------------
    # every shape on its own route (estep_route) and, where that is the task
    # route, on the group route too: logp equal to the plain version bit
    # for bit, post within the reference test's tolerance, a zero-vote task
    # exactly uniform, a second call equal bit for bit
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {}

    def compare(label, B, W, C, T, V, atol_p, zero_row=None, routes=None,
                quiet=False):
        rows, idx = make_estep_inputs(gen, B, W, C, T, V, dev)
        if zero_row is not None:
            idx[..., zero_row, :] = W * C
        R = W * C + 1
        Bn = 1 if B is None else B
        route = estep_route(Bn, R, C, T, V)
        if routes is None:
            routes = [route] + (["group"] if route == "task" else [])
        lr, pr = ds_estep_ref(rows, idx)
        errs[label] = 0.0
        for rt in routes:
            lp, p = ds_estep(rows, idx, _route=rt)
            torch.cuda.synchronize()
            e_p = (p - pr).abs().max().item()
            same_lp = torch.equal(lp, lr)
            lp2, p2 = ds_estep(rows, idx, _route=rt)
            again = torch.equal(lp, lp2) and torch.equal(p, p2)
            plan = estep_task_plan(Bn, R, C, T, V) if rt == "task" else None
            if not quiet:
                say(f"[estep] {label}: B={B} W={W} C={C} T={T} V={V} route "
                    f"{rt}{'' if plan is None else f' {plan}'}: logp "
                    f"{'bit-equal' if same_lp else 'DIFFERS'}, "
                    f"max|dpost|={e_p:.3g} (tol {atol_p}), second call "
                    f"{'bit-equal' if again else 'DIFFERS'}")
            check(same_lp and e_p <= atol_p and again
                  and bool(torch.isfinite(lp).all()),
                  f"ds_estep ({rt}) disagrees with its plain version at "
                  f"{label}")
            if zero_row is not None:
                check(bool((p[..., zero_row, :] == 1.0 / C).all()),
                      f"zero-vote task not exactly uniform at {label} ({rt})")
            errs[label] = max(errs[label], e_p)
        return rows, idx

    compare("9x4x77x5", None, 9, 4, 77, 5, 1e-5, zero_row=7)
    compare("16x8x512x5", None, 16, 8, 512, 5, 1e-4)
    compare("C33", None, 5, 33, 301, 4, 1e-5, zero_row=3)
    compare("C130", 3, 4, 130, 77, 3, 1e-5, zero_row=5)
    compare("refresh", 512, 9, 2, 32, 5, 1e-5, zero_row=0)
    compare("offline-C4", None, 1024, 4, 1 << 20, 5, 1e-5, zero_row=9)
    compare("offline-C8", None, 1024, 8, 1 << 20, 5, 1e-5, zero_row=9)
    # the task route's grid of class and vote counts, ragged T, in block
    # mode (one table) and warp mode (many small tables)
    n_grid = 0
    for C_ in (2, 3, 4, 5, 8):
        for V_ in (1, 3, 5, 7):
            for B_, W_, T_ in ((None, 37, 3001), (7, 5, 45)):
                compare(f"grid C{C_} V{V_} B{B_}", B_, W_, C_, T_, V_, 1e-5,
                        zero_row=1, quiet=True)
                n_grid += 1
    say(f"[estep] grid: {n_grid} shapes (C in 2, 3, 4, 5, 8; V in 1, 3, 5, "
        f"7; block mode T=3001 and warp mode B=7 T=45) on the task and group "
        f"routes: logp bit-equal, post within 1e-5, zero-vote tasks exactly "
        f"uniform, second calls bit-equal")
    # an idx base off the 16-byte grid, on every route of the offline shapes
    for label, B_, W_, C_, T_ in (("offline-C4", None, 1024, 4, 1 << 20),
                                  ("offline-C8", None, 1024, 8, 1 << 20),
                                  ("refresh", 512, 9, 2, 32)):
        rows, idx = make_estep_inputs(gen, B_, W_, C_, T_, 5, dev)
        buf = torch.empty(idx.numel() + 1, dtype=torch.int32, device=dev)
        off = buf[1:].view(idx.shape)
        off.copy_(idx)
        lr, pr = ds_estep_ref(rows, idx)
        for rt in ("task", "group"):
            lp, p = ds_estep(rows, off, _route=rt)
            check(torch.equal(lp, lr) and (p - pr).abs().max().item() <= 1e-5,
                  f"ds_estep ({rt}) is wrong on an unaligned idx at {label}")
        say(f"[estep] unaligned idx base at {label}: every route bit-equal "
            "in logp")
    del buf, off

    # ---- phase 3: offline EM ---------------------------------------------
    T, V, W, C = 1 << 20, 5, 1024, 4
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    truth = torch.randint(0, C, (T,), generator=g, device=dev)
    acc_w = 0.55 + 0.4 * torch.rand((W,), generator=g, device=dev)
    workers = torch.randint(0, W, (T, V), generator=g, device=dev)
    right = torch.rand((T, V), generator=g, device=dev) < acc_w[workers]
    other = (truth[:, None] + torch.randint(1, C, (T, V), generator=g,
                                            device=dev)) % C
    labels = torch.where(right, truth[:, None], other)
    mask = torch.rand((T, V), generator=g, device=dev) < 0.9
    mask[:64] = False                                   # zero-vote tasks
    ds_estep.launches = ds_estep.task_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em = aggregate.dawid_skene(labels, workers, mask, n_workers=W,
                               n_classes=C, iters=20, one_coin=False,
                               device=dev)
    torch.cuda.synchronize()
    em_s = time.perf_counter() - t0
    em_launches = ds_estep.launches
    em_task = ds_estep.task_launches
    check(em_launches == 20 and em_task == 20, f"offline EM made "
          f"{em_launches} E-step launches ({em_task} on the task route), "
          "expected 20 (all 20)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em2 = aggregate.dawid_skene(labels, workers, mask, n_workers=W,
                                n_classes=C, iters=20, one_coin=False,
                                device=dev)
    torch.cuda.synchronize()
    em2_s = time.perf_counter() - t0
    same = all(torch.equal(em[k], em2[k]) for k in em)
    check(same, "offline EM is not bitwise repeatable on the card")
    post = em["posterior"]
    check(tuple(post.shape) == (T, C) and bool(torch.isfinite(post).all()),
          "offline EM posterior is not finite of shape (T, C)")
    check(bool((post[:64] == 1.0 / C).all()),
          "zero-vote tasks are not exactly uniform after EM")
    label_acc = (post.argmax(-1) == truth)[64:].float().mean().item()
    acc_err = (em["accuracy"] - acc_w).abs().mean().item()
    say(f"[em] T={T} V={V} W={W} C={C} full confusion x20: {em_s:.3f} s "
        f"first call, {em2_s:.3f} s second call; launches={em_launches} "
        f"(task route {em_task}), "
        f"label accuracy "
        f"{label_acc:.4f}, mean |acc - true acc| {acc_err:.4f}, repeatable")
    check(label_acc > 0.85, f"offline EM label accuracy {label_acc}")
    Ts = 1 << 14          # a slice against the port on the CPU
    cpu = aggregate.dawid_skene(labels[:Ts].cpu(), workers[:Ts].cpu(),
                                mask[:Ts].cpu(), n_workers=W, n_classes=C,
                                iters=20, one_coin=False, device="cpu")
    gpu = aggregate.dawid_skene(labels[:Ts], workers[:Ts], mask[:Ts],
                                n_workers=W, n_classes=C, iters=20,
                                one_coin=False, device=dev)
    d_post = (gpu["posterior"].cpu() - cpu["posterior"]).abs().max().item()
    d_acc = (gpu["accuracy"].cpu() - cpu["accuracy"]).abs().max().item()
    say(f"[em] T={Ts} card vs CPU: max|dpost|={d_post:.3g} "
        f"max|dacc|={d_acc:.3g} (tol 1e-4)")
    check(d_post <= 1e-4 and d_acc <= 1e-4, "offline EM: card and CPU differ")

    # ---- phase 4: the stream ---------------------------------------------
    # through the front door: the registry scenario with the learner's
    # refresh knobs, lowered and run by scenarios.run
    spec4 = scen.get_scenario("skewed_adaptive5", {
        "policy.learner.refresh_every": 40,
        "policy.learner.refresh_iters": 6})
    cfg = get_stream_config("skewed_adaptive5",
                            {"refresh_every": 40, "refresh_iters": 6})
    check(scen.to_stream_config(spec4) == cfg, "the front door's stream "
          "config differs from get_stream_config's")
    H, N, SEED = 1440, 256, 0
    n_refresh = H // cfg.refresh_every
    ds_estep.launches = ds_estep.task_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res4 = scen.run(spec4, engine="stream", horizon=H, n_reps=N, seed=SEED,
                    device="cuda")
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    out = res4["raw"]
    check(res4["config"] == cfg, "scenarios.run lowered another config")
    stream_launches = ds_estep.launches
    stream_task = ds_estep.task_launches
    check(stream_launches == stream_task == n_refresh * cfg.refresh_iters,
          f"stream made {stream_launches} E-step launches ({stream_task} on "
          f"the task route), expected {n_refresh * cfg.refresh_iters}")
    ints = [k for k, v in out.items() if torch.is_tensor(v)
            and not v.is_floating_point()]
    total = lambda k: int(out[k].sum().item())
    lhs = total("arrived")
    rhs = (total("done_all") + total("backlog_end") + total("in_flight_end")
           + total("dropped"))
    say(f"[stream] {cfg.n_shards * N} shard-replications x {H} ticks: "
        f"{stream_s:.2f} s wall ({H / stream_s:.1f} ticks/s), "
        f"ds_estep launches={stream_launches} ({n_refresh} refreshes x "
        f"{cfg.refresh_iters} iterations; task route {stream_task})")
    say(f"[stream] conservation: arrived {lhs} == done {total('done_all')} "
        f"+ backlog {total('backlog_end')} + in flight "
        f"{total('in_flight_end')} + dropped {total('dropped')}")
    check(lhs == rhs, "stream conservation fails")
    # the same run through the entry point itself
    out2 = router.run_stream(cfg, H, n_reps=N, seed=SEED, device="cuda")
    diff = [k for k in ints if not torch.equal(out[k], out2[k])]
    diff += [f"series.{k}" for k in out["series"]
             if not torch.equal(out["series"][k], out2["series"][k])]
    check(not diff, f"stream is not repeatable on the card: {diff}")
    summ = router.stream_summary(cfg, out)
    check(res4["metrics"] == router.stream_summary(cfg, out2),
          "scenarios.run's metrics differ from run_stream's summary")
    say("[stream] scenarios.run(skewed_adaptive5 + refresh) = run_stream on "
        "the same seed: config equal, every integer output and the "
        "summary equal")
    say("[stream] summary " + json.dumps(summ, sort_keys=True))
    for k in ("sustained_rate", "accuracy", "mean_tis", "cost"):
        check(math.isfinite(summ[k]) and summ[k] > 0, f"summary {k}={summ[k]}")

    # first 8 replications against the port on the CPU, same init+arrivals
    n8 = 8
    ws, banks, seeds = router.draw_init(cfg, N, SEED)
    sub = lambda d: {k: v[:n8] for k, v in d.items()}
    ws8, banks8, seeds8 = sub(ws), sub(banks), seeds[:n8]
    n_new, n_arr = router.draw_arrivals(cfg, H, N, seed=SEED, device="cuda")
    arr8 = (n_new[:, :n8].cpu(), n_arr[:, :n8].cpu())
    inj = router.run_stream(
        cfg, H, n_reps=n8, device="cuda",
        init=router.state_from_numpy(cfg, ws8, banks8, seeds8, "cuda"),
        arrivals=arr8)
    same_as_main = all(torch.equal(inj[k], out[k][:n8]) for k in ints)
    check(same_as_main, "the injected card run does not reproduce the first "
          "8 replications of the main run")
    ref = router.run_stream(
        cfg, H, n_reps=n8, device="cpu",
        init=router.state_from_numpy(cfg, ws8, banks8, seeds8, "cpu"),
        arrivals=arr8)
    cpu_diff = [k for k in ints if not torch.equal(inj[k].cpu(), ref[k])]
    rel = max(abs(float(inj[k].sum()) - float(ref[k].sum()))
              / max(abs(float(ref[k].sum())), 1e-9)
              for k in ("sum_tis", "cost_wait", "cost_work"))
    if cpu_diff:
        first = H
        for k in ("finalized", "backlog", "in_flight"):
            neq = (inj["series"][k].cpu() != ref["series"][k]).any(0)
            if neq.any():
                first = min(first, int(neq.nonzero()[0]))
        say(f"[stream] card vs CPU (8 reps): integer outputs differ in "
            f"{cpu_diff}; first differing tick {first}")
        if first < H:
            # the cause: rerun both to that tick and name the state that
            # differs first
            st = {}
            for d in ("cuda", "cpu"):
                init = router.state_from_numpy(cfg, ws8, banks8, seeds8, d)
                _, st[d] = router._run_one(
                    cfg, first + 1, init, float(np.float32(0.3 * H * cfg.dt)),
                    1.0, None, (arr8[0][:first + 1], arr8[1][:first + 1]))
            for part in ("ws", "win", "bl"):
                for k, v in st["cuda"][part].items():
                    w = st["cpu"][part][k]
                    if not torch.equal(v.cpu(), w):
                        dv = (v.cpu().double() - w.double()).abs()
                        dv = dv[torch.isfinite(dv)]
                        say(f"[stream]   cause at tick {first}: {part}.{k} "
                            f"differs (max |d| "
                            f"{dv.max().item() if dv.numel() else 'n/a'})")
    else:
        say(f"[stream] card vs CPU (8 reps, {H} ticks): every integer output "
            f"equal; float sums rel diff {rel:.3g}")

    # ---- phase 5: timings ------------------------------------------------
    # per call: CUDA events around back-to-back calls (what a caller pays,
    # launch overhead included); device: the kernel's own device time from
    # the profiler (mean over the launches it recorded). The routes run in
    # turns (new, old, old, new) on the same inputs; the bound is the
    # card's least time for the work, and a tiny shape is judged against
    # the larger of its bound and the launch floor
    floor_us = launch_floor_us()
    say(f"[time] launch floor: a one-element zero_() takes {floor_us:.2f} us "
        f"on the device (profiler, mean of 200 launches); {card}")
    timings = {}
    turns = ("task", "group", "group", "task")
    for label, B, W_, C_, T_, V_, order in (
            ("refresh", 512, 9, 2, 32, 5, turns),
            ("offline-C4", None, 1024, 4, 1 << 20, 5, turns),
            ("offline-C8", None, 1024, 8, 1 << 20, 5, turns)):
        rows, idx = make_estep_inputs(gen, B, W_, C_, T_, V_, dev)
        reps = 200 if label == "refresh" else 50
        Bn = 1 if B is None else B
        R_ = W_ * C_ + 1
        bound, by, nbytes = estep_bound_ms(Bn, R_, C_, T_, V_)
        seen = {}
        for rt in order:
            ms = cuda_ms(lambda: ds_estep(rows, idx, _route=rt), reps)

            def many():
                for _ in range(reps):
                    ds_estep(rows, idx, _route=rt)
            dev_us, _ = mean_us(kernel_events(many)[1], "ds_estep")
            seen.setdefault(rt, []).append((ms, dev_us))
        plain = cuda_ms(lambda: ds_estep_ref(rows, idx), reps)
        res = {rt: (float(np.mean([m for m, _ in v])),
                    float(np.mean([d for _, d in v])))
               for rt, v in seen.items()}
        timings[label] = dict(ms=res["task"][0], dev_us=res["task"][1],
                              routes=res, plain_ms=plain, bound_ms=bound,
                              bound_by=by, bytes=nbytes)
        for rt, (ms, dev_us) in res.items():
            share = (f"{bound * 1e3 / dev_us * 100:.1f}% of bound"
                     if dev_us > 0 else "device time not measured")
            turns_txt = ", ".join(f"{d:.2f}" for _, d in seen[rt])
            say(f"[time] ds_estep {label} (B={Bn}, T={T_}, V={V_}, R={R_}, "
                f"C={C_}) route {rt}: per call {ms * 1e3:.2f} us, device "
                f"{dev_us:.2f} us ({share}; turns {turns_txt}); bound "
                f"{bound * 1e3:.3f} us ({by}, {nbytes} B), launch floor "
                f"{floor_us:.2f} us; plain per call {plain * 1e3:.2f} us; "
                f"{card}")
    say(f"[time] stream {H / stream_s:.1f} ticks/s wall ({N} reps x "
        f"{cfg.n_shards} shards, refresh every {cfg.refresh_every}, first "
        f"run); {card}")
    # where the offline EM's time goes: two iterations under the profiler
    wall, n_k, busy, by_name = device_profile(
        lambda: aggregate.dawid_skene(labels, workers, mask, n_workers=W,
                                      n_classes=C, iters=2, one_coin=False,
                                      device=dev))
    if n_k:
        e_us = sum(v for k, v in by_name.items() if "ds_estep" in k)
        say(f"[profile] offline EM, 2 iterations: {wall * 1e3:.1f} ms wall "
            f"with the profiler on, {n_k} kernels, device busy "
            f"{busy / 1e3:.1f} ms, of which the E-step {e_us:.1f} us "
            f"({e_us / busy * 100:.2f}%); {card}")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            say(f"[profile]   {us / 2e3:8.2f} ms/iteration  {name[:90]}")
    else:
        say("[profile] offline EM: device time not measured (no device "
            "events)")
    # where a tick's time goes: 80 ticks (two refreshes) under the profiler
    Hp = 2 * cfg.refresh_every
    wall, n_k, busy, by_name = device_profile(
        lambda: router.run_stream(cfg, Hp, n_reps=N, seed=SEED + 1,
                                  device="cuda"))
    if n_k:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        say(f"[profile] stream {Hp} ticks: {n_k / Hp:.0f} kernels per tick, "
            f"device busy {busy / Hp:.0f} us per tick; wall per tick "
            f"{wall / Hp * 1e6:.0f} us with the profiler on, "
            f"{stream_s / H * 1e6:.0f} us without: device idle "
            f"{(1 - busy / Hp / (stream_s / H * 1e6)) * 100:.1f}% of the "
            f"unprofiled tick; {card}")
        for name, us in top:
            say(f"[profile]   {us / Hp:8.1f} us/tick  {name[:90]}")
    else:
        say("[profile] stream: device time not measured (no device events)")

    # ---- phase 6: the entropy kernel against its plain version ----------
    # tolerances are the reference tests': learner widths and the LM vocab
    # as tests/test_kernels.py (atol max(tol, 1e-4) * 10, rtol 1e-2, tol
    # 2e-5 in float32 and 2e-2 in bfloat16), the odd shapes as
    # tests/test_learning.py (1e-4 in float32, 2e-2 in bfloat16), the
    # learning path's shapes at float32's 1e-4 (tests/test_learning.py:83)
    f32, bf16 = torch.float32, torch.bfloat16
    wide_tol = lambda dt: ((2e-1 if dt == bf16 else 1e-3), 1e-2)
    odd_tol = lambda dt: ((2e-2, 2e-2) if dt == bf16 else (1e-4, 1e-4))
    ent_cases = []
    for dt in (f32, bf16):
        dn = "f32" if dt == f32 else "bf16"
        ent_cases += [(f"learner {N}x{C} {dn}", N, C, dt, *wide_tol(dt))
                      for N, C in ((256, 2), (384, 10), (512, 64), (777, 17),
                                   (1024, 48))]
        ent_cases += [(f"odd {N}x{V} {dn}", N, V, dt, *odd_tol(dt))
                      for N, V in ((1, 3), (33, 777), (129, 513))]
        ent_cases += [(f"vocab {N}x50304 {dn}", N, 50304, dt, *wide_tol(dt))
                      for N in (64, 512)]
    LEARN_SHAPES = {"learn-mnist": (64 * 3000, 10),
                    "learn-hybrid": (64 * 1500, 2)}
    ent_cases += [(label, N, V, f32, 1e-4, 1e-4)
                  for label, (N, V) in LEARN_SHAPES.items()]
    # the narrow route (V <= 64) is also held bit for bit against the old
    # narrow kernel (route narrow_v1)
    ent_inputs, ent_errs = {}, {}
    for label, N, V, dt, atol, rtol in ent_cases:
        x = (torch.randn((N, V), generator=gen, device=dev) * 3).to(dt)
        h = entropy_scores(x)
        torch.cuda.synchronize()
        want = entropy_ref(x)
        err = (h - want).abs().max().item()
        lo, hi = h.min().item(), h.max().item()
        narrow = entropy_route(V, dt) == "narrow"
        same_v1 = narrow and torch.equal(h, entropy_scores(
            x, _route="narrow_v1"))
        ok = (bool(torch.isfinite(h).all()) and tuple(h.shape) == (N,)
              and bool(torch.allclose(h, want, atol=atol, rtol=rtol))
              and lo >= 0.0 and hi <= math.log(V) + 1e-3
              and same_v1 == narrow)
        say(f"[entropy] {label} (route {entropy_route(V, dt)}): max|dH|="
            f"{err:.3g} (atol {atol}, rtol {rtol}), H in [{lo:.4g}, "
            f"{hi:.4g}], log V={math.log(V):.4g}"
            + (", bit-equal to narrow_v1" if same_v1 else ""))
        check(ok, f"entropy kernel disagrees with its plain version (or the "
              f"old narrow kernel) at {label}")
        ent_inputs[label] = x
        ent_errs[label] = err
    # the narrow route's widths, ragged N, both dtypes, on an aligned and
    # an unaligned base: bit-equal to narrow_v1, within the plain version's
    # odd-shape tolerance
    n_narrow, worst = 0, 0.0
    for V in (1, 2, 3, 10, 16, 17, 33, 48, 64):
        for N in (1000, 70001):
            for dt in (f32, bf16):
                buf = (torch.randn((N * V + 1,), generator=gen, device=dev)
                       * 3).to(dt)
                atol, rtol = odd_tol(dt)
                for x in (buf[:-1].view(N, V), buf[1:].view(N, V)):
                    h = entropy_scores(x)
                    old = entropy_scores(x, _route="narrow_v1")
                    want = entropy_ref(x)
                    check(torch.equal(h, old) and bool(torch.allclose(
                        h, want, atol=atol, rtol=rtol)),
                        f"narrow entropy kernel wrong at ({N}, {V}) {dt}, "
                        f"base {x.data_ptr() % 16}")
                    worst = max(worst, (h - want).abs().max().item())
                    n_narrow += 1
    say(f"[entropy] narrow grid: {n_narrow} cases (V in 1, 2, 3, 10, 16, 17, "
        f"33, 48, 64; N 1000 and 70001; f32 and bf16; aligned and unaligned "
        f"bases) bit-equal to narrow_v1; max|dH| vs plain {worst:.3g}")
    # a base address off the 16-byte grid, and leading dims
    buf = torch.randn((4 * 33 * 777 + 1,), generator=gen, device=dev) * 3
    x = buf[1:].view(4, 33, 777)
    h = entropy_scores(x)
    err = (h - entropy_ref(x)).abs().max().item()
    say(f"[entropy] unaligned base, (4, 33, 777) f32: max|dH|={err:.3g} "
        "(tol 1e-4)")
    check(tuple(h.shape) == (4, 33) and err <= 1e-4,
          "entropy kernel is wrong on an unaligned base")

    # ---- phase 7: the hybrid-learning loop ------------------------------
    # run_learning("hybrid_small") at its spec-built dataset and at the
    # paper's MNIST-sized problem (mnist_like(4000, seed=4) split 3:1),
    # 64 replications x 10 rounds x 60 fit steps, twice each
    R7, ROUNDS, FIT = 64, 10, 60
    learn_kw = dict(n_reps=R7, rounds=ROUNDS, fit_steps=FIT)
    Xm, ym = mnist_like(4000, seed=4)
    sizes = {"hybrid_small": spec_dataset("hybrid_small"),
             "mnist_like": train_test_split(Xm, ym, test_frac=0.25, seed=4)}
    learn, learn_launches = {}, {}
    round_fn = simfast._learner_round
    for label, data in sizes.items():
        rounds_seen = []

        def recording_round(*a, **k):
            out = round_fn(*a, **k)
            labeled_in = a[12]
            aux = out[5]
            rounds_seen.append((labeled_in.cpu(), aux["chosen"].cpu(),
                                aux["take"].cpu(), aux["n_ticks"].cpu()))
            return out
        # the checked run: counts from 0, every round's picks recorded
        simfast._learner_round = recording_round
        try:
            entropy_scores.launches = 0
            r1 = run_learning(scen.get_scenario("hybrid_small"), *data,
                              device="cuda", **learn_kw)
            torch.cuda.synchronize()
            n_launch = entropy_scores.launches
        finally:
            simfast._learner_round = round_fn
        learn_launches[label] = n_launch
        check(n_launch == ROUNDS, f"learning ({label}) made {n_launch} "
              f"entropy launches, expected {ROUNDS}")
        # the timed run, unrecorded
        entropy_scores.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r2 = run_learning(scen.get_scenario("hybrid_small"), *data,
                          device="cuda", **learn_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(entropy_scores.launches == ROUNDS,
              f"learning ({label}) second run made "
              f"{entropy_scores.launches} entropy launches")
        a1 = {**r1["curve"], **{k: r1["raw"][k] for k in
                               ("W", "b", "labeled", "y_obs", "total_time")}}
        a2 = {**r2["curve"], **{k: r2["raw"][k] for k in
                               ("W", "b", "labeled", "y_obs", "total_time")}}
        diff = [k for k in a1 if not torch.equal(a1[k], a2[k])]
        check(not diff, f"learning ({label}) is not bitwise repeatable on "
              f"the card: {diff}")
        t = a1["t"].cpu().numpy()
        nl = a1["n_labeled"].cpu().numpy()
        acc = a1["acc"].cpu().numpy()
        check(t.shape == nl.shape == acc.shape == (R7, ROUNDS + 1)
              and np.isfinite(acc).all() and np.isfinite(t).all(),
              f"learning ({label}) curve shapes or values are wrong")
        check(bool((np.diff(t, axis=1) > 0).all()),
              f"learning ({label}): time does not strictly increase")
        check(bool((np.diff(nl, axis=1) > 0).all()),
              f"learning ({label}): n_labeled does not grow every round")
        check(len(rounds_seen) == ROUNDS, "round recorder missed rounds")
        ticks = torch.stack([r[3] for r in rounds_seen], 1)
        for lab_in, chosen, take, _ in rounds_seen:
            again = torch.gather(lab_in, 1, chosen)[take]
            check(not bool(again.any()), f"learning ({label}): a labeled "
                  "point was chosen again")
            for i in range(R7):
                picks = chosen[i][take[i]]
                check(picks.unique().numel() == picks.numel(),
                      f"learning ({label}): a point chosen twice in a round")
        fin = acc[:, -1]
        learn[label] = dict(wall=wall, reps_per_s=R7 / wall, acc=fin,
                            n_labeled=nl[:, -1], data=data, curve=a1,
                            ticks=ticks)
        say(f"[learn] {label} (X {tuple(data[0].shape)}, "
            f"{int(data[1].max()) + 1} classes): {R7} reps x {ROUNDS} "
            f"rounds x {FIT} fit steps in {wall:.3f} s "
            f"({R7 / wall:.2f} replications/s, second run); final accuracy "
            f"{fin.mean():.4f} +- {fin.std():.4f}, labels "
            f"{nl[:, -1].min()}..{nl[:, -1].max()}, sim time "
            f"{t[:, -1].mean():.0f} s; crowd batch ticks per round "
            f"{ticks.float().mean():.1f} mean, lock-step (max over "
            f"replications) {ticks.max(0).values.float().mean():.1f}; "
            f"entropy launches {n_launch} (= "
            f"rounds); second run bit-equal; no point chosen twice; {card}")
    check(float(learn["hybrid_small"]["acc"].mean()) > 0.8,
          "hybrid_small final accuracy is not above 0.8")

    # the first 8 replications of hybrid_small against the port on the
    # CPU, with the same draws: the draws the entry point makes, made
    # ahead and cut to 8 replications
    cfg7 = get_fast_config("hybrid_small")
    X7, y7 = sizes["hybrid_small"][:2]
    bcfg = dataclasses.replace(cfg7, n_tasks=cfg7.pool_size,
                               batch_size=cfg7.pool_size,
                               n_classes=int(y7.max()) + 1)
    rng7 = np.random.default_rng(0)
    gen7 = torch.Generator(device=dev)
    gen7.manual_seed(0)
    n8 = 8
    draws = [simfast.draw_round(bcfg, R7, X7.shape[0], rng7, gen7)
             for _ in range(ROUNDS)]
    cut = lambda d: dict(u=d["u"][:n8].cpu(),
                         ws={k: v[:n8] for k, v in d["ws"].items()},
                         banks={k: v[:n8] for k, v in d["banks"].items()},
                         seed=d["seed"][:n8])
    draws8 = [cut(d) for d in draws]
    kw8 = dict(learn_kw, n_reps=n8, draws=draws8)
    g8 = run_learning("hybrid_small", *sizes["hybrid_small"], device="cuda",
                      **kw8)["curve"]
    c8 = run_learning("hybrid_small", *sizes["hybrid_small"], device="cpu",
                      **kw8)["curve"]
    main8 = {k: v[:n8] for k, v in learn["hybrid_small"]["curve"].items()}
    check(torch.equal(g8["n_labeled"], main8["n_labeled"]),
          "the injected card run does not reproduce the main run's labels")
    check(torch.equal(g8["n_labeled"].cpu(), c8["n_labeled"]),
          "hybrid_small: card and CPU n_labeled differ")
    ga, ca = g8["acc"][:, -1].cpu().numpy(), c8["acc"][:, -1].numpy()
    gap = abs(float(ga.mean()) - float(ca.mean()))
    check(gap <= max(float(ca.std()), 1e-6),
          f"hybrid_small: card and CPU final accuracy differ by {gap}")
    same_t = torch.equal(g8["t"].cpu(), c8["t"])
    same_main = torch.equal(g8["acc"], main8["acc"])
    say(f"[learn] hybrid_small first {n8} reps, card vs CPU on the same "
        f"draws: n_labeled equal; final accuracy {ga.mean():.4f} vs "
        f"{ca.mean():.4f} (gap {gap:.4g}, CPU std {ca.std():.4f}); max "
        f"|dacc| over the curve "
        f"{(g8['acc'].cpu() - c8['acc']).abs().max().item():.4g}; sim time "
        f"{'bit-equal' if same_t else 'differs'} (max |dt| "
        f"{(g8['t'].cpu() - c8['t']).abs().max().item():.4g} s); injected "
        f"card run = main run's first {n8} in n_labeled, acc "
        f"{'bit-equal' if same_main else 'differs'}")

    # ---- timings of phases 6-7 ------------------------------------------
    # at the learning shapes the new narrow kernel and the old one
    # (narrow_v1) in turns (new, old, old, new) on the same inputs
    ent_t = {}
    for label, N, V, dt, _, _ in ent_cases:
        x = ent_inputs[label]
        reps = 20 if N * V > 10 ** 7 else 100
        route = entropy_route(V, dt)
        order = ((route, "narrow_v1", "narrow_v1", route)
                 if label in LEARN_SHAPES else (route,))
        seen = {}
        for rt in order:
            ms = cuda_ms(lambda: entropy_scores(x, _route=rt), reps)

            def many():
                for _ in range(reps):
                    entropy_scores(x, _route=rt)
            dev_us, _ = mean_us(kernel_events(many)[1], "entropy")
            seen.setdefault(rt, []).append((ms, dev_us))
        plain = cuda_ms(lambda: entropy_ref(x), reps)
        lib = cuda_ms(lambda: torch.distributions.Categorical(
            logits=x, validate_args=False).entropy(), reps)

        def many_plain():
            for _ in range(reps):
                entropy_ref(x)
        _, _, plain_busy, _ = device_profile(many_plain)
        elt = 2 if dt == bf16 else 4
        bound, by, nbytes = entropy_bound_ms(N, V, elt)
        res = {rt: (float(np.mean([m for m, _ in v])),
                    float(np.mean([d for _, d in v])))
               for rt, v in seen.items()}
        ent_t[label] = dict(ms=res[route][0], dev_us=res[route][1],
                            routes=res, plain_ms=plain, library_ms=lib,
                            bound_ms=bound, bound_by=by)
        for rt, (ms, dev_us) in res.items():
            share = bound * 1e3 / dev_us * 100 if dev_us > 0 else 0.0
            dev_txt = (f"device {dev_us:.2f} us ({share:.1f}% of bound; turns "
                       f"{', '.join(f'{d:.2f}' for _, d in seen[rt])})"
                       if dev_us > 0 else "device time not measured (no "
                       "device events in the profile)")
            say(f"[time] entropy {label} (N={N}, V={V}) route {rt}: per call "
                f"{ms * 1e3:.2f} us, {dev_txt}, plain per call "
                f"{plain * 1e3:.2f} us (device {plain_busy / reps:.2f} us), "
                f"Categorical.entropy per call "
                f"{lib * 1e3:.2f} us, bound {bound * 1e3:.3f} us ({by}, "
                f"{nbytes} B), launch floor {floor_us:.2f} us; {card}")
    for label, res in learn.items():
        say(f"[time] learning {label}: {res['reps_per_s']:.2f} replications/s "
            f"({R7} reps x {ROUNDS} rounds in {res['wall']:.3f} s wall, "
            f"{res['wall'] / ROUNDS * 1e3:.1f} ms per round); {card}")
        # where a round's time goes: two rounds under the profiler
        wall, n_k, busy, by_name = device_profile(
            lambda: run_learning("hybrid_small", *res["data"], device="cuda",
                                 **dict(learn_kw, rounds=2)))
        if n_k:
            per = res["wall"] / ROUNDS * 1e6
            say(f"[profile] learning {label}, 2 rounds: {n_k / 2:.0f} kernels "
                f"per round, device busy {busy / 2:.0f} us per round; wall "
                f"per round {wall / 2 * 1e6:.0f} us with the profiler on, "
                f"{per:.0f} us without: device idle "
                f"{(1 - busy / 2 / per) * 100:.1f}% of the unprofiled round; "
                f"{card}")
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            for name, us in top:
                say(f"[profile]   {us / 2:9.1f} us/round  {name[:90]}")
            # the fit's share: one 60-step refit of all replications
            Xd = torch.as_tensor(res["data"][0], device=dev)
            yd = torch.as_tensor(res["data"][1], device=dev)
            C7 = int(yd.max()) + 1
            sw = (torch.rand((R7, Xd.shape[0]), generator=gen, device=dev)
                  < 0.03).to(torch.float32)
            st0 = linear.init(Xd.shape[1], C7, lead=(R7,), device=dev)
            fwall, f_k, f_busy, _ = device_profile(
                lambda: linear.fit(st0, Xd, yd.expand(R7, -1), sw,
                                   steps=FIT))
            say(f"[profile] learning {label}: one {FIT}-step fit of {R7} "
                f"replications: {f_k} kernels ({f_k / FIT:.1f} per step), "
                f"device busy {f_busy:.0f} us, wall {fwall * 1e6:.0f} us "
                f"with the profiler on; the crowd batch's lock-step ticks "
                f"per round {res['ticks'].max(0).values.float().mean():.1f}"
                f"; {card}")
        else:
            say(f"[profile] learning {label}: device time not measured (no "
                "device events)")

    # ---- phase 8: the flash_attention kernel against its plain version ---
    # tolerances as tests/test_kernels.py: 2e-5 in float32 (the kernel sums
    # q.k and p v in another order than the plain version's matmuls), 2e-2
    # in bfloat16 (both round the output to bfloat16; the kernel rounds each
    # 64-key tile's unnormalized p to bfloat16 before p v, the plain version
    # the normalized p, as the reference's _attn_direct does)
    tol = lambda dt: 2e-2 if dt == bf16 else 2e-5
    tsp = lambda x: x.transpose(1, 2)

    def flash_inputs(B, Hq, Hkv, Sq, Sk, D, dt, layout):
        """(B, S, H, D) operands: made so (``bshd``), or made (B, H, S, D)
        as the reference's grid is and passed as transposed views
        (``bhsd``, read by stride)."""
        if layout == "bhsd":
            sq, sk, t = (B, Hq, Sq, D), (B, Hkv, Sk, D), tsp
        else:
            sq, sk, t = (B, Sq, Hq, D), (B, Sk, Hkv, D), (lambda x: x)
        return tuple(t(torch.randn(sh, generator=gen, device=dev).to(dt))
                     for sh in (sq, sk, sk))

    def flash_plain(q, k, v, causal, window):
        return tsp(attention_ref(tsp(q), tsp(k), tsp(v), causal=causal,
                                 window=window))

    flash_cases = []
    for shape in [(2, 4, 2, 256, 256, 64), (1, 8, 8, 384, 384, 128),
                  (2, 4, 1, 128, 512, 64), (1, 2, 2, 200, 200, 64),
                  (1, 6, 2, 256, 256, 128)]:
        for causal, window in [(True, 0), (False, 0), (True, 96)]:
            if not causal and shape[3] != shape[4]:
                continue
            for dt in (f32, bf16):
                flash_cases.append((f"grid {shape} c={int(causal)} "
                                    f"w={window} {dt}".replace("torch.", ""),
                                    shape, causal, window, dt, "bhsd"))
    FLASH_MAIN = (64, 10, 1, 48, 48, 256)
    FLASH_TRAIN = "training (4, 512, 10/1, 256) bf16"
    flash_cases += [
        ("encoder (64, 48, 10/1, 256) bf16", FLASH_MAIN, True, 2048, bf16,
         "bshd"),
        ("window at length (1, 4096, 10/1, 256) bf16",
         (1, 10, 1, 4096, 4096, 256), True, 2048, bf16, "bshd"),
        ("ragged (2, 77, 4/2, 80) bf16", (2, 4, 2, 77, 77, 80), True, 0,
         bf16, "bshd"),
        ("unaligned rows (1, 100, 3/1, 60) bf16", (1, 3, 1, 100, 100, 60),
         True, 0, bf16, "bshd"),
        (FLASH_TRAIN, (4, 10, 1, 512, 512, 256), True, 2048, bf16, "bshd")]
    flash_inputs_kept, flash_errs = {}, {}
    for label, shape, causal, window, dt, layout in flash_cases:
        q, k, v = flash_inputs(*shape, dt, layout)
        o = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = flash_plain(q, k, v, causal, window)
        diff = (o.float() - want.float()).abs()
        err, err_mean = diff.max().item(), diff.mean().item()
        ok = (bool(torch.isfinite(o).all()) and o.shape == q.shape
              and bool(torch.allclose(o.float(), want.float(), atol=tol(dt),
                                      rtol=tol(dt))))
        say(f"[flash] {label} ({layout}): max|do|={err:.3g} mean|do|="
            f"{err_mean:.3g} (atol/rtol {tol(dt)})")
        check(ok, f"flash_attention kernel disagrees with its plain version "
              f"at {label}")
        check(torch.equal(o, flash_attention(q, k, v, causal=causal,
                                             window=window)),
              f"flash_attention is not repeatable at {label}")
        flash_errs[label] = err
        if shape in (FLASH_MAIN, (1, 10, 1, 4096, 4096, 256),
                     (4, 10, 1, 512, 512, 256)):
            flash_inputs_kept[label] = (shape, causal, window, dt,
                                        (q, k, v))

    # ---- phase 9: the linear_scan kernels against their plain versions --
    # tolerance 20x tests/test_kernels.py's (as its scan test). Each route's
    # kernel rounds the same multiplies and adds in the same order as its
    # plain version (sequential: linear_scan_ref; chunked: chunks of
    # SCAN_CHUNK steps and their carries, linear_scan_chunked_ref), so each
    # is also held equal to it bit for bit; the chunked plain version is
    # held within the tolerance of the sequential one, and the wrapper
    # equal to the plain version of the route scan_route gives the shape
    scan_cases = [(f"grid ({B}, {S}, {D}) {str(dt)[6:]}", B, S, D, dt)
                  for B, S, D in ((1, 64, 64), (3, 300, 150), (8, 256, 128),
                                  (2, 1000, 33))
                  for dt in (f32, bf16)]
    SCAN_MAIN = (64, 48, 2560)
    SCAN_TRAIN = (4, 512, 2560)
    scan_cases += [("encoder rglru (64, 48, 2560) f32", *SCAN_MAIN, f32),
                   ("training rglru (4, 512, 2560) f32", *SCAN_TRAIN, f32),
                   ("long (2, 4096, 2560) f32", 2, 4096, 2560, f32),
                   ("ragged (3, 1001, 2560) f32", 3, 1001, 2560, f32)]
    scan_inputs_kept, scan_errs = {}, {}
    for label, B, S, D, dt in scan_cases:
        a = torch.sigmoid(torch.randn((B, S, D), generator=gen,
                                      device=dev)).to(dt)
        b = torch.randn((B, S, D), generator=gen, device=dev).to(dt)
        h0 = torch.randn((B, D), generator=gen, device=dev).to(dt)
        route = scan_route(B, S, D, dt)
        for init in (h0, None):
            init_f = None if init is None else init.float()
            outs = {r: kscan._fwd_kernel(a, b, init_f, r) for r in ROUTES}
            torch.cuda.synchronize()
            wants = {r: ROUTES[r][0](a, b, init) for r in ROUTES}
            same = {r: torch.equal(outs[r], wants[r]) for r in ROUTES}
            again = {r: torch.equal(outs[r], kscan._fwd_kernel(
                a, b, init_f, r)) for r in ROUTES}
            err = {r: (outs[r].float() - wants[r].float()).abs().max().item()
                   for r in ROUTES}
            t20 = 20 * tol(dt)
            ok = all(bool(torch.isfinite(o_).all()) and o_.shape == a.shape
                     for o_ in outs.values())
            # the chunked plain version against the sequential one
            gap = (wants["chunked"].float() - wants["sequential"].float()
                   ).abs().max().item()
            ok = ok and bool(torch.allclose(wants["chunked"].float(),
                                            wants["sequential"].float(),
                                            atol=t20, rtol=t20))
            h = linear_scan(a, b, init)
            torch.cuda.synchronize()
            wrapped = torch.equal(h, wants[route])
            say(f"[scan] {label} h0={'yes' if init is not None else 'no'}: "
                + ", ".join(f"{r} max|dh|={err[r]:.3g} "
                            f"{'bit-equal' if same[r] else 'NOT bit-equal'}"
                            f"{'' if again[r] else ' NOT repeatable'}"
                            for r in ROUTES)
                + f"; chunked vs sequential plain {gap:.3g} (atol/rtol "
                f"{t20:.3g}); the wrapper takes {route}"
                f"{'' if wrapped else ' and DISAGREES with its plain version'}")
            check(ok and all(same.values()) and all(again.values())
                  and wrapped, f"a linear_scan kernel disagrees with its "
                  f"plain version at {label}")
        scan_errs[label] = err
        if (B, S, D) in (SCAN_MAIN, SCAN_TRAIN, (2, 4096, 2560)):
            scan_inputs_kept[label] = (a, b, h0)

    # ---- phase 10: LM-featured learning at full width --------------------
    OV10 = {"features.kind": "lm", "embed.model": "recurrentgemma-2b",
            "embed.reduced": EMBED_REDUCED}
    spec10 = get_learning_spec("hybrid_small", OV10)
    cfg10 = eenc.resolved_config(spec10.embed)
    n_tr, n_te = 1500, 500
    n_mb = -(-(n_tr + n_te) // spec10.embed.batch_size)
    group, n_full, rem = cfg10.layer_groups()
    kinds = group * n_full + rem
    want_flash = kinds.count("attn") * n_mb
    want_scan = kinds.count("rglru") * n_mb
    say(f"[lm] {cfg10.name}{' (reduced)' if EMBED_REDUCED else ''}: "
        f"{cfg10.n_layers} layers ({kinds.count('rglru')} rglru, "
        f"{kinds.count('attn')} attn), d_model {cfg10.d_model}, vocab "
        f"{cfg10.vocab_size}; {n_tr} + {n_te} tasks x "
        f"{spec10.embed.seq_len} tokens in {n_mb} micro-batches of "
        f"{spec10.embed.batch_size}")
    # the embed seed as make_dataset folds dataset seed 0 into it
    ec10 = dataclasses.replace(spec10.embed, seed=spec10.embed.seed + 7919)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params10 = eenc.model_params(ec10, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params10, torch.is_tensor))
    say(f"[lm] parameters: {n_params} ({n_params * 4 / 1e9:.2f} GB float32) "
        f"drawn from the seed in {init_s:.1f} s")

    def counts():
        return (flash_attention.launches, linear_scan.launches,
                entropy_scores.launches)

    def zero_counts():
        flash_attention.launches = 0
        linear_scan.launches = linear_scan.chunked_launches = 0
        entropy_scores.launches = 0

    learn10 = dict(n_reps=R7, rounds=ROUNDS, fit_steps=FIT)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r10 = run_learning("hybrid_small", overrides=OV10, device="cuda",
                       n_train=n_tr, n_test=n_te, **learn10)
    torch.cuda.synchronize()
    lm_first_s = time.perf_counter() - t0
    lm_launches = counts()
    # the encoder's scans, (64, 48, 2560), take the sequential route
    lm_chunked = linear_scan.chunked_launches
    check(lm_launches == (want_flash, want_scan, ROUNDS),
          f"LM learning made (flash, scan, entropy) = {lm_launches} "
          f"launches, expected {(want_flash, want_scan, ROUNDS)}")
    want_chunked = (want_scan if scan_route(spec10.embed.batch_size,
                                            spec10.embed.seq_len,
                                            cfg10.d_lru, f32) == "chunked"
                    else 0)
    check(lm_chunked == want_chunked, f"LM learning made {lm_chunked} "
          f"chunked scan launches, expected {want_chunked}")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r10b = run_learning("hybrid_small", overrides=OV10, device="cuda",
                        n_train=n_tr, n_test=n_te, **learn10)
    torch.cuda.synchronize()
    lm_second_s = time.perf_counter() - t0
    check(counts() == lm_launches, "LM learning's second run launched "
          f"{counts()}")
    k10 = ("W", "b", "labeled", "y_obs", "total_time")
    a1 = {**r10["curve"], **{k: r10["raw"][k] for k in k10}}
    a2 = {**r10b["curve"], **{k: r10b["raw"][k] for k in k10}}
    diff = [k for k in a1 if not torch.equal(a1[k], a2[k])]
    check(not diff, f"LM learning is not bitwise repeatable: {diff}")
    acc10 = a1["acc"].cpu().numpy()
    t10 = a1["t"].cpu().numpy()
    nl10 = a1["n_labeled"].cpu().numpy()
    check(acc10.shape == (R7, ROUNDS + 1) and np.isfinite(acc10).all()
          and bool((np.diff(t10, axis=1) > 0).all())
          and bool((np.diff(nl10, axis=1) > 0).all()),
          "LM learning curve shapes or invariants are wrong")
    # the dataset alone: encoded twice, bit for bit, timed
    ds_times, ds = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds.append(ebank.make_dataset(spec10, n_tr, n_te, seed=0,
                                     device="cuda"))
        torch.cuda.synchronize()
        ds_times.append(time.perf_counter() - t0)
    check(all(np.array_equal(x, y) for x, y in zip(ds[0], ds[1])),
          "LM features are not bitwise repeatable on the card")
    X10 = ds[0][0]
    check(X10.shape == (n_tr, spec10.n_features)
          and np.isfinite(X10).all(), "LM features are not finite (N, F)")
    tasks_per_s = (n_tr + n_te) / ds_times[1]
    # the learning loop alone on those features
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r10c = run_learning("hybrid_small", *ds[0], device="cuda", **learn10)
    torch.cuda.synchronize()
    learn_only_s = time.perf_counter() - t0
    check(all(torch.equal(r10c["curve"][k], r10["curve"][k])
              for k in ("t", "n_labeled", "acc")),
          "the LM dataset passed explicitly gives another curve")
    fin10 = acc10[:, -1]
    say(f"[lm] run_learning(features.kind=lm): {R7} reps x {ROUNDS} rounds "
        f"x {FIT} fit steps; first run {lm_first_s:.2f} s, second run "
        f"{lm_second_s:.2f} s; launches flash "
        f"{lm_launches[0]} (= {kinds.count('attn')} x {n_mb}), scan "
        f"{lm_launches[1]} (= {kinds.count('rglru')} x {n_mb}; "
        f"{lm_launches[1] - lm_chunked} sequential, {lm_chunked} chunked), "
        f"entropy "
        f"{lm_launches[2]}; second run bit-equal; final accuracy "
        f"{fin10.mean():.4f} +- {fin10.std():.4f}, labels "
        f"{nl10[:, -1].min()}..{nl10[:, -1].max()}; {card}")
    say(f"[time] LM dataset ({n_tr + n_te} tasks x {spec10.embed.seq_len} "
        f"tokens): {ds_times[0]:.3f} s / {ds_times[1]:.3f} s -> "
        f"{tasks_per_s:.1f} tasks embedded/s (second call); learning on it "
        f"{learn_only_s:.3f} s -> {R7 / learn_only_s:.2f} replications/s; "
        f"{card}")

    # the kernels' forward against the plain versions' forward, same
    # parameters and tokens, 3 micro-batches. An attention output that
    # rounds to the other bfloat16 neighbour (the kernel sums in another
    # order) moves the later layers by bfloat16 ulps through 26 layers, so
    # this comparison is coarse: phases 8 and 9 hold each kernel tightly at
    # these shapes. The limit (3e-2 mean, 0.3 max, of the mean |h|) lies
    # 1.6x above the sound reading on an H100 (1.9e-2) and must lie below
    # that of a planted fault, the plain attention without its causal mask
    # (1.06). A second fault, p kept in float32 before PV (where the plain
    # version, as the reference's default path, rounds it to bfloat16), read
    # 2.7e-2 the other way round: within the limit, so this comparison does
    # not tell the rounding point apart (tests/test_torch_models.py holds
    # it against the reference).
    rng10 = np.random.default_rng(0)
    lab = rng10.integers(0, 2, 3 * spec10.embed.batch_size).astype(np.int32)
    tok, _ = make_tokens(ec10, lab, np.zeros_like(lab, bool), 2,
                         cfg10.vocab_size, spec10.class_sep)
    tok = torch.as_tensor(tok, device=dev)
    cp10 = compute_params(params10)
    Bm = spec10.embed.batch_size

    def forward_with(attn=None, scan=None):
        saved = (mlayers.flash_attention, mrec.linear_scan)
        mlayers.flash_attention = attn or saved[0]
        mrec.linear_scan = scan or saved[1]
        try:
            return torch.cat([forward(cp10, cfg10, tok[i:i + Bm],
                                      logits_mode="hidden")
                              for i in range(0, len(tok), Bm)])
        finally:
            mlayers.flash_attention, mrec.linear_scan = saved

    def attention_p_f32(q, k, v, *, causal, window):
        """The plain attention with p kept in float32 before PV."""
        q, k, v = tsp(q), tsp(k), tsp(v)
        G, Sq, D = q.shape[1] // k.shape[1], q.shape[2], q.shape[3]
        kk = k.repeat_interleave(G, 1).float()
        vv = v.repeat_interleave(G, 1).float()
        sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (
            1.0 / math.sqrt(D))
        i = torch.arange(Sq, device=q.device)
        keep = torch.ones((Sq, Sq), dtype=torch.bool, device=q.device)
        if causal:
            keep &= i[None] <= i[:, None]
        if window > 0:
            keep &= i[:, None] - i[None] < window
        p = torch.softmax(sc.masked_fill(~keep, -1e30), -1)
        return tsp(torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype))

    plain_flash = lambda q, k, v, *, causal, window: flash_plain(
        q, k, v, causal, window)
    no_mask = lambda q, k, v, *, causal, window: flash_plain(
        q, k, v, False, 0)

    def scan_plain(a, b, h0=None):
        """The plain version of the route the wrapper takes."""
        return ROUTES[scan_route(*a.shape, a.dtype)][0](a, b, h0)
    hk = forward_with()
    hp = forward_with(plain_flash, scan_plain)
    scale = hp.abs().mean().item()

    def fwd_err(h):
        dh = (h - hp).abs()
        return (dh.mean().item() / scale, dh.max().item() / scale,
                dh.eq(0).float().mean().item())

    mean_rel, max_rel, frac_eq = fwd_err(hk)
    fault_nm = fwd_err(forward_with(no_mask, scan_plain))
    fault_pr = fwd_err(forward_with(attention_p_f32, scan_plain))
    say(f"[lm] kernels' forward vs plain forward on the card ({len(tok)} "
        f"tasks, hidden states): mean |dh| {mean_rel:.3g} and max "
        f"{max_rel:.3g} of the mean |h| {scale:.4g}; {frac_eq * 100:.1f}% "
        f"equal (limit: 3e-2 and 0.3). Planted faults, same measure: no "
        f"causal mask {fault_nm[0]:.3g} / {fault_nm[1]:.3g} "
        f"({fault_nm[2] * 100:.1f}% equal); p kept in float32 "
        f"{fault_pr[0]:.3g} / {fault_pr[1]:.3g} ({fault_pr[2] * 100:.1f}% "
        f"equal)")
    check(bool(torch.isfinite(hk).all()) and mean_rel <= 3e-2
          and max_rel <= 0.3, "the kernels' forward disagrees with the "
          "plain forward")
    check(fault_nm[0] > 3e-2, "the forward comparison's limit does not "
          "catch an attention without its causal mask")

    # every bfloat16 GEMM of one rglru block and one attn block at full
    # width (inside full_fp32, as forward runs them) against the same
    # product done by hand in float32 and rounded once: float32
    # accumulation, as the reference's. With it the two differ by at most
    # one bfloat16 ulp but in a few elements (near zero, or where the
    # tensor cores' float32 sums round otherwise): at most 3.7e-4 of them
    # on an H100. A planted fault, 8 slices of K summed to bfloat16 and
    # added in bfloat16 as a split-K GEMM with reduced-precision
    # reductions would, puts 0.2 of them beyond one ulp. The limit, 1e-2,
    # lies between the two.
    from torch.overrides import TorchFunctionMode

    def bf16_order(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    def gemm_by_hand(a, b, split):
        out = None
        for ks in torch.arange(a.shape[-1], device=a.device
                               ).tensor_split(split):
            part = (a[..., ks].float() @ b[ks].float()).to(bf16)
            out = part if out is None else out + part
        return out

    class GemmAudit(TorchFunctionMode):
        """Runs every op as it is; for each bfloat16 product, records the
        share of its elements more than one ulp from the product by hand,
        and the same for the planted fault."""
        def __init__(self):
            super().__init__()
            self.rows = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (getattr(func, "__name__", "") in ("matmul", "__matmul__")
                    and all(a.dtype == bf16 for a in args[:2])):
                a, b = args[:2]
                want = bf16_order(gemm_by_hand(a, b, 1))
                far = lambda y: ((bf16_order(y) - want).abs() > 1
                                 ).float().mean().item()
                self.rows.append((tuple(b.shape), far(out),
                                  far(gemm_by_hand(a, b, 8))))
            return out

    gp0 = tree_map(lambda t: t[0], cp10["groups"], is_leaf=torch.is_tensor)
    xb = cp10["embed"][tok[:Bm].long()].to(bf16)
    audit = GemmAudit()
    with full_fp32(), torch.no_grad(), audit:
        for bi, bkind in enumerate(group):
            xb = mmodel.apply_block(gp0[bi], bkind, xb, cfg10)
    gemm_far = max(r[1] for r in audit.rows)
    gemm_fault = min(r[2] for r in audit.rows)
    say(f"[lm] the bfloat16 GEMMs of blocks {', '.join(group)} at full width "
        f"(M = {Bm * spec10.embed.seq_len}), cuBLAS vs float32 accumulation "
        f"by hand: share of elements beyond one ulp per GEMM "
        + ", ".join(f"{r[0]} {r[1]:.3g}" for r in audit.rows)
        + f"; at most {gemm_far:.3g} (limit 1e-2). Planted bfloat16 split-K: "
        f"at least {gemm_fault:.3g}")
    check(len(audit.rows) > 0 and gemm_far <= 1e-2, "cuBLAS's bfloat16 GEMMs "
          "do not accumulate as float32 does")
    check(gemm_fault > 1e-2, "the GEMM check's limit does not catch "
          "bfloat16 split-K reductions")

    # a reduced model on the card against the port on the CPU: the same
    # features to the bfloat16 tolerance (cuBLAS and the CPU's GEMMs sum in
    # other orders), then the learning loop on the same round draws
    OVr = dict(OV10, **{"embed.reduced": True})
    spec_r = get_learning_spec("hybrid_small", OVr)
    Xg = ebank.make_dataset(spec_r, n_tr, n_te, seed=0, device="cuda")
    Xc = ebank.make_dataset(spec_r, n_tr, n_te, seed=0, device="cpu")
    dX = np.abs(Xg[0] - Xc[0])
    sX = np.abs(Xc[0]).mean()
    check(all(np.array_equal(a, b) for a, b in zip(Xg[1::2], Xc[1::2])),
          "reduced LM dataset: card and CPU labels differ")
    check(dX.mean() <= 3e-2 * sX and dX.max() <= 0.3 * sX,
          f"reduced LM features: card and CPU differ (mean {dX.mean()}, "
          f"max {dX.max()})")
    bcfg10 = dataclasses.replace(get_fast_config("hybrid_small"),
                                 n_tasks=10, batch_size=10, n_classes=2)
    g10 = torch.Generator(device=dev)
    g10.manual_seed(5)
    rng_d = np.random.default_rng(5)
    nr = 16
    draws10 = [simfast.draw_round(bcfg10, nr, n_tr, rng_d, g10)
               for _ in range(ROUNDS)]
    draws10 = [dict(d, u=d["u"].cpu()) for d in draws10]
    kwr = dict(n_reps=nr, rounds=ROUNDS, fit_steps=FIT, draws=draws10)
    cg = run_learning("hybrid_small", *Xg, device="cuda", **kwr)["curve"]
    cc = run_learning("hybrid_small", *Xc, device="cpu", **kwr)["curve"]
    ga, ca = cg["acc"][:, -1].cpu().numpy(), cc["acc"][:, -1].numpy()
    gap = abs(float(ga.mean()) - float(ca.mean()))
    same_nl = (cg["n_labeled"].cpu() == cc["n_labeled"]).float().mean()
    say(f"[lm] reduced model, card vs CPU: features mean |dX| "
        f"{dX.mean() / sX:.3g} and max {dX.max() / sX:.3g} of the mean |X|; "
        f"learning on the same draws ({nr} reps): final accuracy "
        f"{ga.mean():.4f} vs {ca.mean():.4f} (gap {gap:.4g}, CPU std "
        f"{ca.std():.4f}); n_labeled equal in {same_nl.item() * 100:.0f}% "
        f"of entries")
    check(gap <= max(float(ca.std()), 0.02),
          "reduced LM learning: card and CPU final accuracy differ")

    # ---- timings of phases 8-10 -----------------------------------------
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash_t = {}
    for label, (shape, causal, window, dt, (q, k, v)) in \
            flash_inputs_kept.items():
        B, Hq, Hkv, Sq, Sk, D = shape
        reps = 50 if Sq <= 64 else 5
        call = lambda: flash_attention(q, k, v, causal=causal,
                                       window=window)
        ms = cuda_ms(call, reps)
        plain = cuda_ms(lambda: flash_plain(q, k, v, causal, window), reps)
        if window == 0 or window >= Sq:
            lib_call = lambda: sdpa(tsp(q), tsp(k), tsp(v), is_causal=causal,
                                    enable_gqa=True)
        else:
            qi = torch.arange(Sq, device=dev)
            mask = ((qi[None] <= qi[:, None])
                    & (qi[:, None] - qi[None] < window))
            lib_call = lambda: sdpa(tsp(q), tsp(k), tsp(v), attn_mask=mask,
                                    enable_gqa=True)
        lib = cuda_ms(lib_call, reps)

        def many():
            for _ in range(reps):
                call()
        dev_us, n_ev = mean_us(kernel_events(many)[1], "flash_fwd")
        bound, by, nbytes = flash_bound_ms(B, Hq, Hkv, Sq, Sk, D, 2, causal,
                                           window)
        # device time per call without host gaps: the kernel and SDPA each
        # replayed from a CUDA graph of 20 calls
        g_ms, g_lib = graph_ms(call, 20), graph_ms(lib_call, 20)
        flash_t[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=bound, bound_by=by, dev_us=dev_us)
        dev_txt = (f"device {dev_us:.2f} us ({bound * 1e3 / dev_us * 100:.1f}"
                   f"% of bound; {n_ev} of {reps} launches in the profile)"
                   if dev_us > 0 else "device time not measured (no device "
                   "events in the profile)")
        lib_kernels = sorted(kernel_events(
            lambda: [lib_call() for _ in range(reps)])[1])
        say(f"[time] SDPA's kernels at {label}: "
            + ("; ".join(n_[:90] for n_ in lib_kernels) or "none recorded"))
        say(f"[time] flash_attention {label}: per call {ms * 1e3:.2f} us, "
            f"{dev_txt}, plain per call {plain * 1e3:.2f} us, SDPA per call "
            f"{lib * 1e3:.2f} us, bound {bound * 1e3:.3f} us ({by}, {nbytes} "
            f"B); from a CUDA graph: kernel {fmt_us(g_ms)}, SDPA "
            f"{fmt_us(g_lib)} per call; {card}")
    # both routes' forward kernels at the kept shapes (the wrapper's own
    # route marked), launched directly; device time by the profiler
    scan_t = {}
    KNAME = {"sequential": ("linear_scan_fwd", "linear_scan_bwd"),
             "chunked": ("linear_scan_chunked_fwd", "linear_scan_chunked_bwd")}
    for label, (a, b, h0) in scan_inputs_kept.items():
        B, S, D = a.shape
        reps = 50 if S <= 64 else 10
        h0f = h0.float()
        bound, by, nbytes = scan_bound_ms(B, S, D, 4, True)
        for r in ROUTES:
            call = lambda: kscan._fwd_kernel(a, b, h0f, r)
            ms = cuda_ms(call, reps)
            plain = cuda_ms(lambda: ROUTES[r][0](a, b, h0), 1)

            def many():
                for _ in range(reps):
                    call()
            dev_us, n_ev = mean_us(kernel_events(many)[1], KNAME[r][0])
            scan_t[(label, r)] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                      bound_by=by, dev_us=dev_us)
            share = bound * 1e3 / dev_us * 100 if dev_us > 0 else 0.0
            dev_txt = (f"device {dev_us:.2f} us ({share:.1f}% of bound; "
                       f"{n_ev} of {reps} launches in the profile)"
                       if dev_us > 0 else "device time not measured (no "
                       "device events in the profile)")
            mine = " (the wrapper's route)" if r == scan_route(B, S, D, f32) \
                else ""
            say(f"[time] linear_scan {r}{mine} {label} with h0: per call "
                f"{ms * 1e3:.2f} us ({bound / ms * 100:.1f}% of bound), "
                f"{dev_txt}, plain per call {plain * 1e3:.2f} us, bound "
                f"{bound * 1e3:.3f} us ({by}, {nbytes} B); {card}")
    # where the routes cross: the forward per call at S = 512 over B
    sweep = []
    for S_ in (48, 128, 512):
        for B in (4, 8, 16, 24, 32, 64):
            a = torch.sigmoid(torch.randn((B, S_, 2560), generator=gen,
                                          device=dev))
            b = torch.randn((B, S_, 2560), generator=gen, device=dev)
            h0f = torch.randn((B, 2560), generator=gen, device=dev)
            t_ = {r: cuda_ms(lambda: kscan._fwd_kernel(a, b, h0f, r), 20)
                  for r in ROUTES}
            sweep.append(
                f"({B}, {S_}) route {scan_route(B, S_, 2560, f32)}: "
                f"sequential {t_['sequential'] * 1e3:.2f} us, chunked "
                f"{t_['chunked'] * 1e3:.2f} us, bound "
                f"{scan_bound_ms(B, S_, 2560, 4, True)[0] * 1e3:.2f} us")
            del a, b, h0f
    say(f"[time] linear_scan forward per call at (B, S, 2560) f32 with h0, "
        f"both routes: " + "; ".join(sweep) + f"; {card}")
    # where an encoder micro-batch's time goes
    toks2 = tok[:2 * Bm]
    lens2 = torch.full((2 * Bm,), spec10.embed.seq_len, dtype=torch.int32,
                       device=dev)
    # (the full model's parameters passed as they are: the reduced runs
    # above may have pushed them out of the encoder's two-entry cache)
    enc2 = lambda: eenc.encode(ec10, toks2, lens2, spec10.n_features,
                               device=dev, params=params10)
    enc2()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc2()
    torch.cuda.synchronize()
    enc_wall = time.perf_counter() - t0
    wall, n_k, busy, by_name = device_profile(enc2)
    if n_k:
        say(f"[profile] encoder, 2 micro-batches of {Bm} x "
            f"{spec10.embed.seq_len} tokens: {n_k} kernels, device busy "
            f"{busy / 1e3:.2f} ms of {enc_wall * 1e3:.2f} ms wall without "
            f"the profiler ({wall * 1e3:.2f} ms with it): device idle "
            f"{(1 - busy / 1e6 / enc_wall) * 100:.1f}%; {card}")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
            say(f"[profile]   {us / 2e3:8.3f} ms/micro-batch  {name[:90]}")
    else:
        say("[profile] encoder: device time not measured (no device events)")

    # ---- phase 11: the streaming_xent kernels against their plain versions
    # free what the earlier phases hold on the card: the encoder's cached
    # full-width parameters (11.6 GB) and the kept kernel inputs
    del params10, cp10, gp0, xb, flash_inputs_kept, scan_inputs_kept
    del ent_inputs, hk, hp
    eenc._params.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    # tolerances: loss and lse read the same values as the plain version
    # and sum in float32 in other orders (2e-4 absolute, 1e-5 relative);
    # dlogits: the kernel's exp differs from torch's in the last bits (1e-6
    # absolute, 1e-4 relative), and a bfloat16 result can round to the
    # other neighbour (8e-3 relative, one ulp)
    XENT_MAIN = "training (2048, 256000) f32"
    xent_cases = [(f"test ({N}, {V}) {str(dt)[6:]}", N, V, dt)
                  for N, V in ((10, 100), (64, 50304), (33, 777))
                  for dt in (f32, bf16)]
    xent_cases += [(XENT_MAIN, 2048, 256000, f32),
                   ("ignored rows (257, 1001) f32", 257, 1001, f32)]
    xent_errs, xent_kept = {}, None
    for label, N, V, dt in xent_cases:
        x = (torch.randn((N, V), generator=gen, device=dev) * 3).to(dt)
        t = torch.randint(0, V, (N,), generator=gen, device=dev)
        g = torch.randn((N,), generator=gen, device=dev)
        ign = torch.zeros((N,), dtype=torch.bool, device=dev)
        if label.startswith("ignored"):
            # softmax_xent clamps an ignored target (-1) to 0 and masks its
            # row: its gradient is 0
            ign = torch.rand((N,), generator=gen, device=dev) < 0.3
            t = torch.where(ign, torch.zeros_like(t), t)
            g = torch.where(ign, torch.zeros_like(g), g)
        t32 = t.to(torch.int32)
        loss, lse = kxent._fwd_kernel(x, t32)
        dx = kxent._bwd_kernel(x, t32, lse, g)
        torch.cuda.synchronize()
        want_lse = torch.logsumexp(x.float(), -1)
        want_dx = xent_bwd_ref(x, t, want_lse, g)
        e_loss = (loss - xent_ref(x, t)).abs().max().item()
        e_lse = (lse - want_lse).abs().max().item()
        e_dx = (dx.float() - want_dx.float()).abs().max().item()
        rt = 8e-3 if dt == bf16 else 1e-4
        ok = (bool(torch.isfinite(loss).all()) and dx.dtype == dt
              and bool(torch.allclose(loss, xent_ref(x, t), atol=2e-4,
                                      rtol=1e-5))
              and bool(torch.allclose(lse, want_lse, atol=2e-4, rtol=1e-5))
              and bool(torch.allclose(dx.float(), want_dx.float(),
                                      atol=1e-6, rtol=rt))
              and bool((dx[ign] == 0).all()))
        say(f"[xent] {label}: max|dloss|={e_loss:.3g} max|dlse|={e_lse:.3g} "
            f"(atol 2e-4, rtol 1e-5), max|ddlogits|={e_dx:.3g} (atol 1e-6, "
            f"rtol {rt}){'; ignored rows: dlogits 0' if ign.any() else ''}")
        check(ok, f"streaming_xent kernels disagree with their plain "
              f"versions at {label}")
        again = kxent._fwd_kernel(x, t32)
        check(torch.equal(loss, again[0]) and torch.equal(lse, again[1])
              and torch.equal(dx, kxent._bwd_kernel(x, t32, lse, g)),
              f"streaming_xent is not repeatable at {label}")
        xent_errs[label] = (e_loss, e_dx)
        if label == XENT_MAIN:
            xent_kept = (x, t, t32, g, lse)
        del x, dx, want_dx
    x, t, t32, g, lse = xent_kept
    N, V = x.shape
    reps = 10
    xent_t = {}
    ms_f = cuda_ms(lambda: kxent._fwd_kernel(x, t32), reps)
    ms_b = cuda_ms(lambda: kxent._bwd_kernel(x, t32, lse, g), reps)
    plain_f = cuda_ms(lambda: xent_ref(x, t), reps)
    plain_b = cuda_ms(lambda: xent_bwd_ref(x, t, lse, g), reps)
    F = torch.nn.functional
    lib_f = cuda_ms(lambda: F.cross_entropy(x, t, reduction="none"), reps)
    xr = x.detach().requires_grad_(True)
    lib_loss = F.cross_entropy(xr, t, reduction="none")
    lib_b = cuda_ms(lambda: torch.autograd.grad(lib_loss, xr, g,
                                                retain_graph=True), reps)
    del lib_loss, xr

    def many_xent():
        for _ in range(reps):
            kxent._bwd_kernel(x, t32, *kxent._fwd_kernel(x, t32)[1:], g)
    _, events = kernel_events(many_xent)
    for direction, ms, plain, lib in (("fwd", ms_f, plain_f, lib_f),
                                      ("bwd", ms_b, plain_b, lib_b)):
        dev_us, n_ev = mean_us(events, f"xent_{direction}")
        bound, by, nbytes = xent_bound_ms(N, V, 4, direction == "bwd")
        xent_t[direction] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                 bound_ms=bound, bound_by=by, dev_us=dev_us)
        dev_txt = (f"device {dev_us:.2f} us ({bound * 1e3 / dev_us * 100:.1f}"
                   f"% of bound; {n_ev} of {reps} launches in the profile)"
                   if dev_us > 0 else "device time not measured (no device "
                   "events in the profile)")
        say(f"[time] streaming_xent {direction} {XENT_MAIN}: per call "
            f"{ms * 1e3:.2f} us, {dev_txt}, plain per call "
            f"{plain * 1e3:.2f} us, F.cross_entropy(reduction='none') "
            f"{'forward' if direction == 'fwd' else 'backward (autograd)'} "
            f"per call {lib * 1e3:.2f} us, bound {bound * 1e3:.3f} us ({by}, "
            f"{nbytes} B); {card}")
    del x, t, t32, g, lse, xent_kept
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 12: the backward kernels against their plain backward ----
    # flash: dq, dk, dv against attention_bwd_ref (float32, P materialized)
    # on the kernel forward's o, at the reference tests' 2e-2 in bfloat16
    # (both round float32 sums to bfloat16) and 1e-4 in float32 (5x the
    # forward's 2e-5: dk and dv sum G * Sq terms, ds cancels p (dp -
    # delta)); the forward's o is also held equal with and without lse
    def fbwd_tol(dt):
        return 2e-2 if dt == bf16 else 1e-4

    FB_MAIN = "training (4, 512, 10/1, 256) bf16"
    fb_cases = []
    for shape in [(2, 4, 2, 256, 256, 64), (1, 8, 8, 384, 384, 128),
                  (2, 4, 1, 128, 512, 64), (1, 2, 2, 200, 200, 64),
                  (1, 6, 2, 256, 256, 128)]:
        for causal, window in [(True, 0), (False, 0), (True, 96)]:
            if not causal and shape[3] != shape[4]:
                continue
            for dt in (f32, bf16):
                fb_cases.append((f"grid {shape} c={int(causal)} w={window} "
                                 f"{str(dt)[6:]}", shape, causal, window, dt))
    fb_cases += [
        ("encoder (64, 48, 10/1, 256) bf16", FLASH_MAIN, True, 2048, bf16),
        ("window at length (1, 4096, 10/1, 256) bf16",
         (1, 10, 1, 4096, 4096, 256), True, 2048, bf16),
        ("ragged (2, 77, 4/2, 80) bf16", (2, 4, 2, 77, 77, 80), True, 0,
         bf16),
        ("short window (1, 300, 10/1, 256) f32", (1, 10, 1, 300, 300, 256),
         True, 64, f32),
        ("unaligned rows (1, 100, 3/1, 60) bf16", (1, 3, 1, 100, 100, 60),
         True, 0, bf16),
        ("head groups of 2 and 3 (3, 700, 10/2, 64) bf16",
         (3, 10, 2, 700, 700, 64), True, 0, bf16),
        (FB_MAIN, (4, 10, 1, 512, 512, 256), True, 2048, bf16)]
    fb_errs, fb_kept = {}, None
    for label, shape, causal, window, dt in fb_cases:
        B, Hq, Hkv, Sq, Sk, D = shape
        q, k, v = flash_inputs(*shape, dt, "bshd")
        do = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(dt)
        o, lse = kflash._fwd_kernel(q, k, v, causal, window, True)
        dq, dk, dv = kflash._bwd_kernel(q, k, v, o, lse, do, causal, window)
        torch.cuda.synchronize()
        want = attention_bwd_ref(tsp(q), tsp(k), tsp(v), tsp(o), tsp(do),
                                 causal=causal, window=window)
        tl = fbwd_tol(dt)
        errs_ = []
        ok = torch.equal(o, kflash._fwd_kernel(q, k, v, causal, window,
                                               False)[0])
        for got, w in zip((dq, dk, dv), want):
            w = tsp(w)
            errs_.append((got.float() - w.float()).abs().max().item())
            ok = ok and (got.shape == w.shape and got.dtype == dt
                         and bool(torch.isfinite(got).all())
                         and bool(torch.allclose(got.float(), w.float(),
                                                 atol=tl, rtol=tl)))
        say(f"[flash-bwd] {label}: max|ddq|={errs_[0]:.3g} "
            f"max|ddk|={errs_[1]:.3g} max|ddv|={errs_[2]:.3g} (atol/rtol "
            f"{tl}); o equal with and without lse")
        check(ok, f"flash_attention backward disagrees with its plain "
              f"version at {label}")
        again = kflash._bwd_kernel(q, k, v, o, lse, do, causal, window)
        check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
              f"flash_attention backward is not repeatable at {label}")
        fb_errs[label] = max(errs_)
        if label == FB_MAIN:
            fb_kept = (q, k, v, o, lse, do)
        del want, again
    # scan: da, db, dh0 of each route's backward kernel against its plain
    # backward (linear_scan_bwd_ref / linear_scan_chunked_bwd_ref), bit for
    # bit, on its own route's forward output; the chunked plain backward
    # within 4e-4 (tests/test_torch_kernels.py's tolerance against jax.vjp)
    # of the sequential one
    SB_MAIN = "training rglru (4, 512, 2560) f32"
    sb_cases = [(f"grid ({B}, {S}, {D}) {str(dt)[6:]}", B, S, D, dt)
                for B, S, D in ((1, 64, 64), (3, 300, 150), (8, 256, 128),
                                (2, 1000, 33))
                for dt in (f32, bf16)]
    sb_cases += [("encoder rglru (64, 48, 2560) f32", *SCAN_MAIN, f32),
                 ("long (2, 4096, 2560) f32", 2, 4096, 2560, f32),
                 ("ragged (3, 1001, 2560) f32", 3, 1001, 2560, f32),
                 (SB_MAIN, 4, 512, 2560, f32)]
    sb_kept, sb_err_main = None, {}
    for label, B, S, D, dt in sb_cases:
        a = torch.sigmoid(torch.randn((B, S, D), generator=gen,
                                      device=dev)).to(dt)
        b = torch.randn((B, S, D), generator=gen, device=dev).to(dt)
        h0 = torch.randn((B, D), generator=gen, device=dev)
        g = torch.randn((B, S, D), generator=gen, device=dev).to(dt)
        for init in (h0, None):
            txt, ok, wants = [], True, {}
            for r in ROUTES:
                h = kscan._fwd_kernel(a, b, init, r)
                da, db, dh0 = kscan._bwd_kernel(a, h, init, g,
                                                init is not None, r)
                torch.cuda.synchronize()
                wa, wb, wh0 = wants[r] = ROUTES[r][1](a, h, g, init)
                same = (torch.equal(da, wa) and torch.equal(db, wb)
                        and (init is None or torch.equal(dh0, wh0)))
                again = kscan._bwd_kernel(a, h, init, g, init is not None, r)
                rep = all(x is None or torch.equal(x, y)
                          for x, y in zip((da, db, dh0), again))
                err = max((da.float() - wa.float()).abs().max().item(),
                          (db.float() - wb.float()).abs().max().item())
                txt.append(f"{r} max|dda|, |ddb|={err:.3g} "
                           f"{'bit-equal' if same else 'NOT bit-equal'}"
                           f"{'' if rep else ' NOT repeatable'}")
                ok = ok and same and rep and bool(
                    torch.isfinite(da.float()).all())
                if label == SB_MAIN:
                    sb_err_main[r] = err
            gap = max((x.float() - y.float()).abs().max().item()
                      for x, y in zip(wants["chunked"], wants["sequential"])
                      if x is not None)
            tb_ = 4e-4 if dt == f32 else 2e-2
            close = all(bool(torch.allclose(x.float(), y.float(), atol=tb_,
                                            rtol=tb_))
                        for x, y in zip(wants["chunked"], wants["sequential"])
                        if x is not None)
            say(f"[scan-bwd] {label} h0={'yes' if init is not None else 'no'}"
                f": " + ", ".join(txt) + f"; chunked vs sequential plain "
                f"{gap:.3g} (atol/rtol {tb_})")
            check(ok and close, f"a linear_scan backward kernel disagrees "
                  f"with its plain version at {label}")
        if label == SB_MAIN:
            sb_kept = (a, b, h0, g)

    # timings at the training shapes
    q, k, v, o, lse, do = fb_kept
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    reps = 10
    ms = cuda_ms(lambda: kflash._bwd_kernel(q, k, v, o, lse, do, True,
                                            2048), reps)
    plain = cuda_ms(lambda: attention_bwd_ref(tsp(q), tsp(k), tsp(v),
                                              tsp(o), tsp(do), causal=True,
                                              window=2048), reps)
    qr, kr, vr = (tsp(z).detach().requires_grad_(True) for z in (q, k, v))
    lib_o = sdpa(qr, kr, vr, is_causal=True, enable_gqa=True)
    lib = cuda_ms(lambda: torch.autograd.grad(lib_o, (qr, kr, vr), tsp(do),
                                              retain_graph=True), reps)
    del lib_o
    # device times from CUDA graphs: the backward kernels alone, and the
    # forward, and forward plus backward, of both the kernels and SDPA
    # (SDPA's backward is captured with its own forward)
    g_bwd = graph_ms(lambda: kflash._bwd_kernel(q, k, v, o, lse, do, True,
                                                2048), 10)
    g_fb = graph_ms(lambda: torch.autograd.grad(
        flash_attention(qr.transpose(1, 2), kr.transpose(1, 2),
                        vr.transpose(1, 2), causal=True, window=2048),
        (qr, kr, vr), do), 10)
    g_lib_f = graph_ms(lambda: sdpa(qr, kr, vr, is_causal=True,
                                    enable_gqa=True), 10)
    g_lib_fb = graph_ms(lambda: torch.autograd.grad(
        sdpa(qr, kr, vr, is_causal=True, enable_gqa=True), (qr, kr, vr),
        tsp(do)), 10)
    g_lib_b = (None if g_lib_f is None or g_lib_fb is None
               else g_lib_fb - g_lib_f)
    say(f"[time] flash_attention backward {FB_MAIN} from CUDA graphs: the "
        f"kernels {fmt_us(g_bwd)}, forward + backward {fmt_us(g_fb)}; SDPA "
        f"forward {fmt_us(g_lib_f)}, forward + backward {fmt_us(g_lib_fb)}, "
        f"so its backward {fmt_us(g_lib_b)} per call; {card}")
    del qr, kr, vr

    def many_fb():
        for _ in range(reps):
            kflash._bwd_kernel(q, k, v, o, lse, do, True, 2048)
    _, events = kernel_events(many_fb)
    dev_us, n_ev = mean_us(events, "flash_bwd")
    parts = {part: mean_us(events, part)
             for part in ("flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv",
                          "flash_bwd_reduce")}
    bound, by, nbytes = flash_bwd_bound_ms(B, Hq, Hkv, Sq, Sq, D, 2, True,
                                           2048)
    fb_t = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                bound_by=by, dev_us=dev_us)
    dev_txt = (f"device {dev_us:.2f} us ({bound * 1e3 / dev_us * 100:.1f}% "
               f"of bound; " + ", ".join(f"{n} {u:.1f} us ({c} events)"
                                         for n, (u, c) in parts.items())
               + f" of {reps} launches)" if dev_us > 0 else "device time not "
               "measured (no device events in the profile)")
    say(f"[time] flash_attention backward {FB_MAIN}: per call "
        f"{ms * 1e3:.2f} us, {dev_txt}, plain per call {plain * 1e3:.2f} us, "
        f"SDPA backward (autograd) per call {lib * 1e3:.2f} us, bound "
        f"{bound * 1e3:.3f} us ({by}, {nbytes} B); {card}")
    del fb_kept, q, k, v, o, lse, do
    a, b, h0, g = sb_kept
    B, S, D = a.shape
    bound, by, nbytes = scan_bwd_bound_ms(B, S, D, 4)
    sb_t = {}
    for r in ROUTES:
        h = kscan._fwd_kernel(a, b, h0, r)
        call = lambda: kscan._bwd_kernel(a, h, h0, g, True, r)
        ms = cuda_ms(call, reps)
        plain = cuda_ms(lambda: ROUTES[r][1](a, h, g, h0), 2)

        def many_sb():
            for _ in range(reps):
                call()
        dev_us, n_ev = mean_us(kernel_events(many_sb)[1], KNAME[r][1])
        sb_t[r] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                       dev_us=dev_us)
        dev_txt = (f"device {dev_us:.2f} us ({bound * 1e3 / dev_us * 100:.1f}"
                   f"% of bound; {n_ev} of {reps} launches in the profile)"
                   if dev_us > 0 else "device time not measured (no device "
                   "events in the profile)")
        mine = " (the wrapper's route)" if r == scan_route(B, S, D, f32) \
            else ""
        say(f"[time] linear_scan backward {r}{mine} {SB_MAIN} with h0: per "
            f"call {ms * 1e3:.2f} us ({bound / ms * 100:.1f}% of bound), "
            f"{dev_txt}, plain per call {plain * 1e3:.2f} us, bound "
            f"{bound * 1e3:.3f} us ({by}, {nbytes} B); {card}")
    del sb_kept, a, b, h0, g, h

    # gradients reach every input through the public wrappers on the card
    mk = lambda shape, dt: torch.randn(shape, generator=gen, device=dev).to(
        dt).requires_grad_(True)
    q, k, v = mk((2, 48, 10, 256), bf16), mk((2, 48, 1, 256), bf16), \
        mk((2, 48, 1, 256), bf16)
    o = flash_attention(q, k, v, causal=True, window=2048)
    a = torch.sigmoid(torch.randn((2, 48, 64), generator=gen, device=dev)
                      ).requires_grad_(True)
    b, h0 = mk((2, 48, 64), f32), mk((2, 64), f32)
    hs = linear_scan(a, b, h0)
    lg = mk((8, 1000), f32)
    xl = streaming_xent(lg, torch.arange(8, device=dev))
    check(all(z.grad_fn is not None for z in (o, hs, xl)),
          "a kernel's output on the card has no grad_fn")
    (o.float().square().sum() + hs.square().sum() + xl.sum()).backward()
    flow = {n: z.grad for n, z in (("q", q), ("k", k), ("v", v), ("a", a),
                                   ("b", b), ("h0", h0), ("logits", lg))}
    check(all(gz is not None and bool(torch.isfinite(gz.float()).all())
              and gz.abs().max().item() > 0 for gz in flow.values()),
          f"a gradient does not reach every input on the card: "
          f"{[n for n, gz in flow.items() if gz is None]}")
    say(f"[grad] on the card: flash, scan and xent outputs carry a grad_fn; "
        f"a backward reaches {', '.join(flow)} with finite, nonzero "
        f"gradients")
    del q, k, v, o, a, b, h0, hs, lg, xl, flow

    # ---- phase 13: training recurrentgemma-2b at full width --------------
    gc.collect()
    torch.cuda.empty_cache()
    cfg13 = get_config("recurrentgemma-2b")
    if TRAIN_REDUCED:
        cfg13 = reduced(cfg13)
    corpus13 = CorpusConfig(vocab_size=cfg13.vocab_size, seq_len=512,
                            global_batch=4)
    STEPS13 = 5
    tc13 = TrainConfig(steps=STEPS13, lr=3e-4, warmup=1, log_every=1,
                       seed=0)
    # one fixed batch (the corpus's first), so that the loss must fall
    batch13 = make_batch(corpus13, 0)
    tokens13 = corpus13.global_batch * corpus13.seq_len
    group, n_full, rem = cfg13.layer_groups()
    n_attn, n_rglru = (group * n_full + rem).count("attn"), \
        (group * n_full + rem).count("rglru")
    # remat recomputes each stacked group's forward in the backward (the
    # reference's jax.checkpoint(group_body)); the unrolled tail is not
    # recomputed
    want13 = {"streaming_xent": (1, 1),
              "flash_attention": (n_attn + group.count("attn") * n_full,
                                  n_attn),
              "linear_scan": (n_rglru + group.count("rglru") * n_full,
                              n_rglru)}
    kern13 = {"streaming_xent": streaming_xent,
              "flash_attention": flash_attention, "linear_scan": linear_scan}

    class FixedLoader:
        """The same batch every step; records when each step asks."""
        def __init__(self):
            self.times = []

        def __next__(self):
            self.times.append(time.perf_counter())
            return batch13

    def train_once(logs):
        for fn in kern13.values():
            fn.launches = fn.bwd_launches = 0
        linear_scan.chunked_launches = linear_scan.chunked_bwd_launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loader = FixedLoader()
        trainer = Trainer(cfg13, corpus13, tc13, log=logs.append,
                          device="cuda")
        t0 = time.perf_counter()
        state = trainer.run(loader=loader)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = {n: (fn.launches, fn.bwd_launches)
                    for n, fn in kern13.items()}
        launches["linear_scan_chunked"] = (linear_scan.chunked_launches,
                                           linear_scan.chunked_bwd_launches)
        peak = torch.cuda.max_memory_allocated()
        steps = np.diff(loader.times + [t_end])
        return dict(trainer=trainer, state=state, launches=launches,
                    peak=peak, init_s=loader.times[0] - t0, steps=steps,
                    losses=[m["loss"] for _, m in trainer.metrics_log],
                    gnorms=[m["grad_norm"] for _, m in trainer.metrics_log])

    def digest(params):
        """An exact digest of the parameters' bits: per leaf, the int32
        view weighted by position, summed in (wrapping) int64, in chunks."""
        out = []
        for leaf in leaves(params, torch.is_tensor):
            flat = leaf.detach().reshape(-1).view(torch.int32)
            acc = 0
            for i0 in range(0, flat.numel(), 1 << 26):
                bits = flat[i0:i0 + (1 << 26)].to(torch.int64)
                w = (torch.arange(i0, i0 + bits.numel(), device=bits.device)
                     % 1000003 + 1)
                acc += int((bits * w).sum())
            out.append(acc)
        return out

    logs13 = []
    r1 = train_once(logs13)
    for line in logs13:
        say(line)
    per_step = STEPS13
    for n, want in want13.items():
        got = r1["launches"][n]
        check(got == (want[0] * per_step, want[1] * per_step),
              f"training made {got} (forward, backward) {n} launches in "
              f"{per_step} steps, expected "
              f"{(want[0] * per_step, want[1] * per_step)}")
    # the scans at (4, 512, 2560) take the chunked route, forward and
    # backward
    route13 = scan_route(corpus13.global_batch, corpus13.seq_len, cfg13.d_lru,
                         f32)
    want_ch = (r1["launches"]["linear_scan"] if route13 == "chunked"
               else (0, 0))
    check(r1["launches"]["linear_scan_chunked"] == want_ch,
          f"training made {r1['launches']['linear_scan_chunked']} chunked "
          f"scan launches, expected {want_ch} (route {route13})")
    check(all(math.isfinite(x) for x in r1["losses"] + r1["gnorms"]),
          f"training losses or grad norms not finite: {r1['losses']}, "
          f"{r1['gnorms']}")
    loss_fn13 = make_loss_fn(cfg13, remat=False)
    b13 = {k_: torch.as_tensor(v_, device=dev) for k_, v_ in batch13.items()}
    with torch.no_grad(), full_fp32():
        final_loss = float(loss_fn13(r1["state"]["params"], b13)[1]["loss"])
    check(final_loss < r1["losses"][0], f"the loss on the fixed batch did not "
          f"fall: {r1['losses'][0]} -> {final_loss}")
    d1 = digest(r1["state"]["params"])
    # where a step's time goes: one more step under the profiler
    step_fn = r1["trainer"].step_fn
    state13 = r1["state"]
    for fn in kern13.values():
        fn.launches = fn.bwd_launches = 0
    linear_scan.chunked_launches = linear_scan.chunked_bwd_launches = 0
    wall, ev13 = kernel_events(lambda: step_fn(state13, b13))
    n_k = sum(len(v) for v in ev13.values())
    by_name = {n: sum(v) for n, v in ev13.items()}
    busy = sum(by_name.values())
    # the profile's events of the port's kernels against the launches the
    # wrappers counted in that step
    seen13 = {n: mean_us(ev13, n)[1]
              for n in ("xent_fwd", "xent_bwd", "flash_fwd", "flash_bwd_dq",
                        "flash_bwd_dkdv", "linear_scan_fwd",
                        "linear_scan_bwd", "linear_scan_chunked_fwd",
                        "linear_scan_chunked_bwd")}
    made13 = {"xent_fwd": streaming_xent.launches,
              "xent_bwd": streaming_xent.bwd_launches,
              "flash_fwd": flash_attention.launches,
              "flash_bwd_dq": flash_attention.bwd_launches,
              "flash_bwd_dkdv": flash_attention.bwd_launches,
              "linear_scan_fwd": (linear_scan.launches
                                  - linear_scan.chunked_launches),
              "linear_scan_bwd": (linear_scan.bwd_launches
                                  - linear_scan.chunked_bwd_launches),
              "linear_scan_chunked_fwd": linear_scan.chunked_launches,
              "linear_scan_chunked_bwd": linear_scan.chunked_bwd_launches}
    # the same step in this process with the scans forced onto the
    # sequential route, then on their own route again: the chunked route's
    # share of the step, measured on one card in turns
    def step_busy():
        _, ev = kernel_events(lambda: step_fn(state13, b13))
        return (sum(sum(v) for v in ev.values()),
                sum(sum(v) for n_, v in ev.items() if "linear_scan" in n_))
    own_route = kscan.scan_route
    kscan.scan_route = lambda B, S, D, dtype: "sequential"
    try:
        ab_seq = step_busy()
    finally:
        kscan.scan_route = own_route
    ab_own = step_busy()
    n_params = sum(t_.numel() for t_ in leaves(state13["params"],
                                               torch.is_tensor))
    del r1["state"], r1["trainer"], state13, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    r2 = train_once([])
    check(r2["losses"] == r1["losses"] and r2["gnorms"] == r1["gnorms"]
          and digest(r2["state"]["params"]) == d1,
          "two training runs from the same seed differ")
    del r2
    gc.collect()
    torch.cuda.empty_cache()
    sps = 1.0 / float(np.mean(r1["steps"][1:]))
    say(f"[train] {cfg13.name}{' (reduced)' if TRAIN_REDUCED else ''}: "
        f"{n_params} parameters, {cfg13.n_layers} layers, d_model "
        f"{cfg13.d_model}, vocab {cfg13.vocab_size}; batch "
        f"{corpus13.global_batch} x {corpus13.seq_len} tokens (fixed), "
        f"microbatches 1, remat on, AdamW lr 3e-4; {STEPS13} steps")
    say(f"[train] losses {', '.join(f'{x:.6f}' for x in r1['losses'])}; "
        f"after the last step {final_loss:.6f}; grad norms "
        f"{', '.join(f'{x:.4f}' for x in r1['gnorms'])}; second run from "
        f"the same seed: losses, grad norms and parameter digest bit-equal. "
        f"The scans take the {route13} route here (chunks of the recurrence "
        f"composed in order), so the sums, and with them the losses, are "
        f"ordered otherwise than by the sequential kernel")
    say(f"[train] launches per step (forward, backward): "
        + ", ".join(f"{n} {tuple(c // per_step for c in r1['launches'][n])}"
                    for n in kern13)
        + f" = expected (flash forward {n_attn} + {n_attn} recomputed, scan "
        f"forward {n_rglru} + {group.count('rglru') * n_full} recomputed: "
        f"the tail's {rem.count('rglru')} are not); of the scans' "
        f"{tuple(c // per_step for c in r1['launches']['linear_scan_chunked'])}"
        f" on the chunked route")
    say(f"[time] training: parameters drawn in {r1['init_s']:.1f} s; step "
        f"times {', '.join(f'{s_:.3f}' for s_ in r1['steps'])} s -> "
        f"{sps:.3f} steps/s, {sps * tokens13:.0f} tokens/s (steps 2-"
        f"{STEPS13}); peak memory {r1['peak'] / 1e9:.2f} GB "
        f"(max_memory_allocated); {card}")
    check(r1["peak"] < 80e9, "peak memory above 80 GB")
    if n_k:
        step_s = float(np.mean(r1["steps"][1:]))
        say(f"[profile] one training step: {n_k} kernels, device busy "
            f"{busy / 1e3:.1f} ms of {step_s * 1e3:.1f} ms wall without the "
            f"profiler ({wall * 1e3:.1f} ms with it): device idle "
            f"{(1 - busy / 1e6 / step_s) * 100:.1f}%; {card}")
        say("[profile] the port's kernels, events in the profile / launches "
            "counted: " + ", ".join(f"{n} {seen13[n]}/{made13[n]}"
                                    for n in seen13))
        for part in ("flash_fwd", "flash_bwd", "linear_scan_chunked_fwd",
                     "linear_scan_chunked_bwd", "linear_scan_fwd",
                     "linear_scan_bwd", "linear_scan"):
            us = sum(t_ for n_, t_ in by_name.items() if part in n_)
            say(f"[profile] {part}*: {us / 1e3:.3f} ms/step, "
                f"{us / busy * 100:.2f}% of the step's device time; {card}")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            say(f"[profile]   {us / 1e3:8.3f} ms/step  {name[:90]}")
        scan_own = sum(t_ for n_, t_ in by_name.items() if "linear_scan" in n_)
        say(f"[profile] the step in turns, device busy / scans: {route13} "
            f"route {busy / 1e3:.1f} / {scan_own / 1e3:.3f} ms, the scans "
            f"forced onto the sequential route {ab_seq[0] / 1e3:.1f} / "
            f"{ab_seq[1] / 1e3:.3f} ms, {route13} again "
            f"{ab_own[0] / 1e3:.1f} / {ab_own[1] / 1e3:.3f} ms; {card}")
    else:
        say("[profile] training: device time not measured (no device "
            "events)")
    train13 = dict(launches=r1["launches"], per_step=per_step)

    # a reduced model on the card against the port on the CPU: losses of 3
    # steps, within one bfloat16 ulp of the loss (4e-3 relative: cuBLAS and
    # the CPU's GEMMs sum in other orders)
    cfg_r = reduced(get_config("recurrentgemma-2b"))
    corpus_r = CorpusConfig(vocab_size=cfg_r.vocab_size, seq_len=64,
                            global_batch=4)
    tc_r = TrainConfig(steps=3, lr=3e-3, warmup=1, log_every=1, seed=3)
    lr_ = {}
    for key, d in (("card", "cuda"), ("cpu", "cpu")):
        linear_scan.launches = linear_scan.bwd_launches = 0
        linear_scan.chunked_launches = linear_scan.chunked_bwd_launches = 0
        t_r = Trainer(cfg_r, corpus_r, tc_r, log=lambda *a_: None, device=d)
        t_r.run()
        lr_[key] = [m["loss"] for _, m in t_r.metrics_log]
        if key == "card":
            # its scans, (4, 64, 64), take the sequential route
            scan_r = (linear_scan.launches - linear_scan.chunked_launches,
                      linear_scan.bwd_launches
                      - linear_scan.chunked_bwd_launches)
    dl = max(abs(a_ - b_) / b_ for a_, b_ in zip(lr_["card"], lr_["cpu"]))
    say(f"[train] reduced model, card vs CPU, 3 steps: losses "
        f"{lr_['card']} vs {lr_['cpu']} (max relative difference {dl:.3g}, "
        f"limit 4e-3); sequential scan launches on the card (forward, "
        f"backward) {scan_r}")
    check(len(lr_["card"]) == 3 and dl <= 4e-3,
          "reduced training: card and CPU losses differ")
    # restart-exact at reduced size on the card: a straight run of 12 steps
    # against one that crashes at step 7 (checkpoint at 5) and resumes
    ck = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    try:
        def mini(sub):
            tc = TrainConfig(steps=12, ckpt_dir=str(ck / sub), ckpt_every=5,
                             ckpt_background=False, log_every=100,
                             microbatches=2, seed=1)
            return Trainer(cfg_r, CorpusConfig(vocab_size=cfg_r.vocab_size,
                                               seq_len=16, global_batch=4,
                                               seed=1),
                           tc, log=lambda *a_: None, device="cuda")
        straight = mini("a").run()
        try:
            mini("b").run(fail_at_step=7)
            check(False, "the injected failure did not happen")
        except RuntimeError:
            pass
        resumed = mini("b").run()
        fa, fb = ckpt_flatten(straight), ckpt_flatten(resumed)
        check(fa.keys() == fb.keys() and all(np.array_equal(fa[k_], fb[k_])
                                             for k_ in fa),
              "the resumed run differs from the straight run")
        say(f"[train] restart at reduced size on the card: 12 steps straight "
            f"= crash at 7, restore step 5, continue to 12: all {len(fa)} "
            f"state arrays bit-equal")
    finally:
        shutil.rmtree(ck, ignore_errors=True)

    t_main = timings["refresh"]
    e_main = ent_t["learn-hybrid"]
    FLASH_LABEL = "encoder (64, 48, 10/1, 256) bf16"
    SCAN_LABEL = "encoder rglru (64, 48, 2560) f32"
    SCAN_TRAIN_LABEL = "training rglru (4, 512, 2560) f32"
    f_main = flash_t[FLASH_LABEL]
    s_main = scan_t[(SCAN_LABEL, "sequential")]
    c_main = scan_t[(SCAN_TRAIN_LABEL, "chunked")]
    scan_tr = train13["launches"]["linear_scan"]
    scan_ch = train13["launches"]["linear_scan_chunked"]
    # full-width training's scans, (4, 512, 2560), take the chunked route;
    # the sequential backward runs in the reduced training on the card,
    # whose scans are 64 steps long
    say(f"[scan] launches on the main paths: sequential forward "
        f"{lm_launches[1] - lm_chunked} (LM learning) + "
        f"{scan_tr[0] - scan_ch[0]} (training at full width) + {scan_r[0]} "
        f"(reduced training), chunked forward {lm_chunked} + {scan_ch[0]} + "
        f"0; sequential backward {scan_tr[1] - scan_ch[1]} + {scan_r[1]}, "
        f"chunked backward {scan_ch[1]} (full width, route {route13})")
    check(lm_launches[1] - lm_chunked > 0 and scan_ch[0] > 0
          and scan_ch[1] > 0 and scan_r[1] > 0, "a linear_scan kernel of "
          "the main paths was not launched")
    # ---- phase 14: the learner-aware stream tick --------------------------
    gc.collect()
    torch.cuda.empty_cache()
    stream_learner_phase(card)

    # ---- phase 15: the scenario front door and the live serve path ------
    gc.collect()
    torch.cuda.empty_cache()
    serve_phase(card)

    # ds_estep: the public call at the stream's refresh shape (the task
    # route's warp mode), and the task kernel at the offline EM's C4 shape
    # (block mode, the table in shared memory); entropy_scores: the narrow
    # route at the two learning shapes
    t_off = timings["offline-C4"]
    e_mnist = ent_t["learn-mnist"]
    say(json.dumps({"kernels": [{
        "name": "ds_estep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ds_estep.cu",
        "replaces": "src/repro/kernels/ds_estep.py:58",
        "launches": stream_launches,
        "max_abs_err": errs["refresh"],
        "ms": t_main["ms"], "plain_ms": t_main["plain_ms"],
        "bound_ms": t_main["bound_ms"], "bound_by": t_main["bound_by"],
        "library_ms": None}, {
        "name": "ds_estep_task", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ds_estep.cu",
        "replaces": "src/repro/kernels/ds_estep.py:58",
        "launches": em_task,
        "max_abs_err": errs["offline-C4"],
        "ms": t_off["ms"], "plain_ms": t_off["plain_ms"],
        "bound_ms": t_off["bound_ms"], "bound_by": t_off["bound_by"],
        "library_ms": None}, {
        "name": "entropy_scores", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/entropy.cu",
        "replaces": "src/repro/kernels/uncertainty.py:55",
        "launches": learn_launches["hybrid_small"],
        "max_abs_err": ent_errs["learn-hybrid"],
        "ms": e_main["ms"], "plain_ms": e_main["plain_ms"],
        "bound_ms": e_main["bound_ms"], "bound_by": e_main["bound_by"],
        "library_ms": e_main["library_ms"]}, {
        "name": "entropy_scores_narrow", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/entropy.cu",
        "replaces": "src/repro/kernels/uncertainty.py:55",
        "launches": learn_launches["mnist_like"],
        "max_abs_err": ent_errs["learn-mnist"],
        "ms": e_mnist["ms"], "plain_ms": e_mnist["plain_ms"],
        "bound_ms": e_mnist["bound_ms"], "bound_by": e_mnist["bound_by"],
        "library_ms": e_mnist["library_ms"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "launches": lm_launches[0],
        "max_abs_err": flash_errs[FLASH_LABEL],
        "ms": f_main["ms"], "plain_ms": f_main["plain_ms"],
        "bound_ms": f_main["bound_ms"], "bound_by": f_main["bound_by"],
        "library_ms": f_main["library_ms"]}, {
        "name": "linear_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan.py:44",
        "launches": lm_launches[1] - lm_chunked,
        "max_abs_err": scan_errs[SCAN_LABEL]["sequential"],
        "ms": s_main["ms"], "plain_ms": s_main["plain_ms"],
        "bound_ms": s_main["bound_ms"], "bound_by": s_main["bound_by"],
        "library_ms": None}, {
        "name": "linear_scan_chunked", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan.py:44",
        "launches": scan_ch[0],
        "max_abs_err": scan_errs[SCAN_TRAIN_LABEL]["chunked"],
        "ms": c_main["ms"], "plain_ms": c_main["plain_ms"],
        "bound_ms": c_main["bound_ms"], "bound_by": c_main["bound_by"],
        "library_ms": None}, {
        "name": "streaming_xent", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/xent.cu",
        "replaces": "src/repro/kernels/xent.py:53",
        "launches": train13["launches"]["streaming_xent"][0],
        "max_abs_err": xent_errs[XENT_MAIN][0],
        "ms": xent_t["fwd"]["ms"], "plain_ms": xent_t["fwd"]["plain_ms"],
        "bound_ms": xent_t["fwd"]["bound_ms"],
        "bound_by": xent_t["fwd"]["bound_by"],
        "library_ms": xent_t["fwd"]["library_ms"]}, {
        "name": "streaming_xent_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/xent.cu",
        "replaces": "src/repro/kernels/xent.py:53",
        "launches": train13["launches"]["streaming_xent"][1],
        "max_abs_err": xent_errs[XENT_MAIN][1],
        "ms": xent_t["bwd"]["ms"], "plain_ms": xent_t["bwd"]["plain_ms"],
        "bound_ms": xent_t["bwd"]["bound_ms"],
        "bound_by": xent_t["bwd"]["bound_by"],
        "library_ms": xent_t["bwd"]["library_ms"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "launches": train13["launches"]["flash_attention"][1],
        "max_abs_err": fb_errs[FB_MAIN],
        "ms": fb_t["ms"], "plain_ms": fb_t["plain_ms"],
        "bound_ms": fb_t["bound_ms"], "bound_by": fb_t["bound_by"],
        "library_ms": fb_t["library_ms"]}, {
        "name": "linear_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan.py:44",
        "launches": scan_r[1],
        "max_abs_err": sb_err_main["sequential"],
        "ms": sb_t["sequential"]["ms"],
        "plain_ms": sb_t["sequential"]["plain_ms"],
        "bound_ms": sb_t["sequential"]["bound_ms"],
        "bound_by": sb_t["sequential"]["bound_by"],
        "library_ms": None}, {
        "name": "linear_scan_chunked_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan.py:44",
        "launches": scan_ch[1],
        "max_abs_err": sb_err_main["chunked"],
        "ms": sb_t["chunked"]["ms"], "plain_ms": sb_t["chunked"]["plain_ms"],
        "bound_ms": sb_t["chunked"]["bound_ms"],
        "bound_by": sb_t["chunked"]["bound_by"],
        "library_ms": None}]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
