"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --launch-times SRC
    python3 chip_smoke.py --phase14

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
 14. the in-order sum kernels (``ordered_matmul``, ``segment_sum``) at the
     stream cells' shapes (the fuse (65536, 32, 8) @ (65536, 8, 2), the
     fit's logits (32768, 256, 8) @ (32768, 8, 2), its gradient's
     transposed view (32768, 8, 256) @ (32768, 256, 2), a ``_row_sum``
     level (32768, 256, 2) in 32s), bit for bit equal to their plain
     versions on the card and the CPU, timed beside them and their bounds;
     then the learner-aware stream tick at 256 replications: (a)
     ``skewed_learner_fused`` (the learner fused into the posterior,
     uncertainty-first routing) with the EM refresh for 240 ticks, (b)
     ``chance_hard`` (scored routing) with ``uncertain_learnable``
     admission (the learnability head) for 120, (c) ``stream_sharded`` (8
     shards, pressure stealing) and (d) the same at 20x its rate, where
     shards do steal, each for 120 ticks; each twice, bit for bit in every
     integer output, conservation exact, (a)'s 36 E-steps on the task route,
     (a)'s in-order sums on the kernel (an ``ordered_matmul`` a tick and
     two products and two ``_row_sum`` levels an Adam step of each fit),
     ``model_known > 0`` with the learner, as much stolen as donated, and
     the first 8 replications equal to a CPU run of the port on the same
     initial state and arrivals (else the first differing tick and state
     are named); ticks per second, and a profiled 40-tick window of (a)
     and (b) (80 before phase 21);
 15. the scenario front door and the live serve path: (a) the registry
     smoke (``repro_torch.scenarios.smoke``) on the card, every (scenario,
     engine) pair;
     (b) ``serve_tick`` driven directly for 300 ticks on
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
     second, p50 / p95 wall latency and the tick's cold / warm time;
 16. traces and traced sweeps: (a) phase 4's run with ``trace.enabled``
     through ``scenarios.run``: every output of phase 4's untraced run
     equal bit for bit, its 216 E-steps on the task route, backlog wait +
     window wait + work time = time in system, the trace artifact written,
     read back and rendered, the phase means and p95s, ticks per second,
     a profiled 80-tick window, and traced against untraced in turns;
     (b) ``run_stream_sweep`` over rates 0.5x-4x and (c)
     ``run_stream_votes_sweep`` over caps 3 / 5 / 7 / 9 with the refresh
     (its E-step 9 votes wide, held against the plain version at that
     shape and timed), each 64 replications x 240 ticks, and (d)
     ``scenarios.sweep`` over ``pool.acc_a`` and ``difficulty.p_hard`` at
     120 ticks: each sweep one batched run, every point's integer outputs
     equal to its standalone run's (floats within 1e-6 relative), the
     batched run's time against the per-value runs'; (e) ``smallR1``
     traced equal to untraced, and the batch engine's ``pool.median_mu``
     and ``pool.acc_b`` sweeps equal to their standalone runs;
 17. the LM stream at full width: (a) the embedding bank of ``lm_stream``
     through xlstm-125m at its published widths (12 layers, d_model 768,
     4 heads of 192, vocab 50304; random weights from the seed) at
     ``EmbedSpec``'s own sizes (48 tokens, 512 entries, micro-batches of
     64), built twice, bit for bit, one micro-batch against the port's
     forward on the CPU on the same parameters (the tests' jitted bound),
     s, kernels and device idle share per micro-batch; (b) ``lm_stream``
     and ``lm_chance_hard`` on that model through ``scenarios.run`` for
     240 ticks x 256 replications, each twice, bit for bit in every
     integer output, and a 4 x 120 run equal to the port on the CPU on the
     same bank, initial state and arrivals; ticks per second and kernels
     per tick; (c) live text over HTTP: 8 clients x 32 text submissions to
     ``lm_stream`` at full width, a quarter with a known label, every one
     answered; answered tasks per second, p50 / p95 wall latency and the
     ``embed_texts`` time per tick;
 18. the grid and the event-loop engine: (a) ``run_grid`` on
     ``paper_stream`` (24 cells in 2 classes, 64 replications x 240 ticks,
     each class one batched run of 12 cells x 64 replications): the first
     cell of each class and a cell below its class's largest votes cap
     equal to their standalone ``scenarios.run`` (integers equal, floats
     within 1e-6 relative); cells per second, the batched time against
     the standalone runs', kernels per tick of a class (a profiled 40-tick
     window); (b) ``run_grid`` on ``paper_fast`` (18 cells in 2 classes,
     256 replications), the first cell of each class equal to its
     standalone run; (c) ``python -m repro_torch.grid grid_smoke_stream
     --n-reps 4 --horizon 240`` in a subprocess, its artifact read back
     (6 cells, 1 class, ``compile_s`` null); (d) the scalar event loop:
     ``smallR1`` x 8 and ``throughput_v3_pm`` x 2 through ``scenarios.run(
     engine="events")`` equal to the CPU in every ``LabelResult`` field;
     the quality-maintenance run (pool 12, 3 votes, 240 tasks, threshold
     0.72) twice, bit for bit, its evictions equal to the CPU's, 10
     ``ds_estep`` launches per EM, all on the task route, one E-step at
     the sweep's shape against the plain version and timed; ``run_learning
     ("hybrid_small", engine="events")`` twice, bit for bit, one
     ``entropy_scores`` launch per batch, every selection equal to the
     plain entropy's on the same model and to a card run on the plain
     entropy; the entropy at the selection's (400, 2) timed beside its
     bound, the plain version and ``Categorical.entropy``;
 19. the rest of the LM stack (prefill and decode with their caches, the
     MoE, cross-attention and the encoder-decoder), every model with random
     weights drawn on the card from a seed: (a) recurrentgemma-2b at full
     width and depth, 4 prompts of 2560 tokens (past its 2048 window, so
     prefill fills the ring), then 16 greedy decode steps; (b)
     granite-moe-3b-a800m at full width and depth as ``lm_stream``'s
     encoder: the bank (512 x 48 tokens, micro-batches of 64) twice, bit
     for bit, and ``run_stream`` on it for 120 ticks x 64 replications;
     at full width and 2 layers the card against the CPU on the same
     parameters: the MoE's dispatch integers equal in float32, each
     bfloat16 routing flip named with its gap; (c) whisper-base at full
     width and depth: the bank through the encoder over 1500 stub frames,
     and a prefill of 4 x 64 tokens with random frames plus 8 decode
     steps; (d) mixtral-8x7b (1 layer; capacity raised to the expert count
     so that no token drops) and llama-3.2-vision-11b (5 layers, one
     cross-attending 1600 image tokens), prefill of 4 x 256 tokens plus 4
     decode steps. Every prefill + decode runs twice, bit for bit, its
     flash and scan launches as the layers give them (decode: by position,
     the RG-LRU step elementwise, cross-attention through the kernel), and
     each step's logits within the train forward's own response to a
     one-ulp move of the embeddings, a decode that does not carry its
     cache breaking that bound; then the self-attention block alone in
     float32 at full width (positions enter nowhere else), prefill +
     decode against the train block: ``pos`` exact, the output within the
     block's response to a one-ulp input move, a decode at positions off
     by one breaking that bound; top-1 agreement,
     prefill ms, decode ms a token, kernels and idle share of a decode
     step; ``flash_attention`` at the encoder's (64, 1500, 8, 64), the
     bank's cross shape (Sq 48, Sk 1500) and the VLM's (Sq 256, Sk 1600),
     and ``linear_scan`` at the prefill's (4, 2560, 2560), each held
     against its plain version (flash within 2e-2, the scan bit-equal; a
     second call bit-equal), timed beside its bound and SDPA, with the
     launches the main path made at that shape;
 20. the device-sharded labeling service (``sharding.n_devices = D``, one
     controller over D shard groups; group g on ``cuda:g`` where the
     machine has D cards, else every group on ``cuda:0``, said): (a)
     ``stream_sharded`` at 20x its rate, 64 replications x 120 ticks at
     D = 1, 2 and 4, each D bit-equal to D = 1 in every output, stolen ==
     donated > 0, ticks per second and kernels per tick (a profiled
     20-tick window) at D = 1 and 2; (b) ``skewed_adaptive5`` with the
     refresh at D = 2, bit-equal to D = 1, ``ds_estep`` launches counted
     per group (every E-step of a group's rows on the task route), the
     kernel at a group's refresh shape against its plain version and
     timed; (c) ``serve_tick`` on ``stream_sharded`` (window 8) at D = 2
     for 100 ticks with injected arrivals, tick for tick equal to D = 1;
     (d) ``simulate_learning_batch("hybrid_small")`` (64 x 10 rounds) split
     in two, bit-equal to one device, one ``entropy_scores`` launch a
     round per group, the kernel at a group's shape against its plain
     version and timed; (e) ``lm_stream`` at full width at D = 2 for 60
     ticks (the bank built once, copied to each group), bit-equal to
     D = 1;
 21. the LM stack on a 2 x 2 ``("data", "model")`` mesh
     (``make_local_mesh(2, 2, devices=...)``: the first four cards where
     the machine has four, else every slot on ``cuda:0``, said):
     granite-moe-3b-a800m at its published widths, depth cut to 4 layers,
     random float32 masters drawn on the card from a seed, laid out by the
     sharding rules (the bytes each slot holds checked against the specs'
     share); (a) 3 train steps at 4 x 256 tokens with the MoE island
     (``moe_groups`` = 4), twice, bit for bit: loss, aux, grad norm, ms per
     step, the kernels of a profiled step, ``flash_attention`` /
     ``streaming_xent`` launches and island slots per step, peak memory;
     (a') 3 steps at 2 layers in float32 against the port's CPU run of
     the same mesh, each from the card's state: every dispatch's routing
     integers equal; the loss, the grad norm and, per leaf, the step's
     move of AdamW's first moment (the clipped gradient) within the
     bounds of ``GATE``, which the planted faults (gradients zeroed,
     halved, one data group's dropped) must fall outside; (b) prefill of
     4 x 512 tokens and 8 greedy decode steps on the mesh at 4 layers,
     twice, bit for bit (b': at 2 layers in float32 against the CPU,
     routing equal, the logits within ``GATE``, and a bfloat16 run and a
     decode from a stale cache outside it); (c)
     ``Trainer`` on the mesh (the reduced model), 4 steps with a
     checkpoint at 2: a crash and restore equal to the straight run, the
     mesh checkpoint restored on one card; (c') the same ``Trainer`` with
     ``compression=True``, twice, bit for bit, every compressed gradient
     leaf (seen through a wrapping ``grad_transform``) gathered equal to
     ``compress_tree`` of the gathered gradient, each element an integer
     multiple of its leaf's scale within +-127; then the mesh step's
     ``flash_attention`` and ``streaming_xent`` kernels, forward and
     backward, at a data group's shapes against their plain versions,
     timed beside their bounds and the library calls;
 22. the dry-run: (a) ``python -m repro_torch.launch.dryrun --all --mesh
     both`` in a subprocess (host only): every cell OK or SKIP, no error,
     the skips ``cell_supported``'s, a record for each cell that ran; the
     seconds and each train cell's argument bytes a device; (b)
     ``build_cell`` for granite-moe-3b-a800m at published widths, 4
     layers, train 4 x 256 on ``make_local_mesh(2, 2, devices=["cuda:0"]
     * 4)``: a state laid out by the step's ``in_specs`` (each slot's
     parameter and moment bytes the record's ``argument_bytes`` less the
     batch's and the counters' share), one step equal bit for bit to a
     step built directly by ``make_train_step`` with ``build_cell``'s
     arguments on the same state and batch, its ``flash_attention`` and
     ``streaming_xent`` launches forward and backward counted.

It exits nonzero as soon as a phase fails, prints one ``{"kernels": ...}``
JSON line, and ends with ``{"ok": true, "device": ...}``. It imports only
torch, numpy and the port (``src/repro_torch``), and needs no network.

With ``--launch-times SRC`` it only prints the per-call times of
``ds_estep`` at the refresh shape and of ``entropy_scores`` at the learning
shapes through the package under SRC (another commit's ``src`` unpacked
beside this one, say), to compare two launch paths in turns in one run.
With ``--phase14`` it runs only the build of ``ds_estep`` and
``ordered_sum`` and phase 14; with ``--phase17`` only the registry smoke
and phase 17 (no kernel build: the LM stream launches none); with
``--phase18`` only the registry smoke, the build of ``ds_estep`` and
``entropy`` and phase 18; with ``--phase19`` only the build of
``flash_attention`` and ``linear_scan`` and phase 19; with ``--phase20``
only the build of ``ds_estep`` and ``entropy`` and phase 20; with
``--phase21`` only the build of ``flash_attention`` (both sources) and
``xent`` and phase 21; with ``--phase22`` only that build and phase 22;
with ``--mesh-gates`` only that build and phase 21's (a') and (b') for the
seeds 22, 23 and 24 (the readings of the float32 gates, sound and
planted, over seeds); with ``--lm-depth`` only the
full-width xlstm-125m forward on the card against the CPU, group by group,
in bfloat16 and float32, beside the forward's own response to a one-ulp
move of its input (how far bfloat16 rounding alone carries with depth).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
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


def ordered_sum_bound_ms(n_in, n_out, n_products):
    """Least time for an in-order float32 sum on an H100 SXM: ``n_in``
    inputs read once and ``n_out`` sums written once at the memory rate, or
    its ``n_products`` multiplies and adds at the float32 rate, whichever is
    larger."""
    nbytes = 4 * (n_in + n_out)
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2 * n_products / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def ordered_sum_kernels(card: str) -> dict:
    """The in-order sum kernels (``kernels/ordered_sum.py``) on card tensors
    at the stream cells' shapes (65536 shard rows, window 32, ring 256, F 8,
    C 2): each call bit for bit equal to its plain version on the same
    inputs on the card (the product tensor and ``segment_reduce``, the path
    before the kernel) and on the CPU over the first 2048 rows; then its
    time beside the plain version's and its bound."""
    from repro_torch.kernels.ordered_sum import ordered_matmul, segment_sum
    from repro_torch.kernels.ref import ordered_matmul_ref, segment_sum_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)

    def wide(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * torch.exp(3 * torch.randn(shape, generator=gen,
                                            device="cuda")))

    X, Xf = wide(32768, 256, 8), wide(65536, 32, 8)
    shapes = {
        # name: (the wrapper's call, its plain version, the inputs)
        "tick.fuse": (ordered_matmul, ordered_matmul_ref,
                      (Xf, wide(65536, 8, 2))),
        "fit logits": (ordered_matmul, ordered_matmul_ref,
                       (X, wide(32768, 8, 2))),
        "fit gradient": (ordered_matmul, ordered_matmul_ref,
                         (X.transpose(-1, -2), wide(32768, 256, 2))),
        "_row_sum level": (lambda g: segment_sum(g, 32),
                           lambda g: segment_sum_ref(g, 32),
                           (wide(32768, 256, 2),)),
    }
    res = {}
    for name, (call, plain, args) in shapes.items():
        tag = (f"[ordered_sum] {name} "
               + " @ ".join(str(tuple(a.shape)) for a in args))
        got, want = call(*args), plain(*args)
        cpu = plain(*(a[:2048].cpu() for a in args))
        check(got.shape == want.shape
              and torch.equal(got.view(torch.int32), want.view(torch.int32))
              and torch.equal(got[:2048].cpu().view(torch.int32),
                              cpu.view(torch.int32)),
              f"{tag}: the kernel's sums are not bit for bit the plain "
              f"version's")
        n_in = sum(a.numel() for a in args)
        n_prod = (args[0].numel() * args[1].shape[-1] if len(args) == 2
                  else args[0].numel())
        res[name] = kernel_times(
            tag, lambda: call(*args), lambda: plain(*args), None,
            ordered_sum_bound_ms(n_in, got.numel(), n_prod), card, reps=50,
            atol=0.0, rtol=0.0)
        say(f"{tag}: bit for bit the plain version's on the card and the "
            f"CPU's on the first 2048 rows")
    return res


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
    from repro_torch.kernels.ordered_sum import ordered_matmul, segment_sum
    from repro_torch.labelstream import router
    from repro_torch.labelstream.arrivals import ArrivalConfig
    from repro_torch.labelstream.routing import RoutingConfig
    from repro_torch.scenarios import get_stream_config

    kern = ordered_sum_kernels(card)
    H, N, SEED, n8 = 1440, 256, 0, 8
    refresh = {"refresh_every": 40, "refresh_iters": 6}
    runs = [
        # (a) runs a sixth of phase 4's horizon and (b)-(d) a twelfth, to
        # keep the smoke run well inside its time limit with phases 15-20
        # after them (phase 20 drives stream_sharded in device groups)
        ("a", f"skewed_learner_fused with the refresh, horizon cut to "
         f"{H // 6} ticks",
         get_stream_config("skewed_learner_fused", refresh), H // 6),
        ("b", "chance_hard with uncertain_learnable admission, horizon cut "
         f"to {H // 12} ticks",
         get_stream_config("chance_hard", {"routing": RoutingConfig(
             enabled=True, admission="uncertain_learnable")}), H // 12),
        ("c", "stream_sharded (8 shards, pressure stealing), horizon cut "
         f"to {H // 12} ticks",
         get_stream_config("stream_sharded"), H // 12),
        # the registry's stream_sharded never builds a backlog, so nothing
        # is stolen; at 20x its rate shards do steal
        ("d", "stream_sharded at 20x its rate (stealing under load), "
         f"horizon cut to {H // 12} ticks",
         get_stream_config("stream_sharded", {"arrivals": ArrivalConfig(
             kind="poisson", rate=0.8)}), H // 12),
    ]
    tick_us = {}
    for label, what, cfg, h in runs:
        tag = f"[learner-stream {label}]"
        n_refresh = h // cfg.refresh_every if cfg.refresh_every else 0
        ds_estep.launches = ds_estep.task_launches = 0
        ordered_matmul.launches = segment_sum.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = router.run_stream(cfg, h, n_reps=N, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, task = ds_estep.launches, ds_estep.task_launches
        check(launches == task == n_refresh * cfg.refresh_iters,
              f"{tag} made {launches} E-step launches ({task} on the task "
              f"route), expected {n_refresh * cfg.refresh_iters}")
        o_mm, o_ss = ordered_matmul.launches, segment_sum.launches
        say(f"{tag} ordered_sum launches: {o_mm} ordered_matmul, {o_ss} "
            f"segment_sum")
        if label == "a":
            # the fuse each tick; each Adam step of a fit (every fit_every
            # ticks from tick 0) two products and _row_sum's levels
            L = cfg.learner
            fits, n, levels = len(range(0, h, L.fit_every)), L.buffer, 1
            while n >= 32:
                n, levels = -(-n // 32), levels + 1
            want = (h + 2 * fits * L.fit_steps, levels * fits * L.fit_steps)
            check((o_mm, o_ss) == want, f"{tag} made {o_mm} ordered_matmul "
                  f"and {o_ss} segment_sum launches, expected {want}")
            for k in kern.values():
                k["launches"] = o_mm
            kern["_row_sum level"]["launches"] = o_ss
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

    # where a tick's time goes: 40 ticks of (a) and (b) under the profiler
    for label, _, cfg, _ in runs[:2]:
        Hp = 40
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
    return kern


def _outputs(out, prefix="") -> dict:
    """A run's tensors as one flat dict (nested series and per-shard
    diagnostics under dotted names)."""
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(_outputs(v, f"{prefix}{k}."))
        elif torch.is_tensor(v):
            flat[prefix + k] = v
    return flat


def _point(out, i: int):
    """Point ``i`` of a sweep's ``(V, n_reps, ...)`` outputs."""
    if isinstance(out, dict):
        return {k: _point(v, i) for k, v in out.items()}
    return out[i] if torch.is_tensor(out) else out


def hold_point(tag: str, got: dict, want: dict) -> float:
    """Point ``got`` of a batched sweep against its standalone run
    ``want``: every integer output equal (else fail), and the largest
    relative difference of the float outputs returned (0.0 when they are
    bit-equal; a batched run's reductions need not round as a narrower
    run's do on the card)."""
    g, w = _outputs(got), _outputs(want)
    check(set(w) <= set(g), f"{tag} lacks {sorted(set(w) - set(g))}")
    diff = [k for k, v in w.items() if not v.is_floating_point()
            and not torch.equal(g[k], v)]
    check(not diff, f"{tag} integer outputs differ from the standalone run: "
          f"{diff}")
    rel = 0.0
    for k, v in w.items():
        if v.is_floating_point() and not torch.equal(g[k], v):
            d = (g[k].double() - v.double()).abs()
            d = d[torch.isfinite(d)]
            scale = v.double().abs().max().item() or 1.0
            rel = max(rel, (d.max().item() if d.numel() else 0.0) / scale)
    check(rel <= 1e-6, f"{tag} float outputs differ by {rel:.3g} relative")
    return rel


def traced_sweeps_phase(card: str, phase4: dict) -> dict:
    """Phase 16: traces and traced sweeps on the card (see the module
    docstring). ``phase4`` holds phase 4's untraced run (on the host), its
    wall seconds and its kernels per tick. Returns the ``ds_estep`` numbers
    at the votes sweep's shape for the ``kernels`` line."""
    import tempfile
    from repro_torch import scenarios as scen
    from repro_torch.core import simfast
    from repro_torch.kernels.ds_estep import ds_estep, estep_route
    from repro_torch.kernels.ref import ds_estep_ref
    from repro_torch.labelstream import router
    from repro_torch.obs import export, report

    refresh = {"policy.learner.refresh_every": 40,
               "policy.learner.refresh_iters": 6}
    H, N, SEED = 1440, 256, 0

    # (a) the traced stream: phase 4's run with trace.enabled
    spec = scen.get_scenario("skewed_adaptive5",
                             {**refresh, "trace.enabled": True})
    ds_estep.launches = ds_estep.task_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = scen.run(spec, engine="stream", horizon=H, n_reps=N, seed=SEED,
                   device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, task = ds_estep.launches, ds_estep.task_launches
    cfg = res["config"]
    check(launches == task == H // 40 * 6, f"[trace a] made {launches} "
          f"E-step launches ({task} on the task route), expected "
          f"{H // 40 * 6}")
    out = res["raw"]
    flat, want = _outputs(out), phase4["out"]
    diff = [k for k in want if not torch.equal(flat[k].cpu(), want[k])]
    check(not diff, f"[trace a] the traced run differs from phase 4's "
          f"untraced run in {diff}")
    s3 = sum(float(out["ps_" + pk].sum()) for pk in
             ("backlog_wait", "window_wait", "work_time"))
    tis = float(out["sum_tis"].sum())
    check(tis > 0 and abs(s3 - tis) <= 1e-3 * tis,
          f"[trace a] backlog + window wait + work time {s3} != time in "
          f"system {tis}")
    say(f"[trace a] skewed_adaptive5 + refresh, traced: {N} reps x "
        f"{cfg.n_shards} shards x {H} ticks in {secs:.2f} s "
        f"({H / secs:.1f} ticks/s; phase 4 untraced "
        f"{H / phase4['secs']:.1f}); ds_estep launches {launches} (task "
        f"route {task}); every output of phase 4's untraced run equal bit "
        f"for bit; backlog + window wait + work time {s3:.6g} s = time in "
        f"system {tis:.6g} s; {card}")
    for pk, m in res["metrics"]["phases"].items():
        say(f"[trace a]   {pk:13s} mean {m['mean']:9.3f} s, p50 "
            f"{m['p50']:7.1f} s, p95 {m['p95']:7.1f} s"
            f"{' (saturated)' if m['hist_saturated'] else ''}")
    with tempfile.TemporaryDirectory() as tmp:
        path = export.write_trace(res["trace"], directory=tmp,
                                  name="skewed_adaptive5")
        doc = export.read_trace(path)
        check(doc["header"]["engine"] == "stream"
              and len(doc["phases"]) == 4 and len(doc["series"]) >= 10,
              "[trace a] the artifact does not read back")
        txt = report.render(doc)
        size = Path(path).stat().st_size
    check("latency sources" in txt, "[trace a] the report lacks its table")
    say(f"[trace a] artifact {size} bytes, {sum(map(len, doc.values())) - 1} "
        "lines after the header, read back and rendered:")
    for line in txt.splitlines()[:9]:
        say(f"[trace a]   {line}")
    Hp = 80
    wall, n_k, busy, _ = device_profile(
        lambda: router.run_stream(cfg, Hp, n_reps=N, seed=SEED + 1,
                                  device="cuda"))
    if n_k:
        say(f"[profile] traced stream {Hp} ticks: {n_k / Hp:.0f} kernels "
            f"per tick (phase 4 untraced: "
            f"{phase4['kpt'] if phase4['kpt'] else 'not measured'}), device "
            f"busy {busy / Hp:.0f} us per tick; device idle "
            f"{(1 - busy / Hp / (secs / H * 1e6)) * 100:.1f}% of the "
            f"unprofiled tick; {card}")
    else:
        say("[profile] traced stream: device time not measured")
    del res, out, flat
    # what observing costs, in turns in this call (untraced, traced,
    # traced, untraced): phase 4's and (a)'s ticks/s come minutes apart
    Ht, rates = 120, {"untraced": [], "traced": []}
    plain_cfg = dataclasses.replace(cfg, trace=None)
    for which in ("untraced", "traced", "traced", "untraced"):
        one = cfg if which == "traced" else plain_cfg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        router.run_stream(one, Ht, n_reps=N, seed=SEED + 2, device="cuda")
        torch.cuda.synchronize()
        rates[which].append(Ht / (time.perf_counter() - t0))
    mean = {k: sum(v) / len(v) for k, v in rates.items()}
    say(f"[trace a] in turns ({Ht} ticks x {N} reps): untraced "
        f"{', '.join(f'{r:.1f}' for r in rates['untraced'])} ticks/s, "
        f"traced {', '.join(f'{r:.1f}' for r in rates['traced'])}: the "
        f"trace costs {(1 - mean['traced'] / mean['untraced']) * 100:.1f}% "
        f"of the ticks/s; {card}")
    base4 = scen.get_scenario("skewed_adaptive5", refresh)
    cfg4 = scen.to_stream_config(base4)
    Hs, Ns = 240, 64

    # (b) the rate sweep against the four per-value runs
    scales = [0.5, 1.0, 2.0, 4.0]
    t0 = time.perf_counter()
    for sc in scales:
        router.draw_arrivals(cfg4, Hs, Ns, seed=SEED, rate_scale=sc,
                             device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sw = router.run_stream_sweep(cfg4, Hs, scales, n_reps=Ns, seed=SEED,
                                 device="cuda")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    loop_s, rel = 0.0, 0.0
    for i, sc in enumerate(scales):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = router.run_stream(cfg4, Hs, n_reps=Ns, seed=SEED,
                                rate_scale=sc, device="cuda")
        torch.cuda.synchronize()
        loop_s += time.perf_counter() - t0
        rel = max(rel, hold_point(f"[sweep b] scale {sc}", _point(sw, i),
                                  one))
    done = [int(sw["done"][i].sum()) for i in range(len(scales))]
    say(f"[sweep b] rate sweep {scales} x {Ns} reps x {Hs} ticks as one "
        f"batched run: {sweep_s:.2f} s ({Hs / sweep_s:.1f} ticks/s, "
        f"{len(scales) * Hs / sweep_s:.1f} point-ticks/s), of which the "
        f"arrivals' pre-draw ~{draw_s:.2f} s; the four per-value runs "
        f"{loop_s:.2f} s ({len(scales) * Hs / loop_s:.1f} point-ticks/s): "
        f"{loop_s / sweep_s:.2f}x; every point equals run_stream at its "
        f"scale (integers equal, floats max rel {rel:.3g}); done per point "
        f"{done}; {card}")
    del sw

    # (c) the votes sweep with the refresh: the E-step at V = 9
    caps = [3, 5, 7, 9]
    ds_estep.launches = ds_estep.task_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sw = router.run_stream_votes_sweep(cfg4, Hs, caps, n_reps=Ns, seed=SEED,
                                       device="cuda")
    torch.cuda.synchronize()
    vsweep_s = time.perf_counter() - t0
    v_launches, v_task = ds_estep.launches, ds_estep.task_launches
    want_l = Hs // 40 * 6
    check(v_launches == v_task == want_l, f"[sweep c] made {v_launches} "
          f"E-step launches ({v_task} on the task route), expected {want_l}")
    rel, loop_s = 0.0, 0.0
    for i, c in enumerate(caps):
        one_cfg = dataclasses.replace(cfg4, policy=dataclasses.replace(
            cfg4.policy, votes_cap=c))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = router.run_stream(one_cfg, Hs, n_reps=Ns, seed=SEED,
                                device="cuda")
        torch.cuda.synchronize()
        loop_s += time.perf_counter() - t0
        rel = max(rel, hold_point(f"[sweep c] cap {c}", _point(sw, i), one))
    vpt = [float(sw["votes_fin"][i].sum() / sw["done"][i].sum())
           for i in range(len(caps))]
    say(f"[sweep c] votes sweep {caps} x {Ns} reps x {Hs} ticks with the "
        f"refresh: {vsweep_s:.2f} s ({Hs / vsweep_s:.1f} ticks/s); the four "
        f"standalone runs {loop_s:.2f} s ({loop_s / vsweep_s:.2f}x); "
        f"ds_estep launches {v_launches} (task route {v_task}); every point "
        f"equals run_stream at its cap (integers equal, floats max rel "
        f"{rel:.3g}); votes per task {[round(v, 3) for v in vpt]}; {card}")
    del sw
    # the E-step at the sweep's shape: B = points x reps x shards, T = the
    # window, V = the largest cap, against its plain version
    B9, W9, C9, T9, V9 = (len(caps) * Ns * cfg4.n_shards, cfg4.pool_size + 1,
                          cfg4.n_classes, cfg4.window, max(caps))
    R9 = W9 * C9 + 1
    check(estep_route(B9, R9, C9, T9, V9) == "task",
          "[sweep c] the votes sweep's E-step is not on the task route")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    rows, idx = make_estep_inputs(gen, B9, W9, C9, T9, V9,
                                  torch.device("cuda"))
    idx[:, 0, :] = R9 - 1                       # a task with no votes
    lr, pr = ds_estep_ref(rows, idx)
    lp, pp = ds_estep(rows, idx)
    torch.cuda.synchronize()
    err = (pp - pr).abs().max().item()
    check(torch.equal(lp, lr) and err <= 1e-5
          and bool((pp[:, 0] == 1.0 / C9).all()),
          f"[sweep c] ds_estep disagrees with its plain version at B={B9} "
          f"T={T9} V={V9} (max|dpost| {err:.3g})")
    reps = 200
    ms = cuda_ms(lambda: ds_estep(rows, idx), reps)

    def many():
        for _ in range(reps):
            ds_estep(rows, idx)
    dev_us, _ = mean_us(kernel_events(many)[1], "ds_estep")
    plain = cuda_ms(lambda: ds_estep_ref(rows, idx), reps)
    bound, by, nbytes = estep_bound_ms(B9, R9, C9, T9, V9)
    say(f"[sweep c] ds_estep at the votes sweep's shape (B={B9}, T={T9}, "
        f"V={V9}, R={R9}, C={C9}), task route: logp bit-equal to the plain "
        f"version, max|dpost| {err:.3g} (tol 1e-5), a zero-vote task "
        f"exactly uniform; per call {ms * 1e3:.2f} us, device "
        f"{fmt_us(dev_us / 1e3 if dev_us else None)}, bound "
        f"{bound * 1e3:.3f} us ({by}, {nbytes} B), plain per call "
        f"{plain * 1e3:.2f} us; {card}")
    estep9 = dict(launches=v_launches, max_abs_err=err, ms=ms,
                  plain_ms=plain, bound_ms=bound, bound_by=by)

    # (d) the grid axes through the front door, at half the horizon
    Hg = Hs // 2
    for axis, values in (("pool.acc_a", [4.0, 9.0, 18.0, 40.0]),
                         ("difficulty.p_hard", [0.0, 0.25, 0.5])):
        ds_estep.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs = scen.sweep(base4, axis, values, horizon=Hg, n_reps=Ns,
                        seed=SEED, device="cuda")
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
        check(gs["vectorized"] is True, f"[grid d] {axis} ran per value")
        check(ds_estep.launches == Hg // 40 * 6, f"[grid d] {axis} made "
              f"{ds_estep.launches} E-step launches, expected "
              f"{Hg // 40 * 6}")
        rel = 0.0
        for i, v in enumerate(values):
            one = scen.run(scen.override(base4, {axis: v}), horizon=Hg,
                           n_reps=Ns, seed=SEED, device="cuda")
            rel = max(rel, hold_point(f"[grid d] {axis}={v}",
                                      _point(gs["raw"], i), one["raw"]))
        acc = [round(r["accuracy"], 4) for r in gs["results"]]
        say(f"[grid d] sweep {axis} {values} x {Ns} reps x {Hg} ticks: "
            f"{grid_s:.2f} s, one batched run; every point equals "
            f"scenarios.run at its value (integers equal, floats max rel "
            f"{rel:.3g}); accuracy {acc}; {card}")

    # (e) the batch engine: traced = untraced, and its two sweeps
    small = scen.get_scenario("smallR1")
    a = scen.run(small, n_reps=Ns, seed=SEED, device="cuda")
    t = scen.run(scen.get_scenario("smallR1", {"trace.enabled": True}),
                 n_reps=Ns, seed=SEED, device="cuda")
    diff = [k for k, v in a["raw"].items() if not torch.equal(v, t["raw"][k])]
    check(not diff, f"[batch e] traced smallR1 differs in {diff}")
    tr_keys = sorted(k for k in t["raw"] if k.startswith("trace_"))
    check(len(tr_keys) == 8 and int(t["raw"]["trace_done"].sum())
          == int(t["raw"]["done"].sum()), "[batch e] the trace counters "
          "do not add up")
    say(f"[batch e] smallR1 traced ({Ns} reps): every untraced output equal "
        f"bit for bit; {len(tr_keys)} trace counters, assigned "
        f"{int(t['raw']['trace_assigned'][:, -1].sum())}, straggler "
        f"duplicates {int(t['raw']['trace_dups'][:, -1].sum())}; the "
        f"artifact has {len(t['trace'])} lines")
    fcfg = scen.to_fast_config(small)
    for axis, values in (("pool.median_mu", [75.0, 150.0, 300.0]),
                         ("pool.acc_b", [1.0, 2.0, 4.0])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs = scen.sweep(small, axis, values, n_reps=Ns, seed=SEED,
                        device="cuda")
        torch.cuda.synchronize()
        sw_s = time.perf_counter() - t0
        check(gs["vectorized"] is True, f"[batch e] {axis} ran per value")
        rel = 0.0
        for i, v in enumerate(values):
            one = simfast.simulate(dataclasses.replace(
                fcfg, **{axis.split(".")[1]: v}), Ns, seed=SEED,
                device="cuda")
            rel = max(rel, hold_point(f"[batch e] {axis}={v}",
                                      _point(gs["raw"], i), one))
        say(f"[batch e] sweep {axis} {values} x {Ns} reps: {sw_s:.2f} s, one "
            f"batched run; every point equals simulate at its value "
            f"(integers equal, floats max rel {rel:.3g}); mean total time "
            f"{[round(r['mean_total_time'], 1) for r in gs['results']]}")
    return estep9


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

    # (b) the serve tick, driven directly (300 ticks: the smoke run stays
    # well inside its time limit with phases 16-17 after it)
    T, T_CPU, SEED = 300, 200, 0
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
    row = next(r for r in stats["timing"] if r["name"] == "serve.tick")
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


# phase 17: lm_stream's embedding at xlstm-125m's published widths, with
# EmbedSpec's own sizes (the registry's lm scenarios cut the bank to 64
# entries of 16 tokens for the CPU smoke)
LM_FULL = {"embed.reduced": False, "embed.seq_len": 48,
           "embed.bank_size": 512, "embed.batch_size": 64}


def _int_outputs(out) -> dict:
    """A run's integer tensors as one flat dict (series and per-shard
    diagnostics under dotted names)."""
    return {k: v for k, v in _outputs(out).items()
            if not v.is_floating_point()}


def lm_stream_phase(card: str):
    """Phase 17: the LM stream at full width on the card (see the module
    docstring); fails at the first check that does not hold. Returns the
    numbers PERF.md reports."""
    import asyncio

    from repro_torch.configs import get_config
    from repro_torch.device import full_fp32
    from repro_torch.embed import bank as ebank
    from repro_torch.embed import encoder as eenc
    from repro_torch.embed.corpus import make_tokens
    from repro_torch.kernels.ds_estep import ds_estep
    from repro_torch.labelstream import router
    from repro_torch.models import layers as mlayers
    from repro_torch.models import model as mmodel
    from repro_torch.models.params import count_params, tree_map
    from repro_torch.obs import timing
    from repro_torch.scenarios import get_scenario, run, to_stream_config
    from repro_torch.serving.server import LabelServer, ServeClient
    kern = {n: importlib.import_module(f"repro_torch.kernels.{m}")
            for n, m in (("entropy_scores", "uncertainty"),
                         ("flash_attention", "flash_attention"),
                         ("linear_scan", "linear_scan"),
                         ("streaming_xent", "xent"))}

    def launches():
        return {"ds_estep": ds_estep.launches,
                **{n: getattr(mod, n).launches for n, mod in kern.items()}}

    res = {}
    # ---- (a) the full-width bank ------------------------------------------
    spec = get_scenario("lm_stream", LM_FULL)
    cfg = to_stream_config(spec)
    L, C = cfg.learner, cfg.n_classes
    ec = L.embed
    mcfg = eenc.resolved_config(ec)
    check(mcfg == get_config("xlstm-125m") and not ec.reduced,
          "[lm a] lm_stream does not embed with the full-width xlstm-125m")
    n_params = count_params(mmodel.model_template(mcfg))
    before = launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = router._bank_for(cfg, "cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = ebank._bank.__wrapped__(ec, C, L.n_features, L.class_sep,
                                    L.hard_sep_scale, eenc.device_key("cuda"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_micro = ec.bank_size // ec.batch_size
    check(bank.shape == (2, C, ec.bank_size // (2 * C), L.n_features)
          and bool(torch.isfinite(bank).all()),
          f"[lm a] bank shape {tuple(bank.shape)} or values wrong")
    check(torch.equal(bank, again.feats), "[lm a] the full-width bank is "
          "not bit-repeatable on the card")
    say(f"[lm a] xlstm-125m at full width ({mcfg.n_layers} layers, d_model "
        f"{mcfg.d_model}, {mcfg.n_heads} heads of {mcfg.head_dim}, vocab "
        f"{mcfg.vocab_size}; {n_params} parameters, random from seed "
        f"{ec.seed}): bank {tuple(bank.shape)} of {ec.bank_size} x "
        f"{ec.seq_len} tokens in {first_s:.2f} s with the parameter draw, "
        f"{build_s:.3f} s again ({build_s / n_micro * 1e3:.1f} ms per "
        f"micro-batch of {ec.batch_size}); the two builds bit-equal; {card}")
    # one micro-batch against the port's forward on the CPU, same
    # parameters and projection. In float32 the two agree to rounding; in
    # bfloat16 (the bank's path) a rounding that goes the other way on one
    # side compounds through the 12 layers of random weights (measured on
    # an H100: 0.5% of the mean at 2 layers, 6% at 12, while float32
    # agrees to 3e-5; PERF.md), so the bfloat16 features are held to what
    # the forward itself does when its input moves by one bfloat16 ulp
    K = ec.bank_size // (2 * C)
    hard = np.repeat(np.arange(2), C * K).astype(bool)
    labels = np.tile(np.repeat(np.arange(C, dtype=np.int32), K), 2)
    tokens, lengths = make_tokens(ec, labels, hard, C, mcfg.vocab_size,
                                  L.class_sep, L.hard_sep_scale)
    B = ec.batch_size
    tb, lb = tokens[:B], lengths[:B]
    params = eenc.model_params(ec, "cuda")
    proj = eenc.projection(ec, L.n_features, "cuda")
    cpu_params = tree_map(lambda t: t.cpu(), params, is_leaf=torch.is_tensor)

    def rel(got, want):
        d, scale = (got.cpu() - want).abs(), float(want.abs().mean())
        return float(d.mean()) / scale, float(d.max()) / scale

    def hidden32(ps, dev):
        # the forward in float32 throughout (parameters and activations)
        ps = tree_map(lambda t: t.to(torch.float32), ps,
                      is_leaf=torch.is_tensor)
        x = ps["embed"][torch.as_tensor(tb, device=dev).long()]
        group, n_full, _ = mcfg.layer_groups()
        with full_fp32():
            for gp in mmodel._unstack(ps["groups"], n_full):
                x = group_hidden(x, gp, group, mcfg)
            return mlayers.apply_norm(ps["final_norm"], x, mcfg.norm,
                                      mcfg.norm_eps).cpu()

    t0 = time.perf_counter()
    f32 = rel(hidden32(params, "cuda"), hidden32(cpu_params, "cpu"))
    check(f32[0] <= 2e-4 and f32[1] <= 5e-3, "[lm a] the float32 forward "
          f"on the card differs from the CPU's: mean {f32[0]:.3g}, max "
          f"{f32[1]:.3g} of the mean |hidden| (bound 2e-4, 5e-3)")
    card_f = eenc.encode(ec, tb, lb, L.n_features, device="cuda")
    cpu_f = eenc.encode(ec, tb, lb, L.n_features, device="cpu",
                        params=cpu_params, proj=proj.cpu())
    sign = torch.sign(torch.randn(cpu_params["embed"].shape,
                                  generator=torch.Generator().manual_seed(1)))
    moved = dict(cpu_params, embed=cpu_params["embed"]
                 * (1 + 2.0 ** -8 * sign))
    moved_f = eenc.encode(ec, tb, lb, L.n_features, device="cpu",
                          params=moved, proj=proj.cpu())
    cpu_s = time.perf_counter() - t0
    bf, ulp = rel(card_f, cpu_f), rel(moved_f, cpu_f)
    check(bf[0] <= ulp[0] and bf[1] <= ulp[1], "[lm a] the card's bfloat16 "
          f"features differ from the CPU's (mean {bf[0]:.3g}, max "
          f"{bf[1]:.3g} of the mean |feature|) by more than a one-ulp move "
          f"of the input does on the CPU (mean {ulp[0]:.3g}, max "
          f"{ulp[1]:.3g})")
    say(f"[lm a] one micro-batch ({B} x {ec.seq_len} tokens) on the card "
        f"against the port on the CPU, same parameters: float32 forward mean "
        f"|d| {f32[0]:.3g}, max {f32[1]:.3g} of the mean |hidden| (bound "
        f"2e-4, 5e-3); bfloat16 features mean {bf[0]:.3g}, max {bf[1]:.3g} "
        f"of the mean |feature| (the tests' jitted bound 3e-2, 0.3 "
        f"{'holds' if bf[0] <= 3e-2 and bf[1] <= 0.3 else 'does not hold'}"
        f"), within the CPU's own response to a one-ulp move of the input "
        f"(mean {ulp[0]:.3g}, max {ulp[1]:.3g}); CPU {cpu_s:.1f} s")
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        eenc.encode(ec, tb, lb, L.n_features, device="cuda")
    torch.cuda.synchronize()
    mb_s = (time.perf_counter() - t0) / reps
    wall, events = kernel_events(
        lambda: eenc.encode(ec, tb, lb, L.n_features, device="cuda"),
        cpu=False)
    n_k = sum(len(v) for k, v in events.items()
              if not k.startswith(("Memcpy", "Memset")))
    busy_ms = sum(sum(v) for v in events.values()) / 1e3
    idle = (1 - busy_ms / (mb_s * 1e3)) * 100 if events else None
    say(f"[lm a] a micro-batch takes {mb_s * 1e3:.1f} ms "
        f"({B / mb_s:.0f} tasks embedded/s): "
        + (f"{n_k} kernels, device busy {busy_ms:.1f} ms, idle "
           f"{idle:.1f}% (profiler on: {wall * 1e3:.1f} ms); "
           if events else "device time not measured (no device events); ")
        + card)
    if events:
        for name, us in sorted(((k, sum(v)) for k, v in events.items()),
                               key=lambda kv: -kv[1])[:6]:
            say(f"[profile]   {us / 1e3:8.2f} ms  {name[:90]}")
    res["bank"] = dict(params=n_params, micro_ms=mb_s * 1e3, kernels=n_k,
                       busy_ms=busy_ms, idle=idle, build_s=build_s,
                       first_s=first_s, bf16=bf, ulp=ulp, f32=f32)

    # ---- (b) both LM workloads at full width ------------------------------
    H, N, SEED, H4, N4 = 240, 256, 0, 120, 4
    for name in ("lm_stream", "lm_chance_hard"):
        tag = f"[lm b {name}]"
        sp = get_scenario(name, LM_FULL)
        scfg = to_stream_config(sp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(sp, horizon=H, n_reps=N, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        t0 = time.perf_counter()
        out2 = run(sp, horizon=H, n_reps=N, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        secs2 = time.perf_counter() - t0
        a, b = _int_outputs(out["raw"]), _int_outputs(out2["raw"])
        diff = [k for k in a if not torch.equal(a[k], b[k])]
        check(not diff, f"{tag} is not repeatable on the card: {diff}")
        raw = out["raw"]
        total = lambda k: int(raw[k].sum().item())
        lhs = total("arrived")
        rhs = (total("done_all") + total("backlog_end")
               + total("in_flight_end") + total("dropped"))
        check(lhs == rhs, f"{tag} conservation fails: {lhs} != {rhs}")
        check(total("done") > 0 and total("model_known") > 0,
              f"{tag} nothing finalized or no task model-known")
        m = out["metrics"]
        for k in ("sustained_rate", "accuracy", "mean_tis", "cost"):
            check(math.isfinite(m[k]) and m[k] > 0, f"{tag} metric {k}="
                  f"{m[k]}")
        say(f"{tag} {N} reps x {scfg.n_shards} shards x {H} ticks in "
            f"{secs:.2f} s ({H / secs:.1f} ticks/s, first run with the "
            f"bank build; {H / secs2:.1f} the second); second run bit-equal "
            f"in every integer output; arrived {lhs} = done "
            f"{total('done_all')} + backlog {total('backlog_end')} + in "
            f"flight {total('in_flight_end')} + dropped {total('dropped')}; "
            f"model_known {total('model_known')}, accuracy "
            f"{m['accuracy']:.4f}, votes/task {m['votes_per_task']:.3f}; "
            f"{card}")
        # 4 x 120 against the port on the CPU, same bank, init, arrivals
        ws, banks, seeds = router.draw_init(scfg, N4, SEED + 1)
        arr = router.draw_arrivals(scfg, H4, N4, seed=SEED + 1,
                                   device="cuda")
        sbank = router._bank_for(scfg, "cuda")
        card_o = router.run_stream(
            scfg, H4, n_reps=N4, device="cuda", arrivals=arr,
            init=router.state_from_numpy(scfg, ws, banks, seeds, "cuda"))
        t1 = time.perf_counter()
        cpu_o = router.run_stream(
            scfg, H4, n_reps=N4, device="cpu",
            arrivals=(arr[0].cpu(), arr[1].cpu()), bank=sbank.cpu(),
            init=router.state_from_numpy(scfg, ws, banks, seeds, "cpu"))
        cpu_s = time.perf_counter() - t1
        a, b = _int_outputs(card_o), _int_outputs(cpu_o)
        diff = [k for k in a if not torch.equal(a[k].cpu(), b[k])]
        check(not diff, f"{tag} card and CPU integer outputs differ: {diff}")
        check(int(card_o["done_all"].sum()) > 0, f"{tag} the "
              f"{N4} x {H4} run finalized nothing")
        say(f"{tag} {N4} reps x {H4} ticks on the card equal the port on the "
            f"CPU in every integer output (same bank, init and arrivals; "
            f"CPU {cpu_s:.1f} s)")
        Hp = 40
        wall, events = kernel_events(
            lambda: router.run_stream(scfg, Hp, n_reps=N, seed=SEED + 2,
                                      device="cuda"), cpu=False)
        n_k = sum(len(v) for k, v in events.items()
                  if not k.startswith(("Memcpy", "Memset")))
        busy = sum(sum(v) for v in events.values())
        tick_us = 1e6 * secs2 / H
        idle = (1 - busy / Hp / tick_us) * 100 if n_k else None
        say(f"[profile] lm b {name}, {Hp} ticks: "
            + (f"{n_k / Hp:.0f} kernels per tick, device busy "
               f"{busy / Hp:.0f} us per tick of {tick_us:.0f} us: idle "
               f"{idle:.1f}%; " if n_k else "device time not measured; ")
            + card)
        res[name] = dict(ticks_per_s=H / secs2, kernels=n_k / Hp if n_k
                         else None, idle=idle)

    # ---- (c) live text over HTTP ------------------------------------------
    n_clients, per_client = 8, 32
    words = ("label review movie product great terrible fine awful good "
             "bad service order late fast broken works quality price "
             "refund support").split()

    async def load():
        srv = await LabelServer(spec, seed=SEED, port=0, tick_interval_s=0.0,
                                device="cuda").start()

        async def client(ci):
            rng = np.random.default_rng(100 + ci)
            c = await ServeClient(srv.host, srv.port).connect()
            got = []
            for i in range(per_client):
                text = " ".join(rng.choice(words, rng.integers(4, 30)))
                label = int(rng.integers(0, C)) if i % 4 == 0 else None
                st, r = await c.submit(wait=True, timeout_s=120.0,
                                       text=text, label=label)
                got.append((st, r, label))
            await c.aclose()
            return got

        t0 = time.perf_counter()
        got = await asyncio.gather(*[client(i) for i in range(n_clients)])
        wall = time.perf_counter() - t0
        stats = srv.stats()
        await srv.close()
        return [x for g in got for x in g], wall, stats

    timing.clear()
    got, wall, stats = asyncio.run(asyncio.wait_for(load(), 400))
    n = n_clients * per_client
    done = [(r, lab) for st, r, lab in got
            if st == 200 and r["status"] == "done"]
    check(len(done) == n and stats["answered"] == n
          and stats["conservation"], f"[lm c] {len(done)}/{n} answered, "
          f"stats {stats}")
    given = [(r["label"], lab) for r, lab in done if lab is not None]
    check(len(given) == n // 4 and all(0 <= r < C for r, _ in given),
          "[lm c] a labelled request was not answered with a label")
    agree = sum(r == lab for r, lab in given) / len(given)
    # the given label is the task's true label; the crowd (Beta(18, 2)
    # accuracies, finalized at 0.95 confidence) answers it for ~96% of
    # tasks, so three quarters is far below what a working path gives
    check(agree >= 0.75, f"[lm c] only {agree:.3f} of the labelled "
          "requests were answered with their given label")
    rows = {r["name"]: r for r in stats["timing"]}
    emb, tick = rows.get("serve.embed"), rows["serve.tick"]
    check(emb is not None and emb["calls"] > 0, "[lm c] no embed_texts call")
    embed_ms = emb["total_s"] / emb["calls"] * 1e3
    res["http"] = dict(tasks_per_s=n / wall, p50_s=stats["p50_latency_s"],
                       p95_s=stats["p95_latency_s"], ticks=stats["ticks"],
                       embed_ms=embed_ms, embed_calls=emb["calls"],
                       tick_ms=tick["total_s"] / tick["calls"] * 1e3,
                       agree=agree)
    say(f"[lm c] {n_clients} clients x {per_client} text submissions "
        f"(wait=true, {len(given)} with a known label) to lm_stream at full "
        f"width: {n} answered in {wall:.2f} s ({n / wall:.2f} answered "
        f"tasks/s), p50 {stats['p50_latency_s'] * 1e3:.1f} ms, p95 "
        f"{stats['p95_latency_s'] * 1e3:.1f} ms; {stats['ticks']} ticks, "
        f"{emb['calls']} embed_texts calls at {embed_ms:.1f} ms each (cold "
        f"{emb['cold_s'] * 1e3:.1f} ms), serve tick "
        f"{res['http']['tick_ms']:.2f} ms; answers equal to the given label "
        f"{agree:.3f}; "
        f"conservation exact; {card}")
    used = {k: launches()[k] - before[k] for k in before}
    say(f"[lm] kernel launches in phase 17 (the LM stream runs none of the "
        f"five: no refresh, C = 2, no attention, no scan, no loss): {used}")
    res["launches"] = used
    return res


def grid_events_phase(card: str) -> dict:
    """Phase 18: the grid engine and the scalar event-loop engine on the card
    (see the module docstring); fails at the first check that does not
    hold. Returns the ``ds_estep`` and ``entropy_scores`` numbers on the
    events path for the ``kernels`` line."""
    import functools
    import os
    import tempfile
    from repro_torch import grid as rgrid
    from repro_torch import scenarios as scen
    from repro_torch.core import clamshell as ccs
    from repro_torch.core import quality as cquality
    from repro_torch.core.lifeguard import LifeGuard
    from repro_torch.core.workers import Population
    from repro_torch.kernels.ds_estep import ds_estep, estep_route
    from repro_torch.kernels.ref import ds_estep_ref, entropy_ref
    from repro_torch.kernels.uncertainty import entropy_scores
    from repro_torch.labelstream import aggregate
    from repro_torch.learning import compat, linear
    from repro_torch.obs.export import read_grid

    dev = torch.device("cuda")
    asdict = dataclasses.asdict

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) paper_stream: 24 cells in 2 classes, each class one batched run
    Ha, Na = 240, 64
    g = scen.get_grid("paper_stream")
    _, cells, classes = rgrid.partition_grid(g)
    check(len(cells) == 24 and len(classes) == 2,
          f"[grid a] paper_stream partitions into {len(classes)} classes")
    res, grid_s = timed(lambda: rgrid.run_grid(
        g, n_reps=Na, horizon=Ha, keep_raw=True, device="cuda"))
    check(res["n_classes"] == 2 and all(c["batched"] and c["compile_s"] is
                                        None for c in res["classes"]),
          "[grid a] a paper_stream class did not run batched")
    cap = {f: spec.policy.redundancy.votes for f, (_, _, spec)
           in enumerate(cells)}
    top = max(cap[f] for f in classes[1].cells)
    picks = [classes[0].cells[0], classes[1].cells[0],
             next(f for f in classes[1].cells if 1 < cap[f] < top)]
    alone_s, rel = [], 0.0
    for f in picks:
        one, s = timed(lambda f=f: scen.run(cells[f][2], n_reps=Na,
                                            horizon=Ha, device="cuda"))
        alone_s.append(s)
        rel = max(rel, hold_point(f"[grid a] cell {f} {cells[f][1]}",
                                  res["cells"][f]["raw"], one["raw"]))
    per_cell = sum(alone_s) / len(alone_s)
    exe = [c["execute_s"] for c in res["classes"]]
    shards = scen.to_stream_config(g.base).n_shards
    say(f"[grid a] paper_stream: 24 cells x {Na} reps x {Ha} ticks in 2 "
        f"batched runs ({len(classes[0].cells)} + {len(classes[1].cells)} "
        f"cells x {Na} reps = {len(classes[0].cells) * Na} rows x {shards} "
        f"shards each): {grid_s:.2f} s ({24 / grid_s:.2f} cells/s), class execute "
        f"{', '.join(f'{e:.2f}' for e in exe)} s; standalone runs of cells "
        f"{picks} {', '.join(f'{s:.2f}' for s in alone_s)} s, so 24 "
        f"standalone runs ~{24 * per_cell:.1f} s ({24 * per_cell / grid_s:.2f}"
        f"x the grid); those cells equal their standalone runs (integers "
        f"equal, floats max rel {rel:.3g}; cell {picks[2]} at cap "
        f"{cap[picks[2]]} below the class's {top}); {card}")
    del res
    sub = scen.GridSpec(base=g.base, name="paper_stream_class0", axes=(
        ("policy.straggler.enabled", (False,)),) + tuple(
        (p, v) for p, v in g.axes if p != "policy.straggler.enabled"))
    Hp = 40
    wall, n_k, busy, _ = device_profile(lambda: rgrid.run_grid(
        sub, n_reps=Na, horizon=Hp, device="cuda"))
    if n_k:
        say(f"[profile] paper_stream class 0 (12 cells x {Na} reps) {Hp} "
            f"ticks: {n_k / Hp:.0f} kernels per tick, device busy "
            f"{busy / Hp:.0f} us per tick; device idle "
            f"{(1 - busy * 1e-6 / wall) * 100:.1f}% of the profiled window; "
            f"{card}")
    else:
        say("[profile] paper_stream class 0: device time not measured")

    # (b) paper_fast: 18 cells in 2 classes on the batch engine
    Nb = 256
    gf = scen.get_grid("paper_fast")
    _, fcells, fclasses = rgrid.partition_grid(gf)
    resf, fast_s = timed(lambda: rgrid.run_grid(gf, n_reps=Nb, keep_raw=True,
                                                device="cuda"))
    check(resf["n_cells"] == 18 and resf["n_classes"] == 2
          and all(c["batched"] for c in resf["classes"]),
          "[grid b] paper_fast did not run as 2 batched classes")
    rel, fast_alone = 0.0, []
    for cls in fclasses:
        f = cls.cells[0]
        one, s = timed(lambda f=f: scen.run(fcells[f][2], "simfast",
                                            n_reps=Nb, device="cuda"))
        fast_alone.append(s)
        rel = max(rel, hold_point(f"[grid b] cell {f} {fcells[f][1]}",
                                  resf["cells"][f]["raw"], one["raw"]))
    exe = ", ".join(f"{c['execute_s']:.2f}" for c in resf["classes"])
    say(f"[grid b] paper_fast: 18 cells x {Nb} reps in 2 batched runs: "
        f"{fast_s:.2f} s ({18 / fast_s:.2f} cells/s), class execute {exe} s; "
        f"the first cell of each class equals its standalone run "
        f"({', '.join(f'{s:.2f}' for s in fast_alone)} s; integers equal, "
        f"floats max rel {rel:.3g}); {card}")
    del resf

    # (c) the command line in a subprocess, read back
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "GRID_grid_smoke_stream.jsonl"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.grid", "grid_smoke_stream",
             "--n-reps", "4", "--horizon", "240", "--out", str(path)],
            env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"[grid c] the grid CLI failed: "
              f"{proc.stdout[-600:]} {proc.stderr[-1200:]}")
        doc = read_grid(str(path))
        check(len(doc["cell"]) == 6 and len(doc["class"]) == 1
              and doc["class"][0]["compile_s"] is None,
              "[grid c] the artifact does not read back as 6 cells, 1 class")
    for line in proc.stdout.strip().splitlines():
        say(f"[grid c]   {line}")
    say(f"[grid c] python -m repro_torch.grid grid_smoke_stream --n-reps 4 "
        f"--horizon 240 in a subprocess: {cli_s:.1f} s with start-up; the "
        f"artifact read back with 6 cells, 1 class, compile_s null")

    # (d) the events engine: labeling on the card equals the CPU
    for name, n in (("smallR1", 8), ("throughput_v3_pm", 2)):
        spec = scen.get_scenario(name)
        card_run, s = timed(lambda: scen.run(spec, "events", n_reps=n,
                                             device="cuda"))
        cpu_run = scen.run(spec, "events", n_reps=n, device="cpu")
        diff = [i for i, (a, b) in enumerate(zip(card_run["raw"],
                                                  cpu_run["raw"]))
                if asdict(a) != asdict(b)]
        check(not diff and len(card_run["raw"]) == n,
              f"[events d] {name}: replications {diff} differ from the CPU")
        m = card_run["metrics"]
        say(f"[events d] {name} x {n} replications ({spec.n_tasks} tasks "
            f"each): {s:.2f} s ({s / n:.3f} s a replication); every "
            f"LabelResult field equal to the CPU run; mean latency "
            f"{m['mean_latency']:.1f} s, total {m['total_time']:.1f} s, "
            f"accuracy {m['accuracy']:.3f}; {card}")

    # the quality-maintenance run: Dawid-Skene EM at every batch boundary
    truth = np.random.default_rng(0).integers(0, 2, 240)

    def quality(device):
        cs = ccs.ClamShell(ccs.CSConfig(
            pool_size=12, straggler=True, votes_needed=3,
            quality_threshold=0.72, seed=13),
            population=Population(seed=21, acc_a=4.0, acc_b=1.6),
            device=device)
        return cs, cs.run_labeling(240, true_labels=truth)

    n_em, shapes = [0], []
    real_em, real_estep = cquality.em_worker_accuracy, aggregate.ds_estep

    def count_em(*a, **kw):
        n_em[0] += 1
        return real_em(*a, **kw)

    def spy_estep(rows, idx, **kw):
        shapes.append((tuple(rows.shape), tuple(idx.shape)))
        return real_estep(rows, idx, **kw)
    cquality.em_worker_accuracy = count_em
    aggregate.ds_estep = spy_estep
    try:
        cpu_cs, cpu_r = quality("cpu")
    finally:
        aggregate.ds_estep = real_estep
    try:
        n_em[0] = 0
        ds_estep.launches = ds_estep.task_launches = 0
        (cs1, r1), q_s = timed(lambda: quality("cuda"))
        q_launches, q_task, ems = (ds_estep.launches, ds_estep.task_launches,
                                   n_em[0])
    finally:
        cquality.em_worker_accuracy = real_em
    cs2, r2 = quality("cuda")
    ev1, ev2 = cs1.maintainer.quality_evictions, \
        cs2.maintainer.quality_evictions
    evc = cpu_cs.maintainer.quality_evictions
    check(asdict(r1) == asdict(r2) and ev1 == ev2,
          "[events d] the quality run is not repeatable on the card")
    check(len(ev1) > 0 and [e[:2] for e in ev1] == [e[:2] for e in evc],
          f"[events d] the card's evictions {[e[:2] for e in ev1]} differ "
          f"from the CPU's {[e[:2] for e in evc]}")
    check(asdict(r1) == asdict(cpu_r),
          "[events d] the quality run's LabelResult differs from the CPU's")
    check(ems > 0 and q_launches == q_task == 10 * ems,
          f"[events d] {q_launches} ds_estep launches ({q_task} on the task "
          f"route) for {ems} EMs of 10 iterations")
    dacc = max(abs(a[2] - b[2]) for a, b in zip(ev1, evc))
    say(f"[events d] quality maintenance (pool 12, 3 votes, 240 tasks, "
        f"threshold 0.72): {q_s:.2f} s; {len(ev1)} evictions, (time, wid) "
        f"equal to the CPU run's (accuracies max |diff| {dacc:.3g}), a "
        f"second card run equal bit for bit; {ems} sweeps reached the EM: "
        f"ds_estep launches {q_launches}, all on the task route; "
        f"LabelResult equal to the CPU's; {card}")
    shape = max(set(shapes), key=shapes.count)
    (B, R, C), (_, T, V) = shape
    W = (R - 1) // C
    check(estep_route(B, R, C, T, V) == "task",
          "[events d] the sweep's E-step is not on the task route")
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    rows, idx = make_estep_inputs(gen, B, W, C, T, V, dev)
    idx[:, 0, :] = R - 1
    lr_, pr_ = ds_estep_ref(rows, idx)
    lp, pp = ds_estep(rows, idx)
    torch.cuda.synchronize()
    e_err = (pp - pr_).abs().max().item()
    check(torch.equal(lp, lr_) and e_err <= 1e-5
          and bool((pp[:, 0] == 1.0 / C).all()),
          f"[events d] ds_estep disagrees with its plain version at the "
          f"sweep's shape (max|dpost| {e_err:.3g})")
    reps = 200
    e_ms = cuda_ms(lambda: ds_estep(rows, idx), reps)

    def many():
        for _ in range(reps):
            ds_estep(rows, idx)
    e_dev, _ = mean_us(kernel_events(many)[1], "ds_estep")
    e_plain = cuda_ms(lambda: ds_estep_ref(rows, idx), reps)
    e_bound, e_by, e_bytes = estep_bound_ms(B, R, C, T, V)
    say(f"[events d] ds_estep at the sweep's shape (B={B}, T={T}, V={V}, "
        f"R={R}, C={C}; {shapes.count(shape)} of the CPU run's "
        f"{len(shapes)} E-steps), task route: logp bit-equal to the plain "
        f"version, max|dpost| {e_err:.3g} (tol 1e-5); per call "
        f"{e_ms * 1e3:.2f} us, device "
        f"{fmt_us(e_dev / 1e3 if e_dev else None)}, bound "
        f"{e_bound * 1e3:.3f} us ({e_by}, {e_bytes} B), plain per call "
        f"{e_plain * 1e3:.2f} us; {card}")

    # hybrid learning on the event loop: entropy selection on the card
    batches, checks = [], []
    real_submit = LifeGuard.submit_batch
    real_unc = compat.LogisticLearner.uncertainty
    real_sel = compat.LogisticLearner.select_uncertain

    def submit(self, tasks, cb):
        batches.append([t.payload for t in tasks])
        return real_submit(self, tasks, cb)

    def unc(self, X):
        u = real_unc(self, X)
        self._seen = (X, u)
        return u

    def sel(self, X_pool, candidates, k):
        # the kernel's top-k against the plain entropy's on the same model:
        # where they first differ, the plain entropies' gap between the two
        # points the orders put there
        out = real_sel(self, X_pool, candidates, k)
        if k > 0 and len(candidates):
            X, u = self._seen
            plain = entropy_ref(linear.logits(self._state(), self._x(X))
                                ).cpu().numpy()
            want = np.argsort(-plain, kind="stable")[:k]
            got = np.argsort(-u, kind="stable")[:k]
            j = np.flatnonzero(want != got)
            gap = float(abs(plain[want[j[0]]] - plain[got[j[0]]])) \
                if len(j) else None
            top = np.sort(plain)[::-1][:k + 1]
            checks.append((float(np.abs(u - plain).max()), gap,
                           float(np.diff(-top).min())))
        return out

    def learn(plain_entropy=False):
        del batches[:]
        LifeGuard.submit_batch = submit
        ccs.LogisticLearner = functools.partial(
            compat.LogisticLearner,
            use_kernel=False if plain_entropy else None)
        try:
            out, s = timed(lambda: scen.run_learning(
                "hybrid_small", engine="events", device="cuda"))
        finally:
            LifeGuard.submit_batch = real_submit
            ccs.LogisticLearner = compat.LogisticLearner
        return list(batches), out, s

    compat.LogisticLearner.uncertainty = unc
    compat.LogisticLearner.select_uncertain = sel
    try:
        entropy_scores.launches = 0
        b1, o1, l_s = learn()
        l_launches = entropy_scores.launches
        calls = list(checks)
    finally:
        compat.LogisticLearner.uncertainty = real_unc
        compat.LogisticLearner.select_uncertain = real_sel
    b2, o2, _ = learn()
    b3, o3, _ = learn(plain_entropy=True)
    check(b1 == b2 and o1["curve"] == o2["curve"]
          and asdict(o1["result"]) == asdict(o2["result"]),
          "[events d] run_learning is not repeatable on the card")
    check(l_launches == len(b1) == len(calls) and l_launches > 0,
          f"[events d] {l_launches} entropy_scores launches for {len(b1)} "
          f"batches with active points")
    # a choice may differ from the plain entropy's only on a near-tie: the
    # plain entropies of the two points within twice the kernel's error
    flips = [(i, gap) for i, (_, gap, _) in enumerate(calls)
             if gap is not None]
    diff = [i for i, (a, b) in enumerate(zip(b1, b3)) if a != b]
    u_err = max(c[0] for c in calls)
    check(u_err <= 1e-5 and all(gap <= 2 * u_err for _, gap in flips),
          f"[events d] the kernel's entropies differ from the plain "
          f"version's by {u_err:.3g} (tol 1e-5), or a choice differs by more "
          f"than a near-tie: (batch, gap) {flips[:3]}")
    if flips or diff:
        say(f"[events d] near-tie flips against the plain entropy, (batch, "
            f"the plain entropies' gap between the two points): {flips}; "
            f"the plain-entropy run first differs at batch {diff[:1]}")
    gaps = [c[2] for c in calls if c[2] > 0]
    curve = o1["curve"]
    say(f"[events d] run_learning(hybrid_small, engine='events'): "
        f"{l_s:.2f} s a run ({len(b1)} batches, {curve[-1][1]} labels, "
        f"test accuracy {curve[0][2]:.3f} -> {curve[-1][2]:.3f} at "
        f"{curve[-1][0]:.0f} simulated s); a second card run equal bit for "
        f"bit; entropy_scores launches {l_launches}, one per batch; "
        f"selections equal to the plain entropy's on the same model in "
        f"{len(calls) - len(flips)} of {len(calls)} batches (max|dH| "
        f"{u_err:.3g}, the smallest nonzero gap among the top k + 1 "
        f"{min(gaps, default=0.0):.3g}), a card run on the plain entropy "
        f"equal in {len(b1) - len(diff)} of {len(b1)} batches; {card}")
    N, Cc = 400, 2
    x = torch.randn((N, Cc), generator=gen, device=dev) * 3
    h = entropy_scores(x)
    torch.cuda.synchronize()
    h_err = (h - entropy_ref(x)).abs().max().item()
    check(h_err <= 1e-5, f"[events d] entropy_scores disagrees with its "
          f"plain version at ({N}, {Cc}): {h_err:.3g}")
    reps = 200
    h_ms = cuda_ms(lambda: entropy_scores(x), reps)

    def many_h():
        for _ in range(reps):
            entropy_scores(x)
    h_dev, _ = mean_us(kernel_events(many_h)[1], "entropy")
    h_plain = cuda_ms(lambda: entropy_ref(x), reps)
    h_lib = cuda_ms(lambda: torch.distributions.Categorical(
        logits=x, validate_args=False).entropy(), reps)
    h_bound, h_by, h_bytes = entropy_bound_ms(N, Cc, 4)
    say(f"[events d] entropy_scores at the selection's shape ({N}, {Cc}): "
        f"max|dH| {h_err:.3g} (tol 1e-5); per call {h_ms * 1e3:.2f} us, "
        f"device {fmt_us(h_dev / 1e3 if h_dev else None)}, bound "
        f"{h_bound * 1e3:.3f} us ({h_by}, {h_bytes} B), plain per call "
        f"{h_plain * 1e3:.2f} us, Categorical.entropy per call "
        f"{h_lib * 1e3:.2f} us; {card}")
    return dict(
        estep=dict(launches=q_launches, max_abs_err=max(e_err, 0.0),
                   ms=e_ms, plain_ms=e_plain, bound_ms=e_bound,
                   bound_by=e_by, library_ms=None),
        entropy=dict(launches=l_launches, max_abs_err=max(h_err, u_err),
                     ms=h_ms, plain_ms=h_plain, bound_ms=h_bound,
                     bound_by=h_by, library_ms=h_lib))

def draw_on_card(template, gen: torch.Generator):
    """float32 tensors for every leaf of ``template`` from the distributions
    of ``init_params``, drawn in flatten order on the card from ``gen``: a
    full-width model's billions of values take seconds there and tens of
    seconds on the host (the numbers differ from a CPU draw of the seed)."""
    from repro_torch.models.params import _init_leaf, tree_map
    return tree_map(lambda p: _init_leaf(p, gen), template)


def card_model(name: str, seed: int, master: bool = False, **cut):
    """A registered architecture at its published widths (``cut``: the
    fields cut to fit the phase) with random float32 weights drawn on the
    card from ``seed``, cast once to bfloat16 (the masters are dropped), or
    the float32 masters themselves with ``master``. Returns (config,
    parameters, parameter count)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import compute_params, model_template
    from repro_torch.models.params import count_params
    cfg = dataclasses.replace(get_config(name), **cut)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    template = model_template(cfg)
    ps = draw_on_card(template, gen)
    ps = ps if master else compute_params(ps)
    torch.cuda.synchronize()
    return cfg, ps, count_params(template)


@contextlib.contextmanager
def flash_by_shape(tally: dict):
    """While open, adds ``flash_attention``'s own launch count to
    ``tally[(B, Sq, Sk, Hq, Hkv, D, causal)]`` for each call the model's
    layers make, so that a time taken at one shape is paired with the
    launches made at that shape."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import layers as mlayers
    inner = mlayers.flash_attention

    def counted(q, k, v, *, causal=True, window=0):
        n = kfa.flash_attention.launches
        out = inner(q, k, v, causal=causal, window=window)
        key = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
               q.shape[3], causal)
        tally[key] = tally.get(key, 0) + kfa.flash_attention.launches - n
        return out

    mlayers.flash_attention = counted
    try:
        yield tally
    finally:
        mlayers.flash_attention = inner


def _counts():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.linear_scan import linear_scan
    return flash_attention.launches, linear_scan.launches


def _zero_counts():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.linear_scan import linear_scan
    flash_attention.launches = 0
    linear_scan.launches = linear_scan.chunked_launches = 0


def decode_check(tag: str, cfg, cp, prompts, cs, n_steps: int, card: str,
                 seed: int, tally: dict | None = None) -> dict:
    """Prefill ``prompts`` (B, S) (``cs`` the cross source or None), then
    ``n_steps`` greedy decode steps through ``make_prefill_step`` /
    ``make_decode_step`` on bfloat16 parameters, twice, bit for bit; each
    step's logits held against the train-mode forward over the same
    tokens. The bound is the forward's own response to moving every
    embedding value by one bfloat16 ulp (random direction), mean and max
    over the steps. A decode that does not carry its cache (a planted
    fault) must break the mean bound. Positions off by one stay inside it
    on recurrentgemma-2b, and the max bound is loose on mixtral-8x7b
    (3.75 of the mean |logit|): :func:`positions_gate` holds positions in
    float32. Counts the kernels' launches in prefill
    and in decode (in the first run also by shape into ``tally``); times
    prefill, decode per token, and profiles one decode step."""
    from repro_torch.models.model import forward
    from repro_torch.models.stepfn import make_decode_step, make_prefill_step
    B, S = prompts.shape
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    batch = {"tokens": prompts, "cross_src": cs}
    pos = lambda p: torch.full((B,), p, dtype=torch.int32, device="cuda")

    def run():
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = prefill(cp, batch)
        torch.cuda.synchronize()
        pre_s, pre_n = time.perf_counter() - t0, _counts()
        _zero_counts()
        outs, toks = [lg], []
        t0 = time.perf_counter()
        for i in range(n_steps):
            toks.append(outs[-1].argmax(-1))
            ld, cache = decode(cp, cache, toks[-1][:, None], pos(S + i))
            outs.append(ld)
        torch.cuda.synchronize()
        return dict(logits=torch.stack(outs, 1), toks=torch.stack(toks, 1),
                    cache=cache, pre_s=pre_s, dec_s=time.perf_counter() - t0,
                    pre_n=pre_n, dec_n=_counts())

    with (flash_by_shape(tally) if tally is not None
          else contextlib.nullcontext()):
        r1 = run()
    r2 = run()
    check(torch.equal(r1["logits"], r2["logits"])
          and torch.equal(r1["toks"], r2["toks"]),
          f"{tag} prefill + decode is not bit-repeatable on the card")
    blocks = cfg.blocks()
    n_self = sum(k in ("attn", "moe", "xattn") for k in blocks)
    n_x, n_rg = blocks.count("xattn"), blocks.count("rglru")
    want_pre = (n_self + n_x + cfg.n_encoder_layers, n_rg)
    check(r1["pre_n"] == want_pre, f"{tag} prefill launched (flash, scan) "
          f"= {r1['pre_n']}, the model's layers give {want_pre}")
    check(r1["dec_n"] == (n_x * n_steps, 0), f"{tag} decode launched "
          f"(flash, scan) = {r1['dec_n']}, want ({n_x * n_steps}, 0): "
          "self-attention by position, cross-attention by the kernel, the "
          "RG-LRU step elementwise")
    # the train-mode forward over the prompt and the greedy tokens
    seq = torch.cat([prompts, r1["toks"]], 1)
    unembed = cp.get("unembed")
    unembed = cp["embed"].T if unembed is None else unembed

    def logits_at(params):
        h = forward(params, cfg, seq, cross_src=cs, logits_mode="hidden")[0]
        return (h[:, S - 1:].to(torch.bfloat16) @ unembed).float()

    ref = logits_at(cp)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    step = (torch.randint(0, 2, cp["embed"].shape, generator=gen,
                          device="cuda", dtype=torch.int16) * 2 - 1)
    # the bit pattern moved by one: the neighbouring bfloat16 value (a zero
    # stays, where one step down would wrap to NaN)
    e = cp["embed"]
    moved = dict(cp, embed=torch.where(
        e == 0, e, (e.view(torch.int16) + step).view(torch.bfloat16)))
    del step, e
    resp = (logits_at(moved) - ref).abs()
    del moved
    err = (r1["logits"] - ref).abs()
    scale = float(ref.abs().mean())
    e_mean, e_max = float(err.mean()) / scale, float(err.max()) / scale
    b_mean, b_max = float(resp.mean()) / scale, float(resp.max()) / scale
    top1 = float((r1["logits"].argmax(-1) == ref.argmax(-1)).float().mean())
    # planted fault, on the same tokens: decode that does not carry its
    # cache (every step from prefill's)
    _, cache0 = prefill(cp, batch)
    stale = [decode(cp, cache0, r1["toks"][:, i:i + 1], pos(S + i))[0]
             for i in range(n_steps)]
    s_mean = float((torch.stack(stale, 1)[:, 1:] - ref[:, 2:]).abs().mean()
                   ) / scale
    d_mean = float(err[:, 1:].mean()) / scale
    check(e_mean <= b_mean and e_max <= b_max, f"{tag} decode's logits "
          f"differ from the forward's (mean {e_mean:.3g}, max {e_max:.3g} "
          f"of the mean |logit|) by more than a one-ulp move of the "
          f"embeddings moves the forward (mean {b_mean:.3g}, max "
          f"{b_max:.3g})")
    # positions off by one move recurrentgemma-2b's logits less than this
    # bound (8 of its 26 layers attend; measured on an H100, PERF.md):
    # positions_gate holds them in float32
    check(s_mean > b_mean, f"{tag} the planted fault (cache not carried) "
          f"stays inside the bound: mean {s_mean:.3g} <= {b_mean:.3g}")
    # one decode step profiled
    last = r1["toks"][:, -1:]
    wall, n_k, busy_us, _ = device_profile(
        lambda: decode(cp, r1["cache"], last, pos(S + n_steps)))
    tok_ms = 1e3 * r1["dec_s"] / n_steps
    idle = (1 - busy_us / 1e3 / tok_ms) * 100 if n_k else None
    say(f"{tag} B {B}, prompt {S} tokens"
        + (f", cross source {tuple(cs.shape)}" if cs is not None else "")
        + f": prefill {1e3 * r1['pre_s']:.1f} ms ({1e3 * r2['pre_s']:.1f} "
        f"again) with {r1['pre_n'][0]} flash_attention and {r1['pre_n'][1]} "
        f"linear_scan launches; {n_steps} greedy decode steps "
        f"{tok_ms:.2f} ms a token ({1e3 * r2['dec_s'] / n_steps:.2f} again), "
        f"{r1['dec_n'][0]} flash launches (cross-attention); both runs "
        f"bit-equal; against the train forward over the same {S + n_steps} "
        f"tokens: mean |d| {e_mean:.3g}, max {e_max:.3g} of the mean |logit| "
        f"(decode steps alone mean {d_mean:.3g}), within the forward's "
        f"response to a one-ulp move of the embeddings (mean {b_mean:.3g}, "
        f"max {b_max:.3g}); top-1 agreement {top1 * 100:.1f}%; planted "
        f"fault: cache not carried (steps 2-{n_steps}) mean {s_mean:.3g}; "
        f"one decode step "
        + (f"{n_k} kernels, device busy {busy_us:.0f} us of {tok_ms * 1e3:.0f}"
           f" us: idle {idle:.1f}%" if n_k else "device time not measured")
        + f"; {card}")
    return dict(prefill_ms=1e3 * r1["pre_s"], token_ms=tok_ms,
                kernels=n_k or None, idle=idle, top1=top1, err=(e_mean, e_max),
                bound=(b_mean, b_max), fault=s_mean,
                pre_n=r1["pre_n"],
                dec_n=r1["dec_n"])


def positions_gate(tag: str, cfg, S: int, n_steps: int, card: str,
                   seed: int) -> dict:
    """Positions enter the model only in self-attention (RoPE, the cache
    slot, the causal and window masks), and in bfloat16 a whole model's
    rounding can drown them (:func:`decode_check`). So this holds that
    block alone at the model's widths in float32 (products in full
    float32), on the card: random float32 weights and inputs (B 4, S + n
    positions), prefill of S and ``n_steps`` decode steps at positions S,
    S + 1, ... against the train block over all S + n positions. What is
    left between them is the cache's bfloat16 k and v (the reference's
    cache dtype). Each step's ``pos`` must be exact (slot p % C holds p),
    the attention's output (the block's output less its residual input)
    within the train block's own response to moving every input value by
    one bfloat16 ulp (random direction), mean and max; decode at
    positions off by one (a planted fault) must break the mean bound."""
    from repro_torch.device import full_fp32
    from repro_torch.models import layers as mlayers
    from repro_torch.models import model as mmodel
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    p = draw_on_card(mlayers.attn_template(cfg), gen)
    B, T = 4, S + n_steps
    x = torch.randn((B, T, cfg.d_model), generator=gen, device="cuda")
    xb = x.to(torch.bfloat16)
    step = (torch.randint(0, 2, x.shape, generator=gen, device="cuda",
                          dtype=torch.int16) * 2 - 1)
    moved = x + (torch.where(xb == 0, xb, (xb.view(torch.int16) + step)
                             .view(torch.bfloat16)).float() - xb.float())
    block = lambda x_, c, ctx: mmodel._self_attention(p, x_, c, cfg, ctx)
    at = lambda i: torch.full((B, 1), i, dtype=torch.int32, device="cuda")
    with full_fp32():
        ref = block(x, None, {"mode": "train"})[0][:, S:] - x[:, S:]
        resp = (block(moved, None, {"mode": "train"})[0][:, S:]
                - moved[:, S:] - ref).abs()
        _, cache = block(x[:, :S], None, {"mode": "prefill", "ctx_len": S})
        C = cache["pos"].shape[1]
        want = torch.full((B, C), -1, dtype=torch.int32, device="cuda")
        for q in range(max(0, S - C), S):
            want[:, q % C] = q
        pos_ok = torch.equal(cache["pos"], want)
        dec, off, c_off = [], [], cache
        for i in range(n_steps):
            xi = x[:, S + i:S + i + 1]
            y, cache = block(xi, cache, {"mode": "decode",
                                         "positions": at(S + i)})
            dec.append(y - xi)
            want[:, (S + i) % C] = S + i
            pos_ok &= torch.equal(cache["pos"], want)
            y, c_off = block(xi, c_off, {"mode": "decode",
                                         "positions": at(S + i + 1)})
            off.append(y - xi)
    err = (torch.cat(dec, 1) - ref).abs()
    fault = (torch.cat(off, 1) - ref).abs()
    scale = float(ref.abs().mean())
    e_mean, e_max = float(err.mean()) / scale, float(err.max()) / scale
    b_mean, b_max = float(resp.mean()) / scale, float(resp.max()) / scale
    f_mean = float(fault.mean()) / scale
    say(f"{tag} positions: the self-attention block alone in float32 at "
        f"full width, prefill of {S} ({C} slots) + {n_steps} decode steps "
        f"against the train block: pos {'exact' if pos_ok else 'WRONG'}; "
        f"output mean |d| {e_mean:.3g}, max {e_max:.3g} of the mean "
        f"|attention output|, within a one-ulp input move's (mean "
        f"{b_mean:.3g}, max {b_max:.3g}); planted fault (positions off by "
        f"one) mean {f_mean:.3g}; {card}")
    check(pos_ok, f"{tag} decode's cache positions are not slot p % C = p")
    check(e_mean <= b_mean and e_max <= b_max, f"{tag} the float32 decode "
          f"block differs from the train block (mean {e_mean:.3g}, max "
          f"{e_max:.3g}) by more than a one-ulp input move moves it (mean "
          f"{b_mean:.3g}, max {b_max:.3g})")
    check(f_mean > b_mean, f"{tag} the planted fault (positions off by one) "
          f"stays inside the float32 bound: mean {f_mean:.3g} <= "
          f"{b_mean:.3g}")
    return dict(err=(e_mean, e_max), bound=(b_mean, b_max), fault=f_mean)


def kernel_times(tag: str, call, plain, lib, bound, card: str, reps: int,
                 atol: float, rtol: float) -> dict:
    """A kernel's wrapper at one shape, held against the plain version on
    the same inputs: finite, of the plain version's shape, within ``atol``
    / ``rtol`` (``torch.allclose``), and a second call bit-equal; then per
    call (CUDA events) the kernel, the plain version and the library call
    (or None), beside the bound ``(ms, by, bytes)``."""
    got, want = call(), plain()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape
          and bool(torch.allclose(got.float(), want.float(), atol=atol,
                                  rtol=rtol)),
          f"{tag}: the kernel disagrees with its plain version (max |d| "
          f"{err:.3g}, atol / rtol {atol:g} / {rtol:g})")
    check(torch.equal(got, call()), f"{tag}: the kernel is not repeatable")
    ms, plain_ms = cuda_ms(call, reps), cuda_ms(plain, max(1, reps // 5))
    lib_ms = cuda_ms(lib, reps) if lib is not None else None
    b_ms, by, nbytes = bound
    say(f"[time] {tag}: per call {ms * 1e3:.2f} us ({b_ms / ms * 100:.1f}% "
        f"of its bound {b_ms * 1e3:.3f} us, {by}, {nbytes} B), plain "
        f"{plain_ms * 1e3:.2f} us, "
        + (f"library {lib_ms * 1e3:.2f} us" if lib is not None
           else "no library call") + f"; max |kernel - plain| {err:.3g} "
        f"(atol / rtol {atol:g} / {rtol:g}), a second call bit-equal; "
        + card)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=by)


def lm_stack_phase(card: str) -> dict:
    """Phase 19: the rest of the LM stack at published widths on the card
    (see the module docstring); fails at the first check that does not
    hold. Returns the numbers PERF.md reports and the kernels line's
    entries for the new shapes."""
    from repro_torch.device import full_fp32
    from repro_torch.embed import encoder as eenc
    from repro_torch.embed.corpus import make_tokens
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.linear_scan import ROUTES, linear_scan, scan_route
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.labelstream import router
    from repro_torch.learning.features import standardize
    from repro_torch.models import layers as mlayers
    from repro_torch.models import model as mmodel
    from repro_torch.models.params import tree_map
    from repro_torch.scenarios import get_scenario, to_stream_config

    res, dev = {}, torch.device("cuda")
    gen = torch.Generator(device=dev)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # ---- (a) recurrentgemma-2b: the ring and the RG-LRU step --------------
    t_a = time.perf_counter()
    cfg, cp, n = card_model("recurrentgemma-2b", 1901)
    gen.manual_seed(1902)
    prompts = torch.randint(0, cfg.vocab_size, (4, 2560), generator=gen,
                            device=dev)
    say(f"[stack a] recurrentgemma-2b at full width and depth ({n} "
        f"parameters drawn on the card in {time.perf_counter() - t_a:.1f} "
        f"s): 4 prompts of 2560 tokens, past the {cfg.window}-token window, "
        f"so prefill keeps a ring of {mmodel.cache_len(cfg, 2560)} slots")
    res["rg"] = decode_check("[stack a]", cfg, cp, prompts, None, 16, card,
                             1903)
    check(res["rg"]["pre_n"][1] > 0, "[stack a] no linear_scan launch")
    # the scan at prefill's shape: (4, 2560, 2560) float32 from h0
    a = torch.rand((4, 2560, 2560), generator=gen, device=dev) * 0.5 + 0.5
    b = torch.randn((4, 2560, 2560), generator=gen, device=dev)
    h0 = torch.randn((4, 2560), generator=gen, device=dev)
    route = scan_route(4, 2560, 2560, torch.float32)
    # bit-equal to its route's plain version, as phase 9 holds the scan
    k_scan = kernel_times(
        f"linear_scan at recurrentgemma-2b's prefill (4, 2560, 2560) f32 "
        f"with h0, {route} route", lambda: linear_scan(a, b, h0),
        lambda: ROUTES[route][0](a, b, h0), None,
        scan_bound_ms(4, 2560, 2560, 4, True), card, 20, 0.0, 0.0)
    k_scan["launches"] = res["rg"]["pre_n"][1]
    res["rg"]["positions"] = positions_gate("[stack a]", cfg, 2560, 16,
                                            card, 1904)
    del cp, prompts, a, b, h0
    free()
    say(f"[stack a] done in {time.perf_counter() - t_a:.1f} s")

    # ---- (b) granite-moe-3b-a800m as the LM stream's encoder -------------
    t_b = time.perf_counter()
    name = "granite-moe-3b-a800m"
    spec = get_scenario("lm_stream", {**LM_FULL, "embed.model": name})
    scfg = to_stream_config(spec)
    L, C = scfg.learner, scfg.n_classes
    ec, F = L.embed, L.n_features
    cfg, cp, n = card_model(name, 1911)
    check(eenc.resolved_config(ec) == cfg, f"[stack b] lm_stream's "
          f"EmbedSpec does not name the full-width {name}")
    K = ec.bank_size // (2 * C)
    hard = np.repeat(np.arange(2), C * K).astype(bool)
    labels = np.tile(np.repeat(np.arange(C, dtype=np.int32), K), 2)
    tokens, lengths = make_tokens(ec, labels, hard, C, cfg.vocab_size,
                                  L.class_sep, L.hard_sep_scale)
    proj = eenc.projection(ec, F, dev)

    def bank_of(ec_, cp_, tok, lens):
        E = eenc.encode(ec_, tok, lens, F, device=dev, params=cp_, proj=proj)
        return standardize(E).reshape(2, C, K, F)

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = bank_of(ec, cp, tokens, lengths)
    torch.cuda.synchronize()
    bank_s, bank_n = time.perf_counter() - t0, _counts()
    t0 = time.perf_counter()
    again = bank_of(ec, cp, tokens, lengths)
    torch.cuda.synchronize()
    bank2_s = time.perf_counter() - t0
    n_micro = ec.bank_size // ec.batch_size
    check(torch.equal(bank, again) and bool(torch.isfinite(bank).all()),
          "[stack b] the granite bank is not finite or not bit-repeatable")
    check(bank_n == (cfg.n_layers * n_micro, 0), f"[stack b] the bank "
          f"launched (flash, scan) = {bank_n}")
    B = ec.batch_size
    _, n_k, busy_us, _ = device_profile(lambda: eenc.encode(
        ec, tokens[:B], lengths[:B], F, device=dev, params=cp, proj=proj))
    say(f"[stack b] {name} at full width and depth ({n} parameters) as "
        f"lm_stream's encoder: bank {tuple(bank.shape)} of {ec.bank_size} x "
        f"{ec.seq_len} tokens in {bank_s:.2f} s ({bank2_s:.3f} s again: "
        f"{ec.bank_size / bank2_s:.1f} tasks embedded/s), bit-equal; "
        f"{bank_n[0]} flash launches ({bank_n[0] // n_micro} per "
        f"micro-batch of {B}); a micro-batch {n_k} kernels, device busy "
        f"{busy_us / 1e3:.1f} ms; {card}")
    Hs, Ns = 120, 64
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = router.run_stream(scfg, Hs, n_reps=Ns, seed=0, bank=bank,
                            device="cuda")
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    total = lambda k: int(out[k].sum().item())
    lhs = total("arrived")
    rhs = (total("done_all") + total("backlog_end") + total("in_flight_end")
           + total("dropped"))
    check(lhs == rhs and total("done") > 0 and total("model_known") > 0,
          f"[stack b] lm_stream on the {name} bank: conservation "
          f"{lhs} vs {rhs}, done {total('done')}, model_known "
          f"{total('model_known')}")
    m = router.stream_summary(scfg, out)
    say(f"[stack b] lm_stream on the {name} bank: {Ns} reps x "
        f"{scfg.n_shards} shards x {Hs} ticks in {stream_s:.2f} s "
        f"({Hs / stream_s:.1f} ticks/s); conservation exact; accuracy "
        f"{m['accuracy']:.4f}, model_known {total('model_known')}")
    res["granite"] = dict(tasks_per_s=ec.bank_size / bank2_s,
                          kernels=n_k, bank_flash=bank_n[0],
                          ticks_per_s=Hs / stream_s)
    del cp, bank, again, out
    free()
    # two layers at full width, card against CPU on the same parameters
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    gen.manual_seed(1912)
    master = draw_on_card(mmodel.model_template(cfg2), gen)
    cpu_master = tree_map(lambda t: t.cpu(), master, is_leaf=torch.is_tensor)
    tok16 = torch.as_tensor(tokens[:16]).long()

    def dispatch(ps, device, dtype):
        ps = tree_map(lambda t: t.to(dtype), ps, is_leaf=torch.is_tensor)
        x = ps["embed"][tok16.to(device)]
        T, outs = x.shape[0] * x.shape[1], []
        with full_fp32():
            for (p,) in mmodel._unstack(ps["groups"], 2):
                x, _ = mmodel._self_attention(p["attn"], x, None, cfg2,
                                              {"mode": "train"})
                h = mlayers.apply_norm(p["moe"]["norm"], x, cfg2.norm,
                                       cfg2.norm_eps)
                probs = torch.softmax((h.reshape(T, -1)
                                       @ p["moe"]["router"]).float(), -1)
                d = mlayers.moe_dispatch(probs, cfg2.moe_top_k,
                                         mlayers.moe_capacity(cfg2, T))
                outs.append({k: d[k].cpu() for k in ("topi", "dest", "keep")}
                            | {"probs": probs.cpu()})
                x = x + mlayers.apply_moe(p["moe"], h, cfg2)[0]
        return outs

    t0 = time.perf_counter()
    g32, c32 = dispatch(master, dev, torch.float32), \
        dispatch(cpu_master, "cpu", torch.float32)
    for li, (g, c) in enumerate(zip(g32, c32)):
        for k in ("topi", "dest", "keep"):
            check(torch.equal(g[k], c[k]), f"[stack b] float32 layer "
                  f"{li + 1}: the card's {k} differs from the CPU's")
    g16, c16 = dispatch(master, dev, torch.bfloat16), \
        dispatch(cpu_master, "cpu", torch.bfloat16)
    flips, k8 = [], cfg2.moe_top_k
    for li, (g, c) in enumerate(zip(g16, c16)):
        for t in range(g["topi"].shape[0]):
            on_card = set(g["topi"][t].tolist())
            on_cpu = set(c["topi"][t].tolist())
            if on_card == on_cpu:
                continue
            p = c["probs"][t].sort(descending=True).values
            flips.append(f"layer {li + 1} token {t}: experts "
                         f"{sorted(on_card - on_cpu)} in for "
                         f"{sorted(on_cpu - on_card)}, CPU gap at the "
                         f"{k8}th pick {float(p[k8 - 1] - p[k8]):.3g}")
    n_dest = [int((g["dest"] != c["dest"]).sum()) for g, c in zip(g16, c16)]
    per_layer = [sum(f.startswith(f"layer {li + 1} ") for f in flips)
                 for li in range(2)]
    say(f"[stack b] {name}, 2 layers at full width, 16 x {ec.seq_len} "
        f"tokens, card against CPU on the same parameters: float32 topi, "
        f"dest and keep equal in both layers; bfloat16: {len(flips)} routing "
        f"flips of {2 * len(tok16.flatten())} token routings ({per_layer} "
        f"by layer; a flip in layer 1 changes the token's output, so layer "
        f"2 inherits it), dest differs in {n_dest} slots (a flip moves the "
        f"ranks after it in its experts' runs); CPU "
        f"{time.perf_counter() - t0:.1f} s")
    for f in flips:
        say(f"[stack b]   flip: {f}")
    res["granite"]["flips"] = len(flips)
    del master, cpu_master
    free()
    say(f"[stack b] done in {time.perf_counter() - t_b:.1f} s")

    # ---- (c) whisper-base: the encoder and cross-attention ---------------
    t_c = time.perf_counter()
    name = "whisper-base"
    spec = get_scenario("lm_stream", {**LM_FULL, "embed.model": name})
    ec = to_stream_config(spec).learner.embed
    cfg, cp, n = card_model(name, 1921)
    check(eenc.resolved_config(ec) == cfg, "[stack c] wrong config")
    tokens, lengths = make_tokens(ec, labels, hard, C, cfg.vocab_size,
                                  L.class_sep, L.hard_sep_scale)
    proj = eenc.projection(ec, F, dev)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with flash_by_shape({}) as w_tally:
        bank = bank_of(ec, cp, tokens, lengths)
    torch.cuda.synchronize()
    bank_s, bank_n = time.perf_counter() - t0, _counts()
    again = bank_of(ec, cp, tokens, lengths)
    check(torch.equal(bank, again) and bool(torch.isfinite(bank).all()),
          "[stack c] the whisper bank is not finite or not bit-repeatable")
    per = cfg.n_encoder_layers + 2 * cfg.n_layers
    check(bank_n == (per * n_micro, 0), f"[stack c] the bank launched "
          f"(flash, scan) = {bank_n}, want ({per * n_micro}, 0)")
    say(f"[stack c] {name} at full width and depth ({n} parameters): bank "
        f"of {ec.bank_size} x {ec.seq_len} tokens through the encoder over "
        f"{cfg.encoder_seq} zero stub frames in {bank_s:.2f} s "
        f"({ec.bank_size / bank_s:.1f} tasks/s), bit-equal; {bank_n[0]} "
        f"flash launches ({per} per micro-batch: {cfg.n_encoder_layers} "
        f"non-causal encoder, {cfg.n_layers} causal self, {cfg.n_layers} "
        f"cross with Sq {ec.seq_len} != Sk {cfg.encoder_seq}); by shape "
        f"(B, Sq, Sk, Hq, Hkv, D, causal): {w_tally}; {card}")
    gen.manual_seed(1922)
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                            device=dev)
    frames = torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    res["whisper"] = decode_check("[stack c]", cfg, cp, prompts, frames, 8,
                                  card, 1923)
    res["whisper"]["positions"] = positions_gate("[stack c]", cfg, 64, 8,
                                                 card, 1924)
    res["whisper"]["bank_flash"] = bank_n[0]
    res["whisper"]["tally"] = w_tally
    res["whisper"]["tasks_per_s"] = ec.bank_size / bank_s
    del cp, bank, again
    free()
    say(f"[stack c] done in {time.perf_counter() - t_c:.1f} s")

    # ---- (d) mixtral-8x7b and llama-3.2-vision-11b, one group deep --------
    t_d = time.perf_counter()
    for key, name, cut, seed in (
            ("mixtral", "mixtral-8x7b", dict(n_layers=1,
                                             capacity_factor=8.0), 1931),
            ("vision", "llama-3.2-vision-11b", dict(n_layers=5), 1941)):
        cfg, cp, n = card_model(name, seed, **cut)
        gen.manual_seed(seed + 1)
        prompts = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen,
                                device=dev)
        cs = (torch.randn((4, cfg.n_img_tokens, cfg.d_model), generator=gen,
                          device=dev).to(torch.bfloat16)
              if cfg.n_img_tokens else None)
        say(f"[stack d] {name} at full width, {cfg.n_layers} layer(s) "
            f"({cfg.blocks()}; {n} parameters)"
            + (", capacity factor raised to the expert count so that no "
               "token is dropped, as tests/test_models.py does"
               if cfg.n_experts else ""))
        tally = {}
        res[key] = decode_check(f"[stack d {key}]", cfg, cp, prompts, cs, 4,
                                card, seed + 2, tally)
        res[key]["tally"] = tally
        res[key]["positions"] = positions_gate(f"[stack d {key}]", cfg, 256,
                                               4, card, seed + 3)
        del cp, cs
        free()
    say(f"[stack d] done in {time.perf_counter() - t_d:.1f} s")

    # ---- the kernel at the new shapes --------------------------------------
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tsp = lambda x: x.transpose(1, 2)
    kern = {"linear_scan_prefill": k_scan}
    # each shape's launches as the wrapper counted them in the run that made
    # them: whisper's first bank (its encoder, and its cross-attention over
    # the 1500 frames) and the VLM's first prefill (its one cross layer)
    for key, (Bq, Hq, Hkv, Sq, Sk, D), tally in (
            ("flash_attention_encoder", (64, 8, 8, 1500, 1500, 64), w_tally),
            ("flash_attention_cross_bank", (64, 8, 8, 48, 1500, 64),
             w_tally),
            ("flash_attention_cross", (4, 32, 8, 256, 1600, 128),
             res["vision"]["tally"])):
        launches = tally.get((Bq, Sq, Sk, Hq, Hkv, D, False), 0)
        check(launches > 0, f"[stack] {key}: the main path made no launch "
              f"at (B {Bq}, Sq {Sq}, Sk {Sk}, {Hq}/{Hkv}, D {D}); by shape "
              f"{tally}")
        q = torch.randn((Bq, Sq, Hq, D), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((Bq, Sk, Hkv, D), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        # bfloat16 at phase 9's flash tolerance
        kern[key] = kernel_times(
            f"flash_attention {key[16:]} ({Bq}, Sq {Sq}, Sk {Sk}, {Hq}/{Hkv} "
            f"heads, D {D}) bf16 non-causal, {launches} launches at this "
            f"shape", lambda: flash_attention(q, k, v, causal=False),
            lambda: tsp(attention_ref(tsp(q), tsp(k), tsp(v), causal=False)),
            lambda: sdpa(tsp(q), tsp(k), tsp(v), enable_gqa=True),
            flash_bound_ms(Bq, Hq, Hkv, Sq, Sk, D, 2, False, 0), card, 20,
            2e-2, 2e-2)
        kern[key]["launches"] = launches
        del q, k, v
        free()
    res["kernels"] = kern
    return res


def group_hidden(x, gp, group, mcfg):
    """One stacked group of the model's train-mode forward on x."""
    from repro_torch.models import model as mmodel
    one = mmodel._Groups(None, x.shape[0], x.dtype, x.device)
    return mmodel._run_group([x], x.new_zeros(()), gp, None, group, mcfg,
                             [{"mode": "train", "mlstm_impl": "chunked"}],
                             one, False, None)[0][0]


def sharded_phase(card: str) -> dict:
    """Phase 20: the device-sharded labeling service (see the module
    docstring). A run of D shard groups puts group g on ``cuda:g`` where
    the machine has D cards, else every group on ``cuda:0`` (said).
    Returns the ``ds_estep`` and ``entropy_scores`` entries of the kernels
    line at the groups' shapes."""
    from repro_torch.core import simfast
    from repro_torch.kernels.ds_estep import ds_estep, estep_route
    from repro_torch.kernels.ref import ds_estep_ref, entropy_ref
    from repro_torch.kernels.uncertainty import entropy_scores
    from repro_torch.labelstream import aggregate, router
    from repro_torch.labelstream.arrivals import ArrivalConfig
    from repro_torch.learning import linear
    from repro_torch.scenarios import (
        get_fast_config, get_scenario, get_stream_config, spec_dataset,
        to_serve_config, to_stream_config,
    )

    N, SEED = 64, 0
    dev = torch.device("cuda")
    n_cards = torch.cuda.device_count()

    def devices(D):
        return ([f"cuda:{i}" for i in range(D)] if n_cards >= D
                else ["cuda:0"] * D)

    for D in (2, 4):
        if n_cards < D:
            say(f"[sharded] {n_cards} card(s) visible: the {D} groups of a "
                f"D = {D} run all go on cuda:0 (devices=['cuda:0'] * {D}); "
                "copies between cards are not exercised")

    def sharded(cfg, D):
        return dataclasses.replace(cfg, sharding=dataclasses.replace(
            cfg.sharding, n_devices=D))

    def same(tag, got, want):
        g, w = _outputs(got), _outputs(want)
        check(g.keys() == w.keys(), f"{tag} outputs differ in keys")
        diff = [k for k in w if not torch.equal(g[k], w[k])]
        check(not diff, f"{tag} differs from the one-group run in {diff}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # ---- (a) stream_sharded at 20x its rate: D = 1, 2, 4 ----------------
    H = 120
    cfg = get_stream_config("stream_sharded", {"arrivals": ArrivalConfig(
        kind="poisson", rate=0.8)})
    router.run_stream(sharded(cfg, 2), 4, n_reps=N, seed=SEED,
                      device="cuda", devices=devices(2))      # warm-up
    runs = {}
    for D in (1, 2, 4):
        runs[D] = timed(lambda: router.run_stream(
            sharded(cfg, D), H, n_reps=N, seed=SEED, device="cuda",
            devices=devices(D) if D > 1 else None))
    for D in (1, 2, 4):
        out, secs = runs[D]
        if D > 1:
            same(f"[sharded a] D = {D}", out, runs[1][0])
        st, do = int(out["stolen"].sum()), int(out["donated"].sum())
        check(st == do and st > 0,
              f"[sharded a] D = {D}: stolen {st}, donated {do}")
        say(f"[sharded a] stream_sharded at 20x its rate, {N} reps x "
            f"{cfg.n_shards} shards x {H} ticks, D = {D} group(s) of "
            f"{cfg.n_shards // D} shards on {devices(D) if D > 1 else 'cuda'}"
            f": {secs:.2f} s ({H / secs:.1f} ticks/s); stolen {st} == "
            f"donated {do}" + ("; every output equal to D = 1 bit for bit"
                               if D > 1 else "") + f"; {card}")
    kpt = {}
    for D in (1, 2):
        Hp = 20
        wall, n_k, busy, _ = device_profile(lambda: router.run_stream(
            sharded(cfg, D), Hp, n_reps=N, seed=SEED + 1, device="cuda",
            devices=devices(D) if D > 1 else None))
        kpt[D] = n_k / Hp if n_k else None
        say(f"[profile] sharded a, D = {D}, {Hp} ticks: "
            + (f"{n_k / Hp:.0f} kernels per tick, device busy "
               f"{busy / Hp:.0f} us per tick, wall {wall / Hp * 1e6:.0f} us "
               "per tick with the profiler on" if n_k else
               "device time not measured (no device events)") + f"; {card}")
    say(f"[sharded a] D = 1 vs D = 2: {H / runs[1][1]:.1f} vs "
        f"{H / runs[2][1]:.1f} ticks/s, "
        + (f"{kpt[1]:.0f} vs {kpt[2]:.0f} kernels per tick"
           if kpt[1] and kpt[2] else "kernels per tick not measured"))

    # ---- (b) skewed_adaptive5 with the refresh at D = 2 -----------------
    refresh = {"refresh_every": 40, "refresh_iters": 6}
    cfg = get_stream_config("skewed_adaptive5", refresh)
    D, Sl = 2, cfg.n_shards // 2
    n_est = H // cfg.refresh_every * cfg.refresh_iters
    one = router.run_stream(cfg, H, n_reps=N, seed=SEED, device="cuda")
    calls = []
    real_estep = aggregate.ds_estep

    def spy_estep(rows, idx, **kw):
        calls.append((str(idx.device), idx.shape[0]))
        return real_estep(rows, idx, **kw)

    aggregate.ds_estep = spy_estep
    try:
        ds_estep.launches = ds_estep.task_launches = 0
        got, secs = timed(lambda: router.run_stream(
            sharded(cfg, D), H, n_reps=N, seed=SEED, device="cuda",
            devices=devices(D)))
        e_launches, e_task = ds_estep.launches, ds_estep.task_launches
    finally:
        aggregate.ds_estep = real_estep
    same("[sharded b]", got, one)
    # a refresh tick runs group 0's whole EM, then group 1's
    group_of = [i // cfg.refresh_iters % D for i in range(len(calls))]
    per_group = [group_of.count(g) for g in range(D)]
    check(e_launches == e_task == len(calls) == D * n_est
          and per_group == [n_est] * D
          and all(b == N * Sl for _, b in calls),
          f"[sharded b] {e_launches} ds_estep launches ({e_task} on the task "
          f"route, per group {per_group}), expected {n_est} per group of "
          f"{N * Sl} rows")
    say(f"[sharded b] skewed_adaptive5 with the refresh, {N} reps x "
        f"{cfg.n_shards} shards x {H} ticks at D = {D}: {secs:.2f} s, every "
        f"output equal to D = 1 bit for bit; ds_estep launches {e_launches} "
        f"(task route {e_task}), per group {per_group} on "
        f"{sorted(set(d for d, _ in calls))}, {N * Sl} rows each; {card}")
    P, C = cfg.pool_size, cfg.n_classes
    B, W, T, V = N * Sl, P + 1, cfg.window, cfg.policy.votes_cap
    R = W * C + 1
    check(estep_route(B, R, C, T, V) == "task",
          "[sharded b] the group's E-step is not on the task route")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    rows, idx = make_estep_inputs(gen, B, W, C, T, V, dev)
    lr_, pr_ = ds_estep_ref(rows, idx)
    lp, pp = ds_estep(rows, idx)
    lp2, pp2 = ds_estep(rows, idx)
    torch.cuda.synchronize()
    e_err = (pp - pr_).abs().max().item()
    check(torch.equal(lp, lr_) and e_err <= 1e-5 and torch.equal(lp, lp2)
          and torch.equal(pp, pp2),
          f"[sharded b] ds_estep disagrees with its plain version at the "
          f"group's shape (max|dpost| {e_err:.3g})")
    reps = 200
    e_ms = cuda_ms(lambda: ds_estep(rows, idx), reps)
    e_plain = cuda_ms(lambda: ds_estep_ref(rows, idx), reps)
    e_bound, e_by, e_bytes = estep_bound_ms(B, R, C, T, V)
    say(f"[sharded b] ds_estep at a group's refresh shape (B={B}, T={T}, "
        f"V={V}, R={R}, C={C}), task route: logp bit-equal to the plain "
        f"version, max|dpost| {e_err:.3g} (tol 1e-5), a second call equal; "
        f"per call {e_ms * 1e3:.2f} us, bound {e_bound * 1e3:.3f} us "
        f"({e_by}, {e_bytes} B), plain per call {e_plain * 1e3:.2f} us; "
        f"{card}")

    # ---- (c) the serve tick at D = 2 ------------------------------------
    Hs = 100
    base = get_scenario("stream_sharded", {"window": 8})
    cfg1 = to_serve_config(base)
    cfg2 = to_serve_config(get_scenario("stream_sharded", {
        "window": 8, "sharding.n_devices": 2}))
    (o1, sched, _), s1 = timed(lambda: drive_serve(
        router, cfg1, router.serve_init(cfg1, 7, device="cuda"), Hs, 20))
    st2 = router.serve_init(cfg2, 7, device="cuda", devices=devices(2))
    check(len(st2["groups"]) == 2, "[sharded c] the serve state does not "
          "hold two groups")
    (o2, _, _), s2 = timed(lambda: drive_serve(router, cfg2, st2, Hs, 20,
                                               sched))
    for i, (a, b) in enumerate(zip(o2, o1)):
        diff = [k for k in SERVE_INTS + ("conf", "tis")
                if not np.array_equal(a[k], b[k])]
        check(not diff, f"[sharded c] tick {i} differs from D = 1 in {diff}")
    total = lambda k: sum(int(o[k].sum()) for o in o2)
    check(total("fin") > 0 and total("stolen") == total("donated") > 0,
          f"[sharded c] fin {total('fin')}, stolen {total('stolen')}, "
          f"donated {total('donated')}")
    say(f"[sharded c] serve_tick on stream_sharded (window 8), {Hs} ticks "
        f"with injected arrivals: D = 2 equal to D = 1 tick for tick in "
        f"every output; {Hs / s1:.1f} vs {Hs / s2:.1f} ticks/s (D = 1 vs "
        f"2); finalized {total('fin')}, stolen {total('stolen')}; {card}")

    # ---- (d) the learning batch split in two ----------------------------
    fcfg = get_fast_config("hybrid_small")
    X, y, Xt, yt = spec_dataset("hybrid_small")
    rounds = 10
    kw = dict(rounds=rounds, n_reps=N, seed=SEED, device="cuda")
    one, l1 = timed(lambda: simfast.simulate_learning_batch(
        fcfg, X, y, Xt, yt, shard=False, **kw))
    shapes = []
    real_ent = linear.entropy_from_logits

    def spy_ent(lg, **k):
        shapes.append((str(lg.device), tuple(lg.shape)))
        return real_ent(lg, **k)

    linear.entropy_from_logits = spy_ent
    try:
        entropy_scores.launches = 0
        got, l2 = timed(lambda: simfast.simulate_learning_batch(
            fcfg, X, y, Xt, yt, devices=devices(2), **kw))
        h_launches = entropy_scores.launches
    finally:
        linear.entropy_from_logits = real_ent
    same("[sharded d]", got, one)
    check(h_launches == len(shapes) == 2 * rounds
          and all(s[0] == N // 2 for _, s in shapes),
          f"[sharded d] {h_launches} entropy_scores launches at {shapes[:2]}"
          f", expected {2 * rounds} of {N // 2} replications")
    say(f"[sharded d] simulate_learning_batch(hybrid_small), {N} reps x "
        f"{rounds} rounds split in two: every output equal to the "
        f"one-device run; entropy_scores launches {h_launches} (one a round "
        f"on each of {sorted(set(d for d, _ in shapes))}); "
        f"{N / l1:.2f} vs {N / l2:.2f} replications/s (one device vs the "
        f"split); {card}")
    Rg, n, Cc = shapes[0][1]
    x = (torch.randn((Rg * n, Cc), generator=gen, device=dev) * 3.0)
    h = entropy_scores(x)
    h2 = entropy_scores(x)
    h_err = (h - entropy_ref(x)).abs().max().item()
    check(h_err <= 1e-5 and torch.equal(h, h2),
          f"[sharded d] entropy_scores disagrees with its plain version at "
          f"the group's shape (max|d| {h_err:.3g})")
    h_ms = cuda_ms(lambda: entropy_scores(x), reps)
    h_plain = cuda_ms(lambda: entropy_ref(x), reps)
    h_lib = cuda_ms(lambda: torch.distributions.Categorical(
        logits=x, validate_args=False).entropy(), reps)
    h_bound, h_by, h_bytes = entropy_bound_ms(Rg * n, Cc, 4)
    say(f"[sharded d] entropy_scores at a group's shape ({Rg * n}, {Cc}): "
        f"max|d| {h_err:.3g} (tol 1e-5), a second call equal; per call "
        f"{h_ms * 1e3:.2f} us, bound {h_bound * 1e3:.3f} us ({h_by}, "
        f"{h_bytes} B), plain per call {h_plain * 1e3:.2f} us, "
        f"Categorical.entropy per call {h_lib * 1e3:.2f} us; {card}")

    # ---- (e) lm_stream at D = 2 -----------------------------------------
    He = 60
    cfg = to_stream_config(get_scenario("lm_stream", LM_FULL))
    bank, b_s = timed(lambda: router._bank_for(cfg, "cuda"))
    one, e1 = timed(lambda: router.run_stream(cfg, He, n_reps=N, seed=SEED,
                                              device="cuda", bank=bank))
    got, e2 = timed(lambda: router.run_stream(
        sharded(cfg, 2), He, n_reps=N, seed=SEED, device="cuda", bank=bank,
        devices=devices(2)))
    same("[sharded e]", got, one)
    check(int(one["done_all"].sum()) > 0, "[sharded e] nothing finalized")
    say(f"[sharded e] lm_stream at full width (bank {tuple(bank.shape)} "
        f"built once in {b_s:.2f} s, copied to each group), {N} reps x "
        f"{He} ticks: D = 2 equal to D = 1 in every output; {He / e1:.1f} vs "
        f"{He / e2:.1f} ticks/s; {card}")
    return dict(
        estep=dict(launches=e_launches, max_abs_err=max(e_err, 0.0),
                   ms=e_ms, plain_ms=e_plain, bound_ms=e_bound,
                   bound_by=e_by, library_ms=None),
        entropy=dict(launches=h_launches, max_abs_err=h_err, ms=h_ms,
                     plain_ms=h_plain, bound_ms=h_bound, bound_by=h_by,
                     library_ms=h_lib))


@contextlib.contextmanager
def moe_routes(rec: list):
    """While open, appends every ``moe_dispatch`` result of the port's
    layers (``topi`` as sets, sorted per token: the order of a token's
    picks changes nothing downstream; ``dest``, ``keep``, and the gap
    between each token's k-th and (k+1)-th router probability, on the
    CPU) to ``rec``."""
    from repro_torch.models import layers as mlayers
    inner = mlayers.moe_dispatch

    def recorded(probs, k, C):
        r = inner(probs, k, C)
        top = torch.topk(probs.detach(), min(k + 1, probs.shape[-1])).values
        rec.append({"topi": torch.sort(r["topi"], -1).values.cpu(),
                    "dest": r["dest"].cpu(), "keep": r["keep"].cpu(),
                    "gap": (top[:, k - 1] - top[:, -1]).cpu()})
        return r

    mlayers.moe_dispatch = recorded
    try:
        yield rec
    finally:
        mlayers.moe_dispatch = inner


# Phase 21's float32 gates, card against the CPU. (a'): the train step's
# loss (relative), its grad norm (relative) and, per parameter leaf, the
# step's move of AdamW's first moment, mu - b1 mu_before = (1 - b1) times
# the clipped gradient (relative norm of the difference, and 1 - cosine).
# (b'): prefill and decode logits, the relative norm of the difference of
# each of the 9 sets of (B, V) logits.
GATE = {"loss": 1e-4, "grad_norm": 1e-4, "mu_rel": 2e-3, "mu_cos": 1e-6,
        "logits": 2e-3}


class _PlantedAdamW:
    """AdamW whose gradients are scaled by ``factor`` before its step (a
    planted fault: 0 zeroes them, 0.5 halves them)."""

    def __init__(self, factor):
        from repro_torch.training.optimizer import AdamW
        self.inner, self.factor = AdamW(), factor

    def update_(self, grads, state, params):
        from repro_torch.models.params import leaves
        for leaf in leaves(grads, torch.is_tensor):
            for t in leaf.flat():
                t.mul_(self.factor)
        return self.inner.update_(grads, state, params)


@contextlib.contextmanager
def drop_data_group():
    """While open, every gathered weight's backward drops the gradients of
    the copies past the first half of its targets: data group 1's
    contribution to every weight gradient (a planted fault of the reduce
    over ``data``)."""
    from repro_torch.distributed import sharding as tsh
    cls = tsh._GatherCopies
    inner = cls.__dict__["backward"]

    def backward(ctx, *grads):
        keep = max(1, len(grads) // 2)
        return inner.__func__(ctx, *(g if k < keep else None
                                     for k, g in enumerate(grads)))

    cls.backward = staticmethod(backward)
    try:
        yield
    finally:
        cls.backward = inner


def mesh_gates(card: str, mesh, cpu_mesh, seed: int, B=4, S=256, P=512,
               steps=3) -> dict:
    """Phase 21 (a') and (b'): granite-moe-3b-a800m at 2 layers in float32
    on ``mesh`` (the card) against ``cpu_mesh``, weights and tokens from
    ``seed``. (a') ``steps`` train steps, each starting the CPU from the
    card's state; after step 1 the planted faults (gradients zeroed,
    halved, data group 1's dropped) step the card from the same state.
    (b') prefill B x P and 8 greedy decode steps, the CPU fed the card's
    tokens; the planted faults run the card in bfloat16, and decode from
    the prefill's cache at every step. Routing (``topi``, ``dest``,
    ``keep`` per slot) must be equal, every reading within :data:`GATE`
    and every planted fault's reading outside it. Returns the readings."""
    from repro_torch.distributed import sharding as tsh
    from repro_torch.models import stepfn
    from repro_torch.models.model import model_template
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.training.optimizer import AdamW
    f32, GRANITE = torch.float32, "granite-moe-3b-a800m"
    t_a = time.perf_counter()
    cfg, ps, _ = card_model(GRANITE, seed, master=True, n_layers=2)
    sp = tsh.put(ps, tsh.param_pspecs(model_template(cfg), mesh), mesh)
    del ps
    opt = AdamW()
    st_c = {"params": sp, "opt_state": opt.init(sp),
            "step": torch.zeros((), dtype=torch.int32, device=mesh.lead)}
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    targets = toks[:, 1:].copy()
    targets[0, :40] = -1                   # data group 0 counts fewer
    batch = {"tokens": torch.from_numpy(toks[:, :S]).cuda(),
             "targets": torch.from_numpy(targets).cuda()}
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    is_sh = lambda x: isinstance(x, tsh.Sharded)

    def copied(tree, m2, dev):
        # the same layout on mesh m2, each piece copied (onto ``dev``)
        cp = lambda t: t.clone() if dev is None else t.to(dev, copy=True)
        return tree_map(lambda x: tsh.Sharded(
            m2, x.spec, x.shape, [[cp(p) for p in row]
                                  for row in x.pieces]), tree, is_sh)

    def state_on(st, m2, dev=None):
        o, cp = st["opt_state"], lambda t: t.to(dev or t.device, copy=True)
        return {"params": copied(st["params"], m2, dev),
                "opt_state": {"mu": copied(o["mu"], m2, dev),
                              "nu": copied(o["nu"], m2, dev),
                              "count": cp(o["count"])},
                "step": cp(st["step"])}

    # remat off (it changes no number): the CPU skips the recompute
    mk = lambda o, m2: stepfn.make_train_step(
        cfg, o, remat=False, mesh=m2, moe_groups=m2.size, compute_dtype=f32)
    step_c, step_h = mk(opt, mesh), mk(AdamW(), cpu_mesh)
    faults = {"zeroed": mk(_PlantedAdamW(0.0), mesh),
              "halved": mk(_PlantedAdamW(0.5), mesh),
              "group 1 dropped": mk(AdamW(), mesh)}
    b1, lr = opt.b1, opt.lr

    def moved(mu, mu0):
        # per leaf, the step's move of mu, whole on the card, float64
        return [a.double() - b1 * b for a, b in zip(
            leaves(tsh.gather(mu, mesh.lead), torch.is_tensor), mu0)]

    def readings(mc, mu_c, mh, mu_h):
        gn = abs(mc["grad_norm"].item() - mh["grad_norm"].item()) \
            / mh["grad_norm"].item()
        rel, cos = 0.0, 0.0
        for a, b in zip(mu_c, mu_h):
            na, nb = float(a.norm()), float(b.norm())
            if nb == 0.0 and na == 0.0:
                continue
            rel = max(rel, float((a - b).norm()) / max(nb, 1e-300))
            cos = max(cos, 1.0 - float((a * b).sum())
                      / max(na * nb, 1e-300))
        return {"grad_norm": gn, "mu_rel": rel, "mu_cos": cos}

    sound, planted, dl, dp, n_disp = [], {}, 0.0, 0.0, 0
    t_card = t_cpu = 0.0
    for s_ in range(steps):
        st_h = state_on(st_c, cpu_mesh, "cpu")
        mu0 = leaves(tsh.gather(st_c["opt_state"]["mu"], mesh.lead),
                     torch.is_tensor)
        twins = ({k: state_on(st_c, mesh) for k in faults}
                 if s_ == 0 else {})
        t0 = time.perf_counter()
        with moe_routes([]) as rc:
            st_c, mc = step_c(st_c, batch)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        with moe_routes([]) as rh:
            st_h, mh = step_h(st_h, cpu_batch)
        t_card, t_cpu = t_card + t1 - t0, t_cpu + time.perf_counter() - t1
        for n, (a, b) in enumerate(zip(rc, rh)):
            if not all(torch.equal(a[k], b[k])
                       for k in ("topi", "dest", "keep")):
                bad = (a["topi"] != b["topi"]).any(-1).nonzero()
                bad = bad.reshape(-1).tolist()
                fail(f"[mesh a'] step {s_ + 1}, dispatch {n} of {len(rc)}: "
                     f"float32 routing differs between card and CPU at "
                     f"tokens {bad[:8]} (CPU gaps "
                     f"{[b['gap'][t].item() for t in bad[:8]]}; {len(bad)} "
                     f"differ in topi)")
        check(len(rc) == len(rh) > 0, "[mesh a'] no MoE dispatch seen")
        n_disp += len(rc)
        lc, lh = mc["loss"].item(), mh["loss"].item()
        dl = max(dl, abs(lc - lh) / abs(lh))
        dp = max(dp, max(float((a.cpu() - b).abs().max()) for x, y in zip(
            leaves(st_c["params"], torch.is_tensor),
            leaves(st_h["params"], torch.is_tensor))
            for a, b in zip(x.flat(), y.flat())))
        mu_h = moved(st_h["opt_state"]["mu"], mu0)
        r = readings(mc, moved(st_c["opt_state"]["mu"], mu0), mh, mu_h)
        sound.append(r)
        say(f"[mesh a'] step {s_ + 1}: loss {lc:.6f} vs {lh:.6f}, grad norm "
            f"{mc['grad_norm'].item():.6f} vs {mh['grad_norm'].item():.6f} "
            f"(rel {r['grad_norm']:.3g}), mu's move per leaf: max rel "
            f"{r['mu_rel']:.3g}, max 1 - cos {r['mu_cos']:.3g}")
        for name, tw in twins.items():
            with (drop_data_group() if name == "group 1 dropped"
                  else contextlib.nullcontext()):
                tw, mf = faults[name](tw, batch)
            planted[name] = readings(mf, moved(tw["opt_state"]["mu"], mu0),
                                     mh, mu_h)
            del tw
        del st_h, mu0, mu_h, twins
    worst = {k: max(r[k] for r in sound) for k in sound[0]}
    say(f"[mesh a'] 2 layers in float32, {steps} steps on the 2 x 2 mesh, "
        f"card vs CPU (each step from the card's state; seed {seed}): "
        f"routing equal in all {n_disp} dispatches (topi, dest, keep per "
        f"slot), loss max rel {dl:.3g} (bound {GATE['loss']:g}), grad norm "
        f"max rel {worst['grad_norm']:.3g} (bound {GATE['grad_norm']:g}), "
        f"mu's move max rel {worst['mu_rel']:.3g} (bound "
        f"{GATE['mu_rel']:g}), max 1 - cos {worst['mu_cos']:.3g} (bound "
        f"{GATE['mu_cos']:g}), max |d param| {dp:.3g} (2 lr "
        f"{2 * lr * 1.01:.3g}); card {t_card:.2f} s, CPU {t_cpu:.2f} s")
    for name, r in planted.items():
        say(f"[mesh a'] planted fault, gradient {name}, step 1: grad norm "
            f"rel {r['grad_norm']:.3g}, mu's move max rel {r['mu_rel']:.3g}"
            f", max 1 - cos {r['mu_cos']:.3g}")
    check(dl <= GATE["loss"] and dp <= 2 * lr * 1.01 and all(
        worst[k] <= GATE[k] for k in worst),
          f"[mesh a'] card vs CPU outside the gate: loss rel {dl:.3g}, "
          f"{worst}, max |d param| {dp:.3g} (bounds {GATE}, 2 lr "
          f"{2 * lr * 1.01:.3g})")
    for name, r in planted.items():
        check(any(r[k] > GATE[k] for k in r),
              f"[mesh a'] the gate passes the planted fault (gradient "
              f"{name}): {r}")
    say(f"[mesh a'] took {time.perf_counter() - t_a:.1f} s")

    # (b') prefill B x P + 8 greedy decode steps, float32
    t_b = time.perf_counter()
    st_h = {"params": copied(st_c["params"], cpu_mesh, "cpu")}
    ptoks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))).cuda()

    def serve(params, m2, dtype, forced=None, stale=False):
        pre = stepfn.make_prefill_step(cfg, mesh=m2, moe_groups=m2.size,
                                       compute_dtype=dtype)
        dec = stepfn.make_decode_step(cfg, mesh=m2, compute_dtype=dtype)
        with moe_routes([]) as rec:
            lg, cache = pre(params, {"tokens": ptoks.to(m2.lead)})
            first, lgs, toks_ = cache, [lg.cpu()], []
            for n in range(8):
                tok = (lgs[-1].argmax(-1)[:, None] if forced is None
                       else forced[n]).to(m2.lead)
                toks_.append(tok.cpu())
                lg, cache = dec(params, first if stale else cache, tok,
                                torch.full((B,), P + n, device=m2.lead))
                lgs.append(lg.cpu())
        return lgs, rec, toks_

    far = lambda a, b: max(float((x.double() - y.double()).norm()
                                 / y.double().norm()) for x, y in zip(a, b))
    lc, rc, tc = serve(st_c["params"], mesh, f32)
    lh, rh, _ = serve(st_h["params"], cpu_mesh, f32, forced=tc)
    rel = far(lc, lh)
    check(all(torch.equal(a[k], b[k]) for a, b in zip(rc, rh)
              for k in ("topi", "dest", "keep")),
          "[mesh b'] float32 prefill / decode: routing differs")
    served = {"bfloat16 compute": serve(st_c["params"], mesh,
                                        torch.bfloat16, forced=tc)[0],
              "decode from the prefill's cache": serve(
                  st_c["params"], mesh, f32, forced=tc, stale=True)[0]}
    served = {k: far(v, lh) for k, v in served.items()}
    say(f"[mesh b'] 2 layers in float32, prefill {B} x {P} + 8 greedy "
        f"decode steps on the mesh, card vs CPU (seed {seed}): routing "
        f"equal in {len(rc)} dispatches, logits |card - CPU| / |CPU| max "
        f"{rel:.3g} over the 9 sets (bound {GATE['logits']:g}); planted "
        + ", ".join(f"{k} {v:.3g}" for k, v in served.items())
        + f" ({time.perf_counter() - t_b:.1f} s); {card}")
    check(rel <= GATE["logits"],
          f"[mesh b'] float32 prefill / decode: logits {rel:.3g} apart "
          f"(bound {GATE['logits']:g})")
    for k, v in served.items():
        check(v > GATE["logits"],
              f"[mesh b'] the gate passes the planted fault ({k}): {v:.3g}")
    return {"train": sound, "train_planted": planted, "loss": dl,
            "logits": rel, "logits_planted": served}


def ordered_sum_line(kern: dict) -> list:
    """Phase 14's in-order sum kernels as entries of the ``kernels`` line:
    they replace no TPU kernel, and no library call computes them."""
    names = {"tick.fuse": "ordered_matmul_fuse",
             "fit logits": "ordered_matmul_logits",
             "fit gradient": "ordered_matmul_grad",
             "_row_sum level": "segment_sum_row_sum"}
    return [{"name": names[k], "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ordered_sum.cu",
             "replaces": None, **v} for k, v in kern.items()]


def card_meshes():
    """Phase 21's 2 x 2 mesh, its slots on the first four cards where the
    machine has four, else all on ``cuda:0`` (said), and the same mesh on
    the CPU."""
    from repro_torch.launch.mesh import make_local_mesh
    devs = ([f"cuda:{i}" for i in range(4)]
            if torch.cuda.device_count() >= 4 else ["cuda:0"] * 4)
    mesh = make_local_mesh(2, 2, devices=devs)
    say(f"[mesh] make_local_mesh(2, 2, devices={devs}): slots "
        f"{[[str(d) for d in row] for row in mesh.devices]}")
    check(all(d.type == "cuda" for row in mesh.devices for d in row)
          and mesh.size == 4, "[mesh] a slot is not on a card")
    return mesh, make_local_mesh(2, 2, device="cpu")


def mesh_phase(card: str) -> dict:
    """Phase 21: the LM stack on a 2 x 2 ``("data", "model")`` mesh (see
    the module docstring); the slots on the first four cards where the
    machine has four, else all on ``cuda:0`` (said). Fails at the first
    check that does not hold. Returns the kernels line's entries for the
    mesh train step's kernels at a data group's shapes."""
    from repro_torch.data.corpus import CorpusConfig
    from repro_torch.distributed import sharding as tsh
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import (
        attention_bwd_ref, attention_ref, xent_bwd_ref, xent_ref,
    )
    from repro_torch.kernels.xent import streaming_xent
    from repro_torch.models import layers as mlayers
    from repro_torch.models import stepfn
    from repro_torch.models.model import model_template
    from repro_torch.models.params import leaves
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.trainer import TrainConfig, Trainer
    kfa = importlib.import_module("repro_torch.kernels.flash_attention")
    kxent = importlib.import_module("repro_torch.kernels.xent")

    GRANITE, B, S, STEPS = "granite-moe-3b-a800m", 4, 256, 3
    mesh, cpu_mesh = card_meshes()
    rng = np.random.default_rng(21)
    vocab = 49155
    toks = rng.integers(0, vocab, (B, S + 1))
    targets = toks[:, 1:].copy()
    targets[0, :40] = -1                   # data group 0 counts fewer
    batch = {"tokens": torch.from_numpy(toks[:, :S]).cuda(),
             "targets": torch.from_numpy(targets).cuda()}

    def mesh_state(n_layers, seed):
        cfg, ps, n = card_model(GRANITE, seed, master=True,
                                n_layers=n_layers)
        specs = tsh.param_pspecs(model_template(cfg), mesh)
        sp = tsh.put(ps, specs, mesh)
        del ps
        opt = AdamW()
        z = torch.zeros((), dtype=torch.int32, device=mesh.lead)
        return cfg, specs, n, opt, {"params": sp, "opt_state": opt.init(sp),
                                    "step": z}

    def launches():
        return (flash_attention.launches, flash_attention.bwd_launches,
                streaming_xent.launches, streaming_xent.bwd_launches)

    def zero():
        flash_attention.launches = flash_attention.bwd_launches = 0
        streaming_xent.launches = streaming_xent.bwd_launches = 0

    island = []
    local = mlayers._moe_local
    mlayers._moe_local = lambda *a: island.append(1) or local(*a)
    try:
        # (a) three train steps at 4 layers, twice
        t_a = time.perf_counter()
        runs = []
        for rep in range(2):
            gc.collect()
            torch.cuda.empty_cache()
            cfg, specs, n_par, opt, st = mesh_state(4, 21)
            if rep == 0:
                share = [0] * 4
                for x, s in zip(leaves(st["params"], torch.is_tensor),
                                leaves(specs, tsh.is_spec)):
                    k = math.prod(tsh._axis_size(mesh, e) for e in s if e)
                    for i in range(4):
                        share[i] += math.prod(x.shape) * 4 // k
                held = [sum(leaf.pieces[i][j].numel() * 4 for leaf in
                            leaves(st["params"], torch.is_tensor))
                        for i, j in mesh.slots()]
                check(held == share and all(
                    leaf.pieces[i][j].device == mesh.devices[i][j]
                    for leaf in leaves(st["params"], torch.is_tensor)
                    for i, j in mesh.slots()),
                      f"[mesh a] slot bytes {held} differ from the specs' "
                      f"share {share}, or a piece is off its slot")
                say(f"[mesh a] {GRANITE} at published widths, 4 layers, "
                    f"{n_par / 1e6:.1f} M float32 parameters "
                    f"({n_par * 4 / 1e9:.2f} GB): bytes each slot holds at "
                    f"rest {held} (params; the moments hold as much again "
                    f"each), equal to the specs' share")
            step = stepfn.make_train_step(
                cfg, opt, mesh=mesh, moe_groups=mesh.size,
                constrain=tsh.make_constrain(mesh))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero()
            island.clear()
            mets, secs = [], []
            for s_ in range(STEPS):
                t0 = time.perf_counter()
                if rep == 0 and s_ == STEPS - 1:
                    res = []
                    wall, events = kernel_events(
                        lambda: res.append(step(st, batch)), cpu=False)
                    n_k = sum(len(v) for v in events.values())
                    busy = sum(sum(v) for v in events.values())
                    st, m = res[0]
                else:
                    st, m = step(st, batch)
                mets.append(m)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            if rep == 0:
                n_launch, n_island = launches(), len(island)
                peak = torch.cuda.max_memory_allocated() / 1e9
                check(all(n > 0 for n in n_launch),
                      f"[mesh a] a kernel of the mesh step was not launched "
                      f"(flash fwd / bwd, xent fwd / bwd: {n_launch})")
            runs.append(([{k: v.item() for k, v in m.items()} for m in mets],
                         [t.clone() for leaf in leaves(st["params"],
                                                       torch.is_tensor)
                          for t in leaf.flat()]))
            del st, step
        check(runs[0][0] == runs[1][0] and all(
            torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1])),
              "[mesh a] two card runs of the mesh train step differ")
        m0 = runs[0][0]
        check(all(math.isfinite(v) for m in m0 for v in m.values()),
              "[mesh a] a metric is not finite")
        ms_step = 1e3 * min(secs[1:2] or secs)
        say(f"[mesh a] 3 steps x {B} x {S} tokens on the 2 x 2 mesh (island "
            f"each step: moe_groups = {mesh.size}): loss "
            f"{[round(m['loss'], 5) for m in m0]}, aux "
            f"{[round(m['aux'], 5) for m in m0]}, grad norm "
            f"{[round(m['grad_norm'], 4) for m in m0]}; two runs bit-equal; "
            f"ms per step {[round(1e3 * t, 1) for t in secs]} (step 3 "
            f"profiled); launches per step: flash fwd / bwd "
            f"{n_launch[0] // STEPS} / {n_launch[1] // STEPS}, xent fwd / "
            f"bwd {n_launch[2] // STEPS} / {n_launch[3] // STEPS}, island "
            f"slots {n_island // STEPS}; peak {peak:.2f} GB; {card}")
        say(f"[mesh a] (a) took {time.perf_counter() - t_a:.1f} s")
        if n_k:
            say(f"[mesh a] profiled step: {n_k} kernels, device busy "
                f"{busy / 1e3:.1f} of {wall * 1e3:.1f} ms wall "
                f"({(1 - busy / 1e6 / wall) * 100:.1f}% idle, profiler on)")
            for name, ts_ in sorted(events.items(),
                                    key=lambda kv: -sum(kv[1]))[:6]:
                say(f"[mesh a]   {sum(ts_) / 1e3:7.2f} ms in {len(ts_)} "
                    f"launches  {name[:90]}")
        else:
            say("[mesh a] kernels per step: not measured (no device events)")
        del runs
        gc.collect()
        torch.cuda.empty_cache()

        # (a') and (b') 2 layers in float32, card against the CPU, and
        # the planted faults each gate must reject
        mesh_gates(card, mesh, cpu_mesh, 22)
        gc.collect()
        torch.cuda.empty_cache()

        P = 512
        ptoks = torch.from_numpy(rng.integers(0, vocab, (B, P))).cuda()
        # (b) prefill 4 x 512 + 8 greedy decode steps at 4 layers, twice
        t_b = time.perf_counter()
        cfg4, _, _, _, st = mesh_state(4, 21)
        pre = stepfn.make_prefill_step(cfg4, mesh=mesh, moe_groups=mesh.size)
        dec = stepfn.make_decode_step(cfg4, mesh=mesh)
        reps = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = pre(st["params"], {"tokens": ptoks})
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            lgs, t0 = [lg], time.perf_counter()
            for n in range(8):
                lg, cache = dec(st["params"], cache,
                                lgs[-1].argmax(-1)[:, None],
                                torch.full((B,), P + n, device="cuda"))
                lgs.append(lg)
            torch.cuda.synchronize()
            reps.append((lgs, t_pre, (time.perf_counter() - t0) / 8))
        check(all(torch.equal(a, b) for a, b in zip(reps[0][0], reps[1][0]))
              and all(bool(torch.isfinite(x).all()) for x in reps[0][0]),
              "[mesh b] prefill / decode on the mesh does not repeat")
        say(f"[mesh b] 4 layers, prefill {B} x {P} on the island + 8 greedy "
            f"decode steps (global dispatch), twice, bit-equal: prefill "
            f"{reps[1][1] * 1e3:.1f} ms, decode {reps[1][2] * 1e3:.2f} ms a "
            f"token ((b) took {time.perf_counter() - t_b:.1f} s); {card}")
        del st, cache, reps, lgs
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        mlayers._moe_local = local

    # (c) Trainer on the mesh: 4 steps, checkpoint at 2, crash and restore
    t_c = time.perf_counter()
    from repro_torch.configs import get_config, reduced
    cfg_r = reduced(get_config(GRANITE))
    root = ROOT / "build" / "mesh_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    corpus = CorpusConfig(vocab_size=cfg_r.vocab_size, seq_len=64,
                          global_batch=4)

    def trainer(sub, m):
        tc = TrainConfig(steps=4, lr=1e-3, warmup=1, ckpt_dir=str(root / sub),
                         ckpt_every=2, log_every=1, seed=3,
                         ckpt_background=False)
        return Trainer(cfg_r, corpus, tc, mesh=m, log=lambda *a: None,
                       device="cuda")

    try:
        straight = ckpt._flatten(trainer("a", mesh).run())
        try:
            trainer("b", mesh).run(fail_at_step=3)
            fail("[mesh c] the injected crash did not happen")
        except RuntimeError as exc:
            check("injected" in str(exc), f"[mesh c] {exc}")
        resumed = ckpt._flatten(trainer("b", mesh).run())
        one, _ = ckpt.restore(str(root / "a"),
                              trainer("a", None).state_template(),
                              device="cuda")
        check(straight.keys() == resumed.keys() and all(
            np.array_equal(straight[k], resumed[k]) for k in straight),
              "[mesh c] crash + restore differs from the straight run")
        check(all(np.array_equal(v, straight[k])
                  for k, v in ckpt._flatten(one).items()),
              "[mesh c] the mesh checkpoint does not restore on one device")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say(f"[mesh c] Trainer on the mesh ({GRANITE} reduced, 4 x 64 tokens, "
        f"moe_groups = {mesh.size}): 4 steps, checkpoint at 2, crash at 3 and "
        f"restore: equal to the straight run bit for bit; the mesh "
        f"checkpoint restores on one card, equal "
        f"({time.perf_counter() - t_c:.1f} s)")

    # (c') the same Trainer with compression: the gradient QDQ'd to int8
    # with each whole leaf's scale, seen through a wrapping grad_transform
    t_cc = time.perf_counter()
    from repro_torch.distributed import compression as tcomp
    from repro_torch.training import trainer as ttrainer
    seen = []

    def wrapped(grads):
        before = tsh.gather(grads, mesh.lead)
        out = tcomp.compress_tree(grads)
        # the optimizer clips the gradient in place: keep a copy
        seen.append((before, [x.clone() for x in leaves(
            tsh.gather(out, mesh.lead), torch.is_tensor)]))
        return out

    def compressed_run():
        tc = TrainConfig(steps=4, lr=1e-3, warmup=1, log_every=1, seed=3,
                         compression=True)
        t = Trainer(cfg_r, corpus, tc, mesh=mesh, log=lambda *a: None,
                    device="cuda")
        return ckpt._flatten(t.run())

    inner = ttrainer.compress_tree
    ttrainer.compress_tree = wrapped
    try:
        zero()
        comp = [compressed_run()]
        n_cc = launches()
        comp.append(compressed_run())
    finally:
        ttrainer.compress_tree = inner
    check(all(n > 0 for n in n_cc), f"[mesh c'] a kernel of the compressed "
          f"step was not launched (flash fwd / bwd, xent fwd / bwd: {n_cc})")
    check(comp[0].keys() == comp[1].keys() and all(
        np.array_equal(comp[0][k], comp[1][k]) for k in comp[0]),
          "[mesh c'] two compressed Trainer runs on the mesh differ")
    check(len(seen) == 8, f"[mesh c'] {len(seen)} compressed steps, not 8")
    n_leaf = 0
    for before, after in seen:
        want = leaves(tcomp.compress_tree(before), torch.is_tensor)
        for g, a, w in zip(leaves(before, torch.is_tensor), after, want):
            scale = tcomp.int8_scale(g.float().abs().max())
            q = torch.round(a.float() / scale)
            check(torch.equal(a, w) and torch.equal(q * scale, a.float())
                  and float(q.abs().max()) <= 127,
                  "[mesh c'] a compressed leaf gathered is not compress_tree "
                  "of the gathered gradient, or not an integer multiple of "
                  "its scale within +-127")
            n_leaf += 1
    check(any(not np.array_equal(comp[0][k], straight[k])
              for k in straight if k.startswith("params/")),
          "[mesh c'] compression changed no parameter")
    say(f"[mesh c'] Trainer on the mesh with compression ({GRANITE} "
        f"reduced, 4 x 64 tokens): 4 steps, twice, bit-equal; {n_leaf} "
        f"compressed leaves over 8 steps, each gathered equal to "
        f"compress_tree of the gathered gradient bit for bit, every element "
        f"an integer multiple of its scale within +-127; launches a run: "
        f"flash fwd / bwd {n_cc[0]} / {n_cc[1]}, xent fwd / bwd {n_cc[2]} / "
        f"{n_cc[3]} ({time.perf_counter() - t_cc:.1f} s)")

    # the mesh step's kernels at a data group's shapes, against their plain
    # versions (these launches are not the main path's)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    rows, Hq, Hkv, D = B // 2, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf16 = torch.bfloat16
    q = torch.randn((rows, S, Hq, D), generator=gen, device="cuda").to(bf16)
    k = torch.randn((rows, S, Hkv, D), generator=gen, device="cuda").to(bf16)
    v = torch.randn((rows, S, Hkv, D), generator=gen, device="cuda").to(bf16)
    tr = lambda x: x.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shape = f"({rows}, {S}, {Hq}/{Hkv}, {D}) bf16 causal"
    fa = kernel_times(
        f"flash_attention at the mesh step's {shape}",
        lambda: kfa._fwd_kernel(q, k, v, True, 0, False)[0],
        lambda: tr(attention_ref(tr(q), tr(k), tr(v), causal=True)),
        lambda: sdpa(tr(q), tr(k), tr(v), is_causal=True, enable_gqa=True),
        flash_bound_ms(rows, Hq, Hkv, S, S, D, 2, True, 0), card, 50,
        2e-2, 2e-2)
    o, lse = kfa._fwd_kernel(q, k, v, True, 0, True)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(bf16)
    cat = lambda ts: torch.cat([t.float().reshape(-1) for t in ts])
    qr, kr, vr = (tr(x).detach().requires_grad_(True) for x in (q, k, v))
    lib_o = sdpa(qr, kr, vr, is_causal=True, enable_gqa=True)
    fb = kernel_times(
        f"flash_attention backward at the mesh step's {shape}",
        lambda: cat(kfa._bwd_kernel(q, k, v, o, lse, do, True, 0)),
        lambda: cat(tr(t) for t in attention_bwd_ref(
            tr(q), tr(k), tr(v), tr(o), tr(do), causal=True)),
        lambda: torch.autograd.grad(lib_o, (qr, kr, vr), tr(do),
                                    retain_graph=True),
        flash_bwd_bound_ms(rows, Hq, Hkv, S, S, D, 2, True, 0), card, 50,
        2e-2, 2e-2)
    N = rows * S
    x = torch.randn((N, cfg.vocab_size), generator=gen, device="cuda") * 2
    t = torch.randint(0, cfg.vocab_size, (N,), generator=gen, device="cuda")
    t32 = t.to(torch.int32)
    xl = kernel_times(
        f"streaming_xent at the mesh step's ({N}, {cfg.vocab_size}) f32",
        lambda: kxent._fwd_kernel(x, t32)[0], lambda: xent_ref(x, t),
        lambda: torch.nn.functional.cross_entropy(x, t, reduction="none"),
        xent_bound_ms(N, cfg.vocab_size, 4, False), card, 50, 2e-4, 1e-5)
    lse_x = kxent._fwd_kernel(x, t32)[1]
    g = torch.rand((N,), generator=gen, device="cuda")
    xr = x.detach().requires_grad_(True)
    lib_l = torch.nn.functional.cross_entropy(xr, t, reduction="none")
    xb = kernel_times(
        f"streaming_xent backward at the mesh step's ({N}, "
        f"{cfg.vocab_size}) f32",
        lambda: kxent._bwd_kernel(x, t32, lse_x, g),
        lambda: xent_bwd_ref(x, t, lse_x, g),
        lambda: torch.autograd.grad(lib_l, xr, g, retain_graph=True),
        xent_bound_ms(N, cfg.vocab_size, 4, True), card, 50, 1e-6, 1e-4)
    return {
        "flash_attention_mesh": dict(launches=n_launch[0], **fa),
        "flash_attention_bwd_mesh": dict(launches=n_launch[1], **fb),
        "streaming_xent_mesh": dict(launches=n_launch[2], **xl),
        "streaming_xent_bwd_mesh": dict(launches=n_launch[3], **xb),
    }


def mesh_kernels(res: dict) -> list:
    """Phase 21's entries of the kernels line."""
    src = {"flash_attention_mesh": ("flash_attention.cu", "flash_attention"),
           "flash_attention_bwd_mesh": ("flash_attention_bwd.cu",
                                        "flash_attention"),
           "streaming_xent_mesh": ("xent.cu", "xent"),
           "streaming_xent_bwd_mesh": ("xent.cu", "xent")}
    line = {"flash_attention": 84, "xent": 53}
    return [{"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{cu}",
             "replaces": f"src/repro/kernels/{py}.py:{line[py]}", **res[name]}
            for name, (cu, py) in src.items()]


def dryrun_phase(card: str) -> dict:
    """Phase 22: the dry-run (see the module docstring). Fails at the first
    check that does not hold. Returns (b)'s launches of the mesh step's
    kernels, forward and backward."""
    from repro_torch.configs import ARCHS, SHAPES, cell_supported, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as tsh
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.xent import streaming_xent
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import stepfn
    from repro_torch.models.model import model_template
    from repro_torch.models.params import leaves
    from repro_torch.training.optimizer import AdamW

    # (a) the CLI over every cell and both production layouts, host only
    out = ROOT / "build" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both", "--out", str(out)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    check(run.returncode == 0, f"[dryrun a] the CLI exited {run.returncode}: "
          f"{(run.stdout + run.stderr)[-2000:]}")
    # one OK / SKIP / FAIL line a cell; a record file for each cell that
    # ran (the reference's CLI writes none for a skip)
    lines = {tuple(ln.split()[1:4]): ln.split()[0]
             for ln in run.stdout.splitlines()
             if ln.split()[:1] in (["OK"], ["SKIP"], ["FAIL"])}
    recs = {(r["arch"], r["shape"], r["mesh"]): r for r in (
        json.loads(f.read_text()) for f in sorted(out.glob("*.json")))}
    cells = [(a, sh_, m) for a in ARCHS for sh_ in SHAPES
             for m in ("single", "multi")]
    check(sorted(lines) == sorted(cells),
          f"[dryrun a] {len(lines)} lines for {len(cells)} cells")
    skips = {k for k, v in lines.items() if v == "SKIP"}
    check(sorted(recs) == sorted(set(cells) - skips)
          and all(r["status"] == "ok" for r in recs.values())
          and all(lines[k] == "OK" for k in recs),
          "[dryrun a] a cell that ran is not ok, or its record is missing")
    want = {(a, sh_, m) for a, sh_, m in cells
            if not cell_supported(get_config(a), SHAPES[sh_])[0]}
    check(skips == want, f"[dryrun a] the skips {sorted(skips)} are not "
          f"cell_supported's {sorted(want)}")
    say(f"[dryrun a] python -m repro_torch.launch.dryrun --all --mesh both: "
        f"{len(recs)} ok, {len(skips)} skipped, 0 errors, "
        f"in {secs:.1f} s (host only)")
    for (a, sh_, m), r in sorted(recs.items()):
        if r["status"] == "ok" and SHAPES[sh_].kind == "train":
            say(f"[dryrun a]   {a:24s} {sh_} {m:6s} microbatches "
                f"{r['microbatches']}, kv_shard {r['kv_shard']}: "
                f"{r['memory']['argument_bytes'] / 2**30:.3f} GB of "
                f"arguments a device")

    # (b) build_cell's step on a real 2 x 2 mesh on one card
    t_b = time.perf_counter()
    GRANITE, B, S = "granite-moe-3b-a800m", 4, 256
    mesh = make_local_mesh(2, 2, devices=["cuda:0"] * 4)
    cfg, ps, n_par = card_model(GRANITE, 22, master=True, n_layers=4)
    shape = ShapeConfig("train_4x256", "train", S, B)
    step, args, extra = dryrun.build_cell(cfg, shape, mesh, kv_shard="auto")
    rec_bytes = dryrun.argument_bytes(args, step.in_specs, mesh)
    rng = np.random.default_rng(22)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :S]).cuda(),
             "targets": torch.from_numpy(toks[:, 1:].copy()).cuda()}
    opt = AdamW(lr=3e-4)
    state = {"params": ps, "opt_state": opt.init(ps),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    st, b = step.place(state, batch)
    held = [sum(leaf.pieces[i][j].numel() * leaf.pieces[i][j].element_size()
                for tree in (st["params"], st["opt_state"]["mu"],
                             st["opt_state"]["nu"])
                for leaf in leaves(tree, torch.is_tensor))
            for i, j in mesh.slots()]
    share = 2 * (B // 2) * S * 4 + 8     # tokens + targets, two counters
    check(held == [rec_bytes - share] * 4,
          f"[dryrun b] slot state bytes {held} differ from the record's "
          f"{rec_bytes} less the batch's and counters' {share}")
    # the direct step on the same state, laid out by the parameters' specs
    specs = tsh.param_pspecs(model_template(cfg), mesh)
    sp = tsh.put(ps, specs, mesh)
    opt_d = AdamW(lr=3e-4)
    direct = {"params": sp, "opt_state": opt_d.init(sp),
              "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    direct_step = stepfn.make_train_step(
        cfg, opt_d, microbatches=1, remat=True,
        constrain=tsh.make_constrain(mesh), moe_groups=2, mesh=mesh)
    del ps, state
    flash_attention.launches = flash_attention.bwd_launches = 0
    streaming_xent.launches = streaming_xent.bwd_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, m = step(st, b)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n_launch = (flash_attention.launches, flash_attention.bwd_launches,
                streaming_xent.launches, streaming_xent.bwd_launches)
    direct, md = direct_step(direct, batch)
    check(n_launch == (16, 8, 2, 2),
          f"[dryrun b] flash fwd / bwd, xent fwd / bwd launches {n_launch}, "
          "not 16 / 8 / 2 / 2")
    check(all(torch.equal(m[k], md[k]) for k in md) and all(
        torch.equal(a, c) for x, y in zip(
            leaves(st["params"], torch.is_tensor),
            leaves(direct["params"], torch.is_tensor))
        for a, c in zip(x.flat(), y.flat())),
          "[dryrun b] build_cell's step differs from the step built directly")
    check(all(math.isfinite(v.item()) for v in m.values()),
          "[dryrun b] a metric is not finite")
    say(f"[dryrun b] build_cell({GRANITE} at published widths, 4 layers, "
        f"{n_par / 1e6:.1f} M parameters; train {B} x {S}) on "
        f"make_local_mesh(2, 2, devices=['cuda:0'] * 4): extra {extra}; the "
        f"record's argument_bytes {rec_bytes} a slot = state {held[0]} "
        f"(params {held[0] // 3} x 3) + batch 4096 + counters 8; one step "
        f"{ms:.1f} ms (cold), loss {m['loss'].item():.5f}, equal bit for bit "
        f"to make_train_step's with build_cell's arguments (AdamW(lr=3e-4), "
        f"moe_groups = 2); launches flash fwd / bwd {n_launch[0]} / "
        f"{n_launch[1]}, xent fwd / bwd {n_launch[2]} / {n_launch[3]} "
        f"((b) took {time.perf_counter() - t_b:.1f} s); {card}")
    del st, direct, sp
    gc.collect()
    torch.cuda.empty_cache()
    return dict(zip(("flash_attention_mesh", "flash_attention_bwd_mesh",
                     "streaming_xent_mesh", "streaming_xent_bwd_mesh"),
                    n_launch))


def dryrun_kernels(res21: dict, launches22: dict) -> list:
    """Phase 22's entries of the kernels line: (b)'s launches, beside the
    times phase 21 took in this run at the same shapes (a data group's
    (2, 256) tokens of granite-moe-3b-a800m)."""
    return [dict(e, name=e["name"].replace("_mesh", "_dryrun"),
                 launches=launches22[e["name"]])
            for e in mesh_kernels(res21)]


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"{torch.cuda.get_device_name(0)}, power limit unknown"


def lm_depth(card: str):
    """``python3 chip_smoke.py --lm-depth``: the full-width xlstm-125m
    forward of 16 bank tasks on the card against the CPU after each
    mLSTM + sLSTM group, in bfloat16 and in float32, beside the CPU's and
    the card's response to moving the embedded input by one bfloat16 ulp
    (2^-8 relative, random signs)."""
    from repro_torch.device import full_fp32
    from repro_torch.embed import encoder as eenc
    from repro_torch.embed.corpus import make_tokens
    from repro_torch.models import layers as mlayers
    from repro_torch.models import model as mmodel
    from repro_torch.models.params import tree_map
    from repro_torch.scenarios import get_scenario, to_stream_config

    cfg = to_stream_config(get_scenario("lm_stream", LM_FULL))
    L, C = cfg.learner, cfg.n_classes
    ec = L.embed
    mcfg = eenc.resolved_config(ec)
    K = ec.bank_size // (2 * C)
    hard = np.repeat(np.arange(2), C * K).astype(bool)
    labels = np.tile(np.repeat(np.arange(C, dtype=np.int32), K), 2)
    tokens, _ = make_tokens(ec, labels, hard, C, mcfg.vocab_size,
                            L.class_sep, L.hard_sep_scale)
    tb = torch.as_tensor(tokens[:16]).long()
    group, n_full, _ = mcfg.layer_groups()
    params = eenc.model_params(ec, "cuda")
    cpu_params = tree_map(lambda t: t.cpu(), params, is_leaf=torch.is_tensor)
    sign = torch.sign(torch.randn((16, ec.seq_len, mcfg.d_model),
                                  generator=torch.Generator().manual_seed(0)))

    def hidden(ps, dev, dtype, move):
        ps = tree_map(lambda t: t.to(dtype), ps, is_leaf=torch.is_tensor)
        x = ps["embed"][tb.to(dev)]
        if move:
            x = (x.float() * (1 + 2.0 ** -8 * sign.to(dev))).to(dtype)
        outs = []
        with full_fp32():
            for gp in mmodel._unstack(ps["groups"], n_full):
                x = group_hidden(x, gp, group, mcfg)
                outs.append(mlayers.apply_norm(
                    ps["final_norm"], x, mcfg.norm, mcfg.norm_eps
                ).float().cpu())
        return outs

    def rel(a, b):
        d, scale = (a - b).abs(), b.abs().mean()
        return f"mean {float(d.mean() / scale):.3g} max " \
            f"{float(d.max() / scale):.3g}"

    for dtype in (torch.bfloat16, torch.float32):
        g, c = hidden(params, "cuda", dtype, False), \
            hidden(cpu_params, "cpu", dtype, False)
        cm, gm = hidden(cpu_params, "cpu", dtype, True), \
            hidden(params, "cuda", dtype, True)
        for k in range(n_full):
            say(f"[depth] {str(dtype)[6:]} after {len(group) * (k + 1)} "
                f"layers: card vs CPU {rel(g[k], c[k])}; CPU moved one ulp "
                f"{rel(cm[k], c[k])}; card moved {rel(gm[k], g[k])} (of "
                f"the mean |hidden|); {card}")


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
    if len(sys.argv) == 2 and sys.argv[1] in ("--phase14", "--phase17",
                                               "--phase18", "--phase19",
                                               "--phase20", "--phase21",
                                               "--phase22", "--lm-depth",
                                               "--mesh-gates"):
        sys.path.insert(0, str(ROOT / "src"))
        torch.backends.cuda.matmul.allow_tf32 = False
        card = card_line()
        say(card)
        if sys.argv[1] == "--lm-depth":
            lm_depth(card)
            return
        if sys.argv[1] == "--phase14":
            from repro_torch.kernels import _build
            t0 = time.perf_counter()
            _build.build(("ds_estep", "ordered_sum"))
            say(f"[build] ds_estep, ordered_sum "
                f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            say(json.dumps({"kernels": ordered_sum_line(
                stream_learner_phase(card))}))
            say(f"[phase 14] done in {time.perf_counter() - t0:.1f} s")
            return
        if sys.argv[1] == "--phase20":
            from repro_torch.kernels import _build
            t0 = time.perf_counter()
            _build.build(("ds_estep", "entropy"))
            say(f"[build] ds_estep, entropy {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            say(json.dumps(sharded_phase(card)))
            say(f"[phase 20] done in {time.perf_counter() - t0:.1f} s")
            return
        if sys.argv[1] == "--mesh-gates":
            from repro_torch.kernels import _build
            _build.build(("flash_attention", "flash_attention_bwd", "xent"))
            mesh, cpu_mesh = card_meshes()
            for seed in (22, 23, 24):
                mesh_gates(card, mesh, cpu_mesh, seed)
                gc.collect()
                torch.cuda.empty_cache()
            return
        if sys.argv[1] == "--phase21":
            from repro_torch.kernels import _build
            t0 = time.perf_counter()
            _build.build(("flash_attention", "flash_attention_bwd", "xent"))
            say(f"[build] flash_attention, flash_attention_bwd, xent "
                f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            say(json.dumps({"kernels": mesh_kernels(mesh_phase(card))}))
            say(f"[phase 21] done in {time.perf_counter() - t0:.1f} s")
            return
        if sys.argv[1] == "--phase22":
            from repro_torch.kernels import _build
            t0 = time.perf_counter()
            _build.build(("flash_attention", "flash_attention_bwd", "xent"))
            say(f"[build] flash_attention, flash_attention_bwd, xent "
                f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            say(json.dumps({"launches": dryrun_phase(card)}))
            say(f"[phase 22] done in {time.perf_counter() - t0:.1f} s")
            return
        if sys.argv[1] == "--phase19":
            from repro_torch.kernels import _build
            t0 = time.perf_counter()
            _build.build(("flash_attention", "linear_scan"))
            say(f"[build] flash_attention, linear_scan "
                f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            say(json.dumps(lm_stack_phase(card)["kernels"]))
            say(f"[phase 19] done in {time.perf_counter() - t0:.1f} s")
            return
        from repro_torch.scenarios import smoke
        check(smoke.main(["--device", "cuda"]) == 0,
              "[serve a] the registry smoke failed on the card")
        if sys.argv[1] == "--phase17":
            lm_stream_phase(card)
            return
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build(("ds_estep", "entropy"))
        say(f"[build] ds_estep, entropy {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        grid_events_phase(card)
        say(f"[phase 18] done in {time.perf_counter() - t0:.1f} s")
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
    t_smoke = time.perf_counter()
    say(f"[phase 1] starts at {time.perf_counter() - t_smoke:.1f} s")
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
    say(f"[phase 2] starts at {time.perf_counter() - t_smoke:.1f} s")
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
    say(f"[phase 3] starts at {time.perf_counter() - t_smoke:.1f} s")
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
    say(f"[phase 4] starts at {time.perf_counter() - t_smoke:.1f} s")
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
    # phase 16 holds its traced run against this one
    phase4 = dict(out={k: v.cpu() for k, v in _outputs(out).items()},
                  secs=stream_s, kpt=None)

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
    say(f"[phase 5] starts at {time.perf_counter() - t_smoke:.1f} s")
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
        phase4["kpt"] = round(n_k / Hp)
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
    say(f"[phase 6] starts at {time.perf_counter() - t_smoke:.1f} s")
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
    say(f"[phase 7] starts at {time.perf_counter() - t_smoke:.1f} s")
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
    say(f"[phase 8] starts at {time.perf_counter() - t_smoke:.1f} s")
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
    say(f"[phase 9] starts at {time.perf_counter() - t_smoke:.1f} s")
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
    say(f"[phase 10] starts at {time.perf_counter() - t_smoke:.1f} s")
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
                                      logits_mode="hidden")[0]
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
            xb = mmodel.apply_block(gp0[bi], bkind, xb, None, cfg10,
                                    {"mode": "train"})[0]
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
    say(f"[phase 11] starts at {time.perf_counter() - t_smoke:.1f} s")
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
    say(f"[phase 12] starts at {time.perf_counter() - t_smoke:.1f} s")
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
    say(f"[phase 13] starts at {time.perf_counter() - t_smoke:.1f} s")
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
    say(f"[phase 14] starts at {time.perf_counter() - t_smoke:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    os14 = stream_learner_phase(card)

    # ---- phase 15: the scenario front door and the live serve path ------
    say(f"[phase 15] starts at {time.perf_counter() - t_smoke:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    serve_phase(card)

    # ---- phase 16: traces and traced sweeps -------------------------------
    say(f"[phase 16] starts at {time.perf_counter() - t_smoke:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    estep9 = traced_sweeps_phase(card, phase4)

    # ---- phase 17: the LM stream at full width ----------------------------
    say(f"[phase 17] starts at {time.perf_counter() - t_smoke:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    lm_stream_phase(card)

    # ---- phase 18: the grid and the event-loop engine ---------------------
    say(f"[phase 18] starts at {time.perf_counter() - t_smoke:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    ev18 = grid_events_phase(card)

    # ---- phase 19: the rest of the LM stack -------------------------------
    say(f"[phase 19] starts at {time.perf_counter() - t_smoke:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    eenc._params.cache_clear()              # phases 10 and 17's parameters
    gc.collect()
    torch.cuda.empty_cache()
    st19 = lm_stack_phase(card)["kernels"]

    # ---- phase 20: the device-sharded labeling service -------------------
    say(f"[phase 20] starts at {time.perf_counter() - t_smoke:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    sh20 = sharded_phase(card)

    # ---- phase 21: the LM stack on a mesh ---------------------------------
    say(f"[phase 21] starts at {time.perf_counter() - t_smoke:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t21 = time.perf_counter()
    mesh21 = mesh_phase(card)
    say(f"[phase 21] done in {time.perf_counter() - t21:.1f} s")

    # ---- phase 22: the dry-run -------------------------------------------
    say(f"[phase 22] starts at {time.perf_counter() - t_smoke:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t22 = time.perf_counter()
    dry22 = dryrun_phase(card)
    say(f"[phase 22] done in {time.perf_counter() - t22:.1f} s")

    # ds_estep: the public call at the stream's refresh shape (the task
    # route's warp mode), and the task kernel at the offline EM's C4 shape
    # (block mode, the table in shared memory); entropy_scores: the narrow
    # route at the two learning shapes
    t_off = timings["offline-C4"]
    e_mnist = ent_t["learn-mnist"]
    say(f"[phase] all done at {time.perf_counter() - t_smoke:.1f} s")
    say(json.dumps({"kernels": [{
        "name": "ds_estep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ds_estep.cu",
        "replaces": "src/repro/kernels/ds_estep.py:58",
        "launches": stream_launches,
        "max_abs_err": errs["refresh"],
        "ms": t_main["ms"], "plain_ms": t_main["plain_ms"],
        "bound_ms": t_main["bound_ms"], "bound_by": t_main["bound_by"],
        "library_ms": None}, {
        "name": "ds_estep_votes_sweep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ds_estep.cu",
        "replaces": "src/repro/kernels/ds_estep.py:58",
        "launches": estep9["launches"],
        "max_abs_err": estep9["max_abs_err"],
        "ms": estep9["ms"], "plain_ms": estep9["plain_ms"],
        "bound_ms": estep9["bound_ms"], "bound_by": estep9["bound_by"],
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
        "name": "ds_estep_events", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ds_estep.cu",
        "replaces": "src/repro/kernels/ds_estep.py:58",
        **ev18["estep"]}, {
        "name": "entropy_scores_events", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/entropy.cu",
        "replaces": "src/repro/kernels/uncertainty.py:55",
        **ev18["entropy"]}, {
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
        "library_ms": None}, {
        "name": "flash_attention_encoder", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        **st19["flash_attention_encoder"]}, {
        "name": "flash_attention_cross", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        **st19["flash_attention_cross"]}, {
        "name": "flash_attention_cross_bank", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        **st19["flash_attention_cross_bank"]}, {
        "name": "linear_scan_prefill", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan.py:44",
        **st19["linear_scan_prefill"]}, {
        "name": "ds_estep_sharded", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ds_estep.cu",
        "replaces": "src/repro/kernels/ds_estep.py:58",
        **sh20["estep"]}, {
        "name": "entropy_scores_sharded", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/entropy.cu",
        "replaces": "src/repro/kernels/uncertainty.py:55",
        **sh20["entropy"]}] + ordered_sum_line(os14) + mesh_kernels(mesh21)
        + dryrun_kernels(mesh21, dry22)}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
