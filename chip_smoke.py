"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's main path on the card:

  1. the card's name and power limit, and the kernel build (``nvcc -Xptxas
     -v``: registers, shared memory and spills);
  2. the ``ds_estep`` kernel against its plain PyTorch version at the
     shapes the main path gives it and at edge shapes;
  3. the offline Dawid-Skene EM (full confusion, 20 iterations) on 2^20
     synthetic tasks, twice, bit for bit, and against the CPU on a slice;
  4. the streaming labeling service (``skewed_adaptive5`` with the EM
     refresh every 40 ticks) for 1440 ticks x 256 replications, twice, and
     its first 8 replications against a CPU run of the port with the same
     initial state and arrivals;
  5. timings: the kernel per call (CUDA events) and its device time
     (``torch.profiler``) beside its bound and its plain version; the
     stream's ticks per second, and a profiled window of it (kernels and
     device busy time per tick).

It exits nonzero as soon as a phase fails, prints one ``{"kernels": ...}``
JSON line, and ends with ``{"ok": true, "device": ...}``. It imports only
torch, numpy and the port (``src/repro_torch``), and needs no network.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (data sheet)
H100_F32_FLOPS = 67e12              # H100 SXM float32, no tensor cores


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


def device_profile(fn):
    """Run ``fn()`` under ``torch.profiler`` and return ``(wall_s, kernels,
    busy_us, by_name)``: the host wall time (profiler on), the number of
    device kernels, their summed device time and that time per kernel
    name. ``kernels`` is 0 where the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return wall, len(kern), sum(by_name.values()), by_name


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch reports no CUDA device; nothing to run",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.ds_estep import ds_estep, smem_budget
    from repro_torch.kernels.ref import ds_estep_ref
    from repro_torch.labelstream import aggregate, router
    from repro_torch.scenarios import get_stream_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- phase 1: the card and the build --------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"{kind}, power limit unknown"
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
    say(f"[build] ds_estep stages row tables up to {smem_budget()} bytes "
        "in shared memory")

    # ---- phase 2: kernel vs plain version --------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {}

    def compare(label, B, W, C, T, V, atol_lp, atol_p, zero_row=None):
        rows, idx = make_estep_inputs(gen, B, W, C, T, V, dev)
        if zero_row is not None:
            idx[..., zero_row, :] = W * C
        lp, p = ds_estep(rows, idx)
        torch.cuda.synchronize()
        lr, pr = ds_estep_ref(rows, idx)
        e_lp = (lp - lr).abs().max().item()
        e_p = (p - pr).abs().max().item()
        ok = (torch.isfinite(lp).all().item() and e_lp <= atol_lp
              and e_p <= atol_p)
        R = W * C + 1
        path = "smem" if R * C * 4 <= smem_budget() else "global"
        say(f"[estep] {label}: B={B} W={W} C={C} T={T} V={V} ({path}) "
            f"max|dlogp|={e_lp:.3g} (tol {atol_lp}) max|dpost|={e_p:.3g} "
            f"(tol {atol_p})")
        check(ok, f"ds_estep disagrees with its plain version at {label}")
        if zero_row is not None:
            check(bool((p[..., zero_row, :] == 1.0 / C).all()),
                  f"zero-vote task not exactly uniform at {label}")
        errs[label] = max(e_lp, e_p)

    compare("9x4x77x5", None, 9, 4, 77, 5, 1e-4, 1e-5, zero_row=7)
    compare("16x8x512x5", None, 16, 8, 512, 5, 1e-3, 1e-4)
    compare("C33", None, 5, 33, 301, 4, 1e-4, 1e-5, zero_row=3)
    compare("C130", 3, 4, 130, 77, 3, 1e-4, 1e-5, zero_row=5)
    compare("refresh", 512, 9, 2, 32, 5, 1e-4, 1e-5, zero_row=0)
    compare("offline-C4", None, 1024, 4, 1 << 20, 5, 1e-4, 1e-5)
    compare("offline-C8", None, 1024, 8, 1 << 20, 5, 1e-4, 1e-5)

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
    ds_estep.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em = aggregate.dawid_skene(labels, workers, mask, n_workers=W,
                               n_classes=C, iters=20, one_coin=False,
                               device=dev)
    torch.cuda.synchronize()
    em_s = time.perf_counter() - t0
    em_launches = ds_estep.launches
    check(em_launches == 20, f"offline EM made {em_launches} E-step "
          "launches, expected 20")
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
        f"first call, {em2_s:.3f} s second call; launches={em_launches}, "
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
    cfg = get_stream_config("skewed_adaptive5",
                            {"refresh_every": 40, "refresh_iters": 6})
    H, N, SEED = 1440, 256, 0
    n_refresh = H // cfg.refresh_every
    ds_estep.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = router.run_stream(cfg, H, n_reps=N, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    stream_launches = ds_estep.launches
    check(stream_launches == n_refresh * cfg.refresh_iters,
          f"stream made {stream_launches} E-step launches, expected "
          f"{n_refresh * cfg.refresh_iters}")
    ints = [k for k, v in out.items() if torch.is_tensor(v)
            and not v.is_floating_point()]
    total = lambda k: int(out[k].sum().item())
    lhs = total("arrived")
    rhs = (total("done_all") + total("backlog_end") + total("in_flight_end")
           + total("dropped"))
    say(f"[stream] {cfg.n_shards * N} shard-replications x {H} ticks: "
        f"{stream_s:.2f} s wall ({H / stream_s:.1f} ticks/s), "
        f"ds_estep launches={stream_launches} ({n_refresh} refreshes x "
        f"{cfg.refresh_iters} iterations)")
    say(f"[stream] conservation: arrived {lhs} == done {total('done_all')} "
        f"+ backlog {total('backlog_end')} + in flight "
        f"{total('in_flight_end')} + dropped {total('dropped')}")
    check(lhs == rhs, "stream conservation fails")
    out2 = router.run_stream(cfg, H, n_reps=N, seed=SEED, device="cuda")
    diff = [k for k in ints if not torch.equal(out[k], out2[k])]
    diff += [f"series.{k}" for k in out["series"]
             if not torch.equal(out["series"][k], out2["series"][k])]
    check(not diff, f"stream is not repeatable on the card: {diff}")
    say("[stream] second run with the same seed: every integer output equal")
    summ = router.stream_summary(cfg, out)
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
    # the profiler
    timings = {}
    for label, B, W_, C_, T_, V_ in (
            ("refresh", 512, 9, 2, 32, 5),
            ("offline-C4", None, 1024, 4, 1 << 20, 5),
            ("offline-C8", None, 1024, 8, 1 << 20, 5)):
        rows, idx = make_estep_inputs(gen, B, W_, C_, T_, V_, dev)
        reps = 200 if label == "refresh" else 50
        ms = cuda_ms(lambda: ds_estep(rows, idx), reps)
        plain = cuda_ms(lambda: ds_estep_ref(rows, idx), reps)

        def many():
            for _ in range(reps):
                ds_estep(rows, idx)
        _, n_k, busy, by_name = device_profile(many)
        dev_us = sum(v for k, v in by_name.items() if "ds_estep" in k) / reps
        Bn = 1 if B is None else B
        bound, by, nbytes = estep_bound_ms(Bn, W_ * C_ + 1, C_, T_, V_)
        timings[label] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                              bound_by=by, bytes=nbytes)
        dev_txt = (f"device {dev_us:.2f} us ({bound * 1e3 / dev_us * 100:.1f}"
                   f"% of bound)" if dev_us > 0 else "device time not "
                   "measured (no device events in the profile)")
        say(f"[time] ds_estep {label} (B={Bn}, T={T_}, V={V_}, "
            f"R={W_ * C_ + 1}, C={C_}): per call {ms * 1e3:.2f} us, "
            f"{dev_txt}, plain per call {plain * 1e3:.2f} us, bound "
            f"{bound * 1e3:.3f} us ({by}, {nbytes} B); {card}")
    say(f"[time] stream {H / stream_s:.1f} ticks/s wall ({N} reps x "
        f"{cfg.n_shards} shards, refresh every {cfg.refresh_every}, first "
        f"run); {card}")
    # where the offline EM's time goes: two iterations under the profiler
    wall, n_k, busy, by_name = device_profile(
        lambda: aggregate.dawid_skene(labels, workers, mask, n_workers=W,
                                      n_classes=C, iters=2, one_coin=False,
                                      device=dev))
    if n_k:
        say(f"[profile] offline EM, 2 iterations: {wall * 1e3:.1f} ms wall "
            f"with the profiler on, {n_k} kernels, device busy "
            f"{busy / 1e3:.1f} ms; {card}")
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

    t_main = timings["refresh"]
    say(json.dumps({"kernels": [{
        "name": "ds_estep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ds_estep.cu",
        "replaces": "src/repro/kernels/ds_estep.py:58",
        "launches": stream_launches,
        "max_abs_err": errs["refresh"],
        "ms": t_main["ms"], "plain_ms": t_main["plain_ms"],
        "bound_ms": t_main["bound_ms"], "bound_by": t_main["bound_by"],
        "library_ms": None}]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
