"""One run of one cell: find its files by name, set the program up, measure
a window, check what the window produced against the plain reference, and
report.

Everything that belongs to a cell is found by name from ``BENCHMARK.json``
at the repository root:

- the cell (``workloads``) names a configuration and a traffic mix;
- the configuration's ``file`` (``perfbench/configs/<name>.json``) holds the
  configuration as it is run;
- the traffic mix is ``perfbench/traffic/<traffic>.json``, whose
  ``driver`` names the general generator that reads it
  (``perfbench/drivers/<driver>.py``);
- each metric is ``perfbench/metrics/<metric name>.py``, a reader whose
  ``read(run)`` returns the value or None when it finds nothing to read.

A driver has ``setup(run)``, ``window(run, state)`` and ``check(run,
state)``; ``run`` is the dict this module fills and the readers read.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(entries, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"{name!r} is not in BENCHMARK.json")


def cell_files(bench: dict, cell_name: str):
    """The cell's entry, its configuration (the file's contents) and its
    traffic mix (the file's contents)."""
    cell = find(bench["workloads"], cell_name)
    cfg_entry = find(bench["configs"], cell["config"])
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def driver_of(traffic: dict):
    return importlib.import_module(f"perfbench.drivers.{traffic['driver']}")


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced. An entry with ``workloads``
    names its cells; a per-layer metric without it goes wherever the
    end-to-end metric it moves is reported."""
    def has(m):
        return "workloads" not in m or cell_name in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if has(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries, run: dict) -> dict:
    out = {}
    for m in entries:
        v = reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def timed_calls(run: dict, seconds: float, call, trace_first):
    """The measured window: ``call(i)`` back to back while the window is
    open, each started before ``seconds`` have passed; the window lasts
    until the last call that started inside it ends. ``call`` returns a
    dict of what it completed. Records ``run["calls"]`` (each with
    ``t0`` / ``t1`` relative to the window's start, and ``error`` for a
    call that raised) and ``run["window_s"]``. In a traced run the device
    trace is open from the first call until ``trace_first(n, elapsed)``,
    asked after each call with the number of calls made, says no;
    ``run["traced_calls"]`` counts the calls it saw."""
    import torch
    from perfbench.profiling import Trace
    dev = torch.device(run["device"])
    calls = run["calls"] = []
    trace = Trace(dev) if run["trace"] else None
    tracing = trace is not None
    if tracing:
        # the profiler's own start-up stays outside the window
        trace.__enter__()
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds:
        t = time.perf_counter() - start
        try:
            rec = dict(call(i) or {})
        except Exception as exc:           # a failed call is counted
            rec = {"error": f"{type(exc).__name__}: {exc}"}
            print(f"call {i} failed:\n{traceback.format_exc()}",
                  file=sys.stderr)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec.update(t0=t, t1=time.perf_counter() - start)
        calls.append(rec)
        i += 1
        if tracing:
            run["traced_calls"] = i
            if not trace_first(i, rec["t1"]):
                trace.__exit__(None, None, None)
                tracing = False
    if tracing:
        trace.__exit__(None, None, None)
    run["window_s"] = calls[-1]["t1"] if calls else 0.0
    run["trace_obj"] = trace


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        lines = smi.stdout.strip().splitlines()
        return lines[0] if lines else "power limit unknown"
    except (OSError, subprocess.SubprocessError):
        return "power limit unknown"


def jax_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str, t_start: float, bench: dict = None,
            config: dict = None, traffic: dict = None,
            control: bool = False) -> dict:
    """One run of ``cell_name`` on ``device`` after the process started at
    ``t_start`` (``time.perf_counter``). ``config`` / ``traffic`` replace
    the cell's files (tests run small sizes on the CPU). With ``control``
    the driver also reads its control's numbers (``run["control"]``: the
    reference one precision down, compared as the program is). Returns the
    filled ``run`` dict with ``result``: the result line's object."""
    import torch
    bench = bench or benchmark()
    cell, cfg_file, trf_file = cell_files(bench, cell_name)
    run = dict(cell=cell, config=config or cfg_file,
               traffic=traffic or trf_file, seed=int(seed),
               seconds=float(seconds), trace=bool(trace), device=device)
    drv = driver_of(run["traffic"])
    cuda = torch.device(device).type == "cuda"
    state = drv.setup(run)
    if cuda:
        torch.cuda.synchronize()
        # the window's peak: what set-up built and dropped is not held
        torch.cuda.reset_peak_memory_stats()
    run["setup_s"] = time.perf_counter() - t_start
    drv.window(run, state)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = run.pop("trace_obj", None)
    if tr is not None:
        run["kernels"] = tr.kernels
        run["traced_wall_s"] = tr.wall_s
        run["busy_s"] = tr.busy_s()
    run["jax_after_window"] = jax_modules()
    checks = drv.check(run, state)
    if control:
        run["control"] = drv.control(run, state)
    del state
    failed = sum(1 for c in run["calls"] if "error" in c)
    correct = (failed == 0 and bool(run["calls"])
               and all(c["value"] <= c["limit"] for c in checks.values()))
    entries = metrics_of(bench, cell_name, trace)
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": (torch.cuda.get_device_name(0) if cuda else "cpu"),
                "count": int(cell["chips"]),
                "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(run["calls"]),
              "failed": failed, "metrics": read_metrics(entries, run),
              "device": dev_info}
    if trace:
        dev_info["busy_s"] = run.get("busy_s", 0.0)
        dev_info["window_s"] = run.get("traced_wall_s", 0.0)
        from perfbench.profiling import breakdown
        result["breakdown"] = breakdown(run.get("kernels", []))
    dev_info["card"] = card_line() if cuda else "cpu"
    result["checks"] = checks
    run["result"] = result
    return run


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    bench = benchmark()
    chips = int(find(bench["workloads"], args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    run = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  "cuda", t_start, bench)
    found = sorted(set(run["jax_after_window"]) | set(jax_modules()))
    if found:
        print(f"the run loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    res = run["result"]
    dur = [c["t1"] - c["t0"] for c in run["calls"]]
    if dur:
        print(f"calls {len(dur)} in {run['window_s']:.3f} s: first "
              f"{dur[0]:.3f} s, median {sorted(dur)[len(dur) // 2]:.3f} s, "
              f"last {dur[-1]:.3f} s; set-up {run['setup_s']:.3f} s",
              file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0
