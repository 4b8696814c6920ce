"""Trace-artifact export: facade run output -> versioned JSON-lines (port of
``src/repro/obs/export.py``; the same schema and line kinds, so each
package's :func:`read_trace` reads the other's artifacts).

The artifact is a flat ``TRACE_<name>.jsonl`` written to ``$BENCH_DIR``
(default ``artifacts``), one self-describing dict per line keyed by
``kind``:

  * ``header``    — schema_version / engine / scenario (always line 1)
  * ``phases``    — one line per latency phase: pooled histogram + sum
                    (the paper Table-1-style latency-source decomposition)
  * ``series``    — one line per per-tick/-batch activity series, reduced
                    across replications (counts sum, gauges average)
  * ``counters``  — end-of-run scalar totals
  * ``summary``   — the engine's summary metrics verbatim
  * ``wallclock`` — first-call vs later-call wall-clock from
                    ``repro_torch.obs.timing``

``python -m repro_torch.obs.export <scenario> [--device cpu]`` runs a
trace-enabled scenario twice (the first call pays the kernel build and the
device warm-up, which the wallclock section splits out) and writes the
artifact; ``repro_torch.obs.report`` renders it. The engines' tensors are
read back to the host once, by :func:`trace_doc`.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch.obs import timing
from repro_torch.obs.trace import PHASES

SCHEMA_VERSION = 1

#: histogram geometry for the events engine's host-side recorder (the
#: batched engines bin with their own cfg.tis_bin_s/tis_bins)
EVENTS_BIN_S = 8.0
EVENTS_BINS = 128

#: series reduced across replications by MEAN (instantaneous gauges /
#: scores); everything else is an event count and sums
_MEAN_SERIES = frozenset({
    "backlog", "in_flight", "busy_workers", "idle_workers", "adm_score",
    "trace_batch_end",
})

#: simfast per-batch counters carried as CUMULATIVE snapshots in the
#: per-batch output; the exporter diffs them into per-batch deltas
_CUMULATIVE = frozenset({
    "trace_assigned", "trace_dups", "trace_churned", "trace_evicted",
})


def _series_line(name: str, arr, *, axis: str) -> dict:
    """Reduce a (n_reps, N) series across replications into one line."""
    a = np.asarray(arr, dtype=np.float64)
    if a.ndim == 1:
        a = a[None]
    reduce = "mean" if name in _MEAN_SERIES else "sum"
    red = a.mean(0) if reduce == "mean" else a.sum(0)
    return dict(kind="series", name=name, axis=axis, reduce=reduce,
                values=[float(x) for x in red])


def _phase_line(pk: str, hist, total: float, *, bin_s: float, count: float,
                total_tis: float) -> dict:
    hist = np.asarray(hist)
    return dict(kind="phases", phase=pk, hist=[int(x) for x in hist],
                sum=float(total), bin_s=float(bin_s), count=float(count),
                total_tis=float(total_tis),
                hist_saturated=bool(hist.size and hist[-1] > 0))


def _stream_lines(res: dict) -> list:
    cfg, raw = res["config"], res["raw"]
    out = []
    done = float(np.asarray(raw["done"]).sum())
    if "ph_backlog_wait" in raw:
        total_tis = float(np.asarray(raw["sum_tis"]).sum())
        for pk in PHASES:
            ph = np.asarray(raw["ph_" + pk])
            out.append(_phase_line(
                pk, ph.reshape(-1, ph.shape[-1]).sum(0),
                float(np.asarray(raw["ps_" + pk]).sum()),
                bin_s=cfg.tis_bin_s, count=done, total_tis=total_tis))
    for name in sorted(raw.get("series", {})):
        out.append(_series_line(name, raw["series"][name], axis="tick"))
    out.append(dict(
        kind="counters", engine="stream",
        n_reps=int(np.asarray(raw["done"]).shape[0]),
        done=done,
        arrived=float(np.asarray(raw["arrived"]).sum()),
        dropped=float(np.asarray(raw["dropped"]).sum()),
        stolen=float(np.asarray(raw["stolen"]).sum()),
        donated=float(np.asarray(raw["donated"]).sum()),
        n_churned=float(np.asarray(raw["n_churned"]).sum()),
        n_evicted=float(np.asarray(raw["n_evicted"]).sum()),
    ))
    return out


def _simfast_lines(res: dict) -> list:
    raw = res["raw"]
    out = []
    for name in sorted(k for k in raw if k.startswith("trace_")):
        a = np.asarray(raw[name], dtype=np.float64)
        if name in _CUMULATIVE:
            a = np.diff(a, axis=-1, prepend=0.0)
        out.append(_series_line(name, a, axis="batch"))
    counters = dict(
        kind="counters", engine="simfast",
        n_reps=int(np.asarray(raw["done"]).shape[0]),
        done=float(np.asarray(raw["done"]).sum()),
        n_churned=float(np.asarray(raw["n_churned"]).sum()),
        n_evicted=float(np.asarray(raw["n_evicted"]).sum()),
        total_time=float(np.asarray(raw["total_time"]).mean()),
    )
    for name in ("trace_assigned", "trace_dups"):
        if name in raw:
            # last cumulative snapshot = whole-run total, summed over reps
            counters[name.replace("trace_", "")] = float(
                np.asarray(raw[name], dtype=np.float64)[..., -1].sum())
    out.append(counters)
    return out


def _events_lines(res: dict) -> list:
    rec = res.get("events_trace")
    if rec is None:
        return []
    out = []
    total_tis = sum(t["completed_at"] - t["created_at"] for t in rec.tasks)
    for pk, d in rec.phase_hists(EVENTS_BIN_S, EVENTS_BINS).items():
        out.append(_phase_line(pk, d["hist"], d["sum"], bin_s=EVENTS_BIN_S,
                               count=len(rec.tasks), total_tis=total_tis))
    for name in ("n_tasks", "mean_latency", "votes"):
        out.append(_series_line(
            name, np.asarray([[b[name] for b in rec.batches]]), axis="batch"))
    out.append(dict(
        kind="counters", engine="events",
        n_tasks=len(rec.tasks), n_batches=len(rec.batches),
        votes=sum(t["n_votes"] for t in rec.tasks),
        assignments=sum(t["n_assignments"] for t in rec.tasks),
        correct=sum(1 for t in rec.tasks if t["correct"]),
    ))
    return out


def _jsonable(v):
    """Recursively coerce numpy scalars/arrays into JSON-native values."""
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, np.ndarray):
        return [_jsonable(x) for x in v.tolist()]
    if isinstance(v, (np.floating, np.integer, np.bool_)):
        return v.item()
    return v


def _host(v):
    """A result's tensors (nested in dicts) as numpy arrays."""
    if isinstance(v, dict):
        return {k: _host(x) for k, x in v.items()}
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return v


def trace_doc(res: dict) -> list:
    """Build the artifact lines from a ``repro_torch.scenarios.run`` result
    dict (any engine). The first line is always the schema header."""
    res = dict(res, raw=_host(res["raw"])) if "raw" in res else res
    engine = res["engine"]
    lines = [dict(kind="header", schema_version=SCHEMA_VERSION,
                  engine=engine, scenario=res.get("scenario"))]
    if engine == "stream":
        lines += _stream_lines(res)
    elif engine == "simfast":
        lines += _simfast_lines(res)
    elif engine == "events":
        lines += _events_lines(res)
    else:
        raise ValueError(f"trace_doc: unknown engine {engine!r}")
    lines.append(dict(kind="summary",
                      metrics=_jsonable(res.get("metrics", {}))))
    lines.append(dict(kind="wallclock", entries=timing.summary()))
    return lines


def write_trace(lines: list, *, path: str = None, directory: str = None,
                name: str = None) -> str:
    """Write artifact ``lines`` as JSONL; default path is
    ``$BENCH_DIR/TRACE_<scenario>.jsonl`` next to the BENCH artifacts."""
    if path is None:
        directory = directory or os.environ.get("BENCH_DIR", "artifacts")
        if name is None:
            hdr = lines[0] if lines else {}
            name = hdr.get("scenario") or hdr.get("engine") or "trace"
        path = os.path.join(directory, f"TRACE_{name}.jsonl")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        for ln in lines:
            f.write(json.dumps(ln, sort_keys=True) + "\n")
    return path


def read_trace(path: str) -> dict:
    """Parse + validate a trace artifact. Returns ``{"header": <line1>,
    "<kind>": [lines...]}`` for every other kind present."""
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    if not lines or lines[0].get("kind") != "header":
        raise ValueError(f"{path}: not a trace artifact (first line must "
                         "be kind='header')")
    sv = lines[0].get("schema_version")
    if sv != SCHEMA_VERSION:
        raise ValueError(f"{path}: schema_version {sv!r} != "
                         f"{SCHEMA_VERSION} (regenerate the artifact)")
    doc = {"header": lines[0]}
    for ln in lines[1:]:
        doc.setdefault(ln.get("kind", "?"), []).append(ln)
    return doc


def grid_doc(res: dict) -> list:
    """Build ``GRID_<name>.jsonl`` artifact lines from a
    :func:`repro_torch.grid.run_grid` result dict (the reference's schema).
    Same JSONL-with-header shape as the trace artifact, tagged
    ``artifact='grid'``: one ``class`` line per static-config class (its
    ``execute_s``; ``compile_s`` is null, the port compiles nothing), one
    ``cell`` line per grid cell (axis values + scalar summary metrics),
    and a trailing ``summary`` line with the total wall-clock."""
    lines = [dict(kind="header", schema_version=SCHEMA_VERSION,
                  artifact="grid", name=res["name"], engine=res["engine"],
                  axes=_jsonable(res["axes"]), n_cells=res["n_cells"],
                  n_classes=res["n_classes"])]
    for c in res["classes"]:
        lines.append(dict(kind="class", **_jsonable(c)))
    for c in res["cells"]:
        lines.append(dict(kind="cell", idx=c["idx"],
                          class_id=c["class_id"],
                          values=_jsonable(c["values"]),
                          metrics=_jsonable(c["metrics"])))
    lines.append(dict(kind="summary", wallclock_s=res["wallclock_s"]))
    return lines


def write_grid(lines: list, *, path: str = None, directory: str = None,
               name: str = None) -> str:
    """Write grid-artifact ``lines``; default path is
    ``$BENCH_DIR/GRID_<name>.jsonl``."""
    if path is None:
        directory = directory or os.environ.get("BENCH_DIR", "artifacts")
        if name is None:
            name = (lines[0].get("name") if lines else None) or "grid"
        path = os.path.join(directory, f"GRID_{name}.jsonl")
    return write_trace(lines, path=path)


def read_grid(path: str) -> dict:
    """Parse + validate a grid artifact. Returns ``{"header": <line1>,
    "class": [...], "cell": [...], "summary": [...]}``."""
    doc = read_trace(path)
    hdr = doc["header"]
    if hdr.get("artifact") != "grid":
        raise ValueError(f"{path}: not a grid artifact (header artifact="
                         f"{hdr.get('artifact')!r})")
    n_cells = hdr.get("n_cells")
    got = len(doc.get("cell", []))
    if got != n_cells:
        raise ValueError(f"{path}: header says {n_cells} cells but the "
                         f"artifact carries {got} cell lines")
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.export",
        description="Run a trace-enabled scenario and write its "
                    "TRACE_<name>.jsonl artifact.")
    ap.add_argument("scenario", help="registered scenario name "
                                     "(repro_torch.scenarios."
                                     "list_scenarios)")
    ap.add_argument("--engine", default=None,
                    help="events | simfast | stream (default: "
                         "scenario's preferred engine)")
    ap.add_argument("--horizon", type=int, default=240,
                    help="stream horizon in ticks (default 240)")
    ap.add_argument("--n-reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate-scale", type=float, default=1.0)
    ap.add_argument("--out", default=None, help="output path override")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) | cpu")
    args = ap.parse_args(argv)

    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.facade import _resolve_engine, run

    spec = get_scenario(args.scenario, {"trace.enabled": True})
    engine = _resolve_engine(spec, args.engine)
    kw = dict(engine=engine, seed=args.seed, n_reps=args.n_reps,
              device=args.device)
    if engine == "stream":
        kw.update(horizon=args.horizon, rate_scale=args.rate_scale)
    label = f"run[{args.scenario}/{engine}]"
    # a first call, so the wallclock section can split the one-time cost
    # (kernel build, device warm-up) from a later call's
    timing.timeit(label, run, spec, **kw)
    res, _ = timing.timeit(label, run, spec, **kw)
    # the doc built inside run() predates the timing record for that very
    # call — rebuild so the wallclock section sees both entries
    path = write_trace(trace_doc(res), path=args.out, name=args.scenario)
    print(f"# wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
