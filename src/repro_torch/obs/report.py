"""Text dashboard over trace artifacts: ``python -m repro_torch.obs.report
artifacts/TRACE_*.jsonl`` (port of ``src/repro/obs/report.py``; the same
text for the same artifact).

Renders, per artifact: the latency-source phase table (mean / p50 / p95 /
share of total time-in-system), unicode sparklines for every activity
series, the end-of-run counters, the first-call vs later-call wallclock
table and the engine summary metrics. Pure stdlib + the parsed JSONL — no
engine imports — so it runs anywhere the artifact does.
"""
from __future__ import annotations

import argparse

BARS = "▁▂▃▄▅▆▇█"
WIDTH = 64


def sparkline(values, width: int = WIDTH) -> str:
    """Bucket-mean a series down to ``width`` chars of block glyphs."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        n = len(vals)
        vals = [sum(vals[i * n // width:(i + 1) * n // width])
                / max((i + 1) * n // width - i * n // width, 1)
                for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return BARS[0] * len(vals)
    return "".join(BARS[min(int((v - lo) / span * len(BARS)), len(BARS) - 1)]
                   for v in vals)


def _pct(hist, q: float, bin_s: float) -> float:
    """Right-edge percentile with the engines' top-bin convention: a
    percentile landing in the clipped top bin (or an empty histogram) is
    unbounded above -> inf (as ``labelstream.router._hist_percentile``)."""
    tot = sum(hist)
    if not hist or tot == 0:
        return float("inf")
    c = 0
    for idx, h in enumerate(hist):
        c += h
        if c >= q / 100.0 * tot:
            return float("inf") if idx >= len(hist) - 1 else (idx + 1) * bin_s
    return float("inf")


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        if v != v or v in (float("inf"), float("-inf")):
            return str(v)
        return f"{v:.4g}"
    return str(v)


def render(doc: dict) -> str:
    """Render one parsed artifact (``repro_torch.obs.export.read_trace``)."""
    hdr = doc["header"]
    out = [f"== trace: {hdr.get('scenario')} "
           f"[engine={hdr.get('engine')}, schema v{hdr['schema_version']}]"]

    phases = doc.get("phases", [])
    if phases:
        total = max(sum(p["sum"] for p in phases), 1e-9)
        tis = phases[0].get("total_tis", 0.0)
        out.append("\n-- latency sources (seconds; share of decomposed "
                   "time) --")
        out.append(f"{'phase':<14} {'mean':>8} {'p50':>8} {'p95':>8} "
                   f"{'share%':>7}  sat")
        for p in phases:
            n = max(p.get("count", 0.0), 1.0)
            out.append(
                f"{p['phase']:<14} {_fmt(p['sum'] / n):>8} "
                f"{_fmt(_pct(p['hist'], 50, p['bin_s'])):>8} "
                f"{_fmt(_pct(p['hist'], 95, p['bin_s'])):>8} "
                f"{100.0 * p['sum'] / total:>6.1f}%  "
                f"{'!' if p.get('hist_saturated') else ''}")
        if tis:
            out.append(f"{'(total tis)':<14} "
                       f"{_fmt(tis / max(phases[0]['count'], 1.0)):>8}")

    series = doc.get("series", [])
    if series:
        out.append(f"\n-- activity series (per {series[0]['axis']}) --")
        for s in series:
            v = s["values"]
            stats = (f"min={_fmt(min(v))} mean="
                     f"{_fmt(sum(v) / len(v))} max={_fmt(max(v))}"
                     if v else "empty")
            out.append(f"{s['name']:<14} {sparkline(v)}  [{stats}]")

    for c in doc.get("counters", []):
        kv = {k: v for k, v in c.items() if k != "kind"}
        out.append("\n-- counters --")
        out.append("  ".join(f"{k}={_fmt(v)}" for k, v in sorted(kv.items())))

    wall = [e for w in doc.get("wallclock", []) for e in w.get("entries", [])]
    if wall:
        out.append("\n-- wallclock (compile vs execute) --")
        out.append(f"{'call':<36} {'n':>3} {'cold_s':>8} {'warm_s':>8} "
                   f"{'compile_s':>9}")
        for e in wall:
            out.append(f"{e['name']:<36} {e['calls']:>3} "
                       f"{_fmt(e['cold_s']):>8} {_fmt(e['warm_s']):>8} "
                       f"{_fmt(e['compile_s']):>9}")

    for s in doc.get("summary", []):
        m = s.get("metrics", {})
        flat = {k: v for k, v in m.items() if not isinstance(v, dict)}
        if flat:
            out.append("\n-- summary metrics --")
            out.append("  ".join(f"{k}={_fmt(v)}"
                                 for k, v in sorted(flat.items())))
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render text dashboards from TRACE_*.jsonl artifacts.")
    ap.add_argument("artifacts", nargs="+", help="TRACE_*.jsonl paths")
    args = ap.parse_args(argv)
    from repro_torch.obs.export import read_trace
    for path in args.artifacts:
        print(render(read_trace(path)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
