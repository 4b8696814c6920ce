"""Load sweeps of the labeling stream, back to back.

A call is one batched sweep of the configuration's scenario over the
offered rates the traffic file lists (log-spaced multiples of the
scenario's own rate), ``n_reps`` replications each, ``horizon`` ticks: the
program's ``scenarios.sweep(spec, "arrivals.rate", ...)``, or, where the
configuration names an encoder, ``labelstream.run_stream_sweep(...,
bank=)`` on the bank that encoder built in set-up and the same per-point
summaries. Each call has a seed of its own, derived from the run's.

The check reruns sampled replications (one or more a rate, each from a
call drawn from the seed) in the CPU copy of the tick
(``perfbench.reference.stream``), from start states and arrivals it
draws from the call's seed itself, and compares every output of those
rows: integers exactly, floats by their largest relative gap. It also
counts, over the sampled rows of every call, the rows whose outputs break
a law of the stream (:func:`invariant_breaks`), read from the outputs
alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json

import numpy as np
import torch

from perfbench.harness import timed_calls

_MASK = (1 << 63) - 1


def call_seed(seed: int, i: int) -> int:
    """The seed of the window's call ``i`` (set-up's warm-up is -1)."""
    return (int(seed) * 1_000_003 + 7919 * (i + 1)) & _MASK


def rate_values(base: float, rates: dict) -> list:
    """The offered rates: ``n`` multiples of ``base`` from ``lo_x`` to
    ``hi_x``, log-spaced."""
    x = np.geomspace(rates["lo_x"], rates["hi_x"], rates["n"])
    return [float(base * v) for v in x]


def _plain(obj):
    return json.loads(json.dumps(obj))


def _departures(got, stated, prefix=""):
    """The dotted keys of ``stated`` (nested groups included) whose value
    ``got`` does not hold; keys ``got`` has beyond them are not looked at."""
    out = []
    for k, v in stated.items():
        if isinstance(v, dict) and isinstance(got.get(k), dict):
            out += _departures(got[k], v, f"{prefix}{k}.")
        elif k not in got or got[k] != v:
            out.append(prefix + k)
    return out


def check_config(cfg, stated: dict):
    """Raise where the program's lowered configuration departs from a
    field the configuration file states."""
    diff = sorted(_departures(_plain(dataclasses.asdict(cfg)), stated))
    if diff:
        raise ValueError(f"the program's configuration departs from the "
                         f"file in {diff}")


def flat(out, prefix="") -> dict:
    """A sweep's tensors as one flat dict (nested series under dotted
    names); the floats ``warmup_t`` / ``measured_s`` are left out."""
    res = {}
    for k, v in out.items():
        if isinstance(v, dict):
            res.update(flat(v, f"{prefix}{k}."))
        elif torch.is_tensor(v):
            res[prefix + k] = v
    return res


def _slice_point(raw, i):
    if isinstance(raw, dict):
        return {k: v if not isinstance(v, (dict,)) and not torch.is_tensor(v)
                else _slice_point(v, i) for k, v in raw.items()}
    return raw[i]


def setup(run: dict) -> dict:
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.compile import to_stream_config
    conf, trf = run["config"], run["traffic"]
    spec = get_scenario(conf["scenario"], conf.get("overrides") or None)
    cfg = to_stream_config(spec)
    check_config(cfg, conf["stream_config"])
    values = rate_values(spec.arrivals.rate, trf["rates"])
    st = dict(spec=spec, cfg=cfg, values=values, bank=None, samples=[])
    if conf.get("encoder"):
        from perfbench.drivers.encode_requests import build_bank
        st["bank"], st["bank_check"] = build_bank(run, cfg)
    _sweep(run, st, -1, trf["warmup_horizon"])
    return st


def _sweep(run, st, i, horizon):
    """One sweep call; returns the raw ``(V, n_reps, ...)`` outputs and the
    per-point summaries."""
    trf, cfg = run["traffic"], st["cfg"]
    kw = dict(n_reps=trf["n_reps"], seed=call_seed(run["seed"], i),
              warmup_frac=trf["warmup_frac"], device=run["device"])
    if st["bank"] is None:
        from repro_torch.scenarios import sweep
        res = sweep(st["spec"], "arrivals.rate", st["values"],
                    engine="stream", horizon=horizon, **kw)
        return res["raw"], res["results"]
    from repro_torch.labelstream import run_stream_sweep, stream_summary
    base = st["spec"].arrivals.rate
    raw = run_stream_sweep(cfg, horizon, [v / base for v in st["values"]],
                           bank=st["bank"], **kw)
    return raw, [stream_summary(cfg, _slice_point(raw, p))
                 for p in range(len(st["values"]))]


def _sample_rows(run: dict, i: int) -> list:
    """The (point, replication) rows of call ``i`` that the check may
    rerun, drawn from the run's seed."""
    trf = run["traffic"]
    rng = np.random.default_rng([run["seed"] & _MASK, i, 1])
    k = trf["check"]["rows_per_point"]
    return [(p, int(r)) for p in range(trf["rates"]["n"])
            for r in rng.choice(trf["n_reps"], size=k, replace=False)]


def window(run: dict, st: dict):
    trf = run["traffic"]
    H, V, N = trf["horizon"], trf["rates"]["n"], trf["n_reps"]
    shapes = run["estep_shapes"] = []
    agg = orig = None
    if run["trace"]:
        # the E-step's shapes while traced, for its roofline
        from repro_torch.labelstream import aggregate as agg
        orig = agg.ds_estep

        def counted(rows, idx, **kw):
            if len(shapes) < 100_000:
                B = rows.shape[0] if rows.dim() == 3 else 1
                shapes.append((B,) + tuple(rows.shape[-2:])
                              + tuple(idx.shape[-2:]))
            return orig(rows, idx, **kw)
        agg.ds_estep = counted

    def call(i):
        raw, results = _sweep(run, st, i, H)
        rows = _sample_rows(run, i)
        p = torch.tensor([r[0] for r in rows])
        r = torch.tensor([r[1] for r in rows])
        st["samples"].append({k: v[p.to(v.device), r.to(v.device)].cpu()
                              for k, v in flat(raw).items()})
        if len(results) != V:
            raise RuntimeError(f"sweep returned {len(results)} points")
        return {"rep_ticks": V * N * H, "ticks": H}

    trace_calls = trf.get("trace_calls", 1)
    try:
        timed_calls(run, run["seconds"], call,
                    lambda done, _t: done < trace_calls)
    finally:
        if orig is not None:
            agg.ds_estep = orig
    run["ticks_traced"] = H * min(trace_calls, len(run["calls"]))
    run["estep_shapes_traced"] = shapes[:]


def _reference_rows(run: dict, st: dict, picks: list, low: bool = False):
    """The reference's outputs for ``picks`` ((call, point, replication)
    triples), in that order: each row's start state and arrivals drawn from
    its call's seed as the program draws them (the arrivals on the run's
    device, whose generator the program used), then one CPU run of every
    row, one precision down with ``low``."""
    from perfbench.reference.stream import router as ref
    from perfbench.reference.stream.config import stream_config
    from perfbench.reference.stream.precision import lower_precision
    trf = run["traffic"]
    cfg = stream_config(run["config"]["stream_config"])
    H, N = trf["horizon"], trf["n_reps"]
    base = cfg.arrivals.rate
    values = rate_values(base, trf["rates"])
    draws = []
    inits = {}
    for c, p, r in picks:
        seed = call_seed(run["seed"], c)
        if seed not in inits:
            inits[seed] = ref.draw_init(cfg, N, seed)
        ws, banks, seeds = inits[seed]
        sub = lambda d: {k: v[r:r + 1] for k, v in d.items()}
        n_new, n_arr = ref.draw_arrivals(
            cfg, H, N, seed=seed, rate_scale=values[p] / base,
            device=run["device"])
        draws.append(((sub(ws), sub(banks), seeds[r:r + 1]),
                      (n_new[:, r:r + 1].cpu(), n_arr[:, r:r + 1].cpu())))
    bank = None if st["bank"] is None else st["bank"].cpu()
    with lower_precision() if low else contextlib.nullcontext():
        out = ref.run_rows(cfg, H, draws, warmup_frac=trf["warmup_frac"],
                           bank=bank)
    return flat(out)


def compare(got: dict, want: dict) -> dict:
    """``int_mismatch``: integer elements that differ (and keys missing on
    either side); ``float_gap``: the largest gap of a float output over
    the largest magnitude of that output in the reference."""
    mism, gap = 0, 0.0
    for k in set(got) | set(want):
        if k not in got or k not in want or got[k].shape != want[k].shape:
            mism += 1
            continue
        a, b = got[k], want[k]
        if a.is_floating_point():
            a, b = a.double(), b.double()
            d = (a - b).abs()
            d = torch.where(torch.isnan(a) & torch.isnan(b),
                            torch.zeros_like(d), d)
            d = torch.where(torch.isnan(d), torch.full_like(d, np.inf), d)
            if d.numel():
                scale = float(b.nan_to_num().abs().max())
                gap = max(gap, float(d.max()) / scale if scale > 0
                          else float(d.max()))
        else:
            mism += int((a != b).sum())
    return {"int_mismatch": float(mism), "float_gap": float(gap)}


def picks_of(run: dict, st: dict) -> list:
    """One (call, point, replication) a rate per sampled row: each point's
    call drawn from the seed among the window's calls, its replication
    among that call's sampled rows."""
    n_calls = len(st["samples"])
    rng = np.random.default_rng([run["seed"] & _MASK, 2])
    out = []
    for j, (p, r) in enumerate(_sample_rows(run, 0)):
        c = int(rng.integers(n_calls))
        out.append((c, p, _sample_rows(run, c)[j][1]))
    return out


def program_rows(run: dict, st: dict, picks: list) -> dict:
    """The program's outputs of the rows ``picks``, stacked in their
    order (each call kept its sampled rows in ``_sample_rows`` order)."""
    maps = [{pr: j for j, pr in enumerate(_sample_rows(run, c))}
            for c in range(len(st["samples"]))]
    return {k: torch.stack([st["samples"][c][k][maps[c][(p, r)]]
                            for c, p, r in picks])
            for k in st["samples"][0]}


def invariant_breaks(rows: dict, votes_cap: int) -> int:
    """How many (row, law) pairs break a law that every replication's
    outputs keep whatever the tick computes, read from the outputs alone:
    every arrival is finalized, queued, in flight or counted dropped; the
    per-tick series add up to the totals and end at the final backlog and
    window; the histogram counts the warm finalized tasks; the warm
    finalized tasks are no more than all finalized ones, and their correct,
    model-known and votes counts fit inside them."""
    s = lambda k: rows[k].long()
    laws = [
        s("arrived") == s("dropped") + s("done_all") + s("backlog_end")
        + s("in_flight_end"),
        s("series.arrivals").sum(-1) == s("arrived"),
        s("series.finalized").sum(-1) == s("done_all"),
        s("series.backlog")[:, -1] == s("backlog_end"),
        s("series.in_flight")[:, -1] == s("in_flight_end"),
        s("per_shard.backlog_end").sum(-1) == s("backlog_end"),
        s("per_shard.in_flight_end").sum(-1) == s("in_flight_end"),
        s("hist").sum(-1) == s("done"),
        (s("done") <= s("done_all")) & (s("arrived_warm") <= s("arrived")),
        (s("correct") >= 0) & (s("correct") <= s("done")),
        (s("model_known") >= 0) & (s("model_known") <= s("done")),
        (s("votes_fin") >= 0) & (s("votes_fin") <= votes_cap * s("done")),
    ]
    return int(sum(int((~ok).sum()) for ok in laws))


def check(run: dict, st: dict) -> dict:
    limits = run["config"]["limits"]
    checks = {}
    if st.get("bank_check") is not None:
        from perfbench.drivers.encode_requests import check_bank
        checks.update(check_bank(run, st))
    names = ("int_mismatch", "float_gap", "invariant_breaks")
    if not st["samples"]:
        return dict(checks, **{k: {"value": float("inf"), "limit": limits[k]}
                               for k in names})
    cap = run["config"]["stream_config"]["policy"]["votes_cap"]
    every = {k: torch.cat([smp[k] for smp in st["samples"]])
             for k in st["samples"][0]}
    broken = invariant_breaks(every, cap)
    picks = picks_of(run, st)
    got = program_rows(run, st, picks)
    if run["device"] != "cpu":
        torch.cuda.empty_cache()
    want = st["reference"] = _reference_rows(run, st, picks)
    values = dict(compare(got, want), invariant_breaks=float(broken))
    for k in names:
        checks[k] = {"value": values[k], "limit": limits[k]}
    return checks


def control(run: dict, st: dict) -> dict:
    """The control's numbers: the reference with bfloat16 operands in the
    program's place, on the rows the check compared (and, with a bank,
    the encoder stage's control)."""
    out = {}
    if st.get("bank_check") is not None:
        from perfbench.drivers.encode_requests import check_bank
        out.update({k: v["value"]
                    for k, v in check_bank(run, st, fp8=True).items()})
    low = _reference_rows(run, st, picks_of(run, st), low=True)
    cap = run["config"]["stream_config"]["policy"]["votes_cap"]
    out.update(compare(low, st["reference"]),
               invariant_breaks=float(invariant_breaks(low, cap)))
    return out
