"""The port's traces against the JAX package's: the stream tick's
latency-source buffers and per-tick series, the batch engine's per-batch
counters, the trace artifact (``obs.export``) and its text report
(``obs.report``).

Parity with injected draws (the harness of ``tests/test_torch_stream.py``):
the reference's initial state and arrivals are handed to the port, so every
phase histogram, integer series and ``trace_*`` counter must be equal and
every phase sum (``ps_*``) and float series within rtol 1e-5. Within the
port, tracing observes and never perturbs: a traced run equals the untraced
run on every shared key, bit for bit. Reference calls run inside
``jax.threefry_partitionable(False)``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import simfast as js  # noqa: E402
from repro.labelstream import router as jr  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs.trace import TraceConfig as JTraceConfig  # noqa: E402
from repro.scenarios import get_scenario as jget  # noqa: E402
from repro.scenarios.compile import (  # noqa: E402
    to_fast_config as jfast, to_serve_config as jserve,
)
from repro_torch import scenarios as T  # noqa: E402
from repro_torch.core import simfast as ts  # noqa: E402
from repro_torch.core.simfast_stats import summarize  # noqa: E402
from repro_torch.labelstream import router as tr  # noqa: E402
from repro_torch.labelstream.arrivals import ArrivalConfig  # noqa: E402
from repro_torch.labelstream.routing import RoutingConfig  # noqa: E402
from repro_torch.obs import export as texport  # noqa: E402
from repro_torch.obs import report as treport  # noqa: E402
from repro_torch.obs.trace import PHASES, TraceConfig  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    get_fast_config, get_stream_config,
)
from test_torch_batch_engine import _ref_draws as _ref_batch_draws  # noqa
from test_torch_stream import (  # noqa: E402
    REFRESH, _assert_outputs_match, _ref_cfg, _ref_draws,
)
from test_torch_stream_learner import _ref_overrides  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
H, N, SEED = 120, 2, 3
LEARNABLE = {"routing": RoutingConfig(enabled=True,
                                      admission="uncertain_learnable")}
# stream_sharded at 20x its rate: backlogs build, so shards steal
LOADED = {"arrivals": ArrivalConfig(kind="poisson", rate=0.8)}
WORKLOADS = [("heterogeneous_pool", None), ("skewed_adaptive5", REFRESH),
             ("chance_hard", LEARNABLE), ("stream_sharded", LOADED)]
IDS = ["heterogeneous_pool", "skewed_adaptive5-refresh",
       "chance_hard-uncertain_learnable", "stream_sharded-20x"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traced(cfg, trace):
    return dataclasses.replace(cfg, trace=trace)


def _assert_summary_close(got, want, path=""):
    assert got.keys() == want.keys(), path
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_summary_close(g, w, f"{path}{k}.")
        elif isinstance(w, float) and math.isfinite(w):
            assert g == pytest.approx(w, rel=1e-5), path + k
        else:
            assert g == w, path + k


def _same_tensors(a, b, path=""):
    """Every tensor key of ``a`` is in ``b`` with identical bits."""
    for k, v in a.items():
        if isinstance(v, dict):
            _same_tensors(v, b[k], f"{path}{k}.")
        elif torch.is_tensor(v):
            assert torch.equal(v, b[k]), path + k


def _stream_pair(name, overrides):
    """The reference's traced run and the port's, on the reference's
    draws; returns ``(jcfg, want, cfg, got)``."""
    jcfg = _traced(_ref_cfg(name, _ref_overrides(overrides)), JTraceConfig())
    with jax.threefry_partitionable(False):
        want = jr.run_stream(jcfg, H, n_reps=N, seed=SEED)
        ws, banks, seeds, n_new, n_arr = _ref_draws(jcfg, H, N, SEED)
    want = jax.tree_util.tree_map(np.asarray, dict(want))
    cfg = _traced(get_stream_config(name, overrides), TraceConfig())
    init = tr.state_from_numpy(cfg, ws, banks, seeds, "cpu")
    got = tr.run_stream(cfg, H, n_reps=N, device="cpu", init=init,
                        arrivals=(n_new, n_arr))
    return jcfg, want, cfg, got


@pytest.mark.parametrize("name,overrides", WORKLOADS, ids=IDS)
def test_trace_matches_reference_with_injected_draws(name, overrides):
    jcfg, want, cfg, got = _stream_pair(name, overrides)
    assert int(want["done"].sum()) > 0
    for pk in PHASES:
        assert "ph_" + pk in got and "ps_" + pk in got
    series = {"votes", "busy_workers", "idle_workers", "dropped", "stolen",
              "donated"}
    if cfg.routing.admission != "fifo":
        series.add("adm_score")
        assert float(want["series"]["adm_score"].sum()) > 0
    assert series <= set(got["series"]) and series <= set(want["series"])
    # the learnability head's entries near zero carry the run's rounding
    # in absolute terms: held at rtol 1e-5 of its largest entry, as in
    # tests/test_torch_stream_learner.py
    for k in ("learn2_W", "learn2_b"):
        if k in want:
            w, g = want.pop(k), got.pop(k).numpy()
            scale = np.abs(w).max(axis=tuple(range(1, w.ndim)),
                                  keepdims=True)
            assert (np.abs(g - w) <= 1e-5 * scale).all(), k
    _assert_outputs_match(got, want)
    _assert_summary_close(tr.stream_summary(cfg, got),
                          jr.stream_summary(jcfg, want))
    if overrides is LOADED:
        assert int(want["series"]["stolen"].sum()) > 0
        np.testing.assert_array_equal(got["series"]["stolen"].sum(-1),
                                      got["series"]["donated"].sum(-1))


@pytest.mark.parametrize("name,overrides", WORKLOADS, ids=IDS)
def test_traced_run_equals_untraced_and_phases_add_up(name, overrides):
    """Tracing observes, never perturbs: on the port's own draws every key
    of the untraced run is in the traced run with the same bits, and
    backlog wait + window wait + work time = the summed time in system
    (finalize lag overlaps the tail)."""
    cfg = get_stream_config(name, overrides)
    base = tr.run_stream(cfg, H, n_reps=N, seed=SEED, device="cpu")
    traced = tr.run_stream(_traced(cfg, TraceConfig()), H, n_reps=N,
                           seed=SEED, device="cpu")
    _same_tensors(base, traced)
    s = sum(float(traced["ps_" + pk].sum())
            for pk in ("backlog_wait", "window_wait", "work_time"))
    tis = float(traced["sum_tis"].sum())
    assert tis > 0
    assert abs(s - tis) <= 1e-3 * max(tis, 1.0), (s, tis)
    done = int(traced["done"].sum())
    for pk in PHASES:
        assert int(traced["ph_" + pk].sum()) == done, pk
    assert set(base) | {"ph_" + pk for pk in PHASES} \
        | {"ps_" + pk for pk in PHASES} == set(traced)
    m = tr.stream_summary(cfg, traced)
    assert set(m["phases"]) == set(PHASES)
    for pk in PHASES:
        assert set(m["phases"][pk]) == {"mean", "p50", "p95",
                                        "hist_saturated"}
        assert m["phases"][pk]["mean"] >= 0.0


def test_trace_partial_modes():
    cfg = get_stream_config("heterogeneous_pool")
    phases = tr.run_stream(_traced(cfg, TraceConfig(per_tick=False)), 40,
                           n_reps=1, device="cpu")
    assert "ph_backlog_wait" in phases and "votes" not in phases["series"]
    ticks = tr.run_stream(_traced(cfg, TraceConfig(phases=False)), 40,
                          n_reps=1, device="cpu")
    assert "ph_backlog_wait" not in ticks and "votes" in ticks["series"]
    with pytest.raises(ValueError, match="phases/per_tick"):
        TraceConfig(phases=False, per_tick=False)
    assert T.to_stream_config(T.get_scenario(
        "heterogeneous_pool", {"trace.enabled": True,
                               "trace.per_tick": False})).trace \
        == TraceConfig(per_tick=False)


def test_hist_saturated_flags_clipped_histogram():
    """A 2-bin 1-second histogram clips everything into the top bin: the
    flag fires and the top-bin percentile reports inf."""
    res = T.run(T.get_scenario("heterogeneous_pool",
                               {"trace.enabled": True, "engine.tis_bins": 2,
                                "engine.tis_bin_s": 1.0}),
                engine="stream", horizon=80, n_reps=1, seed=0, device="cpu")
    assert res["metrics"]["hist_saturated"] is True
    assert res["metrics"]["p50_tis"] == float("inf")
    assert any(p["hist_saturated"] for p in res["metrics"]["phases"].values())


# ---- the batch engine's counters -----------------------------------------

def test_simfast_trace_matches_reference_with_injected_draws():
    rc = dataclasses.replace(jfast(jget("smallR1")), trace=JTraceConfig())
    labels = np.random.default_rng(3).integers(0, rc.n_classes, rc.n_tasks)
    with jax.threefry_partitionable(False):
        want = {k: np.asarray(v) for k, v in js.simulate(
            rc, 3, seed=SEED, true_labels=labels, shard=False).items()}
        draws = _ref_batch_draws(rc, 3, SEED)
    assert "tr_assigned" in draws["ws"]
    cfg = dataclasses.replace(get_fast_config("smallR1"),
                              trace=TraceConfig())
    got = ts.simulate(cfg, 3, true_labels=labels, device="cpu", draws=draws)
    keys = sorted(k for k in want if k.startswith("trace_"))
    assert keys == sorted(k for k in got if k.startswith("trace_"))
    assert len(keys) == 8
    for k in keys:
        g = got[k].numpy()
        assert g.shape == want[k].shape, k
        if k in ("trace_batch_end", "trace_votes"):
            # batch end times carry the latency draws' last-bit libm
            # differences (tests/test_torch_batch_engine.py)
            np.testing.assert_allclose(g, want[k], rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, want[k], err_msg=k)
    assert int(got["trace_done"].sum()) == int(got["done"].sum())
    assert (got["trace_dups"][:, -1] > 0).all()


def test_simfast_traced_run_equals_untraced():
    cfg = get_fast_config("smallR1")
    base = ts.simulate(cfg, 3, seed=0, device="cpu")
    traced = ts.simulate(dataclasses.replace(cfg, trace=TraceConfig()), 3,
                         seed=0, device="cpu")
    _same_tensors(base, traced)
    nb = cfg.n_batches
    for k in ("trace_ticks", "trace_votes", "trace_done", "trace_assigned",
              "trace_dups", "trace_churned", "trace_evicted",
              "trace_batch_end"):
        assert tuple(traced[k].shape) == (3, nb), k
    assert torch.equal(traced["trace_ticks"], traced["n_ticks"])
    ends = traced["trace_batch_end"]
    assert bool((ends[:, 1:] >= ends[:, :-1]).all())


# ---- the artifact and the report -----------------------------------------

def _close_line(g, w, path):
    if isinstance(w, dict):
        assert g.keys() == w.keys(), path
        for k in w:
            _close_line(g[k], w[k], f"{path}.{k}")
    elif isinstance(w, list):
        assert len(g) == len(w), path
        for i, (a, b) in enumerate(zip(g, w)):
            _close_line(a, b, f"{path}[{i}]")
    elif isinstance(w, float) and not isinstance(w, bool) \
            and math.isfinite(w):
        assert g == pytest.approx(w, rel=1e-5, abs=1e-6), path
    else:
        assert g == w, path


def _docs_pair():
    """The trace artifact's lines of the reference and of the port for a
    stream run (``heterogeneous_pool``) and a batch run (``smallR1``) on the
    reference's draws; the ``wallclock`` line is left out."""
    jcfg, want, cfg, got = _stream_pair("heterogeneous_pool", None)
    docs = [(dict(engine="stream", scenario="heterogeneous_pool",
                  config=jcfg, metrics=jr.stream_summary(jcfg, want),
                  raw=want),
             dict(engine="stream", scenario="heterogeneous_pool", config=cfg,
                  metrics=tr.stream_summary(cfg, got), raw=got))]
    rc = dataclasses.replace(jfast(jget("smallR1")), trace=JTraceConfig())
    with jax.threefry_partitionable(False):
        jraw = {k: np.asarray(v) for k, v in js.simulate(
            rc, 3, seed=SEED, shard=False).items()}
        draws = _ref_batch_draws(rc, 3, SEED)
    from repro.core.simfast_stats import summarize as jsummarize
    fcfg = dataclasses.replace(get_fast_config("smallR1"),
                               trace=TraceConfig())
    traw = ts.simulate(fcfg, 3, device="cpu", draws=draws)
    docs.append((dict(engine="simfast", scenario="smallR1", config=rc,
                      metrics=dataclasses.asdict(jsummarize(jraw)),
                      raw=jraw),
                 dict(engine="simfast", scenario="smallR1", config=fcfg,
                      metrics=dataclasses.asdict(summarize(traw)),
                      raw=traw)))
    return [([ln for ln in jexport.trace_doc(j) if ln["kind"] != "wallclock"],
             [ln for ln in texport.trace_doc(t) if ln["kind"] != "wallclock"])
            for j, t in docs]


@pytest.fixture(scope="module")
def docs_pair():
    return _docs_pair()


def test_trace_doc_equals_reference_line_for_line(docs_pair):
    for want, got in docs_pair:
        assert [ln["kind"] for ln in got] == [ln["kind"] for ln in want]
        assert got[0] == want[0]            # the header, exactly
        for i, (g, w) in enumerate(zip(got, want)):
            _close_line(g, w, f"line {i} ({w['kind']})")
        kinds = {ln["kind"] for ln in got}
        assert {"series", "counters", "summary"} <= kinds
        if got[0]["engine"] == "stream":
            assert [ln["phase"] for ln in got if ln["kind"] == "phases"] \
                == list(PHASES)


def test_each_read_trace_reads_the_others_file(docs_pair, tmp_path):
    for i, (want, got) in enumerate(docs_pair):
        pt = texport.write_trace(got, directory=str(tmp_path), name=f"t{i}")
        pj = jexport.write_trace(want, directory=str(tmp_path),
                                 name=f"j{i}")
        for read, path, lines in ((jexport.read_trace, pt, got),
                                  (texport.read_trace, pj, want),
                                  (texport.read_trace, pt, got)):
            doc = read(path)
            assert doc["header"] == lines[0]
            assert sum(len(v) for k, v in doc.items() if k != "header") \
                == len(lines) - 1
        # the same report text from either package, on either artifact
        for path in (pt, pj):
            doc = texport.read_trace(path)
            txt = treport.render(doc)
            assert txt == jreport.render(jexport.read_trace(path))
            assert "== trace:" in txt and "counters" in txt
            if doc["header"]["engine"] == "stream":
                assert "latency sources" in txt
                for pk in PHASES:
                    assert pk in txt
    bad = tmp_path / "TRACE_bad.jsonl"
    bad.write_text(json.dumps({"kind": "header", "schema_version": 99})
                   + "\n")
    with pytest.raises(ValueError, match="schema_version"):
        texport.read_trace(str(bad))


def test_run_attaches_the_trace_artifact(tmp_path, capsys):
    res = T.run(T.get_scenario("heterogeneous_pool",
                               {"trace.enabled": True}),
                engine="stream", horizon=40, n_reps=2, device="cpu")
    kinds = [ln["kind"] for ln in res["trace"]]
    assert kinds[0] == "header" and kinds[-1] == "wallclock"
    assert kinds.count("phases") == len(PHASES)
    doc = texport.read_trace(texport.write_trace(
        res["trace"], directory=str(tmp_path), name="run"))
    for ln in doc["phases"]:
        assert len(ln["hist"]) == res["config"].tis_bins
    res = T.run(T.get_scenario("smallR1", {"trace.enabled": True}),
                n_reps=2, device="cpu")
    assert "trace" in res and res["trace"][0]["engine"] == "simfast"
    assert "trace" not in T.run(T.get_scenario("smallR1"), n_reps=1,
                                device="cpu")
    p = texport.write_trace(res["trace"], directory=str(tmp_path),
                            name="b")
    assert treport.main([p]) == 0
    assert "engine=simfast" in capsys.readouterr().out


def test_export_cli_end_to_end(tmp_path):
    """``python -m repro_torch.obs.export heterogeneous_pool --device cpu``
    writes the artifact (two calls, so the wallclock section splits the
    first call's one-time cost) and exits 0; the report CLI renders it."""
    out = tmp_path / "TRACE_cli.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               BENCH_DIR=str(tmp_path))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.export",
         "heterogeneous_pool", "--device", "cpu", "--horizon", "60",
         "--out", str(out)], env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    doc = texport.read_trace(str(out))
    assert doc["header"]["engine"] == "stream"
    assert {"phases", "series", "counters", "summary", "wallclock"} \
        <= set(doc)
    mine = [e for e in doc["wallclock"][0]["entries"]
            if e["name"].startswith("run[heterogeneous_pool")]
    assert mine and mine[0]["calls"] == 2
    assert mine[0]["compile_s"] is not None
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(out)], env=env,
        capture_output=True, text=True, timeout=120)
    assert rep.returncode == 0 and "latency sources" in rep.stdout


# ---- serve mode ----------------------------------------------------------

def test_serve_tick_unchanged_by_a_traced_config():
    """Serve mode takes a traced config as the reference does: the window
    carries the trace's keys and ``serve_tick``'s outputs equal the
    untraced ones, tick for tick."""
    spec = T.get_scenario("serve_default")
    traced_spec = T.get_scenario("serve_default", {"trace.enabled": True})
    cfg, cfg_t = T.to_serve_config(spec), T.to_serve_config(traced_spec)
    assert cfg_t.trace == TraceConfig() and cfg.trace is None
    jcfg = jserve(jget("serve_default", {"trace.enabled": True}))
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(jcfg)
    a = tr.serve_init(cfg, seed=2, device="cpu")
    b = tr.serve_init(cfg_t, seed=2, device="cpu")
    assert {"admit_t", "work_s", "wait_s", "last_evt_t"} \
        <= set(b["win"]) - set(a["win"])
    rng = np.random.default_rng(0)
    S, M = cfg.n_shards, cfg.max_arrivals_per_tick
    uid = np.zeros(S, np.int64)
    fin = 0
    for _ in range(40):
        n = rng.integers(0, min(M, 4) + 1, S)
        a, oa = tr.serve_tick(cfg, a, n, uid)
        b, ob = tr.serve_tick(cfg_t, b, n, uid)
        uid += n
        assert oa.keys() == ob.keys()
        for k, v in oa.items():
            if torch.is_tensor(v):
                assert torch.equal(v, ob[k]), k
            else:
                assert v == ob[k], k
        fin += int(oa["fin"].sum())
    assert fin > 0
