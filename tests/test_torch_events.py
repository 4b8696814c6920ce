"""The port's scalar event-loop engine against the JAX package's: the event
heap, worker draws, TermEst, ``ClamShell.run_labeling`` /
``run_learning``, quality maintenance, ``event_loop_summary``,
``make_learner_step``, and the host-only satellites (the serving
scheduler, the elastic host monitor).

The event loop is host Python over numpy generators on the reference's
seeds, so a labeling run's ``LabelResult`` must equal the reference's in
every field, every float included. The device work — the quality sweep's
Dawid-Skene EM and the learner's fits and entropies — runs here on the CPU
(``device="cpu"``); its floats may differ from JAX's in the last bits, so
the quality sweep is held on its eviction list ``(time, wid)`` and the
learner on its chosen points per batch, ``labeled`` and the curve's times,
with the curve's accuracies within one test point. Reference calls that
draw JAX keys run inside ``jax.threefry_partitionable(False)``.
"""
import dataclasses
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import scenarios as J  # noqa: E402
from repro.core import clamshell as jcs  # noqa: E402
from repro.core import simfast as jsim  # noqa: E402
from repro.core import simfast_stats as jstats  # noqa: E402
from repro.core import workers as jwk  # noqa: E402
from repro.core.events import EventLoop as JLoop  # noqa: E402
from repro.core.maintenance import termest_latency as j_termest  # noqa: E402
from repro.distributed import elastic as jel  # noqa: E402
from repro.serving import scheduler as jsch  # noqa: E402
from repro_torch import scenarios as T  # noqa: E402
from repro_torch.core import clamshell as tcs  # noqa: E402
from repro_torch.core import simfast as tsim  # noqa: E402
from repro_torch.core import simfast_stats as tstats  # noqa: E402
from repro_torch.core import workers as twk  # noqa: E402
from repro_torch.core.events import EventLoop as TLoop  # noqa: E402
from repro_torch.core.maintenance import (  # noqa: E402
    termest_latency as t_termest,
)
from repro_torch.distributed import elastic as tel  # noqa: E402
from repro_torch.learning import linear  # noqa: E402
from repro_torch.serving import scheduler as tsch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_result(got, want):
    """Every ``LabelResult`` field equal, floats bit for bit."""
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g == w, (f.name, g, w)


# ---- the event heap, the population, TermEst -----------------------------

def test_event_loop_order_matches_reference():
    rng = np.random.default_rng(0)
    times = np.round(rng.uniform(0, 20, 200), 1).tolist()
    stops = []
    for Loop in (JLoop, TLoop):
        loop, seen = Loop(), []

        def hit(i, loop=loop, seen=seen):
            seen.append((loop.now, i))
            if i % 7 == 0:                    # events schedule events
                loop.after(1.5, hit, 1000 + i)
        for i, t in enumerate(times):
            loop.at(t, hit, i)
        loop.at(-3.0, hit, -1)                # a past time runs now
        end = loop.run_until(15.0)
        stops.append((seen, end, loop.empty()))
    assert stops[0] == stops[1]
    assert stops[1][0][0] == (0.0, -1)


def test_population_draws_equal_reference():
    for kw in (dict(seed=0), dict(seed=21, acc_a=4.0, acc_b=1.6),
               dict(seed=5, median_mu=60.0, sigma_ln=0.6)):
        jp, tp = jwk.Population(**kw), twk.Population(**kw)
        for _ in range(300):
            assert dataclasses.asdict(tp.draw()) == \
                dataclasses.asdict(jp.draw())
        assert tp.split_stats(150.0) == jp.split_stats(150.0)
        assert tp.predicted_mpl(150.0, 12) == jp.predicted_mpl(150.0, 12)


def _worker(mod, n, nc, nt, lat_c, lat_f):
    w = mod.Worker(0, mu=300, sigma=10, accuracy=0.9)
    w.n_started, w.n_completed, w.n_terminated = n, nc, nt
    w.completed_latency_sum = nc * lat_c
    w.completed_latency_sqsum = nc * lat_c * lat_c
    w.terminator_latency_sum = nt * lat_f
    return w


@pytest.mark.parametrize("n,nc,nt,alpha", [
    (10, 6, 4, 1.0),          # the reference test's mixed case
    (5, 0, 5, 1.0),           # all terminated: no division by zero
    (8, 8, 0, 1.0),           # nothing censored: the empirical mean
    (0, 0, 0, 1.0),           # no observation: nan
    (12, 3, 9, 0.5),
])
def test_termest_matches_reference(n, nc, nt, alpha):
    want = j_termest(_worker(jwk, n, nc, nt, 200.0, 50.0), alpha)
    got = t_termest(_worker(twk, n, nc, nt, 200.0, 50.0), alpha)
    assert got == want or (math.isnan(got) and math.isnan(want))


# ---- run_labeling, field for field ---------------------------------------

def _cfg(**kw):
    return kw


LABELING = {
    "straggler-on": (_cfg(pool_size=15, straggler=True, seed=3), 120),
    "straggler-off": (_cfg(pool_size=15, straggler=False, seed=3), 120),
    "route-random": (_cfg(pool_size=12, routing="random", seed=7), 100),
    "route-longest": (_cfg(pool_size=12, routing="longest", seed=7), 100),
    "route-fewest": (_cfg(pool_size=12, routing="fewest", seed=7), 100),
    "route-oracle": (_cfg(pool_size=12, routing="oracle", seed=7), 100),
    "pm_l-termest": (_cfg(pool_size=20, straggler=True, pm_l=150.0,
                          use_termest=True, seed=5), 300),
    "pm_l-no-termest": (_cfg(pool_size=20, straggler=True, pm_l=150.0,
                             use_termest=False, seed=5), 300),
    "pm_l-no-straggler": (_cfg(pool_size=20, straggler=False, pm_l=150.0,
                               seed=6, session_mean_s=7200.0), 400),
    "cold-pool": (_cfg(pool_size=10, retainer=False, seed=4), 60),
    "qc-3-votes": (_cfg(pool_size=10, straggler=True, votes_needed=3,
                        seed=11), 60),
    "churn": (_cfg(pool_size=10, session_mean_s=300.0, seed=2), 200),
    "grouped-records": (_cfg(pool_size=8, n_records=4, batch_ratio=0.5,
                             seed=9), 48),
}


@pytest.mark.parametrize("case", sorted(LABELING))
def test_run_labeling_equals_reference(case):
    kw, n_tasks = LABELING[case]
    truth = np.random.default_rng(0).integers(0, 2, n_tasks)
    want = jcs.ClamShell(jcs.CSConfig(**kw)).run_labeling(
        n_tasks, true_labels=truth)
    cs = tcs.ClamShell(tcs.CSConfig(**kw), device="cpu")
    got = cs.run_labeling(n_tasks, true_labels=truth)
    _same_result(got, want)
    assert got.n_labels == n_tasks * kw.get("n_records", 1)


@pytest.mark.parametrize("name", ["smallR1", "throughput_v3_pm"])
def test_registry_scenarios_on_events_equal_reference(name):
    """Through the front door: ``scenarios.run(engine="events")``, one
    replication per seed, at the scenario's own task count (400 for
    ``throughput_v3_pm``), traced so the host recorder is compared too."""
    spec = T.get_scenario(name, {"trace.enabled": True})
    jspec = J.get_scenario(name, {"trace.enabled": True})
    got = T.run(spec, "events", n_reps=2, seed=4, device="cpu")
    want = J.run(jspec, "events", n_reps=2, seed=4)
    assert got["engine"] == "events" and len(got["raw"]) == 2
    assert dataclasses.asdict(got["config"]) == \
        dataclasses.asdict(want["config"])
    for g, w in zip(got["raw"], want["raw"]):
        _same_result(g, w)
        assert len(g.task_latencies) == spec.n_tasks
    assert got["metrics"] == want["metrics"]
    assert got["events_trace"].tasks == want["events_trace"].tasks
    assert got["events_trace"].batches == want["events_trace"].batches
    # the artifact line for line, but for the process-wide wall-clock
    strip = lambda doc: [ln for ln in doc  # noqa: E731
                         if ln["kind"] != "wallclock"]
    assert strip(got["trace"]) == strip(want["trace"])


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcs.ClamShell(tcs.CSConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run(T.get_scenario("smallR1"), "events")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_learning("hybrid_small", engine="events")


# ---- quality maintenance: the Dawid-Skene EM on the device ---------------

def test_quality_maintenance_evictions_equal_reference():
    """The run of ``tests/test_core.py``'s quality test: pool 12, 3 votes,
    240 tasks, threshold 0.72, a noisy population. The port's EM runs in
    torch, so its accuracies may differ from JAX's in the last bits; the
    evictions ``(time, wid)`` must be the same list (a flip on a near-tie
    would name the worker and both accuracies here)."""
    truth = np.random.default_rng(0).integers(0, 2, 240)

    def run(mod, **kw):
        cs = mod.ClamShell(mod.CSConfig(pool_size=12, straggler=True,
                                        votes_needed=3,
                                        quality_threshold=0.72, seed=13),
                           population=(jwk if mod is jcs else twk)
                           .Population(seed=21, acc_a=4.0, acc_b=1.6), **kw)
        return cs, cs.run_labeling(240, true_labels=truth)

    with jax.threefry_partitionable(False):
        jc, want = run(jcs)
    tc, got = run(tcs, device="cpu")
    jq, tq = jc.maintainer.quality_evictions, tc.maintainer.quality_evictions
    assert len(jq) > 0
    flips = [(w[:2], g[:2], w[2], g[2]) for w, g in zip(jq, tq)
             if w[:2] != g[:2]]
    assert not flips and len(tq) == len(jq), flips
    np.testing.assert_allclose([g[2] for g in tq], [w[2] for w in jq],
                               rtol=1e-5, atol=1e-6)
    _same_result(got, want)


# ---- run_learning: the learner's choices per batch -----------------------

def _learning_run(mod, jax_side: bool, kind: str, budget: int, **kw):
    S = J if jax_side else T
    spec = S.get_scenario("hybrid_small", {"policy.learner.kind": kind})
    X, y, Xt, yt = T.spec_dataset("hybrid_small", n_train=600, n_test=200)
    cs = mod.ClamShell(S.to_cs_config(spec, seed=0), **kw)
    batches = []
    submit = cs.lifeguard.submit_batch

    def record(tasks, cb):
        batches.append([t.payload for t in tasks])
        return submit(tasks, cb)
    cs.lifeguard.submit_batch = record
    curve, res = cs.run_learning(X, y, Xt, yt, label_budget=budget)
    return batches, curve, res, len(yt)


@pytest.mark.parametrize("kind", ["HL", "AL", "PL"])
def test_run_learning_choices_equal_reference(kind):
    with jax.threefry_partitionable(False):
        jb, jcurve, jres, n_test = _learning_run(jcs, True, kind, 200)
    tb, tcurve, tres, _ = _learning_run(tcs, False, kind, 200,
                                        device="cpu")
    differ = [(i, a, b) for i, (a, b) in enumerate(zip(jb, tb)) if a != b]
    assert not differ and len(tb) == len(jb) == 20, differ[:1]
    assert [c[:2] for c in tcurve] == [c[:2] for c in jcurve]
    np.testing.assert_allclose([c[2] for c in tcurve],
                               [c[2] for c in jcurve], atol=1.0 / n_test)
    _same_result(tres, jres)
    assert tcurve[-1][2] > tcurve[0][2] + 0.2


def test_run_learning_facade_equals_reference():
    kw = dict(n_train=300, n_test=100, label_budget=40)
    with jax.threefry_partitionable(False):
        want = J.run_learning(J.get_scenario("hybrid_small"), engine="events",
                              **kw)
    got = T.run_learning(T.get_scenario("hybrid_small"), engine="events",
                         device="cpu", **kw)
    assert dataclasses.asdict(got["config"]) == \
        dataclasses.asdict(want["config"])
    assert [c[:2] for c in got["curve"]] == [c[:2] for c in want["curve"]]
    np.testing.assert_allclose([c[2] for c in got["curve"]],
                               [c[2] for c in want["curve"]], atol=0.01)
    _same_result(got["result"], want["result"])


def test_logistic_learner_matches_reference():
    from repro.learning import LogisticLearner as JL
    from repro_torch.learning.compat import LogisticLearner as TL
    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 6)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int64)
    j, t = JL(6, 2), TL(6, 2, device="cpu")
    assert j.score(X, y) == t.score(X, y)
    for n in (10, 40, 150):
        j.fit(X[:n], y[:n])
        t.fit(X[:n], y[:n])
        assert t.version == j.version
        np.testing.assert_allclose(t.W.numpy(), np.asarray(j.W), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(t.uncertainty(X), j.uncertainty(X),
                                   rtol=1e-4, atol=1e-6)
        cand = rng.choice(300, 120, replace=False)
        assert np.array_equal(t.select_uncertain(X, cand, 15),
                              j.select_uncertain(X, cand, 15))
    assert t.fit(X[:0], y[:0]).version == j.version
    assert len(t.select_uncertain(X, cand, 0)) == 0


# ---- the batch engine's helpers over the event loop ----------------------

def test_event_loop_summary_equals_reference():
    jc = jsim.FastConfig(pool_size=10, n_tasks=40)
    tc = tsim.FastConfig(pool_size=10, n_tasks=40)
    want = jstats.event_loop_summary(jc, 3, seed=2)
    got = tstats.event_loop_summary(tc, 3, seed=2, device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    rep = tstats.parity_report(got, want)
    assert all(v == 0.0 for v in rep.values())


def test_make_learner_step_matches_reference():
    n, d, c = 64, 4, 2
    key = jax.random.key(0)
    with jax.threefry_partitionable(False):
        X = np.asarray(jax.random.normal(key, (n, d)))
        u = np.asarray(jax.random.uniform(key, (n,)))
    W = np.zeros((d, c), np.float32)
    W[0, 0] = 8.0
    b = np.zeros((c,), np.float32)
    labeled = np.zeros((n,), bool)
    labeled[::5] = True
    y_obs = (X[:, 0] > 0).astype(np.int32) * labeled
    jstep = jsim.make_learner_step(n_passive=3, k_active=2, fit_steps=10)
    with jax.threefry_partitionable(False):
        jW, jb, jch, jact = jstep(jnp.asarray(W), jnp.asarray(b),
                                  jnp.asarray(X), jnp.asarray(labeled),
                                  jnp.asarray(y_obs), key)
    tstep = tsim.make_learner_step(n_passive=3, k_active=2, fit_steps=10)
    tt = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    tW, tb, tch, tact = tstep(tt(W), tt(b), tt(X), tt(labeled),
                              tt(y_obs.astype(np.int64)), tt(u))
    np.testing.assert_array_equal(tch.numpy(), np.asarray(jch))
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    np.testing.assert_allclose(tW.numpy(), np.asarray(jW), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4,
                               atol=1e-5)
    # the two active picks are the two most uncertain unlabeled points
    ent = linear.entropy(linear.with_params(tt(W), tt(b)), tt(X)).numpy()
    ent[labeled] = -np.inf
    assert set(tch[:2].tolist()) == set(np.argsort(-ent, kind="stable")[:2])


# ---- host-only satellites ------------------------------------------------

@pytest.mark.parametrize("straggler", [False, True])
def test_serving_scheduler_equals_reference(straggler):
    want = jsch.ServingScheduler(straggler=straggler, seed=3).run(300)
    got = tsch.ServingScheduler(straggler=straggler, seed=3).run(300)
    assert got == want
    assert got["n"] == 300


def test_host_monitor_and_dp_rule_equal_reference():
    out = []
    for mod in (jel, tel):
        clk = {"t": 0.0}
        mon = mod.HostMonitor(range(4), pm_l=2.0, heartbeat_timeout=10.0,
                              clock=lambda clk=clk: clk["t"])
        for _ in range(8):
            clk["t"] += 1
            for h in range(4):
                if h != 3:
                    mon.heartbeat(h)
                mon.record_step(h, 10.0 if h == 2 else 1.0,
                                terminated=(h == 1 and clk["t"] > 6),
                                terminator_latency=0.5)
        clk["t"] += 8
        for h in (0, 1, 2):
            mon.heartbeat(h)
        out.append((mon.check(), mon.alive_hosts, mon.evicted,
                    [dataclasses.asdict(h.stats)
                     for h in mon.hosts.values()]))
    assert out[0] == out[1]
    assert dict(out[1][0])[3] == "heartbeat" and 2 in dict(out[1][0])
    for n, batch in ((16, 256), (15, 256), (3, 256), (7, 96), (1, 5)):
        assert tel.largest_valid_dp(n, batch) == \
            jel.largest_valid_dp(n, batch)
