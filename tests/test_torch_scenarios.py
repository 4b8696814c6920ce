"""The port's scenario layer against the JAX package's: specs, the registry,
compilation, the facade's ``run`` / ``sweep`` / ``run_learning`` and the
registry smoke.

Specs raise the reference's exceptions with the reference's messages; the
registry holds the reference's scenarios; every registry scenario lowers to
the reference's configs field for field (``dataclasses.asdict``, nested
configs included) on every engine the port runs. ``run`` equals the engine
entry point plus its summary bit for bit, and the port's ``summarize``
equals the reference's on the same output. The facade runs on the CPU here
(``device="cpu"``).
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import scenarios as J  # noqa: E402
from repro.core import simfast_stats as jstats  # noqa: E402
from repro.scenarios import spec as jspec  # noqa: E402
from repro_torch import scenarios as T  # noqa: E402
from repro_torch.core import simfast_stats as tstats  # noqa: E402
from repro_torch.core.simfast import simulate  # noqa: E402
from repro_torch.labelstream.router import (  # noqa: E402
    run_stream, stream_summary,
)
from repro_torch.scenarios import smoke  # noqa: E402
from repro_torch.scenarios import spec as tspec  # noqa: E402

NAMES = J.list_scenarios()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _message(ctor, mod):
    with pytest.raises(ValueError) as e:
        ctor(mod)
    return str(e.value)


# the invalid fields of tests/test_scenarios.py, the contradictory specs,
# and the sub-specs and cross-field checks that file does not reach
INVALID = {
    "arrival-kind": lambda m: m.ArrivalSpec(kind="bogus"),
    "arrival-rate": lambda m: m.ArrivalSpec(rate=0.0),
    "arrival-amplitude": lambda m: m.ArrivalSpec(amplitude=1.0),
    "difficulty-p_hard": lambda m: m.DifficultySpec(p_hard=1.5),
    "feature-hard_sep_scale": lambda m: m.FeatureSpec(hard_sep_scale=0.0),
    "feature-kind": lambda m: m.FeatureSpec(kind="image"),
    "pool-size": lambda m: m.PoolSpec(pool_size=0),
    "pool-cv": lambda m: m.PoolSpec(cv_lo=2.0, cv_hi=1.0),
    "pool-bank": lambda m: m.PoolSpec(bank=0),
    "pool-est_prior_acc": lambda m: m.PoolSpec(est_prior_acc=1.0),
    "engine-dt": lambda m: m.EngineKnobs(dt=-1.0),
    "engine-tis_bins": lambda m: m.EngineKnobs(tis_bins=1),
    "straggler-max_dup": lambda m: m.StragglerSpec(max_dup=-1),
    "maintenance-pm_l": lambda m: m.MaintenanceSpec(pm_l=0.0),
    "redundancy-votes": lambda m: m.RedundancySpec(votes=0),
    "redundancy-min_votes": lambda m: m.RedundancySpec(votes=2, min_votes=3),
    "redundancy-conf": lambda m: m.RedundancySpec(conf_threshold=0.4),
    "routing-kind": lambda m: m.RoutingSpec(kind="greedy"),
    "routing-ewma": lambda m: m.RoutingSpec(ewma_alpha=0.0),
    "admission-kind": lambda m: m.AdmissionSpec(kind="lifo"),
    "learner-kind": lambda m: m.LearnerSpec(kind="XL"),
    "learner-al_fraction": lambda m: m.LearnerSpec(al_fraction=1.5),
    "learner-refresh_iters": lambda m: m.LearnerSpec(refresh_iters=0),
    "sharding-steal": lambda m: m.ShardingSpec(steal="greedy"),
    "trace-enabled": lambda m: m.TraceSpec(enabled=True, phases=False,
                                           per_tick=False),
    "serve-port": lambda m: m.ServeSpec(port=70000),
    "embed-pooling": lambda m: m.EmbedSpec(pooling="max"),
    "scenario-n_classes": lambda m: m.ScenarioSpec(n_classes=1),
    "scenario-n_tasks": lambda m: m.ScenarioSpec(n_tasks=0),
    "scenario-backlog": lambda m: m.ScenarioSpec(window=64, backlog=32),
    # contradictions
    "admission-without-learner": lambda m: m.PolicySpec(
        admission=m.AdmissionSpec(kind="uncertain")),
    "batch_replay-not-fifo": lambda m: m.AdmissionSpec(kind="uncertain",
                                                       batch_replay=True),
    "learner-n_features": lambda m: m.ScenarioSpec(
        n_classes=4, features=m.FeatureSpec(n_features=2),
        policy=m.PolicySpec(learner=m.LearnerSpec(enabled=True))),
    "sharding-divides": lambda m: m.ScenarioSpec(
        pool=m.PoolSpec(n_shards=3), sharding=m.ShardingSpec(n_devices=2)),
    "sharding-shards_per_device": lambda m: m.ScenarioSpec(
        pool=m.PoolSpec(n_shards=4),
        sharding=m.ShardingSpec(n_devices=2, shards_per_device=3)),
    "steal-needs-fifo": lambda m: m.ScenarioSpec(
        sharding=m.ShardingSpec(steal="pressure"),
        policy=m.PolicySpec(admission=m.AdmissionSpec(kind="uncertain"),
                            learner=m.LearnerSpec(enabled=True))),
    "lm-stream-needs-learner": lambda m: m.ScenarioSpec(
        arrivals=m.ArrivalSpec(kind="poisson"),
        features=m.FeatureSpec(kind="lm")),
    "lm-bank_size": lambda m: m.ScenarioSpec(
        features=m.FeatureSpec(kind="lm"), embed=m.EmbedSpec(bank_size=6)),
    "lm-bank-covers-window": lambda m: m.ScenarioSpec(
        features=m.FeatureSpec(kind="lm"), embed=m.EmbedSpec(bank_size=16)),
    "lm-projection_dim": lambda m: m.ScenarioSpec(
        features=m.FeatureSpec(kind="lm"),
        embed=m.EmbedSpec(projection_dim=4)),
    "grid-axis": lambda m: m.GridSpec(axes=(("pool.nope", (1,)),)),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_invalid_specs_raise_the_reference_message(case):
    want = _message(INVALID[case], jspec)
    assert _message(INVALID[case], tspec) == want


def test_override_hash_and_equality():
    for ov in ({"pool.pool_size": 6, "window": 16},
               {"policy.redundancy.votes": 5, "arrivals.rate": 0.02},
               {"policy.learner.refresh_every": 40}):
        got = T.override(T.get_scenario("stream_default"), ov)
        want = J.override(J.get_scenario("stream_default"), ov)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    spec = T.get_scenario("heterogeneous_pool")
    assert spec == T.get_scenario("heterogeneous_pool")
    assert hash(spec) == hash(T.get_scenario("heterogeneous_pool"))
    assert spec.pool.pool_size == 8 and T.override(
        spec, {"pool.pool_size": 6}) != spec
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.window = 4
    for bad in ({"pool.nope": 1}, {"pool.pool_size.x": 1}):
        want = _message(lambda m: m.override(J.get_scenario("smallR1"), bad),
                        jspec)
        got = _message(lambda m: m.override(T.get_scenario("smallR1"), bad),
                       tspec)
        assert got == want


def test_registry_matches_reference():
    assert T.list_scenarios() == NAMES
    for name in NAMES:
        assert dataclasses.asdict(T.get_scenario(name)) == \
            dataclasses.asdict(J.get_scenario(name)), name
    assert T.list_grids() == J.list_grids()
    for name in T.list_grids():
        g, w = T.get_grid(name), J.get_grid(name)
        assert g.axes == w.axes and g.shape == w.shape
        assert dataclasses.asdict(g.base) == dataclasses.asdict(w.base)
    with pytest.raises(KeyError, match="unknown scenario"):
        T.get_scenario("nope")
    with pytest.raises(ValueError, match="already registered"):
        T.register_scenario("smallR1", T.get_scenario("smallR1"))
    with pytest.raises(TypeError):
        T.register_scenario("tmp_not_a_spec", object())


@pytest.mark.parametrize("name", NAMES)
def test_compile_matches_reference_field_for_field(name):
    spec, jsp = T.get_scenario(name), J.get_scenario(name)
    assert T.engines(spec) == J.engines(jsp)
    asdict = dataclasses.asdict
    assert asdict(T.to_embed_config(spec)) == asdict(J.to_embed_config(jsp))
    for engine in J.engines(jsp):
        if engine == "events":
            with pytest.raises(NotImplementedError, match="A9"):
                T.compile_for(spec, engine)
        elif engine == "simfast":
            assert asdict(T.to_fast_config(spec)) == \
                asdict(J.to_fast_config(jsp))
        else:
            assert asdict(T.to_stream_config(spec)) == \
                asdict(J.to_stream_config(jsp))
            got = T.to_serve_config(spec)
            assert got.serve and asdict(got) == \
                asdict(J.to_serve_config(jsp))


def _same_rejection(fn_t, fn_j):
    with pytest.raises(ValueError) as e:
        fn_j()
    want = str(e.value)
    with pytest.raises(ValueError) as e:
        fn_t()
    assert str(e.value).replace("repro_torch.", "repro.") == want


@pytest.mark.parametrize("ov", [
    {"pool.n_shards": 2},
    {"policy.redundancy": "adaptive"},
    {"policy.routing.kind": "scored"},
    {"policy.admission.batch_replay": True},
    {"policy.learner.enabled": True},
    {"features.kind": "lm"},
    {"difficulty.p_hard": 0.25},
    {"sharding.steal": "pressure"},
    {"arrivals.kind": "poisson"},
])
def test_compile_rejections_match_reference(ov):
    if ov == {"policy.redundancy": "adaptive"}:
        t_ov = {"policy.redundancy": T.RedundancySpec(adaptive=True,
                                                      votes=3)}
        j_ov = {"policy.redundancy": J.RedundancySpec(adaptive=True,
                                                      votes=3)}
    else:
        t_ov = j_ov = ov
    bt = T.override(T.get_scenario("smallR1"), t_ov)
    bj = J.override(J.get_scenario("smallR1"), j_ov)
    _same_rejection(lambda: T.to_fast_config(bt),
                    lambda: J.to_fast_config(bj))
    # and the stream side: batch arrivals, a cold pool
    st, sj = T.get_scenario("smallR1"), J.get_scenario("smallR1")
    _same_rejection(lambda: T.to_stream_config(st),
                    lambda: J.to_stream_config(sj))
    cold_t = T.override(T.get_scenario("stream_default"),
                        {"pool.retainer": False})
    cold_j = J.override(J.get_scenario("stream_default"),
                        {"pool.retainer": False})
    _same_rejection(lambda: T.to_stream_config(cold_t),
                    lambda: J.to_stream_config(cold_j))
    _same_rejection(lambda: T.run(st, engine="stream", device="cpu"),
                    lambda: J.run(sj, engine="stream"))


def test_name_keyed_helpers_are_registry_lowerings():
    refresh = {"refresh_every": 40, "refresh_iters": 6}
    for name in T.list_stream_configs():
        assert T.get_stream_config(name) == \
            T.to_stream_config(T.get_scenario(name))
    # phase 4's stream through the spec layer: the learner's refresh knobs
    assert T.to_stream_config(T.get_scenario("skewed_adaptive5", {
        "policy.learner.refresh_every": 40,
        "policy.learner.refresh_iters": 6})) == \
        T.get_stream_config("skewed_adaptive5", refresh)
    assert T.list_fast_configs() == ["hybrid_small", "smallR1",
                                     "throughput_v3_pm"]
    for name in T.list_fast_configs():
        assert T.get_fast_config(name) == \
            T.to_fast_config(T.get_scenario(name))
        assert T.get_learning_spec(name) == \
            T.learning_spec(T.get_scenario(name))
    with pytest.raises(KeyError, match="unknown batch workload"):
        T.get_fast_config("stream_default")
    with pytest.raises(KeyError, match="unknown stream workload"):
        T.get_stream_config("serve_default")


def test_trace_and_events_raise_naming_their_item():
    traced = T.override(T.get_scenario("stream_default"),
                        {"trace.enabled": True})
    with pytest.raises(NotImplementedError, match="A5e"):
        T.to_stream_config(traced)
    with pytest.raises(NotImplementedError, match="A9"):
        T.run(T.get_scenario("smallR1"), "events", device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        T.to_cs_config(T.get_scenario("smallR1"))
    with pytest.raises(TypeError):
        T.run(T.get_stream_config("stream_default"), device="cpu")


def test_run_stream_equals_entry_point_bit_for_bit():
    spec = T.override(T.get_scenario("heterogeneous_pool"),
                      {"pool.pool_size": 4, "window": 8})
    res = T.run(spec, engine="stream", horizon=40, n_reps=2, seed=3,
                device="cpu")
    cfg = T.to_stream_config(spec)
    assert res["engine"] == "stream" and res["config"] == cfg
    raw = run_stream(cfg, 40, n_reps=2, seed=3, device="cpu")

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif torch.is_tensor(a):
            assert torch.equal(a, b)
        else:
            assert a == b
    same(res["raw"], raw)
    assert res["metrics"] == stream_summary(cfg, raw)
    # the default engine of a stream workload, and the spec's horizon
    short = T.override(spec, {"horizon": 5})
    assert T.run(short, device="cpu")["metrics"] == stream_summary(
        cfg, run_stream(cfg, 5, device="cpu"))


def test_run_simfast_equals_simulate_and_reference_summarize():
    spec = T.override(T.get_scenario("smallR1"), {"n_tasks": 8})
    res = T.run(spec, n_reps=3, seed=2, device="cpu")
    assert res["engine"] == "simfast"
    raw = simulate(res["config"], 3, seed=2, device="cpu")
    for k, v in raw.items():
        assert torch.equal(res["raw"][k], v), k
    want = dataclasses.asdict(tstats.summarize(raw))
    assert res["metrics"] == want
    host = {k: v.numpy() for k, v in raw.items()}
    assert dataclasses.asdict(jstats.summarize(host)) == want
    rep = tstats.parity_report(tstats.summarize(raw), jstats.summarize(host))
    assert max(rep.values()) == 0.0


def test_sweep_per_value_equals_runs():
    small = T.override(T.get_scenario("smallR1"), {"n_tasks": 8})
    sw = T.sweep(small, "policy.redundancy.votes", [1, 3], n_reps=2,
                 seed=1, device="cpu")
    assert sw["vectorized"] is False and sw["engine"] == "simfast"
    assert sw["results"] == [
        T.run(T.override(small, {"policy.redundancy.votes": v}), n_reps=2,
              seed=1, device="cpu")["metrics"] for v in (1, 3)]
    bursty = T.override(T.get_scenario("bursty_admission"),
                        {"pool.pool_size": 4})
    sw = T.sweep(bursty, "arrivals.rate", [0.01, 0.03], horizon=20,
                 n_reps=2, device="cpu")
    assert sw["vectorized"] is False
    assert sw["results"] == [
        T.run(T.override(bursty, {"arrivals.rate": v}), horizon=20,
              n_reps=2, device="cpu")["metrics"] for v in (0.01, 0.03)]
    # a Base-NR pool's recruit axis is per value in the reference too
    cold = T.override(small, {"pool.retainer": False})
    assert T.sweep(cold, "pool.recruit_mean_s", [30.0], n_reps=1,
                   device="cpu")["vectorized"] is False


@pytest.mark.parametrize("name,axis,item", [
    ("stream_default", "arrivals.rate", "A5f"),
    ("stream_default", "policy.redundancy.votes", "A5f"),
    ("stream_default", "pool.acc_a", "A5f"),
    ("chance_hard", "difficulty.p_hard", "A5f"),
    ("smallR1", "pool.median_mu", "A8"),
    ("smallR1", "pool.acc_b", "A8"),
])
def test_sweep_vectorized_axes_raise(name, axis, item):
    with pytest.raises(NotImplementedError, match=item):
        T.sweep(T.get_scenario(name), axis, [1.0, 2.0], device="cpu")


def test_run_learning_takes_a_spec():
    kw = dict(rounds=2, n_reps=3, fit_steps=10, n_train=300, n_test=100,
              device="cpu")
    by_name = T.run_learning("hybrid_small", **kw)
    by_spec = T.run_learning(T.get_scenario("hybrid_small"), **kw)
    assert by_spec["scenario"] == "hybrid_small"
    assert by_spec["config"] == by_name["config"]
    for k in ("t", "n_labeled", "acc"):
        assert torch.equal(by_spec["curve"][k], by_name["curve"][k])
    # an override reaches the dataset: a narrower feature space
    narrow = T.run_learning(T.get_scenario("hybrid_small"),
                            overrides={"features.n_features": 4}, **kw)
    assert narrow["raw"]["W"].shape[-2] == 4
    with pytest.raises(NotImplementedError, match="A9"):
        T.run_learning(T.get_scenario("hybrid_small"), engine="events",
                       device="cpu")
    with pytest.raises(TypeError):
        T.run_learning(3, device="cpu")


def test_registry_smoke_on_the_cpu(capsys):
    assert smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[FAIL]" not in out
    todo = sorted(line.split()[1] + "/" + line.split()[2]
                  for line in out.splitlines() if line.startswith("[TODO]"))
    assert todo == ["hybrid_small/events", "lm_chance_hard/stream",
                    "lm_stream/stream", "smallR1/events",
                    "throughput_v3_pm/events"]
    assert out.count("[ ok ]") == 15
