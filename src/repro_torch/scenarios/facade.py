"""The execution facade: ``run(scenario, engine=...)``, ``sweep(scenario,
axis=..., values=...)`` and ``run_learning`` (port of
``src/repro/scenarios/facade.py``).

    from repro_torch import scenarios
    res = scenarios.run(scenarios.get_scenario("heterogeneous_pool"),
                        engine="stream", horizon=1200, n_reps=4, seed=0)
    res["metrics"]["votes_per_task"]

``run`` lowers the spec to the engine's config and calls the engine's entry
point with it (:func:`~repro_torch.labelstream.router.run_stream` +
``stream_summary``, :func:`~repro_torch.core.simfast.simulate` +
``summarize``, or one :class:`~repro_torch.core.clamshell.ClamShell` run
per seed for the scalar event loop), so a run equals that call bit for
bit. Every entry point runs on the card unless the caller passes
``device="cpu"``.

With ``trace.enabled`` on the spec, ``run`` also attaches the trace
artifact's lines (``repro_torch.obs.export.trace_doc``) as ``out["trace"]``.

``sweep`` runs a scenario across one axis. The axes the reference traces
into one vectorized program run as one batched run here: the stream
engine's offered rate (``run_stream_sweep``; mmpp rate sweeps excepted),
votes cap (``run_stream_votes_sweep``) and the ``StreamTraced`` axes
(``run_stream_grid``: the Beta accuracy prior and the difficulty mixture),
and the batch engine's ``SimScales`` pool axes (``simulate_swept``) and
Beta accuracy prior (``simulate_swept_pop``). Every other axis runs one
``run`` per value, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.scenarios.compile import (
    TRACED_AXES, engines, to_cs_config, to_fast_config, to_stream_config,
)
from repro_torch.scenarios.registry import (
    get_fast_config, get_learning_spec, get_scenario, learning_spec,
)
from repro_torch.scenarios.spec import ScenarioSpec, override

#: axis name -> SimScales field for the batched simfast sweep
_SIMFAST_AXES = {
    "pool.median_mu": "mu",
    "pool.session_mean_s": "session",
    "pool.recruit_mean_s": "recruit",
}
#: stream axes that map onto the rate scale
_STREAM_AXES = ("arrivals.rate",)
#: stream axis that maps onto the masked votes cap
_STREAM_VOTES_AXIS = "policy.redundancy.votes"
#: Beta accuracy-prior axes: traced on both batched engines (simfast
#: ``PopTraced``, stream ``StreamTraced``)
_ACC_AXES = tuple(p for p in TRACED_AXES["simfast"]
                  if p in TRACED_AXES["stream"])
#: stream axes of the ``StreamTraced`` grid bundle (the traced axes other
#: than the rate scale and the masked cap), each under its field name
_STREAM_TRACED_AXES = {p: p.split(".")[-1] for p in TRACED_AXES["stream"]
                       if p not in _STREAM_AXES + (_STREAM_VOTES_AXIS,)}


def _resolve_engine(spec: ScenarioSpec, engine):
    compat = engines(spec)
    if engine is None:
        if not compat:
            raise ValueError(f"scenario {spec.name or '<anonymous>'} is "
                             "compatible with no engine")
        return compat[0] if len(compat) == 1 else compat[1 if
                                                         "simfast" in compat
                                                         else 0]
    if engine not in compat:
        raise ValueError(f"scenario {spec.name or '<anonymous>'} cannot run "
                         f"on engine {engine!r} (compatible: {compat})")
    return engine


def _label_metrics(results) -> dict:
    """Mean service metrics over a list of event-loop LabelResults."""
    lat_means = [np.mean(r.task_latencies) for r in results
                 if r.task_latencies]
    lat_stds = [np.std(r.task_latencies) for r in results
                if r.task_latencies]
    return dict(
        n_reps=len(results),
        total_time=float(np.mean([r.total_time for r in results])),
        n_labels=float(np.mean([r.n_labels for r in results])),
        throughput=float(np.mean([r.throughput for r in results])),
        # a run that timed out before any completion has no latency data;
        # report inf (no evidence of a bounded latency), never NaN
        mean_latency=float(np.mean(lat_means)) if lat_means
        else float("inf"),
        std_latency=float(np.mean(lat_stds)) if lat_stds else float("inf"),
        accuracy=float(np.mean([r.accuracy for r in results])),
        cost=float(np.mean([r.cost for r in results])),
        cost_wait=float(np.mean([r.cost_wait for r in results])),
        cost_work=float(np.mean([r.cost_work for r in results])),
    )


def _attach_trace(out: dict, scenario: ScenarioSpec) -> dict:
    """With ``scenario.trace.enabled``, build the trace artifact's lines
    (``repro_torch.obs.export.trace_doc``) from the engine's output and
    attach them as ``out["trace"]``, ready for ``write_trace``."""
    if scenario.trace.enabled:
        from repro_torch.obs.export import trace_doc
        out["trace"] = trace_doc(out)
    return out


def run(scenario, engine: str = None, *, seed: int = 0, n_reps: int = 1,
        horizon: int = None, rate_scale: float = 1.0,
        warmup_frac: float = 0.3, true_labels=None, max_time: float = None,
        device="cuda", devices=None) -> dict:
    """Run ``scenario`` on ``engine`` (default: the scenario's preferred
    compatible engine — simfast for batch workloads, stream otherwise) on
    ``device``.

    Returns ``{"engine", "scenario", "config", "metrics", "raw"}``:
    ``config`` is the lowered engine config, ``metrics`` the engine's
    summary dict and ``raw`` the engine's output (tensors for simfast and
    stream, a list of ``LabelResult`` for events); with ``trace.enabled``,
    ``trace`` the trace artifact's lines (and ``events_trace``, the
    recorder, on events). Engine knobs: ``horizon`` / ``rate_scale`` /
    ``warmup_frac`` (stream; ``horizon`` defaults to the spec's),
    ``true_labels`` (batch engines), ``max_time`` (events: the budget in
    simulated seconds); on events ``n_reps`` runs seeds ``seed .. seed +
    n_reps - 1``. ``devices`` lists the device groups of a device-sharded
    stream scenario (``sharding.n_devices > 1``; see
    :func:`~repro_torch.launch.mesh.make_stream_mesh`) or the devices the
    batch engine splits its replications across.
    """
    if not isinstance(scenario, ScenarioSpec):
        raise TypeError("run() takes a ScenarioSpec (use get_scenario or "
                        f"construct one); got {type(scenario).__name__}")
    engine = _resolve_engine(scenario, engine)
    out = dict(engine=engine, scenario=scenario.name)
    if engine == "stream":
        from repro_torch.labelstream.router import run_stream, stream_summary
        cfg = to_stream_config(scenario)
        raw = run_stream(cfg, horizon if horizon is not None
                         else scenario.horizon, n_reps=n_reps, seed=seed,
                         warmup_frac=warmup_frac, rate_scale=rate_scale,
                         device=device, devices=devices)
        out.update(config=cfg, metrics=stream_summary(cfg, raw), raw=raw)
        return _attach_trace(out, scenario)
    if engine == "simfast":
        from repro_torch.core.simfast import simulate
        from repro_torch.core.simfast_stats import summarize
        cfg = to_fast_config(scenario)
        raw = simulate(cfg, n_reps, seed=seed, true_labels=true_labels,
                       device=device, devices=devices)
        out.update(config=cfg, metrics=dataclasses.asdict(summarize(raw)),
                   raw=raw)
        return _attach_trace(out, scenario)

    # events: the scalar engine, one replication per seed
    from repro_torch.core.clamshell import ClamShell
    cfg = to_cs_config(scenario, seed=seed)
    rec = None
    if scenario.trace.enabled:
        from repro_torch.obs.trace import EventsTrace
        rec = EventsTrace()
    results = []
    for r in range(n_reps):
        cs = ClamShell(to_cs_config(scenario, seed=seed + r), device=device)
        kw = {} if max_time is None else {"max_time": max_time}
        if true_labels is not None:
            kw["true_labels"] = true_labels
            kw["n_classes"] = scenario.n_classes
        if rec is not None:
            kw["trace"] = rec
        results.append(cs.run_labeling(scenario.n_tasks, **kw))
    out.update(config=cfg, metrics=_label_metrics(results), raw=results)
    if rec is not None:
        out["events_trace"] = rec
    return _attach_trace(out, scenario)


def _slice_point(raw, i):
    """Point ``i`` of a sweep's ``(V, n_reps, ...)`` outputs."""
    if isinstance(raw, dict):
        return {k: v if k in ("warmup_t", "measured_s")
                else _slice_point(v, i) for k, v in raw.items()}
    return raw[i]


def _vectorized(axis, values, engine, raw, summary):
    return dict(axis=axis, values=values, engine=engine, vectorized=True,
                results=[summary(_slice_point(raw, i))
                         for i in range(len(values))], raw=raw)


def sweep(scenario, axis: str, values, engine: str = None, *, seed: int = 0,
          n_reps: int = 1, horizon: int = None, warmup_frac: float = 0.3,
          true_labels=None, device="cuda", devices=None) -> dict:
    """Run ``scenario`` at each value of one axis (``axis`` is a dotted
    spec path). The axes the reference vectorizes run as one batched run
    (``vectorized=True``, with the stacked outputs as ``raw``): the stream
    engine's ``arrivals.rate`` (not for mmpp, whose burst rate must not
    scale), ``policy.redundancy.votes`` and the ``StreamTraced`` axes (a
    device-sharded spec runs those per value: ``run_stream_grid`` spends
    its batch on values, not on device groups), and the batch engine's
    ``SimScales`` pool axes (the recruit axis only on a retainer pool) and
    Beta accuracy prior. Anything else runs one :func:`run` per value
    (``vectorized=False``), on ``devices`` as :func:`run` takes them.
    Returns ``{"axis", "values", "engine", "vectorized", "results"}`` with
    ``results[i]`` the metrics dict at ``values[i]``."""
    if not isinstance(scenario, ScenarioSpec):
        raise TypeError("sweep() takes a ScenarioSpec, got "
                        f"{type(scenario).__name__}")
    engine = _resolve_engine(scenario, engine)
    values = list(values)
    H = horizon if horizon is not None else scenario.horizon
    kw = dict(n_reps=n_reps, seed=seed, device=device)

    # the rate scale multiplies the WHOLE offered process: that equals
    # overriding arrivals.rate for poisson and diurnal, but mmpp's burst
    # rate is absolute, so mmpp rate sweeps run per value
    if engine == "stream" and axis in _STREAM_AXES \
            and scenario.arrivals.kind != "mmpp":
        from repro_torch.labelstream.router import (
            run_stream_sweep, stream_summary,
        )
        cfg = to_stream_config(scenario)
        scales = [v / scenario.arrivals.rate for v in values]
        raw = run_stream_sweep(cfg, H, scales, warmup_frac=warmup_frac, **kw)
        return _vectorized(axis, values, engine, raw,
                           lambda o: stream_summary(cfg, o))

    # masked caps: each value still goes through override() first so the
    # spec rejects exactly what a per-value run would reject
    if engine == "stream" and axis == _STREAM_VOTES_AXIS:
        from repro_torch.labelstream.router import (
            run_stream_votes_sweep, stream_summary,
        )
        for v in values:
            override(scenario, {axis: v})
        cfg = to_stream_config(scenario)
        raw = run_stream_votes_sweep(cfg, H, values, warmup_frac=warmup_frac,
                                     **kw)
        return _vectorized(axis, values, engine, raw,
                           lambda o: stream_summary(cfg, o))

    # the Beta accuracy prior and the difficulty mixture through the
    # StreamTraced grid bundle (device-sharded specs run per value)
    if engine == "stream" and axis in _STREAM_TRACED_AXES \
            and scenario.sharding.n_devices == 1:
        from repro_torch.labelstream.router import (
            StreamTraced, run_stream_grid, stream_summary,
        )
        for v in values:
            override(scenario, {axis: v})
        cfg = to_stream_config(scenario)
        V = len(values)
        tr = StreamTraced(
            rate=np.full((V,), cfg.arrivals.rate),
            votes_cap=np.full((V,), cfg.policy.votes_cap, np.int64),
            acc_a=np.full((V,), cfg.acc_a), acc_b=np.full((V,), cfg.acc_b),
            p_hard=np.full((V,), cfg.p_hard),
            hard_scale=np.full((V,), cfg.hard_scale),
        )._replace(**{_STREAM_TRACED_AXES[axis]:
                      np.asarray(values, np.float64)})
        raw = run_stream_grid(cfg, H, tr, warmup_frac=warmup_frac, **kw)
        return _vectorized(axis, values, engine, raw,
                           lambda o: stream_summary(cfg, o))

    if engine == "simfast" and axis in _ACC_AXES:
        from repro_torch.core.simfast import PopTraced, simulate_swept_pop
        from repro_torch.core.simfast_stats import summarize
        for v in values:
            override(scenario, {axis: v})
        cfg = to_fast_config(scenario)
        pop = PopTraced()._replace(**{axis.split(".")[1]:
                                      np.asarray(values, np.float64)})
        raw = simulate_swept_pop(cfg, n_reps, pop, seed=seed,
                                 true_labels=true_labels, device=device,
                                 devices=devices)
        return _vectorized(axis, values, engine, raw,
                           lambda o: dataclasses.asdict(summarize(o)))

    # SimScales.recruit multiplies whichever recruitment mean the engine
    # uses; on a Base-NR (cold) pool that is cold_recruit_mean_s, not the
    # axis's recruit_mean_s, so Base-NR recruit sweeps run per value
    if engine == "simfast" and axis in _SIMFAST_AXES \
            and not (axis == "pool.recruit_mean_s"
                     and not scenario.pool.retainer):
        from repro_torch.core.simfast import SimScales, simulate_swept
        from repro_torch.core.simfast_stats import summarize
        cfg = to_fast_config(scenario)
        base = {"pool.median_mu": scenario.pool.median_mu,
                "pool.session_mean_s": scenario.pool.session_mean_s,
                "pool.recruit_mean_s": scenario.pool.recruit_mean_s}[axis]
        scales = SimScales()._replace(**{
            _SIMFAST_AXES[axis]: np.asarray([v / base for v in values],
                                            np.float32)})
        raw = simulate_swept(cfg, n_reps, scales, seed=seed,
                             true_labels=true_labels, device=device,
                             devices=devices)
        return _vectorized(axis, values, engine, raw,
                           lambda o: dataclasses.asdict(summarize(o)))

    results = []
    for v in values:
        res = run(override(scenario, {axis: v}), engine, seed=seed,
                  n_reps=n_reps, horizon=horizon, warmup_frac=warmup_frac,
                  true_labels=true_labels, device=device, devices=devices)
        results.append(res["metrics"])
    return dict(axis=axis, values=values, engine=engine, vectorized=False,
                results=results)


def _k_active(spec, pool_size: int) -> int:
    # the learner kind as the active/passive split of each pool-sized
    # round: PL buys only random points, AL only uncertainty-sampled ones,
    # HL the al_fraction mix (pool // 2 at the default 0.5, as the engine's
    # own default, so odd pool sizes match it)
    if spec.kind == "PL":
        return 0
    if spec.kind == "AL":
        return pool_size
    if spec.kind == "HL":
        return pool_size // 2 if spec.al_fraction == 0.5 \
            else int(round(spec.al_fraction * pool_size))
    raise ValueError("run_learning engine='simfast' cannot express "
                     f"policy.learner.kind={spec.kind!r}")


def _gaussian_dataset(spec, n_train: int, n_test: int, seed: int):
    from repro_torch.data.datasets import (
        make_classification, train_test_split,
    )
    Xa, ya = make_classification(
        n_samples=n_train + n_test, n_features=spec.n_features,
        n_informative=min(spec.n_features, max(2, spec.n_classes)),
        n_classes=spec.n_classes, class_sep=spec.class_sep, seed=seed)
    return train_test_split(Xa, ya, test_frac=n_test / (n_train + n_test),
                            seed=seed)


def spec_dataset(name: str, n_train: int = 1500, n_test: int = 500,
                 seed: int = 0, overrides: dict = None):
    """The named workload's Gaussian dataset as :func:`run_learning` builds
    it: ``make_classification`` with the spec's width and separation and
    ``n_informative = min(n_features, max(2, n_classes))``, split
    ``n_train``/``n_test``. Returns numpy ``(X, y, X_test, y_test)``."""
    return _gaussian_dataset(get_learning_spec(name, overrides), n_train,
                             n_test, seed)


def run_learning(scenario, X=None, y=None, X_test=None, y_test=None,
                 engine: str = "simfast", *, vectorized: bool = True,
                 rounds: int = 10, n_reps: int = 64, seed: int = 0,
                 fit_steps: int = 60, k_active=None, use_kernel: bool = True,
                 accest=None, n_train: int = 1500, n_test: int = 500,
                 device="cuda", draws=None, overrides: dict = None,
                 embed_draws: dict = None, label_budget: int = 500,
                 max_time: float = 6 * 3600.0):
    """Hybrid learning on a scenario: a :class:`ScenarioSpec`, or a registry
    name with the reference's dotted ``overrides`` (see
    :func:`~repro_torch.scenarios.registry.get_learning_spec`).

    With ``X=None`` the dataset is built from the spec, seeded with
    ``seed``: Gaussian features as :func:`spec_dataset`, or for
    ``features.kind="lm"`` :func:`~repro_torch.embed.bank.make_dataset` on
    ``device``, with ``embed_draws`` (its ``u``/``ul``/``params``/``proj``)
    replacing its draws. Otherwise pass all of ``X``/``y``/``X_test``/
    ``y_test``. ``vectorized`` runs
    :func:`~repro_torch.core.simfast.simulate_learning_batch` over
    ``n_reps`` replications, else the scalar
    :func:`~repro_torch.core.simfast.simulate_learning` (with ``accest``);
    the learner kind sets each round's active / passive split unless
    ``k_active`` does. ``draws`` replaces the rounds' draws. Returns the
    engine's result with the config.

    ``engine="events"`` runs the paper's simulator,
    :meth:`~repro_torch.core.clamshell.ClamShell.run_learning`: one
    replication, its learner policy (kind, fractions, asynchronous
    retraining, decision latency) from ``policy.learner``, up to
    ``label_budget`` labels or ``max_time`` simulated seconds; the batch
    engine's knobs (``n_reps``, ``rounds``, ``fit_steps``, ``use_kernel``,
    ``vectorized``, ``accest``, ``k_active``, ``draws``) do not apply
    there. With a registry name, ``overrides`` are dotted spec paths.
    Returns ``{"engine", "scenario", "config", "curve", "result"}``.
    """
    from repro_torch.core.simfast import (
        simulate_learning, simulate_learning_batch,
    )
    from repro_torch.device import resolve_device
    from repro_torch.embed.bank import make_dataset

    dev = resolve_device(device)
    if engine not in ("events", "simfast"):
        raise ValueError("run_learning engine must be 'events' or "
                         f"'simfast', got {engine!r}")
    if isinstance(scenario, str) and engine == "events":
        scenario = get_scenario(scenario, overrides)
        overrides = None
    if isinstance(scenario, str):
        name = scenario
        cfg = get_fast_config(name)
        spec = get_learning_spec(name, overrides)
    elif isinstance(scenario, ScenarioSpec):
        if overrides:
            scenario = override(scenario, overrides)
        name, spec = scenario.name, learning_spec(scenario)
        # the batch engine consumes the dataset's matrix, not in-tick
        # feature draws: lower the config with the feature kind stripped
        cfg = to_fast_config(override(scenario, {"features.kind": "gaussian"})
                             if spec.feature_kind != "gaussian" else scenario)
    else:
        raise TypeError("run_learning() takes a ScenarioSpec or a registry "
                        f"name, got {type(scenario).__name__}")
    if X is None:
        if y is not None or X_test is not None or y_test is not None:
            raise ValueError("run_learning: pass all of X/y/X_test/y_test "
                             "or none (spec-built dataset)")
        if spec.feature_kind == "lm":
            X, y, X_test, y_test = make_dataset(
                spec, n_train, n_test, seed=seed, device=dev,
                **(embed_draws or {}))
        else:
            X, y, X_test, y_test = _gaussian_dataset(spec, n_train, n_test,
                                                     seed)
    elif y is None or X_test is None or y_test is None:
        raise ValueError("run_learning: pass all of X/y/X_test/y_test "
                         "or none (spec-built dataset)")
    if engine == "events":
        from repro_torch.core.clamshell import ClamShell
        host = lambda a: a.cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)  # noqa: E731
        # the event loop consumes the matrix built above: lower the config
        # with the feature kind stripped, as the batch engine does
        ccfg = to_cs_config(override(scenario, {"features.kind": "gaussian"})
                            if spec.feature_kind != "gaussian" else scenario,
                            seed=seed)
        curve, res = ClamShell(ccfg, device=dev).run_learning(
            host(X), host(y), host(X_test), host(y_test),
            label_budget=label_budget, max_time=max_time)
        return dict(engine="events", scenario=name, config=ccfg,
                    curve=curve, result=res)
    if k_active is None:
        k_active = _k_active(spec, cfg.pool_size)
    kw = dict(rounds=rounds, seed=seed, fit_steps=fit_steps,
              k_active=k_active, use_kernel=use_kernel,
              decision_latency_s=spec.decision_latency_s, device=dev,
              draws=draws)
    if vectorized:
        raw = simulate_learning_batch(cfg, X, y, X_test, y_test,
                                      n_reps=n_reps, **kw)
        return dict(engine="simfast", scenario=name, config=cfg, raw=raw,
                    curve=raw["curve"])
    curve, info = simulate_learning(cfg, X, y, X_test, y_test, accest=accest,
                                    **kw)
    return dict(engine="simfast", scenario=name, config=cfg, curve=curve,
                raw=info)
