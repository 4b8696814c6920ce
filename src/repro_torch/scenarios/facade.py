"""The execution facade: ``run(scenario, engine=...)``, ``sweep(scenario,
axis=..., values=...)`` and ``run_learning`` (port of
``src/repro/scenarios/facade.py``).

    from repro_torch import scenarios
    res = scenarios.run(scenarios.get_scenario("heterogeneous_pool"),
                        engine="stream", horizon=1200, n_reps=4, seed=0)
    res["metrics"]["votes_per_task"]

``run`` lowers the spec to the engine's config and calls the engine's entry
point with it (:func:`~repro_torch.labelstream.router.run_stream` +
``stream_summary``, or :func:`~repro_torch.core.simfast.simulate` +
``summarize``), so a run equals that call bit for bit. Every entry point
runs on the card unless the caller passes ``device="cpu"``.

``sweep`` runs one ``run`` per value of an axis, as the reference does for
every axis it does not trace. The axes the reference traces into one
vectorized program (the stream engine's offered rate, votes cap and
``StreamTraced`` axes; the batch engine's ``SimScales`` / ``PopTraced``
pool axes) raise ``NotImplementedError`` until those programs are ported
(ROADMAP A5f, A8): the reference's vectorized points equal per-value runs
only at scale 1.0, so looping instead would return other numbers.

The event-loop engine is not ported (ROADMAP A9): ``engine="events"``
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.scenarios.compile import (
    engines, to_fast_config, to_stream_config,
)
from repro_torch.scenarios.registry import (
    get_fast_config, get_learning_spec, get_scenario, learning_spec,
)
from repro_torch.scenarios.spec import ScenarioSpec, override

#: simfast axes the reference sweeps through ``SimScales``
_SIMFAST_AXES = ("pool.median_mu", "pool.session_mean_s",
                 "pool.recruit_mean_s")
#: the stream axis the reference sweeps through the traced rate scale
_STREAM_AXES = ("arrivals.rate",)
#: the stream axis the reference sweeps through the masked votes cap
_STREAM_VOTES_AXIS = "policy.redundancy.votes"
#: Beta accuracy-prior axes (simfast ``PopTraced``)
_ACC_AXES = ("pool.acc_a", "pool.acc_b")
#: stream axes of the reference's ``StreamTraced`` bundle
_STREAM_TRACED_AXES = ("pool.acc_a", "pool.acc_b", "difficulty.p_hard",
                       "difficulty.hard_scale")


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
    if engine == "events":
        raise NotImplementedError("the event-loop engine is not ported yet "
                                  "(ROADMAP A9)")
    return engine


def run(scenario, engine: str = None, *, seed: int = 0, n_reps: int = 1,
        horizon: int = None, rate_scale: float = 1.0,
        warmup_frac: float = 0.3, true_labels=None, device="cuda") -> dict:
    """Run ``scenario`` on ``engine`` (default: the scenario's preferred
    compatible engine — simfast for batch workloads, stream otherwise) on
    ``device``.

    Returns ``{"engine", "scenario", "config", "metrics", "raw"}``:
    ``config`` is the lowered engine config, ``metrics`` the engine's
    summary dict and ``raw`` the engine's output tensors. Engine knobs:
    ``horizon`` / ``rate_scale`` / ``warmup_frac`` (stream; ``horizon``
    defaults to the spec's), ``true_labels`` (simfast).
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
                         device=device)
        out.update(config=cfg, metrics=stream_summary(cfg, raw), raw=raw)
        return out
    from repro_torch.core.simfast import simulate
    from repro_torch.core.simfast_stats import summarize
    cfg = to_fast_config(scenario)
    raw = simulate(cfg, n_reps, seed=seed, true_labels=true_labels,
                   device=device)
    out.update(config=cfg, metrics=dataclasses.asdict(summarize(raw)),
               raw=raw)
    return out


def _vectorized_in_reference(spec: ScenarioSpec, engine: str, axis: str):
    """The ROADMAP item that ports the reference's vectorized sweep of
    ``axis`` on ``engine``, or None where the reference runs per value."""
    if engine == "stream":
        if axis in _STREAM_AXES and spec.arrivals.kind != "mmpp":
            return "A5f"
        if axis == _STREAM_VOTES_AXIS:
            return "A5f"
        if axis in _STREAM_TRACED_AXES and spec.sharding.n_devices == 1:
            return "A5f"
    if engine == "simfast":
        if axis in _ACC_AXES:
            return "A8"
        # a Base-NR pool's recruit axis is swept per value in the reference
        if axis in _SIMFAST_AXES and not (axis == "pool.recruit_mean_s"
                                          and not spec.pool.retainer):
            return "A8"
    return None


def sweep(scenario, axis: str, values, engine: str = None, *, seed: int = 0,
          n_reps: int = 1, horizon: int = None, warmup_frac: float = 0.3,
          true_labels=None, device="cuda") -> dict:
    """Run ``scenario`` at each value of one axis, one :func:`run` per
    value (``axis`` is a dotted spec path). Returns ``{"axis", "values",
    "engine", "vectorized", "results"}`` with ``results[i]`` the metrics
    dict at ``values[i]`` and ``vectorized=False``. An axis the reference
    sweeps in one vectorized program raises ``NotImplementedError``."""
    if not isinstance(scenario, ScenarioSpec):
        raise TypeError("sweep() takes a ScenarioSpec, got "
                        f"{type(scenario).__name__}")
    engine = _resolve_engine(scenario, engine)
    values = list(values)
    item = _vectorized_in_reference(scenario, engine, axis)
    if item is not None:
        raise NotImplementedError(
            f"sweep over {axis!r} on engine {engine!r} is vectorized in the "
            f"reference and not ported yet (ROADMAP {item})")
    results = []
    for v in values:
        res = run(override(scenario, {axis: v}), engine, seed=seed,
                  n_reps=n_reps, horizon=horizon, warmup_frac=warmup_frac,
                  true_labels=true_labels, device=device)
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
                 embed_draws: dict = None):
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
    engine's result with the config. ``engine="events"`` (the reference's
    event loop) is not ported yet (ROADMAP A9).
    """
    from repro_torch.core.simfast import (
        simulate_learning, simulate_learning_batch,
    )
    from repro_torch.device import resolve_device
    from repro_torch.embed.bank import make_dataset

    dev = resolve_device(device)
    if engine == "events":
        raise NotImplementedError("run_learning on the event-loop engine is "
                                  "not ported yet (ROADMAP A9)")
    if engine != "simfast":
        raise ValueError("run_learning engine must be 'events' or "
                         f"'simfast', got {engine!r}")
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
