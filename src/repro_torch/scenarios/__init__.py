"""repro_torch.scenarios: the declarative Scenario/Policy layer over the
port's engines (port of ``src/repro/scenarios``).

    from repro_torch import scenarios

    spec = scenarios.get_scenario("heterogeneous_pool")
    res = scenarios.run(spec, engine="stream", horizon=1200, n_reps=4)
    res = scenarios.sweep(scenarios.get_scenario("smallR1"),
                          axis="policy.redundancy.votes", values=[1, 3])

The pieces:

  * ``spec``      — frozen, validated :class:`ScenarioSpec` (workload) and
    :class:`PolicySpec` (system response), and ``override`` for dotted-path
    functional updates;
  * ``registry``  — ``register_scenario`` / ``get_scenario`` /
    ``list_scenarios``: the named canonical workloads, and the port's
    name-keyed ``get_stream_config`` / ``get_fast_config`` /
    ``get_learning_spec`` over them;
  * ``facade``    — ``run`` / ``sweep`` / ``run_learning`` on the stream and
    batch engines;
  * ``compile``   — spec -> engine config lowering, field for field the
    reference's.

Exports resolve lazily (PEP 562), so importing the specs does not import
the engines.
"""
import importlib

_EXPORTS = {
    # specs
    "ScenarioSpec": "spec",
    "PolicySpec": "spec",
    "ArrivalSpec": "spec",
    "DifficultySpec": "spec",
    "FeatureSpec": "spec",
    "PoolSpec": "spec",
    "EngineKnobs": "spec",
    "StragglerSpec": "spec",
    "MaintenanceSpec": "spec",
    "RedundancySpec": "spec",
    "RoutingSpec": "spec",
    "AdmissionSpec": "spec",
    "LearnerSpec": "spec",
    "ShardingSpec": "spec",
    "TraceSpec": "spec",
    "ServeSpec": "spec",
    "EmbedSpec": "spec",
    "GridSpec": "spec",
    "override": "spec",
    # registry
    "register_scenario": "registry",
    "get_scenario": "registry",
    "list_scenarios": "registry",
    "register_grid": "registry",
    "get_grid": "registry",
    "list_grids": "registry",
    "LearningSpec": "registry",
    "learning_spec": "registry",
    "get_fast_config": "registry",
    "get_learning_spec": "registry",
    "get_stream_config": "registry",
    "list_fast_configs": "registry",
    "list_stream_configs": "registry",
    # facade
    "run": "facade",
    "sweep": "facade",
    "run_learning": "facade",
    "spec_dataset": "facade",
    # compilation + engine compatibility
    "engines": "compile",
    "compile_for": "compile",
    "to_fast_config": "compile",
    "to_stream_config": "compile",
    "to_serve_config": "compile",
    "to_cs_config": "compile",
    "to_embed_config": "compile",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        value = getattr(mod, name)
        globals()[name] = value          # cache for subsequent lookups
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
