"""labelstream: online streaming labeling service (PyTorch port).

Tasks arrive continuously (``arrivals``), the router admits them into a
ring-buffer task window over sharded retainer pools (``router``), votes are
aggregated by a batched full-confusion Dawid-Skene EM (``aggregate``, on
the Hopper ``ds_estep`` kernel), and posterior-confidence adaptive
redundancy (``policy``) stops requesting votes once a task's posterior is
confident. ``run_stream_sweep`` / ``run_stream_votes_sweep`` /
``run_stream_grid`` run a sweep's points as rows of one batched run;
``serve_init`` / ``serve_tick`` step the same tick with injected arrivals
for the live front end (``repro_torch.serving``). Exports resolve lazily,
as in the reference package.
"""
import importlib

_EXPORTS = {
    "dawid_skene": "aggregate",
    "dawid_skene_batch": "aggregate",
    "pack_votes": "aggregate",
    "aggregate_votes": "aggregate",
    "ArrivalConfig": "arrivals",
    "sample_arrivals": "arrivals",
    "PolicyConfig": "policy",
    "RoutingConfig": "routing",
    "StreamConfig": "router",
    "StreamLearnerConfig": "router",
    "ShardingConfig": "router",
    "StreamTraced": "router",
    "heterogeneous_stream_config": "router",
    "run_stream": "router",
    "run_stream_sweep": "router",
    "run_stream_votes_sweep": "router",
    "run_stream_grid": "router",
    "stream_summary": "router",
    "serve_init": "router",
    "serve_tick": "router",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        value = getattr(mod, name)
        globals()[name] = value          # cache for subsequent lookups
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
