"""The port's streaming labeling tick against the JAX package's router.

Parity with injected draws: the reference's initial state (worker banks,
counter seeds) and its per-tick arrival counts are computed here with the
reference's own threefry calls, exactly as ``router._run_one`` makes them,
and handed to the port through ``state_from_numpy`` and ``run_stream(...,
arrivals=...)``. Every other draw of the tick comes from the counter hash
both packages share, so every integer output must be equal; float sums
(``sum_tis``, costs) agree within rtol 1e-5. Reference calls run inside
``jax.threefry_partitionable(False)``.
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

from repro.labelstream import router as jr  # noqa: E402
from repro.labelstream import arrivals as jarr  # noqa: E402
from repro.scenarios import get_scenario  # noqa: E402
from repro.scenarios.compile import to_stream_config  # noqa: E402
from repro_torch.kernels.ds_estep import ds_estep  # noqa: E402
from repro_torch.labelstream import router as tr  # noqa: E402
from repro_torch.labelstream import (  # noqa: E402
    ShardingConfig, StreamLearnerConfig,
)
from repro_torch.labelstream.routing import RoutingConfig  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    get_stream_config, list_stream_configs,
)

# the FIFO tick's workloads; the learner-aware ones are held in
# tests/test_torch_stream_learner.py
FIFO = ["stream_default", "stream_batch_replay", "skewed_fixed5",
        "skewed_adaptive5"]
NAMES = FIFO + ["skewed_learner_fused", "heterogeneous_pool",
                "heterogeneous_routed", "bursty_admission",
                "bursty_admission_uncertain", "chance_hard", "stream_sharded"]
REFRESH = {"refresh_every": 40, "refresh_iters": 6}
H, N = 200, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the tick is hundreds of tiny ops: threads only add overhead, and the
    # suite runs several workers at once
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_cfg(name, overrides=None):
    cfg = to_stream_config(get_scenario(name))
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _ref_draws(cfg, horizon, n_reps, seed):
    """The reference's threefry draws of ``run_stream(cfg, horizon,
    n_reps=n_reps, seed=seed)``: per-shard initial worker state, banks and
    counter seeds (router.py:1114-1124), and per-tick arrival totals and
    per-shard counts before the per-shard cap (router.py:1165-1177)."""
    S, M = cfg.n_shards, cfg.max_arrivals_per_tick
    cap_total = M * S

    def one(key):
        k_init, k_seed, k_run = jax.random.split(key, 3)
        init_kd = jax.random.key_data(jax.random.split(k_init, S))
        seeds = jax.random.bits(k_seed, (S,), jnp.uint32)
        ws, banks, _, _ = jax.vmap(lambda kd: jr._init_shard(
            cfg, jax.random.wrap_key_data(kd)))(init_kd)

        def tick(carry, _):
            key, arr, t = carry
            key, k_arr, k_sid = jax.random.split(key, 3)
            n_new, arr, _ = jarr.sample_arrivals(
                cfg.arrivals, arr, k_arr, t, cfg.dt, jnp.float32(1.0), None)
            n_cap = jnp.minimum(n_new, cap_total)
            sid = jax.random.randint(k_sid, (cap_total,), 0, S)
            valid = jnp.arange(cap_total) < n_cap
            n_arr = jnp.zeros((S + 1,), jnp.int32).at[
                jnp.where(valid, sid, S)].add(1)[:S]
            return (key, arr, t + cfg.dt), (n_new, n_arr)

        _, (n_new, n_arr) = jax.lax.scan(
            tick, (k_run, jarr.init_arrival_state(cfg.arrivals),
                   jnp.zeros(())), None,
            length=horizon)
        return ws, banks, seeds, n_new, n_arr

    keys = jax.random.split(jax.random.key(seed), n_reps)
    ws, banks, seeds, n_new, n_arr = jax.jit(jax.vmap(one))(keys)
    host = lambda d: {k: np.asarray(v) for k, v in d.items()}
    return (host(ws), host(banks), np.asarray(seeds),
            np.asarray(n_new).T, np.asarray(n_arr).transpose(1, 0, 2))


def _assert_outputs_match(got, want):
    for k, v in want.items():
        if k in ("warmup_t", "measured_s"):
            assert got[k] == pytest.approx(float(v), rel=1e-12), k
            continue
        if isinstance(v, dict):
            _assert_outputs_match(got[k], v)
            continue
        w = np.asarray(v)
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_summaries_match(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, float) and math.isfinite(w):
            assert got[k] == pytest.approx(w, rel=1e-5), k
        else:
            assert got[k] == w, k


def test_registry_configs_match_reference():
    assert list_stream_configs() == sorted(NAMES)
    for name in NAMES:
        want = dataclasses.asdict(_ref_cfg(name))
        got = dataclasses.asdict(get_stream_config(name))
        assert got == want, name
    assert get_stream_config("skewed_adaptive5", REFRESH).refresh_every == 40
    with pytest.raises(KeyError):
        get_stream_config("lm_stream")


@pytest.mark.parametrize("name,overrides", [(n, None) for n in FIFO]
                         + [("skewed_adaptive5", REFRESH)])
def test_stream_matches_reference_with_injected_draws(name, overrides):
    seed = 3
    jcfg = _ref_cfg(name, overrides)
    with jax.threefry_partitionable(False):
        want = jr.run_stream(jcfg, H, n_reps=N, seed=seed)
        ws, banks, seeds, n_new, n_arr = _ref_draws(jcfg, H, N, seed)
    want = jax.tree_util.tree_map(np.asarray, dict(want))
    assert int(want["done"].sum()) > 0
    cfg = get_stream_config(name, overrides)
    init = tr.state_from_numpy(cfg, ws, banks, seeds, "cpu")
    before = ds_estep.launches
    got = tr.run_stream(cfg, H, n_reps=N, device="cpu", init=init,
                        arrivals=(n_new, n_arr))
    assert ds_estep.launches == before             # plain version on the CPU
    _assert_outputs_match(got, want)
    _assert_summaries_match(tr.stream_summary(cfg, got),
                            jr.stream_summary(jcfg, want))


@pytest.mark.parametrize("change,err", [
    (dict(learner=StreamLearnerConfig(enabled=True, feature_kind="lm")),
     NotImplementedError),
    (dict(trace=object()), NotImplementedError),
    (dict(sharding=ShardingConfig(n_devices=2)), NotImplementedError),
    (dict(serve=True), ValueError),
    (dict(routing=RoutingConfig(admission="uncertain")), ValueError),
    (dict(routing=RoutingConfig(admission="lifo")), ValueError),
    (dict(sharding=ShardingConfig(steal="greedy")), ValueError),
    (dict(sharding=ShardingConfig(steal="pressure"),
          routing=RoutingConfig(admission="uncertain"),
          learner=StreamLearnerConfig(enabled=True)), ValueError),
    (dict(sharding=ShardingConfig(steal="pressure", steal_max=0)),
     ValueError),
    (dict(sharding=ShardingConfig(steal="pressure", steal_slack=-1)),
     ValueError),
    (dict(sharding=ShardingConfig(n_devices=3)), ValueError),
    (dict(learner=StreamLearnerConfig(feature_kind="lm")), ValueError),
    (dict(learner=StreamLearnerConfig(feature_kind="text")), ValueError),
    (dict(n_classes=4, learner=StreamLearnerConfig(enabled=True,
                                                   n_features=2)),
     ValueError),
])
def test_unported_or_invalid_configs_raise(change, err):
    cfg = dataclasses.replace(get_stream_config("stream_default"), **change)
    with pytest.raises(err):
        tr.run_stream(cfg, 5, n_reps=1, device="cpu")


def test_cuda_run_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.run_stream(get_stream_config("stream_default"), 5, n_reps=1)
