"""The port's batched sweeps against the JAX package's vectorized ones: the
stream engine's rate, votes-cap and grid sweeps (``run_stream_sweep``,
``run_stream_votes_sweep``, ``run_stream_grid``) and the batch engine's
``simulate_swept`` / ``simulate_swept_pop``.

Against the reference, each point's draws are injected: the reference
shares one set of keys across its points, so point i's initial state and
arrivals are the reference's draws at point i's values (the harness of
``tests/test_torch_stream.py`` and ``tests/test_torch_batch_engine.py``),
and every integer output of every point must be equal, floats within the
tolerances those files state. Against the port itself, on its own RNG,
every point must equal the port's standalone run at that value and seed,
bit for bit. Reference calls run inside
``jax.threefry_partitionable(False)``.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import simfast as js  # noqa: E402
from repro.labelstream import arrivals as jarr  # noqa: E402
from repro.labelstream import router as jr  # noqa: E402
from repro.scenarios import get_scenario as jget  # noqa: E402
from repro.scenarios.compile import to_fast_config as jfast  # noqa: E402
from repro_torch.core import simfast as ts  # noqa: E402
from repro_torch.labelstream import router as tr  # noqa: E402
from repro_torch.obs import timing  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    get_fast_config, get_stream_config,
)
from test_torch_batch_engine import _np_tree  # noqa: E402
from test_torch_stream import (  # noqa: E402
    REFRESH, _assert_outputs_match, _ref_cfg,
)

H, N, SEED = 120, 2, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_point_draws(cfg, horizon, n_reps, seed, rate_scale=1.0,
                     rate_abs=None, pop=None):
    """The reference's threefry draws of one sweep point: ``_run_one``'s
    initial state (with the point's ``PopTraced`` accuracy prior) and its
    arrivals (at the point's rate scale or absolute rate), as in
    ``tests/test_torch_stream.py::_ref_draws``."""
    S, M = cfg.n_shards, cfg.max_arrivals_per_tick
    cap_total = M * S

    def one(key):
        k_init, k_seed, k_run = jax.random.split(key, 3)
        init_kd = jax.random.key_data(jax.random.split(k_init, S))
        seeds = jax.random.bits(k_seed, (S,), jnp.uint32)
        ws, banks, _, _ = jax.vmap(lambda kd: jr._init_shard(
            cfg, jax.random.wrap_key_data(kd), pop))(init_kd)

        def tick(carry, _):
            key, arr, t = carry
            key, k_arr, k_sid = jax.random.split(key, 3)
            n_new, arr, _ = jarr.sample_arrivals(
                cfg.arrivals, arr, k_arr, t, cfg.dt,
                jnp.float32(rate_scale),
                None if rate_abs is None else jnp.float32(rate_abs))
            n_cap = jnp.minimum(n_new, cap_total)
            sid = jax.random.randint(k_sid, (cap_total,), 0, S)
            valid = jnp.arange(cap_total) < n_cap
            n_arr = jnp.zeros((S + 1,), jnp.int32).at[
                jnp.where(valid, sid, S)].add(1)[:S]
            return (key, arr, t + cfg.dt), (n_new, n_arr)

        _, (n_new, n_arr) = jax.lax.scan(
            tick, (k_run, jarr.init_arrival_state(cfg.arrivals),
                   jnp.zeros(())), None, length=horizon)
        return ws, banks, seeds, n_new, n_arr

    keys = jax.random.split(jax.random.key(seed), n_reps)
    ws, banks, seeds, n_new, n_arr = jax.jit(jax.vmap(one))(keys)
    host = lambda d: {k: np.asarray(v) for k, v in d.items()}
    return ((host(ws), host(banks), np.asarray(seeds)),
            (np.asarray(n_new).T, np.asarray(n_arr).transpose(1, 0, 2)))


def _point(out, i):
    if isinstance(out, dict):
        return {k: v if k in ("warmup_t", "measured_s") else _point(v, i)
                for k, v in out.items()}
    return out[i]


def _host(out):
    return jax.tree_util.tree_map(np.asarray, dict(out))


def _assert_points_match(got, want, V):
    for i in range(V):
        _assert_outputs_match(_point(got, i), _point(want, i))


def _same(a, b, path=""):
    assert a.keys() == b.keys(), path
    for k, v in a.items():
        if isinstance(v, dict):
            _same(v, b[k], f"{path}{k}.")
        elif torch.is_tensor(v):
            assert torch.equal(v, b[k]), path + k
        else:
            assert v == b[k], path + k


# ---- stream sweeps against the reference ---------------------------------

def test_rate_sweep_matches_reference_with_injected_draws():
    scales = [0.5, 1.0, 2.0, 4.0]
    jcfg = _ref_cfg("heterogeneous_pool")
    with jax.threefry_partitionable(False):
        want = _host(jr.run_stream_sweep(jcfg, H, scales, n_reps=N,
                                         seed=SEED, shard=False))
        draws = [_ref_point_draws(jcfg, H, N, SEED, rate_scale=s)
                 for s in scales]
    got = tr.run_stream_sweep(get_stream_config("heterogeneous_pool"), H,
                              scales, n_reps=N, device="cpu", draws=draws)
    assert tuple(got["done"].shape) == (4, N)
    _assert_points_match(got, want, 4)
    done = want["done"].sum(-1)
    assert (done[1:] > done[:-1]).all()          # more load, more labels


def test_votes_sweep_matches_reference_with_injected_draws():
    """``skewed_adaptive5`` with the EM refresh, caps 3 / 5 / 7 / 9: the
    vote buffers and the refresh's E-step are 9 votes wide."""
    caps = [3, 5, 7, 9]
    jcfg = _ref_cfg("skewed_adaptive5", REFRESH)
    with jax.threefry_partitionable(False):
        want = _host(jr.run_stream_votes_sweep(jcfg, H, caps, n_reps=N,
                                               seed=SEED))
        draws = [_ref_point_draws(jcfg, H, N, SEED)] * len(caps)
    cfg = get_stream_config("skewed_adaptive5", REFRESH)
    got = tr.run_stream_votes_sweep(cfg, H, caps, n_reps=N, device="cpu",
                                    draws=draws)
    _assert_points_match(got, want, 4)
    vpt = want["votes_fin"].sum(-1) / want["done"].sum(-1)
    assert vpt[-1] > vpt[0]


@pytest.mark.parametrize("name,field,values", [
    ("stream_default", "acc_a", [4.0, 18.0, 40.0]),
    ("chance_hard", "p_hard", [0.0, 0.25, 0.5]),
])
def test_grid_matches_reference_with_injected_draws(name, field, values):
    jcfg = _ref_cfg(name)
    V = len(values)
    base = dict(rate=jcfg.arrivals.rate, votes_cap=jcfg.policy.votes_cap,
                acc_a=jcfg.acc_a, acc_b=jcfg.acc_b, p_hard=jcfg.p_hard,
                hard_scale=jcfg.hard_scale)
    leaves = {k: np.full((V,), v, np.int32 if k == "votes_cap"
                         else np.float32) for k, v in base.items()}
    leaves[field] = np.asarray(values, np.float32)
    with jax.threefry_partitionable(False):
        want = _host(jr.run_stream_grid(jcfg, H, jr.StreamTraced(**leaves),
                                        n_reps=N, seed=SEED, shard=False))
        draws = [_ref_point_draws(
            jcfg, H, N, SEED, rate_abs=base["rate"],
            pop=js.PopTraced(acc_a=jnp.float32(leaves["acc_a"][i]),
                             acc_b=jnp.float32(leaves["acc_b"][i])))
            for i in range(V)]
    got = tr.run_stream_grid(
        get_stream_config(name), H,
        tr.StreamTraced(**{field: np.asarray(values)}), n_reps=N,
        device="cpu", draws=draws)
    _assert_points_match(got, want, V)


# ---- stream sweeps against the port's own standalone runs ----------------

def test_rate_sweep_points_equal_standalone_runs():
    cfg = get_stream_config("stream_sharded")
    scales = [0.5, 4.0, 20.0]
    got = tr.run_stream_sweep(cfg, 80, scales, n_reps=N, seed=SEED,
                              device="cpu")
    for i, s in enumerate(scales):
        _same(_point(got, i), tr.run_stream(cfg, 80, n_reps=N, seed=SEED,
                                            rate_scale=s, device="cpu"))
    assert int(got["stolen"][-1].sum()) > 0


def test_votes_sweep_points_equal_standalone_runs():
    cfg = get_stream_config("skewed_adaptive5", REFRESH)
    caps = [3, 9, 5]
    got = tr.run_stream_votes_sweep(cfg, H, caps, n_reps=N, seed=SEED,
                                    device="cpu")
    for i, c in enumerate(caps):
        one = dataclasses.replace(cfg, policy=dataclasses.replace(
            cfg.policy, votes_cap=c))
        _same(_point(got, i), tr.run_stream(one, H, n_reps=N, seed=SEED,
                                            device="cpu"))


def test_grid_cells_equal_standalone_runs():
    """Every StreamTraced axis at once, the learner and uncertainty
    admission on (``chance_hard`` under ``uncertain``): each cell equals
    ``run_stream`` on the config with the cell's values, and a cell of
    sentinels equals the config's own run."""
    from repro_torch.labelstream.routing import RoutingConfig
    cfg = get_stream_config("chance_hard", {"routing": RoutingConfig(
        enabled=True, admission="uncertain")})
    grid = tr.StreamTraced(rate=[0.0, 0.05, 0.02],
                           votes_cap=[0, 3, 4],
                           acc_a=[0.0, 4.0, 9.0], acc_b=[0.0, 1.5, 0.0],
                           p_hard=[-1.0, 0.0, 0.75],
                           hard_scale=[-1.0, 0.5, 0.2])
    got = tr.run_stream_grid(cfg, 80, grid, n_reps=N, seed=SEED,
                             device="cpu")
    cells = [cfg,
             dataclasses.replace(
                 cfg, arrivals=dataclasses.replace(cfg.arrivals, rate=0.05),
                 policy=dataclasses.replace(cfg.policy, votes_cap=3),
                 acc_a=4.0, acc_b=1.5, p_hard=0.0, hard_scale=0.5),
             dataclasses.replace(
                 cfg, arrivals=dataclasses.replace(cfg.arrivals, rate=0.02),
                 policy=dataclasses.replace(cfg.policy, votes_cap=4),
                 acc_a=9.0, p_hard=0.75, hard_scale=0.2)]
    for i, one in enumerate(cells):
        _same(_point(got, i), tr.run_stream(one, 80, n_reps=N, seed=SEED,
                                            device="cpu"))


def test_stream_sweep_validation_matches_reference():
    for fn_t, fn_j in (
            (lambda: tr.run_stream_votes_sweep(
                get_stream_config("stream_default"), 5, [], device="cpu"),
             lambda: jr.run_stream_votes_sweep(_ref_cfg("stream_default"),
                                               5, [])),
            (lambda: tr.run_stream_votes_sweep(
                get_stream_config("stream_default"), 5, [0, 3],
                device="cpu"),
             lambda: jr.run_stream_votes_sweep(_ref_cfg("stream_default"),
                                               5, [0, 3])),
            (lambda: tr.run_stream_grid(
                get_stream_config("stream_default"), 5,
                tr.StreamTraced(votes_cap=[9]), device="cpu"),
             lambda: jr.run_stream_grid(_ref_cfg("stream_default"), 5,
                                        jr.StreamTraced(votes_cap=[9]))),
            (lambda: tr.run_stream_grid(
                get_stream_config("stream_default"), 5,
                tr.StreamTraced(p_hard=[1.5]), device="cpu"),
             lambda: jr.run_stream_grid(_ref_cfg("stream_default"), 5,
                                        jr.StreamTraced(p_hard=[1.5])))):
        with pytest.raises(ValueError) as e:
            fn_j()
        want = str(e.value)
        with pytest.raises(ValueError) as e:
            fn_t()
        assert str(e.value) == want


def test_grid_timing_name_records_the_execute_time():
    timing.clear()
    tr.run_stream_grid(get_stream_config("stream_default"), 10,
                       tr.StreamTraced(acc_a=[2.0, 3.0]), device="cpu",
                       timing_name="grid[test]")
    names = [e["name"] for e in timing.summary()]
    assert names == ["grid[test].execute"]
    timing.clear()


# ---- the batch engine's sweeps --------------------------------------------

def _ref_pop_draws(cfg, n_reps, seed, pop):
    """The reference's per-replication draws of one ``simulate_swept_pop``
    point (``_simulate_one`` with the point's ``PopTraced``)."""
    def one(key):
        k_init, k_run = jax.random.split(key)
        ws, banks = js._init_workers(cfg, k_init, pop)
        return ws, banks, jax.random.bits(k_run, (), jnp.uint32)
    keys = jax.random.split(jax.random.key(seed), n_reps)
    ws, banks, s = jax.vmap(one)(keys)
    return dict(ws=_np_tree(ws), banks=_np_tree(banks), seed=np.asarray(s))


def _assert_batch_points_match(got, want, V):
    for i in range(V):
        w = {k: v[i] for k, v in want.items()}
        g = {k: v[i].numpy() for k, v in got.items()}
        for k in ("done", "result", "n_evicted", "n_churned"):
            np.testing.assert_array_equal(g[k].astype(np.int64),
                                          w[k].astype(np.int64), err_msg=k)
        scale = float(w["total_time"].max())
        np.testing.assert_allclose(g["total_time"], w["total_time"],
                                   rtol=1e-6)
        np.testing.assert_allclose(g["latency"], w["latency"], rtol=1e-6,
                                   atol=1e-6 * scale)
        for k in ("cost", "cost_wait", "cost_work", "accuracy",
                  "mean_pool_mu"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("axis", ["median_mu", "acc_b"])
def test_simfast_sweeps_match_reference_with_injected_draws(axis):
    rc = jfast(jget("smallR1"))
    labels = np.random.default_rng(3).integers(0, rc.n_classes, rc.n_tasks)
    cfg = get_fast_config("smallR1")
    with jax.threefry_partitionable(False):
        if axis == "median_mu":
            scales = np.asarray([0.5, 1.0, 2.0], np.float32)
            want = js.simulate_swept(rc, 3, js.SimScales(mu=scales),
                                     seed=SEED, true_labels=labels,
                                     shard=False)
            pops = [js.PopTraced(median_mu=jnp.float32(rc.median_mu * s),
                                 session_mean_s=jnp.float32(
                                     rc.session_mean_s),
                                 recruit_mean_s=jnp.float32(
                                     rc.recruit_mean_s),
                                 cold_recruit_mean_s=jnp.float32(
                                     rc.cold_recruit_mean_s))
                    for s in scales]
        else:
            values = np.asarray([1.0, 2.0, 4.0], np.float32)
            want = js.simulate_swept_pop(rc, 3, js.PopTraced(acc_b=values),
                                         seed=SEED, true_labels=labels,
                                         shard=False)
            pops = [js.PopTraced(acc_b=jnp.float32(v)) for v in values]
        draws = [_ref_pop_draws(rc, 3, SEED, p) for p in pops]
    want = _np_tree(want)
    if axis == "median_mu":
        got = ts.simulate_swept(cfg, 3, ts.SimScales(mu=scales),
                                true_labels=labels, device="cpu",
                                draws=draws)
    else:
        got = ts.simulate_swept_pop(cfg, 3, ts.PopTraced(acc_b=values),
                                    true_labels=labels, device="cpu",
                                    draws=draws)
    assert tuple(got["done"].shape) == (3, 3, rc.n_tasks)
    _assert_batch_points_match(got, want, 3)


def test_simfast_sweep_points_equal_standalone_runs():
    cfg = get_fast_config("smallR1")
    got = ts.simulate_swept(cfg, 3, ts.SimScales(mu=[0.5, 2.0],
                                                 session=0.25,
                                                 recruit=[1.0, 4.0]),
                            seed=SEED, device="cpu")
    cells = [dict(median_mu=75.0, session_mean_s=450.0),
             dict(median_mu=300.0, session_mean_s=450.0,
                  recruit_mean_s=180.0, cold_recruit_mean_s=800.0)]
    for i, c in enumerate(cells):
        one = ts.simulate(dataclasses.replace(cfg, **c), 3, seed=SEED,
                          device="cpu")
        for k, v in one.items():
            assert torch.equal(got[k][i], v), (i, k)
    # a Base-NR pool recruits on the cold mean; a sentinel point is the
    # config's own run
    cold = dataclasses.replace(cfg, retainer=False)
    got = ts.simulate_swept_pop(cold, 2, ts.PopTraced(
        cold_recruit_mean_s=[0.0, 50.0], acc_a=[0.0, 6.0]), seed=SEED,
        device="cpu")
    for i, c in enumerate([{}, dict(cold_recruit_mean_s=50.0, acc_a=6.0)]):
        one = ts.simulate(dataclasses.replace(cold, **c), 2, seed=SEED,
                          device="cpu")
        for k, v in one.items():
            assert torch.equal(got[k][i], v), (i, k)
