"""The port's stream-tick primitives against the JAX package: simfast's
pool machinery, the adaptive-redundancy policy and the arrival processes.

Random states are made from a seed with numpy and handed to both. The
counter-based hash is compared bit for bit (seeds at and above 2^31, steps
near 2^31); matching, churn, TermEst, the latency draw and the policy give
equal integers and floats within rtol 1e-6 (the libm of XLA and of PyTorch
may differ in the last bit of log/cos). Arrival counts come from different
generators and are held in distribution.
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

from repro.core import simfast as js  # noqa: E402
from repro.labelstream import arrivals as ja  # noqa: E402
from repro.labelstream import policy as jp  # noqa: E402
from repro_torch.core import simfast as ts  # noqa: E402
from repro_torch.labelstream import arrivals as tarr  # noqa: E402
from repro_torch.labelstream import policy as tp  # noqa: E402


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_same(got, want, rtol=1e-6):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))


def test_fast_config_fields_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(js.FastConfig)}
    port = {f.name: f.default for f in dataclasses.fields(ts.FastConfig)}
    assert ref == port


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lowbias32_bitwise(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    x[:4] = [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    want = np.asarray(js._lowbias32(jnp.asarray(x.astype(np.uint32))))
    got = ts._lowbias32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("step", [0, 1, 17, 2 ** 31 - 2, 2 ** 31 - 1])
def test_uniform_block_bitwise(step):
    rng = np.random.default_rng(step % 1000)
    seeds = rng.integers(0, 2 ** 32, 64, dtype=np.uint64)
    seeds[:3] = [2 ** 31, 2 ** 32 - 1, 0]
    n = 37
    want = jax.vmap(lambda s: js._uniform_block(s, jnp.int32(step), n))(
        jnp.asarray(seeds.astype(np.uint32)))
    got = ts._uniform_block(torch.from_numpy(seeds.astype(np.int64)), step, n)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).all() and (got < 1).all()


def _states(seed, B=16, P=8, Wn=12):
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, (B, P)).astype(np.float32)
    ints = lambda hi: rng.integers(0, hi, (B, P)).astype(np.int32)
    n_started = ints(8)
    n_completed = np.minimum(ints(8), n_started)
    n_terminated = np.minimum(ints(3), n_started - n_completed)
    comp_sum = (n_completed * f(100, 400)).astype(np.float32)
    ws = dict(
        mu=f(20, 400), sigma=f(5, 200), acc=f(0.55, 0.99),
        repl_idx=ints(70), busy_until=np.where(rng.random((B, P)) < 0.5,
                                               np.inf, f(0, 2000)
                                               ).astype(np.float32),
        assigned=np.where(rng.random((B, P)) < 0.5, -1, ints(Wn)),
        start_t=f(0, 500), blocked_until=f(0, 1500), session_end=f(0, 3000),
        n_started=n_started, n_completed=n_completed,
        n_terminated=n_terminated, comp_sum=comp_sum,
        comp_sqsum=(comp_sum ** 2 / np.maximum(n_completed, 1)
                    * f(1.0, 1.5)).astype(np.float32),
        term_sum=(n_terminated * f(50, 300)).astype(np.float32),
        cost_wait=rng.uniform(0, 5, B).astype(np.float32),
        cost_work=rng.uniform(0, 5, B).astype(np.float32),
        n_evicted=rng.integers(0, 4, B).astype(np.int32),
        n_churned=rng.integers(0, 4, B).astype(np.int32))
    banks = {k: rng.uniform(lo, hi, (B, P, 64)).astype(np.float32)
             for k, lo, hi in (("mu", 20, 400), ("sigma", 5, 200),
                               ("acc", 0.55, 0.99))}
    return ws, banks


def _torch(d):
    out = {}
    for k, v in d.items():
        v = np.asarray(v)
        out[k] = torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                  else v)
    return out


@pytest.mark.parametrize("pm_l,use_termest", [
    (240.0, True), (150.0, False), (float("inf"), True)])
def test_churn_and_maintain_matches_reference(pm_l, use_termest):
    ws, banks = _states(int(pm_l) % 97 if math.isfinite(pm_l) else 5)
    kw = dict(pool_size=8, pm_l=pm_l, use_termest=use_termest, min_obs=2,
              bank=64)
    rng = np.random.default_rng(1)
    u1, u2 = (rng.random((16, 8)).astype(np.float32) for _ in range(2))
    t = 1000.0
    want_ws, want_leave = jax.vmap(
        lambda w, b, a, c: js.churn_and_maintain(js.FastConfig(**kw), w, b,
                                                 t, a, c, 45.0))(
        jax.tree_util.tree_map(jnp.asarray, ws),
        jax.tree_util.tree_map(jnp.asarray, banks),
        jnp.asarray(u1), jnp.asarray(u2))
    got_ws, got_leave = ts.churn_and_maintain(
        ts.FastConfig(**kw), _torch(ws), _torch(banks), t,
        torch.from_numpy(u1), torch.from_numpy(u2), 45.0)
    _assert_same(got_leave, want_leave)
    assert got_leave.any()
    for k in want_ws:
        _assert_same(got_ws[k], want_ws[k])


@pytest.mark.parametrize("seed", [11, 12])
def test_termest_and_emp_std_match_reference(seed):
    ws, _ = _states(seed)
    cfg_j = js.FastConfig(alpha=1.0)
    cfg_t = ts.FastConfig(alpha=1.0)
    jws = jax.tree_util.tree_map(jnp.asarray, ws)
    _assert_same(ts._termest(cfg_t, _torch(ws)), js._termest(cfg_j, jws))
    _assert_same(ts._emp_std(_torch(ws)), js._emp_std(jws))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_priority_match_matches_reference(seed):
    rng = np.random.default_rng(seed)
    B, P, Wn = 32, 8, 16
    avail = rng.random((B, P)) < 0.6
    tier1 = rng.random((B, Wn)) < 0.3
    tier2 = (rng.random((B, Wn)) < 0.3) & ~tier1
    shift = rng.integers(0, Wn, B).astype(np.int32)
    want = jax.vmap(js.priority_match)(jnp.asarray(avail), jnp.asarray(tier1),
                                       jnp.asarray(tier2), jnp.asarray(shift))
    got = ts.priority_match(torch.from_numpy(avail), torch.from_numpy(tier1),
                            torch.from_numpy(tier2),
                            torch.from_numpy(shift.astype(np.int64)))
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_draw_latency_and_exp_match_reference():
    rng = np.random.default_rng(4)
    mu = rng.uniform(15, 500, (64, 8)).astype(np.float32)
    sigma = rng.uniform(5, 300, (64, 8)).astype(np.float32)
    u1, u2 = (rng.random((64, 8)).astype(np.float32) for _ in range(2))
    cfg_j, cfg_t = js.FastConfig(), ts.FastConfig()
    want = js.draw_latency(cfg_j, *map(jnp.asarray, (mu, sigma, u1, u2)))
    got = ts.draw_latency(cfg_t, *map(torch.from_numpy, (mu, sigma, u1, u2)))
    _assert_same(got, want)
    assert float(got.min()) >= cfg_t.latency_floor
    _assert_same(ts._exp(torch.from_numpy(u1), 45.0),
                 js._exp(jnp.asarray(u1), 45.0))


def test_init_workers_shapes_and_ranges():
    cfg = ts.FastConfig(pool_size=6, bank=10)
    ws, banks = ts._init_workers(cfg, np.random.default_rng(0), (3, 2))
    ref_ws, ref_banks = js._init_workers(js.FastConfig(pool_size=6, bank=10),
                                         jax.random.key(0))
    assert set(ws) == set(ref_ws) and set(banks) == set(ref_banks)
    for k, v in ref_ws.items():
        assert ws[k].shape == (3, 2) + v.shape, k
        assert ws[k].dtype.kind == np.asarray(v).dtype.kind, k
    assert banks["acc"].shape == (3, 2, 6, 10)
    assert (banks["acc"] >= 0.55).all() and (banks["acc"] <= 0.995).all()
    assert (banks["mu"] >= 15.0).all()
    np.testing.assert_array_equal(ws["mu"], banks["mu"][..., 0])
    # a trace adds the cumulative counters, as the reference's does
    from repro.obs.trace import TraceConfig as JTrace
    from repro_torch.obs.trace import TraceConfig
    ws_t, _ = ts._init_workers(ts.FastConfig(trace=TraceConfig()),
                               np.random.default_rng(0), (3,))
    ref_t, _ = js._init_workers(js.FastConfig(trace=JTrace()),
                                jax.random.key(0))
    assert set(ws_t) == set(ref_t) == set(ref_ws) | {"tr_assigned",
                                                     "tr_dups"}
    for k in ("tr_assigned", "tr_dups"):
        assert ws_t[k].shape == (3,) and not ws_t[k].any()


# ---- labelstream policy and arrivals (the tick's other primitives) -------


@pytest.mark.parametrize("adaptive,cap,thr,min_votes,max_out", [
    (True, 5, 0.98, 2, 2), (True, 3, 0.95, 1, 1), (False, 3, 0.92, 1, 1)])
def test_policy_matches_reference(adaptive, cap, thr, min_votes, max_out):
    rng = np.random.default_rng(cap)
    lp = rng.normal(0, 3, (64, 3)).astype(np.float32)
    lp[:4] = 0.0                                   # uniform posteriors
    n_votes = rng.integers(0, cap + 2, 64).astype(np.int32)
    kw = dict(adaptive=adaptive, votes_cap=cap, conf_threshold=thr,
              min_votes=min_votes, max_outstanding=max_out)
    pj, pt = jp.PolicyConfig(**kw), tp.PolicyConfig(**kw)
    lpj, lpt = jnp.asarray(lp), torch.from_numpy(lp)
    nvj, nvt = jnp.asarray(n_votes), torch.from_numpy(n_votes.astype(np.int64))
    _assert_same(tp.confidence(lpt), jp.confidence(lpj))
    _assert_same(tp.uncertainty(lpt), jp.uncertainty(lpj))
    _assert_same(tp.target_outstanding(nvt, pt),
                 jp.target_outstanding(nvj, pj))
    for g, w in zip(tp.should_finalize(lpt, nvt, pt),
                    jp.should_finalize(lpj, nvj, pj)):
        _assert_same(g, w)
    model = rng.normal(0, 1, (64, 3)).astype(np.float32)
    fj = jp.fuse_posteriors(lpj, jnp.asarray(model), 0.7)
    ft = tp.fuse_posteriors(lpt, torch.from_numpy(model), 0.7)
    _assert_same(ft, fj)
    for g, w in zip(tp.learner_known(ft, nvt, threshold=0.9,
                                     min_votes_known=1),
                    jp.learner_known(fj, nvj, threshold=0.9,
                                     min_votes_known=1)):
        _assert_same(g, w)


@pytest.mark.parametrize("kind", ["poisson", "mmpp", "diurnal"])
def test_arrivals_match_reference_in_distribution(kind):
    """Rates equal the reference's; counts are Poisson draws from the run's
    generator, so their mean is held to 5 standard errors."""
    cfg_kw = dict(kind=kind, rate=0.05, rate_hi=0.4, dwell_mean_s=300.0,
                  period_s=3000.0, amplitude=0.8)
    cj, ct = ja.ArrivalConfig(**cfg_kw), tarr.ArrivalConfig(**cfg_kw)
    n_reps, dt = 4096, 5.0
    for t, mode in ((0.0, 0), (750.0, 1), (2250.0, 0)):
        sj = dict(mode=jnp.asarray(mode, jnp.int32))
        st = dict(mode=torch.full((n_reps,), mode, dtype=torch.int64))
        want = float(ja.rate_at(cj, sj, jnp.float32(t)))
        got = tarr.rate_at(ct, st, t)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        gen = torch.Generator().manual_seed(int(t))
        n, st2, rate = tarr.sample_arrivals(ct, st, gen, t, dt)
        mean = want * dt
        assert n.dtype == torch.int64 and (n >= 0).all()
        assert abs(float(n.float().mean()) - mean) \
            <= 5 * math.sqrt(mean / n_reps)
        if kind == "mmpp":
            flip = float((st2["mode"] != mode).float().mean())
            p = 1 - math.exp(-dt / 300.0)
            assert abs(flip - p) <= 5 * math.sqrt(p * (1 - p) / n_reps)
        else:
            assert torch.equal(st2["mode"], st["mode"])
    init = tarr.init_arrival_state(ct, 3, device="cpu")
    assert init["mode"].shape == (3,) and int(init["mode"].sum()) == 0
