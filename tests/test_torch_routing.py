"""The port's routing and learner-tick pieces against the JAX package's, on
seeded inputs: ``_standardize`` (bit for bit, constant pools included) and
``route_scores``, ``scored_match`` (and its pin to ``priority_match``
under constant scores), ``admit_select``, ``learnability_features``,
``admit_scores``, the stealing plan and rebalance, and the learner's ring
push and cadenced fits (``_learner_push_fit``) from the same mid-run state.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.simfast import priority_match as jpriority  # noqa: E402
from repro.labelstream import router as jr  # noqa: E402
from repro.labelstream import routing as jrt  # noqa: E402
from repro.learning import linear as jlin  # noqa: E402
from repro_torch.core.simfast import priority_match  # noqa: E402
from repro_torch.labelstream import router as tr  # noqa: E402
from repro_torch.labelstream import routing as trt  # noqa: E402
from repro_torch.learning import linear as tlin  # noqa: E402
from repro_torch.scenarios import get_stream_config  # noqa: E402

t = torch.from_numpy
vjit = lambda f: jax.jit(jax.vmap(f))


def _pools(rng, n_const, n_rand, P, lo, hi):
    """Pools of P values: ``n_const`` constant ones, then random ones."""
    const = np.repeat(rng.uniform(lo, hi, (n_const, 1)), P, 1)
    rand = rng.uniform(lo, hi, (n_rand, P))
    return np.concatenate([const, rand]).astype(np.float32)


@pytest.mark.parametrize("P", [8, 16])
def test_standardize_bit_equal_including_constant_pools(P):
    rng = np.random.default_rng(P)
    x = _pools(rng, 300, 300, P, -3.0, 3.0)
    want = np.asarray(vjit(jrt._standardize)(x))
    got = trt._standardize(t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # the trap: equal values do not standardize to zeros
    assert (np.abs(want[:300]).max(-1) > 0).sum() > 50


def test_route_scores_match_reference():
    """Bit for bit at cold start (every acc_hat 0.85, every latency EWMA at
    the median): the standardized axes there are rounding residues whose
    sign routes every worker. Elsewhere the log and log1p of the two
    libraries may differ in the last bit, so rtol 1e-5."""
    rng = np.random.default_rng(0)
    B, P, W = 300, 8, 32
    acc = rng.uniform(0.52, 0.995, (B, P)).astype(np.float32)
    lat = rng.uniform(20.0, 400.0, (B, P)).astype(np.float32)
    acc[:100], lat[:100] = np.float32(0.85), np.float32(150.0)
    unc = rng.uniform(0.0, 1.0, (B, W)).astype(np.float32)
    unc[:, :4], unc[:, 4:8] = 1.0, 0.0
    jcfg, tcfg = jrt.RoutingConfig(enabled=True), trt.RoutingConfig(
        enabled=True)
    want = np.asarray(vjit(lambda a, l, u: jrt.route_scores(a, l, u, jcfg))(
        acc, lat, unc))
    got = trt.route_scores(t(acc), t(lat), t(unc), tcfg).numpy()
    np.testing.assert_array_equal(got[:100], want[:100])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(want[:100]).max() > 0


def _match_inputs(rng, n, P, W, levels):
    avail = rng.random((n, P)) < rng.uniform(0.2, 0.9, (n, 1))
    t1 = rng.random((n, W)) < rng.uniform(0.1, 0.6, (n, 1))
    t2 = (rng.random((n, W)) < rng.uniform(0.1, 0.6, (n, 1))) & ~t1
    # quantized scores: ties between workers and between tasks
    scores = rng.integers(0, levels, (n, P, W)).astype(np.float32) / levels
    shift = rng.integers(0, W, n)
    return scores, avail, t1, t2, shift


@pytest.mark.parametrize("P,W,levels", [(8, 32, 5), (8, 8, 3), (16, 16, 50)])
def test_scored_match_matches_reference(P, W, levels):
    rng = np.random.default_rng(P * W + levels)
    scores, avail, t1, t2, shift = _match_inputs(rng, 200, P, W, levels)
    want = vjit(jrt.scored_match)(scores, avail, t1, t2,
                                  shift.astype(np.int32))
    got = trt.scored_match(t(scores), t(avail), t(t1), t(t2), t(shift))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].any()


@pytest.mark.parametrize("const", [0.0, 1.7, -3.2])
def test_scored_match_is_priority_match_under_constant_scores(const):
    rng = np.random.default_rng(1234)
    P, W = 8, 32
    _, avail, t1, t2, shift = _match_inputs(rng, 300, P, W, 2)
    take_r, task_r, tier1_r, n1_r = priority_match(t(avail), t(t1), t(t2),
                                                   t(shift))
    take_s, task_s, tier1_s, n1_s = trt.scored_match(
        torch.full((300, P, W), const), t(avail), t(t1), t(t2), t(shift))
    assert torch.equal(take_r, take_s)
    assert torch.equal(task_r[take_r], task_s[take_s])
    assert torch.equal(tier1_r, tier1_s)
    assert torch.equal(n1_r, n1_s)
    # and the reference's priority_match agrees
    jt, jtask, _, _ = jax.vmap(jpriority)(avail, t1, t2,
                                          shift.astype(np.int32))
    np.testing.assert_array_equal(take_s.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(task_s[take_s].numpy(),
                                  np.asarray(jtask)[np.asarray(jt)])


def test_admit_select_matches_reference():
    rng = np.random.default_rng(7)
    n, Q = 300, 64
    unc = (rng.integers(0, 6, (n, Q)) / 5.0).astype(np.float32)  # ties
    occ = rng.random((n, Q)) < rng.uniform(0.0, 1.0, (n, 1))
    n_adm = rng.integers(0, Q + 4, n)
    want_a, want_o = vjit(jrt.admit_select)(unc, occ, n_adm.astype(np.int32))
    got_a, got_o = trt.admit_select(t(unc), t(occ), t(n_adm))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    # conservation, most uncertain first, ties by slot
    a = got_a.numpy()
    assert (a.sum(-1) == np.minimum(n_adm, occ.sum(-1))).all()
    assert not (a & ~occ).any()
    for i in range(n):
        left = occ[i] & ~a[i]
        if a[i].any() and left.any():
            assert unc[i][a[i]].min() >= unc[i][left].max()
        ranked = got_o[i, :a[i].sum()].numpy()
        key = -unc[i][ranked]
        assert (np.diff(key) >= 0).all()
        same = np.diff(key) == 0
        assert (np.diff(ranked)[same] > 0).all()


def test_learnability_features_and_admit_scores_match_reference():
    rng = np.random.default_rng(3)
    n, Q, F = 40, 64, 8
    feat = rng.normal(0, 2, (n, Q, F)).astype(np.float32)
    unc = rng.uniform(0, 1, (n, Q)).astype(np.float32)
    gW = rng.normal(0, 0.5, (n, 2 * F, 2)).astype(np.float32)
    gb = rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        trt.learnability_features(t(feat)).numpy(),
        np.asarray(jrt.learnability_features(feat)))
    want = np.asarray(vjit(jrt.admit_scores)(unc, feat, gW, gb))
    got = trt.admit_scores(t(unc), t(feat), t(gW), t(gb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # an untrained head scores 0.5: the ranking is plain uncertainty's
    zero = trt.admit_scores(t(unc), t(feat), torch.zeros(n, 2 * F, 2),
                            torch.zeros(n, 2)).numpy()
    np.testing.assert_array_equal(zero, unc * np.float32(0.5))


def _ref_cfg(name, **kw):
    from repro.scenarios import get_scenario
    from repro.scenarios.compile import to_stream_config
    return dataclasses.replace(to_stream_config(get_scenario(name)), **kw)


@pytest.mark.parametrize("S,steal_max,slack", [(8, 4, 1), (5, 3, 0),
                                               (2, 4, 2)])
def test_steal_plan_matches_reference(S, steal_max, slack):
    rng = np.random.default_rng(S)
    counts = rng.integers(0, 40, (400, S))
    counts[:50] = 7                                    # balanced
    want = vjit(lambda c: jr._steal_plan(c, steal_max, slack))(
        counts.astype(np.int32))
    got = tr._steal_plan(t(counts), steal_max, slack)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].sum(-1) == got[1].sum(-1)).all()
    assert got[0].sum() > 0


def test_steal_rebalance_matches_reference():
    S, Q = 8, 24
    jcfg = _ref_cfg("stream_sharded", backlog=Q)
    cfg = get_stream_config("stream_sharded", {"backlog": Q})
    rng = np.random.default_rng(11)
    n = 50
    times = rng.uniform(0, 1000, (n, S, Q + 1)).astype(np.float32)
    head = rng.integers(0, Q, (n, S))
    count = rng.integers(0, Q + 1, (n, S))
    count[:, 0] = Q                      # a full ring that wraps
    want_bl, want_got, want_gave = vjit(
        lambda tm, h, c: jr._steal_rebalance(
            jcfg, dict(times=tm, head=h, count=c), 0, None))(
        times, head.astype(np.int32), count.astype(np.int32))
    got_bl, got, gave = tr._steal_rebalance(cfg, dict(
        times=t(times.reshape(n * S, Q + 1)), head=t(head.reshape(-1)),
        count=t(count.reshape(-1))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_got).ravel())
    np.testing.assert_array_equal(gave.numpy(),
                                  np.asarray(want_gave).ravel())
    for k in ("head", "count"):
        np.testing.assert_array_equal(got_bl[k].numpy(),
                                      np.asarray(want_bl[k]).reshape(-1))
    # the live ring entries (the dump slot Q takes masked writes)
    np.testing.assert_array_equal(
        got_bl["times"].numpy().reshape(n, S, Q + 1)[..., :Q],
        np.asarray(want_bl["times"])[..., :Q])
    assert got.sum() > 0 and got.sum() == gave.sum()


def _learner_state(rng, N, F, Bf, learnable):
    """A mid-run learner state as numpy arrays (leading dim N)."""
    def leaves(d, c):
        W = rng.normal(0, 0.3, (N, d, c)).astype(np.float32)
        b = rng.normal(0, 0.3, (N, c)).astype(np.float32)
        m = lambda s: rng.normal(0, 0.01, s).astype(np.float32)
        v = lambda s: rng.uniform(1e-6, 1e-3, s).astype(np.float32)
        return (W, b, m(W.shape), m(b.shape), v(W.shape), v(b.shape),
                rng.integers(1, 200, N).astype(np.int32))
    st = dict(learn=leaves(F, 2),
              buf_X=rng.normal(0, 1.5, (N, Bf + 1, F)).astype(np.float32),
              buf_y=rng.integers(0, 2, (N, Bf + 1)).astype(np.int32),
              buf_n=np.array([0, 5, 250, 900][:N], np.int32))
    st["buf_X"][:, Bf] = 0.0
    st["buf_y"][:, Bf] = 0
    if learnable:
        st["learn2"] = leaves(2 * F, 2)
        st["buf_t"] = rng.integers(0, 2, (N, Bf + 1)).astype(np.int32)
        st["buf_t"][:, Bf] = 0
    return st


@pytest.mark.parametrize("name,step", [("skewed_learner_fused", 8),
                                       ("skewed_learner_fused", 9),
                                       ("chance_hard", 12)])
def test_learner_push_fit_matches_reference(name, step):
    """From the same mid-run state and finalized examples: the rings equal,
    the learner (2 Adam steps carrying momentum) within 1e-6 and the
    learnability head (60 steps from scratch) within 1e-5 of their largest
    entry; off the cadence both are untouched."""
    learnable = name == "chance_hard"
    R = {"routing": trt.RoutingConfig(enabled=True,
                                      admission="uncertain_learnable")} \
        if learnable else {}
    cfg = get_stream_config(name, R)
    jcfg = _ref_cfg(name, **({"routing": jrt.RoutingConfig(
        enabled=True, admission="uncertain_learnable")} if learnable else {}))
    L, S, Ws = cfg.learner, cfg.n_shards, cfg.window
    F, Bf, N = L.n_features, L.buffer, 4
    rng = np.random.default_rng(step)
    st = _learner_state(rng, N, F, Bf, learnable)
    train = dict(mask=rng.random((N, S, Ws)) < 0.3,
                 feat=rng.normal(0, 1.5, (N, S, Ws, F)).astype(np.float32),
                 label=rng.integers(0, 2, (N, S, Ws)).astype(np.int32))
    train["mask"][0] = False           # a replication with nothing to push
    if learnable:
        train["learnable"] = rng.integers(0, 2, (N, S, Ws)).astype(np.int32)

    def ref_one(s, tr_):
        s = dict(s, learn=jlin.LinearLearner(*s["learn"]))
        if "learn2" in s:
            s["learn2"] = jlin.LinearLearner(*s["learn2"])
        return jr._learner_push_fit(jcfg, s, tr_, jnp.int32(step),
                                    lambda x: x)
    want = jax.jit(jax.vmap(ref_one))(st, train)

    ls = tr._learner_from_numpy(cfg, st, N, "cpu")
    flat = {k: t(v.reshape((N * S,) + v.shape[2:])) for k, v in
            train.items()}
    flat["label"] = flat["label"].long()
    if learnable:
        flat["learnable"] = flat["learnable"].long()
    got = tr._learner_push_fit(cfg, ls, flat, step)
    for k in ("buf_X", "buf_y", "buf_n") + (("buf_t",) if learnable else ()):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    fit_now = step % L.fit_every == 0
    # each learner within a bound of its largest entry per replication:
    # entries near zero carry the fit's rounding in absolute terms
    for k, bound in (("learn", 1e-6), ("learn2", 1e-5)):
        if k not in want:
            continue
        for f, g, w in zip(tlin.LinearLearner._fields, got[k], want[k]):
            g, w = g.numpy(), np.asarray(w)
            if f == "t" or not fit_now:
                np.testing.assert_array_equal(g, w, err_msg=f"{k}.{f}")
                continue
            scale = np.abs(w).max(axis=tuple(range(1, w.ndim)),
                                  keepdims=True)
            assert (np.abs(g - w) <= bound * scale).all(), f"{k}.{f}"


def test_ordered_matmul_adds_in_index_order():
    """The learner's product: each output the sum of its products in index
    order (the same on the CPU and the card), whatever the batch size."""
    rng = np.random.default_rng(5)
    A = t(rng.normal(0, 1, (6, 40, 16)).astype(np.float32))
    B = t(rng.normal(0, 1, (6, 16, 2)).astype(np.float32))
    want = A[..., :, 0, None] * B[..., None, 0, :]
    for k in range(1, 16):
        want = want + A[..., :, k, None] * B[..., None, k, :]
    got = tlin.ordered_matmul(A, B)
    assert torch.equal(got, want)
    assert torch.equal(tlin.ordered_matmul(A[:2], B[:2]), got[:2])
    np.testing.assert_allclose(got.numpy(), torch.matmul(A, B).numpy(),
                               rtol=1e-5, atol=1e-5)
