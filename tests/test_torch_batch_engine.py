"""The port's simfast batch engine and its learning round against the JAX
package.

Parity with injected draws: the reference's threefry draws — each
replication's initial worker pool, banks and uint32 counter seed, and in
the learning round the passive uniforms — are computed here with the
reference's own calls, exactly as ``simulate`` / ``_learning_batch_impl``
make them, and handed to the port (``simulate(draws=...)``,
``_learner_round(..., draw)``). Every other draw of a tick comes from the
counter hash both packages share, so tick counts, ``done``, ``result`` and
every integer counter must be equal. Float outputs are float32 bit-equal
except where noted: XLA's and PyTorch's libm may differ in the last bit of
the ``log1p``/``cos`` of a latency draw, which moves a completion time by
an ulp, so latencies (differences of such times) are held within 1e-6 of
the run's time scale and float sums within rtol 1e-6. Reference calls run
inside ``jax.threefry_partitionable(False)`` and share their compiles
through module-scoped fixtures.
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
from repro.obs.trace import TraceConfig  # noqa: E402
from repro.scenarios import get_scenario  # noqa: E402
from repro.scenarios.compile import to_fast_config  # noqa: E402
from repro_torch.core import simfast as ts  # noqa: E402
from repro_torch.scenarios import get_fast_config  # noqa: E402

N_REPS, SEED = 4, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the tick is ~100 tiny ops: threads only add overhead, and the suite
    # runs several workers at once
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _ref_init(cfg, key):
    """The reference's per-replication init draws inside ``_simulate_one``."""
    k_init, k_run = jax.random.split(key)
    ws, banks = js._init_workers(cfg, k_init)
    return ws, banks, jax.random.bits(k_run, (), jnp.uint32)


def _ref_draws(cfg, n_reps, seed):
    keys = jax.random.split(jax.random.key(seed), n_reps)
    ws, banks, s = jax.vmap(lambda k: _ref_init(cfg, k))(keys)
    return dict(ws=_np_tree(ws), banks=_np_tree(banks), seed=np.asarray(s))


@pytest.fixture(scope="module", params=["smallR1", "throughput_v3_pm"])
def sim_pair(request):
    name = request.param
    rc = to_fast_config(get_scenario(name))
    labels = np.random.default_rng(3).integers(0, rc.n_classes, rc.n_tasks)
    with jax.threefry_partitionable(False):
        # trace counters consume no randomness: they only add the per-batch
        # tick counts to the outputs
        traced = dataclasses.replace(rc, trace=TraceConfig())
        want = _np_tree(js.simulate(traced, N_REPS, seed=SEED,
                                    true_labels=labels, shard=False))
        draws = _ref_draws(rc, N_REPS, SEED)
    got = ts.simulate(get_fast_config(name), N_REPS, true_labels=labels,
                      device="cpu", draws=draws)
    return name, {k: v.numpy() for k, v in got.items()}, want


def test_fast_configs_match_reference_lowering():
    for name in ("smallR1", "hybrid_small", "throughput_v3_pm"):
        rc = to_fast_config(get_scenario(name))
        pc = get_fast_config(name)
        assert {f.name: getattr(pc, f.name) for f in dataclasses.fields(pc)} \
            == {f.name: getattr(rc, f.name) for f in dataclasses.fields(rc)}
        assert (pc.eff_batch, pc.n_batches, pc.batch_steps) \
            == (rc.eff_batch, rc.n_batches, rc.batch_steps)


def test_simulate_integers_and_ticks_equal(sim_pair):
    name, got, want = sim_pair
    np.testing.assert_array_equal(got["n_ticks"], want["trace_ticks"])
    for k in ("done", "result", "n_evicted", "n_churned"):
        np.testing.assert_array_equal(got[k].astype(np.int64),
                                      want[k].astype(np.int64), err_msg=k)
    assert want["done"].all()


def test_simulate_lockstep_replications_stop_apart(sim_pair):
    """The batched while-loop: replications that finish a batch many ticks
    before the others are frozen, not stepped on."""
    name, got, want = sim_pair
    ticks = want["trace_ticks"]
    assert (ticks.max(0) - ticks.min(0)).max() >= 8, ticks
    np.testing.assert_array_equal(got["n_ticks"], ticks)


def test_simulate_floats_match(sim_pair):
    name, got, want = sim_pair
    np.testing.assert_array_equal(got["total_time"], want["total_time"])
    np.testing.assert_array_equal(got["cost_work"], want["cost_work"])
    scale = float(want["total_time"].max())
    np.testing.assert_allclose(got["latency"], want["latency"], rtol=1e-6,
                               atol=1e-6 * scale)
    for k in ("cost", "cost_wait", "accuracy", "mean_pool_mu"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0,
                                   err_msg=k)


def test_simulate_rejects_unported_options():
    """The trace counters and the per-row population overrides run (see
    tests/test_torch_trace.py and tests/test_torch_sweep.py); what the
    engine cannot take raises ``TypeError``: the reference's TraceConfig
    in place of the port's, and a population override that is not the
    per-row dict ``simulate_swept_pop`` builds."""
    from repro_torch.obs.trace import TraceConfig as PortTrace
    cfg = get_fast_config("smallR1")
    traced = ts.simulate(dataclasses.replace(cfg, trace=PortTrace()), 2,
                         device="cpu")
    assert traced["trace_ticks"].shape == (2, cfg.n_batches)
    with pytest.raises(TypeError):
        ts.simulate(dataclasses.replace(cfg, trace=TraceConfig()), 2,
                    device="cpu")
    with pytest.raises(TypeError):
        ts._simulate_one(cfg, {}, {}, torch.zeros(2, dtype=torch.int64),
                         np.zeros(cfg.n_tasks), pop=object())


def test_simulate_own_draws_repeat_and_conserve():
    cfg = get_fast_config("smallR1")
    a = ts.simulate(cfg, 3, seed=7, device="cpu")
    b = ts.simulate(cfg, 3, seed=7, device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert bool(a["done"].all())
    assert bool((a["latency"] > 0).all())
    assert bool((a["cost"] > 0).all())
    c = ts.simulate(cfg, 3, seed=8, device="cpu")
    assert not torch.equal(a["latency"], c["latency"])


# --------------------------------------------------------------------------
# the learning round: 5 rounds x 4 replications at the problem of
# tests/test_learning.py::test_simulate_learning_batch_matches_scalar_...
# --------------------------------------------------------------------------

ROUNDS, FIT_STEPS, DEC = 5, 30, 15.0


def _problem():
    rng = np.random.default_rng(0)
    N, d = 500, 8
    W0 = rng.normal(size=(d, 2))
    X = rng.normal(size=(N, d)).astype(np.float32)
    y = (X @ W0).argmax(-1)
    Xt = rng.normal(size=(200, d)).astype(np.float32)
    yt = (Xt @ W0).argmax(-1)
    return X, y, Xt, yt


@pytest.fixture(scope="module")
def learning_rounds():
    """Per round: the reference's round inputs, its draws and its outputs,
    and the port's outputs on those inputs and draws."""
    X, y, Xt, yt = _problem()
    cfg = js.FastConfig(pool_size=10)
    p = cfg.pool_size
    k_active, n_passive = p // 2, p - p // 2
    bcfg = dataclasses.replace(cfg, n_tasks=p, batch_size=p, n_classes=2)
    pcfg = ts.FastConfig(pool_size=p, n_tasks=p, batch_size=p, n_classes=2)
    n = X.shape[0]
    Xj, yj, Xtj, ytj = (jnp.asarray(X), jnp.asarray(y, jnp.int32),
                        jnp.asarray(Xt), jnp.asarray(yt, jnp.int32))

    def ref_round(W, b, lab, yo, t, k_round):
        k_sel, k_sim = jax.random.split(k_round)
        ws, banks, s = _ref_init(bcfg, k_sim)
        draw = dict(u=jax.random.uniform(k_sel, (n,)), ws=ws, banks=banks,
                    seed=s)
        out = js._learner_round(bcfg, Xj, yj, Xtj, ytj, k_active, n_passive,
                                FIT_STEPS, DEC, None, W, b, lab, yo, t,
                                k_round)
        return out, draw

    step = jax.jit(jax.vmap(ref_round))
    Xp, yp, Xtp, ytp = (torch.from_numpy(X), torch.from_numpy(y),
                        torch.from_numpy(Xt), torch.from_numpy(yt))
    res = []
    with jax.threefry_partitionable(False):
        keys = jax.random.split(jax.random.key(SEED), N_REPS)
        W = jnp.zeros((N_REPS, 8, 2))
        b = jnp.zeros((N_REPS, 2))
        lab = jnp.zeros((N_REPS, n), bool)
        yo = jnp.zeros((N_REPS, n), jnp.int32)
        t = jnp.zeros((N_REPS,))
        for _ in range(ROUNDS):
            kk = jax.vmap(jax.random.split)(keys)
            keys, k_round = kk[:, 0], kk[:, 1]
            inp = dict(W=np.asarray(W), b=np.asarray(b),
                       labeled=np.asarray(lab), y_obs=np.asarray(yo),
                       t=np.asarray(t))
            (W, b, lab, yo, t, aux), draw = step(W, b, lab, yo, t, k_round)
            want = dict(W=np.asarray(W), b=np.asarray(b),
                        labeled=np.asarray(lab), y_obs=np.asarray(yo),
                        t=np.asarray(t), **_np_tree(aux))
            draw = dict(u=np.asarray(draw["u"]), ws=_np_tree(draw["ws"]),
                        banks=_np_tree(draw["banks"]),
                        seed=np.asarray(draw["seed"]))
            gW, gb, glab, gyo, gt, gaux = ts._learner_round(
                pcfg, Xp, yp, Xtp, ytp, k_active, n_passive, FIT_STEPS, DEC,
                None, torch.tensor(inp["W"]), torch.tensor(inp["b"]),
                torch.tensor(inp["labeled"]),
                torch.tensor(inp["y_obs"]).long(),
                torch.tensor(inp["t"]),
                ts._draws_to_device(draw, torch.device("cpu")))
            got = dict(W=gW.numpy(), b=gb.numpy(), labeled=glab.numpy(),
                       y_obs=gyo.numpy(), t=gt.numpy(),
                       **{k: v.numpy() for k, v in gaux.items()})
            res.append((inp, want, got))
    return res


def test_learner_round_chooses_the_same_points(learning_rounds):
    for r, (inp, want, got) in enumerate(learning_rounds):
        np.testing.assert_allclose(got["ent"], want["ent"], rtol=1e-5,
                                   atol=1e-6)
        for i in range(N_REPS):
            gc, wc = got["chosen"][i], want["chosen"][i].astype(np.int64)
            diff = np.nonzero(gc != wc)[0]
            if diff.size:
                # a swap is accepted only between points whose reference
                # entropies tie within 1e-6
                assert sorted(gc[diff]) == sorted(wc[diff]), (r, i)
                ent = want["ent"][i]
                assert np.ptp(ent[wc[diff]]) <= 1e-6, (r, i, ent[wc[diff]])
        np.testing.assert_array_equal(got["act_mask"], want["act_mask"])


def test_learner_round_labels_equal(learning_rounds):
    for r, (inp, want, got) in enumerate(learning_rounds):
        np.testing.assert_array_equal(got["labeled"], want["labeled"])
        np.testing.assert_array_equal(got["y_obs"],
                                      want["y_obs"].astype(np.int64))
        np.testing.assert_array_equal(got["done"], want["done"])
        np.testing.assert_array_equal(got["labeled"].sum(-1),
                                      want["labeled"].sum(-1))
        assert (want["labeled"].sum(-1) > inp["labeled"].sum(-1)).all()


def test_learner_round_fit_and_time_match(learning_rounds):
    for r, (inp, want, got) in enumerate(learning_rounds):
        np.testing.assert_allclose(got["W"], want["W"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["b"], want["b"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["acc"], want["acc"], atol=1e-6)
        np.testing.assert_allclose(got["t"], want["t"], rtol=1e-6)


def test_simulate_learning_batch_matches_reference_distribution():
    """The port's own draws against the reference's, as
    tests/test_learning.py holds the batched loop against the scalar one:
    final test accuracy within one std, time strictly increasing, labels
    bought every round and never twice, and the learner learns."""
    X, y, Xt, yt = _problem()
    kw = dict(rounds=5, n_reps=64, seed=0, fit_steps=30)
    with jax.threefry_partitionable(False):
        ref = js.simulate_learning_batch(js.FastConfig(pool_size=10), X, y,
                                         Xt, yt, shard=False, **kw)
    acc_r = np.asarray(ref["curve"]["acc"])[:, -1]
    out = ts.simulate_learning_batch(ts.FastConfig(pool_size=10), X, y, Xt,
                                     yt, device="cpu", **kw)
    t = out["curve"]["t"].numpy()
    nl = out["curve"]["n_labeled"].numpy()
    acc = out["curve"]["acc"].numpy()
    assert t.shape == nl.shape == acc.shape == (64, 6)
    assert (np.diff(t, axis=1) > 0).all()
    assert (np.diff(nl, axis=1) > 0).all() and (nl[:, -1] >= 40).all()
    assert (nl[:, -1] == out["labeled"].sum(-1).numpy()).all()
    gap = abs(float(acc[:, -1].mean()) - float(acc_r.mean()))
    assert gap <= max(float(acc[:, -1].std()), 0.02), \
        (gap, acc[:, -1].mean(), acc[:, -1].std(), acc_r.mean())
    assert acc[:, -1].mean() > 0.8 and acc_r.mean() > 0.8
    again = ts.simulate_learning_batch(ts.FastConfig(pool_size=10), X, y, Xt,
                                       yt, device="cpu", **kw)
    for k in ("t", "n_labeled", "acc"):
        assert torch.equal(out["curve"][k], again["curve"][k])


def test_simulate_learning_scalar_with_accest():
    from repro_torch.learning import AccEst
    X, y, Xt, yt = _problem()
    acc = AccEst(r=0.5)
    curve, info = ts.simulate_learning(ts.FastConfig(pool_size=8), X[:300],
                                       y[:300], Xt[:100], yt[:100], rounds=3,
                                       seed=0, fit_steps=20, accest=acc,
                                       device="cpu")
    assert len(curve) == 4 and curve[0][1] == 0
    assert curve[-1][1] >= 20
    assert all(b[0] > a[0] for a, b in zip(curve, curve[1:]))
    assert 0.1 <= acc.al_fraction() <= 0.9 and acc.n_updates == 3
    assert int(info["labeled"].sum()) == curve[-1][1]


def test_simulate_learning_batch_mnist_size_matches_reference():
    """The MNIST-sized problem of chip_smoke.py (784 features, 10 classes):
    the port's final accuracy distribution is the reference's, low as it
    is for 90 labels at this width."""
    from repro.data.datasets import mnist_like, train_test_split
    Xm, ym = mnist_like(4000, seed=4)
    X, y, Xt, yt = train_test_split(Xm, ym, test_frac=0.25, seed=4)
    kw = dict(rounds=10, n_reps=8, seed=0, fit_steps=60)
    with jax.threefry_partitionable(False):
        ref = js.simulate_learning_batch(js.FastConfig(pool_size=10), X, y,
                                         Xt, yt, shard=False, **kw)
    acc_r = np.asarray(ref["curve"]["acc"])[:, -1]
    out = ts.simulate_learning_batch(ts.FastConfig(pool_size=10), X, y, Xt,
                                     yt, device="cpu", **kw)
    acc = out["curve"]["acc"].numpy()[:, -1]
    assert (out["curve"]["n_labeled"].numpy()[:, -1] == 100).all()
    gap = abs(float(acc.mean()) - float(acc_r.mean()))
    assert gap <= max(float(acc.std()), 0.02), (gap, acc.mean(), acc_r.mean())
