"""The port's entropy scorer, linear learner, point selection, datasets and
learning front door against the JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both packages (bf16
inputs are rounded from the same float32 values by both). Entropy is held
against the JAX oracle and the Pallas kernel in interpret mode at the
reference tests' shapes and tolerances (tests/test_kernels.py,
tests/test_learning.py); on the CPU the port's wrapper runs its plain
version, which the card tests (tests/test_torch_kernels_cuda.py) hold the
kernel against. The learner's fit is held at rtol 1e-4 / atol 1e-5;
selection is equal, ties included.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.data import datasets as jdata  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.uncertainty import (  # noqa: E402
    entropy_scores as jax_entropy,
)
from repro.learning import allocate as jalloc  # noqa: E402
from repro.learning import features as jfeat  # noqa: E402
from repro.learning import linear as jl  # noqa: E402
from repro.learning import select as jsel  # noqa: E402
from repro_torch.data import datasets as tdata  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import entropy_ref  # noqa: E402
from repro_torch.kernels.uncertainty import entropy_scores  # noqa: E402
from repro_torch.labelstream import arrivals as tarr  # noqa: E402
from repro_torch.learning import allocate as talloc  # noqa: E402
from repro_torch.learning import features as tfeat  # noqa: E402
from repro_torch.learning import linear as tl  # noqa: E402
from repro_torch.learning import select as tsel  # noqa: E402
from repro_torch.scenarios import run_learning  # noqa: E402


def _logits(shape, scale, seed, bf16=False):
    x = (np.random.default_rng(seed).normal(size=shape) * scale
         ).astype(np.float32)
    j, t = jnp.asarray(x), torch.from_numpy(x)
    if bf16:
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _check_entropy(shape, scale, seed, bf16, atol, rtol):
    j, t = _logits(shape, scale, seed, bf16)
    before = entropy_scores.launches
    got = entropy_scores(t)
    assert entropy_scores.launches == before       # CPU tensors: no launch
    assert got.dtype == torch.float32 and got.shape == shape[:-1]
    np.testing.assert_array_equal(got.numpy(), entropy_ref(t).numpy())
    flat = j.reshape(-1, shape[-1])
    want = [np.asarray(jref.entropy_ref(j)),
            np.asarray(jax_entropy(flat, interpret=True)).reshape(shape[:-1])]
    for w in want:
        np.testing.assert_allclose(got.numpy(), w, atol=atol, rtol=rtol)
    V = shape[-1]
    assert (got.numpy() >= -1e-3).all()
    assert (got.numpy() <= np.log(V) + 1e-3).all()


# tests/test_kernels.py::test_entropy: atol max(tol, 1e-4) * 10, rtol 1e-2
@pytest.mark.parametrize("N,V", [(10, 100), (100, 1000), (64, 50304),
                                 (33, 777)])
@pytest.mark.parametrize("bf16", [False, True])
def test_entropy_matches_jax_vocab_widths(N, V, bf16):
    tol = 2e-2 if bf16 else 2e-5
    _check_entropy((N, V), 4.0, N * V, bf16, max(tol, 1e-4) * 10, 1e-2)


# tests/test_kernels.py::test_entropy_learner_widths
@pytest.mark.parametrize("N,C", [(256, 2), (384, 10), (512, 64), (777, 17),
                                 (1024, 48)])
@pytest.mark.parametrize("bf16", [False, True])
def test_entropy_matches_jax_learner_widths(N, C, bf16):
    tol = 2e-2 if bf16 else 2e-5
    _check_entropy((N, C), 3.0, N * C, bf16, max(tol, 1e-4) * 10, 1e-2)


# tests/test_learning.py::test_entropy_kernel_matches_oracle_odd_shapes
@pytest.mark.parametrize("N,V", [(1, 3), (7, 129), (33, 1031), (65, 130),
                                 (3, 2), (129, 513)])
@pytest.mark.parametrize("bf16", [False, True])
def test_entropy_matches_jax_odd_shapes(N, V, bf16):
    tol = 2e-2 if bf16 else 1e-4
    _check_entropy((N, V), 3.0, N + V, bf16, tol, tol)


# tests/test_kernels.py::test_entropy_vmapped and tests/test_learning.py::
# test_entropy_kernel_batched_vmap_matches_oracle: leading dims
@pytest.mark.parametrize("shape,atol,rtol", [((4, 300, 8), 1e-3, 1e-2),
                                             ((3, 256, 33), 1e-3, 1e-2),
                                             ((4, 33, 257), 1e-4, 1e-4)])
def test_entropy_matches_jax_batched(shape, atol, rtol):
    _check_entropy(shape, 3.0, sum(shape), False, atol, rtol)


def test_entropy_wrapper_checks_inputs():
    with pytest.raises(TypeError):
        entropy_scores(torch.zeros((3, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        entropy_scores(torch.tensor(1.0))
    assert entropy_scores(torch.zeros((5, 0))).shape == (5,)


def test_uncertainty_topk_matches_jax_with_ties():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 7)).astype(np.float32) * 2
    x[10:20] = x[3]                 # equal rows: equal entropies
    x[40:44] = 0.0                  # the maximum, tied four ways
    jv, ji = jops.uncertainty_topk(jnp.asarray(x), 16)
    tv, ti = tops.uncertainty_topk(torch.from_numpy(x), 16)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    assert ti[:4].tolist() == [40, 41, 42, 43]


# --------------------------------------------------------------------------
# the learner
# --------------------------------------------------------------------------

def _problem(seed=0, n=400, d=6, n_classes=3):
    rng = np.random.default_rng(seed)
    W0 = rng.normal(size=(d, n_classes))
    X = rng.normal(size=(n, d)).astype(np.float32)
    return X, (X @ W0).argmax(-1)


def _ref_state(X, y, sw, steps, seed):
    """One init (a small random W, b) and the reference's fit from it."""
    rng = np.random.default_rng(seed)
    d, C = X.shape[1], int(y.max()) + 1
    st = jl.init(d, C)._replace(
        W=jnp.asarray(rng.normal(size=(d, C)).astype(np.float32) * 0.1),
        b=jnp.asarray(rng.normal(size=(C,)).astype(np.float32) * 0.1))
    fitted = jl.fit(st, jnp.asarray(X), jnp.asarray(y, jnp.int32),
                    jnp.asarray(sw), steps=steps)
    return st, fitted


@pytest.mark.parametrize("labeled_frac", [1.0, 0.3])
def test_fit_matches_jax(labeled_frac):
    X, y = _problem()
    rng = np.random.default_rng(1)
    sw = (rng.uniform(size=len(y)) < labeled_frac).astype(np.float32)
    st, want = _ref_state(X, y, sw, 40, seed=2)
    got = tl.fit(tl.from_numpy(st, device="cpu"), torch.from_numpy(X),
                 torch.from_numpy(y), torch.from_numpy(sw), steps=40)
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), rtol=1e-4,
                               atol=1e-5)
    assert int(got.t) == int(want.t) == 40
    np.testing.assert_allclose(
        tl.test_accuracy(got, torch.from_numpy(X), torch.from_numpy(y)),
        float(jl.test_accuracy(want, jnp.asarray(X), jnp.asarray(y))),
        atol=1e-6)


@pytest.mark.parametrize("pick", [2, 6])
def test_fit_from_zero_on_balanced_labels_matches_jax(pick):
    """At uniform predictions a class-balanced label set makes the bias
    gradient zero in exact arithmetic; the reference's rounding residue
    (0 or +-2^-27, by its summation order) is what Adam's normalized step
    follows, so the port must sum the rows in the reference's order."""
    X, y = _problem(seed=4, n=200, d=5, n_classes=2)
    rng = np.random.default_rng(pick)
    sw = np.zeros(len(y), np.float32)
    for c in range(2):
        sw[rng.choice(np.nonzero(y == c)[0], 5, replace=False)] = 1.0
    st = jl.init(5, 2)
    want = jl.fit(st, jnp.asarray(X), jnp.asarray(y, jnp.int32),
                  jnp.asarray(sw), steps=30)
    got = tl.fit(tl.from_numpy(st, device="cpu"), torch.from_numpy(X),
                 torch.from_numpy(y), torch.from_numpy(sw), steps=30)
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), rtol=1e-4,
                               atol=1e-5)


def test_row_sum_follows_the_reference_order():
    rng = np.random.default_rng(1)
    rs = jax.jit(lambda a: jnp.sum(a, 1))
    for n in (1, 31, 32, 33, 500, 1500, 3000):
        a = (rng.normal(size=(3, n, 4))
             * np.exp(rng.normal(size=(3, n, 4)) * 3)).astype(np.float32)
        np.testing.assert_array_equal(tl._row_sum(torch.from_numpy(a)).numpy(),
                                      np.asarray(rs(jnp.asarray(a))))


def test_fit_batched_matches_per_replication():
    X, y = _problem()
    rng = np.random.default_rng(3)
    sw = (rng.uniform(size=(3, len(y))) < 0.4).astype(np.float32)
    sw[1] = 0.0                                  # a replication, no labels
    ys = np.stack([y, (y + 1) % 3, y])
    st = tl.init(6, 3, lead=(3,), device="cpu")
    got = tl.fit(st, torch.from_numpy(X), torch.from_numpy(ys),
                 torch.from_numpy(sw), steps=25)
    for i in range(3):
        one = tl.fit(tl.init(6, 3, device="cpu"), torch.from_numpy(X),
                     torch.from_numpy(ys[i]), torch.from_numpy(sw[i]),
                     steps=25)
        np.testing.assert_allclose(got.W[i].numpy(), one.W.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert int(got.t[i]) == int(one.t)
    assert int(got.t[1]) == 0 and not got.W[1].any()


def test_fit_no_labels_is_noop():
    X, y = _problem()
    sw = np.zeros(len(y), np.float32)
    st, want = _ref_state(X, y, sw, 10, seed=5)
    port = tl.from_numpy(st, device="cpu")
    got = tl.fit(port, torch.from_numpy(X), torch.from_numpy(y),
                 torch.from_numpy(sw), steps=10)
    for a, b, w in zip(got, tl.reset_opt(port), want):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


def test_online_fit_keeps_momentum():
    X, y = _problem()
    sw = np.ones(len(y), np.float32)
    jst, tst = jl.init(6, 3), tl.init(6, 3, device="cpu")
    for _ in range(4):
        jst = jl.fit(jst, jnp.asarray(X), jnp.asarray(y, jnp.int32),
                     jnp.asarray(sw), steps=10, fresh_opt=False)
        tst = tl.fit(tst, torch.from_numpy(X), torch.from_numpy(y),
                     torch.from_numpy(sw), steps=10, fresh_opt=False)
    assert int(tst.t) == int(jst.t) == 40
    for a, w in zip(tst[:6], jst[:6]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    assert int(tl.fit(tst, torch.from_numpy(X), torch.from_numpy(y),
                      torch.from_numpy(sw), steps=10).t) == 10


def test_entropy_and_predict_match_jax():
    X, y = _problem()
    st, fitted = _ref_state(X, y, np.ones(len(y), np.float32), 20, seed=6)
    port = tl.from_numpy(fitted, device="cpu")
    Xt = torch.from_numpy(X)
    np.testing.assert_allclose(tl.entropy(port, Xt).numpy(),
                               np.asarray(jl.entropy(fitted, jnp.asarray(X))),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        tl.entropy(port, Xt, use_kernel=False).numpy(),
        entropy_ref(tl.logits(port, Xt)).numpy())
    np.testing.assert_array_equal(tl.predict(port, Xt).numpy(),
                                  np.asarray(jl.predict(fitted,
                                                        jnp.asarray(X))))
    np.testing.assert_allclose(tl.predict_proba(port, Xt).numpy(),
                               np.asarray(jl.predict_proba(fitted,
                                                           jnp.asarray(X))),
                               atol=1e-6)


# --------------------------------------------------------------------------
# selection
# --------------------------------------------------------------------------

def _sel_inputs(seed, n=40, B=8):
    rng = np.random.default_rng(seed)
    # quantized scores force many exact ties
    scores = (np.round(rng.uniform(0, 1, (B, n)) * 4) / 4).astype(np.float32)
    labeled = rng.uniform(size=(B, n)) < 0.3
    return scores, labeled


@pytest.mark.parametrize("k", [0, 7, 45])
def test_al_select_matches_jax_with_ties(k):
    scores, labeled = _sel_inputs(3)
    idx, take = tsel.al_select(torch.from_numpy(scores),
                               torch.from_numpy(labeled), k)
    for i in range(scores.shape[0]):
        ji, jt = jsel.al_select(jnp.asarray(scores[i]),
                                jnp.asarray(labeled[i]), k)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(take[i].numpy(), np.asarray(jt))


@pytest.mark.parametrize("k_active,n_passive", [(5, 5), (0, 10), (10, 0),
                                                (30, 20)])
def test_hybrid_select_matches_jax_on_injected_uniforms(k_active, n_passive):
    scores, labeled = _sel_inputs(4)
    B, n = scores.shape
    keys = jax.random.split(jax.random.key(9), B)
    with jax.threefry_partitionable(False):
        u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))
        want = [jsel.hybrid_select(keys[i], jnp.asarray(scores[i]),
                                   jnp.asarray(labeled[i]), k_active,
                                   n_passive) for i in range(B)]
    chosen, take, act = tsel.hybrid_select(
        torch.from_numpy(u), torch.from_numpy(scores),
        torch.from_numpy(labeled), k_active, n_passive)
    for i, (jc, jt, ja) in enumerate(want):
        np.testing.assert_array_equal(chosen[i].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(take[i].numpy(), np.asarray(jt))
        np.testing.assert_array_equal(act[i].numpy(), np.asarray(ja))
        valid = chosen[i][take[i]].numpy()
        assert len(set(valid.tolist())) == len(valid)
        assert not labeled[i][valid].any()


# --------------------------------------------------------------------------
# datasets, features, allocation, the front door
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 4])
def test_datasets_bit_identical(seed):
    for fn, kw in ((tdata.make_classification,
                    dict(n_samples=300, n_features=8, n_informative=2,
                         n_classes=2, class_sep=1.8)),
                   (tdata.make_classification,
                    dict(n_samples=250, n_features=12, n_informative=5,
                         n_classes=4)),
                   (tdata.mnist_like, dict(n_samples=200)),
                   (tdata.cifar_like, dict(n_samples=50))):
        got = fn(seed=seed, **kw)
        want = getattr(jdata, fn.__name__)(seed=seed, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        parts = tdata.train_test_split(*got, test_frac=0.25, seed=seed)
        for a, b in zip(parts, jdata.train_test_split(*want, test_frac=0.25,
                                                      seed=seed)):
            np.testing.assert_array_equal(a, b)


def test_standardize_and_allocate_match_jax():
    X = np.random.default_rng(2).normal(3.0, 2.0, (50, 6)).astype(np.float32)
    X[:, 2] = 1.5                                # a constant feature
    np.testing.assert_allclose(tfeat.standardize(X).numpy(),
                               np.asarray(jfeat.standardize(X)), atol=1e-6)
    for budget, r in ((10, 0.5), (10, 0.0), (7, 0.33), (0, 0.5)):
        assert talloc.split_budget(budget, r) == jalloc.split_budget(budget,
                                                                     r)
    a, b = talloc.AccEst(r=0.5), jalloc.AccEst(r=0.5)
    for ga, gp in ((0.9, 0.1), (-0.2, 0.3), (0.05, 0.9), (0.0, 0.0)):
        assert a.update(ga, gp) == b.update(ga, gp)
    assert a.split(9) == b.split(9)


def test_init_arrival_state_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tarr.init_arrival_state(tarr.ArrivalConfig(kind="mmpp"), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_learning("hybrid_small", rounds=1, n_reps=1)


def test_run_learning_spec_built_dataset():
    """The facade builds the reference's dataset from the spec and runs
    the batch engine's learning loop with the learner kind's split."""
    out = run_learning("hybrid_small", rounds=2, n_reps=3, fit_steps=10,
                       n_train=300, n_test=100, device="cpu")
    curve = out["curve"]
    assert curve["acc"].shape == (3, 3)
    assert (curve["n_labeled"][:, -1] == 20).all()
    assert out["config"].pool_size == 10
    Xa, ya = jdata.make_classification(n_samples=400, n_features=8,
                                       n_informative=2, n_classes=2,
                                       class_sep=1.8, seed=0)
    X, y, Xt, yt = jdata.train_test_split(Xa, ya, test_frac=0.25, seed=0)
    same = run_learning("hybrid_small", X, y, Xt, yt, rounds=2, n_reps=3,
                        fit_steps=10, device="cpu")
    for k in ("t", "n_labeled", "acc"):
        assert torch.equal(curve[k], same["curve"][k])
    curve1 = run_learning("hybrid_small", X, y, Xt, yt, vectorized=False,
                          rounds=2, fit_steps=10, device="cpu")["curve"]
    assert len(curve1) == 3 and curve1[-1][1] == 20
    with pytest.raises(ValueError):
        run_learning("hybrid_small", X, device="cpu")
