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
from repro_torch.kernels import ordered_sum as kos  # noqa: E402
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


def _in_order(A, B):
    """``A @ B`` in numpy float32, each output from 0 adding its products in
    index order, each product and add rounded on its own."""
    A, B = np.broadcast_arrays(A[..., :, :, None], B[..., None, :, :])
    out = np.zeros(A.shape[:-3] + (A.shape[-3], A.shape[-1]), np.float32)
    with np.errstate(all="ignore"):
        for t in range(A.shape[-2]):
            out = out + A[..., t, :] * B[..., t, :]
    return out


def _segment_reduce_matmul(A, B):
    """The learner's product as the port computed it before the kernel: the
    product tensor, then one sequential ``segment_reduce`` over its k."""
    p = A[..., :, :, None] * B[..., None, :, :]
    lead, k, m = p.shape[:-2], p.shape[-2], p.shape[-1]
    p = p.reshape((-1, k, m))
    lengths = torch.full((p.shape[0], 1), k, dtype=torch.int64)
    return torch.segment_reduce(p, "sum", lengths=lengths, axis=1,
                                unsafe=True).reshape(lead + (m,))


def _wide(rng, shape):
    return (rng.normal(size=shape) * np.exp(rng.normal(size=shape) * 3)
            ).astype(np.float32)


# (A's shape, B's shape, A transposed from its last two dims): the stream
# cells' shapes cut down, the gradient's transposed view, k = 1, k not a
# multiple of 4, m = 1 and 3, n = 0, leading and broadcast dims
ORDERED_CASES = [
    ((4, 32, 8), (4, 8, 2), False),
    ((3, 256, 8), (3, 8, 2), False),
    ((3, 8, 256), (3, 256, 2), True),
    ((5, 1024, 8), (5, 8, 2), False),
    ((6, 40, 1), (6, 1, 2), False),
    ((6, 40, 7), (6, 7, 2), False),
    ((6, 40, 16), (6, 16, 1), False),
    ((6, 9, 5), (6, 5, 3), False),
    ((4, 0, 8), (4, 8, 2), False),
    ((2, 3, 5, 4), (2, 3, 4, 2), False),
    ((5, 4), (3, 4, 2), False),
]


@pytest.mark.parametrize("a_shape,b_shape,transposed", ORDERED_CASES)
def test_ordered_matmul_cpu_route_equals_segment_reduce(a_shape, b_shape,
                                                        transposed):
    rng = np.random.default_rng(sum(a_shape) + 7 * sum(b_shape))
    a = _wide(rng, a_shape[:-2] + a_shape[-2:][::-1] if transposed
              else a_shape)
    B = torch.from_numpy(_wide(rng, b_shape))
    A = torch.from_numpy(a)
    if transposed:
        A = A.transpose(-1, -2)
        assert not A.is_contiguous()
    before = kos.ordered_matmul.launches
    got = kos.ordered_matmul(A, B)
    assert kos.ordered_matmul.launches == before     # CPU: no launch
    assert got.dtype == torch.float32
    assert torch.equal(got, _segment_reduce_matmul(A, B))
    np.testing.assert_array_equal(got.numpy(), _in_order(A.numpy(),
                                                         B.numpy()))
    assert torch.equal(tl.ordered_matmul(A, B), got)


# a's values against b's ones: each case's in-order sum differs from a
# pairwise or reversed one, or needs IEEE's rules for zeros, inf and NaN
ORDER_VALUES = {
    "cancel": [1e8, 1.0, -1e8],
    "cancel_late": [1.0, 1e8, -1e8, 1.0],
    "signed_zeros": [-0.0, -0.0, -0.0],
    "neg_zero_then_zero": [-0.0, 0.0],
    "inf": [np.inf, 1.0, 2.0],
    "inf_minus_inf": [np.inf, -np.inf, 1.0],
    "nan": [1.0, np.nan, 2.0],
    "tiny": [1e-45, 1e-45, 3e38, -3e38],
}


@pytest.mark.parametrize("case", list(ORDER_VALUES))
def test_ordered_sums_follow_index_order_on_special_values(case):
    v = np.asarray(ORDER_VALUES[case], np.float32)
    k = v.size
    A = torch.from_numpy(np.stack([v, v[::-1].copy()])[None])  # (1, 2, k)
    B = torch.ones((1, k, 2))
    B[0, :, 1] = -1.0
    got = kos.ordered_matmul(A, B)
    want = _in_order(A.numpy(), B.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  _segment_reduce_matmul(A, B).numpy())
    np.testing.assert_array_equal(np.signbit(got.numpy()),
                                  np.signbit(want))
    g = A.transpose(-1, -2).contiguous()                   # (1, k, 2)
    seg, seg_want = kos.segment_sum(g, k), np.zeros((1, 1, 2), np.float32)
    with np.errstate(all="ignore"):
        for t in range(k):
            seg_want = seg_want + g.numpy()[:, t:t + 1]
    np.testing.assert_array_equal(seg.numpy(), seg_want)
    np.testing.assert_array_equal(np.signbit(seg.numpy()),
                                  np.signbit(seg_want))
    if case == "cancel":
        assert got[0, 0, 0].item() == 0.0 and v.sum(dtype=np.float64) == 1.0
    if case == "signed_zeros":
        assert not np.signbit(got.numpy()).any()      # 0 + -0 is +0


@pytest.mark.parametrize("R,n,C,size", [
    (4, 256, 2, 32), (4, 8, 2, 8), (3, 96, 4, 32), (5, 7, 1, 7),
    (2, 30, 3, 5), (0, 64, 2, 32), (3, 0, 2, 4)])
def test_segment_sum_cpu_route_equals_segment_reduce(R, n, C, size):
    rng = np.random.default_rng(R * 1000 + n * 10 + C)
    g = torch.from_numpy(_wide(rng, (R, n, C)))
    before = kos.segment_sum.launches
    got = kos.segment_sum(g, size)
    assert kos.segment_sum.launches == before
    assert got.shape == (R, n // size, C)
    lengths = torch.full((R, n // size), size, dtype=torch.int64)
    assert torch.equal(got, torch.segment_reduce(g, "sum", lengths=lengths,
                                                 axis=1, unsafe=True))
    runs = g.numpy().reshape(R, n // size, size, C)
    want = np.zeros((R, n // size, C), np.float32)
    for t in range(size):
        want = want + runs[:, :, t]
    np.testing.assert_array_equal(got.numpy(), want)


def test_ordered_sum_wrapper_refuses_bad_inputs():
    A, B = torch.zeros(2, 3, 4), torch.zeros(2, 4, 2)
    bad = [
        (TypeError, lambda: kos.ordered_matmul(A.double(), B.double())),
        (TypeError, lambda: kos.ordered_matmul(A, B.to(torch.bfloat16))),
        (ValueError, lambda: kos.ordered_matmul(A[0, 0], B)),
        (ValueError, lambda: kos.ordered_matmul(A, torch.zeros(2, 3, 2))),
        (ValueError, lambda: kos.ordered_matmul(torch.zeros(2, 3, 0),
                                                torch.zeros(2, 0, 2))),
        (ValueError, lambda: kos.ordered_matmul(A, torch.zeros(2, 4, 0))),
        (ValueError, lambda: kos.ordered_matmul(A, torch.zeros(3, 4, 2))),
        (ValueError, lambda: kos.ordered_matmul(A.to("meta"), B.to("meta"))),
        (TypeError, lambda: kos.segment_sum(A.double(), 3)),
        (ValueError, lambda: kos.segment_sum(A[0], 3)),
        (ValueError, lambda: kos.segment_sum(A, 2)),
        (ValueError, lambda: kos.segment_sum(A, 0)),
    ]
    counts = (kos.ordered_matmul.launches, kos.segment_sum.launches)
    for err, call in bad:
        with pytest.raises(err):
            call()
    assert (kos.ordered_matmul.launches, kos.segment_sum.launches) == counts


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
