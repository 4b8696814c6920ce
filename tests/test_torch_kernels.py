"""The port's kernel wrappers on the CPU, held against the JAX package.

On the CPU, ``repro_torch.kernels.ds_estep.ds_estep`` runs its plain
version ``ds_estep_ref``; both are held against the Pallas kernel in
interpret mode and against the JAX package's jnp oracle, on the same
inputs made from a seed with numpy. Tolerances are the reference test's
(tests/test_labelstream.py::test_ds_estep_kernel_matches_ref): 1e-4 on
logp, 1e-5 on post. The kernel itself is held against the plain version on
the card in tests/test_torch_kernels_cuda.py and chip_smoke.py.

The cross entropy's plain version is held against the Pallas kernel in
interpret mode at the reference test's cases and tolerance
(tests/test_kernels.py::test_streaming_xent), and against the jnp oracle at
float32's 2e-5. The plain backward versions (``xent_bwd_ref``,
``attention_bwd_ref``, ``linear_scan_bwd_ref``) are held against
``jax.vjp`` of the reference's oracles: float32 at 2e-5 for the cross
entropy and attention (float32 sums in other orders) and 20x that for the
scan (the oracle's associative scan sums in another order, as its forward
test allows); bfloat16 attention at the reference tests' 2e-2 (jnp.repeat's
transpose sums the G heads' gradients in bfloat16, the port in float32);
the bfloat16 cross entropy's gradient within one bfloat16 ulp. On the CPU
each wrapper's autograd gives exactly its plain backward (for the scan,
that of the route ``scan_route`` takes for the shape).

The chunked scan's plain versions sum in another order than the
reference's associative scan and its Pallas kernel, so they are held to
the scan's existing tolerances, not bit for bit: 20x the reference test's
tol against the oracle, 1e-5 against the Pallas kernel in interpret mode
(float32; bfloat16 rounds the output, 20x its tol), 4e-4 against
``jax.vjp`` of the oracle. For S <= SCAN_CHUNK the two routes are equal
bit for bit.
"""
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402

import repro.kernels.ref as jref  # noqa: E402
from repro.kernels.ds_estep import ds_estep as jax_ds_estep  # noqa: E402
from repro.kernels.linear_scan import linear_scan as jax_scan  # noqa: E402
from repro.kernels.xent import streaming_xent as jax_xent  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.ds_estep import (  # noqa: E402
    ROUTES as ESTEP_ROUTES, ds_estep, estep_route,
)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.linear_scan import (  # noqa: E402
    ROUTES, SEQUENTIAL_MAX_STEPS, linear_scan, scan_route,
)
from repro_torch.kernels.ref import (  # noqa: E402
    SCAN_CHUNK, attention_bwd_ref, attention_ref, ds_estep_ref, entropy_ref,
    linear_scan_bwd_ref, linear_scan_chunked_bwd_ref, linear_scan_chunked_ref,
    linear_scan_ref, xent_bwd_ref, xent_ref,
)
from repro_torch.kernels.uncertainty import (  # noqa: E402
    ROUTES as ENTROPY_ROUTES, entropy_route, entropy_scores,
)
from repro_torch.kernels.xent import streaming_xent  # noqa: E402


def _inputs(W, C, T, V, seed, B=None):
    rng = np.random.default_rng(seed)
    R = W * C + 1
    lead = () if B is None else (B,)
    rows = np.log(rng.uniform(0.05, 0.95, lead + (R, C))).astype(np.float32)
    rows[..., -1, :] = 0.0
    idx = rng.integers(0, R, lead + (T, V)).astype(np.int32)
    idx[..., 7 % T, :] = R - 1                     # a zero-vote task
    return rows, idx


# (W, C, T, V, B): the reference test's shapes, a class count above one
# warp, and a batched table as the stream refresh builds it
SHAPES = [(9, 4, 77, 5, None), (16, 8, 512, 5, None), (5, 33, 50, 3, None),
          (9, 2, 32, 5, 6), (4, 33, 40, 4, 3)]


@pytest.mark.parametrize("W,C,T,V,B", SHAPES)
def test_ds_estep_plain_matches_jax(W, C, T, V, B):
    rows, idx = _inputs(W, C, T, V, seed=W * C + T, B=B)
    before = ds_estep.launches
    lp, p = ds_estep(torch.from_numpy(rows), torch.from_numpy(idx))
    assert ds_estep.launches == before            # CPU tensors: no launch
    lp, p = lp.numpy(), p.numpy()
    lr, pr = ds_estep_ref(torch.from_numpy(rows), torch.from_numpy(idx))
    np.testing.assert_array_equal(lp, lr.numpy())
    np.testing.assert_array_equal(p, pr.numpy())
    batch = [(rows, idx)] if B is None else list(zip(rows, idx))
    for b, (r, i) in enumerate(batch):
        lj, pj = jref.ds_estep_ref(jnp.asarray(r), jnp.asarray(i))
        lk, pk = jax_ds_estep(jnp.asarray(r), jnp.asarray(i), interpret=True)
        got_lp = lp if B is None else lp[b]
        got_p = p if B is None else p[b]
        for want_lp, want_p in ((lj, pj), (lk, pk)):
            np.testing.assert_allclose(got_lp, np.asarray(want_lp), atol=1e-4)
            np.testing.assert_allclose(got_p, np.asarray(want_p), atol=1e-5)
        np.testing.assert_allclose(got_p[7 % T], 1.0 / C, atol=1e-7)
        np.testing.assert_allclose(got_lp[7 % T], -math.log(C), atol=1e-6)


def _task_softmax(logp):
    """The task kernel's softmax, op by op in float32: a sequential max
    over the classes, e_c = exp(logp_c - m), s = e_0 + e_1 + ... in class
    order, post = e_c / s."""
    C = logp.shape[-1]
    m = logp[..., 0]
    for c in range(1, C):
        m = torch.maximum(m, logp[..., c])
    e = [torch.exp(logp[..., c] - m) for c in range(C)]
    s = e[0]
    for c in range(1, C):
        s = s + e[c]
    return torch.stack([x / s for x in e], -1)


# SHAPES at their tolerances, then offline-sized tables (W = 1024) at T =
# 4096 for the class counts the offline EM and the stream run
EMUL_SHAPES = ([(W, C, T, V, B, 1e-4 if (W, C, T) == (16, 8, 512) else 1e-5)
                for W, C, T, V, B in SHAPES]
               + [(1024, C, 4096, 5, None, 1e-5) for C in (2, 4, 8)])


@pytest.mark.parametrize("W,C,T,V,B,tol", EMUL_SHAPES)
def test_ds_estep_task_softmax_order_holds_the_card_tolerance(W, C, T, V, B,
                                                              tol):
    """The task kernel takes its softmax in another order than
    ``torch.softmax``; emulated on the CPU, that order stays within the
    card's post tolerance of ``ds_estep_ref``, and a zero-vote task stays
    exactly uniform."""
    rows, idx = _inputs(W, C, T, V, seed=W + C + T, B=B)
    lr, pr = ds_estep_ref(torch.from_numpy(rows), torch.from_numpy(idx))
    pe = _task_softmax(lr)
    assert (pe - pr).abs().max().item() <= tol
    assert torch.equal(pe[..., 7 % T, :],
                       torch.full_like(pe[..., 7 % T, :], 1.0 / C))


def test_estep_and_entropy_routes_are_functions_of_shape(monkeypatch):
    """The routes read the shape (and the dtype) only: no device argument,
    and the same answer whether or not torch sees a card."""
    import inspect
    assert list(inspect.signature(estep_route).parameters) == [
        "B", "R", "C", "T", "V"]
    assert list(inspect.signature(entropy_route).parameters) == [
        "V", "dtype"]
    cases = {(1, 4097, 4, 1 << 20, 5): "task", (1, 8193, 8, 1 << 20, 5):
             "task", (512, 19, 2, 32, 5): "task", (1, 10, 1, 7, 32): "task",
             (1, 10, 8, 7, 33): "group", (1, 37, 9, 77, 5): "group",
             (3, 129, 32, 77, 3): "group", (3, 521, 130, 77, 3): "wide"}
    ent = {(2, torch.float32): "narrow", (64, torch.bfloat16): "narrow",
           (65, torch.float32): "wide", (50304, torch.bfloat16): "wide"}

    def routes():
        return ({c: estep_route(*c) for c in cases},
                {c: entropy_route(*c) for c in ent})
    assert routes() == (cases, ent)

    def no_device(*_a, **_k):
        raise AssertionError("a route asked about a device")
    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    monkeypatch.setattr(torch.cuda, "device_count", no_device)
    monkeypatch.setattr(torch.cuda, "current_device", no_device)
    assert routes() == (cases, ent)
    assert set(cases.values()) <= set(ESTEP_ROUTES)
    assert set(ent.values()) <= set(ENTROPY_ROUTES)
    with pytest.raises(TypeError):
        entropy_route(10, torch.float64)


@pytest.mark.parametrize("route", [None] + sorted(ESTEP_ROUTES))
def test_ds_estep_wrapper_on_cpu_ignores_the_route(route):
    """CPU tensors take ``ds_estep_ref`` whatever ``_route`` says, and no
    launch is counted; so does ``entropy_scores`` with ``entropy_ref``."""
    rows, idx = _inputs(9, 4, 77, 5, seed=2, B=3)
    r, i = torch.from_numpy(rows), torch.from_numpy(idx)
    before = (ds_estep.launches, ds_estep.task_launches,
              entropy_scores.launches)
    lp, p = ds_estep(r, i, _route=route)
    lr, pr = ds_estep_ref(r, i)
    assert torch.equal(lp, lr) and torch.equal(p, pr)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(33, 10)).astype(np.float32))
    for er in [None] + sorted(ENTROPY_ROUTES):
        assert torch.equal(entropy_scores(x, _route=er), entropy_ref(x))
    assert (ds_estep.launches, ds_estep.task_launches,
            entropy_scores.launches) == before


@pytest.mark.parametrize("current", [0, 1])
def test_launch_enters_the_device_only_when_not_current(monkeypatch,
                                                        current):
    """``_build.launch`` passes the card's current stream to the entry
    point as its last argument and returns its error code; it enters
    ``torch.cuda.device`` only when the tensor's card is not the current
    one."""
    entered = []

    class Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(_build, "_stream", lambda index: 1000 + index)
    calls = []

    def fn(*args):
        calls.append(args)
        return 7
    assert _build.launch(fn, torch.device("cuda", 1), "a", 2) == 7
    assert calls == [("a", 2, 1001)]
    assert entered == ([] if current == 1 else [1])


def test_ds_estep_zero_votes_is_uniform():
    rows, _ = _inputs(3, 5, 4, 2, seed=3)
    idx = np.zeros((6, 0), np.int32)
    lp, p = ds_estep(torch.from_numpy(rows), torch.from_numpy(idx))
    lj, pj = jref.ds_estep_ref(jnp.asarray(rows), jnp.asarray(idx))
    assert lp.shape == (6, 5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=1e-6)
    np.testing.assert_array_equal(p.numpy(), np.full((6, 5), 0.2, np.float32))


@pytest.mark.parametrize("rows_shape,idx_shape", [
    ((5, 2), (4, 3, 2)), ((2, 5, 2), (3, 4, 3)), ((0, 2), (4, 3)),
    ((5,), (5,))])
def test_ds_estep_rejects_bad_shapes(rows_shape, idx_shape):
    with pytest.raises(ValueError):
        ds_estep(torch.zeros(rows_shape), torch.zeros(idx_shape,
                                                      dtype=torch.int32))


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device("cuda")
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        repro_torch.resolve_device("meta")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


# ------------------------------------------------ the training kernels ----

def _xent_inputs(N, V, seed, bf16):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(N, V)) * 3).astype(np.float32)
    t = rng.integers(0, V, N).astype(np.int32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if bf16:
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    return xj, xt, jnp.asarray(t), torch.from_numpy(t)


@pytest.mark.parametrize("N,V", [(10, 100), (64, 50304), (33, 777)])
@pytest.mark.parametrize("bf16", [False, True])
def test_xent_plain_matches_pallas_interpret(N, V, bf16):
    xj, xt, tj, tt = _xent_inputs(N, V, N + V, bf16)
    got = xent_ref(xt, tt).numpy()
    before = streaming_xent.launches
    np.testing.assert_array_equal(streaming_xent(xt, tt).numpy(), got)
    np.testing.assert_array_equal(ops.streaming_xent(xt, tt).numpy(), got)
    assert streaming_xent.launches == before          # CPU: no launch
    tol = 2e-2 if bf16 else 2e-5
    np.testing.assert_allclose(
        got, np.asarray(jax_xent(xj, tj, interpret=True)),
        atol=max(tol * 10, 1e-4), rtol=1e-2)
    np.testing.assert_allclose(got, np.asarray(jref.xent_ref(xj, tj)),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("N,V", [(10, 100), (33, 777)])
@pytest.mark.parametrize("bf16", [False, True])
def test_xent_bwd_plain_matches_jax_vjp(N, V, bf16):
    xj, xt, tj, tt = _xent_inputs(N, V, N * V, bf16)
    g = np.random.default_rng(N).normal(size=N).astype(np.float32)
    g[1] = 0.0
    _, vjp = jax.vjp(lambda z: jref.xent_ref(z, tj), xj)
    (want,) = vjp(jnp.asarray(g))
    lse = torch.logsumexp(xt.float(), -1)
    got = xent_bwd_ref(xt, tt, lse, torch.from_numpy(g))
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-6, rtol=8e-3 if bf16 else 2e-5)
    xr = xt.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(streaming_xent(xr, tt),
                                  xr, torch.from_numpy(g))
    assert torch.equal(auto, got)


# (B, Hq, Hkv, Sq, Sk, D) x (causal, window): GQA at a length that is not a
# multiple of anything, MQA across lengths, a window, and non-causal ones
ATTN_BWD = [((1, 4, 2, 37, 37, 16), (True, 0)),
            ((2, 4, 1, 24, 40, 16), (True, 0)),
            ((1, 2, 2, 50, 50, 32), (True, 8)),
            ((1, 3, 1, 20, 20, 16), (False, 0)),
            ((1, 2, 2, 33, 33, 16), (False, 5))]


@pytest.mark.parametrize("shape,cw", ATTN_BWD)
@pytest.mark.parametrize("bf16", [False, True])
def test_attention_bwd_plain_matches_jax_vjp(shape, cw, bf16):
    B, Hq, Hkv, Sq, Sk, D = shape
    causal, window = cw
    rng = np.random.default_rng(sum(shape))
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D),
                      (B, Hq, Sq, D))]
    js = [jnp.asarray(a) for a in arrs]
    ts_ = [torch.from_numpy(a) for a in arrs]
    if bf16:
        js = [a.astype(jnp.bfloat16) for a in js]
        ts_ = [a.to(torch.bfloat16) for a in ts_]
    q, k, v, do = ts_
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(
        a, b, c, causal=causal, window=window), *js[:3])
    want = vjp(js[3])
    o = attention_ref(q, k, v, causal=causal, window=window)
    got = attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    tol = 2e-2 if bf16 else 2e-5
    for a, b in zip(got, want):
        assert a.dtype == q.dtype and tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   atol=tol, rtol=tol)
    # the wrapper's autograd on the CPU is the plain backward, in the
    # model's (B, S, H, D) layout
    tr = lambda x: x.transpose(1, 2)
    qr, kr, vr = (tr(x).detach().requires_grad_(True) for x in (q, k, v))
    auto = torch.autograd.grad(flash_attention(qr, kr, vr, causal=causal,
                                               window=window),
                               (qr, kr, vr), tr(do))
    for a, b in zip(auto, got):
        assert torch.equal(tr(a), b)


_LOG2E = math.log2(math.e)


def _bf16_route(q, k, v, do, causal, window, sms=132, tile=64):
    """The arithmetic of the card's bfloat16 flash kernels, in PyTorch:
    bf16 q, k, v (B, H, S, D) multiplied exactly into float32 scores; the
    forward's online softmax over 64-key tiles in base 2, each tile's p
    rounded to bf16 before p v, o divided by l and rounded once; the
    backward's p^T and ds^T = p^T (dp^T - delta) (the difference in
    float32) rounded to bf16 before their products, dk and dv summed per
    group of query heads (the kernel's split rule for ``sms`` SMs) and the
    groups' partials summed in order. Returns o and (dq, dk, dv)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    sl2 = _LOG2E / math.sqrt(D)
    qf, gf = q.float(), do.float()
    kf = k.float().repeat_interleave(G, 1)
    vf = v.float().repeat_interleave(G, 1)
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        keep &= kp <= qp
    if window > 0:
        keep &= qp - kp < window
    x = torch.where(keep, torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sl2,
                    torch.tensor(-1e30))
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, D))
    for k0 in range(0, Sk, tile):
        xt = x[..., k0:k0 + tile]
        m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(xt - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bhkd->bhqd", p.bfloat16().float(), vf[:, :, k0:k0 + tile])
        m = m_new
    den = l.clamp_min(1e-30)
    o = (acc / den).to(q.dtype)
    lse2 = m + torch.log2(den)                  # log2 units
    p = torch.exp2(x - lse2)
    delta = (gf * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, vf) - delta)
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    scale = 1 / math.sqrt(D)
    dq = (torch.einsum("bhqk,bhkd->bhqd", dsb, kf) * scale).to(q.dtype)
    dk_h = torch.einsum("bhqk,bhqd->bhkd", dsb, qf)
    dv_h = torch.einsum("bhqk,bhqd->bhkd", pb, gf)
    base = B * Hkv * -(-Sk // tile)
    nsplit = 1 if base >= sms else min(G, -(-sms // base))
    dk = torch.zeros((B, Hkv, Sk, D))
    dv = torch.zeros((B, Hkv, Sk, D))
    for s in range(nsplit):
        lo, hi = s * G // nsplit, (s + 1) * G // nsplit
        part = lambda t: t.reshape(B, Hkv, G, Sk, D)[:, :, lo:hi].sum(2)
        dk, dv = dk + part(dk_h), dv + part(dv_h)
    return o, (dq, (dk * scale).to(k.dtype), dv.to(v.dtype))


# the card tests' edge shapes (a head dim that is not a multiple of 8 over
# an odd head count, a ragged head dim, a GQA group of 5 that the head split
# does not divide, with a window) and the training shape's row structure
# (512 tokens, 10 q heads over one kv head of 256)
ROUTE_SHAPES = [((1, 3, 1, 100, 100, 60), (True, 0)),
                ((2, 4, 2, 77, 77, 80), (True, 0)),
                ((1, 5, 1, 150, 150, 32), (True, 40)),
                ((1, 10, 1, 512, 512, 256), (True, 2048))]


@pytest.mark.parametrize("shape,cw", ROUTE_SHAPES)
def test_bf16_route_rounding_fits_the_card_gates(shape, cw):
    """Rounding each 64-key tile's unnormalized p and ds to bf16 where the
    tensor-core kernels do keeps o, dq, dk and dv within the card tests'
    2e-2 of the plain versions, which round the normalized p to bf16 before
    p v as the reference's ``_attn_direct`` does, so the design needs no
    hi/lo split."""
    B, Hq, Hkv, Sq, Sk, D = shape
    causal, window = cw
    rng = np.random.default_rng(sum(shape))
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to(torch.bfloat16)
                   for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D),
                             (B, Hkv, Sk, D), (B, Hq, Sq, D)))
    o, grads = _bf16_route(q, k, v, do, causal, window)
    want_o = attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(o.float(), want_o.float(), atol=2e-2,
                               rtol=2e-2)
    want = attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    for got, w in zip(grads, want):
        assert got.dtype == torch.bfloat16 and got.shape == w.shape
        torch.testing.assert_close(got.float(), w.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("B,S,D", [(2, 50, 7), (3, 33, 16)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_linear_scan_bwd_plain_matches_jax_vjp(B, S, D, with_h0):
    rng = np.random.default_rng(B * S * D)
    a = (1 / (1 + np.exp(-rng.normal(size=(B, S, D))))).astype(np.float32)
    b = rng.normal(size=(B, S, D)).astype(np.float32)
    h0 = rng.normal(size=(B, D)).astype(np.float32)
    g = rng.normal(size=(B, S, D)).astype(np.float32)
    args = (jnp.asarray(a), jnp.asarray(b)) + ((jnp.asarray(h0),)
                                               if with_h0 else ())
    _, vjp = jax.vjp(lambda *x: jref.linear_scan_ref(*x), *args)
    want = vjp(jnp.asarray(g))
    th0 = torch.from_numpy(h0) if with_h0 else None
    h = linear_scan_ref(torch.from_numpy(a), torch.from_numpy(b), th0)
    da, db, dh0 = linear_scan_bwd_ref(torch.from_numpy(a), h,
                                      torch.from_numpy(g), th0)
    got = (da, db) + ((dh0,) if with_h0 else ())
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=4e-4,
                                   rtol=4e-4)
    # the wrapper's autograd is the plain backward of the route it takes
    fwd, bwd = ROUTES[scan_route(B, S, D, torch.float32)][:2]
    ta, tb, tg = (torch.from_numpy(x) for x in (a, b, g))
    plain = bwd(ta, fwd(ta, tb, th0), tg, th0)
    plain = plain[:2] + ((plain[2],) if with_h0 else ())
    ins = [torch.from_numpy(x).requires_grad_(True)
           for x in (a, b) + ((h0,) if with_h0 else ())]
    auto = torch.autograd.grad(linear_scan(*ins), ins, torch.from_numpy(g))
    for x, y in zip(auto, plain):
        assert torch.equal(x, y)


def _scan_inputs(B, S, D, seed):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.normal(size=(B, S, D))))).astype(np.float32)
    return (a, rng.normal(size=(B, S, D)).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32),
            rng.normal(size=(B, S, D)).astype(np.float32))


# tests/test_kernels.py::test_linear_scan's shapes and a ragged S (77 = 9
# chunks and 5 steps)
CHUNKED_SHAPES = [(1, 64, 64), (3, 300, 150), (8, 256, 128), (2, 1000, 33),
                  (2, 77, 40)]


@pytest.mark.parametrize("B,S,D", CHUNKED_SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_linear_scan_chunked_plain_matches_jax(B, S, D, bf16):
    a, b, h0, _ = _scan_inputs(B, S, D, B * S + D)
    ta, tb, th = (torch.from_numpy(x) for x in (a, b, h0))
    if bf16:
        ta, tb, th = ta.bfloat16(), tb.bfloat16(), th.bfloat16()
    f = lambda t: jnp.asarray(t.float().numpy())
    tol = 20 * (2e-2 if bf16 else 2e-5)
    for init_t, init_j in ((th, f(th)), (None, None)):
        got = linear_scan_chunked_ref(ta, tb, init_t)
        assert got.dtype == ta.dtype and got.shape == ta.shape
        want = jax.jit(jref.linear_scan_ref)(f(ta), f(tb), init_j)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                                   atol=tol, rtol=tol)
        # and within the same tolerance of the sequential plain version
        np.testing.assert_allclose(
            got.float().numpy(),
            linear_scan_ref(ta, tb, init_t).float().numpy(),
            atol=tol, rtol=tol)
    jd = jnp.bfloat16 if bf16 else jnp.float32
    pallas = jax_scan(f(ta).astype(jd), f(tb).astype(jd), f(th).astype(jd),
                      interpret=True)
    ptol = 20 * 2e-2 if bf16 else 1e-5
    np.testing.assert_allclose(
        linear_scan_chunked_ref(ta, tb, th).float().numpy(),
        np.asarray(pallas.astype(jnp.float32)), atol=ptol, rtol=ptol)


@pytest.mark.parametrize("B,S,D", [(2, 50, 7), (3, 33, 16), (2, 77, 40)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_linear_scan_chunked_bwd_plain_matches_jax_vjp(B, S, D, with_h0):
    a, b, h0, g = _scan_inputs(B, S, D, B * S * D + 1)
    args = (jnp.asarray(a), jnp.asarray(b)) + ((jnp.asarray(h0),)
                                               if with_h0 else ())
    _, vjp = jax.vjp(lambda *x: jref.linear_scan_ref(*x), *args)
    want = vjp(jnp.asarray(g))
    th0 = torch.from_numpy(h0) if with_h0 else None
    ta, tb, tg = (torch.from_numpy(x) for x in (a, b, g))
    h = linear_scan_chunked_ref(ta, tb, th0)
    da, db, dh0 = linear_scan_chunked_bwd_ref(ta, h, tg, th0)
    got = (da, db) + ((dh0,) if with_h0 else ())
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=4e-4,
                                   rtol=4e-4)


@pytest.mark.parametrize("S", list(range(1, SCAN_CHUNK + 1)))
@pytest.mark.parametrize("bf16", [False, True])
def test_linear_scan_routes_equal_within_one_chunk(S, bf16):
    """For S <= SCAN_CHUNK the chunked walk is the sequential one: equal
    bit for bit, forward and backward, with and without h0."""
    a, b, h0, g = (torch.from_numpy(x)
                   for x in _scan_inputs(3, S, 17, 100 + S))
    if bf16:
        a, b, g = a.bfloat16(), b.bfloat16(), g.bfloat16()
    for init in (h0, None):
        h = linear_scan_ref(a, b, init)
        assert torch.equal(linear_scan_chunked_ref(a, b, init), h)
        for x, y in zip(linear_scan_chunked_bwd_ref(a, h, g, init),
                        linear_scan_bwd_ref(a, h, g, init)):
            assert torch.equal(x, y)


def test_linear_scan_route_is_a_function_of_shape_and_dtype(monkeypatch):
    """The route reads the shape and dtype only: no device argument, and
    the same answer whether or not torch sees a card."""
    import inspect
    assert list(inspect.signature(scan_route).parameters) == [
        "B", "S", "D", "dtype"]
    cases = {(4, 512, 2560): "chunked", (2, 4096, 2560): "chunked",
             (64, 48, 2560): "sequential", (64, 512, 2560): "chunked",
             (4, SEQUENTIAL_MAX_STEPS, 64): "sequential",
             (4, SEQUENTIAL_MAX_STEPS + 1, 64): "chunked"}
    got = {c: scan_route(*c, torch.float32) for c in cases}
    assert got == cases
    assert {c: scan_route(*c, torch.bfloat16) for c in cases} == cases

    def no_device(*_a, **_k):
        raise AssertionError("scan_route asked about a device")
    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    monkeypatch.setattr(torch.cuda, "device_count", no_device)
    assert {c: scan_route(*c, torch.float32) for c in cases} == cases
    with pytest.raises(TypeError):
        scan_route(4, 512, 2560, torch.float64)


@pytest.mark.parametrize("B,S,D", [(2, 5, 16), (2, 40, 16), (2, 77, 40),
                                   (3, 300, 150)])
def test_linear_scan_wrapper_runs_its_route_plain_version(B, S, D):
    """On the CPU the wrapper's output and autograd gradients are the plain
    versions of the route it takes, and no launch is counted."""
    a, b, h0, g = (torch.from_numpy(x) for x in _scan_inputs(B, S, D, S))
    fwd, bwd = ROUTES[scan_route(B, S, D, torch.float32)][:2]
    before = (linear_scan.launches, linear_scan.bwd_launches,
              linear_scan.chunked_launches, linear_scan.chunked_bwd_launches)
    ins = [x.clone().requires_grad_(True) for x in (a, b, h0)]
    h = linear_scan(*ins)
    assert torch.equal(h, fwd(a, b, h0))
    auto = torch.autograd.grad(h, ins, g)
    for x, y in zip(auto, bwd(a, h.detach(), g, h0)):
        assert torch.equal(x, y)
    assert (linear_scan.launches, linear_scan.bwd_launches,
            linear_scan.chunked_launches,
            linear_scan.chunked_bwd_launches) == before


# ------------------------------------------------- ops and margin_ref ----

def _ops_inputs(op, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    if op == "attention":
        return (f(2, 4, 48, 32), f(2, 2, 48, 32), f(2, 2, 48, 32)), \
            dict(causal=True, window=16)
    if op == "linear_scan":
        return (rng.uniform(0.5, 1.0, (2, 40, 24)).astype(np.float32),
                f(2, 40, 24), f(2, 24)), {}
    if op == "entropy_scores":
        return (f(33, 10) * 3,), {}
    return (f(33, 100), rng.integers(0, 100, 33).astype(np.int32)), {}


@pytest.mark.parametrize("impl", ["auto", "ref"])
@pytest.mark.parametrize("op", ["attention", "linear_scan", "entropy_scores",
                                "streaming_xent"])
def test_ops_impl_dispatchers_match_reference_oracles(op, impl):
    """``kernels.ops``'s ``impl`` dispatchers (reference ops.py:26-49): on
    CPU tensors both ``impl="auto"`` (the wrapper, its plain version here)
    and ``impl="ref"`` match the reference's jnp oracle, at float32's 2e-5
    (20x for the scan, as its oracle test allows); any other impl
    raises."""
    from repro.kernels import ops as jops
    args, kw = _ops_inputs(op, 3)
    want = np.asarray(getattr(jops, op)(*(jnp.asarray(a) for a in args),
                                        impl="ref", **kw))
    got = getattr(ops, op)(*(torch.from_numpy(a) for a in args), impl=impl,
                           **kw)
    tol = 4e-4 if op == "linear_scan" else 2e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="impl"):
        getattr(ops, op)(*(torch.from_numpy(a) for a in args), impl="tpu",
                         **kw)


def test_margin_ref_matches_reference():
    """``kernels.ref.margin_ref`` (reference ref.py:50): top-1 minus top-2
    softmax probability, float32 and bfloat16 logits."""
    from repro_torch.kernels.ref import margin_ref
    x = np.random.default_rng(4).normal(size=(3, 17, 9)).astype(np.float32)
    for bf16 in (False, True):
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        if bf16:
            xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
        got = margin_ref(xt)
        assert got.dtype == torch.float32 and got.shape == (3, 17)
        np.testing.assert_allclose(got.numpy(), np.asarray(jref.margin_ref(
            xj)), rtol=2e-6, atol=2e-6)
