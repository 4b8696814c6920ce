"""The port's LM stack against the JAX package, on the CPU: the plain
versions of the attention and scan kernels, the layers, the RG-LRU and
attention blocks, and the model forward of a reduced recurrentgemma-2b.

Inputs are made from a seed with numpy; parameters are the reference's own
(drawn inside ``jax.threefry_partitionable(False)``) carried across with
``params_from_numpy``. Tolerances:
- the plain kernels: the reference tests' (tests/test_kernels.py), 2e-5 in
  float32 and 2e-2 in bfloat16, 20x that for the scan (the reference's
  associative scan sums in another order than the port's sequential one);
- blocks and forward against the reference run op by op (``jax.
  disable_jit``; attention ``direct``, which the reference's ``auto``
  takes at these lengths and whose rounding of p to bfloat16 before p v
  the port's plain attention shares): both round every bfloat16 op in the
  same order (the port's gelu follows jax's op order for that), so most
  outputs are equal;
  where XLA's and oneDNN's bfloat16 GEMMs sum in different orders an
  element now and then rounds the other way (a bfloat16 ulp, 2^-8
  relative) and that spreads through the later layers. Over four parameter
  seeds the forward's mean |difference| stayed below 2.5e-3 of the mean
  |output| and its max below 0.07 of it: held at 5e-3 and 0.15;
- forward against the reference jitted with its default attention (the
  encoder's path): XLA's fused RG-LRU and attention blocks give other last
  bits than op by op, so many elements of a block differ by a bfloat16 ulp
  and that compounds over the layers (measured with p kept in float32 by
  the port: mean 1.2-2.1e-2, max 0.2 of the mean |output|): held at 3e-2
  and 0.3.
"""
import dataclasses
import os
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jflash,
)
from repro.kernels.linear_scan import linear_scan as jscan  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import recurrent as jr  # noqa: E402
from repro.models.params import count_params as jcount  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.linear_scan import (  # noqa: E402
    ROUTES, linear_scan, scan_route,
)
from repro_torch.kernels.ref import (  # noqa: E402
    attention_ref, linear_scan_ref,
)
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import recurrent as tr  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    count_params, init_params, leaves, params_from_numpy, tree_map,
)
from repro_torch.models.stepfn import (  # noqa: E402
    make_decode_step, make_prefill_step,
)

RG = "recurrentgemma-2b"
BF = torch.bfloat16


def _tol(bf16):
    return 2e-2 if bf16 else 2e-5


def _pair(shape, seed, bf16=False, scale=1.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale
         ).astype(np.float32)
    j, t = jnp.asarray(x), torch.from_numpy(x)
    if bf16:
        j, t = j.astype(jnp.bfloat16), t.to(BF)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, mean_rel, max_rel):
    """mean |got - want| <= mean_rel * mean |want| and max |got - want| <=
    max_rel * mean |want|."""
    got, want = _np(got), _np(want)
    d, scale = np.abs(got - want), np.abs(want).mean()
    assert got.shape == want.shape
    assert d.mean() <= mean_rel * scale and d.max() <= max_rel * scale, \
        (d.mean() / scale, d.max() / scale)


def _configs(n_layers):
    return (dataclasses.replace(jreduced(jget_config(RG)), n_layers=n_layers),
            dataclasses.replace(reduced(get_config(RG)), n_layers=n_layers))


_PARAMS = {}


def _params(n_layers):
    """The reference's parameters of a reduced recurrentgemma-2b with
    ``n_layers`` layers, and the port's carried copy."""
    if n_layers not in _PARAMS:
        jcfg, tcfg = _configs(n_layers)
        with jax.threefry_partitionable(False):
            P = jinit(jm.model_template(jcfg), jax.random.key(n_layers))
        _PARAMS[n_layers] = (P, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, P), device="cpu"))
    return _PARAMS[n_layers]


# ----------------------------------------------------- plain kernels ----

FLASH_GRID = [
    (shape, cw, bf16)
    for shape in [(2, 4, 2, 256, 256, 64), (1, 8, 8, 384, 384, 128),
                  (2, 4, 1, 128, 512, 64), (1, 2, 2, 200, 200, 64),
                  (1, 6, 2, 256, 256, 128)]
    for cw in [(True, 0), (False, 0), (True, 96)]
    for bf16 in (False, True)
    if cw[0] or shape[3] == shape[4]]


@pytest.mark.parametrize("shape,cw,bf16", FLASH_GRID)
def test_attention_ref_matches_jax(shape, cw, bf16):
    """tests/test_kernels.py::test_flash_attention's grid, against the
    reference's oracle; the wrapper runs the plain version for CPU
    tensors and launches nothing."""
    B, Hq, Hkv, Sq, Sk, D = shape
    causal, window = cw
    qj, qt = _pair((B, Hq, Sq, D), sum(shape), bf16)
    kj, kt = _pair((B, Hkv, Sk, D), sum(shape) + 1, bf16)
    vj, vt = _pair((B, Hkv, Sk, D), sum(shape) + 2, bf16)
    want = _np(jref.attention_ref(qj, kj, vj, causal=causal, window=window))
    before = flash_attention.launches
    t = lambda x: x.transpose(1, 2)       # the wrapper takes (B, S, H, D)
    got = t(flash_attention(t(qt), t(kt), t(vt), causal=causal,
                            window=window))
    assert flash_attention.launches == before
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert torch.equal(got, attention_ref(qt, kt, vt, causal=causal,
                                          window=window))
    np.testing.assert_allclose(_np(got), want, atol=_tol(bf16),
                               rtol=_tol(bf16))


@pytest.mark.parametrize("shape,causal,window", [
    ((2, 4, 1, 128, 256, 64), True, 0),      # MQA, cross-length
    ((1, 2, 2, 200, 200, 64), True, 96),     # ragged tail, window
    ((1, 6, 2, 128, 128, 32), False, 0),     # GQA group 3, no mask
])
def test_attention_ref_matches_pallas_interpret(shape, causal, window):
    B, Hq, Hkv, Sq, Sk, D = shape
    qj, qt = _pair((B, Hq, Sq, D), 7)
    kj, kt = _pair((B, Hkv, Sk, D), 8)
    vj, vt = _pair((B, Hkv, Sk, D), 9)
    want = _np(jflash(qj, kj, vj, causal=causal, window=window,
                      interpret=True))
    got = attention_ref(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=2e-5)


def test_flash_wrapper_model_layout_on_cpu():
    """(B, S, H, D) in, (B, S, H, D) out: the plain version on the
    transposed operands."""
    _, q = _pair((2, 24, 4, 16), 1, bf16=True)
    _, k = _pair((2, 24, 2, 16), 2, bf16=True)
    _, v = _pair((2, 24, 2, 16), 3, bf16=True)
    got = flash_attention(q, k, v, causal=True, window=8)
    t = lambda x: x.transpose(1, 2)
    want = t(attention_ref(t(q), t(k), t(v), causal=True, window=8))
    assert got.shape == q.shape and torch.equal(got, want)
    with pytest.raises(TypeError):
        flash_attention(q, k.float(), v)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :1], v)


@pytest.mark.parametrize("B,S,D", [(1, 64, 64), (3, 300, 150), (8, 256, 128),
                                   (2, 1000, 33)])
@pytest.mark.parametrize("bf16", [False, True])
def test_linear_scan_ref_matches_jax(B, S, D, bf16):
    """tests/test_kernels.py::test_linear_scan's shapes at 20x its tol,
    with and without h0; the wrapper runs the plain version of its route."""
    rng = np.random.default_rng(B * S + D)
    a = (1.0 / (1.0 + np.exp(-rng.normal(size=(B, S, D))))).astype(
        np.float32)
    b = rng.normal(size=(B, S, D)).astype(np.float32)
    h0 = rng.normal(size=(B, D)).astype(np.float32)
    at, bt, ht = (torch.from_numpy(x) for x in (a, b, h0))
    if bf16:
        at, bt, ht = at.to(BF), bt.to(BF), ht.to(BF)
    f = lambda t: jnp.asarray(t.float().numpy())
    for init_t, init_j in ((ht, f(ht)), (None, None)):
        want = np.asarray(jax.jit(jref.linear_scan_ref)(f(at), f(bt),
                                                        init_j))
        before = linear_scan.launches
        got = linear_scan(at, bt, init_t)
        assert linear_scan.launches == before and got.dtype == at.dtype
        # the plain version of the route the wrapper takes for the shape
        plain = ROUTES[scan_route(B, S, D, at.dtype)][0]
        assert torch.equal(got, plain(at, bt, init_t))
        tol = 20 * _tol(bf16)
        np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,D", [(2, 300, 150), (3, 64, 33)])
def test_linear_scan_ref_matches_pallas_interpret(B, S, D):
    rng = np.random.default_rng(S)
    a = (1.0 / (1.0 + np.exp(-rng.normal(size=(B, S, D))))).astype(
        np.float32)
    b = rng.normal(size=(B, S, D)).astype(np.float32)
    h0 = rng.normal(size=(B, D)).astype(np.float32)
    want = np.asarray(jscan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                            interpret=True))
    got = linear_scan_ref(*(torch.from_numpy(x) for x in (a, b, h0)))
    # the Pallas kernel loops over time in the same order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_linear_scan_wrapper_checks_inputs():
    a = torch.zeros((2, 4, 3))
    with pytest.raises(ValueError):
        linear_scan(a, torch.zeros((2, 4, 2)))
    with pytest.raises(TypeError):
        linear_scan(a, a.double())
    with pytest.raises(ValueError):
        linear_scan(a, a, torch.zeros((3, 3)))


# ----------------------------------------------------------- layers ----

@pytest.mark.parametrize("bf16", [False, True])
def test_norm_rope_mlp_match_jax(bf16):
    jcfg, tcfg = _configs(3)
    P, tp = _params(3)
    xj, xt = _pair((2, 12, 64), 3, bf16)
    cast = (lambda p: p.astype(jnp.bfloat16)) if bf16 else (lambda p: p)
    mlp_j = jax.tree_util.tree_map(lambda a: cast(a[0]), P["groups"][0]["mlp"])
    mlp_t = tree_map(lambda a: a[0].to(xt.dtype), tp["groups"][0]["mlp"],
                     is_leaf=torch.is_tensor)
    for kind in ("rmsnorm", "layernorm"):
        p = {"scale": (1.0 + 0.1 * np.arange(64)).astype(np.float32),
             "bias": (0.01 * np.arange(64)).astype(np.float32)}
        want = jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, xj,
                             kind, 1e-6)
        got = tl.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            xt, kind, 1e-6)
        # float32 rounding of the mean and rsqrt (bfloat16: rounded away)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5,
                                   rtol=1e-6)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    qj, qt = _pair((2, 12, 4, 16), 4, bf16)
    np.testing.assert_allclose(
        _np(tl.rope(qt, torch.from_numpy(pos), 10000.0)),
        _np(jl.rope(qj, jnp.asarray(pos), 10000.0)),
        atol=1e-6 if not bf16 else 1e-2, rtol=1e-6 if not bf16 else 1e-2)
    # float32: matmul rounding; bfloat16: the GEMMs' sum order can round an
    # element the other way (one bfloat16 ulp)
    mlp_tol = 1e-2 if bf16 else 1e-5
    np.testing.assert_allclose(
        _np(tl.apply_mlp(mlp_t, xt, tcfg)), _np(jl.apply_mlp(mlp_j, xj, jcfg)),
        atol=mlp_tol, rtol=mlp_tol)


@pytest.mark.parametrize("impl", ["direct", "flash_xla"])
@pytest.mark.parametrize("window", [0, 8])
def test_attention_matches_jax_layers(impl, window):
    """The model's attention (B, S, H, D) with GQA against
    ``layers.attention``: float32 inputs agree to float32 rounding with
    either reference path; bfloat16 agrees exactly with ``direct`` (both
    round p to bfloat16 before PV) and within a bfloat16 ulp of the output
    with ``flash_xla`` (p float32)."""
    for bf16 in (False, True):
        qj, qt = _pair((2, 20, 4, 16), 11, bf16)
        kj, kt = _pair((2, 20, 2, 16), 12, bf16)
        vj, vt = _pair((2, 20, 2, 16), 13, bf16)
        pos = jnp.arange(20)
        want = _np(jl.attention(qj, kj, vj, q_pos=pos, k_pos=pos,
                                causal=True, window=window, impl=impl))
        got = tl.attention(qt, kt, vt, causal=True, window=window)
        tol = 2e-2 if bf16 and impl == "flash_xla" else (1e-2 if bf16
                                                          else 2e-6)
        np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)
        by_index = tl.attention(qt, kt, vt, q_pos=torch.arange(20),
                                k_pos=torch.arange(20), causal=True,
                                window=window)
        assert torch.equal(by_index, got)


# (B, S, Hq, Hkv, D), window, positions: by index (the flash wrapper's
# plain versions) or by value (a batch offset and empty k slots)
C11_CASES = [((2, 20, 4, 2, 16), 0, "index"), ((1, 64, 4, 1, 32), 0, "index"),
             ((2, 37, 6, 2, 16), 16, "index"), ((2, 24, 4, 1, 16), 8,
                                                "position")]


@pytest.mark.parametrize("shape,window,pos", C11_CASES)
def test_bf16_attention_rounds_p_as_reference_direct(shape, window, pos):
    """bfloat16 attention and its gradients against the reference's
    ``direct`` path (``impl="direct"``, what ``auto`` takes up to 1024
    tokens) and ``jax.vjp`` of it: p rounded to bfloat16 before p v, and
    dv = round(p)^T do. Both sum in float32 in other orders, so at most a
    rare element rounds to the other bfloat16 neighbour: o and dv held at a
    mean |difference| of 1e-4 of the mean |output| and 1% of elements
    unequal, which p kept in float32 misses (mean 1.3-2.5e-3, 34-50%
    unequal). dq and dk: by value, autograd of the same forward, as tight;
    by index the plain backward keeps dp = do v^T in float32 and takes
    delta = rowsum(do o) as the card's kernels do (the reference rounds dp
    to bfloat16 and sums p dp, which at D = 256 moves it past the kernels'
    2e-2 gate), measured 1.2-2.2e-3: held at 5e-3 and no share."""
    B, S, Hq, Hkv, D = shape
    rng = np.random.default_rng(sum(shape) + window)
    arrs = [rng.normal(size=s_).astype(np.float32)
            for s_ in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                       (B, S, Hq, D))]
    js = [jnp.asarray(x).astype(jnp.bfloat16) for x in arrs]
    ts = [torch.from_numpy(x).to(BF) for x in arrs]
    if pos == "index":
        qp = kp = np.arange(S, dtype=np.int32)
    else:
        qp = np.stack([np.arange(S) + 3, np.arange(S)]).astype(np.int32)[:B]
        kp = np.stack([np.arange(S), np.where(np.arange(S) < S - 5,
                                              np.arange(S), -1)]
                      ).astype(np.int32)[:B]
    _, vjp = jax.vjp(lambda q, k, v: jl.attention(
        q, k, v, q_pos=jnp.asarray(qp), k_pos=jnp.asarray(kp), causal=True,
        window=window, impl="direct"), *js[:3])
    want = [jl.attention(*js[:3], q_pos=jnp.asarray(qp),
                         k_pos=jnp.asarray(kp), causal=True, window=window,
                         impl="direct")] + list(vjp(js[3]))
    q, k, v = (x.clone().requires_grad_(True) for x in ts[:3])
    o = tl.attention(q, k, v, q_pos=torch.from_numpy(qp),
                     k_pos=torch.from_numpy(kp), causal=True, window=window,
                     impl="auto" if pos == "index" else "direct")
    got = [o.detach()] + list(torch.autograd.grad(o, (q, k, v), ts[3]))
    for name, x, y in zip(("o", "dq", "dk", "dv"), got, want):
        assert x.dtype == BF and tuple(x.shape) == tuple(y.shape), name
        d, scale = np.abs(_np(x) - _np(y)), np.abs(_np(y)).mean()
        mean_rel, share = ((5e-3, 1.0) if pos == "index" and name in ("dq",
                                                                     "dk")
                           else (1e-4, 1e-2))
        assert d.mean() <= mean_rel * scale and (d > 0).mean() <= share, \
            (name, d.mean() / scale, (d > 0).mean())


def test_attention_masks_by_position_on_cpu():
    """Positions other than the index (a batch offset, empty k slots
    marked -1) are masked by value with ``impl="direct"``, as
    ``_scores_mask``; ``impl="auto"`` (the kernel's route) refuses them."""
    qj, qt = _pair((2, 6, 4, 16), 21)
    kj, kt = _pair((2, 9, 1, 16), 22)
    vj, vt = _pair((2, 9, 1, 16), 23)
    q_pos = np.array([[3, 4, 5, 6, 7, 8], [0, 1, 2, 3, 4, 5]], np.int32)
    k_pos = np.array([[0, 1, 2, 3, 4, 5, 6, 7, 8],
                      [0, 1, 2, 3, 4, 5, -1, -1, -1]], np.int32)
    for window in (0, 4):
        want = jl.attention(qj, kj, vj, q_pos=jnp.asarray(q_pos),
                            k_pos=jnp.asarray(k_pos), causal=True,
                            window=window, impl="direct")
        got = tl.attention(qt, kt, vt, q_pos=torch.from_numpy(q_pos),
                           k_pos=torch.from_numpy(k_pos), causal=True,
                           window=window, impl="direct")
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-6, rtol=2e-6)
        with pytest.raises(ValueError, match="masks by index"):
            tl.attention(qt, kt, vt, q_pos=torch.from_numpy(q_pos),
                         k_pos=torch.from_numpy(k_pos), causal=True,
                         window=window)


# ----------------------------------------------------------- blocks ----

def _bf16_block(P, tp, idx):
    pj = jax.tree_util.tree_map(lambda a: a[0].astype(jnp.bfloat16),
                                P["groups"][idx])
    pt = tree_map(lambda a: a[0].to(BF), tp["groups"][idx],
                  is_leaf=torch.is_tensor)
    return pj, pt


def test_rglru_and_attn_blocks_equal_reference_op_by_op():
    """The RG-LRU and attention blocks of a reduced recurrentgemma-2b on
    bfloat16 parameters, against the reference run op by op (equal but for
    the odd element a bfloat16 GEMM rounds the other way)."""
    jcfg, tcfg = _configs(3)
    P, tp = _params(3)
    # the forward test's activation shape, so the eager reference reuses
    # its compiled ops
    xj, xt = _pair((4, 16, 64), 31, bf16=True)
    ctx = {"mode": "train", "attn_impl": "direct",
           "positions": jnp.broadcast_to(jnp.arange(16)[None], (4, 16))}
    with jax.disable_jit():
        p0, t0 = _bf16_block(P, tp, 0)
        st = jr.rglru_init_state(jcfg, 4)
        y, new = jr.apply_rglru(p0["rglru"], xj, st, jcfg)
        yt, newt = tr.apply_rglru(t0["rglru"], xt,
                                  tr.rglru_init_state(tcfg, 4, dtype=BF,
                                                     device="cpu"),
                                  tcfg)
        _close(yt, y, 5e-3, 0.15)
        _close(newt["h"], new["h"], 5e-3, 0.15)
        _close(newt["conv"], new["conv"], 5e-3, 0.15)
        for idx, kind in ((0, "rglru"), (2, "attn")):
            pj, pt = _bf16_block(P, tp, idx)
            want = jm.apply_block(pj, kind, xj, None, jcfg, ctx)[0]
            got = tm.apply_block(pt, kind, xt, None, tcfg,
                                 {"mode": "train"})[0]
            _close(got, want, 5e-3, 0.15)


def test_causal_conv_and_gelu_equal_reference():
    u_j, u_t = _pair((2, 10, 64), 41, bf16=True)
    w_j, w_t = _pair((4, 64), 42, bf16=True, scale=0.5)
    b_j, b_t = _pair((64,), 43, bf16=True)
    prev_j, prev_t = _pair((2, 3, 64), 44, bf16=True)
    with jax.disable_jit():
        out, st = jr._causal_conv(u_j, w_j, b_j, prev_j)
        g = jax.nn.gelu(u_j * 3)
    out_t, st_t = tr._causal_conv(u_t, w_t, b_t, prev_t)
    np.testing.assert_array_equal(_np(out_t), _np(out))
    np.testing.assert_array_equal(_np(st_t), _np(st))
    np.testing.assert_array_equal(_np(tl.gelu_tanh(u_t * 3)), _np(g))


# ---------------------------------------------------------- forward ----

@pytest.mark.parametrize("n_layers", [3, 5])
@pytest.mark.parametrize("logits_mode", ["hidden", "all"])
def test_forward_matches_reference(n_layers, logits_mode):
    """Reduced recurrentgemma-2b, 3 layers (one group) and 5 (one group
    and a 2-layer tail), window 8 at 16 tokens, against the reference run
    op by op with direct attention and jitted with its default path, at
    the tolerances stated above."""
    jcfg, tcfg = _configs(n_layers)
    P, tp = _params(n_layers)
    toks = np.random.default_rng(n_layers).integers(
        0, 256, (4, 16)).astype(np.int32)
    got = tm.forward(tp, tcfg, torch.from_numpy(toks),
                     logits_mode=logits_mode)[0].numpy()
    with jax.disable_jit():
        eager = np.asarray(jm.forward(P, jcfg, jnp.asarray(toks),
                                      logits_mode=logits_mode,
                                      attn_impl="direct")[0])
    _close(got, eager, 5e-3, 0.15)
    jitted = np.asarray(jax.jit(lambda p, t: jm.forward(
        p, jcfg, t, logits_mode=logits_mode)[0])(P, jnp.asarray(toks)))
    _close(got, jitted, 3e-2, 0.3)
    assert got.shape == ((4, 16, 64) if logits_mode == "hidden"
                         else (4, 16, 256))


def test_forward_last_logits_and_unported_kinds():
    """Last-position logits; prefill + decode and the MoE and
    encoder-decoder templates, which raised before they were ported, now
    run (their parity with the reference is in tests/test_torch_decode.py
    and tests/test_torch_moe_xattn.py)."""
    jcfg, tcfg = _configs(3)
    _, tp = _params(3)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 8)).astype(np.int32))
    last = tm.forward(tp, tcfg, toks, logits_mode="last")[0]
    full, cache, aux = tm.forward(tp, tcfg, toks, logits_mode="all")
    assert last.shape == (2, 1, 256)
    assert torch.equal(last[:, 0], full[:, -1])
    assert cache is None and float(aux) == 0.0
    with pytest.raises(ValueError, match="positions"):
        tm.forward(tp, tcfg, toks, mode="decode")
    lg, cache = make_prefill_step(tcfg)(tp, {"tokens": toks[:, :7]})
    assert torch.equal(lg, tm.forward(tp, tcfg, toks[:, :7])[0][:, -1])
    ld, _ = make_decode_step(tcfg)(tp, cache, toks[:, 7:],
                                   torch.full((2,), 7))
    _close(ld, full[:, 7], 5e-3, 0.15)
    g = tm.model_template(reduced(get_config("granite-moe-3b-a800m")))
    assert g["groups"][0]["moe"]["w_gate"].shape == (2, 4, 64, 128)
    w = tm.model_template(reduced(get_config("whisper-base")))
    assert w["encoder"][0]["attn"]["wq"].shape == (2, 64, 64)
    assert "xattn" in w["groups"][0] and "enc_norm" in w


# ----------------------------------------------------------- params ----

def test_templates_and_counts_match_reference():
    """Same tree (paths, shapes, init kinds) as the reference's template,
    the full-width recurrentgemma-2b included (2.89 B parameters; nothing
    is allocated)."""
    for full in (False, True):
        jc = jget_config(RG) if full else jreduced(jget_config(RG))
        tc = get_config(RG) if full else reduced(get_config(RG))
        jt, tt = jm.model_template(jc), tm.model_template(tc)
        jleaves = jax.tree_util.tree_leaves_with_path(
            jt, is_leaf=lambda x: type(x).__name__ == "PSpec")
        tleaves = leaves(tt)
        assert [(tuple(p.shape), p.init) for _, p in jleaves] == \
            [(tuple(p.shape), p.init) for p in tleaves]
        assert count_params(tt) == jcount(jt)
    assert count_params(tm.model_template(get_config(RG))) == 2_894_574_080
    g, n, rem = get_config(RG).layer_groups()
    assert (g, n, rem) == (("rglru", "rglru", "attn"), 8, ("rglru", "rglru"))


def test_init_params_distributions_and_carry():
    _, tcfg = _configs(5)
    t1 = init_params(tm.model_template(tcfg), torch.Generator().manual_seed(3),
                     device="cpu")
    t2 = init_params(tm.model_template(tcfg), torch.Generator().manual_seed(3),
                     device="cpu")
    for a, b in zip(leaves(t1, torch.is_tensor), leaves(t2, torch.is_tensor)):
        assert torch.equal(a, b) and a.dtype == torch.float32
    assert abs(float(t1["embed"].std()) - 0.02) < 2e-3
    w = t1["groups"][0]["mlp"]["w_up"]                     # (1, 64, 128)
    assert abs(float(w.std()) - 64 ** -0.5) < 0.02
    lam = t1["groups"][0]["rglru"]["lam"]
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    assert bool((t1["tail"][0]["rglru"]["conv_b"] == 0).all())
    assert len(t1["tail"]) == 2
    with pytest.raises(ValueError):
        init_params(tm.model_template(tcfg),
                    types.SimpleNamespace(device=torch.device("cuda")))
    P, tp = _params(5)
    assert tp["groups"][0]["rglru"]["w_i"].shape == (1, 64, 64)
    np.testing.assert_array_equal(tp["tail"][1]["mlp"]["w_up"].numpy(),
                                  np.asarray(P["tail"][1]["mlp"]["w_up"]))
