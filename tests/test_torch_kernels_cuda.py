"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and skips itself when torch sees none;
run them on the card with ``PYTHONPATH=src python -m pytest -q
--noconftest -m cuda tests/test_torch_kernels_cuda.py`` (the repo's
``tests/conftest.py`` imports JAX). They import torch and the port only, so
they run where JAX is not installed. The CPU parity of the plain versions
with the JAX package is in ``tests/test_torch_kernels.py``.
"""
import math

import numpy as np
import pytest
import torch

import repro_torch.kernels.flash_attention as kflash
import repro_torch.kernels.linear_scan as kscan
from repro_torch.kernels.ds_estep import ds_estep, estep_route, task_plan
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.linear_scan import linear_scan
from repro_torch.kernels.ordered_sum import ordered_matmul, segment_sum
from repro_torch.kernels.ref import (
    attention_bwd_ref, attention_ref, ds_estep_ref, entropy_ref,
    linear_scan_ref, ordered_matmul_ref, segment_sum_ref, xent_bwd_ref,
    xent_ref,
)
from repro_torch.learning import linear
from repro_torch.kernels.uncertainty import entropy_scores
from repro_torch.kernels.xent import streaming_xent


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch reports no CUDA device")
    return torch.device("cuda")


def _inputs(B, W, C, T, V, seed, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    R = W * C + 1
    lead = () if B is None else (B,)
    rows = torch.log(torch.rand(lead + (R, C), generator=g, device=dev) * 0.9
                     + 0.05)
    rows[..., R - 1, :] = 0.0
    idx = torch.randint(0, R, lead + (T, V), generator=g, device=dev,
                        dtype=torch.int32)
    return rows.contiguous(), idx.contiguous()


# (B, W, C, T, V, atol logp, atol post): the reference test's shapes and
# tolerances, class counts above one warp and not a power of two, T not a
# tile multiple, the stream refresh's batched shape, and the offline EM's
# shapes on the shared-memory (C=4) and global (C=8) paths
SHAPES = [
    (None, 9, 4, 77, 5, 1e-4, 1e-5),
    (None, 16, 8, 512, 5, 1e-3, 1e-4),
    (None, 5, 33, 301, 4, 1e-4, 1e-5),
    (3, 4, 130, 77, 3, 1e-4, 1e-5),
    (512, 9, 2, 32, 5, 1e-4, 1e-5),
    (None, 1024, 4, 1 << 20, 5, 1e-4, 1e-5),
    (None, 1024, 8, 1 << 20, 5, 1e-4, 1e-5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,C,T,V,atol_lp,atol_p", SHAPES)
def test_ds_estep_kernel_matches_plain(B, W, C, T, V, atol_lp, atol_p):
    dev = _card()
    rows, idx = _inputs(B, W, C, T, V, seed=W * C + T, dev=dev)
    idx[..., 0, :] = W * C                      # a zero-vote task
    before = ds_estep.launches
    lp, p = ds_estep(rows, idx)
    torch.cuda.synchronize()
    assert ds_estep.launches == before + 1
    lr, pr = ds_estep_ref(rows, idx)
    assert lp.shape == lr.shape and p.shape == pr.shape
    assert (lp - lr).abs().max().item() <= atol_lp
    assert (p - pr).abs().max().item() <= atol_p
    assert bool((p[..., 0, :] == 1.0 / C).all())
    assert bool((lp[..., 0, :] == -math.log(C)).all()) or \
        (lp[..., 0, :] + math.log(C)).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_ds_estep_wrapper_rejects_bad_inputs():
    dev = _card()
    rows, idx = _inputs(None, 4, 3, 10, 2, seed=1, dev=dev)
    with pytest.raises(TypeError):
        ds_estep(rows.double(), idx)
    with pytest.raises(TypeError):
        ds_estep(rows, idx.long())
    with pytest.raises(ValueError):
        ds_estep(rows, idx.t())
    with pytest.raises(ValueError):
        ds_estep(rows, idx.cpu())


# (B, W, C, T, V): the task route's grid of class and vote counts, each in
# block mode (one table, a ragged T) and in warp mode (many small tables),
# the offline shapes (the table in shared memory at C = 4, too large for it
# at C = 8) and the refresh's
TASK_SHAPES = (
    [(None, 37, C, 3001, V) for C in (2, 3, 4, 5, 8) for V in (1, 3, 5, 7)]
    + [(7, 5, C, 45, V) for C in (2, 3, 4, 5, 8) for V in (1, 3, 5, 7)]
    + [(None, 1024, 4, 1 << 20, 5), (None, 1024, 8, 1 << 20, 5),
       (512, 9, 2, 32, 5), (3, 300, 6, 70000, 5)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,C,T,V", TASK_SHAPES)
@pytest.mark.parametrize("route", ["task", "group"])
def test_ds_estep_routes_match_plain(route, B, W, C, T, V):
    """Both routes at C <= 8: logp equal to the plain version bit for bit,
    post within the reference test's 1e-5, a zero-vote task exactly
    uniform, a second call equal bit for bit, one launch counted (a task
    launch on the task route only)."""
    dev = _card()
    rows, idx = _inputs(B, W, C, T, V, seed=W * C + T + V, dev=dev)
    idx[..., 1, :] = W * C                      # a zero-vote task
    assert estep_route(1 if B is None else B, W * C + 1, C, T, V) == "task"
    before = (ds_estep.launches, ds_estep.task_launches)
    lp, p = ds_estep(rows, idx, _route=route)
    torch.cuda.synchronize()
    assert (ds_estep.launches, ds_estep.task_launches) == (
        before[0] + 1, before[1] + (route == "task"))
    lr, pr = ds_estep_ref(rows, idx)
    assert torch.equal(lp, lr)
    assert (p - pr).abs().max().item() <= 1e-5
    assert bool((p[..., 1, :] == 1.0 / C).all())
    lp2, p2 = ds_estep(rows, idx, _route=route)
    assert torch.equal(lp, lp2) and torch.equal(p, p2)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [4, 8])
def test_ds_estep_task_placements_match_plain(C):
    """The task route's placement of a table too large for one block's
    shared memory (W = 1024 at C = 8; W = 4096 at C = 4): its first rows
    there and the rest in L2; and an idx base off the 16-byte grid."""
    dev = _card()
    W = 1024 if C == 8 else 4096
    rows, idx = _inputs(None, W, C, 20001, 5, seed=C, dev=dev)
    plan = task_plan(1, W * C + 1, C, 20001, 5)
    assert plan is not None and plan[0] == "l2" and 0 < plan[1] < W * C + 1
    lp, p = ds_estep(rows, idx)
    lr, pr = ds_estep_ref(rows, idx)
    assert torch.equal(lp, lr) and (p - pr).abs().max().item() <= 1e-5
    buf = torch.empty(idx.numel() + 1, dtype=torch.int32, device=dev)
    off = buf[1:].view(idx.shape)
    off.copy_(idx)
    assert off.data_ptr() % 16 != 0
    lo, po = ds_estep(rows, off)
    assert torch.equal(lo, lr) and torch.equal(po, p)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(None, 3001), (7, 45)])
def test_ds_estep_task_unaligned_and_out_of_range(B, T):
    """Block and warp mode: an idx base one element into its storage gives
    the same bits; indices outside [0, R) read as the null row."""
    dev = _card()
    rows, idx = _inputs(B, 9, 4, T, 5, seed=T, dev=dev)
    want = ds_estep(rows, idx)
    buf = torch.empty(idx.numel() + 1, dtype=torch.int32, device=dev)
    off = buf[1:].view(idx.shape)
    off.copy_(idx)
    got = ds_estep(rows, off)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    bad = idx.clone()
    bad[..., 2, 0] = -3
    bad[..., 3, 1] = 9 * 4 + 1
    null = idx.clone()
    null[..., 2, 0] = 9 * 4
    null[..., 3, 1] = 9 * 4
    lb, pb = ds_estep(rows, bad)
    ln, pn = ds_estep_ref(rows, null)
    assert torch.equal(lb, ln) and (pb - pn).abs().max().item() <= 1e-5


# V up to the narrow route's 64 (the rows kernel to 16, entropy_narrow
# above), ragged N, both dtypes
NARROW_GRID = [(N, V, dt) for V in (1, 2, 3, 10, 16, 17, 33, 48, 64)
               for N in (1, 31, 1000, 70001)
               for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,V,dtype", NARROW_GRID)
def test_entropy_narrow_matches_v1_and_plain(N, V, dtype):
    """The narrow route's kernels give the old narrow kernel's bits, and
    hold to the plain version (1e-4 in float32, 2e-2 in bfloat16, as
    tests/test_learning.py), on an aligned and on an unaligned base."""
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(N + V)
    buf = (torch.randn((N * V + 1,), generator=g, device=dev) * 3).to(dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for x in (buf[:-1].view(N, V), buf[1:].view(N, V)):
        before = entropy_scores.launches
        h = entropy_scores(x)
        assert entropy_scores.launches == before + 1
        old = entropy_scores(x, _route="narrow_v1")
        torch.cuda.synchronize()
        assert torch.equal(h, old)
        torch.testing.assert_close(h, entropy_ref(x), atol=tol, rtol=tol)


# (N, V, dtype, atol, rtol): the learner widths of tests/test_kernels.py
# (atol max(tol, 1e-4) * 10, rtol 1e-2), the odd shapes of
# tests/test_learning.py (1e-4 in float32, 2e-2 in bfloat16; none is a
# multiple of a tile or of a 16-byte vector), the LM vocab, and the
# learning path's (replications x points, classes) shapes
ENTROPY_SHAPES = (
    [(N, C, dt, (2e-1 if dt == torch.bfloat16 else 1e-3), 1e-2)
     for N, C in ((256, 2), (384, 10), (512, 64), (777, 17), (1024, 48))
     for dt in (torch.float32, torch.bfloat16)]
    + [(N, V, dt, (2e-2 if dt == torch.bfloat16 else 1e-4),
        (2e-2 if dt == torch.bfloat16 else 1e-4))
       for N, V in ((1, 3), (33, 777), (129, 513))
       for dt in (torch.float32, torch.bfloat16)]
    + [(N, 50304, dt, (2e-1 if dt == torch.bfloat16 else 1e-3), 1e-2)
       for N in (64, 512) for dt in (torch.float32, torch.bfloat16)]
    + [(64 * 3000, 10, torch.float32, 1e-4, 1e-4),
       (64 * 1500, 2, torch.float32, 1e-4, 1e-4)])


@pytest.mark.cuda
@pytest.mark.parametrize("N,V,dtype,atol,rtol", ENTROPY_SHAPES)
def test_entropy_kernel_matches_plain(N, V, dtype, atol, rtol):
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(N * V)
    x = (torch.randn((N, V), generator=g, device=dev) * 3).to(dtype)
    before = entropy_scores.launches
    h = entropy_scores(x)
    torch.cuda.synchronize()
    assert entropy_scores.launches == before + 1
    want = entropy_ref(x)
    assert h.dtype == torch.float32 and h.shape == (N,)
    torch.testing.assert_close(h, want, atol=atol, rtol=rtol)
    assert bool((h >= 0).all()) and bool((h <= math.log(V) + 1e-3).all())
    assert torch.equal(h, entropy_scores(x))          # repeatable


@pytest.mark.cuda
@pytest.mark.parametrize("V", [7, 130, 50304])
def test_entropy_kernel_unaligned_rows_and_leading_dims(V):
    """A base address off the 16-byte grid (a contiguous view one element
    into its storage) and leading dims flattened to rows."""
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(V)
    buf = torch.randn((2 * 3 * V + 1,), generator=g, device=dev) * 4
    x = buf[1:].view(2, 3, V)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    h = entropy_scores(x)
    assert h.shape == (2, 3)
    torch.testing.assert_close(h, entropy_ref(x), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_entropy_wrapper_rejects_bad_inputs():
    dev = _card()
    x = torch.randn((8, 5), device=dev)
    with pytest.raises(TypeError):
        entropy_scores(x.double())
    with pytest.raises(ValueError):
        entropy_scores(x.t())
    assert entropy_scores(x[:0]).shape == (0,)


def _tol(dtype):
    """tests/test_kernels.py's tolerance: 2e-2 in bfloat16 (the output is
    rounded to bfloat16 by both), 2e-5 in float32 (the kernel sums q.k and
    p v in another order than the plain version's matmuls)."""
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def _randn(shape, seed, dev, dtype=torch.float32):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


# (B, Hq, Hkv, Sq, Sk, D) x (causal, window) x dtype: the grid of
# tests/test_kernels.py::test_flash_attention (MQA and cross-length, a
# ragged 200, GQA group 3; non-causal only at Sq == Sk)
FLASH_GRID = [
    (shape, cw, dt)
    for shape in [(2, 4, 2, 256, 256, 64), (1, 8, 8, 384, 384, 128),
                  (2, 4, 1, 128, 512, 64), (1, 2, 2, 200, 200, 64),
                  (1, 6, 2, 256, 256, 128)]
    for cw in [(True, 0), (False, 0), (True, 96)]
    for dt in (torch.float32, torch.bfloat16)
    if cw[0] or shape[3] == shape[4]]


def _check_flash(B, Hq, Hkv, Sq, Sk, D, causal, window, dtype, seed,
                 heads_first=True, atol=None):
    """The wrapper takes (B, S, H, D). ``heads_first``: the operands are
    made (B, H, S, D), as the reference's grid is, and passed as their
    ``transpose(1, 2)`` views (read by stride); else made (B, S, H, D)."""
    dev = _card()
    t = lambda x: x.transpose(1, 2)
    if heads_first:
        mk = lambda shape, sd: t(_randn(shape, sd, dev, dtype))
        shapes = ((B, Hq, Sq, D), (B, Hkv, Sk, D))
    else:
        mk = lambda shape, sd: _randn(shape, sd, dev, dtype)
        shapes = ((B, Sq, Hq, D), (B, Sk, Hkv, D))
    q = mk(shapes[0], seed)
    k = mk(shapes[1], seed + 1)
    v = mk(shapes[1], seed + 2)
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert o.shape == q.shape and o.dtype == dtype
    want = t(attention_ref(t(q), t(k), t(v), causal=causal, window=window))
    tol = _tol(dtype) if atol is None else atol
    torch.testing.assert_close(o.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(o, flash_attention(q, k, v, causal=causal,
                                          window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cw,dtype", FLASH_GRID)
def test_flash_attention_kernel_matches_plain(shape, cw, dtype):
    _check_flash(*shape, *cw, dtype, seed=sum(shape))


# the model's shapes in its (B, S, H, D) layout: the encoder's full-width
# micro-batch (64 tasks x 48 tokens, 10 q heads over 1 kv head, D = 256,
# window 2048), recurrentgemma-2b's window binding at length 4096, the
# training shape (4 x 512 tokens), a head dim that is not a multiple of 16
# with ragged lengths, and one that is not a multiple of 8 over an odd head
# count, so rows are not 16-byte aligned (the bf16 kernel's element-wise
# staging)
@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,D,window", [
    (64, 10, 1, 48, 256, 2048),
    (1, 10, 1, 4096, 256, 2048),
    (4, 10, 1, 512, 256, 2048),
    (2, 4, 2, 77, 80, 0),
    (1, 3, 1, 100, 60, 0),
])
def test_flash_attention_kernel_model_layout(B, Hq, Hkv, S, D, window):
    _check_flash(B, Hq, Hkv, S, S, D, True, window, torch.bfloat16,
                 seed=S + D, heads_first=False)


# the shapes the rest of the LM stack gives the kernel, (B, S, H, D)
# layout: whisper-base's encoder (non-causal over 1500 frames), its
# cross-attention at prefill and decode (Sq != Sk, Sk = 1500 not a multiple
# of 64), llama-3.2-vision-11b's cross-attention over 1600 image tokens
# (GQA 32/8, D = 128), granite-moe-3b-a800m's causal self-attention (GQA
# 24/8, D = 64), and GQA 24/8 and 32/8 at ragged lengths without a mask
@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal", [
    (2, 8, 8, 1500, 1500, 64, False),
    (4, 8, 8, 48, 1500, 64, False),
    (4, 8, 8, 1, 1500, 64, False),
    (2, 32, 8, 48, 1600, 128, False),
    (4, 32, 8, 1, 1600, 128, False),
    (4, 24, 8, 48, 48, 64, True),
    (2, 24, 8, 37, 1500, 64, False),
    (1, 32, 8, 130, 130, 128, False),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_cross_and_encoder_shapes(B, Hq, Hkv, Sq, Sk,
                                                         D, causal, dtype):
    _check_flash(B, Hq, Hkv, Sq, Sk, D, causal, 0, dtype,
                 seed=Sq + Sk + D, heads_first=False)


@pytest.mark.cuda
def test_flash_attention_wrapper_rejects_bad_inputs():
    dev = _card()
    q = _randn((1, 2, 8, 16), 0, dev)        # (B, S, H, D)
    with pytest.raises(TypeError):
        flash_attention(q, q.double(), q)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :1].transpose(2, 3), q[:, :1].transpose(2, 3))
    with pytest.raises(ValueError):
        big = _randn((1, 1, 4, 288), 1, dev)
        flash_attention(big, big, big)
    with pytest.raises(ValueError):
        flash_attention(q, _randn((1, 3, 3, 16), 2, dev),   # 8 % 3 heads
                        _randn((1, 3, 3, 16), 3, dev))


# (B, S, D) of tests/test_kernels.py::test_linear_scan (tolerance 20x its
# tol, for its associative scan), the encoder's rglru shape with h0 and a
# long sequence at the model's width
SCAN_SHAPES = [(1, 64, 64), (3, 300, 150), (8, 256, 128), (2, 1000, 33),
               (64, 48, 2560), (2, 4096, 2560)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_scan_kernel_matches_plain(B, S, D, dtype):
    dev = _card()
    a = torch.sigmoid(_randn((B, S, D), B * S, dev)).to(dtype)
    b = _randn((B, S, D), B * S + 1, dev, dtype)
    h0 = _randn((B, D), B * S + 2, dev, dtype)
    for init in (h0, None):
        before = linear_scan.launches
        h = linear_scan(a, b, init)
        torch.cuda.synchronize()
        assert linear_scan.launches == before + 1
        want = linear_scan_ref(a, b, init)
        assert h.dtype == dtype and h.shape == (B, S, D)
        tol = 20 * _tol(dtype)
        torch.testing.assert_close(h.float(), want.float(), atol=tol,
                                   rtol=tol)
        # one rounded multiply and one rounded add per step, in the same
        # order as the plain version of the route the wrapper takes: equal
        # bit for bit by design
        route = kscan.scan_route(B, S, D, dtype)
        assert torch.equal(h, kscan.ROUTES[route][0](a, b, init))


@pytest.mark.cuda
def test_linear_scan_wrapper_rejects_bad_inputs():
    dev = _card()
    a = _randn((2, 8, 4), 0, dev)
    with pytest.raises(TypeError):
        linear_scan(a, a.double())
    with pytest.raises(ValueError):
        linear_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError):
        linear_scan(a, a, _randn((3, 4), 1, dev))


# (N, V): tests/test_kernels.py::test_streaming_xent's shapes (logits x 3),
# a row not a multiple of the 16-byte vector with an odd base, and the
# training shape's width. Loss and lse: both read the same values and sum
# in float32 in other orders (2e-4 absolute, 1e-5 relative); dlogits: the
# kernel's exp differs from torch's in the last bits (1e-6 absolute) and a
# bfloat16 result can round to the other neighbour (one ulp, 2^-8).
XENT_SHAPES = [(10, 100), (64, 50304), (33, 777), (5, 1001), (16, 256000)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,V", XENT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streaming_xent_kernels_match_plain(N, V, dtype):
    dev = _card()
    x = (_randn((N, V), N * V, dev) * 3).to(dtype)
    g = torch.Generator(device=dev)
    g.manual_seed(N + V)
    t = torch.randint(0, V, (N,), generator=g, device=dev)
    t[0] = V - 1
    gout = _randn((N,), N, dev)
    gout[-1] = 0.0                           # an ignored row
    xr = x.detach().requires_grad_(True)
    before = (streaming_xent.launches, streaming_xent.bwd_launches)
    loss = streaming_xent(xr, t)
    assert loss.grad_fn is not None
    (dx,) = torch.autograd.grad(loss, xr, gout)
    torch.cuda.synchronize()
    assert (streaming_xent.launches, streaming_xent.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert loss.dtype == torch.float32 and dx.dtype == dtype
    torch.testing.assert_close(loss, xent_ref(x, t), atol=2e-4, rtol=1e-5)
    lse = torch.logsumexp(x.float(), -1)
    want = xent_bwd_ref(x, t, lse, gout)
    rtol = 8e-3 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(dx.float(), want.float(), atol=1e-6,
                               rtol=rtol)
    assert bool((dx[-1] == 0).all())
    assert torch.equal(loss, streaming_xent(x, t))


@pytest.mark.cuda
def test_streaming_xent_unaligned_and_rejects():
    dev = _card()
    buf = _randn((3 * 777 + 1,), 5, dev)
    x = buf[1:].view(3, 777)                 # base off the 16-byte grid
    t = torch.tensor([0, 776, 100], device=dev)
    torch.testing.assert_close(streaming_xent(x, t), xent_ref(x, t),
                               atol=2e-4, rtol=1e-5)
    with pytest.raises(ValueError):
        streaming_xent(_randn((4, 8), 1, dev).t(), t[:1].expand(8))
    with pytest.raises(TypeError):
        streaming_xent(_randn((4, 8), 1, dev).double(), t[:1].expand(4))
    with pytest.raises(TypeError):
        streaming_xent(_randn((4, 8), 1, dev), t[:1].expand(4).float())


def _bwd_tol(dtype):
    """The backward against attention_bwd_ref: in bfloat16 the reference
    tests' 2e-2 (both round dq, dk, dv to bfloat16 from float32 sums); in
    float32 5x the forward's 2e-5, since dk and dv sum G * Sq terms and ds
    cancels p (dp - delta)."""
    return 2e-2 if dtype == torch.bfloat16 else 1e-4


def _check_flash_bwd(B, Hq, Hkv, Sq, Sk, D, causal, window, dtype, seed):
    dev = _card()
    q = _randn((B, Sq, Hq, D), seed, dev, dtype).requires_grad_(True)
    k = _randn((B, Sk, Hkv, D), seed + 1, dev, dtype).requires_grad_(True)
    v = _randn((B, Sk, Hkv, D), seed + 2, dev, dtype).requires_grad_(True)
    do = _randn((B, Sq, Hq, D), seed + 3, dev, dtype)
    before = (flash_attention.launches, flash_attention.bwd_launches)
    o = flash_attention(q, k, v, causal=causal, window=window)
    assert o.grad_fn is not None
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    t = lambda x: x.transpose(1, 2)
    want = attention_bwd_ref(t(q.detach()), t(k.detach()), t(v.detach()),
                             t(o.detach()), t(do), causal=causal,
                             window=window)
    tol = _bwd_tol(dtype)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == t(w).shape
        torch.testing.assert_close(got.float(), t(w).float(), atol=tol,
                                   rtol=tol)
    again = torch.autograd.grad(
        flash_attention(q, k, v, causal=causal, window=window), (q, k, v),
        do)
    assert all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again))


# the forward's grid in (B, S, H, D) (causal, full and window), the
# training shape (4 x 512 tokens, 10 q heads over 1 kv head of 256,
# recurrentgemma's window binding only past 2048), a length that is not a
# tile multiple, a ragged head dim with a short window, unaligned rows
# (head dim 60 over 3 heads), and GQA groups of 5 that the bf16 dk/dv
# kernel splits into 2 and 3 heads, at a length that is not a multiple of
# 64 (3 x 2 kv heads x 11 k tiles = 66 blocks a group)
FLASH_BWD = [
    (shape, cw, dt)
    for shape in [(2, 4, 2, 256, 256, 64), (2, 4, 1, 128, 512, 64),
                  (1, 2, 2, 200, 200, 64), (1, 6, 2, 256, 256, 128)]
    for cw in [(True, 0), (False, 0), (True, 96)]
    for dt in (torch.float32, torch.bfloat16)
    if cw[0] or shape[3] == shape[4]] + [
    ((4, 10, 1, 512, 512, 256), (True, 2048), torch.bfloat16),
    ((2, 4, 2, 77, 77, 80), (True, 0), torch.bfloat16),
    ((1, 10, 1, 300, 300, 256), (True, 64), torch.float32),
    ((1, 3, 1, 100, 100, 60), (True, 0), torch.bfloat16),
    ((3, 10, 2, 700, 700, 64), (True, 0), torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cw,dtype", FLASH_BWD)
def test_flash_attention_backward_matches_plain(shape, cw, dtype):
    _check_flash_bwd(*shape, *cw, dtype, seed=sum(shape) + 7)


@pytest.mark.cuda
def test_flash_attention_backward_head_split():
    """The bf16 dk/dv kernel splits a kv head's G query heads into groups
    so that its grid holds a block per SM; the wrapper sizes the float32
    partials by the kernel's rule (none for one group or float32)."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = kflash._launcher("scratch")
    for B, Hq, Hkv, Sk, D in [(4, 10, 1, 512, 256), (3, 10, 2, 700, 64),
                              (1, 8, 8, 384, 128), (2, 4, 2, 77, 80)]:
        base = B * Hkv * -(-Sk // 64)
        ns = 1 if base >= sms else min(Hq // Hkv, -(-sms // base))
        dp = next(p for p in (32, 64, 128, 256) if D <= p)
        with torch.cuda.device(dev):
            assert scratch(B, Hq, Hkv, Sk, D, 1) == (
                2 * ns * B * Hkv * Sk * dp * 4 if ns > 1 else 0)
            assert scratch(B, Hq, Hkv, Sk, D, 0) == 0


# the forward's scan shapes and the training shape (4 x 512 tokens at the
# RG-LRU width): one rounded multiply and add per step in the same order
# in kernel and plain version, so equal bit for bit
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D", SCAN_SHAPES[:4] + [(4, 512, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_scan_backward_matches_plain(B, S, D, dtype):
    dev = _card()
    a = torch.sigmoid(_randn((B, S, D), B * S, dev)).to(dtype)
    b = _randn((B, S, D), B * S + 1, dev, dtype)
    h0 = _randn((B, D), B * S + 2, dev)
    g = _randn((B, S, D), B * S + 3, dev, dtype)
    for init in (h0, None):
        ar, br = a.requires_grad_(True), b.requires_grad_(True)
        hr = None if init is None else init.requires_grad_(True)
        before = (linear_scan.launches, linear_scan.bwd_launches)
        h = linear_scan(ar, br, hr)
        grads = torch.autograd.grad(h, [x for x in (ar, br, hr)
                                        if x is not None], g)
        torch.cuda.synchronize()
        assert (linear_scan.launches, linear_scan.bwd_launches) == (
            before[0] + 1, before[1] + 1)
        bwd = kscan.ROUTES[kscan.scan_route(B, S, D, dtype)][1]
        da, db, dh0 = bwd(a.detach(), h.detach(), g, init)
        assert torch.equal(grads[0], da) and torch.equal(grads[1], db)
        if init is not None:
            assert torch.equal(grads[2], dh0)


# each route's kernels launched directly: the reference tests' grid, the
# training shape (4 x 512 tokens at the RG-LRU width), a long sequence and
# a ragged S that is not a multiple of the chunk; a D whose rows are not
# 16-byte aligned takes the element-wise staging
ROUTE_SHAPES = ([(B, S, D, dt) for B, S, D in SCAN_SHAPES[:4]
                 for dt in (torch.float32, torch.bfloat16)]
                + [(4, 512, 2560, torch.float32),
                   (2, 4096, 2560, torch.float32),
                   (3, 77, 2560, torch.float32), (2, 333, 90, torch.bfloat16)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,dtype", ROUTE_SHAPES)
@pytest.mark.parametrize("route", ["sequential", "chunked"])
def test_linear_scan_route_kernels_match_plain(route, B, S, D, dtype):
    """Each route's forward and backward kernel equal its plain versions
    bit for bit (every multiply and add rounded on its own, in one order),
    repeat bit for bit, and count one launch per call."""
    dev = _card()
    fwd, bwd = kscan.ROUTES[route][:2]
    a = torch.sigmoid(_randn((B, S, D), B * S, dev)).to(dtype)
    b = _randn((B, S, D), B * S + 1, dev, dtype)
    h0 = _randn((B, D), B * S + 2, dev)
    g = _randn((B, S, D), B * S + 3, dev, dtype)
    chunked = int(route == "chunked")
    for init in (h0, None):
        count = lambda: (linear_scan.launches, linear_scan.bwd_launches,
                         linear_scan.chunked_launches,
                         linear_scan.chunked_bwd_launches)
        before = count()
        h = kscan._fwd_kernel(a, b, init, route)
        grads = kscan._bwd_kernel(a, h, init, g, init is not None, route)
        torch.cuda.synchronize()
        assert count() == (before[0] + 1, before[1] + 1,
                           before[2] + chunked, before[3] + chunked)
        assert torch.equal(h, fwd(a, b, init))
        want = bwd(a, h, g, init)
        assert torch.equal(grads[0], want[0]) and torch.equal(grads[1],
                                                              want[1])
        if init is not None:
            assert torch.equal(grads[2], want[2])
        assert torch.equal(h, kscan._fwd_kernel(a, b, init, route))
        again = kscan._bwd_kernel(a, h, init, g, init is not None, route)
        assert all(x is None and y is None or torch.equal(x, y)
                   for x, y in zip(grads, again))


@pytest.mark.cuda
def test_gradients_flow_through_the_kernels():
    """Outputs of the kernels on card tensors that need a gradient carry a
    grad_fn, and a backward reaches every input with a nonzero gradient."""
    dev = _card()
    mk = lambda shape, sd: _randn(shape, sd, dev, torch.bfloat16
                                  ).requires_grad_(True)
    q, k, v = mk((2, 48, 10, 256), 1), mk((2, 48, 1, 256), 2), \
        mk((2, 48, 1, 256), 3)
    o = flash_attention(q, k, v, causal=True, window=2048)
    assert o.grad_fn is not None
    o.float().square().sum().backward()
    a = torch.sigmoid(_randn((2, 48, 64), 4, dev)).requires_grad_(True)
    b = _randn((2, 48, 64), 5, dev).requires_grad_(True)
    h0 = _randn((2, 64), 6, dev).requires_grad_(True)
    h = linear_scan(a, b, h0)
    assert h.grad_fn is not None
    h.square().sum().backward()
    x = _randn((8, 1000), 7, dev).requires_grad_(True)
    loss = streaming_xent(x, torch.arange(8, device=dev))
    assert loss.grad_fn is not None
    loss.sum().backward()
    for name, t in (("q", q), ("k", k), ("v", v), ("a", a), ("b", b),
                    ("h0", h0), ("logits", x)):
        assert t.grad is not None, name
        assert bool(torch.isfinite(t.grad.float()).all()), name
        assert t.grad.abs().max().item() > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_runs_on_every_card(dtype):
    """The flash kernels, forward and backward, on every visible card (a
    mesh puts data groups on cards other than ``cuda:0``): the float32
    kernels opt into more than 48 KB of shared memory, an attribute each
    device needs set; set once per process, a launch on the second card
    failed with an invalid value. Needs two cards."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards; torch sees one")
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        q = _randn((2, 64, 8, 64), 3 * i, dev, dtype).requires_grad_(True)
        k = _randn((2, 64, 2, 64), 3 * i + 1, dev, dtype
                   ).requires_grad_(True)
        v = _randn((2, 64, 2, 64), 3 * i + 2, dev, dtype
                   ).requires_grad_(True)
        o = flash_attention(q, k, v, causal=True)
        do = torch.ones_like(o)
        got = torch.autograd.grad(o, (q, k, v), do)
        t = lambda x: x.detach().transpose(1, 2)
        want_o = attention_ref(t(q), t(k), t(v), causal=True).transpose(1, 2)
        want = attention_bwd_ref(t(q), t(k), t(v), t(o), t(do), causal=True)
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        assert o.device == dev
        assert torch.allclose(o.float(), want_o.float(), atol=tol, rtol=tol)
        for a, b in zip(got, want):
            assert torch.allclose(a.float(), b.transpose(1, 2).float(),
                                  atol=tol, rtol=tol)


@pytest.mark.cuda
def test_mesh_train_step_float32_on_the_card_matches_the_cpu():
    """Two float32 train steps of reduced granite-moe-3b-a800m (2 layers)
    on a 2 x 2 mesh whose slots share the card (the MoE island, 4 x 16
    tokens) against the same mesh on the CPU: every dispatch's routing
    integers equal, the losses within 1e-5 relative, the parameters within
    AdamW's 2 lr a step; the gradient itself after step 1 (one shared
    state): the grad norm within 1e-4 relative and, per leaf, AdamW's first
    moment (0.1 times the clipped gradient) within 1e-3 relative norm and
    1e-6 of cosine 1; the kernels launched (``flash_attention`` and
    ``streaming_xent``, forward and backward)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import sharding as tsh
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as mlayers
    from repro_torch.models import stepfn
    from repro_torch.models.model import model_template
    from repro_torch.models.params import init_params, leaves
    from repro_torch.training.optimizer import AdamW

    _card()
    cfg = reduced(get_config("granite-moe-3b-a800m"))
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (4, 17), generator=g)
    batch = {"tokens": toks[:, :16], "targets": toks[:, 1:].clone()}
    batch["targets"][0, :5] = -1
    inner = mlayers.moe_dispatch
    out = {}
    for dev in ("cuda", "cpu"):
        mesh = make_local_mesh(2, 2, devices=[dev] * 4)
        P = init_params(model_template(cfg), torch.Generator().manual_seed(6),
                        device="cpu")
        sp = tsh.put(P, tsh.param_pspecs(model_template(cfg), mesh), mesh)
        opt = AdamW()
        st = {"params": sp, "opt_state": opt.init(sp),
              "step": torch.zeros((), dtype=torch.int32, device=mesh.lead)}
        step = stepfn.make_train_step(cfg, opt, mesh=mesh, moe_groups=4,
                                      compute_dtype=torch.float32)
        rec, losses = [], []
        mlayers.moe_dispatch = lambda *a: rec.append(inner(*a)) or rec[-1]
        before = (flash_attention.launches, flash_attention.bwd_launches,
                  streaming_xent.launches, streaming_xent.bwd_launches)
        try:
            for n in range(2):
                st, m = step(st, {k: v.to(mesh.lead)
                                  for k, v in batch.items()})
                losses.append(m["loss"].item())
                if n == 0:
                    gnorm = m["grad_norm"].item()
                    mu = tsh.gather(st["opt_state"]["mu"], "cpu")
        finally:
            mlayers.moe_dispatch = inner
        after = (flash_attention.launches, flash_attention.bwd_launches,
                 streaming_xent.launches, streaming_xent.bwd_launches)
        out[dev] = (rec, losses, tsh.gather(st["params"], "cpu"),
                    [a - b for a, b in zip(after, before)], gnorm, mu)
    (rc, lc, pc, nc, gc_, mc), (rh, lh, ph, nh, gh, mh) = \
        out["cuda"], out["cpu"]
    assert abs(gc_ - gh) <= 1e-4 * gh, (gc_, gh)
    for a, b in zip(leaves(mc, torch.is_tensor), leaves(mh, torch.is_tensor)):
        a, b = a.double(), b.double()
        assert (a - b).norm() <= 1e-3 * b.norm()
        assert (a * b).sum() >= (1 - 1e-6) * a.norm() * b.norm()
    assert all(n > 0 for n in nc) and not any(nh), (nc, nh)
    assert len(rc) == len(rh) == 2 * 2 * 4 * 2   # steps x layers x slots x 2
    for a, b in zip(rc, rh):
        for k in ("topi", "dest", "keep"):
            assert torch.equal(a[k].cpu(), b[k]), k
    for a, b in zip(lc, lh):
        assert abs(a - b) <= 1e-5 * abs(b)
    for a, b in zip(leaves(pc, torch.is_tensor), leaves(ph, torch.is_tensor)):
        assert (a - b).abs().max().item() <= 2 * 2 * AdamW().lr * 1.01


def test_lm_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    """The LM path's entry points default to the card and raise without
    one; ``device="cpu"`` runs the plain versions. Runs everywhere (the
    card is hidden)."""
    from repro_torch.embed import bank, encoder
    from repro_torch.embed.config import EmbedConfig
    from repro_torch.scenarios import get_learning_spec, run_learning

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ov = {"features.kind": "lm", "embed.model": "recurrentgemma-2b",
          "embed.seq_len": 8, "embed.batch_size": 4}
    ec = EmbedConfig(model="recurrentgemma-2b", seq_len=8, batch_size=4)
    spec = get_learning_spec("hybrid_small", ov)
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    lengths = torch.full((2,), 8, dtype=torch.int32)
    calls = [
        lambda d: encoder.model_params(ec, **d),
        lambda d: encoder.projection(ec, 8, **d),
        lambda d: encoder.encode(ec, tokens, lengths, 8, **d),
        lambda d: bank.make_dataset(spec, 6, 2, **d),
        lambda d: bank.embedding_bank(ec, 2, 8, 3.0, **d),
        lambda d: run_learning("hybrid_small", overrides=ov, n_train=6,
                               n_test=2, rounds=1, n_reps=1, fit_steps=2,
                               **d),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call({})
    params = encoder.model_params(ec, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert encoder.encode(ec, tokens, lengths, 8, device="cpu").shape == (2, 8)
    X, y, Xt, yt = bank.make_dataset(spec, 6, 2, device="cpu")
    assert X.shape == (6, 8) and Xt.shape == (2, 8)


def _wide(shape, seed, dev):
    """float32 values over ~20 binades of both signs, made on ``dev``, so
    that a sum in another order or with an fma rounds differently."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev)
            * torch.exp(3 * torch.randn(shape, generator=g, device=dev)))


def _segment_reduce_matmul(A, B):
    """The learner's product as the port computed it on the card before the
    kernel: the product tensor, then one sequential ``segment_reduce``."""
    p = A[..., :, :, None] * B[..., None, :, :]
    lead, k, m = p.shape[:-2], p.shape[-2], p.shape[-1]
    p = p.reshape((-1, k, m))
    lengths = torch.full((p.shape[0], 1), k, dtype=torch.int64,
                         device=p.device)
    return torch.segment_reduce(p, "sum", lengths=lengths, axis=1,
                                unsafe=True).reshape(lead + (m,))


def _check_ordered(A, B, cpu_rows=None):
    """The kernel's ``A @ B`` equal bit for bit to the segment_reduce path on
    the card and to the plain version on the CPU (on the first
    ``cpu_rows`` batch elements where given); one launch."""
    before = ordered_matmul.launches
    got = ordered_matmul(A, B)
    torch.cuda.synchronize()
    assert ordered_matmul.launches == before + (got.numel() > 0)
    want = _segment_reduce_matmul(A, B)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    sl = slice(None) if cpu_rows is None else slice(0, cpu_rows)
    a, b = A[sl].cpu(), B[sl].cpu()
    np.testing.assert_array_equal(got[sl].cpu().numpy(),
                                  ordered_matmul_ref(a, b).numpy())
    return got


# (A made as, A's shape after a transpose of its last two dims if True, B):
# tick.fuse, the fit's logits, the fit's gradient (a transposed view),
# ranked admission's backlog product, the learnability head
ORDERED_CELL_SHAPES = [
    ((65536, 32, 8), False, (65536, 8, 2)),
    ((32768, 256, 8), False, (32768, 8, 2)),
    ((32768, 256, 8), True, (32768, 256, 2)),
    ((65536, 1024, 8), False, (65536, 8, 2)),
    ((32768, 256, 16), False, (32768, 16, 2)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("a_shape,transposed,b_shape", ORDERED_CELL_SHAPES)
def test_ordered_matmul_kernel_matches_plain_at_the_cells(a_shape,
                                                          transposed,
                                                          b_shape):
    dev = _card()
    A = _wide(a_shape, sum(a_shape), dev)
    if transposed:
        A = A.transpose(-1, -2)
    B = _wide(b_shape, sum(b_shape) + 1, dev)
    _check_ordered(A, B, cpu_rows=2048)


# (A's shape, B's shape, how A is laid out): k = 1, k not a multiple of 4,
# m = 1, m = 3 and 4, n = 0, leading and broadcast dims, a ring slice (the
# fit's buf_X[:, :Bf]), one offset by a float (unaligned), a transposed view
ORDERED_EDGES = [
    ((64, 40, 1), (64, 1, 2), "plain"),
    ((64, 40, 7), (64, 7, 2), "plain"),
    ((64, 40, 12), (64, 12, 1), "plain"),
    ((64, 9, 5), (64, 5, 3), "plain"),
    ((64, 9, 8), (64, 8, 4), "plain"),
    ((64, 0, 8), (64, 8, 2), "plain"),
    ((2, 3, 50, 8), (2, 3, 8, 2), "plain"),
    ((50, 8), (7, 8, 2), "plain"),
    ((3, 50, 8), (1, 8, 2), "plain"),
    ((512, 256, 8), (512, 8, 2), "ring"),
    ((512, 256, 8), (512, 8, 2), "unaligned"),
    ((512, 13, 37), (512, 37, 2), "transposed"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("a_shape,b_shape,layout", ORDERED_EDGES)
def test_ordered_matmul_kernel_edge_shapes(a_shape, b_shape, layout):
    dev = _card()
    if layout == "ring":
        A = _wide(a_shape[:1] + (300,) + a_shape[2:], 3, dev)[:, :256]
    elif layout == "unaligned":
        A = _wide((a_shape[0], 256 * 8 + 1), 4, dev)[:, 1:].reshape(a_shape)
    elif layout == "transposed":
        A = _wide(a_shape[:-2] + a_shape[-2:][::-1], 5, dev).transpose(-1, -2)
    else:
        A = _wide(a_shape, sum(a_shape), dev)
    if layout != "plain":
        assert not A.is_contiguous() or A.data_ptr() % 16
    _check_ordered(A, _wide(b_shape, 7, dev))


# order-sensitive values (a's row, against b's ones and minus ones)
ORDER_VALUES = [
    [1e8, 1.0, -1e8], [1.0, 1e8, -1e8, 1.0], [-0.0, -0.0, -0.0],
    [-0.0, 0.0], [float("inf"), 1.0, 2.0], [float("inf"), float("-inf"), 1.0],
    [1.0, float("nan"), 2.0], [1e-45, 1e-45, 3e38, -3e38],
]


@pytest.mark.cuda
@pytest.mark.parametrize("values", ORDER_VALUES)
def test_ordered_sums_special_values_on_the_card(values):
    dev = _card()
    v = torch.tensor(values, dtype=torch.float32)
    A = torch.stack([v, v.flip(0)])[None]                    # (1, 2, k)
    B = torch.ones((1, v.numel(), 2))
    B[0, :, 1] = -1.0
    got = ordered_matmul(A.to(dev), B.to(dev)).cpu().numpy()
    want = ordered_matmul_ref(A, B).numpy()
    np.testing.assert_array_equal(got, want)
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(np.signbit(got[ok]), np.signbit(want[ok]))
    g = A.transpose(-1, -2).contiguous()                     # (1, k, 2)
    seg = segment_sum(g.to(dev), v.numel()).cpu().numpy()
    seg_want = segment_sum_ref(g, v.numel()).numpy()
    np.testing.assert_array_equal(seg, seg_want)
    ok = ~np.isnan(seg_want)
    np.testing.assert_array_equal(np.signbit(seg[ok]),
                                  np.signbit(seg_want[ok]))


# (R, n, C, size): _row_sum's two levels at the fit's (32768, 256, 2), the
# pool sum's (rows, P, 1), C = 3 and 4, a strided g
SEGMENT_SHAPES = [
    (32768, 256, 2, 32, False), (32768, 8, 2, 8, False),
    (65536, 8, 1, 8, False), (100, 96, 3, 32, False), (100, 64, 4, 16, False),
    (100, 64, 2, 32, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("R,n,C,size,strided", SEGMENT_SHAPES)
def test_segment_sum_kernel_matches_plain(R, n, C, size, strided):
    dev = _card()
    g = _wide((R, n, C + 1) if strided else (R, n, C), R + n + C, dev)
    if strided:
        g = g[..., 1:]
    before = segment_sum.launches
    got = segment_sum(g, size)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    lengths = torch.full((R, n // size), size, dtype=torch.int64, device=dev)
    card = torch.segment_reduce(g, "sum", lengths=lengths, axis=1,
                                unsafe=True)
    np.testing.assert_array_equal(got.cpu().numpy(), card.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  segment_sum_ref(g.cpu(), size).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 1, 31, 33, 1500])
def test_row_sum_on_the_card_equals_the_cpu(n):
    dev = _card()
    g = _wide((4096, n, 2), n, dev)
    np.testing.assert_array_equal(linear._row_sum(g).cpu().numpy(),
                                  linear._row_sum(g.cpu()).numpy())


@pytest.mark.cuda
def test_ordered_sum_wrapper_rejects_bad_inputs():
    dev = _card()
    A, B = torch.zeros(2, 3, 4, device=dev), torch.zeros(2, 4, 2, device=dev)
    bad = [
        (TypeError, lambda: ordered_matmul(A.double(), B.double())),
        (TypeError, lambda: ordered_matmul(A.to(torch.bfloat16), B)),
        (ValueError, lambda: ordered_matmul(A, B.cpu())),
        (ValueError, lambda: ordered_matmul(A, torch.zeros(2, 3, 2,
                                                           device=dev))),
        (ValueError, lambda: ordered_matmul(A, torch.zeros(3, 4, 2,
                                                           device=dev))),
        (ValueError, lambda: ordered_matmul(A, torch.zeros(2, 4, 0,
                                                           device=dev))),
        (TypeError, lambda: segment_sum(A.double(), 3)),
        (ValueError, lambda: segment_sum(A, 2)),
        (ValueError, lambda: segment_sum(A[0], 3)),
    ]
    counts = (ordered_matmul.launches, segment_sum.launches)
    for err, call in bad:
        with pytest.raises(err):
            call()
    assert (ordered_matmul.launches, segment_sum.launches) == counts
    ordered_matmul(A, B)
    ordered_matmul(A, B)
    segment_sum(A, 3)
    assert (ordered_matmul.launches, segment_sum.launches) == (
        counts[0] + 2, counts[1] + 1)
