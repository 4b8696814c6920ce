"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and skips itself when torch sees none;
run them on the card with ``PYTHONPATH=src python -m pytest -q
--noconftest -m cuda tests/test_torch_kernels_cuda.py`` (the repo's
``tests/conftest.py`` imports JAX). They import torch and the port only, so
they run where JAX is not installed. The CPU parity of the plain versions
with the JAX package is in ``tests/test_torch_kernels.py``.
"""
import math

import pytest
import torch

from repro_torch.kernels.ds_estep import ds_estep
from repro_torch.kernels.ref import ds_estep_ref, entropy_ref
from repro_torch.kernels.uncertainty import entropy_scores


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
