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
from repro_torch.kernels.ref import ds_estep_ref


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
