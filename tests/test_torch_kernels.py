"""The port's kernel wrappers on the CPU, held against the JAX package.

On the CPU, ``repro_torch.kernels.ds_estep.ds_estep`` runs its plain
version ``ds_estep_ref``; both are held against the Pallas kernel in
interpret mode and against the JAX package's jnp oracle, on the same
inputs made from a seed with numpy. Tolerances are the reference test's
(tests/test_labelstream.py::test_ds_estep_kernel_matches_ref): 1e-4 on
logp, 1e-5 on post. The kernel itself is held against the plain version on
the card in tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.kernels.ref as jref  # noqa: E402
from repro.kernels.ds_estep import ds_estep as jax_ds_estep  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ds_estep import ds_estep  # noqa: E402
from repro_torch.kernels.ref import ds_estep_ref  # noqa: E402


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
