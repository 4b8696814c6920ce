"""Prefill and decode with their caches, for all ten architectures of the
registry at reduced size, against the JAX package on the CPU.

Parameters are the reference's own (drawn inside
``jax.threefry_partitionable(False)``) carried across with
``params_from_numpy``; tokens and cross sources are made from a seed with
numpy. MoE configs take ``capacity_factor = n_experts``, as the
reference's own decode test does, so that no token is dropped and the
forward over S + 1 tokens routes as prefill + decode do. Tolerances:
- the port's ``make_prefill_step`` / ``make_decode_step`` against the
  reference's run op by op (``jax.disable_jit``): logits, and the caches'
  float leaves (k, v, ck, cv, recurrent states; over the elements that are
  not zero on both sides, so that empty slots do not dilute the mean),
  within 5e-3 of the mean |value| in the mean and 0.15 at the most, the
  bounds the forward is held to in tests/test_torch_models.py (a bfloat16
  GEMM of oneDNN may round an element the other way from XLA's); measured
  equal on every architecture but for one cached value of whisper-base
  that decode wrote one bfloat16 ulp apart. ``pos`` (and so every slot's
  placement) is equal;
- the port's decode against its own train-mode forward over the same
  tokens: tests/test_models.py's ``test_decode_matches_full_forward`` and
  ``test_sliding_window_cache_ring`` bounds (atol 5e-2, 0.25 with MoE, 0.5
  for xlstm-125m; rtol 0.1);
- ``init_cache``: equal to the reference's (shapes, dtypes, values).
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import stepfn as jstep  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.params import leaves, params_from_numpy  # noqa: E402
from repro_torch.models.stepfn import (  # noqa: E402
    make_decode_step, make_prefill_step,
)

NAMES = sorted(ARCHS)
B, S = 2, 16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, mean_rel=5e-3, max_rel=0.15):
    """mean |got - want| <= mean_rel * mean |want| and max |got - want| <=
    max_rel * mean |want| (equal when want is all zero)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    d, scale = np.abs(got - want), np.abs(want).mean()
    if scale == 0:
        assert d.max() == 0
        return
    assert d.mean() <= mean_rel * scale and d.max() <= max_rel * scale, \
        (d.mean() / scale, d.max() / scale)


def _configs(name):
    jc, tc = jreduced(JARCHS[name]), reduced(get_config(name))
    if tc.n_experts:
        jc = dataclasses.replace(jc, capacity_factor=float(jc.n_experts))
        tc = dataclasses.replace(tc, capacity_factor=float(tc.n_experts))
    return jc, tc


def _inputs(cfg, n_tokens, seed):
    """Tokens (B, n_tokens) and the cross source (B, T, d) of the
    cross-attending models (None for the others), as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, n_tokens)).astype(np.int32)
    n = cfg.encoder_seq if cfg.is_encoder_decoder else cfg.n_img_tokens
    cs = rng.normal(size=(B, n, cfg.d_model)).astype(np.float32) if n \
        else None
    return toks, cs


def _cross(cs):
    """The cross source as each package takes it (bfloat16)."""
    if cs is None:
        return None, None
    return (jnp.asarray(cs).astype(jnp.bfloat16),
            torch.from_numpy(cs).to(torch.bfloat16))


_RUNS = {}


def _run(name):
    """Prefill of S tokens and one decode step, in both packages, and the
    port's train forward over the S + 1 tokens."""
    if name in _RUNS:
        return _RUNS[name]
    jc, tc = _configs(name)
    with jax.threefry_partitionable(False):
        P = jinit(jm.model_template(jc), jax.random.key(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, P),
                           device="cpu")
    toks, cs = _inputs(tc, S + 1, 1)
    csj, cst = _cross(cs)
    bj, bt = {"tokens": jnp.asarray(toks[:, :S])}, \
        {"tokens": torch.from_numpy(toks[:, :S])}
    if cs is not None:
        bj["cross_src"], bt["cross_src"] = csj, cst
    with jax.disable_jit():
        lj, cj = jstep.make_prefill_step(jc)(P, bj)
        dj, cj2 = jstep.make_decode_step(jc)(
            P, cj, jnp.asarray(toks[:, S:]), jnp.full((B,), S, jnp.int32))
    lt, ct = make_prefill_step(tc)(tp, bt)
    dt, ct2 = make_decode_step(tc)(tp, ct, torch.from_numpy(toks[:, S:]),
                                   torch.full((B,), S, dtype=torch.int32))
    oracle = tm.forward(tp, tc, torch.from_numpy(toks), cross_src=cst,
                        mlstm_impl="seq")[0]
    _RUNS[name] = dict(jc=jc, tc=tc, ref=(lj, cj, dj, cj2),
                       port=(lt, ct, dt, ct2), oracle=oracle)
    return _RUNS[name]


def _paths(cache):
    """The reference's cache leaves with their paths, in flatten order."""
    return jax.tree_util.tree_leaves_with_path(cache)


def _hold_cache(got, want):
    jl, tl = _paths(want), leaves(got, torch.is_tensor)
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        key = jax.tree_util.keystr(path)
        assert tuple(g.shape) == tuple(w.shape), key
        assert str(g.dtype).split(".")[1] == str(w.dtype), key
        if key.endswith("['pos']"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=key)
        else:
            # empty slots are zero on both sides; the bounds hold over the
            # rest (a mostly empty cache would dilute the mean |value|)
            gn, wn = _np(g), _np(w)
            full = (gn != 0) | (wn != 0)
            _close(gn[full], wn[full])


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_logits_match_reference(name):
    r = _run(name)
    lj, _, dj, _ = r["ref"]
    lt, _, dt, _ = r["port"]
    assert lt.shape == (B, r["tc"].vocab_size) and lt.dtype == torch.float32
    _close(lt, lj)
    _close(dt, dj)


@pytest.mark.parametrize("name", NAMES)
def test_caches_match_reference(name):
    """Every cache leaf after prefill and after one decode step: same
    tree, shapes and dtypes; ``pos`` (the slot placement) equal; the
    values within the stated bounds."""
    r = _run(name)
    _hold_cache(r["port"][1], r["ref"][1])
    _hold_cache(r["port"][3], r["ref"][3])


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_own_forward(name):
    """tests/test_models.py::test_decode_matches_full_forward on the port:
    prefill's last logits and the decoded token's against the train
    forward (sequential mLSTM) over the same S + 1 tokens."""
    r = _run(name)
    tc = r["tc"]
    atol = 0.25 if tc.n_experts else 5e-2
    if name == "xlstm-125m":
        atol = 0.5
    lt, _, dt, _ = r["port"]
    np.testing.assert_allclose(_np(lt), _np(r["oracle"][:, S - 1]),
                               atol=atol, rtol=0.1)
    np.testing.assert_allclose(_np(dt), _np(r["oracle"][:, S]), atol=atol,
                               rtol=0.1)


@pytest.mark.parametrize("name", NAMES)
def test_init_cache_matches_reference(name):
    jc, tc = _configs(name)
    want = jm.init_cache(jc, 3, 20)
    got = tm.init_cache(tc, 3, 20, device="cpu")
    jl, tl = _paths(want), leaves(got, torch.is_tensor)
    assert len(jl) == len(tl) > 0
    for (path, w), g in zip(jl, tl):
        key = jax.tree_util.keystr(path)
        assert tuple(g.shape) == tuple(w.shape), key
        assert str(g.dtype).split(".")[1] == str(w.dtype), key
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=key)
    assert tm.cache_len(tc, 20) == jm.cache_len(jc, 20)


@pytest.mark.parametrize("name,ctx", [("h2o-danube-1.8b", 24),
                                      ("recurrentgemma-2b", 12),
                                      ("xlstm-125m", 12),
                                      ("whisper-base", 6)])
def test_multi_step_decode(name, ctx):
    """Four decode steps after a prefill: through danube's ring (window 8,
    tests/test_models.py::test_sliding_window_cache_ring on the port),
    recurrentgemma's RG-LRU and ring, xlstm's carried mLSTM and sLSTM
    states, whisper's cached cross keys. Each step against the port's
    train forward and the reference's decode op by op; ``pos`` equal to
    the reference's at every step."""
    jc, tc = _configs(name)
    with jax.threefry_partitionable(False):
        P = jinit(jm.model_template(jc), jax.random.key(2))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, P),
                           device="cpu")
    toks, cs = _inputs(tc, ctx + 4, 3)
    csj, cst = _cross(cs)
    oracle = tm.forward(tp, tc, torch.from_numpy(toks), cross_src=cst,
                        mlstm_impl="seq")[0]
    bt = {"tokens": torch.from_numpy(toks[:, :ctx]), "cross_src": cst}
    bj = {"tokens": jnp.asarray(toks[:, :ctx]), "cross_src": csj}
    atol = 0.5 if name == "xlstm-125m" else 5e-2
    with jax.disable_jit():
        lj, cj = jstep.make_prefill_step(jc)(P, bj)
        lt, ct = make_prefill_step(tc)(tp, bt)
        _close(lt, lj)
        np.testing.assert_allclose(_np(lt), _np(oracle[:, ctx - 1]),
                                   atol=atol, rtol=0.1)
        dec_j, dec_t = jstep.make_decode_step(jc), make_decode_step(tc)
        for i in range(4):
            p = ctx + i
            tok = toks[:, p:p + 1]
            dj, cj = dec_j(P, cj, jnp.asarray(tok),
                           jnp.full((B,), p, jnp.int32))
            before = [t.clone() for t in leaves(ct, torch.is_tensor)]
            dt, ct_new = dec_t(tp, ct, torch.from_numpy(tok),
                               torch.full((B,), p, dtype=torch.int32))
            # the cache given is not changed
            assert all(torch.equal(a, b) for a, b in
                       zip(before, leaves(ct, torch.is_tensor)))
            ct = ct_new
            _close(dt, dj)
            np.testing.assert_allclose(_np(dt), _np(oracle[:, p]),
                                       atol=atol, rtol=0.1)
            _hold_cache(ct, cj)
