"""The port's xLSTM blocks (mLSTM, sLSTM), the xlstm-125m forward, and the
encoder and embedding bank on it, against the JAX package on the CPU.

Parameters are the reference's own (drawn inside
``jax.threefry_partitionable(False)``) carried across with
``params_from_numpy``; inputs are made from a seed with numpy. Tolerances:
- the float32 cores (``_mlstm_seq``, ``_mlstm_chunked``, the sLSTM
  recurrence) on float32 inputs: rtol 1e-5 against the reference; the
  port's chunked form against its own sequential one: rtol 1e-4 (the two
  forms sum in different orders);
- the blocks on bfloat16 parameters and the forward, against the
  reference run op by op (``jax.disable_jit``): 5e-3 of the mean |output|
  in the mean and 0.15 at the most (``_close``), as the RG-LRU blocks are
  held in tests/test_torch_models.py;
- the forward against the reference jitted (XLA fuses the blocks'
  elementwise chains and rounds them once): 3e-2 and 0.3;
- ``encode``: the bounds of tests/test_torch_embed.py's
  ``test_encode_matches_reference_with_carried_params`` (3e-2, 0.3).
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
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.embed import encoder as jenc  # noqa: E402
from repro.embed.config import EmbedConfig as JEmbedConfig  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import recurrent as jr  # noqa: E402
from repro.models.params import count_params as jcount  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.embed import bank as tbank  # noqa: E402
from repro_torch.embed import corpus as tcorpus  # noqa: E402
from repro_torch.embed import encoder as tenc  # noqa: E402
from repro_torch.embed.config import EmbedConfig  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import recurrent as tr  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    count_params, init_params, leaves, params_from_numpy, tree_map,
)

XL = "xlstm-125m"
BF = torch.bfloat16


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


def _rel(got, want, rtol):
    """Every element within ``rtol`` of the reference, relative to it, with
    an absolute floor of ``rtol`` times the mean |reference|."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).mean())


def _pair(shape, seed, bf16=False, scale=1.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale
         ).astype(np.float32)
    j, t = jnp.asarray(x), torch.from_numpy(x)
    if bf16:
        j, t = j.astype(jnp.bfloat16), t.to(BF)
    return j, t


def _configs(n_layers=2):
    return (dataclasses.replace(jreduced(jget_config(XL)), n_layers=n_layers),
            dataclasses.replace(reduced(get_config(XL)), n_layers=n_layers))


_PARAMS = {}


def _params(n_layers=2):
    """The reference's parameters of a reduced xlstm-125m and the port's
    carried copy."""
    if n_layers not in _PARAMS:
        jcfg, _ = _configs(n_layers)
        with jax.threefry_partitionable(False):
            P = jinit(jm.model_template(jcfg), jax.random.key(10 + n_layers))
        _PARAMS[n_layers] = (P, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, P), device="cpu"))
    return _PARAMS[n_layers]


def _block(P, tp, idx, dtype):
    """Block ``idx`` of the first group, cast to ``dtype`` on both sides."""
    jd = jnp.bfloat16 if dtype == BF else jnp.float32
    pj = jax.tree_util.tree_map(lambda a: a[0].astype(jd), P["groups"][idx])
    pt = tree_map(lambda a: a[0].to(dtype), tp["groups"][idx],
                  is_leaf=torch.is_tensor)
    return pj, pt


# ------------------------------------------------------------ blocks ----

@pytest.mark.parametrize("impl", ["seq", "chunked"])
def test_xlstm_blocks_equal_reference_op_by_op(impl):
    """mLSTM (both forms) and sLSTM on bfloat16 parameters at S = 16, their
    states, and both blocks through ``apply_block``, against the reference
    run op by op."""
    jcfg, tcfg = _configs()
    P, tp = _params()
    assert tcfg.layer_groups()[0] == ("mlstm", "slstm")
    xj, xt = _pair((4, 16, 64), 21, bf16=True)
    pm_j, pm_t = _block(P, tp, 0, BF)
    ps_j, ps_t = _block(P, tp, 1, BF)
    with jax.disable_jit():
        y, st = jr.apply_mlstm(pm_j["mlstm"], xj, jr.mlstm_init_state(jcfg, 4),
                               jcfg, impl=impl)
        ys, sts = jr.apply_slstm(ps_j["slstm"], xj,
                                 jr.slstm_init_state(jcfg, 4), jcfg)
        ctx = {"mode": "train", "mlstm_impl": impl}
        bm = jm.apply_block(pm_j, "mlstm", xj, None, jcfg, ctx)[0]
        bs = jm.apply_block(ps_j, "slstm", xj, None, jcfg, ctx)[0]
    yt, stt = tr.apply_mlstm(pm_t["mlstm"], xt,
                             tr.mlstm_init_state(tcfg, 4, device="cpu"),
                             tcfg, impl=impl)
    yst, stst = tr.apply_slstm(ps_t["slstm"], xt,
                               tr.slstm_init_state(tcfg, 4, device="cpu"),
                               tcfg)
    assert yt.dtype == BF and yst.dtype == BF
    _close(yt, y, 5e-3, 0.15)
    _close(yst, ys, 5e-3, 0.15)
    for k in ("C", "n"):
        _close(stt[k], st[k], 5e-3, 0.15)
    _close(stt["m"], st["m"], 5e-3, 0.15)
    for k in ("c", "n", "h", "m"):
        _close(stst[k], sts[k], 5e-3, 0.15)
        assert stst[k].dtype == torch.float32
    _close(tm.apply_block(pm_t, "mlstm", xt, None, tcfg, ctx)[0], bm, 5e-3,
           0.15)
    _close(tm.apply_block(ps_t, "slstm", xt, None, tcfg, ctx)[0], bs, 5e-3,
           0.15)


def _core_inputs(B, S, H, dqk, dv, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v = f(B, S, H, dqk), f(B, S, H, dqk) * dqk ** -0.5, f(B, S, H, dv)
    log_i = f(B, S, H)
    log_f = (-np.logaddexp(0.0, -(f(B, S, H) + 2.0))).astype(np.float32)
    return q, k, v, log_i, log_f


def _state(C, n, m, torch_side):
    if torch_side:
        return {"C": torch.from_numpy(C), "n": torch.from_numpy(n),
                "m": torch.from_numpy(m)}
    return {"C": jnp.asarray(C), "n": jnp.asarray(n), "m": jnp.asarray(m)}


@pytest.mark.parametrize("form,S,chunk", [("seq", 16, None),
                                          ("chunked", 32, 8),
                                          ("chunked", 16, 256)])
def test_mlstm_float32_cores_match_reference(form, S, chunk):
    """``_mlstm_seq`` and ``_mlstm_chunked`` (chunk 8 at S = 32: four
    chunks, so the inter-chunk decay and state carry run) on float32
    inputs, from the empty state and then from the state the first half
    left, against the reference's at rtol 1e-5."""
    B, H, dqk, dv = 3, 4, 16, 32
    arrs = _core_inputs(B, S, H, dqk, dv, S + (chunk or 0))
    j0 = _state(np.zeros((B, H, dqk, dv), np.float32),
                np.zeros((B, H, dqk), np.float32),
                np.full((B, H), -1e30, np.float32), False)
    t0 = tr.mlstm_init_state(_mlstm_cfg(H, dqk, dv), B, device="cpu")
    kw = {} if chunk is None else {"chunk": chunk}
    jf = jr._mlstm_seq if form == "seq" else jr._mlstm_chunked
    tf = tr._mlstm_seq if form == "seq" else tr._mlstm_chunked
    half = S // 2
    sl = lambda a, lo, hi: a[:, lo:hi]
    hj, sj = jf(*(jnp.asarray(sl(a, 0, half)) for a in arrs), j0, **kw)
    ht, st = tf(*(torch.from_numpy(sl(a, 0, half)) for a in arrs), t0, **kw)
    _rel(ht, hj, 1e-5)
    hj2, sj2 = jf(*(jnp.asarray(sl(a, half, S)) for a in arrs), sj, **kw)
    ht2, st2 = tf(*(torch.from_numpy(sl(a, half, S)) for a in arrs), st,
                  **kw)
    _rel(ht2, hj2, 1e-5)
    for k in ("C", "n", "m"):
        _rel(st2[k], sj2[k], 1e-5)


def _mlstm_cfg(H, dqk, dv):
    """A stand-in config with the mLSTM dimensions (d_inner = H * dv)."""
    return dataclasses.replace(reduced(get_config(XL)), n_heads=H,
                               head_dim=dqk, d_model=H * dv // 2)


def test_mlstm_chunked_equals_its_sequential_form():
    """The port's chunked form against its own oracle at rtol 1e-4: one
    chunk, four chunks, and from a carried state."""
    B, S, H, dqk, dv = 2, 48, 4, 16, 32
    arrs = [torch.from_numpy(a) for a in _core_inputs(B, S, H, dqk, dv, 5)]
    st0 = tr.mlstm_init_state(_mlstm_cfg(H, dqk, dv), B, device="cpu")
    h_seq, s_seq = tr._mlstm_seq(*arrs, st0)
    for chunk in (48, 12):
        h_ch, s_ch = tr._mlstm_chunked(*arrs, st0, chunk=chunk)
        _rel(h_ch, h_seq, 1e-4)
        for k in ("C", "n", "m"):
            _rel(s_ch[k], s_seq[k], 1e-4)
    h2s, _ = tr._mlstm_seq(*arrs, s_seq)
    h2c, _ = tr._mlstm_chunked(*arrs, s_seq, chunk=16)
    _rel(h2c, h2s, 1e-4)
    with pytest.raises(ValueError):
        tr._mlstm_chunked(*arrs, st0, chunk=20)
    with pytest.raises(ValueError):
        tr.apply_mlstm({}, torch.zeros(1, 2, 64), st0, reduced(
            get_config(XL)), impl="scan")


def test_slstm_float32_recurrence_matches_reference():
    """The sLSTM block on float32 parameters and inputs (the recurrence and
    its ``r_gates`` product in float32), from the empty state and from a
    carried one, against the reference's at rtol 1e-5."""
    jcfg, tcfg = _configs()
    P, tp = _params()
    pj, pt = _block(P, tp, 1, torch.float32)
    xj, xt = _pair((3, 16, 64), 8)
    y, st = jr.apply_slstm(pj["slstm"], xj, jr.slstm_init_state(jcfg, 3),
                           jcfg)
    yt, stt = tr.apply_slstm(pt["slstm"], xt,
                             tr.slstm_init_state(tcfg, 3, device="cpu"), tcfg)
    _rel(yt, y, 1e-5)
    y2, st2 = jr.apply_slstm(pj["slstm"], xj, st, jcfg)
    yt2, stt2 = tr.apply_slstm(pt["slstm"], xt, stt, tcfg)
    _rel(yt2, y2, 1e-5)
    for k in ("c", "n", "h", "m"):
        _rel(stt2[k], st2[k], 1e-5)


# ----------------------------------------------------------- forward ----

@pytest.mark.parametrize("logits_mode", ["hidden", "all"])
def test_xlstm_forward_matches_reference(logits_mode):
    """Reduced xlstm-125m (one mLSTM + sLSTM group) at 16 tokens, against
    the reference op by op and jitted; the chunked and sequential mLSTM
    forms agree on the port."""
    jcfg, tcfg = _configs()
    P, tp = _params()
    toks = np.random.default_rng(3).integers(0, 256, (4, 16)).astype(np.int32)
    got = tm.forward(tp, tcfg, torch.from_numpy(toks),
                     logits_mode=logits_mode)[0].numpy()
    with jax.disable_jit():
        eager = np.asarray(jm.forward(P, jcfg, jnp.asarray(toks),
                                      logits_mode=logits_mode)[0])
    _close(got, eager, 5e-3, 0.15)
    jitted = np.asarray(jax.jit(lambda p, t: jm.forward(
        p, jcfg, t, logits_mode=logits_mode)[0])(P, jnp.asarray(toks)))
    _close(got, jitted, 3e-2, 0.3)
    assert got.shape == ((4, 16, 64) if logits_mode == "hidden"
                         else (4, 16, 256))
    seq = tm.forward(tp, tcfg, torch.from_numpy(toks),
                     logits_mode=logits_mode, mlstm_impl="seq")[0].numpy()
    _close(seq, got, 5e-3, 0.15)


def test_xlstm_templates_and_counts_match_reference():
    """Same tree (shapes, init kinds) and parameter count as the
    reference's template, reduced and at full width (nothing allocated);
    ``_ff_inner`` and the fan-in of ``r_gates``."""
    for full in (False, True):
        jc = jget_config(XL) if full else jreduced(jget_config(XL))
        tc = get_config(XL) if full else reduced(get_config(XL))
        jt, tt = jm.model_template(jc), tm.model_template(tc)
        jleaves = jax.tree_util.tree_leaves(
            jt, is_leaf=lambda x: type(x).__name__ == "PSpec")
        assert [(tuple(p.shape), p.init) for p in jleaves] == \
            [(tuple(p.shape), p.init) for p in leaves(tt)]
        assert count_params(tt) == jcount(jt)
        assert tc._ff_inner() == jc._ff_inner()
    full = get_config(XL)
    assert full._ff_inner() == 2048 and reduced(full)._ff_inner() == 128
    assert full.layer_groups() == (("mlstm", "slstm"), 6, ())
    n = count_params(tm.model_template(full))
    assert 0.12e9 < n < 0.14e9, n
    # r_gates (H, dh, 4 dh) draws with fan-in dh = shape[-2], as the
    # reference's init_params does
    _, tcfg = _configs()
    t = init_params(tm.model_template(tcfg), torch.Generator().manual_seed(1),
                    device="cpu")
    r = t["groups"][1]["slstm"]["r_gates"]
    assert r.shape == (1, 4, 16, 64)
    assert abs(float(r.std()) - 16 ** -0.5) < 0.02
    assert bool((t["groups"][1]["slstm"]["b_gates"] == 0).all())
    assert bool((t["groups"][0]["mlstm"]["hnorm"]["scale"] == 1).all())
    P, tp = _params()
    np.testing.assert_array_equal(
        tp["groups"][1]["slstm"]["r_gates"].numpy(),
        np.asarray(P["groups"][1]["slstm"]["r_gates"]))


# --------------------------------------------------- encoder and bank ----

EC_KW = dict(model=XL, seq_len=16, bank_size=64, batch_size=32)


@pytest.mark.parametrize("pooling", ["mean", "last"])
def test_xlstm_encode_matches_reference_with_carried_params(pooling):
    """``encode`` through the reduced xlstm-125m on the reference's
    parameters and projection, against the reference's ``encode``."""
    ec_j = JEmbedConfig(**EC_KW, pooling=pooling, seed=4)
    ec_t = EmbedConfig(**EC_KW, pooling=pooling, seed=4)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 256, (40, 16)).astype(np.int32)
    lengths = rng.integers(4, 17, 40).astype(np.int32)
    with jax.threefry_partitionable(False):
        want = np.asarray(jenc.encode(ec_j, tokens, lengths, 8, shard=False))
        P = jenc.model_params(ec_j)
        proj = np.array(jenc.projection(ec_j, 8))
    got = tenc.encode(ec_t, tokens, lengths, 8, device="cpu",
                      params=params_from_numpy(
                          jax.tree_util.tree_map(np.asarray, P),
                          device="cpu"),
                      proj=torch.from_numpy(proj))
    assert got.dtype == torch.float32 and got.shape == (40, 8)
    _close(got.numpy(), want, 3e-2, 0.3)


def test_xlstm_embedding_bank_layout_cache_and_texts():
    """The port's bank on the reduced xlstm-125m: the (2, C, K, F) layout,
    standardized over the bank, cached per config and device; bank_gather
    picks class, variant and half; ``embed_texts`` lands in the bank's
    space (the bank's statistics, not the batch's)."""
    ec = EmbedConfig(**EC_KW)
    b = tbank.embedding_bank(ec, 2, 8, 3.0, 0.1, device="cpu")
    assert b.feats.shape == (2, 2, 16, 8) and b.feats.dtype == torch.float32
    assert b is tbank.embedding_bank(ec, 2, 8, 3.0, 0.1, device="cpu")
    flat = b.feats.reshape(-1, 8)
    assert float(flat.mean(0).abs().max()) < 1e-4
    assert float((flat.std(0, correction=0) - 1).abs().max()) < 1e-3
    assert bool(torch.isfinite(flat).all())
    u = torch.tensor([0.0, 0.99, 0.5])
    tl = torch.tensor([1, 0, 1])
    diff = torch.tensor([1.0, 0.0, 0.5])
    g = tbank.bank_gather(b.feats, u, tl, diff)
    assert torch.equal(g[0], b.feats[0, 1, 0])
    assert torch.equal(g[1], b.feats[1, 0, 15])
    assert torch.equal(g[2], b.feats[1, 1, 8])
    texts = ["classify this", "another task", "a third one"]
    v = tbank.embed_texts(ec, texts, 2, 8, 3.0, 0.1, device="cpu")
    assert v.shape == (3, 8) and bool(torch.isfinite(v).all())
    assert torch.equal(v, tbank.embed_texts(ec, texts, 2, 8, 3.0, 0.1,
                                            device="cpu"))
    cfg = tenc.resolved_config(ec)
    pairs = [tcorpus.tokenize_text(t, ec.seq_len, cfg.vocab_size)
             for t in texts]
    E = tenc.encode(ec, np.stack([p[0] for p in pairs]),
                    np.asarray([p[1] for p in pairs], np.int32), 8,
                    device="cpu")
    assert torch.equal(v, (E - b.mean) / torch.clamp(b.std, min=1e-6))
