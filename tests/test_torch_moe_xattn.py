"""The MoE, cross-attention and encoder-decoder blocks of the port against
the JAX package on the CPU: the MoE's dispatch and combine, the
cross-attention sub-block in each mode, the whisper encoder, the attention
routes, the embedding ``encode`` of the four architectures that have these
blocks, and the train step's loss, aux and gradients of reduced
granite-moe-3b-a800m and whisper-base.

Parameters are the reference's own (drawn inside
``jax.threefry_partitionable(False)``) carried across with
``params_from_numpy``; inputs are made from a seed with numpy. Tolerances:
- the MoE's dispatch integers (``topi``, the slot order, ``keep``,
  ``dest``, the source tokens) and the aux count: equal, with and without
  capacity drops;
- ``apply_moe`` on bfloat16 parameters against the reference run op by
  op: out within 5e-3 of the mean |out| in the mean and 0.15 at the most
  (the forward's bounds in tests/test_torch_models.py; measured equal),
  aux within rtol 1e-5 (float32 softmax and mean: XLA's and PyTorch's
  exp differ in the last bit);
- ``_cross_attention`` and ``_encode`` against the reference op by op:
  5e-3 and 0.15, as above;
- ``encode``: the bounds of tests/test_torch_embed.py (3e-2, 0.3);
- the train step against ``jax.value_and_grad`` of the reference's loss
  run op by op, per gradient leaf: relative error ||g - g_ref|| /
  ||g_ref|| and cosine; the loss, and aux, within an absolute bound.
  The bounds are tests/test_torch_training.py's (5e-2, 0.999, 5e-4);
  measured: granite 8.8e-3, 0.99996, loss 4.8e-7 apart, aux equal;
  whisper 1.4e-2, 0.99991, loss 8.6e-5 apart.
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
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import stepfn as jstep  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.embed import encoder as tenc  # noqa: E402
from repro_torch.embed.config import EmbedConfig  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import stepfn as ts  # noqa: E402
from repro_torch.models.params import leaves, params_from_numpy  # noqa: E402

GRANITE, MIXTRAL = "granite-moe-3b-a800m", "mixtral-8x7b"
WHISPER, VISION = "whisper-base", "llama-3.2-vision-11b"
BF = torch.bfloat16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, mean_rel=5e-3, max_rel=0.15):
    """mean |got - want| <= mean_rel * mean |want| and max |got - want| <=
    max_rel * mean |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    d, scale = np.abs(got - want), np.abs(want).mean()
    assert d.mean() <= mean_rel * scale and d.max() <= max_rel * scale, \
        (d.mean() / scale, d.max() / scale)


def _configs(name, **kw):
    return (dataclasses.replace(jreduced(jget_config(name)), **kw),
            dataclasses.replace(reduced(get_config(name)), **kw))


def _bf16_tree(template_j, seed):
    """Reference parameters of ``template_j`` in bfloat16 (as ``forward``
    casts them), and the port's carried copy."""
    with jax.threefry_partitionable(False):
        P = jinit(template_j, jax.random.key(seed))
    P = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), P)
    return P, params_from_numpy(jax.tree_util.tree_map(np.asarray, P),
                                device="cpu")


def _pair(shape, seed, scale=1.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale
         ).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(BF)


# ------------------------------------------------------------------ moe ----

def _ref_dispatch(P, x, cfg):
    """The reference's top-k and capacity dispatch, op for op as
    ``repro.models.layers.apply_moe`` computes it with ``groups=1``."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    Tg = B * S
    xf = x.reshape(1, Tg, d)
    probs = jax.nn.softmax((xf @ P["router"]).astype(jnp.float32), axis=-1)
    _, topi = jax.lax.top_k(probs, k)
    C = int(max(8, -(-k * Tg * cfg.capacity_factor // E)))
    slots_e = topi.reshape(1, Tg * k)
    order = jnp.argsort(slots_e, axis=-1, stable=True)
    sorted_e = jnp.take_along_axis(slots_e, order, axis=-1)
    first = jax.vmap(lambda se: jnp.searchsorted(se, se, side="left"))(
        sorted_e)
    rank = jnp.arange(Tg * k)[None] - first
    keep = rank < C
    dest = jnp.where(keep, sorted_e * C + rank, E * C)
    return dict(C=C, topi=topi[0], order=order[0], keep=keep[0],
                dest=dest[0], tok=(order // k)[0])


MOE_CASES = [(GRANITE, {}), (GRANITE, {"capacity_factor": 0.5}),
             (GRANITE, {"capacity_factor": 4.0}), (MIXTRAL, {}),
             (MIXTRAL, {"capacity_factor": 0.25}),
             (GRANITE, {"n_experts": 8, "moe_top_k": 4})]


@pytest.mark.parametrize("name,kw", MOE_CASES)
def test_moe_dispatch_and_out_match_reference(name, kw):
    """Dispatch integers equal to the reference's (drops where the
    capacity factor is small, none at cf = 4), out and aux within the
    stated bounds, on bfloat16 parameters and activations."""
    jc, tc = _configs(name, **kw)
    P, tp = _bf16_tree(jl.moe_template(jc), 3)
    xj, xt = _pair((4, 16, 64), 5)
    with jax.disable_jit():
        want = _ref_dispatch(P, xj, jc)
        yj, auxj = jl.apply_moe(P, xj, jc, groups=1)
    T = 4 * 16
    C = tl.moe_capacity(tc, T)
    assert C == want["C"]
    probs = torch.softmax((xt.reshape(T, 64) @ tp["router"]).float(), -1)
    got = tl.moe_dispatch(probs, tc.moe_top_k, C)
    for key in ("topi", "order", "keep", "dest", "tok"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    drops = int((~got["keep"]).sum())
    assert (drops > 0) == (tc.capacity_factor < 1.0), drops
    yt, auxt = tl.apply_moe(tp, xt, tc)
    assert yt.dtype == BF and auxt.dtype == torch.float32
    _close(yt, yj)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)


def test_moe_top_k_ties_take_the_lower_expert():
    """A tie in the router's probabilities goes to the lower expert, as
    ``jax.lax.top_k`` orders it (``torch.topk`` promises no order)."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                          [0.4, 0.1, 0.4, 0.1]])
    got = tl.moe_dispatch(probs, 2, 8)["topi"]
    want = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [[1, 2], [0, 1], [0, 2]]


def test_moe_combine_adds_in_expert_order():
    """The combine adds a token's k = 4 contributions in ascending expert
    order, one bfloat16 rounding each: equal to the reference's scatter-add
    on every element, while the top-k order (best first) differs from it
    somewhere, so the test can tell the two apart."""
    jc, tc = _configs(GRANITE, n_experts=8, moe_top_k=4,
                      capacity_factor=8.0)
    P, tp = _bf16_tree(jl.moe_template(jc), 7)
    xj, xt = _pair((4, 16, 64), 9, scale=3.0)
    with jax.disable_jit():
        yj, _ = jl.apply_moe(P, xj, jc, groups=1)
    yt, _ = tl.apply_moe(tp, xt, tc)
    np.testing.assert_array_equal(_np(yt), _np(yj))
    # the same contributions added best expert first
    T, d = 64, 64
    xf = xt.reshape(T, d)
    probs = torch.softmax((xf @ tp["router"]).float(), -1)
    r = tl.moe_dispatch(probs, 4, tl.moe_capacity(tc, T))
    w = r["topw"]
    act = tl.act_fn(tc)
    out = torch.zeros((T, d), dtype=BF)
    for j in range(4):
        e = r["topi"][:, j]
        h = act(torch.einsum("td,tdf->tf", xf, tp["w_gate"][e])) * \
            torch.einsum("td,tdf->tf", xf, tp["w_up"][e])
        y = torch.einsum("tf,tfd->td", h, tp["w_down"][e])
        out = out + (y * w[:, j:j + 1]).to(BF)
    assert not np.array_equal(_np(out), _np(yj).reshape(T, d))


# ------------------------------------------------- cross-attention ----

@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_cross_attention_matches_reference(mode):
    """The cross-attention sub-block of reduced llama-3.2-vision-11b (8
    image tokens): train and prefill project the cross source, decode
    reads ``ck`` / ``cv`` from the cache; the query takes no RoPE."""
    jc, tc = _configs(VISION)
    P, tp = _bf16_tree(jl.attn_template(jc, cross=True), 11)
    S = 1 if mode == "decode" else 12
    xj, xt = _pair((2, S, 64), 12)
    sj, st = _pair((2, 8, 64), 13)
    ckj, ckt = _pair((2, 8, 2, 16), 14)
    cvj, cvt = _pair((2, 8, 2, 16), 15)
    pos = np.full((2, S), 30, np.int32) if mode == "decode" else \
        np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    ctx_j = {"mode": mode, "positions": jnp.asarray(pos), "cross_src": sj,
             "cache_dtype": jnp.bfloat16}
    ctx_t = {"mode": mode, "positions": torch.from_numpy(pos.copy()),
             "cross_src": st}
    with jax.disable_jit():
        yj, nj = jm._cross_attention(P, xj, {"ck": ckj, "cv": cvj}, jc,
                                     ctx_j)
    yt, nt = tm._cross_attention(tp, xt, {"ck": ckt, "cv": cvt}, tc, ctx_t)
    _close(yt, yj)
    for key in ("ck", "cv"):
        assert nt[key].dtype == BF
        _close(nt[key], nj[key])
    if mode == "decode":
        assert nt["ck"] is ckt


def test_encoder_matches_reference():
    """Whisper's encoder (2 non-causal blocks over 16 frames, layernorm,
    gelu, no RoPE) and the forward that decodes on it."""
    jc, tc = _configs(WHISPER)
    with jax.threefry_partitionable(False):
        P = jinit(jm.model_template(jc), jax.random.key(17))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, P),
                           device="cpu")
    fj, ft = _pair((2, 16, 64), 18)
    bfj = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), P)
    with jax.disable_jit():
        want = jm._encode(bfj, jc, fj, {})
    got = tm._encode(tm.compute_params(tp), tc, ft)
    assert got.dtype == BF and got.shape == (2, 16, 64)
    _close(got, want)
    toks = np.random.default_rng(19).integers(0, 256, (2, 10)).astype(
        np.int32)
    with jax.disable_jit():
        lj = jm.forward(P, jc, jnp.asarray(toks), cross_src=fj)[0]
    lt, cache, aux = tm.forward(tp, tc, torch.from_numpy(toks), cross_src=ft)
    _close(lt, lj)
    assert cache is None and float(aux) == 0.0
    with pytest.raises(ValueError, match="cross_src"):
        tm.forward(tp, tc, torch.from_numpy(toks))


def test_attention_routes_by_mode_and_mask(monkeypatch):
    """Prefill's self-attention, the encoder and every cross-attention
    (decode's too: the mask does not depend on position) go through the
    flash wrapper; decode's self-attention over its cache goes by
    position. The route is chosen from the mode and the mask, not from
    whether the kernel succeeds."""
    calls = []
    flash, direct = tl.flash_attention, tl._attention_by_position

    def count_flash(q, k, v, *, causal, window):
        calls.append(("flash", q.shape[1], k.shape[1], causal))
        return flash(q, k, v, causal=causal, window=window)

    def count_direct(q, k, v, *a):
        calls.append(("direct", q.shape[1], k.shape[1], a[2]))
        return direct(q, k, v, *a)

    monkeypatch.setattr(tl, "flash_attention", count_flash)
    monkeypatch.setattr(tl, "_attention_by_position", count_direct)
    jc, tc = _configs(WHISPER)
    with jax.threefry_partitionable(False):
        P = jinit(jm.model_template(jc), jax.random.key(21))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, P),
                           device="cpu")
    toks = torch.from_numpy(np.random.default_rng(22).integers(
        0, 256, (2, 6)).astype(np.int32))
    _, ft = _pair((2, 16, 64), 23)
    _, cache = ts.make_prefill_step(tc)(tp, {"tokens": toks,
                                             "cross_src": ft})
    n_dec = tc.n_layers                     # xattn blocks (every layer)
    assert calls == [("flash", 16, 16, False)] * tc.n_encoder_layers + [
        ("flash", 6, 6, True), ("flash", 6, 16, False)] * n_dec
    calls.clear()
    ts.make_decode_step(tc)(tp, cache, toks[:, :1], torch.full((2,), 6))
    assert calls == [("direct", 1, 134, True), ("flash", 1, 16, False)] \
        * n_dec
    # explicit positions that are the index take the kernel's route; other
    # positions are masked by value with impl="direct" and raise under
    # "auto" (on either device: the route does not depend on it)
    calls.clear()
    q = torch.randn(2, 5, 4, 16)
    kv = torch.randn(2, 5, 2, 16)
    tl.attention(q, kv, kv, q_pos=torch.arange(5), k_pos=torch.arange(5))
    tl.attention(q, kv, kv, q_pos=torch.arange(5) + 3,
                 k_pos=torch.arange(5) + 3, impl="direct")
    tl.attention(q, kv, kv, q_pos=torch.arange(5) + 3, causal=False)
    assert [c[0] for c in calls] == ["flash", "direct", "flash"]
    with pytest.raises(ValueError, match="masks by index"):
        tl.attention(q, kv, kv, q_pos=torch.arange(5) + 3,
                     k_pos=torch.arange(5) + 3)
    # the train forward at positions other than the index: by position
    calls.clear()
    tm.forward(tp, tc, toks, cross_src=ft,
               positions=(torch.arange(6) + 3).expand(2, 6))
    assert [c[0] for c in calls] == ["flash"] * tc.n_encoder_layers + [
        "direct", "flash"] * n_dec
    # the reference's flash_xla and band routes (tiles checked) take the
    # kernel's; an unknown route or a malformed tile raises
    calls.clear()
    tl.attention(q, kv, kv, impl="band:4")
    tl.attention(q, kv, kv, impl="flash_xla:4:8")
    assert [c[0] for c in calls] == ["flash", "flash"]
    for bad in ("ring", "band:4:8", "flash_xla:0", "direct:4"):
        with pytest.raises(ValueError, match="impl"):
            tl.attention(q, kv, kv, impl=bad)


# ------------------------------------------------------------ encode ----

@pytest.mark.parametrize("name", [GRANITE, MIXTRAL, VISION, WHISPER])
def test_encode_matches_reference(name):
    """The embedding ``encode`` of the four architectures with MoE or
    cross-attention blocks at reduced size, on the reference's own
    parameters and projection; whisper and the VLM take the zero cross
    source stub."""
    kw = dict(model=name, reduced=True, seq_len=16, batch_size=8, seed=4)
    ec_j, ec_t = JEmbedConfig(**kw), EmbedConfig(**kw)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 256, (12, 16)).astype(np.int32)
    lengths = rng.integers(4, 17, 12).astype(np.int32)
    with jax.threefry_partitionable(False):
        P = jenc.model_params(ec_j)
        proj = np.asarray(jenc.projection(ec_j, 8))
        want = np.asarray(jenc.encode(ec_j, tokens, lengths, 8,
                                      shard=False))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, P),
                               device="cpu")
    got = tenc.encode(ec_t, tokens, lengths, 8, device="cpu", params=params,
                      proj=torch.from_numpy(proj.copy()))
    assert got.shape == (12, 8) and got.dtype == torch.float32
    _close(got, want, 3e-2, 0.3)
    cs = tenc._cross_src(tenc.resolved_config(ec_t), 3, "cpu")
    want_cs = jenc._cross_src(jenc.resolved_config(ec_j), 3)
    if want_cs is None:
        assert cs is None
    else:
        assert cs.dtype == BF and tuple(cs.shape) == want_cs.shape
        assert not bool(cs.any())


# -------------------------------------------------------- train step ----

def _ref_loss_grads(jc, P, batch):
    f = jax.value_and_grad(jstep.make_loss_fn(jc, remat=False,
                                              attn_impl="direct"),
                           has_aux=True)
    with jax.disable_jit():
        (_, m), g = f(P, {k: jnp.asarray(v) for k, v in batch.items()})
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(g)], m


@pytest.mark.parametrize("name", [GRANITE, WHISPER])
def test_train_step_loss_aux_and_grads_match_reference(name):
    """Loss, aux and every gradient leaf of the train step's loss (B = 2,
    S = 16, one target ignored; whisper with 16 encoder frames) against
    ``jax.value_and_grad`` of the reference's, with remat on and off in
    the port (equal)."""
    jc, tc = _configs(name)
    with jax.threefry_partitionable(False):
        P = jinit(jm.model_template(jc), jax.random.key(25))
    Pn = jax.tree_util.tree_map(np.asarray, P)
    rng = np.random.default_rng(26)
    toks = rng.integers(0, 256, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :16], "targets": toks[:, 1:].copy()}
    batch["targets"][0, 3] = -1
    if name == WHISPER:
        batch["cross_src"] = rng.normal(size=(2, 16, 64)).astype(np.float32)
    want_g, m = _ref_loss_grads(jc, P, batch)
    got = []
    for remat in (False, True):
        tp = params_from_numpy(Pn, device="cpu")
        req = [t.requires_grad_(True) for t in leaves(tp, torch.is_tensor)]
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        if "cross_src" in tb:
            tb["cross_src"] = tb["cross_src"].to(BF)
        total, mt = ts.make_loss_fn(tc, remat=remat)(tp, tb)
        got.append((torch.autograd.grad(total, req), mt))
    assert all(torch.equal(a, b) for a, b in zip(got[0][0], got[1][0]))
    grads, mt = got[0]
    mt = {k: float(v.detach()) for k, v in mt.items()}
    assert abs(mt["loss"] - float(m["loss"])) <= 5e-4
    assert abs(mt["aux"] - float(m["aux"])) <= 5e-4
    if name == GRANITE:
        assert mt["aux"] > 0
    assert len(grads) == len(want_g)
    for i, (a, b) in enumerate(zip(grads, want_g)):
        a = a.numpy()
        assert a.shape == b.shape
        nb = np.linalg.norm(b)
        if nb == 0:
            assert np.linalg.norm(a) == 0, i
            continue
        rel = np.linalg.norm(a - b) / nb
        cos = float((a * b).sum() / (np.linalg.norm(a) * nb))
        assert rel <= 5e-2 and cos >= 0.999, (i, a.shape, rel, cos)
