"""Model assembly (port of ``src/repro/models/model.py``): embedding ->
stacked layer groups -> unrolled tail -> final norm -> hidden states or
logits; one :func:`forward` for training (no cache), prefill (builds the
cache) and decode (reads and updates it).

Parameters are the reference's tree (see :mod:`repro_torch.models.params`):
``groups`` holds the repeating group's blocks stacked on a leading
``n_full`` axis and runs as a loop over that axis; ``tail`` holds the
non-tiling remainder (recurrentgemma's 26 = 8 * 3 + 2) and runs unrolled;
an encoder-decoder (whisper) adds the stacked ``encoder`` and its
``enc_norm``. Float32 master parameters are cast to bfloat16 at use;
norms, softmax and the recurrences compute in float32 inside.

All six block kinds run: ``attn``, ``xattn`` (self-attention, then
cross-attention to ``cross_src``: image tokens, or the encoder's output),
``moe``, ``rglru``, ``mlstm`` and ``slstm``. Caches are the reference's:
per attention block bfloat16 ``k`` / ``v`` of (B, C, Hkv, D) and int32
``pos`` (-1 in an empty slot), ``ck`` / ``cv`` for the cross source, the
recurrent blocks' states; the groups' caches stacked like their
parameters. Prefill attends by index through the flash kernel; decode
attends over its cache slots by position (the reference's ``direct``
route), and its cross-attention, whose mask does not depend on position,
through the flash kernel.

The reference's ``constrain``, ``mesh``, ``moe_groups``, ``opt`` and
``attn_impl`` arguments shard or retune the computation over a device
mesh; on one card they have nothing to do and stay with the multi-device
work (ROADMAP A13b).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import full_fp32, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models.params import (
    PSpec, leaves, tree_map, tree_stack_template, with_leaves,
)

MODES = ("train", "prefill", "decode")


def block_template(cfg, kind):
    if kind == "attn":
        return {"attn": L.attn_template(cfg), "mlp": L.mlp_template(cfg)}
    if kind == "xattn":
        return {"attn": L.attn_template(cfg),
                "xattn": L.attn_template(cfg, cross=True),
                "mlp": L.mlp_template(cfg)}
    if kind == "moe":
        return {"attn": L.attn_template(cfg), "moe": L.moe_template(cfg)}
    if kind == "mlstm":
        return {"mlstm": R.mlstm_template(cfg)}
    if kind == "slstm":
        return {"slstm": R.slstm_template(cfg)}
    if kind == "rglru":
        return {"rglru": R.rglru_template(cfg), "mlp": L.mlp_template(cfg)}
    raise ValueError(kind)


def model_template(cfg):
    group, n_full, rem = cfg.layer_groups()
    t = {
        "embed": PSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                       "embed"),
        "final_norm": L.norm_template(cfg.d_model, cfg.norm),
        "groups": tree_stack_template(
            tuple(block_template(cfg, k) for k in group), n_full),
        "tail": tuple(block_template(cfg, k) for k in rem),
    }
    if not cfg.tie_embeddings:
        t["unembed"] = PSpec((cfg.d_model, cfg.vocab_size),
                             ("embed", "vocab"))
    if cfg.is_encoder_decoder:
        t["encoder"] = tree_stack_template(
            (block_template(cfg, "attn"),), cfg.n_encoder_layers)
        t["enc_norm"] = L.norm_template(cfg.d_model, cfg.norm)
    return t


# -------------------------------------------------------------- caches ----

def cache_len(cfg, ctx_len: int) -> int:
    """Slots per attention cache: the context and 128 generated tokens,
    at most the window."""
    full = ctx_len + 128
    return min(cfg.window, full) if cfg.window > 0 else full


def init_block_cache(cfg, kind, batch, ctx_len, dtype=torch.bfloat16, *,
                     device):
    """The empty cache of one block on ``device``."""
    C = cache_len(cfg, ctx_len)
    kvshape = (cfg.n_kv_heads, cfg.head_dim)

    def kv():
        return {"k": torch.zeros((batch, C) + kvshape, dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, C) + kvshape, dtype=dtype,
                                 device=device),
                "pos": torch.full((batch, C), -1, dtype=torch.int32,
                                  device=device)}

    if kind in ("attn", "moe"):
        return kv()
    if kind == "xattn":
        n_cross = (cfg.encoder_seq if cfg.is_encoder_decoder
                   else cfg.n_img_tokens)
        c = kv()
        for key in ("ck", "cv"):
            c[key] = torch.zeros((batch, n_cross) + kvshape, dtype=dtype,
                                 device=device)
        return c
    if kind == "mlstm":
        return R.mlstm_init_state(cfg, batch, dtype, device=device)
    if kind == "slstm":
        return R.slstm_init_state(cfg, batch, dtype, device=device)
    if kind == "rglru":
        return R.rglru_init_state(cfg, batch, dtype, device=device)
    raise ValueError(kind)


def init_cache(cfg, batch, ctx_len, dtype=torch.bfloat16, *, device="cuda"):
    """The empty cache of the whole model on ``device`` (the card unless
    told otherwise; raises without one): ``groups`` stacked on a leading
    ``n_full`` axis, ``tail`` a tuple."""
    dev = resolve_device(device)
    group, n_full, rem = cfg.layer_groups()
    gc = tuple(init_block_cache(cfg, k, batch, ctx_len, dtype, device=dev)
               for k in group)
    stacked = tree_map(
        lambda t: t[None].repeat((n_full,) + (1,) * t.dim()), gc,
        is_leaf=torch.is_tensor)
    tail = tuple(init_block_cache(cfg, k, batch, ctx_len, dtype, device=dev)
                 for k in rem)
    return {"groups": stacked, "tail": tail}


# -------------------------------------------------------------- blocks ----

def _self_attention(p, x, cache, cfg, ctx):
    """Pre-norm self-attention sub-block. Returns (x, new cache or None).

    train / prefill: attention through the flash kernel when the positions
    are the index (``ctx["positions"]`` None or ``arange(S)``), by position
    otherwise; prefill keeps the
    keys and values in C = :func:`cache_len` slots, padded at the back, or
    the last C entries rolled so that position p sits in slot p % C.
    decode (S == 1): writes slot ``pos % C`` of each row, then attends
    over the slots by position."""
    B, S, _ = x.shape
    h = L.apply_norm(p["norm"], x, cfg.norm, cfg.norm_eps)
    q, k, v = L._proj_qkv(p, h, cfg)
    pos = ctx.get("positions")
    q_pos = (torch.arange(S, dtype=torch.int32, device=x.device)
             if pos is None else pos)
    q = L.rope(q, q_pos, cfg.rope_theta)
    k = L.rope(k, q_pos, cfg.rope_theta)
    mode = ctx["mode"]
    new = None
    if mode == "decode":
        C = cache["k"].shape[1]
        slot = (pos[:, 0] % C).long()
        bidx = torch.arange(B, device=x.device)
        kk, vv, pp = cache["k"].clone(), cache["v"].clone(), \
            cache["pos"].clone()
        kk[bidx, slot] = k[:, 0].to(kk.dtype)
        vv[bidx, slot] = v[:, 0].to(vv.dtype)
        pp[bidx, slot] = pos[:, 0].to(pp.dtype)
        new = {"k": kk, "v": vv, "pos": pp}
        o = L.attention(q, kk.to(v.dtype), vv.to(v.dtype), q_pos=pos,
                        k_pos=pp, causal=True, window=cfg.window,
                        impl="direct")
    else:
        # positions other than the index are masked by value
        impl = ("auto" if pos is None or L._is_index(pos, S)
                else "direct")
        o = L.attention(q, k, v, q_pos=pos, k_pos=pos, causal=True,
                        window=cfg.window, impl=impl)
        if mode == "prefill":
            C = cache_len(cfg, ctx["ctx_len"])
            pp = q_pos.to(torch.int32).expand(B, S)
            if C >= S:                        # everything, padded at the back
                pad = lambda t: torch.cat([t, t.new_zeros(
                    (B, C - S) + tuple(t.shape[2:]))], 1)
                new = {"k": pad(k).to(torch.bfloat16),
                       "v": pad(v).to(torch.bfloat16),
                       "pos": torch.cat([pp, pp.new_full((B, C - S), -1)],
                                        1)}
            else:                             # the last C entries, a ring
                shift = (S - C) % C
                roll = lambda t: torch.roll(t[:, S - C:], shift, dims=1)
                new = {"k": roll(k).to(torch.bfloat16),
                       "v": roll(v).to(torch.bfloat16), "pos": roll(pp)}
    o = o.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return x + o @ p["wo"], new


def _cross_attention(p, x, cache, cfg, ctx):
    """Pre-norm cross-attention to the cross source (no RoPE, no bias on
    the query, no mask). decode reads ``ck`` / ``cv`` from the cache;
    train and prefill project ``ctx["cross_src"]``. Returns (x, {"ck",
    "cv"})."""
    B, S, _ = x.shape
    h = L.apply_norm(p["norm"], x, cfg.norm, cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if ctx["mode"] == "decode":
        ck, cv = cache["ck"].to(x.dtype), cache["cv"].to(x.dtype)
        new = {"ck": cache["ck"], "cv": cache["cv"]}
    else:
        src = ctx["cross_src"]
        if src is None:
            raise ValueError(f"{cfg.name} cross-attends: pass cross_src")
        T = src.shape[1]
        ck = (src @ p["wk"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        cv = (src @ p["wv"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        new = {"ck": ck.to(torch.bfloat16), "cv": cv.to(torch.bfloat16)}
    o = L.attention(q, ck, cv, causal=False, window=0)
    return x + o.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"], new


def apply_block(p, kind, x, cache, cfg, ctx):
    """One block. ``cache`` is the block's cache (decode) or None;
    ``ctx`` holds ``mode`` (train, prefill or decode), ``positions`` (None
    for the index; (B, 1) int32 in decode), ``cross_src``, ``ctx_len``
    (prefill) and ``mlstm_impl`` (``"chunked"``, or the sequential oracle
    ``"seq"``). Returns (x, new cache or None, float32 aux loss). The
    xLSTM blocks are pre-norm with a residual and no MLP."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    c = cache or {}
    if kind in ("attn", "moe", "xattn"):
        x, new = _self_attention(p["attn"], x, c, cfg, ctx)
        if kind == "xattn":
            x, cross_new = _cross_attention(p["xattn"], x, c, cfg, ctx)
            if ctx["mode"] != "train":
                new = {**new, **cross_new}
        if kind == "moe":
            h = L.apply_norm(p["moe"]["norm"], x, cfg.norm, cfg.norm_eps)
            y, aux = L.apply_moe(p["moe"], h, cfg)
        else:
            h = L.apply_norm(p["mlp"]["norm"], x, cfg.norm, cfg.norm_eps)
            y = L.apply_mlp(p["mlp"], h, cfg)
        return x + y, new, aux
    B = x.shape[0]
    if kind == "mlstm":
        st = c or R.mlstm_init_state(cfg, B, device=x.device)
        h = L.apply_norm(p["mlstm"]["norm"], x, cfg.norm, cfg.norm_eps)
        y, st = R.apply_mlstm(p["mlstm"], h, st, cfg,
                              impl=ctx.get("mlstm_impl", "chunked"))
        return x + y, st, aux
    if kind == "slstm":
        st = c or R.slstm_init_state(cfg, B, device=x.device)
        h = L.apply_norm(p["slstm"]["norm"], x, cfg.norm, cfg.norm_eps)
        y, st = R.apply_slstm(p["slstm"], h, st, cfg)
        return x + y, st, aux
    if kind == "rglru":
        st = c or R.rglru_init_state(cfg, B, dtype=x.dtype, device=x.device)
        h = L.apply_norm(p["rglru"]["norm"], x, cfg.norm, cfg.norm_eps)
        y, st = R.apply_rglru(p["rglru"], h, st, cfg)
        x = x + y
        h = L.apply_norm(p["mlp"]["norm"], x, cfg.norm, cfg.norm_eps)
        return x + L.apply_mlp(p["mlp"], h, cfg), st, aux
    raise ValueError(kind)


def compute_params(params, dtype=torch.bfloat16):
    """The parameter tree with float32 leaves cast to ``dtype`` (what
    ``forward`` does at use; cast once to reuse across calls)."""
    return tree_map(lambda t: t.to(dtype) if t.dtype == torch.float32
                    else t, params, is_leaf=torch.is_tensor)


def _unstack(groups, n):
    """The stacked ``groups`` tree as ``n`` trees, one per group (``unbind``
    views: the backward stacks their gradients once)."""
    parts = [t.unbind(0) for t in leaves(groups, torch.is_tensor)]
    return [with_leaves(groups, [p[gi] for p in parts]) for gi in range(n)]


def _stack(trees):
    """Trees of one structure as one tree stacked on a leading axis."""
    parts = [leaves(t, torch.is_tensor) for t in trees]
    return with_leaves(trees[0], [torch.stack(ls) for ls in zip(*parts)])


def _group_body(x, aux, gp, gc, group, cfg, ctx):
    """One stacked group: returns (x, aux, the blocks' new caches; None in
    train mode)."""
    new = []
    for i, kind in enumerate(group):
        x, nc, a = apply_block(gp[i], kind, x, None if gc is None else gc[i],
                               cfg, ctx)
        aux = aux + a
        new.append(nc)
    return x, aux, (None if ctx["mode"] == "train" else tuple(new))


def _encode(params, cfg, frames):
    """The whisper-style encoder over (B, T, d) frame embeddings (the conv
    front end is a stub): stacked non-causal attention blocks without
    RoPE, then ``enc_norm``."""
    B, T, _ = frames.shape
    x = frames
    for (p,) in _unstack(params["encoder"], cfg.n_encoder_layers):
        h = L.apply_norm(p["attn"]["norm"], x, cfg.norm, cfg.norm_eps)
        q, k, v = L._proj_qkv(p["attn"], h, cfg)
        o = L.attention(q, k, v, causal=False, window=0)
        x = x + o.reshape(B, T, cfg.n_heads * cfg.head_dim) @ p["attn"]["wo"]
        h = L.apply_norm(p["mlp"]["norm"], x, cfg.norm, cfg.norm_eps)
        x = x + L.apply_mlp(p["mlp"], h, cfg)
    return L.apply_norm(params["enc_norm"], x, cfg.norm, cfg.norm_eps)


def forward(params, cfg, tokens, *, mode="train", positions=None,
            cache=None, cross_src=None, logits_mode="all", remat=False,
            mlstm_impl="chunked"):
    """tokens (B, S) int -> (out, new cache, aux loss).

    ``out`` is the hidden states (B, S, d) float32 (``logits_mode=
    "hidden"``) or the logits (B, S, V) / (B, 1, V) float32 (``"all"`` /
    ``"last"``); ``new cache`` is None in train mode, else the tree
    :func:`init_cache` describes; ``aux`` is the float32 sum of the MoE
    blocks' load-balancing losses (0 without MoE). ``mode`` is ``train``
    (no cache), ``prefill`` (builds the cache for a context of S tokens)
    or ``decode`` (S == 1: ``positions`` (B,) int, the token's position in
    each row, and the ``cache`` to read; the cache given is not changed).
    ``positions`` (B, S) in train / prefill replaces the index.
    ``cross_src`` (B, T, d) is the cross-attending models' source: image
    tokens, or frames that an encoder-decoder first encodes (train and
    prefill; decode reads the cache). ``remat`` recomputes each stacked
    group in the backward instead of keeping its activations (the same
    numbers either way); ``mlstm_impl`` is the mLSTM's form (``"chunked"``,
    or the sequential oracle ``"seq"``), as in the reference. A backward
    through it runs outside this function, so callers wrap it in
    :func:`repro_torch.device.full_fp32` as well."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if logits_mode not in ("all", "last", "hidden"):
        raise ValueError(f"logits_mode must be all, last or hidden, got "
                         f"{logits_mode!r}")
    if mode == "decode" and (positions is None or cache is None):
        raise ValueError("decode takes positions (B,) and a cache")
    B, S = tokens.shape
    group, n_full, rem = cfg.layer_groups()
    params = compute_params(params)
    if positions is not None:
        positions = torch.as_tensor(positions, dtype=torch.int32,
                                    device=tokens.device)
        if positions.dim() == 1:
            positions = positions[:, None]            # decode (B, 1)
    ctx = {"mode": mode, "positions": positions, "cross_src": cross_src,
           "ctx_len": S if mode == "prefill" else None,
           "mlstm_impl": mlstm_impl}
    with full_fp32():
        if cfg.is_encoder_decoder and mode != "decode":
            if cross_src is None:
                raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                                 "cross_src")
            ctx["cross_src"] = _encode(params, cfg, cross_src)
        x = params["embed"][tokens.long()].to(torch.bfloat16)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        gcs = (_unstack(cache["groups"], n_full) if cache is not None
               else [None] * n_full)
        new_groups = []
        for gp, gc in zip(_unstack(params["groups"], n_full), gcs):
            if remat:
                x, aux, nc = checkpoint(
                    _group_body, x, aux, gp, gc, group, cfg, ctx,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                x, aux, nc = _group_body(x, aux, gp, gc, group, cfg, ctx)
            new_groups.append(nc)
        new_tail = []
        for i, kind in enumerate(rem):
            x, nc, a = apply_block(
                params["tail"][i], kind, x,
                None if cache is None else cache["tail"][i], cfg, ctx)
            aux = aux + a
            new_tail.append(nc)
        new_cache = None
        if mode != "train":
            new_cache = {"groups": _stack(new_groups),
                         "tail": tuple(new_tail)}
        x = L.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        if logits_mode == "hidden":
            return x.to(torch.float32), new_cache, aux
        if logits_mode == "last":
            x = x[:, -1:]
        unembed = params.get("unembed")
        if unembed is None:
            unembed = params["embed"].T
        return (x @ unembed.to(x.dtype)).to(torch.float32), new_cache, aux
