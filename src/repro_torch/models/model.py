"""Model assembly (port of ``src/repro/models/model.py``): embedding ->
stacked layer groups -> unrolled tail -> final norm -> hidden states or
logits.

Parameters are the reference's tree (see :mod:`repro_torch.models.params`):
``groups`` holds the repeating group's blocks stacked on a leading
``n_full`` axis and runs as a loop over that axis; ``tail`` holds the
non-tiling remainder (recurrentgemma's 26 = 8 * 3 + 2) and runs unrolled.
Float32 master parameters are cast to bfloat16 at use; norms, softmax and
the recurrence compute in float32 inside.

Ported: the ``attn``, ``rglru``, ``mlstm`` and ``slstm`` blocks
(recurrentgemma-2b and xlstm-125m) and ``forward(mode="train")`` with
``logits_mode`` hidden, all or last, ``mlstm_impl`` chunked or seq, and
``remat`` (each stacked group's body under ``torch.utils.checkpoint``, the
counterpart of the reference's ``jax.checkpoint(group_body)``). Not yet:
``prefill`` / ``decode`` and their caches (ROADMAP A12c), the ``moe`` and
``xattn`` blocks and the encoder-decoder (A12d); they raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import full_fp32
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models.params import (
    PSpec, leaves, tree_map, tree_stack_template, with_leaves,
)

BLOCK_KINDS = ("attn", "rglru", "mlstm", "slstm")


def _check_kind(kind):
    if kind not in BLOCK_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP A12d; the "
            f"port runs {', '.join(BLOCK_KINDS)})")


def block_template(cfg, kind):
    _check_kind(kind)
    if kind == "attn":
        return {"attn": L.attn_template(cfg), "mlp": L.mlp_template(cfg)}
    if kind == "mlstm":
        return {"mlstm": R.mlstm_template(cfg)}
    if kind == "slstm":
        return {"slstm": R.slstm_template(cfg)}
    return {"rglru": R.rglru_template(cfg), "mlp": L.mlp_template(cfg)}


def model_template(cfg):
    if cfg.is_encoder_decoder:
        raise NotImplementedError("the encoder-decoder is not ported yet "
                                  "(ROADMAP A12d)")
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
    return t


def _self_attention(p, x, cfg):
    """Pre-norm self-attention sub-block, train mode (positions = index)."""
    B, S, _ = x.shape
    h = L.apply_norm(p["norm"], x, cfg.norm, cfg.norm_eps)
    q, k, v = L._proj_qkv(p, h, cfg)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)
    o = L.attention(q, k, v, causal=True, window=cfg.window)
    return x + o.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]


def apply_block(p, kind, x, cfg, mlstm_impl="chunked"):
    """One block in train mode (no cache) from the empty state. Returns x.
    The xLSTM blocks are pre-norm with a residual and no MLP;
    ``mlstm_impl`` picks the mLSTM's form (``"chunked"`` or the sequential
    oracle ``"seq"``)."""
    _check_kind(kind)
    if kind in ("mlstm", "slstm"):
        h = L.apply_norm(p[kind]["norm"], x, cfg.norm, cfg.norm_eps)
        if kind == "mlstm":
            st = R.mlstm_init_state(cfg, x.shape[0], device=x.device)
            y, _ = R.apply_mlstm(p["mlstm"], h, st, cfg, impl=mlstm_impl)
        else:
            st = R.slstm_init_state(cfg, x.shape[0], device=x.device)
            y, _ = R.apply_slstm(p["slstm"], h, st, cfg)
        return x + y
    if kind == "attn":
        x = _self_attention(p["attn"], x, cfg)
    else:
        st = R.rglru_init_state(cfg, x.shape[0], dtype=x.dtype,
                                device=x.device)
        h = L.apply_norm(p["rglru"]["norm"], x, cfg.norm, cfg.norm_eps)
        y, _ = R.apply_rglru(p["rglru"], h, st, cfg)
        x = x + y
    h = L.apply_norm(p["mlp"]["norm"], x, cfg.norm, cfg.norm_eps)
    return x + L.apply_mlp(p["mlp"], h, cfg)


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


def _group_body(x, gp, group, cfg, mlstm_impl):
    for i, kind in enumerate(group):
        x = apply_block(gp[i], kind, x, cfg, mlstm_impl)
    return x


def forward(params, cfg, tokens, *, mode="train", logits_mode="all",
            remat=False, mlstm_impl="chunked"):
    """tokens (B, S) int -> hidden states (B, S, d) float32
    (``logits_mode="hidden"``) or logits (B, S, V) / (B, 1, V) float32
    (``"all"`` / ``"last"``). Train mode only: positions are the index.
    ``remat`` recomputes each stacked group in the backward instead of
    keeping its activations (the same numbers either way); ``mlstm_impl``
    is the mLSTM's form (``"chunked"``, or the sequential oracle
    ``"seq"``), as in the reference. A backward
    through it runs outside this function, so callers wrap it in
    :func:`repro_torch.device.full_fp32` as well."""
    if mode != "train":
        raise NotImplementedError(f"forward mode {mode!r} (prefill/decode "
                                  "caches) is not ported yet (ROADMAP A12c)")
    if logits_mode not in ("all", "last", "hidden"):
        raise ValueError(f"logits_mode must be all, last or hidden, got "
                         f"{logits_mode!r}")
    if cfg.is_encoder_decoder or cfg.cross_attn_every:
        raise NotImplementedError("cross-attention models are not ported "
                                  "yet (ROADMAP A12d)")
    group, n_full, rem = cfg.layer_groups()
    params = compute_params(params)
    with full_fp32():
        x = params["embed"][tokens.long()].to(torch.bfloat16)
        for gp in _unstack(params["groups"], n_full):
            if remat:
                x = checkpoint(_group_body, x, gp, group, cfg, mlstm_impl,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = _group_body(x, gp, group, cfg, mlstm_impl)
        for i, kind in enumerate(rem):
            x = apply_block(params["tail"][i], kind, x, cfg, mlstm_impl)
        x = L.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        if logits_mode == "hidden":
            return x.to(torch.float32)
        if logits_mode == "last":
            x = x[:, -1:]
        unembed = params.get("unembed")
        if unembed is None:
            unembed = params["embed"].T
        return (x @ unembed.to(x.dtype)).to(torch.float32)
