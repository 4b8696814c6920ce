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

On a mesh (``mesh=``, an :class:`~repro_torch.launch.mesh.LMMesh`) the
parameters rest as :class:`~repro_torch.distributed.sharding.Sharded`
leaves laid out by the sharding rules, the batch splits over the ``data``
axis, and each data group runs its rows on its lead slot's device, a
block's weights gathered there just before the block (and, under remat,
again in the backward). The MoE block takes the reference's ``shard_map``
island (:func:`repro_torch.models.layers._moe_island`) under the
reference's condition, and otherwise dispatches all tokens at once on the
mesh's lead device, as the reference's global ``apply_moe`` does. Sums
over slots run in slot order, so a run repeats bit for bit.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import full_fp32, resolve_device
from repro_torch.distributed.sharding import (
    Constrain, gather_copies, is_sharded, param_pspecs, put,
)
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
    return _init_cache(cfg, batch, ctx_len, dtype, resolve_device(device))


def _init_cache(cfg, batch, ctx_len, dtype, dev):
    """:func:`init_cache` on ``dev`` (a ``meta`` device too: the abstract
    decode cache)."""
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

    train / prefill: attention on the route ``ctx["attn_impl"]`` when the
    positions are the index (``ctx["positions"]`` None or ``arange(S)``),
    by position otherwise; prefill keeps the
    keys and values in C = :func:`cache_len` slots, padded at the back, or
    the last C entries rolled so that position p sits in slot p % C.
    decode (S == 1): writes slot ``pos % C`` of each row, then attends
    over the slots by position. ``ctx["opt"]`` holds the reference's
    flags: ``attn_bf16`` (:func:`layers.attention`'s ``mixed``),
    ``attn_head_shard`` (q, k, v and the output through the
    activation-sharding hook ``ctx["cons"]``) and ``ar_bf16`` (the output
    projection rounded to bfloat16 before the residual add)."""
    B, S, _ = x.shape
    opt = ctx.get("opt", ())
    cons = ctx.get("cons")
    mixed = "attn_bf16" in opt
    h = L.apply_norm(p["norm"], x, cfg.norm, cfg.norm_eps)
    q, k, v = L._proj_qkv(p, h, cfg)
    pos = ctx.get("positions")
    q_pos = (torch.arange(S, dtype=torch.int32, device=x.device)
             if pos is None else pos)
    q = L.rope(q, q_pos, cfg.rope_theta)
    k = L.rope(k, q_pos, cfg.rope_theta)
    if "attn_head_shard" in opt and cons is not None:
        q = cons(q, ("batch", "seq", "heads_act", "head_dim"))
        k = cons(k, ("batch", "seq", "kv_act", "head_dim"))
        v = cons(v, ("batch", "seq", "kv_act", "head_dim"))
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
                        impl="direct", mixed=mixed)
    else:
        # positions other than the index are masked by value
        impl = (ctx.get("attn_impl", "auto")
                if pos is None or L._is_index(pos, S) else "direct")
        o = L.attention(q, k, v, q_pos=pos, k_pos=pos, causal=True,
                        window=cfg.window, impl=impl, mixed=mixed)
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
    if "attn_head_shard" in opt and cons is not None:
        o = cons(o, ("batch", "seq", "heads_act", "head_dim"))
    y = o.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    if "ar_bf16" in opt:
        y = y.to(torch.bfloat16)
    return x + y, new


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
    (prefill), ``mlstm_impl`` (``"chunked"``, or the sequential oracle
    ``"seq"``), ``attn_impl``, ``cons`` (the activation-sharding hook or
    None) and ``opt`` (the reference's flags: ``ar_bf16`` also rounds the
    MLP's output to bfloat16 before the residual add, ``rnn_local`` passes
    the sLSTM's gate pre-activations through ``cons``). The MoE block
    dispatches all tokens at once (the mesh's island is
    :func:`_mesh_moe`'s). Returns (x, new cache or None, float32 aux
    loss). The xLSTM blocks are pre-norm with a residual and no MLP."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    c = cache or {}
    opt = ctx.get("opt", ())
    if kind in ("attn", "moe", "xattn"):
        x, new = _self_attention(p["attn"], x, c, cfg, ctx)
        if kind == "xattn":
            x, cross_new = _cross_attention(p["xattn"], x, c, cfg, ctx)
            if ctx["mode"] != "train":
                new = {**new, **cross_new}
        if kind == "moe":
            h = L.apply_norm(p["moe"]["norm"], x, cfg.norm, cfg.norm_eps)
            y, aux = L.apply_moe(p["moe"], h, cfg, cons=ctx.get("cons"),
                                 groups=1)
        else:
            h = L.apply_norm(p["mlp"]["norm"], x, cfg.norm, cfg.norm_eps)
            y = L.apply_mlp(p["mlp"], h, cfg)
            if "ar_bf16" in opt:
                y = y.to(torch.bfloat16)
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
        y, st = R.apply_slstm(p["slstm"], h, st, cfg, cons=ctx.get("cons"),
                              local="rnn_local" in opt)
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
    views, of a Sharded leaf's pieces too: the backward stacks their
    gradients once)."""
    parts = [t.unbind(0) for t in leaves(groups, torch.is_tensor)]
    return [with_leaves(groups, [p[gi] for p in parts]) for gi in range(n)]


def _stack(trees):
    """Trees of one structure as one tree stacked on a leading axis."""
    parts = [leaves(t, torch.is_tensor) for t in trees]
    return with_leaves(trees[0], [torch.stack(ls) for ls in zip(*parts)])


def _enc_block(p, x, cfg):
    """One whisper-style encoder block: non-causal attention without RoPE,
    then the MLP."""
    B, T, _ = x.shape
    h = L.apply_norm(p["attn"]["norm"], x, cfg.norm, cfg.norm_eps)
    q, k, v = L._proj_qkv(p["attn"], h, cfg)
    o = L.attention(q, k, v, causal=False, window=0)
    x = x + o.reshape(B, T, cfg.n_heads * cfg.head_dim) @ p["attn"]["wo"]
    h = L.apply_norm(p["mlp"]["norm"], x, cfg.norm, cfg.norm_eps)
    return x + L.apply_mlp(p["mlp"], h, cfg)


def _encode(params, cfg, frames, g=None):
    """The whisper-style encoder over (B, T, d) frame embeddings (the conv
    front end is a stub): stacked non-causal attention blocks without
    RoPE, then ``enc_norm``. With ``g`` (:class:`_Groups`) ``frames`` is
    the data groups' list, and so is the result."""
    if g is None:
        one = _Groups(None, frames.shape[0], frames.dtype, frames.device)
        return _encode(params, cfg, [frames], one)[0]
    fs = list(frames)
    for (p,) in _unstack(params["encoder"], cfg.n_encoder_layers):
        ps = g.fetch(p)
        fs = [_enc_block(ps[i], f, cfg) for i, f in enumerate(fs)]
    pn = g.fetch(params["enc_norm"])
    return [L.apply_norm(pn[i], f, cfg.norm, cfg.norm_eps)
            for i, f in enumerate(fs)]


def _check_args(mode, logits_mode, positions, cache, compute_dtype):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if logits_mode not in ("all", "last", "hidden"):
        raise ValueError(f"logits_mode must be all, last or hidden, got "
                         f"{logits_mode!r}")
    if mode == "decode" and (positions is None or cache is None):
        raise ValueError("decode takes positions (B,) and a cache")
    if compute_dtype not in (None, torch.bfloat16, torch.float32):
        raise ValueError(f"compute_dtype must be bfloat16, float32 or None, "
                         f"got {compute_dtype}")


def forward(params, cfg, tokens, *, mode="train", positions=None,
            cache=None, cross_src=None, logits_mode="all", remat=False,
            attn_impl="auto", mlstm_impl="chunked", constrain=None,
            compute_dtype=torch.bfloat16, moe_groups=1, mesh=None, opt=()):
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
    :func:`repro_torch.device.full_fp32` as well.

    The reference's other arguments: ``attn_impl`` is the train and
    prefill self-attention's route (:func:`layers.attention`);
    ``constrain`` the activation-sharding hook
    (:func:`repro_torch.distributed.sharding.make_constrain`), called where
    the reference calls it; ``opt`` its flags (``attn_bf16``,
    ``attn_head_shard``, ``ar_bf16``, ``rnn_local``: see
    :func:`_self_attention` and :func:`apply_block`); ``compute_dtype`` the
    dtype float32 masters are cast to at use (``None`` or float32 keeps
    them: the bfloat16 embedding rows are then widened to float32 at once,
    where the reference widens them at the first product). With ``mesh``
    the forward runs over the mesh (see the module docstring and
    :func:`forward_groups`); the MoE blocks take the reference's island
    when ``B % max(moe_groups, 1) == 0``. The out is gathered onto the
    mesh's lead device and the cache is the list of the data groups'
    caches."""
    outs, caches, aux = forward_groups(
        params, cfg, tokens, mesh=mesh, mode=mode, positions=positions,
        cache=cache if mesh is not None or cache is None else [cache],
        cross_src=cross_src, logits_mode=logits_mode, remat=remat,
        attn_impl=attn_impl, mlstm_impl=mlstm_impl, constrain=constrain,
        compute_dtype=compute_dtype, moe_groups=moe_groups, opt=opt)
    if mesh is None:
        return outs[0], caches and caches[0], aux
    return mesh.all_gather(outs, "data", 0, mesh.lead), caches, aux


class _Groups:
    """The data groups of a forward. Without a mesh: one group of all
    ``B`` rows on ``device``. On one: ``mesh.shape["data"]`` groups of
    ``rows`` rows, group i on its lead slot's device ``devs[i]``."""

    def __init__(self, mesh, B, cd, device=None):
        self.mesh, self.cd = mesh, cd
        if mesh is None:
            self.n, self.rows, self.devs = 1, B, [torch.device(device)]
            return
        nd = mesh.shape["data"]
        if B % nd:
            raise ValueError(f"the batch of {B} rows does not split over "
                             f"data={nd} (the mesh's data groups)")
        self.n, self.rows = nd, B // nd
        self.devs = [mesh.devices[i][0] for i in range(nd)]

    def split(self, t):
        """Group i's rows of ``t`` on its device (None stays None)."""
        if t is None:
            return [None] * self.n
        r = self.rows
        return [t[i * r:(i + 1) * r].to(d) for i, d in enumerate(self.devs)]

    def fetch(self, tree, devs=None):
        """Per target device (default: the groups'), ``tree`` with its
        Sharded leaves gathered whole there (differentiable) and float32
        leaves cast to the compute dtype. Without a mesh ``tree`` itself:
        its weights were cast once, up front."""
        devs = self.devs if devs is None else devs
        if self.mesh is None:
            return [tree] * len(devs)
        copies = [gather_copies(x, [(d, None) for d in devs])
                  for x in leaves(tree, torch.is_tensor)]
        cast = lambda t: t.to(self.cd) if t.dtype == torch.float32 else t
        return [with_leaves(tree, [cast(c[i]) for c in copies])
                for i in range(len(devs))]


def _mesh_moe(p, xs, caches, cfg, ctxs, g, island, constrain):
    """A MoE block over a mesh's data groups: its attention per group,
    then the island (``island``) or the global dispatch on the mesh's lead
    device. Returns (xs, new caches, aux)."""
    pa = g.fetch(p["attn"])
    pn = g.fetch(p["moe"]["norm"])
    xs, news, hs = list(xs), [], []
    for i in range(g.n):
        xs[i], new = _self_attention(pa[i], xs[i], caches[i] or {}, cfg,
                                     ctxs[i])
        news.append(new)
        hs.append(L.apply_norm(pn[i], xs[i], cfg.norm, cfg.norm_eps))
    experts = {k: p["moe"][k] for k in ("router", "w_gate", "w_up",
                                        "w_down")}
    if island:
        ys, aux = L._moe_island(experts, hs, cfg, g.mesh)
    else:
        h = g.mesh.all_gather(hs, "data", 0, g.mesh.lead)
        (pm,) = g.fetch(experts, [g.mesh.lead])
        y, aux = L.apply_moe(pm, h, cfg, cons=constrain, groups=1)
        ys = g.split(y)
    return [x + y for x, y in zip(xs, ys)], news, aux


def _block(p, kind, xs, caches, cfg, ctxs, g, island, constrain):
    """One block over the data groups ``xs``: (xs, new caches, the MoE's
    aux or None). A MoE block on a mesh is :func:`_mesh_moe`'s; any other
    block runs per group on its weights fetched there."""
    caches = caches or [None] * g.n
    if kind == "moe" and g.mesh is not None:
        return _mesh_moe(p, xs, caches, cfg, ctxs, g, island, constrain)
    ps = g.fetch(p)
    out = [apply_block(ps[i], kind, xs[i], caches[i], cfg, ctxs[i])
           for i in range(g.n)]
    return ([o[0] for o in out], [o[1] for o in out],
            out[0][2] if kind == "moe" else None)


def _run_group(xs, aux, gp, gcs, group, cfg, ctxs, g, island, constrain):
    """One stacked group over the data groups: (xs, aux, the groups' new
    caches per block; None in train mode)."""
    new = []
    for bi, kind in enumerate(group):
        xs, nc, a = _block(gp[bi], kind, xs,
                           None if gcs is None else [c[bi] for c in gcs],
                           cfg, ctxs, g, island, constrain)
        xs = [x if c.get("cons") is None
              else c["cons"](x, ("batch", "seq", "embed_act"))
              for x, c in zip(xs, ctxs)]
        if a is not None:
            aux = aux + a
        new.append(nc)
    return xs, aux, (None if ctxs[0]["mode"] == "train" else new)


class _Remat(torch.autograd.Function):
    """Remat of one stacked group over a mesh's data groups: the forward
    runs ``run`` without a graph; the backward runs it again with one and
    takes the gradients of every tensor input at once. PyTorch's
    non-reentrant checkpoint recomputes from whichever device's autograd
    thread first unpacks a saved tensor, and two devices' threads race
    there when a region spans cards; this node runs its backward once, on
    one thread. ``tensors`` are every input the region differentiates:
    the groups' activations, the aux, the cross sources, the weights'
    pieces."""

    @staticmethod
    def forward(ctx, run, *tensors):
        ctx.run = run
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            return tuple(run(list(tensors)))

    @staticmethod
    def backward(ctx, *grads):
        ins = [t.detach().requires_grad_(t.requires_grad)
               for t in ctx.saved_tensors]
        with torch.enable_grad(), full_fp32():
            outs = ctx.run(ins)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        want = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       want, [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs else [None] * len(want))
        return (None,) + tuple(next(got) if t.requires_grad else None
                               for t in ins)


def _remat_group(xs, aux, gp, group, cfg, ctxs, g, island, constrain):
    """:func:`_run_group` in train mode on a mesh under :class:`_Remat`.
    An input used by several groups (an encoder's output) gets one
    gradient from each group's node, added by the engine: the bfloat16
    sum of those can round apart from the graph kept whole."""
    sharded = leaves(gp, torch.is_tensor)
    pieces = [p for x in sharded for p in x.flat()]
    cs = [c["cross_src"] for c in ctxs]
    has_cs = cs[0] is not None
    n = len(xs)

    def run(ts):
        xs_, aux_ = ts[:n], ts[n]
        at = n + 1
        ctxs_ = ctxs
        if has_cs:
            ctxs_ = [dict(c, cross_src=t) for c, t in zip(ctxs,
                                                          ts[at:at + n])]
            at += n
        it = iter(ts[at:])
        gp_ = with_leaves(gp, [x.with_pieces([next(it) for _ in x.flat()])
                               for x in sharded])
        xs_, aux_, _ = _run_group(xs_, aux_, gp_, None, group, cfg, ctxs_,
                                  g, island, constrain)
        return list(xs_) + [aux_]

    outs = _Remat.apply(run, *xs, aux, *(cs if has_cs else []), *pieces)
    return list(outs[:n]), outs[n]


def forward_groups(params, cfg, tokens, *, mesh=None, mode="train",
                   positions=None, cache=None, cross_src=None,
                   logits_mode="all", remat=False, attn_impl="auto",
                   mlstm_impl="chunked", constrain=None,
                   compute_dtype=torch.bfloat16, moe_groups=1, opt=(),
                   island=True):
    """:func:`forward` over the data groups, returning theirs: (outs,
    caches, aux) with ``outs[i]`` group i's rows of the out on its device,
    ``caches[i]`` its cache (None in train mode; in decode ``cache`` is
    that list), ``aux`` on the lead device.

    Without ``mesh`` there is one group, on the parameters' device, whose
    weights are cast once and used as they are. On a mesh ``params`` is
    the tree of :class:`~repro_torch.distributed.sharding.Sharded` leaves
    that :func:`~repro_torch.distributed.sharding.put` lays out by
    ``param_pspecs`` (a tree of tensors is laid out so first); B must
    split over the data axis; each block's weights are gathered onto the
    groups' devices just before it. The MoE blocks take the island when
    ``island`` and ``B % max(moe_groups, 1) == 0`` (the reference's
    condition; its decode step takes no mesh, and the port's passes
    ``island=False``).

    ``remat`` is :class:`_Remat` on a mesh of several slots in train mode
    (prefill and decode keep no graph to recompute), on one card as on
    several. Without a mesh, and on a mesh of one slot, it is PyTorch's
    checkpoint: under :class:`_Remat` the bfloat16 gradients of a tensor
    that several nodes share (whisper's encoder output, its tied
    embedding) add in another grouping, and a one-slot mesh would no
    longer equal no mesh bit for bit (the test
    ``test_one_slot_mesh_is_bit_equal_to_no_mesh[whisper-base-1]``)."""
    _check_args(mode, logits_mode, positions, cache, compute_dtype)
    B, S = tokens.shape
    group, n_full, rem = cfg.layer_groups()
    cd = compute_dtype or torch.float32
    if mesh is None:
        params = compute_params(params, cd)
        g = _Groups(None, B, cd, params["embed"].device)
    else:
        if not is_sharded(params):
            params = put(params, param_pspecs(model_template(cfg), mesh),
                         mesh)
        g = _Groups(mesh, B, cd)
    island = island and B % max(moe_groups, 1) == 0
    if positions is not None:
        positions = torch.as_tensor(positions, dtype=torch.int32,
                                    device=tokens.device)
        if positions.dim() == 1:
            positions = positions[:, None]            # decode (B, 1)
    base = {"mode": mode, "ctx_len": S if mode == "prefill" else None,
            "mlstm_impl": mlstm_impl, "attn_impl": attn_impl,
            "opt": tuple(opt)}
    cons_g = (constrain.bind(g.rows)
              if mesh is not None and isinstance(constrain, Constrain)
              else constrain)
    ctxs = [dict(base, positions=pos, cross_src=cs, cons=cons_g)
            for pos, cs in zip(g.split(positions), g.split(
                None if cross_src is None else cross_src.to(cd)))]
    if cache is not None and len(cache) != g.n:
        raise ValueError(f"a mesh's cache is the list of its {g.n} data "
                         f"groups' caches, got {len(cache)}")
    with full_fp32():
        if cfg.is_encoder_decoder and mode != "decode":
            if cross_src is None:
                raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                                 "cross_src")
            srcs = _encode(params, cfg, [c["cross_src"] for c in ctxs], g)
            for c, src in zip(ctxs, srcs):
                c["cross_src"] = src
        # gathered once: a tied unembedding's gradient adds to the
        # lookup's in the compute dtype
        emb = g.fetch(params["embed"])
        xs = [emb[i][t.long()].to(torch.bfloat16).to(cd)
              for i, t in enumerate(g.split(tokens))]
        xs = [x if c["cons"] is None
              else c["cons"](x, ("batch", "seq", "embed_act"))
              for x, c in zip(xs, ctxs)]
        aux = torch.zeros((), dtype=torch.float32, device=g.devs[0])
        gcs = ([_unstack(c["groups"], n_full) for c in cache]
               if cache is not None else None)
        news = [[] for _ in range(g.n)]
        for gi, gp in enumerate(_unstack(params["groups"], n_full)):
            gc = None if gcs is None else [c[gi] for c in gcs]
            args = (xs, aux, gp, gc, group, cfg, ctxs, g, island, constrain)
            if remat and (mesh is None or mesh.size == 1):
                xs, aux, nc = checkpoint(_run_group, *args,
                                         use_reentrant=False,
                                         preserve_rng_state=False)
            elif remat and mode == "train":
                xs, aux = _remat_group(xs, aux, gp, group, cfg, ctxs, g,
                                       island, constrain)
                nc = None
            else:
                xs, aux, nc = _run_group(*args)
            if nc is not None:
                for i in range(g.n):
                    news[i].append(tuple(blk[i] for blk in nc))
        tails = [[] for _ in range(g.n)]
        for bi, kind in enumerate(rem):
            xs, nc, a = _block(
                params["tail"][bi], kind, xs,
                None if cache is None else [c["tail"][bi] for c in cache],
                cfg, ctxs, g, island, constrain)
            if a is not None:
                aux = aux + a
            for i in range(g.n):
                tails[i].append(nc[i])
        caches = None
        if mode != "train":
            caches = [{"groups": _stack(news[i]), "tail": tuple(tails[i])}
                      for i in range(g.n)]
        pn = g.fetch(params["final_norm"])
        xs = [L.apply_norm(pn[i], x, cfg.norm, cfg.norm_eps)
              for i, x in enumerate(xs)]
        if logits_mode == "hidden":
            return [x.to(torch.float32) for x in xs], caches, aux
        if logits_mode == "last":
            xs = [x[:, -1:] for x in xs]
        if "unembed" in params:
            un = g.fetch(params["unembed"])
        else:
            un = [t.T for t in emb]
        outs = [(x @ u.to(x.dtype)).to(torch.float32)
                for x, u in zip(xs, un)]
        return ([o if c["cons"] is None
                 else c["cons"](o, ("batch", "seq", "vocab_act"))
                 for o, c in zip(outs, ctxs)], caches, aux)
