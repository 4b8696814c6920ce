"""Transformer layers (port of ``src/repro/models/layers.py``): norms, RoPE,
GQA attention, the attention block's projections, the MLP and the
capacity-routed MoE.

Tensors keep the reference's layouts: activations (B, S, d), attention
operands (B, S, H, D). :func:`attention` picks its route from the call, as
the reference's ``impl`` does: masks that the index gives (train and
prefill, whose positions are the index; cross-attention and the encoder,
whose masks do not depend on positions) go through the
:mod:`repro_torch.kernels.flash_attention` wrapper (the Hopper kernel on
the card, its plain version on the CPU), in place of the reference's jnp
``_attn_flash_xla`` / ``_attn_band`` / short-shape ``_attn_direct``;
``impl="direct"`` (decode over a cache, whose slots carry positions) is
the reference's ``_attn_direct``, plain materialized attention masked by
position on either device.

:func:`apply_moe` is the reference's ``apply_moe`` with ``groups=1``.
``apply_moe_shardmap`` and ``_moe_local`` dispatch inside a device mesh
and stay with the multi-device work (ROADMAP A13b).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.params import PSpec

_NEG = -1e30


# ---------------------------------------------------------------- norms ----

def norm_template(d, kind):
    t = {"scale": PSpec((d,), ("embed",), "ones")}
    if kind == "layernorm":
        t["bias"] = PSpec((d,), ("embed",), "zeros")
    return t


def apply_norm(p, x, kind, eps):
    """RMSNorm or LayerNorm in float32, returned in ``x``'s dtype."""
    xf = x.to(torch.float32)
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ----------------------------------------------------------------- rope ----

def rope(x, positions, theta):
    """Rotary embedding over the two halves of the head (not interleaved).
    x: (B, S, H, D); positions: (S,) or (B, S)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions.to(torch.float32)[..., None] * freqs   # (..., S, D/2)
    if ang.dim() == x.dim() - 2:
        ang = ang.expand(x.shape[:-3] + ang.shape)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----

def _is_index(pos, S):
    ar = torch.arange(S, device=pos.device, dtype=pos.dtype)
    return bool((pos == ar).all())


def _attention_by_position(q, k, v, q_pos, k_pos, causal, window):
    """The reference's ``_attn_direct``: scores and softmax in float32, p
    rounded to v's dtype before p v; masking by position vectors, negative
    ``k_pos`` marking empty slots."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    valid = k_pos[..., None, :] >= 0
    if causal:
        valid = valid & (k_pos[..., None, :] <= q_pos[..., :, None])
    if window > 0:
        valid = valid & (q_pos[..., :, None] - k_pos[..., None, :] < window)
    mask = torch.where(valid, 0.0, _NEG).to(torch.float32)
    s = s * D ** -0.5 + mask[:, None, None]
    p = torch.softmax(s, dim=-1).to(v.dtype).to(torch.float32)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, Hq, D).to(v.dtype)


def attention(q, k, v, *, q_pos=None, k_pos=None, causal=True, window=0,
              impl="auto"):
    """GQA attention. q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D). Returns
    (B, Sq, Hq, D) in ``v``'s dtype.

    ``impl="auto"`` goes through the flash kernel's wrapper, which masks by
    index: the positions are the index (None, or vectors equal to
    ``arange(S)``: train, prefill), or the mask does not depend on them
    (no causality, no window, no ``k_pos``: cross-attention, the encoder);
    other positions raise on either device. ``impl="direct"`` masks by the
    position vectors ((S,) or (B, S), default the index; a negative
    ``k_pos`` marks an empty cache slot) on either device: the reference's
    decode route."""
    if impl not in ("auto", "direct"):
        raise ValueError(f"attention impl must be 'auto' or 'direct', got "
                         f"{impl!r}")
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    if impl == "auto":
        by_index = ((q_pos is None or _is_index(q_pos, Sq))
                    and (k_pos is None or _is_index(k_pos, Sk)))
        # without causality or a window only k_pos (empty slots) shapes it
        free = k_pos is None and not causal and window == 0
        if not (by_index or free):
            raise ValueError("attention impl='auto' masks by index: "
                             "positions must equal arange(S) "
                             "(impl='direct' masks by position)")
        return flash_attention(q, k, v, causal=causal,
                               window=window).to(v.dtype)
    q_pos = torch.arange(Sq, device=q.device) if q_pos is None else q_pos
    k_pos = torch.arange(Sk, device=k.device) if k_pos is None else k_pos
    q_pos = q_pos.expand(B, Sq) if q_pos.dim() == 1 else q_pos
    k_pos = k_pos.expand(B, Sk) if k_pos.dim() == 1 else k_pos
    return _attention_by_position(q, k, v, q_pos, k_pos, causal, window)


# ------------------------------------------------------- attention block ----

def attn_template(cfg, cross=False):
    d = cfg.d_model
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    t = {
        "wq": PSpec((d, qd), ("embed", "heads")),
        "wk": PSpec((d, kvd), ("embed", "kv")),
        "wv": PSpec((d, kvd), ("embed", "kv")),
        "wo": PSpec((qd, d), ("heads", "embed")),
        "norm": norm_template(d, cfg.norm),
    }
    if cfg.qkv_bias and not cross:
        t["bq"] = PSpec((qd,), ("heads",), "zeros")
        t["bk"] = PSpec((kvd,), ("kv",), "zeros")
        t["bv"] = PSpec((kvd,), ("kv",), "zeros")
    return t


def _proj_qkv(p, x, cfg):
    B, S, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, cfg.n_heads, cfg.head_dim),
            k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim))


# ------------------------------------------------------------------ mlp ----

def mlp_template(cfg, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    t = {
        "w_up": PSpec((d, f), ("embed", "ffn")),
        "w_down": PSpec((f, d), ("ffn", "embed")),
        "norm": norm_template(d, cfg.norm),
    }
    if cfg.mlp_gated:
        t["w_gate"] = PSpec((d, f), ("embed", "ffn"))
    return t


def gelu_tanh(x):
    """``jax.nn.gelu`` (its default tanh approximation) in jax's op order,
    every op rounded to x's dtype as the reference's bfloat16 math is
    (``F.gelu`` rounds once and differs in ~45% of bfloat16 outputs)."""
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    inner = x + c(0.044715) * x ** 3
    return x * (0.5 * (1.0 + torch.tanh(c(0.7978845608028654) * inner)))


def sigmoid(x):
    """``jax.nn.sigmoid`` in x's dtype. In bfloat16 XLA rounds every op of
    1 / (1 + exp(-x)) (``torch.sigmoid`` rounds once and differs in ~1/3
    of the outputs); float32 takes ``torch.sigmoid`` (within an ulp)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return torch.reciprocal(1.0 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: x * :func:`sigmoid` (x), each op in x's dtype (in
    bfloat16 ``x * torch.sigmoid(x)`` differs in ~28% of the outputs)."""
    return x * sigmoid(x)


def act_fn(cfg):
    """The MLP's activation: ``jax.nn.silu`` or ``jax.nn.gelu``."""
    return silu if cfg.act == "silu" else gelu_tanh


def apply_mlp(p, x, cfg):
    act = act_fn(cfg)
    h = x @ p["w_up"]
    h = act(x @ p["w_gate"]) * h if cfg.mlp_gated else act(h)
    return h @ p["w_down"]


# ------------------------------------------------------------------ moe ----

def moe_template(cfg):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": PSpec((d, E), ("embed", "experts_dim")),
        "w_gate": PSpec((E, d, f), ("experts", "embed", "ffn")),
        "w_up": PSpec((E, d, f), ("experts", "embed", "ffn")),
        "w_down": PSpec((E, f, d), ("experts", "ffn", "embed")),
        "norm": norm_template(d, cfg.norm),
    }


def moe_capacity(cfg, n_tokens):
    """Slots per expert: the reference's expression, float floor division
    included."""
    E, k = cfg.n_experts, cfg.moe_top_k
    return int(max(8, -(-k * n_tokens * cfg.capacity_factor // E)))


def moe_dispatch(probs, k, C):
    """Top-k routing and capacity dispatch of (T, E) float32 router
    probabilities. Returns a dict of ``topw`` (T, k) float32 renormalized
    weights and ``topi`` (T, k) experts, best first, a tie to the lower
    expert (``jax.lax.top_k``'s order: a stable descending sort); the
    T * k slots in expert order (a stable argsort of the flattened
    ``topi``): ``order``, each slot's rank in its expert's run, ``keep``
    (rank < C), ``dest`` (expert * C + rank, or the drop row E * C) and
    ``tok`` (the slot's token)."""
    T, E = probs.shape
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = srt.values[:, :k], srt.indices[:, :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    slots = topi.reshape(T * k)
    order = torch.argsort(slots, stable=True)
    sorted_e = slots[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(T * k, device=probs.device) - first
    keep = rank < C
    dest = torch.where(keep, sorted_e * C + rank,
                       torch.full_like(rank, E * C))
    return dict(topw=topw, topi=topi, order=order, keep=keep, dest=dest,
                tok=order // k)


def apply_moe(p, x, cfg):
    """Capacity-routed top-k MoE on (B, S, d) x: the reference's
    ``apply_moe`` with ``groups=1`` (one dispatch over all B * S tokens).
    Returns (y (B, S, d) in x's dtype, the float32 switch-style aux loss).

    Each expert takes at most C slots (:func:`moe_capacity`) in token
    order; overflowing slots go to a drop row that is thrown away (several
    writes land there; which one wins does not matter). The combine adds
    a token's k weighted expert outputs, each rounded to x's dtype, into a
    zero row in ascending expert order, one rounding per add: the order in
    which the reference's scatter-add visits them (its slots are sorted by
    expert), and no float atomics."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    T = B * S
    xf = x.reshape(T, d)
    probs = torch.softmax((xf @ p["router"]).to(torch.float32), dim=-1)
    C = moe_capacity(cfg, T)
    r = moe_dispatch(probs, k, C)
    dest, keep, order = r["dest"], r["keep"], r["order"]
    xe = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    xe = xe.index_put((dest,), xf[r["tok"]])
    xe = xe[:-1].reshape(E, C, d)
    act = act_fn(cfg)
    h = act(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).reshape(E * C, d)
    w_slot = r["topw"].reshape(T * k)[order]
    ys = torch.where(keep[:, None], ye[torch.clamp(dest, max=E * C - 1)],
                     torch.zeros((), dtype=ye.dtype, device=ye.device))
    contrib = (ys * w_slot[:, None]).to(x.dtype)         # slots, expert order
    # each token's k slots, in the order the sorted slots visit them
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * k, device=x.device)
    pos = torch.sort(pos.reshape(T, k), dim=-1).values
    parts = contrib[pos]                                 # (T, k, d)
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + parts[:, j]
    me = probs.mean(0)
    ce = torch.bincount(r["topi"].reshape(-1), minlength=E)
    aux = E * torch.sum(me * (ce.to(torch.float32) / (T * k)))
    return out.reshape(B, S, d), aux
