"""Transformer layers (port of ``src/repro/models/layers.py``): norms, RoPE,
GQA attention, the attention block's projections and the MLP.

Tensors keep the reference's layouts: activations (B, S, d), attention
operands (B, S, H, D). :func:`attention` masks by index through the
:mod:`repro_torch.kernels.flash_attention` wrapper (the Hopper kernel on
the card, its plain version on the CPU), which takes the place of the
reference's jnp ``_attn_direct`` / ``_attn_flash_xla`` / ``_attn_band``.
Masking by arbitrary positions (``_scores_mask``) runs the plain
materialized version and only on the CPU. MoE is not ported.
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


def attention(q, k, v, *, q_pos=None, k_pos=None, causal=True, window=0):
    """GQA attention. q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D). Returns
    (B, Sq, Hq, D) in ``v``'s dtype.

    Positions default to the index (``arange``), the train-mode case, and
    go through the flash kernel's wrapper. Explicit position vectors
    ((S,) or (B, S)) that equal the index take the same route; any other
    positions are masked by value, on the CPU only (the kernel masks by
    index)."""
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    if q_pos is not None or k_pos is not None:
        q_pos = (torch.arange(Sq, device=q.device) if q_pos is None
                 else q_pos)
        k_pos = (torch.arange(Sk, device=k.device) if k_pos is None
                 else k_pos)
        if not (_is_index(q_pos, Sq) and _is_index(k_pos, Sk)):
            if q.device.type != "cpu":
                raise ValueError("attention on the card masks by index: "
                                 "positions must equal arange(S)")
            q_pos = q_pos.expand(B, Sq) if q_pos.dim() == 1 else q_pos
            k_pos = k_pos.expand(B, Sk) if k_pos.dim() == 1 else k_pos
            return _attention_by_position(q, k, v, q_pos, k_pos, causal,
                                          window)
    o = flash_attention(q, k, v, causal=causal, window=window)
    return o.to(v.dtype)


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
    """``jax.nn.silu``: x * sigmoid(x), each op in x's dtype."""
    return x * torch.sigmoid(x)


def act_fn(cfg):
    """The MLP's activation: ``jax.nn.silu`` or ``jax.nn.gelu``."""
    return silu if cfg.act == "silu" else gelu_tanh


def apply_mlp(p, x, cfg):
    act = act_fn(cfg)
    h = x @ p["w_up"]
    h = act(x @ p["w_gate"]) * h if cfg.mlp_gated else act(h)
    return h @ p["w_down"]
