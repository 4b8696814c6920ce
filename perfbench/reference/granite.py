"""Plain float32 reference of the attention + mixture-of-experts text
encoder (granite-moe-3b-a800m's block) as the labeling service runs it:
token embedding, per layer a pre-norm causal GQA self-attention with
rotary positions and a pre-norm top-k MoE of gated SiLU experts, a final
RMSNorm, a masked mean over each text's real tokens and a projection to
the feature width.

It follows the service's encoder call, which sets what a text's features
depend on: texts go through in micro-batches of ``batch_size`` rows (a
short last chunk padded by repeating its last row, pad rows dropped), and
each micro-batch's tokens (padded positions included) are routed together:
an expert takes at most C = max(8, ceil(k T cf / E)) slots of the T tokens
in token order, and a pick beyond that is dropped.

Like the service, it applies no granite multipliers (scores scaled by
1/sqrt(head_dim)): the benchmark folds the published ones into the weights
it hands both sides. Like the service, it keeps a capacity factor of 1.25
with dropped picks, where the published MoE routes every pick.

Plain PyTorch, no kernel: matrix products in float32 with TF32 off. With
``fp8`` every product's two operands are first rounded to float8 e4m3 with
one scale a tensor (the control one precision below the bfloat16 the
service computes in). Imports nothing of the service.
"""
from __future__ import annotations

import contextlib
import math

import torch

F8_MAX = 448.0      # largest float8 e4m3fn


@contextlib.contextmanager
def exact_fp32():
    mm = torch.backends.cuda.matmul
    old = (mm.allow_tf32, torch.backends.cudnn.allow_tf32)
    mm.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _q8(t):
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), back in float32."""
    s = t.abs().max().clamp(min=1e-30) / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _mm(a, b, fp8):
    if fp8:
        a, b = _q8(a), _q8(b)
    return a @ b


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """Rotary positions 0..S-1 over the two halves of each head of
    (B, S, H, D)."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v):
    """Causal GQA attention of (B, S, H, D) tensors, q head h on kv head
    h // (Hq / Hkv), scores scaled by 1/sqrt(D)."""
    B, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def moe(x, router, w_gate, w_up, w_down, top_k, capacity_factor, fp8):
    """Top-k capacity-routed MoE of (T, d) tokens: softmax router
    probabilities, the k largest (a tie to the lower expert), weights
    renormalised over the k; each expert keeps its first C picks in token
    order; output = sum of kept picks' weight x expert(x)."""
    T, d = x.shape
    E = router.shape[-1]
    probs = torch.softmax(_mm(x, router, fp8), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    w = top.values[:, :top_k]
    w = w / w.sum(-1, keepdim=True)
    pick = top.indices[:, :top_k]
    C = int(max(8, -(-top_k * T * capacity_factor // E)))
    flat = pick.reshape(-1)                        # token-major picks
    out = torch.zeros_like(x)
    for e in range(E):
        slots = (flat == e).nonzero()[:, 0][:C]    # first C in token order
        if slots.numel() == 0:
            continue
        tok, j = slots // top_k, slots % top_k
        xe = x[tok]
        h = torch.nn.functional.silu(_mm(xe, w_gate[e], fp8)) \
            * _mm(xe, w_up[e], fp8)
        out.index_add_(0, tok, w[tok, j][:, None] * _mm(h, w_down[e], fp8))
    return out


def encode_batch(W: dict, m: dict, tokens, lengths, proj, fp8=False):
    """(B, S) tokens and (B,) real lengths of one micro-batch -> (B, F)
    float32 features. ``W`` holds the weights by name (``embed``,
    ``final_norm``, and per layer stacked ``attn_norm``, ``wq``, ``wk``,
    ``wv``, ``wo``, ``moe_norm``, ``router``, ``w_gate``, ``w_up``,
    ``w_down``), ``m`` the sizes (``n_layers``, ``n_heads``,
    ``n_kv_heads``, ``head_dim``, ``moe_top_k``, ``capacity_factor``,
    ``norm_eps``, ``rope_theta``)."""
    f = lambda t: t.to(torch.float32)
    B, S = tokens.shape
    Hq, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps = m["norm_eps"]
    x = f(W["embed"][tokens.long()])
    for i in range(m["n_layers"]):
        h = rmsnorm(x, f(W["attn_norm"][i]), eps)
        q = _mm(h, f(W["wq"][i]), fp8).reshape(B, S, Hq, D)
        k = _mm(h, f(W["wk"][i]), fp8).reshape(B, S, Hkv, D)
        v = _mm(h, f(W["wv"][i]), fp8).reshape(B, S, Hkv, D)
        o = attention(rope(q, m["rope_theta"]), rope(k, m["rope_theta"]), v)
        x = x + _mm(o.reshape(B, S, Hq * D), f(W["wo"][i]), fp8)
        h = rmsnorm(x, f(W["moe_norm"][i]), eps).reshape(B * S, -1)
        x = x + moe(h, f(W["router"][i]), f(W["w_gate"][i]),
                    f(W["w_up"][i]), f(W["w_down"][i]), m["moe_top_k"],
                    m["capacity_factor"], fp8).reshape(B, S, -1)
    x = rmsnorm(x, f(W["final_norm"]), eps)
    mask = (torch.arange(S, device=x.device)[None, :]
            < lengths[:, None]).to(torch.float32)
    pooled = (x * mask[:, :, None]).sum(1) / lengths.clamp(min=1)[:, None]
    return pooled @ f(proj)


def encode(W: dict, m: dict, tokens, lengths, proj, batch_size: int,
           fp8=False):
    """Features of (N, S) texts in the service's micro-batches of
    ``batch_size`` rows (see the module docstring)."""
    with exact_fp32(), torch.no_grad():
        out = []
        for i in range(0, tokens.shape[0], batch_size):
            tb, lb = tokens[i:i + batch_size], lengths[i:i + batch_size]
            n = tb.shape[0]
            if n < batch_size:
                tb = torch.cat([tb, tb[-1:].expand(batch_size - n, -1)])
                lb = torch.cat([lb, lb[-1:].expand(batch_size - n)])
            out.append(encode_batch(W, m, tb, lb, proj, fp8)[:n])
        return torch.cat(out)
