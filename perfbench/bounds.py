"""The yardstick's arithmetic: the published H100 peaks, the least time of
each hand-written kernel at a shape (frozen copies of ``chip_smoke.py``'s
bound functions), and the model FLOPs of an encoder forward.

A bound is the larger of the bytes the kernel must move over the memory
rate and the operations it must do over the matching peak. A roofline
share is that bound over the kernel's measured device time.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12              # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12            # bfloat16 tensor cores


def _bound(nbytes, t_ops):
    t_bytes = nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def estep_bound_ms(B, R, C, T, V):
    """Least time for the Dawid-Skene E-step: the (B, R, C) float32 row
    table and the (B, T, V) int32 vote rows read once and the two (B, T, C)
    float32 outputs written once at the memory rate, or its float32
    operations (V adds, one subtract, max, exp, sum and divide per class)
    at the float32 rate, whichever is larger. Returns (ms, which, bytes)."""
    nbytes = 4 * (B * T * V + B * R * C + 2 * B * T * C)
    return _bound(nbytes, B * T * C * (V + 5) / H100_F32_FLOPS)


def entropy_bound_ms(N, V, elt):
    """Least time for the entropy of N rows of V logits: the logits read
    once and N float32 entropies written once, or ~5 float32 operations a
    logit at the float32 rate."""
    return _bound(N * V * elt + 4 * N, 5 * N * V / H100_F32_FLOPS)


def _kept_pairs(Sq, Sk, causal, window):
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= k <= q
    if window > 0:
        keep &= q - k < window
    return int(keep.sum())


def flash_bound_ms(B, Hq, Hkv, Sq, Sk, D, elt, causal, window):
    """Least time for attention: q, k, v read once and o written once, or
    the two products over the (q, k) pairs the masks keep (2 D
    multiply-adds each for q.k and p v) at the bfloat16 tensor-core rate."""
    nbytes = elt * (2 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D)
    flops = 4 * D * _kept_pairs(Sq, Sk, causal, window) * B * Hq
    return _bound(nbytes, flops / H100_BF16_FLOPS)


def scan_bound_ms(B, S, D, elt, h0):
    """Least time for the linear recurrence: a and b read once, h written
    once (h0 read once), or 2 float32 operations an element."""
    nbytes = 3 * B * S * D * elt + (4 * B * D if h0 else 0)
    return _bound(nbytes, 2 * B * S * D / H100_F32_FLOPS)


def xent_bound_ms(N, V, elt, backward):
    """Least time for the cross entropy of N rows of V logits: forward
    reads the logits and targets and writes loss and lse; backward also
    reads lse and the loss gradient and writes dlogits; ~4 float32
    operations a logit."""
    nbytes = N * V * elt * (2 if backward else 1) + 12 * N
    return _bound(nbytes, 4 * N * V / H100_F32_FLOPS)


def moe_active_params(d_model, n_heads, n_kv_heads, head_dim, d_ff,
                      n_experts, moe_top_k, n_layers) -> int:
    """Parameters one token multiplies in an attention + top-k MoE stack,
    embeddings left out: per layer q, k, v and o, the router, and top_k
    gated experts of three d_model x d_ff matrices."""
    attn = d_model * head_dim * (2 * n_heads + 2 * n_kv_heads)
    router = d_model * n_experts
    experts = moe_top_k * 3 * d_model * d_ff
    return n_layers * (attn + router + experts)


def encoder_flops(lengths, *, d_model, n_heads, n_kv_heads, head_dim, d_ff,
                  n_experts, moe_top_k, n_layers) -> float:
    """Model FLOPs of a causal forward over texts of the real lengths
    ``lengths``: 2 x the active non-embedding parameters a real token, and
    attention's two products (q.k and p v, 2 head_dim FLOPs a pair and
    head each) over the causal pairs of real tokens. Pad rows and padded
    positions are not counted."""
    L = np.asarray(lengths, np.float64)
    per_token = 2.0 * moe_active_params(d_model, n_heads, n_kv_heads,
                                        head_dim, d_ff, n_experts, moe_top_k,
                                        n_layers)
    pairs = float((L * (L + 1) / 2).sum())
    return per_token * float(L.sum()) + \
        n_layers * n_heads * 4.0 * head_dim * pairs
