"""The RG-LRU recurrent block of RecurrentGemma (port of the RG-LRU part of
``src/repro/models/recurrent.py``).

``apply_rglru`` runs the diagonal recurrence through
:func:`repro_torch.kernels.linear_scan.linear_scan` (the Hopper kernel on
the card, its plain version on the CPU), in place of the reference's
``jax.lax.associative_scan``; the two sum in different orders, so they
agree to float32 rounding, not bit for bit. The xLSTM blocks (mLSTM,
sLSTM) are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_scan import linear_scan
from repro_torch.models.layers import gelu_tanh, norm_template
from repro_torch.models.params import PSpec

_LRU_C = 8.0


def rglru_template(cfg):
    d, dl, cw = cfg.d_model, cfg.d_lru, cfg.conv_width
    return {
        "w_x": PSpec((d, dl), ("embed", "lru")),
        "w_gate": PSpec((d, dl), ("embed", "lru")),
        "conv_w": PSpec((cw, dl), ("conv", "lru"), "conv"),
        "conv_b": PSpec((dl,), ("lru",), "zeros"),
        "w_i": PSpec((dl, dl), ("lru", "lru_out")),
        "b_i": PSpec((dl,), ("lru",), "zeros"),
        "w_r": PSpec((dl, dl), ("lru", "lru_out")),
        "b_r": PSpec((dl,), ("lru",), "zeros"),
        "lam": PSpec((dl,), ("lru",), "lru_lambda"),
        "w_out": PSpec((dl, d), ("lru", "embed")),
        "norm": norm_template(d, cfg.norm),
    }


def rglru_init_state(cfg, batch, dtype=torch.float32, *, device):
    """The zero state of ``batch`` sequences on the caller's ``device``."""
    return {
        "h": torch.zeros((batch, cfg.d_lru), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_lru),
                            dtype=dtype, device=device),
    }


def _causal_conv(u, w, b, prev):
    """Depthwise causal convolution in u's dtype. u: (B, S, dl), w:
    (cw, dl), prev: (B, cw - 1, dl) -> (out, last cw - 1 inputs)."""
    cw, S = w.shape[0], u.shape[1]
    upad = torch.cat([prev.to(u.dtype), u], dim=1)
    out = upad[:, 0:S] * w[cw - 1]
    for i in range(1, cw):
        out = out + upad[:, i:i + S] * w[cw - 1 - i]
    return out + b, (upad[:, -(cw - 1):] if cw > 1 else prev)


def apply_rglru(p, x, state, cfg):
    """The RG-LRU block on (B, S, d) x from ``state`` (``h`` (B, dl)
    float32, ``conv`` (B, cw - 1, dl)). The gates and the recurrence run in
    float32 (their float32 products must not use TF32; see
    :func:`repro_torch.models.model.forward`). Returns (y, new state)."""
    u = x @ p["w_x"]
    g = gelu_tanh(x @ p["w_gate"])
    uc, conv_state = _causal_conv(u, p["conv_w"], p["conv_b"], state["conv"])
    uf = uc.to(torch.float32)
    gate_i = torch.sigmoid(uf @ p["w_i"].to(torch.float32) + p["b_i"])
    gate_r = torch.sigmoid(uf @ p["w_r"].to(torch.float32) + p["b_r"])
    log_a = -_LRU_C * F.softplus(p["lam"].to(torch.float32)) * gate_r
    a = torch.exp(log_a)
    b = (torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
         * (gate_i * uf))
    h = linear_scan(a, b, state["h"])
    y = (h.to(x.dtype) * g) @ p["w_out"]
    return y, {"h": h[:, -1], "conv": conv_state}
