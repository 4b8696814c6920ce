"""Recurrent sequence-mixing blocks: RG-LRU (RecurrentGemma), mLSTM and
sLSTM (xLSTM) (port of ``src/repro/models/recurrent.py``). Every block has
``*_template(cfg)``, ``*_init_state(cfg, batch, device=...)`` and
``apply_*(p, x, state, cfg) -> (y, new state)`` for any S >= 1.

``apply_rglru`` runs the diagonal recurrence through
:func:`repro_torch.kernels.linear_scan.linear_scan` (the Hopper kernel on
the card, its plain version on the CPU), in place of the reference's
``jax.lax.associative_scan``; the two sum in different orders, so they
agree to float32 rounding, not bit for bit. A single step (S == 1,
decode) is the reference's elementwise ``a * h + b`` from the carried
state, with no scan.

The mLSTM has the reference's two forms: the sequential oracle
:func:`_mlstm_seq` (and the S == 1 path) and the chunkwise-parallel
:func:`_mlstm_chunked` that the model runs. The chunk's inclusive prefix
sum of the log forget gates is a product with a lower-triangular ones
matrix, not ``torch.cumsum``: PyTorch's float scan on the card promises no
summation order, a matrix product in full float32 sums in a fixed one, so
card runs repeat bit for bit. The sLSTM recurrence is a loop over the
sequence. No Pallas kernel sits under either block in the reference; both
are plain PyTorch here, their float32 products in full float32
(:func:`repro_torch.device.full_fp32`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import full_fp32
from repro_torch.kernels.linear_scan import linear_scan
from repro_torch.models.layers import (
    apply_norm, gelu_tanh, norm_template, sigmoid,
)
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
    if x.shape[1] == 1:                       # decode: one step
        h = (a[:, 0] * state["h"] + b[:, 0])[:, None]
    else:
        h = linear_scan(a, b, state["h"])
    y = (h.to(x.dtype) * g) @ p["w_out"]
    return y, {"h": h[:, -1], "conv": conv_state}


# ------------------------------------------------------------------ mLSTM ----

def _mlstm_dims(cfg):
    d = cfg.d_model
    d_inner = 2 * d
    H = cfg.n_heads
    return d, d_inner, H, d_inner // H, cfg.head_dim


def mlstm_template(cfg):
    d, d_inner, H, dv, dqk = _mlstm_dims(cfg)
    return {
        "w_up": PSpec((d, d_inner), ("embed", "ffn")),
        "w_z": PSpec((d, d_inner), ("embed", "ffn")),
        "w_q": PSpec((d_inner, H * dqk), ("ffn", "heads")),
        "w_k": PSpec((d_inner, H * dqk), ("ffn", "heads")),
        "w_if": PSpec((d, 2 * H), ("embed", "gates")),
        "b_if": PSpec((2 * H,), ("gates",), "zeros"),
        "hnorm": {"scale": PSpec((d_inner,), ("ffn",), "ones")},
        "w_down": PSpec((d_inner, d), ("ffn", "embed")),
        "norm": norm_template(d, cfg.norm),
    }


def mlstm_init_state(cfg, batch, dtype=torch.float32, *, device):
    """The empty state of ``batch`` sequences on the caller's ``device``:
    ``C`` (B, H, dqk, dv), ``n`` (B, H, dqk) and the stabilizer ``m`` (B,
    H) = -1e30, all float32 (``dtype`` is the reference's unused
    argument)."""
    _, _, H, dv, dqk = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dqk, dv), **f32),
            "n": torch.zeros((batch, H, dqk), **f32),
            "m": torch.full((batch, H), -1e30, **f32)}


def _mlstm_gates(p, x, cfg):
    """Projections in x's dtype; q, k, v and the log gates in float32."""
    d, d_inner, H, dv, dqk = _mlstm_dims(cfg)
    B, S, _ = x.shape
    f32 = torch.float32
    u = x @ p["w_up"]
    z = sigmoid(x @ p["w_z"])
    q = (u @ p["w_q"]).reshape(B, S, H, dqk).to(f32)
    k = (u @ p["w_k"]).reshape(B, S, H, dqk).to(f32) * (dqk ** -0.5)
    v = u.reshape(B, S, H, dv).to(f32)
    gf = (x @ p["w_if"] + p["b_if"]).to(f32).reshape(B, S, H, 2)
    return u, z, q, k, v, gf[..., 0], F.logsigmoid(gf[..., 1])


def _mlstm_seq(q, k, v, log_i, log_f, state):
    """The sequential oracle. q, k: (B, S, H, dqk), v: (B, S, H, dv),
    log_i, log_f: (B, S, H), all float32. Returns (h (B, S, H, dv), new
    state)."""
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt, li, lf = q[:, t], k[:, t], v[:, t], log_i[:, t], \
            log_f[:, t]
        m_new = torch.maximum(lf + m, li)
        fp = torch.exp(lf + m - m_new)[..., None]
        ip = torch.exp(li - m_new)[..., None]
        C = fp[..., None] * C + (ip * kt)[..., None] * vt[..., None, :]
        n = fp * n + ip * kt
        num = torch.einsum("bhkv,bhk->bhv", C, qt)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                            torch.exp(-m_new))[..., None]
        m = m_new
        hs.append(num / den)
    return torch.stack(hs, 1), {"C": C, "n": n, "m": m}


def _mlstm_chunked(q, k, v, log_i, log_f, state, chunk=256):
    """Chunkwise-parallel mLSTM: the attention form inside a chunk of
    ``min(chunk, S)`` steps and the state recurrence across chunks; the
    same function as :func:`_mlstm_seq` (tested)."""
    B, S, H, _ = q.shape
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {L}")
    tril = torch.tril(torch.ones((L, L), dtype=torch.float32,
                                 device=q.device))
    mask = tril.bool()
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for c0 in range(0, S, L):
        qt, kt, vt = q[:, c0:c0 + L], k[:, c0:c0 + L], v[:, c0:c0 + L]
        li, lf = log_i[:, c0:c0 + L], log_f[:, c0:c0 + L]
        # inclusive prefix sums F_i = sum_{j <= i} lf_j in a fixed order
        Fs = torch.einsum("ij,bjh->bih", tril, lf)
        g = li - Fs                                   # g_j = li_j - F_j
        G = torch.cummax(g, dim=1).values             # max_{j <= i} g_j
        M = torch.maximum(m[:, None], G)              # row stabilizer - F_i
        dec_q = torch.exp(m[:, None] - M)             # (B, L, H)
        w_k = torch.exp(g - M[:, -1:])                # chunk-final key decay
        # w_ij = exp(g_j - M_i) for j <= i; the clamp is exact there and
        # keeps the masked j > i entries finite
        s = torch.einsum("bihk,bjhk->bhij", qt, kt)
        wij = torch.exp(torch.clamp(g[:, None, :] - M[:, :, None],
                                    max=0.0)).permute(0, 3, 1, 2)
        sw_ = s * torch.where(mask, wij, 0.0)
        qd = dec_q[..., None] * qt
        num = torch.einsum("blhk,bhkv->blhv", qd, C) \
            + torch.einsum("bhij,bjhv->bihv", sw_, vt)
        den = torch.einsum("blhk,bhk->blh", qd, n) \
            + sw_.sum(-1).transpose(1, 2)             # sw_ holds q_i . k_j
        m_row = Fs + M                                # absolute stabilizer
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_row))[..., None])
        # the state at the chunk's end
        m_new = Fs[:, -1] + M[:, -1]
        decC = torch.exp(m - M[:, -1])
        kw = w_k[..., None] * kt
        C = decC[..., None, None] * C + torch.einsum("bjhk,bjhv->bhkv", kw,
                                                     vt)
        n = decC[..., None] * n + kw.sum(1)
        m = m_new
    return torch.cat(hs, 1), {"C": C, "n": n, "m": m}


def apply_mlstm(p, x, state, cfg, impl="seq"):
    """The mLSTM block on (B, S, d) x from ``state``
    (:func:`mlstm_init_state`). ``impl`` is ``"seq"`` (the oracle) or
    ``"chunked"``; S == 1 always runs the sequential step. Returns (y, new
    state)."""
    if impl not in ("seq", "chunked"):
        raise ValueError(f"mLSTM impl must be 'seq' or 'chunked', got "
                         f"{impl!r}")
    _, d_inner, _, _, _ = _mlstm_dims(cfg)
    B, S, _ = x.shape
    with full_fp32():
        u, z, q, k, v, log_i, log_f = _mlstm_gates(p, x, cfg)
        core = _mlstm_chunked if impl == "chunked" and S > 1 else _mlstm_seq
        h, new_state = core(q, k, v, log_i, log_f, state)
        h = h.reshape(B, S, d_inner).to(x.dtype)
        hn = apply_norm({"scale": p["hnorm"]["scale"]}, h, "rmsnorm",
                        cfg.norm_eps)
        return (hn * z) @ p["w_down"], new_state


# ------------------------------------------------------------------ sLSTM ----

def slstm_template(cfg):
    d, H = cfg.d_model, cfg.n_heads
    dh, fi = d // H, cfg._ff_inner()
    return {
        "w_gates": PSpec((d, 4 * d), ("embed", "gates")),
        "r_gates": PSpec((H, dh, 4 * dh), ("heads_dim", "embed", "gates")),
        "b_gates": PSpec((4 * d,), ("gates",), "zeros"),
        "gnorm": {"scale": PSpec((d,), ("embed",), "ones")},
        "w_up": PSpec((d, 2 * fi), ("embed", "ffn")),
        "w_down": PSpec((fi, d), ("ffn", "embed")),
        "norm": norm_template(d, cfg.norm),
    }


def slstm_init_state(cfg, batch, dtype=torch.float32, *, device):
    """The empty state of ``batch`` sequences on the caller's ``device``:
    ``c``, ``n``, ``h`` (B, d) zeros and ``m`` (B, d) = -1e30, float32."""
    f32 = dict(dtype=torch.float32, device=device)
    z = lambda: torch.zeros((batch, cfg.d_model), **f32)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, cfg.d_model), -1e30, **f32)}


def apply_slstm(p, x, state, cfg, cons=None, local=False):
    """The sLSTM block on (B, S, d) x from ``state``
    (:func:`slstm_init_state`): the gated recurrence with head-wise
    recurrent weights, step by step in float32, then the group norm and the
    GEGLU projection in x's dtype. With ``local`` (the reference's
    ``rnn_local``) the gate pre-activations pass through the
    activation-sharding hook ``cons`` once per layer, replicated over
    ``model`` (the port's data groups hold them whole). Returns (y, new
    state)."""
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    B, S, _ = x.shape
    with full_fp32():
        gx = x @ p["w_gates"] + p["b_gates"]
        if local and cons is not None:
            gx = cons(gx, ("batch", "seq", None))
        gx = gx.to(torch.float32)
        r = p["r_gates"].to(torch.float32)
        c, n, h, m = state["c"], state["n"], state["h"], state["m"]
        hs = []
        for t in range(S):
            gr = torch.einsum("bhd,hdg->bhg", h.reshape(B, H, dh), r)
            g = gx[:, t] + gr.reshape(B, 4 * d)
            gi, gf, gz, go = g.chunk(4, -1)
            log_f = F.logsigmoid(gf)
            m_new = torch.maximum(log_f + m, gi)
            ip = torch.exp(gi - m_new)
            fp = torch.exp(log_f + m - m_new)
            c = fp * c + ip * torch.tanh(gz)
            n = fp * n + ip
            h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
            m = m_new
            hs.append(h)
        y = torch.stack(hs, 1).to(x.dtype)
        y = apply_norm({"scale": p["gnorm"]["scale"]}, y, "rmsnorm",
                       cfg.norm_eps)
        a, b = (y @ p["w_up"]).chunk(2, -1)
        return (gelu_tanh(a) * b) @ p["w_down"], \
            {"c": c, "n": n, "h": h, "m": m}
