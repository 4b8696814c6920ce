"""Plain PyTorch versions of the port's kernels: what the wrappers run for
CPU tensors, and what the kernels are held against on the card."""
from __future__ import annotations

import math

import torch


def ds_estep_ref(rows, idx):
    """Dawid-Skene E-step. rows: ([B,] R, C) float32 log-confusion row table
    with a trailing all-zero null row; idx: ([B,] T, V) per-vote row indices
    (null row for padded votes). Returns (logp, post), both ([B,] T, C),
    with the uniform -log C prior included in logp.

    The votes are summed in order (v = 0, 1, ...) before -log C is
    subtracted; the CUDA kernel sums in the same order."""
    C = rows.shape[-1]
    if idx.dim() == 2:
        g = rows[idx.long()]                                 # (T, V, C)
    else:
        b = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
        g = rows[b, idx.long()]                              # (B, T, V, C)
    acc = torch.zeros(g.shape[:-2] + (C,), dtype=rows.dtype,
                      device=rows.device)
    for v in range(g.shape[-2]):
        acc = acc + g[..., v, :]
    logp = acc - math.log(C)
    return logp, torch.softmax(logp, dim=-1)


def entropy_ref(logits):
    """Predictive entropy per row: (..., V) float32 or bfloat16 logits ->
    (...) float32. Same op order as the JAX package's oracle: log-softmax
    in float32, then ``-(exp(logp) * logp).sum(-1)``."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -(torch.exp(logp) * logp).sum(-1)


def margin_ref(logits):
    """Top-1 minus top-2 softmax probability per row (a low margin is an
    uncertain row): (..., V) logits, V >= 2 -> (...) float32."""
    p = torch.softmax(logits.to(torch.float32), dim=-1)
    top2 = torch.topk(p, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def ordered_matmul_ref(A, B):
    """``A (..., n, k) @ B (..., k, m)``, each output the sum of its k
    products added in index order by one sequential ``segment_reduce``: the
    product tensor, then :func:`segment_sum_ref` over it. It holds all
    n·k·m products at once."""
    p = A[..., :, :, None] * B[..., None, :, :]
    lead, k, m = p.shape[:-2], p.shape[-2], p.shape[-1]
    return segment_sum_ref(p.reshape((-1, k, m)), k).reshape(lead + (m,))


def segment_sum_ref(g, size: int):
    """``(R, S*size, C)`` -> ``(R, S, C)``: each run of ``size`` rows summed
    in index order from 0 by a sequential ``segment_reduce``."""
    lengths = torch.full((g.shape[0], g.shape[1] // size), size,
                         dtype=torch.int64, device=g.device)
    return torch.segment_reduce(g, "sum", lengths=lengths, axis=1,
                                unsafe=True)


def attention_ref(q, k, v, *, causal=True, window=0):
    """Materialized GQA attention in float32. q: (B, Hq, Sq, D); k, v:
    (B, Hkv, Sk, D); q head h reads kv head h // (Hq // Hkv). Masks by
    index: causal keeps k <= q, a window keeps q - k < window; a masked
    score is -1e30 (a row with no valid key averages v); scores are
    scaled by 1 / sqrt(D). The normalized p is rounded to v's dtype before
    p v, as the JAX package's ``_attn_direct`` does (a no-op in float32).
    Returns (B, Hq, Sq, D) in q's dtype."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kk = k.repeat_interleave(G, dim=1).to(torch.float32)
    vv = v.repeat_interleave(G, dim=1).to(torch.float32)
    s = (torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk)
         * (1.0 / math.sqrt(D)))
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= qp - kp < window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(v.dtype).to(torch.float32)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def linear_scan_ref(a, b, h0=None):
    """The diagonal recurrence h_t = a_t * h_{t-1} + b_t over (B, S, D),
    from h0 (B, D) or zero, in float32 (a multiply, then an add, both
    rounded, step by step in order, as the CUDA kernel does). Returns
    (B, S, D) in a's dtype."""
    B, S, D = a.shape
    af, bf = a.to(torch.float32), b.to(torch.float32)
    h = (torch.zeros((B, D), dtype=torch.float32, device=a.device)
         if h0 is None else h0.to(torch.float32))
    out = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)


def attention_bwd_ref(q, k, v, o, do, *, causal=True, window=0):
    """The gradient of :func:`attention_ref` in float32, with P
    materialized. q, o, do: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D). With
    s = scale q k^T (masked -1e30), p = softmax(s), delta = rowsum(do o):
    dv = round(p)^T do with p rounded to v's dtype as the forward rounds it
    (the cast's gradient is the identity; a no-op in float32), ds = p (do
    v^T - delta), dq = scale ds k, dk = scale ds^T q, dk and dv summed over
    each kv head's G query heads. Returns (dq, dk, dv) in q's, k's and v's
    dtypes."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf, of, gf = q.float(), o.float(), do.float()
    kk = k.repeat_interleave(G, dim=1).to(torch.float32)
    vv = v.repeat_interleave(G, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= qp - kp < window
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, -1e30)), -1)
    delta = (gf * of).sum(-1, keepdim=True)
    pv = p.to(v.dtype).to(torch.float32)
    dv = torch.einsum("bhqk,bhqd->bhkd", pv, gf)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, vv) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    fold = lambda t: t.reshape(B, Hkv, G, Sk, D).sum(2)
    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


def linear_scan_bwd_ref(a, h, g, h0=None):
    """The gradient of :func:`linear_scan_ref` from its output h and the
    output gradient g, all (B, S, D), walking t in reverse in float32:
    dh_t = g_t + a_{t+1} * dh_{t+1} (a multiply, then an add, both
    rounded), da_t = dh_t * h_{t-1} (h_{-1} = h0 or 0), db_t = dh_t, and
    dh0 = a_0 * dh_0, as the CUDA kernel computes them. Returns (da, db)
    in a's dtype and dh0 (B, D) float32."""
    B, S, D = a.shape
    af, hf, gf = a.to(torch.float32), h.to(torch.float32), g.to(torch.float32)
    hinit = (torch.zeros((B, D), dtype=torch.float32, device=a.device)
             if h0 is None else h0.to(torch.float32))
    da = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    db = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    dh = None
    for t in range(S - 1, -1, -1):
        dh = gf[:, t] if t == S - 1 else gf[:, t] + af[:, t + 1] * dh
        da[:, t] = dh * (hf[:, t - 1] if t > 0 else hinit)
        db[:, t] = dh
    dh0 = (af[:, 0] * dh if S > 0
           else torch.zeros((B, D), dtype=torch.float32, device=a.device))
    return da.to(a.dtype), db.to(a.dtype), dh0


# steps per chunk of the chunked scan; csrc/linear_scan.cu's kL, which the
# wrapper checks against this at load
SCAN_CHUNK = 8


def _chunks(x, n, lead=0):
    """(B, S, D) float32 -> (B, n, SCAN_CHUNK, D), after ``lead`` zero rows
    in front (dropping as many at the end) and zero rows past S."""
    B, S, D = x.shape
    z = lambda k: torch.zeros((B, k, D), dtype=torch.float32,
                              device=x.device)
    body = x if lead == 0 else torch.cat([z(lead), x[:, :S - lead]], 1)
    pad = n * SCAN_CHUNK - S
    body = torch.cat([body, z(pad)], 1) if pad else body
    return body.reshape(B, n, SCAN_CHUNK, D)


def linear_scan_chunked_ref(a, b, h0=None):
    """:func:`linear_scan_ref` in chunks of ``SCAN_CHUNK`` steps, as the
    chunked CUDA kernel computes it, vectorized over the chunks: each
    chunk's pair from (1, 0), step by step in order (A = a A, B = a B + b);
    the carries in chunk order (H_c = A_c H_{c-1} + B_c from h0 or 0); then
    each chunk walked again from H_{c-1} with the sequential step h = a h +
    b. Every multiply and add is rounded on its own, so for S <= SCAN_CHUNK
    it equals :func:`linear_scan_ref` bit for bit. Returns (B, S, D) in a's
    dtype."""
    B, S, D = a.shape
    n = -(-S // SCAN_CHUNK)
    af, bf = _chunks(a.to(torch.float32), n), _chunks(b.to(torch.float32), n)
    A = torch.ones((B, n, D), dtype=torch.float32, device=a.device)
    Bc = torch.zeros((B, n, D), dtype=torch.float32, device=a.device)
    for u in range(SCAN_CHUNK):
        A = af[:, :, u] * A
        Bc = af[:, :, u] * Bc + bf[:, :, u]
    h = (torch.zeros((B, D), dtype=torch.float32, device=a.device)
         if h0 is None else h0.to(torch.float32))
    hin = torch.empty((B, n, D), dtype=torch.float32, device=a.device)
    for c in range(n):
        hin[:, c] = h
        h = A[:, c] * h + Bc[:, c]
    out = torch.empty_like(af)
    h = hin
    for u in range(SCAN_CHUNK):
        h = af[:, :, u] * h + bf[:, :, u]
        out[:, :, u] = h
    return out.reshape(B, n * SCAN_CHUNK, D)[:, :S].to(a.dtype)


def linear_scan_chunked_bwd_ref(a, h, g, h0=None):
    """:func:`linear_scan_bwd_ref` in chunks of ``SCAN_CHUNK`` steps, as the
    chunked CUDA kernel computes it, vectorized over the chunks and walked
    in reverse: each chunk's pair from (1, 0) from its last step down (A =
    a_{t+1} A, B = a_{t+1} B + g_t, with a_S = 0); the carries from the
    last chunk down (dh after chunk c = A_c dh + B_c, from 0); then each
    chunk walked again from its carry with dh_t = g_t + a_{t+1} dh_{t+1}
    (dh_{S-1} = g_{S-1}), da_t = dh_t h_{t-1} (h_{-1} = h0 or 0), db_t =
    dh_t, and dh0 = a_0 dh_0. Every multiply and add is rounded on its own,
    so for S <= SCAN_CHUNK it equals :func:`linear_scan_bwd_ref` bit for
    bit. Returns (da, db) in a's dtype and dh0 (B, D) float32."""
    B, S, D = a.shape
    dev = a.device
    if S == 0:
        return (torch.empty_like(a), torch.empty_like(a),
                torch.zeros((B, D), dtype=torch.float32, device=dev))
    n = -(-S // SCAN_CHUNK)
    af, gf = a.to(torch.float32), g.to(torch.float32)
    hinit = (torch.zeros((B, D), dtype=torch.float32, device=dev)
             if h0 is None else h0.to(torch.float32))
    an = _chunks(torch.cat([af[:, 1:], torch.zeros_like(af[:, :1])], 1),
                 n)                                             # a_{t+1}
    gc = _chunks(gf, n)
    hp = _chunks(h.to(torch.float32), n, lead=1)                # h_{t-1}
    hp[:, 0, 0] = hinit
    A = torch.ones((B, n, D), dtype=torch.float32, device=dev)
    Bc = torch.zeros((B, n, D), dtype=torch.float32, device=dev)
    for u in range(SCAN_CHUNK - 1, -1, -1):
        A = an[:, :, u] * A
        Bc = an[:, :, u] * Bc + gc[:, :, u]
    cin = torch.empty((B, n, D), dtype=torch.float32, device=dev)
    carry = torch.zeros((B, D), dtype=torch.float32, device=dev)
    for c in range(n - 1, -1, -1):
        cin[:, c] = carry
        carry = A[:, c] * carry + Bc[:, c]
    da = torch.empty_like(an)
    db = torch.empty_like(an)
    dh, last = cin, (S - 1) % SCAN_CHUNK
    for u in range(SCAN_CHUNK - 1, -1, -1):
        dh = gc[:, :, u] + an[:, :, u] * dh
        if u == last:
            dh[:, n - 1] = gc[:, n - 1, u]                    # t = S - 1
        da[:, :, u] = dh * hp[:, :, u]
        db[:, :, u] = dh
    dh0 = af[:, 0] * dh[:, 0]
    cut = lambda x: x.reshape(B, n * SCAN_CHUNK, D)[:, :S].to(a.dtype)
    return cut(da), cut(db), dh0


def xent_ref(logits, targets):
    """Per-row cross entropy: (N, V) float32 or bfloat16 logits and (N,)
    targets -> (N,) float32. The JAX package's oracle: float32 logsumexp
    minus the target logit."""
    x = logits.to(torch.float32)
    lse = torch.logsumexp(x, dim=-1)
    lt = torch.take_along_dim(x, targets.long()[:, None], dim=1)[:, 0]
    return lse - lt


def xent_bwd_ref(logits, targets, lse, g):
    """The gradient of :func:`xent_ref`: dlogits_ij = g_i (exp(x_ij -
    lse_i) - [j = t_i]) in float32, returned in the logits' dtype.
    lse: (N,) float32 log-sum-exp of the rows; g: (N,) float32."""
    p = torch.exp(logits.to(torch.float32) - lse[:, None])
    hit = torch.zeros_like(p).scatter_(1, targets.long()[:, None], 1.0)
    return (g[:, None] * (p - hit)).to(logits.dtype)
