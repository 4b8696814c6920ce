"""Transformer layers (port of ``src/repro/models/layers.py``): norms, RoPE,
GQA attention, the attention block's projections, the MLP and the
capacity-routed MoE, on one device and on a mesh.

Tensors keep the reference's layouts: activations (B, S, d), attention
operands (B, S, H, D). :func:`attention` takes the reference's routes
(``impl``): ``auto``, ``flash_xla`` and ``band`` (with their ``":cq[:ck]"``
tile suffix) go through the :mod:`repro_torch.kernels.flash_attention`
wrapper (the Hopper kernel on the card, its plain version on the CPU),
which computes the same online-softmax function as the reference's jnp
``_attn_flash_xla`` and skips fully masked tiles as ``_attn_band`` does;
it masks by index, so it serves train and prefill (positions are the
index), cross-attention and the encoder (masks that do not depend on
positions). ``direct`` (decode over a cache, whose slots carry positions)
is the reference's ``_attn_direct``, plain materialized attention masked
by position on either device.

:func:`apply_moe` is the reference's group-local capacity dispatch
(``groups``), :func:`_moe_local` the device-local dispatch of the MoE's
``shard_map`` island and :func:`apply_moe_shardmap` that island over an
:class:`~repro_torch.launch.mesh.LMMesh`: every (data, model) slot
dispatches its data group's tokens to its ``ffn`` shard of the experts,
the partial outputs are added over ``model`` in slot order and the aux
loss is averaged over every slot, as the reference's ``shard_map``
computes them.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import P, Sharded, gather_copies, shard
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.params import PSpec
from repro_torch.obs import timing

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


ROUTES = ("auto", "direct", "flash_xla", "band")


def parse_impl(impl: str):
    """The reference's ``impl``: a route of :data:`ROUTES`, with tiles
    ``flash_xla:cq[:ck]`` or ``band:cq`` (positive integers). Returns
    ``(route, tiles)``."""
    name, *parts = str(impl).split(":")
    if name not in ROUTES:
        raise ValueError(f"attention impl must be one of {ROUTES} (flash_xla "
                         f"and band with ':cq[:ck]' tiles), got {impl!r}")
    most = {"flash_xla": 2, "band": 1}.get(name, 0)
    if len(parts) > most:
        raise ValueError(f"attention impl {impl!r}: {name} takes at most "
                         f"{most} tile size(s)")
    try:
        tiles = tuple(int(t) for t in parts)
    except ValueError:
        raise ValueError(f"attention impl {impl!r}: tile sizes must be "
                         "integers") from None
    if any(t < 1 for t in tiles):
        raise ValueError(f"attention impl {impl!r}: tile sizes must be >= 1")
    return name, tiles


def attention(q, k, v, *, q_pos=None, k_pos=None, causal=True, window=0,
              impl="auto", mixed=False):
    """GQA attention. q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D). Returns
    (B, Sq, Hq, D) in ``v``'s dtype.

    ``impl`` ``auto``, ``flash_xla`` and ``band`` go through the flash
    kernel's wrapper, which masks by index: the positions are the index
    (None, or vectors equal to ``arange(S)``: train, prefill), or the mask
    does not depend on them (no causality, no window, no ``k_pos``:
    cross-attention, the encoder); other positions raise on either device.
    The kernel keeps its own tiles: the reference's ``cq`` / ``ck`` are
    checked and change nothing. ``impl="direct"`` masks by the position
    vectors ((S,) or (B, S), default the index; a negative ``k_pos`` marks
    an empty cache slot) on either device: the reference's decode route.

    ``mixed`` is the reference's ``attn_bf16``: its bfloat16 products with
    float32 accumulation equal the float32 products of bfloat16 operands,
    and it rounds p to v's dtype before p v. Both routes already do so:
    the direct route always (as the reference's ``_attn_direct``), the
    kernel on bfloat16 operands (its p v runs on bfloat16 tensor cores)."""
    route, _ = parse_impl(impl)
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    if route != "direct":
        by_index = ((q_pos is None or _is_index(q_pos, Sq))
                    and (k_pos is None or _is_index(k_pos, Sk)))
        # without causality or a window only k_pos (empty slots) shapes it
        free = k_pos is None and not causal and window == 0
        if not (by_index or free):
            raise ValueError(f"attention impl={impl!r} masks by index: "
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


def _moe_tokens(p, xf, cfg, C, round_weights):
    """One capacity dispatch of (T, d) tokens ``xf``: routing, the experts'
    FFN over C slots each, and the combine. ``round_weights`` rounds the
    route weights to xf's dtype before they scale the expert outputs (the
    reference's ``_moe_local``); otherwise each product is rounded
    (``apply_moe``). Returns (out (T, d), probs (T, E) float32, topi)."""
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    with timing.span("moe.dispatch"):
        probs = torch.softmax((xf @ p["router"]).to(torch.float32), dim=-1)
        r = moe_dispatch(probs, k, C)
        dest, keep, order = r["dest"], r["keep"], r["order"]
        xe = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
        xe = xe.index_put((dest,), xf[r["tok"]])
        xe = xe[:-1].reshape(E, C, d)
    act = act_fn(cfg)
    h = act(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).reshape(E * C, d)
    with timing.span("moe.combine"):
        w_slot = r["topw"].reshape(T * k)[order]
        ys = torch.where(keep[:, None], ye[torch.clamp(dest, max=E * C - 1)],
                         torch.zeros((), dtype=ye.dtype, device=ye.device))
        if round_weights:
            contrib = ys * w_slot.to(xf.dtype)[:, None]
        else:
            contrib = (ys * w_slot[:, None]).to(xf.dtype)  # expert order
        # each token's k slots, in the order the sorted slots visit them
        pos = torch.empty_like(order)
        pos[order] = torch.arange(T * k, device=xf.device)
        pos = torch.sort(pos.reshape(T, k), dim=-1).values
        parts = contrib[pos]                             # (T, k, d)
        out = torch.zeros((T, d), dtype=xf.dtype, device=xf.device)
        for j in range(k):
            out = out + parts[:, j]
    return out, probs, r["topi"]


def _aux(probs, topi, E):
    """The switch-style load-balancing loss of (T, E) probabilities and
    (T, k) picks: E * sum(mean prob * share of the T * k slots)."""
    T, k = topi.shape
    ce = torch.bincount(topi.reshape(-1), minlength=E)
    return E * torch.sum(probs.mean(0) * (ce.to(torch.float32) / (T * k)))


def apply_moe(p, x, cfg, cons=None, groups=1):
    """Capacity-routed top-k MoE on (B, S, d) x with the reference's
    group-local dispatch: the T = B * S tokens split into G = ``groups``
    consecutive groups (G = 1 when it does not divide T), each dispatched
    on its own with C = :func:`moe_capacity` (T / G) slots per expert.
    Returns (y (B, S, d) in x's dtype, the float32 switch-style aux loss
    over all tokens). ``cons`` is the activation-sharding hook (the
    reference also constrains the dispatched slots, a (G, E, C, d) tensor
    the port, dispatching group by group, never forms).

    Each expert takes at most C slots in token order; overflowing slots go
    to a drop row that is thrown away (several writes land there; which
    one wins does not matter). The combine adds a token's k weighted
    expert outputs, each rounded to x's dtype, into a zero row in
    ascending expert order, one rounding per add: the order in which the
    reference's scatter-add visits them (its slots are sorted by expert),
    and no float atomics."""
    B, S, d = x.shape
    T = B * S
    G = groups if T % groups == 0 else 1
    Tg = T // G
    xf = x.reshape(G, Tg, d)
    if cons is not None:
        xf = cons(xf, ("batch", "seq", "embed_act"))
    C = moe_capacity(cfg, Tg)
    res = [_moe_tokens(p, xf[g], cfg, C, False) for g in range(G)]
    out = res[0][0] if G == 1 else torch.cat([r[0] for r in res])
    probs = res[0][1] if G == 1 else torch.cat([r[1] for r in res])
    topi = res[0][2] if G == 1 else torch.cat([r[2] for r in res])
    return out.reshape(B, S, d), _aux(probs, topi, cfg.n_experts)


def _moe_local(p_local, x_flat, cfg):
    """The device-local capacity dispatch of the reference's MoE island:
    (T_l, d) local tokens through the local weight shards (``router``
    (d, E), ``w_gate`` / ``w_up`` (E, d, f_l), ``w_down`` (E, f_l, d)),
    C = :func:`moe_capacity` (T_l) slots per expert, the route weights
    rounded to the activations' dtype before the multiply. Returns the
    PARTIAL (T_l, d) output (summed over ``model`` by the caller) and the
    slot's aux loss."""
    C = moe_capacity(cfg, x_flat.shape[0])
    out, probs, topi = _moe_tokens(p_local, x_flat, cfg, C, True)
    return out, _aux(probs, topi, cfg.n_experts)


_ISLAND_SPECS = {"router": P("data", None),
                 "w_gate": P(None, "data", "model"),
                 "w_up": P(None, "data", "model"),
                 "w_down": P(None, "model", "data")}


def _moe_island(p, xs, cfg, mesh):
    """The MoE island over ``mesh``: ``p`` the MoE's ``router`` / ``w_gate``
    / ``w_up`` / ``w_down`` as :class:`Sharded` leaves (any layout), ``xs``
    the data groups' (B_l, S, d) activations on their lead slots. Slot
    (i, j) runs :func:`_moe_local` on group i's tokens with the whole
    router and ``ffn`` shard j of the experts, gathered onto its device;
    group i's output is its slots' partial outputs added over ``model`` in
    slot order on its lead slot, and the aux loss the mean over every slot.
    Returns (the groups' outputs, aux on the mesh's lead device)."""
    nd, nm = mesh.shape["data"], mesh.shape["model"]
    d, f = cfg.d_model, cfg.d_ff
    if f % nm or d % nd:
        raise ValueError(f"the MoE island splits d_ff={f} over model={nm} "
                         f"and d_model={d} over data={nd}: both must divide")
    fl = f // nm
    every = slice(None)
    ffn = lambda j: slice(j * fl, (j + 1) * fl)
    regions = {"router": lambda j: None,
               "w_gate": lambda j: (every, every, ffn(j)),
               "w_up": lambda j: (every, every, ffn(j)),
               "w_down": lambda j: (every, ffn(j), every)}
    slots = mesh.slots()
    devs = [mesh.devices[i][j] for i, j in slots]
    w = {name: gather_copies(p[name], [(devs[s], reg(j)) for s, (_, j)
                                       in enumerate(slots)])
         for name, reg in regions.items()}
    outs, auxs = [], []
    for s, (i, j) in enumerate(slots):
        bl, sl, _ = xs[i].shape
        pl = {name: w[name][s].to(xs[i].dtype) for name in regions}
        out, aux = _moe_local(pl, xs[i].reshape(bl * sl, d).to(devs[s]),
                              cfg)
        outs.append(out)
        auxs.append(aux)
    ys = [mesh.psum(outs[i * nm:(i + 1) * nm], "model",
                    mesh.devices[i][0]).reshape(xs[i].shape)
          for i in range(nd)]
    return ys, mesh.pmean(auxs, ("data", "model"), mesh.lead)


def apply_moe_shardmap(p, x, cfg, mesh):
    """The reference's production MoE over an
    :class:`~repro_torch.launch.mesh.LMMesh`: (B, S, d) x split over the
    data axis (B must divide), the weights (tensors, laid out by the
    island's specs, or :class:`Sharded` leaves) gathered as
    :func:`_moe_island` says. Returns (y (B, S, d) on the mesh's lead
    device, the aux loss there)."""
    nd = mesh.shape["data"]
    B = x.shape[0]
    if B % nd:
        raise ValueError(f"apply_moe_shardmap: batch {B} does not split over "
                         f"data={nd}")
    p = {k: p[k] if isinstance(p[k], Sharded) else shard(p[k], spec, mesh)
         for k, spec in _ISLAND_SPECS.items()}
    rows = B // nd
    xs = [x[i * rows:(i + 1) * rows].to(mesh.devices[i][0])
          for i in range(nd)]
    ys, aux = _moe_island(p, xs, cfg, mesh)
    return mesh.all_gather(ys, "data", 0, mesh.lead), aux
