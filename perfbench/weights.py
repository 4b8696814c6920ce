"""Model inputs made from the seed on the card: an encoder's weights in the
type they are served in, and the feature projection.

The weights take the program's parameter layout (its template gives each
leaf's shape and kind of initialisation) and the distributions of its
initialiser: N(0, 1/fan_in) for matrices, N(0, 0.02^2) for the embedding,
ones for norm scales, zeros for biases. They are drawn as one bfloat16
normal buffer from a ``torch.Generator`` on the card, and each leaf is a
scaled view of it, so a 3.3 B-parameter model takes one call and no host
memory. The same seed gives the same weights on every run.

:func:`fold_multipliers` scales them by a configuration's published
multipliers, so that a program that applies none computes the published
function; :func:`add_topics` gives the embedding and the routers a topic
structure, so that texts of one topic favour a few experts.
"""
from __future__ import annotations

import math

import torch


def _scale(shape, init):
    if init == "embed":
        return 0.02
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def draw_weights(template_leaves, seed: int, device, dtype=torch.bfloat16):
    """``(generator, tensors)``: one tensor a leaf of ``template_leaves``
    (the program's leaves in its flatten order, each with ``shape`` and
    ``init``), drawn from a generator on ``device`` seeded with ``seed``;
    the generator is returned to draw what follows from the same stream."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    drawn = [p for p in template_leaves if p.init in ("fan_in", "embed")]
    other = {p.init for p in template_leaves} - {"fan_in", "embed", "ones",
                                                 "zeros"}
    if other:
        raise ValueError(f"no draw for initialisers {sorted(other)}")
    total = sum(math.prod(p.shape) for p in drawn)
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    out, at = [], 0
    for p in template_leaves:
        if p.init == "ones":
            out.append(torch.ones(p.shape, dtype=dtype, device=device))
        elif p.init == "zeros":
            out.append(torch.zeros(p.shape, dtype=dtype, device=device))
        else:
            n = math.prod(p.shape)
            out.append(flat[at:at + n].view(p.shape).mul_(
                _scale(p.shape, p.init)))
            at += n
    return gen, out


def draw_projection(gen, d_model: int, n_features: int, device):
    """A Gaussian projection d_model -> n_features in float32, scaled by
    1/sqrt(n_features), drawn from ``gen``."""
    z = torch.randn((d_model, n_features), generator=gen,
                    dtype=torch.float32, device=device)
    return z / math.sqrt(n_features)


def fold_multipliers(W: dict, mult: dict, head_dim: int):
    """Scale the weights ``W`` (by the reference's names, in place) so that
    a model without multipliers computes the one with them: the embedding
    by ``embedding_multiplier``, the queries by ``attention_multiplier``
    times sqrt(head_dim) (scores scaled by the multiplier, not by
    1/sqrt(head_dim)), and each block's output projection (``wo``, the
    experts' ``w_down``) by ``residual_multiplier``."""
    W["embed"].mul_(mult["embedding_multiplier"])
    W["wq"].mul_(mult["attention_multiplier"] * math.sqrt(head_dim))
    W["wo"].mul_(mult["residual_multiplier"])
    W["w_down"].mul_(mult["residual_multiplier"])


def add_topics(W: dict, topics: dict, gen, device):
    """A topic structure in the weights ``W`` (in place), drawn from
    ``gen``: ``n`` unit directions, one a topic; the embedding rows of topic
    z's block of ``vocab // n`` ids share ``embed_share`` of their variance
    along z's direction; in every layer each topic favours
    ``experts_per_topic`` experts drawn at random, whose router columns
    gain ``router_boost`` times the topic's direction. A token whose hidden
    state leans along z then sends most of its picks to z's experts."""
    emb, router = W["embed"], W["router"]
    V, d = emb.shape
    n_layers, E = router.shape[0], router.shape[-1]
    Z, k = int(topics["n"]), int(topics["experts_per_topic"])
    u = torch.randn((Z, d), generator=gen, dtype=torch.float32,
                    device=device)
    u = u / u.norm(dim=-1, keepdim=True)
    share = float(topics["embed_share"])
    rows = emb[:Z * (V // Z)].view(Z, V // Z, d)
    scale = rows.float().pow(2).mean().sqrt()
    rows.copy_((rows.float() * math.sqrt(1.0 - share)
                + math.sqrt(share * d) * scale * u[:, None, :]).to(emb.dtype))
    pick = torch.rand((n_layers, Z, E), generator=gen, device=device
                      ).argsort(-1)[..., :k]
    member = torch.zeros((n_layers, Z, E), device=device).scatter_(
        -1, pick, 1.0)
    router.add_(float(topics["router_boost"])
                * torch.einsum("zd,lze->lde", u, member).to(router.dtype))
