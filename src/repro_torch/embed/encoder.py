"""Batched embedding extraction through the port's model (port of
``src/repro/embed/encoder.py``).

Token sequences run through :func:`repro_torch.models.model.forward` with
``logits_mode="hidden"`` (bfloat16 compute, float32 final-norm hidden
states), are pooled over the real positions (masked mean or the last real
token) and projected to the learner's feature width by a seeded Gaussian
projection. Every micro-batch has the static ``batch_size``: a short last
chunk is padded by repeating its last row and the pad rows are dropped, so
a row's features do not depend on how many tasks are encoded (on the card
cuBLAS picks its algorithms by the row count, so a smaller batch could
round differently).

The model parameters and the projection are drawn from a CPU
``torch.Generator`` seeded with ``EmbedConfig.seed`` (the same tensors on
every device; the reference draws other numbers with ``jax.random``) and
cached per architecture, seed and device. The reference's multi-device
``pmap`` over micro-batches has no meaning on one card and is not ported.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import full_fp32, resolve_device
from repro_torch.embed.config import EmbedConfig
from repro_torch.models.model import compute_params, forward, model_template
from repro_torch.models.params import init_params
from repro_torch.obs import timing

# offset of the projection's stream from the parameters' (the reference
# folds 0x9E3779B9 into the seed's key)
_PROJ_SEED = 0x9E3779B9


@functools.lru_cache(maxsize=None)
def resolved_config(ec: EmbedConfig):
    """The (possibly reduced) ModelConfig behind an EmbedConfig."""
    cfg = get_config(ec.model)
    return reduced(cfg) if ec.reduced else cfg


def device_key(device) -> str:
    """The cache key of ``device``: ``"cpu"`` or ``"cuda:<index>"``, so
    that ``"cuda"`` and the current card's ``"cuda:0"`` share one entry."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


# two parameter sets at most: a full-width recurrentgemma-2b (11.6 GB of
# float32 master weights) and a full-width xlstm-125m (0.5 GB) fit together
@functools.lru_cache(maxsize=2)
def _params(model: str, is_reduced: bool, seed: int, device: str):
    cfg = resolved_config(EmbedConfig(model=model, reduced=is_reduced))
    gen = torch.Generator().manual_seed(seed)
    return init_params(model_template(cfg), gen, device=device)


def model_params(ec: EmbedConfig, device="cuda"):
    """Seeded random-init float32 parameters of the embedding model on
    ``device`` (no training: random features through a structured
    architecture are the reference's baseline too)."""
    return _params(ec.model, ec.reduced, ec.seed, device_key(device))


@functools.lru_cache(maxsize=8)
def _projection(model, is_reduced, seed, n_features, device):
    cfg = resolved_config(EmbedConfig(model=model, reduced=is_reduced))
    gen = torch.Generator().manual_seed(seed + _PROJ_SEED)
    z = torch.randn((cfg.d_model, n_features), generator=gen,
                    dtype=torch.float32)
    return (z / torch.sqrt(torch.tensor(n_features,
                                        dtype=torch.float32))).to(device)


def projection(ec: EmbedConfig, n_features: int, device="cuda"):
    """Seeded Gaussian projection d_model -> n_features, scaled by
    1/sqrt(n_features) (variance preserving)."""
    if ec.projection_dim is not None and ec.projection_dim != n_features:
        raise ValueError(
            f"EmbedConfig.projection_dim={ec.projection_dim} != requested "
            f"feature width {n_features}")
    return _projection(ec.model, ec.reduced, ec.seed, n_features,
                       device_key(device))


def _cross_src(cfg, B, device):
    """The zero cross source of the architectures that need one (whisper's
    encoder frames, the VLM's image tokens), (B, T, d) bfloat16: the task
    text carries the signal. None for the others."""
    n = (cfg.encoder_seq if cfg.is_encoder_decoder else cfg.n_img_tokens)
    if not n:
        return None
    return torch.zeros((B, n, cfg.d_model), dtype=torch.bfloat16,
                       device=device)


def _embed_batch(cfg, params, tokens, lengths, pooling, proj):
    """(B, T) tokens + (B,) lengths -> (B, F) float32 features."""
    B, T = tokens.shape
    hidden, _, _ = forward(params, cfg, tokens, mode="train",
                           logits_mode="hidden",
                           cross_src=_cross_src(cfg, B, tokens.device))
    with full_fp32():
        if pooling == "mean":
            mask = (torch.arange(T, device=tokens.device)[None, :]
                    < lengths[:, None])
            pooled = ((hidden * mask[:, :, None]).sum(1)
                      / torch.clamp(lengths, min=1).to(torch.float32)[:, None])
        else:                                 # "last": final real token
            pooled = hidden[torch.arange(B, device=tokens.device),
                            torch.clamp(lengths - 1, min=0).long()]
        return (pooled @ proj).to(torch.float32)


def encode(ec: EmbedConfig, tokens, lengths, n_features: int, *,
           device="cuda", params=None, proj=None):
    """Embed ``(N, seq_len)`` token sequences to ``(N, n_features)``
    float32 on ``device``, in micro-batches of ``ec.batch_size``.

    ``params`` (a float32 parameter tree on ``device``, e.g. from
    :func:`repro_torch.models.params.params_from_numpy`) and ``proj``
    replace the seeded draws."""
    dev = resolve_device(device)
    cfg = resolved_config(ec)
    params = model_params(ec, dev) if params is None else params
    proj = projection(ec, n_features, dev) if proj is None else proj
    cparams = compute_params(params)          # bfloat16 once, not per batch
    tokens = torch.as_tensor(tokens, dtype=torch.int32).to(dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32).to(dev)
    if tokens.dim() != 2 or tokens.shape[1] != ec.seq_len:
        raise ValueError(f"tokens must be (N, seq_len={ec.seq_len}), "
                         f"got {tuple(tokens.shape)}")
    N, B = int(tokens.shape[0]), ec.batch_size
    feats = []
    for i in range(0, N, B):
        with timing.span("encode.batch"):
            tb, lb = tokens[i:i + B], lengths[i:i + B]
            n = int(tb.shape[0])
            if n < B:
                tb = torch.cat([tb, tb[-1:].expand(B - n, -1)])
                lb = torch.cat([lb, lb[-1:].expand(B - n)])
            feats.append(_embed_batch(cfg, cparams, tb, lb, ec.pooling,
                                      proj)[:n])
    if not feats:
        return torch.empty((0, n_features), dtype=torch.float32, device=dev)
    return torch.cat(feats, dim=0)
