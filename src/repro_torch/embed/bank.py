"""Embedding bank and LM-feature datasets (port of
``src/repro/embed/bank.py``).

:func:`make_dataset` builds the batch learning loop's train/test matrices
from a synthetic corpus encoded through the model (what
``run_learning`` uses for ``features.kind="lm"``). :func:`embedding_bank`
precomputes the standardized ``(2, n_classes, variants, n_features)`` bank
(easy/hard x class x variant) that the stream and serve ticks gather from
with :func:`bank_gather` (``labelstream.router._bank_for``), cached per
embedding config, workload and device; :func:`embed_texts` maps submitted
text into the bank's feature space for the live server.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.embed.config import EmbedConfig
from repro_torch.embed.corpus import make_tokens, tokenize_text
from repro_torch.embed.encoder import device_key, encode, resolved_config
from repro_torch.learning.features import standardize


class EmbeddingBank(NamedTuple):
    """``feats[h, c, v]`` is variant ``v`` of an easy (``h=0``) or hard
    (``h=1``) task of class ``c``, standardized over the bank; ``mean`` and
    ``std`` are the bank's statistics before standardizing."""
    feats: torch.Tensor                  # (2, C, K, F)
    mean: torch.Tensor                   # (F,)
    std: torch.Tensor                    # (F,)

    @property
    def n_classes(self) -> int:
        return self.feats.shape[1]

    @property
    def n_variants(self) -> int:
        return self.feats.shape[2]

    @property
    def n_features(self) -> int:
        return self.feats.shape[3]


@functools.lru_cache(maxsize=None)
def _bank(ec, n_classes, n_features, class_sep, hard_sep_scale, device):
    C = n_classes
    if ec.bank_size % (2 * C) != 0 or ec.bank_size < 2 * C:
        raise ValueError(
            f"EmbedConfig.bank_size={ec.bank_size} must be a positive "
            f"multiple of 2 * n_classes = {2 * C} (easy/hard x class x "
            "variant layout)")
    K = ec.bank_size // (2 * C)
    hard = np.repeat(np.arange(2), C * K).astype(bool)
    labels = np.tile(np.repeat(np.arange(C, dtype=np.int32), K), 2)
    cfg = resolved_config(ec)
    tokens, lengths = make_tokens(ec, labels, hard, C, cfg.vocab_size,
                                  class_sep, hard_sep_scale)
    E = encode(ec, tokens, lengths, n_features, device=device)
    mu, sd = E.mean(dim=0), E.std(dim=0, correction=0)
    return EmbeddingBank(feats=standardize(E).reshape(2, C, K, n_features),
                         mean=mu, std=sd)


def embedding_bank(ec: EmbedConfig, n_classes: int, n_features: int,
                   class_sep: float, hard_sep_scale: float = 1.0, *,
                   device="cuda") -> EmbeddingBank:
    """Build (and cache) the bank for one embedding + workload config, per
    device."""
    return _bank(ec, n_classes, n_features, class_sep, hard_sep_scale,
                 device_key(device))


def bank_gather(feats, u, tl, diff):
    """Bank lookup: a uniform ``u`` in [0, 1) picks the variant, ``tl`` the
    class row, ``diff < 1`` the hard half."""
    K = feats.shape[2]
    v = torch.clamp((u * K).to(torch.int64), max=K - 1)
    h = (diff < 1.0).to(torch.int64)
    return feats[h, torch.clamp(tl.to(torch.int64), 0, feats.shape[1] - 1), v]


def embed_texts(ec: EmbedConfig, texts, n_classes: int, n_features: int,
                class_sep: float, hard_sep_scale: float = 1.0, *,
                device="cuda"):
    """Encode submitted text into the bank's feature space: hash-tokenize,
    encode, then normalize with the bank's statistics (not the batch's).
    Returns ``(N, n_features)`` float32 on ``device``."""
    bank = embedding_bank(ec, n_classes, n_features, class_sep,
                          hard_sep_scale, device=device)
    cfg = resolved_config(ec)
    pairs = [tokenize_text(t, ec.seq_len, cfg.vocab_size) for t in texts]
    tokens = np.stack([p[0] for p in pairs])
    lengths = np.asarray([p[1] for p in pairs], np.int32)
    E = encode(ec, tokens, lengths, n_features, device=device)
    return (E - bank.mean) / torch.clamp(bank.std, min=1e-6)


def make_dataset(spec, n_train: int, n_test: int, seed: int = 0, *,
                 device="cuda", u=None, ul=None, params=None, proj=None):
    """LM-feature dataset for the batch learning loop from a
    :class:`~repro_torch.scenarios.registry.LearningSpec`: labels and
    difficulty flags from a numpy generator seeded with ``seed``, a fresh
    corpus (the dataset seed folds into the embed seed, so datasets never
    alias the bank), encoded on ``device`` and standardized. Returns numpy
    ``(X, y, X_test, y_test)``. ``u``/``ul`` (the corpus's uniforms) and
    ``params``/``proj`` (the model's) replace the seeded draws."""
    dev = resolve_device(device)
    ec = spec.embed
    C = spec.n_classes
    rng = np.random.default_rng(seed)
    N = n_train + n_test
    labels = rng.integers(0, C, N).astype(np.int32)
    hard = rng.random(N) < spec.p_hard
    ec = dataclasses.replace(ec, seed=ec.seed + 7919 * (seed + 1))
    cfg = resolved_config(ec)
    tokens, lengths = make_tokens(ec, labels, hard, C, cfg.vocab_size,
                                  spec.class_sep, spec.hard_sep_scale,
                                  u=u, ul=ul)
    X = standardize(encode(ec, tokens, lengths, spec.n_features, device=dev,
                           params=params, proj=proj)).cpu().numpy()
    return (X[:n_train], labels[:n_train], X[n_train:], labels[n_train:])
