"""Deterministic synthetic text tasks (port of
``src/repro/embed/corpus.py``).

Each task is a token sequence whose token distribution carries the class:
every class owns a block of ``SIG_TOKENS`` signature tokens in the upper
half of the vocab, and each position is a signature token with probability
``signal`` (else a Zipf-skewed background token from the lower half).
``signal`` maps the Gaussian path's ``class_sep`` into token space and
shrinks by ``hard_sep_scale`` on hard tasks. The reference draws its
uniforms with ``jax.random``; the port draws them from a seeded CPU
``torch.Generator`` (other numbers, the same distribution) or takes them
injected, and then applies the reference's numpy arithmetic, so injected
uniforms give bit-equal tokens and lengths.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.embed.config import EmbedConfig

#: signature tokens per class (vocab block width)
SIG_TOKENS = 8


def signal_strength(class_sep: float, hard_sep_scale: float = 1.0,
                    hard: bool = False) -> float:
    """Map ``class_sep`` onto the per-position signature-token probability
    (clipped to keep some background mass)."""
    s = min(class_sep / 4.0, 0.95)
    if hard:
        s *= hard_sep_scale
    return float(max(s, 0.0))


def draw_uniforms(seed: int, N: int, T: int):
    """The corpus's uniforms for ``N`` tasks of ``T`` positions: ``u``
    (3, N, T) and ``ul`` (N,) float32 numpy, from a CPU generator seeded
    with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((3, N, T), generator=g, dtype=torch.float32)
    ul = torch.rand((N,), generator=g, dtype=torch.float32)
    return u.numpy(), ul.numpy()


def make_tokens(ec: EmbedConfig, labels, hard, n_classes: int,
                vocab_size: int, class_sep: float,
                hard_sep_scale: float = 1.0, *, u=None, ul=None):
    """Token-id sequences for ``len(labels)`` tasks.

    ``labels`` (N,) class ids, ``hard`` (N,) difficulty flags. Returns
    numpy ``(tokens (N, seq_len) int32, lengths (N,) int32)`` with lengths
    in ``[seq_len // 2, seq_len]`` and zeros past each length. ``u``
    (3, N, seq_len) and ``ul`` (N,) replace the drawn uniforms."""
    labels = np.asarray(labels, np.int32)
    hard = np.asarray(hard, bool)
    N, T = labels.shape[0], ec.seq_len
    if vocab_size < 2 * n_classes * SIG_TOKENS:
        raise ValueError(
            f"vocab_size={vocab_size} too small for {n_classes} classes x "
            f"{SIG_TOKENS} signature tokens (need >= "
            f"{2 * n_classes * SIG_TOKENS})")
    bg = vocab_size // 2                      # background token range
    if u is None or ul is None:
        du, dul = draw_uniforms(ec.seed, N, T)
        u = du if u is None else u
        ul = dul if ul is None else ul
    u = np.asarray(u, np.float32)
    ul = np.asarray(ul, np.float32)
    if u.shape != (3, N, T) or ul.shape != (N,):
        raise ValueError(f"u must be (3, {N}, {T}) and ul ({N},), got "
                         f"{u.shape} and {ul.shape}")

    s_easy = signal_strength(class_sep, hard_sep_scale, hard=False)
    s_hard = signal_strength(class_sep, hard_sep_scale, hard=True)
    sig_p = np.where(hard, s_hard, s_easy)[:, None]          # (N, 1)
    # class c's signature block sits at [bg + c*SIG, bg + (c+1)*SIG)
    sig_tok = (bg + labels[:, None] * SIG_TOKENS
               + np.minimum((u[1] * SIG_TOKENS).astype(np.int32),
                            SIG_TOKENS - 1))
    # Zipf-ish background: quadratic skew toward low token ids
    bg_tok = np.minimum((u[2] ** 2 * bg).astype(np.int32), bg - 1)
    tokens = np.where(u[0] < sig_p, sig_tok, bg_tok).astype(np.int32)

    lo = T // 2
    lengths = (lo + np.minimum((ul * (T - lo + 1)).astype(np.int32),
                               T - lo)).astype(np.int32)
    mask = np.arange(T)[None, :] < lengths[:, None]
    return np.where(mask, tokens, 0).astype(np.int32), lengths


def tokenize_text(text: str, seq_len: int, vocab_size: int):
    """Deterministic hash tokenizer for submitted text: whitespace words
    roll through sha1 into token ids. Returns ``(tokens (seq_len,) int32,
    length)``; empty text maps to one zero token."""
    words = text.split()[:seq_len]
    if not words:
        return np.zeros((seq_len,), np.int32), 1
    toks = [int.from_bytes(
        hashlib.sha1(w.encode("utf-8", "replace")).digest()[:4], "big")
        % vocab_size for w in words]
    out = np.zeros((seq_len,), np.int32)
    out[:len(toks)] = toks
    return out, len(toks)
