"""How task text becomes a feature vector (copy of
``src/repro/embed/config.py``).

``model`` names a :mod:`repro_torch.configs` architecture; ``reduced=True``
runs it at smoke scale (d_model 64, vocab 256). ``pooling`` collapses the
(B, S, d_model) final-norm hidden states to one vector per task (masked
mean or the last real token); a seeded Gaussian projection then maps
d_model to the feature width (``projection_dim`` optionally pins it).
``bank_size`` is the number of precomputed bank embeddings, ``batch_size``
the encoder's micro-batch, and ``seed`` fixes corpus, model parameters and
projection.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

POOLING_KINDS = ("mean", "last")


@dataclasses.dataclass(frozen=True)
class EmbedConfig:
    model: str = "xlstm-125m"
    reduced: bool = True
    pooling: str = "mean"         # "mean" | "last"
    seq_len: int = 48             # max tokens per task
    bank_size: int = 512          # precomputed embeddings (2*C*K layout)
    projection_dim: Optional[int] = None  # None = the feature width
    batch_size: int = 64          # encoder micro-batch
    seed: int = 0

    def __post_init__(self):
        def fail(field, msg):
            raise ValueError(f"EmbedConfig.{field}: {msg}")
        if self.pooling not in POOLING_KINDS:
            fail("pooling", f"must be one of {POOLING_KINDS}, "
                 f"got {self.pooling!r}")
        if self.seq_len < 4:
            fail("seq_len", f"must be >= 4, got {self.seq_len}")
        if self.bank_size < 2:
            fail("bank_size", f"must be >= 2, got {self.bank_size}")
        if self.projection_dim is not None and self.projection_dim < 1:
            fail("projection_dim",
                 f"must be None or >= 1, got {self.projection_dim}")
        if self.batch_size < 1:
            fail("batch_size", f"must be >= 1, got {self.batch_size}")
