"""Architecture and workload-shape descriptions (copy of
``src/repro/configs/base.py``).

A ``ModelConfig`` is pure data; a workload cell is a ``(ModelConfig,
ShapeConfig)`` pair, :func:`cell_supported` says whether it runs. ``block_pattern`` is the repeating unit of
the layer stack, tiled (and truncated) to ``n_layers``. Block kinds:
``attn`` (self-attention + MLP, full or sliding window), ``xattn``
(attention + cross-attention), ``moe`` (attention + mixture of experts),
``mlstm`` / ``slstm`` (xLSTM) and ``rglru`` (RG-LRU + MLP, RecurrentGemma).
The port's model runs all of them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: tuple = ("attn",)
    window: int = 0                 # 0 = full attention; >0 = sliding window
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # VLM cross attention: layer i cross-attends iff i % every == every - 1
    cross_attn_every: int = 0
    n_img_tokens: int = 0
    # encoder-decoder (audio)
    n_encoder_layers: int = 0
    encoder_seq: int = 0
    # recurrent blocks
    conv_width: int = 4
    lru_width: int = 0              # 0 -> d_model
    # misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"
    mlp_gated: bool = True
    norm: str = "rmsnorm"

    @property
    def subquadratic(self) -> bool:
        """True if the context cost is sub-quadratic (recurrent blocks or a
        sliding window without full attention): ``long_500k`` runs."""
        blocks = self.blocks()
        recurrent = any(b in ("mlstm", "slstm", "rglru") for b in blocks)
        swa = self.window > 0
        full_attn = any(b in ("attn", "xattn", "moe")
                        for b in blocks) and self.window == 0
        return (recurrent or swa) and not (full_attn and not swa)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def d_lru(self) -> int:
        return self.lru_width or self.d_model

    def blocks(self) -> tuple:
        """Expanded per-layer block kinds, length ``n_layers``."""
        pat = self.block_pattern
        out = (list(pat) * -(-self.n_layers // len(pat)))[:self.n_layers]
        if self.cross_attn_every > 0:
            e = self.cross_attn_every
            out = [("xattn" if i % e == e - 1 else b)
                   for i, b in enumerate(out)]
        return tuple(out)

    def layer_groups(self):
        """``(group, n_full, remainder)``: the repeating group of block
        kinds, how many full groups the stack holds (run over stacked
        parameters), and the truncated tail (run unrolled), e.g.
        recurrentgemma's 26 = 8 * 3 + 2."""
        blocks = self.blocks()
        g = (len(self.block_pattern) if self.cross_attn_every == 0
             else self.cross_attn_every)
        n_full = len(blocks) // g
        group = tuple(blocks[:g])
        for i in range(n_full):
            if tuple(blocks[i * g:(i + 1) * g]) != group:
                raise ValueError(f"{self.name}: non-tiling block pattern "
                                 f"{blocks}")
        return group, n_full, tuple(blocks[n_full * g:])

    def _ff_inner(self) -> int:
        """The sLSTM block's GEGLU width: ~8/3 of d_model, a multiple of
        64 (2048 for xlstm-125m)."""
        return max(64, int(self.d_model * 8 / 3) // 64 * 64)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """(supported, reason). ``long_500k`` needs sub-quadratic context
    handling."""
    if shape.name == "long_500k":
        if cfg.is_encoder_decoder:
            return False, "enc-dec: 500k decoder context out of scope"
        if not cfg.subquadratic:
            return False, ("pure full-attention arch: 500k dense KV out of "
                           "scope")
    return True, ""


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test scale version of an architecture (same family and
    pattern, one full group)."""
    g = cfg.cross_attn_every or len(cfg.block_pattern)
    return dataclasses.replace(
        cfg,
        n_layers=max(2, g),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        window=min(cfg.window, 8) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        n_img_tokens=8 if cfg.n_img_tokens else 0,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_seq else 0,
        lru_width=64 if cfg.lru_width else 0,
    )
