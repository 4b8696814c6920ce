"""Abstract inputs and states of every workload cell (port of
``src/repro/launch/specs.py``).

Everything here is a ``meta`` tensor, the counterpart of the reference's
``ShapeDtypeStruct``: shapes and dtypes, nothing allocated. The decode
cache is :func:`repro_torch.models.model.init_cache`'s tree on the
``meta`` device. Nothing here runs the model.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import _init_cache, model_template
from repro_torch.models.params import abstract_params, tree_map

_META = torch.device("meta")


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=_META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Abstract inputs for the step function of this (arch x shape) cell.

    train   -> {"tokens", "targets"[, "cross_src"]}
    prefill -> {"tokens"[, "cross_src"]}
    decode  -> {"tokens" (B, 1), "positions" (B,), "cache": <tree>}
    """
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model

    def cross(batch):
        if cfg.is_encoder_decoder:
            batch["cross_src"] = _sds((B, cfg.encoder_seq, d), torch.bfloat16)
        elif cfg.n_img_tokens:
            batch["cross_src"] = _sds((B, cfg.n_img_tokens, d),
                                      torch.bfloat16)
        return batch

    if shape.kind == "train":
        return cross({"tokens": _sds((B, S), torch.int32),
                      "targets": _sds((B, S), torch.int32)})
    if shape.kind == "prefill":
        return cross({"tokens": _sds((B, S), torch.int32)})
    if shape.kind == "decode":
        return {"tokens": _sds((B, 1), torch.int32),
                "positions": _sds((B,), torch.int32),
                "cache": _init_cache(cfg, B, S, torch.bfloat16, _META)}
    raise ValueError(shape.kind)


def abstract_model(cfg: ModelConfig, dtype=torch.float32):
    return abstract_params(model_template(cfg), dtype)


def abstract_train_state(cfg: ModelConfig, dtype=torch.float32):
    """The train state's shapes and dtypes: parameters of ``dtype``,
    float32 AdamW moments of the parameters' shapes, int32 counters."""
    p = abstract_model(cfg, dtype)
    zf = lambda tree: tree_map(lambda x: _sds(x.shape, torch.float32), tree,
                               is_leaf=torch.is_tensor)
    return {"params": p,
            "opt_state": {"mu": zf(p), "nu": zf(p),
                          "count": _sds((), torch.int32)},
            "step": _sds((), torch.int32)}
