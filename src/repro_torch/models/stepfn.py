"""Step functions (port of ``src/repro/models/stepfn.py``): the token
cross entropy, the loss function, the train step with microbatch
accumulation, and the serving steps prefill and decode.

The loss runs through :func:`repro_torch.kernels.xent.streaming_xent` (the
Hopper forward and backward kernels on the card, the plain versions on the
CPU) on the (B * S, V) logits; the reference computes the same per-row
loss with ``jax.nn.logsumexp`` and ``take_along_axis``. Gradients come
from ``torch.autograd.grad`` over the float32 master parameters, with the
forward and the backward (remat's recompute included) inside
:func:`repro_torch.device.full_fp32`, so the backward's products run as
the forward's do whatever the global matmul settings are. The reference's
``attn_impl``, ``constrain``, ``moe_groups``, ``mesh`` and ``opt``
arguments shard or retune the step over a device mesh and stay with the
multi-device work (ROADMAP A13b).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.device import full_fp32
from repro_torch.kernels.xent import streaming_xent
from repro_torch.models.model import forward
from repro_torch.models.params import leaves, with_leaves


def softmax_xent(logits, targets, ignore_id=-1):
    """Mean token cross entropy. logits float32 (B, S, V), targets (B, S)
    int; targets equal to ``ignore_id`` count neither in the sum nor in the
    count."""
    mask = (targets != ignore_id).to(torch.float32)
    t = torch.clamp(targets, min=0)
    V = logits.shape[-1]
    per_tok = streaming_xent(logits.reshape(-1, V),
                             t.reshape(-1)).reshape(targets.shape) * mask
    return per_tok.sum() / torch.clamp(mask.sum(), min=1.0)


def make_loss_fn(cfg, *, remat=True, aux_weight=0.01):
    """loss_fn(params, batch) -> (loss + aux_weight * aux, {"loss", "aux"});
    ``aux`` is the MoE blocks' load-balancing loss (0 without MoE), and
    ``batch["cross_src"]`` the cross-attending models' source."""
    def loss_fn(params, batch):
        logits, _, aux = forward(params, cfg, batch["tokens"], mode="train",
                                 cross_src=batch.get("cross_src"),
                                 remat=remat)
        loss = softmax_xent(logits, batch["targets"])
        return loss + aux_weight * aux, {"loss": loss, "aux": aux}

    return loss_fn


def make_train_step(cfg, optimizer, *, microbatches=1, remat=True,
                    grad_transform: Optional[Callable] = None):
    """train_step(state, batch) -> (state, metrics).

    state = {"params", "opt_state", "step"}; batch leaves are (B, ...) and
    are split into ``microbatches`` accumulation steps run in order
    (float32 accumulators from zero, divided by ``microbatches``, as the
    reference's scan). ``grad_transform`` hooks gradient compression
    (:mod:`repro_torch.distributed.compression`). The optimizer updates the
    parameters and its moments in place (see
    :mod:`repro_torch.training.optimizer`); metrics are 0-d float32 tensors
    ``loss``, ``aux`` and ``grad_norm``."""
    loss_fn = make_loss_fn(cfg, remat=remat)

    def grad_fn(params, batch):
        req = [p.detach().requires_grad_(True)
               for p in leaves(params, torch.is_tensor)]
        with full_fp32():
            total, metrics = loss_fn(with_leaves(params, req), batch)
            grads = torch.autograd.grad(total, req)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        params = state["params"]
        if microbatches > 1:
            mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in leaves(params, torch.is_tensor)]
            dev = grads[0].device
            metrics = {"loss": torch.zeros((), dtype=torch.float32,
                                           device=dev),
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=dev)}
            for i in range(microbatches):
                g, m = grad_fn(params, {k: v[i] for k, v in mb.items()})
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                metrics = {k: metrics[k] + m[k] for k in metrics}
                del g
            for acc in grads:
                acc.div_(microbatches)
            metrics = {k: v / microbatches for k, v in metrics.items()}
        else:
            grads, metrics = grad_fn(params, batch)
        grads = with_leaves(params, grads)
        if grad_transform is not None:
            grads = grad_transform(grads)
        opt_state, gnorm = optimizer.update_(grads, state["opt_state"],
                                             params)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return {"params": params, "opt_state": opt_state,
                "step": state["step"] + 1}, metrics

    return train_step


def make_prefill_step(cfg):
    """prefill(params, batch) -> (last logits (B, V) float32, cache): the
    context ``batch["tokens"]`` (B, S) (and ``batch["cross_src"]``) run in
    prefill mode. Pass bfloat16 parameters (``compute_params``) to cast
    the float32 masters once instead of at every call."""
    def prefill(params, batch):
        logits, cache, _ = forward(params, cfg, batch["tokens"],
                                   mode="prefill",
                                   cross_src=batch.get("cross_src"),
                                   logits_mode="last")
        return logits[:, 0], cache

    return prefill


def make_decode_step(cfg):
    """decode(params, cache, tokens (B, 1), positions (B,)) -> (logits
    (B, V) float32, new cache): one token per row at its position."""
    def decode(params, cache, tokens, positions):
        logits, cache, _ = forward(params, cfg, tokens, mode="decode",
                                   positions=positions, cache=cache,
                                   logits_mode="last")
        return logits[:, 0], cache

    return decode
