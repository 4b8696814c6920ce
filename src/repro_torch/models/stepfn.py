"""Step functions (port of ``src/repro/models/stepfn.py``): the token
cross entropy, the loss function and the train step with microbatch
accumulation.

The loss runs through :func:`repro_torch.kernels.xent.streaming_xent` (the
Hopper forward and backward kernels on the card, the plain versions on the
CPU) on the (B * S, V) logits; the reference computes the same per-row
loss with ``jax.nn.logsumexp`` and ``take_along_axis``. Gradients come
from ``torch.autograd.grad`` over the float32 master parameters, with the
forward and the backward (remat's recompute included) inside
:func:`repro_torch.device.full_fp32`, so the backward's products run as
the forward's do whatever the global matmul settings are. ``prefill`` and
``decode`` are not ported yet (ROADMAP A12c).
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
    the ported blocks have no auxiliary loss, so aux is 0."""
    def loss_fn(params, batch):
        logits = forward(params, cfg, batch["tokens"], mode="train",
                         remat=remat)
        loss = softmax_xent(logits, batch["targets"])
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
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


def make_prefill_step(cfg, **_):
    raise NotImplementedError("prefill (and its caches) is not ported yet "
                              "(ROADMAP A12c)")


def make_decode_step(cfg, **_):
    raise NotImplementedError("decode (and its caches) is not ported yet "
                              "(ROADMAP A12c)")
