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
the forward's do whatever the global matmul settings are.

The reference's ``attn_impl``, ``constrain``, ``moe_groups``, ``mesh`` and
``opt`` arguments reach :func:`repro_torch.models.model.forward`. On a
mesh the parameters and the optimizer state are
:class:`~repro_torch.distributed.sharding.Sharded` leaves laid out by the
parameters' specs; the loss is the global mean token loss (each data group
adds its masked loss sum and its token count, summed over groups in group
order: not a mean of group means); the gradients reach each slot's shards
reduced over ``data`` in group order; AdamW clips by the global norm of
the whole gradient and updates every slot's shards in place.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.device import full_fp32
from repro_torch.distributed.sharding import Sharded
from repro_torch.kernels.xent import streaming_xent
from repro_torch.models.model import forward, forward_groups
from repro_torch.models.params import leaves, with_leaves


def _xent_sums(logits, targets, ignore_id):
    mask = (targets != ignore_id).to(torch.float32)
    t = torch.clamp(targets, min=0)
    V = logits.shape[-1]
    per_tok = streaming_xent(logits.reshape(-1, V),
                             t.reshape(-1)).reshape(targets.shape) * mask
    return per_tok.sum(), mask.sum()


def softmax_xent(logits, targets, ignore_id=-1):
    """Mean token cross entropy. logits float32 (B, S, V), targets (B, S)
    int; targets equal to ``ignore_id`` count neither in the sum nor in the
    count."""
    total, count = _xent_sums(logits, targets, ignore_id)
    return total / torch.clamp(count, min=1.0)


def mesh_xent(outs, targets, mesh, ignore_id=-1):
    """:func:`softmax_xent` over a mesh's data groups: ``outs[i]`` group
    i's logits on its device, ``targets`` (B, S) the whole batch. Each
    group's masked loss sum and token count are added over the groups in
    group order on the mesh's lead device, then divided."""
    rows = targets.shape[0] // len(outs)
    sums, counts = zip(*(_xent_sums(o, targets[i * rows:(i + 1) * rows]
                                    .to(o.device), ignore_id)
                         for i, o in enumerate(outs)))
    return (mesh.psum(list(sums), "data", mesh.lead)
            / torch.clamp(mesh.psum(list(counts), "data", mesh.lead),
                          min=1.0))


def make_loss_fn(cfg, *, remat=True, attn_impl="auto", constrain=None,
                 aux_weight=0.01, moe_groups=1, mesh=None, opt=(),
                 compute_dtype=torch.bfloat16):
    """loss_fn(params, batch) -> (loss + aux_weight * aux, {"loss", "aux"});
    ``aux`` is the MoE blocks' load-balancing loss (0 without MoE), and
    ``batch["cross_src"]`` the cross-attending models' source. The other
    arguments reach ``forward``; ``compute_dtype`` (the port's: the
    reference's step functions keep ``forward``'s bfloat16) lets a card
    run be held against the CPU in float32."""
    kw = dict(mode="train", remat=remat, attn_impl=attn_impl,
              constrain=constrain, moe_groups=moe_groups, opt=opt,
              compute_dtype=compute_dtype)

    def loss_fn(params, batch):
        if mesh is None:
            logits, _, aux = forward(params, cfg, batch["tokens"],
                                     cross_src=batch.get("cross_src"), **kw)
            loss = softmax_xent(logits, batch["targets"])
        else:
            outs, _, aux = forward_groups(params, cfg, batch["tokens"],
                                          cross_src=batch.get("cross_src"),
                                          mesh=mesh, **kw)
            loss = mesh_xent(outs, batch["targets"], mesh)
        return loss + aux_weight * aux, {"loss": loss, "aux": aux}

    return loss_fn


def _grad_leaves(params):
    """The tensors the gradient is taken for: each leaf, or each Sharded
    leaf's pieces (slot order), detached and requiring grad; returns
    (those tensors, the tree rebuilt on them, regroup), ``regroup`` mapping
    a list of gradients for those tensors back to one per leaf."""
    flat, rebuilt, sizes = [], [], []
    for x in leaves(params, torch.is_tensor):
        if isinstance(x, Sharded):
            pcs = [t.detach().requires_grad_(True) for t in x.flat()]
            rebuilt.append(x.with_pieces(pcs))
        else:
            pcs = [x.detach().requires_grad_(True)]
            rebuilt.append(pcs[0])
        flat += pcs
        sizes.append(len(pcs))

    def regroup(grads):
        out, at = [], 0
        for x, n in zip(rebuilt, sizes):
            part = list(grads[at:at + n])
            out.append(x.with_pieces(part) if isinstance(x, Sharded)
                       else part[0])
            at += n
        return out

    return flat, with_leaves(params, rebuilt), regroup


def make_train_step(cfg, optimizer, *, microbatches=1, remat=True,
                    attn_impl="auto", constrain=None, moe_groups=1,
                    mesh=None, opt=(), compute_dtype=torch.bfloat16,
                    grad_transform: Optional[Callable] = None):
    """train_step(state, batch) -> (state, metrics).

    state = {"params", "opt_state", "step"}; batch leaves are (B, ...) and
    are split into ``microbatches`` accumulation steps run in order
    (float32 accumulators from zero, divided by ``microbatches``, as the
    reference's scan). ``grad_transform`` hooks gradient compression
    (:mod:`repro_torch.distributed.compression`; on a mesh it gets the
    tree of Sharded gradients). The optimizer updates the parameters and
    its moments in place (see
    :mod:`repro_torch.training.optimizer`); metrics are 0-d float32 tensors
    ``loss``, ``aux`` and ``grad_norm``. With ``mesh`` the state's
    parameters and moments are Sharded (see the module docstring)."""
    loss_fn = make_loss_fn(cfg, remat=remat, attn_impl=attn_impl,
                           constrain=constrain, moe_groups=moe_groups,
                           mesh=mesh, opt=opt, compute_dtype=compute_dtype)

    def grad_fn(params, batch):
        req, tree, regroup = _grad_leaves(params)
        with full_fp32():
            total, metrics = loss_fn(tree, batch)
            grads = torch.autograd.grad(total, req)
        return list(grads), regroup, {k: v.detach()
                                      for k, v in metrics.items()}

    def train_step(state, batch):
        params = state["params"]
        if microbatches > 1:
            mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            grads = None
            for i in range(microbatches):
                g, regroup, m = grad_fn(params,
                                        {k: v[i] for k, v in mb.items()})
                if grads is None:
                    grads = [torch.zeros(t.shape, dtype=torch.float32,
                                         device=t.device) for t in g]
                    dev = m["loss"].device
                    metrics = {
                        "loss": torch.zeros((), dtype=torch.float32,
                                            device=dev),
                        "aux": torch.zeros((), dtype=torch.float32,
                                           device=dev)}
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                metrics = {k: metrics[k] + m[k] for k in metrics}
                del g
            for acc in grads:
                acc.div_(microbatches)
            metrics = {k: v / microbatches for k, v in metrics.items()}
        else:
            grads, regroup, metrics = grad_fn(params, batch)
        grads = with_leaves(params, regroup(grads))
        if grad_transform is not None:
            grads = grad_transform(grads)
        opt_state, gnorm = optimizer.update_(grads, state["opt_state"],
                                             params)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return {"params": params, "opt_state": opt_state,
                "step": state["step"] + 1}, metrics

    return train_step


def make_prefill_step(cfg, *, attn_impl="auto", constrain=None,
                      moe_groups=1, mesh=None, opt=(),
                      compute_dtype=torch.bfloat16):
    """prefill(params, batch) -> (last logits (B, V) float32, cache): the
    context ``batch["tokens"]`` (B, S) (and ``batch["cross_src"]``) run in
    prefill mode. Pass bfloat16 parameters (``compute_params``) to cast
    the float32 masters once instead of at every call. On a mesh the cache
    is the data groups' list (:func:`~repro_torch.models.model.forward`)."""
    def prefill(params, batch):
        logits, cache, _ = forward(params, cfg, batch["tokens"],
                                   mode="prefill",
                                   cross_src=batch.get("cross_src"),
                                   logits_mode="last", attn_impl=attn_impl,
                                   constrain=constrain,
                                   moe_groups=moe_groups, mesh=mesh, opt=opt,
                                   compute_dtype=compute_dtype)
        return logits[:, 0], cache

    return prefill


def make_decode_step(cfg, *, constrain=None, opt=(), mesh=None,
                     compute_dtype=torch.bfloat16):
    """decode(params, cache, tokens (B, 1), positions (B,)) -> (logits
    (B, V) float32, new cache): one token per row at its position.

    The reference's decode step takes no mesh: on one, its sharded arrays
    compute the one-device function. ``mesh`` (the port's) runs the
    sharded state and the data groups' caches that a mesh prefill returns,
    with that function: the MoE dispatches all tokens at once, never on
    the island."""
    def decode(params, cache, tokens, positions):
        kw = dict(mode="decode", positions=positions, cache=cache,
                  logits_mode="last", constrain=constrain, opt=opt,
                  compute_dtype=compute_dtype)
        if mesh is None:
            logits, cache, _ = forward(params, cfg, tokens, **kw)
            return logits[:, 0], cache
        outs, cache, _ = forward_groups(params, cfg, tokens, mesh=mesh,
                                        island=False, **kw)
        logits = mesh.all_gather(outs, "data", 0, mesh.lead)
        return logits[:, 0], cache

    return decode
