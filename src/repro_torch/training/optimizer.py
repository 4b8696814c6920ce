"""AdamW with global-norm clipping and the cosine schedule (port of
``src/repro/training/optimizer.py``).

The arithmetic is the reference's, in float32 and in its op order: the
bias corrections ``1 - b**count`` are float32 powers of a float32 count,
the learning rate comes from the schedule as a float32 0-d tensor, and
every multiply and add is its own op. Unlike the reference, which returns
new trees, :meth:`AdamW.update_` updates the parameters, the moments and
the gradients in place, leaf by leaf: at full width (2.89 B parameters,
11.6 GB per float32 tree) a second copy of the gradients and new moment
trees would not fit beside the first on one 80 GB card.

On a mesh the parameters, gradients and moments are
:class:`~repro_torch.distributed.sharding.Sharded` leaves of one layout
(ZeRO-3): the global norm adds, leaf by leaf in flatten order, the
distinct shards' sums of squares in slot order, and every slot updates
its own shards (replicas alike) in place on its device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import Sharded
from repro_torch.models.params import leaves, tree_map


def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def cosine_schedule(base_lr, warmup_steps, total_steps, min_ratio=0.1):
    """lr(step): linear warm-up to ``base_lr``, then a cosine decay to
    ``min_ratio * base_lr`` at ``total_steps``, as a float32 0-d tensor
    (``step`` a tensor, on its device, or a number)."""
    def lr(step):
        step = (step.to(torch.float32) if torch.is_tensor(step)
                else torch.tensor(float(step), dtype=torch.float32))
        warm = base_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


class AdamW:
    def __init__(self, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 clip_norm=1.0, schedule=None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.schedule = schedule

    def init(self, params):
        """Zero float32 moments (of the params' layout on a mesh) and a zero
        int32 count, on the params' (lead) device."""
        def z(p):
            if isinstance(p, Sharded):
                return p.with_pieces([z(t) for t in p.flat()])
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        first = leaves(params, torch.is_tensor)[0]
        first = first.mesh.lead if isinstance(first, Sharded) else \
            first.device
        return {"mu": tree_map(z, params, is_leaf=torch.is_tensor),
                "nu": tree_map(z, params, is_leaf=torch.is_tensor),
                "count": torch.zeros((), dtype=torch.int32, device=first)}

    @staticmethod
    def global_norm(tree):
        """sqrt of the sum over leaves (in flatten order) of each leaf's sum
        of squares, in float32 (a Sharded leaf's: its distinct shards'
        added in slot order on the mesh's lead device)."""
        total = None
        for leaf in leaves(tree, torch.is_tensor):
            if isinstance(leaf, Sharded):
                s = None
                for i, j in leaf.holders():
                    t = torch.sum(torch.square(
                        leaf.pieces[i][j].to(torch.float32))).to(
                            leaf.mesh.lead)
                    s = t if s is None else s + t
            else:
                s = torch.sum(torch.square(leaf.to(torch.float32)))
            total = s if total is None else total + s
        return torch.sqrt(total)

    def update_(self, grads, state, params):
        """One AdamW step in place: ``params``, ``state["mu"]`` and
        ``state["nu"]`` are updated and ``grads`` is clipped, all in place.
        Returns ``(new_state, grad_norm)``: the state with the incremented
        count, and the gradients' global norm before clipping."""
        count = state["count"] + 1
        cf = count.to(torch.float32)
        gnorm = self.global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        bc1 = 1 - _f32(self.b1, cf) ** cf
        bc2 = 1 - _f32(self.b2, cf) ** cf
        lr = self.schedule(count) if self.schedule else self.lr
        neg_lr = -lr
        on = {}

        def consts(dev):
            # the step's scalars on ``dev`` (copied once per device)
            if dev not in on:
                on[dev] = tuple(t.to(dev) if torch.is_tensor(t) else t
                                for t in (scale, bc1, bc2, neg_lr))
            return on[dev]

        for g, m, v, p in zip(leaves(grads, torch.is_tensor),
                              leaves(state["mu"], torch.is_tensor),
                              leaves(state["nu"], torch.is_tensor),
                              leaves(params, torch.is_tensor)):
            if isinstance(p, Sharded):
                for parts in zip(g.flat(), m.flat(), v.flat(), p.flat()):
                    self._leaf_(*parts, *consts(parts[3].device))
            else:
                self._leaf_(g, m, v, p, scale, bc1, bc2, neg_lr)
        return {"mu": state["mu"], "nu": state["nu"], "count": count}, gnorm

    def _leaf_(self, g, m, v, p, scale, bc1, bc2, neg_lr):
        g.mul_(scale)
        m.mul_(self.b1).add_(g * (1 - self.b1))
        v.mul_(self.b2).add_(torch.square(g).mul_(1 - self.b2))
        den = (v / bc2).sqrt_().add_(self.eps)
        upd = (m / bc1).div_(den)
        del den
        upd.add_(self.weight_decay * p.to(torch.float32))
        p.add_(upd.mul_(neg_lr).to(p.dtype))
