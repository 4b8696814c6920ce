"""The batched full-confusion Dawid-Skene EM of the stream's refresh, and
the deterministic scatter helpers of the tick (a frozen copy of the
program's ``labelstream/aggregate.py``, cut to them, with the plain E-step
of ``ref.py`` in place of the kernel).

Votes live in dense padded ``(B, T, V)`` arrays with a validity mask; the
E-step is a gather + softmax over a log-confusion row table (row ``w*C +
l`` holds ``log P(vote=l | true=c)``), the M-step a padded segment-sum of
posteriors into (worker, label) bins, each bin adding its votes in order.
"""
from __future__ import annotations

import torch

from perfbench.reference.stream.ref import ds_estep_ref as ds_estep

ACC_CLIP = 1e-3          # matches quality.em_worker_accuracy_ref
CONF_CLIP = 1e-6
INIT_ACC = 0.8


def _count_rows(n: int, idx):
    """(B, n) int64 histogram of ``idx`` (B, K) over [0, n) (integer
    atomics add in any order to the same result)."""
    out = torch.zeros((idx.shape[0], n), dtype=torch.int64, device=idx.device)
    return out.scatter_add_(1, idx, torch.ones_like(idx))


def _segments(idx, n: int):
    """The sort that :func:`_segment_sum` reuses: a stable order of ``idx``
    (B, K) along dim 1 and the (B, n) run lengths of its values."""
    return torch.argsort(idx, dim=1, stable=True), _count_rows(n, idx)


def _segment_sum(src, order, lengths):
    """(B, n, *rest) sums of ``src`` (B, K, *rest) by destination, from
    :func:`_segments`; ``lengths`` may drop trailing destinations, whose
    updates are then skipped. Each destination adds its updates one after
    another in their original order, on the CPU and on the card alike, so
    the sums are deterministic and equal to a sequential scatter-add — the
    reference's order. (Float ``scatter_add_``/``index_add_`` race atomics
    on the card; ``index_put_(accumulate=True)`` races them on the CPU
    above 32768 elements.)"""
    full = order.reshape(order.shape + (1,) * (src.dim() - 2)).expand_as(src)
    return torch.segment_reduce(torch.gather(src, 1, full), "sum",
                                lengths=lengths, axis=1, unsafe=True)


def _add_at(dst, idx, src):
    """``dst[b, idx[b, k]] += src[b, k]`` for k = 0, 1, ... in turn, along
    dim 1, on a copy of ``dst`` (B, n, *rest). ``dst`` goes first into
    each destination's sum, so rounding matches the sequential update."""
    B, n = dst.shape[:2]
    slots = torch.arange(n, device=idx.device).expand(B, n)
    return _segment_sum(torch.cat([dst, src], 1),
                        *_segments(torch.cat([slots, idx], 1), n))


def _row_table(log_conf, n_workers, n_classes):
    """(B, W, C_true, C_vote) log-confusion -> (B, W*C+1, C_true) row table
    with a trailing all-zero null row for masked votes."""
    B = log_conf.shape[0]
    rows = log_conf.transpose(2, 3).reshape(B, n_workers * n_classes,
                                            n_classes)
    null = torch.zeros((B, 1, n_classes), dtype=rows.dtype,
                       device=rows.device)
    return torch.cat([rows, null], dim=1).contiguous()


def _estep(log_conf, idx, n_workers, n_classes):
    """One batched E-step: a single kernel launch for every batch element."""
    return ds_estep(_row_table(log_conf, n_workers, n_classes), idx)


def _ds_em(labels, workers, mask, n_workers, n_classes, iters, one_coin):
    """Batched EM over ``(B, T, V)`` vote tensors; returns a dict of
    ``(B, ...)`` tensors. ``iters`` is a host integer."""
    B, T, V = labels.shape
    W, C = n_workers, n_classes
    R = W * C
    dev = labels.device
    # masked votes point at the null row; real votes at row w*C + label
    idx = torch.where(mask, workers * C + labels,
                      torch.full_like(labels, R)).to(torch.int32).contiguous()
    # the M-step's destinations never change: sort the votes by row once.
    # Masked votes sort last (null row R, dump worker W) and their segment
    # is left out of the sums: it adds only zeros, and one thread would add
    # them all
    row_order, row_len = _segments(idx.reshape(B, T * V).long(), R + 1)
    wcol = torch.where(mask, workers, torch.full_like(workers, W))
    maskf = mask.to(torch.float32)
    w_order, w_len = _segments(wcol.reshape(B, T * V), W + 1)
    votes_per_worker = _segment_sum(maskf.reshape(B, T * V), w_order,
                                    w_len[:, :W])
    eye = torch.eye(C, dtype=torch.float32, device=dev)

    def conf_from_acc(acc):
        a = torch.clamp(acc, ACC_CLIP, 1.0 - ACC_CLIP)
        off = (1.0 - a) / max(C - 1, 1)
        return (a[..., None, None] * eye
                + off[..., None, None] * (1.0 - eye))     # (B, W, C, C)

    def mstep(post):
        # post[t, c] scattered into (worker, vote-label) bins: one padded
        # segment-sum, no (T, V, W) one-hot
        contrib = post[:, :, None, :].expand(B, T, V, C) * maskf[..., None]
        counts = _segment_sum(contrib.reshape(B, T * V, C), row_order,
                              row_len[:, :R])
        # (B, W, true, vote)
        counts = counts.reshape(B, W, C, C).transpose(2, 3)
        if one_coin:
            diag = torch.diagonal(counts, dim1=-2, dim2=-1).sum(-1)
            acc = (1.0 + diag) / (2.0 + torch.clamp(votes_per_worker,
                                                    min=0.0))
            return conf_from_acc(acc), acc
        row_tot = counts.sum(-1, keepdim=True)
        conf = (counts + 1.0 / C) / (row_tot + 1.0)         # Laplace rows
        acc = torch.diagonal(conf, dim1=-2, dim2=-1).sum(-1) / C
        return conf, acc

    acc = torch.full((B, W), INIT_ACC, device=dev)
    conf = conf_from_acc(acc)
    logp = torch.zeros((B, T, C), device=dev)
    post = torch.full((B, T, C), 1.0 / C, device=dev)
    for _ in range(iters):
        logp, post = _estep(torch.log(torch.clamp(conf, CONF_CLIP, 1.0)),
                            idx, W, C)
        conf, acc = mstep(post)
    # scalar reference order: labels come from the E-step of the LAST
    # iteration, accuracies from the M-step that follows it
    return dict(log_posterior=logp, posterior=post, confusion=conf,
                accuracy=acc, n_votes=maskf.sum(-1),
                votes_per_worker=votes_per_worker)

