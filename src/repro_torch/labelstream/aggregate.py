"""Batched full-confusion Dawid-Skene EM in PyTorch.

Port of ``src/repro/labelstream/aggregate.py``:

  * votes live in dense padded arrays — ``labels``/``workers`` ([B,] T, V)
    with a validity ``mask`` — produced by :func:`pack_votes`;
  * the E-step is one fused gather+softmax over a log-confusion row table
    (row ``w*C + l`` holds ``log P(vote=l | true=c)`` for worker w): the
    Hopper kernel :func:`repro_torch.kernels.ds_estep.ds_estep` for CUDA
    tensors, its plain version for CPU tensors. A batch of EMs makes one
    launch per iteration;
  * the M-step is a padded segment-sum of posteriors into (worker, label)
    bins (:func:`_segment_sum`): the votes are sorted by bin once per EM,
    and each bin adds its votes in order, deterministically on both
    devices;
  * EM iterations run as a Python loop; independent replications are a
    leading batch dimension (:func:`dawid_skene_batch`).

Two observation models:
  * ``one_coin=True``  — symmetric accuracy per worker, numerically the
    scalar :func:`repro_torch.core.quality.em_worker_accuracy_ref` (same 0.8
    init, +1/+2 Beta smoothing and accuracy clipping);
  * ``one_coin=False`` — full C x C confusion matrix per worker with
    Laplace-smoothed rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ds_estep import ds_estep

ACC_CLIP = 1e-3          # matches quality.em_worker_accuracy_ref
CONF_CLIP = 1e-6
INIT_ACC = 0.8


class VotePack(NamedTuple):
    """Dense vote table + the worker-id mapping used to build it."""
    labels: np.ndarray       # (T, V) int32 vote labels
    workers: np.ndarray      # (T, V) int32 dense worker indices
    mask: np.ndarray         # (T, V) bool validity
    worker_ids: list         # dense index -> original worker id


def _bucket(n: int, step: int) -> int:
    return max(step, -(-n // step) * step)


def pack_votes(task_votes, *, pad_tasks_to: Optional[int] = None,
               pad_votes_to: Optional[int] = None,
               pad_workers_to: Optional[int] = None
               ) -> "tuple[VotePack, int]":
    """Pack ``[[(label, worker_id), ...], ...]`` into dense padded arrays.

    Returns ``(pack, n_workers)`` — the dense vote table and the (bucket-
    padded) worker-axis size to hand to :func:`dawid_skene`. Shapes are
    bucket-padded (tasks to 32, votes to 4, workers to 8) as in the
    reference. Tasks with empty vote lists are legal and come out fully
    masked.
    """
    ids = sorted({w for votes in task_votes for _, w in votes})
    wid_to_dense = {w: i for i, w in enumerate(ids)}
    T = len(task_votes)
    V = max((len(v) for v in task_votes), default=0)
    Tp = pad_tasks_to or _bucket(T, 32)
    Vp = pad_votes_to or _bucket(V, 4)
    labels = np.zeros((Tp, Vp), np.int32)
    workers = np.zeros((Tp, Vp), np.int32)
    mask = np.zeros((Tp, Vp), bool)
    for i, votes in enumerate(task_votes):
        for j, (label, wid) in enumerate(votes):
            labels[i, j] = label
            workers[i, j] = wid_to_dense[wid]
            mask[i, j] = True
    n_workers = pad_workers_to or _bucket(max(len(ids), 1), 8)
    if n_workers < len(ids):
        raise ValueError("pad_workers_to smaller than distinct workers")
    return VotePack(labels, workers, mask, ids), n_workers


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


def _as_votes(labels, workers, mask, dev):
    def conv(x, dtype):
        if torch.is_tensor(x):
            return x.to(device=dev, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    return (conv(labels, torch.int64), conv(workers, torch.int64),
            conv(mask, torch.bool))


def dawid_skene(labels, workers, mask, *, n_workers: int, n_classes: int,
                iters: int = 20, one_coin: bool = False, device="cuda"):
    """Vectorized Dawid-Skene EM over a dense padded vote table.

    labels/workers: (T, V) ints; mask: (T, V) bool (numpy arrays or
    tensors). Returns a dict of tensors on ``device``: ``posterior`` (T, C),
    ``log_posterior`` (T, C), ``confusion`` (W, C, C), ``accuracy`` (W,),
    ``n_votes`` (T,) and ``votes_per_worker`` (W,).
    """
    dev = resolve_device(device)
    lab, wrk, msk = _as_votes(labels, workers, mask, dev)
    out = _ds_em(lab[None], wrk[None], msk[None], int(n_workers),
                 int(n_classes), int(iters), bool(one_coin))
    return {k: v[0] for k, v in out.items()}


def dawid_skene_batch(labels, workers, mask, *, n_workers: int,
                      n_classes: int, iters: int = 20, one_coin: bool = False,
                      device="cuda"):
    """:func:`dawid_skene` over a leading replication axis.

    labels/workers/mask: (n_reps, T, V). Each replication runs its own EM
    in lock-step; each iteration is one E-step launch for all of them.
    """
    dev = resolve_device(device)
    lab, wrk, msk = _as_votes(labels, workers, mask, dev)
    return _ds_em(lab, wrk, msk, int(n_workers), int(n_classes), int(iters),
                  bool(one_coin))


def aggregate_votes(task_votes, n_classes: int, *, iters: int = 20,
                    one_coin: bool = True, device="cuda"):
    """List-of-votes front door: pack, run EM, unpack to python types.

    Returns ``(labels, acc_by_worker, out)`` where ``labels`` is a list of
    posterior-argmax labels (len == len(task_votes)), ``acc_by_worker`` maps
    original worker ids to estimated accuracy, and ``out`` is the raw
    :func:`dawid_skene` result (padded shapes), or None when there are no
    votes or fewer than two classes.
    """
    dev = resolve_device(device)
    T = len(task_votes)
    pack, n_workers = pack_votes(task_votes)
    if not pack.worker_ids or n_classes < 2:
        return [0] * T, {w: INIT_ACC for w in pack.worker_ids}, None
    out = dawid_skene(pack.labels, pack.workers, pack.mask,
                      n_workers=n_workers, n_classes=n_classes, iters=iters,
                      one_coin=one_coin, device=dev)
    post = out["posterior"][:T].cpu().numpy()
    acc = out["accuracy"].cpu().numpy()
    labels = [int(c) for c in post.argmax(-1)]
    acc_by_worker = {w: float(acc[i]) for i, w in enumerate(pack.worker_ids)}
    return labels, acc_by_worker, out
