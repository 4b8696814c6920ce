"""The port's Dawid-Skene EM and quality front ends against the JAX package.

Both packages get the same packed votes (the reference tests'
``_synthetic_votes`` generator, numpy-seeded); the port runs on the CPU,
where its E-step is the plain version of the Hopper kernel. Posterior,
accuracy and confusion agree within atol 1e-5: the E-step's vote sums run
in the same order as the reference's, and what differs is the last bit of
exp/log between XLA and PyTorch. The reference's E-step runs through its
jnp path and, in one case, through its Pallas kernel in interpret mode.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import quality as jq  # noqa: E402
from repro.labelstream import aggregate as ja  # noqa: E402
from repro_torch.core import quality as tq  # noqa: E402
from repro_torch.kernels.ds_estep import ds_estep  # noqa: E402
from repro_torch.labelstream import aggregate as ta  # noqa: E402

ATOL = 1e-5


def _synthetic_votes(n_tasks=30, accs=(0.95, 0.9, 0.85, 0.8, 0.3), seed=0,
                     n_classes=2):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, n_classes, n_tasks)
    tv = []
    for t in range(n_tasks):
        votes = []
        for w, a in enumerate(accs):
            if rng.random() < a:
                votes.append((int(truth[t]), w))
            else:
                wrong = int(rng.integers(0, n_classes - 1))
                votes.append((wrong + 1 if wrong >= truth[t] else wrong, w))
        tv.append(votes)
    return tv, truth


def _assert_em_close(out_t, out_j, atol=ATOL):
    for k in ("posterior", "log_posterior", "confusion", "accuracy",
              "n_votes", "votes_per_worker"):
        got = out_t[k].numpy()
        want = np.asarray(out_j[k])
        assert got.shape == want.shape, k
        # log-posteriors are sums of up to V logs of magnitude ~10: compare
        # them relative to their size, the probabilities absolutely
        if k == "log_posterior":
            np.testing.assert_allclose(got, want, rtol=ATOL, atol=atol,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got, want, atol=atol, err_msg=k)


@pytest.mark.parametrize("one_coin", [True, False])
@pytest.mark.parametrize("n_classes,seed,sparse", [
    (2, 0, False), (3, 1, False), (4, 2, True)])
def test_dawid_skene_matches_reference(one_coin, n_classes, seed, sparse):
    """Dense and sparse vote tables; every pack carries zero-vote padding
    tasks, and one task has an empty vote list."""
    tv, _ = _synthetic_votes(n_tasks=37, seed=seed, n_classes=n_classes)
    if sparse:
        rng = np.random.default_rng(seed)
        tv = [[v for v in votes if rng.random() < 0.6] for votes in tv]
    tv.append([])
    pack, n_workers = ta.pack_votes(tv)
    pack_j, n_workers_j = ja.pack_votes(tv)
    for a, b in zip(pack[:3], pack_j[:3]):
        np.testing.assert_array_equal(a, b)
    assert n_workers == n_workers_j and pack.worker_ids == pack_j.worker_ids
    kw = dict(n_workers=n_workers, n_classes=n_classes, iters=20,
              one_coin=one_coin)
    out_t = ta.dawid_skene(pack.labels, pack.workers, pack.mask,
                           device="cpu", **kw)
    out_j = ja.dawid_skene(pack.labels, pack.workers, pack.mask,
                           use_kernel=False, **kw)
    _assert_em_close(out_t, out_j)
    # padded zero-vote tasks stay exactly uniform
    empty = ~pack.mask.any(-1)
    assert empty.any()
    np.testing.assert_array_equal(out_t["posterior"].numpy()[empty],
                                  np.float32(1.0) / np.float32(n_classes))


def test_dawid_skene_matches_reference_pallas_estep():
    """The reference with its Pallas E-step (interpret mode) as the target."""
    tv, _ = _synthetic_votes(n_tasks=20, seed=7)
    pack, n_workers = ta.pack_votes(tv)
    kw = dict(n_workers=n_workers, n_classes=2, iters=8, one_coin=True)
    out_t = ta.dawid_skene(pack.labels, pack.workers, pack.mask,
                           device="cpu", **kw)
    out_k = ja.dawid_skene(pack.labels, pack.workers, pack.mask,
                           use_kernel=True, **kw)
    # the interpret-mode kernel sums through a one-hot matmul, in another
    # order than the gather: the reference's own kernel-vs-jnp test allows
    # 1e-4 (tests/test_labelstream.py::test_ds_em_with_kernel_estep_...)
    _assert_em_close(out_t, out_k, atol=1e-4)


@pytest.mark.parametrize("one_coin", [True, False])
def test_dawid_skene_batch_matches_reference(one_coin):
    packs = [ta.pack_votes(_synthetic_votes(n_tasks=16, seed=s)[0],
                           pad_workers_to=8)[0] for s in (5, 6, 7)]
    lab, wrk, msk = (np.stack([p[i] for p in packs]) for i in range(3))
    kw = dict(n_workers=8, n_classes=2, iters=12, one_coin=one_coin)
    before = ds_estep.launches
    out_t = ta.dawid_skene_batch(lab, wrk, msk, device="cpu", **kw)
    assert ds_estep.launches == before
    out_j = ja.dawid_skene_batch(lab, wrk, msk, use_kernel=False, **kw)
    _assert_em_close(out_t, out_j)
    for r in range(3):
        one = ta.dawid_skene(lab[r], wrk[r], msk[r], device="cpu", **kw)
        for k in one:
            np.testing.assert_array_equal(one[k].numpy(), out_t[k][r].numpy())


@pytest.mark.parametrize("one_coin", [True, False])
@pytest.mark.parametrize("case", ["votes", "empty", "one_class", "no_votes"])
def test_aggregate_votes_matches_reference(one_coin, case):
    tv, _ = _synthetic_votes(n_tasks=25, seed=3, n_classes=3)
    n_classes = 3
    if case == "empty":
        tv = tv + [[], []]
    elif case == "one_class":
        n_classes = 1
    elif case == "no_votes":
        tv = [[] for _ in range(4)]
    lab_t, acc_t, out_t = ta.aggregate_votes(tv, n_classes, one_coin=one_coin,
                                             device="cpu")
    lab_j, acc_j, out_j = ja.aggregate_votes(tv, n_classes, one_coin=one_coin,
                                             use_kernel=False)
    assert lab_t == lab_j
    assert acc_t.keys() == acc_j.keys()
    np.testing.assert_allclose([acc_t[w] for w in acc_t],
                               [acc_j[w] for w in acc_t], atol=ATOL)
    assert (out_t is None) == (out_j is None)
    if out_t is not None:
        _assert_em_close(out_t, out_j)


@pytest.mark.parametrize("seed,n_classes", [(0, 2), (4, 3), (9, 2)])
def test_em_worker_accuracy_matches_reference_and_scalar(seed, n_classes):
    tv, _ = _synthetic_votes(n_tasks=30, seed=seed, n_classes=n_classes)
    tv.append([])
    lab_t, acc_t = tq.em_worker_accuracy(tv, n_classes, device="cpu")
    lab_j, acc_j = jq.em_worker_accuracy(tv, n_classes)
    lab_s, acc_s = tq.em_worker_accuracy_ref(tv, n_classes)
    lab_sj, acc_sj = jq.em_worker_accuracy_ref(tv, n_classes)
    assert lab_t == lab_j == lab_s == lab_sj
    for w in acc_s:
        assert acc_s[w] == acc_sj[w]
        np.testing.assert_allclose(acc_t[w], acc_j[w], atol=ATOL)
        # one-coin EM in float32 against the float64 scalar loop
        np.testing.assert_allclose(acc_t[w], acc_s[w], atol=1e-4)


@pytest.mark.parametrize("votes,n_classes,acc", [
    ([(0, 1, 5.0), (0, 2, 5.0), (1, 3, 5.0)], 2, {1: 1.0, 2: 1.0, 3: 0.0}),
    ([(2, 1), (1, 2), (1, 3)], 3, {1: 0.99, 2: 0.6, 3: 0.6}),
    ([], 2, {}),
])
def test_vote_rules_match_reference(votes, n_classes, acc):
    assert tq.majority_vote(votes, n_classes) == \
        jq.majority_vote(votes, n_classes)
    assert tq.weighted_vote(votes, n_classes, acc) == \
        jq.weighted_vote(votes, n_classes, acc)


def test_dawid_skene_accepts_tensors():
    tv, _ = _synthetic_votes(n_tasks=10, seed=2)
    pack, n_workers = ta.pack_votes(tv)
    a = ta.dawid_skene(pack.labels, pack.workers, pack.mask,
                       n_workers=n_workers, n_classes=2, device="cpu")
    b = ta.dawid_skene(torch.from_numpy(pack.labels),
                       torch.from_numpy(pack.workers),
                       torch.from_numpy(pack.mask), n_workers=n_workers,
                       n_classes=2, device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
