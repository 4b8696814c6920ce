"""The port's stream on its own draws, on the CPU: two runs with the same
seed are equal in every output (float sums, the EM refresh's scatter-adds
and the learner's fits included), arrivals are conserved, the draw helpers
reproduce a seeded run, and the refresh is not a no-op. The tick-for-tick
parity with the JAX package is in ``tests/test_torch_stream.py`` and
``tests/test_torch_stream_learner.py``; the card version of the
determinism check is phases 4 and 14 of ``chip_smoke.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.labelstream import router as tr
from repro_torch.scenarios import get_stream_config

REFRESH = {"refresh_every": 40, "refresh_iters": 6}
H, N = 200, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the tick is hundreds of tiny ops: threads only add overhead, and the
    # suite runs several workers at once
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_refresh_changes_the_run():
    """The refresh variant of the parity test is not vacuous: with the same
    draws, the EM refresh changes the online estimates and so the run."""
    cfg = get_stream_config("skewed_adaptive5")
    a = tr.run_stream(cfg, H, n_reps=N, seed=1, device="cpu")
    b = tr.run_stream(dataclasses.replace(cfg, refresh_every=10,
                                          refresh_iters=6),
                      H, n_reps=N, seed=1, device="cpu")
    assert torch.equal(a["arrived"], b["arrived"])
    assert not all(torch.equal(a[k], b[k]) for k in
                   ("hist", "completions", "n_churned", "cost_wait"))


@pytest.mark.parametrize("name,overrides", [("skewed_adaptive5", REFRESH),
                                            ("stream_batch_replay", None),
                                            ("skewed_learner_fused", REFRESH),
                                            ("chance_hard", None)])
def test_stream_is_deterministic(name, overrides):
    """Two runs with the same seed agree in every output, float sums, the
    refresh's scatter-adds and the learner's fits included."""
    cfg = get_stream_config(name, overrides)
    a = tr.run_stream(cfg, 300, n_reps=3, seed=5, device="cpu")
    b = tr.run_stream(cfg, 300, n_reps=3, seed=5, device="cpu")
    for k, v in a.items():
        if isinstance(v, dict):
            for kk in v:
                assert torch.equal(v[kk], b[k][kk]), (k, kk)
        elif torch.is_tensor(v):
            assert torch.equal(v, b[k]), k
    arrived = int(a["arrived"].sum())
    assert arrived == int(a["done_all"].sum() + a["backlog_end"].sum()
                          + a["in_flight_end"].sum() + a["dropped"].sum())


def test_draw_helpers_reproduce_a_seeded_run():
    cfg = get_stream_config("stream_default", REFRESH)
    a = tr.run_stream(cfg, 150, n_reps=3, seed=8, device="cpu")
    init = tr.state_from_numpy(cfg, *tr.draw_init(cfg, 3, 8), "cpu")
    arr = tr.draw_arrivals(cfg, 150, 3, seed=8, device="cpu")
    b = tr.run_stream(cfg, 150, n_reps=3, device="cpu", init=init,
                      arrivals=arr)
    for k, v in a.items():
        if torch.is_tensor(v):
            assert torch.equal(v, b[k]), k
    assert torch.equal(arr[0].sum(0), a["arrived"])
