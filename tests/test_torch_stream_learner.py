"""The port's learner-aware stream tick against the JAX package's router:
learner fusion, scored routing, uncertainty admission and single-device
stealing, with the reference's initial state and arrivals injected (see
``tests/test_torch_stream.py``). Every integer output (``model_known``,
``stolen`` and ``donated`` included) must be equal; float sums and the
learnability head's final parameters agree within rtol 1e-5, and so does
``stream_summary``. Reference calls run inside
``jax.threefry_partitionable(False)``.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.labelstream import router as jr  # noqa: E402
from repro_torch.labelstream import router as tr  # noqa: E402
from repro_torch.labelstream.arrivals import ArrivalConfig  # noqa: E402
from repro_torch.labelstream.routing import RoutingConfig  # noqa: E402
from repro_torch.scenarios import get_stream_config  # noqa: E402
from test_torch_stream import (  # noqa: E402
    H, N, REFRESH, _assert_outputs_match, _assert_summaries_match,
    _ref_cfg, _ref_draws,
)

NEW = ["skewed_learner_fused", "heterogeneous_pool", "heterogeneous_routed",
       "bursty_admission", "bursty_admission_uncertain", "chance_hard",
       "stream_sharded"]
LEARNABLE = {"routing": RoutingConfig(enabled=True,
                                      admission="uncertain_learnable")}
# stream_sharded at 20x its rate: backlogs build, so shards steal
LOADED = {"arrivals": ArrivalConfig(kind="poisson", rate=0.8)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_overrides(overrides):
    # the reference's config classes in place of the port's
    from repro.labelstream.arrivals import ArrivalConfig as JArrivals
    from repro.labelstream.routing import RoutingConfig as JRouting
    kinds = {"routing": JRouting, "arrivals": JArrivals}
    return {k: kinds[k](**dataclasses.asdict(v)) if k in kinds else v
            for k, v in (overrides or {}).items()}


@pytest.mark.parametrize("name,overrides",
                         [(n, None) for n in NEW]
                         + [("chance_hard", LEARNABLE),
                            ("skewed_learner_fused", REFRESH),
                            ("stream_sharded", LOADED)])
def test_learner_stream_matches_reference_with_injected_draws(name,
                                                              overrides):
    seed = 3
    jcfg = _ref_cfg(name, _ref_overrides(overrides))
    with jax.threefry_partitionable(False):
        want = jr.run_stream(jcfg, H, n_reps=N, seed=seed)
        ws, banks, seeds, n_new, n_arr = _ref_draws(jcfg, H, N, seed)
    want = jax.tree_util.tree_map(np.asarray, dict(want))
    assert int(want["done"].sum()) > 0
    cfg = get_stream_config(name, overrides)
    init = tr.state_from_numpy(cfg, ws, banks, seeds, "cpu")
    got = tr.run_stream(cfg, H, n_reps=N, device="cpu", init=init,
                        arrivals=(n_new, n_arr))
    # the learnability head after its last 60-step refit from scratch: its
    # entries near zero carry the run's accumulated rounding in absolute
    # terms, so the head is held at rtol 1e-5 of its largest entry
    for k in ("learn2_W", "learn2_b"):
        if k in want:
            w = want.pop(k)
            g = got.pop(k).numpy()
            scale = np.abs(w).max(axis=tuple(range(1, w.ndim)),
                                  keepdims=True)
            assert (np.abs(g - w) <= 1e-5 * scale).all(), k
    _assert_outputs_match(got, want)
    _assert_summaries_match(tr.stream_summary(cfg, got),
                            jr.stream_summary(jcfg, want))
    if cfg.learner.enabled:
        assert int(want["model_known"].sum()) > 0
    assert int(got["stolen"].sum()) == int(got["donated"].sum())
    if overrides is LOADED:
        assert int(want["stolen"].sum()) > 0


def test_state_from_numpy_carries_a_learner():
    """``state_from_numpy(..., learner=...)`` starts the run from the given
    learner: an untrained one reproduces the default start; a trained one
    with a full ring (fusion at full weight) calls more tasks known and
    buys fewer votes."""
    cfg = get_stream_config("skewed_learner_fused")
    L, C, Hs, n = cfg.learner, cfg.n_classes, 100, 2
    draws = tr.draw_init(cfg, n, 4)
    arr = tr.draw_arrivals(cfg, Hs, n, seed=4, rate_scale=10.0,
                           device="cpu")

    def run(learner):
        init = tr.state_from_numpy(cfg, *draws, "cpu", learner=learner)
        return tr.run_stream(cfg, Hs, n_reps=n, device="cpu", init=init,
                             arrivals=arr, warmup_frac=0.0)

    def state(W, b, buf_n):
        z = lambda *s: np.zeros(s, np.float32)
        return dict(learn=(W, b, z(*W.shape), z(*b.shape), z(*W.shape),
                           z(*b.shape), np.zeros(n, np.int32)),
                    buf_X=z(n, L.buffer + 1, L.n_features),
                    buf_y=np.zeros((n, L.buffer + 1), np.int32),
                    buf_n=np.full(n, buf_n, np.int32))

    base = run(None)
    untrained = run(state(np.zeros((n, L.n_features, C), np.float32),
                          np.zeros((n, C), np.float32), 0))
    for k, v in base.items():
        if torch.is_tensor(v):
            assert torch.equal(v, untrained[k]), k
    # a learner that reads the class means: logit gap ~ 2 * 2 * 1.8
    W = np.broadcast_to(2.0 * np.eye(L.n_features, C, dtype=np.float32),
                        (n, L.n_features, C)).copy()
    trained = run(state(W, np.zeros((n, C), np.float32), L.buffer))
    total = lambda o, k: int(o[k].sum())
    # more tasks known, fewer crowd votes bought
    assert total(trained, "model_known") > total(base, "model_known")
    assert total(trained, "completions") < total(base, "completions")
    with pytest.raises(ValueError, match="lacks"):
        tr.state_from_numpy(cfg, *draws, "cpu", learner={"buf_n": 0})
