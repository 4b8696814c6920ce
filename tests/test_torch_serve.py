"""The port's serve tick against the JAX package's, tick for tick.

The reference's ``serve_init(cfg, seed)`` state is injected into the port
(``serve_state_from_numpy``) and both ticks run the same injection
schedule. Every integer output (``fin``, ``uid``, ``label``, ``votes``,
``dropped``, ``backlog``, ``in_flight``, ``stolen``, ``donated``) must be
equal at every tick, and so must the integer leaves of the end state (but
for the dump rows of masked writes, whose contents the reference leaves to
XLA's scatter order); ``conf``, ``tis`` and ``t`` agree within rtol 1e-5,
atol 1e-6 (float order, ROADMAP C12). Then the port alone: two runs are
bitwise equal, conservation is exact at every tick, stolen = donated, and
a tick leaves the state it was given untouched. Reference calls run inside
``jax.threefry_partitionable(False)``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.labelstream import router as jr  # noqa: E402
from repro.scenarios import get_scenario as jget  # noqa: E402
from repro.scenarios.compile import to_serve_config as jserve  # noqa: E402
from repro_torch.labelstream import router as tr  # noqa: E402
from repro_torch.scenarios import get_scenario, to_serve_config  # noqa: E402

INT_KEYS = ("fin", "uid", "label", "votes", "dropped", "backlog",
            "in_flight", "stolen", "donated")
FLOAT_KEYS = ("conf", "tis")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cycle(S, T):
    # the schedule of tests/test_embed.py's serve digests, T ticks long
    return np.asarray([[(i + s) % 3 for s in range(S)] for i in range(T)],
                      np.int64)


def _flood(S, T):
    # two hot shards at the per-tick maximum, the rest light: the hot
    # backlogs fill (their tails drop) and the others steal from them
    rng = np.random.default_rng(5)
    sched = rng.integers(0, 3, (T, S))
    sched[:, :2] = 64
    return sched


def _queue(S, T):
    # more arrivals than an 8-slot window admits: the ranked backlog fills
    return np.random.default_rng(6).integers(2, 9, (T, S))


CASES = {
    "serve_default-8": ("serve_default", None, _cycle, 8),
    "serve_default-40": ("serve_default", None, _cycle, 40),
    "stream_sharded-window8": ("stream_sharded", {"window": 8}, _flood, 24),
    "chance_hard-uncertain_learnable": (
        "chance_hard", {"policy.admission.kind": "uncertain_learnable"},
        _queue, 120),
}


def _run_ref(cfg, sched, seed):
    with jax.threefry_partitionable(False):
        st = jr.serve_init(cfg, seed)
        init = jax.device_get(st)
        outs, base = [], np.zeros(cfg.n_shards, np.int64)
        for n in sched:
            st, o = jr.serve_tick(cfg, st, n.astype(np.int32),
                                  base.astype(np.int32))
            outs.append(jax.device_get(o))
            base += n
    return init, outs, jax.device_get(st)


def _run_port(cfg, state, sched):
    outs, base = [], np.zeros(cfg.n_shards, np.int64)
    for n in sched:
        state, o = tr.serve_tick(cfg, state, n, base)
        outs.append(tr.serve_out_numpy(o))
        base += n
    return outs, state


def _end_ints(cfg, ref_end, port_end):
    """Pairs (name, reference, port) of the end state's integer leaves, the
    dump rows (window row W of the vote store, backlog row Q) cut."""
    Ws, Q = cfg.window, cfg.backlog
    pairs = []
    for part in ("ws", "win", "bl"):
        for k, v in ref_end[part].items():
            v = np.asarray(v)
            if v.dtype.kind not in "iub":
                continue
            g = port_end[part][k].numpy()
            if k in ("vote_wid", "vote_lab"):
                v, g = v[:, :Ws], g[:, :Ws]
            elif part == "bl" and v.ndim == 2 and v.shape[1] == Q + 1:
                v, g = v[:, :Q], g[:, :Q]
            pairs.append((f"{part}.{k}", v, g))
    ls = port_end["learner"]
    if ls is not None:
        for k in ("buf_y", "buf_n", "buf_t"):
            if k in ref_end:
                pairs.append((k, np.asarray(ref_end[k]), ls[k][0].numpy()))
        pairs.append(("learn.t", np.asarray(ref_end["learn"].t),
                      ls["learn"].t[0].numpy()))
    pairs.append(("step", np.asarray(ref_end["step"]),
                  np.asarray(port_end["step"])))
    return pairs


@pytest.mark.parametrize("case", sorted(CASES))
def test_serve_tick_matches_reference_tick_for_tick(case):
    name, ov, schedule, T = CASES[case]
    jcfg = jserve(jget(name, ov))
    cfg = to_serve_config(get_scenario(name, ov))
    sched = schedule(cfg.n_shards, T)
    init, want, ref_end = _run_ref(jcfg, sched, seed=11)
    got, end = _run_port(cfg, tr.serve_state_from_numpy(cfg, init, "cpu"),
                         sched)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in INT_KEYS:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]),
                                          err_msg=f"tick {i}: {k}")
        for k in FLOAT_KEYS:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"tick {i}: {k}")
        assert g["t"] == pytest.approx(float(w["t"]), rel=1e-7)
    for k, w, g in _end_ints(cfg, ref_end, end):
        np.testing.assert_array_equal(g, w, err_msg=f"end state {k}")
    total = lambda k: sum(int(g[k].sum()) for g in got)
    assert total("fin") > 0
    if name == "stream_sharded":
        # the schedule does what it is for: drops and steals
        assert total("dropped") > 0 and total("stolen") > 0
    if name == "chance_hard":
        assert int(end["learner"]["buf_n"].sum()) > 0


def _clone(state):
    def c(v):
        if torch.is_tensor(v):
            return v.clone()
        if isinstance(v, dict):
            return {k: c(x) for k, x in v.items()}
        if isinstance(v, tuple):
            return type(v)(*(c(x) for x in v))
        return v
    return c(state)


def _leaves(state, prefix=""):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        elif isinstance(v, tuple):
            out.update({f"{prefix}{k}.{f}": x for f, x in zip(v._fields, v)})
        elif v is not None:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("case", ["serve_default-40",
                                  "stream_sharded-window8",
                                  "chance_hard-uncertain_learnable"])
def test_serve_tick_deterministic_conserving_and_alias_free(case):
    name, ov, schedule, T = CASES[case]
    cfg = to_serve_config(get_scenario(name, ov))
    sched = schedule(cfg.n_shards, T)
    init = tr.serve_init(cfg, seed=7, device="cpu")
    kept = _clone(init)
    outs_a, end_a = _run_port(cfg, init, sched)
    outs_b, end_b = _run_port(cfg, tr.serve_init(cfg, seed=7, device="cpu"),
                              sched)
    # the state a caller keeps is not touched by the ticks
    for k, v in _leaves(kept).items():
        w = _leaves(init)[k]
        assert (torch.equal(v, w) if torch.is_tensor(v) else v == w), k
    for i, (a, b) in enumerate(zip(outs_a, outs_b)):
        for k in INT_KEYS + FLOAT_KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")
    la, lb = _leaves(end_a), _leaves(end_b)
    assert la.keys() == lb.keys()
    for k in la:
        assert (torch.equal(la[k], lb[k]) if torch.is_tensor(la[k])
                else la[k] == lb[k]), k
    injected = finalized = dropped = 0
    for n, o in zip(sched, outs_a):
        injected += int(n.sum())
        finalized += int(o["fin"].sum())
        dropped += int(o["dropped"].sum())
        assert injected == finalized + dropped + int(o["backlog"].sum()) \
            + int(o["in_flight"].sum())
        assert int(o["stolen"].sum()) == int(o["donated"].sum())
        # finalized slots answer real requests with a label and a vote
        fin = o["fin"]
        assert (o["uid"][fin] >= 0).all() and (o["votes"][fin] >= 0).all()
    assert finalized > 0


def test_serve_out_numpy_is_exact():
    cfg = to_serve_config(get_scenario("serve_default"))
    st = tr.serve_init(cfg, seed=0, device="cpu")
    for n in _cycle(cfg.n_shards, 6):
        st, out = tr.serve_tick(cfg, st, n, np.zeros(cfg.n_shards))
    host = tr.serve_out_numpy(out)
    assert host["fin"].dtype == bool and host["t"] == out["t"]
    for k in INT_KEYS + FLOAT_KEYS:
        v = out[k].numpy()
        assert host[k].shape == v.shape, k
        np.testing.assert_array_equal(host[k], v, err_msg=k)
        if k in FLOAT_KEYS:
            assert host[k].dtype == np.float32


def test_serve_entry_points_validate():
    cfg = to_serve_config(get_scenario("serve_default"))
    st = tr.serve_init(get_scenario("serve_default"), device="cpu")
    M, S = cfg.max_arrivals_per_tick, cfg.n_shards
    with pytest.raises(ValueError, match="max_arrivals_per_tick"):
        tr.serve_tick(cfg, st, np.full(S, M + 1), np.zeros(S))
    with pytest.raises(ValueError, match=r"\(2,\)"):
        tr.serve_tick(cfg, st, np.zeros(S + 1), np.zeros(S + 1))
    with pytest.raises(ValueError, match="feature_kind='lm'"):
        tr.serve_tick(cfg, st, np.zeros(S), np.zeros(S),
                      feat=np.zeros((S, M, 8)))
    with pytest.raises(ValueError, match="serve=True"):
        tr.serve_init(tr.StreamConfig(), device="cpu")
    with pytest.raises(ValueError, match="live-injection mode"):
        tr.run_stream(cfg, 5, device="cpu")
    lm = to_serve_config(get_scenario("lm_stream"))
    st = tr.serve_init(lm, device="cpu")
    assert st["bank"].shape == (2, 2, 16, 8) and st["bank"].device.type \
        == "cpu"
    S, M, F = lm.n_shards, lm.max_arrivals_per_tick, lm.learner.n_features
    with pytest.raises(ValueError, match="lm injections"):
        tr.serve_tick(lm, st, np.zeros(S), np.zeros(S),
                      feat=np.zeros((S, M, F + 1)))
    with pytest.raises(ValueError, match="lm injections"):
        tr.serve_tick(lm, st, np.zeros(S), np.zeros(S),
                      labels=np.zeros((S, M - 1)))
    st, out = tr.serve_tick(lm, st, np.ones(S), np.zeros(S),
                            feat=np.full((S, M, F), np.nan),
                            labels=np.full((S, M), -1))
    assert int(out["backlog"].sum() + out["in_flight"].sum()) == S


def test_serve_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.serve_init(get_scenario("serve_default"))
