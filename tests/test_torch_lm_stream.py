"""The port's LM-featured stream service against the JAX package: the
``lm_stream`` and ``lm_chance_hard`` workloads through ``run_stream``, a
sweep and a trace, ``serve_tick`` with injected text features and labels,
and text over HTTP.

The reference's initial state and arrivals are injected as in
tests/test_torch_stream.py, and so is its embedding bank
(``repro.labelstream.router._bank_for``, the reduced xlstm-125m's features):
the tick gathers from the bank with the counter hash both packages share,
so every integer output must be equal tick for tick; float sums agree
within rtol 1e-5 (``stream_summary`` too), the learnability head within
1e-5 of its largest entry (ROADMAP C12). Reference calls run inside
``jax.threefry_partitionable(False)``.
"""
import asyncio
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.labelstream import router as jr  # noqa: E402
from repro.scenarios import get_scenario as jget  # noqa: E402
from repro.scenarios.compile import to_serve_config as jserve  # noqa: E402
from repro_torch import scenarios as T  # noqa: E402
from repro_torch.labelstream import router as tr  # noqa: E402
from repro_torch.labelstream.arrivals import ArrivalConfig  # noqa: E402
from repro_torch.labelstream.routing import RoutingConfig  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    get_scenario, get_stream_config, to_serve_config,
)
from repro_torch.serving.server import LabelServer, ServeClient  # noqa: E402
from test_torch_serve import (  # noqa: E402
    FLOAT_KEYS, INT_KEYS, _end_ints, _flood,
)
from test_torch_stream import (  # noqa: E402
    H, N, _assert_outputs_match, _assert_summaries_match, _ref_cfg,
    _ref_draws,
)
from test_torch_stream_learner import _ref_overrides  # noqa: E402

LEARNABLE = {"routing": RoutingConfig(enabled=True,
                                      admission="uncertain_learnable")}
# lm_stream at 20x its rate: enough finalized tasks that the learner's
# fusion weight ramps up and tasks are called model-known
LOADED = {"arrivals": ArrivalConfig(kind="poisson", rate=0.2)}
LIMIT_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_timing():
    # the timing registry is the process's: start each test from an empty
    # one and leave it empty for the tests that run after in this process
    from repro_torch.obs import timing
    timing.clear()
    yield
    timing.clear()


def _ref_bank(jcfg):
    """The reference's embedding bank features of a stream config, as the
    reference's tick reads them (its own cache)."""
    with jax.threefry_partitionable(False):
        return np.asarray(jr._bank_for(jcfg))


# ------------------------------------------------------------ stream ----

@pytest.mark.parametrize("name,overrides", [
    ("lm_stream", None), ("lm_stream", LOADED), ("lm_chance_hard", None),
    ("lm_chance_hard", LEARNABLE)],
    ids=["lm_stream", "lm_stream-loaded", "lm_chance_hard",
         "lm_chance_hard-uncertain_learnable"])
def test_lm_stream_matches_reference_with_injected_draws(name, overrides):
    """200 ticks x 2 replications on the reference's init, arrivals and
    bank: every integer output equal, floats allclose. The
    ``uncertain_learnable`` override reaches the ranked backlog, whose
    arrivals gather their features at arrival."""
    seed = 3
    jcfg = _ref_cfg(name, _ref_overrides(overrides))
    bank = _ref_bank(jcfg)
    with jax.threefry_partitionable(False):
        want = jr.run_stream(jcfg, H, n_reps=N, seed=seed)
        ws, banks, seeds, n_new, n_arr = _ref_draws(jcfg, H, N, seed)
    want = jax.tree_util.tree_map(np.asarray, dict(want))
    assert int(want["done"].sum()) > 0
    cfg = get_stream_config(name, overrides)
    assert cfg.learner.feature_kind == "lm"
    init = tr.state_from_numpy(cfg, ws, banks, seeds, "cpu")
    got = tr.run_stream(cfg, H, n_reps=N, device="cpu", init=init,
                        arrivals=(n_new, n_arr), bank=bank)
    for k in ("learn2_W", "learn2_b"):
        if k in want:
            w, g = want.pop(k), got.pop(k).numpy()
            scale = np.abs(w).max(axis=tuple(range(1, w.ndim)),
                                  keepdims=True)
            assert (np.abs(g - w) <= 1e-5 * scale).all(), k
    _assert_outputs_match(got, want)
    _assert_summaries_match(tr.stream_summary(cfg, got),
                            jr.stream_summary(jcfg, want))
    if overrides is LOADED:
        assert int(want["model_known"].sum()) > 0


def test_lm_bank_builds_on_the_run_device_and_is_checked(monkeypatch):
    """Without ``bank=`` the run builds the port's own bank (cached per
    config and device) and equals a run given that bank; a bank of another
    layout raises; the bank defaults to the card."""
    cfg = get_stream_config("lm_stream", LOADED)
    bank = tr._bank_for(cfg, "cpu")
    assert bank.shape == (2, 2, 16, 8) and bank is tr._bank_for(cfg, "cpu")
    a = tr.run_stream(cfg, 60, n_reps=2, seed=1, device="cpu")
    b = tr.run_stream(cfg, 60, n_reps=2, seed=1, device="cpu",
                      bank=bank.numpy())
    _assert_outputs_match(a, {k: v.numpy() if torch.is_tensor(v) else v
                              for k, v in b.items() if k != "series"})
    with pytest.raises(ValueError, match="bank must be"):
        tr.run_stream(cfg, 5, device="cpu", bank=np.zeros((2, 2, 16, 4)))
    with pytest.raises(ValueError, match="only read"):
        tr.run_stream(get_stream_config("stream_default"), 5, device="cpu",
                      bank=bank)
    assert tr._bank_for(get_stream_config("stream_default"), "cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr._bank_for(cfg)


def test_lm_sweep_points_equal_standalone_runs_and_trace():
    """``run_stream_sweep`` on ``lm_stream``: each point equals its
    standalone run bit for bit; a traced ``lm_stream`` through
    ``scenarios.run`` equals the untraced run in every shared output."""
    cfg = get_stream_config("lm_stream")
    bank = tr._bank_for(cfg, "cpu")
    scales = [4.0, 20.0]
    sw = tr.run_stream_sweep(cfg, 80, scales, n_reps=2, seed=2,
                             device="cpu", bank=bank)
    for i, s in enumerate(scales):
        one = tr.run_stream(cfg, 80, n_reps=2, seed=2, rate_scale=s,
                            device="cpu", bank=bank)
        for k, v in one.items():
            if torch.is_tensor(v):
                assert torch.equal(sw[k][i], v), (s, k)
    assert int(sw["arrived"][1].sum()) > int(sw["arrived"][0].sum())
    assert int(sw["done"][0].sum()) > 0 and int(sw["done"][1].sum()) > 0
    spec = get_scenario("lm_stream", {"arrivals.rate": 0.2})
    plain = T.run(spec, horizon=120, n_reps=2, seed=4, device="cpu")
    traced = T.run(T.override(spec, {"trace.enabled": True}), horizon=120,
                   n_reps=2, seed=4, device="cpu")
    assert "trace" in traced and "trace" not in plain
    for k, v in plain["raw"].items():
        if torch.is_tensor(v):
            assert torch.equal(traced["raw"][k], v), k
    for k, v in plain["raw"]["series"].items():
        assert torch.equal(traced["raw"]["series"][k], v), k
    assert traced["metrics"]["phases"]


# ------------------------------------------------------------- serve ----

def _inject(cfg, sched, seed, with_inj):
    """Per tick, (feat (S, M, F), labels (S, M)) for the tick's arrivals:
    a third real feature rows, a third given labels (both, some), the rest
    NaN / -1 (simulate); None without injections."""
    S, M, F = cfg.n_shards, cfg.max_arrivals_per_tick, cfg.learner.n_features
    rng = np.random.default_rng(seed)
    out = []
    for n in sched:
        if not with_inj:
            out.append((None, None))
            continue
        feat = np.full((S, M, F), np.nan, np.float32)
        lab = np.full((S, M), -1, np.int32)
        for s in range(S):
            for w in range(int(n[s])):
                r = rng.random()
                if r < 0.33 or r > 0.9:
                    feat[s, w] = rng.normal(size=F).astype(np.float32)
                if r > 0.66:
                    lab[s, w] = rng.integers(0, cfg.n_classes)
        out.append((feat, lab))
    return out


def _light(S, T):
    # a steady trickle that keeps the 8-slot windows busy
    return np.random.default_rng(7).integers(0, 3, (T, S))


SERVE = {
    "lm_stream": ("lm_stream", None, _light, 60, True),
    "lm_stream-simulated": ("lm_stream", None, _light, 60, False),
    "lm_chance_hard": ("lm_chance_hard", None, _light, 60, True),
    "lm_chance_hard-uncertain_learnable": (
        "lm_chance_hard", {"policy.admission.kind": "uncertain_learnable"},
        _light, 60, True),
    "lm_stream-steal": ("lm_stream", {"sharding.steal": "pressure",
                                      "pool.n_shards": 4}, _flood, 24, True),
}


@pytest.mark.parametrize("case", sorted(SERVE))
def test_lm_serve_tick_matches_reference_tick_for_tick(case):
    """``serve_tick`` on the LM workloads against the reference's, from its
    ``serve_init`` state with its bank injected, injections mixing real
    feature rows, known labels and simulated arrivals; the stealing case
    moves the label / difficulty / embedding rings."""
    name, ov, schedule, T_, with_inj = SERVE[case]
    jcfg = jserve(jget(name, ov))
    cfg = to_serve_config(get_scenario(name, ov))
    sched = schedule(cfg.n_shards, T_)
    inj = _inject(cfg, sched, 9, with_inj)
    with jax.threefry_partitionable(False):
        bank = np.asarray(jr._bank_for(jcfg))
        st = jr.serve_init(jcfg, 11)
        init = jax.device_get(st)
        want, base = [], np.zeros(cfg.n_shards, np.int64)
        for n, (f, lab) in zip(sched, inj):
            st, o = jr.serve_tick(jcfg, st, n.astype(np.int32),
                                  base.astype(np.int32), feat=f, labels=lab)
            want.append(jax.device_get(o))
            base += n
        ref_end = jax.device_get(st)
    state = tr.serve_state_from_numpy(cfg, init, "cpu", bank=bank)
    got, base = [], np.zeros(cfg.n_shards, np.int64)
    for n, (f, lab) in zip(sched, inj):
        state, o = tr.serve_tick(cfg, state, n, base, feat=f, labels=lab)
        got.append(tr.serve_out_numpy(o))
        base += n
    for i, (g, w) in enumerate(zip(got, want)):
        for k in INT_KEYS:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]),
                                          err_msg=f"tick {i}: {k}")
        for k in FLOAT_KEYS:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"tick {i}: {k}")
    for k, w, g in _end_ints(cfg, ref_end, state):
        np.testing.assert_array_equal(g, w, err_msg=f"end state {k}")
    if "feat" in ref_end["bl"]:
        Q = cfg.backlog
        np.testing.assert_allclose(state["bl"]["feat"][:, :Q].numpy(),
                                   np.asarray(ref_end["bl"]["feat"])[:, :Q],
                                   rtol=1e-6)
    total = lambda k: sum(int(g[k].sum()) for g in got)
    assert total("fin") > 0
    if case == "lm_stream-steal":
        assert total("stolen") > 0 and total("stolen") == total("donated")


def test_lm_serve_given_labels_and_features_reach_the_window():
    """Labels >= 0 become the admitted tasks' true labels and finite
    feature rows their features; NaN rows and -1 draw from the bank."""
    cfg = to_serve_config(get_scenario("lm_stream"))
    S, M, F = cfg.n_shards, cfg.max_arrivals_per_tick, cfg.learner.n_features
    st = tr.serve_init(cfg, seed=3, device="cpu")
    feat = np.full((S, M, F), np.nan, np.float32)
    feat[:, 0] = 7.0
    labels = np.full((S, M), -1)
    labels[:, 0] = 1
    st, _ = tr.serve_tick(cfg, st, np.ones(S), np.zeros(S), feat=feat,
                          labels=labels)
    win = st["win"]
    assert bool(win["active"].any(-1).all())
    on = win["active"]
    assert bool((win["true_label"][on] == 1).all())
    assert bool((win["feat"][on] == 7.0).all())
    st, _ = tr.serve_tick(cfg, st, np.ones(S), np.ones(S))
    new = st["win"]["active"] & ~on
    bank = st["bank"].reshape(-1, F)
    rows = st["win"]["feat"][new]
    assert rows.shape[0] == S
    assert all(bool((bank == r).all(-1).any()) for r in rows)


# -------------------------------------------------------------- HTTP ----

def _run(coro):
    async def bounded():
        return await asyncio.wait_for(coro, LIMIT_S)
    return asyncio.run(bounded())


async def _lm_server(monkeypatch=None, calls=None):
    if calls is not None:
        real = tr.serve_tick

        def spy(cfg, state, n_arr, uid_base, feat=None, labels=None):
            calls.append((np.array(n_arr), feat, labels))
            return real(cfg, state, n_arr, uid_base, feat=feat,
                        labels=labels)
        monkeypatch.setattr(tr, "serve_tick", spy)
    return await LabelServer(get_scenario("lm_stream"), seed=0, port=0,
                             tick_interval_s=0.0, device="cpu").start()


def test_lm_text_submission_embeds_and_answers(monkeypatch):
    """A submission with text (and a known label) is embedded on the
    server's device, injected into its tick and answered; a plain one
    answers beside it; the embed shows in the timing rows."""
    calls = []

    async def main():
        srv = await _lm_server(monkeypatch, calls)
        c = await ServeClient(srv.host, srv.port).connect()
        texted = await c.submit(wait=True, timeout_s=50.0,
                                text="the quick brown fox", label=1)
        plain = await c.submit(wait=True, timeout_s=50.0)
        stats = srv.stats()
        await c.aclose()
        await srv.close()
        return texted, plain, stats

    (st, rt), (sp, rp), stats = _run(main())
    assert st == 200 and rt["status"] == "done", (st, rt)
    assert sp == 200 and rp["status"] == "done", (sp, rp)
    assert rt["label"] in (0, 1) and rt["votes"] >= 1
    assert stats["answered"] == stats["submitted"] == 2
    assert stats["conservation"] is True
    assert {row["name"] for row in stats["timing"]} >= {"serve.tick",
                                                        "serve.embed"}
    injected = [(f, lab) for _, f, lab in calls if f is not None]
    assert len(injected) == 1
    f, lab = injected[0]
    s, w = np.argwhere(lab == 1)[0]
    assert np.isfinite(f[s, w]).all() and (lab >= 0).sum() == 1
    assert np.isnan(np.delete(f.reshape(-1, f.shape[-1]),
                              s * f.shape[1] + w, 0)).all()


def test_lm_given_label_is_honoured(monkeypatch):
    """A label-only submission injects its label (no text, no embed call)
    into the tick as the task's true label and is answered."""
    calls = []

    async def main():
        srv = await _lm_server(monkeypatch, calls)
        c = await ServeClient(srv.host, srv.port).connect()
        r = await c.submit(wait=True, timeout_s=50.0, label=0)
        stats = srv.stats()
        await c.aclose()
        await srv.close()
        return r, stats

    (status, r), stats = _run(main())
    assert status == 200 and r["status"] == "done", r
    inj = [(f, lab) for _, f, lab in calls if lab is not None]
    assert len(inj) == 1
    f, lab = inj[0]
    assert (lab == 0).sum() == 1 and (lab >= 0).sum() == 1
    assert np.isnan(f).all()
    assert "serve.embed" not in {row["name"] for row in stats["timing"]}


def test_lm_server_rejects_bad_fields_and_gaussian_text():
    """400 for a non-string text and a label outside [-1, C) on an LM
    server, and for text or a label on a Gaussian one; none enters the
    ledger."""
    async def main():
        srv = await _lm_server()
        c = await ServeClient(srv.host, srv.port).connect()
        got = {}
        for key, body in (("text_int", {"text": 5}),
                          ("label_hi", {"label": 2}),
                          ("label_lo", {"label": -2}),
                          ("label_str", {"label": "1"}),
                          ("label_bool", {"label": True})):
            got[key] = (await c.request("POST", "/tasks", body))[0]
        stats = srv.stats()
        await c.aclose()
        await srv.close()
        gs = await LabelServer(get_scenario("serve_default"), seed=0,
                               port=0, tick_interval_s=0.0,
                               device="cpu").start()
        c = await ServeClient(gs.host, gs.port).connect()
        status, r = await c.submit(text="hello", label=0)
        got["gaussian_text"] = status
        got["gaussian_error"] = "lm" in r["error"]
        gstats = gs.stats()
        await c.aclose()
        await gs.close()
        return got, stats, gstats

    got, stats, gstats = _run(main())
    assert got == {"text_int": 400, "label_hi": 400, "label_lo": 400,
                   "label_str": 400, "label_bool": 400,
                   "gaussian_text": 400, "gaussian_error": True}
    assert stats["submitted"] == 0 and gstats["submitted"] == 0


def test_lm_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.serve_init(get_scenario("lm_stream"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LabelServer(get_scenario("lm_chance_hard"))


def test_heterogeneous_stream_config_matches_reference():
    """ROADMAP A14: the canonical heterogeneous-pool config, with and
    without overrides, field for field."""
    from repro_torch.labelstream import heterogeneous_stream_config as tcfg
    for ov in ({}, {"window": 8, "n_shards": 4}):
        want = dataclasses.asdict(jr.heterogeneous_stream_config(**ov))
        assert dataclasses.asdict(tcfg(**ov)) == want
