"""The device-sharded labeling service of the port (``sharding.n_devices =
D > 1``): one controller over D shard groups, here all on the CPU.

Two ways of holding it, as ``src/repro/labelstream/router.py`` promises
for its ``shard_map`` tick (any device count gives bit-identical results):

- the port at D groups against the port at one group, every output
  ``torch.equal`` (tolerance 0): ``run_stream`` on ``stream_sharded``
  (default, overloaded with stealing, traced), ``skewed_adaptive5`` with
  the EM refresh, ``lm_stream`` on an injected bank, ``serve_tick`` tick for
  tick, ``LabelServer``, the batch engine's replication split, a sharded
  grid class, ``scenarios.run`` / ``sweep``;
- the port at D = 2 against the reference's unsharded run with its draws
  injected (reference calls inside ``jax.threefry_partitionable(False)``):
  integer outputs equal, floats within rtol 1e-5 as in
  tests/test_torch_stream.py.

A structural test checks that a D run really holds D group states of
``n_shards / D`` shards, and the validation tests the reference's messages.
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
from repro.launch import mesh as jmesh  # noqa: E402
from repro.scenarios import get_scenario as jget  # noqa: E402
from repro.scenarios.compile import to_serve_config as jserve  # noqa: E402
from repro_torch import grid as tgrid  # noqa: E402
from repro_torch import scenarios as T  # noqa: E402
from repro_torch.core import simfast as ts  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.kernels.ds_estep import ds_estep  # noqa: E402
from repro_torch.kernels.uncertainty import entropy_scores  # noqa: E402
from repro_torch.labelstream import router as tr  # noqa: E402
from repro_torch.labelstream.arrivals import ArrivalConfig  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.learning import linear  # noqa: E402
from repro_torch.obs.trace import TraceConfig  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    get_fast_config, get_scenario, get_stream_config, spec_dataset,
    to_serve_config,
)
from repro_torch.serving.server import LabelServer, ServeClient  # noqa: E402
from test_torch_serve import FLOAT_KEYS, INT_KEYS, _flood  # noqa: E402
from test_torch_stream import (  # noqa: E402
    _assert_outputs_match, _ref_cfg, _ref_draws,
)

H, N = 120, 2
# stream_sharded overloaded: 8-slot windows at 10x the rate, so backlogs
# build and shards steal
OVERLOAD = {"window": 8,
            "arrivals": ArrivalConfig(kind="poisson", rate=0.4)}
REFRESH = {"refresh_every": 20, "refresh_iters": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sharded(cfg, D):
    return dataclasses.replace(
        cfg, sharding=dataclasses.replace(cfg.sharding, n_devices=D))


def _flat(out, prefix=""):
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(_flat(v, f"{prefix}{k}."))
        else:
            flat[prefix + k] = v
    return flat


def _assert_equal(got, want):
    """Every output equal: tensors by ``torch.equal``, numbers by ==."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k, v in w.items():
        if torch.is_tensor(v):
            assert g[k].device == v.device and torch.equal(g[k], v), k
        else:
            assert g[k] == v, k


# ---------------------------------------------------------- run_stream ----

@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", ["default", "overloaded", "traced"])
def test_stream_sharded_equals_one_group(case, D):
    ov = {"default": None, "overloaded": OVERLOAD,
          "traced": {"trace": TraceConfig()}}[case]
    cfg = get_stream_config("stream_sharded", ov)
    one = tr.run_stream(cfg, H, n_reps=N, seed=4, device="cpu")
    got = tr.run_stream(_sharded(cfg, D), H, n_reps=N, seed=4, device="cpu")
    _assert_equal(got, one)
    assert int(one["done_all"].sum()) > 0
    stolen, donated = int(got["stolen"].sum()), int(got["donated"].sum())
    assert stolen == donated
    if case == "overloaded":
        assert stolen > 0
    if case == "traced":
        assert "ph_backlog_wait" in got and "votes" in got["series"]


def test_refresh_and_lm_bank_equal_one_group():
    """``skewed_adaptive5`` with the periodic EM refresh (the E-step on
    the CPU's plain path: no kernel launch) and ``lm_stream`` on an
    injected bank, at two groups."""
    cfg = get_stream_config("skewed_adaptive5", REFRESH)
    before = ds_estep.launches
    one = tr.run_stream(cfg, H, n_reps=N, seed=2, device="cpu")
    got = tr.run_stream(_sharded(cfg, 2), H, n_reps=N, seed=2,
                        device="cpu")
    assert ds_estep.launches == before
    _assert_equal(got, one)
    cfg = get_stream_config("lm_stream")
    L = cfg.learner
    bank = np.random.default_rng(0).normal(
        size=(2, cfg.n_classes, 16, L.n_features)).astype(np.float32)
    one = tr.run_stream(cfg, 200, n_reps=N, seed=2, device="cpu", bank=bank)
    got = tr.run_stream(_sharded(cfg, 2), 200, n_reps=N, seed=2,
                        device="cpu", bank=bank)
    _assert_equal(got, one)
    assert int(one["model_known"].sum()) > 0


def test_sharded_stream_matches_reference_with_injected_draws():
    """Two groups on the reference's unsharded draws (its init, arrivals
    and, for the refresh, the same E-step schedule): integer outputs
    equal, floats within rtol 1e-5."""
    for name, ov in (("stream_sharded", OVERLOAD),
                     ("skewed_adaptive5", REFRESH)):
        jcfg = _ref_cfg(name, ov)
        with jax.threefry_partitionable(False):
            want = jr.run_stream(jcfg, H, n_reps=N, seed=3)
            ws, banks, seeds, n_new, n_arr = _ref_draws(jcfg, H, N, 3)
        want = jax.tree_util.tree_map(np.asarray, dict(want))
        cfg = _sharded(get_stream_config(name, ov), 2)
        got = tr.run_stream(cfg, H, n_reps=N, device="cpu",
                            init=tr.state_from_numpy(cfg, ws, banks, seeds,
                                                     "cpu"),
                            arrivals=(n_new, n_arr))
        _assert_outputs_match(got, want)
        assert int(want["done"].sum()) > 0
        if name == "stream_sharded":
            assert int(got["stolen"].sum()) > 0


def test_a_sharded_run_holds_its_groups(monkeypatch):
    """No quiet single-group path: a run at D = 4 advances four groups of
    n_shards / 4 shards a tick, and a sharded serve state holds them."""
    calls = []
    tick = tr._shard_tick

    def spy(cfg, ws, banks, win, bl, n_arr, t, step, seed, *a, **kw):
        calls.append((step, seed.shape[0], n_arr.shape[0]))
        return tick(cfg, ws, banks, win, bl, n_arr, t, step, seed, *a, **kw)

    monkeypatch.setattr(tr, "_shard_tick", spy)
    cfg = _sharded(get_stream_config("stream_sharded"), 4)
    tr.run_stream(cfg, 3, n_reps=N, device="cpu")
    S = cfg.n_shards
    assert calls == [(s, N * S // 4, N * S // 4)
                     for s in range(3) for _ in range(4)]
    st = tr.serve_init(to_serve_config(get_scenario(
        "stream_sharded", {"sharding.n_devices": 4})), 0, device="cpu")
    assert len(st["groups"]) == 4 and st["mesh"].size == 4
    assert all(g["seeds"].shape == (S // 4,) for g in st["groups"])
    flat = tr.gather_state(cfg, st)
    one = tr.serve_init(to_serve_config(get_scenario("stream_sharded")), 0,
                        device="cpu")
    for k in ("ws", "win", "bl"):
        for f, v in one[k].items():
            assert torch.equal(flat[k][f], v), (k, f)
    assert torch.equal(flat["seeds"], one["seeds"])


# -------------------------------------------------------------- serve ----

def _serve(cfg, state, sched, inj=None):
    outs, base = [], np.zeros(cfg.n_shards, np.int64)
    for i, n in enumerate(sched):
        f, lab = inj[i] if inj is not None else (None, None)
        state, o = tr.serve_tick(cfg, state, n, base, feat=f, labels=lab)
        outs.append(tr.serve_out_numpy(o))
        base += n
    return outs, state


def _lm_injections(cfg, sched, seed):
    S, M, F = cfg.n_shards, cfg.max_arrivals_per_tick, cfg.learner.n_features
    rng = np.random.default_rng(seed)
    out = []
    for n in sched:
        feat = np.full((S, M, F), np.nan, np.float32)
        lab = np.full((S, M), -1, np.int64)
        for s in range(S):
            for w in range(int(n[s])):
                if rng.random() < 0.5:
                    feat[s, w] = rng.normal(size=F)
                else:
                    lab[s, w] = rng.integers(0, cfg.n_classes)
        out.append((feat, lab))
    return out


@pytest.mark.parametrize("name", ["stream_sharded", "lm_stream"])
def test_serve_tick_sharded_equals_one_group(name):
    """Tick for tick at two groups, the identity rings (uid, and the LM
    label / embedding with injected ``feat`` / ``labels``) riding the
    cross-group steal: every output equal, and the end state too."""
    ov = {"window": 8} if name == "stream_sharded" else \
        {"sharding.steal": "pressure", "pool.n_shards": 4}
    cfg1 = to_serve_config(get_scenario(name, ov))
    cfg2 = to_serve_config(get_scenario(name, dict(
        ov, **{"sharding.n_devices": 2})))
    kw = {}
    if cfg1.learner.feature_kind == "lm":
        kw["bank"] = np.random.default_rng(1).normal(
            size=(2, cfg1.n_classes, 16, cfg1.learner.n_features)
        ).astype(np.float32)
    sched = _flood(cfg1.n_shards, 30)
    sched = np.minimum(sched, cfg1.max_arrivals_per_tick)
    inj = _lm_injections(cfg1, sched, 2) if kw else None
    one, end1 = _serve(cfg1, tr.serve_init(cfg1, 5, device="cpu", **kw),
                       sched, inj)
    st2 = tr.serve_init(cfg2, 5, device="cpu", **kw)
    assert len(st2["groups"]) == 2
    two, end2 = _serve(cfg2, st2, sched, inj)
    for i, (g, w) in enumerate(zip(two, one)):
        for k in INT_KEYS + FLOAT_KEYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i}: {k}")
        assert g["t"] == w["t"]
    end2 = tr.gather_state(cfg2, end2)
    for part in ("ws", "win", "bl"):
        for k, v in end1[part].items():
            assert torch.equal(end2[part][k], v), (part, k)
    assert sum(int(o["stolen"].sum()) for o in two) > 0
    assert sum(int(o["fin"].sum()) for o in two) > 0


def test_sharded_serve_matches_reference_tick_for_tick():
    """The reference's unsharded ``serve_init`` state injected into a
    two-group serve state: integer outputs equal, conf / tis within rtol
    1e-5, atol 1e-6 (as tests/test_torch_serve.py)."""
    name, ov = "stream_sharded", {"window": 8}
    jcfg = jserve(jget(name, ov))
    cfg = to_serve_config(get_scenario(name, dict(
        ov, **{"sharding.n_devices": 2})))
    sched = _flood(cfg.n_shards, 24)
    with jax.threefry_partitionable(False):
        st = jr.serve_init(jcfg, 11)
        init = jax.device_get(st)
        want, base = [], np.zeros(cfg.n_shards, np.int64)
        for n in sched:
            st, o = jr.serve_tick(jcfg, st, n.astype(np.int32),
                                  base.astype(np.int32))
            want.append(jax.device_get(o))
            base += n
    state = tr.serve_state_from_numpy(cfg, init, "cpu")
    assert len(state["groups"]) == 2
    got, _ = _serve(cfg, state, sched)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in INT_KEYS:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]),
                                          err_msg=f"tick {i}: {k}")
        for k in FLOAT_KEYS:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"tick {i}: {k}")
    assert sum(int(o["stolen"].sum()) for o in got) > 0


def test_label_server_serves_a_sharded_config():
    """``LabelServer`` on ``stream_sharded`` at two groups on the CPU:
    every submission answers and the ledger balances."""
    async def main():
        srv = await LabelServer(
            get_scenario("stream_sharded", {"sharding.n_devices": 2}),
            seed=0, port=0, tick_interval_s=0.0, device="cpu").start()
        assert len(srv.state["groups"]) == 2
        c = await ServeClient(srv.host, srv.port).connect()
        out = [await c.submit(wait=True, timeout_s=30.0) for _ in range(12)]
        await c.aclose()
        stats = srv.stats()
        await srv.close()
        return out, stats

    out, stats = asyncio.run(asyncio.wait_for(main(), 60.0))
    assert all(s == 200 and r["status"] == "done" for s, r in out), out
    assert stats["submitted"] == stats["answered"] == 12
    assert stats["conservation"] is True


# ------------------------------------------------------- batch engine ----

def _same(a, b, path=""):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _same(a[k], b[k], f"{path}{k}.")
    else:
        assert torch.equal(a, b), path


def test_batch_engine_replication_split_equals_one_device(monkeypatch):
    """``simulate``, ``simulate_swept_pop`` and ``simulate_learning_batch``
    split across three CPU devices, with 5 rows (padded to 6) each: every
    output equal to the one-device run, the entropy scored once per round
    on each device (the plain version here: no kernel launch)."""
    cfg = get_fast_config("smallR1")
    cpu3 = ["cpu"] * 3
    _same(ts.simulate(cfg, 5, seed=3, device="cpu", devices=cpu3),
          ts.simulate(cfg, 5, seed=3, device="cpu"))
    pop = ts.PopTraced(acc_a=np.array([5.0, 9.0, 12.0, 15.0, 18.0]))
    got = ts.simulate_swept_pop(cfg, 2, pop, seed=1, device="cpu",
                                devices=cpu3)
    _same(got, ts.simulate_swept_pop(cfg, 2, pop, seed=1, device="cpu"))
    assert got["done"].shape[:2] == (5, 2)
    hcfg = get_fast_config("hybrid_small")
    X, y, Xt, yt = spec_dataset("hybrid_small", 256, 64)
    calls = []
    real = linear.entropy_from_logits

    def count(lg, **kw):
        calls.append(lg.shape[0])
        return real(lg, **kw)

    monkeypatch.setattr(linear, "entropy_from_logits", count)
    before = entropy_scores.launches
    got = ts.simulate_learning_batch(hcfg, X, y, Xt, yt, rounds=3, n_reps=5,
                                     device="cpu", devices=cpu3)
    assert entropy_scores.launches == before
    assert calls == [2] * 9                 # 3 rounds x 3 devices x 2 rows
    monkeypatch.undo()
    _same(got, ts.simulate_learning_batch(hcfg, X, y, Xt, yt, rounds=3,
                                          n_reps=5, device="cpu"))
    # shard=False and too few replications keep one device
    _same(ts.simulate(cfg, 2, seed=3, device="cpu", devices=cpu3),
          ts.simulate(cfg, 2, seed=3, device="cpu", shard=False,
                      devices=cpu3))


# ------------------------------------------------- grid and front door ----

def test_sharded_grid_class_and_front_door_equal_one_group():
    """A sharded grid class runs per cell through the sharded
    ``run_stream``; each cell equals its standalone run and the unsharded
    run. ``scenarios.run`` and a per-value ``sweep`` of a sharded spec
    equal the unsharded ones."""
    base = get_scenario("stream_sharded", {"sharding.n_devices": 2,
                                           "window": 8})
    g = T.GridSpec(base=base, axes=(("pool.acc_a", (6.0, 12.0)),))
    res = tgrid.run_grid(g, horizon=60, n_reps=N, seed=2, keep_raw=True,
                         device="cpu")
    assert [c["batched"] for c in res["classes"]] == [False]
    _, cells, _ = tgrid.partition_grid(g)
    for cell, (_, _, spec) in zip(res["cells"], cells):
        one = T.run(T.override(spec, {"sharding.n_devices": 1}), horizon=60,
                    n_reps=N, seed=2, device="cpu")
        assert cell["metrics"] == one["metrics"]
        _assert_equal(cell["raw"], one["raw"])
    sw = T.sweep(base, "pool.acc_a", [6.0, 12.0], horizon=60, n_reps=N,
                 seed=2, device="cpu")
    assert sw["vectorized"] is False
    assert sw["results"] == [c["metrics"] for c in res["cells"]]
    got = T.run(base, horizon=60, n_reps=N, seed=2, device="cpu",
                devices=["cpu", "cpu"])
    one = T.run(T.override(base, {"sharding.n_devices": 1}), horizon=60,
                n_reps=N, seed=2, device="cpu")
    _assert_equal(got["raw"], one["raw"])


# ---------------------------------------------------------- validation ----

def test_mesh_and_validation_raise_with_the_reference_messages(monkeypatch):
    def msg(fn, *a):
        with pytest.raises(ValueError) as e:
            fn(*a)
        return str(e.value)

    for args in ((6, 4), (8, 0), (3, 2)):
        assert msg(tmesh.check_stream_sharding, *args) \
            == msg(jmesh.check_stream_sharding, *args)
    tmesh.check_stream_sharding(8, 4)
    cfg = tr.StreamConfig(n_shards=3, pool_size=6,
                          sharding=tr.ShardingConfig(n_devices=2))
    with pytest.raises(ValueError, match="does not divide"):
        tr.run_stream(cfg, 10, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        jr.run_stream(jr.StreamConfig(
            n_shards=3, pool_size=6,
            sharding=jr.ShardingConfig(n_devices=2)), 10)
    mesh = tmesh.make_stream_mesh(4, "cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert tmesh.make_stream_mesh(2, devices=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError, match="devices= lists 1"):
        tmesh.make_stream_mesh(2, devices=["cpu"])
    sharded = _sharded(get_stream_config("stream_sharded"), 2)
    with pytest.raises(ValueError, match="devices= lists 3"):
        tr.run_stream(sharded, 5, device="cpu", devices=["cpu"] * 3)
    # a card machine with fewer cards than groups: the count is named, and
    # nothing runs on fewer groups
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices but only 1 "
                       "CUDA device.*devices="):
        tr.run_stream(sharded, 5)
    with pytest.raises(ValueError, match="needs 2 devices"):
        tr.serve_init(to_serve_config(get_scenario(
            "stream_sharded", {"sharding.n_devices": 2})))
    # the groups split evenly or not at all
    with pytest.raises(ValueError, match="does not split into 3"):
        tsh.shard_put({"a": torch.zeros(8)},
                      tmesh.StreamMesh((torch.device("cpu"),) * 3))
    with pytest.raises(ValueError, match="run_stream_grid"):
        tr.run_stream_grid(sharded, 5, tr.StreamTraced(), device="cpu")


def test_shard_helpers_round_trip():
    mesh = tmesh.make_stream_mesh(4, "cpu")
    x = torch.arange(2 * 8 * 3).reshape(2 * 8, 3)
    parts = tsh.shard_rows({"x": x, "none": None}, mesh, 2)
    assert [p["x"].shape for p in parts] == [(4, 3)] * 4
    assert torch.equal(parts[1]["x"], x.reshape(2, 8, 3)[:, 2:4].reshape(4, 3))
    assert torch.equal(tsh.gather_rows(parts, mesh, 2)["x"], x)
    specs = tsh.leading_axis_specs({"a": torch.zeros(3), "b": 1.0}, 0)
    assert specs == {"a": 0, "b": None}
    assert torch.equal(mesh.psum([torch.ones(2)] * 4), torch.full((2,), 4.0))
