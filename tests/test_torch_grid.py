"""The port's grid engine against the JAX package's: ``partition_grid``,
``run_grid`` and the ``python -m repro_torch.grid`` command line.

The partition is held to the reference's classes and cell order on every
registered grid and on the reference test's edge cases. Each class of a
batched grid must equal, cell by cell, the port's own standalone
``scenarios.run`` of that cell, bit for bit. Against the reference, each
class run gets the reference's draws for each of its cells (injected
through the batched runs' ``draws=`` as in ``tests/test_torch_sweep.py``):
every integer output of every cell equal, floats within the tolerances of
``tests/test_torch_stream.py`` / ``test_torch_sweep.py``, and each cell's
metrics equal to the reference's ``run_grid(keep_raw=True)`` cell metrics
(integers exactly, floats to 1e-5 relative). Reference calls run inside
``jax.threefry_partitionable(False)``.
"""
import dataclasses
import json
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.grid as jgrid  # noqa: E402
from repro import scenarios as J  # noqa: E402
from repro.core import simfast as js  # noqa: E402
from repro.grid.__main__ import main as jmain  # noqa: E402
from repro.scenarios.compile import (  # noqa: E402
    to_fast_config as jfast, to_stream_config as jstream,
)
from repro_torch import grid as tgrid  # noqa: E402
from repro_torch import scenarios as T  # noqa: E402
from repro_torch.core import simfast as ts  # noqa: E402
from repro_torch.grid.__main__ import main as tmain  # noqa: E402
from repro_torch.labelstream import router as tr  # noqa: E402
from repro_torch.obs.export import grid_doc, read_grid, write_grid  # noqa
from test_torch_stream import _assert_outputs_match  # noqa: E402
from test_torch_sweep import _ref_point_draws, _ref_pop_draws  # noqa: E402

SMALL = {"pool.pool_size": 6, "window": 16}
H, N, SEED = 120, 2, 0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(base_t, base_j, axes, name=None):
    return (T.GridSpec(base=base_t, axes=axes, name=name),
            J.GridSpec(base=base_j, axes=axes, name=name))


def _classes(classes):
    return [c.cells for c in classes]


def _same(a, b, path=""):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _same(a[k], b[k], f"{path}{k}.")
    elif torch.is_tensor(b):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _close_metrics(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _close_metrics(g, w)
        elif isinstance(w, (float, np.floating)) and math.isfinite(w):
            assert g == pytest.approx(float(w), rel=1e-5), k
        elif isinstance(w, (float, np.floating)) and math.isnan(w):
            assert math.isnan(g), k
        else:
            assert g == w, k


# ---- the partition --------------------------------------------------------

@pytest.mark.parametrize("name", ["paper_stream", "paper_fast",
                                  "grid_smoke_stream",
                                  "grid_smoke_simfast"])
def test_registered_grids_partition_as_the_reference(name):
    tg, jg = T.get_grid(name), J.get_grid(name)
    te, tcells, tcls = tgrid.partition_grid(tg)
    je, jcells, jcls = jgrid.partition_grid(jg)
    assert te == je
    assert [(i, v) for i, v, _ in tcells] == [(i, v) for i, v, _ in jcells]
    assert _classes(tcls) == _classes(jcls)
    assert len(tcls) == {"paper_stream": 2, "paper_fast": 2}.get(name, 1)
    assert [c.class_id for c in tcls] == list(range(len(tcls)))


@pytest.mark.parametrize("case", ["traced-one-class", "static-splits",
                                  "events-hash-equal", "invalid-reset",
                                  "horizon"])
def test_partition_edge_cases_match_reference(case):
    def stream(mod, extra=None):
        return mod.get_scenario("stream_default", {**SMALL, **(extra or {})})
    engine, kw = None, {}
    if case == "traced-one-class":
        axes = (("arrivals.rate", (0.008, 0.012)),
                ("policy.redundancy.votes", (1, 2, 3)),
                ("pool.acc_a", (6.0, 9.0)))
        base = (stream(T), stream(J))
    elif case == "static-splits":
        axes = (("policy.straggler.enabled", (False, True)),
                ("arrivals.rate", (0.008, 0.010, 0.012)))
        base = (stream(T), stream(J))
    elif case == "events-hash-equal":
        axes = (("n_tasks", (40, 40, 80)),)
        base = (T.get_scenario("smallR1"), J.get_scenario("smallR1"))
        engine = "events"
    elif case == "invalid-reset":
        ov = {"policy.redundancy.votes": 2, "policy.redundancy.min_votes": 2}
        axes = (("policy.redundancy.votes", (3, 5)),
                ("policy.redundancy.min_votes", (3,)))
        base = (stream(T, ov), stream(J, ov))
    else:
        axes = (("arrivals.rate", (0.008, 0.012)),)
        base = (stream(T), stream(J))
        kw = dict(horizon=100)
    tg, jg = _grids(*base, axes)
    te, _, tcls = tgrid.partition_grid(tg, engine, **kw)
    je, _, jcls = jgrid.partition_grid(jg, engine, **kw)
    assert te == je
    assert _classes(tcls) == _classes(jcls)
    want = {"traced-one-class": [tuple(range(12))],
            "static-splits": [(0, 1, 2), (3, 4, 5)],
            "events-hash-equal": [(0, 1), (2,)],
            "invalid-reset": [(0,), (1,)],
            "horizon": [(0, 1)]}[case]
    assert _classes(tcls) == want


def test_configs_hash_equal_iff_equal():
    """The frozen engine configs hold no tensors: configs that compare
    equal hash equal, which the partition relies on."""
    for lower in (T.to_stream_config, T.to_fast_config):
        base = "stream_default" if lower is T.to_stream_config \
            else "smallR1"
        a, b = lower(T.get_scenario(base)), lower(T.get_scenario(base))
        assert a == b and hash(a) == hash(b) and a is not b
        leaves = [getattr(a, f.name) for f in dataclasses.fields(a)]
        assert not any(torch.is_tensor(v) for v in leaves)


def test_non_gridspec_raises_the_reference_error():
    for part, get in ((tgrid.partition_grid, T.get_scenario),
                      (jgrid.partition_grid, J.get_scenario)):
        with pytest.raises(TypeError, match="partition_grid takes a "
                                            "GridSpec, got ScenarioSpec"):
            part(get("smallR1"))
    with pytest.raises(TypeError, match="GridSpec"):
        tgrid.run_grid(T.get_scenario("smallR1"), device="cpu")
    with pytest.raises(KeyError, match="unknown grid"):
        T.get_grid("no_such_grid")


# ---- batched classes equal standalone runs --------------------------------

def test_stream_grid_cells_equal_standalone_runs():
    g = T.get_grid("grid_smoke_stream")
    res = tgrid.run_grid(g, n_reps=N, horizon=H, seed=SEED, keep_raw=True,
                         device="cpu")
    assert res["engine"] == "stream" and res["n_classes"] == 1
    assert res["classes"][0]["batched"] is True
    assert res["classes"][0]["compile_s"] is None
    assert res["classes"][0]["execute_s"] > 0
    for cell, (_, values, spec) in zip(res["cells"], g.cells()):
        one = T.run(spec, "stream", n_reps=N, horizon=H, seed=SEED,
                    device="cpu")
        _same(cell["raw"], one["raw"])
        assert cell["metrics"] == one["metrics"], values
    assert sum(int(c["raw"]["done"].sum()) for c in res["cells"]) > 10


def test_simfast_grid_cells_equal_standalone_runs():
    g = T.get_grid("grid_smoke_simfast")
    res = tgrid.run_grid(g, n_reps=N, seed=SEED, keep_raw=True,
                         device="cpu")
    assert res["engine"] == "simfast" and res["n_classes"] == 1
    for cell, (_, values, spec) in zip(res["cells"], g.cells()):
        one = T.run(spec, "simfast", n_reps=N, seed=SEED, device="cpu")
        _same(cell["raw"], one["raw"])
        assert cell["metrics"] == one["metrics"], values


def test_paper_stream_masked_cap_cell_equals_standalone_run():
    """``paper_stream``'s classes run at cap 5; a cell at cap 1 runs masked
    and is summarized under its own config."""
    g = T.get_grid("paper_stream")
    sub = T.GridSpec(base=g.base, name="t_cap", axes=(
        ("policy.straggler.enabled", (True,)),
        ("policy.redundancy.votes", (1, 5)),
        ("arrivals.rate", (0.012,))))
    res = tgrid.run_grid(sub, n_reps=N, horizon=40, keep_raw=True,
                         device="cpu")
    assert res["n_classes"] == 1
    for cell, (_, _, spec) in zip(res["cells"], sub.cells()):
        one = T.run(spec, n_reps=N, horizon=40, device="cpu")
        _same(cell["raw"], one["raw"])
        assert cell["metrics"] == one["metrics"]


# ---- against the reference, draws injected --------------------------------

def test_stream_grid_matches_reference_with_injected_draws(monkeypatch):
    jg, tg = J.get_grid("grid_smoke_stream"), T.get_grid("grid_smoke_stream")
    _, cells, _ = jgrid.partition_grid(jg)
    cfgs = [jstream(s) for _, _, s in cells]
    cls_cfg = dataclasses.replace(cfgs[0], policy=dataclasses.replace(
        cfgs[0].policy, votes_cap=max(c.policy.votes_cap for c in cfgs)))
    with jax.threefry_partitionable(False):
        want = jgrid.run_grid(jg, n_reps=N, horizon=H, seed=SEED,
                              shard=False, keep_raw=True)
        draws = [_ref_point_draws(
            cls_cfg, H, N, SEED, rate_abs=np.float32(c.arrivals.rate),
            pop=js.PopTraced(acc_a=jnp.float32(c.acc_a),
                             acc_b=jnp.float32(c.acc_b)))
            for c in cfgs]
    grid_run = tr.run_stream_grid
    monkeypatch.setattr(tr, "run_stream_grid", lambda *a, **kw: grid_run(
        *a, draws=draws, **kw))
    got = tgrid.run_grid(tg, n_reps=N, horizon=H, seed=SEED, keep_raw=True,
                         device="cpu")
    assert got["n_classes"] == want["n_classes"] == 1
    for g, w in zip(got["cells"], want["cells"]):
        assert (g["idx"], g["values"], g["class_id"]) == \
            (w["idx"], w["values"], w["class_id"])
        _assert_outputs_match(g["raw"], jax.tree_util.tree_map(
            np.asarray, dict(w["raw"])))
        _close_metrics(g["metrics"], w["metrics"])


def test_simfast_grid_matches_reference_with_injected_draws(monkeypatch):
    jg, tg = (J.get_grid("grid_smoke_simfast"),
              T.get_grid("grid_smoke_simfast"))
    _, cells, _ = jgrid.partition_grid(jg)
    cfgs = [jfast(s) for _, _, s in cells]
    labels = np.random.default_rng(3).integers(0, 2, cfgs[0].n_tasks)
    f32 = np.float32
    with jax.threefry_partitionable(False):
        want = jgrid.run_grid(jg, n_reps=N, seed=SEED, true_labels=labels,
                              shard=False, keep_raw=True)
        draws = [_ref_pop_draws(cfgs[0], N, SEED, js.PopTraced(
            median_mu=f32(c.median_mu), session_mean_s=f32(c.session_mean_s),
            recruit_mean_s=f32(c.recruit_mean_s),
            cold_recruit_mean_s=f32(c.cold_recruit_mean_s),
            acc_a=f32(c.acc_a), acc_b=f32(c.acc_b))) for c in cfgs]
    swept = ts.simulate_swept_pop
    monkeypatch.setattr(ts, "simulate_swept_pop", lambda *a, **kw: swept(
        *a, draws=draws, **kw))
    got = tgrid.run_grid(tg, n_reps=N, seed=SEED, true_labels=labels,
                         keep_raw=True, device="cpu")
    for g, w in zip(got["cells"], want["cells"]):
        assert g["values"] == w["values"]
        wr = {k: np.asarray(v) for k, v in w["raw"].items()}
        for k in ("done", "result", "n_evicted", "n_churned"):
            np.testing.assert_array_equal(g["raw"][k].numpy().astype(
                np.int64), wr[k].astype(np.int64), err_msg=k)
        for k in ("total_time", "latency", "cost", "accuracy"):
            np.testing.assert_allclose(g["raw"][k].numpy(), wr[k],
                                       rtol=1e-6, atol=1e-6 * float(
                                           wr["total_time"].max()),
                                       err_msg=k)
        _close_metrics(g["metrics"], w["metrics"])


def test_events_grid_runs_per_cell_equal_reference():
    axes = (("policy.straggler.enabled", (False, True)),)
    tg, jg = _grids(T.get_scenario("smallR1"), J.get_scenario("smallR1"),
                    axes, name="t_events")
    got = tgrid.run_grid(tg, "events", n_reps=2, seed=1, keep_raw=True,
                         device="cpu")
    want = jgrid.run_grid(jg, "events", n_reps=2, seed=1, keep_raw=True)
    assert got["engine"] == "events" and got["n_classes"] == 2
    assert [c["batched"] for c in got["classes"]] == [False, False]
    for g, w in zip(got["cells"], want["cells"]):
        assert g["metrics"] == w["metrics"]
        for a, b in zip(g["raw"], w["raw"]):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_sharded_stream_class_falls_back_per_cell_and_names_a13():
    """A device-sharded stream class is one class that runs per cell (the
    reference's fallback), each cell through the sharded ``run_stream`` on
    its two shard groups: every cell equals its standalone run, sharded or
    not, bit for bit."""
    g = T.GridSpec(base=T.get_scenario("stream_sharded",
                                       {"sharding.n_devices": 2}),
                   axes=(("arrivals.rate", (0.01, 0.02)),))
    _, cells, classes = tgrid.partition_grid(g)
    assert len(classes) == 1
    got = tgrid.run_grid(g, horizon=40, n_reps=2, seed=1, keep_raw=True,
                         device="cpu")
    assert [c["batched"] for c in got["classes"]] == [False]
    for cell, (_, _, spec) in zip(got["cells"], cells):
        alone = T.run(spec, horizon=40, n_reps=2, seed=1, device="cpu")
        one = T.run(T.override(spec, {"sharding.n_devices": 1}), horizon=40,
                    n_reps=2, seed=1, device="cpu")
        assert cell["metrics"] == alone["metrics"] == one["metrics"]
        _same(cell["raw"], one["raw"])


# ---- the artifact and the command line -----------------------------------

def test_grid_artifact_roundtrip(tmp_path):
    g = T.GridSpec(base=T.get_scenario("smallR1"), name="t_art",
                   axes=(("pool.acc_a", (5.0, 9.0)),))
    res = tgrid.run_grid(g, n_reps=2, device="cpu")
    path = write_grid(grid_doc(res), directory=str(tmp_path))
    assert path.endswith("GRID_t_art.jsonl")
    raw = [json.loads(ln) for ln in open(path)]
    assert [ln["compile_s"] for ln in raw if ln["kind"] == "class"] == [None]
    assert '"compile_s": null' in open(path).read()
    doc = read_grid(path)
    assert doc["header"]["artifact"] == "grid"
    assert doc["header"]["n_cells"] == 2
    assert len(doc["cell"]) == 2 and len(doc["class"]) == res["n_classes"]
    assert doc["class"][0]["compile_s"] is None
    assert doc["class"][0]["execute_s"] > 0
    assert doc["cell"][0]["metrics"]["n_reps"] == 2
    # the reference's reader takes the port's artifact
    from repro.obs.export import read_grid as jread
    assert jread(path)["cell"] == doc["cell"]


def test_cli_list_equals_reference(capsys):
    assert jmain(["--list"]) == 0
    want = capsys.readouterr().out
    assert tmain(["--list"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.count("\n") == 4


def test_cli_runs_a_grid_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "GRID_smoke.jsonl"
    assert tmain(["grid_smoke_simfast", "--n-reps", "2", "--device", "cpu",
                  "--no-shard", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "engine=simfast cells=6 classes=1" in text
    assert "compile=- " in text and "batched" in text
    doc = read_grid(str(out))
    assert len(doc["cell"]) == 6 and len(doc["class"]) == 1
