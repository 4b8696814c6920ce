"""The harness finds configurations, cells and metrics by file name alone,
and ``BENCHMARK.json`` keeps to the benchmark's contract."""
import json
import re
import shutil

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def test_every_cell_finds_its_files_by_name(bench):
    for cell in bench["workloads"]:
        c, conf, trf = harness.cell_files(bench, cell["name"])
        assert conf["name"] == cell["config"]
        driver = harness.driver_of(trf)
        for hook in ("setup", "window", "check", "control"):
            assert callable(getattr(driver, hook))
        assert set(conf["limits"]) >= {"int_mismatch", "float_gap"} or \
            "feat_gap" in conf["limits"]


def test_every_metric_has_a_reader_file(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert callable(harness.reader(m["name"]))


def test_each_cell_reports_set_up_another_end_to_end_and_a_layer(bench):
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(bench, cell["name"],
                                                     False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.metrics_of(bench, cell["name"], True)
        assert layer
        for m in layer:                       # it moves what the cell reports
            assert m["moves"] in e2e


def test_a_new_metric_file_and_entry_are_found_without_an_edit(
        bench, tmp_path, monkeypatch):
    root = tmp_path / "perfbench"
    shutil.copytree(harness.BENCH / "metrics", root / "metrics")
    (root / "metrics" / "calls_made.py").write_text(
        "def read(run):\n    return len(run['calls'])\n")
    added = dict(bench, per_layer=bench["per_layer"] + [
        {"name": "calls_made", "unit": "calls", "better": "higher",
         "source": "host_clock", "layer": "device", "moves": "setup_s"}])
    monkeypatch.setattr(harness, "BENCH", root)
    names = [m["name"] for m in harness.metrics_of(
        added, "learner_stream.sweep", True)]
    assert "calls_made" in names
    got = harness.read_metrics(
        [m for m in added["per_layer"] if m["name"] == "calls_made"],
        {"calls": [{}, {}]})
    assert got == {"calls_made": {"value": 2.0, "unit": "calls"}}


def test_benchmark_json_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in bench[k]}) == len(bench[k])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in metrics)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
    pairs = [(c["config"], c["traffic"]) for c in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/")
        assert (harness.ROOT / c["file"]).is_file()
    assert all(c["chips"] in (1, 4) for c in bench["workloads"])
    assert len(json.dumps(bench)) < 64 * 1024
