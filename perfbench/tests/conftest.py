"""Small versions of the benchmark's cells for the CPU: the same files and
drivers, with the traffic cut to a few rates, replications and ticks and
the LM configuration on the program's reduced encoder."""
import dataclasses
import json
import sys
import time

import pytest

from perfbench import harness

# the program under test, as ``perfbench/run.py`` finds it
if str(harness.ROOT / "src") not in sys.path:
    sys.path.insert(0, str(harness.ROOT / "src"))


def small(cell_name: str):
    """``(config, traffic)`` of ``cell_name`` cut to a CPU test's size."""
    bench = harness.benchmark()
    _, conf, trf = harness.cell_files(bench, cell_name)
    if "encoder" in conf:
        from repro_torch.embed.encoder import resolved_config
        from repro_torch.scenarios import get_scenario
        from repro_torch.scenarios.compile import to_stream_config
        ov = dict(conf["overrides"], **{
            "embed.reduced": True, "embed.seq_len": 16,
            "embed.bank_size": 64, "embed.batch_size": 8})
        cfg = to_stream_config(get_scenario(conf["scenario"], ov))
        m = resolved_config(cfg.learner.embed)
        enc = {k: getattr(m, k) for k in conf["encoder"]}
        enc["block_pattern"] = list(enc["block_pattern"])
        conf = dict(conf, overrides=ov, encoder=enc, stream_config=json.loads(
            json.dumps(dataclasses.asdict(cfg))))
    if trf["driver"] == "encode_requests":
        trf = dict(trf, texts_per_request=dict(lo=5, hi=20, block=4),
                   text_len=dict(lo=4, hi=16), check=dict(requests=2))
    else:
        trf = dict(trf, rates=dict(n=4, lo_x=4.0, hi_x=16.0), n_reps=4,
                   horizon=81, warmup_horizon=41)
    return conf, trf


def run_small(cell_name: str, seed: int = 12345, seconds: float = 0.5,
              trace: bool = False, control: bool = False):
    conf, trf = small(cell_name)
    return harness.execute(cell_name, seed, seconds, trace, "cpu",
                           time.perf_counter(), config=conf, traffic=trf,
                           control=control)


@pytest.fixture
def cpu_run():
    return run_small
