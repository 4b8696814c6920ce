"""One short run of each cell on the card, through the benchmark's command
(``python3 perfbench/run.py ...``): exit 0, a result line whose
``correct`` is true, the card named. Skips without a card."""
import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in
                                  harness.benchmark()["workloads"]])
def test_a_short_run_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "2147483901", "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "learner_stream.sweep", "--seed", "1", "--seconds", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
