"""The port's stream on its own draws against the JAX package's, in
distribution: ``stream_summary`` of a long run agrees within the
reference's own seed-to-seed spread (the tick-for-tick parity with
injected draws is in ``tests/test_torch_stream.py``). Reference calls run
inside ``jax.threefry_partitionable(False)``.
"""
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.labelstream import router as jr  # noqa: E402
from repro.scenarios import get_scenario  # noqa: E402
from repro.scenarios.compile import to_stream_config  # noqa: E402
from repro_torch.labelstream import router as tr  # noqa: E402
from repro_torch.scenarios import get_stream_config  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the tick is hundreds of tiny ops: threads only add overhead, and the
    # suite runs several workers at once
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Seed-to-seed spread of the reference's stream_summary on stream_default
# at 1000 ticks x 16 replications, measured over seeds 0-19 on the CPU
# (standard deviations): offered_rate 0.0004, sustained_rate 0.0004,
# completion_ratio 0.0, mean_tis 10.0 s, p50_tis 8.2 s, p95_tis 43.6 s,
# accuracy 0.0064, votes_per_task 0.026, completions_per_task 0.024,
# cost 0.71. Two independent runs differ with sd sqrt(2) x that, so each
# metric is held to 4 sqrt(2) sd of the reference.
SPREAD = dict(offered_rate=0.0004, sustained_rate=0.0004,
              completion_ratio=0.005, mean_tis=10.0, p50_tis=8.2,
              p95_tis=43.6, accuracy=0.0064, votes_per_task=0.026,
              completions_per_task=0.024, cost=0.71)


def test_stream_summary_agrees_without_injection():
    """Without injection the port draws from its own generators (numpy for
    the banks, torch for arrivals), so it agrees with the reference only in
    distribution; see SPREAD for the tolerances and where they come from."""
    cfg = get_stream_config("stream_default")
    ref_cfg = to_stream_config(get_scenario("stream_default"))
    with jax.threefry_partitionable(False):
        want = jr.stream_summary(
            ref_cfg, jr.run_stream(ref_cfg, 1000, n_reps=16, seed=0))
    got = tr.stream_summary(cfg, tr.run_stream(cfg, 1000, n_reps=16, seed=0,
                                               device="cpu"))
    for k, sd in SPREAD.items():
        assert abs(got[k] - want[k]) <= 4 * math.sqrt(2) * sd, \
            (k, got[k], want[k])
    assert got["dropped"] == want["dropped"] == 0.0
    assert not got["hist_saturated"]
