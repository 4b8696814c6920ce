"""Run one cell of the benchmark once on the card and print its result:

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number the
correctness check compared, beside its limit). Without a CUDA card it
exits with code 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root and the program's sources, never this folder alone
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "perfbench"]
# a library that would load JAX by itself must not
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
