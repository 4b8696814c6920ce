"""The readings a cell's correctness limits are set from, on the card:

    python3 perfbench/readings.py --workload NAME --seeds 1,2,3 [--seconds S]

For each seed, one run of the cell with a short window (the harness's own
set-up, window and check) and the control: the reference one precision
down put in the program's place and compared as the program is. Prints
one JSON line a seed with the program's numbers and the control's. The
benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "perfbench"]

from perfbench import harness  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: no readings", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.execute(args.workload, seed, args.seconds, False,
                              "cuda", t0, control=not args.no_control)
        res = run["result"]
        print(json.dumps({
            "seed": seed, "correct": res["correct"],
            "calls": res["attempted"],
            "program": {k: c["value"] for k, c in res["checks"].items()},
            "control": run.get("control"),
            "diag": run.get("diag"), "diag_control": run.get("diag_control"),
            "metrics": {k: m["value"] for k, m in res["metrics"].items()},
            "peak_bytes": res["device"]["memory_peak_bytes"],
            "seconds": time.perf_counter() - t0}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
