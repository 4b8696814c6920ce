"""Registry smoke: run every named scenario a tick or two on every engine
the port runs (port of ``src/repro/scenarios/smoke.py``).

    PYTHONPATH=src python -m repro_torch.scenarios.smoke [--device cpu]

Each scenario is shrunk (few tasks, two stream ticks, one replication): the
point is "does every (scenario, engine) pair still compile and produce
finite metrics", not performance. Pairs the port cannot run yet print as
``[TODO]`` with the ROADMAP item that ports them and are counted apart;
any other failure makes the exit code nonzero.
"""
from __future__ import annotations

import argparse
import math
import sys
import time

from repro_torch.scenarios.compile import engines
from repro_torch.scenarios.facade import run
from repro_torch.scenarios.registry import get_scenario, list_scenarios
from repro_torch.scenarios.spec import override


def shrink(spec):
    """A tiny but structurally identical copy of ``spec`` for smoke runs."""
    small = {"n_tasks": min(spec.n_tasks, 4), "horizon": 2}
    if spec.batch_size is not None:
        small["batch_size"] = min(spec.batch_size, 4)
    # a couple of simulated minutes bounds a batch run
    small["engine.max_batch_time"] = min(spec.engine.max_batch_time, 1800.0)
    return override(spec, small)


def unported(spec, engine: str):
    """The ROADMAP item that ports ``(spec, engine)``, or None if the port
    runs it."""
    if engine == "events":
        return "A9"
    if engine == "stream" and spec.features.kind == "lm":
        return "A12b"
    return None


def main(argv=None, device="cuda") -> int:
    """Run the smoke on ``device`` (``--device`` on the command line);
    returns the exit code. Prints one line per pair and a summary."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    t0 = time.time()
    failures, todo, n_ok = [], [], 0
    for name in list_scenarios():
        spec = get_scenario(name)
        compat = engines(spec)
        if not compat:
            failures.append(f"{name}: no compatible engine")
            print(f"[FAIL] {name}: no compatible engine")
            continue
        for engine in compat:
            item = unported(spec, engine)
            if item is not None:
                todo.append(f"{name}/{engine} ({item})")
                print(f"[TODO] {name:28s} {engine:8s} not ported yet "
                      f"(ROADMAP {item})")
                continue
            try:
                res = run(shrink(spec), engine, n_reps=1, seed=0,
                          device=args.device)
                m = res["metrics"]
                # inf is a documented sentinel (the time-in-system
                # percentiles report inf when nothing finalized in a
                # 2-tick run); NaN is never legitimate
                bad = [k for k, v in m.items()
                       if isinstance(v, float) and math.isnan(v)]
                if bad:
                    raise ValueError(f"NaN metrics: {bad}")
                head = {k: m[k] for k in list(m)[:3]}
                n_ok += 1
                print(f"[ ok ] {name:28s} {engine:8s} {head}")
            except Exception as e:  # noqa: BLE001 — report, don't abort
                failures.append(f"{name}/{engine}: {type(e).__name__}: {e}")
                print(f"[FAIL] {name:28s} {engine:8s} {e}")
    print(f"# {len(list_scenarios())} scenarios on {args.device}: {n_ok} "
          f"ok, {len(todo)} not ported yet, {len(failures)} failure(s), "
          f"{time.time() - t0:.1f}s")
    for f in failures:
        print(f"  - {f}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
