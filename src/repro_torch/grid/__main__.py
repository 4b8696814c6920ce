"""CLI: run a registered grid and write its GRID_<name>.jsonl artifact.

    PYTHONPATH=src python -m repro_torch.grid paper_stream --n-reps 2
    PYTHONPATH=src python -m repro_torch.grid --list

It runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.grid",
        description="Run a registered Scenario×Policy grid with one "
                    "batched run per static-config class and write the "
                    "GRID_<name>.jsonl artifact.")
    ap.add_argument("grid", nargs="?", help="registered grid name "
                                            "(repro_torch.scenarios."
                                            "list_grids)")
    ap.add_argument("--list", action="store_true",
                    help="list registered grids and exit")
    ap.add_argument("--engine", default=None,
                    help="events | simfast | stream (default: the base "
                         "scenario's preferred engine)")
    ap.add_argument("--n-reps", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--horizon", type=int, default=None,
                    help="stream horizon in ticks (default: the base "
                         "scenario's horizon)")
    ap.add_argument("--warmup-frac", type=float, default=0.3)
    ap.add_argument("--no-shard", action="store_true",
                    help="accepted for the reference's command line; a "
                         "class always runs on one device")
    ap.add_argument("--out", default=None, help="output path override")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = ap.parse_args(argv)

    from repro_torch.scenarios import get_grid, list_grids

    if args.list or args.grid is None:
        for name in list_grids():
            g = get_grid(name)
            axes = " x ".join(f"{p}[{len(vs)}]" for p, vs in g.axes)
            print(f"{name}: {g.n_cells} cells = {axes} "
                  f"(base {g.base.name or '<anonymous>'})")
        return 0

    from repro_torch.grid import run_grid
    from repro_torch.obs.export import grid_doc, write_grid

    res = run_grid(get_grid(args.grid), args.engine, seed=args.seed,
                   n_reps=args.n_reps, horizon=args.horizon,
                   warmup_frac=args.warmup_frac, shard=not args.no_shard,
                   device=args.device)
    path = write_grid(grid_doc(res), path=args.out)
    print(f"# engine={res['engine']} cells={res['n_cells']} "
          f"classes={res['n_classes']} wallclock={res['wallclock_s']:.1f}s")
    for c in res["classes"]:
        comp = "-" if c["compile_s"] is None else f"{c['compile_s']:.2f}s"
        print(f"#   class {c['class_id']}: {c['n_cells']} cells "
              f"compile={comp} execute={c['execute_s']:.2f}s "
              f"{'batched' if c['batched'] else 'per-cell'}")
    print(f"# wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
