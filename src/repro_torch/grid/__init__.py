"""Batched Scenario×Policy grid runs, one batched run per static-config
class (port of ``src/repro/grid``).

    from repro_torch import grid, scenarios
    res = grid.run_grid(scenarios.get_grid("paper_stream"), n_reps=2)
    res["n_classes"]   # batched runs made, vs res["n_cells"] cells run

``python -m repro_torch.grid <grid-name>`` runs a registered grid and
writes its ``GRID_<name>.jsonl`` artifact.
"""
from repro_torch.grid.engine import GridClass, partition_grid, run_grid

__all__ = ["GridClass", "partition_grid", "run_grid"]
