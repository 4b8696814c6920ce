"""Scenario×Policy grid engine: one batched run per static-config class.

Port of ``src/repro/grid/engine.py``. A :class:`~repro_torch.scenarios.
spec.GridSpec` names a base scenario and a set of dotted-axis value lists;
its cells are the full cartesian product. :func:`partition_grid` groups the
cells into *static-config equivalence classes*: a cell's traced axes (the
engine's ``TRACED_AXES`` — arrival rate, votes cap, pool accuracy and the
difficulty mixture for the stream engine; the pool-population axes for
simfast) are overridden back to the base value and the remainder is
lowered to the engine's hashable frozen config. Cells whose lowered
configs compare equal differ only in values the batched engines take per
cell, so :func:`run_grid` runs the whole class as ONE batched run on the
device (``run_stream_grid`` over a ``StreamTraced`` bundle, or
``simulate_swept_pop`` over a ``PopTraced`` bundle).

Each cell's outputs equal the standalone ``scenarios.run`` of that cell
bit for bit: the bundles carry each cell's absolute values, read as
float64 on the host as a standalone run reads its config. The scalar
events engine batches nothing and runs one run per cell; so does a
device-sharded stream class (``sharding.n_devices > 1``), each cell through
the sharded ``run_stream`` on its device groups, as in the reference.

The port compiles nothing: a class records only its ``execute`` time, and
its ``compile_s`` is None.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.obs import timing
from repro_torch.scenarios.compile import TRACED_AXES, compile_for
from repro_torch.scenarios.facade import _resolve_engine, _slice_point
from repro_torch.scenarios.facade import run as _run_cell
from repro_torch.scenarios.spec import GridSpec, _get_path, override


@dataclasses.dataclass(frozen=True)
class GridClass:
    """One static-config equivalence class of grid cells."""
    class_id: int
    cells: tuple          # flat cell indices, grid order
    specs: tuple          # compiled-from ScenarioSpec per cell


def partition_grid(grid: GridSpec, engine: str = None, *,
                   horizon: int = None, seed: int = 0):
    """Partition ``grid`` cells into static-config equivalence classes.

    Returns ``(engine, cells, classes)`` where ``cells`` is
    ``grid.cells()`` and ``classes`` a list of :class:`GridClass` in
    first-seen order. Two cells share a class iff, after overriding the
    engine's traced axes back to the base scenario's values, they lower
    to equal (hash-equal) engine configs and run at the same horizon.
    A cell whose traced-axis reset fails spec validation (e.g. a swept
    ``min_votes`` above the base votes cap) becomes its own class rather
    than an error.
    """
    if not isinstance(grid, GridSpec):
        raise TypeError(f"partition_grid takes a GridSpec, got "
                        f"{type(grid).__name__}")
    engine = _resolve_engine(grid.base, engine)
    traced = TRACED_AXES[engine]
    base_vals = {p: _get_path(grid.base, p) for p in traced}
    cells = grid.cells()
    by_key: dict = {}
    order: list = []
    for flat, (idx, values, spec) in enumerate(cells):
        resets = {p: base_vals[p] for p in traced if p in values}
        try:
            key_spec = override(spec, resets) if resets else spec
            key_cfg = compile_for(key_spec, engine, seed=seed)
            try:
                hash(key_cfg)
            except TypeError:
                # the events engine's CSConfig is mutable (unhashable): key
                # on the frozen spec, which lowers deterministically
                key_cfg = key_spec
            key = (key_cfg,
                   horizon if horizon is not None else spec.horizon)
        except ValueError:
            key = ("cell", flat)
        if key not in by_key:
            by_key[key] = dict(cells=[], specs=[])
            order.append(key)
        by_key[key]["cells"].append(flat)
        by_key[key]["specs"].append(spec)
    return engine, cells, [
        GridClass(class_id=j, cells=tuple(by_key[k]["cells"]),
                  specs=tuple(by_key[k]["specs"]))
        for j, k in enumerate(order)
    ]


def _f64(xs):
    # per-cell values as float64, as a standalone run reads its config
    return np.asarray(xs, np.float64)


def _last(entries: dict, name: str):
    xs = entries.get(name)
    return float(xs[-1]) if xs else None


def _run_class_stream(cls, name, *, horizon, n_reps, seed, warmup_frac,
                      device):
    """Run one stream-engine class as one batched grid run. Returns
    ``(cell_cfgs, raw)`` — ``raw`` stacked over the class's cells in class
    order — or ``None`` when the class runs per cell (a device-sharded
    tick: ``run_stream_grid`` spends its batch on cells, not on device
    groups)."""
    from repro_torch.labelstream.router import StreamTraced, run_stream_grid
    from repro_torch.scenarios.compile import to_stream_config

    cfgs = [to_stream_config(s) for s in cls.specs]
    cls_cfg = cfgs[0]
    if cls_cfg.sharding.n_devices > 1:
        return None
    # the class run's buffers are sized at the largest cap in the class;
    # each cell's own (smaller or equal) cap runs masked
    cap = max(c.policy.votes_cap for c in cfgs)
    if cap != cls_cfg.policy.votes_cap:
        cls_cfg = dataclasses.replace(
            cls_cfg,
            policy=dataclasses.replace(cls_cfg.policy, votes_cap=cap))
    tr = StreamTraced(
        rate=_f64([c.arrivals.rate for c in cfgs]),
        votes_cap=np.asarray([c.policy.votes_cap for c in cfgs], np.int64),
        acc_a=_f64([c.acc_a for c in cfgs]),
        acc_b=_f64([c.acc_b for c in cfgs]),
        p_hard=_f64([c.p_hard for c in cfgs]),
        hard_scale=_f64([c.hard_scale for c in cfgs]),
    )
    raw = run_stream_grid(cls_cfg, horizon, tr, n_reps=n_reps, seed=seed,
                          warmup_frac=warmup_frac, timing_name=name,
                          device=device)
    return cfgs, raw


def _run_class_simfast(cls, name, *, n_reps, seed, true_labels, shard,
                       device, devices):
    """Run one simfast-engine class as one batched population-bundle run.
    Returns ``(cell_cfgs, raw)``."""
    from repro_torch.core.simfast import PopTraced, simulate_swept_pop
    from repro_torch.scenarios.compile import to_fast_config

    cfgs = [to_fast_config(s) for s in cls.specs]
    pop = PopTraced(
        median_mu=_f64([c.median_mu for c in cfgs]),
        session_mean_s=_f64([c.session_mean_s for c in cfgs]),
        recruit_mean_s=_f64([c.recruit_mean_s for c in cfgs]),
        cold_recruit_mean_s=_f64([c.cold_recruit_mean_s for c in cfgs]),
        acc_a=_f64([c.acc_a for c in cfgs]),
        acc_b=_f64([c.acc_b for c in cfgs]),
    )
    raw = simulate_swept_pop(cfgs[0], n_reps, pop, seed=seed,
                             true_labels=true_labels, shard=shard,
                             timing_name=name, device=device,
                             devices=devices)
    return cfgs, raw


def _summary(engine: str, cfg, point) -> dict:
    """A batched cell's metrics, as its standalone ``scenarios.run``
    reports them."""
    if engine == "stream":
        from repro_torch.labelstream.router import stream_summary
        return stream_summary(cfg, point)
    from repro_torch.core.simfast_stats import summarize
    return dataclasses.asdict(summarize(point))


def run_grid(grid: GridSpec, engine: str = None, *, seed: int = 0,
             n_reps: int = 1, horizon: int = None,
             warmup_frac: float = 0.3, true_labels=None, shard: bool = True,
             keep_raw: bool = False, device="cuda", devices=None) -> dict:
    """Execute every cell of ``grid`` on ``device``, one batched run per
    static-config equivalence class (one run per cell on the events
    engine).

    Returns a dict with ``name``/``engine``/``axes``/``n_cells``/
    ``n_classes``, per-cell records (``idx``, ``values``, ``class_id``,
    ``metrics`` — the engine's summary for that cell, equal to a
    standalone ``scenarios.run``), per-class records (``cells``,
    ``batched``, ``execute_s`` from :mod:`repro_torch.obs.timing`, and
    ``compile_s`` None: the port compiles nothing) and total
    ``wallclock_s``. ``keep_raw`` also attaches each cell's raw engine
    output (its slice of the class batch) under ``cells[i]["raw"]``.
    ``shard`` splits a simfast class's cells across several devices
    (``devices``, else every card; see ``simulate_swept_pop``); a
    device-sharded stream class runs each cell on its shard groups, on
    ``devices`` if given (see
    :func:`~repro_torch.launch.mesh.make_stream_mesh`).
    """
    t0 = time.perf_counter()
    engine, cells, classes = partition_grid(grid, engine, horizon=horizon,
                                            seed=seed)
    gname = grid.name or "grid"
    cell_metrics = [None] * len(cells)
    cell_raw = [None] * len(cells)
    cls_of = {flat: c.class_id for c in classes for flat in c.cells}
    class_records = []
    for cls in classes:
        name = f"grid[{gname}].class{cls.class_id}"
        hz = horizon if horizon is not None else cls.specs[0].horizon
        batched = None
        if engine == "stream":
            batched = _run_class_stream(
                cls, name, horizon=hz, n_reps=n_reps, seed=seed,
                warmup_frac=warmup_frac, device=device)
        elif engine == "simfast":
            batched = _run_class_simfast(
                cls, name, n_reps=n_reps, seed=seed,
                true_labels=true_labels, shard=shard, device=device,
                devices=devices)
        if batched is not None:
            cfgs, raw = batched
            for j, flat in enumerate(cls.cells):
                point = _slice_point(raw, j)
                # summarize under the CELL's own config (its cap, its
                # rate), not the class run's maxed-cap config
                cell_metrics[flat] = _summary(engine, cfgs[j], point)
                if keep_raw:
                    cell_raw[flat] = point
        else:
            # per cell: the scalar events engine, or a device-sharded
            # stream tick
            t1 = time.perf_counter()
            for j, flat in enumerate(cls.cells):
                res = _run_cell(cls.specs[j], engine, seed=seed,
                                n_reps=n_reps, horizon=horizon,
                                warmup_frac=warmup_frac,
                                true_labels=true_labels, device=device,
                                devices=devices)
                cell_metrics[flat] = res["metrics"]
                if keep_raw:
                    cell_raw[flat] = res["raw"]
            timing.record(name + ".execute", time.perf_counter() - t1)
        class_records.append(dict(
            class_id=cls.class_id, n_cells=len(cls.cells),
            cells=list(cls.cells), batched=batched is not None,
            compile_s=None,
            execute_s=_last(timing.entries(), name + ".execute"),
        ))
    cell_records = []
    for flat, (idx, values, _spec) in enumerate(cells):
        rec = dict(idx=list(idx), values=dict(values),
                   class_id=cls_of[flat], metrics=cell_metrics[flat])
        if keep_raw:
            rec["raw"] = cell_raw[flat]
        cell_records.append(rec)
    return dict(
        name=gname, engine=engine,
        axes=[(p, list(vs)) for p, vs in grid.axes],
        n_cells=len(cells), n_classes=len(classes),
        cells=cell_records, classes=class_records,
        wallclock_s=time.perf_counter() - t0,
    )
