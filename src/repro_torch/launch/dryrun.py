"""The dry-run over the production layouts (port of
``src/repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

For every (architecture x shape) cell on the reference's production
meshes (16 x 16, 2 x 16 x 16, or ``--mesh-shape`` such as ``128x2``) it
builds the cell's step with the reference's arguments, resolves and
sanitizes the specs of its state, inputs and cache against the abstract
arguments (``meta`` tensors from :mod:`repro_torch.launch.specs`), and
writes one JSON record per cell: the step's microbatches and cache
layout, the chips, the parameters, the model FLOPs, and the bytes one
device holds of the step's arguments under those specs.

It runs on the host only. The layouts are
:class:`~repro_torch.launch.mesh.MeshLayout` shapes with no devices, and
no step runs on them: the port has no compiler to lower a step for 256
chips, so "ok" means the step was built and every spec resolved and
sanitized. Left out, because they read XLA's compiled program: the
reference's per-device FLOPs, HBM and collective bytes, the top
collectives, the roofline and its dominant term, XLA's cost analysis,
the useful-FLOPs ratio, lower / compile seconds, and the output / temp /
alias / peak memory; ``--save-hlo`` is refused (there is no HLO).

:func:`build_cell` on a real mesh (``make_local_mesh``) returns a step
that runs: :meth:`CellStep.place` lays concrete arguments out as its
``in_specs`` say, in the form the port's mesh steps take them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, cell_supported, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import LMMesh, layout_of, production_layout
from repro_torch.launch.specs import (
    abstract_model, abstract_train_state, input_specs,
)
from repro_torch.models.model import _init_cache, model_template
from repro_torch.models.params import (
    count_params, leaves, tree_map, with_leaves,
)
from repro_torch.models.stepfn import (
    make_decode_step, make_prefill_step, make_train_step,
)
from repro_torch.training.optimizer import AdamW

NO_HLO = ("--save-hlo: the port lowers no XLA program, so there is no HLO "
          "to save")


def _data_parallel(mesh) -> int:
    """The data-parallel ways: the product of the batch axes' sizes."""
    return math.prod(mesh.shape[a] for a in sh.batch_axes(mesh))


def pick_microbatches(cfg, shape, mesh):
    """Bound per-device microbatch activations to ~8k tokens."""
    dp = _data_parallel(mesh)
    B, S = shape.global_batch, shape.seq_len
    per_dev_tokens = B * S // dp
    mb = max(1, per_dev_tokens // 8192)
    while B % mb or (B // mb) % dp:
        mb -= 1
    return max(mb, 1)


@dataclasses.dataclass(frozen=True)
class CellStep:
    """A cell's step with the layout of its arguments and results:
    ``in_specs`` / ``out_specs`` are the sanitized :class:`P` trees the
    reference hands ``jax.jit`` as its shardings (None where it leaves the
    layout to the compiler). Called, it runs the step; only a real
    :class:`~repro_torch.launch.mesh.LMMesh` has devices to run it on."""
    kind: str
    fn: object
    in_specs: tuple
    out_specs: tuple
    mesh: object

    def __call__(self, *args):
        if not isinstance(self.mesh, LMMesh):
            raise RuntimeError(
                f"a {type(self.mesh).__name__} has no devices: the step "
                "built on it does not run (build the cell on "
                "make_local_mesh to run it)")
        return self.fn(*args)

    def place(self, *args):
        """Concrete arguments (whole tensors) laid out as ``in_specs`` say,
        in the form the port's mesh steps take them: parameters and
        moments as Sharded leaves by their specs, the replicated counters
        whole on the lead slot, the batch whole on the lead slot (the
        forward splits its rows over ``data``), and a decode cache as the
        data groups' caches, each group's rows on its lead slot."""
        mesh = self.mesh
        lead = lambda t: t.to(mesh.lead)
        put = lambda tree, specs: sh.put(tree, specs, mesh)
        batch = lambda b: tree_map(lead, b, is_leaf=torch.is_tensor)
        if self.kind == "train":
            state, b = args
            sps = self.in_specs[0]
            return ({"params": put(state["params"], sps["params"]),
                     "opt_state": {
                         "mu": put(state["opt_state"]["mu"],
                                   sps["opt_state"]["mu"]),
                         "nu": put(state["opt_state"]["nu"],
                                   sps["opt_state"]["nu"]),
                         "count": lead(state["opt_state"]["count"])},
                     "step": lead(state["step"])}, batch(b))
        params = put(args[0], self.in_specs[0])
        if self.kind == "prefill":
            return params, batch(args[1])
        cache, tokens, positions = args[1:]
        nd = mesh.shape["data"]
        rows = tokens.shape[0] // nd
        xs = leaves(cache, torch.is_tensor)
        dims = [_data_dim(s) for s in leaves(self.in_specs[1], sh.is_spec)]
        groups = [with_leaves(cache, [
            x.narrow(d, i * rows, rows).to(mesh.devices[i][0])
            for x, d in zip(xs, dims)]) for i in range(nd)]
        return params, groups, lead(tokens), lead(positions)


def _data_dim(spec) -> int:
    """The dimension a cache spec splits over ``data`` (its batch)."""
    for k, m in enumerate(spec):
        if m is not None and "data" in (m if isinstance(m, tuple) else (m,)):
            return k
    raise ValueError(f"the cache spec {spec} does not split over data: the "
                     "mesh's decode step takes the data groups' caches")


def argument_bytes(args, in_specs, mesh) -> int:
    """The bytes one device holds of ``args`` laid out by ``in_specs``: per
    leaf its shard's elements (the leaf's over the product of the mesh
    axes its spec names) times its itemsize. A replicated leaf counts
    whole on every device, as XLA's argument size counts it."""
    xs = leaves(args, torch.is_tensor)
    ss = leaves(in_specs, sh.is_spec)
    if len(xs) != len(ss):
        raise ValueError(f"argument_bytes: {len(ss)} specs for {len(xs)} "
                         "leaves")
    total = 0
    for x, s in zip(xs, ss):
        split = math.prod(sh._axis_size(mesh, m) for m in s if m is not None)
        total += x.numel() // split * x.element_size()
    return total


def build_cell(cfg, shape, mesh, *, attn_impl="auto", kv_shard="kv_heads",
               microbatches=None, opt=()):
    """Returns ``(step, args, extra)``: the cell's :class:`CellStep`, its
    abstract arguments (``meta`` tensors) and ``{"microbatches"
    (train), "kv_shard"}``. ``mesh`` is a
    :class:`~repro_torch.launch.mesh.MeshLayout` or a real
    :class:`~repro_torch.launch.mesh.LMMesh`."""
    template = model_template(cfg)
    pspecs = sh.param_pspecs(template, mesh)
    cons = sh.make_constrain(mesh)
    in_ps = sh.input_pspecs(cfg, shape.kind, mesh)
    dp = _data_parallel(mesh)

    if kv_shard == "auto":
        # KV heads rarely divide a 16-way model axis; fall back to
        # sequence-sharded caches when they don't.
        ms = mesh.shape["model"]
        kv_shard = "kv_heads" if cfg.n_kv_heads % ms == 0 else "seq"

    if shape.kind == "train":
        mb = microbatches or pick_microbatches(cfg, shape, mesh)
        optimizer = AdamW(lr=3e-4)
        fn = make_train_step(cfg, optimizer, microbatches=mb, remat=True,
                             attn_impl=attn_impl, constrain=cons,
                             moe_groups=dp, mesh=mesh, opt=opt)
        state = abstract_train_state(cfg)
        state_ps = {
            "params": pspecs,
            "opt_state": {"mu": pspecs, "nu": pspecs, "count": P()},
            "step": P(),
        }
        batch = input_specs(cfg, shape)
        state_ps = sh.sanitize(state_ps, state, mesh)
        in_ps = sh.sanitize(in_ps, batch, mesh)
        step = CellStep("train", fn, (state_ps, in_ps), (state_ps, None),
                        mesh)
        return step, (state, batch), {"microbatches": mb,
                                      "kv_shard": kv_shard}

    params = abstract_model(cfg)
    pspecs = sh.sanitize(pspecs, params, mesh)
    if shape.kind == "prefill":
        fn = make_prefill_step(cfg, attn_impl=attn_impl, constrain=cons,
                               moe_groups=dp, mesh=mesh, opt=opt)
        batch = input_specs(cfg, shape)
        in_ps = sh.sanitize(in_ps, batch, mesh)
        # the cache the prefill returns, from the allocator it uses
        cache_abs = _init_cache(cfg, shape.global_batch, shape.seq_len,
                                torch.bfloat16, torch.device("meta"))
        cache_ps = sh.sanitize(sh.cache_pspecs(cfg, mesh, kv_shard),
                               cache_abs, mesh)
        step = CellStep("prefill", fn, (pspecs, in_ps), (None, cache_ps),
                        mesh)
        return step, (params, batch), {"kv_shard": kv_shard}

    # decode
    fn = make_decode_step(cfg, constrain=cons, opt=opt, mesh=mesh)
    spec = input_specs(cfg, shape)
    cache_ps = sh.sanitize(sh.cache_pspecs(cfg, mesh, kv_shard),
                           spec["cache"], mesh)
    ba = sh.batch_axes(mesh)
    tok_ps, pos_ps = sh.sanitize(
        (P(ba, None), P(ba)), (spec["tokens"], spec["positions"]), mesh)
    step = CellStep("decode", fn, (pspecs, cache_ps, tok_ps, pos_ps),
                    (None, cache_ps), mesh)
    return step, (params, spec["cache"], spec["tokens"],
                  spec["positions"]), {"kv_shard": kv_shard}


def run_cell(arch, shape_name, mesh_kind, *, outdir=None, attn_impl="auto",
             kv_shard="auto", microbatches=None, tag="baseline",
             save_hlo=False, opt=(), mesh_shape=None):
    """The record of one cell (see the module docstring), written to
    ``{outdir}/{arch}_{shape}_{mesh}_{tag}.json`` when ``outdir`` is
    given: ``skipped`` with ``cell_supported``'s reason, ``error`` with
    the traceback's last 2000 characters, or ``ok``."""
    if save_hlo:
        raise ValueError(NO_HLO)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "attn_impl": attn_impl, "kv_shard": kv_shard, "opt": list(opt),
    }
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    if mesh_shape:  # re-layout the same chips, e.g. "128x2"
        mesh = layout_of(mesh_shape)
        rec["mesh_shape"] = mesh_shape
    else:
        mesh = production_layout(multi_pod=(mesh_kind == "multi"))
    try:
        step, args, extra = build_cell(
            cfg, shape, mesh, attn_impl=attn_impl, kv_shard=kv_shard,
            microbatches=microbatches, opt=opt)
        rec.update(extra)
        tokens = (shape.global_batch * shape.seq_len
                  if shape.kind != "decode" else shape.global_batch)
        mult = 3.0 if shape.kind == "train" else 1.0  # fwd+bwd vs fwd
        rec.update(
            status="ok",
            n_chips=mesh.size,
            n_params=count_params(model_template(cfg)),
            memory={"argument_bytes": argument_bytes(args, step.in_specs,
                                                     mesh)},
            model_flops_total=2.0 * mult * _active_params(cfg) * tokens,
        )
    except Exception as e:  # record the failure; dry-run failures are bugs
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir,
                            f"{arch}_{shape_name}_{mesh_kind}_{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=float)
    return rec


def _active_params(cfg):
    """Active (per-token) params from the real template, embeddings excluded
    from the 6ND convention's N only for the unembed projection cost."""
    n_total = count_params(model_template(cfg))
    if cfg.n_experts and cfg.moe_top_k:
        moe_blocks = sum(1 for b in cfg.blocks() if b == "moe")
        per_expert = (2 if not cfg.mlp_gated else 3) * cfg.d_model * cfg.d_ff
        inactive = moe_blocks * (cfg.n_experts - cfg.moe_top_k) * per_expert
        return n_total - inactive
    return n_total


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="The port's dry-run over the production layouts "
                    "(host only; no step runs).")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--attn-impl", default="auto")
    ap.add_argument("--kv-shard", default="auto")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--opt", default="", help="comma-separated opt flags")
    ap.add_argument("--mesh-shape", default=None,
                    help="override mesh layout, e.g. 128x2 (same chip count)")
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: the port has no HLO")
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error(NO_HLO)

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                rec = run_cell(
                    arch, shape, mk, outdir=args.out,
                    attn_impl=args.attn_impl, kv_shard=args.kv_shard,
                    microbatches=args.microbatches, tag=args.tag,
                    opt=tuple(f for f in args.opt.split(",") if f),
                    mesh_shape=args.mesh_shape)
                if rec["status"] == "ok":
                    gb = rec["memory"]["argument_bytes"] / 2**30
                    print(f"OK   {arch:24s} {shape:12s} {mk:6s} "
                          f"microbatches={rec.get('microbatches', '-')} "
                          f"kv_shard={rec['kv_shard']} "
                          f"n_params={rec['n_params']} "
                          f"args={gb:.3f}GB/device", flush=True)
                elif rec["status"] == "skipped":
                    print(f"SKIP {arch:24s} {shape:12s} {mk:6s} "
                          f"{rec['reason']}", flush=True)
                else:
                    failures += 1
                    print(f"FAIL {arch:24s} {shape:12s} {mk:6s} "
                          f"{rec['error']}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
