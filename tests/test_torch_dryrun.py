"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's on the CPU.

Every arch x shape cell on the reference's layouts (16 x 16, 2 x 16 x 16
and ``--mesh-shape 128x2``) is held against the reference's own functions,
called in-process on a duck mesh that has only ``axis_names`` and
``shape`` (all the rules read, so no 512 host devices are needed):
``pick_microbatches``, the ``auto`` ``kv_shard`` rule, ``_active_params``,
``count_params``, the model FLOPs, the sanitized state, input and cache
specs leaf for leaf, and the bytes a device holds of the arguments under
them. The prefill's abstract cache is held against ``jax.eval_shape`` of
the reference's prefill. XLA's argument size for one compiled cell (the
reference's CLI in a subprocess) checks what ``argument_bytes`` counts.
Skip records equal the reference's ``run_cell``'s. The CLI runs in a
subprocess. ``build_cell`` on a CPU ``make_local_mesh(2, 2)`` builds
steps that equal, bit for bit, the steps built directly.

``import repro.launch.dryrun`` rewrites ``os.environ["XLA_FLAGS"]`` to ask
for 512 host devices; the fixture that imports it puts the old value
back, so later subprocesses of the same worker do not inherit it.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import stepfn as jstep  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, reduced  # noqa: E402,E501
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import stepfn as ts  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAMES = list(ARCHS)
# (mesh kind, --mesh-shape, the layout's axes and sizes)
LAYOUTS = [("single", None, {"data": 16, "model": 16}),
           ("multi", None, {"pod": 2, "data": 16, "model": 16}),
           ("single", "128x2", {"data": 128, "model": 2})]
LAYOUT_IDS = ["16x16", "2x16x16", "128x2"]


class Duck:
    """A mesh as the reference's rules see it: axis names and sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.fixture
def jdry(monkeypatch):
    """``repro.launch.dryrun`` imported with ``XLA_FLAGS`` put back."""
    old = os.environ.get("XLA_FLAGS")
    if old is None:
        monkeypatch.delenv("XLA_FLAGS", raising=False)
    else:
        monkeypatch.setenv("XLA_FLAGS", old)
    import repro.launch.dryrun as mod
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return mod


def _walk(tree, leaf, prefix=()):
    """(path, leaf) pairs of a tree of dicts, tuples and lists."""
    if leaf(tree) or not isinstance(tree, (dict, tuple, list)):
        yield "/".join(prefix), tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], leaf, prefix + (str(k),))
    else:
        for i, v in enumerate(tree):
            yield from _walk(v, leaf, prefix + (str(i),))


def _jspecs(tree):
    return {k: tuple(v) for k, v in _walk(tree, lambda x: isinstance(x, JP))}


def _tspecs(tree):
    return {k: tuple(v) for k, v in _walk(tree, tsh.is_spec)}


def _shapes(tree, torch_side):
    """path -> (shape, dtype name) of an abstract tree."""
    if torch_side:
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in _walk(tree, torch.is_tensor)}
    return {k: (tuple(v.shape), str(v.dtype))
            for k, v in _walk(tree, lambda x: hasattr(x, "dtype"))}


def _ref_bytes(args, specs, mesh):
    """The bytes a device holds of the reference's abstract ``args`` under
    its sanitized ``specs``: each leaf's elements over the product of the
    mesh axes its spec names, times its itemsize."""
    spec_of = _jspecs(specs)
    total = 0
    for path, x in _walk(args, lambda x: hasattr(x, "dtype")):
        split = 1
        for m in spec_of[path]:
            for a in (m if isinstance(m, tuple) else (m,) if m else ()):
                split *= mesh.shape[a]
        total += int(np.prod(x.shape, dtype=np.int64)) // split \
            * jnp.dtype(x.dtype).itemsize
    return total


@functools.lru_cache(maxsize=None)
def _ref_prefill_cache(name):
    jc = jreg.get_config(name)
    shape = jbase.SHAPES["prefill_32k"]
    return jax.eval_shape(jstep.make_prefill_step(jc),
                          jspecs.abstract_model(jc),
                          jspecs.input_specs(jc, shape))[1]


def _reference_cell(jdry, name, shape_name, duck):
    """What the reference's ``build_cell`` / ``run_cell`` compute for a
    supported cell, from its own functions on ``duck``: (extra, in specs,
    out specs, abstract args, n_params, model FLOPs)."""
    jc, shape = jreg.get_config(name), jbase.SHAPES[shape_name]
    template = jm.model_template(jc)
    pspecs = jsh.param_pspecs(template, duck)
    in_ps = jsh.input_pspecs(jc, shape.kind, duck)
    kv = "kv_heads" if jc.n_kv_heads % duck.shape["model"] == 0 else "seq"
    extra = {"kv_shard": kv}
    if shape.kind == "train":
        extra["microbatches"] = jdry.pick_microbatches(jc, shape, duck)
        state = jspecs.abstract_train_state(jc)
        state_ps = jsh.sanitize({
            "params": pspecs,
            "opt_state": {"mu": pspecs, "nu": pspecs, "count": JP()},
            "step": JP()}, state, duck)
        batch = jspecs.input_specs(jc, shape)
        in_ps = jsh.sanitize(in_ps, batch, duck)
        ins, outs, args = (state_ps, in_ps), (state_ps, None), (state, batch)
    else:
        params = jspecs.abstract_model(jc)
        pspecs = jsh.sanitize(pspecs, params, duck)
        if shape.kind == "prefill":
            batch = jspecs.input_specs(jc, shape)
            in_ps = jsh.sanitize(in_ps, batch, duck)
            cache_ps = jsh.sanitize(jsh.cache_pspecs(jc, duck, kv),
                                    _ref_prefill_cache(name), duck)
            ins, outs = (pspecs, in_ps), (None, cache_ps)
            args = (params, batch)
        else:
            spec = jspecs.input_specs(jc, shape)
            cache_ps = jsh.sanitize(jsh.cache_pspecs(jc, duck, kv),
                                    spec["cache"], duck)
            ba = jsh.batch_axes(duck)
            tok_ps, pos_ps = jsh.sanitize(
                [JP(ba, None), JP(ba)],
                [spec["tokens"], spec["positions"]], duck)
            ins = (pspecs, cache_ps, tok_ps, pos_ps)
            outs = (None, cache_ps)
            args = (params, spec["cache"], spec["tokens"],
                    spec["positions"])
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind != "decode" else shape.global_batch)
    mult = 3.0 if shape.kind == "train" else 1.0
    flops = 2.0 * mult * jdry._active_params(jc) * tokens
    return (extra, ins, outs, args, jparams.count_params(template), flops)


@pytest.mark.parametrize("kind,mesh_shape,axes", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("name", NAMES)
def test_cells_match_reference(jdry, name, kind, mesh_shape, axes):
    """Every shape of ``name`` on one layout: the record (microbatches,
    kv_shard, n_chips, n_params, model FLOPs, argument bytes) and
    ``build_cell``'s sanitized in / out specs and abstract arguments equal
    what the reference's functions give on the same layout."""
    layout = (tmesh.layout_of(mesh_shape) if mesh_shape
              else tmesh.production_layout(multi_pod=kind == "multi"))
    assert layout.shape == axes and layout.axis_names == tuple(axes)
    duck = Duck(axes)
    assert tdry._active_params(get_config(name)) == jdry._active_params(
        jreg.get_config(name))
    n_ok = 0
    for shape_name in SHAPES:
        rec = tdry.run_cell(name, shape_name, kind, mesh_shape=mesh_shape)
        if rec["status"] == "skipped":
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        n_ok += 1
        extra, ins, outs, args, n_params, flops = _reference_cell(
            jdry, name, shape_name, duck)
        assert {k: rec[k] for k in extra} == extra, shape_name
        assert rec["n_chips"] == int(np.prod(list(axes.values())))
        assert rec["n_params"] == n_params
        assert rec["model_flops_total"] == flops
        assert rec["memory"] == {"argument_bytes": _ref_bytes(args, ins,
                                                              duck)}
        step, targs, textra = tdry.build_cell(
            get_config(name), SHAPES[shape_name], layout, kv_shard="auto")
        assert textra == extra
        assert len(step.in_specs) == len(ins)
        for t, j in zip(step.in_specs, ins):
            assert _tspecs(t) == _jspecs(j), shape_name
        for t, j in zip(step.out_specs, outs):
            assert (t is None) == (j is None)
            if t is not None:
                assert _tspecs(t) == _jspecs(j), shape_name
        assert _shapes(targs, True) == _shapes(args, False), shape_name
        with pytest.raises(RuntimeError, match="has no devices"):
            step(*targs)
    assert n_ok >= 3


@pytest.mark.parametrize("name", NAMES)
def test_prefill_cache_is_the_reference_prefills(name):
    """The prefill's abstract cache (``_init_cache`` on ``meta``, the
    allocator the prefill uses) equals ``jax.eval_shape`` of the
    reference's prefill at ``prefill_32k`` in shape and dtype, leaf for
    leaf (a sliding window keeps its window)."""
    shape = SHAPES["prefill_32k"]
    got = tm._init_cache(get_config(name), shape.global_batch,
                         shape.seq_len, torch.bfloat16, torch.device("meta"))
    want = _ref_prefill_cache(name)
    assert _shapes(got, True) == _shapes(want, False)
    cfg = get_config(name)
    if cfg.window:
        k = next(v for p, v in _walk(got, torch.is_tensor)
                 if p.endswith("/k"))
        assert k.shape[2] == cfg.window


def test_skip_records_equal_the_reference(jdry):
    """Every unsupported cell on every layout: the port's record equals
    the reference's ``run_cell`` dict (which returns before it builds any
    mesh)."""
    n = 0
    for name in NAMES:
        for shape_name in SHAPES:
            for kind, mesh_shape, _ in LAYOUTS:
                got = tdry.run_cell(name, shape_name, kind,
                                    mesh_shape=mesh_shape, tag="t",
                                    opt=("attn_bf16",))
                if got["status"] != "skipped":
                    continue
                want = jdry.run_cell(name, shape_name, kind,
                                     mesh_shape=mesh_shape, tag="t",
                                     opt=("attn_bf16",))
                assert list(got.items()) == list(want.items())
                n += 1
    assert n == 5 * len(LAYOUTS)      # long_500k of five architectures


def test_planted_failure_is_an_error_record_and_exit_1(monkeypatch, capsys,
                                                       tmp_path):
    """A ``build_cell`` that raises gives ``status`` "error" with the
    exception and the traceback's tail, and the CLI exits 1 with a FAIL
    line; the record keeps the reference's leading keys in order."""
    def planted(*a, **kw):
        raise RuntimeError("planted")

    monkeypatch.setattr(tdry, "build_cell", planted)
    rec = tdry.run_cell("xlstm-125m", "train_4k", "single",
                        outdir=str(tmp_path))
    assert list(rec)[:7] == ["arch", "shape", "mesh", "tag", "attn_impl",
                             "kv_shard", "opt"]
    assert rec["status"] == "error" and rec["error"] == "RuntimeError: planted"
    assert "planted" in rec["traceback"] and len(rec["traceback"]) <= 2000
    assert json.loads((tmp_path / "xlstm-125m_train_4k_single_baseline.json")
                      .read_text()) == rec
    with pytest.raises(SystemExit) as exc:
        tdry.main(["--arch", "xlstm-125m", "--shape", "train_4k",
                   "--out", str(tmp_path)])
    assert exc.value.code == 1
    assert "FAIL xlstm-125m" in capsys.readouterr().out


def _cli(args, module="repro_torch.launch.dryrun", env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-m", module] + args, cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def reference_cell(tmp_path_factory):
    """The reference's CLI on xlstm-125m ``decode_32k`` (one cheap cell,
    as ``tests/test_dryrun.py`` runs it), started with the first test that
    asks for it."""
    out = tmp_path_factory.mktemp("ref_dryrun")
    proc = _cli(["--arch", "xlstm-125m", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(out), "--tag", "t"],
                module="repro.launch.dryrun")
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=60)


def test_cli_cells_and_refusals(tmp_path, reference_cell):
    """The CLI in a subprocess: xlstm-125m ``decode_32k`` on the single
    layout is OK with its record (and its argument bytes are XLA's for the
    reference's compiled cell plus the decode positions, which the
    reference's jit prunes: xLSTM reads no positions); qwen2.5-14b
    ``long_500k`` is a SKIP with exit 0; ``--save-hlo`` is refused."""
    ok = _cli(["--arch", "xlstm-125m", "--shape", "decode_32k", "--mesh",
               "single", "--out", str(tmp_path), "--tag", "t"])
    skip = _cli(["--arch", "qwen2.5-14b", "--shape", "long_500k", "--mesh",
                 "single", "--out", str(tmp_path)])
    hlo = _cli(["--arch", "xlstm-125m", "--save-hlo"])
    out, err = ok.communicate(timeout=300)
    assert ok.returncode == 0, out + err
    assert "OK   xlstm-125m" in out and "kv_shard=seq" in out
    rec = json.loads((tmp_path / "xlstm-125m_decode_32k_single_t.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["kv_shard"] == "seq" and rec["opt"] == []
    assert rec["n_params"] == 120108336
    assert set(rec) == {"arch", "shape", "mesh", "tag", "attn_impl",
                        "kv_shard", "opt", "status", "n_chips", "n_params",
                        "memory", "model_flops_total"}
    out, err = skip.communicate(timeout=300)
    assert skip.returncode == 0 and "SKIP qwen2.5-14b" in out, out + err
    out, err = hlo.communicate(timeout=300)
    assert hlo.returncode == 2 and "there is no HLO" in err, out + err
    proc, ref_out = reference_cell
    r_out, r_err = proc.communicate(timeout=600)
    assert proc.returncode == 0, r_out[-2000:] + r_err[-2000:]
    want = json.loads((ref_out / "xlstm-125m_decode_32k_single_t.json")
                      .read_text())
    assert want["n_chips"] == rec["n_chips"]
    assert want["model_flops_total"] == rec["model_flops_total"]
    positions = 128 // 16 * 4          # (128,) int32 split over data
    assert rec["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"] + positions


# ---------------------------------------------- build_cell on a mesh ----

GRANITE, DANUBE = "granite-moe-3b-a800m", "h2o-danube-1.8b"


def _state(cfg, seed):
    p = tparams.init_params(tm.model_template(cfg),
                            torch.Generator().manual_seed(seed),
                            device="cpu")
    return {"params": p, "opt_state": AdamW().init(p),
            "step": torch.zeros((), dtype=torch.int32)}


def _batch(B, S, seed):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, 256, (B, S + 1)))
    b = {"tokens": toks[:, :S], "targets": toks[:, 1:].clone()}
    b["targets"][0, :3] = -1
    return b


@pytest.mark.parametrize("name", [GRANITE, DANUBE])
def test_build_cell_steps_run_on_a_local_mesh(name):
    """``build_cell`` on a CPU ``make_local_mesh(2, 2)`` for a reduced
    config: its train, prefill and decode steps, on arguments laid out by
    ``place`` as ``in_specs`` say, equal bit for bit the steps built
    directly with the reference's arguments (``AdamW(lr=3e-4)``, remat,
    ``moe_groups`` = the data groups, the constrain hook), on the
    parameters laid out by ``param_pspecs``; the train record's argument
    bytes are each slot's parameter and moment bytes plus the batch's and
    the replicated counters' share."""
    cfg = reduced(get_config(name))
    mesh = tmesh.make_local_mesh(2, 2, device="cpu")
    cons = tsh.make_constrain(mesh)
    specs = tsh.param_pspecs(tm.model_template(cfg), mesh)
    B, S = 4, 8

    # train
    step, args, extra = tdry.build_cell(cfg, ShapeConfig("t", "train", S, B),
                                        mesh, kv_shard="auto")
    assert extra == {"microbatches": 1, "kv_shard": "kv_heads"}
    state, batch = step.place(_state(cfg, 3), _batch(B, S, 4))
    held = [sum(leaf.pieces[i][j].numel() * 4 for tree in (
        state["params"], state["opt_state"]["mu"], state["opt_state"]["nu"])
        for leaf in tparams.leaves(tree, torch.is_tensor))
        for i, j in mesh.slots()]
    batch_share = 2 * (B // 2) * S * 4
    want_bytes = tdry.argument_bytes(args, step.in_specs, mesh)
    assert held == [want_bytes - batch_share - 8] * 4
    got_state, got_m = step(state, batch)
    sp = tsh.put(_state(cfg, 3)["params"], specs, mesh)
    opt = AdamW(lr=3e-4)
    direct = {"params": sp, "opt_state": opt.init(sp),
              "step": torch.zeros((), dtype=torch.int32)}
    want_state, want_m = ts.make_train_step(
        cfg, opt, remat=True, constrain=cons, moe_groups=2, mesh=mesh)(
            direct, _batch(B, S, 4))
    assert all(torch.equal(got_m[k], want_m[k]) for k in want_m)
    a, b = tckpt._flatten(got_state), tckpt._flatten(want_state)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # prefill, then decode on its cache (the train step moved sp in place)
    params = _state(cfg, 3)["params"]
    sp = tsh.put(params, specs, mesh)
    pre, _, _ = tdry.build_cell(cfg, ShapeConfig("p", "prefill", S, B),
                                    mesh, kv_shard="auto")
    toks = _batch(B, S, 5)["tokens"]
    lg, cache = pre(*pre.place(params, {"tokens": toks}))
    lg_d, cache_d = ts.make_prefill_step(cfg, constrain=cons, moe_groups=2,
                                         mesh=mesh)(sp, {"tokens": toks})
    assert torch.equal(lg, lg_d)
    for c, d in zip(cache, cache_d):
        for x, y in zip(tparams.leaves(c, torch.is_tensor),
                        tparams.leaves(d, torch.is_tensor)):
            assert torch.equal(x, y)
    # the data groups' caches as one, the shape the abstract cache gives
    # (a group's leaves lead with the layer axis, the batch behind it)
    paths = [p for p, _ in _walk(cache[0], torch.is_tensor)]
    whole = tparams.with_leaves(cache[0], [
        torch.cat(xs, int(p.startswith("groups/"))) for p, xs in zip(
            paths, zip(*(tparams.leaves(c, torch.is_tensor)
                         for c in cache)))])
    assert _shapes(whole, True) == _shapes(tm._init_cache(
        cfg, B, S, torch.bfloat16, torch.device("meta")), True)
    dec, _, _ = tdry.build_cell(cfg, ShapeConfig("d", "decode", S, B), mesh,
                                kv_shard="auto")
    tok = lg.argmax(-1)[:, None].to(torch.int32)
    pos = torch.full((B,), S, dtype=torch.int32)
    got = dec(*dec.place(params, whole, tok, pos))
    want = ts.make_decode_step(cfg, constrain=cons, mesh=mesh)(
        sp, cache_d, tok, pos)
    assert torch.equal(got[0], want[0])
    for c, d in zip(got[1], want[1]):
        for x, y in zip(tparams.leaves(c, torch.is_tensor),
                        tparams.leaves(d, torch.is_tensor)):
            assert torch.equal(x, y)
