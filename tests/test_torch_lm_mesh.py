"""The LM stack on a mesh: the port's sharding rules, abstract specs, local
mesh, MoE island and sharded train / prefill / decode steps against the JAX
package on the CPU, and the port's own invariants.

Rules are compared with no devices, on duck meshes ``{data, model}`` =
(1, 1), (2, 2), (4, 1), (1, 4), (16, 16) and ``{pod, data, model}`` =
(2, 16, 16), for all ten architectures at full width: spec trees equal
leaf by leaf and path by path, ``make_constrain``'s specs equal to those
the reference hands ``with_sharding_constraint`` (captured through a
monkeypatch), abstract shapes and dtypes equal.

Numbers are compared with the reference's own mesh run: this file runs
itself as ``python tests/test_torch_lm_mesh.py --reference OUT`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=4
--xla_allow_excess_precision=false`` set before JAX starts (the second
flag makes XLA round every bfloat16 op where the program says, as the
port does op by op), and the subprocess writes the jitted reference's
results on ``make_local_mesh(2, 2)`` (and (4, 1) for
granite-moe-3b-a800m) to an npz: the train forward at a batch that
divides ``moe_groups`` (the MoE island) and, for the MoE models, at one
that does not (the global dispatch), one train step, prefill and two
greedy decode steps, and for every MoE dispatch its picks and the gap
between its k-th and (k+1)-th router probability (an island slot's also
its input, partial output and aux), recorded through a patched
``jax.lax.top_k`` and ``jax.debug.callback``. The port runs on
``make_local_mesh(..., device="cpu")`` on the same parameters (drawn
inside ``jax.threefry_partitionable(False)``) and inputs (numpy, seeded).
Bounds:
- the island slot by slot on the reference's recorded inputs: routing
  integers (``topi``, ``dest``, ``keep``) equal, partial outputs within
  tests/test_torch_moe_xattn.py's op-by-op bounds (mean |d| <= 5e-3 and
  max |d| <= 0.15 of the mean |want|), aux rtol 1e-5;
- end to end, routing: every token picks the reference's experts (their
  order changes nothing downstream) and ``dest`` / ``keep`` are equal,
  except where a near tie (gap < ``GAP_R`` = 5e-3) routes the other way
  and what that flip reaches (later tokens of its dispatch group, later
  positions of its row). GSPMD's tensor-parallel partial sums round the
  reference's dense products differently from any unsharded run: on
  granite 2 x 2 two tokens flip, at gaps 1.9e-4 and 1.4e-3;
- end to end, logits over the positions no flip reaches: the jitted
  forward's bounds of tests/test_torch_models.py (3e-2, 0.3; measured
  0.9-1.5e-2 and 0.06-0.12, the size of the reference's own 1 x 1 vs
  2 x 2 difference); aux rtol 1e-5 (1e-4 for the global dispatch, 2e-2
  where a token flipped); greedy tokens equal wherever the reference's
  top-2 gap exceeds twice the bound on one logit;
- the train step: loss and aux within 5e-4, gradients (the first moment
  ``mu`` = 0.1 x the clipped gradient) per leaf within relative norm
  5e-2 and cosine 0.999 (tests/test_torch_training.py's bounds), grad
  norm rtol 1e-2, parameters within 2 lr (AdamW's first step moves each
  by lr (+-1 + wd p)); where the forward flips a near tie, loss and aux
  within 1e-2 and gradients within 0.5 / 0.95 (measured on granite 2 x 2:
  2.1e-3, 3.7e-3, 0.30 / 0.958).
"""
import dataclasses
import math
import os
import pathlib
import subprocess
import sys

# the reference's subprocess: 4 host devices, and every bfloat16 op rounded
# where the program says (XLA otherwise keeps fused intermediates in
# float32, which the op-by-op port does not)
REF_XLA_FLAGS = ("--xla_force_host_platform_device_count=4 "
                 "--xla_allow_excess_precision=false")
if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = REF_XLA_FLAGS
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, all_cells, get_config  # noqa: E402,E501
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import stepfn as ts  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
GRANITE, MIXTRAL = "granite-moe-3b-a800m", "mixtral-8x7b"
RGEMMA, XLSTM, WHISPER = "recurrentgemma-2b", "xlstm-125m", "whisper-base"
# (tag, architecture, mesh shape, moe_groups for the forward whose batch
# does not divide it; None: no MoE)
CASES = [("granite_2x2", GRANITE, (2, 2), 8), ("granite_4x1", GRANITE, (4, 1), 8),
         ("mixtral_2x2", MIXTRAL, (2, 2), 8), ("rgemma_2x2", RGEMMA, (2, 2), None),
         ("xlstm_2x2", XLSTM, (2, 2), None), ("whisper_2x2", WHISPER, (2, 2), None)]
B, S, N_DEC, SEED = 4, 16, 2, 11
BF = torch.bfloat16


def case_inputs(name, seed=7):
    """The batch of a case: B x S tokens and targets, data group 0's rows
    ignoring 7 more targets than group 1's; whisper's 16 frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :S], "targets": toks[:, 1:].copy()}
    batch["targets"][0, 2:9] = -1
    batch["targets"][3, 5] = -1
    if name == WHISPER:
        batch["cross_src"] = rng.normal(size=(B, 16, 64)).astype(np.float32)
    return batch


def ref_params(name):
    cfg = jbase.reduced(jreg.get_config(name))
    with jax.threefry_partitionable(False):
        return cfg, jparams.init_params(jm.model_template(cfg),
                                        jax.random.key(SEED))


# ------------------------------------------- the reference's mesh run ----

def reference(out):
    """Run every case on the reference's mesh (this process sees 4 host
    devices) and write the results to the npz ``out``."""
    from jax.sharding import NamedSharding
    from repro.launch.mesh import make_local_mesh
    from repro.models import stepfn as jstep
    from repro.training.checkpoint import _flatten
    from repro.training.optimizer import AdamW as JAdamW

    res, routes = {}, []
    local, dispatch_all, top_k = jl._moe_local, jl.apply_moe, jax.lax.top_k

    def save(*vals):
        routes.append(tuple(np.asarray(v).astype(
            np.float32 if v.dtype == jnp.bfloat16 else v.dtype)
            for v in vals))

    def top_k_of(slot, extra=()):
        """``jax.lax.top_k`` for the MoE's router that also hands the picks
        and the gap between the k-th and (k+1)-th probability (with
        ``slot`` and ``extra``) to the host."""
        def fn(probs, k):
            E = probs.shape[-1]
            top, idx = top_k(probs, min(k + 1, E))
            gap = (top[..., k - 1] - top[..., k] if k < E
                   else jnp.full(top.shape[:-1], jnp.inf))
            jax.debug.callback(save, *slot(), idx[..., :k], gap, *extra)
            return top[..., :k], idx[..., :k]
        return fn

    def recorded(p_local, x_flat, cfg):
        slot = lambda: (jax.lax.axis_index("data"),
                        jax.lax.axis_index("model"))
        jax.lax.top_k = top_k_of(slot, (x_flat,))
        try:
            out_, aux = local(p_local, x_flat, cfg)
        finally:
            jax.lax.top_k = top_k
        jax.debug.callback(save, *slot(), out_, aux)
        return out_, aux

    def recorded_global(*a, **kw):
        jax.lax.top_k = top_k_of(lambda: (0, 0))
        try:
            return dispatch_all(*a, **kw)
        finally:
            jax.lax.top_k = top_k

    def run(prefix, fn, *args):
        """``fn(*args)`` with the MoE's routing recorded under ``prefix``:
        per slot and MoE layer ``topi`` and ``gap`` (and on the island
        ``x``, ``out`` and ``aux``)."""
        routes.clear()
        jl._moe_local, jl.apply_moe = recorded, recorded_global
        try:
            result = jax.block_until_ready(fn(*args))
        finally:
            jl._moe_local, jl.apply_moe = local, dispatch_all
        seen = {}
        for rec in routes:
            i, j = int(rec[0]), int(rec[1])
            if len(rec) == 4 and rec[3].ndim == 0:          # out, aux
                n = seen[(i, j)]
                keys = ("out", "aux")
            else:
                n = seen[(i, j)] = seen.get((i, j), -1) + 1
                keys = ("topi", "gap", "x")
            for key, v in zip(keys, rec[2:]):
                v = v.reshape(-1, v.shape[-1]) if key in (
                    "topi", "x", "out") else v.reshape(-1)
                res[f"{prefix}/slot/{i}/{j}/{n}/{key}"] = v
        return result

    for tag, name, shape, mg_odd in CASES:
        cfg, P = ref_params(name)
        mesh = make_local_mesh(*shape)
        Ps = jax.device_put(P, jsh.named(
            jsh.param_pspecs(jm.model_template(cfg), mesh), mesh))
        cons = jsh.make_constrain(mesh)
        specs = jsh.input_pspecs(cfg, "train", mesh)
        batch = {k: jnp.asarray(v) for k, v in case_inputs(name).items()}
        if "cross_src" in batch:
            batch["cross_src"] = batch["cross_src"].astype(jnp.bfloat16)
        batch = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
                 for k, v in batch.items()}
        cs = batch.get("cross_src")
        fwds = [("div", mesh.devices.size)]
        if mg_odd is not None:
            fwds.append(("odd", mg_odd))
        for ftag, mg in fwds:
            fwd = jax.jit(lambda p, t, c, mg=mg: jm.forward(
                p, cfg, t, cross_src=c, constrain=cons, moe_groups=mg,
                mesh=mesh))
            lg, _, aux = run(f"{tag}/fwd_{ftag}", fwd, Ps, batch["tokens"],
                             cs)
            res[f"{tag}/fwd_{ftag}/logits"] = np.asarray(lg)
            res[f"{tag}/fwd_{ftag}/aux"] = np.asarray(aux)
        opt = JAdamW()
        state = {"params": Ps, "opt_state": opt.init(Ps),
                 "step": jnp.zeros((), jnp.int32)}
        state, m = jax.jit(jstep.make_train_step(
            cfg, opt, constrain=cons, mesh=mesh,
            moe_groups=mesh.devices.size))(state, batch)
        for k, v in m.items():
            res[f"{tag}/step/{k}"] = np.asarray(v)
        for k, v in _flatten({"params": state["params"],
                              "mu": state["opt_state"]["mu"]}).items():
            res[f"{tag}/step/{k}"] = v
        pre = jax.jit(jstep.make_prefill_step(
            cfg, constrain=cons, moe_groups=mesh.devices.size, mesh=mesh))
        dec = jax.jit(jstep.make_decode_step(cfg, constrain=cons))
        pb = {"tokens": batch["tokens"]}
        if cs is not None:
            pb["cross_src"] = cs
        lg, cache = run(f"{tag}/prefill", pre, Ps, pb)
        res[f"{tag}/prefill/logits"] = np.asarray(lg)
        for n in range(N_DEC):
            tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
            res[f"{tag}/decode/{n}/tokens"] = np.asarray(tok)
            lg, cache = run(f"{tag}/decode/{n}", dec, Ps, cache, tok,
                            jnp.full((B,), S + n, jnp.int32))
            res[f"{tag}/decode/{n}/logits"] = np.asarray(lg)
    np.savez(out, **res)


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's subprocess, started with the module's first test so
    that it runs while the tests that do not read it do."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=REF_XLA_FLAGS)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    with open(tmp / "stderr.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, __file__, "--reference",
                                 str(tmp / "reference.npz")], env=env,
                                stdout=subprocess.DEVNULL, stderr=err)
    try:
        yield proc, tmp
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


@pytest.fixture(scope="module")
def ref(reference_run):
    proc, tmp = reference_run
    rc = proc.wait(timeout=900)
    assert rc == 0, (tmp / "stderr.txt").read_text()[-4000:]
    with np.load(tmp / "reference.npz") as data:
        return dict(data)


# ------------------------------------------------------------ helpers ----

def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, mean_rel=5e-3, max_rel=0.15):
    """mean |got - want| <= mean_rel * mean |want| and max |got - want| <=
    max_rel * mean |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    d, scale = np.abs(got - want), np.abs(want).mean()
    assert d.mean() <= mean_rel * scale and d.max() <= max_rel * scale, \
        (d.mean() / scale, d.max() / scale)


class Duck:
    """A mesh as the rules see it: axis names and sizes, no devices."""

    def __init__(self, **shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


DUCKS = [dict(data=1, model=1), dict(data=2, model=2), dict(data=4, model=1),
         dict(data=1, model=4), dict(data=16, model=16),
         dict(pod=2, data=16, model=16)]
NAMES = list(ARCHS)


def _walk(tree, leaf, prefix=()):
    """(path, leaf) pairs of a tree of dicts and tuples; ``leaf`` says what
    stops the walk (a spec is a tuple)."""
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


# ------------------------------------------------------- rule parity ----

@pytest.mark.parametrize("name", NAMES)
def test_param_specs_and_logical_axes_match_reference(name):
    """``param_pspecs`` on every duck mesh, ``logical_axes`` and
    ``abstract_params`` (float32 and bfloat16) of the full-width template:
    equal to the reference's path by path."""
    jt = jm.model_template(jreg.get_config(name))
    tt = tm.model_template(get_config(name))
    ja = dict(_walk(jparams.logical_axes(jt), lambda x: isinstance(x, tuple)
                    and all(isinstance(a, str) for a in x)))
    ta = dict(_walk(tparams.logical_axes(tt), lambda x: isinstance(x, tuple)
                    and all(isinstance(a, str) for a in x)))
    assert ja == ta and len(ja) > 10
    assert tparams.is_pspec(tparams.leaves(tt)[0])
    for dt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF)):
        assert _shapes(jparams.abstract_params(jt, dt), False) == _shapes(
            tparams.abstract_params(tt, tdt), True)
    assert all(x.device.type == "meta" for x in tparams.leaves(
        tparams.abstract_params(tt), torch.is_tensor))
    for shape in DUCKS:
        want = _jspecs(jsh.param_pspecs(jt, Duck(**shape)))
        got = _tspecs(tsh.param_pspecs(tt, Duck(**shape)))
        assert got == want, shape


@pytest.mark.parametrize("name", NAMES)
def test_sanitize_and_cache_specs_match_reference(name):
    """``sanitize`` of the parameters' unchecked specs (every mapping kept
    whatever the size) against the abstract parameters, and of
    ``cache_pspecs`` (both ``kv_shard``) against each decode cell's
    abstract cache; ``cache_pspecs`` itself and ``batch_axes``."""
    jc, tc = jreg.get_config(name), get_config(name)
    jt, tt = jm.model_template(jc), tm.model_template(tc)
    for shape in DUCKS:
        jmesh, tmesh_ = Duck(**shape), Duck(**shape)
        assert jsh.batch_axes(jmesh) == tsh.batch_axes(tmesh_)
        loose_j = jax.tree_util.tree_map(
            lambda p: jsh._resolve(p.axes, jsh.PARAM_RULES, jmesh),
            jt, is_leaf=jparams.is_pspec)
        loose_t = tparams.tree_map(
            lambda p: tsh._resolve(p.axes, tsh.PARAM_RULES, tmesh_), tt)
        assert _tspecs(loose_t) == _jspecs(loose_j)
        want = jsh.sanitize(loose_j, jparams.abstract_params(jt), jmesh)
        got = tsh.sanitize(loose_t, tparams.abstract_params(tt), tmesh_)
        assert _tspecs(got) == _jspecs(want), shape
        for kv in ("kv_heads", "seq"):
            cj = jsh.cache_pspecs(jc, jmesh, kv_shard=kv)
            ct = tsh.cache_pspecs(tc, tmesh_, kv_shard=kv)
            assert _tspecs(ct) == _jspecs(cj), (shape, kv)
            for cell in ("decode_32k", "long_500k"):
                aj = jspecs.input_specs(jc, jbase.SHAPES[cell])["cache"]
                at = tspecs.input_specs(tc, SHAPES[cell])["cache"]
                assert _tspecs(tsh.sanitize(ct, at, tmesh_)) == _jspecs(
                    jsh.sanitize(cj, aj, jmesh)), (shape, kv, cell)


@pytest.mark.parametrize("name", NAMES)
def test_input_specs_and_train_state_match_reference(name):
    """``input_pspecs`` of each shape kind, ``input_specs`` of every cell
    (the decode cache built on ``meta``), ``abstract_model`` and
    ``abstract_train_state``: equal shapes and dtypes."""
    jc, tc = jreg.get_config(name), get_config(name)
    for shape in DUCKS:
        for kind in ("train", "prefill", "decode"):
            assert _tspecs(tsh.input_pspecs(tc, kind, Duck(**shape))) == \
                _jspecs(jsh.input_pspecs(jc, kind, Duck(**shape)))
    for cell in jbase.SHAPES:
        want = _shapes(jspecs.input_specs(jc, jbase.SHAPES[cell]), False)
        got = tspecs.input_specs(tc, SHAPES[cell])
        assert _shapes(got, True) == want, cell
        assert all(x.device.type == "meta"
                   for _, x in _walk(got, torch.is_tensor))
    assert _shapes(tspecs.abstract_train_state(tc), True) == _shapes(
        jspecs.abstract_train_state(jc), False)
    assert _shapes(tspecs.abstract_model(tc, BF), True) == _shapes(
        jspecs.abstract_model(jc, jnp.bfloat16), False)


def _activations(cfg, cell):
    """(shape, logical axes) of the activations the forward constrains in
    a cell, and of the MoE's dispatch (G = 1), padded and short axes
    included."""
    B = cell.global_batch
    S = 1 if cell.kind == "decode" else cell.seq_len
    d, V = cfg.d_model, cfg.vocab_size
    out = [((B, S, d), ("batch", "seq", "embed_act")),
           ((B, S, d), ("batch",)),
           ((B, S, cfg.n_heads, cfg.head_dim),
            ("batch", "seq", "heads_act", "head_dim")),
           ((B, S, cfg.n_kv_heads, cfg.head_dim),
            ("batch", "seq", "kv_act", "head_dim")),
           ((B, S, V), ("batch", "seq", "vocab_act")),
           ((B, S, 4 * d), ("batch", "seq", None))]
    if cfg.n_experts:
        E, T = cfg.n_experts, B * S
        C = int(max(8, -(-cfg.moe_top_k * T * cfg.capacity_factor // E)))
        out += [((1, T, d), ("batch", "seq", "embed_act")),
                ((1, E, C, d), ("batch", "experts_act", "seq", "embed_act")),
                ((1, E, C, cfg.d_ff),
                 ("batch", "experts_act", "seq", "ffn_act"))]
    return out


def test_constrain_specs_match_reference(monkeypatch):
    """``make_constrain``'s spec of every activation the forward constrains
    in every cell of every architecture on every duck mesh, against the
    spec the reference hands ``with_sharding_constraint``: among them the
    34% padding rule's both sides (40 q-heads over 16 kept, 8 kv heads and
    a batch of 1 over 16 dropped)."""
    seen = []
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    kept = dropped = 0
    for name in NAMES:
        jc, tc = jreg.get_config(name), get_config(name)
        for shape in DUCKS:
            jcons = jsh.make_constrain(Duck(**shape))
            tcons = tsh.make_constrain(Duck(**shape))
            for cell in jbase.SHAPES.values():
                for shp, axes in _activations(jc, cell):
                    seen.clear()
                    jcons(jax.ShapeDtypeStruct(shp, jnp.float32), axes)
                    got = tuple(tcons.spec(shp, axes))
                    assert got == seen[0], (name, shape, shp, axes)
                    loose = tsh._resolve(
                        tuple(axes) + (None,) * (len(shp) - len(axes)),
                        tsh.ACT_RULES, Duck(**shape))
                    for i, m in enumerate(loose):
                        if m is not None and shp[i] % tsh._axis_size(
                                Duck(**shape), m):
                            kept += got[i] is not None
                            dropped += got[i] is None
    assert kept > 0 and dropped > 0, (kept, dropped)
    x = torch.zeros(2, 3, 4)
    assert tsh.make_constrain(Duck(data=2, model=2))(x, ("batch",)) is x


def test_all_cells_and_shapes_match_reference():
    """``all_cells`` (arch, shape, supported, reason) in the reference's
    order, ``SHAPES`` and ``subquadratic``."""
    want = [(a.name, s, ok, why) for a, s, ok, why in jreg.all_cells()]
    got = [(a.name, dataclasses.astuple(s), ok, why)
           for a, s, ok, why in all_cells()]
    assert got == [(a, dataclasses.astuple(s), ok, why)
                   for a, s, ok, why in want]
    assert sum(not c[2] for c in got) > 0
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    assert [c.subquadratic for c in ARCHS.values()] == [
        c.subquadratic for c in jreg.ARCHS.values()]


# ------------------------------------------------------ mesh and place ----

def test_local_mesh_slots_collectives_and_errors(monkeypatch):
    """``make_local_mesh``: CPU slots, ``devices=`` in slot order (a card
    may repeat), the reference's message when too few cards are visible,
    nothing on fewer slots; the collectives in slot order;
    ``make_production_mesh`` raises."""
    m = tmesh.make_local_mesh(2, 2, device="cpu")
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert m.axis_names == ("data", "model")
    assert m.slots() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(d.type == "cpu" for row in m.devices for d in row)
    m2 = tmesh.make_local_mesh(1, 3, devices=["cpu"] * 3)
    assert m2.shape == {"data": 1, "model": 3}
    with pytest.raises(ValueError, match="lists 2 device"):
        tmesh.make_local_mesh(2, 2, devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="TPU pod"):
        tmesh.make_production_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="needs 4 devices but only 2 CUDA"):
        tmesh.make_local_mesh(2, 2)
    assert tmesh.make_local_mesh(1, 2).devices == (
        (torch.device("cuda", 0), torch.device("cuda", 1)),)
    xs = [torch.tensor([1.0, 2.0]), torch.tensor([1e8, 3.0]),
          torch.tensor([-1e8, 5.0])]
    m3 = tmesh.make_local_mesh(3, 1, device="cpu")
    assert m3.psum(xs, "data", "cpu").tolist() == [0.0, 10.0]
    assert m3.all_gather(xs, "data", 0, "cpu").tolist() == [
        1.0, 2.0, 1e8, 3.0, -1e8, 5.0]
    assert m.pmean([torch.tensor(float(i)) for i in range(4)],
                   ("data", "model"), "cpu").item() == 1.5
    with pytest.raises(ValueError, match="takes 2 tensors"):
        m.psum(xs, "model", "cpu")


def test_put_gather_round_trip_and_slot_bytes():
    """``put`` by ``param_pspecs`` then ``gather`` gives back every leaf
    bit for bit; each slot holds exactly its spec share of each leaf's
    bytes (a leaf split over data x model by 1/4, over one axis by 1/2,
    replicated whole), as the reference's NamedSharding would; the pieces
    are each slot's own copies."""
    cfg = reduced(get_config(GRANITE))
    P = tparams.init_params(tm.model_template(cfg),
                            torch.Generator().manual_seed(3), device="cpu")
    mesh = tmesh.make_local_mesh(2, 2, device="cpu")
    specs = tsh.param_pspecs(tm.model_template(cfg), mesh)
    sp = tsh.put(P, specs, mesh)
    back = tsh.gather(sp, "cpu")
    for a, b in zip(tparams.leaves(back, torch.is_tensor),
                    tparams.leaves(P, torch.is_tensor)):
        assert torch.equal(a, b)
    want = [0] * 4
    total = 0
    for x, s in zip(tparams.leaves(P, torch.is_tensor),
                    tparams.leaves(specs, tsh.is_spec)):
        share = math.prod(tsh._axis_size(mesh, e) for e in s if e)
        total += x.numel() * 4
        for k in range(4):
            want[k] += x.numel() * 4 // share
    got = [sum(leaf.pieces[i][j].numel() * 4
               for leaf in tparams.leaves(sp, torch.is_tensor))
           for i, j in mesh.slots()]
    assert got == want and max(got) < total
    ptrs = [leaf.pieces[i][j].data_ptr()
            for leaf in tparams.leaves(sp, torch.is_tensor)
            for i, j in mesh.slots()]
    assert len(set(ptrs)) == len(ptrs)
    with pytest.raises(ValueError, match="does not split"):
        tsh.shard(torch.zeros(3, 4), tsh.P("data", None), mesh)


# --------------------------------------------- layers against the reference

def _bf16_pair(template_j, seed):
    with jax.threefry_partitionable(False):
        P = jparams.init_params(template_j, jax.random.key(seed))
    P = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), P)
    return P, tparams.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, P), device="cpu")


def _x_pair(shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(BF)


@pytest.mark.parametrize("groups,bs", [(1, (4, 16)), (2, (4, 16)),
                                       (4, (4, 16)), (3, (4, 5))])
def test_apply_moe_groups_match_reference(groups, bs):
    """``apply_moe`` with the reference's group-local dispatch (``groups``
    1, 2, 4, and 3 on 20 tokens, which falls back to one group), and
    ``_moe_local``, against the reference op by op on bfloat16
    parameters; ``moe_dispatch`` called once per group."""
    cfg_j = jbase.reduced(jreg.get_config(GRANITE))
    cfg_t = reduced(get_config(GRANITE))
    P, tp = _bf16_pair(jl.moe_template(cfg_j), 5)
    xj, xt = _x_pair(bs + (64,), 6)
    with jax.disable_jit():
        yj, auxj = jl.apply_moe(P, xj, cfg_j, groups=groups)
        lj, laj = jl._moe_local(P, xj.reshape(-1, 64), cfg_j)
    calls = []
    inner = tl.moe_dispatch
    tl.moe_dispatch = lambda *a: calls.append(a[0].shape) or inner(*a)
    try:
        yt, auxt = tl.apply_moe(tp, xt, cfg_t, groups=groups)
    finally:
        tl.moe_dispatch = inner
    T = bs[0] * bs[1]
    G = groups if T % groups == 0 else 1
    assert calls == [(T // G, cfg_t.n_experts)] * G
    _close(yt, yj)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)
    lt, lat = tl._moe_local(tp, xt.reshape(-1, 64), cfg_t)
    _close(lt, lj)
    np.testing.assert_allclose(float(lat), float(laj), rtol=1e-5)


@pytest.mark.parametrize("impl", ["direct", "flash_xla", "flash_xla:8:16",
                                  "band:8", "auto"])
@pytest.mark.parametrize("mixed", [False, True])
def test_attention_routes_match_reference(impl, mixed):
    """Each of the reference's attention routes (its tiles parsed, a band
    narrower than the sequence) with and without ``mixed``, on a sliding
    window of 8 over 32 bfloat16 positions, against the reference op by
    op."""
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
    kv = rng.normal(size=(2, 2, 32, 2, 16)).astype(np.float32)
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kv[0], kv[1])]
    t = [torch.from_numpy(a).to(BF) for a in (q, kv[0], kv[1])]
    pos = np.arange(32, dtype=np.int32)
    with jax.disable_jit():
        want = jl.attention(*j, q_pos=jnp.asarray(pos),
                            k_pos=jnp.asarray(pos), window=8, impl=impl,
                            mixed=mixed)
    got = tl.attention(*t, q_pos=torch.from_numpy(pos),
                       k_pos=torch.from_numpy(pos), window=8, impl=impl,
                       mixed=mixed)
    assert got.dtype == BF
    _close(got, want)


# ------------------------------------------------- the port on a mesh ----

def _port_case(name, shape):
    cfg_j, P = ref_params(name)
    cfg = reduced(get_config(name))
    tp = tparams.params_from_numpy(jax.tree_util.tree_map(np.asarray, P),
                                   device="cpu")
    mesh = tmesh.make_local_mesh(*shape, device="cpu")
    sp = tsh.put(tp, tsh.param_pspecs(tm.model_template(cfg), mesh), mesh)
    batch = {k: torch.from_numpy(v) for k, v in case_inputs(name).items()}
    if "cross_src" in batch:
        batch["cross_src"] = batch["cross_src"].to(BF)
    return cfg, tp, mesh, sp, batch


class _Recorder:
    """While open, records every ``moe_dispatch`` result and every
    ``_moe_local`` (out, aux) of the port's layers, in call order."""

    def __enter__(self):
        self.dispatch, self.local = [], []
        self._d, self._l = tl.moe_dispatch, tl._moe_local
        tl.moe_dispatch = lambda *a: self.dispatch.append(
            self._d(*a)) or self.dispatch[-1]
        tl._moe_local = lambda *a: self.local.append(
            self._l(*a)) or self.local[-1]
        return self

    def __exit__(self, *exc):
        tl.moe_dispatch, tl._moe_local = self._d, self._l


def _dispatch_np(topi, E, C):
    """The reference's ``dest`` and ``keep`` of (T, k) picks (a stable
    argsort of the slots, each slot's rank in its expert's run)."""
    se = topi.reshape(-1)
    srt = se[np.argsort(se, kind="stable")]
    rank = np.arange(se.size) - np.searchsorted(srt, srt, side="left")
    keep = rank < C
    return np.where(keep, srt * C + rank, E * C), keep


def _flips(ref, pre, rec, slots, rows, seq, cfg, hit=None):
    """The port's MoE routing against the reference's recorded routing:
    ``rec`` holds one dispatch per slot (``slots``, in order) per MoE
    layer, each over ``rows`` rows of ``seq`` tokens (the island: every
    slot of the mesh, a data group's rows; the global dispatch: one slot,
    every row; ``hit``: the rows earlier steps' flips reach). Returns the
    (B, seq) mask of the positions a routing flip reaches, and the flips (layer, row, position, the reference's gap
    between its k-th and (k+1)-th router probability). A flip reaches
    every later token of its dispatch group (their capacity ranks) and,
    through attention, every later position of its row.

    Asserted: every flip that no earlier flip reaches is a near tie (gap <
    ``GAP_R``); every other token picks the same experts (their order
    changes nothing downstream); ``dest`` and ``keep`` are equal in every
    slot and layer without a flip."""
    reach = np.zeros((B, seq), bool)        # positions earlier flips reach
    if hit is not None:
        reach[hit] = True
    flips = []
    for layer in range(len(rec) // len(slots)):
        for s_, (i, j) in enumerate(slots):
            r = rec[layer * len(slots) + s_]
            key = f"{pre}/slot/{i}/{j}/{layer}/"
            topi = r["topi"].numpy()
            want = ref[key + "topi"]
            # the order of a token's picks changes nothing downstream
            bad = (np.sort(topi, -1) != np.sort(want, -1)).any(-1)
            for t in np.nonzero(bad)[0]:
                row, pos = i * rows + t // seq, t % seq
                gap = float(ref[key + "gap"][t])
                assert reach[row, pos] or gap < GAP_R, (key, t, gap)
                if j == 0:
                    flips.append((layer, int(row), int(pos), gap))
            if not bad.any():
                C = tl.moe_capacity(cfg, topi.shape[0])
                dest, keep = _dispatch_np(want, cfg.n_experts, C)
                np.testing.assert_array_equal(r["dest"].numpy(), dest,
                                              err_msg=key + "dest")
                np.testing.assert_array_equal(r["keep"].numpy(), keep,
                                              err_msg=key + "keep")
        for layer_, row, pos, _ in flips:
            if layer_ == layer:
                g0 = row // rows * rows
                group = reach[g0:g0 + rows].reshape(-1)   # a view
                group[(row - g0) * seq + pos:] = True
    return reach, flips


def _forward(ref, pre, name, shape, mg):
    """The port's train forward on the mesh with its MoE routing held
    against the reference's (:func:`_flips`): (logits, aux, the mask
    flips reach, flips)."""
    cfg, _, mesh, sp, batch = _port_case(name, shape)
    with _Recorder() as rec:
        lg, cache, aux = tm.forward(sp, cfg, batch["tokens"],
                                    cross_src=batch.get("cross_src"),
                                    constrain=tsh.make_constrain(mesh),
                                    moe_groups=mg, mesh=mesh)
    assert cache is None and lg.device.type == "cpu"
    if not cfg.n_experts:
        assert not rec.dispatch
        return lg, aux, np.zeros((B, S), bool), []
    island = B % mg == 0
    slots = mesh.slots() if island else [(0, 0)]
    assert len(rec.dispatch) == len(slots) * cfg.n_layers
    assert len(rec.local) == (len(rec.dispatch) if island else 0)
    mask, flips = _flips(ref, pre, rec.dispatch, slots,
                         B // shape[0] if island else B, S, cfg)
    return lg, aux, mask, flips


@pytest.fixture(scope="module")
def port_runs(ref):
    """Per case, :func:`_forward` at ``moe_groups`` = mesh size (the
    island for MoE), run once for the tests that read it."""
    runs = {}

    def run(tag, name, shape):
        if tag not in runs:
            runs[tag] = _forward(ref, f"{tag}/fwd_div", name, shape,
                                 shape[0] * shape[1])
        return runs[tag]

    return run


def _close_where(got, want, keep, mean_rel, max_rel):
    """:func:`_close` over the (B, S) positions ``keep`` of (B, S, V)
    logits (or the rows ``keep`` of (B, V))."""
    _close(_np(got)[keep], np.asarray(want)[keep], mean_rel, max_rel)


# GSPMD splits the reference's dense products over the mesh (FSDP and TP
# partial sums, each rounded to bfloat16), so its mesh run differs from
# any unsharded one by the jitted forward's bounds of
# tests/test_torch_models.py (measured, port against the reference's
# mesh run: mean 0.9-1.4e-2, max 0.06-0.12 of the mean |logit|; the
# reference's own 1 x 1 run against its 2 x 2 run: the same size)
MEAN_REL, MAX_REL = 3e-2, 0.3
GAP_R = 5e-3


@pytest.mark.parametrize("tag,name,shape,mg_odd", CASES)
def test_mesh_forward_matches_reference(ref, port_runs, tag, name, shape,
                                        mg_odd):
    """The train forward on the mesh: logits (over the positions no
    routing flip reaches) and aux at ``moe_groups`` = mesh size (the
    island for MoE) and, for MoE, at a ``moe_groups`` the batch does not
    divide (the global dispatch on the lead slot); routing held as
    :func:`_flips` says. Aux within rtol 1e-5 (1e-4 for the global
    dispatch, whose mean over all tokens GSPMD sums shard by shard), or
    2e-2 where a token routes a near tie the other way (one of T * k slots
    moves from one expert's count to another's)."""
    lg, aux, mask, flips = port_runs(tag, name, shape)
    pre = f"{tag}/fwd_div"
    keep = ~mask
    assert keep.mean() >= 0.25, flips
    _close_where(lg, ref[pre + "/logits"], keep, MEAN_REL, MAX_REL)
    np.testing.assert_allclose(float(aux), ref[pre + "/aux"],
                               rtol=2e-2 if flips else 1e-5)
    if tag == "granite_4x1":
        assert not flips                     # no TP sums on this mesh
    if mg_odd is None:
        return
    lg, aux, mask, flips = _forward(ref, f"{tag}/fwd_odd", name, shape,
                                    mg_odd)
    assert (~mask).mean() >= 0.25, flips
    _close_where(lg, ref[f"{tag}/fwd_odd/logits"], ~mask, MEAN_REL, MAX_REL)
    np.testing.assert_allclose(float(aux), ref[f"{tag}/fwd_odd/aux"],
                               rtol=2e-2 if flips else 1e-4)


@pytest.mark.parametrize("tag,name,shape,mg_odd", CASES[:3])
def test_mesh_island_matches_reference_slot_by_slot(ref, tag, name, shape,
                                                    mg_odd):
    """``apply_moe_shardmap`` on the activations the reference's island
    took in each MoE layer of its mesh forward (recorded slot by slot),
    with that layer's bfloat16 weights: every slot's routing integers
    (``topi``, ``dest``, ``keep``) equal, its partial output within 5e-3 /
    0.15 of the mean |out| and its aux within rtol 1e-5 (the op-by-op
    bounds of tests/test_torch_moe_xattn.py); the output the port returns
    is its slots' partial outputs added over ``model``."""
    cfg_j, P = ref_params(name)
    cfg = reduced(get_config(name))
    mesh = tmesh.make_local_mesh(*shape, device="cpu")
    rows = B // shape[0]
    pre = f"{tag}/fwd_div/slot"
    for layer in range(cfg.n_layers):
        moe = {k: jnp.asarray(v[layer]).astype(jnp.bfloat16)
               for k, v in P["groups"][0]["moe"].items() if k != "norm"}
        p = tparams.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, moe), device="cpu")
        x = torch.cat([torch.from_numpy(np.asarray(
            ref[f"{pre}/{i}/0/{layer}/x"], np.float32)).reshape(
                rows, S, -1) for i in range(shape[0])]).to(BF)
        with _Recorder() as rec:
            y, aux = tl.apply_moe_shardmap(p, x, cfg, mesh)
        assert len(rec.local) == mesh.size
        for s_, (i, j) in enumerate(mesh.slots()):
            key = f"{pre}/{i}/{j}/{layer}/"
            r = rec.dispatch[s_]
            topi = ref[key + "topi"]
            dest, keep = _dispatch_np(topi, cfg.n_experts, tl.moe_capacity(
                cfg, topi.shape[0]))
            for k, want in (("topi", topi), ("dest", dest), ("keep", keep)):
                np.testing.assert_array_equal(r[k].numpy(), want,
                                              err_msg=key + k)
            out, a = rec.local[s_]
            _close(out, ref[key + "out"])
            np.testing.assert_allclose(float(a), ref[key + "aux"].item(),
                                       rtol=1e-5)
        nm = shape[1]
        want = torch.cat([sum(rec.local[i * nm + j][0] for j in range(nm))
                          .reshape(rows, S, -1) for i in range(shape[0])])
        assert torch.equal(y, want)
        np.testing.assert_allclose(
            float(aux), np.mean([ref[f"{pre}/{i}/{j}/{layer}/aux"].item()
                                 for i, j in mesh.slots()]), rtol=1e-5)


def _rel(a, b):
    nb = np.linalg.norm(b)
    return np.linalg.norm(a - b) / nb, float((a * b).sum() / (
        np.linalg.norm(a) * nb))


@pytest.mark.parametrize("tag,name,shape,mg_odd", CASES)
def test_mesh_train_step_matches_reference(ref, port_runs, tag, name, shape,
                                           mg_odd):
    """One train step on the mesh (``moe_groups`` = mesh size, as the
    reference's Trainer), data groups with unequal ignored targets: the
    global mean token loss, aux, grad norm, each gradient leaf (the first
    moment ``mu`` = 0.1 x the clipped gradient) at
    tests/test_torch_training.py's bounds, and the parameters (AdamW's
    first step moves each by lr (+-1 + wd p), so they differ by at most
    2 lr); the state stays laid out by the parameters' specs. A case whose
    forward routes a near tie the other way (:func:`_flips`) is held at
    the bounds those tokens allow (measured on granite 2 x 2, 6 of 64
    tokens reached: loss 2.1e-3 and aux 3.7e-3 apart, the MoE leaves'
    gradients 0.30 / 0.958)."""
    flips = port_runs(tag, name, shape)[3]
    cfg, tp, mesh, sp, batch = _port_case(name, shape)
    opt = AdamW()
    state = {"params": sp, "opt_state": opt.init(sp),
             "step": torch.zeros((), dtype=torch.int32)}
    step = ts.make_train_step(cfg, opt, constrain=tsh.make_constrain(mesh),
                              mesh=mesh, moe_groups=mesh.size)
    state, m = step(state, batch)
    pre = f"{tag}/step"
    tol, g_rel, g_cos = (1e-2, 0.5, 0.95) if flips else (5e-4, 5e-2, 0.999)
    assert abs(float(m["loss"]) - float(ref[pre + "/loss"])) <= tol
    assert abs(float(m["aux"]) - float(ref[pre + "/aux"])) <= tol
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ref[pre + "/grad_norm"]), rtol=1e-2)
    for tree in (state["params"], state["opt_state"]["mu"]):
        assert all(isinstance(x, tsh.Sharded)
                   for x in tparams.leaves(tree, torch.is_tensor))
    got = tckpt._flatten(state)
    for k in tckpt._flatten(tp):
        want = ref[f"{pre}/mu/{k}"]
        if not want.any():
            assert not got[f"opt_state/mu/{k}"].any(), k
        else:
            rel, cos = _rel(got[f"opt_state/mu/{k}"], want)
            assert rel <= g_rel and cos >= g_cos, (k, rel, cos)
        d = np.abs(got[f"params/{k}"] - ref[f"{pre}/params/{k}"]).max()
        assert d <= 2 * opt.lr * 1.001, (k, d)
    assert int(state["step"]) == 1


@pytest.mark.parametrize("tag,name,shape,mg_odd", CASES)
def test_mesh_prefill_decode_matches_reference(ref, tag, name, shape,
                                               mg_odd):
    """Prefill on the mesh (the island where it divides) and two decode
    steps (the global dispatch) over the data groups' caches, fed the
    reference's greedy tokens: each step's routing held as :func:`_flips`
    says, its logits within the bounds and the port's own greedy token
    equal wherever the reference's top-2 gap exceeds twice the bound on
    one logit, over the rows no routing flip so far reaches."""
    cfg, _, mesh, sp, batch = _port_case(name, shape)
    cons = tsh.make_constrain(mesh)
    pre = ts.make_prefill_step(cfg, constrain=cons, moe_groups=mesh.size,
                               mesh=mesh)
    dec = ts.make_decode_step(cfg, constrain=cons, mesh=mesh)
    pb = {"tokens": batch["tokens"]}
    if "cross_src" in batch:
        pb["cross_src"] = batch["cross_src"]
    hit = np.zeros(B, bool)                 # rows a flip has reached

    def routed(rec, prefix, slots, rows, seq):
        if cfg.n_experts:
            mask = _flips(ref, prefix, rec.dispatch, slots, rows, seq,
                          cfg, hit)[0]
            hit[mask.any(-1)] = True
        else:
            assert not rec.dispatch

    with _Recorder() as rec:
        lg, cache = pre(sp, pb)
    routed(rec, f"{tag}/prefill", mesh.slots(), B // shape[0], S)
    assert isinstance(cache, list) and len(cache) == shape[0]
    want = ref[f"{tag}/prefill/logits"]
    checked = []
    for n in range(N_DEC + 1):
        keep = ~hit
        assert keep.any(), (tag, n)
        _close_where(lg, want, keep, MEAN_REL, MAX_REL)
        top2 = np.sort(want, -1)[:, -2:]
        # two logits may each move by the bound
        sure = (top2[:, 1] - top2[:, 0]
                > 2 * MAX_REL * np.abs(want).mean()) & keep
        mine = lg.argmax(-1).numpy()
        np.testing.assert_array_equal(mine[sure], want.argmax(-1)[sure],
                                      err_msg=f"{tag} step {n}")
        checked.append(int(sure.sum()))
        if n == N_DEC:
            break
        tok = torch.from_numpy(ref[f"{tag}/decode/{n}/tokens"])
        with _Recorder() as rec:
            lg, cache = dec(sp, cache, tok, torch.full((B,), S + n))
        routed(rec, f"{tag}/decode/{n}", [(0, 0)], B, 1)
        want = ref[f"{tag}/decode/{n}/logits"]
    assert sum(checked) > 0, checked


def test_island_taken_under_the_reference_condition(monkeypatch):
    """``apply_block``'s MoE takes the island exactly when there is a mesh
    and ``B % max(moe_groups, 1) == 0`` (``moe_groups`` 0 counts as 1);
    the decode step never takes it."""
    cfg = reduced(get_config(GRANITE))
    P = tparams.init_params(tm.model_template(cfg),
                            torch.Generator().manual_seed(4), device="cpu")
    mesh = tmesh.make_local_mesh(2, 1, device="cpu")
    calls = []
    inner = tl._moe_island
    monkeypatch.setattr(tl, "_moe_island",
                        lambda *a: calls.append(1) or inner(*a))
    toks = torch.randint(0, 256, (4, 8), generator=torch.Generator()
                         .manual_seed(5))
    for b, mg, island in ((4, 4, True), (4, 1, True), (4, 0, True),
                          (2, 4, False), (4, 3, False), (2, 2, True)):
        calls.clear()
        tm.forward(P, cfg, toks[:b], mesh=mesh, moe_groups=mg)
        assert len(calls) == (cfg.n_layers if island else 0), (b, mg)
    calls.clear()
    tm.forward(P, cfg, toks, moe_groups=4)
    assert not calls
    _, cache = ts.make_prefill_step(cfg, mesh=mesh, moe_groups=2)(
        P, {"tokens": toks})
    calls.clear()
    ts.make_decode_step(cfg, mesh=mesh)(P, cache, toks[:, :1],
                                        torch.full((4,), 8))
    assert not calls
    with pytest.raises(ValueError, match="does not split over data=2"):
        tm.forward(P, cfg, toks[:3], mesh=mesh)


# ------------------------------------------------------ port-internal ----

@pytest.mark.parametrize("name,mg", [(RGEMMA, 1), (WHISPER, 1),
                                     (GRANITE, 3)])
def test_one_slot_mesh_is_bit_equal_to_no_mesh(name, mg):
    """On a 1 x 1 mesh the forward, a train step (parameters, moments,
    metrics) and prefill + decode equal the one-device calls bit for bit
    (the MoE at a ``moe_groups`` the batch does not divide: the island's
    rounding of the route weights is the reference's other function)."""
    cfg = reduced(get_config(name))
    mk = lambda: tparams.init_params(tm.model_template(cfg),
                                     torch.Generator().manual_seed(9),
                                     device="cpu")
    mesh = tmesh.make_local_mesh(1, 1, device="cpu")
    rng = np.random.default_rng(10)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 9)).astype(np.int64))
    batch = {"tokens": toks[:, :8], "targets": toks[:, 1:].clone()}
    batch["targets"][1, :3] = -1
    if cfg.is_encoder_decoder:
        batch["cross_src"] = torch.from_numpy(rng.normal(
            size=(2, 16, 64)).astype(np.float32)).to(BF)
    cs = batch.get("cross_src")
    a = tm.forward(mk(), cfg, batch["tokens"], cross_src=cs)
    b = tm.forward(mk(), cfg, batch["tokens"], cross_src=cs, mesh=mesh,
                   moe_groups=mg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    opt = AdamW()
    states = []
    for m_ in (None, mesh):
        p = mk() if m_ is None else tsh.put(mk(), tsh.param_pspecs(
            tm.model_template(cfg), mesh), mesh)
        st = {"params": p, "opt_state": opt.init(p),
              "step": torch.zeros((), dtype=torch.int32)}
        step = ts.make_train_step(cfg, opt, mesh=m_, moe_groups=mg)
        for _ in range(2):
            st, met = step(st, batch)
        states.append((tckpt._flatten(st), met))
    (fa, ma), (fb, mb) = states
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    pb = {k: v for k, v in batch.items() if k != "targets"}
    la, ca = ts.make_prefill_step(cfg)(mk(), pb)
    lb, cb = ts.make_prefill_step(cfg, mesh=mesh, moe_groups=mg)(mk(), pb)
    assert torch.equal(la, lb)
    tok = la.argmax(-1)[:, None]
    da, _ = ts.make_decode_step(cfg)(mk(), ca, tok, torch.full((2,), 8))
    db, _ = ts.make_decode_step(cfg, mesh=mesh)(mk(), cb, tok,
                                                torch.full((2,), 8))
    assert torch.equal(da, db)


@pytest.mark.parametrize("name", [GRANITE, RGEMMA, WHISPER])
def test_remat_across_devices_matches_checkpoint(monkeypatch, name):
    """A mesh's train-mode remat is the single-node ``_Remat`` (PyTorch's
    checkpoint races between devices' autograd threads when a region
    spans cards). On the CPU, where PyTorch's checkpoint of the same
    group (put in its place here) has no race, the gradients are equal
    bit for bit, but for the encoder of an encoder-decoder, whose output
    each decoder group's node differentiates apart (bfloat16 sums in
    another grouping: within 1e-2 relative norm)."""
    cfg = reduced(get_config(name))
    mesh = tmesh.make_local_mesh(2, 1, device="cpu")
    mk = lambda: tsh.put(tparams.init_params(
        tm.model_template(cfg), torch.Generator().manual_seed(13),
        device="cpu"), tsh.param_pspecs(tm.model_template(cfg), mesh), mesh)
    rng = np.random.default_rng(14)
    toks = torch.from_numpy(rng.integers(0, 256, (4, 9)).astype(np.int64))
    batch = {"tokens": toks[:, :8], "targets": toks[:, 1:].clone()}
    if cfg.is_encoder_decoder:
        batch["cross_src"] = torch.from_numpy(rng.normal(
            size=(4, 16, 64)).astype(np.float32)).to(BF)
    remat_group = tm._remat_group

    def checkpointed(xs, aux, gp, group, cfg, ctxs, g, island, cons):
        xs, aux, _ = checkpoint(tm._run_group, xs, aux, gp, None, group,
                                cfg, ctxs, g, island, cons,
                                use_reentrant=False,
                                preserve_rng_state=False)
        return xs, aux

    grads = []
    for stand_in in (checkpointed, remat_group):
        monkeypatch.setattr(tm, "_remat_group", stand_in)
        flat, tree, _ = ts._grad_leaves(mk())
        total, _ = ts.make_loss_fn(cfg, mesh=mesh, moe_groups=4)(tree, batch)
        grads.append(torch.autograd.grad(total, flat))
    names = [k for k, x in tckpt._paths(tparams.abstract_params(
        tm.model_template(cfg))) for _ in range(mesh.size)]
    for k, a, b in zip(names, *grads):
        if cfg.is_encoder_decoder and k.startswith(("enc", "embed")):
            rel = float((a - b).norm() / b.norm())
            assert rel <= 1e-2, (k, rel)
        else:
            assert torch.equal(a, b), k


def test_mesh_loss_is_the_global_token_mean():
    """Data groups with unequal numbers of ignored targets: the mesh loss
    is the sum of every group's masked loss over every group's count (the
    one-device loss to rounding), not the mean of the group means."""
    mesh = tmesh.make_local_mesh(2, 1, device="cpu")
    g = torch.Generator().manual_seed(12)
    logits = torch.randn(4, 6, 32, generator=g)
    targets = torch.randint(0, 32, (4, 6), generator=g)
    targets[:2, :5] = -1                       # group 0 keeps 2 of 12
    whole = ts.softmax_xent(logits, targets)
    got = ts.mesh_xent([logits[:2], logits[2:]], targets, mesh)
    np.testing.assert_allclose(float(got), float(whole), rtol=1e-6)
    halves = (ts.softmax_xent(logits[:2], targets[:2])
              + ts.softmax_xent(logits[2:], targets[2:])) / 2
    assert abs(float(halves) - float(whole)) > 1e-2


def _trainer(tmp, cfg, mesh, steps=4):
    from repro_torch.data.corpus import CorpusConfig
    from repro_torch.training.trainer import TrainConfig, Trainer
    corpus = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=8,
                          global_batch=4)
    tc = TrainConfig(steps=steps, lr=1e-3, warmup=1, ckpt_dir=str(tmp),
                     ckpt_every=2, log_every=1, seed=2,
                     ckpt_background=False)
    return Trainer(cfg, corpus, tc, mesh=mesh, log=lambda *a: None,
                   device="cpu")


def test_trainer_on_mesh_restores_exactly_and_across_layouts(tmp_path):
    """``Trainer(mesh=...)`` with ``moe_groups`` = mesh size (a batch of 4
    on a 2 x 2 mesh takes the island; the reference's quirk): a crash at
    step 3 and a restore of the step-2 checkpoint end where the straight
    run does, bit for bit; the mesh checkpoint holds the gathered state in
    the one-device format, restores on one device and lays out again on a
    mesh of another shape."""
    cfg = reduced(get_config(GRANITE))
    mesh = tmesh.make_local_mesh(2, 2, device="cpu")
    t = _trainer(tmp_path / "a", cfg, mesh)
    assert t.step_fn is not None
    straight = tckpt._flatten(t.run())
    with pytest.raises(RuntimeError, match="injected"):
        _trainer(tmp_path / "b", cfg, mesh).run(fail_at_step=3)
    assert tckpt.latest_step(str(tmp_path / "b")) == 2
    resumed = _trainer(tmp_path / "b", cfg, mesh).run()
    assert tparams.leaves(resumed["params"], torch.is_tensor)[0].mesh is mesh
    resumed = tckpt._flatten(resumed)
    assert straight.keys() == resumed.keys()
    for k in straight:
        np.testing.assert_array_equal(straight[k], resumed[k], err_msg=k)
    one = _trainer(tmp_path / "a", cfg, None)
    s1, step = tckpt.restore(str(tmp_path / "a"), one.state_template(),
                             device="cpu")
    assert step == 4 and torch.is_tensor(s1["params"]["embed"])
    for k, v in tckpt._flatten(s1).items():
        np.testing.assert_array_equal(v, straight[k], err_msg=k)
    other = tmesh.make_local_mesh(1, 2, device="cpu")
    s2, _ = tckpt.restore(str(tmp_path / "a"), one.state_template(),
                          shardings=_trainer(tmp_path / "a", cfg,
                                             other).shardings(),
                          device="cpu")
    assert s2["params"]["embed"].mesh is other
    back = tckpt._flatten(s2)
    assert back.keys() == straight.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, straight[k], err_msg=k)


@pytest.mark.parametrize("rows,island", [(2, False), (4, True)])
def test_trainer_moe_groups_is_the_mesh_size(monkeypatch, rows, island):
    """The Trainer's step takes ``moe_groups`` = ``mesh.size`` (the
    reference's ``mesh.devices.size``: every slot, not the data groups),
    so on a 2 x 2 mesh a batch of 2 rows falls back to the global dispatch
    and a batch of 4 takes the island."""
    from repro_torch.data.corpus import CorpusConfig
    from repro_torch.training.trainer import TrainConfig, Trainer
    cfg = reduced(get_config(GRANITE))
    mesh = tmesh.make_local_mesh(2, 2, device="cpu")
    calls = []
    inner = tl._moe_island
    monkeypatch.setattr(tl, "_moe_island",
                        lambda *a: calls.append(1) or inner(*a))
    corpus = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=8,
                          global_batch=rows)
    Trainer(cfg, corpus, TrainConfig(steps=1, log_every=1), mesh=mesh,
            log=lambda *a: None, device="cpu").run()
    assert len(calls) == (2 * cfg.n_layers if island else 0)   # + remat


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    reference(sys.argv[2])
