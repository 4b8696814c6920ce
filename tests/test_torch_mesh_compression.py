"""Gradient compression on a mesh: the port's ``compress_tree`` on
``Sharded`` gradients, the compressed mesh train step and the mesh
``Trainer(compression=True)``, against the port's own whole-tensor
compression and against the reference's mesh trainer on the CPU.

``compress_tree`` of a Sharded leaf takes the whole tensor's scale (the
largest |g| over the distinct shards) and QDQs every slot's piece with it,
so gathered it equals the whole tensor's compression bit for bit.

The reference's side runs as ``python tests/test_torch_mesh_compression.py
--reference OUT`` with the 4 forced host devices and the bfloat16
rounding flag of ``tests/test_torch_lm_mesh.py``: one step of its
``Trainer(mesh=make_local_mesh(2, 2), TrainConfig(compression=True))``
(the jitted step with ``compress_tree`` as its ``grad_transform``) on a
reduced dense architecture, h2o-danube-1.8b (no MoE, so no near-tie
routing flips; ROADMAP C17), from parameters drawn inside
``jax.threefry_partitionable(False)``. The port's trainer runs the same
step on the same parameters and batch. Bounds, those of
``test_mesh_train_step_matches_reference``: loss and aux within 5e-4,
grad norm rtol 1e-2, the first moment (0.1 x the clipped compressed
gradient) per leaf within relative norm 5e-2 and cosine 0.999, the
parameters within 2 lr (measured: the first moments 2.0e-2 to 2.6e-2
apart, cosine >= 0.99966). The int8 levels are read back from each
leaf's first moment (127 mu / max |mu|), and the uncompressed gradients
from an uncompressed step on each side: GSPMD's tensor-parallel partial
sums round the reference's gradient otherwise than the port's (C17), so
where the two gradients lie within half a level of each other, one that
sits near a rounding midpoint lands one level over. Those one-level
flips are counted and bounded, and none moves by more than one level.
"""
import os
import pathlib
import subprocess
import sys

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

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.corpus import CorpusConfig  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import stepfn as ts  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.trainer import TrainConfig, Trainer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
DANUBE, GRANITE = "h2o-danube-1.8b", "granite-moe-3b-a800m"
B, S, SEED = 4, 16, 11
LR = 1e-3


def case_inputs(seed=7):
    """B x S tokens and targets, data group 0 ignoring more targets."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :S], "targets": toks[:, 1:].copy()}
    batch["targets"][0, 2:9] = -1
    batch["targets"][3, 5] = -1
    return batch


def ref_params():
    cfg = jbase.reduced(jreg.get_config(DANUBE))
    with jax.threefry_partitionable(False):
        return cfg, jparams.init_params(jm.model_template(cfg),
                                        jax.random.key(SEED))


def train_config(**kw):
    return dict(dict(steps=4, lr=LR, warmup=1, compression=True,
                     log_every=1), **kw)


# ------------------------------------------- the reference's mesh run ----

def reference(out):
    """One step of the reference's compressed mesh Trainer (this process
    sees 4 host devices); writes metrics, parameters and first moments."""
    from jax.sharding import NamedSharding
    from repro.data.corpus import CorpusConfig as JCorpus
    from repro.distributed import sharding as jsh
    from repro.launch.mesh import make_local_mesh
    from repro.training.checkpoint import _flatten
    from repro.training.trainer import TrainConfig as JTC
    from repro.training.trainer import Trainer as JTrainer

    cfg, P_ = ref_params()
    mesh = make_local_mesh(2, 2)
    Ps = jax.device_put(P_, jsh.named(
        jsh.param_pspecs(jm.model_template(cfg), mesh), mesh))
    specs = jsh.input_pspecs(cfg, "train", mesh)
    batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, specs[k]))
             for k, v in case_inputs().items()}
    res = {}
    for tag, compression in (("c", True), ("u", False)):
        tr = JTrainer(cfg, JCorpus(vocab_size=cfg.vocab_size, seq_len=S,
                                   global_batch=B),
                      JTC(**train_config(compression=compression)),
                      mesh=mesh, constrain=jsh.make_constrain(mesh),
                      log=lambda *a: None)
        state = {"params": Ps, "opt_state": tr.opt.init(Ps),
                 "step": jnp.zeros((), jnp.int32)}
        state, m = tr.step_fn(state, batch)
        res.update({f"{tag}/m/{k}": np.asarray(v) for k, v in m.items()})
        for k, v in _flatten({"params": state["params"],
                              "mu": state["opt_state"]["mu"]}).items():
            res[f"{tag}/{k}"] = v
    np.savez(out, **res)


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's subprocess, started with the module's first test so
    that it runs while the tests that do not read it do."""
    tmp = tmp_path_factory.mktemp("mesh_compression")
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


# ------------------------------------------------- compress_tree ----

MESH = tmesh.make_local_mesh(2, 2, device="cpu")


def _leaf(shape, seed, dtype=torch.float32, peak=None):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 1e-3
    if peak is not None:
        x[peak] = -0.5                      # the largest |g|, negative
    return x.to(dtype)


# (spec, where the largest |g| lies, dtype): over data, model, both and
# none; the peak in a region that data (or model, or both) replicates
CASES = [(P("data", None), (3, 5), torch.float32),
         (P(None, "model"), (0, 1), torch.float32),
         (P("data", "model"), (1, 4), torch.float32),
         (P(None, None), (2, 2), torch.float32),
         (P(("data", "model"), None), (0, 0), torch.float32),
         (P(None, "model"), (3, 4), torch.bfloat16),
         (P("data", None), None, torch.float32)]


@pytest.mark.parametrize("spec,peak,dtype", CASES,
                         ids=[f"{i}" for i in range(len(CASES))])
def test_compress_tree_on_sharded_equals_whole(spec, peak, dtype):
    """``compress_tree`` of Sharded leaves keeps the layout, every slot's
    piece stays on its slot, and gathered it equals ``compress_tree`` of
    the whole tensors bit for bit (the scale from the largest |g| over the
    distinct shards, wherever it lies); replicas stay equal."""
    x = _leaf((4, 6), 1, dtype, peak)
    tree = {"a": x, "b": (_leaf((8,), 2), _leaf((4, 6), 3, dtype))}
    specs = {"a": spec, "b": (P("data"), spec)}
    got = tcomp.compress_tree(tsh.put(tree, specs, MESH))
    want = tcomp.compress_tree(tree)
    for g_, w, s in zip(tparams.leaves(got, torch.is_tensor),
                        tparams.leaves(want, torch.is_tensor),
                        tparams.leaves(specs, tsh.is_spec)):
        assert isinstance(g_, tsh.Sharded) and g_.spec == s
        assert g_.dtype == w.dtype
        assert all(g_.pieces[i][j].device == MESH.devices[i][j]
                   for i, j in MESH.slots())
        assert torch.equal(g_.full("cpu"), w)
        for i, j in MESH.slots():               # replicas included
            assert torch.equal(g_.pieces[i][j],
                               w[tsh._region(w.shape, s, MESH, i, j)])


def _grads_seen(monkeypatch):
    """Wrap ``compress_tree`` where the trainer and step take it: each call
    records (the gathered gradient before, the gathered compressed one)."""
    seen = []

    def wrapped(grads):
        before = tsh.gather(grads, "cpu")
        out = tcomp.compress_tree(grads)
        seen.append((before, tparams.tree_map(
            lambda x: x.clone(), tsh.gather(out, "cpu"),
            is_leaf=torch.is_tensor)))
        return out

    monkeypatch.setattr("repro_torch.training.trainer.compress_tree",
                        wrapped)
    return seen


def _check_compressed(seen):
    for before, after in seen:
        want = tcomp.compress_tree(before)
        for g, a, w in zip(tparams.leaves(before, torch.is_tensor),
                           tparams.leaves(after, torch.is_tensor),
                           tparams.leaves(want, torch.is_tensor)):
            assert torch.equal(a, w)
            scale = tcomp.int8_scale(g.float().abs().max())
            q = torch.round(a.float() / scale)
            assert torch.equal(q * scale, a.float())
            assert float(q.abs().max()) <= 127


def test_compressed_mesh_step_is_compress_tree_of_the_gathered_gradient(
        monkeypatch):
    """The compressed 2 x 2 step (reduced granite, the island): every
    compressed leaf gathered equals ``compress_tree`` of the gathered
    gradient bit for bit, and each element is an integer multiple of its
    leaf's scale within +-127; two runs are bit-equal."""
    seen = _grads_seen(monkeypatch)
    cfg = reduced(get_config(GRANITE))
    corpus = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=8,
                          global_batch=4)
    runs = []
    for _ in range(2):
        t = Trainer(cfg, corpus, TrainConfig(**train_config(seed=2)),
                    mesh=MESH, log=lambda *a: None, device="cpu")
        runs.append(tckpt._flatten(t.run(max_steps=2)))
    assert len(seen) == 4
    _check_compressed(seen)
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k], err_msg=k)


def test_one_slot_mesh_compressed_step_is_the_one_device_step():
    """On a 1 x 1 mesh the compressed step equals the one-device compressed
    step bit for bit (parameters, moments, metrics), two steps."""
    cfg = reduced(get_config(DANUBE))
    mesh = tmesh.make_local_mesh(1, 1, device="cpu")
    mk = lambda: tparams.init_params(tm.model_template(cfg),
                                     torch.Generator().manual_seed(9),
                                     device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in case_inputs().items()}
    out = []
    for m_ in (None, mesh):
        p = mk() if m_ is None else tsh.put(mk(), tsh.param_pspecs(
            tm.model_template(cfg), mesh), mesh)
        opt = AdamW()
        st = {"params": p, "opt_state": opt.init(p),
              "step": torch.zeros((), dtype=torch.int32)}
        step = ts.make_train_step(cfg, opt, mesh=m_,
                                  grad_transform=tcomp.compress_tree)
        for _ in range(2):
            st, met = step(st, batch)
        out.append((tckpt._flatten(st), met))
    (fa, ma), (fb, mb) = out
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def _levels(mu):
    """A gradient in int8 levels of its leaf's scale, from its first moment
    (a positive multiple of it): 127 mu / max |mu| (integers where the
    gradient was compressed)."""
    return 127 * mu.astype(np.float64) / np.abs(mu).max()


def _port_step(compression):
    """One step of the port's mesh Trainer on the reference's parameters:
    (metrics, flattened state, the parameters' flattened tree)."""
    _, P_ = ref_params()
    cfg = reduced(get_config(DANUBE))
    mesh = tmesh.make_local_mesh(2, 2, device="cpu")
    t = Trainer(cfg, CorpusConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B),
                TrainConfig(**train_config(compression=compression)),
                mesh=mesh, constrain=tsh.make_constrain(mesh),
                log=lambda *a: None, device="cpu")
    tp = tparams.params_from_numpy(jax.tree_util.tree_map(np.asarray, P_),
                                   device="cpu")
    sp = tsh.put(tp, tsh.param_pspecs(tm.model_template(cfg), mesh), mesh)
    state = {"params": sp, "opt_state": t.opt.init(sp),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = {k: torch.from_numpy(v) for k, v in case_inputs().items()}
    state, m = t.step_fn(state, batch)
    return m, tckpt._flatten(state), tckpt._flatten(tp)


def test_compressed_mesh_trainer_matches_reference(ref):
    """One step of the port's ``Trainer(mesh=2 x 2, compression=True)``
    against the reference's on the same parameters and batch, at the
    bounds of the module docstring. In levels of each leaf's scale: each
    side's compressed gradient is its own uncompressed gradient rounded
    (within half a level), and where the two sides' uncompressed gradients
    lie within half a level of each other their levels differ by at most
    one: a one-level flip at a rounding midpoint, in at most ``FLIP_FRAC``
    of those elements (measured 0.117: 10012 of 85211)."""
    m, got, keys = _port_step(True)
    _, got_u, _ = _port_step(False)
    assert abs(float(m["loss"]) - float(ref["c/m/loss"])) <= 5e-4
    assert abs(float(m["aux"]) - float(ref["c/m/aux"])) <= 5e-4
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ref["c/m/grad_norm"]), rtol=1e-2)
    n_flip = n_near = 0
    for k in keys:
        want, mine = ref[f"c/mu/{k}"], got[f"opt_state/mu/{k}"]
        d = np.abs(got[f"params/{k}"] - ref[f"c/params/{k}"]).max()
        assert d <= 2 * LR * 1.001, (k, d)
        if not want.any():
            assert not mine.any(), k
            continue
        rel = np.linalg.norm(mine - want) / np.linalg.norm(want)
        cos = float((mine * want).sum() / (np.linalg.norm(mine)
                                            * np.linalg.norm(want)))
        assert rel <= 5e-2 and cos >= 0.999, (k, rel, cos)
        q_p, q_r = _levels(mine), _levels(want)
        x_p = _levels(got_u[f"opt_state/mu/{k}"])
        x_r = _levels(ref[f"u/mu/{k}"])
        for q, x in ((q_p, x_p), (q_r, x_r)):
            assert np.abs(q - np.round(q)).max() <= 1e-3, k
            assert np.abs(q - x).max() <= 0.5 + 1e-3, k
        near = np.abs(x_p - x_r) < 0.5
        dq = np.abs(np.round(q_p) - np.round(q_r))[near]
        assert dq.max(initial=0) <= 1, (k, dq.max())
        n_flip += int((dq == 1).sum())
        n_near += int(near.sum())
    assert n_near > 0.5 * sum(got[f"opt_state/mu/{k}"].size for k in keys)
    assert n_flip <= FLIP_FRAC * n_near, (n_flip, n_near)


FLIP_FRAC = 0.15


def test_compressed_mesh_trainer_restores_exactly(tmp_path):
    """``Trainer(mesh=2 x 2, compression=True)`` on the CPU: a crash at step
    3 and a restore of the step-2 checkpoint end where the straight run
    does, bit for bit, and the compressed run differs from the
    uncompressed one."""
    cfg = reduced(get_config(GRANITE))
    corpus = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=8,
                          global_batch=4)

    def trainer(sub, compression=True):
        tc = TrainConfig(steps=4, lr=1e-3, warmup=1, ckpt_dir=str(
            tmp_path / sub), ckpt_every=2, log_every=1, seed=2,
            ckpt_background=False, compression=compression)
        return Trainer(cfg, corpus, tc, mesh=MESH, log=lambda *a: None,
                       device="cpu")

    straight = tckpt._flatten(trainer("a").run())
    with pytest.raises(RuntimeError, match="injected"):
        trainer("b").run(fail_at_step=3)
    assert tckpt.latest_step(str(tmp_path / "b")) == 2
    resumed = tckpt._flatten(trainer("b").run())
    assert straight.keys() == resumed.keys()
    for k in straight:
        np.testing.assert_array_equal(straight[k], resumed[k], err_msg=k)
    plain = tckpt._flatten(trainer("c", compression=False).run())
    assert any(not np.array_equal(plain[k], straight[k])
               for k in straight if k.startswith("params/"))


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    reference(sys.argv[2])
