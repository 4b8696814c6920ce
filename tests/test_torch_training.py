"""The port's training path against the JAX package, on the CPU: the token
cross entropy, loss and gradients of a reduced recurrentgemma-2b, AdamW and
its schedule, the corpus and its loader, gradient compression, checkpoints
(interchangeable with the reference's), the trainer's restart and the
launcher.

Inputs are made from a seed with numpy; the reference's parameters are
drawn inside ``jax.threefry_partitionable(False)`` and carried across with
``params_from_numpy``. Tolerances:
- loss and gradients of the reduced model (B = 2, S = 32, 3 or 5 layers,
  one target ignored) against ``jax.value_and_grad`` of the reference's
  loss, per leaf: relative error ||g - g_ref|| / ||g_ref|| and cosine.
  Both run the model in bfloat16 with float32 masters; against the
  reference run op by op (``jax.disable_jit``, attention ``direct``, whose
  rounding of p the port's plain attention shares) the worst leaf
  measured 2.1e-2 and cosine 0.99979, the loss 5.2e-5 apart (against
  ``flash_xla``, when the port kept p in float32): held at 5e-2, 0.999
  and 5e-4. Jitted, XLA's fused blocks round
  bfloat16 otherwise (ROADMAP C8): measured 4.8e-2, 0.99887 and 4.4e-4,
  held at 0.1, 0.995 and 2e-3;
- AdamW and the cosine schedule on identical gradients: 1e-6 (the same
  float32 ops in the same order; libm's cos and pow may differ in the last
  bit);
- the corpus, compression's int8 values and checkpoints: equal.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.data import corpus as jcorpus  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import stepfn as jstep  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.trainer import Trainer as JTrainer  # noqa: E402
from repro.training.trainer import TrainConfig as JTrainConfig  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import corpus as tcorpus  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import stepfn as ts  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params, leaves, params_from_numpy,
)
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training.optimizer import AdamW, cosine_schedule  # noqa: E402
from repro_torch.training.trainer import TrainConfig, Trainer  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402

RG = "recurrentgemma-2b"
ROOT = Path(__file__).resolve().parents[1]


def _configs(n_layers):
    return (dataclasses.replace(jreduced(jget_config(RG)), n_layers=n_layers),
            dataclasses.replace(reduced(get_config(RG)), n_layers=n_layers))


_PARAMS = {}


def _ref_params(n_layers):
    if n_layers not in _PARAMS:
        jcfg, _ = _configs(n_layers)
        with jax.threefry_partitionable(False):
            P = jinit(jm.model_template(jcfg), jax.random.key(11))
        _PARAMS[n_layers] = (P, jax.tree_util.tree_map(np.asarray, P))
    return _PARAMS[n_layers]


def _batch(B=2, S=32, seed=0):
    tok = np.random.default_rng(seed).integers(0, 256, (B, S + 1)
                                               ).astype(np.int32)
    batch = {"tokens": tok[:, :-1].copy(), "targets": tok[:, 1:].copy()}
    batch["targets"][0, 3] = -1                    # one ignored target
    return batch


# ------------------------------------------------------------ the loss ----

def test_softmax_xent_masks_ignore_tokens():
    """tests/test_models.py::test_xent_masks_ignore_tokens, mirrored."""
    logits = torch.zeros((1, 4, 8))
    targets = torch.tensor([[1, 2, -1, -1]])
    loss = ts.softmax_xent(logits, targets)
    assert abs(float(loss) - np.log(8)) < 1e-5
    assert float(ts.softmax_xent(logits, torch.full((1, 4), -1))) == 0.0


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 7, 50)) * 3).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    targets[1, :4] = -1
    want = float(jstep.softmax_xent(jnp.asarray(logits),
                                    jnp.asarray(targets)))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = ts.softmax_xent(x, torch.from_numpy(targets))
    assert abs(got.item() - want) < 1e-5
    (g,) = torch.autograd.grad(got, x)
    gj = jax.grad(lambda z: jstep.softmax_xent(z, jnp.asarray(targets)))(
        jnp.asarray(logits))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-7,
                               rtol=1e-5)
    assert bool((g[1, :4] == 0).all())


# ----------------------------------------------- loss and gradients ----

def _ref_grads(jcfg, P, batch, remat, mb, jit):
    """The reference's loss and gradients, microbatches averaged as its
    scan does (float32 zeros + each, divided by the count)."""
    impl = "auto" if jit else "direct"
    f = jax.value_and_grad(jstep.make_loss_fn(jcfg, remat=remat,
                                              attn_impl=impl), has_aux=True)
    if jit:
        f = jax.jit(f)
    B = batch["tokens"].shape[0]
    acc, loss = None, np.float32(0)
    for i in range(mb):
        b = {k: jnp.asarray(v.reshape((mb, B // mb) + v.shape[1:])[i])
             for k, v in batch.items()}
        if jit:
            (_, m), g = f(P, b)
        else:
            with jax.disable_jit():
                (_, m), g = f(P, b)
        g = [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]
        acc = g if acc is None else [a + x for a, x in zip(acc, g)]
        loss = loss + np.float32(m["loss"])
    return [a / np.float32(mb) for a in acc], float(loss / np.float32(mb))


def _port_grads(tcfg, Pn, batch, remat, mb):
    """The port's train step on carried parameters; its gradients as the
    grad_transform hook sees them (copied: the optimizer clips in place)."""
    tp = params_from_numpy(Pn, device="cpu")
    seen = {}

    def capture(g):
        seen["g"] = [x.clone().numpy() for x in leaves(g, torch.is_tensor)]
        return g
    opt = AdamW()
    step = ts.make_train_step(tcfg, opt, microbatches=mb, remat=remat,
                              grad_transform=capture)
    state = {"params": tp, "opt_state": opt.init(tp),
             "step": torch.zeros((), dtype=torch.int32)}
    _, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return seen["g"], float(m["loss"]), m


@pytest.mark.parametrize("n_layers,remat,mb,jit", [
    (3, False, 1, False), (3, True, 2, False),
    (5, True, 1, True), (5, False, 2, True)])
def test_loss_and_grads_match_reference(n_layers, remat, mb, jit):
    jcfg, tcfg = _configs(n_layers)
    P, Pn = _ref_params(n_layers)
    batch = _batch()
    want_g, want_l = _ref_grads(jcfg, P, batch, remat, mb, jit)
    got_g, got_l, m = _port_grads(tcfg, Pn, batch, remat, mb)
    # the port's remat is exact: the other setting gives the same numbers
    other, other_l, _ = _port_grads(tcfg, Pn, batch, not remat, mb)
    assert other_l == got_l and all(np.array_equal(a, b)
                                    for a, b in zip(other, got_g))
    rel_max, cos_min, dl_max = (0.1, 0.995, 2e-3) if jit else \
        (5e-2, 0.999, 5e-4)
    assert abs(got_l - want_l) <= dl_max, (got_l, want_l)
    assert len(got_g) == len(want_g)
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        assert a.shape == b.shape and a.dtype == np.float32
        nb = np.linalg.norm(b)
        rel = np.linalg.norm(a - b) / nb
        cos = float((a * b).sum() / (np.linalg.norm(a) * nb))
        assert rel <= rel_max and cos >= cos_min, (i, a.shape, rel, cos)
    gn = float(m["grad_norm"])
    want_gn = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                for g in want_g)))
    assert abs(gn - want_gn) <= rel_max * want_gn


def test_forward_remat_is_exact_and_flows():
    _, tcfg = _configs(5)
    _, Pn = _ref_params(5)
    toks = torch.from_numpy(_batch()["tokens"])
    outs = []
    for remat in (False, True):
        p = params_from_numpy(Pn, device="cpu")
        ps = leaves(p, torch.is_tensor)
        for t in ps:
            t.requires_grad_(True)
        y = tm.forward(p, tcfg, toks, remat=remat)[0]
        g = torch.autograd.grad(y.square().mean(), ps)
        outs.append((y.detach(), g))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    assert all(float(x.abs().max()) > 0 for x in outs[0][1])


def test_memorises_a_fixed_batch():
    """tests/test_models.py::test_training_reduces_loss, mirrored on the
    reduced recurrentgemma-2b: 30 AdamW steps on one batch."""
    cfg = reduced(get_config(RG))
    params = init_params(tm.model_template(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    opt = AdamW(lr=3e-3)
    state = {"params": params, "opt_state": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = ts.make_train_step(cfg, opt)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 32)))
    batch = {"tokens": tokens, "targets": tokens}
    losses = []
    for _ in range(30):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert int(state["step"]) == 30
    assert losses[-1] < losses[0] * 0.7, losses[::10]


# ------------------------------------------------------------ AdamW ----

def test_adamw_and_schedule_match_reference():
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)},
            "t": (rng.normal(size=(2, 2)).astype(np.float32),)}
    sched_j = jopt.cosine_schedule(1e-2, 2, 6)
    sched_t = cosine_schedule(1e-2, 2, 6)
    for s in range(9):
        np.testing.assert_allclose(float(sched_t(torch.tensor(s))),
                                   float(sched_j(jnp.asarray(s))),
                                   rtol=1e-6, atol=1e-9)
    jo = jopt.AdamW(lr=1e-2, schedule=sched_j)
    to = AdamW(lr=1e-2, schedule=sched_t)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = jax.tree_util.tree_map(lambda x: torch.from_numpy(x.copy()), tree)
    js, tst = jo.init(jp), to.init(tp)
    for step in range(6):
        scale = 0.3 if step % 2 else 5.0           # clipped and not
        g = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) * scale).astype(np.float32),
            tree)
        upd, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax.tree_util.tree_map(jnp.add, jp, upd)
        tst, gn = to.update_(jax.tree_util.tree_map(
            lambda x: torch.from_numpy(x.copy()), g), tst, tp)
        np.testing.assert_allclose(
            float(gn), float(jo.global_norm(jax.tree_util.tree_map(
                jnp.asarray, g))), rtol=1e-6)
        for a, b in zip(leaves(tp, torch.is_tensor) +
                        leaves(tst["mu"], torch.is_tensor) +
                        leaves(tst["nu"], torch.is_tensor),
                        jax.tree_util.tree_leaves(jp) +
                        jax.tree_util.tree_leaves(js["mu"]) +
                        jax.tree_util.tree_leaves(js["nu"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        assert int(tst["count"]) == int(js["count"]) == step + 1


# ------------------------------------------------- corpus and loader ----

@pytest.mark.parametrize("kw,step", [
    (dict(vocab_size=256, seq_len=32, global_batch=2, seed=0), 0),
    (dict(vocab_size=256000, seq_len=512, global_batch=4), 3),
    (dict(vocab_size=64, seq_len=8, global_batch=8, seed=7, n_shards=2,
          shard_id=1), 5)])
def test_make_batch_bit_equal_to_reference(kw, step):
    got = tcorpus.make_batch(tcorpus.CorpusConfig(**kw), step)
    want = jcorpus.make_batch(jcorpus.CorpusConfig(**kw), step)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_straggler_mitigation():
    """tests/test_training.py::test_prefetch_straggler_mitigation,
    mirrored: a hung fetch is beaten by its speculative duplicate."""
    calls = {"n": 0}

    def flaky_fetch(step):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(3.0)     # the straggler
        return {"x": np.full((2,), step)}

    c = tcorpus.CorpusConfig(vocab_size=8, seq_len=4, global_batch=2)
    loader = tcorpus.PrefetchLoader(c, fetch=flaky_fetch,
                                    straggler_timeout=0.15, depth=1)
    t0 = time.time()
    batch = next(loader)
    dt = time.time() - t0
    loader.stop()
    assert dt < 2.5                      # did not wait for the straggler
    assert loader.n_duplicates >= 1
    assert batch["x"].shape == (2,)


def test_prefetch_starts_at_its_step():
    c = tcorpus.CorpusConfig(vocab_size=64, seq_len=8, global_batch=2,
                             seed=4)
    loader = tcorpus.PrefetchLoader(c, start_step=5)
    try:
        for step in (5, 6):
            got = next(loader)
            np.testing.assert_array_equal(
                got["tokens"], tcorpus.make_batch(c, step)["tokens"])
    finally:
        loader.stop()


# ------------------------------------------------------ compression ----

def test_compression_matches_reference():
    rng = np.random.default_rng(9)
    g = (rng.normal(size=(6, 33)) * 0.1).astype(np.float32)
    g[0, 0] = 0.0125                               # a rounding tie region
    q, s = tcomp.quantize_int8(torch.from_numpy(g))
    qj, sj = jcomp.quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    assert float(s) == float(sj)
    np.testing.assert_array_equal(
        tcomp.dequantize_int8(q, s).numpy(),
        np.asarray(jcomp.dequantize_int8(qj, sj)))
    tree = {"w": g, "b": (g[0] * 3,)}
    got = tcomp.compress_tree(jax.tree_util.tree_map(torch.from_numpy, tree))
    want = jcomp.compress_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    for a, b in zip(leaves(got, torch.is_tensor),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # (the reference's error feedback takes every tuple for its own
    # (compressed, residual) pair, so its tree holds no tuple here)
    tree = {"w": g, "b": g[0] * 3}
    init_t, tf_t = tcomp.make_error_feedback()
    init_j, tf_j = jcomp.make_error_feedback()
    rt = init_t(jax.tree_util.tree_map(torch.from_numpy, tree))
    rj = init_j(jax.tree_util.tree_map(jnp.asarray, tree))
    for _ in range(2):
        ct, rt = tf_t(jax.tree_util.tree_map(torch.from_numpy, tree), rt)
        cj, rj = tf_j(jax.tree_util.tree_map(jnp.asarray, tree), rj)
        for a, b in zip(leaves(ct, torch.is_tensor) + leaves(rt,
                                                             torch.is_tensor),
                        jax.tree_util.tree_leaves(cj)
                        + jax.tree_util.tree_leaves(rj)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)


def _mini(tmp_path, **kw):
    cfg = reduced(get_config(RG))
    corpus = tcorpus.CorpusConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=4, seed=1)
    tc = TrainConfig(steps=12, ckpt_dir=str(tmp_path / "ckpt"),
                     ckpt_every=5, ckpt_background=False, log_every=100,
                     microbatches=2, **kw)
    return Trainer(cfg, corpus, tc, log=lambda *a: None, device="cpu")


def test_compression_trains(tmp_path):
    t = _mini(tmp_path, compression=True)
    state = t.run()
    assert int(state["step"]) == 12
    losses = [m["loss"] for _, m in t.metrics_log]
    assert losses and all(np.isfinite(x) for x in losses)


# ------------------------------------------------------ checkpoints ----

def test_checkpoint_roundtrip(tmp_path):
    """tests/test_training.py::test_checkpoint_roundtrip, mirrored."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32),
                  "d": (torch.zeros(()), torch.full((2,), 7.0))}}
    tckpt.save(str(tmp_path), 3, tree)
    assert tckpt.latest_step(str(tmp_path)) == 3
    template = jax.tree_util.tree_map(
        lambda x: torch.empty(x.shape, device="meta"), tree)
    restored, step = tckpt.restore(str(tmp_path), template, device="cpu")
    assert step == 3
    for a, b in zip(leaves(tree, torch.is_tensor),
                    leaves(restored, torch.is_tensor)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert tckpt.restore(str(tmp_path / "none"), template,
                         device="cpu") == (None, None)


def test_checkpoints_interchange_with_reference(tmp_path):
    """The trainer's state has the reference's keys, shapes and dtypes;
    a checkpoint the reference writes restores in the port and one the
    port writes restores in the reference."""
    jcfg, tcfg = _configs(3)
    corpus = jcorpus.CorpusConfig(vocab_size=256, seq_len=16,
                                  global_batch=2)
    jt = JTrainer(jcfg, corpus, JTrainConfig(steps=1), log=lambda *a: None)
    with jax.threefry_partitionable(False):
        jstate = jt.init_state()
    tt = Trainer(tcfg, tcorpus.CorpusConfig(vocab_size=256, seq_len=16,
                                            global_batch=2),
                 TrainConfig(steps=1), log=lambda *a: None, device="cpu")
    tstate = tt.init_state()
    jflat, tflat = jckpt._flatten(jstate), tckpt._flatten(tstate)
    assert sorted(jflat) == sorted(tflat)
    assert "params/groups/2/attn/wq" in tflat and "step" in tflat
    assert "opt_state/mu/embed" in tflat and "opt_state/count" in tflat
    for k in jflat:
        assert jflat[k].shape == tflat[k].shape, k
        assert jflat[k].dtype == tflat[k].dtype, k
    jckpt.save(str(tmp_path / "ref"), 7, jstate)
    got, step = tckpt.restore(str(tmp_path / "ref"), tt.state_template(),
                              device="cpu")
    assert step == 7
    for k, v in tckpt._flatten(got).items():
        np.testing.assert_array_equal(v, jflat[k])
    tckpt.save(str(tmp_path / "port"), 2, tstate)
    back, step = jckpt.restore(str(tmp_path / "port"),
                               jax.eval_shape(jt.init_state))
    assert step == 2
    for k, v in jckpt._flatten(back).items():
        np.testing.assert_array_equal(v, tflat[k])


# ----------------------------------------------------------- trainer ----

def test_trainer_checkpoint_restart_exact(tmp_path):
    """tests/test_training.py::test_trainer_checkpoint_restart_exact,
    mirrored and held bitwise: the loader starts at the restored step, so
    the resumed run ends where the straight run does."""
    t1 = _mini(tmp_path)
    s_full = t1.run()                       # 12 steps straight through
    t2 = _mini(tmp_path / "b")
    with pytest.raises(RuntimeError):
        t2.run(fail_at_step=7)              # crash at step 7 (ckpt at 5)
    assert tckpt.latest_step(str(tmp_path / "b" / "ckpt")) == 5
    t3 = _mini(tmp_path / "b")
    s_resumed = t3.run()                    # restore at 5, finish to 12
    assert int(s_resumed["step"]) == 12
    full = tckpt._flatten(s_full)
    resumed = tckpt._flatten(s_resumed)
    assert full.keys() == resumed.keys()
    for k in full:
        np.testing.assert_array_equal(full[k], resumed[k], err_msg=k)


def test_param_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs(3)
    _, Pn = _ref_params(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(tm.model_template(tcfg), torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(Pn)
    corpus = tcorpus.CorpusConfig(vocab_size=256, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tcfg, corpus, TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tckpt.restore(str(tmp_path), {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tcfg, corpus, TrainConfig(steps=1),
                mesh=make_local_mesh(2, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_cache(tcfg, 2, 8)


def test_launch_train_reduced_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "2", "--seq", "16", "--batch", "2", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[trainer] step     1 loss" in out.stdout
