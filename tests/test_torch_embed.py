"""The port's LM-feature path against the JAX package, on the CPU: the
synthetic corpus, the encoder over a reduced recurrentgemma-2b, the
LM-feature dataset and the learning front door with ``features.kind="lm"``.

The reference draws its corpus uniforms, model parameters and projection
with ``jax.random`` (inside ``jax.threefry_partitionable(False)``); the
tests hand those to the port (``u``/``ul``, ``params_from_numpy``,
``proj``), so both packages see the same inputs. Tolerances:
- tokens, lengths, labels, the tokenizer and the bank lookup: equal;
- features: the port's forward agrees with the reference's jitted forward
  to the bfloat16 tolerance of tests/test_torch_models.py (XLA's fused
  blocks round differently from the port's op-by-op ones), and pooling
  and the projection add only float32 rounding: mean |difference| within
  3e-2 and max within 0.3 of the mean |feature|;
- a row's features do not depend on how many tasks are encoded: equal.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import embed as jembed  # noqa: E402
from repro.embed import encoder as jenc  # noqa: E402
from repro.scenarios import get_scenario, override  # noqa: E402
from repro.scenarios.compile import to_embed_config  # noqa: E402
from repro_torch.embed import bank as tbank  # noqa: E402
from repro_torch.embed import corpus as tcorpus  # noqa: E402
from repro_torch.embed import encoder as tenc  # noqa: E402
from repro_torch.embed.config import EmbedConfig  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    get_learning_spec, run_learning,
)
from repro_torch.core import simfast as ts  # noqa: E402

RG = "recurrentgemma-2b"
# reduced recurrentgemma-2b (3 layers, window 8) at 16 tokens: the CPU tests
# run its sliding window
EC_KW = dict(model=RG, seq_len=16, bank_size=64, batch_size=32)
OVERRIDES = {"features.kind": "lm", "embed.model": RG, "embed.seq_len": 16,
             "embed.batch_size": 32}


def _close(got, want, mean_rel, max_rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d, scale = np.abs(got - want), np.abs(want).mean()
    assert got.shape == want.shape
    assert d.mean() <= mean_rel * scale and d.max() <= max_rel * scale, \
        (d.mean() / scale, d.max() / scale)


def _ref_draws(ec, N, n_features):
    """The reference's corpus uniforms, parameters and projection for
    ``ec``, as the port takes them."""
    with jax.threefry_partitionable(False):
        key = jax.random.key(ec.seed)
        u = np.asarray(jax.random.uniform(key, (3, N, ec.seq_len)))
        ul = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (N,)))
        P = jenc.model_params(ec)
        proj = np.asarray(jenc.projection(ec, n_features))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, P),
                               device="cpu")
    return dict(u=u, ul=ul, params=params, proj=torch.from_numpy(proj.copy()))


def _tasks(N, n_classes, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_classes, N).astype(np.int32),
            rng.random(N) < 0.3)


# ----------------------------------------------------------- corpus ----

@pytest.mark.parametrize("seed,C,sep,hs", [(0, 2, 1.8, 1.0), (7, 4, 3.0, 0.2),
                                           (3, 10, 5.0, 0.5)])
def test_make_tokens_bit_equal_on_injected_uniforms(seed, C, sep, hs):
    ec_j = jembed.EmbedConfig(**EC_KW, seed=seed)
    ec_t = EmbedConfig(**EC_KW, seed=seed)
    labels, hard = _tasks(50, C, seed)
    with jax.threefry_partitionable(False):
        tj, lj = jembed.make_tokens(ec_j, labels, hard, C, 256, sep, hs)
    d = _ref_draws(ec_j, 50, 8)
    tt, lt = tcorpus.make_tokens(ec_t, labels, hard, C, 256, sep, hs,
                                 u=d["u"], ul=d["ul"])
    np.testing.assert_array_equal(tt, np.asarray(tj))
    np.testing.assert_array_equal(lt, np.asarray(lj))
    assert tt.dtype == np.int32 and lt.dtype == np.int32


def test_make_tokens_own_draws():
    ec = EmbedConfig(**EC_KW)
    labels, hard = _tasks(400, 2, 1)
    t1, l1 = tcorpus.make_tokens(ec, labels, hard, 2, 256, 3.0, 0.2)
    t2, l2 = tcorpus.make_tokens(ec, labels, hard, 2, 256, 3.0, 0.2)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(l1, l2)
    assert t1.shape == (400, 16) and (t1 >= 0).all() and (t1 < 256).all()
    assert (l1 >= 8).all() and (l1 <= 16).all()
    assert (t1[np.arange(16)[None] >= l1[:, None]] == 0).all()
    # class c's signature block [128 + 8c, 136 + 8c) carries the signal,
    # more of it on easy tasks
    sig = (t1 >= 128 + 8 * labels[:, None]) & (t1 < 136 + 8 * labels[:, None])
    real = np.arange(16)[None] < l1[:, None]
    rate = lambda m: sig[m][real[m]].mean()
    assert rate(~hard) > 0.6 and rate(hard) < 0.3
    with pytest.raises(ValueError):
        tcorpus.make_tokens(ec, labels, hard, 20, 256, 3.0)


def test_signal_strength_and_tokenizer_match():
    for args in ((1.8,), (3.0, 0.1, True), (9.0, 0.5, False), (2.0, 0.3,
                                                               True)):
        assert tcorpus.signal_strength(*args) == \
            jembed.signal_strength(*args)
    for text in ("label this movie review", "", "a b c " * 20, "ünïcode"):
        tj, lj = jembed.tokenize_text(text, 16, 256)
        tt, lt = tcorpus.tokenize_text(text, 16, 256)
        np.testing.assert_array_equal(tt, tj)
        assert lt == lj


def test_embed_config_validation_matches():
    for bad in (dict(pooling="max"), dict(seq_len=3), dict(bank_size=1),
                dict(projection_dim=0), dict(batch_size=0)):
        with pytest.raises(ValueError) as ej:
            jembed.EmbedConfig(**bad)
        with pytest.raises(ValueError) as et:
            EmbedConfig(**bad)
        assert str(et.value) == str(ej.value)


# ---------------------------------------------------------- encoder ----

@pytest.mark.parametrize("pooling", ["mean", "last"])
def test_encode_matches_reference_with_carried_params(pooling):
    ec_j = jembed.EmbedConfig(**EC_KW, pooling=pooling, seed=5)
    ec_t = EmbedConfig(**EC_KW, pooling=pooling, seed=5)
    labels, hard = _tasks(40, 2, 5)
    d = _ref_draws(ec_j, 40, 8)
    tokens, lengths = tcorpus.make_tokens(ec_t, labels, hard, 2, 256, 3.0,
                                          u=d["u"], ul=d["ul"])
    with jax.threefry_partitionable(False):
        want = np.asarray(jembed.encode(ec_j, tokens, lengths, 8,
                                        shard=False))
    got = tenc.encode(ec_t, tokens, lengths, 8, device="cpu",
                      params=d["params"], proj=d["proj"])
    assert got.dtype == torch.float32 and got.shape == (40, 8)
    _close(got.numpy(), want, 3e-2, 0.3)


def test_encode_row_features_do_not_depend_on_n():
    """Static micro-batches padded by repeating the last row: a row's
    features are the same bits whether 5, 64 or 70 tasks are encoded, and
    tokens past a task's length do not reach them."""
    ec = EmbedConfig(**EC_KW, seed=2)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 256, (70, 16)).astype(np.int32)
    lengths = rng.integers(4, 17, 70).astype(np.int32)
    e70 = tenc.encode(ec, tokens, lengths, 8, device="cpu")
    e64 = tenc.encode(ec, tokens[:64], lengths[:64], 8, device="cpu")
    e5 = tenc.encode(ec, tokens[:5], lengths[:5], 8, device="cpu")
    assert e70.shape == (70, 8)
    assert torch.equal(e70[:64], e64) and torch.equal(e64[:5], e5)
    t2 = tokens.copy()
    t2[0, lengths[0]:] = (t2[0, lengths[0]:] + 7) % 256
    assert torch.equal(tenc.encode(ec, t2[:5], lengths[:5], 8,
                                   device="cpu")[0], e5[0])
    assert bool(torch.isfinite(e70).all())
    last = tenc.encode(dataclasses.replace(ec, pooling="last"), tokens[:5],
                       lengths[:5], 8, device="cpu")
    assert not torch.equal(last, e5)
    with pytest.raises(ValueError):
        tenc.encode(ec, tokens[:, :8], lengths, 8, device="cpu")
    with pytest.raises(ValueError):
        tenc.projection(dataclasses.replace(ec, projection_dim=4), 8,
                        device="cpu")


# ------------------------------------------------- dataset, learning ----

def _ref_dataset_draws(n_train, n_test, seed):
    spec = override(get_scenario("hybrid_small"), OVERRIDES)
    ec = to_embed_config(spec)
    ec = dataclasses.replace(ec, seed=ec.seed + 7919 * (seed + 1))
    return spec, _ref_draws(ec, n_train + n_test, spec.features.n_features)


def test_make_dataset_matches_reference():
    spec_j, d = _ref_dataset_draws(96, 32, seed=1)
    with jax.threefry_partitionable(False):
        want = jembed.make_dataset(spec_j, 96, 32, seed=1)
    spec_t = get_learning_spec("hybrid_small", OVERRIDES)
    got = tbank.make_dataset(spec_t, 96, 32, seed=1, device="cpu", **d)
    for g, w in zip(got[1::2], want[1::2]):                  # labels
        np.testing.assert_array_equal(g, np.asarray(w))
    for g, w in zip(got[0::2], want[0::2]):                  # features
        assert g.dtype == np.float32
        _close(g, np.asarray(w), 3e-2, 0.3)


def test_run_learning_lm_features_on_injected_draws():
    """``run_learning`` with ``features.kind="lm"`` builds its dataset
    through ``make_dataset`` (the reference's tokens, parameters and
    projection injected) and runs the batch learning loop on it: the same
    curve as passing that dataset explicitly, on the same injected round
    draws."""
    n_train, n_test, seed = 96, 32, 0
    _, d = _ref_dataset_draws(n_train, n_test, seed)
    spec = get_learning_spec("hybrid_small", OVERRIDES)
    data = tbank.make_dataset(spec, n_train, n_test, seed=seed, device="cpu",
                              **d)
    cfg = ts.FastConfig(pool_size=10)
    bcfg = dataclasses.replace(cfg, n_tasks=10, batch_size=10, n_classes=2)
    rng, gen = np.random.default_rng(3), torch.Generator().manual_seed(3)
    draws = [ts.draw_round(bcfg, 4, n_train, rng, gen) for _ in range(3)]
    kw = dict(rounds=3, n_reps=4, fit_steps=20, seed=seed, device="cpu",
              draws=draws)
    out = run_learning("hybrid_small", overrides=OVERRIDES, n_train=n_train,
                       n_test=n_test, embed_draws=d, **kw)
    same = run_learning("hybrid_small", *data, **kw)
    for k in ("t", "n_labeled", "acc"):
        assert torch.equal(out["curve"][k], same["curve"][k])
    assert out["curve"]["acc"].shape == (4, 4)
    assert (out["curve"]["n_labeled"][:, -1] == 30).all()


def test_learning_spec_overrides():
    spec = get_learning_spec("hybrid_small", {
        **OVERRIDES, "embed.reduced": False, "difficulty.p_hard": 0.25,
        "features.hard_sep_scale": 0.5})
    assert spec.feature_kind == "lm" and spec.p_hard == 0.25
    assert spec.hard_sep_scale == 0.5 and spec.embed.reduced is False
    assert spec.embed == EmbedConfig(model=RG, reduced=False, seq_len=16,
                                     batch_size=32)
    assert get_learning_spec("hybrid_small").feature_kind == "gaussian"
    with pytest.raises(KeyError):
        get_learning_spec("hybrid_small", {"features.colour": 1})
    with pytest.raises(KeyError):
        get_learning_spec("hybrid_small", {"embed.colour": 1})
    with pytest.raises(ValueError, match="bank_size"):
        get_learning_spec("hybrid_small", {"embed.bank_size": 6})
    with pytest.raises(ValueError, match="projection_dim"):
        get_learning_spec("hybrid_small", {"embed.projection_dim": 4})
    with pytest.raises(ValueError, match="feature_kind"):
        get_learning_spec("hybrid_small", {"features.kind": "image"})


# ------------------------------------------------------------- bank ----

def test_embedding_bank_gather_and_texts():
    ec = EmbedConfig(**EC_KW)
    b = tbank.embedding_bank(ec, 2, 8, 3.0, 0.1, device="cpu")
    assert b is tbank.embedding_bank(ec, 2, 8, 3.0, 0.1, device="cpu")
    assert b.feats.shape == (2, 2, 16, 8) and b.n_variants == 16
    flat = b.feats.reshape(-1, 8)
    np.testing.assert_allclose(flat.mean(0).numpy(), 0.0, atol=1e-4)
    np.testing.assert_allclose(flat.std(0, correction=0).numpy(), 1.0,
                               atol=1e-3)
    u = np.array([0.0, 0.999, 0.5, 0.3], np.float32)
    tl = np.array([0, 1, 5, -2], np.int32)
    diff = np.array([1.0, 0.5, 1.0, 0.2], np.float32)
    want = np.asarray(jembed.bank_gather(jnp.asarray(b.feats.numpy()),
                                         jnp.asarray(u), jnp.asarray(tl),
                                         jnp.asarray(diff)))
    got = tbank.bank_gather(b.feats, torch.from_numpy(u),
                            torch.from_numpy(tl), torch.from_numpy(diff))
    np.testing.assert_array_equal(got.numpy(), want)
    v = tbank.embed_texts(ec, ["classify this", "another task"], 2, 8, 3.0,
                          0.1, device="cpu")
    assert v.shape == (2, 8) and bool(torch.isfinite(v).all())
    with pytest.raises(ValueError, match="bank_size"):
        tbank.embedding_bank(dataclasses.replace(ec, bank_size=6), 4, 8,
                             3.0, device="cpu")
