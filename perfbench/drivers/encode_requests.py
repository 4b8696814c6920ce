"""A closed loop of one submitter pushing text jobs through the LM encoder.

Request i holds n texts of 8-48 real tokens (zeros past each length); the
submitter calls the program's ``embed.encoder.encode`` on it and waits for
the features on the host, then sends the next. Sizes come in blocks: each
block is one permutation, drawn from the seed, of the same ``block`` sizes
(quantiles of a log-uniform law on [lo, hi]), so every seed sends the same
work in another order. The next block's tokens are made while the current
one runs. With ``topics`` in the traffic file, each text has a topic (a
Zipf law over ``n``) and draws each token from its topic's block of the
vocabulary with probability ``in_topic``, else from the whole vocabulary;
without it, every token from the whole vocabulary.

The weights are drawn on the card from the seed in bfloat16, the type the
encoder computes in, scaled by the configuration's published multipliers
and given the traffic's topic structure (``perfbench.weights``), and
handed to ``encode(params=...)`` with a seeded projection. The check
reruns the largest request of the window and others drawn from the seed
through the plain float32 reference (``perfbench.reference.granite``) on
the same weights and compares each text's features.

A traced run counts, after its trace has closed, every capacity dispatch
of the MoE: the picks, the picks dropped at capacity and the largest
expert's load over the mean (``run["moe"]``).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench.harness import timed_calls
from perfbench.weights import (
    add_topics, draw_projection, draw_weights, fold_multipliers,
)

_MASK = (1 << 63) - 1
# the sizes of the encoder block that the file's ``encoder`` states and the
# program's model configuration must match
_MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
               "d_ff", "vocab_size", "n_experts", "moe_top_k",
               "capacity_factor", "norm_eps", "rope_theta", "window",
               "qkv_bias", "tie_embeddings", "act", "mlp_gated", "norm",
               "block_pattern")


def _program_encoder(run: dict):
    """The program's embedding config, model config and feature width for
    the run's configuration, checked against the file."""
    from repro_torch.embed.encoder import resolved_config
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.compile import to_stream_config
    from perfbench.drivers.stream_sweep import check_config
    conf = run["config"]
    cfg = to_stream_config(get_scenario(conf["scenario"],
                                        conf.get("overrides") or None))
    check_config(cfg, conf["stream_config"])
    ec = cfg.learner.embed
    mcfg = resolved_config(ec)
    stated = conf["encoder"]
    got = {k: getattr(mcfg, k) for k in _MODEL_KEYS}
    got["block_pattern"] = list(got["block_pattern"])
    diff = [k for k in _MODEL_KEYS if got[k] != stated[k]]
    if diff:
        raise ValueError(f"the program's encoder departs from the file in "
                         f"{diff}")
    return cfg, ec, mcfg


def draw_model(run: dict, mcfg, n_features: int):
    """``(params, proj, names)``: the weights in the program's layout drawn
    from the run's seed on its device, scaled by the configuration's
    ``multipliers`` and given the traffic's ``topics``, the projection
    after them, and the same weights by the reference's names."""
    from repro_torch.models.model import model_template
    from repro_torch.models.params import leaves, tree_map
    template = model_template(mcfg)
    gen, vals = draw_weights(leaves(template), run["seed"], run["device"])
    it = iter(vals)
    params = tree_map(lambda _: next(it), template)
    proj = draw_projection(gen, mcfg.d_model, n_features, run["device"])
    names = reference_names(params)
    mult = run["config"].get("multipliers")
    if mult:
        fold_multipliers(names, mult, mcfg.head_dim)
    topics = run["traffic"].get("topics")
    if topics:
        add_topics(names, topics, gen, run["device"])
    return params, proj, names


def reference_names(params: dict) -> dict:
    """The weights of one stack of attention + MoE blocks by the
    reference's names (stacked over layers)."""
    if params.get("tail") or len(params["groups"]) != 1 \
            or set(params) - {"embed", "final_norm", "groups", "tail"}:
        raise ValueError("the reference takes one stack of attention + "
                         "MoE blocks, tied embeddings, no biases")
    g = params["groups"][0]
    a, e = g["attn"], g["moe"]
    if set(a) != {"wq", "wk", "wv", "wo", "norm"}:
        raise ValueError(f"attention leaves {sorted(a)}")
    return dict(embed=params["embed"], final_norm=params["final_norm"]["scale"],
                attn_norm=a["norm"]["scale"], wq=a["wq"], wk=a["wk"],
                wv=a["wv"], wo=a["wo"], moe_norm=e["norm"]["scale"],
                router=e["router"], w_gate=e["w_gate"], w_up=e["w_up"],
                w_down=e["w_down"])


def request_sizes(trf: dict) -> list:
    """One block's sizes: quantiles of log-uniform on [lo, hi]."""
    s = trf["texts_per_request"]
    lo, hi, n = math.log(s["lo"]), math.log(s["hi"]), s["block"]
    return [int(round(math.exp(lo + (hi - lo) * (j + 0.5) / n)))
            for j in range(n)]


def make_block(run: dict, b: int, seq_len: int, vocab: int) -> list:
    """Block ``b``'s requests as ``(tokens (n, seq_len) int32, lengths
    (n,) int32)`` numpy pairs, drawn from the run's seed."""
    trf = run["traffic"]
    rng = np.random.default_rng([run["seed"] & _MASK, b + 1, 3])
    sizes = request_sizes(trf)
    lo, hi = trf["text_len"]["lo"], trf["text_len"]["hi"]
    topics = trf.get("topics")
    out = []
    for j in rng.permutation(len(sizes)):
        n = sizes[j]
        lengths = rng.integers(lo, hi + 1, n).astype(np.int32)
        tokens = rng.integers(0, vocab, (n, seq_len))
        if topics:
            Z = int(topics["n"])
            p = 1.0 / np.arange(1, Z + 1) ** float(topics["zipf_s"])
            z = rng.choice(Z, size=n, p=p / p.sum())
            own = z[:, None] * (vocab // Z) + rng.integers(
                0, vocab // Z, (n, seq_len))
            tokens = np.where(rng.random((n, seq_len)) < topics["in_topic"],
                              own, tokens)
        tokens = tokens.astype(np.int32)
        tokens[np.arange(seq_len)[None, :] >= lengths[:, None]] = 0
        out.append((tokens, lengths))
    return out


def setup(run: dict) -> dict:
    from repro_torch.embed.encoder import encode
    cfg, ec, mcfg = _program_encoder(run)
    F = cfg.learner.n_features
    params, proj, names = draw_model(run, mcfg, F)
    st = dict(ec=ec, mcfg=mcfg, F=F, params=params, proj=proj, names=names,
              blocks={}, done=[])
    # the one micro-batch shape every request uses, twice
    warm = make_block(run, -1, ec.seq_len, mcfg.vocab_size)
    for tokens, lengths in warm[:2]:
        encode(ec, tokens, lengths, F, device=run["device"], params=params,
               proj=proj).cpu()
    return st


def window(run: dict, st: dict):
    from repro_torch.embed.encoder import encode
    ec, mcfg, F = st["ec"], st["mcfg"], st["F"]
    nb = run["traffic"]["texts_per_request"]["block"]
    blocks = st["blocks"]
    blocks[0] = make_block(run, 0, ec.seq_len, mcfg.vocab_size)

    def call(i):
        b, j = divmod(i, nb)
        tokens, lengths = blocks[b][j]
        t0 = time.perf_counter()
        feats = encode(ec, tokens, lengths, F, device=run["device"],
                       params=st["params"], proj=st["proj"]).cpu()
        lat = time.perf_counter() - t0
        if j == 0 and b + 1 not in blocks:        # the next block, made ahead
            blocks[b + 1] = make_block(run, b + 1, ec.seq_len,
                                       mcfg.vocab_size)
        st["done"].append((i, feats))
        return {"texts": int(lengths.shape[0]), "latency_s": lat,
                "lengths": lengths}

    trace_s = run["traffic"].get("trace_seconds", 8)
    moe = counting_moe(run, st) if run["trace"] else None

    def keep_tracing(_n, t):
        if t >= trace_s and moe is not None:
            moe["on"] = True
        return t < trace_s
    try:
        timed_calls(run, run["seconds"], call, keep_tracing)
    finally:
        if moe is not None:
            moe["undo"]()
            run["moe"] = {k: (float(v) if torch.is_tensor(v) else v)
                          for k, v in moe.items() if k not in ("on", "undo")}
    run["model"] = {k: getattr(mcfg, k) for k in
                    ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                     "n_experts", "moe_top_k", "n_layers")}
    run["micro_batch"] = (ec.batch_size, ec.seq_len)


def counting_moe(run: dict, st: dict) -> dict:
    """Wrap the program's MoE dispatch so that, while the returned dict's
    ``on`` is set, each dispatch adds its picks, its picks dropped at
    capacity and its largest expert's load over the mean, on the device
    (no wait for it); ``undo`` restores the dispatch."""
    from repro_torch.models import layers
    orig = layers.moe_dispatch
    acc = dict(on=False, dispatches=0, picks=0, dropped=0, load_ratio_sum=0)

    def dispatch(probs, k, C):
        r = orig(probs, k, C)
        if acc["on"]:
            T, E = probs.shape
            load = torch.zeros(E, dtype=torch.int64, device=probs.device
                               ).scatter_add_(0, r["topi"].reshape(-1),
                                              torch.ones_like(
                                                  r["topi"].reshape(-1)))
            acc["dispatches"] += 1
            acc["picks"] += T * k
            acc["dropped"] = acc["dropped"] + (~r["keep"]).sum()
            acc["load_ratio_sum"] = acc["load_ratio_sum"] \
                + load.max().to(torch.float64) * (E / (T * k))
        return r

    def undo():
        layers.moe_dispatch = orig
    layers.moe_dispatch = dispatch
    acc["undo"] = undo
    return acc


def _request(st, i):
    b, j = divmod(i, len(st["blocks"][0]))
    return st["blocks"][b][j]


def _text_gaps(got, want):
    """Each text's distance between its features and the reference's,
    over the median norm of the reference's features."""
    d = (got.double() - want.double()).norm(dim=-1)
    return d / max(float(want.double().norm(dim=-1).median()), 1e-30)


def feature_gap(got, want) -> float:
    """The root mean square of the texts' gaps (:func:`_text_gaps`): steady
    from seed to seed where the widest gap is set by the one text whose
    expert routing flips between bfloat16 and float32, and still far off
    for one text whose features are wrong."""
    return float(_text_gaps(got, want).square().mean().sqrt())


def reference_features(run, st, tokens, lengths, fp8=False):
    from perfbench.reference import granite
    dev = run["device"]
    return granite.encode(
        st["names"], run["config"]["encoder"],
        torch.as_tensor(tokens, device=dev),
        torch.as_tensor(lengths, device=dev), st["proj"],
        st["ec"].batch_size, fp8=fp8).cpu()


def picks(run: dict, st: dict) -> list:
    """The requests the check reruns: the largest of the window (the first
    of them) and others drawn from the seed."""
    done = [i for i, _ in st["done"]]
    k = run["traffic"]["check"]["requests"]
    sizes = {i: _request(st, i)[1].shape[0] for i in done}
    big = max(done, key=lambda i: (sizes[i], -i))
    rng = np.random.default_rng([run["seed"] & _MASK, 4])
    rest = [i for i in done if i != big]
    extra = rng.choice(len(rest), size=min(k - 1, len(rest)),
                       replace=False) if rest else []
    return [big] + [rest[int(j)] for j in extra]


def check(run: dict, st: dict) -> dict:
    limits = run["config"]["limits"]
    if not st["done"]:
        return {"feat_gap": {"value": float("inf"),
                             "limit": limits["feat_gap"]}}
    feats = dict(st["done"])
    st["reference"] = {}
    gap = 0.0
    for i in picks(run, st):
        tokens, lengths = _request(st, i)
        want = st["reference"][i] = reference_features(run, st, tokens,
                                                       lengths)
        gap = max(gap, feature_gap(feats[i], want))
        run.setdefault("diag", []).append(_per_text(feats[i], want))
    return {"feat_gap": {"value": gap, "limit": limits["feat_gap"]}}


def _per_text(got, want):
    r = _text_gaps(got, want).numpy()
    return dict(n=len(r), max=float(r.max()), p90=float(np.quantile(r, .9)),
                median=float(np.median(r)),
                rms=float(np.sqrt((r * r).mean())))


def control(run: dict, st: dict) -> dict:
    """The control's number: the reference in float8 in the program's
    place, on the requests the check compared."""
    gap = 0.0
    for i, want in st["reference"].items():
        tokens, lengths = _request(st, i)
        low = reference_features(run, st, tokens, lengths, fp8=True)
        gap = max(gap, feature_gap(low, want))
        run.setdefault("diag_control", []).append(_per_text(low, want))
    return {"feat_gap": gap}


def build_bank(run: dict, cfg):
    """The stream's embedding bank, built as the program builds it (its
    corpus of 2 x C x K texts, encoded, standardised over the bank) but
    with the weights and projection drawn on the card from the run's seed.
    Returns ``(bank (2, C, K, F), what the check of the bank needs)``; the
    weights are dropped."""
    from repro_torch.embed.corpus import make_tokens
    from repro_torch.embed.encoder import encode
    from repro_torch.learning.features import standardize
    _, ec, mcfg = _program_encoder(run)
    L, C = cfg.learner, cfg.n_classes
    K = ec.bank_size // (2 * C)
    hard = np.repeat(np.arange(2), C * K).astype(bool)
    labels = np.tile(np.repeat(np.arange(C, dtype=np.int32), K), 2)
    tokens, lengths = make_tokens(ec, labels, hard, C, mcfg.vocab_size,
                                  L.class_sep, L.hard_sep_scale)
    params, proj, _ = draw_model(run, mcfg, L.n_features)
    E = encode(ec, tokens, lengths, L.n_features, device=run["device"],
               params=params, proj=proj)
    bank = standardize(E).reshape(2, C, K, L.n_features)
    return bank, dict(tokens=tokens, lengths=lengths, ec=ec, mcfg=mcfg,
                      F=L.n_features)


def plain_standardize(X, eps: float = 1e-6):
    """Each feature less its mean over the rows, over its population
    standard deviation (floored at ``eps``), in float64."""
    X = X.double()
    sd = ((X - X.mean(0)) ** 2).mean(0).sqrt()
    return (X - X.mean(0)) / sd.clamp(min=eps)


def check_bank(run: dict, st: dict, fp8: bool = False) -> dict:
    """The bank by itself: every bank text through the reference on the
    same weights (drawn again from the seed), the features standardised
    plainly over the bank, against the program's standardised bank. With
    ``fp8`` the control in the program's place: the reference in float8,
    standardised the same way, against the reference."""
    bc = st["bank_check"]
    _, proj, names = draw_model(run, bc["mcfg"], bc["F"])
    ref_st = dict(names=names, proj=proj, ec=bc["ec"])
    want = plain_standardize(reference_features(
        run, ref_st, bc["tokens"], bc["lengths"]))
    got = st["bank"].reshape(-1, bc["F"]).cpu() if not fp8 else \
        plain_standardize(reference_features(
            run, ref_st, bc["tokens"], bc["lengths"], fp8=True))
    limit = run["config"]["limits"]["bank_gap"]
    run.setdefault("diag_control" if fp8 else "diag", []).append(
        _per_text(got, want))
    return {"bank_gap": {"value": feature_gap(got, want), "limit": limit}}
