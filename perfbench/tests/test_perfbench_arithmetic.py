"""The yardstick's arithmetic against hand-counted cases."""
import math

import pytest

from perfbench import bounds
from perfbench.harness import reader
from perfbench.profiling import Kernel, breakdown, merged

GRANITE = dict(d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64, d_ff=512,
               n_experts=40, moe_top_k=8, n_layers=32)


def test_granite_active_parameters_a_token():
    # q, o: 1536 x 1536; k, v: 1536 x 512; router 1536 x 40; 8 experts of
    # three 1536 x 512 matrices; 32 layers
    attn = 2 * 1536 * 1536 + 2 * 1536 * 512
    per_layer = attn + 1536 * 40 + 8 * 3 * 1536 * 512
    assert attn == 6_291_456
    assert per_layer == 25_227_264
    n = bounds.moe_active_params(**GRANITE)
    assert n == 32 * per_layer == 807_272_448
    assert abs(n - 806e6) / 806e6 < 0.002      # "about 806 M"


def test_encoder_flops_counts_real_tokens_and_causal_pairs():
    p = bounds.moe_active_params(**GRANITE)
    # one text of 3 real tokens: 3 tokens x 2 p, and 6 causal (q, k)
    # pairs x 4 head_dim FLOPs x 24 heads x 32 layers
    want = 3 * 2 * p + 6 * 4 * 64 * 24 * 32
    assert bounds.encoder_flops([3], **GRANITE) == want
    assert bounds.encoder_flops([3, 1], **GRANITE) == \
        want + 2 * p + 1 * 4 * 64 * 24 * 32


def test_estep_bound_by_hand():
    # B=2, R=17, C=2, T=32, V=5: ints 2*32*5, table 2*17*2, two outputs
    # 2*2*32*2, 4 bytes each
    ms, which, nbytes = bounds.estep_bound_ms(2, 17, 2, 32, 5)
    assert nbytes == 4 * (320 + 68 + 256)
    assert which == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12)


def test_flash_bound_by_hand():
    # B=1, Hq=2, Hkv=1, S=4, D=8, causal: 10 kept pairs x 4 x 8 x 2 heads
    ms, which, nbytes = bounds.flash_bound_ms(1, 2, 1, 4, 4, 8, 2, True, 0)
    assert nbytes == 2 * (2 * 2 * 4 * 8 + 2 * 1 * 4 * 8)
    flops = 10 * 4 * 8 * 2
    assert ms == pytest.approx(1e3 * max(nbytes / 3.35e12, flops / 989e12))
    # a window of 2 keeps 7 of the causal pairs
    assert bounds._kept_pairs(4, 4, True, 2) == 7
    # at the encoder's shape the bytes bound it (25 MB against 0.46 GFLOP)
    assert bounds.flash_bound_ms(64, 24, 8, 48, 48, 64, 2, True, 0)[1:] == \
        ("bytes", 25_165_824)


def test_roofline_readers_read_bound_over_time():
    B, R, C, T, V = 16384, 17, 2, 32, 5
    bound_us = 1e3 * bounds.estep_bound_ms(B, R, C, T, V)[0]
    run = {"kernels": [Kernel("ds_estep_task_warp", 0.0, 2 * bound_us),
                       Kernel("other", 0.0, 5.0)],
           "estep_shapes_traced": [(B, R, C, T, V)]}
    assert reader("ds_estep_roofline.stream")(run) == pytest.approx(50.0)
    m = {k: GRANITE[k] for k in ("n_heads", "n_kv_heads", "head_dim")}
    fb = 1e3 * bounds.flash_bound_ms(64, 24, 8, 48, 48, 64, 2, True, 0)[0]
    run = {"kernels": [Kernel("void flash_fwd_mma<64>", 0.0, 4 * fb)],
           "model": m, "micro_batch": (64, 48)}
    assert reader("flash_roofline.embed")(run) == pytest.approx(25.0)


def test_readers_with_nothing_to_read_return_none():
    for name in ("ds_estep_roofline.stream", "flash_roofline.embed",
                 "encode_mfu", "device_idle.stream", "device_idle.embed",
                 "device_idle.bank", "kernels_per_tick.stream",
                 "kernels_per_tick.bank", "moe_drop_share",
                 "moe_load_ratio"):
        assert reader(name)({"kernels": [], "calls": []}) is None


def test_encode_mfu_by_hand():
    lengths = [10, 20]
    run = {"calls": [{"lengths": lengths, "texts": 2}], "traced_calls": 1,
           "kernels": [Kernel("k", 0.0, 1.0)], "traced_wall_s": 0.5,
           "model": GRANITE}
    want = 100 * bounds.encoder_flops(lengths, **GRANITE) / 0.5 / 989e12
    assert reader("encode_mfu")(run) == pytest.approx(want)


def test_end_to_end_readers():
    calls = [{"rep_ticks": 100, "t0": 0, "t1": 1},
             {"rep_ticks": 100, "t0": 1, "t1": 2.5}]
    assert reader("rep_ticks_per_s")({"calls": calls, "window_s": 2.5}) == 80
    assert reader("bank_rep_ticks_per_s")({"calls": calls,
                                           "window_s": 2.5}) == 80
    lat = [{"latency_s": s / 100, "texts": 1} for s in range(1, 101)]
    assert reader("embed_p95_ms")({"calls": lat}) == pytest.approx(950.5)
    assert reader("tasks_embedded_per_s")({"calls": lat,
                                           "window_s": 4}) == 25


def test_busy_is_the_union_of_intervals_and_gaps_are_labelled():
    ks = [Kernel("a", 0, 10), Kernel("b", 5, 10), Kernel("c", 30, 5)]
    assert merged(ks) == [(0, 15, "b"), (30, 35, "c")]
    bd = breakdown(ks)
    assert bd["idle_gaps"] == [["after b", pytest.approx(15e-6)]]
    assert [n for n, _ in bd["device_ops"]] == ["a", "b", "c"]
    assert math.isclose(sum(s for _, s in bd["device_ops"]), 25e-6)


def test_the_other_bounds_by_hand():
    # entropy: N x V logits read and N floats written, 5 operations a logit
    ms, which, nbytes = bounds.entropy_bound_ms(1000, 16, 4)
    assert nbytes == 1000 * 16 * 4 + 4 * 1000 and which == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12)
    # scan: a, b, h of B x S x D and h0
    assert bounds.scan_bound_ms(2, 8, 4, 4, True)[2] == 3 * 2 * 8 * 4 * 4 \
        + 4 * 2 * 4
    # cross entropy: the logits once forward, twice backward, 12 B a row
    assert bounds.xent_bound_ms(10, 100, 4, False)[2] == 10 * 100 * 4 + 120
    assert bounds.xent_bound_ms(10, 100, 4, True)[2] == 2 * 10 * 100 * 4 + 120


def _stream_row(**over):
    """One replication's outputs that keep every law of the stream: 10
    arrivals, 1 dropped, 6 finalized (4 warm), 2 queued, 1 in flight."""
    import torch
    row = {"arrived": 10, "dropped": 1, "done_all": 6, "backlog_end": 2,
           "in_flight_end": 1, "done": 4, "arrived_warm": 7, "correct": 3,
           "model_known": 1, "votes_fin": 9,
           "series.arrivals": [4, 6], "series.finalized": [2, 4],
           "series.backlog": [3, 2], "series.in_flight": [2, 1],
           "per_shard.backlog_end": [1, 1], "per_shard.in_flight_end": [0, 1],
           "hist": [0, 3, 1]}
    row.update(over)
    return {k: torch.tensor([v]) for k, v in row.items()}


def test_the_stream_laws_by_hand():
    from perfbench.drivers.stream_sweep import invariant_breaks
    assert invariant_breaks(_stream_row(), votes_cap=5) == 0
    # one more finalized task than arrived: conservation and the series
    assert invariant_breaks(_stream_row(done_all=7), votes_cap=5) == 2
    assert invariant_breaks(_stream_row(votes_fin=21), votes_cap=5) == 1
    assert invariant_breaks(_stream_row(hist=[0, 3, 2]), votes_cap=5) == 1


def test_the_configuration_check_reads_only_what_the_file_states():
    import dataclasses

    from perfbench.drivers.stream_sweep import check_config

    @dataclasses.dataclass
    class Inner:
        a: int = 1
        b: float = 2.0

    @dataclasses.dataclass
    class Cfg:
        n: int = 3
        inner: Inner = dataclasses.field(default_factory=Inner)
        added_later: bool = True

    check_config(Cfg(), {"n": 3, "inner": {"a": 1}})
    with pytest.raises(ValueError, match="inner.b"):
        check_config(Cfg(), {"n": 3, "inner": {"a": 1, "b": 2.5}})
    with pytest.raises(ValueError, match="gone"):
        check_config(Cfg(), {"gone": 1})


def test_the_weights_fold_the_multipliers_and_take_the_topics():
    import torch

    from perfbench.weights import add_topics, fold_multipliers
    ones = lambda *s: torch.ones(s)
    W = dict(embed=ones(8, 4), wq=ones(2, 4, 4), wo=ones(2, 4, 4),
             w_down=ones(2, 3, 2, 4), router=torch.zeros(2, 4, 6))
    fold_multipliers(W, dict(embedding_multiplier=12.0,
                             attention_multiplier=1 / 16,
                             residual_multiplier=0.25), head_dim=16)
    assert W["embed"].eq(12.0).all() and W["wq"].eq(0.25).all()
    assert W["wo"].eq(0.25).all() and W["w_down"].eq(0.25).all()
    g = torch.Generator().manual_seed(3)
    emb = torch.randn(8, 64, generator=g)
    W = dict(embed=emb.clone(), router=torch.zeros(3, 64, 10))
    add_topics(W, dict(n=2, experts_per_topic=4, embed_share=0.9,
                       router_boost=1.0), torch.Generator().manual_seed(4),
               "cpu")
    e = torch.nn.functional.normalize(W["embed"], dim=-1)
    same, other = e[:4] @ e[:4].T, e[:4] @ e[4:].T
    assert same.mean() > 0.8 and other.abs().mean() < 0.4
    # each layer: every topic lifts its 4 experts' columns along its
    # direction, and leaves the other experts' columns at zero
    lifted = W["router"].norm(dim=1) > 0
    assert (lifted.sum(-1) >= 4).all() and (lifted.sum(-1) <= 8).all()


def test_topic_texts_draw_from_their_topic_block():
    import numpy as np

    from perfbench.drivers.encode_requests import make_block
    trf = dict(texts_per_request=dict(lo=64, hi=64, block=2),
               text_len=dict(lo=48, hi=48),
               topics=dict(n=4, zipf_s=1.0, in_topic=0.8))
    run = dict(seed=2 ** 40 + 3, traffic=trf)
    tokens, _ = make_block(run, 0, 48, 400)[0]
    block = tokens // 100
    topic = np.array([np.bincount(r, minlength=4).argmax() for r in block])
    share = (block == topic[:, None]).mean()
    assert 0.8 < share < 0.9                  # 0.8 + 0.2 / 4 expected


def test_plain_standardisation_and_the_moe_readers_by_hand():
    import torch

    from perfbench.drivers.encode_requests import plain_standardize
    X = torch.tensor([[1.0, 5.0], [3.0, 5.0]])
    assert plain_standardize(X).tolist() == [[-1.0, 0.0], [1.0, 0.0]]
    moe = {"moe": dict(dispatches=4, picks=800, dropped=40.0,
                       load_ratio_sum=10.0)}
    assert reader("moe_drop_share")(moe) == pytest.approx(5.0)
    assert reader("moe_load_ratio")(moe) == pytest.approx(2.5)
    assert reader("moe_drop_share")({}) is None
