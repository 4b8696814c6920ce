"""The spans of ``repro_torch.obs.timing``: off without a profiler (no
record, no CUDA call, outputs unchanged), on under one (the sweep's
pre-draw and the tick's sections with their parents, the encoder's
micro-batches with the MoE's dispatch and combine inside), the cap, a span
on a device that is no card, and on the card the clock they share with
the profiler's device events.

The tests import torch and the port only. The card test (``cuda``
mark) skips without a card; run it there with ``PYTHONPATH=src python -m
pytest -q --noconftest -m cuda tests/test_torch_spans.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.embed.config import EmbedConfig
from repro_torch.embed.encoder import encode, resolved_config
from repro_torch.labelstream import run_stream_sweep
from repro_torch.obs import timing
from repro_torch.scenarios import get_stream_config

SECTIONS = ("tick.admit", "tick.votes", "tick.fuse", "tick.finalize",
            "tick.workers", "tick.assign")
EC = EmbedConfig(model="granite-moe-3b-a800m", reduced=True, seq_len=16,
                 batch_size=8)


@pytest.fixture(autouse=True)
def _fresh():
    timing.clear_spans()
    yield
    timing.clear_spans()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _stream_cfg():
    # the benchmark's learner configuration with a refresh every 4 ticks
    return dataclasses.replace(get_stream_config("skewed_learner_fused"),
                               refresh_every=4, refresh_iters=2)


def _sweep():
    return run_stream_sweep(_stream_cfg(), 12, [1.0, 3.0], n_reps=2, seed=7,
                            device="cpu")


def _requests(n=20, seed=3):
    m = resolved_config(EC)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, EC.seq_len + 1, n).astype(np.int32)
    tokens = rng.integers(1, m.vocab_size, (n, EC.seq_len)).astype(np.int32)
    tokens[np.arange(EC.seq_len)[None, :] >= lengths[:, None]] = 0
    return tokens, lengths


def _encode(tokens, lengths):
    return encode(EC, tokens, lengths, 8, device="cpu")


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    else:
        assert a == b


def test_off_is_the_shared_no_op_and_touches_no_card(monkeypatch):
    def no_card(*a, **k):
        raise AssertionError("CUDA touched with the spans off")
    for name in ("Event", "is_initialized", "synchronize", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    ctx = timing.span("a")
    assert ctx is timing.span("b") is timing.span("c", "cuda:0")
    with ctx:
        pass
    assert timing.spans() == [] and timing.dropped_spans() == 0


def test_off_records_nothing_and_leaves_the_registry_alone():
    timing.clear()
    timing.record("site", 0.5)
    before = timing.summary()
    _sweep()
    _encode(*_requests())
    assert timing.spans() == []
    assert timing.summary() == before
    _profiled(_sweep)
    assert timing.spans()
    assert timing.summary() == before
    timing.clear()


@pytest.mark.parametrize("what", ["stream_sweep", "encode"])
def test_outputs_bit_identical_with_spans_on(what):
    if what == "stream_sweep":
        fn = _sweep
    else:
        req = _requests(n=21)
        fn = lambda: _encode(*req)            # noqa: E731
    off = fn()
    on = _profiled(fn)
    assert timing.spans()
    _equal(off, on)


def test_sweep_spans_nest_tick_by_tick():
    _profiled(_sweep)
    sp = timing.spans()
    names = [s.name for s in sp]
    assert names.count("sweep.predraw") == 1
    pre = names.index("sweep.predraw")
    assert sp[pre].parent == -1
    ticks = [i for i, s in enumerate(sp) if s.name == "tick"]
    assert len(ticks) == 12
    # the pre-draw ends before the first tick starts
    assert pre < ticks[0] and sp[pre].t1_ns <= sp[ticks[0]].t0_ns
    for step, i in enumerate(ticks):
        assert sp[i].parent == -1
        kids = [j for j, s in enumerate(sp) if s.parent == i]
        got = sorted(sp[j].name for j in kids)
        want = list(SECTIONS) + ["tick.learner_fit"] * 2
        if step % 4 == 3:
            want.append("tick.refresh")
        assert got == sorted(want), step
        for j in kids:
            assert sp[i].t0_ns <= sp[j].t0_ns <= sp[j].t1_ns <= sp[i].t1_ns
            assert sp[j].device_ms is None           # no card here
        # the sections follow the tick's order
        order = [sp[j].name for j in kids if sp[j].name in SECTIONS]
        assert order == list(SECTIONS)
    assert all(s.t1_ns is not None for s in sp)


def test_cap_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(timing, "SPAN_CAP", 3)

    def many():
        with timing.span("outer"):
            for _ in range(6):
                with timing.span("inner"):
                    pass
    _profiled(many)
    sp = timing.spans()
    assert [s.name for s in sp] == ["outer", "inner", "inner"]
    assert [s.parent for s in sp] == [-1, 0, 0]
    assert timing.dropped_spans() == 4
    timing.clear_spans()
    assert timing.dropped_spans() == 0 and timing.spans() == []


def test_span_on_a_device_that_is_no_card_records_no_events(monkeypatch):
    def no_card(*a, **k):
        raise AssertionError("CUDA touched for a span on the CPU")
    for name in ("Event", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    # as on a machine with a card: a span without a device would take the
    # current card's stream
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)

    def spans_on_the_cpu():
        with timing.span("outer", torch.device("cpu")):
            with timing.span("inner", "cpu"):
                pass
    _profiled(spans_on_the_cpu)
    sp = timing.spans()
    assert [(s.name, s.parent, s.device_ms) for s in sp] == [
        ("outer", -1, None), ("inner", 0, None)]


@pytest.mark.parametrize("n", [5, 8, 21])
def test_encode_batch_spans_hold_the_moe_dispatch_and_combine(n):
    tokens, lengths = _requests(n=n, seed=n)
    _profiled(lambda: _encode(tokens, lengths))
    sp = timing.spans()
    m = resolved_config(EC)
    n_batches = -(-n // EC.batch_size)
    batches = [i for i, s in enumerate(sp) if s.name == "encode.batch"]
    assert len(batches) == n_batches
    assert all(sp[i].parent == -1 for i in batches)
    for i in batches:
        # each layer's MoE: the dispatch, then the combine, inside the batch
        inner = [sp[j].name for j in range(len(sp))
                 if sp[j].parent == i]
        assert inner == ["moe.dispatch", "moe.combine"] * m.n_layers
        for j in range(len(sp)):
            if sp[j].parent == i:
                assert sp[i].t0_ns <= sp[j].t0_ns <= sp[j].t1_ns \
                    <= sp[i].t1_ns
    assert len(sp) == n_batches * (1 + 2 * m.n_layers)


@pytest.mark.cuda
def test_span_shares_the_profilers_clock_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch reports no CUDA device")
    cycles = 2_000_000                      # about 1 ms at the card's clock
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the first launch under the profiler, outside the checked spans
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        # the host waits inside the span: the kernel's whole run lies in
        # its host interval, on the profiler's clock
        with timing.span("clock"):
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
        # the stream busy when the span opens: its events, on the card it
        # names, bracket the kernel alone
        torch.cuda._sleep(cycles // 10)
        with timing.span("device", torch.device("cuda", 0)):
            torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
    sp = {s.name: s for s in timing.spans()}
    # the device events of the profile, their starts in Unix us
    cuda = torch.autograd.DeviceType.CUDA
    spins = sorted((e.start_ns() * 1e-3, e.duration_ns() * 1e-3)
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda and e.duration_ns() > 300_000)
    assert len(spins) == 3, spins
    start, dur = spins[1]
    t0, t1 = sp["clock"].t0_ns * 1e-3, sp["clock"].t1_ns * 1e-3
    assert t0 - 50.0 <= start <= t1 + 50.0, (t0, start, t1)
    assert start + dur <= t1 + 50.0, (start, dur, t1)
    start, dur = spins[2]
    dev_us = sp["device"].device_ms * 1e3
    assert abs(dev_us - dur) <= 0.05 * dur, (dev_us, dur)
