"""The readers of the program's spans against hand-made spans and kernels,
and the padding share against hand-made requests, each answer worked out by
hand."""
import numpy as np
import pytest

from perfbench import spans as pspans
from perfbench.harness import reader
from perfbench.profiling import Kernel
from repro_torch.obs import timing
from repro_torch.obs.timing import Span

US = 1000          # ns a us

STREAM = ("admit_share", "assign_share", "learner_share", "idle_in_predraw",
          "idle_in_tick")
EMBED = ("moe_dispatch_share.embed", "moe_combine_share.embed",
         "pad_token_share.embed", "idle_outside_batches.embed")
ALL = tuple(f"{m}.{c}" for m in STREAM for c in ("stream", "bank")) + EMBED


def _span(name, parent, t0_us, t1_us, ms=None):
    return Span(name, parent, t0_us * US, t1_us * US, ms)


# a sweep call: the pre-draw, then two ticks in the loop; an admission
# outside any tick (serve mode) that no share may count
STREAM_SPANS = [
    _span("sweep.predraw", -1, 0, 100, 0.2),
    _span("tick", -1, 100, 500, 10.0),
    _span("tick.admit", 1, 110, 200, 2.0),
    _span("tick.assign", 1, 200, 300, 3.0),
    _span("tick.fuse", 1, 300, 350, 1.0),
    _span("tick.learner_fit", 1, 350, 400, 0.5),
    _span("tick", -1, 500, 900, 10.0),
    _span("tick.admit", 6, 510, 600, 1.0),
    _span("tick.assign", 6, 600, 700, 4.0),
    _span("tick.learner_fit", 6, 700, 800, 0.5),
    _span("tick.admit", -1, 950, 990, 100.0),
]
# busy [20, 60], [80, 150] (across the pre-draw's end), [300, 450], and
# [600, 1000] (two kernels overlapping, past the last tick's end)
KERNELS = [Kernel("a", 20.0, 40.0), Kernel("b", 80.0, 70.0),
           Kernel("c", 300.0, 150.0), Kernel("d", 600.0, 300.0),
           Kernel("e", 850.0, 150.0)]
WALL_S = 2000e-6


def _program(monkeypatch, spans):
    monkeypatch.setattr(pspans, "program", lambda: spans)


def test_tick_shares_count_only_sections_inside_a_tick(monkeypatch):
    _program(monkeypatch, STREAM_SPANS)
    run = {"kernels": KERNELS, "traced_wall_s": WALL_S}
    for cell in ("stream", "bank"):
        # the two ticks' 20 ms: admission 2 + 1, assignment 3 + 4, the
        # learner 1 + 0.5 + 0.5 (the admission outside a tick left out)
        assert reader(f"admit_share.{cell}")(run) == pytest.approx(15.0)
        assert reader(f"assign_share.{cell}")(run) == pytest.approx(35.0)
        assert reader(f"learner_share.{cell}")(run) == pytest.approx(10.0)


def test_idle_is_put_down_to_the_span_the_host_was_in(monkeypatch):
    _program(monkeypatch, STREAM_SPANS)
    run = {"kernels": KERNELS, "traced_wall_s": WALL_S}
    for cell in ("stream", "bank"):
        # pre-draw [0, 100]: busy 40 + 20 (the kernel that straddles its
        # end counts up to 100 only): 40 us idle of 2000
        assert reader(f"idle_in_predraw.{cell}")(run) == pytest.approx(2.0)
        # ticks [100, 900] as one interval: busy 50 + 150 + 300, so 300 us
        # idle
        assert reader(f"idle_in_tick.{cell}")(run) == pytest.approx(15.0)
    # both together stay inside the trace's idle: 1340 us of 2000
    assert 2.0 + 15.0 <= 100.0 * (1 - 660e-6 / WALL_S)


EMBED_SPANS = [
    _span("request", -1, 0, 1000),
    _span("encode.batch", 0, 100, 400, 20.0),
    _span("layer", 1, 100, 250),                    # nested deeper
    _span("moe.dispatch", 2, 100, 150, 3.0),
    _span("other", 2, 150, 200, 4.0),
    _span("moe.combine", 2, 200, 250, 2.0),
    _span("moe.dispatch", 1, 250, 300, 1.0),
    _span("moe.combine", 1, 300, 350, 1.0),
    _span("encode.batch", 0, 500, 800, 20.0),
    _span("moe.dispatch", 8, 500, 600, 4.0),
    _span("moe.combine", 8, 600, 700, 3.0),
    _span("moe.dispatch", -1, 900, 950, 50.0),       # outside a batch
]


def test_moe_shares_and_idle_outside_the_batches(monkeypatch):
    _program(monkeypatch, EMBED_SPANS)
    # busy [0, 50], [150, 450] (across the first batch's end), [700, 750]
    kernels = [Kernel("a", 0.0, 50.0), Kernel("b", 150.0, 300.0),
               Kernel("c", 700.0, 50.0)]
    run = {"kernels": kernels, "traced_wall_s": 1000e-6}
    # 40 ms of batches: dispatch 3 + 1 + 4, combine 2 + 1 + 3
    assert reader("moe_dispatch_share.embed")(run) == pytest.approx(20.0)
    assert reader("moe_combine_share.embed")(run) == pytest.approx(15.0)
    # idle 600 us of 1000: inside the batches [100, 150] and [500, 700],
    # [750, 800]: 300 us, so 300 us outside them
    assert reader("idle_outside_batches.embed")(run) == pytest.approx(30.0)


def _request(lengths):
    return {"texts": len(lengths), "lengths": np.asarray(lengths, np.int32)}


def test_pad_share_counts_pad_rows_and_positions_of_traced_requests():
    run = {"micro_batch": (4, 10), "traced_calls": 3,
           "calls": [_request([10, 10, 10, 10]),     # 40 of 40 slots
                     _request([5, 5, 5, 5, 5]),      # 25 of 80
                     {"error": "RuntimeError: x"},   # a failed call
                     _request([1, 2, 3])]}           # after the trace
    # 65 real tokens of 120 slots
    assert reader("pad_token_share.embed")(run) == pytest.approx(
        100.0 * (1 - 65 / 120))
    run["traced_calls"] = 4
    # and 6 of 40 more
    assert reader("pad_token_share.embed")(run) == pytest.approx(
        100.0 * (1 - 71 / 160))
    # untraced, or the failed call alone
    assert reader("pad_token_share.embed")(
        {"micro_batch": (4, 10), "calls": run["calls"]}) is None
    assert reader("pad_token_share.embed")(
        {"micro_batch": (4, 10), "traced_calls": 1,
         "calls": [{"error": "x"}]}) is None


def test_overlap_and_union_by_hand():
    assert pspans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert pspans.overlap([(0, 10)], [(10, 20)]) == 0
    sp = [_span("x", -1, 0, 10), _span("x", -1, 5, 20),
          _span("y", -1, 30, 40), _span("x", -1, 50, 60)]
    assert pspans.host_us(sp, ("x",)) == [(0.0, 20.0), (50.0, 60.0)]


def test_without_spans_every_reader_reads_none(monkeypatch):
    run = {"kernels": KERNELS, "traced_wall_s": WALL_S, "calls": []}
    timing.clear_spans()
    for name in ALL:                       # nothing recorded
        assert reader(name)(run) is None, name
    monkeypatch.delattr(timing, "spans")   # a program without spans
    for name in ALL:
        assert reader(name)(run) is None, name
    monkeypatch.undo()
    # spans but no trace, and a trace whose spans lack the names
    _program(monkeypatch, STREAM_SPANS)
    for name in ALL:
        if name.startswith("idle"):
            assert reader(name)({"kernels": [], "calls": []}) is None
    assert reader("idle_outside_batches.embed")(run) is None
    assert reader("moe_dispatch_share.embed")(run) is None
