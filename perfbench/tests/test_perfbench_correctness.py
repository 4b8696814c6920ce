"""The check that decides ``correct``, at a size a CPU holds: sound runs
pass, the control (the reference one precision down in the program's
place) fails, and so does a run whose timed path is broken underneath
(the harness's look for a card is skipped; everything else runs)."""
import torch

import pytest

from perfbench.tests.conftest import run_small

CELLS = ("learner_stream.sweep", "lm_embed.text", "lm_stream.bank")


def _fails(run) -> bool:
    res = run["result"]
    return not res["correct"]


def _control_fails(run) -> bool:
    limits = {k: c["limit"] for k, c in run["result"]["checks"].items()}
    return any(v > limits[k] for k, v in run["control"].items())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_its_control_is_not(cell):
    run = run_small(cell, seed=2 ** 31 + 77, control=True)
    assert run["result"]["correct"], run["result"]["checks"]
    assert run["result"]["attempted"] >= 1
    assert _control_fails(run), (run["result"]["checks"], run["control"])


# ----------------------------------------------------------------- faults --

def _stream_fault(kind, monkeypatch):
    from repro_torch.labelstream import router
    tick, run_one = router._shard_tick, router._run_one
    if kind == "state_unchanged":
        def shard_tick(cfg, ws, banks, win, bl, *a, **kw):
            _, _, _, m, train = tick(cfg, ws, banks, win, bl, *a, **kw)
            return ws, win, bl, m, train
        monkeypatch.setattr(router, "_shard_tick", shard_tick)
    elif kind == "half_batch":
        def half(cfg, horizon, state, *a, **kw):
            out, st = run_one(cfg, horizon, state, *a, **kw)

            def fill(v):
                if not torch.is_tensor(v) or v.dim() == 0:
                    return v
                n = v.shape[0] // 2
                mean = v[:n].double().mean(0)
                v = v.clone()
                v[n:] = mean.to(v.dtype)
                return v
            return {k: ({kk: fill(vv) for kk, vv in v.items()}
                        if isinstance(v, dict) else fill(v))
                    for k, v in out.items()}, st
        monkeypatch.setattr(router, "_run_one", half)
    else:                                   # an answer altered at its tick
        def altered(*a, **kw):
            ws, win, bl, m, train = tick(*a, **kw)
            m = dict(m, done_all=m["done_all"] + 1)
            return ws, win, bl, m, train
        monkeypatch.setattr(router, "_shard_tick", altered)


def _encoder_fault(kind, monkeypatch):
    from repro_torch.embed import encoder
    from repro_torch.models import model
    embed = encoder._embed_batch
    if kind == "state_unchanged":
        def block(p, kind_, x, cache, cfg, ctx):
            return x, None, torch.zeros((), device=x.device)
        monkeypatch.setattr(model, "apply_block", block)
    elif kind == "half_batch":
        def half(cfg, params, tokens, lengths, pooling, proj):
            n = tokens.shape[0] // 2
            f = embed(cfg, params, tokens[:n], lengths[:n], pooling, proj)
            return torch.cat([f, f.mean(0, keepdim=True).expand(
                tokens.shape[0] - n, -1)])
        monkeypatch.setattr(encoder, "_embed_batch", half)
    else:                                   # two texts' answers swapped
        def swapped(*a, **kw):
            f = embed(*a, **kw)
            return f[torch.tensor([1, 0] + list(range(2, f.shape[0])))]
        monkeypatch.setattr(encoder, "_embed_batch", swapped)


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, kind, monkeypatch):
    if cell == "lm_embed.text":
        _encoder_fault(kind, monkeypatch)
    else:
        _stream_fault(kind, monkeypatch)
    run = run_small(cell, seed=2 ** 31 + 91)
    assert _fails(run), run["result"]["checks"]


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "answer_altered"])
def test_a_broken_bank_encoder_is_not_correct(kind, monkeypatch):
    _encoder_fault(kind, monkeypatch)
    run = run_small("lm_stream.bank", seed=2 ** 31 + 93)
    assert _fails(run), run["result"]["checks"]
    assert run["result"]["checks"]["bank_gap"]["value"] > \
        run["result"]["checks"]["bank_gap"]["limit"]


def test_the_comparisons_by_hand():
    from perfbench.drivers.encode_requests import feature_gap
    from perfbench.drivers.stream_sweep import compare
    nan = float("nan")
    got = {"n": torch.tensor([1, 2, 3]), "x": torch.tensor([1.0, 4.0, nan])}
    want = {"n": torch.tensor([1, 0, 0]), "x": torch.tensor([1.0, 2.0, nan])}
    # two integers differ; the float gap 2 over the largest magnitude 2
    assert compare(got, want) == {"int_mismatch": 2.0, "float_gap": 1.0}
    assert compare(got, {"n": want["n"]})["int_mismatch"] == 3.0
    assert compare({"x": torch.tensor([nan])},
                   {"x": torch.tensor([1.0])})["float_gap"] == float("inf")
    # texts of norms 3, 4, 5 (median 4), gaps 0, 0, 2: RMS of (0, 0, 0.5)
    ref = torch.tensor([[3.0, 0.0], [0.0, 4.0], [3.0, 4.0]])
    bad = ref.clone()
    bad[2, 0] += 2.0
    assert feature_gap(bad, ref) == pytest.approx((0.25 / 3) ** 0.5)
