"""The FLOP and byte counters against hand counts, the traffic generator's
promises, and the trace reduction on events made by hand."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from harness import flops, manifest, readers, trace, traffic


def test_lstm_layer_at_the_flagship_lm_shape():
    # 2 * T * B * (in + H) * 4H at T=160, B=128, in = H = 2048
    assert flops.lstm_layer_flops(160, 128, 2048, 2048) == \
        2 * 160 * 128 * 4096 * 8192
    assert flops.lstm_layer_flops(160, 128, 2048, 2048) / 1e12 == \
        pytest.approx(1.374, abs=5e-4)


def test_lm_step_is_three_forwards_of_the_stack_and_projection():
    model = {"emb_dim": 2048, "dim": 2048, "n_layers": 4}
    fwd = 4 * 2 * 160 * 128 * 4096 * 8192 + 2 * 160 * 128 * 2048 * 31
    assert flops.lm_step_flops(model, 31, 160, 128) == 3 * fwd
    assert flops.lm_step_flops(model, 31, 160, 128) / 1e12 == \
        pytest.approx(16.50, abs=5e-3)


def test_recurrence_bounds_match_the_hand_count():
    # K6 at T=160 B=128 H=2048: 2*T*B*H*4H operations over 989 TFLOP/s
    ms, by = flops.lstm_bound(160, 128, 2048, 1)
    assert by == "operations"
    assert ms == pytest.approx(2 * 160 * 128 * 2048 * 8192 / 989e12 * 1e3)
    assert ms == pytest.approx(0.695, abs=5e-4)
    # K1 at the 16-row shape, both directions: the port's table's 0.170 ms
    assert flops.lstm_bound(400, 16, 1280, 2)[0] == pytest.approx(0.170,
                                                                  abs=5e-4)
    # a tiny recurrence is bound by its bytes: bf16 streams in and out
    ms, by = flops.lstm_bound(4, 2, 8, 1)
    nbytes = 4 * 2 * (32 * 4 + 8 * 4) + 8 * 32 * 2
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_asr_step_at_a_small_shape_by_hand():
    model = {"encoder": {"dim": [4]},
             "attention": {"dim": 3, "loc_kernel_size": 1,
                           "loc_kernel_num": 2},
             "decoder": {"dim": 5, "layer": 2}}
    b, frames, steps, v = 2, 8, 3, 7
    conv = 2 * b * 9 * (8 * 40 * 3 * 64 + 8 * 40 * 64 * 64
                        + 4 * 20 * 64 * 128 + 4 * 20 * 128 * 128)
    te, d0 = 2, 1280
    enc = 2 * (2 * te * b * (d0 + 4) * 16) + 2 * te * b * 8 * 8
    heads = 2 * te * b * 8 * v + 2 * te * b * 8 * 3
    per = (2 * b * 10 * 3 + 2 * b * te * 3 * 2 + 2 * b * te * 2 * 3
           + 2 * b * te * 3 + 2 * b * te * 8 + 2 * b * (13 + 5) * 20
           + 2 * b * (5 + 5) * 20 + 2 * b * 5 * v)
    want = 3 * (conv + enc + heads + steps * per)
    assert flops.asr_step_flops(model, v, 120, b, frames, steps) == want


def test_text_traffic_keeps_the_work_of_every_seed():
    p = json.loads((manifest.ROOT / "benchmark" / "traffic"
                    / "sentences_long.json").read_text())
    a = traffic.batches(p, 31, 2 ** 31 + 7, 3)
    b = traffic.batches(p, 31, 12345, 3)
    for x, y in zip(a, b):
        assert x["txt"].shape == y["txt"].shape == (128, 160)
        assert sorted(x["txt_len"]) == sorted(y["txt_len"])
        assert int((x["txt"] != 0).sum()) == int(x["txt_len"].sum())
    assert not np.array_equal(a[0]["txt"], b[0]["txt"])
    again = traffic.batches(p, 31, 2 ** 31 + 7, 1)
    assert np.array_equal(again[0]["txt"], a[0]["txt"])
    ends = a[0]["txt"][np.arange(128), a[0]["txt_len"] - 1]
    assert (ends == traffic.EOS).all()


def test_audio_traffic_lands_in_one_bucket_with_alignments():
    p = json.loads((manifest.ROOT / "benchmark" / "traffic"
                    / "speech_long.json").read_text())
    p = dict(p, rows=8)
    for k, batch in enumerate(traffic.batches(p, 31, 2 ** 31 + 3, 2)):
        assert batch["wav"].shape == (8, 256000)
        assert batch["txt"].shape == (8, 272)
        frames = 1 + (batch["wav_len"] - 1) // 160
        # the longer transcript goes to the longer utterance: CTC has an
        # alignment for every row (labels within the encoder's frames)
        assert (batch["txt_len"] < frames // 4).all()
        order = np.argsort(batch["wav_len"])
        assert (np.diff(batch["txt_len"][order]) >= 0).all()


def test_trace_union_gaps_and_kernel_names():
    merged = trace._merge([(0, 10), (5, 20), (30, 40), (40, 41)])
    assert merged == [[0, 20], [30, 41]]
    top = trace._top_level([(0, 100, "outer", 1), (10, 20, "inner", 1),
                            (150, 160, "next", 1)])
    assert [n for _, _, n in top] == ["outer", "next"]
    assert trace.short_name("void (anonymous namespace)::k<float>(int*)") \
        == "k<float>"
    s = trace.Summary(2.0, 1.5, {"lstm_fwd_chunked_kernel<bf16>": (0.3, 4),
                                 "other": (1.2, 10)}, 14, {}, [])
    assert trace.kernel_time(s, ("lstm_fwd_chunked_kernel",)) == (0.3, 4)


def test_readers_on_a_made_up_window():
    s = trace.Summary(2.0, 1.5, {"lstm_fwd_chunked_kernel<bf16>": (0.01, 4)},
                      4, {"forward": (0.5, 2)}, [])
    prog = SimpleNamespace(model={"dim": 2048},
                           step_flops=lambda shape: 1e12)
    ctx = SimpleNamespace(family="lm", steps=2, summary=s, prog=prog,
                          shapes=[{"T": 160, "B": 128}] * 2)
    assert readers.idle_pct(ctx, "lm") == pytest.approx(25.0)
    assert readers.idle_pct(ctx, "asr") is None
    assert readers.mfu_pct(ctx, "lm") == pytest.approx(
        100 * 2e12 / 2.0 / 989e12)
    per = flops.lstm_bound(160, 128, 2048, 1)[0]
    got = readers.roofline_pct(
        ctx, ("lstm_fwd_chunked_kernel",),
        lambda sh: flops.lstm_bound(sh["T"], sh["B"], 2048, 1)[0])
    assert got == pytest.approx(100 * per * 1e-3 * 4 / 0.01)
    assert readers.roofline_pct(ctx, ("absent",), lambda sh: 1.0) is None
    assert readers.span_ms(ctx, "lm", "forward") == pytest.approx(250.0)
