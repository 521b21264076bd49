"""The readers of the LM step's spans (``host_ms.lm.*``, ``idle_ms.lm.*``):
on a made-up trace reduction, and on a traced run of the debug LM cell on
the CPU."""

from types import SimpleNamespace

import pytest
import torch

import run
from debug_cells import lm_cell
from harness import manifest, trace

SPANS = ("place", "forward", "backward", "optimizer")
NAMES = ["{}.lm.{}".format(k, s) for k in ("host_ms", "idle_ms")
         for s in SPANS]


def _ctx(family="lm", steps=4, spans=None, gaps=()):
    spans = {"place": (0.008, 4), "forward": (0.040, 4),
             "backward": (0.020, 4), "optimizer": (0.012, 4)} \
        if spans is None else spans
    s = trace.Summary(1.0, 0.9, {}, 0, spans, list(gaps))
    return SimpleNamespace(family=family, steps=steps, summary=s)


def _read(name, ctx):
    return manifest.metric_reader(name).read(ctx)


def test_the_eight_are_declared_for_both_lm_cells():
    declared = {m["name"]: m for m in manifest.manifest()["per_layer"]}
    for name in NAMES:
        m = declared[name]
        assert (m["source"], m["unit"], m["better"], m["moves"]) == (
            "program_span", "ms", "lower", "lm_tokens_per_s")
        assert m["workloads"] == ["lm_best.train", "lm_best.short"]


@pytest.mark.parametrize("span", SPANS)
def test_readers_of_a_span_on_a_made_up_window(span):
    # the gap named after the span, another span's, and the host's own
    ctx = _ctx(gaps=[(span, 0.006), ("host, no op", 0.05),
                     ("aten::mul", 0.01)])
    host, idle = "host_ms.lm." + span, "idle_ms.lm." + span
    assert _read(host, ctx) == pytest.approx(
        1e3 * ctx.summary.spans[span][0] / 4)
    assert _read(idle, ctx) == pytest.approx(1.5)
    # the span ran and no gap fell in it
    quiet = _ctx(gaps=[("host, no op", 0.05)])
    assert _read(idle, quiet) == 0.0
    # the span is absent from the trace (a program without it)
    spans = {k: v for k, v in ctx.summary.spans.items() if k != span}
    absent = _ctx(spans=spans, gaps=[("host, no op", 0.05)])
    assert _read(host, absent) is None and _read(idle, absent) is None
    # another family's cell, a window of no step
    for other in (_ctx(family="asr", gaps=ctx.summary.gaps),
                  _ctx(steps=0, gaps=ctx.summary.gaps)):
        assert _read(host, other) is None and _read(idle, other) is None


def test_a_traced_cpu_run_of_the_lm_cell_reports_all_eight():
    res = run.execute(lm_cell(), 2 ** 31 + 77, 0.3, True,
                      torch.device("cpu"))
    assert res["correct"], res["checks"]
    got = res["metrics"]
    for name in NAMES:
        assert name in got, sorted(got)
        assert got[name]["unit"] == "ms" and got[name]["value"] >= 0.0
    assert sum(got["host_ms.lm." + s]["value"] for s in SPANS) > 0.0
