"""The flagship ASR step's cell, ``asr_best.train``: what ``load_cell``
finds for it, which metrics it and the LM cells report, and its per-layer
readers on a made-up trace reduction and on a traced CPU run of its debug
cell. On the card (``cuda``), at the cell's own size: the control, the
reference computed with float8 operands, fails the cell's limits on three
seeds."""

from types import SimpleNamespace

import pytest
import torch

import run
from debug_cells import asr_cell
from families import asr as fam_asr, base
from harness import compare, manifest, trace

CELL = "asr_best.train"
LM_CELLS = ("lm_best.train", "lm_best.short")
SPANS = ("place", "features", "forward", "backward", "optimizer")
SPAN_METRICS = ["{}.asr.{}".format(k, s) for k in ("host_ms", "idle_ms")
                for s in SPANS]


def test_the_cell_resolves_to_its_files():
    cell = manifest.load_cell(CELL)
    assert cell.entry["chips"] == 1
    assert cell.config_entry["name"] == "asr_best"
    assert cell.config["family"] == "asr"
    assert cell.config["run"]["data"]["corpus"]["batch_size"] == 128
    assert cell.traffic["kind"] == "audio" and cell.traffic["rows"] == 64
    assert set(cell.limits["limits"]) == set(compare.NAMES)
    assert manifest.family_module(cell) is fam_asr


def test_the_cell_reports_utterances_and_the_lm_cells_do_not():
    cell = manifest.load_cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {"asr_utts_per_s",
                                                    "setup_s"}
    assert fam_asr.RATE_METRIC == "asr_utts_per_s"
    for m in cell.per_layer:
        assert m["moves"] == "asr_utts_per_s"
        assert m["workloads"] == [CELL]
    for name in LM_CELLS:
        lm = manifest.load_cell(name)
        names = [m["name"] for m in lm.end_to_end + lm.per_layer]
        assert "lm_tokens_per_s" in names
        assert not [n for n in names if "asr" in n], names


def _ctx(family="asr", steps=4):
    s = trace.Summary(
        2.0, 0.5,
        {"bilstm_resident_kernel<bf16>": (0.05, 20),
         "bilstm_bwd_resident_kernel<bf16>": (0.08, 20)}, 80000,
        {"place": (0.004, 4), "features": (0.012, 4), "forward": (0.9, 4),
         "backward": (0.3, 4), "optimizer": (0.2, 4)},
        [("forward", 0.8), ("optimizer", 0.1), ("host, no op", 0.02)])
    cfg = base.run_config(manifest.load_cell(CELL).config)
    prog = SimpleNamespace(model=cfg["model"], step_flops=lambda shape: 1e12)
    shapes = [{"B": 64, "frames": 1600, "T": 400, "L": 272}] * steps
    return SimpleNamespace(family=family, steps=steps, summary=s, prog=prog,
                           shapes=shapes)


@pytest.mark.parametrize("name", [m["name"] for m in
                                  manifest.load_cell(CELL).per_layer])
def test_each_reader_reads_an_asr_window_and_not_an_lm_one(name):
    reader = manifest.metric_reader(name)
    got = reader.read(_ctx())
    assert isinstance(got, float) and got >= 0.0, got
    assert reader.read(_ctx(family="lm")) is None


def test_the_span_readers_on_a_made_up_window():
    ctx = _ctx()
    read = {n: manifest.metric_reader(n).read(ctx) for n in SPAN_METRICS}
    assert read["host_ms.asr.forward"] == pytest.approx(225.0)
    assert read["idle_ms.asr.forward"] == pytest.approx(200.0)
    assert read["idle_ms.asr.optimizer"] == pytest.approx(25.0)
    # the span ran and no gap fell in it
    assert read["idle_ms.asr.place"] == 0.0
    assert read["idle_ms.asr.features"] == 0.0


def test_a_traced_cpu_run_of_the_asr_cell_reports_every_span():
    # the verdict at debug widths is test_harness_faults' to check: there
    # delta3, the worst small leaf after three near-sign Adadelta steps,
    # swings from seed to seed
    res = run.execute(asr_cell(), 2 ** 31 + 79, 0.3, True,
                      torch.device("cpu"))
    assert set(res["checks"]) == set(compare.NAMES)
    got = res["metrics"]
    for name in SPAN_METRICS:
        assert name in got, sorted(got)
        assert got[name]["unit"] == "ms" and got[name]["value"] >= 0.0
    assert sum(got["host_ms.asr." + s]["value"] for s in SPANS) > 0.0
    assert got["launches_per_step.asr"]["value"] >= 0.0


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size(card, tmp_path):
    cell = manifest.load_cell(CELL)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        prog = fam_asr.Program(cell, seed, card, str(tmp_path))
        prog.free()
        ref = fam_asr.reference_readings(prog, "f32")
        ctl = fam_asr.reference_readings(prog, "fp8")
        ok, checks = compare.judge(compare.numbers(ctl, ref),
                                   cell.limits["limits"])
        assert not ok, checks
