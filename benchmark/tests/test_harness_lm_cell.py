"""The 4x LSTM-1024 LM's cell, ``lm.train``: what ``load_cell`` finds for
it and which metrics it reports, the port against the plain reference
through its own configuration file at debug widths, and the readers of K5
(``k5f_roofline``, ``k5b_roofline``) on a made-up trace reduction, where
K6's launches of the same templates sit beside K5's. On the card
(``cuda``): a step at a reduced width launches K5 alone, K5f in its wide
form, and its first steps pass the cell's limits."""

from types import SimpleNamespace

import pytest
import torch

import run
from debug_cells import lm_cell
from families import base, lm as fam_lm
from harness import compare, flops, instances, manifest, trace

CELL = "lm.train"
LM_CELLS = ["lm_best.train", "lm_best.short", CELL]
SHARED = (["lm_tokens_per_s", "mfu_pct.lm", "device_idle_pct.lm",
           "adam_roofline"]
          + ["{}.lm.{}".format(k, s) for k in ("host_ms", "idle_ms")
             for s in ("place", "forward", "backward", "optimizer")])
K5 = ("k5f_roofline", "k5b_roofline")
K6 = ("k6f_roofline", "k6b_roofline")
CPU = torch.device("cpu")


def test_the_cell_resolves_to_the_recipe_as_published():
    cell = manifest.load_cell(CELL)
    assert cell.entry["chips"] == 1
    assert cell.entry["traffic"] == "sentences_long"
    assert cell.config_entry["name"] == "lm"
    assert cell.config_entry["reduced"] == [] and cell.config["reduced"] == []
    assert cell.config["family"] == "lm"
    run_cfg = cell.config["run"]
    assert run_cfg["model"] == {"emb_tying": True, "emb_dim": 1024,
                                "module": "LSTM", "dim": 1024, "n_layers": 4,
                                "dropout": 0.5}
    assert run_cfg["data"]["corpus"]["batch_size"] == 128
    assert run_cfg["data"]["corpus"]["train_split"] == ["train-clean-100"]
    assert (run_cfg["hparas"]["optimizer"], run_cfg["hparas"]["lr"]) == (
        "Adam", 1e-4)
    assert set(cell.limits["limits"]) == set(compare.NAMES)
    assert manifest.family_module(cell) is fam_lm


def test_the_cell_reports_k5_and_not_k6():
    cell = manifest.load_cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {"lm_tokens_per_s",
                                                    "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert set(SHARED) - {"lm_tokens_per_s"} <= names
    assert set(K5) <= names
    assert not names & set(K6)
    for m in cell.per_layer:
        assert m["moves"] == "lm_tokens_per_s"
    for other in ("lm_best.train", "lm_best.short"):
        got = {m["name"] for m in manifest.load_cell(other).per_layer}
        assert set(K6) <= got and not got & set(K5)


@pytest.mark.parametrize("name", SHARED + list(K5))
def test_each_lm_metric_lists_its_cells(name):
    declared = {m["name"]: m for m in manifest.manifest()["end_to_end"]
                + manifest.manifest()["per_layer"]}
    want = [CELL] if name in K5 else LM_CELLS
    assert declared[name]["workloads"] == want
    if name in K5:
        m = declared[name]
        assert (m["unit"], m["better"], m["source"], m["layer"],
                m["moves"]) == ("%", "higher", "device_trace",
                                "kernels (ops/kernels, csrc)",
                                "lm_tokens_per_s")


def test_the_port_follows_the_reference_through_the_cells_file(tmp_path):
    cell = lm_cell(CELL)
    assert cell.config_entry["file"] == "benchmark/configs/lm.json"
    prog = fam_lm.Program(cell, 2 ** 31 + 23, CPU, str(tmp_path))
    got = prog.check_steps()
    prog.free()
    ref = fam_lm.reference_readings(prog)
    nums = compare.numbers(got, ref)
    # the first step's loss: the port on the CPU computes in float32
    assert nums["loss1"][0] < 1e-4
    assert nums["grad1"][0] < cell.limits["limits"]["grad1"]


def test_last_template_argument():
    assert instances.last_argument(
        "lstm_fwd_chunked_kernel<__nv_bfloat16, 8>") == 8
    assert instances.last_argument(
        "lstm_bwd_chunked_kernel<__nv_bfloat16, __nv_bfloat16, 16>") == 16
    assert instances.last_argument("lstm_fwd_chunked_kernel<float>") is None
    assert instances.last_argument("nvjet_tst_192x192_64x3") is None


def _ctx(kernels, steps=2, family="lm", dim=1024):
    s = trace.Summary(2.0, 1.8, kernels, sum(n for _, n in kernels.values()),
                      {}, [])
    return SimpleNamespace(family=family, steps=steps, summary=s,
                           prog=SimpleNamespace(model={"dim": dim}),
                           shapes=[{"T": 160, "B": 128}] * steps)


# two steps' launches at T=160 B=128: K5 at 2.1 and 2.6 ms a launch, K6's
# instantiations of the same templates beside them at 3.2 and 4.1
WINDOW = {
    "lstm_fwd_chunked_kernel<__nv_bfloat16, 8>": (8 * 2.1e-3, 8),
    "lstm_fwd_chunked_kernel<__nv_bfloat16, 16>": (8 * 3.2e-3, 8),
    "lstm_bwd_chunked_kernel<__nv_bfloat16, __nv_bfloat16, 16>":
        (8 * 2.6e-3, 8),
    "lstm_bwd_chunked_kernel<__nv_bfloat16, float, 32>": (8 * 4.1e-3, 8),
    "lstm_pack_chunked_kernel<__nv_bfloat16, 8>": (8 * 1e-5, 8),
    "adam_multi_tensor_kernel<float, float>": (2 * 3e-4, 2),
}


@pytest.mark.parametrize("name,ms", [("k5f_roofline", 2.1),
                                     ("k5b_roofline", 2.6)])
def test_k5_readers_count_only_k5s_tiles(name, ms):
    # 2 * T * B * H * 4H operations over 989 TFLOP/s: 0.17371 ms a launch
    bound = 2 * 160 * 128 * 1024 * 4096 / 989e12 * 1e3
    assert flops.lstm_bound(160, 128, 1024, 1) == (
        pytest.approx(bound), "operations")
    got = manifest.metric_reader(name).read(_ctx(WINDOW))
    assert got == pytest.approx(100.0 * bound / ms, rel=1e-12)
    assert got == pytest.approx({2.1: 8.272, 2.6: 6.681}[ms], abs=1e-3)


@pytest.mark.parametrize("name", K5)
def test_k5_readers_read_nothing_without_k5(name):
    reader = manifest.metric_reader(name)
    k6_only = {k: WINDOW[k] for k in (
        "lstm_fwd_chunked_kernel<__nv_bfloat16, 16>",
        "lstm_bwd_chunked_kernel<__nv_bfloat16, float, 32>")}
    assert reader.read(_ctx(k6_only)) is None
    assert reader.read(_ctx({})) is None
    assert reader.read(_ctx(WINDOW, family="asr")) is None
    assert reader.read(_ctx(WINDOW, steps=0)) is None


def test_a_traced_cpu_run_of_the_cell_reads_no_kernel_rows():
    # the CPU runs the kernels' plain versions: K5's readers find nothing
    # and stay silent, the span readers read
    res = run.execute(lm_cell(CELL), 2 ** 31 + 81, 0.3, True, CPU)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert not set(K5) & set(got)
    assert "host_ms.lm.forward" in got and "device_idle_pct.lm" in got


def _reduced(cell):
    """The cell at a width K5 holds and a batch its wide form takes: two
    layers of 256 units, 32 rows."""
    cfg = dict(cell.config, run=dict(cell.config["run"]))
    cfg["run"]["model"] = dict(cfg["run"]["model"], emb_dim=256, dim=256,
                               n_layers=2)
    traffic = dict(cell.traffic, rows=32, pool=4)
    return cell._replace(config=cfg, traffic=traffic)


@pytest.mark.cuda
def test_a_step_on_the_card_launches_k5_wide_alone(card, tmp_path):
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as KL
    cell = _reduced(manifest.load_cell(CELL))
    assert KL.fits_resident(256, card) and KL.form_for(256, 32, card) == \
        "wide"
    prog = fam_lm.Program(cell, 2 ** 31 + 5, card, str(tmp_path))
    names = ("FWD_WIDE_LAUNCHES", "FWD_NARROW_LAUNCHES", "BWD_LAUNCHES",
             "FWD_CHUNKED_LAUNCHES", "BWD_CHUNKED_LAUNCHES")
    before = {n: getattr(KL, n) for n in names}
    got = prog.check_steps()
    torch.cuda.synchronize()
    steps = base.CHECKED_STEPS + base.WARM_STEPS
    launched = {n: getattr(KL, n) - before[n] for n in names}
    assert launched == {"FWD_WIDE_LAUNCHES": 2 * steps,
                        "FWD_NARROW_LAUNCHES": 0, "BWD_LAUNCHES": 2 * steps,
                        "FWD_CHUNKED_LAUNCHES": 0,
                        "BWD_CHUNKED_LAUNCHES": 0}, launched
    assert prog.failed() == 0
    prog.free()
    ref = fam_lm.reference_readings(prog)
    ok, checks = compare.judge(compare.numbers(got, ref),
                               cell.limits["limits"])
    assert ok, checks
