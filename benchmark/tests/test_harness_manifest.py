"""BENCHMARK.json in the form its checker takes (keys, names, units,
bounds), every name resolving to its file, and a cell added by new files
alone."""

import json
import re
import shutil

import pytest

from harness import manifest

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.manifest()


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_entries_have_the_required_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert UNIT.match(m["unit"]), m["unit"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_are_unique_and_well_formed():
    groups = [BENCH["configs"], BENCH["workloads"],
              BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in groups:
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        cell = manifest.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_every_name_resolves_to_its_file():
    for c in BENCH["configs"]:
        cfg = manifest.load_json(ROOT / c["file"])
        assert (ROOT / "benchmark" / "families"
                / (cfg["family"] + ".py")).exists()
        assert (ROOT / "benchmark" / "reference"
                / (cfg["family"] + ".py")).exists()
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in BENCH["workloads"]:
        cell = manifest.load_cell(w["name"])
        assert set(cell.limits["limits"]) == {"loss1", "loss", "grad1",
                                              "delta3"}
        assert cell.traffic["kind"] in ("text", "audio")
    for m in BENCH["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]).read)


def test_a_cell_dropped_into_a_copy_is_found(tmp_path):
    """A new traffic mix, cell and per-layer metric are new files and new
    entries; nothing already there is edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    traffic = json.loads((ROOT / "benchmark" / "traffic"
                          / "sentences_long.json").read_text())
    traffic.update(min_tokens=200, max_tokens=300)
    (tmp_path / "benchmark" / "traffic" / "sentences_longer.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark" / "workloads" / "lm_best.longer.json").write_text(
        (ROOT / "benchmark" / "workloads" / "lm_best.train.json").read_text())
    (tmp_path / "benchmark" / "metrics" / "steps_seen.lm.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    bench["workloads"].append({"name": "lm_best.longer", "config": "lm_best",
                               "traffic": "sentences_longer", "chips": 1,
                               "why": "longer rows"})
    bench["end_to_end"][0]["workloads"].append("lm_best.longer")
    bench["per_layer"].append({"name": "steps_seen.lm", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "step", "moves": "lm_tokens_per_s",
                               "workloads": ["lm_best.longer"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = manifest.load_cell("lm_best.longer", root=tmp_path)
    assert cell.traffic["max_tokens"] == 300
    assert [m["name"] for m in cell.per_layer] == ["steps_seen.lm"]
    reader = manifest.metric_reader("steps_seen.lm", root=tmp_path)
    assert reader.read(type("Ctx", (), {"steps": 7})) == 7.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        manifest.load_cell("no_such.cell")


def test_configs_state_the_run_and_the_cut():
    for c in BENCH["configs"]:
        cfg = manifest.load_json(ROOT / c["file"])
        assert cfg["source"] == c["source"]
        assert {"data", "hparas", "model"} <= set(cfg["run"])
        assert (ROOT / cfg["run"]["data"]["text"]["vocab_file"]).exists()
        assert "assumed" in cfg
