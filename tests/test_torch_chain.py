"""The dataset-free train -> decode -> score chain through the port alone,
on the CPU: the port's CLI trains ``config/synthetic_debug.yaml`` (a
1-layer decoder, CTC weight 0.5; only max_step, valid_step and the
directories overridden), decodes a copy of ``config/synthetic_test.yaml``
(beam 4, joint CTC 0.3) whose ``src.ckpt`` points at the checkpoint it
wrote, and scores both CSVs with its own scorer, in a fresh process that
never imports JAX. The port's scorer must give the numbers of the repo's
``eval.py`` / ``eval_beam.py`` on the same CSVs, an empty hypothesis
included."""

import json
import os
import subprocess
import sys

import pytest
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "smoke"
CHAIN = r"""
import json, sys
from e2e_asr_pytorch_tpu_torch.eval import main as score
from e2e_asr_pytorch_tpu_torch.main import main
tmp = sys.argv[1]
trained = main(["--config", "config/synthetic_debug.yaml", "--name", "smoke",
                "--cpu", "--njobs", "0", "--logdir", tmp + "/log",
                "--ckpdir", tmp + "/ckpt", "--override", "hparas.max_step=2",
                "hparas.valid_step=2"])
tester = main(["--test", "--config", tmp + "/test.yaml", "--name", "smoke",
               "--cpu", "--njobs", "0", "--outdir", tmp + "/out"])
scores = {}
for split in ("dev", "test"):
    stem = "{}/out/smoke_{}_".format(tmp, split)
    scores[split] = [score(["--file", stem + "output.csv"]),
                     score(["--beam", "--file", stem + "beam.csv"])]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "e2e_asr_pytorch_tpu"))
print("CHAIN " + json.dumps(dict(
    step=trained.step, n_valid=trained.n_valid_batches,
    layers=trained.spec.decoder.layer, n_utts=tester.n_utts,
    beam=tester.beam_size, ctc_weight=tester.dec_ctc_weight,
    scores=scores, jax=bad)))
"""


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The chain run once in a fresh process from the repo root (the
    configs' relative paths are the repo's); its stdout and directory."""
    tmp = tmp_path_factory.mktemp("chain")
    with open(os.path.join(ROOT, "config", "synthetic_test.yaml")) as f:
        test = yaml.safe_load(f)
    test["src"]["ckpt"] = str(tmp / "ckpt" / NAME / "last_att_dev.pth")
    with open(tmp / "test.yaml", "w") as f:
        yaml.safe_dump(test, f)
    # one intra-op thread: the chain is tens of thousands of tiny ops, and
    # beside the other test workers a thread pool per op oversubscribes
    # the host's cores
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", CHAIN, str(tmp)], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-4000:])
    line = [l for l in res.stdout.splitlines() if l.startswith("CHAIN ")]
    return json.loads(line[-1][len("CHAIN "):]), res.stdout, tmp


def test_chain_trains_decodes_and_scores_through_the_port(chain):
    got, stdout, tmp = chain
    assert got["jax"] == [], got["jax"]
    assert got["step"] == 2 and got["n_valid"] > 0 and got["layers"] == 1
    assert (got["n_utts"], got["beam"], got["ctc_weight"]) == (32, 4, 0.3)
    assert "Joint CTC decoding enabled" in stdout
    assert (tmp / "ckpt" / NAME / "last_att_dev.pth").exists()
    for split in ("dev", "test"):
        rows = (tmp / "out" / "smoke_{}_output.csv".format(split)
                ).read_text().splitlines()
        beam = (tmp / "out" / "smoke_{}_beam.csv".format(split)
                ).read_text().splitlines()
        assert rows[0] == "idx\thyp\ttruth" and len(rows) == 1 + 16
        assert beam[0] == "idx\tbeam\thyp\ttruth" and len(beam) == 1 + 16 * 4
        (wer, cer), (o_wer, o_cer) = got["scores"][split]
        assert 0.0 <= o_wer <= wer and 0.0 <= o_cer <= cer


def _csv_cases(tmp):
    """The chain's four CSVs and two with an empty hypothesis."""
    out = tmp / "out"
    cases = {"{}_{}".format(s, kind): (out / "smoke_{}_{}.csv".format(s, kind),
                                       kind == "beam")
             for s in ("dev", "test") for kind in ("output", "beam")}
    empty = tmp / "empty_output.csv"
    empty.write_text("idx\thyp\ttruth\nu1\t\tA B\nu2\tA C\tA B\n"
                     "u3\tXY\tXYZ W\n")
    empty_beam = tmp / "empty_beam.csv"
    empty_beam.write_text("idx\tbeam\thyp\ttruth\nu1\t0\t\tA B\nu1\t1\tA\tA B"
                          "\nu2\t0\tQ\tQ R\nu2\t1\t\tQ R\n")
    cases["empty_output"] = (empty, False)
    cases["empty_beam"] = (empty_beam, True)
    return cases


def _scores(tmp, case, reader=None):
    """(the port's scores, the repo's eval.py / eval_beam.py scores)."""
    sys.path.insert(0, ROOT)
    import eval as eval_tool
    import eval_beam
    from e2e_asr_pytorch_tpu_torch import eval as port
    path, beam = _csv_cases(tmp)[case]
    sound = port.read_tsv
    if reader is not None:
        port.read_tsv = reader
    try:
        got = port.main((["--beam"] if beam else []) + ["--file", str(path)])
    finally:
        port.read_tsv = sound
    want = (eval_beam if beam else eval_tool).main(["--file", str(path)])
    return got, want


@pytest.mark.parametrize("case", ["dev_output", "test_output", "dev_beam",
                                  "test_beam", "empty_output", "empty_beam"])
def test_port_scorer_gives_the_repo_scorers_numbers(chain, case):
    got, want = _scores(chain[2], case)
    assert got == pytest.approx(want, rel=1e-12, abs=0.0), (got, want)


def test_port_scorer_vs_repo_fails_when_empty_hypotheses_drop(chain):
    """A reader that loses the rows of empty hypotheses (pandas' default
    NaN handling, then a dropna) must give other numbers."""
    from e2e_asr_pytorch_tpu_torch import eval as port
    sound = port.read_tsv

    def dropping(path):
        return [r for r in sound(path) if r["hyp"]]
    got, want = _scores(chain[2], "empty_output", reader=dropping)
    assert got != pytest.approx(want, rel=1e-3)
