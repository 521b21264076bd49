"""The port's pure-CTC prefix beam search (``decode/ctc_beam.py``) against
the JAX package's ``ctc_beam_decode`` on the same log-posteriors, with and
without LM fusion: tokens and lengths equal, scores within 1e-4 (the same
f32 ops). The JAX LM path runs one utterance a call (its per-frame freeze
broadcasts a (B,) mask against the LM's (L,B,K,H) state on the layer axis,
ROADMAP queue 3, F6), so the port's batch is held row by row against it.
Then the cases of ``tests/test_ctc_beam.py`` (a brute-force oracle, empty
and short inputs) and the port's CLI decoding a CTC-only model."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from e2e_asr_pytorch_tpu.decode import ctc_beam as JB
from e2e_asr_pytorch_tpu.models import lm as JLM
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.decode import ctc_beam as TB
from e2e_asr_pytorch_tpu_torch.models import lm as TLM
from test_ctc_beam import _best_by_enumeration, ctc_label_logprob

SCORE_ATOL = 1e-4
B, T, V = 3, 12, 7
ENC_LEN = np.array([12, 8, 3])
LM_MODEL = dict(emb_tying=True, emb_dim=16, module="LSTM", dim=16,
                n_layers=2, dropout=0.0)
CFG = dict(beam_size=4, cand_size=4, max_tokens=9)


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, V)) * 2.0
    logp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    lspec = JLM.build_spec(V, **LM_MODEL)
    jl = JLM.lm_init(jax.random.PRNGKey(1), lspec)
    return dict(logp=logp, lspec=lspec, jl=jl,
                tlspec=TLM.build_spec(V, **LM_MODEL),
                tl=convert.from_jax_params(jax.tree.map(np.asarray, jl)))


def _port(s, logp, lm_weight):
    lm = (s["tl"], s["tlspec"]) if lm_weight else (None, None)
    out = TB.ctc_beam_decode(torch.from_numpy(logp),
                             torch.from_numpy(ENC_LEN),
                             TB.CTCBeamConfig(**CFG, lm_weight=lm_weight),
                             *lm)
    return {k: v.numpy() for k, v in out.items()}


def _jax(s, lm_weight, rows=slice(None)):
    lm = (s["jl"], s["lspec"]) if lm_weight else (None, None)
    out = JB.ctc_beam_decode(jnp.asarray(s["logp"][rows]),
                             jnp.asarray(ENC_LEN[rows]),
                             JB.CTCBeamConfig(**CFG, lm_weight=lm_weight),
                             *lm)
    return {k: np.asarray(v) for k, v in out.items()}


def _differences(j, t):
    """(tokens equal, lengths equal, max |score err|)."""
    return (np.array_equal(j["tokens"], t["tokens"]),
            np.array_equal(j["out_len"], t["out_len"]),
            float(np.abs(j["scores"] - t["scores"]).max()))


def test_ctc_beam_matches_jax(shared):
    t = _port(shared, shared["logp"], 0.0)
    tok, lens, err = _differences(_jax(shared, 0.0), t)
    assert tok and lens and err <= SCORE_ATOL, err
    assert (t["out_len"][:, 0] > 0).all()


def test_ctc_beam_vs_jax_fails_under_a_doubled_blank(shared):
    logp = shared["logp"].copy()
    logp[..., 0] *= 2.0
    tok, lens, err = _differences(_jax(shared, 0.0), _port(shared, logp, 0.0))
    assert not (tok and lens and err <= SCORE_ATOL)


def _with_lm_rows(s, port_weight):
    t = _port(s, s["logp"], port_weight)
    res = []
    for i in range(B):
        j = _jax(s, 0.3, rows=slice(i, i + 1))
        res.append(_differences(j, {k: v[i:i + 1] for k, v in t.items()}))
    return res


def test_ctc_beam_with_lm_matches_jax(shared):
    for tok, lens, err in _with_lm_rows(shared, 0.3):
        assert tok and lens and err <= SCORE_ATOL, err


def test_ctc_beam_with_lm_vs_jax_fails_under_a_doubled_lm_weight(shared):
    assert max(err for _, _, err in _with_lm_rows(shared, 0.6)) \
        > 100 * SCORE_ATOL


def test_ctc_beam_matches_bruteforce():
    rng = np.random.default_rng(0)
    t, v = 6, 4
    gaps = []
    for _ in range(5):
        x = rng.standard_normal((t, v)) * 2.0
        logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
        ref_seq, ref_lp = _best_by_enumeration(logp, t, v)
        out = TB.ctc_beam_decode(
            torch.tensor(logp[None], dtype=torch.float32), torch.tensor([t]),
            TB.CTCBeamConfig(beam_size=8, cand_size=v - 1, max_tokens=t))
        n = int(out["out_len"][0, 0])
        hyp = out["tokens"][0, 0, :n].tolist()
        exact = ctc_label_logprob(logp, hyp)
        # without cross-parent merging the tracked score underestimates the
        # exact sequence probability, never overestimates
        assert float(out["scores"][0, 0]) <= exact + 1e-3
        gaps.append(ref_lp - exact)
        assert ref_lp - exact < 0.8
    assert np.median(gaps) < 0.2


def test_ctc_beam_empty_and_short_inputs():
    logp = torch.full((2, 5, 4), -5.0)
    logp[:, :, 0] = -0.01
    out = TB.ctc_beam_decode(logp, torch.tensor([5, 1]),
                             TB.CTCBeamConfig(beam_size=3, cand_size=3,
                                              max_tokens=4))
    assert out["out_len"][:, 0].tolist() == [0, 0]
    s = out["scores"].numpy()
    assert (np.diff(s, axis=1) <= 1e-6).all()          # sorted


def test_cli_decodes_a_ctc_only_model_with_the_ctc_beam(tmp_path):
    """``--test`` with beam 2 + LM on a CTC-only model (``ctc_weight: 1``)
    takes the CTC prefix beam and writes the CSVs eval.py reads."""
    from e2e_asr_pytorch_tpu_torch.eval import main as score
    from e2e_asr_pytorch_tpu_torch.main import main
    from e2e_asr_pytorch_tpu_torch.models import asr as TM
    from e2e_asr_pytorch_tpu_torch.train import checkpoint as TC
    from test_torch_decode import MODEL, VOCAB, _write_configs
    cfg = _write_configs(tmp_path)
    model = dict(MODEL, ctc_weight=1.0)
    with open(tmp_path / "train.yaml") as f:
        train = yaml.safe_load(f)
    train["model"] = model
    with open(tmp_path / "train.yaml", "w") as f:
        yaml.safe_dump(train, f)
    TC.save_checkpoint(str(tmp_path / "asr.pth"), TM.asr_init(
        torch.Generator().manual_seed(3), TM.build_spec(120, VOCAB, **model)))
    solver = main(["--test", "--cpu", "--config", cfg, "--njobs", "0",
                   "--no-msg", "--outdir", str(tmp_path / "out")])
    assert not solver.spec.enable_att and solver.n_utts == 6
    out = tmp_path / "out"
    for split in ("dev", "test"):
        beam = (out / "test_sd0_{}_beam.csv".format(split)).read_text()
        assert len(beam.splitlines()) == 1 + 3 * 2
        wer, cer = score(["--file", os.path.join(
            out, "test_sd0_{}_output.csv".format(split))])
        assert wer >= 0.0 and cer >= 0.0
