"""Port of the decode slice against the JAX package on shared weights:
greedy, beam-4 + LM shallow fusion, and beam-4 with joint CTC prefix
scoring (ctc_weight 0.3, with and without LM 0.3) give EQUAL tokens and
avg_scores within 1e-4 (f32 throughout; the JAX encoder runs its Pallas K1
in interpret mode so both sides take the recurrent matmul in bf16). Also:
top-k tie order, the port's CLI writing the CSVs that eval.py reads,
checkpoint round trip, and a CPU decode through the port importing no
JAX."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from e2e_asr_pytorch_tpu.decode import beam as JB
from e2e_asr_pytorch_tpu.decode import greedy as JG
from e2e_asr_pytorch_tpu.models import asr as JM
from e2e_asr_pytorch_tpu.models import lm as JLM
from e2e_asr_pytorch_tpu.ops.pallas import lstm as PL
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.decode import beam as TB
from e2e_asr_pytorch_tpu_torch.decode import greedy as TG
from e2e_asr_pytorch_tpu_torch.models import asr as TM
from e2e_asr_pytorch_tpu_torch.models import lm as TLM
from e2e_asr_pytorch_tpu_torch.train import checkpoint as TC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_ATOL = 1e-4
VOCAB = 31
MODEL = dict(
    ctc_weight=0.5,
    encoder=dict(vgg=5, vgg_freq=-1, vgg_low_filt=-1, module="LSTM",
                 bidirection=True, dim=[32, 32], dropout=[0.0, 0.0],
                 layer_norm=[False, False], proj=[True, True],
                 sample_rate=[1, 1], sample_style="drop"),
    attention=dict(mode="loc", dim=16, num_head=1, v_proj=False,
                   temperature=0.5, loc_kernel_size=5, loc_kernel_num=3),
    decoder=dict(module="LSTM", dim=32, layer=2, dropout=0.0))
LM_MODEL = dict(emb_tying=True, emb_dim=32, module="LSTM", dim=32,
                n_layers=2, dropout=0.0)


@pytest.fixture
def jax_kernel(monkeypatch):
    monkeypatch.setenv("E2E_ASR_PALLAS", "force")
    monkeypatch.setattr(PL, "INTERPRET", True)


@pytest.fixture(scope="module")
def shared():
    """JAX-initialised ASR + LM weights, carried into the port, and a batch
    of 120-dim features (fbank40 + deltas layout)."""
    spec = JM.build_spec(120, VOCAB, **MODEL)
    jp = JM.asr_init(jax.random.PRNGKey(0), spec)
    lspec = JLM.build_spec(VOCAB, **LM_MODEL)
    jl = JLM.lm_init(jax.random.PRNGKey(1), lspec)
    rng = np.random.default_rng(0)
    feat = rng.uniform(0.0, 1.0, (2, 48, 120)).astype(np.float32)
    feat_len = np.array([48, 37], np.int32)
    return dict(spec=spec, jp=jp, lspec=lspec, jl=jl, feat=feat,
                feat_len=feat_len,
                tspec=TM.build_spec(120, VOCAB, **MODEL),
                tp=convert.from_jax_params(jax.tree.map(np.asarray, jp)),
                tlspec=TLM.build_spec(VOCAB, **LM_MODEL),
                tl=convert.from_jax_params(jax.tree.map(np.asarray, jl)))


def test_greedy_tokens_equal_jax(jax_kernel, shared):
    s = shared
    jo = JG.greedy_decode(s["jp"], s["spec"], jnp.asarray(s["feat"]),
                          jnp.asarray(s["feat_len"]), 9)
    to = TG.greedy_decode(s["tp"], s["tspec"], torch.from_numpy(s["feat"]),
                          torch.from_numpy(s["feat_len"]).long(), 9)
    np.testing.assert_array_equal(np.asarray(jo["att_tokens"]),
                                  to["att_tokens"].numpy())
    np.testing.assert_array_equal(np.asarray(jo["ctc_tokens"]),
                                  to["ctc_tokens"].numpy())


def test_greedy_fails_under_doubled_decoder_weight(jax_kernel, shared):
    s = shared
    tp = dict(s["tp"], decoder=dict(s["tp"]["decoder"]))
    layers = [dict(p) for p in tp["decoder"]["layers"]]
    layers[0]["w_x"] = layers[0]["w_x"] * 2.0
    tp["decoder"]["layers"] = layers
    jo = JG.greedy_decode(s["jp"], s["spec"], jnp.asarray(s["feat"]),
                          jnp.asarray(s["feat_len"]), 9)
    to = TG.greedy_decode(tp, s["tspec"], torch.from_numpy(s["feat"]),
                          torch.from_numpy(s["feat_len"]).long(), 9)
    assert not np.array_equal(np.asarray(jo["att_tokens"]),
                              to["att_tokens"].numpy())


def test_ctc_greedy_collapse_equals_jax():
    from e2e_asr_pytorch_tpu.ops.ctc import ctc_greedy_collapse as jax_collapse
    from e2e_asr_pytorch_tpu_torch.ops.ctc import ctc_greedy_collapse
    ids = np.random.default_rng(5).integers(0, 4, (6, 17)).astype(np.int32)
    ids[0] = 0
    np.testing.assert_array_equal(np.asarray(jax_collapse(jnp.asarray(ids))),
                                  ctc_greedy_collapse(
                                      torch.from_numpy(ids)).numpy())


def _beam_both(s, lm_weight_port=0.3, beam=4, eos_threshold=1.5,
               max_steps=12, ctc_weight=0.0, lm_weight=0.3):
    cfg = dict(beam_size=beam, min_len_ratio=0.05, max_len_ratio=0.25,
               ctc_weight=ctc_weight, lm_weight=lm_weight,
               eos_threshold=eos_threshold, max_steps=max_steps)
    jo = JB.beam_decode(s["jp"], s["spec"], JB.BeamConfig(**cfg),
                        jnp.asarray(s["feat"]), jnp.asarray(s["feat_len"]),
                        s["jl"], s["lspec"])
    cfg["lm_weight"] = lm_weight_port
    to = TB.beam_decode(s["tp"], s["tspec"], TB.BeamConfig(**cfg),
                        torch.from_numpy(s["feat"]),
                        torch.from_numpy(s["feat_len"]).long(), s["tl"],
                        s["tlspec"])
    return jo, to


def test_beam_with_lm_equals_jax(jax_kernel, shared):
    jo, to = _beam_both(shared)
    np.testing.assert_array_equal(np.asarray(jo["tokens"]),
                                  to["tokens"].numpy())
    np.testing.assert_array_equal(np.asarray(jo["out_len"]),
                                  to["out_len"].numpy())
    err = np.abs(np.asarray(jo["avg_scores"]) - to["avg_scores"].numpy())
    assert float(err.max()) <= SCORE_ATOL
    assert np.isfinite(to["avg_scores"].numpy()[:, 0]).all()


def test_beam_fails_under_doubled_lm_weight(jax_kernel, shared):
    jo, to = _beam_both(shared, lm_weight_port=0.6)
    err = np.abs(np.asarray(jo["avg_scores"]) - to["avg_scores"].numpy())
    assert float(err.max()) > 100 * SCORE_ATOL


@pytest.mark.parametrize("lm_weight", [0.0, 0.3])
def test_joint_ctc_beam_equals_jax(jax_kernel, shared, lm_weight):
    jo, to = _beam_both(shared, lm_weight_port=lm_weight, ctc_weight=0.3,
                        lm_weight=lm_weight)
    np.testing.assert_array_equal(np.asarray(jo["tokens"]),
                                  to["tokens"].numpy())
    np.testing.assert_array_equal(np.asarray(jo["out_len"]),
                                  to["out_len"].numpy())
    err = np.abs(np.asarray(jo["avg_scores"]) - to["avg_scores"].numpy())
    assert float(err.max()) <= SCORE_ATOL
    assert np.isfinite(to["avg_scores"].numpy()[:, 0]).all()


def test_joint_ctc_beam_fails_when_psi_prev_flips_sign(jax_kernel, shared,
                                                       monkeypatch):
    """The CTC term psi - psi_prev with psi_prev's sign flipped: the
    taken token's psi (one candidate a beam) comes back negated."""
    from e2e_asr_pytorch_tpu_torch.ops import ctc_prefix as TP
    sound = TP.score_psi

    def flipped(*args):
        psi = sound(*args)
        return -psi if args[4].shape[-1] == 1 else psi
    monkeypatch.setattr(TP, "score_psi", flipped)
    jo, to = _beam_both(shared, lm_weight_port=0.0, ctc_weight=0.3,
                        lm_weight=0.0)
    err = np.abs(np.asarray(jo["avg_scores"]) - to["avg_scores"].numpy())
    assert float(err.max()) > 100 * SCORE_ATOL


def test_beam_tie_order_equals_jax(jax_kernel, shared):
    """One step of beam 30 over a 31-token vocab: only beam 0 is alive, all
    30 non-<sos> tokens are its candidates, and an <eos> threshold that every
    <eos> passes consumes the <eos> below min_len. That leaves 29 live
    hypotheses, so the 30th output row is a NEG_INF tie between the empty
    finished-pool rows and a dead beam; ties toward the lower index pick
    the finished-pool row. All rows, that one included, must equal JAX's."""
    jo, to = _beam_both(shared, beam=30, eos_threshold=100.0, max_steps=1)
    assert (to["avg_scores"].numpy()[:, -1] < -1e29).all()
    np.testing.assert_array_equal(np.asarray(jo["tokens"]),
                                  to["tokens"].numpy())
    np.testing.assert_array_equal(np.asarray(jo["out_len"]),
                                  to["out_len"].numpy())


def test_cast_matmul_weights_is_the_per_use_cast(shared):
    """The solver casts matmul weights to the compute dtype once; a bf16
    beam decode must give exactly what the per-use casts give."""
    s = shared
    cfg = TB.BeamConfig(beam_size=3, min_len_ratio=0.05, max_len_ratio=0.25,
                        lm_weight=0.3, max_steps=6)
    outs = []
    for cast in (False, True):
        tp, tl = s["tp"], s["tl"]
        if cast:
            tp = convert.cast_matmul_weights(tp, torch.bfloat16)
            tl = convert.cast_matmul_weights(tl, torch.bfloat16)
        outs.append(TB.beam_decode(tp, s["tspec"], cfg,
                                   torch.from_numpy(s["feat"]),
                                   torch.from_numpy(s["feat_len"]).long(),
                                   tl, s["tlspec"],
                                   compute_dtype=torch.bfloat16))
    cast_tp = convert.cast_matmul_weights(s["tp"], torch.bfloat16)
    assert cast_tp["decoder"]["layers"][0]["w_x"].dtype == torch.bfloat16
    assert cast_tp["decoder"]["layers"][0]["b"].dtype == torch.float32
    assert cast_tp["pre_embed"].dtype == torch.float32
    for k in ("tokens", "avg_scores", "out_len"):
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_top_k_breaks_ties_like_lax():
    x = np.array([[0.0, 1.0, 1.0, -1e30, 1.0, -1e30, -1e30, 0.0]],
                 np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    tv, ti = TB._top_k(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_unported_decode_options_raise(shared):
    """Nothing raises at decode any more: the emb-fusion plugin that did
    is ported (held against JAX in test_torch_plugin.py). Here a fusing
    plugin with a fixed lambda of 0 (fused = log(softmax + 1e-8)) must give
    the unfused greedy and beam tokens."""
    from e2e_asr_pytorch_tpu_torch.models import plugin as TP
    s = shared
    cfg = TB.BeamConfig(beam_size=2, min_len_ratio=0.0, max_len_ratio=0.2,
                        ctc_weight=0.3, max_steps=4)
    feat = torch.from_numpy(s["feat"])
    feat_len = torch.from_numpy(s["feat_len"]).long()
    dec = s["tspec"].decoder.dim
    gen = torch.Generator().manual_seed(0)
    spec = TP.EmbPluginSpec(dim=4, dec_dim=dec, distance="CosEmb", weight=1.0,
                            fuse=1e-9, temperature=1.0, freeze=True,
                            fuse_normalize=False, dropout=0.0,
                            vocab_size=VOCAB)
    params = {"net1": {"w": torch.randn(dec, 6, generator=gen),
                       "b": torch.zeros(6)},
              "net2": {"w": torch.randn(6, 4, generator=gen),
                       "b": torch.zeros(4)},
              "fuse_lambda": torch.zeros(1), "temp": torch.ones(1),
              "emb_table": torch.randn(VOCAB, 4, generator=gen)}
    reg = TP.EmbeddingRegularizer(spec, params)
    assert reg.apply_fuse
    plain = TB.beam_decode(s["tp"], s["tspec"], cfg, feat, feat_len)
    fused = TB.beam_decode(s["tp"], s["tspec"], cfg, feat, feat_len,
                           emb_reg=reg, emb_params=params)
    np.testing.assert_array_equal(plain["tokens"].numpy(),
                                  fused["tokens"].numpy())
    plain = TG.greedy_decode(s["tp"], s["tspec"], feat, feat_len, 4)
    fused = TG.greedy_decode(s["tp"], s["tspec"], feat, feat_len, 4,
                             emb_reg=reg, emb_params=params)
    np.testing.assert_array_equal(plain["att_tokens"].numpy(),
                                  fused["att_tokens"].numpy())


def test_checkpoint_round_trip(tmp_path, shared):
    path = str(tmp_path / "m.pth")
    TC.save_checkpoint(path, shared["tl"], step=7, metric_name="ppx",
                       metric_value=2.5)
    ck = TC.load_checkpoint(path)
    assert ck["global_step"] == 7 and ck["metric_value"] == 2.5
    a = convert.tree_leaves(ck["model"])
    b = convert.tree_leaves(shared["tl"])
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------- the CLI
def _write_configs(tmp_path):
    """A tiny flagship-shaped recipe on the synthetic corpus, seeded port
    checkpoints for the ASR model and the LM, and a test config."""
    vocab_file = os.path.join(ROOT, "corpus", "librispeech_char.txt")
    train_cfg = {
        "data": {"corpus": {"name": "synthetic", "path": "",
                            "train_split": ["train"], "dev_split": ["dev"],
                            "bucketing": True, "batch_size": 2},
                 "audio": {"feat_type": "fbank", "feat_dim": 40,
                           "apply_cmvn": False, "delta_order": 2,
                           "delta_window_size": 2, "frame_length": 25,
                           "frame_shift": 10, "ref_level_db": 20,
                           "min_level_db": -100, "preemphasis_coeff": 0.97,
                           "augment": False, "time_aug": False},
                 "text": {"mode": "character", "vocab_file": vocab_file}},
        "model": MODEL,
    }
    lm_cfg = {"model": LM_MODEL}
    spec = TM.build_spec(120, VOCAB, **MODEL)
    gen = torch.Generator().manual_seed(3)
    TC.save_checkpoint(str(tmp_path / "asr.pth"), TM.asr_init(gen, spec))
    TC.save_checkpoint(str(tmp_path / "lm.pth"), TLM.lm_init(
        gen, TLM.build_spec(VOCAB, **LM_MODEL)))
    test_cfg = {
        "data": {"corpus": {"name": "synthetic", "path": "",
                            "dev_split": ["dev"], "test_split": ["test"],
                            "bucketing": False, "batch_size": 2, "n_utts": 3,
                            "min_tokens": 2, "max_tokens": 4}},
        "src": {"config": str(tmp_path / "train.yaml"),
                "ckpt": str(tmp_path / "asr.pth")},
        "decode": {"ctc_weight": 0, "beam_size": 2, "min_len_ratio": 0.01,
                   "max_len_ratio": 0.06,
                   "lm_config": str(tmp_path / "lm.yaml"),
                   "lm_path": str(tmp_path / "lm.pth"), "lm_weight": 0.3},
    }
    for name, cfg in (("train", train_cfg), ("lm", lm_cfg),
                      ("test", test_cfg)):
        with open(tmp_path / (name + ".yaml"), "w") as f:
            yaml.safe_dump(cfg, f)
    return str(tmp_path / "test.yaml")


def _argv(tmp_path, cfg, *extra):
    return ["--test", "--cpu", "--config", cfg, "--njobs", "0", "--no-msg",
            "--outdir", str(tmp_path / "out"), *extra]


def test_cli_beam_and_greedy_write_csvs_eval_reads(tmp_path):
    sys.path.insert(0, ROOT)
    import eval as eval_tool
    import eval_beam
    from e2e_asr_pytorch_tpu_torch.main import main
    cfg = _write_configs(tmp_path)
    solver = main(_argv(tmp_path, cfg))
    assert solver.n_utts == 6 and solver.audio_seconds > 0
    out = tmp_path / "out"
    for split in ("dev", "test"):
        rows = (out / "test_sd0_{}_output.csv".format(split)).read_text()
        assert rows.splitlines()[0] == "idx\thyp\ttruth"
        assert len(rows.splitlines()) == 1 + 3
        beam = (out / "test_sd0_{}_beam.csv".format(split)).read_text()
        assert beam.splitlines()[0] == "idx\tbeam\thyp\ttruth"
        assert len(beam.splitlines()) == 1 + 3 * 2
        wer, cer = eval_tool.main(["--file", str(
            out / "test_sd0_{}_output.csv".format(split))])
        assert 0.0 <= cer and 0.0 <= wer
        eval_beam.main(["--file", str(
            out / "test_sd0_{}_beam.csv".format(split))])
    main(_argv(tmp_path, cfg, "--name", "greedy", "--override",
               "decode.beam_size=1"))
    rows = (out / "greedy_dev_output.csv").read_text().splitlines()
    assert len(rows) == 1 + 3 and not (out / "greedy_dev_beam.csv").exists()


def test_cli_refuses_training_and_lm(tmp_path):
    """Every training option is ported; what still refuses is what JAX
    refuses: emb fusion with on-line BERT targets raises JAX's ValueError
    before any BERT model is read, and an upstream that is not registered
    raises the JAX package's KeyError, which lists the registered ones. The flagship
    training step itself is held in test_torch_train.py, ``--lm`` in
    test_torch_lm.py, the upstreams in test_torch_apc.py and scheduled
    sampling in test_torch_generic_scan.py."""
    from e2e_asr_pytorch_tpu_torch.main import main
    cfg = _write_configs(tmp_path)
    with open(tmp_path / "train.yaml") as f:
        sched = yaml.safe_load(f)
    sched["hparas"] = {"optimizer": "Adadelta", "lr": 1.0,
                       "lr_scheduler": "fixed", "tf_start": 0.9,
                       "tf_end": 0.8, "tf_step": 10, "max_step": 1,
                       "valid_step": 1}
    sched["emb"] = {"enable": True, "bert": "local",
                    "src": str(tmp_path / "no_bert_here"), "fuse": 0.5}
    with open(tmp_path / "sched.yaml", "w") as f:
        yaml.safe_dump(sched, f)
    run = ["--cpu", "--njobs", "0", "--no-msg", "--logdir",
           str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt")]
    with pytest.raises(ValueError,
                       match="embedding fusion needs table targets"):
        main(["--config", str(tmp_path / "sched.yaml")] + run)
    with pytest.raises(KeyError, match=r"available: \['apc', 'fbank80'\]"):
        main(["--config", str(tmp_path / "sched.yaml"), "--upstream",
              "fbank"] + run)


@pytest.mark.parametrize("mode", [["--test"], ["--lm"], []])
@pytest.mark.parametrize("mesh", [["--n-devices", "2"], ["--n-model", "2"]])
def test_cli_refuses_a_device_mesh(tmp_path, monkeypatch, mode, mesh):
    """--n-devices / --n-model now start a data x model mesh of ranks
    (test_torch_parallel.py runs them); what is refused is a mesh larger
    than the visible devices, for every solver, before any rank starts:
    here one visible device, so two ranks (or a 2-wide model axis) are
    refused."""
    from e2e_asr_pytorch_tpu_torch.main import main
    from e2e_asr_pytorch_tpu_torch.parallel import mesh as tmesh
    monkeypatch.setattr(tmesh, "visible_devices", lambda cpu: 1)
    cfg = _write_configs(tmp_path)
    with pytest.raises(ValueError, match="mesh larger than device count|"
                       "--n-model must divide"):
        main(mode + ["--config", cfg, "--cpu", "--njobs", "0", "--no-msg",
                     "--outdir", str(tmp_path / "out")] + mesh)


def test_cli_without_cpu_flag_refuses_to_run_without_cuda(tmp_path):
    from e2e_asr_pytorch_tpu_torch.main import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _write_configs(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--test", "--config", cfg, "--njobs", "0", "--no-msg",
              "--outdir", str(tmp_path / "out")])


def test_cpu_decode_through_the_port_imports_no_jax(tmp_path):
    cfg = _write_configs(tmp_path)
    code = ("import sys\n"
            "from e2e_asr_pytorch_tpu_torch.main import main\n"
            "main({!r})\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
            "                                    'e2e_asr_pytorch_tpu'))\n"
            "assert not bad, bad\n"
            "print('NO_JAX_OK')\n").format(_argv(tmp_path, cfg))
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NO_JAX_OK" in res.stdout
