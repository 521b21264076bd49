"""The GRU and light-GRU listener slices whole, against the JAX package: one
training step (loss, every gradient leaf, the parameters after two Adadelta
updates) and greedy + beam decoding with a GRU language model, by the
methods and bounds of test_torch_train.py and test_torch_decode.py, then the
port's CLI training and decoding a light-GRU model on the CPU.

The JAX side runs its Pallas kernels in interpret mode (K7/K8 for the
listener under ``E2E_ASR_PALLAS=force``, K3/K4 for the int8 value table), so
both sides take the recurrent products with bf16 operands.
"""

import importlib.util
import os

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
from e2e_asr_pytorch_tpu.ops.pallas import gru as PGRU
from e2e_asr_pytorch_tpu.ops.pallas import int8_table as JQ
from e2e_asr_pytorch_tpu.ops.pallas import ligru as PLIGRU
from e2e_asr_pytorch_tpu.ops.pallas import lstm as PL
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.decode import beam as TB
from e2e_asr_pytorch_tpu_torch.decode import greedy as TG
from e2e_asr_pytorch_tpu_torch.models import asr as TM
from e2e_asr_pytorch_tpu_torch.models import lm as TLM

# the whole-step machinery of test_torch_train.py, loaded from the file
# beside this one (another package named ``tests`` may come first on the path)
_spec = importlib.util.spec_from_file_location(
    "_torch_train_shared", os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "test_torch_train.py"))
TRAIN = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TRAIN)

SCORE_ATOL = 1e-4           # as test_torch_decode.py
VOCAB = TRAIN.VOCAB
MODULES = ["GRU", "liGRU"]


def _model(module, **enc):
    model = dict(TRAIN.MODEL)
    model["encoder"] = dict(TRAIN.MODEL["encoder"], module=module, **enc)
    return model


_JAX_STEPS = {}


@pytest.fixture
def jax_kernels(monkeypatch):
    monkeypatch.setenv("E2E_ASR_PALLAS", "force")
    for mod in (PL, PGRU, PLIGRU, JQ):
        monkeypatch.setattr(mod, "INTERPRET", True)
    # a test and its planted-fault twin hold the port against the same JAX
    # steps (same spec, parameters and batch): trace and run them once
    jax_steps = TRAIN._jax_steps

    def once(jspec, *args):
        if jspec not in _JAX_STEPS:
            _JAX_STEPS[jspec] = jax_steps(jspec, *args)
        return _JAX_STEPS[jspec]
    monkeypatch.setattr(TRAIN, "_jax_steps", once)


# ------------------------------------------------------ one training step
# A gradient leaf whose largest reference value is below one f32 epsilon of
# the largest gradient leaf's is zero by construction (the bias of the
# attention's energy projection shifts every frame's energy alike, which the
# softmax does not see): what either side returns for it is the rounding
# noise of the sums that cancel, and its relative error says nothing.
F32_EPS = 2.0 ** -23
# Adadelta's first updates are sign-like (every element moves by some 4.5e-4
# whatever its gradient's size), so the second loss is the least pinned
# quantity of the step: under a 1e-6 feature perturbation the JAX reference's
# own second loss moves by 1e-3 to 5e-3 for these listeners, at any batch
# size. Both listeners are held on eight utterances of 10 to 12 tokens. The
# light GRU (batch norm and relu kinks on top): the reference moves 1.4e-3,
# the port differs by 8e-3 and a doubled learning rate by 2.9e-2. The GRU
# was held on the two utterances of test_torch_train.py, where the port's
# loss2 error (3.126e-3) sat at the bound (3.098e-3) and failed on some
# hosts; on the eight the reference moves 1.49e-4, so the bound is 1.50e-3,
# the port differs by 3.08e-4 (a fifth of it) and a doubled learning rate by
# 2.07e-2.
EIGHT_UTTS = tuple((i, 12 - i % 3) for i in range(8))
UTTS = {"GRU": EIGHT_UTTS, "liGRU": EIGHT_UTTS}


def _out_of_bounds(res):
    top = max(v[2] for k, v in res.items() if k.startswith("grad"))
    return {k: v for k, v in TRAIN._out_of_bounds(res).items()
            if not (k.startswith("grad") and v[2] < F32_EPS * top)}


@pytest.mark.parametrize("module", MODULES)
def test_train_step_matches_jax(jax_kernels, module):
    res = TRAIN._step_both(model=_model(module), utts=UTTS[module])
    bad = _out_of_bounds(res)
    assert not bad, bad
    # the new leaves are among those held
    leaves = {"GRU": ("b_x", "b_h"), "liGRU": ("bn_scale", "bn_bias")}[module]
    for leaf in leaves:
        assert any(k.startswith("grad") and leaf in k for k in res), leaf


@pytest.mark.parametrize("module", MODULES)
def test_train_step_vs_jax_fails_under_doubled_lr_and_grads(jax_kernels,
                                                            module):
    res = TRAIN._step_both(fault=2.0, model=_model(module),
                           utts=UTTS[module])
    bad = _out_of_bounds(res)
    assert "loss2" in bad
    # every leaf the reference pins down (moves < 5% itself) is caught
    pinned = [k for k, v in res.items() if k[:1] in "gd" and v[1] < 0.05]
    assert len(pinned) > 30 and all(k in bad for k in pinned), (
        sorted(set(pinned) - set(bad)))


# ------------------------------------------------------------- the decode
LM_MODEL = dict(emb_tying=True, emb_dim=32, module="GRU", dim=32, n_layers=2,
                dropout=0.0)


def _shared(module):
    """JAX-initialised ASR (GRU or light-GRU listener) + GRU LM weights,
    carried into the port, and a batch of 120-dim features."""
    model = _model(module)
    spec = JM.build_spec(120, VOCAB, **model)
    jp = JM.asr_init(jax.random.PRNGKey(0), spec)
    lspec = JLM.build_spec(VOCAB, **LM_MODEL)
    jl = JLM.lm_init(jax.random.PRNGKey(1), lspec)
    rng = np.random.default_rng(0)
    feat = rng.uniform(0.0, 1.0, (2, 48, 120)).astype(np.float32)
    return dict(spec=spec, jp=jp, lspec=lspec, jl=jl, feat=feat,
                feat_len=np.array([48, 37], np.int32),
                tspec=TM.build_spec(120, VOCAB, **model),
                tp=convert.from_jax_params(jax.tree.map(np.asarray, jp)),
                tlspec=TLM.build_spec(VOCAB, **LM_MODEL),
                tl=convert.from_jax_params(jax.tree.map(np.asarray, jl)))


def _greedy_both(s, tp):
    jo = JG.greedy_decode(s["jp"], s["spec"], jnp.asarray(s["feat"]),
                          jnp.asarray(s["feat_len"]), 9)
    to = TG.greedy_decode(tp, s["tspec"], torch.from_numpy(s["feat"]),
                          torch.from_numpy(s["feat_len"]).long(), 9)
    return jo, to


def _beam_both(s, tp, lm_weight_port=0.3):
    cfg = dict(beam_size=4, min_len_ratio=0.05, max_len_ratio=0.25,
               ctc_weight=0.0, lm_weight=0.3, eos_threshold=1.5,
               max_steps=12)
    jo = JB.beam_decode(s["jp"], s["spec"], JB.BeamConfig(**cfg),
                        jnp.asarray(s["feat"]), jnp.asarray(s["feat_len"]),
                        s["jl"], s["lspec"])
    cfg["lm_weight"] = lm_weight_port
    to = TB.beam_decode(tp, s["tspec"], TB.BeamConfig(**cfg),
                        torch.from_numpy(s["feat"]),
                        torch.from_numpy(s["feat_len"]).long(), s["tl"],
                        s["tlspec"])
    return jo, to


@pytest.mark.parametrize("module", MODULES)
def test_greedy_and_beam_tokens_equal_jax(jax_kernels, module):
    s = _shared(module)
    jo, to = _greedy_both(s, s["tp"])
    np.testing.assert_array_equal(np.asarray(jo["att_tokens"]),
                                  to["att_tokens"].numpy())
    np.testing.assert_array_equal(np.asarray(jo["ctc_tokens"]),
                                  to["ctc_tokens"].numpy())
    jo, to = _beam_both(s, s["tp"])
    np.testing.assert_array_equal(np.asarray(jo["tokens"]),
                                  to["tokens"].numpy())
    np.testing.assert_array_equal(np.asarray(jo["out_len"]),
                                  to["out_len"].numpy())
    err = np.abs(np.asarray(jo["avg_scores"]) - to["avg_scores"].numpy())
    assert float(err.max()) <= SCORE_ATOL
    assert np.isfinite(to["avg_scores"].numpy()[:, 0]).all()


@pytest.mark.parametrize("module", MODULES)
def test_decode_fails_under_planted_faults(jax_kernels, module):
    """A doubled recurrent weight in the listener's first layer changes the
    beam scores; a doubled LM weight does too."""
    s = _shared(module)
    tp = dict(s["tp"], encoder=dict(s["tp"]["encoder"]))
    layers = [dict(p) for p in tp["encoder"]["layers"]]
    layers[0]["fw"] = dict(layers[0]["fw"], w_h=layers[0]["fw"]["w_h"] * 2.0)
    tp["encoder"]["layers"] = layers
    jo, to = _beam_both(s, tp)
    err = np.abs(np.asarray(jo["avg_scores"]) - to["avg_scores"].numpy())
    assert float(err.max()) > 100 * SCORE_ATOL
    jo, to = _beam_both(s, s["tp"], lm_weight_port=0.6)
    err = np.abs(np.asarray(jo["avg_scores"]) - to["avg_scores"].numpy())
    assert float(err.max()) > 100 * SCORE_ATOL


# -------------------------------------------------------- the CLI, on CPU
def _write_configs(tmp, module, bidirection=True):
    paths = TRAIN._write_configs(tmp)
    with open(paths["train"]) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["encoder"].update(module=module, bidirection=bidirection)
    with open(paths["train"], "w") as f:
        yaml.safe_dump(cfg, f)
    return paths


@pytest.mark.parametrize("module,bidirection", [("liGRU", True),
                                                ("GRU", False),
                                                ("LSTM", False)])
def test_cli_trains_and_decodes(tmp_path, module, bidirection):
    """Two steps with a validation, then ``--test`` greedy on the
    checkpoint, with encoder dropout 0.3 on (the light GRU's recurrent mask
    comes from the solver's generator)."""
    from e2e_asr_pytorch_tpu_torch import main as TMain
    from e2e_asr_pytorch_tpu_torch.train import checkpoint as ckpt_lib
    paths = _write_configs(str(tmp_path), module, bidirection)
    argv = ["--config", paths["train"], "--name", "tiny", "--cpu", "--njobs",
            "0", "--logdir", str(tmp_path / "log"), "--ckpdir",
            str(tmp_path / "ckpt"), "--no-msg"]
    solver = TMain.main(argv)
    assert solver.step == 2 and solver.n_valid_batches > 0
    assert solver.spec.encoder.module == module
    ck = ckpt_lib.load_checkpoint(
        str(tmp_path / "ckpt" / "tiny" / "last_att_dev.pth"))
    fw = ck["model"]["encoder"]["layers"][0]["fw"]
    want = {"GRU": ["b_h", "b_x", "w_h", "w_x"],
            "liGRU": ["bn_bias", "bn_scale", "w_h", "w_x"],
            "LSTM": ["b", "w_h", "w_x"]}[module]
    assert sorted(fw) == want
    assert ("bw" in ck["model"]["encoder"]["layers"][0]) == bidirection
    init = TM.asr_init(torch.Generator().manual_seed(0), solver.spec)
    moved = [not torch.equal(a, b) for a, b in zip(
        convert.tree_leaves(init["encoder"]["layers"]),
        convert.tree_leaves(ck["model"]["encoder"]["layers"]))]
    assert all(moved), moved
    out = tmp_path / "out"
    TMain.main(["--test", "--config", paths["test"], "--name", "greedy",
                "--cpu", "--njobs", "0", "--outdir", str(out), "--no-msg"])
    rows = (out / "greedy_test_output.csv").read_text().splitlines()
    assert rows[0] == "idx\thyp\ttruth" and len(rows) == 1 + 8
