"""Port of the embedding-regularizer / fusion plugin (models/plugin.py,
models/bert_embedding.py) against the JAX package, at debug width.

The same numpy inputs and the JAX package's parameters, converted, go
through both packages. Bounds: the emb loss and every gradient leaf (of
the loss plus a fixed random weighting of the fused log-probs) within
1e-5 x max |JAX value| of JAX's; a leaf JAX gives no gradient (a frozen
table, a fixed lambda or tau) gets exactly none. The whole training step
with the plugin: two steps' losses within 1e-5, each leaf's parameter
change after two SGD updates within 1e-3 x max |JAX change| (the whole-step
bound of test_torch_train.py); greedy and beam 8 + LM decoding with fusion
give JAX's tokens. Planted faults that must break these bounds: lambda
without its sigmoid, tau without its relu, a frozen table that trains, the
pad mask ignored, and the fused output scored with label smoothing.
"""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e2e_asr_pytorch_tpu.data.tokenizer import \
    CharacterTextEncoder as JCharEncoder
from e2e_asr_pytorch_tpu.data.tokenizer import load_text_encoder as jload
from e2e_asr_pytorch_tpu.decode import beam as JB
from e2e_asr_pytorch_tpu.decode import greedy as JG
from e2e_asr_pytorch_tpu.models import asr as JM
from e2e_asr_pytorch_tpu.models import lm as JLM
from e2e_asr_pytorch_tpu.models import plugin as JP
from e2e_asr_pytorch_tpu.ops.pallas import lstm as PL
from e2e_asr_pytorch_tpu.train import checkpoint as JC
from e2e_asr_pytorch_tpu.train import optim as JO
from e2e_asr_pytorch_tpu.train.train_asr import Solver as JSolver
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.data.tokenizer import \
    CharacterTextEncoder as TCharEncoder
from e2e_asr_pytorch_tpu_torch.data.tokenizer import load_text_encoder as tload
from e2e_asr_pytorch_tpu_torch.decode import beam as TB
from e2e_asr_pytorch_tpu_torch.decode import greedy as TG
from e2e_asr_pytorch_tpu_torch.models import asr as TM
from e2e_asr_pytorch_tpu_torch.models import lm as TLM
from e2e_asr_pytorch_tpu_torch.models import plugin as TP
from e2e_asr_pytorch_tpu_torch.ops import losses as TL
from e2e_asr_pytorch_tpu_torch.train import checkpoint as TC
from e2e_asr_pytorch_tpu_torch.train import optim as TO
from e2e_asr_pytorch_tpu_torch.train import train_asr as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB_FILE = os.path.join(ROOT, "corpus", "librispeech_char.txt")
REL = 1e-5
# the whole-step bound of test_torch_train.py: BASE + NOISE_X x the JAX
# reference's own movement under a FEAT_NOISE perturbation of its input
STEP_BASE = {"loss": 1e-5, "leaf": 1e-3}
NOISE_X = 10
FEAT_NOISE = 1e-6


def _write_table(path, tokens, dim, seed=0, extra=()):
    """A fasttext-format table over ``tokens`` (plus </s> and any extra
    lines), values from ``seed``."""
    rng = np.random.default_rng(seed)
    lines = ["{} {}".format(len(tokens) + 1, dim)]
    for t in list(tokens) + ["</s>"]:
        lines.append(t + " " + " ".join("%.4f" % x
                                        for x in rng.standard_normal(dim)))
    lines.extend(extra)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A 3-letter tokenizer in both packages and a 4-dim table with OOV
    rows, a <unk> row and malformed rows."""
    path = _write_table(tmp_path_factory.mktemp("emb") / "emb.vec",
                        ["A", "B", "C", "Q", "Z"], 4,
                        extra=["<unk> 0.5 0.5 0.5 0.5", "bad 1.0 2.0",
                               " 1 2 3 4"])
    return (JCharEncoder(["A", "B", "C"]), TCharEncoder(["A", "B", "C"]),
            path)


def test_load_embedding_table_matches_jax(small):
    jtok, ttok, path = small
    want = JP.load_embedding_table(jtok, path)
    got = TP.load_embedding_table(ttok, path)
    np.testing.assert_array_equal(got, want)
    # <pad> zero, </s> -> <eos>, <unk> the mean of the OOV rows and <unk>
    assert np.abs(got[0]).sum() == 0 and np.abs(got[1]).sum() > 0
    assert np.abs(got[2]).sum() > 0


# (distance, fuse, temperature, fuse_normalize, freeze)
CASES = {
    "cos_fixed": ("CosEmb", 0.3, 2.0, False, True),
    "mse_fixed_norm": ("MSE", 0.5, 1.0, True, True),
    "cos_learnable": ("CosEmb", -1, -1, False, True),
    "mse_vocabwise": ("MSE", -2, -2, False, True),
    "cos_nofuse_trained_table": ("CosEmb", 0, 1.0, False, False),
}


def _cfg(path, case, dropout=0.0):
    distance, fuse, temp, norm, freeze = CASES[case]
    return dict(enable=True, src=path, distance=distance, weight=0.5,
                fuse=fuse, temperature=temp, freeze=freeze,
                fuse_normalize=norm, dropout=dropout)


def _plugin_both(small, case, y_emb=False, negative_temp=False,
                 dropout=0.0):
    """{name: (port value, JAX value)} of the emb loss and of the gradients
    of loss + sum(C * fused) with respect to every plugin leaf, the decoder
    states and the logits."""
    jtok, ttok, path = small
    cfg = _cfg(path, case, dropout)
    jreg = JP.build(cfg, jtok, dec_dim=8, key=jax.random.PRNGKey(0))
    treg = TP.build(cfg, ttok, 8, torch.Generator().manual_seed(0))
    jparams = dict(jreg.params)
    if negative_temp:
        jparams["temp"] = jnp.linspace(-1.0, 1.5, jparams["temp"].shape[0])
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams))
    # the port's build makes the JAX build's shapes
    assert {k: tuple(treg.params[k].shape) for k in (
        "fuse_lambda", "temp", "emb_table")} == \
        {k: tuple(tparams[k].shape) for k in ("fuse_lambda", "temp",
                                               "emb_table")}
    b, l, h, v = 3, 5, 8, jtok.vocab_size
    rng = np.random.default_rng(1)
    dec_state = rng.standard_normal((b, l, h)).astype(np.float32)
    dec_logit = rng.standard_normal((b, l, v)).astype(np.float32)
    label = np.array([[3, 4, 5, 1, 0], [3, 3, 1, 0, 0], [5, 1, 0, 0, 0]],
                     np.int32)
    utt_w = np.array([1.0, 1.0, 0.0], np.float32)
    coef = rng.standard_normal((b, l, v)).astype(np.float32)
    yt = rng.standard_normal((b, l, 4)).astype(np.float32) if y_emb else None

    def jobj(p, ds, dl):
        loss, fused = jreg.loss(p, ds, dl, jnp.asarray(label),
                                utt_w=jnp.asarray(utt_w),
                                y_emb=None if yt is None else jnp.asarray(yt))
        extra = jnp.sum(fused * coef) if fused is not None else 0.0
        return loss + extra, loss
    (_, jloss), jg = jax.value_and_grad(jobj, argnums=(0, 1, 2),
                                        has_aux=True)(
        jparams, jnp.asarray(dec_state), jnp.asarray(dec_logit))

    leaves = convert.tree_map(lambda x: x.clone().requires_grad_(), tparams)
    ds = torch.from_numpy(dec_state).requires_grad_()
    dl = torch.from_numpy(dec_logit).requires_grad_()
    loss, fused = treg.loss(leaves, ds, dl, torch.from_numpy(label).long(),
                            utt_w=torch.from_numpy(utt_w),
                            y_emb=None if yt is None else torch.from_numpy(yt))
    total = loss + (torch.sum(fused * torch.from_numpy(coef))
                    if fused is not None else 0.0)
    flat = convert.tree_leaves(leaves) + [ds, dl]
    tg = torch.autograd.grad(total, flat, allow_unused=True)
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]] + ["ds", "dl"]
    jflat = jax.tree.leaves(jg[0]) + [jg[1], jg[2]]
    out = {"loss": (float(loss.detach()), float(jloss))}
    for n, g, r in zip(names, tg, jflat):
        out[n] = (np.zeros(r.shape, np.float32) if g is None else g.numpy(),
                  np.asarray(r))
    return out


def _out_of_bounds(res):
    bad = {}
    for k, (got, want) in res.items():
        want = np.asarray(want, np.float64)
        err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
        bound = REL * float(np.max(np.abs(want)))
        if err > bound:
            bad[k] = (err, bound)
    return bad


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_fusion_match_jax(small, case):
    res = _plugin_both(small, case)
    assert not _out_of_bounds(res), _out_of_bounds(res)
    distance, fuse, temp, _, freeze = CASES[case]
    # what JAX stops a gradient at gets none in the port
    zero = (["['emb_table']"] if freeze else []) + \
        (["['fuse_lambda']"] if fuse not in (-1, -2) else []) + \
        (["['temp']"] if temp not in (-1, -2) else [])
    for k in zero:
        assert not np.any(res[k][0]) and not np.any(res[k][1]), k
    if fuse in (-1, -2):
        assert np.any(res["['fuse_lambda']"][0])
    if not freeze:
        assert np.any(res["['emb_table']"][0])


def test_loss_with_given_targets_matches_jax(small):
    """The on-line BERT path: (B,L,D) targets handed in take the table's
    place and get no gradient."""
    res = _plugin_both(small, "mse_fixed_norm", y_emb=True)
    assert not _out_of_bounds(res), _out_of_bounds(res)


def test_vocabwise_temperature_below_zero_matches_jax(small):
    res = _plugin_both(small, "mse_vocabwise", negative_temp=True)
    assert not _out_of_bounds(res), _out_of_bounds(res)


def _raw_lambda(self, params):
    return params["fuse_lambda"]


def _raw_temp(self, params):
    return params["temp"]


def _trained_table(self, params):
    return params["emb_table"]


@pytest.mark.parametrize("fault,case,neg", [
    ("lambda_without_sigmoid", "cos_learnable", False),
    ("tau_without_relu", "mse_vocabwise", True),
    ("frozen_table_trains", "cos_fixed", False),
    ("pad_mask_ignored", "cos_fixed", False)])
def test_planted_plugin_faults_break_the_bound(small, monkeypatch, fault,
                                               case, neg):
    if fault == "lambda_without_sigmoid":
        monkeypatch.setattr(TP.EmbeddingRegularizer, "_lambda", _raw_lambda)
    elif fault == "tau_without_relu":
        monkeypatch.setattr(TP.EmbeddingRegularizer, "_temperature",
                            _raw_temp)
    elif fault == "frozen_table_trains":
        monkeypatch.setattr(TP.EmbeddingRegularizer, "_table",
                            _trained_table)
    else:
        monkeypatch.setattr(TP, "_pad_mask",
                            lambda label, dtype: torch.ones(label.shape,
                                                            dtype=dtype))
    assert _out_of_bounds(_plugin_both(small, case, negative_temp=neg))


def test_f11_plugin_dropout_never_acts_in_training(small):
    """ROADMAP queue 3, F11: the JAX package's loss projects without an rng,
    so ``dropout:`` never acts in training. The port does the same: with
    dropout 0.5 both give their dropout-0 loss and gradients bit for bit,
    and stay within the bound of each other."""
    with_drop = _plugin_both(small, "cos_fixed", dropout=0.5)
    without = _plugin_both(small, "cos_fixed")
    for k in without:
        np.testing.assert_array_equal(with_drop[k][0], without[k][0])
        np.testing.assert_array_equal(with_drop[k][1], without[k][1])
    assert not _out_of_bounds(with_drop)


def test_build_refuses_fusion_with_bert_targets(small):
    _, ttok, path = small
    with pytest.raises(ValueError, match="embedding fusion needs table "
                       "targets; it is unavailable with on-line BERT "
                       "targets"):
        TP.build(dict(enable=True, bert="local", src=path, fuse=0.5), ttok,
                 8, torch.Generator())


def test_emb_plugin_tree_converts_and_loads_from_a_jax_checkpoint(
        small, tmp_path):
    """The (1,) and (V,) lambda/tau forms and a tree without emb_table (BERT
    mode) come across leaf for leaf; a JAX-written checkpoint holding the
    subtree loads against a template that includes it, optimizer state
    too."""
    jtok, ttok, path = small
    for case in ("cos_fixed", "mse_vocabwise"):
        jreg = JP.build(_cfg(path, case), jtok, 8, jax.random.PRNGKey(2))
        treg = TP.build(_cfg(path, case), ttok, 8, torch.Generator())
        for tree in (jreg.params, {k: v for k, v in jreg.params.items()
                                   if k != "emb_table"}):
            got = convert.from_jax_params(jax.tree.map(np.asarray, tree))
            assert set(got) == set(tree)
            for k in tree:
                for g, w in zip(convert.tree_leaves(got[k]),
                                jax.tree.leaves(tree[k])):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
                    assert tuple(g.shape) == tuple(w.shape)
        assert {k: tuple(v.shape) for k, v in treg.params.items()
                if not isinstance(v, dict)} == \
            {k: tuple(v.shape) for k, v in jreg.params.items()
             if not isinstance(v, dict)}
    spec = JM.build_spec(40, jtok.vocab_size, **MODEL)
    rng = np.random.default_rng(4)
    jp = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(x.dtype),
        jax.eval_shape(lambda k: JM.asr_init(k, spec),
                       jax.random.PRNGKey(0)))
    jp["emb_plugin"] = jax.tree.map(np.asarray, jreg.params)
    tx, _ = JO.build_optimizer(optimizer="Adadelta", lr=1.0)
    jstate = tx.init(jp)
    ck = str(tmp_path / "jax.pth")
    JC.save_checkpoint(ck, jp, jstate, 3)
    template = TM.asr_init(torch.Generator(), TM.build_spec(
        40, jtok.vocab_size, **MODEL))
    template["emb_plugin"] = treg.params
    opt = TO.build_optimizer(optimizer="Adadelta", lr=1.0)
    got = TC.load_checkpoint(ck, "cpu", template, opt.init(template))
    want = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    got_flat, want_flat = _by_path(got["model"]), _by_path(want)
    assert set(got_flat) == set(want_flat)
    for k, w in want_flat.items():
        np.testing.assert_array_equal(got_flat[k], w, err_msg=k)
    assert set(got["optimizer"]) == {"count", "e_g", "e_x"}
    assert "emb_plugin" in got["optimizer"]["e_g"]


def _by_path(tree, prefix=""):
    """{path: numpy array} of a dict/list tree, whatever its key order."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _by_path(v, prefix + "/" + str(k)).items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _by_path(v, prefix + "/" + str(i)).items()}
    return {prefix: tree.numpy()}


# --------------------------------------------------- the training step
MODEL = dict(
    ctc_weight=0.3,
    encoder=dict(vgg=0, vgg_freq=-1, vgg_low_filt=-1, module="LSTM",
                 bidirection=True, dim=[16], dropout=[0.0],
                 layer_norm=[False], proj=[False], sample_rate=[1],
                 sample_style="drop"),
    attention=dict(mode="loc", dim=8, num_head=1, v_proj=False,
                   temperature=0.5, loc_kernel_size=5, loc_kernel_num=3),
    decoder=dict(module="LSTM", dim=16, layer=1, dropout=0))
LM_MODEL = dict(emb_tying=True, emb_dim=16, module="LSTM", dim=16,
                n_layers=1, dropout=0.0)
STEP_EMB = dict(enable=True, distance="CosEmb", weight=0.3, fuse=-1,
                temperature=-1, freeze=True, fuse_normalize=False,
                dropout=0.0)


@pytest.fixture(scope="module")
def chars(tmp_path_factory):
    """The char tokenizer of both packages and an 8-dim table over it."""
    jtok, ttok = jload("character", VOCAB_FILE), tload("character",
                                                       VOCAB_FILE)
    chars = ["'"] + [chr(c) for c in range(ord("A"), ord("Z") + 1)]
    path = _write_table(tmp_path_factory.mktemp("embtr") / "char.vec",
                        chars, 8)
    return jtok, ttok, path


def _step_data(v):
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((3, 40, 40)).astype(np.float32)
    feat_len = np.array([40, 33, 40], np.int32)
    txt = np.array([[5, 9, 12, 7, 1], [4, 6, 1, 0, 0], [8, 8, 3, 1, 0]],
                   np.int32)
    txt_len = (txt != 0).sum(1).astype(np.int32)
    utt_w = np.array([1.0, 1.0, 0.0], np.float32)
    return feat, feat_len, txt, txt_len, utt_w


@pytest.fixture(scope="module")
def jax_kernels():
    """The JAX side runs its Pallas BLSTM kernel (interpret mode), whose
    w_h is bf16 as the port's recurrence is, as test_torch_train.py does."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("E2E_ASR_PALLAS", "force")
        mp.setattr(PL, "INTERPRET", True)
        yield


@pytest.fixture(scope="module")
def step(chars, jax_kernels):
    """Two SGD steps of the JAX package's loss (its solver's ``_losses``:
    CTC + the fused NLL + the weighted emb loss) on the features, and the
    JAX-initialised parameters for the port."""
    jtok, ttok, path = chars
    v = jtok.vocab_size
    spec = JM.build_spec(40, v, **MODEL)
    jp = JM.asr_init(jax.random.PRNGKey(0), spec)
    cfg = dict(STEP_EMB, src=path)
    jreg = JP.build(cfg, jtok, spec.decoder.dim, jax.random.PRNGKey(1))
    jp["emb_plugin"] = jreg.params
    treg = TP.build(cfg, ttok, spec.decoder.dim, torch.Generator())
    feat, feat_len, txt, txt_len, utt_w = _step_data(v)
    ns = types.SimpleNamespace(
        transfer_learning=False, config={"hparas": {}}, spec=spec,
        emb_reg=True, emb_decoder=jreg, compute_dtype=jnp.float32,
        label_smoothing=True, vocab_size=v)

    def jloss(p, f):
        total, _ = JSolver._losses(
            ns, p, f, jnp.asarray(feat_len),
            jnp.asarray(txt), jnp.asarray(txt_len), 1.0,
            jax.random.PRNGKey(0), True, True, utt_w=jnp.asarray(utt_w))
        return total
    vg = jax.jit(jax.value_and_grad(jloss))
    tx, _ = JO.build_optimizer(optimizer="SGD", lr=0.1, grad_clip=5.0)

    def run(f):
        state, p, losses = tx.init(jp), jp, []
        for _ in range(2):
            loss, g = vg(p, jnp.asarray(f))
            up, state = tx.update(g, state, p)
            p = optax.apply_updates(p, up)
            losses.append(float(loss))
        return p, losses
    p, losses = run(feat)
    # the reference's own movement under a 1e-6 perturbation of its input
    noise = np.random.default_rng(16).standard_normal(feat.shape)
    p_moved, losses_moved = run(
        (feat * (1.0 + FEAT_NOISE * noise)).astype(np.float32))
    return dict(jtok=jtok, ttok=ttok, spec=spec, jp=jp, jp2=p, jreg=jreg,
                treg=treg, losses=losses, jp2_moved=p_moved,
                losses_moved=losses_moved,
                data=(feat, feat_len, txt, txt_len, utt_w))


def _port_steps(s, n=2):
    tspec = TM.build_spec(40, s["jtok"].vocab_size, **MODEL)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, s["jp"]))
    opt = TO.build_optimizer(optimizer="SGD", lr=0.1, grad_clip=5.0)
    cfg = TT.StepConfig(tspec, None, opt, torch.float32, augment=False,
                        label_smoothing=True, sample_free=True,
                        emb=s["treg"])
    feat, feat_len, txt, txt_len, utt_w = s["data"]
    batch = {"txt": torch.from_numpy(txt).long(),
             "txt_len": torch.from_numpy(txt_len).long(),
             "utt_w": torch.from_numpy(utt_w)}
    f, fl = torch.from_numpy(feat), torch.from_numpy(feat_len).long()
    cfg = cfg._replace(upstream=lambda wav, wav_len: (f, fl))
    batch.update(wav=f, wav_len=fl)
    params = convert.tree_map(lambda x: x.clone(), tp)
    state = opt.init(params)
    losses, metrics = [], None
    for _ in range(n):
        params, state, metrics, _, _ = TT.train_step(cfg, params, state,
                                                     batch, None, 1.0)
        losses.append(float(metrics["total"]))
    return tp, params, losses, metrics


def _step_out_of_bounds(s, losses, tp, params):
    bad = {}
    for i, (got, want, moved) in enumerate(zip(losses, s["losses"],
                                               s["losses_moved"])):
        err, floor = abs(got - want), abs(moved - want)
        if err > STEP_BASE["loss"] * abs(want) + NOISE_X * floor:
            bad["loss%d" % (i + 1)] = (err, floor)

    def delta(p):
        return jax.tree.leaves(jax.tree.map(
            lambda a, b: np.asarray(a) - np.asarray(b), p, s["jp"]))
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(s["jp"])[0]]
    for n, a, b, w, m in zip(names, convert.tree_leaves(params),
                             convert.tree_leaves(tp), delta(s["jp2"]),
                             delta(s["jp2_moved"])):
        err = float(np.max(np.abs((a - b).numpy() - w)))
        floor = float(np.max(np.abs(m - w)))
        if err > STEP_BASE["leaf"] * float(np.max(np.abs(w))) \
                + NOISE_X * floor:
            bad[n] = (err, floor)
    return bad


def test_two_train_steps_with_fusion_match_jax(step):
    s = step
    tp, params, losses, metrics = _port_steps(s)
    assert np.isfinite(float(metrics["emb"]))
    bad = _step_out_of_bounds(s, losses, tp, params)
    assert not bad, bad
    want_delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                              s["jp2"], s["jp"])
    # the learnable lambda moved; the frozen table did not
    assert float(np.abs(want_delta["emb_plugin"]["fuse_lambda"]).max()) > 0
    lam = params["emb_plugin"]["fuse_lambda"] - tp["emb_plugin"][
        "fuse_lambda"]
    assert float(lam.abs().max()) > 0
    assert torch.equal(params["emb_plugin"]["emb_table"],
                       tp["emb_plugin"]["emb_table"])


def test_fused_output_scored_with_label_smoothing_breaks_the_bound(
        step, monkeypatch):
    v = step["jtok"].vocab_size
    monkeypatch.setattr(TL, "nll_loss", lambda lp, txt, utt_w=None,
                        global_sum=None: TL.label_smoothing_loss(
                            lp, txt, v, 0.1, utt_w=utt_w))
    tp, params, losses, _ = _port_steps(step)
    bad = _step_out_of_bounds(step, losses, tp, params)
    assert "loss1" in bad and "loss2" in bad, bad


def test_fused_greedy_and_beam_with_lm_give_jax_tokens(step, jax_kernels):
    """The JAX-trained parameters (after the two steps, a learned lambda)
    decode to the same tokens in both packages: greedy over the fused
    distribution, and beam 8 with the LM at weight 0.3 and CTC at 0.3."""
    s = step
    feat, feat_len = s["data"][0], s["data"][1]
    jp2 = s["jp2"]
    tp2 = convert.from_jax_params(jax.tree.map(np.asarray, jp2))
    tspec = TM.build_spec(40, s["jtok"].vocab_size, **MODEL)
    f, fl = torch.from_numpy(feat), torch.from_numpy(feat_len).long()
    jo = JG.greedy_decode(jp2, s["spec"], jnp.asarray(feat),
                          jnp.asarray(feat_len), 8, emb_reg=s["jreg"],
                          emb_params=jp2["emb_plugin"])
    to = TG.greedy_decode(tp2, tspec, f, fl, 8, emb_reg=s["treg"],
                          emb_params=tp2["emb_plugin"])
    np.testing.assert_array_equal(np.asarray(jo["att_tokens"]),
                                  to["att_tokens"].numpy())
    v = s["jtok"].vocab_size
    lspec = JLM.build_spec(v, **LM_MODEL)
    jl = JLM.lm_init(jax.random.PRNGKey(3), lspec)
    tl = convert.from_jax_params(jax.tree.map(np.asarray, jl))
    jcfg = JB.BeamConfig(beam_size=8, min_len_ratio=0.0, max_len_ratio=0.2,
                         ctc_weight=0.3, lm_weight=0.3, max_steps=8)
    tcfg = TB.BeamConfig(beam_size=8, min_len_ratio=0.0, max_len_ratio=0.2,
                         ctc_weight=0.3, lm_weight=0.3, max_steps=8)
    jb = JB.beam_decode(jp2, s["spec"], jcfg, jnp.asarray(feat),
                        jnp.asarray(feat_len), jl, lspec, emb_reg=s["jreg"],
                        emb_params=jp2["emb_plugin"])
    tb = TB.beam_decode(tp2, tspec, tcfg, f, fl, tl,
                        TLM.build_spec(v, **LM_MODEL), emb_reg=s["treg"],
                        emb_params=tp2["emb_plugin"])
    np.testing.assert_array_equal(np.asarray(jb["tokens"]),
                                  tb["tokens"].numpy())
    # fusion changed the search: without it the beam differs
    plain = TB.beam_decode(tp2, tspec, tcfg, f, fl, tl,
                           TLM.build_spec(v, **LM_MODEL))
    assert not np.array_equal(plain["avg_scores"].numpy(),
                              tb["avg_scores"].numpy())


# ------------------------------------------------- the CLI and BERT
def _tiny_configs(tmp, emb):
    import yaml
    text = {"mode": "character", "vocab_file": VOCAB_FILE}
    corpus = {"name": "synthetic", "path": "", "batch_size": 4, "n_utts": 8,
              "max_tokens": 5}
    audio = {"feat_type": "fbank", "feat_dim": 20, "apply_cmvn": False,
             "delta_order": 0, "frame_length": 25, "frame_shift": 10,
             "ref_level_db": 20, "min_level_db": -100,
             "preemphasis_coeff": 0.97, "augment": False, "time_aug": False}
    train = {"data": {"corpus": dict(corpus, train_split=["train"],
                                     dev_split=["dev"], bucketing=True),
                      "audio": audio, "text": text},
             "hparas": {"valid_step": 2, "max_step": 2,
                        "optimizer": "Adadelta", "lr": 1.0, "eps": 1e-8,
                        "lr_scheduler": "fixed", "val_mode": "cer",
                        "label_smoothing": True},
             "model": dict(MODEL, encoder=dict(MODEL["encoder"], vgg=6)),
             "emb": emb}
    test = {"data": {"corpus": dict(corpus, dev_split=["dev"],
                                    test_split=["test"], bucketing=False)},
            "src": {"config": os.path.join(tmp, "train.yaml"),
                    "ckpt": os.path.join(tmp, "ckpt", "emb",
                                         "last_att_dev.pth")},
            "decode": {"beam_size": 2, "ctc_weight": 0.0,
                       "min_len_ratio": 0.0, "max_len_ratio": 0.3,
                       "lm_weight": 0.0}}
    for name, cfg in (("train", train), ("test", test)):
        with open(os.path.join(tmp, name + ".yaml"), "w") as f:
            yaml.safe_dump(cfg, f)


CLI_SCRIPT = r"""
import os, sys
from e2e_asr_pytorch_tpu_torch.main import main
d = sys.argv[1]
run = ["--cpu", "--njobs", "0", "--no-msg", "--name", "emb", "--logdir",
       os.path.join(d, "log"), "--ckpdir", os.path.join(d, "ckpt"),
       "--outdir", os.path.join(d, "out")]
s = main(["--config", os.path.join(d, "train.yaml")] + run)
assert s.emb_decoder.apply_fuse and "emb_plugin" in s.params
print("emb", s.step_stats[-1]["emb"])
t = main(["--test", "--config", os.path.join(d, "test.yaml")] + run)
assert t.emb_reg is not None and t.emb_reg.apply_fuse
assert "jax" not in sys.modules and not any(
    m.startswith("e2e_asr_pytorch_tpu.") for m in sys.modules)
print("ok")
"""


def test_cli_trains_with_fusion_then_decodes_without_jax(chars, tmp_path):
    _, _, path = chars
    _tiny_configs(str(tmp_path), dict(STEP_EMB, src=path))
    out = subprocess.run([sys.executable, "-c", CLI_SCRIPT, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert out.stdout.strip().endswith("ok")
    emb = float(out.stdout.split("emb ")[1].split()[0])
    assert np.isfinite(emb)
    rows = (tmp_path / "out" / "emb_test_output.csv").read_text()
    assert rows.splitlines()[0] == "idx\thyp\ttruth"
    assert (tmp_path / "out" / "emb_test_beam.csv").exists()


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    """A tiny randomly initialised BertForMaskedLM written from a config
    (vocab matched to the char tokenizer); no weights are fetched."""
    # as the port's predictor does: transformers off its TF / JAX backends
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.BertConfig(
        vocab_size=31, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=64)
    d = tmp_path_factory.mktemp("dummy_bert")
    transformers.BertForMaskedLM(cfg).save_pretrained(str(d))
    return str(d)


def test_bert_predictor_matches_jax_and_trains_through_the_solver(
        bert_dir, chars, tmp_path):
    from e2e_asr_pytorch_tpu.models.bert_embedding import \
        BertEmbeddingPredictor as JPred
    from e2e_asr_pytorch_tpu_torch.main import main
    from e2e_asr_pytorch_tpu_torch.models.bert_embedding import \
        BertEmbeddingPredictor as TPred
    jtok, ttok, _ = chars
    ids = np.array([[4, 5, 6, 1], [7, 8, 1, 0]], np.int64)
    want = JPred(bert_dir, jtok).predict(ids)
    pred = TPred(bert_dir, ttok)
    got = pred.predict(ids)
    assert pred.hidden_size == 16 and got.shape == (2, 4, 16)
    np.testing.assert_array_equal(got, want)
    # contextual: one id in another context -> another target
    ids2 = ids.copy()
    ids2[0, 1] = 9
    assert not np.allclose(pred.predict(ids2)[0, 0], got[0, 0])
    _tiny_configs(str(tmp_path), {"enable": True, "bert": "local",
                                  "src": bert_dir, "distance": "MSE",
                                  "weight": 0.1, "fuse": 0,
                                  "temperature": 1.0})
    s = main(["--config", str(tmp_path / "train.yaml"), "--cpu", "--njobs",
              "0", "--no-msg", "--name", "bert", "--logdir",
              str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt")])
    assert s.emb_decoder.predictor is not None
    assert "emb_table" not in s.params["emb_plugin"]
    assert s.step == 2 and all(np.isfinite(x["emb"]) for x in s.step_stats)
