"""Port of the flagship training step against the JAX package: the CTC loss,
the label-smoothed attention loss, SpecAugment's masking, the Adadelta
update, and one whole ``train_step`` of a small model (loss, every gradient
leaf, the parameters after two updates with bf16 optimizer state), then the
port's CLI training on the CPU and decoding what it trained.

The JAX side runs its Pallas kernels as its own tests do (K1/K2 with
``E2E_ASR_PALLAS=force`` in interpret mode, K3/K4 in interpret mode). Every
comparison states its tolerance and has a twin with a planted fault that
must fail it.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from e2e_asr_pytorch_tpu.data.librispeech import SyntheticCorpus
from e2e_asr_pytorch_tpu.models import asr as JM
from e2e_asr_pytorch_tpu.ops import ctc as JC
from e2e_asr_pytorch_tpu.ops import losses as JL
from e2e_asr_pytorch_tpu.ops import specaugment as JS
from e2e_asr_pytorch_tpu.ops.pallas import int8_table as JQ
from e2e_asr_pytorch_tpu.ops.pallas import lstm as PL
from e2e_asr_pytorch_tpu.train import optim as JO
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.models import asr as TM
from e2e_asr_pytorch_tpu_torch.ops import ctc as TC
from e2e_asr_pytorch_tpu_torch.ops import losses as TL
from e2e_asr_pytorch_tpu_torch.ops import specaugment as TS
from e2e_asr_pytorch_tpu_torch.ops.audio import (FeatureConfig,
                                                 extract_features)
from e2e_asr_pytorch_tpu_torch.train import optim as TO
from e2e_asr_pytorch_tpu_torch.train import train_asr as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_kernels(monkeypatch):
    monkeypatch.setenv("E2E_ASR_PALLAS", "force")
    monkeypatch.setattr(PL, "INTERPRET", True)
    monkeypatch.setattr(JQ, "INTERPRET", True)


def _rel(a, b):
    """max |a - b| / max |a|, in f64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30))


# ------------------------------------------------------------------ CTC
# Same log-semiring recursion in f32 on both sides: the loss and its
# gradient agree to rel 1e-5. An impossible alignment (more labels than
# frames) gives the same huge finite loss on both, not inf. On that row the
# -1e10 log-zero absorbs every emission score in f32, so its gradient only
# shows how each side breaks logaddexp ties: it is held finite, and the
# gradient is compared on the other rows.
CTC_REL = 1e-5


def _ctc_case(impossible):
    rng = np.random.default_rng(11)
    b, t, v, l = 3, 12, 6, 4
    lp = rng.standard_normal((b, t, v)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    labels = rng.integers(1, v, (b, l)).astype(np.int32)
    labels[0, 1] = labels[0, 2]                         # a repeat needs a blank
    label_len = np.array([4, 2, 0], np.int32)
    input_len = np.array([12, 9, 7], np.int32)
    if impossible:
        input_len[0] = 3                                # 4 labels in 3 frames
    return lp.astype(np.float32), input_len, labels, label_len


def _ctc_both(impossible, reduction, utt_w=None, scale=1.0):
    lp, il, lab, ll = _ctc_case(impossible)
    w = None if utt_w is None else np.asarray(utt_w, np.float32)

    def jfn(x):
        out = JC.ctc_loss(x, jnp.asarray(il), jnp.asarray(lab),
                          jnp.asarray(ll), reduction=reduction,
                          utt_w=None if w is None else jnp.asarray(w))
        return jnp.sum(out)
    jl, jg = jax.value_and_grad(jfn)(jnp.asarray(lp))
    x = torch.from_numpy(lp * scale).requires_grad_()
    tl = TC.ctc_loss(x, torch.from_numpy(il), torch.from_numpy(lab),
                     torch.from_numpy(ll), reduction=reduction,
                     utt_w=None if w is None else torch.from_numpy(w)).sum()
    (tg,) = torch.autograd.grad(tl, [x])
    assert bool(torch.isfinite(tg).all())
    rows = slice(1, None) if impossible else slice(None)
    return (float(jl), float(tl.detach()), _rel(jl, tl.detach()),
            _rel(np.asarray(jg)[rows], tg[rows]))


@pytest.mark.parametrize("impossible", [False, True])
@pytest.mark.parametrize("reduction,utt_w", [("mean", None), ("none", None),
                                             ("mean", [1.0, 1.0, 0.0]),
                                             ("sum", [1.0, 0.5, 1.0])])
def test_ctc_loss_and_grad_match_jax(impossible, reduction, utt_w):
    jl, tl, rel_l, rel_g = _ctc_both(impossible, reduction, utt_w)
    assert np.isfinite(tl) and rel_l <= CTC_REL and rel_g <= CTC_REL, (
        jl, tl, rel_l, rel_g)
    if impossible and reduction == "none":
        assert tl > 1e9                       # LOG_EPS, not inf


def test_ctc_vs_jax_fails_under_doubled_log_probs():
    _, _, rel_l, _ = _ctc_both(False, "mean", scale=2.0)
    assert rel_l > 100 * CTC_REL


# -------------------------------------------------------- label smoothing
LS_REL = 1e-6


def _ls_both(kind, scale=1.0):
    rng = np.random.default_rng(12)
    b, t, v = 3, 7, 9
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    tgt = rng.integers(1, v, (b, t)).astype(np.int32)
    tgt[1, 5:] = 0
    tgt[2, 3:] = 0
    w = np.array([1.0, 1.0, 0.0], np.float32)
    if kind == "ls":
        jfn = lambda x: JL.label_smoothing_loss(x, jnp.asarray(tgt), v, 0.1)
        tfn = lambda x: TL.label_smoothing_loss(x, torch.from_numpy(tgt), v,
                                                0.1)
    elif kind == "ls_masked":
        jfn = lambda x: JL.label_smoothing_loss(
            x, jnp.asarray(tgt), v, 0.1, mask_pad=True, utt_w=jnp.asarray(w))
        tfn = lambda x: TL.label_smoothing_loss(
            x, torch.from_numpy(tgt), v, 0.1, mask_pad=True,
            utt_w=torch.from_numpy(w))
    else:
        jfn = lambda x: JL.cross_entropy_loss(x, jnp.asarray(tgt),
                                              utt_w=jnp.asarray(w))
        tfn = lambda x: TL.cross_entropy_loss(x, torch.from_numpy(tgt),
                                              utt_w=torch.from_numpy(w))
    jl, jg = jax.value_and_grad(jfn)(jnp.asarray(logits))
    x = torch.from_numpy(logits * scale).requires_grad_()
    tl = tfn(x)
    (tg,) = torch.autograd.grad(tl, [x])
    return _rel(jl, tl.detach()), _rel(jg, tg)


@pytest.mark.parametrize("kind", ["ls", "ls_masked", "ce"])
def test_attention_losses_match_jax(kind):
    assert max(_ls_both(kind)) <= LS_REL


def test_label_smoothing_keeps_the_unmasked_mean():
    """The reference quirk: padding positions count in the mean."""
    logits = torch.randn(2, 4, 5, generator=torch.Generator().manual_seed(0))
    tgt = torch.tensor([[1, 2, 0, 0], [3, 0, 0, 0]])
    full = TL.label_smoothing_loss(logits, tgt, 5, 0.1)
    masked = TL.label_smoothing_loss(logits, tgt, 5, 0.1, mask_pad=True)
    assert abs(full.item() - masked.item()) > 1e-3


def test_attention_losses_vs_jax_fail_under_doubled_logits():
    assert _ls_both("ls", scale=2.0)[0] > 100 * LS_REL


# ----------------------------------------------------------- SpecAugment
# JAX draws its masks inside ``_one_example``; the same draws, taken with
# the same key splits, are fed to the port's ``apply_masks``: the outputs
# agree to f32 rounding of the mean fill (atol 1e-6).
SA_ATOL = 1e-6


def _jax_draws(key, feat_len, f_dim, max_t=40, max_f=27, num_masks=2):
    """The mask bounds ``JS._one_example`` draws for one utterance."""
    def rand_below(k, hi):
        return int(jnp.floor(jax.random.uniform(k)
                             * jnp.asarray(hi, jnp.int32).astype(jnp.float32)
                             ).astype(jnp.int32))
    out = {k: [] for k in ("t_start", "t_end", "f_start", "f_end")}
    for _ in range(num_masks):
        key, k1, k2, k3, k4, k5, k6 = jax.random.split(key, 7)
        width = rand_below(k1, max_t)
        start = rand_below(k2, max(feat_len - width, 1))
        end = start + rand_below(k3, max(width, 1))
        fwidth = rand_below(k4, max_f)
        fstart = rand_below(k5, max(f_dim - fwidth, 1))
        fend = fstart + rand_below(k6, max(fwidth, 1))
        for k, v in zip(out, (start, end, fstart, fend)):
            out[k].append(v)
    return out


def _specaug_both(shift=0):
    rng = np.random.default_rng(13)
    b, t, d = 4, 60, 30
    spec = rng.uniform(0, 1, (b, t, d)).astype(np.float32)
    feat_len = np.array([60, 45, 30, 8], np.int32)
    key = jax.random.PRNGKey(5)
    want = JS.spec_augment(jnp.asarray(spec), jnp.asarray(feat_len), key,
                           max_t=20, max_f=12, num_masks=2)
    keys = jax.random.split(key, b)
    draws = [_jax_draws(keys[i], int(feat_len[i]), d, 20, 12, 2)
             for i in range(b)]
    masks = {k: torch.tensor([dr[k] for dr in draws]) + shift
             for k in draws[0]}
    got = TS.apply_masks(torch.from_numpy(spec),
                         torch.from_numpy(feat_len).long(), masks)
    return float(np.max(np.abs(np.asarray(want) - got.numpy())))


def test_apply_masks_matches_jax_one_example():
    assert _specaug_both() <= SA_ATOL


def test_apply_masks_vs_jax_fails_under_shifted_masks():
    assert _specaug_both(shift=2) > 1e-2


def test_draw_masks_stays_in_range():
    gen = torch.Generator().manual_seed(0)
    feat_len = torch.tensor([100, 50, 7, 1])
    for _ in range(20):
        m = TS.draw_masks(gen, feat_len, 40, max_t=40, max_f=27)
        width = m["t_end"] - m["t_start"]
        assert bool((m["t_start"] >= 0).all() and (width >= 0).all()
                    and (width < 40).all())
        assert bool((m["t_start"] < torch.clamp(feat_len, min=1)[:, None])
                    .all())
        fw = m["f_end"] - m["f_start"]
        assert bool((fw >= 0).all() and (fw < 27).all()
                    and (m["f_end"] <= 40).all())


# -------------------------------------------------------------- Adadelta
# Both sides start from the same non-zero JAX state (``from_jax_opt_state``)
# and take 3 updates on the same gradients, one of them clipped and one
# non-finite (skipped whole). Parameters: rel 1e-6 (the same f32 ops,
# the global norm summed in another order); bf16 accumulators: equal up to
# one bf16 ulp (rel 2^-7); the update count: equal.
OPT_REL = 1e-6


def _opt_params(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32),
                  "d": [rng.standard_normal((2, 2)).astype(np.float32)]}}


def _grads(rng, kind):
    g = _opt_params(rng)
    scale = {"small": 0.1, "big": 10.0, "nan": 1.0}[kind]
    g = jax.tree.map(lambda x: x * scale, g)
    if kind == "nan":
        g["b"]["c"][2] = np.nan
    return g


def _adadelta_both(sched, lr_scale=1.0):
    rng = np.random.default_rng(14)
    hp = dict(optimizer="Adadelta", lr=1.0, eps=1e-8, lr_scheduler=sched,
              optim_state_dtype="bfloat16")
    tx, _ = JO.build_optimizer(grad_clip=5.0, **hp)
    params = _opt_params(rng)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    offset = 101998 if sched == "self_defined" else 0
    state = jax.tree.map(lambda x: x + offset if x.dtype == jnp.int32 else x,
                         state)
    for _ in range(2):                        # a non-zero starting state
        up, state = tx.update(jax.tree.map(jnp.asarray, _grads(rng, "small")),
                              state, jp)
        jp = optax.apply_updates(jp, up)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    tstate = convert.from_jax_opt_state(jax.tree.map(np.asarray, state))
    assert tstate["e_g"]["a"].dtype == torch.bfloat16
    opt = TO.build_optimizer(grad_clip=5.0, **dict(hp, lr=lr_scale))
    worst = 0.0
    for kind in ("big", "nan", "small"):
        g = _grads(rng, kind)
        jnorm = float(JO.global_norm(jax.tree.map(jnp.asarray, g)))
        up, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, up)
        tnorm = opt.step(tp, convert.from_jax_params(g), tstate)
        assert np.isnan(jnorm) == bool(torch.isnan(tnorm))
        if kind != "nan":
            assert abs(float(tnorm) - jnorm) <= 1e-6 * jnorm
        jstate = convert.from_jax_opt_state(jax.tree.map(np.asarray, state))
        assert int(jstate["count"]) == int(tstate["count"])
        for j, t in zip(convert.tree_leaves(jax.tree.map(np.asarray, jp)),
                        convert.tree_leaves(tp)):
            worst = max(worst, _rel(j, t))
        for tree in ("e_g", "e_x"):
            for j, t in zip(convert.tree_leaves(jstate[tree]),
                            convert.tree_leaves(tstate[tree])):
                assert t.dtype == torch.bfloat16
                assert _rel(j.float(), t.float()) <= 2.0 ** -7
    return worst, int(tstate["count"])


@pytest.mark.parametrize("sched", ["fixed", "warmup", "self_defined"])
def test_adadelta_matches_optax(sched):
    worst, count = _adadelta_both(sched)
    assert worst <= OPT_REL
    # 2 warm-up updates + 2 taken; the non-finite one is skipped
    assert count == 4 + (101998 if sched == "self_defined" else 0)


def test_adadelta_vs_optax_fails_under_doubled_lr():
    assert _adadelta_both("fixed", lr_scale=2.0)[0] > 100 * OPT_REL


def test_tf_rate_and_schedules():
    fn = TO.tf_rate_fn(1.0, 0.6, 100, 10)
    assert fn(0) == 1.0 and fn(60) == pytest.approx(0.8) and fn(500) == 0.6
    sched = TO.lr_schedule(1.0, "self_defined")
    assert float(sched(99999)) == 1.0
    assert float(sched(100000)) == pytest.approx(0.85)
    assert float(sched(102000)) == pytest.approx(0.85 ** 2)


# ------------------------------------------------------- the slice whole
# One train_step of a small flagship-shaped model (VGG-5 + 2x BLSTM-32, loc
# attention dim 16, 2x LSTM-32 decoder, ctc_weight 0.5, int8 value table +
# bf16 d_key, label smoothing, Adadelta with bf16 state), f32 compute, from
# the same converted JAX parameters and the same features.
#
# The reference does not pin every leaf down: when JAX's own input features
# move by 1e-6 (relative), its VGG frontend gradients move by 30-70% (max
# pool winners and relu kinks flip) and its attention gradients by ~2e-3.
# So JAX runs twice, the second time on perturbed features, and each
# quantity of the port must stay within BASE + NOISE_X * the reference's own
# movement on it. BASE: 1e-5 for the losses, 1e-3 for each gradient leaf and
# each leaf's parameter change after two updates (max |err| over max |JAX
# value|: f32 sums in other orders over bf16-rounded recurrence operands).
STEP_BASE = {"loss": 1e-5, "leaf": 1e-3}
NOISE_X = 10
FEAT_NOISE = 1e-6
MODEL = dict(
    ctc_weight=0.5,
    encoder=dict(vgg=5, vgg_freq=-1, vgg_low_filt=-1, module="LSTM",
                 bidirection=True, dim=[32, 32], dropout=[0.0, 0.0],
                 layer_norm=[False, False], proj=[True, True],
                 sample_rate=[1, 1], sample_style="drop"),
    attention=dict(mode="loc", dim=16, num_head=1, v_proj=False,
                   temperature=0.5, loc_kernel_size=5, loc_kernel_num=3),
    decoder=dict(module="LSTM", dim=32, layer=2, dropout=0),
    value_table="int8", dkey_bf16=True)
HP = dict(optimizer="Adadelta", lr=1.0, eps=1e-8, lr_scheduler="fixed",
          optim_state_dtype="bfloat16")
VOCAB = 31


def _batch():
    """Two utterances of the synthetic tone corpus (4 and 3 tokens + eos)."""
    corpus = SyntheticCorpus(VOCAB, seed=3)
    utts = [corpus.utterance(i, n) for i, n in ((0, 4), (1, 3))]
    n_wav = max(len(w) for w, _ in utts)
    n_txt = max(len(t) for _, t in utts)
    wav = np.zeros((2, n_wav), np.float32)
    txt = np.zeros((2, n_txt), np.int32)
    for i, (w, t) in enumerate(utts):
        wav[i, :len(w)] = w
        txt[i, :len(t)] = t
    return {"wav": wav, "txt": txt,
            "wav_len": np.array([len(w) for w, _ in utts], np.int32),
            "txt_len": np.array([len(t) for _, t in utts], np.int32)}


def _jax_steps(jspec, jp, feat, feat_len, txt, txt_len):
    """The JAX step, twice: (loss at step 1, its gradients as a port tree,
    loss at step 2, the parameter change after both updates)."""
    def jloss(p, f):
        ctc_out, enc_len, att_out, _, _ = JM.asr_apply(
            p, jspec, f, feat_len, txt.shape[1], teacher=txt,
            rng=jax.random.PRNGKey(0), train=True, sample_free=True)
        return (JC.ctc_loss(ctc_out, enc_len, txt, txt_len) * 0.5
                + JL.label_smoothing_loss(att_out, txt, VOCAB, 0.1) * 0.5)
    step = jax.jit(jax.value_and_grad(jloss))
    tx, _ = JO.build_optimizer(grad_clip=5.0, **HP)

    def run(f):
        state, p, out = tx.init(jp), jp, []
        for _ in range(2):
            loss, g = step(p, f)
            up, state = tx.update(g, state, p)
            p = optax.apply_updates(p, up)
            out.append((float(loss), g))
        delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), p,
                             jp)
        return (out[0][0], convert.from_jax_params(
            jax.tree.map(np.asarray, out[0][1])), out[1][0],
            convert.from_jax_params(delta))
    noise = np.random.default_rng(16).standard_normal(feat.shape)
    return run(jnp.asarray(feat)), run(jnp.asarray(
        (feat * (1.0 + FEAT_NOISE * noise)).astype(np.float32)))


def _leaf_rels(names, ref, got):
    return {n: _rel(r, g) for n, r, g in zip(
        names, convert.tree_leaves(ref), convert.tree_leaves(got))}


def _step_both(fault=1.0):
    """{quantity: (port's error, the reference's own movement)} for the two
    losses, every gradient leaf and every leaf's parameter change; ``fault``
    scales the port's learning rate and its compared gradients."""
    data = _batch()
    feat_cfg = FeatureConfig(feat_dim=40, delta_order=2)
    jspec = JM.build_spec(120, VOCAB, **MODEL)
    jp = JM.asr_init(jax.random.PRNGKey(3), jspec)
    tspec = TM.build_spec(120, VOCAB, **MODEL)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    opt = TO.build_optimizer(grad_clip=5.0, **dict(HP, lr=fault))
    cfg = TT.StepConfig(tspec, feat_cfg, opt, torch.float32, augment=False,
                        label_smoothing=True, sample_free=True)
    batch = TT.to_device(data, "cpu")
    # the JAX side takes the port's features: this holds the model, losses
    # and optimizer (the front end has its own parity test)
    feat, feat_len = extract_features(feat_cfg, batch["wav"],
                                      batch["wav_len"])
    ref, moved = _jax_steps(jspec, jp, feat.numpy(),
                            jnp.asarray(feat_len.numpy()),
                            jnp.asarray(data["txt"]),
                            jnp.asarray(data["txt_len"]))

    tl, _, tg = TT.loss_and_grads(cfg, tp, batch, None, 1.0)
    tg = convert.tree_map(lambda g: g * fault, tg)
    params = copy.deepcopy(tp)
    ostate = opt.init(params)
    losses = []
    for _ in range(2):
        params, ostate, metrics, ctc_out, att_out = TT.train_step(
            cfg, params, ostate, batch, None, 1.0)
        losses.append(float(metrics["total"]))
    assert all(t.dtype == torch.bfloat16
               for t in convert.tree_leaves(ostate["e_g"]))
    assert int(ostate["count"]) == 2 and losses[0] == float(tl)
    assert att_out.shape == (2, 5, VOCAB) and ctc_out.shape[0] == 2
    delta = convert.tree_map(lambda a, b: a - b, params, tp)

    names = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    res = {"loss": (_rel(ref[0], losses[0]), _rel(ref[0], moved[0])),
           "loss2": (_rel(ref[2], losses[1]), _rel(ref[2], moved[2]))}
    for key, i, tree in (("grad", 1, tg), ("delta", 3, delta)):
        err, floor = _leaf_rels(names, ref[i], tree), _leaf_rels(
            names, ref[i], moved[i])
        res.update({key + n: (err[n], floor[n]) for n in names})
    return res


def _out_of_bounds(res):
    return {k: v for k, v in res.items()
            if v[0] > STEP_BASE["loss" if k.startswith("loss") else "leaf"]
            + NOISE_X * v[1]}


def test_train_step_matches_jax(jax_kernels):
    res = _step_both()
    assert not _out_of_bounds(res), _out_of_bounds(res)


def test_train_step_vs_jax_fails_under_doubled_lr_and_grads(jax_kernels):
    res = _step_both(fault=2.0)
    bad = _out_of_bounds(res)
    assert "loss2" in bad
    # every leaf the reference pins down (moves < 5% itself) is caught
    pinned = [k for k, v in res.items() if k[:1] in "gd" and v[1] < 0.05]
    assert len(pinned) > 30 and all(k in bad for k in pinned), (
        sorted(set(pinned) - set(bad)))


# -------------------------------------------------------- the CLI, on CPU
TINY_MODEL = dict(
    ctc_weight=0.5,
    encoder=dict(vgg=5, vgg_freq=-1, vgg_low_filt=-1, module="LSTM",
                 bidirection=True, dim=[16, 16], dropout=[0.3, 0.3],
                 layer_norm=[False, False], proj=[True, True],
                 sample_rate=[1, 1], sample_style="drop"),
    attention=dict(mode="loc", dim=8, num_head=1, v_proj=False,
                   temperature=0.5, loc_kernel_size=5, loc_kernel_num=3),
    decoder=dict(module="LSTM", dim=16, layer=2, dropout=0),
    value_table="int8", dkey_bf16=True)


def _write_configs(tmp, max_step=2):
    with open(os.path.join(ROOT, "config", "librispeech_asr_best.yaml")) as f:
        flagship = yaml.safe_load(f)
    audio = flagship["data"]["audio"]
    text = dict(flagship["data"]["text"])
    text["vocab_file"] = os.path.join(ROOT, text["vocab_file"])
    corpus = {"name": "synthetic", "path": "", "batch_size": 4, "n_utts": 8,
              "max_tokens": 6}
    hparas = dict(flagship["hparas"], valid_step=max_step,
                  max_step=max_step)
    train = {"data": {"corpus": dict(corpus, train_split=["train"],
                                     dev_split=["dev"], bucketing=True),
                      "audio": audio, "text": text},
             "hparas": hparas, "model": TINY_MODEL}
    paths = {k: os.path.join(tmp, k + ".yaml") for k in ("train", "test")}
    test = {"data": {"corpus": dict(corpus, dev_split=["dev"],
                                    test_split=["test"], bucketing=False)},
            "src": {"config": paths["train"],
                    "ckpt": os.path.join(tmp, "ckpt", "tiny",
                                         "last_att_dev.pth")},
            "decode": {"beam_size": 1, "min_len_ratio": 0.01,
                       "max_len_ratio": 0.3, "ctc_weight": 0.0,
                       "lm_weight": 0.0}}
    for name, cfg in (("train", train), ("test", test)):
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    return paths


def test_cli_trains_validates_checkpoints_and_decodes(tmp_path):
    from e2e_asr_pytorch_tpu_torch import main as TMain
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    from e2e_asr_pytorch_tpu_torch.train import checkpoint as ckpt_lib
    paths = _write_configs(str(tmp_path))
    argv = ["--config", paths["train"], "--name", "tiny", "--cpu", "--njobs",
            "0", "--logdir", str(tmp_path / "log"), "--ckpdir",
            str(tmp_path / "ckpt"), "--no-msg"]
    launches = K.LAUNCHES
    solver = TMain.main(argv)
    assert K.LAUNCHES == launches            # CPU tensors: plain versions
    assert solver.step == 2 and len(solver.step_seconds) == 2
    assert all(n > 0 for n in solver.decode_lengths), solver.decode_lengths
    assert solver.n_valid_batches > 0
    names = sorted(os.listdir(tmp_path / "ckpt" / "tiny"))
    assert {"last_att_dev.pth", "last_ctc_dev.pth"} <= set(names), names
    ck = ckpt_lib.load_checkpoint(
        str(tmp_path / "ckpt" / "tiny" / "last_att_dev.pth"))
    assert ck["global_step"] == 2 and int(ck["optimizer"]["count"]) == 2
    assert ck["optimizer"]["e_g"]["decoder"]["char_trans"]["w"].dtype == \
        torch.bfloat16
    init = TM.asr_init(torch.Generator().manual_seed(0), solver.spec)
    moved = [not torch.equal(a, b) for a, b in zip(
        convert.tree_leaves(init), convert.tree_leaves(ck["model"]))]
    assert any(moved)
    # resume from the checkpoint: optimizer state and step come back
    resumed = TMain.build_solver(argv + ["--load", str(
        tmp_path / "ckpt" / "tiny" / "last_att_dev.pth")])
    resumed.set_model()
    assert resumed.step == 2 and int(resumed.opt_state["count"]) == 2
    # the port's --test greedy path decodes the trained checkpoint
    out = tmp_path / "out"
    TMain.main(["--test", "--config", paths["test"], "--name", "greedy",
                "--cpu", "--njobs", "0", "--outdir", str(out), "--no-msg"])
    rows = (out / "greedy_test_output.csv").read_text().splitlines()
    assert rows[0] == "idx\thyp\ttruth" and len(rows) == 1 + 8


def test_training_never_imports_jax(tmp_path):
    """The port's CLI trains a tiny model for one step in a fresh process
    and JAX is never imported (the JAX train-mode loader would)."""
    paths = _write_configs(str(tmp_path), max_step=1)
    code = (
        "import sys\n"
        "from e2e_asr_pytorch_tpu_torch.main import main\n"
        "s = main(sys.argv[1:])\n"
        "assert s.step == 1, s.step\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'e2e_asr_pytorch_tpu' or "
        "m.startswith('e2e_asr_pytorch_tpu.'))\n"
        "assert not bad, bad[:5]\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", code, "--config", paths["train"], "--name",
         "tiny", "--cpu", "--njobs", "0", "--logdir", str(tmp_path / "log"),
         "--ckpdir", str(tmp_path / "ckpt"), "--no-msg"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0 and "NO_JAX_OK" in res.stdout, (
        res.stdout[-2000:], res.stderr[-4000:])


def test_cli_training_refuses_to_run_without_cuda(tmp_path):
    from e2e_asr_pytorch_tpu_torch.main import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    paths = _write_configs(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--config", paths["train"], "--njobs", "0", "--no-msg",
              "--logdir", str(tmp_path / "log"), "--ckpdir",
              str(tmp_path / "ckpt")])


def _random_step(seed):
    """One training step of the tiny model with SpecAugment and encoder
    dropout on, every draw from a generator seeded with ``seed``."""
    spec = TM.build_spec(120, VOCAB, **TINY_MODEL)
    params = TM.asr_init(torch.Generator().manual_seed(0), spec)
    opt = TO.build_optimizer(grad_clip=5.0, **HP)
    cfg = TT.StepConfig(spec, FeatureConfig(feat_dim=40, delta_order=2),
                        opt, torch.float32, augment=True,
                        label_smoothing=True, sample_free=True)
    gen = torch.Generator().manual_seed(seed)
    _, _, metrics, _, _ = TT.train_step(cfg, params, opt.init(params),
                                        TT.to_device(_batch(), "cpu"), gen,
                                        1.0)
    return metrics["total"].item(), metrics["gnorm"].item()


def test_training_randomness_comes_from_the_generator():
    assert _random_step(5) == _random_step(5)
    assert _random_step(5) != _random_step(6)


def _pool_grads(x, port_pool):
    """Gradients of <maxpool(x), ct> through the JAX frontend's pool (its
    reshape form, taken below batch 48) and through ``port_pool``."""
    from e2e_asr_pytorch_tpu.models import frontend as JF
    ct = np.random.default_rng(17).standard_normal(
        (2, 3, 2, 2)).astype(np.float32)                     # B,T/2,F/2,C
    jg = jax.grad(lambda v: jnp.sum(JF._maxpool(v, (2, 2)) * ct))(
        jnp.asarray(x))
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    (tg,) = torch.autograd.grad(
        (port_pool(tx, (2, 2)) * torch.from_numpy(
            ct.transpose(0, 3, 1, 2).copy())).sum(), [tx])
    return np.asarray(jg), tg.numpy().transpose(0, 2, 3, 1)


def test_frontend_pool_splits_tied_gradients_like_jax():
    """Windows of equal values (the relu zeros of the padding) share the
    gradient evenly in the JAX package; max_pool2d would route it all to
    the first element."""
    from e2e_asr_pytorch_tpu_torch.models import frontend as TF
    x = np.random.default_rng(18).standard_normal(
        (2, 7, 5, 2)).astype(np.float32)                     # B,T,F,C
    x[1, 2:] = 0.0                                           # tied windows
    jg, tg = _pool_grads(x, TF._maxpool)
    np.testing.assert_array_equal(jg, tg)
    jg, fg = _pool_grads(x, lambda v, w: torch.nn.functional.max_pool2d(
        v, w, w))
    assert np.abs(jg - fg).max() > 0.1


def test_async_checkpoint_writer_snapshots_and_raises(tmp_path):
    """A save keeps the values of the moment it was asked for (the
    optimizer updates parameters in place afterwards), and a failed write
    is raised by the next wait."""
    from e2e_asr_pytorch_tpu_torch.train import checkpoint as ckpt_lib
    writer = ckpt_lib.AsyncCheckpointWriter()
    params = {"w": torch.zeros(3)}
    writer.save(str(tmp_path / "ok.pth"), params,
                {"count": torch.tensor(3)}, 5, "wer", 0.5)
    params["w"].add_(1.0)
    writer.wait()
    ck = ckpt_lib.load_checkpoint(str(tmp_path / "ok.pth"))
    assert ck["global_step"] == 5 and int(ck["optimizer"]["count"]) == 3
    assert torch.equal(ck["model"]["w"], torch.zeros(3))
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    writer.save(str(blocker / "ck.pth"), params, None, 6)
    with pytest.raises(OSError):
        writer.wait()
