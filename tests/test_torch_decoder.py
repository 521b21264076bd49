"""The folded decoder's autodiff form (a decoder of any depth in training)
against the JAX package's ``_apply_folded`` scan on the same parameters:
one whole training step of a 1-layer decoder through ``_step_both`` (the
bounds of ``test_torch_train.py``), the forward and every gradient leaf of a
3-layer decoder, the ``value_table`` warning, and decoder dropout in
training still refusing. Each parity test has a twin with a planted fault
that must fail it."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.models import asr as JM
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.models import asr as TM
from test_torch_train import (MODEL, _out_of_bounds, _rel, _step_both,
                              jax_kernels)  # noqa: F401 (a fixture)

# the 1-layer decoder of config/synthetic_debug.yaml and
# config/librispeech_asr.yaml on the small model of test_torch_train.py
ONE_LAYER = dict(MODEL, decoder=dict(module="LSTM", dim=32, layer=1,
                                     dropout=0),
                 value_table="bf16", dkey_bf16=False)
# a 3-layer decoder: the forward's logits and attention weights, and each
# gradient leaf of the decoder, attention, embedding and CTC head, within
# GRAD_REL of the JAX value's max |.| (f32 sums in other orders). The
# encoder's leaves come back through the BLSTM backward, where the JAX
# side's Pallas K2 (interpret mode) and the port's plain version round
# bf16(dgates) operands, and a flipped rounding moves them by 2e-3 to 3e-3:
# ENC_GRAD_REL. A leaf whose JAX gradient is under one f32 epsilon of the
# largest leaf's (the energy bias: a common shift before the softmax) is
# zero by construction.
GRAD_REL = 1e-3
ENC_GRAD_REL = 1e-2
VOCAB = 11
DEEP = dict(
    ctc_weight=0.5,
    encoder=dict(vgg=6, vgg_freq=-1, vgg_low_filt=-1, module="LSTM",
                 bidirection=True, dim=[16], dropout=[0.0], layer_norm=[False],
                 proj=[True], sample_rate=[1], sample_style="drop"),
    attention=dict(mode="loc", dim=8, num_head=1, v_proj=False,
                   temperature=0.5, loc_kernel_size=5, loc_kernel_num=3),
    decoder=dict(module="LSTM", dim=16, layer=3, dropout=0))


def test_one_layer_train_step_matches_jax(jax_kernels):
    res = _step_both(model=ONE_LAYER)
    assert not _out_of_bounds(res), _out_of_bounds(res)


def test_one_layer_train_step_fails_under_doubled_lr_and_grads(jax_kernels):
    res = _step_both(fault=2.0, model=ONE_LAYER)
    bad = _out_of_bounds(res)
    assert "loss2" in bad
    pinned = [k for k, v in res.items() if k[:1] in "gd" and v[1] < 0.05]
    assert len(pinned) > 20 and all(k in bad for k in pinned), (
        sorted(set(pinned) - set(bad)))


@pytest.fixture(scope="module")
def deep():
    """The 3-layer decoder's JAX forward and gradients of
    sum(logits^2) + sum(attn * w) on one batch, and the inputs."""
    spec = JM.build_spec(40, VOCAB, **DEEP)
    jp = JM.asr_init(jax.random.PRNGKey(0), spec)
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((2, 40, 40)).astype(np.float32)
    feat_len = np.array([40, 29], np.int32)
    txt = rng.integers(1, VOCAB, (2, 5)).astype(np.int32)
    w_attn = rng.standard_normal((2, 1, 5, 10)).astype(np.float32)

    def loss(p):
        out = JM.asr_apply(p, spec, jnp.asarray(feat), jnp.asarray(feat_len),
                           5, teacher=jnp.asarray(txt), train=True,
                           sample_free=True)
        return (jnp.sum(out[2] ** 2) + jnp.sum(out[3] * w_attn),
                (out[2], out[3]))
    (_, (logits, attn)), grads = jax.value_and_grad(loss, has_aux=True)(jp)
    names = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    return dict(feat=feat, feat_len=feat_len, txt=txt, w_attn=w_attn,
                names=names, logits=np.asarray(logits),
                attn=np.asarray(attn),
                grads=convert.tree_leaves(convert.from_jax_params(
                    jax.tree.map(np.asarray, grads))),
                tp=convert.from_jax_params(jax.tree.map(np.asarray, jp)))


def _deep_port(d, scale_top_w_h=1.0):
    """The port's forward and gradients on ``deep``'s inputs; the top
    layer's w_h scaled by ``scale_top_w_h``."""
    spec = TM.build_spec(40, VOCAB, **DEEP)
    tp = convert.tree_map(lambda x: x.clone(), d["tp"])
    tp["decoder"]["layers"][2]["w_h"] = (tp["decoder"]["layers"][2]["w_h"]
                                         * scale_top_w_h)
    leaves = convert.tree_map(lambda x: x.detach().requires_grad_(), tp)
    out = TM.asr_apply(leaves, spec, torch.from_numpy(d["feat"]),
                       torch.from_numpy(d["feat_len"]).long(), 5,
                       teacher=torch.from_numpy(d["txt"]).long(), train=True,
                       sample_free=True)
    total = (out[2] ** 2).sum() + (out[3] * torch.from_numpy(
        d["w_attn"])).sum()
    flat = convert.tree_leaves(leaves)
    grads = torch.autograd.grad(total, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    largest = max(float(np.abs(g).max()) for g in d["grads"])
    errs = {"logits": _rel(d["logits"], out[2].detach()),
            "attn": _rel(d["attn"], out[3].detach())}
    for n, j, g in zip(d["names"], d["grads"], grads):
        if float(np.abs(j).max()) > largest * np.finfo(np.float32).eps:
            errs[n] = _rel(j, g)
    return errs


def test_deep_decoder_forward_and_grads_match_jax(jax_kernels, deep):
    errs = _deep_port(deep)
    assert sum("decoder" in n for n in errs) == 3 * 3 + 2, sorted(errs)
    bad = {n: e for n, e in errs.items()
           if e > (ENC_GRAD_REL if "encoder" in n else GRAD_REL)}
    assert not bad, bad


def test_deep_decoder_fails_under_doubled_top_w_h(jax_kernels, deep):
    errs = _deep_port(deep, scale_top_w_h=2.0)
    assert errs["logits"] > 10 * GRAD_REL
    assert errs["['decoder']['layers'][2]['w_h']"] > 10 * GRAD_REL


def _train_forward(model, train=True):
    spec = TM.build_spec(40, VOCAB, **model)
    params = TM.asr_init(torch.Generator().manual_seed(0), spec)
    feat = torch.randn(2, 24, 40, generator=torch.Generator().manual_seed(1))
    return TM.asr_apply(params, spec, feat, torch.tensor([24, 17]), 3,
                        teacher=torch.tensor([[1, 2, 3], [4, 5, 0]]),
                        train=train, sample_free=True)


def test_value_table_outside_the_envelope_warns_in_training():
    model = dict(DEEP, value_table="int8", dkey_bf16=True)
    with pytest.warns(UserWarning, match="hand-VJP decoder envelope not met"):
        _train_forward(model)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _train_forward(model, train=False)
        _train_forward(DEEP)


def test_decoder_dropout_in_training_still_raises():
    model = dict(DEEP, decoder=dict(DEEP["decoder"], dropout=0.1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _train_forward(model)
    out = _train_forward(model, train=False)
    assert out[2].shape == (2, 3, VOCAB)
