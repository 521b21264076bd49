"""Port of the VGG-LN frontend and the BLSTM encoder against the JAX package
on shared weights (JAX params carried over with ``convert.from_jax_params``).
The JAX encoder runs its Pallas K1 in interpret mode, so both sides take the
recurrent matmul in bf16. Tolerance atol 1e-4: f32 convs, LayerNorms and
matmuls summed in another order, through 2 recurrent layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.models import encoder as JE
from e2e_asr_pytorch_tpu.models import frontend as JF
from e2e_asr_pytorch_tpu.ops.pallas import lstm as PL
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.models import encoder as TE
from e2e_asr_pytorch_tpu_torch.models import frontend as TF

ATOL = 1e-4
ENC = {
    "vgg5_blstm32x2_proj": dict(vgg=5, dim=[32, 32], dropout=[0.0, 0.0],
                                layer_norm=[False, False], proj=[True, True],
                                sample_rate=[1, 1], sample_style="drop"),
    "vgg5_ln_concat": dict(vgg=5, dim=[16, 16], dropout=[0.0, 0.0],
                           layer_norm=[True, False], proj=[False, True],
                           sample_rate=[2, 1], sample_style="concat"),
    "vgg6_drop": dict(vgg=6, dim=[16], dropout=[0.0], layer_norm=[False],
                      proj=[True], sample_rate=[2], sample_style="drop"),
}


@pytest.fixture
def jax_kernel(monkeypatch):
    monkeypatch.setenv("E2E_ASR_PALLAS", "force")
    monkeypatch.setattr(PL, "INTERPRET", True)


def _feat(seed=0, b=2, t=37, d=120):
    rng = np.random.default_rng(seed)
    feat = rng.uniform(0.0, 1.0, (b, t, d)).astype(np.float32)
    return feat, np.array([t, t - 9], np.int32)


def _both(name, wh_scale=1.0):
    kw = dict(ENC[name], vgg_freq=-1, vgg_low_filt=-1, module="LSTM",
              bidirection=True)
    jspec, tspec = JE.make_spec(120, **kw), TE.make_spec(120, **kw)
    assert tspec.out_dim == jspec.out_dim
    jp = JE.encoder_init(jax.random.PRNGKey(7), jspec)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    tp["layers"][0]["fw"]["w_h"] = tp["layers"][0]["fw"]["w_h"] * wh_scale
    feat, feat_len = _feat()
    jy, jl = JE.encoder_apply(jp, jspec, jnp.asarray(feat),
                              jnp.asarray(feat_len))
    ty, tl = TE.encoder_apply(tp, tspec, torch.from_numpy(feat),
                              torch.from_numpy(feat_len).long())
    assert tuple(ty.shape) == jy.shape
    assert np.array_equal(np.asarray(jl), tl.numpy())
    return float(np.max(np.abs(np.asarray(jy) - ty.float().numpy())))


@pytest.mark.parametrize("name", sorted(ENC))
def test_encoder_matches_jax(jax_kernel, name):
    assert _both(name) <= ATOL


def test_encoder_fails_under_doubled_w_h(jax_kernel):
    assert _both("vgg5_blstm32x2_proj", wh_scale=2.0) > 10 * ATOL


def _frontend_both(ln_scale=1.0):
    jspec, tspec = JF.make_spec(5, 120), TF.make_spec(5, 120)
    assert tuple(tspec) == tuple(jspec)
    jp = JF.frontend_init(jax.random.PRNGKey(3), jspec)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    tp["ln4"]["scale"] = tp["ln4"]["scale"] * ln_scale
    feat, feat_len = _feat(seed=1, t=41)
    jy, jl = JF.frontend_apply(jp, jspec, jnp.asarray(feat),
                               jnp.asarray(feat_len))
    ty, tl = TF.frontend_apply(tp, tspec, torch.from_numpy(feat),
                               torch.from_numpy(feat_len).long())
    assert tuple(ty.shape) == jy.shape == (2, 10, 10 * 128)
    assert np.array_equal(np.asarray(jl), tl.numpy())
    return float(np.max(np.abs(np.asarray(jy) - ty.numpy())))


def test_vgg_ln_frontend_matches_jax():
    assert _frontend_both() <= ATOL


def test_vgg_ln_frontend_fails_under_doubled_last_ln():
    # (a doubled conv would be no test: the LayerNorm after every conv
    # cancels a uniform scale of its zero-bias output)
    assert _frontend_both(ln_scale=2.0) > 10 * ATOL


def test_conv_weights_become_oihw():
    jp = JF.frontend_init(jax.random.PRNGKey(3), JF.make_spec(5, 120))
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    w = np.asarray(jp["conv2"]["w"])                      # HWIO
    assert tuple(tp["conv2"]["w"].shape) == (w.shape[3], w.shape[2], 3, 3)
    np.testing.assert_array_equal(tp["conv2"]["w"].numpy()[5, 4, 0, 2],
                                  w[0, 2, 4, 5])

