"""The port's convolutional frontends, vgg codes 1 (VGG), 2 (FreqVGG), 3
(VGG2), 4 (FreqVGG2) and 7 (Featemb), against the JAX package's on shared
weights (``convert.from_jax_params``; the weights and non-zero biases come
from a numpy seed): forward and the gradient of every
parameter leaf under a fixed cotangent. f32 throughout; tolerance atol 1e-4
on the outputs and on each gradient leaf relative to its largest element:
f32 convs summed in another order. The batch stays under 48, where the JAX
max pool keeps the tie rule the port copies (the gradient of tied maxima
split evenly). Each code has a planted-fault twin: a doubled conv1 weight
for the codes without LayerNorm, a doubled ``dense.w`` for Featemb."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.models import encoder as JE
from e2e_asr_pytorch_tpu.models import frontend as JF
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.models import encoder as TE
from e2e_asr_pytorch_tpu_torch.models import frontend as TF

ATOL = 1e-4
# (input dim, make_spec keyword arguments): 3 x 40 fbank with deltas for the
# conv codes, a 24-wide upstream feature for Featemb
CODES = {1: (120, {}), 2: (120, dict(vgg_freq=16, vgg_low_filt=8)),
         3: (120, {}), 4: (120, dict(vgg_freq=24, vgg_low_filt=4)),
         7: (24, {})}


def _jax_params(vgg, jspec, rng):
    """The JAX frontend's parameter tree (shapes from ``jax.eval_shape`` of
    its init, so no random-number program is compiled) filled from a numpy
    seed: N(0, 1/fan_in) weights, N(0, 0.1^2) biases."""
    shapes = jax.eval_shape(lambda: JF.frontend_init(jax.random.PRNGKey(0),
                                                     jspec))

    def fill(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 100
        return jnp.asarray((rng.standard_normal(s.shape) / np.sqrt(fan_in))
                           .astype(np.float32))
    return jax.tree.map(fill, shapes)


def _fault(vgg, tree):
    """Double the first weight the input meets."""
    if vgg == 7:
        tree["dense"]["w"] = tree["dense"]["w"] * 2.0
    elif vgg in (2, 4):
        tree["low"]["conv1"]["w"] = tree["low"]["conv1"]["w"] * 2.0
    else:
        tree["conv1"]["w"] = tree["conv1"]["w"] * 2.0


def _both(vgg, fault=False, grads=True):
    """(max |output err|, max over leaves of max |grad err| / max |grad|,
    None without ``grads``)."""
    dim, kw = CODES[vgg]
    jspec, tspec = JF.make_spec(vgg, dim, **kw), TF.make_spec(vgg, dim, **kw)
    assert tuple(tspec) == tuple(jspec)
    rng = np.random.default_rng(vgg)
    jp = _jax_params(vgg, jspec, rng)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    if fault:
        _fault(vgg, tp)
    b, t = 3, 41
    feat = rng.uniform(0.0, 1.0, (b, t, dim)).astype(np.float32)
    feat_len = np.array([t, t - 9, t - 20], np.int32)

    def jfwd(p):
        return JF.frontend_apply(p, jspec, jnp.asarray(feat),
                                 jnp.asarray(feat_len))
    jy, jl = jfwd(jp)
    cot = rng.standard_normal(jy.shape).astype(np.float32)

    leaves = convert.tree_map(lambda x: x.clone().requires_grad_(), tp)
    ty, tl = TF.frontend_apply(leaves, tspec, torch.from_numpy(feat),
                               torch.from_numpy(feat_len).long())
    assert tuple(ty.shape) == jy.shape and ty.dtype == torch.float32
    assert jy.shape[-1] == jspec.out_dim
    assert jy.shape[1] == t // jspec.sample_rate
    assert np.array_equal(np.asarray(jl), tl.numpy())
    fwd = float(np.max(np.abs(np.asarray(jy) - ty.detach().numpy())))
    if not grads:
        return fwd, None
    jg = jax.grad(lambda p: jnp.sum(jfwd(p)[0] * cot))(jp)
    jg = convert.from_jax_params(jax.tree.map(np.asarray, jg))
    flat = convert.tree_leaves(leaves)
    tg = torch.autograd.grad((ty * torch.from_numpy(cot)).sum(), flat)
    grad = max(float((a - g).abs().max() / a.abs().max().clamp(min=1e-30))
               for a, g in zip(convert.tree_leaves(jg), tg))
    return fwd, grad


@pytest.mark.parametrize("vgg", sorted(CODES))
def test_frontend_matches_jax(vgg):
    fwd, grad = _both(vgg)
    assert fwd <= ATOL and grad <= ATOL, (fwd, grad)


@pytest.mark.parametrize("vgg", sorted(CODES))
def test_frontend_fails_under_planted_fault(vgg):
    fwd, _ = _both(vgg, fault=True, grads=False)
    assert fwd > 10 * ATOL, fwd


def test_prenet_vgg_builds_vgg1():
    kw = dict(dim=[8], dropout=[0.0], layer_norm=[False], proj=[True],
              sample_rate=[1], prenet="vgg")
    tspec, jspec = TE.make_spec(120, **kw), JE.make_spec(120, **kw)
    assert tspec.frontend == TF.make_spec(1, 120) == tuple(jspec.frontend)
    assert tspec.frontend.vgg == 1 and tspec.out_dim == jspec.out_dim
    assert tspec.layer_in_dims == jspec.layer_in_dims == (10 * 256,)


@pytest.mark.parametrize("vgg", [1, 2, 3, 4])
def test_conv_weights_of_every_code_become_oihw(vgg):
    """Every conv of the new codes, the nested low / high stacks of the
    freq-split codes included, goes HWIO -> OIHW."""
    dim, kw = CODES[vgg]
    jp = _jax_params(vgg, JF.make_spec(vgg, dim, **kw),
                     np.random.default_rng(0))
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    stacks = [(jp["low"], tp["low"]), (jp["high"], tp["high"])] \
        if vgg in (2, 4) else [(jp, tp)]
    for js, ts in stacks:
        for name in ("conv1", "conv2", "conv3", "conv4"):
            w = np.asarray(js[name]["w"])                           # HWIO
            np.testing.assert_array_equal(ts[name]["w"].numpy(),
                                          w.transpose(3, 2, 0, 1))


def test_featemb_dense_stays_2d():
    jp = _jax_params(7, JF.make_spec(7, 24), np.random.default_rng(0))
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    np.testing.assert_array_equal(tp["dense"]["w"].numpy(),
                                  np.asarray(jp["dense"]["w"]))
    assert tuple(tp["dense"]["w"].shape) == (24, 256)
