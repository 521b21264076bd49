"""The port's auxiliary blocks (``models/aux_blocks.py``) against the JAX
package's on shared weights from a numpy seed: the residual conv block
(NHWC, LayerNorm + tanh-GELU, with and without dropout: the JAX keep masks
are drawn as the JAX block draws them and given to the port) and the
batch-norm MLP head, forward and parameter gradients. f32, atol 1e-4 (each
gradient leaf relative to its largest element). Planted faults: a doubled
second conv weight, a doubled batch-norm scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.models import aux_blocks as JB
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.models import aux_blocks as TB

ATOL = 1e-4


def _fill(tree_shapes, rng):
    def fill(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 10
        return jnp.asarray((rng.standard_normal(s.shape) / np.sqrt(fan_in))
                           .astype(np.float32))
    return jax.tree.map(fill, tree_shapes)


def _compare(jfn, tfn, jp, x, fault=None):
    """(max |output err|, max leaf gradient err / max |gradient|)."""
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    if fault is not None:
        fault(tp)
    jy = jfn(jp)
    cot = np.random.default_rng(9).standard_normal(jy.shape).astype(
        np.float32)
    jg = jax.grad(lambda p: jnp.sum(jfn(p) * cot))(jp)
    jg = convert.from_jax_params(jax.tree.map(np.asarray, jg))
    leaves = convert.tree_map(lambda v: v.clone().requires_grad_(), tp)
    ty = tfn(leaves)
    assert tuple(ty.shape) == jy.shape
    tg = torch.autograd.grad((ty * torch.from_numpy(cot)).sum(),
                             convert.tree_leaves(leaves))
    fwd = float(np.max(np.abs(np.asarray(jy) - ty.detach().numpy())))
    return fwd, _grad_err(convert.tree_leaves(jg), tg)


def _grad_err(ref, got):
    """Max over leaves of max |err| / max |ref leaf|. A leaf whose reference
    is under one f32 epsilon of the largest leaf's is zero by construction
    (the linear biases before a batch norm): its error is taken relative to
    the largest leaf's instead."""
    top = max(float(a.abs().max()) for a in ref)
    floor = top * float(np.finfo(np.float32).eps)
    return max(float((a - g).abs().max())
               / (float(a.abs().max()) if float(a.abs().max()) > floor
                  else top) for a, g in zip(ref, got))


def _residual(dropout, fault=None):
    rng = np.random.default_rng(1)
    c = 6
    jp = _fill(jax.eval_shape(lambda: JB.residual_cnn_init(
        jax.random.PRNGKey(0), c)), rng)
    x = rng.standard_normal((2, 11, 9, c)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    train = dropout > 0
    masks = [torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(key, i), 1.0 - dropout, x.shape)))
        for i in (0, 1)] if train else None
    return _compare(
        lambda p: JB.residual_cnn_apply(p, jnp.asarray(x), dropout, key,
                                        train=train),
        lambda p: TB.residual_cnn_apply(p, torch.from_numpy(x), dropout,
                                        train=train, masks=masks),
        jp, x, fault)


def _dnn(fault=None):
    rng = np.random.default_rng(2)
    jp = _fill(jax.eval_shape(lambda: JB.dnn_init(jax.random.PRNGKey(0), 20,
                                                   32)), rng)
    x = rng.standard_normal((3, 7, 20)).astype(np.float32)
    return _compare(lambda p: JB.dnn_apply(p, jnp.asarray(x)),
                    lambda p: TB.dnn_apply(p, torch.from_numpy(x)), jp, x,
                    fault)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_residual_cnn_matches_jax(dropout):
    fwd, grad = _residual(dropout)
    assert fwd <= ATOL and grad <= ATOL, (fwd, grad)


def test_residual_cnn_fails_under_doubled_conv():
    def fault(tp):
        tp["cnn2"]["w"] = tp["cnn2"]["w"] * 2.0
    assert _residual(0.0, fault)[0] > 10 * ATOL


def test_residual_cnn_draws_its_masks_from_the_generator():
    """Without given masks, a train-mode block draws from ``gen``: two
    generators of one seed agree, and the result differs from eval mode."""
    p = TB.residual_cnn_init(torch.Generator().manual_seed(0), 4)
    x = torch.randn(2, 5, 6, 4, generator=torch.Generator().manual_seed(1))
    a, b = (TB.residual_cnn_apply(p, x, 0.5, torch.Generator().manual_seed(3),
                                  train=True) for _ in range(2))
    assert torch.equal(a, b)
    assert not torch.allclose(a, TB.residual_cnn_apply(p, x, 0.5))


def test_dnn_matches_jax():
    fwd, grad = _dnn()
    assert fwd <= ATOL and grad <= ATOL, (fwd, grad)


def test_dnn_fails_under_doubled_bn_scale():
    # (the batch norm after each fc cancels any scale of the fc's output, so
    # the fault doubles the shared batch-norm affine instead)
    def fault(tp):
        tp["bn_scale"] = tp["bn_scale"] * 2.0
    assert _dnn(fault)[0] > 10 * ATOL
