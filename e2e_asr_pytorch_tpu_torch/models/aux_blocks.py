"""Auxiliary building blocks (port of
e2e_asr_pytorch_tpu/models/aux_blocks.py): a pre-activation residual conv
block with LayerNorm + GELU, and a 2-layer batch-norm MLP head. Nothing in
either package wires them in; they are composable blocks for recipes that
extend the encoder.

The residual block keeps the JAX package's NHWC boundary (B,T,F,C) and runs
its convs in torch's NCHW inside. Dropout masks are drawn from a
``torch.Generator``, or given (``masks``), since a JAX draw cannot be
reproduced here.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from e2e_asr_pytorch_tpu_torch.models.frontend import _conv, _conv_init
from e2e_asr_pytorch_tpu_torch.ops.rnn import espnet_linear_init, linear


def residual_cnn_init(gen: torch.Generator, channels: int,
                      kernel: int = 3) -> Dict:
    return {"cnn1": _conv_init(gen, channels, channels, kernel),
            "cnn2": _conv_init(gen, channels, channels, kernel),
            "ln1": {"scale": torch.ones(channels),
                    "bias": torch.zeros(channels)},
            "ln2": {"scale": torch.ones(channels),
                    "bias": torch.zeros(channels)}}


def _ln_lastdim(p: Dict, x: torch.Tensor, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _conv_nhwc(p: Dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return _conv(p, x.permute(0, 3, 1, 2), compute_dtype).permute(0, 2, 3, 1)


def residual_cnn_apply(params: Dict, x: torch.Tensor, dropout: float = 0.0,
                       gen: Optional[torch.Generator] = None,
                       train: bool = False, compute_dtype=torch.float32,
                       masks: Optional[Sequence[torch.Tensor]] = None):
    """Pre-activation residual conv block on NHWC (B,T,F,C): LN -> GELU
    (tanh form, as ``jax.nn.gelu``) -> dropout -> conv -> LN -> GELU ->
    dropout -> conv -> + residual. In training with ``dropout`` > 0 the two
    keep masks are ``masks`` when given, else drawn from ``gen``."""
    keep = 1.0 - dropout
    drop = train and dropout > 0 and (masks is not None or gen is not None)

    def dropped(y, i):
        if not drop:
            return y
        m = masks[i] if masks is not None else (
            torch.rand(y.shape, generator=gen, device=y.device) < keep)
        return y * m / keep

    y = dropped(F.gelu(_ln_lastdim(params["ln1"], x), approximate="tanh"), 0)
    y = _conv_nhwc(params["cnn1"], y, compute_dtype)
    y = dropped(F.gelu(_ln_lastdim(params["ln2"], y), approximate="tanh"), 1)
    y = _conv_nhwc(params["cnn2"], y, compute_dtype)
    return y + x


def dnn_init(gen: torch.Generator, input_dim: int, hidden: int = 512) -> Dict:
    return {"fc1": espnet_linear_init(gen, input_dim, hidden),
            "fc2": espnet_linear_init(gen, hidden, hidden),
            "bn_scale": torch.ones(hidden),
            "bn_bias": torch.zeros(hidden)}


def dnn_apply(params: Dict, x: torch.Tensor,
              compute_dtype=torch.float32) -> torch.Tensor:
    """(B,T,D) -> (B,T,hidden): fc -> batch norm over B*T -> relu, twice,
    one batch norm affine shared by both."""
    def bn(y):
        mean = y.mean(dim=(0, 1), keepdim=True)
        var = y.var(dim=(0, 1), keepdim=True, correction=0)
        y = (y - mean) * torch.rsqrt(var + 1e-5)
        return y * params["bn_scale"] + params["bn_bias"]

    y = torch.relu(bn(linear(params["fc1"], x, compute_dtype)))
    return torch.relu(bn(linear(params["fc2"], y, compute_dtype)))
