"""Listener: conv frontend + (B)LSTM/GRU/liGRU stack with time downsampling
(port of e2e_asr_pytorch_tpu/models/encoder.py).

Each layer is a recurrent pass (``encoder.module``: 'LSTM', 'GRU' or
'liGRU', one direction or two), an optional f32-statistics LayerNorm,
dropout in train mode (the light GRU applies its own recurrent dropout
instead), 'drop'/'concat' time downsampling and a tanh-Linear projection.
Every recurrence goes to its hand-written kernel (``ops/rnn.py``). The stack
runs time-major inside (one transpose in, one out) for every module; the
JAX package does so for the LSTM only, and the values are the same.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from e2e_asr_pytorch_tpu_torch.convert import tree_map
from e2e_asr_pytorch_tpu_torch.models import frontend as F
from e2e_asr_pytorch_tpu_torch.ops import rnn as R


class EncoderSpec(NamedTuple):
    input_size: int
    frontend: Optional[F.FrontendSpec]
    module: str
    bidirection: bool
    dim: Tuple[int, ...]
    dropout: Tuple[float, ...]
    layer_norm: Tuple[bool, ...]
    proj: Tuple[bool, ...]
    sample_rate: Tuple[int, ...]
    sample_style: str
    out_dim: int
    total_sample_rate: int
    layer_in_dims: Tuple[int, ...]
    layer_out_dims: Tuple[int, ...]
    remat: bool = False


def make_spec(input_size: int, vgg: int = 0, vgg_freq: int = -1,
              vgg_low_filt: int = -1, module: str = "LSTM",
              bidirection: bool = True, dim=(), dropout=(), layer_norm=(),
              proj=(), sample_rate=(), sample_style: str = "drop",
              prenet: str = "", remat: bool = False) -> EncoderSpec:
    if prenet and vgg == 0:
        if prenet != "vgg":
            raise ValueError("unsupported prenet: " + prenet)
        vgg = 1
    if not len(sample_rate) == len(dropout) == len(dim):
        raise ValueError("Number of layer mismatch")
    if sample_style not in ("drop", "concat"):
        raise ValueError("sample_style must be drop or concat, got "
                         + sample_style)
    if module not in ("LSTM", "GRU", "liGRU"):
        raise ValueError("encoder module must be LSTM, GRU or liGRU, got "
                         + module)
    fe = F.make_spec(vgg, input_size, vgg_freq, vgg_low_filt) if vgg > 0 \
        else None
    d = fe.out_dim if fe is not None else input_size
    total_sr = fe.sample_rate if fe is not None else 1
    in_dims, out_dims = [], []
    for l in range(len(dim)):
        in_dims.append(d)
        rnn_out = 2 * dim[l] if bidirection else dim[l]
        out_dims.append(rnn_out)
        d = sample_rate[l] * rnn_out if (sample_rate[l] > 1 and
                                         sample_style == "concat") else rnn_out
        total_sr *= sample_rate[l]
    return EncoderSpec(input_size, fe, module, bidirection, tuple(dim),
                       tuple(dropout), tuple(layer_norm), tuple(proj),
                       tuple(sample_rate), sample_style, d, total_sr,
                       tuple(in_dims), tuple(out_dims), bool(remat))


def encoder_init(gen: torch.Generator, spec: EncoderSpec) -> Dict:
    params: Dict = {}
    if spec.frontend is not None:
        params["frontend"] = F.frontend_init(gen, spec.frontend)
    init = {"LSTM": R.lstm_init, "GRU": R.gru_init,
            "liGRU": R.ligru_init}[spec.module]
    layers = []
    for l in range(len(spec.dim)):
        p: Dict = {"fw": init(gen, spec.layer_in_dims[l], spec.dim[l])}
        if spec.bidirection:
            p["bw"] = init(gen, spec.layer_in_dims[l], spec.dim[l])
        if spec.layer_norm[l]:
            p["ln"] = {"scale": torch.ones(spec.layer_out_dims[l]),
                       "bias": torch.zeros(spec.layer_out_dims[l])}
        if spec.proj[l]:
            p["pj"] = R.espnet_linear_init(gen, spec.layer_out_dims[l],
                                           spec.layer_out_dims[l])
        layers.append(p)
    params["layers"] = layers
    return params


def _layer_norm(lnp: Dict, y: torch.Tensor) -> torch.Tensor:
    """LayerNorm over features with f32 statistics (population variance);
    the stream stays in its dtype."""
    yf = y.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, correction=0)
    yn = (yf - mean) * torch.rsqrt(var + 1e-5)
    return (yn * lnp["scale"] + lnp["bias"]).to(y.dtype)


def _rnn_layer_apply(p: Dict, spec: EncoderSpec, l: int, x: torch.Tensor,
                     x_len: torch.Tensor, compute_dtype, train: bool = False,
                     gen: Optional[torch.Generator] = None):
    """One time-major (T,B,D) layer: recurrent pass -> LN -> dropout (train)
    -> downsample -> proj."""
    if spec.module == "LSTM":
        if spec.bidirection:
            y = R.bilstm_layer(p["fw"], p["bw"], x, compute_dtype)
        else:
            y = R.lstm_layer_kernel(p["fw"], x, compute_dtype=compute_dtype,
                                    time_major=True)
    elif spec.module == "GRU":
        if spec.bidirection:
            y = R.bigru_layer(p["fw"], p["bw"], x, compute_dtype,
                              time_major=True)
        else:
            y = R.gru_direction(p["fw"], x, False, compute_dtype, True)
    else:  # liGRU: its own recurrent dropout, one mask for both directions
        kw = dict(dropout=spec.dropout[l], gen=gen, train=train,
                  compute_dtype=compute_dtype, time_major=True)
        if spec.bidirection:
            y = R.biligru_layer(p["fw"], p["bw"], x, **kw)
        else:
            y, _ = R.ligru_layer(p["fw"], x, **kw)
    if spec.layer_norm[l]:
        y = _layer_norm(p["ln"], y)
    if train and spec.dropout[l] > 0 and spec.module != "liGRU":
        y = R.dropout(y, spec.dropout[l], gen)
    sr = spec.sample_rate[l]
    if sr > 1:
        x_len = x_len // sr
        if spec.sample_style == "drop":
            y = y[::sr]
        else:
            t, b, d = y.shape
            t = (t // sr) * sr
            # group sr consecutive frames along features: (T/sr, B, sr*D)
            y = y[:t].reshape(t // sr, sr, b, d).permute(0, 2, 1, 3).reshape(
                t // sr, b, sr * d)
    if spec.proj[l]:
        y = torch.tanh(R.linear(p["pj"], y, compute_dtype,
                                out_dtype=compute_dtype))
    return y, x_len


def encoder_apply(params: Dict, spec: EncoderSpec, feat: torch.Tensor,
                  feat_len: torch.Tensor, compute_dtype=torch.float32,
                  train: bool = False,
                  gen: Optional[torch.Generator] = None,
                  fix_layers: Tuple[int, ...] = (),
                  num_layers: Optional[int] = None):
    """(B,T,D) + lengths -> (B,T/s,out_dim) + lengths. ``train`` turns on
    the per-layer dropout, whose masks come from ``gen``. ``fix_layers``
    freezes the parameters of those rnn layers (-1: the frontend) for
    transfer learning: they get no gradient, while the gradient still flows
    through a frozen layer to the trainable layers below it.
    ``num_layers`` runs only the first layers of the stack."""
    x, x_len = feat, feat_len
    if spec.frontend is not None:
        fe = params["frontend"]
        if -1 in fix_layers:
            fe = tree_map(lambda t: t.detach(), fe)
        x, x_len = F.frontend_apply(fe, spec.frontend, x, x_len,
                                    compute_dtype)
    layers = params["layers"]
    n = len(layers) if num_layers is None else min(num_layers, len(layers))
    if n == 0:
        return x, x_len
    x = x.transpose(0, 1)
    for l in range(n):
        p = layers[l]
        if l in fix_layers:
            p = tree_map(lambda t: t.detach(), p)
        x, x_len = _rnn_layer_apply(p, spec, l, x, x_len, compute_dtype,
                                    train, gen)
    return x.transpose(0, 1), x_len
