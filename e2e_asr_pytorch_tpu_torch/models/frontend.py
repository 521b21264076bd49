"""Convolutional frontends preceding the RNN encoder stack (port of
e2e_asr_pytorch_tpu/models/frontend.py). The ``vgg`` code selects

  1 VGG        -- 2x[conv,conv,maxpool2] 128->256 channels, time/4
  2 FreqVGG    -- low/high frequency bands in separate conv stacks, time/4
  3 VGG2       -- 64->128 channels, time/2 (the second pool is freq-only)
  4 FreqVGG2   -- the freq-split variant of 3, time/2
  5 VGG_LN     -- 64->128 channels with LayerNorm over frequency after
                  every conv, time/4 (the flagship)
  6 Downsample -- keep every 4th frame (no parameters)
  7 Featemb    -- a Linear to 256 over upstream features

The JAX package computes in NHWC (B,T,F,C) with HWIO weights; here the
convolutions run in torch's NCHW (B,C,T,F) with OIHW weights (``convert.py``
moves the layout), and the public boundary keeps the JAX shapes: input
(B,T,D) with delta channels channel-major in D, output (B,T/s,C'*F')
flattened channel-major.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from e2e_asr_pytorch_tpu_torch.ops import rnn as R

FBANK_SIZE = 40
MFCC_SIZE = 13


class FrontendSpec(NamedTuple):
    vgg: int
    in_channel: int
    freq_dim: int
    out_dim: int
    sample_rate: int          # time downsampling factor
    split_freq: int = -1
    low_filt: int = -1
    upstream: bool = False


def check_dim(input_dim: int) -> Tuple[int, int, bool]:
    """Infer (channels, freq) from the stacked feature dim: 13k MFCC or 40k
    fbank, else a flat upstream feature."""
    if input_dim % MFCC_SIZE == 0:
        return input_dim // MFCC_SIZE, MFCC_SIZE, False
    if input_dim % FBANK_SIZE == 0:
        return input_dim // FBANK_SIZE, FBANK_SIZE, False
    return 1, input_dim, True


def make_spec(vgg: int, input_dim: int, vgg_freq: int = -1,
              vgg_low_filt: int = -1) -> FrontendSpec:
    if vgg == 6:
        return FrontendSpec(6, 1, input_dim, input_dim, 4)
    if vgg == 7:
        return FrontendSpec(7, 1, input_dim, 256, 1)
    ch, freq, upstream = check_dim(input_dim)
    if vgg == 1:
        return FrontendSpec(1, ch, freq, (freq // 4) * 256, 4)
    if vgg == 5:
        return FrontendSpec(5, ch, freq, (freq // 4) * 128, 4,
                            upstream=upstream)
    if vgg == 3:
        return FrontendSpec(3, ch, freq, (freq // 4) * 128, 2)
    if vgg in (2, 4):
        if not (vgg_freq % 4 == 0 and 0 < vgg_freq < freq):
            raise ValueError("vgg_freq must be a multiple of 4 in (0, {}), "
                             "got {}".format(freq, vgg_freq))
        low_hide = vgg_low_filt * 2
        high_hide = 128 - low_hide
        out = ((vgg_freq // 4) * low_hide
               + ((freq - vgg_freq) // 4) * high_hide)
        return FrontendSpec(vgg, ch, freq, out, 4 if vgg == 2 else 2,
                            split_freq=vgg_freq, low_filt=vgg_low_filt)
    raise NotImplementedError("vgg = {} is not available".format(vgg))


def _conv_init(gen: torch.Generator, in_ch: int, out_ch: int,
               k: int = 3) -> Dict:
    # N(0, 1/sqrt(fan_in)), zero bias; OIHW
    w = torch.randn((out_ch, in_ch, k, k), generator=gen) / math.sqrt(
        in_ch * k * k)
    return {"w": w, "b": torch.zeros(out_ch)}


def _conv(p: Dict, x: torch.Tensor, compute_dtype=torch.float32):
    """3x3/pad 1 conv of (B,C,T,F) in compute_dtype (stays in it)."""
    return F.conv2d(x.to(compute_dtype), p["w"].to(compute_dtype),
                    p["b"].to(compute_dtype), padding=1)


def _maxpool(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """Non-overlapping max pool over (T,F) of (B,C,T,F), trimming the ragged
    edge like the JAX VALID window. Written as trim + reshape + amax, the
    JAX package's form at training batch: the gradient is split evenly
    among tied maxima (the all-zero windows of the padding after relu),
    where ``max_pool2d`` would route it to the first."""
    b, c, t, f = x.shape
    wt, wf = window
    x = x[:, :, :t - t % wt, :f - f % wf]
    return x.reshape(b, c, t // wt, wt, f // wf, wf).amax(dim=(3, 5))


def _ln_init(dim: int) -> Dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def _layernorm_freq(p: Dict, x: torch.Tensor, eps: float = 1e-5):
    """LayerNorm over the freq axis of (B,C,T,F); statistics in f32 with the
    population variance (jnp.var), data back in the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def _vgg_stack_init(gen: torch.Generator, in_ch: int, c1: int, c2: int,
                    with_ln: bool, freq: int) -> Dict:
    p = {"conv1": _conv_init(gen, in_ch, c1),
         "conv2": _conv_init(gen, c1, c1),
         "conv3": _conv_init(gen, c1, c2),
         "conv4": _conv_init(gen, c2, c2)}
    if with_ln:
        p["ln1"] = _ln_init(freq)
        p["ln2"] = _ln_init(freq)
        p["ln3"] = _ln_init(freq // 2)
        p["ln4"] = _ln_init(freq // 2)
    return p


def _vgg_stack_apply(p: Dict, x: torch.Tensor, second_pool: Tuple[int, int],
                     with_ln: bool, compute_dtype=torch.float32):
    """x: (B,Cin,T,F) -> pooled feature map (B,C2,T',F/4): T/4 after a
    (2,2) second pool, T/2 after a (1,2) one."""
    for name, ln in (("conv1", "ln1"), ("conv2", "ln2")):
        x = _conv(p[name], x, compute_dtype)
        if with_ln:
            x = _layernorm_freq(p[ln], x)
        x = torch.relu(x)
    x = _maxpool(x, (2, 2))
    for name, ln in (("conv3", "ln3"), ("conv4", "ln4")):
        x = _conv(p[name], x, compute_dtype)
        if with_ln:
            x = _layernorm_freq(p[ln], x)
        x = torch.relu(x)
    return _maxpool(x, second_pool)


def frontend_init(gen: torch.Generator, spec: FrontendSpec) -> Dict:
    if spec.vgg == 6:
        return {}
    if spec.vgg == 7:
        return {"dense": R.espnet_linear_init(gen, spec.freq_dim, 256)}
    if spec.vgg == 1:
        return _vgg_stack_init(gen, spec.in_channel, 128, 256, False,
                               spec.freq_dim)
    if spec.vgg in (3, 5):
        return _vgg_stack_init(gen, spec.in_channel, 64, 128, spec.vgg == 5,
                               spec.freq_dim)
    if spec.vgg in (2, 4):
        low_init, low_hide = spec.low_filt, spec.low_filt * 2
        high_init, high_hide = 64 - spec.low_filt, 128 - spec.low_filt * 2
        return {"low": _vgg_stack_init(gen, spec.in_channel, low_init,
                                       low_hide, False, spec.split_freq),
                "high": _vgg_stack_init(gen, spec.in_channel, high_init,
                                        high_hide, False,
                                        spec.freq_dim - spec.split_freq)}
    raise NotImplementedError("vgg = {} is not available".format(spec.vgg))


def _view_input(spec: FrontendSpec, feat: torch.Tensor, feat_len: torch.Tensor,
                crop: int):
    """(B,T,D) -> (B,C,T',F) with the delta channels split out of D
    (channel-major); T cropped to a multiple of the pooling factor."""
    b, t, _ = feat.shape
    t = (t // crop) * crop
    x = feat[:, :t, :].reshape(b, t, spec.in_channel, spec.freq_dim)
    return x.permute(0, 2, 1, 3), feat_len // crop


def _flatten(x: torch.Tensor) -> torch.Tensor:
    """(B,C',T',F') -> (B,T',C'*F'), channel-major like the torch flatten."""
    b, c2, t2, f2 = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t2, c2 * f2)


def frontend_apply(params: Dict, spec: FrontendSpec, feat: torch.Tensor,
                   feat_len: torch.Tensor, compute_dtype=torch.float32):
    """(B,T,D) + lengths -> (B,T/s,out_dim) f32 + new lengths."""
    if spec.vgg == 6:
        return feat[:, ::4, :], feat_len // 4
    if spec.vgg == 7:
        return R.linear(params["dense"], feat, compute_dtype), feat_len
    if spec.vgg in (2, 4):
        crop = 4 if spec.vgg == 2 else 2
        pool = (2, 2) if spec.vgg == 2 else (1, 2)
        x, feat_len = _view_input(spec, feat, feat_len, crop)
        lo = _vgg_stack_apply(params["low"], x[..., :spec.split_freq], pool,
                              False, compute_dtype)
        hi = _vgg_stack_apply(params["high"], x[..., spec.split_freq:], pool,
                              False, compute_dtype)
        return torch.cat([_flatten(lo), _flatten(hi)], dim=-1).float(), \
            feat_len
    if spec.vgg not in (1, 3, 5):
        raise NotImplementedError("vgg = {} is not available".format(
            spec.vgg))
    crop, pool = (2, (1, 2)) if spec.vgg == 3 else (4, (2, 2))
    x, feat_len = _view_input(spec, feat, feat_len, crop)
    x = _vgg_stack_apply(params, x, pool, spec.vgg == 5, compute_dtype)
    return _flatten(x).float(), feat_len
