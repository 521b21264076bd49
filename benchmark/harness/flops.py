"""Operations and bytes from shapes, and the card's peaks.

``bound`` and ``lstm_bound`` are the roofline arithmetic the port's chip
checks use: the least time the card could take is the larger of the
operations over the bf16 tensor-core peak and the bytes over the memory
bandwidth, each input read once and each output written once. The model
FLOPs count what the step's mathematics needs at the shapes it runs, a
multiply-add as two operations, with no recomputation: forward once and
backward twice the forward (the gradients of the inputs and of the
weights).
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16 = 989e12      # FLOP/s, bf16 / fp16 tensor cores
PEAK_BYTES = 3.35e12    # bytes/s, HBM3


def bound(flops: float, nbytes: float) -> Tuple[float, str]:
    """(the least ms the card could take, which of the two binds)."""
    by_ops, by_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def lstm_bound(t: int, b: int, h: int, dirs: int, wide_bytes: int = 4,
               narrow_bytes: int = 4) -> Tuple[float, str]:
    """One launch of a recurrence kernel over ``dirs`` directions, forward
    or backward: 2*T*B*H*4H operations a direction (the recurrent product;
    the input product and dW_h are matmuls outside the kernel); bytes = the
    (T,B,4H) streams (``wide_bytes`` an element over them all), the (T,B,H)
    streams (``narrow_bytes``) and the bf16 w_h. The forward reads xg and
    writes the gate stash, ys and cs; the backward reads the gate stash, cs
    and dy and writes dxg: bf16 streams, 2 bytes in and 2 out an element,
    the defaults."""
    flops = dirs * 2.0 * t * b * h * 4 * h
    nbytes = dirs * (t * b * (4 * h * wide_bytes + h * narrow_bytes)
                     + h * 4 * h * 2)
    return bound(flops, nbytes)


def lstm_layer_flops(t: int, b: int, d_in: int, h: int) -> float:
    """Forward operations of one LSTM direction over (T,B): the input and
    the recurrent products, 2*T*B*(in+H)*4H."""
    return 2.0 * t * b * (d_in + h) * 4 * h


def linear_flops(n: int, d_in: int, d_out: int) -> float:
    return 2.0 * n * d_in * d_out


def lm_step_flops(model: Dict, vocab: int, t: int, b: int) -> float:
    """Model FLOPs of one LM training step over a (B,T) batch: the stacked
    LSTM and the output projection, forward and backward (3x forward)."""
    fwd, d = 0.0, model["emb_dim"]
    for _ in range(model["n_layers"]):
        fwd += lstm_layer_flops(t, b, d, model["dim"])
        d = model["dim"]
    fwd += linear_flops(t * b, d, vocab)
    return 3.0 * fwd


def conv3x3_flops(b: int, t: int, f: int, c_in: int, c_out: int) -> float:
    return 2.0 * b * t * f * c_in * c_out * 9


def asr_step_flops(model: Dict, vocab: int, feat_dim: int, b: int,
                   frames: int, dec_steps: int) -> float:
    """Model FLOPs of one joint CTC-attention training step over a batch of
    ``b`` utterances padded to ``frames`` feature frames and ``dec_steps``
    decoder positions: the VGG frontend (vgg 5, two 2x2 pools), the BLSTM
    layers and their projections, the CTC head, the attention's keys, per
    decoder position its query, location conv and projection, energies,
    context and the decoder LSTMs, and the output projection; forward and
    backward (3x forward). The feature extraction and SpecAugment, which
    have no parameters, are not counted."""
    enc, att, dec = model["encoder"], model["attention"], model["decoder"]
    ch, freq = feat_dim // 40, 40
    t = frames // 4 * 4
    fwd = (conv3x3_flops(b, t, freq, ch, 64) + conv3x3_flops(b, t, freq, 64, 64)
           + conv3x3_flops(b, t // 2, freq // 2, 64, 128)
           + conv3x3_flops(b, t // 2, freq // 2, 128, 128))
    te, d = t // 4, (freq // 4) * 128
    for h in enc["dim"]:
        fwd += 2 * lstm_layer_flops(te, b, d, h) + linear_flops(
            te * b, 2 * h, 2 * h)
        d = 2 * h
    fwd += linear_flops(te * b, d, vocab) + linear_flops(te * b, d,
                                                          att["dim"])
    hd, n_dec = dec["dim"], dec["layer"]
    kw, kn = 2 * att["loc_kernel_size"] + 1, att["loc_kernel_num"]
    per_step = (linear_flops(b, hd * n_dec, att["dim"])
                + 2.0 * b * te * kw * kn
                + linear_flops(b * te, kn, att["dim"])
                + linear_flops(b * te, att["dim"], 1)
                + 2.0 * b * te * d
                + lstm_layer_flops(1, b, d + hd, hd)
                + (n_dec - 1) * lstm_layer_flops(1, b, hd, hd)
                + linear_flops(b, hd, vocab))
    fwd += dec_steps * per_step
    return 3.0 * fwd
