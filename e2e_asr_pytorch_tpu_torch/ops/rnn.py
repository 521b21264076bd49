"""Recurrent ops over explicit parameter dicts (port of
e2e_asr_pytorch_tpu/ops/rnn.py): LSTM, GRU and light GRU.

Parameters keep the JAX layouts: ``espnet_linear`` is {w (in,out), b (out,)},
an LSTM direction is {w_x (in,4H), w_h (H,4H), b (4H,)} in gate order
i,f,g,o, a GRU direction {w_x (in,3H), w_h (H,3H), b_x, b_h (3H,)} in gate
order r,z,n, a light-GRU direction {w_x (in,2H), w_h (H,2H), bn_scale,
bn_bias (2H,)} in gate order z,a. Matmuls take their operands in
``compute_dtype``; where the JAX package sums their products in f32
(``preferred_element_type=float32``) so does the port (``mm_f32``,
``matmul_f32``); the carries stay f32. Every layer hoists its input
projection out of the recurrence and hands the recurrence to a hand-written
kernel: the bidirectional LSTM to the direction-packed one
(``ops/kernels/bilstm.py``), a single LSTM direction to
``ops/kernels/lstm.py``, a GRU layer to ``ops/kernels/gru.py`` and a
light-GRU layer to ``ops/kernels/ligru.py``, both directions of a
bidirectional one in one call (each for the hidden sizes its ``fits`` rule
takes; above it a GRU or light-GRU layer is a plain loop under autograd). As in the JAX package there is no length masking: the
backward direction runs over the padding. The stacked unidirectional RNN
(decoder, LM) sends a stateless LSTM sequence to the kernels and keeps a
plain loop for a call that carries a state and for the GRU.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional

import torch

from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
from e2e_asr_pytorch_tpu_torch.ops.kernels import gru as KG
from e2e_asr_pytorch_tpu_torch.ops.kernels import ligru as KLG
from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as KL


def _normal(gen: torch.Generator, shape, stdv: float) -> torch.Tensor:
    return stdv * torch.randn(shape, generator=gen, dtype=torch.float32)


def espnet_linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                       bias: bool = True) -> Dict[str, torch.Tensor]:
    """W ~ N(0, 1/sqrt(fan_in)), b = 0 (on the CPU; callers move it)."""
    p = {"w": _normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim))}
    if bias:
        p["b"] = torch.zeros(out_dim)
    return p


def linear(params, x: torch.Tensor, compute_dtype=torch.float32,
           out_dtype=torch.float32) -> torch.Tensor:
    """x @ w + b with the operands in ``compute_dtype``, emitted in
    ``out_dtype``: an f32 result is the f32 sum of the products
    (``matmul_f32``), a compute-dtype one the product rounded once."""
    if out_dtype == torch.float32:
        y = matmul_f32(x, params["w"], compute_dtype)
    else:
        y = torch.matmul(x.to(compute_dtype),
                         params["w"].to(compute_dtype)).to(out_dtype)
    if "b" in params:
        y = y + params["b"].to(out_dtype)
    return y


def lstm_init(gen: torch.Generator, in_dim: int, hidden: int,
              forget_bias: bool = False) -> Dict[str, torch.Tensor]:
    """One direction of one LSTM layer. Gate order (i,f,g,o)."""
    b = torch.zeros(4 * hidden)
    if forget_bias:
        b[hidden:2 * hidden] = 1.0
    return {"w_x": _normal(gen, (in_dim, 4 * hidden), 1.0 / math.sqrt(in_dim)),
            "w_h": _normal(gen, (hidden, 4 * hidden), 1.0 / math.sqrt(hidden)),
            "b": b}


def lstm_cell(params, xg_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              compute_dtype=torch.float32):
    """One LSTM step given the precomputed input-gate term xg_t (B,4H)."""
    hidden = h.shape[-1]
    gates = xg_t + matmul_f32(h, params["w_h"], compute_dtype)
    i = torch.sigmoid(gates[..., :hidden])
    f = torch.sigmoid(gates[..., hidden:2 * hidden])
    g = torch.tanh(gates[..., 2 * hidden:3 * hidden])
    o = torch.sigmoid(gates[..., 3 * hidden:])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def lstm_layer_kernel(params, x: torch.Tensor, reverse: bool = False,
                      compute_dtype=torch.float32,
                      time_major: bool = False,
                      xg_f32: bool = False) -> torch.Tensor:
    """One LSTM direction through the hand-written recurrence (zero initial
    state; w_h resident or streamed in chunks by hidden size, see
    ``ops/kernels/lstm.py``). x is (B,T,D), or (T,B,D) with ``time_major``.

    xg is one matmul in compute_dtype, emitted in compute_dtype with the bias
    added in compute_dtype; with ``xg_f32`` it is emitted in f32 with the
    f32 bias instead (``matmul_f32``: the JAX scan form's
    ``preferred_element_type=float32`` product, which the APC stack
    computes). The kernel's hidden stream comes back in xg's dtype while the
    recurrence carries stay f32. The chunked kernels scan forward only, so
    ``reverse`` flips the stream around them; the resident ones index
    backwards inside the kernel."""
    if not time_major:
        x = x.transpose(0, 1)
    if xg_f32:
        xg = (matmul_f32(x, params["w_x"], compute_dtype)
              + params["b"].float()).contiguous()
    else:
        xg = (torch.matmul(x.to(compute_dtype),
                           params["w_x"].to(compute_dtype))
              + params["b"].to(compute_dtype)).contiguous()
    w_h = params["w_h"]
    if KL.fits_resident(w_h.shape[0], xg.device):
        ys = KL.lstm_recurrence(xg, w_h, reverse=reverse)
    else:
        if reverse:
            xg = torch.flip(xg, dims=(0,))
        ys = KL.lstm_recurrence_chunked(xg, w_h)
        if reverse:
            ys = torch.flip(ys, dims=(0,))
    return ys if time_major else ys.transpose(0, 1)


def lstm_layer(params, x: torch.Tensor, state=None, reverse: bool = False,
               compute_dtype=torch.float32):
    """One LSTM direction over (B,T,D) as a loop over ``lstm_cell`` from
    ``state`` (zeros when None). Returns (y (B,T,H) f32, (h, c))."""
    b, t, _ = x.shape
    hidden = params["w_h"].shape[0]
    if state is None:
        h = c = torch.zeros(b, hidden, dtype=torch.float32, device=x.device)
    else:
        h, c = state
    # the big matmul hoisted out of the loop: (B,T,D) @ (D,4H)
    xg = matmul_f32(x, params["w_x"], compute_dtype) + params["b"]
    ys = [None] * t
    for s in (range(t - 1, -1, -1) if reverse else range(t)):
        h, c = lstm_cell(params, xg[:, s], h, c, compute_dtype)
        ys[s] = h
    return torch.stack(ys, dim=1), (h, c)


def bilstm_layer(params_fw, params_bw, x: torch.Tensor,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """Bidirectional LSTM over a time-major x (T,B,D), the encoder stack's
    layout; output (T,B,2H) is [fw ; bw] on the feature axis.

    The two (T,B,4H) gate streams are computed as one matmul each and emitted
    in compute_dtype; the recurrence runs in the direction-packed kernel on a
    CUDA tensor and in its plain version on a CPU tensor. When a gradient is
    wanted the recurrence goes through ``BiLSTMRecurrence`` (K1 with its
    stashes, K2 backward), so dW_x, db and dx come from autograd through the
    two input matmuls."""
    x = x.to(compute_dtype)
    xg_f = (torch.matmul(x, params_fw["w_x"].to(compute_dtype))
            + params_fw["b"].to(compute_dtype)).contiguous()
    xg_b = (torch.matmul(x, params_bw["w_x"].to(compute_dtype))
            + params_bw["b"].to(compute_dtype)).contiguous()
    args = (xg_f, xg_b, params_fw["w_h"], params_bw["w_h"])
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        ys_f, ys_b = K.BiLSTMRecurrence.apply(*args)
    else:
        ys_f, ys_b = K.bilstm_recurrence(*args)
    return torch.cat([ys_f, ys_b], dim=-1)


# ---------------------------------------------------------------------------
# GRU (two bias vectors, gate order r,z,n) and light GRU
# ---------------------------------------------------------------------------

def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two tensors of one dtype, f32 sums and an f32 result, outside
    autograd (the JAX package's ``preferred_element_type=float32``): a
    (...,K) @ b (K,N), or a batched (B,M,K) @ (B,K,N). On the card
    ``torch.mm`` / ``torch.bmm`` with ``out_dtype``; on the CPU, which has no
    such op, the f32 product of the operands widened exactly."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if not a.is_cuda:
        return torch.matmul(a.float(), b.float())
    if b.dim() == 2:
        return torch.mm(a.reshape(-1, a.shape[-1]), b,
                        out_dtype=torch.float32).reshape(
                            *a.shape[:-1], b.shape[1])
    return torch.bmm(a, b, out_dtype=torch.float32)


class _MatmulF32Out(torch.autograd.Function):
    """``mm_f32`` on the card under autograd. Both gradients are products of
    the cotangent rounded to the operands' dtype: exact where the cotangent
    is a compute-dtype one widened by a cast (the GRU), the forward
    product's own operand precision elsewhere."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        if b.dim() == 2:
            return (torch.matmul(g, b.t()),
                    torch.mm(a.reshape(-1, a.shape[-1]).t(),
                             g.reshape(-1, g.shape[-1])))
        return (torch.bmm(g, b.transpose(1, 2)),
                torch.bmm(a.transpose(1, 2), g))


def matmul_f32(x: torch.Tensor, w: torch.Tensor, compute_dtype):
    """x @ w with the operands in ``compute_dtype``, f32 sums and an f32
    result (the JAX package's ``preferred_element_type=float32``): x
    (...,K) @ w (K,N), or a batched (B,M,K) @ (B,K,N). Differentiable;
    without a gradient to take it is ``mm_f32`` itself."""
    a, b = x.to(compute_dtype), w.to(compute_dtype)
    if (a.is_cuda and compute_dtype != torch.float32
            and torch.is_grad_enabled()
            and (a.requires_grad or b.requires_grad)):
        return _MatmulF32Out.apply(a, b)
    return mm_f32(a, b)


def gru_init(gen: torch.Generator, in_dim: int,
             hidden: int) -> Dict[str, torch.Tensor]:
    """One direction of one GRU layer. Gate order (r,z,n)."""
    return {"w_x": _normal(gen, (in_dim, 3 * hidden), 1.0 / math.sqrt(in_dim)),
            "w_h": _normal(gen, (hidden, 3 * hidden), 1.0 / math.sqrt(hidden)),
            "b_x": torch.zeros(3 * hidden),
            "b_h": torch.zeros(3 * hidden)}


def gru_cell(params, xg_t: torch.Tensor, h: torch.Tensor,
             compute_dtype=torch.float32) -> torch.Tensor:
    """One GRU step given the precomputed input term xg_t (B,3H), f32."""
    hidden = h.shape[-1]
    hg = matmul_f32(h, params["w_h"], compute_dtype) + params["b_h"]
    r = torch.sigmoid(xg_t[..., :hidden] + hg[..., :hidden])
    z = torch.sigmoid(xg_t[..., hidden:2 * hidden]
                      + hg[..., hidden:2 * hidden])
    n = torch.tanh(xg_t[..., 2 * hidden:] + r * hg[..., 2 * hidden:])
    return (1.0 - z) * n + z * h


def gru_layer(params, x: torch.Tensor, state=None, reverse: bool = False,
              compute_dtype=torch.float32):
    """One GRU direction over (B,T,D) as a loop over ``gru_cell`` from
    ``state`` (zeros when None). Returns (y (B,T,H) f32, h)."""
    b, t, _ = x.shape
    hidden = params["w_h"].shape[0]
    h = (torch.zeros(b, hidden, dtype=torch.float32, device=x.device)
         if state is None else state)
    xg = matmul_f32(x, params["w_x"], compute_dtype) + params["b_x"]
    ys = [None] * t
    for s in (range(t - 1, -1, -1) if reverse else range(t)):
        h = gru_cell(params, xg[:, s], h, compute_dtype)
        ys[s] = h
    return torch.stack(ys, dim=1), h


def gru_layer_kernel(params, x: torch.Tensor, reverse: bool = False,
                     compute_dtype=torch.float32,
                     time_major: bool = False) -> torch.Tensor:
    """One GRU direction through the hand-written recurrence (zero initial
    state, ``ops/kernels/gru.py``). x is (B,T,D), or (T,B,D) with
    ``time_major``. xg is summed in f32, b_x added in f32 and the stream
    rounded once to compute_dtype; the hidden stream comes back in the same
    dtype. ``reverse`` is walked inside the kernel, no flips."""
    if not time_major:
        x = x.transpose(0, 1)
    ys = KG.gru_recurrence(_gru_xg(params, x, compute_dtype), params["w_h"],
                           params["b_h"], reverse=reverse)
    return ys if time_major else ys.transpose(0, 1)


def _gru_xg(params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """A GRU direction's (T,B,3H) gate inputs from a time-major x: summed in
    f32, b_x added in f32, the stream rounded once to compute_dtype."""
    return (matmul_f32(x, params["w_x"], compute_dtype)
            + params["b_x"]).to(compute_dtype).contiguous()


def _warn_plain_loop(what: str, hidden: int, x: torch.Tensor):
    """A layer on the card whose H is above its kernel's limit loses the
    kernel: say so (Python shows a warning once per call site)."""
    if x.is_cuda:
        warnings.warn(
            "{} layer of H={} is above the hidden size its kernel takes on "
            "{} (ops/kernels: fits): it runs as a plain loop of one small "
            "matmul per time step".format(
                what, hidden, torch.cuda.get_device_name(x.device)),
            RuntimeWarning, stacklevel=3)


def gru_direction(params, x, reverse, compute_dtype, time_major):
    """A stateless GRU direction: the kernel where w_h fits the card, the
    loop (all in compute_dtype, f32 out) above it, with a warning when that
    happens on the card."""
    if KG.fits(params["w_h"].shape[0], x.device):
        return gru_layer_kernel(params, x, reverse, compute_dtype, time_major)
    _warn_plain_loop("GRU", params["w_h"].shape[0], x)
    if time_major:
        x = x.transpose(0, 1)
    y, _ = gru_layer(params, x, reverse=reverse, compute_dtype=compute_dtype)
    return y.transpose(0, 1) if time_major else y


def bigru_layer(params_fw, params_bw, x: torch.Tensor,
                compute_dtype=torch.float32,
                time_major: bool = False) -> torch.Tensor:
    """Bidirectional GRU; output [fw ; bw] on the feature axis. Where w_h
    fits the card both directions' recurrences are one call
    (``ops/kernels/gru.py bigru_recurrence``: one launch of the packed form
    where its rule takes the width), above it each direction is the plain
    loop."""
    if not KG.fits(params_fw["w_h"].shape[0], x.device):
        return torch.cat(
            [gru_direction(params_fw, x, False, compute_dtype, time_major),
             gru_direction(params_bw, x, True, compute_dtype, time_major)],
            dim=-1)
    xt = x if time_major else x.transpose(0, 1)
    ys_f, ys_b = KG.bigru_recurrence(
        _gru_xg(params_fw, xt, compute_dtype),
        _gru_xg(params_bw, xt, compute_dtype), params_fw["w_h"],
        params_bw["w_h"], params_fw["b_h"], params_bw["b_h"])
    y = torch.cat([ys_f, ys_b], dim=-1)
    return y if time_major else y.transpose(0, 1)


def ligru_init(gen: torch.Generator, in_dim: int,
               hidden: int) -> Dict[str, torch.Tensor]:
    """One direction of one light-GRU layer. Gate order (z, candidate)."""
    return {"w_x": _normal(gen, (in_dim, 2 * hidden), 1.0 / math.sqrt(in_dim)),
            "w_h": _normal(gen, (hidden, 2 * hidden), 1.0 / math.sqrt(hidden)),
            "bn_scale": torch.ones(2 * hidden),
            "bn_bias": torch.zeros(2 * hidden)}


def ligru_mask(batch: int, hidden: int, dropout: float,
               gen: Optional[torch.Generator], train: bool,
               device) -> torch.Tensor:
    """The (B,H) recurrent dropout mask shared by every time step, scaled by
    1/keep; ones outside training."""
    if train and dropout > 0.0 and gen is not None:
        keep = 1.0 - dropout
        return (torch.rand((batch, hidden), generator=gen, device=device)
                < keep).float() / keep
    return torch.ones(batch, hidden, dtype=torch.float32, device=device)


def ligru_layer(params, x: torch.Tensor, reverse: bool = False,
                dropout: float = 0.0,
                gen: Optional[torch.Generator] = None, train: bool = False,
                compute_dtype=torch.float32, bn_eps: float = 1e-5,
                time_major: bool = False,
                mask: Optional[torch.Tensor] = None):
    """Light GRU over (B,T,D), or (T,B,D) with ``time_major``. The
    feed-forward term is batch-normalised over batch and time (padding
    included) with this batch's own mean and population variance in f32, in
    training and at decode alike: there are no running statistics. Then the
    recurrence with one (B,H) dropout mask for all steps (``mask``, or drawn
    from ``gen`` when training): the kernel where w_h fits the card
    (``ops/kernels/ligru.py``), a plain loop above it (with a warning on the
    card). Returns (y, h_last)."""
    if not time_major:
        x = x.transpose(0, 1)
    t, b, _ = x.shape
    hidden = params["w_h"].shape[0]
    xg = _ligru_xg(params, x, compute_dtype, bn_eps)
    if mask is None:
        mask = ligru_mask(b, hidden, dropout, gen, train, x.device)
    if KLG.fits(hidden, x.device):
        ys = KLG.ligru_recurrence(xg.contiguous(), params["w_h"], mask,
                                  reverse=reverse)
        h = ys[0] if reverse else ys[-1]
    else:
        _warn_plain_loop("light-GRU", hidden, x)
        h = torch.zeros(b, hidden, dtype=torch.float32, device=x.device)
        steps = [None] * t
        for s in (range(t - 1, -1, -1) if reverse else range(t)):
            hg = matmul_f32(h, params["w_h"], compute_dtype)
            z = torch.sigmoid(xg[s, :, :hidden] + hg[:, :hidden])
            cand = torch.relu(xg[s, :, hidden:] + hg[:, hidden:]) * mask
            h = z * h + (1.0 - z) * cand
            steps[s] = h
        ys = torch.stack(steps, dim=0)
    return (ys if time_major else ys.transpose(0, 1)), h


def _ligru_xg(params, x: torch.Tensor, compute_dtype,
              bn_eps: float = 1e-5) -> torch.Tensor:
    """A light-GRU direction's (T,B,2H) gate inputs from a time-major x:
    the feed-forward term batch-normalised over batch and time with this
    batch's mean and population variance in f32, then scaled, shifted and
    rounded to compute_dtype."""
    xg = matmul_f32(x, params["w_x"], compute_dtype)
    mean = xg.mean(dim=(0, 1), keepdim=True)
    var = xg.var(dim=(0, 1), keepdim=True, correction=0)
    xg = (xg - mean) * torch.rsqrt(var + bn_eps)
    return (xg * params["bn_scale"] + params["bn_bias"]).to(compute_dtype)


def biligru_layer(params_fw, params_bw, x: torch.Tensor,
                  dropout: float = 0.0,
                  gen: Optional[torch.Generator] = None, train: bool = False,
                  compute_dtype=torch.float32, time_major: bool = False,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bidirectional light GRU; output [fw ; bw] on the feature axis. Both
    directions share one dropout mask, as the JAX package's share one key.
    Where w_h fits the card both directions' recurrences are one call
    (``ops/kernels/ligru.py biligru_recurrence``: one launch of the packed
    form where its rule takes the width), the batch norm per direction;
    above it each direction is the plain loop."""
    hidden = params_fw["w_h"].shape[0]
    if mask is None:
        mask = ligru_mask(x.shape[1] if time_major else x.shape[0], hidden,
                          dropout, gen, train, x.device)
    if not KLG.fits(hidden, x.device):
        kw = dict(compute_dtype=compute_dtype, time_major=time_major,
                  mask=mask)
        y_fw, _ = ligru_layer(params_fw, x, **kw)
        y_bw, _ = ligru_layer(params_bw, x, reverse=True, **kw)
        return torch.cat([y_fw, y_bw], dim=-1)
    xt = x if time_major else x.transpose(0, 1)
    ys_f, ys_b = KLG.biligru_recurrence(
        _ligru_xg(params_fw, xt, compute_dtype).contiguous(),
        _ligru_xg(params_bw, xt, compute_dtype).contiguous(),
        params_fw["w_h"], params_bw["w_h"], mask)
    y = torch.cat([ys_f, ys_b], dim=-1)
    return y if time_major else y.transpose(0, 1)


# ---------------------------------------------------------------------------
# Stacked unidirectional RNN (decoder / LM): full sequence and single step
# ---------------------------------------------------------------------------

def _check_stack_module(module: str):
    if module not in ("LSTM", "GRU"):
        raise ValueError("a stacked RNN is LSTM or GRU, got " + module)


def stacked_init(gen: torch.Generator, module: str, in_dim: int, hidden: int,
                 n_layers: int, forget_bias: bool = False) -> List[Dict]:
    _check_stack_module(module)
    layers, d = [], in_dim
    for _ in range(n_layers):
        layers.append(lstm_init(gen, d, hidden, forget_bias)
                      if module == "LSTM" else gru_init(gen, d, hidden))
        d = hidden
    return layers


def stacked_zero_state(module: str, n_layers: int, batch: int, hidden: int,
                       device=None):
    """(h, c), each (L,B,H), for an LSTM stack; h alone for a GRU one."""
    _check_stack_module(module)
    z = torch.zeros(n_layers, batch, hidden, device=device)
    return (z, z) if module == "LSTM" else z


def stacked_step(layers, module: str, x: torch.Tensor, state,
                 dropout: float = 0.0, gen=None, train: bool = False,
                 compute_dtype=torch.float32):
    """One time step through a stacked RNN. x: (B,D); state is (h, c), each
    (L,B,H), for the LSTM and h for the GRU. In training with a generator
    (or ``GivenDraws``) every layer's output but the last is dropped out
    with its own mask, as torch's inter-layer dropout. Returns (top output
    (B,H), new state)."""
    _check_stack_module(module)
    n_layers = len(layers)
    outs = x
    new_h, new_c = [], []
    for l, p in enumerate(layers):
        if module == "GRU":
            xg = matmul_f32(outs, p["w_x"], compute_dtype) + p["b_x"]
            h = gru_cell(p, xg, state[l], compute_dtype)
        else:
            xg = matmul_f32(outs, p["w_x"], compute_dtype) + p["b"]
            h, c = lstm_cell(p, xg, state[0][l], state[1][l], compute_dtype)
            new_c.append(c)
        new_h.append(h)
        outs = h
        if train and dropout > 0 and l < n_layers - 1 and gen is not None:
            outs = dropout_fn(outs, dropout, gen)
    if module == "GRU":
        return outs, torch.stack(new_h)
    return outs, (torch.stack(new_h), torch.stack(new_c))


class GivenDraws:
    """Random draws handed in instead of drawn: a queue of (kind, array)
    taken in the order the caller draws (``keep_mask``, ``uniform``,
    ``gumbel``). Pass it where a ``torch.Generator`` goes; the tests feed
    the JAX package's own draws through it."""

    def __init__(self, draws):
        self.draws = list(draws)

    def take(self, kind: str, shape, device) -> torch.Tensor:
        if not self.draws:
            raise IndexError("no {} draw left".format(kind))
        got, value = self.draws.pop(0)
        value = torch.tensor(value, device=device)
        if got != kind or tuple(value.shape) != tuple(shape):
            raise ValueError("drew {} {} where {} {} was given".format(
                kind, tuple(shape), got, tuple(value.shape)))
        return value


def keep_mask(shape, keep: float, gen, device) -> torch.Tensor:
    """A Bernoulli(keep) boolean mask, drawn from ``gen`` or given."""
    if isinstance(gen, GivenDraws):
        return gen.take("mask", shape, device).bool()
    return torch.rand(shape, generator=gen, device=device) < keep


def uniform(gen, device) -> torch.Tensor:
    """One U[0,1) number as a 0-dim tensor, drawn from ``gen`` or given."""
    if isinstance(gen, GivenDraws):
        return gen.take("uniform", (), device).float()
    return torch.rand((), generator=gen, device=device)


def gumbel(shape, gen, device) -> torch.Tensor:
    """Standard Gumbel noise in f32 as ``jax.random.gumbel`` forms it,
    -log(-log(U)) with U on [tiny, 1), drawn from ``gen`` or given."""
    if isinstance(gen, GivenDraws):
        return gen.take("gumbel", shape, device).float()
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def dropout(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``gen`` (on x's device) or
    given (``GivenDraws``); the stream keeps its dtype."""
    keep = 1.0 - rate
    return x * keep_mask(x.shape, keep, gen, x.device) / keep


dropout_fn = dropout  # ``stacked_sequence`` has a ``dropout`` rate argument


def stacked_sequence(layers, module: str, x: torch.Tensor, state=None,
                     dropout: float = 0.0,
                     gen: Optional[torch.Generator] = None,
                     train: bool = False, compute_dtype=torch.float32):
    """Full-sequence stacked unidirectional RNN (used by the LM): (B,T,D).

    A stateless LSTM call (state=None, the LM's training and validation)
    takes the kernel route layer by layer and returns None as the final
    state; callers must not depend on it. A stateful LSTM call keeps the
    loop and returns the real (h, c), each (L,B,H). A GRU stack is a loop
    either way (from zeros when stateless), as in the JAX package, and
    returns the real h (L,B,H). Dropout between layers (all but the last
    one's output) when ``train`` and a generator is given."""
    _check_stack_module(module)
    n_layers = len(layers)

    def between(outs, l):
        if train and dropout > 0 and l < n_layers - 1 and gen is not None:
            return dropout_fn(outs, dropout, gen)
        return outs

    outs = x
    if module == "GRU":
        final_h = []
        for l, p in enumerate(layers):
            outs, h = gru_layer(p, outs, None if state is None else state[l],
                                compute_dtype=compute_dtype)
            final_h.append(h)
            outs = between(outs, l)
        return outs, torch.stack(final_h)
    if state is None:
        for l, p in enumerate(layers):
            outs = between(lstm_layer_kernel(p, outs,
                                             compute_dtype=compute_dtype), l)
        return outs, None
    final_h, final_c = [], []
    for l, p in enumerate(layers):
        outs, (h, c) = lstm_layer(p, outs, (state[0][l], state[1][l]),
                                  compute_dtype=compute_dtype)
        final_h.append(h)
        final_c.append(c)
        outs = between(outs, l)
    return outs, (torch.stack(final_h), torch.stack(final_c))
