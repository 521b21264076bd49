"""LSTM ops over explicit parameter dicts (port of e2e_asr_pytorch_tpu/ops/rnn.py).

Parameters keep the JAX layouts: ``espnet_linear`` is {w (in,out), b (out,)},
an LSTM direction is {w_x (in,4H), w_h (H,4H), b (4H,)} in gate order
i,f,g,o. Matmuls take their operands in ``compute_dtype``; the LSTM carries
stay f32. The bidirectional layer hoists both input projections out of the
recurrence and hands the recurrence to the direction-packed kernel
(``ops/kernels/bilstm.py``). As in the JAX package there is no length masking:
the backward direction runs over the padding. A single direction over a whole
sequence (the LM's stack) goes to the single-direction kernels
(``ops/kernels/lstm.py``) when the call is stateless, and to a plain loop
over ``lstm_cell`` when it carries a state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
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
    ``out_dtype``."""
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
    gates = xg_t + torch.matmul(h.to(compute_dtype),
                                params["w_h"].to(compute_dtype)).float()
    i = torch.sigmoid(gates[..., :hidden])
    f = torch.sigmoid(gates[..., hidden:2 * hidden])
    g = torch.tanh(gates[..., 2 * hidden:3 * hidden])
    o = torch.sigmoid(gates[..., 3 * hidden:])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def lstm_layer_kernel(params, x: torch.Tensor, reverse: bool = False,
                      compute_dtype=torch.float32,
                      time_major: bool = False) -> torch.Tensor:
    """One LSTM direction through the hand-written recurrence (zero initial
    state; w_h resident or streamed in chunks by hidden size, see
    ``ops/kernels/lstm.py``). x is (B,T,D), or (T,B,D) with ``time_major``.

    xg is one matmul in compute_dtype, emitted in compute_dtype with the bias
    added in compute_dtype; the kernel's hidden stream comes back in the same
    dtype while the recurrence carries stay f32. The chunked kernels scan
    forward only, so ``reverse`` flips the stream around them; the resident
    ones index backwards inside the kernel."""
    if not time_major:
        x = x.transpose(0, 1)
    xg = (torch.matmul(x.to(compute_dtype), params["w_x"].to(compute_dtype))
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
    xg = torch.matmul(x.to(compute_dtype),
                      params["w_x"].to(compute_dtype)).float() + params["b"]
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
# Stacked unidirectional LSTM (decoder / LM): full sequence and single step
# ---------------------------------------------------------------------------

def stacked_init(gen: torch.Generator, module: str, in_dim: int, hidden: int,
                 n_layers: int, forget_bias: bool = False) -> List[Dict]:
    if module != "LSTM":
        raise NotImplementedError(
            "{} stacks are not ported yet (ROADMAP: GRU/liGRU, K7/K8)".format(
                module))
    layers, d = [], in_dim
    for _ in range(n_layers):
        layers.append(lstm_init(gen, d, hidden, forget_bias))
        d = hidden
    return layers


def stacked_zero_state(module: str, n_layers: int, batch: int, hidden: int,
                       device=None):
    if module != "LSTM":
        raise NotImplementedError(
            "{} stacks are not ported yet (ROADMAP: GRU/liGRU, K7/K8)".format(
                module))
    z = torch.zeros(n_layers, batch, hidden, device=device)
    return (z, z)


def stacked_step(layers, module: str, x: torch.Tensor, state,
                 compute_dtype=torch.float32):
    """One time step through a stacked LSTM (eval mode). x: (B,D); state is
    (h, c), each (L,B,H). Returns (top output (B,H), new state)."""
    if module != "LSTM":
        raise NotImplementedError(
            "{} stacks are not ported yet (ROADMAP: GRU/liGRU, K7/K8)".format(
                module))
    hs, cs = state
    new_h, new_c = [], []
    outs = x
    for l, p in enumerate(layers):
        xg = torch.matmul(outs.to(compute_dtype),
                          p["w_x"].to(compute_dtype)).float() + p["b"]
        h, c = lstm_cell(p, xg, hs[l], cs[l], compute_dtype)
        new_h.append(h)
        new_c.append(c)
        outs = h
    return outs, (torch.stack(new_h), torch.stack(new_c))


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``gen`` (on x's device); the
    stream keeps its dtype."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return x * mask / keep


dropout_fn = dropout  # ``stacked_sequence`` has a ``dropout`` rate argument


def stacked_sequence(layers, module: str, x: torch.Tensor, state=None,
                     dropout: float = 0.0,
                     gen: Optional[torch.Generator] = None,
                     train: bool = False, compute_dtype=torch.float32):
    """Full-sequence stacked unidirectional LSTM (used by the LM): (B,T,D).

    Stateless calls (state=None, the LM's training and validation) take the
    kernel route layer by layer and return None as the final state; callers
    must not depend on it. Stateful calls keep the loop and return the real
    (h, c), each (L,B,H). Dropout between layers (all but the last one's
    output) when ``train`` and a generator is given."""
    if module != "LSTM":
        raise NotImplementedError(
            "{} stacks are not ported yet (ROADMAP: GRU/liGRU, K7/K8)".format(
                module))
    n_layers = len(layers)

    def between(outs, l):
        if train and dropout > 0 and l < n_layers - 1 and gen is not None:
            return dropout_fn(outs, dropout, gen)
        return outs

    outs = x
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
