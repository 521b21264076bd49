"""Direction-packed BLSTM forward recurrence (counterpart of the TPU kernel
``bilstm_recurrence`` in e2e_asr_pytorch_tpu/ops/pallas/lstm.py).

Given both directions' input pre-activations ``xg_f, xg_b`` (T,B,4H) in data
order and recurrent weights ``wh_f, wh_b`` (H,4H), advance the forward
direction at data index t and the backward direction at T-1-t from a zero
state. Per step ``gates = xg[t] + bf16(h_prev) @ bf16(w_h)`` accumulated in
f32, gate order i,f,g,o, carries c and h in f32. ``w_h`` is taken in bf16
even when the stream is f32, as on the TPU.

``bilstm_recurrence`` dispatches on the tensors' device: a CPU tensor goes to
the plain PyTorch version ``bilstm_recurrence_ref``, a CUDA tensor to the
hand-written kernel in ``csrc/bilstm_fwd.cu`` (or raises).
"""

from __future__ import annotations

import ctypes

import torch

from e2e_asr_pytorch_tpu_torch.ops.kernels import build

# launches of the CUDA kernel in this process (the only global state)
LAUNCHES = 0


def _cell(gates: torch.Tensor, c: torch.Tensor):
    hidden = c.shape[-1]
    i = torch.sigmoid(gates[..., :hidden])
    f = torch.sigmoid(gates[..., hidden:2 * hidden])
    g = torch.tanh(gates[..., 2 * hidden:3 * hidden])
    o = torch.sigmoid(gates[..., 3 * hidden:])
    c = f * c + i * g
    return o * torch.tanh(c), c


def _h_operand(h: torch.Tensor) -> torch.Tensor:
    """bf16(h), the recurrent matmul's left operand, held exactly in f32."""
    return h.to(torch.bfloat16).float()


def bilstm_recurrence_ref(xg_f, xg_b, wh_f, wh_b, stash: bool = False):
    """Plain PyTorch version with the kernel's numerics: the bf16 products are
    exact in f32 and accumulate in f32. Returns (ys_f, ys_b), plus the bf16
    stashes (cs_f, cs_b, gates_f, gates_b) when ``stash``."""
    t, b, h4 = xg_f.shape
    hidden = h4 // 4
    whf = wh_f.to(torch.bfloat16).float()
    whb = wh_b.to(torch.bfloat16).float()
    zeros = torch.zeros(b, hidden, dtype=torch.float32, device=xg_f.device)
    h_f, c_f, h_b, c_b = zeros, zeros, zeros, zeros
    ys_f = torch.empty(t, b, hidden, dtype=xg_f.dtype, device=xg_f.device)
    ys_b = torch.empty_like(ys_f)
    if stash:
        cs_f = torch.empty(t, b, hidden, dtype=torch.bfloat16,
                           device=xg_f.device)
        cs_b = torch.empty_like(cs_f)
        g_f = torch.empty(t, b, h4, dtype=torch.bfloat16, device=xg_f.device)
        g_b = torch.empty_like(g_f)
    for s in range(t):
        r = t - 1 - s
        gates_f = xg_f[s].float() + _h_operand(h_f) @ whf
        gates_b = xg_b[r].float() + _h_operand(h_b) @ whb
        h_f, c_f = _cell(gates_f, c_f)
        h_b, c_b = _cell(gates_b, c_b)
        ys_f[s] = h_f
        ys_b[r] = h_b
        if stash:
            cs_f[s], cs_b[r] = c_f, c_b
            g_f[s], g_b[r] = gates_f, gates_b
    if stash:
        return ys_f, ys_b, cs_f, cs_b, g_f, g_b
    return ys_f, ys_b


def _units_per_tile(hidden: int) -> int:
    return next(ut for ut in (8, 4, 2, 1) if hidden % ut == 0)


def _library():
    lib = build.load("bilstm_fwd")
    lib.bilstm_fwd.argtypes = ([ctypes.c_void_p] * 12
                               + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.bilstm_fwd.restype = ctypes.c_int
    return lib


def _check(xg_f, xg_b, wh_f, wh_b):
    if xg_f.dim() != 3 or xg_f.shape[-1] % 4:
        raise ValueError("xg must be (T,B,4H), got {}".format(
            tuple(xg_f.shape)))
    t, b, h4 = xg_f.shape
    hidden = h4 // 4
    if xg_b.shape != xg_f.shape or xg_b.dtype != xg_f.dtype:
        raise ValueError("xg_f and xg_b differ: {} {} vs {} {}".format(
            tuple(xg_f.shape), xg_f.dtype, tuple(xg_b.shape), xg_b.dtype))
    if xg_f.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("xg must be float32 or bfloat16, got {}".format(
            xg_f.dtype))
    for w in (wh_f, wh_b):
        if tuple(w.shape) != (hidden, h4):
            raise ValueError("w_h must be ({}, {}), got {}".format(
                hidden, h4, tuple(w.shape)))
    if t < 1 or b < 1:
        raise ValueError("empty sequence or batch: {}".format(
            tuple(xg_f.shape)))


def _launch(xg_f, xg_b, wh_f, wh_b, stash: bool):
    global LAUNCHES
    dev = xg_f.device
    for x in (xg_b, wh_f, wh_b):
        if x.device != dev:
            raise ValueError("all operands must be on {}, got {}".format(
                dev, x.device))
    if not (xg_f.is_contiguous() and xg_b.is_contiguous()):
        raise ValueError("xg_f and xg_b must be contiguous")
    t, b, h4 = xg_f.shape
    hidden = h4 // 4
    ut = _units_per_tile(hidden)
    lib = _library()
    # pack each w_h into per-tile slabs (H/ut, H, 4, ut): a tile's 4*ut gate
    # columns become contiguous rows, so the kernel reads them coalesced
    def pack(w):
        return (w.to(torch.bfloat16).reshape(hidden, 4, hidden // ut, ut)
                .permute(2, 0, 1, 3).contiguous())
    wp_f, wp_b = pack(wh_f), pack(wh_b)
    ys_f = torch.empty(t, b, hidden, dtype=xg_f.dtype, device=dev)
    ys_b = torch.empty_like(ys_f)
    if stash:
        cs_f = torch.empty(t, b, hidden, dtype=torch.bfloat16, device=dev)
        cs_b = torch.empty_like(cs_f)
        g_f = torch.empty(t, b, h4, dtype=torch.bfloat16, device=dev)
        g_b = torch.empty_like(g_f)
        stash_ptrs = [cs_f.data_ptr(), cs_b.data_ptr(), g_f.data_ptr(),
                      g_b.data_ptr()]
    else:
        stash_ptrs = [None] * 4
    hbuf = torch.zeros(2, 2, b, hidden, dtype=torch.bfloat16, device=dev)
    cbuf = torch.zeros(2, b, hidden, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bilstm_fwd(
            xg_f.data_ptr(), xg_b.data_ptr(), wp_f.data_ptr(),
            wp_b.data_ptr(), ys_f.data_ptr(), ys_b.data_ptr(), *stash_ptrs,
            hbuf.data_ptr(), cbuf.data_ptr(), t, b, hidden, ut,
            int(xg_f.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError("bilstm_fwd launch failed: cudaError {}".format(err))
    LAUNCHES += 1
    if stash:
        return ys_f, ys_b, cs_f, cs_b, g_f, g_b
    return ys_f, ys_b


def bilstm_recurrence(xg_f, xg_b, wh_f, wh_b, stash: bool = False):
    """Direction-packed BLSTM recurrence: both directions' (T,B,4H) gate
    inputs (data order) -> (ys_f, ys_b) (T,B,H) each in xg's dtype, plus the
    bf16 stashes (cs_f, cs_b, gates_f, gates_b) when ``stash``."""
    _check(xg_f, xg_b, wh_f, wh_b)
    if xg_f.device.type == "cpu":
        return bilstm_recurrence_ref(xg_f, xg_b, wh_f, wh_b, stash)
    if xg_f.device.type == "cuda":
        return _launch(xg_f, xg_b, wh_f, wh_b, stash)
    raise ValueError("bilstm_recurrence runs on cpu (plain version) or cuda "
                     "(kernel), got {}".format(xg_f.device))
