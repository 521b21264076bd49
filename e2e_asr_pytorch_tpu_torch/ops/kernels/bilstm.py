"""Direction-packed BLSTM recurrence, forward and backward (counterpart of
the TPU kernels behind ``bilstm_recurrence`` in
e2e_asr_pytorch_tpu/ops/pallas/lstm.py).

Forward (K1): given both directions' input pre-activations ``xg_f, xg_b``
(T,B,4H) in data order and recurrent weights ``wh_f, wh_b`` (H,4H), advance
the forward direction at data index t and the backward direction at T-1-t
from a zero state. Per step ``gates = xg[t] + bf16(h_prev) @ bf16(w_h)``
accumulated in f32, gate order i,f,g,o, carries c and h in f32. ``w_h`` is
taken in bf16 even when the stream is f32, as on the TPU.

Backward (K2): from the forward's bf16 stashes (cell states and gate
pre-activations) and the output cotangents, walk each direction's scan in
reverse and emit the bf16 gate cotangents dxg; per step
``dh = dy[t] + bf16(dgates_prev) @ bf16(w_h)^T`` in f32, carries f32.

``bilstm_recurrence`` and ``bilstm_recurrence_bwd`` dispatch on the tensors'
device: a CPU tensor goes to the plain PyTorch version (``*_ref``), a CUDA
tensor to the hand-written kernel in ``csrc/bilstm_fwd.cu`` /
``csrc/bilstm_bwd.cu`` (or raises). ``BiLSTMRecurrence`` is the autograd
Function over both, the same on either device.
"""

from __future__ import annotations

import ctypes

import torch

from e2e_asr_pytorch_tpu_torch.ops.kernels import build

# launches of the CUDA kernels in this process (the only global state):
# LAUNCHES counts K1 (forward), BWD_LAUNCHES counts K2 (backward)
LAUNCHES = 0
BWD_LAUNCHES = 0


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


def _dg_operand(dgates: torch.Tensor) -> torch.Tensor:
    """bf16(dgates), the backward recurrent matmul's left operand, held
    exactly in f32."""
    return dgates.to(torch.bfloat16).float()


def _shift_prev(x: torch.Tensor, forward: bool) -> torch.Tensor:
    """What each direction's forward scan saw before data index t: x[t-1]
    for the forward direction, x[t+1] for the backward one, zeros at the
    scan's start."""
    zero = torch.zeros_like(x[:1])
    if forward:
        return torch.cat([zero, x[:-1]], dim=0)
    return torch.cat([x[1:], zero], dim=0)


def bilstm_recurrence_bwd_ref(wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f, dy_b):
    """Plain PyTorch version of K2 with the kernel's numerics. Stashes are
    bf16 (T,B,H) cs and (T,B,4H) gates; dy (T,B,H) in the stream dtype.
    Returns (dxg_f, dxg_b), bf16 (T,B,4H)."""
    t, b, h4 = g_f.shape
    hidden = h4 // 4
    dev = g_f.device
    out = []
    for wh, cs, gs, dy, fwd in ((wh_f, cs_f, g_f, dy_f, True),
                                (wh_b, cs_b, g_b, dy_b, False)):
        wht = wh.to(torch.bfloat16).float().t()
        cps = _shift_prev(cs, fwd)
        dxg = torch.empty(t, b, h4, dtype=torch.bfloat16, device=dev)
        dh_rec = torch.zeros(b, hidden, dtype=torch.float32, device=dev)
        dc = torch.zeros(b, hidden, dtype=torch.float32, device=dev)
        for s in range(t):
            r = t - 1 - s if fwd else s
            gates = gs[r].float()
            i = torch.sigmoid(gates[:, :hidden])
            f = torch.sigmoid(gates[:, hidden:2 * hidden])
            g = torch.tanh(gates[:, 2 * hidden:3 * hidden])
            o = torch.sigmoid(gates[:, 3 * hidden:])
            tc = torch.tanh(cs[r].float())
            dh = dy[r].float() + dh_rec
            do = dh * tc
            dct = dc + dh * o * (1.0 - tc * tc)
            dgates = torch.cat([dct * g * i * (1.0 - i),
                                dct * cps[r].float() * f * (1.0 - f),
                                dct * i * (1.0 - g * g),
                                do * o * (1.0 - o)], dim=-1)
            dxg[r] = dgates
            dh_rec = _dg_operand(dgates) @ wht
            dc = dct * f
        out.append(dxg)
    return out[0], out[1]


def _units_per_tile(hidden: int) -> int:
    return next(ut for ut in (8, 4, 2, 1) if hidden % ut == 0)


def _library():
    lib = build.load("bilstm_fwd")
    lib.bilstm_fwd.argtypes = ([ctypes.c_void_p] * 12
                               + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.bilstm_fwd.restype = ctypes.c_int
    return lib


def _bwd_library():
    lib = build.load("bilstm_bwd")
    lib.bilstm_bwd.argtypes = ([ctypes.c_void_p] * 11
                               + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.bilstm_bwd.restype = ctypes.c_int
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


def _check_bwd(wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f, dy_b):
    if g_f.dim() != 3 or g_f.shape[-1] % 4:
        raise ValueError("gates must be (T,B,4H), got {}".format(
            tuple(g_f.shape)))
    t, b, h4 = g_f.shape
    hidden = h4 // 4
    for x in (g_f, g_b, cs_f, cs_b):
        if x.dtype != torch.bfloat16:
            raise TypeError("stashes must be bfloat16, got {}".format(x.dtype))
    if g_b.shape != g_f.shape:
        raise ValueError("g_f and g_b differ: {} vs {}".format(
            tuple(g_f.shape), tuple(g_b.shape)))
    for x in (cs_f, cs_b, dy_f, dy_b):
        if tuple(x.shape) != (t, b, hidden):
            raise ValueError("cs/dy must be {}, got {}".format(
                (t, b, hidden), tuple(x.shape)))
    if dy_f.dtype != dy_b.dtype or dy_f.dtype not in (torch.float32,
                                                      torch.bfloat16):
        raise TypeError("dy must be float32 or bfloat16 in both directions, "
                        "got {} {}".format(dy_f.dtype, dy_b.dtype))
    for w in (wh_f, wh_b):
        if tuple(w.shape) != (hidden, h4):
            raise ValueError("w_h must be ({}, {}), got {}".format(
                hidden, h4, tuple(w.shape)))
    if t < 1 or b < 1:
        raise ValueError("empty sequence or batch: {}".format(
            tuple(g_f.shape)))


def _launch_bwd(wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f, dy_b):
    global BWD_LAUNCHES
    dev = g_f.device
    ops = (wh_f, wh_b, cs_f, cs_b, g_b, dy_f, dy_b)
    for x in ops:
        if x.device != dev:
            raise ValueError("all operands must be on {}, got {}".format(
                dev, x.device))
    t, b, h4 = g_f.shape
    hidden = h4 // 4
    lib = _bwd_library()
    whf = wh_f.to(torch.bfloat16).contiguous()
    whb = wh_b.to(torch.bfloat16).contiguous()
    g_f, g_b, cs_f, cs_b, dy_f, dy_b = (
        x.contiguous() for x in (g_f, g_b, cs_f, cs_b, dy_f, dy_b))
    dxg_f = torch.empty(t, b, h4, dtype=torch.bfloat16, device=dev)
    dxg_b = torch.empty_like(dxg_f)
    dcbuf = torch.zeros(2, b, hidden, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bilstm_bwd(
            g_f.data_ptr(), g_b.data_ptr(), whf.data_ptr(), whb.data_ptr(),
            cs_f.data_ptr(), cs_b.data_ptr(), dy_f.data_ptr(),
            dy_b.data_ptr(), dxg_f.data_ptr(), dxg_b.data_ptr(),
            dcbuf.data_ptr(), t, b, hidden, _units_per_tile(hidden),
            int(dy_f.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError("bilstm_bwd launch failed: cudaError {}".format(err))
    BWD_LAUNCHES += 1
    return dxg_f, dxg_b


def bilstm_recurrence_bwd(wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f, dy_b):
    """BLSTM backward recurrence from the forward's bf16 stashes: output
    cotangents dy (T,B,H) -> gate cotangents (dxg_f, dxg_b), bf16
    (T,B,4H)."""
    _check_bwd(wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f, dy_b)
    if g_f.device.type == "cpu":
        return bilstm_recurrence_bwd_ref(wh_f, wh_b, cs_f, cs_b, g_f, g_b,
                                         dy_f, dy_b)
    if g_f.device.type == "cuda":
        return _launch_bwd(wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f, dy_b)
    raise ValueError("bilstm_recurrence_bwd runs on cpu (plain version) or "
                     "cuda (kernel), got {}".format(g_f.device))


class BiLSTMRecurrence(torch.autograd.Function):
    """``bilstm_recurrence`` with its hand-written backward, as the JAX
    custom_vjp (``lstm.py`` ``_bi_rec_fwd``/``_bi_rec_bwd``): the forward
    keeps the bf16 stashes and bf16 ys, the backward runs K2 and forms each
    dW_h as one matmul of the shifted ys against dxg."""

    @staticmethod
    def forward(ctx, xg_f, xg_b, wh_f, wh_b):
        ys_f, ys_b, cs_f, cs_b, g_f, g_b = bilstm_recurrence(
            xg_f, xg_b, wh_f, wh_b, stash=True)
        ctx.save_for_backward(wh_f, wh_b, ys_f.to(torch.bfloat16),
                              ys_b.to(torch.bfloat16), cs_f, cs_b, g_f, g_b)
        return ys_f, ys_b

    @staticmethod
    def backward(ctx, dy_f, dy_b):
        wh_f, wh_b, ys_f, ys_b, cs_f, cs_b, g_f, g_b = ctx.saved_tensors
        dxg_f, dxg_b = bilstm_recurrence_bwd(wh_f, wh_b, cs_f, cs_b, g_f,
                                             g_b, dy_f, dy_b)
        # dW_h = sum_t h_prev[t]^T dxg[t]: bf16 values, f32 sums
        def dwh(ys, dxg, fwd):
            yp = _shift_prev(ys, fwd).float().flatten(0, 1)
            return yp.t() @ dxg.float().flatten(0, 1)
        # cotangents in each input's dtype (the primal xg is the ys/dy dtype)
        return (dxg_f.to(dy_f.dtype), dxg_b.to(dy_b.dtype),
                dwh(ys_f, dxg_f, True).to(wh_f.dtype),
                dwh(ys_b, dxg_b, False).to(wh_b.dtype))
