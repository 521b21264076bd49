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
``dh = dy[t] + bf16(dgates_prev) @ bf16(w_h)^T`` in f32, carries f32. dW_h
is one bf16 product with f32 sums outside the kernel.

``bilstm_recurrence`` and ``bilstm_recurrence_bwd`` dispatch on the tensors'
device: a CPU tensor goes to the plain PyTorch version (``*_ref``), a CUDA
tensor to the hand-written kernel in ``csrc/bilstm_fwd.cu`` /
``csrc/bilstm_bwd.cu`` (or raises). ``BiLSTMRecurrence`` is the autograd
Function over both, the same on either device.

Which form a hidden size gets (``form_for``), K1 and K2 alike. The resident
forms keep each block's slab of w_h in shared memory for the whole walk and
run the product on the tensor cores, both directions in one launch of
blocks that own 20 units each: K1's slab is the 80 gate columns of its
units, K2's their 20 rows of w_h (4H wide). A form is resident when (a) the
2 * ceil(H/20) tiles of the two directions fit the card's SMs, one block
each, and (b) the slab and the ring of operand segments (which the partial
products overlay) fit the shared memory a block may opt into
(``resident_smem_bytes``, ``resident_bwd_smem_bytes``). Both numbers are read
from the card; on an H100 (132 SMs, 232,448 bytes) that is H <= 1280, the
flagship's width, for both: 128 blocks of 231,424 bytes (K1) or 230,464
bytes (K2). Any other H takes the streamed form, which re-reads w_h from L2
every step. The form taken is counted (``RESIDENT_LAUNCHES``,
``STREAMED_LAUNCHES``, ``BWD_RESIDENT_LAUNCHES``, ``BWD_STREAMED_LAUNCHES``);
``LAUNCHES`` and ``BWD_LAUNCHES`` count calls that went through either.
"""

from __future__ import annotations

import ctypes

import torch

from e2e_asr_pytorch_tpu_torch.ops.kernels import build
from e2e_asr_pytorch_tpu_torch.ops.kernels.gru import pad_w
from e2e_asr_pytorch_tpu_torch.ops.kernels.lstm import (_card, _dwh, _pad_units,
                                                        _pad_w, _unpad_units)

# launches of the CUDA kernels in this process (the only global state):
# LAUNCHES counts K1 (forward) once per call of ``bilstm_recurrence`` that
# went through a kernel, whichever form it took and however many CUDA
# launches that form makes; RESIDENT_LAUNCHES and STREAMED_LAUNCHES split it
# by form. BWD_LAUNCHES counts K2 (backward) the same way, split by form
# into BWD_RESIDENT_LAUNCHES and BWD_STREAMED_LAUNCHES.
LAUNCHES = 0
RESIDENT_LAUNCHES = 0
STREAMED_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_RESIDENT_LAUNCHES = 0
BWD_STREAMED_LAUNCHES = 0

FORMS = ("resident", "streamed")
# the resident forms' geometry (csrc/bilstm_fwd.cu, csrc/bilstm_bwd.cu):
# hidden units per block; H is padded to 80 (whole tiles of 20 units, whole
# mma k steps of 16); the 3-stage cp.async ring of 16 rows x (256 + 8) bf16
# beside the slab
TILE_UNITS = 20
_PAD_UNITS = 80
_RING_BYTES = 2 * 3 * 16 * (256 + 8)


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


def _padded(hidden: int) -> int:
    """The resident form takes H in multiples of 80; the wrapper pads with
    units whose weights and inputs are zero, which stay at c = h = 0."""
    return -(-hidden // _PAD_UNITS) * _PAD_UNITS


def resident_smem_bytes(hidden: int, units: int = TILE_UNITS) -> int:
    """Shared memory of one block of the resident form at padded H
    (``resident_smem_bytes`` of csrc/bilstm_fwd.cu) with ``units`` a block
    (20; K5f's narrow form takes 10): the 4*units x (H+8) bf16 slab and the
    cp.async ring, which the partial tiles overlay."""
    return 2 * 4 * units * (_padded(hidden) + 8) + _RING_BYTES


def resident_bwd_smem_bytes(hidden: int) -> int:
    """Shared memory of one block of K2's resident form at padded H
    (``resident_smem_bytes`` of csrc/bilstm_bwd.cu): the block's 20 rows of
    w_h, 20 x (4H+8) bf16, and the cp.async ring, which the partial tiles
    overlay."""
    return 2 * TILE_UNITS * (4 * _padded(hidden) + 8) + _RING_BYTES


def form_for(hidden: int, device=None, backward: bool = False) -> str:
    """The form of K1 (or, with ``backward``, K2) this hidden size gets on
    ``device`` (an H100 when there is no CUDA device to ask): "resident"
    when both directions' 20-unit tiles, one per block, fit the card's SMs
    and a block's shared memory, else "streamed"."""
    n_sm, smem = _card(device)
    need = (resident_bwd_smem_bytes if backward else resident_smem_bytes)(
        hidden)
    if 2 * (_padded(hidden) // TILE_UNITS) <= n_sm and need <= smem:
        return "resident"
    return "streamed"


def pack_resident(w_h: torch.Tensor, units: int = TILE_UNITS) -> torch.Tensor:
    """The resident form's operand for ``units`` a block, (Hp/units,
    4*units, Hp) bf16 with H padded to a multiple of 80: per tile, row
    g*units + j holds the Hp weights of gate g of unit units*tile + j
    (column g*H + units*tile + j of w_h), k contiguous."""
    hidden = w_h.shape[0]
    hp = _padded(hidden)
    return (pad_w(w_h, hidden, hp, 4)
            .reshape(hp, 4, hp // units, units)
            .permute(2, 1, 3, 0)
            .reshape(hp // units, 4 * units, hp)
            .contiguous())  # the kernel reads the memory, not the strides


def pack_streamed(w_h: torch.Tensor) -> torch.Tensor:
    """The streamed form's operand, (H/ut, H, 4, ut) bf16: a tile's 4*ut gate
    columns become contiguous rows, so the kernel reads them coalesced."""
    hidden = w_h.shape[0]
    ut = _units_per_tile(hidden)
    return (w_h.to(torch.bfloat16).reshape(hidden, 4, hidden // ut, ut)
            .permute(2, 0, 1, 3).contiguous())


def pad_streams(xg_f, xg_b, wh_f, wh_b):
    """The resident form's operands at padded H: each gate block of xg gets
    zero units appended, w_h zero rows and columns (inside
    ``pack_resident``). Padded units see gates of 0 and stay at c = h = 0, so
    the real units' sums gain only zeros."""
    hidden = wh_f.shape[0]
    hp = _padded(hidden)
    return (_pad_units(xg_f, hidden, hp, 4), _pad_units(xg_b, hidden, hp, 4),
            pack_resident(wh_f), pack_resident(wh_b))


def _library():
    lib = build.load("bilstm_fwd")
    lib.bilstm_fwd.argtypes = ([ctypes.c_void_p] * 12
                               + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.bilstm_fwd.restype = ctypes.c_int
    lib.bilstm_fwd_resident.argtypes = ([ctypes.c_void_p] * 12
                                        + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
    lib.bilstm_fwd_resident.restype = ctypes.c_int
    return lib


def _bwd_library():
    lib = build.load("bilstm_bwd")
    lib.bilstm_bwd.argtypes = ([ctypes.c_void_p] * 11
                               + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.bilstm_bwd.restype = ctypes.c_int
    lib.bilstm_bwd_resident.argtypes = ([ctypes.c_void_p] * 11
                                        + [ctypes.c_int] * 4
                                        + [ctypes.c_void_p])
    lib.bilstm_bwd_resident.restype = ctypes.c_int
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


def _resolve_form(form, hidden: int, device=None,
                  backward: bool = False) -> str:
    """The form a launch of K1 (or K2) takes: ``form_for``'s when none is
    asked for; an unknown form, or the resident one where it cannot run, is
    refused."""
    ruled = form_for(hidden, device, backward)
    if form is None:
        return ruled
    if form not in FORMS:
        raise ValueError("form must be one of {}, got {!r}".format(FORMS,
                                                                   form))
    if form == "resident" and ruled != "resident":
        raise ValueError(
            "w_h of H={} does not fit {}'s resident form on {}: it takes the "
            "streamed one".format(hidden, "K2" if backward else "K1", device))
    return form


def _launch(xg_f, xg_b, wh_f, wh_b, stash: bool, form):
    global LAUNCHES, RESIDENT_LAUNCHES, STREAMED_LAUNCHES
    dev = xg_f.device
    for x in (xg_b, wh_f, wh_b):
        if x.device != dev:
            raise ValueError("all operands must be on {}, got {}".format(
                dev, x.device))
    if not (xg_f.is_contiguous() and xg_b.is_contiguous()):
        raise ValueError("xg_f and xg_b must be contiguous")
    t, b, h4 = xg_f.shape
    hidden = h4 // 4
    form = _resolve_form(form, hidden, dev)
    lib = _library()
    if form == "resident":
        hp = _padded(hidden)
        xg_f, xg_b, wp_f, wp_b = pad_streams(xg_f, xg_b, wh_f, wh_b)
    else:
        hp = hidden
        wp_f, wp_b = pack_streamed(wh_f), pack_streamed(wh_b)
    ys_f = torch.empty(t, b, hp, dtype=xg_f.dtype, device=dev)
    ys_b = torch.empty_like(ys_f)
    if stash:
        cs_f = torch.empty(t, b, hp, dtype=torch.bfloat16, device=dev)
        cs_b = torch.empty_like(cs_f)
        g_f = torch.empty(t, b, 4 * hp, dtype=torch.bfloat16, device=dev)
        g_b = torch.empty_like(g_f)
        stash_ptrs = [cs_f.data_ptr(), cs_b.data_ptr(), g_f.data_ptr(),
                      g_b.data_ptr()]
    else:
        stash_ptrs = [None] * 4
    hbuf = torch.zeros(2, 2, b, hp, dtype=torch.bfloat16, device=dev)
    cbuf = torch.zeros(2, b, hp, dtype=torch.float32, device=dev)
    is_bf16 = int(xg_f.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (xg_f.data_ptr(), xg_b.data_ptr(), wp_f.data_ptr(),
                wp_b.data_ptr(), ys_f.data_ptr(), ys_b.data_ptr(),
                *stash_ptrs, hbuf.data_ptr(), cbuf.data_ptr(), t, b, hp)
        if form == "resident":
            # both directions from the forward one on
            err = lib.bilstm_fwd_resident(*head, 0, 2, TILE_UNITS, is_bf16,
                                          stream)
        else:
            err = lib.bilstm_fwd(*head, _units_per_tile(hidden), is_bf16,
                                 stream)
    if err != 0:
        raise RuntimeError("bilstm_fwd ({} form) launch failed: cudaError {}"
                           .format(form, err))
    LAUNCHES += 1
    if form == "resident":
        RESIDENT_LAUNCHES += 1
    else:
        STREAMED_LAUNCHES += 1
    ys_f, ys_b = (_unpad_units(y, hidden, hp, 1) for y in (ys_f, ys_b))
    if stash:
        cs_f, cs_b = (_unpad_units(c, hidden, hp, 1) for c in (cs_f, cs_b))
        g_f, g_b = (_unpad_units(g, hidden, hp, 4) for g in (g_f, g_b))
        return ys_f, ys_b, cs_f, cs_b, g_f, g_b
    return ys_f, ys_b


def bilstm_recurrence(xg_f, xg_b, wh_f, wh_b, stash: bool = False,
                      form=None):
    """Direction-packed BLSTM recurrence: both directions' (T,B,4H) gate
    inputs (data order) -> (ys_f, ys_b) (T,B,H) each in xg's dtype, plus the
    bf16 stashes (cs_f, cs_b, gates_f, gates_b) when ``stash``. On a CUDA
    tensor ``form`` picks the kernel's form ("resident" or "streamed");
    None takes ``form_for``'s. A CPU tensor takes the plain version."""
    _check(xg_f, xg_b, wh_f, wh_b)
    if xg_f.device.type == "cpu":
        return bilstm_recurrence_ref(xg_f, xg_b, wh_f, wh_b, stash)
    if xg_f.device.type == "cuda":
        return _launch(xg_f, xg_b, wh_f, wh_b, stash, form)
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


def pad_bwd_operands(hp: int, wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f,
                     dy_b):
    """K2's operands at padded H: w_h bf16 (Hp,4Hp) with zero rows and
    columns, each gate block of the gate stashes and the (T,B,H) streams
    with zero units appended. A padded unit sees gates of 0, c = 0, dy = 0
    and zero weights, so its dgates stay 0 and the real units' sums gain
    only zeros."""
    hidden = wh_f.shape[0]
    return ([_pad_w(w, hidden, hp) for w in (wh_f, wh_b)]
            + [_pad_units(x, hidden, hp, 1) for x in (cs_f, cs_b)]
            + [_pad_units(x, hidden, hp, 4) for x in (g_f, g_b)]
            + [_pad_units(x, hidden, hp, 1) for x in (dy_f, dy_b)])


def _launch_bwd(wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f, dy_b, form):
    global BWD_LAUNCHES, BWD_RESIDENT_LAUNCHES, BWD_STREAMED_LAUNCHES
    dev = g_f.device
    for x in (wh_f, wh_b, cs_f, cs_b, g_b, dy_f, dy_b):
        if x.device != dev:
            raise ValueError("all operands must be on {}, got {}".format(
                dev, x.device))
    t, b, h4 = g_f.shape
    hidden = h4 // 4
    form = _resolve_form(form, hidden, dev, backward=True)
    lib = _bwd_library()
    hp = _padded(hidden) if form == "resident" else hidden
    whf, whb, cs_f, cs_b, g_f, g_b, dy_f, dy_b = pad_bwd_operands(
        hp, wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f, dy_b)
    dxg_f = torch.empty(t, b, 4 * hp, dtype=torch.bfloat16, device=dev)
    dxg_b = torch.empty_like(dxg_f)
    dcbuf = torch.zeros(2, b, hp, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (g_f.data_ptr(), g_b.data_ptr(), whf.data_ptr(),
                whb.data_ptr(), cs_f.data_ptr(), cs_b.data_ptr(),
                dy_f.data_ptr(), dy_b.data_ptr(), dxg_f.data_ptr(),
                dxg_b.data_ptr(), dcbuf.data_ptr(), t, b, hp)
        is_bf16 = int(dy_f.dtype == torch.bfloat16)
        if form == "resident":
            err = lib.bilstm_bwd_resident(*head, is_bf16, stream)
        else:
            err = lib.bilstm_bwd(*head, _units_per_tile(hidden), is_bf16,
                                 stream)
    if err != 0:
        raise RuntimeError("bilstm_bwd ({} form) launch failed: cudaError {}"
                           .format(form, err))
    BWD_LAUNCHES += 1
    if form == "resident":
        BWD_RESIDENT_LAUNCHES += 1
    else:
        BWD_STREAMED_LAUNCHES += 1
    return tuple(_unpad_units(d, hidden, hp, 4) for d in (dxg_f, dxg_b))


def bilstm_recurrence_bwd(wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f, dy_b,
                          form=None):
    """BLSTM backward recurrence from the forward's bf16 stashes: output
    cotangents dy (T,B,H) -> gate cotangents (dxg_f, dxg_b), bf16
    (T,B,4H). On a CUDA tensor ``form`` picks the kernel's form ("resident"
    or "streamed"); None takes ``form_for``'s. A CPU tensor takes the plain
    version."""
    _check_bwd(wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f, dy_b)
    if g_f.device.type == "cpu":
        return bilstm_recurrence_bwd_ref(wh_f, wh_b, cs_f, cs_b, g_f, g_b,
                                         dy_f, dy_b)
    if g_f.device.type == "cuda":
        return _launch_bwd(wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f, dy_b,
                           form)
    raise ValueError("bilstm_recurrence_bwd runs on cpu (plain version) or "
                     "cuda (kernel), got {}".format(g_f.device))


class BiLSTMRecurrence(torch.autograd.Function):
    """``bilstm_recurrence`` with its hand-written backward, as the JAX
    custom_vjp (``lstm.py`` ``_bi_rec_fwd``/``_bi_rec_bwd``): the forward
    keeps the bf16 stashes and bf16 ys, the backward runs K2 and forms each
    dW_h as one bf16 product of the shifted ys against dxg with f32 sums
    (``lstm._dwh``)."""

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
        # cotangents in each input's dtype (the primal xg is the ys/dy dtype)
        return (dxg_f.to(dy_f.dtype), dxg_b.to(dy_b.dtype),
                _dwh(ys_f, dxg_f, False).to(wh_f.dtype),
                _dwh(ys_b, dxg_b, True).to(wh_b.dtype))
