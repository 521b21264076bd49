"""Single-direction LSTM recurrence, forward and backward, in two forms
(counterpart of the TPU kernels behind ``lstm_recurrence`` and
``lstm_recurrence_chunked`` in e2e_asr_pytorch_tpu/ops/pallas/lstm.py).

Shared contract: the input pre-activations ``xg`` (T,B,4H) are computed
outside as one matmul in compute dtype; the carries h, c, dh, dc are f32; the
recurrent product is ``bf16(h) @ bf16(w_h)`` with f32 sums, gate order
i,f,g,o, zero initial state; dW_h is one product outside the kernel.

  K5f ``lstm_fwd``            w_h resident on chip for the whole sequence;
                              ``reverse`` walks t = T-1..0 by indexing.
  K5b ``lstm_bwd``            its backward from the bf16 stashes; dxg bf16.
  K6f ``lstm_fwd_chunked``    the part of w_h that fits stays on chip, the
                              rest is streamed every step in chunks, the
                              partial gates accumulated; forward order only.
  K6b ``lstm_bwd_chunked``    as K6f, the part of w_h that fits stays on
                              chip; dxg f32, unrounded, only the product's
                              operand is bf16.

Each dispatches on the tensors' device: a CPU tensor goes to the plain
PyTorch version (``*_ref``), a CUDA tensor to the hand-written kernel in
``csrc/lstm_fwd.cu`` / ``csrc/lstm_bwd.cu`` (or raises). ``LSTMRecurrence``
and ``LSTMRecurrenceChunked`` are the autograd Functions over them, the same
on either device; ``lstm_recurrence`` / ``lstm_recurrence_chunked`` are the
public entry points and ``recurrence_fn`` picks between them.

Which form a hidden size gets. On the TPU the rule was a VMEM size. Here the
resident kernels keep each block's slab of w_h in shared memory beside the
cp.async ring that streams h or dgates, one tile per block, so w_h is
resident when (a) its unit tiles fit the cooperative grid (one block per
SM): H/8 or H/16 in the forward, H/16 in the backward, and (b) the forward
slab (4*ut x (H+8) bf16) and the backward slab (16 x (4H+8) bf16) each fit,
with the ring, the shared memory a block may opt into. Both numbers are read
from the card (``multi_processor_count``, ``shared_memory_per_block_optin``);
on an H100 (132 SMs, 232,448 bytes) H=1024 is resident with 128 forward
tiles of 8 units (121 KB a block; backward 187 KB) and H=1280 with 80 tiles
of 16 (220 KB), while H=2048 would need a 263 KB slab and takes the chunked
kernels. The chunked kernels keep what they can all the same
(``chunked_plan``, ``chunked_bwd_plan``): of each block's slab, cut into
128-wide k-tiles (16 KB in the forward, whose tile is 64 gate columns; 8 KB
in the backward, whose tile is 32 rows of w_h), as many tiles stay in shared
memory as the opt-in size leaves beside the kernel's rings (6 of 16 forward
and 3 of 64 backward at H=2048 on an H100), and only the others are re-read
from L2 every step.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from e2e_asr_pytorch_tpu_torch.ops.kernels import build

# launches of the CUDA kernels in this process (the only global state)
FWD_LAUNCHES = 0            # K5f
BWD_LAUNCHES = 0            # K5b
FWD_CHUNKED_LAUNCHES = 0    # K6f
BWD_CHUNKED_LAUNCHES = 0    # K6b

# the kernels' geometry (csrc/lstm_common.cuh): k values per streamed chunk,
# the bytes of the 3-stage cp.async ring for the 128-row passes of h /
# dgates, and the units per tile of the resident backward and of both chunked
# kernels' widest tile (H is padded to a multiple of it)
CHUNK_K = 64
_RING_BYTES = 2 * 3 * (CHUNK_K + 8) * 128
_BWD_RESIDENT_UNITS = 16
_PAD_UNITS = 32
# the chunked forward's geometry (csrc/lstm_fwd.cu): w_h and the h exchange
# buffer are laid out in atoms of 64 k values (one 128-byte swizzle row); a
# k-tile, the unit of the kernel's rings and of residency, is two atoms, so H
# is padded to 128; a k-tile of a block's 64-column slab is 16 KB; a block's
# shared memory is 1 KB of alignment slack, a ring of three 32 KB k-tiles of
# h, a ring of two streamed k-tiles of w and 1 KB of barriers, plus the
# resident k-tiles
_TILE_K = 64
_CHUNKED_UNITS = 16
_K_TILE = 2 * _TILE_K
_W_TILE_BYTES = 2 * 4 * _CHUNKED_UNITS * _K_TILE
_H_TILE_BYTES = 2 * 128 * _K_TILE
_CHUNKED_FIXED_BYTES = 1024 + 3 * _H_TILE_BYTES + 2 * _W_TILE_BYTES + 1024
# the chunked backward's geometry (csrc/lstm_bwd.cu): a tile is 32 units x 64
# batch rows; w_h's rows and the exchange buffer of bf16(dgates) are laid out
# in the same 64-value atoms, two to a k-tile, so 4H is a multiple of 128
# whenever H is of 32; a k-tile of a tile's slab is 8 KB, of its dgates rows
# 16 KB; a block's shared memory is 1 KB of alignment slack, a ring of eight
# stages (each a dgates and a slab k-tile), 8 KB for the two warpgroups'
# partial sums and 1 KB of barriers, plus the resident k-tiles
_BWD_CHUNKED_UNITS = 32
_BWD_CHUNKED_ROWS = 64
_BWD_W_TILE_BYTES = 2 * _BWD_CHUNKED_UNITS * _K_TILE
_BWD_G_TILE_BYTES = 2 * _BWD_CHUNKED_ROWS * _K_TILE
_BWD_CHUNKED_FIXED_BYTES = (1024 + 8 * _BWD_G_TILE_BYTES
                            + 8 * _BWD_W_TILE_BYTES + 8192 + 1024)
# what an H100 reports, used when the caller has no CUDA device to ask (the
# CPU tests) or the installed PyTorch does not expose the opt-in size
H100_SMS = 132
H100_SMEM_OPTIN = 232448


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


def _dg_operand(dgates: torch.Tensor) -> torch.Tensor:
    """bf16(dgates), the backward recurrent matmul's left operand, held
    exactly in f32."""
    return dgates.to(torch.bfloat16).float()


def _gate_chunked_matmul(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h @ w formed gate by gate, in four column chunks of the 4H axis (as
    the TPU's chunked forward forms its partial gates): every column's sum
    is whole, so only the chunking differs from ``torch.matmul``."""
    width = w.shape[1] // 4
    return torch.cat([h @ w[:, g * width:(g + 1) * width] for g in range(4)],
                     dim=-1)


def _chunked_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w accumulated over CHUNK_K-wide slices of the contraction axis, as
    the TPU's chunked backward accumulates its partial dh (the kernel sums
    the same products in another order)."""
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, a.shape[1], CHUNK_K):
        acc = acc + a[:, k0:k0 + CHUNK_K] @ w[k0:k0 + CHUNK_K]
    return acc


def _forward_ref(xg, w_h, reverse: bool, stash: bool, matmul):
    t, b, h4 = xg.shape
    hidden = h4 // 4
    wh = w_h.to(torch.bfloat16).float()
    h = c = torch.zeros(b, hidden, dtype=torch.float32, device=xg.device)
    ys = torch.empty(t, b, hidden, dtype=xg.dtype, device=xg.device)
    if stash:
        cs = torch.empty(t, b, hidden, dtype=torch.bfloat16, device=xg.device)
        gs = torch.empty(t, b, h4, dtype=torch.bfloat16, device=xg.device)
    for s in range(t):
        r = t - 1 - s if reverse else s
        # xg (f32 or bf16) is added to the f32 product: gates are f32 before
        # the activations, and the stash rounds that f32 value
        gates = xg[r].float() + matmul(_h_operand(h), wh)
        h, c = _cell(gates, c)
        ys[r] = h
        if stash:
            cs[r], gs[r] = c, gates
    return (ys, cs, gs) if stash else ys


def lstm_recurrence_ref(xg, w_h, reverse: bool = False, stash: bool = False):
    """Plain PyTorch version of K5f with the kernel's numerics (bf16
    products exact in f32, f32 sums). Returns ys (T,B,H) in xg's dtype, plus
    the bf16 stashes (cs, gates) when ``stash``."""
    return _forward_ref(xg, w_h, reverse, stash, torch.matmul)


def lstm_recurrence_chunked_ref(xg, w_h, stash: bool = False):
    """Plain PyTorch version of K6f: as ``lstm_recurrence_ref`` in forward
    order, the gates formed chunk by chunk."""
    return _forward_ref(xg, w_h, False, stash, _gate_chunked_matmul)


def _shift_prev(x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """What the forward scan saw before data index t: x[t-1] for a plain
    scan, x[t+1] for a reversed one, zeros at the scan's start."""
    zero = torch.zeros_like(x[:1])
    if reverse:
        return torch.cat([x[1:], zero], dim=0)
    return torch.cat([zero, x[:-1]], dim=0)


def _backward_ref(w_h, cs, gs, dy, reverse: bool, out_dtype, matmul):
    t, b, h4 = gs.shape
    hidden = h4 // 4
    dev = gs.device
    wht = w_h.to(torch.bfloat16).float().t().contiguous()
    cps = _shift_prev(cs, reverse)
    dxg = torch.empty(t, b, h4, dtype=out_dtype, device=dev)
    dh_rec = torch.zeros(b, hidden, dtype=torch.float32, device=dev)
    dc = torch.zeros(b, hidden, dtype=torch.float32, device=dev)
    for s in range(t):
        r = s if reverse else t - 1 - s
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
        dh_rec = matmul(_dg_operand(dgates), wht)
        dc = dct * f
    return dxg


def lstm_recurrence_bwd_ref(w_h, cs, gates, dy, reverse: bool = False):
    """Plain PyTorch version of K5b. Stashes are bf16 (T,B,H) cs and
    (T,B,4H) gates; dy (T,B,H) in the stream dtype. Returns dxg, bf16
    (T,B,4H), whatever the stream."""
    return _backward_ref(w_h, cs, gates, dy, reverse, torch.bfloat16,
                         torch.matmul)


def lstm_recurrence_chunked_bwd_ref(w_h, cs, gates, dy):
    """Plain PyTorch version of K6b: forward order only, dh accumulated
    chunk by chunk, dxg f32 and unrounded (only the operand of the dh product
    is rounded to bf16)."""
    return _backward_ref(w_h, cs, gates, dy, False, torch.float32,
                         _chunked_matmul)


# ---------------------------------------------------------------------------
# which form a hidden size gets
# ---------------------------------------------------------------------------

def _padded(hidden: int) -> int:
    """The kernels take H in multiples of 32 (the chunked backward's unit
    tile; an mma k step is 16); the wrappers pad with units whose weights
    and inputs are zero."""
    return -(-hidden // _PAD_UNITS) * _PAD_UNITS


def _card(device=None):
    """(SMs, shared memory a block may opt into) of ``device``; an H100's
    when there is no CUDA device to ask."""
    if device is None or torch.device(device).type != "cuda":
        return H100_SMS, H100_SMEM_OPTIN
    props = torch.cuda.get_device_properties(device)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", H100_SMEM_OPTIN))


def _resident_units(hidden: int, device=None):
    """The forward's units per tile under which w_h stays resident in
    shared memory in both directions, or None when it cannot (see the module
    docstring)."""
    n_sm, smem = _card(device)
    hp = _padded(hidden)
    bwd_slab = 2 * _BWD_RESIDENT_UNITS * (4 * hp + 8)
    if (hp // _BWD_RESIDENT_UNITS > n_sm
            or bwd_slab + _RING_BYTES > smem):
        return None
    for ut in (8, 16):
        if hp // ut > n_sm:
            continue  # one tile per block, one block per SM
        if 2 * 4 * ut * (hp + 8) + _RING_BYTES <= smem:
            return ut
    return None


def fits_resident(hidden: int, device=None) -> bool:
    """Counterpart of the TPU package's ``_fits_vmem``, from this card's
    shared memory and SM count."""
    return _resident_units(hidden, device) is not None


def chunked_plan(hidden: int, device=None):
    """How the chunked forward lays H out on ``device`` (an H100 when there
    is no CUDA device to ask): (padded H, 16-unit tiles a block owns, k-tiles
    of each that stay resident in shared memory). The resident share is what
    the card's opt-in shared memory leaves beside the kernel's rings."""
    n_sm, smem = _card(device)
    hp = -(-hidden // _K_TILE) * _K_TILE
    n_tiles = hp // _CHUNKED_UNITS
    tiles_per_block = -(-n_tiles // n_sm)
    room = smem - _CHUNKED_FIXED_BYTES
    if room < 0:
        raise ValueError("the chunked LSTM forward needs {} bytes of shared "
                         "memory a block, the card offers {}".format(
                             _CHUNKED_FIXED_BYTES, smem))
    resident = min(hp // _K_TILE,
                   room // (_W_TILE_BYTES * tiles_per_block))
    return hp, tiles_per_block, resident


def chunked_smem_bytes(hidden: int, device=None) -> int:
    """Shared memory of one block of the chunked forward."""
    _, tiles_per_block, resident = chunked_plan(hidden, device)
    return _CHUNKED_FIXED_BYTES + tiles_per_block * resident * _W_TILE_BYTES


def chunked_resident_share(hidden: int, device=None) -> float:
    """The share of w_h that the chunked forward never re-reads."""
    hp, _, resident = chunked_plan(hidden, device)
    return resident / (hp // _K_TILE)


def chunked_bwd_plan(hidden: int, batch: int, device=None):
    """How the chunked backward lays H out on ``device`` (an H100 when there
    is no CUDA device to ask): (padded H, tiles of 32 units x 64 rows a block
    owns, k-tiles of each tile's slab that stay resident in shared memory).
    The resident share is what the card's opt-in shared memory leaves beside
    the kernel's rings."""
    n_sm, smem = _card(device)
    hp = _padded(hidden)
    n_tiles = (hp // _BWD_CHUNKED_UNITS) * -(-batch // _BWD_CHUNKED_ROWS)
    tiles_per_block = -(-n_tiles // n_sm)
    room = smem - _BWD_CHUNKED_FIXED_BYTES
    if room < 0:
        raise ValueError("the chunked LSTM backward needs {} bytes of shared "
                         "memory a block, the card offers {}".format(
                             _BWD_CHUNKED_FIXED_BYTES, smem))
    resident = min(4 * hp // _K_TILE,
                   room // (_BWD_W_TILE_BYTES * tiles_per_block))
    return hp, tiles_per_block, resident


def chunked_bwd_smem_bytes(hidden: int, batch: int, device=None) -> int:
    """Shared memory of one block of the chunked backward."""
    _, tiles_per_block, resident = chunked_bwd_plan(hidden, batch, device)
    return (_BWD_CHUNKED_FIXED_BYTES
            + tiles_per_block * resident * _BWD_W_TILE_BYTES)


def _swizzle_index(rows: int, device) -> torch.Tensor:
    """(rows, 8): the 16-byte chunk that sits at each chunk position of a
    row of 64 bf16 in the 128-byte swizzle (chunk c of row r at c ^ r % 8)."""
    r = torch.arange(rows, device=device)[:, None]
    return torch.arange(8, device=device)[None, :] ^ (r % 8)


def _swizzle_atoms(x: torch.Tensor) -> torch.Tensor:
    """(..., R, 64) rows of 64 bf16 -> the same rows with their 8-value
    chunks in the 128-byte swizzle of the row's index."""
    rows = x.shape[-2]
    lead = x.shape[:-2]
    idx = _swizzle_index(rows, x.device)
    r = torch.arange(rows, device=x.device)[:, None]
    return x.reshape(*lead, rows, 8, 8)[..., r, idx, :].reshape(*lead, rows,
                                                               _TILE_K)


def pack_chunked(w_h: torch.Tensor, hp: int) -> torch.Tensor:
    """The chunked forward's operand, (Hp/16, Hp/64, 64, 64) bf16: tile,
    k-tile, gate column g*16 + j (column g*H + 16*tile + j of w_h), then that
    column's 64 k values with their 8-value chunks swizzled by the column's
    row, so that one contiguous copy of a k-tile lands it as the tensor
    cores read it."""
    hidden = w_h.shape[0]
    n_tiles, n_kt = hp // _CHUNKED_UNITS, hp // _TILE_K
    w = (_pad_w(w_h, hidden, hp).reshape(n_kt, _TILE_K, 4, n_tiles,
                                         _CHUNKED_UNITS)
         .permute(3, 0, 2, 4, 1)                  # tile, kt, g, j, k
         .reshape(n_tiles, n_kt, 4 * _CHUNKED_UNITS, _TILE_K))
    return _swizzle_atoms(w).contiguous()


def pack_chunked_on_card(w_h: torch.Tensor, hp: int) -> torch.Tensor:
    """``pack_chunked`` by the small kernel beside the recurrence (one pass
    over w_h where the indexing above makes three): what the wrapper calls
    on a CUDA tensor."""
    hidden = w_h.shape[0]
    if w_h.dtype not in (torch.float32, torch.bfloat16):
        w_h = w_h.float()
    w_h = w_h.contiguous()
    wp = torch.empty(hp // _CHUNKED_UNITS, hp // _TILE_K, 4 * _CHUNKED_UNITS,
                     _TILE_K, dtype=torch.bfloat16, device=w_h.device)
    with torch.cuda.device(w_h.device):
        err = _fwd_library().lstm_pack_chunked(
            w_h.data_ptr(), wp.data_ptr(), hidden, hp,
            int(w_h.dtype == torch.bfloat16),
            torch.cuda.current_stream(w_h.device).cuda_stream)
    if err != 0:
        raise RuntimeError("lstm_pack_chunked launch failed: cudaError {}"
                           .format(err))
    return wp


def pack_chunked_bwd(w_h: torch.Tensor, hp: int) -> torch.Tensor:
    """The chunked backward's operand, (Hp/32, 4Hp/64, 32, 64) bf16: unit
    tile, atom, row j of the tile (row 32*tile + j of w_h), that row's 64 k
    values of the atom with their 8-value chunks swizzled by j, so that one
    contiguous copy of a k-tile (two atoms) lands it as the tensor cores
    read it. No transposition: w_h's rows are k-contiguous already."""
    hidden = w_h.shape[0]
    n_ut, n_atoms = hp // _BWD_CHUNKED_UNITS, 4 * hp // _TILE_K
    w = (_pad_w(w_h, hidden, hp)
         .reshape(n_ut, _BWD_CHUNKED_UNITS, n_atoms, _TILE_K)
         .permute(0, 2, 1, 3))                    # tile, atom, j, k
    return _swizzle_atoms(w).contiguous()


def pack_chunked_bwd_on_card(w_h: torch.Tensor, hp: int) -> torch.Tensor:
    """``pack_chunked_bwd`` by the small kernel beside the chunked backward
    (one pass over w_h): what the wrapper calls on a CUDA tensor."""
    hidden = w_h.shape[0]
    if w_h.dtype not in (torch.float32, torch.bfloat16):
        w_h = w_h.float()
    w_h = w_h.contiguous()
    wp = torch.empty(hp // _BWD_CHUNKED_UNITS, 4 * hp // _TILE_K,
                     _BWD_CHUNKED_UNITS, _TILE_K, dtype=torch.bfloat16,
                     device=w_h.device)
    with torch.cuda.device(w_h.device):
        err = _bwd_library().lstm_pack_chunked_bwd(
            w_h.data_ptr(), wp.data_ptr(), hidden, hp,
            int(w_h.dtype == torch.bfloat16),
            torch.cuda.current_stream(w_h.device).cuda_stream)
    if err != 0:
        raise RuntimeError("lstm_pack_chunked_bwd launch failed: cudaError "
                           "{}".format(err))
    return wp


def exchange_layout(dgates: torch.Tensor, hp: int) -> torch.Tensor:
    """bf16(dgates) of one step, (B, 4Hp), as the chunked backward keeps it
    in one of its two exchange buffers: (ceil(B/64), 4Hp/64, 64, 64), row
    block, atom, row of the block, the row's 64 values of the atom swizzled
    by the row; rows beyond the batch are zero."""
    b = dgates.shape[0]
    n_rb = -(-b // _BWD_CHUNKED_ROWS)
    x = F.pad(dgates.to(torch.bfloat16),
              (0, 0, 0, n_rb * _BWD_CHUNKED_ROWS - b))
    x = (x.reshape(n_rb, _BWD_CHUNKED_ROWS, 4 * hp // _TILE_K, _TILE_K)
         .permute(0, 2, 1, 3))                    # row block, atom, row, k
    return _swizzle_atoms(x).contiguous()


def recurrence_fn(hidden: int, device=None):
    """Pick the recurrence for this hidden size: resident when w_h fits the
    grid's shared memory, chunked otherwise."""
    return (lstm_recurrence if fits_resident(hidden, device)
            else lstm_recurrence_chunked)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _fwd_library():
    lib = build.load("lstm_fwd")
    lib.lstm_fwd_resident.argtypes = ([ctypes.c_void_p] * 7
                                      + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.lstm_fwd_resident.restype = ctypes.c_int
    lib.lstm_fwd_chunked.argtypes = ([ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.lstm_fwd_chunked.restype = ctypes.c_int
    lib.lstm_pack_chunked.argtypes = ([ctypes.c_void_p] * 2
                                      + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.lstm_pack_chunked.restype = ctypes.c_int
    return lib


def _bwd_library():
    lib = build.load("lstm_bwd")
    lib.lstm_bwd_resident.argtypes = ([ctypes.c_void_p] * 6
                                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.lstm_bwd_resident.restype = ctypes.c_int
    lib.lstm_bwd_chunked.argtypes = ([ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.lstm_bwd_chunked.restype = ctypes.c_int
    lib.lstm_pack_chunked_bwd.argtypes = ([ctypes.c_void_p] * 2
                                          + [ctypes.c_int] * 3
                                          + [ctypes.c_void_p])
    lib.lstm_pack_chunked_bwd.restype = ctypes.c_int
    return lib


def _pad_units(x: torch.Tensor, hidden: int, hp: int, blocks: int):
    """(..., blocks*H) -> (..., blocks*Hp): zero units appended to each of
    the ``blocks`` H-wide blocks of the last axis."""
    if hp == hidden:
        return x.contiguous()
    lead = x.shape[:-1]
    return F.pad(x.reshape(*lead, blocks, hidden),
                 (0, hp - hidden)).reshape(*lead, blocks * hp)


def _unpad_units(x: torch.Tensor, hidden: int, hp: int, blocks: int):
    if hp == hidden:
        return x
    lead = x.shape[:-1]
    return (x.reshape(*lead, blocks, hp)[..., :hidden]
            .reshape(*lead, blocks * hidden))


def _pad_w(w_h: torch.Tensor, hidden: int, hp: int) -> torch.Tensor:
    """(H,4H) -> bf16 (Hp,4Hp) with zero rows and columns for the padding."""
    w = _pad_units(w_h.to(torch.bfloat16), hidden, hp, 4)
    return F.pad(w, (0, 0, 0, hp - hidden)).contiguous()


def _check_fwd(xg, w_h):
    if xg.dim() != 3 or xg.shape[-1] % 4:
        raise ValueError("xg must be (T,B,4H), got {}".format(tuple(xg.shape)))
    t, b, h4 = xg.shape
    if xg.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("xg must be float32 or bfloat16, got {}".format(
            xg.dtype))
    if tuple(w_h.shape) != (h4 // 4, h4):
        raise ValueError("w_h must be ({}, {}), got {}".format(
            h4 // 4, h4, tuple(w_h.shape)))
    if t < 1 or b < 1:
        raise ValueError("empty sequence or batch: {}".format(
            tuple(xg.shape)))
    if w_h.device != xg.device:
        raise ValueError("xg on {} but w_h on {}".format(xg.device,
                                                         w_h.device))


def _launch_fwd(xg, w_h, reverse: bool, stash: bool, resident: bool):
    global FWD_LAUNCHES, FWD_CHUNKED_LAUNCHES
    dev = xg.device
    t, b, h4 = xg.shape
    hidden = h4 // 4
    if resident:
        hp = _padded(hidden)
        ut = _resident_units(hidden, dev)
        if ut is None:
            raise ValueError(
                "w_h of H={} does not fit the grid's shared memory on {}: "
                "use lstm_recurrence_chunked".format(
                    hidden, torch.cuda.get_device_name(dev)))
        # per tile, row g*ut + j holds the H weights of gate g of unit
        # u0 + j: the kernel's Wt operand, k contiguous
        wp = (_pad_w(w_h, hidden, hp).reshape(hp, 4, hp // ut, ut)
              .permute(2, 1, 3, 0).contiguous())
        hbuf = torch.zeros(2, b, hp, dtype=torch.bfloat16, device=dev)
    else:
        hp, tiles_per_block, resident_ktiles = chunked_plan(hidden, dev)
        wp = pack_chunked_on_card(w_h, hp)
        # 128 rows a pass whatever the batch, in the kernel's tiled layout
        hbuf = torch.zeros(2, -(-b // 128), hp // _TILE_K, 128, _TILE_K,
                           dtype=torch.bfloat16, device=dev)
        step_counter = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _fwd_library()
    xg_p = _pad_units(xg, hidden, hp, 4)
    ys = torch.empty(t, b, hp, dtype=xg.dtype, device=dev)
    cs = gs = None
    if stash:
        cs = torch.empty(t, b, hp, dtype=torch.bfloat16, device=dev)
        gs = torch.empty(t, b, 4 * hp, dtype=torch.bfloat16, device=dev)
    stash_ptrs = [x.data_ptr() if stash else None for x in (cs, gs)]
    cbuf = torch.zeros(b, hp, dtype=torch.float32, device=dev)
    is_bf16 = int(xg.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (xg_p.data_ptr(), wp.data_ptr(), ys.data_ptr(), *stash_ptrs,
                hbuf.data_ptr(), cbuf.data_ptr())
        if resident:
            err = lib.lstm_fwd_resident(*head, t, b, hp, ut, int(reverse),
                                        is_bf16, stream)
        else:
            err = lib.lstm_fwd_chunked(*head, step_counter.data_ptr(), t, b,
                                       hp, tiles_per_block, resident_ktiles,
                                       is_bf16, stream)
    if err != 0:
        raise RuntimeError("lstm_fwd_{} launch failed: cudaError {}".format(
            "resident" if resident else "chunked", err))
    if resident:
        FWD_LAUNCHES += 1
    else:
        FWD_CHUNKED_LAUNCHES += 1
    ys = _unpad_units(ys, hidden, hp, 1)
    if stash:
        return (ys, _unpad_units(cs, hidden, hp, 1),
                _unpad_units(gs, hidden, hp, 4))
    return ys


def _dispatch_fwd(xg, w_h, reverse, stash, resident):
    _check_fwd(xg, w_h)
    if xg.device.type == "cpu":
        if resident:
            return lstm_recurrence_ref(xg, w_h, reverse, stash)
        return lstm_recurrence_chunked_ref(xg, w_h, stash)
    if xg.device.type == "cuda":
        return _launch_fwd(xg, w_h, reverse, stash, resident)
    raise ValueError("the LSTM recurrence runs on cpu (plain version) or "
                     "cuda (kernel), got {}".format(xg.device))


def lstm_fwd(xg, w_h, reverse: bool = False, stash: bool = False):
    """K5f: (T,B,4H) gate inputs (data order) -> ys (T,B,H) in xg's dtype,
    plus the bf16 stashes (cs, gates) when ``stash``; w_h resident."""
    return _dispatch_fwd(xg, w_h, reverse, stash, True)


def lstm_fwd_chunked(xg, w_h, stash: bool = False):
    """K6f: as ``lstm_fwd`` in forward order, w_h streamed in chunks."""
    return _dispatch_fwd(xg, w_h, False, stash, False)


def _check_bwd(w_h, cs, gs, dy):
    if gs.dim() != 3 or gs.shape[-1] % 4:
        raise ValueError("gates must be (T,B,4H), got {}".format(
            tuple(gs.shape)))
    t, b, h4 = gs.shape
    hidden = h4 // 4
    for x in (gs, cs):
        if x.dtype != torch.bfloat16:
            raise TypeError("stashes must be bfloat16, got {}".format(x.dtype))
    for x in (cs, dy):
        if tuple(x.shape) != (t, b, hidden):
            raise ValueError("cs/dy must be {}, got {}".format(
                (t, b, hidden), tuple(x.shape)))
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("dy must be float32 or bfloat16, got {}".format(
            dy.dtype))
    if tuple(w_h.shape) != (hidden, h4):
        raise ValueError("w_h must be ({}, {}), got {}".format(
            hidden, h4, tuple(w_h.shape)))
    for x in (w_h, cs, dy):
        if x.device != gs.device:
            raise ValueError("all operands must be on {}, got {}".format(
                gs.device, x.device))


def _launch_bwd(w_h, cs, gs, dy, reverse: bool, resident: bool):
    global BWD_LAUNCHES, BWD_CHUNKED_LAUNCHES
    dev = gs.device
    t, b, h4 = gs.shape
    hidden = h4 // 4
    hp = _padded(hidden)
    if resident and _resident_units(hidden, dev) is None:
        raise ValueError(
            "w_h of H={} does not fit the grid's shared memory on {}: use "
            "lstm_recurrence_chunked".format(
                hidden, torch.cuda.get_device_name(dev)))
    lib = _bwd_library()
    gs_p = _pad_units(gs, hidden, hp, 4)
    cs_p = _pad_units(cs, hidden, hp, 1)
    dy_p = _pad_units(dy, hidden, hp, 1)
    dcbuf = torch.zeros(b, hp, dtype=torch.float32, device=dev)
    is_bf16 = int(dy.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if resident:
            wh = _pad_w(w_h, hidden, hp)
            dxg = torch.empty(t, b, 4 * hp, dtype=torch.bfloat16, device=dev)
            err = lib.lstm_bwd_resident(
                gs_p.data_ptr(), wh.data_ptr(), cs_p.data_ptr(),
                dy_p.data_ptr(), dxg.data_ptr(), dcbuf.data_ptr(), t, b, hp,
                int(reverse), is_bf16, stream)
        else:
            _, tiles_per_block, resident_ktiles = chunked_bwd_plan(hidden, b,
                                                                   dev)
            wp = pack_chunked_bwd_on_card(w_h, hp)
            dxg = torch.empty(t, b, 4 * hp, dtype=torch.float32, device=dev)
            # both buffers zeroed: buffer 0 is the first step's operand, and
            # rows beyond the batch are read every step
            xbuf = torch.zeros(2, -(-b // _BWD_CHUNKED_ROWS),
                               4 * hp // _TILE_K, _BWD_CHUNKED_ROWS, _TILE_K,
                               dtype=torch.bfloat16, device=dev)
            step_counter = torch.zeros(1, dtype=torch.int32, device=dev)
            err = lib.lstm_bwd_chunked(
                gs_p.data_ptr(), wp.data_ptr(), cs_p.data_ptr(),
                dy_p.data_ptr(), dxg.data_ptr(), xbuf.data_ptr(),
                dcbuf.data_ptr(), step_counter.data_ptr(), t, b, hp,
                tiles_per_block, resident_ktiles, is_bf16, stream)
    if err != 0:
        raise RuntimeError("lstm_bwd_{} launch failed: cudaError {}".format(
            "resident" if resident else "chunked", err))
    if resident:
        BWD_LAUNCHES += 1
    else:
        BWD_CHUNKED_LAUNCHES += 1
    return _unpad_units(dxg, hidden, hp, 4)


def _dispatch_bwd(w_h, cs, gs, dy, reverse, resident):
    _check_bwd(w_h, cs, gs, dy)
    if gs.device.type == "cpu":
        if resident:
            return lstm_recurrence_bwd_ref(w_h, cs, gs, dy, reverse)
        return lstm_recurrence_chunked_bwd_ref(w_h, cs, gs, dy)
    if gs.device.type == "cuda":
        return _launch_bwd(w_h, cs, gs, dy, reverse, resident)
    raise ValueError("the LSTM recurrence runs on cpu (plain version) or "
                     "cuda (kernel), got {}".format(gs.device))


def lstm_bwd(w_h, cs, gates, dy, reverse: bool = False):
    """K5b: output cotangents dy (T,B,H) and the forward's bf16 stashes ->
    gate cotangents dxg, bf16 (T,B,4H)."""
    return _dispatch_bwd(w_h, cs, gates, dy, reverse, True)


def lstm_bwd_chunked(w_h, cs, gates, dy):
    """K6b: as ``lstm_bwd`` in forward order with w_h streamed in chunks;
    dxg f32 (T,B,4H), unrounded."""
    return _dispatch_bwd(w_h, cs, gates, dy, False, False)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _dwh(ys_bf16, dxg_bf16, reverse: bool) -> torch.Tensor:
    """dW_h = sum_t h_prev[t]^T dxg[t]: bf16 values, f32 sums, one matmul.
    On the card the operands stay bf16 and the product is emitted in f32
    (``torch.mm(..., out_dtype=torch.float32)``, PyTorch 2.8 or later): the
    same products and f32 sums as an f32 matmul of the widened operands,
    which is what a CPU tensor gets, on the tensor cores."""
    yp = _shift_prev(ys_bf16, reverse).flatten(0, 1)
    dx = dxg_bf16.flatten(0, 1)
    if yp.is_cuda:
        return torch.mm(yp.t(), dx, out_dtype=torch.float32)
    return yp.float().t() @ dx.float()


class LSTMRecurrence(torch.autograd.Function):
    """``lstm_fwd`` with its hand-written backward, as the JAX custom_vjp
    (``lstm.py`` ``_make_recurrence``): the forward keeps the bf16 stashes
    and bf16 ys, the backward runs K5b and forms dW_h as one matmul of the
    shifted ys against the bf16 dxg."""

    @staticmethod
    def forward(ctx, xg, w_h, reverse):
        ys, cs, gs = lstm_fwd(xg, w_h, reverse, stash=True)
        ctx.save_for_backward(w_h, ys.to(torch.bfloat16), cs, gs)
        ctx.reverse = reverse
        return ys

    @staticmethod
    def backward(ctx, dy):
        w_h, ys, cs, gs = ctx.saved_tensors
        dxg = lstm_bwd(w_h, cs, gs, dy.contiguous(), ctx.reverse)
        # cotangents in each input's dtype (the primal xg is the ys/dy dtype)
        return (dxg.to(dy.dtype), _dwh(ys, dxg, ctx.reverse).to(w_h.dtype),
                None)


class LSTMRecurrenceChunked(torch.autograd.Function):
    """``lstm_fwd_chunked`` with its hand-written backward (the JAX
    ``lstm_recurrence_chunked`` custom_vjp): K6b's f32 dxg is rounded to bf16
    only as the operand of dW_h and to dy's dtype on return."""

    @staticmethod
    def forward(ctx, xg, w_h):
        ys, cs, gs = lstm_fwd_chunked(xg, w_h, stash=True)
        ctx.save_for_backward(w_h, ys.to(torch.bfloat16), cs, gs)
        return ys

    @staticmethod
    def backward(ctx, dy):
        w_h, ys, cs, gs = ctx.saved_tensors
        dxg = lstm_bwd_chunked(w_h, cs, gs, dy.contiguous())
        return (dxg.to(dy.dtype),
                _dwh(ys, dxg.to(torch.bfloat16), False).to(w_h.dtype))


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def lstm_recurrence(xg, w_h, reverse: bool = False) -> torch.Tensor:
    """LSTM recurrence with w_h resident: (T,B,4H) gate inputs + (H,4H)
    recurrent weights -> (T,B,H) hidden states in data order, zero initial
    state. ``reverse`` scans t = T-1..0 inside the kernel, no flips. Takes
    any H whose w_h fits (``fits_resident``)."""
    if _wants_grad(xg, w_h):
        return LSTMRecurrence.apply(xg, w_h, bool(reverse))
    return lstm_fwd(xg, w_h, bool(reverse))


def lstm_recurrence_chunked(xg, w_h) -> torch.Tensor:
    """LSTM recurrence with w_h streamed in chunks: the same contract as
    ``lstm_recurrence`` in forward order, for any H."""
    if _wants_grad(xg, w_h):
        return LSTMRecurrenceChunked.apply(xg, w_h)
    return lstm_fwd_chunked(xg, w_h)
