"""Single-direction LSTM recurrence, forward and backward (counterpart of
the TPU kernels behind ``lstm_recurrence`` and ``lstm_recurrence_chunked``
in e2e_asr_pytorch_tpu/ops/pallas/lstm.py).

Shared contract: the input pre-activations ``xg`` (T,B,4H) are computed
outside as one matmul in compute dtype; the carries h, c, dh, dc are f32; the
recurrent product is ``bf16(h) @ bf16(w_h)`` with f32 sums, gate order
i,f,g,o, zero initial state; dW_h is one product outside the kernel.

  K5f ``lstm_fwd``            w_h held on chip for the whole sequence;
                              ``reverse`` walks t = T-1..0 by indexing.
  K5b ``lstm_bwd``            its backward from the bf16 stashes; dxg bf16.
  K6f ``lstm_fwd_chunked``    the part of w_h that fits stays on chip, the
                              rest is streamed every step in chunks, the
                              partial gates accumulated; forward order only.
  K6b ``lstm_bwd_chunked``    as K6f, the part of w_h that fits stays on
                              chip; dxg f32, unrounded, only the product's
                              operand is bf16.

Each dispatches on the tensors' device: a CPU tensor goes to the plain
PyTorch version (``*_ref``), a CUDA tensor to a hand-written kernel (or
raises). ``LSTMRecurrence`` and ``LSTMRecurrenceChunked`` are the autograd
Functions over them, the same on either device; ``lstm_recurrence`` /
``lstm_recurrence_chunked`` are the public entry points and ``recurrence_fn``
picks between them.

K5f has two forms on the card, one rule (``form_for``) picks by batch:

  narrow  B <= 16, one m16 tile of rows (the single-direction listener):
          K1's resident kernel over one direction (csrc/bilstm_fwd.cu;
          ``reverse`` is the direction). A block owns 10 units (K1 takes 20
          for both directions; 10 measured faster for one) with their 40
          gate columns of w_h in shared memory, the product is split over k
          across its eight warps, one grid barrier a step.
  wide    B > 16 (the 4x LSTM-1024 LM's 128): K6f's kernel
          (csrc/lstm_fwd.cu: wgmma, bulk copies into mbarrier rings, the
          split grid barrier) with ``reverse`` as a time index map and
          tiles of 8 units (32 gate columns, the whole slab resident at
          H=1024), which measured faster here than K6f's 16.

K5b has one form at every batch: K6b's kernel (csrc/lstm_bwd.cu) with
K5's contract (the reversed time map, dxg stored in bf16) in tiles of 16
units x 64 rows. K2's resident kernel over one direction was measured
beside it at B=16 and B=8 and was the slower.

Which kernels a hidden size gets. On the TPU the rule was a VMEM size. Here
an H is K5's when K5f's narrow form can hold it: its H/10 blocks (H padded
to 80) fit the card's SMs, one each, and its slab (40 gate columns of H+8,
bf16) fits beside its ring in the shared memory a block may opt into (K5b
keeps what fits and streams the rest, at any H). Both numbers are read from the card
(``multi_processor_count``, ``shared_memory_per_block_optin``); on an H100
(132 SMs, 232,448 bytes) that is H <= 1280: the 4x LSTM-1024 LM and the
single-direction 1280 listener take K5, the 4x LSTM-2048 LM (208 blocks)
takes K6. The chunked kernels take any H and keep what they
can (``chunked_plan``, ``chunked_bwd_plan``): of each tile's slab, cut into
128-wide k-tiles, as many tiles stay in shared memory as the opt-in size
leaves beside the kernel's rings (K6 at H=2048 on an H100: 6 of 16 forward,
3 of 64 backward), and only the others are re-read from L2 every step.
Launches are counted per kernel and, for K5f, per form.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from e2e_asr_pytorch_tpu_torch.ops.kernels import build

# launches of the CUDA kernels in this process (the only global state):
# FWD_LAUNCHES counts K5f in either form, split by form into
# FWD_NARROW_LAUNCHES and FWD_WIDE_LAUNCHES; BWD_LAUNCHES counts K5b
FWD_LAUNCHES = 0
FWD_NARROW_LAUNCHES = 0
FWD_WIDE_LAUNCHES = 0
BWD_LAUNCHES = 0
FWD_CHUNKED_LAUNCHES = 0    # K6f
BWD_CHUNKED_LAUNCHES = 0    # K6b

FORMS = ("narrow", "wide")  # K5f's
NARROW_ROWS = 16  # the narrow form's batch: one m16 tile of rows

# k values per slice of the contraction in the plain chunked backward
CHUNK_K = 64
# H is padded to a multiple of 32 for the chunked backward (its k-tiles of
# 128 values over 4H)
_PAD_UNITS = 32
# the chunked kernels' geometry (csrc/lstm_fwd.cu, csrc/lstm_bwd.cu): w_h,
# the h exchange buffer and the dgates one are laid out in atoms of 64 k
# values (one 128-byte swizzle row); a k-tile, the unit of the kernels' rings
# and of residency, is two atoms. The forward's tile is U units (4U gate
# columns) for all rows, a k-tile of its slab 2 x 4U x 128 bytes, and H is
# padded to 128; a block's shared memory is 1 KB of alignment slack, a ring
# of three 32 KB k-tiles of h (128 rows), a ring of two streamed slab
# k-tiles and 1 KB of barriers, plus the resident k-tiles. The backward's
# tile is U units x 64 batch rows, a k-tile of its slab 2 x U x 128 bytes, of
# its dgates rows 16 KB; a block's shared memory is 1 KB of slack, a ring of
# eight stages (each a dgates and a slab k-tile), the two warpgroups' partial
# sums (128 x U/2 floats) and 1 KB of barriers, plus the resident k-tiles.
_TILE_K = 64
_K_TILE = 2 * _TILE_K
_H_TILE_BYTES = 2 * 128 * _K_TILE
_BWD_CHUNKED_ROWS = 64
_BWD_G_TILE_BYTES = 2 * _BWD_CHUNKED_ROWS * _K_TILE
# units a block of K5f's narrow form (K1's resident kernel over one
# direction; K1 takes 20 for both directions)
_NARROW_UNITS = 10
# units per tile: K6's, K5f's wide form's and K5b's
_CHUNKED_UNITS = 16
_BWD_CHUNKED_UNITS = 32
_WIDE_FWD_UNITS = 8
_WIDE_BWD_UNITS = 16
# what an H100 reports, used when the caller has no CUDA device to ask (the
# CPU tests) or the installed PyTorch does not expose the opt-in size
H100_SMS = 132
H100_SMEM_OPTIN = 232448


def w_tile_bytes(units: int) -> int:
    """Bytes of one k-tile of the chunked forward's slab of ``units``."""
    return 2 * 4 * units * _K_TILE


def chunked_fixed_bytes(units: int) -> int:
    """The chunked forward's shared memory a block before residents."""
    return 1024 + 3 * _H_TILE_BYTES + 2 * w_tile_bytes(units) + 1024


def bwd_w_tile_bytes(units: int) -> int:
    """Bytes of one k-tile of the chunked backward's slab of ``units``."""
    return 2 * units * _K_TILE


def bwd_chunked_fixed_bytes(units: int) -> int:
    """The chunked backward's shared memory a block before residents."""
    return (1024 + 8 * (_BWD_G_TILE_BYTES + bwd_w_tile_bytes(units))
            + 4 * 128 * (units // 2) + 1024)


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


def time_index(step: int, n_steps: int, reverse: bool,
               backward: bool = False) -> int:
    """The data index that step ``step`` of a walk handles, in the plain
    versions and the kernels alike: the forward scan takes t = s, or T-1-s
    with ``reverse`` (by indexing, no flips); the backward walks its forward
    scan's order from the end."""
    t = n_steps - 1 - step if reverse else step
    return n_steps - 1 - t if backward else t


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
        r = time_index(s, t, reverse)
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
        r = time_index(s, t, reverse, backward=True)
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
# which kernels a hidden size gets, and which form of K5 a batch gets
# ---------------------------------------------------------------------------

def _padded(hidden: int) -> int:
    """The chunked backward takes H in multiples of 32 (its k-tiles of 128
    over 4H); the wrappers pad with units whose weights and inputs are
    zero."""
    return -(-hidden // _PAD_UNITS) * _PAD_UNITS


def _card(device=None):
    """(SMs, shared memory a block may opt into) of ``device``; an H100's
    when there is no CUDA device to ask."""
    if device is None or torch.device(device).type != "cuda":
        return H100_SMS, H100_SMEM_OPTIN
    props = torch.cuda.get_device_properties(device)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", H100_SMEM_OPTIN))


def _narrow_refusal(hidden: int, device=None):
    """Why K5f's narrow form cannot hold w_h of this H on ``device`` (an
    H100 when there is no CUDA device to ask), or None when it can: one
    direction's tiles of _NARROW_UNITS, one a block, must fit the SMs, and
    each block's slab of K1's kernel with its ring the opt-in shared
    memory."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as KB
    n_sm, smem = _card(device)
    n_blocks = KB._padded(hidden) // _NARROW_UNITS
    if n_blocks > n_sm:
        return "its {} blocks of {} units outnumber the card's {} SMs".format(
            n_blocks, _NARROW_UNITS, n_sm)
    need = KB.resident_smem_bytes(hidden, _NARROW_UNITS)
    if need > smem:
        return ("a block's slab and ring take {} bytes of shared memory, the "
                "card offers {}".format(need, smem))
    return None


def fits_resident(hidden: int, device=None) -> bool:
    """Counterpart of the TPU package's ``_fits_vmem``: whether this H is
    K5's (K5f's narrow form holds w_h on this card), else K6's."""
    return _narrow_refusal(hidden, device) is None


def _refuse_unless_k5(hidden: int, device) -> None:
    """An H that K5 cannot hold is refused with the reason: it takes K6
    (``recurrence_fn``)."""
    why = _narrow_refusal(hidden, device)
    if why is not None:
        raise ValueError("w_h of H={} does not fit K5 on {}: {}; use "
                         "lstm_recurrence_chunked".format(
                             hidden, device or "an H100", why))


def form_for(hidden: int, batch: int, device=None) -> str:
    """The form of K5f a (T, ``batch``, 4H) stream gets on ``device`` (an
    H100 when there is no CUDA device to ask): "narrow" when the batch is
    one m16 tile of rows, "wide" above it. An H that K5 cannot hold is
    refused."""
    _refuse_unless_k5(hidden, device)
    return "narrow" if batch <= NARROW_ROWS else "wide"


def chunked_plan(hidden: int, device=None, units: int = _CHUNKED_UNITS):
    """How the chunked forward lays H out on ``device`` (an H100 when there
    is no CUDA device to ask) in tiles of ``units`` (K6f's 16 by default):
    (padded H, tiles a block owns, k-tiles of each that stay resident in
    shared memory). The resident share is what the card's opt-in shared
    memory leaves beside the kernel's rings."""
    n_sm, smem = _card(device)
    hp = -(-hidden // _K_TILE) * _K_TILE
    n_tiles = hp // units
    tiles_per_block = -(-n_tiles // n_sm)
    room = smem - chunked_fixed_bytes(units)
    if room < 0:
        raise ValueError("the chunked LSTM forward needs {} bytes of shared "
                         "memory a block, the card offers {}".format(
                             chunked_fixed_bytes(units), smem))
    resident = min(hp // _K_TILE,
                   room // (w_tile_bytes(units) * tiles_per_block))
    return hp, tiles_per_block, resident


def chunked_smem_bytes(hidden: int, device=None,
                       units: int = _CHUNKED_UNITS) -> int:
    """Shared memory of one block of the chunked forward."""
    _, tiles_per_block, resident = chunked_plan(hidden, device, units)
    return (chunked_fixed_bytes(units)
            + tiles_per_block * resident * w_tile_bytes(units))


def chunked_resident_share(hidden: int, device=None,
                           units: int = _CHUNKED_UNITS) -> float:
    """The share of w_h that the chunked forward never re-reads."""
    hp, _, resident = chunked_plan(hidden, device, units)
    return resident / (hp // _K_TILE)


def chunked_bwd_plan(hidden: int, batch: int, device=None,
                     units: int = _BWD_CHUNKED_UNITS):
    """How the chunked backward lays H out on ``device`` (an H100 when there
    is no CUDA device to ask) in tiles of ``units`` (K6b's 32 by default) x
    64 rows: (padded H, tiles a block owns, k-tiles of each tile's slab that
    stay resident in shared memory). The resident share is what the card's
    opt-in shared memory leaves beside the kernel's rings."""
    n_sm, smem = _card(device)
    hp = _padded(hidden)
    n_tiles = (hp // units) * -(-batch // _BWD_CHUNKED_ROWS)
    tiles_per_block = -(-n_tiles // n_sm)
    room = smem - bwd_chunked_fixed_bytes(units)
    if room < 0:
        raise ValueError("the chunked LSTM backward needs {} bytes of shared "
                         "memory a block, the card offers {}".format(
                             bwd_chunked_fixed_bytes(units), smem))
    resident = min(4 * hp // _K_TILE,
                   room // (bwd_w_tile_bytes(units) * tiles_per_block))
    return hp, tiles_per_block, resident


def chunked_bwd_smem_bytes(hidden: int, batch: int, device=None,
                           units: int = _BWD_CHUNKED_UNITS) -> int:
    """Shared memory of one block of the chunked backward."""
    _, tiles_per_block, resident = chunked_bwd_plan(hidden, batch, device,
                                                    units)
    return (bwd_chunked_fixed_bytes(units)
            + tiles_per_block * resident * bwd_w_tile_bytes(units))


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


def pack_chunked(w_h: torch.Tensor, hp: int,
                 units: int = _CHUNKED_UNITS) -> torch.Tensor:
    """The chunked forward's operand for tiles of ``units``, (Hp/units,
    Hp/64, 4*units, 64) bf16: tile, k-tile atom, gate column g*units + j
    (column g*H + units*tile + j of w_h), then that column's 64 k values
    with their 8-value chunks swizzled by the column's row, so that one
    contiguous copy of a k-tile lands it as the tensor cores read it."""
    hidden = w_h.shape[0]
    n_tiles, n_kt = hp // units, hp // _TILE_K
    w = (_pad_w(w_h, hidden, hp).reshape(n_kt, _TILE_K, 4, n_tiles, units)
         .permute(3, 0, 2, 4, 1)                  # tile, kt, g, j, k
         .reshape(n_tiles, n_kt, 4 * units, _TILE_K))
    return _swizzle_atoms(w).contiguous()


def pack_chunked_on_card(w_h: torch.Tensor, hp: int,
                         units: int = _CHUNKED_UNITS) -> torch.Tensor:
    """``pack_chunked`` by the small kernel beside the recurrence (one pass
    over w_h where the indexing above makes three): what the wrapper calls
    on a CUDA tensor."""
    hidden = w_h.shape[0]
    if w_h.dtype not in (torch.float32, torch.bfloat16):
        w_h = w_h.float()
    w_h = w_h.contiguous()
    wp = torch.empty(hp // units, hp // _TILE_K, 4 * units, _TILE_K,
                     dtype=torch.bfloat16, device=w_h.device)
    with torch.cuda.device(w_h.device):
        err = _fwd_library().lstm_pack_chunked(
            w_h.data_ptr(), wp.data_ptr(), hidden, hp, units,
            int(w_h.dtype == torch.bfloat16),
            torch.cuda.current_stream(w_h.device).cuda_stream)
    if err != 0:
        raise RuntimeError("lstm_pack_chunked launch failed: cudaError {}"
                           .format(err))
    return wp


def pack_chunked_bwd(w_h: torch.Tensor, hp: int,
                     units: int = _BWD_CHUNKED_UNITS) -> torch.Tensor:
    """The chunked backward's operand for tiles of ``units``, (Hp/units,
    4Hp/64, units, 64) bf16: unit tile, atom, row j of the tile (row
    units*tile + j of w_h), that row's 64 k values of the atom with their
    8-value chunks swizzled by j, so that one contiguous copy of a k-tile
    (two atoms) lands it as the tensor cores read it. No transposition: w_h's
    rows are k-contiguous already."""
    hidden = w_h.shape[0]
    n_ut, n_atoms = hp // units, 4 * hp // _TILE_K
    w = (_pad_w(w_h, hidden, hp).reshape(n_ut, units, n_atoms, _TILE_K)
         .permute(0, 2, 1, 3))                    # tile, atom, j, k
    return _swizzle_atoms(w).contiguous()


def pack_chunked_bwd_on_card(w_h: torch.Tensor, hp: int,
                             units: int = _BWD_CHUNKED_UNITS) -> torch.Tensor:
    """``pack_chunked_bwd`` by the small kernel beside the chunked backward
    (one pass over w_h): what the wrapper calls on a CUDA tensor."""
    hidden = w_h.shape[0]
    if w_h.dtype not in (torch.float32, torch.bfloat16):
        w_h = w_h.float()
    w_h = w_h.contiguous()
    wp = torch.empty(hp // units, 4 * hp // _TILE_K, units, _TILE_K,
                     dtype=torch.bfloat16, device=w_h.device)
    with torch.cuda.device(w_h.device):
        err = _bwd_library().lstm_pack_chunked_bwd(
            w_h.data_ptr(), wp.data_ptr(), hidden, hp, units,
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
    """Pick the recurrence for this hidden size: K5 when it holds w_h
    (``fits_resident``), K6 otherwise."""
    return (lstm_recurrence if fits_resident(hidden, device)
            else lstm_recurrence_chunked)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _fwd_library():
    lib = build.load("lstm_fwd")
    lib.lstm_fwd_chunked.argtypes = ([ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.lstm_fwd_chunked.restype = ctypes.c_int
    lib.lstm_pack_chunked.argtypes = ([ctypes.c_void_p] * 2
                                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.lstm_pack_chunked.restype = ctypes.c_int
    return lib


def _bwd_library():
    lib = build.load("lstm_bwd")
    lib.lstm_bwd_chunked.argtypes = ([ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.lstm_bwd_chunked.restype = ctypes.c_int
    lib.lstm_pack_chunked_bwd.argtypes = ([ctypes.c_void_p] * 2
                                          + [ctypes.c_int] * 4
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


def _launch_fwd(xg, w_h, reverse: bool, stash: bool, kernel: str):
    """One launch of K5f in its ``kernel`` form ("narrow", "wide") or of K6f
    ("chunked")."""
    global FWD_LAUNCHES, FWD_NARROW_LAUNCHES, FWD_WIDE_LAUNCHES
    global FWD_CHUNKED_LAUNCHES
    dev = xg.device
    t, b, h4 = xg.shape
    hidden = h4 // 4
    if kernel == "narrow":
        from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as KB
        hp = KB._padded(hidden)
        wp = KB.pack_resident(w_h, _NARROW_UNITS)
        # one direction's two exchange buffers
        hbuf = torch.zeros(1, 2, b, hp, dtype=torch.bfloat16, device=dev)
    else:
        units = _WIDE_FWD_UNITS if kernel == "wide" else _CHUNKED_UNITS
        hp, tiles_per_block, resident_ktiles = chunked_plan(hidden, dev,
                                                            units)
        wp = pack_chunked_on_card(w_h, hp, units)
        # 128 rows a pass whatever the batch, in the kernel's tiled layout
        hbuf = torch.zeros(2, -(-b // 128), hp // _TILE_K, 128, _TILE_K,
                           dtype=torch.bfloat16, device=dev)
        step_counter = torch.zeros(1, dtype=torch.int32, device=dev)
    xg_p = _pad_units(xg, hidden, hp, 4)
    ys = torch.empty(t, b, hp, dtype=xg.dtype, device=dev)
    cs = gs = None
    if stash:
        cs = torch.empty(t, b, hp, dtype=torch.bfloat16, device=dev)
        gs = torch.empty(t, b, 4 * hp, dtype=torch.bfloat16, device=dev)
    cs_ptr, gs_ptr = (x.data_ptr() if stash else None for x in (cs, gs))
    cbuf = torch.zeros(b, hp, dtype=torch.float32, device=dev)
    is_bf16 = int(xg.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel == "narrow":
            # K1's forward direction walks t = s and its backward one
            # t = T-1-s: the scan, plain or reversed, is that one direction
            # alone, its pointers in both directions' places
            p = [x.data_ptr() for x in (xg_p, wp, ys)]
            err = KB._library().bilstm_fwd_resident(
                p[0], p[0], p[1], p[1], p[2], p[2], cs_ptr, cs_ptr, gs_ptr,
                gs_ptr, hbuf.data_ptr(), cbuf.data_ptr(), t, b, hp,
                int(reverse), 1, _NARROW_UNITS, is_bf16, stream)
        else:
            err = _fwd_library().lstm_fwd_chunked(
                xg_p.data_ptr(), wp.data_ptr(), ys.data_ptr(), cs_ptr, gs_ptr,
                hbuf.data_ptr(), cbuf.data_ptr(), step_counter.data_ptr(), t,
                b, hp, tiles_per_block, resident_ktiles, int(reverse), units,
                is_bf16, stream)
    if err != 0:
        raise RuntimeError("lstm_fwd ({}) launch failed: cudaError {}".format(
            kernel, err))
    if kernel == "chunked":
        FWD_CHUNKED_LAUNCHES += 1
    else:
        FWD_LAUNCHES += 1
        if kernel == "narrow":
            FWD_NARROW_LAUNCHES += 1
        else:
            FWD_WIDE_LAUNCHES += 1
    ys = _unpad_units(ys, hidden, hp, 1)
    if stash:
        return (ys, _unpad_units(cs, hidden, hp, 1),
                _unpad_units(gs, hidden, hp, 4))
    return ys


def lstm_fwd(xg, w_h, reverse: bool = False, stash: bool = False):
    """K5f: (T,B,4H) gate inputs (data order) -> ys (T,B,H) in xg's dtype,
    plus the bf16 stashes (cs, gates) when ``stash``; w_h held on chip. A
    CUDA tensor takes the kernel in ``form_for``'s form, a CPU tensor the
    plain version."""
    _check_fwd(xg, w_h)
    if xg.device.type == "cpu":
        return lstm_recurrence_ref(xg, w_h, reverse, stash)
    if xg.device.type == "cuda":
        kernel = form_for(xg.shape[-1] // 4, xg.shape[1], xg.device)
        return _launch_fwd(xg, w_h, reverse, stash, kernel)
    raise ValueError("the LSTM recurrence runs on cpu (plain version) or "
                     "cuda (kernel), got {}".format(xg.device))


def lstm_fwd_chunked(xg, w_h, stash: bool = False):
    """K6f: as ``lstm_fwd`` in forward order, w_h streamed in chunks."""
    _check_fwd(xg, w_h)
    if xg.device.type == "cpu":
        return lstm_recurrence_chunked_ref(xg, w_h, stash)
    if xg.device.type == "cuda":
        return _launch_fwd(xg, w_h, False, stash, "chunked")
    raise ValueError("the LSTM recurrence runs on cpu (plain version) or "
                     "cuda (kernel), got {}".format(xg.device))


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


def _launch_bwd(w_h, cs, gs, dy, reverse: bool, k5: bool):
    """One launch of K5b (``k5``) or of K6b: the same kernel in other tiles,
    K5b's dxg bf16, K6b's f32."""
    global BWD_LAUNCHES, BWD_CHUNKED_LAUNCHES
    dev = gs.device
    t, b, h4 = gs.shape
    hidden = h4 // 4
    hp = _padded(hidden)
    units = _WIDE_BWD_UNITS if k5 else _BWD_CHUNKED_UNITS
    gs_p = _pad_units(gs, hidden, hp, 4)
    cs_p = _pad_units(cs, hidden, hp, 1)
    dy_p = _pad_units(dy, hidden, hp, 1)
    dcbuf = torch.zeros(b, hp, dtype=torch.float32, device=dev)
    is_bf16 = int(dy.dtype == torch.bfloat16)
    _, tiles_per_block, resident_ktiles = chunked_bwd_plan(hidden, b, dev,
                                                           units)
    wp = pack_chunked_bwd_on_card(w_h, hp, units)
    dxg = torch.empty(t, b, 4 * hp, device=dev,
                      dtype=torch.bfloat16 if k5 else torch.float32)
    # both buffers zeroed: buffer 0 is the first step's operand, and rows
    # beyond the batch are read every step
    xbuf = torch.zeros(2, -(-b // _BWD_CHUNKED_ROWS), 4 * hp // _TILE_K,
                       _BWD_CHUNKED_ROWS, _TILE_K, dtype=torch.bfloat16,
                       device=dev)
    step_counter = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _bwd_library().lstm_bwd_chunked(
            gs_p.data_ptr(), wp.data_ptr(), cs_p.data_ptr(), dy_p.data_ptr(),
            dxg.data_ptr(), xbuf.data_ptr(), dcbuf.data_ptr(),
            step_counter.data_ptr(), t, b, hp, tiles_per_block,
            resident_ktiles, int(reverse), units, is_bf16, int(k5),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("lstm_bwd{} launch failed: cudaError {}".format(
            "" if k5 else "_chunked", err))
    if k5:
        BWD_LAUNCHES += 1
    else:
        BWD_CHUNKED_LAUNCHES += 1
    return _unpad_units(dxg, hidden, hp, 4)


def lstm_bwd(w_h, cs, gates, dy, reverse: bool = False):
    """K5b: output cotangents dy (T,B,H) and the forward's bf16 stashes ->
    gate cotangents dxg, bf16 (T,B,4H). A CUDA tensor takes the kernel, a
    CPU tensor the plain version."""
    _check_bwd(w_h, cs, gates, dy)
    if gates.device.type == "cpu":
        return lstm_recurrence_bwd_ref(w_h, cs, gates, dy, reverse)
    if gates.device.type == "cuda":
        _refuse_unless_k5(gates.shape[-1] // 4, gates.device)
        return _launch_bwd(w_h, cs, gates, dy, reverse, True)
    raise ValueError("the LSTM recurrence runs on cpu (plain version) or "
                     "cuda (kernel), got {}".format(gates.device))


def lstm_bwd_chunked(w_h, cs, gates, dy):
    """K6b: as ``lstm_bwd`` in forward order with w_h streamed in chunks;
    dxg f32 (T,B,4H), unrounded."""
    _check_bwd(w_h, cs, gates, dy)
    if gates.device.type == "cpu":
        return lstm_recurrence_chunked_bwd_ref(w_h, cs, gates, dy)
    if gates.device.type == "cuda":
        return _launch_bwd(w_h, cs, gates, dy, False, False)
    raise ValueError("the LSTM recurrence runs on cpu (plain version) or "
                     "cuda (kernel), got {}".format(gates.device))


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
