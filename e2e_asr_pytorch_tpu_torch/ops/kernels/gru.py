"""GRU recurrence, forward and backward (counterpart of the TPU kernels
behind ``gru_recurrence`` in e2e_asr_pytorch_tpu/ops/pallas/gru.py).

Contract: the input pre-activations ``xg`` (T,B,3H) = x @ W_x + b_x are
computed outside in compute dtype, gate order r,z,n; ``w_h`` (H,3H) is cast
to bf16 whatever the compute dtype; ``b_h`` (3H,) is f32 and its n part sits
inside the r gate: n = tanh(xg_n + r * (h @ w_h + b_h)_n). The carry h is
f32 from a zero state; the recurrent product is ``bf16(h) @ bf16(w_h)`` with
f32 sums.

  K7f ``gru_fwd``   ys (T,B,H) in xg's dtype plus, when asked, the bf16 stash
                    of hg = h_prev @ w_h + b_h; ``reverse`` walks t = T-1..0
                    by indexing.
  K7b ``gru_bwd``   from xg, that stash and the bf16 hidden stream: dxg
                    (T,B,3H) in xg's dtype = [dxr,dxz,dxn] and dhg (T,B,3H)
                    f32 = [dxr,dxz,dxn*r]; the carry's product takes
                    bf16(dhg).

Each dispatches on the tensors' device: a CPU tensor goes to the plain
PyTorch version (``*_ref``), a CUDA tensor to the hand-written kernel in
``csrc/gru.cu`` (or raises). ``GRURecurrence`` is the autograd Function over
them, the same on either device, with dW_h = ys_prev^T bf16(dhg) and db_h =
sum dhg formed outside the kernel; ``gru_recurrence`` is the entry point.
``gru_fwd_pair`` / ``gru_bwd_pair`` / ``BiGRURecurrence`` /
``bigru_recurrence`` are the same for both directions of a bidirectional
layer at once; on CPU tensors they are the two plain single-direction
versions.

K7f and K7b each have two forms on the card (``csrc/gru_common.cuh``), one
rule (``form_for``, with ``backward=True`` for K7b) picks:

  packed  both directions of a bidirectional layer in ONE launch, 20 units
          a block (2 * H/20 blocks, H padded to 80), one grid barrier a
          step for both directions. The forward keeps the NG*20 gate columns
          padded to whole n-tiles (GRU 64, light GRU 40) resident, the
          backward its 20 rows of w_h as they are (20 x (NG*H + 8) bf16);
          taken where the layer is bidirectional, the 2 * ceil(H/20) blocks
          fit the card's SMs and the form's slab with its ring a block's
          shared memory: H <= 1280 on an H100, the flagship's width.
  single  one direction a launch, 16 units a block: a unidirectional layer,
          and a bidirectional one above the packed form's limit (two
          launches).

Which hidden sizes get the kernels at all (``fits``). On the TPU the rule
was a VMEM size. Here every block keeps its slab of w_h in shared memory for
the whole sequence, one tile per block and one block per SM, so the single
form and the backward take H when (a) ceil(H/16) tiles fit the card's SMs
and (b) the forward's block (the 3*16 x (H+8) bf16 slab, the cp.async ring
and the eight warps' partial products) and the backward's (16 x (3H+8)
bf16, ring, partials) fit the shared memory a block may opt into. On an
H100 (132 SMs, 232,448 bytes) that is H <= 1792 for the GRU (the flagship's
1280: 80 blocks of 182 KB) and H <= 2112 for the light GRU; above it the
layer takes the plain loop with autograd (``ops/rnn.py``). Launches are
counted per kernel and per form.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from e2e_asr_pytorch_tpu_torch.ops.kernels import build
from e2e_asr_pytorch_tpu_torch.ops.kernels.lstm import (_card, _dwh,
                                                        _pad_units,
                                                        _shift_prev,
                                                        _unpad_units,
                                                        _wants_grad)

# launches of the CUDA kernels in this process (the only global state):
# FWD_LAUNCHES counts K7f in either form (a packed launch walks both
# directions of a layer), split by form into FWD_PACKED_LAUNCHES and
# FWD_SINGLE_LAUNCHES; BWD_LAUNCHES counts K7b likewise, split into
# BWD_PACKED_LAUNCHES and BWD_SINGLE_LAUNCHES
FWD_LAUNCHES = 0
FWD_PACKED_LAUNCHES = 0
FWD_SINGLE_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_PACKED_LAUNCHES = 0
BWD_SINGLE_LAUNCHES = 0

N_GATES = 3
FORMS = ("packed", "single")  # K7f's, K7b's, K8f's and K8b's
# the kernels' geometry (csrc/gru_common.cuh): hidden units per block of the
# single form, and the bytes of its 4-stage cp.async ring of 16 rows x
# (256 + 8) bf16; the packed form's units per block, the multiple of H it
# takes (its tile and an mma k step), the forward's 3-stage ring and the
# backward's 4-stage ring of 16 rows x (512 + 8) bf16
TILE_UNITS = 16
_RING_BYTES = 2 * 4 * 16 * (256 + 8)
_WARPS = 8
PACKED_UNITS = 20
_PACKED_PAD = 80
_PACKED_RING_BYTES = 2 * 3 * 16 * (256 + 8)
_PACKED_BWD_RING_BYTES = 2 * 4 * 16 * (512 + 8)


def _h_operand(h: torch.Tensor) -> torch.Tensor:
    """bf16(h), the recurrent matmul's left operand, held exactly in f32."""
    return h.to(torch.bfloat16).float()


def _dg_operand(dhg: torch.Tensor) -> torch.Tensor:
    """bf16(dhg), the backward recurrent matmul's left operand, rounded from
    the f32 value and held exactly in f32."""
    return dhg.to(torch.bfloat16).float()


def _gates(xg: torch.Tensor, hg: torch.Tensor, hidden: int):
    r = torch.sigmoid(xg[..., :hidden] + hg[..., :hidden])
    z = torch.sigmoid(xg[..., hidden:2 * hidden] + hg[..., hidden:2 * hidden])
    n = torch.tanh(xg[..., 2 * hidden:] + r * hg[..., 2 * hidden:])
    return r, z, n


def gru_recurrence_ref(xg, w_h, b_h, reverse: bool = False,
                       stash: bool = False):
    """Plain PyTorch version of K7f with the kernel's numerics (bf16
    products exact in f32, f32 sums, f32 carry). Returns ys (T,B,H) in xg's
    dtype, plus the bf16 stash hgs (T,B,3H), b_h included, when ``stash``."""
    t, b, h3 = xg.shape
    hidden = h3 // 3
    wh = w_h.to(torch.bfloat16).float()
    bh = b_h.float()
    h = torch.zeros(b, hidden, dtype=torch.float32, device=xg.device)
    ys = torch.empty(t, b, hidden, dtype=xg.dtype, device=xg.device)
    hgs = (torch.empty(t, b, h3, dtype=torch.bfloat16, device=xg.device)
           if stash else None)
    for s in range(t):
        i = t - 1 - s if reverse else s
        hg = _h_operand(h) @ wh + bh
        _, z, n = _gates(xg[i].float(), hg, hidden)
        h = (1.0 - z) * n + z * h
        ys[i] = h
        if stash:
            hgs[i] = hg
    return (ys, hgs) if stash else ys


def gru_recurrence_bwd_ref(xg, w_h, hgs, ys, dy, reverse: bool = False,
                           swap_n_slot: bool = False):
    """Plain PyTorch version of K7b: the gates re-formed from xg and the
    bf16 stash, h_prev from the bf16 hidden stream ``ys`` one scan step
    earlier. Returns (dxg (T,B,3H) in xg's dtype, dhg (T,B,3H) f32).
    ``swap_n_slot`` plants the fault of sending dxn where dxn*r belongs (and
    back), for the checks that must catch it."""
    t, b, h3 = xg.shape
    hidden = h3 // 3
    dev = xg.device
    wht = w_h.to(torch.bfloat16).float().t().contiguous()
    hps = _shift_prev(ys.to(torch.bfloat16), reverse)
    dxg = torch.empty(t, b, h3, dtype=xg.dtype, device=dev)
    dhg = torch.empty(t, b, h3, dtype=torch.float32, device=dev)
    carry = torch.zeros(b, hidden, dtype=torch.float32, device=dev)
    for s in range(t):
        i = s if reverse else t - 1 - s
        hg = hgs[i].float()
        r, z, n = _gates(xg[i].float(), hg, hidden)
        dh = dy[i].float() + carry
        dz = dh * (hps[i].float() - n)
        dxn = dh * (1.0 - z) * (1.0 - n * n)
        dxr = dxn * hg[:, 2 * hidden:] * r * (1.0 - r)
        dxz = dz * z * (1.0 - z)
        for_x, for_h = dxn, dxn * r
        if swap_n_slot:
            for_x, for_h = for_h, for_x
        dxg[i] = torch.cat([dxr, dxz, for_x], dim=-1)
        dhg_i = torch.cat([dxr, dxz, for_h], dim=-1)
        dhg[i] = dhg_i
        carry = dh * z + _dg_operand(dhg_i) @ wht
    return dxg, dhg


# ---------------------------------------------------------------------------
# which hidden sizes get the kernel
# ---------------------------------------------------------------------------

def _padded(hidden: int) -> int:
    """The kernels take H in multiples of 16 (a block's unit tile, and an
    mma k step); the wrappers pad with units whose weights, biases and inputs
    are zero, which stay at h = 0."""
    return -(-hidden // TILE_UNITS) * TILE_UNITS


def block_smem_bytes(n_gates: int, hidden: int):
    """(forward, backward) shared memory of one block at padded H, as
    ``fwd_smem_bytes`` / ``bwd_smem_bytes`` of csrc/gru_common.cuh."""
    hp = _padded(hidden)
    nc = n_gates * TILE_UNITS
    fwd = 2 * nc * (hp + 8) + _RING_BYTES + 4 * _WARPS * 16 * nc
    bwd = (2 * TILE_UNITS * (n_gates * hp + 8) + _RING_BYTES
           + 4 * _WARPS * 16 * TILE_UNITS)
    return fwd, bwd


def recurrence_fits(n_gates: int, hidden: int, device=None) -> bool:
    """Whether a recurrence of ``n_gates`` gate blocks at this H can keep
    w_h on chip on ``device`` (an H100 when there is no CUDA device to ask):
    one 16-unit tile per block, one block per SM, both blocks within the
    opt-in shared memory."""
    n_sm, smem = _card(device)
    return (_padded(hidden) // TILE_UNITS <= n_sm
            and max(block_smem_bytes(n_gates, hidden)) <= smem)


def fits(hidden: int, device=None) -> bool:
    """Counterpart of the TPU package's ``gru_fits_vmem``, from this card's
    SM count and shared memory: H <= 1792 on an H100. Above it the layer
    runs as a plain loop under autograd."""
    return recurrence_fits(N_GATES, hidden, device)


def _padded_packed(hidden: int) -> int:
    """The packed form takes H in multiples of 80 (its 20-unit tile and an
    mma k step); the wrappers pad with zero units, which stay at h = 0."""
    return -(-hidden // _PACKED_PAD) * _PACKED_PAD


def packed_cols(n_gates: int) -> int:
    """Gate columns of a packed block's slab: n_gates * 20 padded to whole
    n-tiles of 8 (GRU 64, light GRU 40)."""
    return -(-n_gates * PACKED_UNITS // 8) * 8


def packed_smem_bytes(n_gates: int, hidden: int) -> int:
    """Shared memory of one block of the packed form at padded H
    (``packed_smem_bytes`` of csrc/gru_common.cuh): the slab and the ring,
    which the partial tiles overlay."""
    return (2 * packed_cols(n_gates) * (_padded_packed(hidden) + 8)
            + _PACKED_RING_BYTES)


def packed_bwd_smem_bytes(n_gates: int, hidden: int) -> int:
    """Shared memory of one block of the packed backward at padded H
    (``packed_bwd_smem_bytes`` of csrc/gru_common.cuh): its 20 rows of w_h,
    each n_gates * H + 8 bf16, and the ring, which the partial tiles
    overlay."""
    return (2 * PACKED_UNITS * (n_gates * _padded_packed(hidden) + 8)
            + _PACKED_BWD_RING_BYTES)


def recurrence_form(n_gates: int, hidden: int, bidirectional: bool,
                    device=None, backward: bool = False) -> str:
    """The form of the forward (with ``backward``, of the backward) a layer
    of ``n_gates`` gate blocks gets on ``device`` (an H100 when there is no
    CUDA device to ask): "packed" when it is bidirectional, both
    directions' 20-unit tiles fit the card's SMs one a block and that
    form's slab with its ring fits a block's shared memory; else "single".
    An H that ``recurrence_fits`` refuses is refused."""
    n_sm, smem = _card(device)
    if not recurrence_fits(n_gates, hidden, device):
        raise ValueError("w_h of H={} does not fit the kernels on {}: the "
                         "layer takes the plain loop".format(
                             hidden, device or "an H100"))
    need = (packed_bwd_smem_bytes if backward else packed_smem_bytes)(
        n_gates, hidden)
    if (bidirectional
            and 2 * (_padded_packed(hidden) // PACKED_UNITS) <= n_sm
            and need <= smem):
        return "packed"
    return "single"


def form_for(hidden: int, bidirectional: bool, device=None,
             backward: bool = False) -> str:
    """The form of K7f (with ``backward``, of K7b) a GRU layer of this H
    gets (``recurrence_form``): "packed" for a bidirectional layer up to
    H = 1280 on an H100."""
    return recurrence_form(N_GATES, hidden, bidirectional, device, backward)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _library():
    lib = build.load("gru")
    lib.gru_fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                            + [ctypes.c_void_p])
    lib.gru_fwd.restype = ctypes.c_int
    lib.gru_fwd_packed.argtypes = ([ctypes.c_void_p] * 10
                                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.gru_fwd_packed.restype = ctypes.c_int
    lib.gru_bwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                            + [ctypes.c_void_p])
    lib.gru_bwd.restype = ctypes.c_int
    lib.gru_bwd_packed.argtypes = ([ctypes.c_void_p] * 16
                                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.gru_bwd_packed.restype = ctypes.c_int
    return lib


def pad_w(w_h: torch.Tensor, hidden: int, hp: int, n_gates: int):
    """(H,G*H) -> bf16 (Hp,G*Hp) with zero rows and columns for the padding:
    the backward kernel's operand as it is."""
    w = _pad_units(w_h.to(torch.bfloat16), hidden, hp, n_gates)
    return F.pad(w, (0, 0, 0, hp - hidden)).contiguous()


def pack_w(w_h: torch.Tensor, hidden: int, hp: int, n_gates: int):
    """The forward kernel's operand, (Hp/16, G*16, Hp) bf16: per tile, row
    g*16 + j holds the Hp weights of gate g of unit 16*tile + j."""
    return (pad_w(w_h, hidden, hp, n_gates)
            .reshape(hp, n_gates, hp // TILE_UNITS, TILE_UNITS)
            .permute(2, 1, 3, 0)
            .reshape(hp // TILE_UNITS, n_gates * TILE_UNITS, hp)
            .contiguous())  # one tile reshapes to a view: the kernel reads
                            # the memory


def pack_w_pair(wh_f: torch.Tensor, wh_b: torch.Tensor, n_gates: int):
    """The packed form's operand, (2, Hp/20, C, Hp) bf16 with H padded to a
    multiple of 80 and C = ``packed_cols``: per direction (forward, then
    backward) and tile, row g*20 + j holds the Hp weights of gate g of unit
    20*tile + j of that direction's w_h (its column g*H + 20*tile + j), k
    contiguous; rows n_gates*20 .. C-1 are zero. One cast and one permuted
    copy a direction, straight into the operand."""
    hidden = wh_f.shape[0]
    hp = _padded_packed(hidden)
    u = PACKED_UNITS
    out = torch.empty(2, hp // u, packed_cols(n_gates), hp,
                      dtype=torch.bfloat16, device=wh_f.device)
    out[:, :, n_gates * u:].zero_()
    for d, w_h in enumerate((wh_f, wh_b)):
        w = (w_h.to(torch.bfloat16) if hp == hidden
             else pad_w(w_h, hidden, hp, n_gates))
        out[d, :, :n_gates * u].unflatten(1, (n_gates, u)).copy_(
            w.reshape(hp, n_gates, hp // u, u).permute(2, 1, 3, 0))
    return out


def check_streams(name: str, n_gates: int, xg, w_h, *same_device):
    if xg.dim() != 3 or xg.shape[-1] % n_gates:
        raise ValueError("xg must be (T,B,{}H), got {}".format(
            n_gates, tuple(xg.shape)))
    t, b, gh = xg.shape
    if xg.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("xg must be float32 or bfloat16, got {}".format(
            xg.dtype))
    if tuple(w_h.shape) != (gh // n_gates, gh):
        raise ValueError("w_h must be ({}, {}), got {}".format(
            gh // n_gates, gh, tuple(w_h.shape)))
    if t < 1 or b < 1:
        raise ValueError("empty sequence or batch: {}".format(
            tuple(xg.shape)))
    for x in (w_h, *same_device):
        if x.device != xg.device:
            raise ValueError("xg on {} but an operand on {}".format(
                xg.device, x.device))
    if xg.device.type not in ("cpu", "cuda"):
        raise ValueError("the {} recurrence runs on cpu (plain version) or "
                         "cuda (kernel), got {}".format(name, xg.device))


def check_bwd_streams(n_gates: int, xg, hgs, ys, dy):
    t, b, gh = xg.shape
    hidden = gh // n_gates
    if hgs.dtype != torch.bfloat16 or tuple(hgs.shape) != (t, b, gh):
        raise ValueError("the stash must be bfloat16 {}, got {} {}".format(
            (t, b, gh), hgs.dtype, tuple(hgs.shape)))
    if ys.dtype != torch.bfloat16:
        raise TypeError("ys must be bfloat16, got {}".format(ys.dtype))
    for x in (ys, dy):
        if tuple(x.shape) != (t, b, hidden):
            raise ValueError("ys/dy must be {}, got {}".format(
                (t, b, hidden), tuple(x.shape)))
    if dy.dtype != xg.dtype:
        raise TypeError("dy must have xg's dtype {}, got {}".format(
            xg.dtype, dy.dtype))


def require_fit(name: str, n_gates: int, hidden: int, dev):
    if not recurrence_fits(n_gates, hidden, dev):
        raise ValueError(
            "w_h of H={} does not fit the grid's shared memory on {}: the "
            "{} layer takes the plain loop there".format(
                hidden, torch.cuda.get_device_name(dev), name))


def launch_fwd(lib, symbol: str, what: str, n_gates: int, xg, w_h, small,
               small_gates: int, reverse: bool, stash: bool):
    """One launch of a forward kernel of this family (``lib.<symbol>``): pads
    H to the tile, packs w_h, allocates the outputs and the h exchange
    buffers. ``small`` is the family's small f32 operand, ``small_gates``
    blocks of H wide (b_h: 3, the light GRU's mask: 1). The caller counts the
    launch."""
    dev = xg.device
    t, b, gh = xg.shape
    hidden = gh // n_gates
    require_fit(what, n_gates, hidden, dev)
    hp = _padded(hidden)
    xg_p = _pad_units(xg, hidden, hp, n_gates)
    wp = pack_w(w_h, hidden, hp, n_gates)
    small_p = _pad_units(small.float(), hidden, hp, small_gates)
    ys = torch.empty(t, b, hp, dtype=xg.dtype, device=dev)
    hgs = (torch.empty(t, b, n_gates * hp, dtype=torch.bfloat16, device=dev)
           if stash else None)
    hbuf = torch.zeros(2, b, hp, dtype=torch.bfloat16, device=dev)
    hcar = torch.zeros(b, hp, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, symbol)(
            xg_p.data_ptr(), wp.data_ptr(), small_p.data_ptr(), ys.data_ptr(),
            hgs.data_ptr() if stash else None, hbuf.data_ptr(),
            hcar.data_ptr(), t, b, hp, int(reverse),
            int(xg.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("{} launch failed: cudaError {}".format(symbol,
                                                                   err))
    ys = _unpad_units(ys, hidden, hp, 1)
    return (ys, _unpad_units(hgs, hidden, hp, n_gates)) if stash else ys


def launch_fwd_packed(lib, symbol: str, n_gates: int, xg_f, xg_b, wh_f,
                      wh_b, small, small_gates: int, stash: bool):
    """One launch of a packed forward kernel of this family
    (``lib.<symbol>``): both directions, the forward one on xg_f and the
    backward one on xg_b. Pads H to 80, packs both w_h, allocates the
    outputs and the two directions' exchange buffers. ``small`` is the
    family's small f32 operand, ``small_gates`` blocks of H wide on its last
    axis (both directions' b_h stacked, (2, 3H): 3; the light GRU's shared
    (B,H) mask: 1). Returns (ys_f, ys_b), and the two stashes after them
    with ``stash``; the caller counts the launch."""
    dev = xg_f.device
    t, b, gh = xg_f.shape
    hidden = gh // n_gates
    hp = _padded_packed(hidden)
    xs = [_pad_units(x, hidden, hp, n_gates) for x in (xg_f, xg_b)]
    wp = pack_w_pair(wh_f, wh_b, n_gates)
    small_p = _pad_units(small.float(), hidden, hp, small_gates).contiguous()
    ys = [torch.empty(t, b, hp, dtype=xg_f.dtype, device=dev)
          for _ in range(2)]
    hgs = ([torch.empty(t, b, n_gates * hp, dtype=torch.bfloat16,
                        device=dev) for _ in range(2)] if stash else None)
    hbuf = torch.zeros(2, 2, b, hp, dtype=torch.bfloat16, device=dev)
    hcar = torch.zeros(2, b, hp, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, symbol)(
            xs[0].data_ptr(), xs[1].data_ptr(), wp.data_ptr(),
            small_p.data_ptr(), ys[0].data_ptr(), ys[1].data_ptr(),
            *((x.data_ptr() for x in hgs) if stash else (None, None)),
            hbuf.data_ptr(), hcar.data_ptr(), t, b, hp,
            int(xg_f.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("{} launch failed: cudaError {}".format(symbol,
                                                                   err))
    out = [_unpad_units(y, hidden, hp, 1) for y in ys]
    if stash:
        out += [_unpad_units(g, hidden, hp, n_gates) for g in hgs]
    return tuple(out)


def check_pair(name: str, n_gates: int, xg_f, xg_b, wh_f, wh_b, *same_device):
    """Both directions' streams and weights of a bidirectional call."""
    check_streams(name, n_gates, xg_f, wh_f, xg_b, wh_b, *same_device)
    check_streams(name, n_gates, xg_b, wh_b)
    if xg_b.shape != xg_f.shape or xg_b.dtype != xg_f.dtype:
        raise ValueError("xg_f and xg_b differ: {} {} vs {} {}".format(
            tuple(xg_f.shape), xg_f.dtype, tuple(xg_b.shape), xg_b.dtype))


def pair_out(f, b, stash: bool):
    """Two single-direction results as a bidirectional call returns them:
    (ys_f, ys_b), and the two stashes after them with ``stash``."""
    return (f[0], b[0], f[1], b[1]) if stash else (f, b)


def pair_form(form, rule: str, what: str, hidden: int, dev) -> str:
    """The form a bidirectional launch takes: the rule's, or ``form`` when
    one is forced (tests, chip_smoke.py); an unknown form, or the packed
    one where it cannot run, is refused."""
    if form is None:
        return rule
    if form not in FORMS:
        raise ValueError("form must be one of {}, got {!r}".format(FORMS,
                                                                   form))
    if form == "packed" and rule != "packed":
        raise ValueError("{} layer of H={} does not fit the packed form on "
                         "{}".format(what, hidden, dev))
    return form


def launch_bwd(lib, symbol: str, what: str, n_gates: int, xg, w_h, small,
               hgs, ys, dy, reverse: bool, with_dhg: bool):
    """One launch of a backward kernel of this family. ``small`` is the
    (B,H) f32 operand that follows w_h in the kernel's arguments (the light
    GRU's mask) or None; ``with_dhg`` adds the f32 (T,B,G*H) output after
    dxg (the GRU's dhg). Returns (dxg, dhg or None); the caller counts the
    launch."""
    dev = xg.device
    t, b, gh = xg.shape
    hidden = gh // n_gates
    require_fit(what, n_gates, hidden, dev)
    hp = _padded(hidden)
    dxg = torch.empty(t, b, n_gates * hp, dtype=xg.dtype, device=dev)
    dhg = (torch.empty(t, b, n_gates * hp, dtype=torch.float32, device=dev)
           if with_dhg else None)
    xbuf = torch.empty(2, b, n_gates * hp, dtype=torch.bfloat16, device=dev)
    dhz = torch.zeros(b, hp, dtype=torch.float32, device=dev)
    operands = ([_pad_units(xg, hidden, hp, n_gates),
                 pad_w(w_h, hidden, hp, n_gates)]
                + ([] if small is None
                   else [_pad_units(small.float(), hidden, hp, 1)])
                + [_pad_units(hgs, hidden, hp, n_gates),
                   _pad_units(ys, hidden, hp, 1),
                   _pad_units(dy, hidden, hp, 1), dxg]
                + ([dhg] if with_dhg else []) + [xbuf, dhz])
    with torch.cuda.device(dev):
        err = getattr(lib, symbol)(
            *(x.data_ptr() for x in operands), t, b, hp, int(reverse),
            int(xg.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("{} launch failed: cudaError {}".format(symbol,
                                                                   err))
    return (_unpad_units(dxg, hidden, hp, n_gates),
            _unpad_units(dhg, hidden, hp, n_gates) if with_dhg else None)


def launch_bwd_packed(lib, symbol: str, n_gates: int, xg_f, xg_b, wh_f, wh_b,
                      mask, hgs_f, hgs_b, ys_f, ys_b, dy_f, dy_b,
                      with_dhg: bool):
    """One launch of a packed backward kernel of this family: both
    directions, the forward one on the *_f operands and the backward one on
    the *_b ones. Pads H to 80 and allocates the outputs and the two
    directions' exchange buffers. ``mask`` is the light GRU's (B,H) f32
    mask, shared by the two, or None; ``with_dhg`` adds each direction's f32
    (T,B,G*H) dhg. Returns (dxg_f, dxg_b), then (dhg_f, dhg_b) with
    ``with_dhg``; the caller counts the launch."""
    dev = xg_f.device
    t, b, gh = xg_f.shape
    hidden = gh // n_gates
    hp = _padded_packed(hidden)

    def wide(x):
        return _pad_units(x, hidden, hp, n_gates)

    def narrow(x):
        return _pad_units(x, hidden, hp, 1)
    dxg = [torch.empty(t, b, n_gates * hp, dtype=xg_f.dtype, device=dev)
           for _ in range(2)]
    dhg = [torch.empty(t, b, n_gates * hp, dtype=torch.float32, device=dev)
           if with_dhg else None for _ in range(2)]
    xbuf = torch.empty(2, 2, b, n_gates * hp, dtype=torch.bfloat16,
                       device=dev)
    dhz = torch.zeros(2, b, hp, dtype=torch.float32, device=dev)
    operands = ([wide(xg_f), wide(xg_b), pad_w(wh_f, hidden, hp, n_gates),
                 pad_w(wh_b, hidden, hp, n_gates)]
                + ([] if mask is None else [narrow(mask.float())])
                + [wide(hgs_f), wide(hgs_b), narrow(ys_f), narrow(ys_b),
                   narrow(dy_f), narrow(dy_b)] + dxg
                + (dhg if with_dhg else []) + [xbuf, dhz])
    with torch.cuda.device(dev):
        err = getattr(lib, symbol)(
            *(x.data_ptr() for x in operands), t, b, hp,
            int(xg_f.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("{} launch failed: cudaError {}".format(symbol,
                                                                   err))
    out = [_unpad_units(x, hidden, hp, n_gates) for x in dxg]
    if with_dhg:
        out += [_unpad_units(x, hidden, hp, n_gates) for x in dhg]
    return tuple(out)


def _check_bias(xg, b_h):
    if tuple(b_h.shape) != (xg.shape[-1],):
        raise ValueError("b_h must be ({},), got {}".format(
            xg.shape[-1], tuple(b_h.shape)))


def _launch_single(xg, w_h, b_h, reverse: bool, stash: bool):
    global FWD_LAUNCHES, FWD_SINGLE_LAUNCHES
    out = launch_fwd(_library(), "gru_fwd", "GRU", N_GATES, xg, w_h, b_h,
                     N_GATES, reverse, stash)
    FWD_LAUNCHES += 1
    FWD_SINGLE_LAUNCHES += 1
    return out


def gru_fwd(xg, w_h, b_h, reverse: bool = False, stash: bool = False):
    """K7f over one direction (the single form on the card): (T,B,3H) gate
    inputs (data order) -> ys (T,B,H) in xg's dtype, plus the bf16 stash hgs
    (T,B,3H) when ``stash``."""
    check_streams("GRU", N_GATES, xg, w_h, b_h)
    _check_bias(xg, b_h)
    if xg.device.type == "cpu":
        return gru_recurrence_ref(xg, w_h, b_h, reverse, stash)
    return _launch_single(xg, w_h, b_h, reverse, stash)


def _launch_fwd_pair(xg_f, xg_b, wh_f, wh_b, bh_f, bh_b, stash: bool,
                     form=None):
    """K7f over both directions of a layer in ``form`` (the rule's when
    None): one packed launch, or two single ones."""
    global FWD_LAUNCHES, FWD_PACKED_LAUNCHES
    hidden = wh_f.shape[0]
    form = pair_form(form, form_for(hidden, True, xg_f.device), "GRU",
                     hidden, xg_f.device)
    if form == "single":
        f = _launch_single(xg_f, wh_f, bh_f, False, stash)
        b = _launch_single(xg_b, wh_b, bh_b, True, stash)
        return pair_out(f, b, stash)
    out = launch_fwd_packed(_library(), "gru_fwd_packed", N_GATES, xg_f,
                            xg_b, wh_f, wh_b, torch.stack([bh_f, bh_b]),
                            N_GATES, stash)
    FWD_LAUNCHES += 1
    FWD_PACKED_LAUNCHES += 1
    return out


def gru_fwd_pair(xg_f, xg_b, wh_f, wh_b, bh_f, bh_b, stash: bool = False):
    """K7f over both directions of a bidirectional layer: the forward one on
    xg_f, the backward one (t = T-1..0) on xg_b, each (T,B,3H) in data
    order with its own w_h and b_h -> (ys_f, ys_b), plus the bf16 stashes
    (hgs_f, hgs_b) after them with ``stash``. On the card in ``form_for``'s
    form (one packed launch up to H = 1280 on an H100); on CPU tensors the
    plain version once per direction."""
    check_pair("GRU", N_GATES, xg_f, xg_b, wh_f, wh_b, bh_f, bh_b)
    _check_bias(xg_f, bh_f)
    _check_bias(xg_b, bh_b)
    if xg_f.device.type == "cpu":
        f = gru_recurrence_ref(xg_f, wh_f, bh_f, False, stash)
        b = gru_recurrence_ref(xg_b, wh_b, bh_b, True, stash)
        return pair_out(f, b, stash)
    return _launch_fwd_pair(xg_f, xg_b, wh_f, wh_b, bh_f, bh_b, stash)


def _launch_bwd_single(xg, w_h, hgs, ys, dy, reverse: bool):
    global BWD_LAUNCHES, BWD_SINGLE_LAUNCHES
    out = launch_bwd(_library(), "gru_bwd", "GRU", N_GATES, xg, w_h, None,
                     hgs, ys, dy, reverse, with_dhg=True)
    BWD_LAUNCHES += 1
    BWD_SINGLE_LAUNCHES += 1
    return out


def gru_bwd(xg, w_h, hgs, ys, dy, reverse: bool = False):
    """K7b over one direction (the single form on the card): output
    cotangents dy (T,B,H), the forward's inputs, its bf16 stash and its bf16
    hidden stream -> (dxg in xg's dtype, dhg f32), both (T,B,3H)."""
    check_streams("GRU", N_GATES, xg, w_h, hgs, ys, dy)
    check_bwd_streams(N_GATES, xg, hgs, ys, dy)
    if xg.device.type == "cpu":
        return gru_recurrence_bwd_ref(xg, w_h, hgs, ys, dy, reverse)
    return _launch_bwd_single(xg, w_h, hgs, ys, dy, reverse)


def check_bwd_pair(name: str, n_gates: int, xg_f, xg_b, wh_f, wh_b, hgs_f,
                   hgs_b, ys_f, ys_b, dy_f, dy_b, *same_device):
    """Both directions' streams of a bidirectional backward call."""
    check_pair(name, n_gates, xg_f, xg_b, wh_f, wh_b, hgs_f, hgs_b, ys_f,
               ys_b, dy_f, dy_b, *same_device)
    check_bwd_streams(n_gates, xg_f, hgs_f, ys_f, dy_f)
    check_bwd_streams(n_gates, xg_b, hgs_b, ys_b, dy_b)


def _launch_bwd_pair(xg_f, xg_b, wh_f, wh_b, hgs_f, hgs_b, ys_f, ys_b, dy_f,
                     dy_b, form=None):
    """K7b over both directions of a layer in ``form`` (the rule's when
    None): one packed launch, or two single ones. Returns (dxg_f, dxg_b,
    dhg_f, dhg_b)."""
    global BWD_LAUNCHES, BWD_PACKED_LAUNCHES
    hidden = wh_f.shape[0]
    form = pair_form(form, form_for(hidden, True, xg_f.device, backward=True),
                     "GRU", hidden, xg_f.device)
    if form == "single":
        dxg_f, dhg_f = _launch_bwd_single(xg_f, wh_f, hgs_f, ys_f, dy_f,
                                          False)
        dxg_b, dhg_b = _launch_bwd_single(xg_b, wh_b, hgs_b, ys_b, dy_b, True)
        return dxg_f, dxg_b, dhg_f, dhg_b
    out = launch_bwd_packed(_library(), "gru_bwd_packed", N_GATES, xg_f,
                            xg_b, wh_f, wh_b, None, hgs_f, hgs_b, ys_f, ys_b,
                            dy_f, dy_b, with_dhg=True)
    BWD_LAUNCHES += 1
    BWD_PACKED_LAUNCHES += 1
    return out


def gru_bwd_pair(xg_f, xg_b, wh_f, wh_b, hgs_f, hgs_b, ys_f, ys_b, dy_f,
                 dy_b):
    """K7b over both directions of a bidirectional layer, each from its own
    forward's inputs, bf16 stash, bf16 hidden stream and cotangents (the
    backward direction's forward walked t = T-1..0) -> (dxg_f, dxg_b, dhg_f,
    dhg_b). On the card in ``form_for(..., backward=True)``'s form (one
    packed launch up to H = 1280 on an H100); on CPU tensors the plain
    version once per direction."""
    check_bwd_pair("GRU", N_GATES, xg_f, xg_b, wh_f, wh_b, hgs_f, hgs_b, ys_f,
                   ys_b, dy_f, dy_b)
    if xg_f.device.type == "cpu":
        dxg_f, dhg_f = gru_recurrence_bwd_ref(xg_f, wh_f, hgs_f, ys_f, dy_f,
                                              False)
        dxg_b, dhg_b = gru_recurrence_bwd_ref(xg_b, wh_b, hgs_b, ys_b, dy_b,
                                              True)
        return dxg_f, dxg_b, dhg_f, dhg_b
    return _launch_bwd_pair(xg_f, xg_b, wh_f, wh_b, hgs_f, hgs_b, ys_f, ys_b,
                            dy_f, dy_b)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

# dW_h = sum_t h_prev[t]^T d[t], bf16 values and f32 sums in one matmul: the
# LSTM kernels' product, shared with the light GRU
dwh = _dwh


class GRURecurrence(torch.autograd.Function):
    """``gru_fwd`` with its hand-written backward, as the JAX custom_vjp
    (``gru.py`` ``_make_recurrence``): the forward keeps xg, the bf16 stash
    and bf16 ys; the backward runs K7b, forms dW_h as one matmul of the
    shifted ys against bf16(dhg) and db_h as the sum of dhg."""

    @staticmethod
    def forward(ctx, xg, w_h, b_h, reverse):
        ys, hgs = gru_fwd(xg, w_h, b_h, reverse, stash=True)
        ctx.save_for_backward(xg, w_h, b_h, hgs, ys.to(torch.bfloat16))
        ctx.reverse = reverse
        return ys

    @staticmethod
    def backward(ctx, dy):
        xg, w_h, b_h, hgs, ys = ctx.saved_tensors
        dxg, dhg = gru_bwd(xg, w_h, hgs, ys, dy.contiguous().to(xg.dtype),
                           ctx.reverse)
        dw = dwh(ys, dhg.to(torch.bfloat16), ctx.reverse)
        return (dxg, dw.to(w_h.dtype), dhg.sum(dim=(0, 1)).to(b_h.dtype),
                None)


def gru_recurrence(xg, w_h, b_h, reverse: bool = False) -> torch.Tensor:
    """GRU recurrence: (T,B,3H) gate inputs (x @ W_x + b_x), (H,3H) and (3H,)
    recurrent weights -> (T,B,H) hidden states in data order, zero initial
    state. ``reverse`` scans t = T-1..0 inside the kernel, no flips. Takes
    any H that ``fits``."""
    if _wants_grad(xg, w_h, b_h):
        return GRURecurrence.apply(xg, w_h, b_h, bool(reverse))
    return gru_fwd(xg, w_h, b_h, bool(reverse))


class BiGRURecurrence(torch.autograd.Function):
    """``gru_fwd_pair`` with its hand-written backward: the forward keeps
    both directions' xg, bf16 stashes and bf16 ys; the backward runs K7b
    over both directions in one call (``gru_bwd_pair``) and forms each dW_h
    and db_h as ``GRURecurrence`` does."""

    @staticmethod
    def forward(ctx, xg_f, xg_b, wh_f, wh_b, bh_f, bh_b):
        ys_f, ys_b, hgs_f, hgs_b = gru_fwd_pair(xg_f, xg_b, wh_f, wh_b, bh_f,
                                                bh_b, stash=True)
        ctx.save_for_backward(xg_f, xg_b, wh_f, wh_b, bh_f, bh_b, hgs_f,
                              hgs_b, ys_f.to(torch.bfloat16),
                              ys_b.to(torch.bfloat16))
        return ys_f, ys_b

    @staticmethod
    def backward(ctx, dy_f, dy_b):
        xg_f, xg_b, wh_f, wh_b, bh_f, bh_b, hgs_f, hgs_b, ys_f, ys_b = (
            ctx.saved_tensors)
        dx_f, dx_b, dhg_f, dhg_b = gru_bwd_pair(
            xg_f, xg_b, wh_f, wh_b, hgs_f, hgs_b, ys_f, ys_b,
            dy_f.contiguous().to(xg_f.dtype), dy_b.contiguous().to(xg_b.dtype))
        out = []
        for w_h, b_h, ys, dhg, reverse in ((wh_f, bh_f, ys_f, dhg_f, False),
                                           (wh_b, bh_b, ys_b, dhg_b, True)):
            dw = dwh(ys, dhg.to(torch.bfloat16), reverse)
            out.append((dw.to(w_h.dtype), dhg.sum(dim=(0, 1)).to(b_h.dtype)))
        (dw_f, db_f), (dw_b, db_b) = out
        return dx_f, dx_b, dw_f, dw_b, db_f, db_b


def bigru_recurrence(xg_f, xg_b, wh_f, wh_b, bh_f, bh_b):
    """Both directions of a bidirectional GRU layer: the forward one on
    xg_f, the backward one on xg_b (walked t = T-1..0 inside the kernel),
    each with its own weights -> (ys_f, ys_b), (T,B,H) each in data order.
    Takes any H that ``fits``; the forms are ``form_for``'s."""
    if _wants_grad(xg_f, xg_b, wh_f, wh_b, bh_f, bh_b):
        return BiGRURecurrence.apply(xg_f, xg_b, wh_f, wh_b, bh_f, bh_b)
    return gru_fwd_pair(xg_f, xg_b, wh_f, wh_b, bh_f, bh_b)
