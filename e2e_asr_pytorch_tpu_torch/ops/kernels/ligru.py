"""Light-GRU recurrence, forward and backward (counterpart of the TPU kernels
behind ``ligru_recurrence`` in e2e_asr_pytorch_tpu/ops/pallas/ligru.py).

Contract: ``xg`` (T,B,2H) is the batch-normalised input projection, gate
order z,a, computed outside in compute dtype; ``w_h`` (H,2H) is cast to bf16
whatever the compute dtype; ``mask`` (B,H) f32 is the recurrent dropout mask
shared by every step (ones outside training). Per step z = sigmoid(xg_z +
hg_z), cand = relu(xg_a + hg_a) * mask, h = z*h + (1-z)*cand with hg =
bf16(h) @ bf16(w_h) in f32 sums and the carry in f32 from a zero state. The
candidates are not bounded, so |h| is not bounded by 1.

  K8f ``ligru_fwd``   ys (T,B,H) in xg's dtype plus, when asked, the bf16
                      stash of hg; ``reverse`` walks t = T-1..0 by indexing.
  K8b ``ligru_bwd``   from xg, that stash and the bf16 hidden stream: dxg
                      (T,B,2H) in xg's dtype = [dz*z*(1-z), dcand*mask*(a>0)];
                      the carry's product takes bf16 of the f32 dxg.

Each dispatches on the tensors' device: a CPU tensor goes to the plain
PyTorch version (``*_ref``), a CUDA tensor to the hand-written kernel in
``csrc/ligru.cu`` (or raises). ``LiGRURecurrence`` is the autograd Function
over them, with dW_h = ys_prev^T bf16(dxg) formed outside the kernel and no
gradient for the mask; ``ligru_recurrence`` is the entry point.
``ligru_fwd_pair`` / ``ligru_bwd_pair`` / ``BiLiGRURecurrence`` /
``biligru_recurrence`` are the same for both directions of a bidirectional
layer at once, the mask shared by the two; on CPU tensors they are the two
plain single-direction versions. ``fits`` says which hidden sizes get the
kernels: H <= 2112 on an H100 (the rule is ``recurrence_fits`` in
``ops/kernels/gru.py``). K8f and K8b have K7f's and K7b's two forms, picked
by the same rule (``form_for``, with ``backward=True`` for K8b): packed,
both directions in one launch of 20-unit blocks (the forward's slab 40 gate
columns, the backward's 20 rows of w_h), for a bidirectional layer up to
H = 1280 on an H100; single, one direction a launch of 16-unit blocks,
otherwise. Launches are counted per kernel and per form.
"""

from __future__ import annotations

import ctypes

import torch

from e2e_asr_pytorch_tpu_torch.ops.kernels import build
from e2e_asr_pytorch_tpu_torch.ops.kernels import gru as G
from e2e_asr_pytorch_tpu_torch.ops.kernels.lstm import (_shift_prev,
                                                        _wants_grad)

# launches of the CUDA kernels in this process (the only global state):
# FWD_LAUNCHES counts K8f in either form (a packed launch walks both
# directions of a layer), split by form into FWD_PACKED_LAUNCHES and
# FWD_SINGLE_LAUNCHES; BWD_LAUNCHES counts K8b likewise, split into
# BWD_PACKED_LAUNCHES and BWD_SINGLE_LAUNCHES
FWD_LAUNCHES = 0
FWD_PACKED_LAUNCHES = 0
FWD_SINGLE_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_PACKED_LAUNCHES = 0
BWD_SINGLE_LAUNCHES = 0

N_GATES = 2


def _h_operand(h: torch.Tensor) -> torch.Tensor:
    """bf16(h), the recurrent matmul's left operand, held exactly in f32."""
    return h.to(torch.bfloat16).float()


def _dg_operand(dxg: torch.Tensor) -> torch.Tensor:
    """bf16(dxg), the backward recurrent matmul's left operand, rounded from
    the f32 value and held exactly in f32."""
    return dxg.to(torch.bfloat16).float()


def ligru_recurrence_ref(xg, w_h, mask, reverse: bool = False,
                         stash: bool = False, k_halves: bool = False):
    """Plain PyTorch version of K8f with the kernel's numerics (bf16
    products exact in f32, f32 sums, f32 carry). Returns ys (T,B,H) in xg's
    dtype, plus the bf16 stash hgs (T,B,2H) when ``stash``. ``k_halves``
    sums the recurrent product over the two halves of its k axis and adds
    the two: the same products in another f32 order, whose distance from
    the one-product walk is the plain version's own spread (the bound of
    the card's whole-sequence check on f32 streams)."""
    t, b, h2 = xg.shape
    hidden = h2 // 2
    half = hidden // 2
    wh = w_h.to(torch.bfloat16).float()
    mask = mask.float()
    h = torch.zeros(b, hidden, dtype=torch.float32, device=xg.device)
    ys = torch.empty(t, b, hidden, dtype=xg.dtype, device=xg.device)
    hgs = (torch.empty(t, b, h2, dtype=torch.bfloat16, device=xg.device)
           if stash else None)
    for s in range(t):
        i = t - 1 - s if reverse else s
        hb = _h_operand(h)
        hg = (hb[:, :half] @ wh[:half] + hb[:, half:] @ wh[half:]
              if k_halves else hb @ wh)
        g = xg[i].float() + hg
        z = torch.sigmoid(g[:, :hidden])
        cand = torch.relu(g[:, hidden:]) * mask
        h = z * h + (1.0 - z) * cand
        ys[i] = h
        if stash:
            hgs[i] = hg
    return (ys, hgs) if stash else ys


def ligru_recurrence_bwd_ref(xg, w_h, mask, hgs, ys, dy,
                             reverse: bool = False):
    """Plain PyTorch version of K8b: z and a re-formed from xg and the bf16
    stash, h_prev from the bf16 hidden stream ``ys`` one scan step earlier.
    Returns dxg (T,B,2H) in xg's dtype."""
    t, b, h2 = xg.shape
    hidden = h2 // 2
    dev = xg.device
    wht = w_h.to(torch.bfloat16).float().t().contiguous()
    mask = mask.float()
    hps = _shift_prev(ys.to(torch.bfloat16), reverse)
    dxg = torch.empty(t, b, h2, dtype=xg.dtype, device=dev)
    carry = torch.zeros(b, hidden, dtype=torch.float32, device=dev)
    for s in range(t):
        i = s if reverse else t - 1 - s
        g = xg[i].float() + hgs[i].float()
        z = torch.sigmoid(g[:, :hidden])
        a = g[:, hidden:]
        cand = torch.relu(a) * mask
        dh = dy[i].float() + carry
        dz = dh * (hps[i].float() - cand)
        da = dh * (1.0 - z) * mask * (a > 0)
        dxg_i = torch.cat([dz * z * (1.0 - z), da], dim=-1)
        dxg[i] = dxg_i
        carry = dh * z + _dg_operand(dxg_i) @ wht
    return dxg


def fits(hidden: int, device=None) -> bool:
    """Counterpart of the TPU package's ``ligru_fits_vmem``, from this
    card's SM count and shared memory (``gru.recurrence_fits``): H <= 2112
    on an H100. Above it the layer runs as a plain loop under autograd."""
    return G.recurrence_fits(N_GATES, hidden, device)


def form_for(hidden: int, bidirectional: bool, device=None,
             backward: bool = False) -> str:
    """The form of K8f (with ``backward``, of K8b) a light-GRU layer of
    this H gets (``gru.recurrence_form``): "packed" for a bidirectional
    layer up to H = 1280 on an H100, else "single"."""
    return G.recurrence_form(N_GATES, hidden, bidirectional, device,
                             backward)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _library():
    lib = build.load("ligru")
    lib.ligru_fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                              + [ctypes.c_void_p])
    lib.ligru_fwd.restype = ctypes.c_int
    lib.ligru_fwd_packed.argtypes = ([ctypes.c_void_p] * 10
                                     + [ctypes.c_int] * 4
                                     + [ctypes.c_void_p])
    lib.ligru_fwd_packed.restype = ctypes.c_int
    lib.ligru_bwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                              + [ctypes.c_void_p])
    lib.ligru_bwd.restype = ctypes.c_int
    lib.ligru_bwd_packed.argtypes = ([ctypes.c_void_p] * 15
                                     + [ctypes.c_int] * 4
                                     + [ctypes.c_void_p])
    lib.ligru_bwd_packed.restype = ctypes.c_int
    return lib


def _check_mask(xg, mask):
    want = (xg.shape[1], xg.shape[2] // 2)
    if tuple(mask.shape) != want:
        raise ValueError("mask must be {}, got {}".format(
            want, tuple(mask.shape)))


def _launch_single(xg, w_h, mask, reverse: bool, stash: bool):
    global FWD_LAUNCHES, FWD_SINGLE_LAUNCHES
    out = G.launch_fwd(_library(), "ligru_fwd", "liGRU", N_GATES, xg, w_h,
                       mask, 1, reverse, stash)
    FWD_LAUNCHES += 1
    FWD_SINGLE_LAUNCHES += 1
    return out


def ligru_fwd(xg, w_h, mask, reverse: bool = False, stash: bool = False):
    """K8f over one direction (the single form on the card): (T,B,2H) gate
    inputs (data order) and the (B,H) mask -> ys (T,B,H) in xg's dtype, plus
    the bf16 stash hgs (T,B,2H) when ``stash``."""
    G.check_streams("liGRU", N_GATES, xg, w_h, mask)
    _check_mask(xg, mask)
    if xg.device.type == "cpu":
        return ligru_recurrence_ref(xg, w_h, mask, reverse, stash)
    return _launch_single(xg, w_h, mask, reverse, stash)


def _launch_fwd_pair(xg_f, xg_b, wh_f, wh_b, mask, stash: bool, form=None):
    """K8f over both directions of a layer in ``form`` (the rule's when
    None): one packed launch, or two single ones."""
    global FWD_LAUNCHES, FWD_PACKED_LAUNCHES
    hidden = wh_f.shape[0]
    form = G.pair_form(form, form_for(hidden, True, xg_f.device), "liGRU",
                       hidden, xg_f.device)
    if form == "single":
        f = _launch_single(xg_f, wh_f, mask, False, stash)
        b = _launch_single(xg_b, wh_b, mask, True, stash)
        return G.pair_out(f, b, stash)
    out = G.launch_fwd_packed(_library(), "ligru_fwd_packed", N_GATES, xg_f,
                              xg_b, wh_f, wh_b, mask, 1, stash)
    FWD_LAUNCHES += 1
    FWD_PACKED_LAUNCHES += 1
    return out


def ligru_fwd_pair(xg_f, xg_b, wh_f, wh_b, mask, stash: bool = False):
    """K8f over both directions of a bidirectional layer: the forward one on
    xg_f, the backward one (t = T-1..0) on xg_b, each (T,B,2H) in data
    order with its own w_h, one (B,H) mask for both -> (ys_f, ys_b), plus
    the bf16 stashes (hgs_f, hgs_b) after them with ``stash``. On the card
    in ``form_for``'s form; on CPU tensors the plain version once per
    direction."""
    G.check_pair("liGRU", N_GATES, xg_f, xg_b, wh_f, wh_b, mask)
    _check_mask(xg_f, mask)
    if xg_f.device.type == "cpu":
        f = ligru_recurrence_ref(xg_f, wh_f, mask, False, stash)
        b = ligru_recurrence_ref(xg_b, wh_b, mask, True, stash)
        return G.pair_out(f, b, stash)
    return _launch_fwd_pair(xg_f, xg_b, wh_f, wh_b, mask, stash)


def _launch_bwd_single(xg, w_h, mask, hgs, ys, dy, reverse: bool):
    global BWD_LAUNCHES, BWD_SINGLE_LAUNCHES
    dxg, _ = G.launch_bwd(_library(), "ligru_bwd", "liGRU", N_GATES, xg, w_h,
                          mask, hgs, ys, dy, reverse, with_dhg=False)
    BWD_LAUNCHES += 1
    BWD_SINGLE_LAUNCHES += 1
    return dxg


def ligru_bwd(xg, w_h, mask, hgs, ys, dy, reverse: bool = False):
    """K8b over one direction (the single form on the card): output
    cotangents dy (T,B,H), the forward's inputs, its bf16 stash and its bf16
    hidden stream -> dxg (T,B,2H) in xg's dtype."""
    G.check_streams("liGRU", N_GATES, xg, w_h, mask, hgs, ys, dy)
    _check_mask(xg, mask)
    G.check_bwd_streams(N_GATES, xg, hgs, ys, dy)
    if xg.device.type == "cpu":
        return ligru_recurrence_bwd_ref(xg, w_h, mask, hgs, ys, dy, reverse)
    return _launch_bwd_single(xg, w_h, mask, hgs, ys, dy, reverse)


def _launch_bwd_pair(xg_f, xg_b, wh_f, wh_b, mask, hgs_f, hgs_b, ys_f, ys_b,
                     dy_f, dy_b, form=None):
    """K8b over both directions of a layer in ``form`` (the rule's when
    None): one packed launch, or two single ones. Returns (dxg_f, dxg_b)."""
    global BWD_LAUNCHES, BWD_PACKED_LAUNCHES
    hidden = wh_f.shape[0]
    form = G.pair_form(form, form_for(hidden, True, xg_f.device,
                                      backward=True),
                       "liGRU", hidden, xg_f.device)
    if form == "single":
        return (_launch_bwd_single(xg_f, wh_f, mask, hgs_f, ys_f, dy_f, False),
                _launch_bwd_single(xg_b, wh_b, mask, hgs_b, ys_b, dy_b, True))
    out = G.launch_bwd_packed(_library(), "ligru_bwd_packed", N_GATES, xg_f,
                              xg_b, wh_f, wh_b, mask, hgs_f, hgs_b, ys_f,
                              ys_b, dy_f, dy_b, with_dhg=False)
    BWD_LAUNCHES += 1
    BWD_PACKED_LAUNCHES += 1
    return out


def ligru_bwd_pair(xg_f, xg_b, wh_f, wh_b, mask, hgs_f, hgs_b, ys_f, ys_b,
                   dy_f, dy_b):
    """K8b over both directions of a bidirectional layer, each from its own
    forward's inputs, bf16 stash, bf16 hidden stream and cotangents, one
    (B,H) mask for both -> (dxg_f, dxg_b). On the card in ``form_for(...,
    backward=True)``'s form; on CPU tensors the plain version once per
    direction."""
    G.check_bwd_pair("liGRU", N_GATES, xg_f, xg_b, wh_f, wh_b, hgs_f, hgs_b,
                     ys_f, ys_b, dy_f, dy_b, mask)
    _check_mask(xg_f, mask)
    if xg_f.device.type == "cpu":
        return (ligru_recurrence_bwd_ref(xg_f, wh_f, mask, hgs_f, ys_f, dy_f,
                                         False),
                ligru_recurrence_bwd_ref(xg_b, wh_b, mask, hgs_b, ys_b, dy_b,
                                         True))
    return _launch_bwd_pair(xg_f, xg_b, wh_f, wh_b, mask, hgs_f, hgs_b, ys_f,
                            ys_b, dy_f, dy_b)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class LiGRURecurrence(torch.autograd.Function):
    """``ligru_fwd`` with its hand-written backward, as the JAX custom_vjp
    (``ligru.py`` ``_make_recurrence``): the forward keeps xg, the mask, the
    bf16 stash and bf16 ys; the backward runs K8b and forms dW_h as one
    matmul of the shifted ys against the emitted dxg cast to bf16. The mask
    is a constant."""

    @staticmethod
    def forward(ctx, xg, w_h, mask, reverse):
        ys, hgs = ligru_fwd(xg, w_h, mask, reverse, stash=True)
        ctx.save_for_backward(xg, w_h, mask, hgs, ys.to(torch.bfloat16))
        ctx.reverse = reverse
        return ys

    @staticmethod
    def backward(ctx, dy):
        xg, w_h, mask, hgs, ys = ctx.saved_tensors
        dxg = ligru_bwd(xg, w_h, mask, hgs, ys,
                        dy.contiguous().to(xg.dtype), ctx.reverse)
        dw = G.dwh(ys, dxg.to(torch.bfloat16), ctx.reverse)
        return dxg, dw.to(w_h.dtype), None, None


def ligru_recurrence(xg, w_h, mask, reverse: bool = False) -> torch.Tensor:
    """Light-GRU recurrence: (T,B,2H) batch-normed gate inputs, (H,2H)
    recurrent weights, (B,H) recurrent dropout mask -> (T,B,H) hidden states
    in data order, zero initial state. ``reverse`` scans t = T-1..0 inside
    the kernel, no flips. Takes any H that ``fits``."""
    if _wants_grad(xg, w_h):
        return LiGRURecurrence.apply(xg, w_h, mask, bool(reverse))
    return ligru_fwd(xg, w_h, mask, bool(reverse))


class BiLiGRURecurrence(torch.autograd.Function):
    """``ligru_fwd_pair`` with its hand-written backward: the forward keeps
    both directions' xg, bf16 stashes and bf16 ys and the shared mask; the
    backward runs K8b over both directions in one call (``ligru_bwd_pair``)
    and forms each dW_h as ``LiGRURecurrence`` does. The mask is a
    constant."""

    @staticmethod
    def forward(ctx, xg_f, xg_b, wh_f, wh_b, mask):
        ys_f, ys_b, hgs_f, hgs_b = ligru_fwd_pair(xg_f, xg_b, wh_f, wh_b,
                                                  mask, stash=True)
        ctx.save_for_backward(xg_f, xg_b, wh_f, wh_b, mask, hgs_f, hgs_b,
                              ys_f.to(torch.bfloat16),
                              ys_b.to(torch.bfloat16))
        return ys_f, ys_b

    @staticmethod
    def backward(ctx, dy_f, dy_b):
        xg_f, xg_b, wh_f, wh_b, mask, hgs_f, hgs_b, ys_f, ys_b = (
            ctx.saved_tensors)
        dx_f, dx_b = ligru_bwd_pair(
            xg_f, xg_b, wh_f, wh_b, mask, hgs_f, hgs_b, ys_f, ys_b,
            dy_f.contiguous().to(xg_f.dtype), dy_b.contiguous().to(xg_b.dtype))
        dw_f, dw_b = (G.dwh(ys, dx.to(torch.bfloat16), reverse).to(w_h.dtype)
                      for ys, dx, w_h, reverse in ((ys_f, dx_f, wh_f, False),
                                                   (ys_b, dx_b, wh_b, True)))
        return dx_f, dx_b, dw_f, dw_b, None


def biligru_recurrence(xg_f, xg_b, wh_f, wh_b, mask):
    """Both directions of a bidirectional light-GRU layer: the forward one
    on xg_f, the backward one on xg_b (walked t = T-1..0 inside the kernel),
    each with its own w_h, one (B,H) mask for both -> (ys_f, ys_b), (T,B,H)
    each in data order. Takes any H that ``fits``; the forms are
    ``form_for``'s."""
    if _wants_grad(xg_f, xg_b, wh_f, wh_b):
        return BiLiGRURecurrence.apply(xg_f, xg_b, wh_f, wh_b, mask)
    return ligru_fwd_pair(xg_f, xg_b, wh_f, wh_b, mask)
