"""The folded teacher-forced decoder scan with its hand-written backward
(port of e2e_asr_pytorch_tpu/models/fold_vjp.py).

``FoldedDecoder`` is a ``torch.autograd.Function`` with the JAX custom_vjp's
forward scan and backward: the backward scan emits per-step gate cotangents
as stacked tensors, the weight gradients collapse to whole-sequence matmuls
after it, and the energy-MLP intermediates are recomputed from the stashed
attention weights instead of stored. Stashes are stacked in the compute
dtype; carries stay f32.

``value_table='int8'`` quantizes the attention values once per call and runs
both per-step table reductions through ``ops/kernels/int8_table.py`` (K3
forward, K4 backward); the gradient with respect to the values is
straight-through (exact for the dequantized table, which the context is
linear in). ``dkey_bf16`` keeps the backward's (B,Te,D) d_key accumulator in
bf16.

On the card each direction's position loop runs as a captured CUDA graph,
replayed once a call (``_Scans``): the same kernels in the same order as
the loop launches eagerly, one host launch in place of tens of thousands.
A key (``scan_key``: the operands' shapes, dtypes and device, ``FoldCfg``)
runs its first call eagerly, which warms the libraries and the allocator,
captures on its next call, and replays after that. The operands are copied
into the graphs' static buffers in the dtypes the loops read them in; what
the calls return is never a static buffer. A forward replay holds its
key's buffers until its backward has run or autograd has freed its
context: a forward that finds its key held, a backward whose forward was
not a replay, a CPU call and a new key past ``MAX_KEYS`` run the loops
eagerly. The loop body is one function on both paths.

Scope, as in the JAX package: 2-layer LSTM decoder, single-head 'loc' or
'dot' attention, pure teacher forcing, no decoder dropout, no fusion.
"""

from __future__ import annotations

import threading
import weakref
from typing import NamedTuple

import torch

from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q8
from e2e_asr_pytorch_tpu_torch.ops import rnn as R

NEG_INF = -1e30

# FoldedDecoder's calls in this process by path, each direction apart (the
# only global state beside the graphs): a capture captured the loop and
# replayed it, a replay replayed a graph captured before, an eager call ran
# the loop as written. The hit share is replays / calls.
FWD_CAPTURES = FWD_REPLAYS = FWD_EAGER = 0
BWD_CAPTURES = BWD_REPLAYS = BWD_EAGER = 0

# Keys with graphs at once. Bucketed training brings one key a bucket
# (five with data/batching.py's buckets) and validation a few more; each
# holds its pool (about 2 GB at 64 rows of 272 positions over 400 frames).
# A new key past the bound runs eagerly: evicting would recapture, a
# synchronize and an eager pass each time, wherever shapes outnumber keys.
MAX_KEYS = 8
_KEYS: dict = {}               # scan_key -> _Scans
_LOCK = threading.Lock()       # guards _KEYS and every _Scans.held

# the operands, in FoldedDecoder's order; the matrices the loops multiply
# by are read in the compute dtype, cast once a call
NAMES = ("xg_emb", "values", "w_ctx", "key", "band", "neg_bias", "prev0",
         "h0", "c0", "w_q", "b_q", "w_lp", "w_e", "b_e", "w_h1", "w_x2",
         "b2", "w_h2")
_CAST = frozenset(("w_ctx", "band", "w_q", "w_lp", "w_e", "w_h1", "w_x2",
                   "w_h2"))


class FoldCfg(NamedTuple):
    mode: str                 # 'loc' | 'dot'
    temperature: float
    compute_dtype: torch.dtype
    value_table: str = "bf16"  # 'bf16' | 'int8'
    dkey_bf16: bool = False


def _mm(a: torch.Tensor, b: torch.Tensor, cd) -> torch.Tensor:
    """a @ b with both operands in the compute dtype, f32 sums and an f32
    result (``preferred_element_type=float32``), a (...,K) @ b (K,N) or
    batched. Forward and backward here run outside autograd, so this is the
    op itself (``ops/rnn.py mm_f32``)."""
    return R.mm_f32(a.to(cd), b.to(cd))


def _lstm_act(gates: torch.Tensor, hidden: int):
    i = torch.sigmoid(gates[..., :hidden])
    f = torch.sigmoid(gates[..., hidden:2 * hidden])
    g = torch.tanh(gates[..., 2 * hidden:3 * hidden])
    o = torch.sigmoid(gates[..., 3 * hidden:])
    return i, f, g, o


def _lstm_cell_bwd(dh, dc, gates, c, c_prev, hidden):
    """(dgates, dc_prev) of one LSTM cell, activations recomputed in f32
    from the stashed gates and cell states."""
    i, f, g, o = _lstm_act(gates.float(), hidden)
    tc = torch.tanh(c.float())
    do = dh * tc
    dct = dc + dh * o * (1.0 - tc * tc)
    dgates = torch.cat([dct * g * i * (1.0 - i),
                        dct * c_prev.float() * f * (1.0 - f),
                        dct * i * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
    return dgates, dct * f


def _loc_features(cfg: FoldCfg, prev_att, band, w_lp):
    """(loc (B,Te,Kn) f32, loc_ctx (B,Te,D) in the compute dtype)."""
    cd = cfg.compute_dtype
    b, te = prev_att.shape
    loc = _mm(prev_att, band, cd).reshape(b, te, -1)
    loc_ctx = torch.tanh(_mm(loc, w_lp, cd)).to(cd)
    return loc, loc_ctx


def _attn_step(cfg: FoldCfg, q, prev_att, key, band, neg_bias, w_lp, w_e,
               b_e):
    """Energy + masked softmax for one step. q: (B,D) post-tanh query
    projection, prev_att: (B,Te). Returns attn (B,Te) f32."""
    cd = cfg.compute_dtype
    if cfg.mode == "dot":
        energy = torch.einsum("bd,btd->bt", q, key.float())
    else:
        _, loc_ctx = _loc_features(cfg, prev_att, band, w_lp)
        e_in = torch.tanh(key + q[:, None, :].to(cd) + loc_ctx)
        energy = (_mm(e_in, w_e, cd) + b_e)[..., 0]
    energy = energy / cfg.temperature
    energy = torch.where(neg_bias < 0, torch.full_like(energy, NEG_INF),
                         energy)
    return torch.softmax(energy, dim=-1)


def _shifted(s: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """The state seen at the START of each step: [first, s[:-1]]."""
    return torch.cat([first[None].to(s.dtype), s[:-1]], dim=0)


def _fwd_scan(cfg, xg_emb, values, w_ctx, key, band, neg_bias, prev0, h0, c0,
              w_q, b_q, w_lp, w_e, b_e, w_h1, w_x2, b2, w_h2):
    cd = cfg.compute_dtype
    hidden = w_h1.shape[0]
    if cfg.value_table == "int8":
        # quantize once per call; the scan re-reads the int8 table per step
        q_tab, v_scale = Q8.quantize_table(values)
    h1, c1, h2, c2 = h0[0], c0[0], h0[1], c0[1]
    prev_att = prev0
    ys = [[] for _ in range(9)]
    for t in range(xg_emb.shape[0]):
        query = torch.cat([h1, h2], dim=-1)                        # (B,2H)
        q = torch.tanh(_mm(query, w_q, cd) + b_q)
        attn = _attn_step(cfg, q, prev_att, key, band, neg_bias, w_lp, w_e,
                          b_e)
        if cfg.value_table == "int8":
            ctx = Q8.context_int8(attn * v_scale, q_tab)
        else:
            ctx = _mm(attn[:, None, :], values, cd)[:, 0]
        gates1 = (xg_emb[t].float() + _mm(ctx, w_ctx, cd)
                  + _mm(h1, w_h1, cd))
        i1, f1, g1, o1 = _lstm_act(gates1, hidden)
        c1 = f1 * c1 + i1 * g1
        h1 = o1 * torch.tanh(c1)
        gates2 = _mm(h1, w_x2, cd) + b2 + _mm(h2, w_h2, cd)
        i2, f2, g2, o2 = _lstm_act(gates2, hidden)
        c2 = f2 * c2 + i2 * g2
        h2 = o2 * torch.tanh(c2)
        if cfg.mode == "loc":
            prev_att = attn
        for stack, x in zip(ys, (h2, attn, h1, c1, c2, gates1, gates2, q,
                                 ctx)):
            stack.append(x.to(cd))
    return [torch.stack(s) for s in ys], (
        (q_tab, v_scale) if cfg.value_table == "int8" else None)


def _bwd_scan(cfg, dtypes, saved, dfeats, dattn_out):
    """The backward scan and the whole-sequence weight gradients: the 18
    cotangents in FoldedDecoder's operand order, each in its operand's
    dtype (``dtypes``, None for an absent operand). ``saved`` is what the
    forward saved: the nine stacks, the value table and its scale, and the
    operands the backward reads, in the dtypes the loops read them in."""
    (feats, attn_s, h1_s, c1_s, c2_s, gates1_s, gates2_s, q_s, ctx_s,
     tab, v_scale, w_ctx, key, band, neg_bias, prev0, h0, c0, w_q, w_lp,
     w_e, w_h1, w_x2, w_h2) = saved
    dt = dict(zip(NAMES, dtypes))
    h2_s = feats
    cd = cfg.compute_dtype
    l, b, hidden = h1_s.shape
    te = attn_s.shape[-1]
    is_loc = cfg.mode == "loc"
    use_int8 = cfg.value_table == "int8"
    valid = neg_bias >= 0                                      # (B,Te)
    dev = h1_s.device

    h1_prev_s = _shifted(h1_s, h0[0])
    h2_prev_s = _shifted(h2_s, h0[1])
    c1_prev_s = _shifted(c1_s, c0[0])
    c2_prev_s = _shifted(c2_s, c0[1])
    prev_att_s = (_shifted(attn_s, prev0) if is_loc
                  else prev0[None].expand(l, b, te))

    wq_t, wh1_t = w_q.to(cd).t(), w_h1.to(cd).t()
    wx2_t, wh2_t = w_x2.to(cd).t(), w_h2.to(cd).t()
    wctx_t = w_ctx.to(cd).t()
    if is_loc:
        wlp_t = w_lp.to(cd).t()
        band_cd = band.to(cd)
        w_e_cd = w_e.to(cd)[:, 0]

    def f32(*shape):
        return torch.zeros(*shape, dtype=torch.float32, device=dev)
    dh1, dc1, dh2, dc2, dprev = (f32(b, hidden), f32(b, hidden),
                                 f32(b, hidden), f32(b, hidden),
                                 f32(b, te))
    d = q_s.shape[-1]
    dkey_acc = torch.zeros(b, te, d, device=dev, dtype=(
        torch.bfloat16 if cfg.dkey_bf16 else torch.float32))
    dwe_acc, dbe_acc = f32(d, 1), f32(1)
    dwlp_acc = f32(w_lp.shape[0] if is_loc else 1, d)
    dgates1_s = torch.empty(l, b, 4 * hidden, dtype=cd, device=dev)
    dgates2_s = torch.empty_like(dgates1_s)
    dqpre_s = torch.empty(l, b, d, dtype=cd, device=dev)
    step_stack_s = torch.empty(
        l, b, te * (w_lp.shape[0] if is_loc else 1), dtype=cd,
        device=dev)
    dctx_s = torch.empty(l, b, wctx_t.shape[1], dtype=cd, device=dev)

    for t in range(l - 1, -1, -1):
        attn = attn_s[t].float()
        # ---- LSTM layer 2 backward
        dgates2, dc2 = _lstm_cell_bwd(dh2 + dfeats[t].float(), dc2,
                                      gates2_s[t], c2_s[t],
                                      c2_prev_s[t], hidden)
        dh2_prev = _mm(dgates2, wh2_t, cd)
        dh1_tot = dh1 + _mm(dgates2, wx2_t, cd)
        # ---- LSTM layer 1 backward
        dgates1, dc1 = _lstm_cell_bwd(dh1_tot, dc1, gates1_s[t],
                                      c1_s[t], c1_prev_s[t], hidden)
        dh1_prev = _mm(dgates1, wh1_t, cd)
        # ---- attention backward (dgates1 is also d(ctxg), d(xg_emb))
        dctx = _mm(dgates1, wctx_t, cd)                        # (B,De)
        if use_int8:
            # exact linearity: d_attn = (dctx . Q) * scale
            dattn = Q8.dattn_int8(dctx, tab) * v_scale
        else:
            dattn = _mm(tab, dctx[:, :, None], cd)[..., 0]
        dattn = dattn + dattn_out[t].float()
        if is_loc:
            dattn = dattn + dprev  # step t+1 read attn as its prev_att
        # softmax (masked energies) backward
        den = attn * (dattn - (dattn * attn).sum(-1, keepdim=True))
        den = torch.where(valid, den, torch.zeros_like(den))
        den = den / cfg.temperature
        q = q_s[t]
        if is_loc:
            # recompute this step's energy-MLP intermediates
            loc, loc_ctx = _loc_features(cfg, prev_att_s[t], band, w_lp)
            e_in = torch.tanh(key + q[:, None, :].to(cd) + loc_ctx)
            den_cd = den.to(cd)
            de_in = den_cd[..., None] * w_e_cd[None, None, :]
            dwe_acc += torch.einsum("btd,bt->d", e_in.float(),
                                    den_cd.float())[:, None]
            dbe_acc += den.sum(dim=(0, 1))[None]
            de_pre = de_in * (1.0 - e_in * e_in)
            # in place: the one (B,Te,D) accumulator of the scan
            dkey_acc.add_(de_pre.to(dkey_acc.dtype))
            dq = de_pre.float().sum(dim=1)                     # (B,D)
            dlocpre = de_pre * (1.0 - loc_ctx * loc_ctx)
            dwlp_acc += _mm(loc.to(cd).flatten(0, 1).t(),
                            dlocpre.flatten(0, 1), cd)
            dloc_flat = _mm(dlocpre, wlp_t, cd).reshape(b, -1)
            dprev = _mm(dloc_flat, band_cd.t(), cd)
            step_stack = dloc_flat
        else:
            dq = torch.einsum("bt,btd->bd", den, key.float())
            step_stack = den
        # query projection backward: q = tanh(query @ w_q + b_q)
        q32 = q.float()
        dqpre = dq * (1.0 - q32 * q32)
        dquery = _mm(dqpre, wq_t, cd)                          # (B,2H)
        dh1 = dh1_prev + dquery[:, :hidden]
        dh2 = dh2_prev + dquery[:, hidden:]
        dgates1_s[t] = dgates1
        dgates2_s[t] = dgates2
        dqpre_s[t] = dqpre
        step_stack_s[t] = step_stack
        dctx_s[t] = dctx

    # ---- weight gradients: whole-sequence matmuls
    def wgrad(inp_s, dg_s):
        return _mm(inp_s.flatten(0, 1).t(), dg_s.flatten(0, 1), cd)

    d_xg_emb = dgates1_s
    d_w_ctx = wgrad(ctx_s, dgates1_s)
    # straight-through in int8 mode (exact for the dequantized values)
    d_values = _mm(attn_s.permute(1, 2, 0), dctx_s.transpose(0, 1), cd)
    query_s = torch.cat([h1_prev_s, h2_prev_s], dim=-1)
    d_wq = wgrad(query_s, dqpre_s)
    d_bq = dqpre_s.float().sum(dim=(0, 1))
    d_wh1 = wgrad(h1_prev_s, dgates1_s)
    d_wx2 = wgrad(h1_s, dgates2_s)
    d_b2 = dgates2_s.float().sum(dim=(0, 1))
    d_wh2 = wgrad(h2_prev_s, dgates2_s)
    if is_loc:
        d_key = dkey_acc
        d_band = wgrad(prev_att_s, step_stack_s)
        d_wlp, d_we, d_be = dwlp_acc, dwe_acc, dbe_acc
        d_prev0 = dprev
    else:
        d_key = _mm(step_stack_s.permute(1, 2, 0), q_s.transpose(0, 1),
                    cd)
        d_band = d_wlp = d_we = d_be = None
        d_prev0 = torch.zeros(b, te, dtype=torch.float32, device=dev)
    d_h0 = torch.stack([dh1, dh2])
    d_c0 = torch.stack([dc1, dc2])
    d_negbias = torch.zeros_like(neg_bias)

    def like(g, name):
        return None if g is None else g.to(dt[name])
    return (d_xg_emb, like(d_values, "values"), like(d_w_ctx, "w_ctx"),
            like(d_key, "key"), like(d_band, "band"), d_negbias,
            like(d_prev0, "prev0"), like(d_h0, "h0"), like(d_c0, "c0"),
            like(d_wq, "w_q"), like(d_bq, "b_q"), like(d_wlp, "w_lp"),
            like(d_we, "w_e"), like(d_be, "b_e"), like(d_wh1, "w_h1"),
            like(d_wx2, "w_x2"), like(d_b2, "b2"), like(d_wh2, "w_h2"))


def _operands(cfg: FoldCfg, args):
    """The operands in the dtypes the loops read them in: the matrices cast
    to the compute dtype once a call, the bits each position's cast gave."""
    cd = cfg.compute_dtype
    return tuple(x.to(cd) if x is not None and n in _CAST else x
                 for n, x in zip(NAMES, args))


def scan_key(cfg: FoldCfg, args) -> tuple:
    """What the scans' kernels depend on: ``FoldCfg``, the device, and each
    operand's shape and dtype (None where it is absent)."""
    return (cfg, args[0].device, tuple(
        None if x is None else (tuple(x.shape), x.dtype) for x in args))


class _Hold:
    """A forward replay's claim on its key's static buffers. The key keeps
    a weak reference: the claim ends when the backward releases it or when
    autograd frees the context that owns it."""

    def __init__(self, scans: "_Scans"):
        self.scans = scans

    def holds(self) -> bool:
        return self.scans.held is not None and self.scans.held() is self

    def release(self):
        # only the holder clears the claim, so no lock is needed here
        if self.holds():
            self.scans.held = None


class _Scans:
    """One key's captured scans: the forward and the backward graph, their
    static buffers, one memory pool for the pair, and the claim of the
    forward replay whose stashes the buffers hold."""

    def __init__(self):
        self.fwd_warm = self.bwd_warm = False
        self.held = None                # weakref to a _Hold
        self.pool = self.fwd = self.bwd = None
        self.ins = self.outs = self.cts = self.grads = None
        self.fwd_q8 = self.bwd_q8 = 0   # K3 / K4 launches in each graph

    def take(self):
        """A claim on the buffers, or None: the key has not run eagerly
        yet, or a forward replay holds it."""
        with _LOCK:
            if not self.fwd_warm or (self.held is not None
                                     and self.held() is not None):
                return None
            hold = _Hold(self)
            self.held = weakref.ref(hold)
            return hold

    def forward(self, cfg: FoldCfg, args) -> bool:
        """Copy the operands in and replay the forward scan, captured first
        on the key's first call here; returns whether it captured."""
        if self.fwd is None:
            cd = cfg.compute_dtype
            self.pool = torch.cuda.graph_pool_handle()
            self.ins = tuple(None if x is None else torch.empty(
                x.shape, dtype=cd if n in _CAST else x.dtype, device=x.device)
                for n, x in zip(NAMES, args))
        for buf, x in zip(self.ins, args):
            if buf is not None:
                buf.copy_(x)
        if self.fwd is None:
            n = Q8.CTX_LAUNCHES
            self.outs, self.fwd = _capture(
                lambda: _fwd_scan(cfg, *self.ins), self.pool)
            self.fwd_q8 = Q8.CTX_LAUNCHES - n
            self.fwd.replay()
            return True
        self.fwd.replay()
        Q8.CTX_LAUNCHES += self.fwd_q8
        return False

    def backward(self, cfg: FoldCfg, dtypes, saved, dfeats,
                 dattn_out) -> bool:
        """Copy the cotangents in and replay the backward scan over the
        forward's static stashes (``saved``), captured first on the key's
        first call here; returns whether it captured."""
        if self.bwd is None:
            self.cts = tuple(torch.empty(x.shape, dtype=x.dtype,
                                         device=x.device)
                             for x in (dfeats, dattn_out))
        self.cts[0].copy_(dfeats)
        self.cts[1].copy_(dattn_out)
        if self.bwd is None:
            n = Q8.DATTN_LAUNCHES
            self.grads, self.bwd = _capture(
                lambda: _bwd_scan(cfg, dtypes, saved, *self.cts), self.pool)
            self.bwd_q8 = Q8.DATTN_LAUNCHES - n
            self.bwd.replay()
            return True
        self.bwd.replay()
        Q8.DATTN_LAUNCHES += self.bwd_q8
        return False


def _capture(fn, pool):
    """(fn's outputs, the graph of its kernels): a capture on the calling
    thread (``thread_local``: another thread's CUDA calls, a loader's or
    the main thread's while autograd's device thread captures, cannot
    spoil it), on torch's side stream after a device synchronize; the graph
    replays on the caller's current stream."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        out = fn()
    return out, graph


def _entry(key):
    """The key's ``_Scans``, made on its first call; None for a new key past
    MAX_KEYS."""
    with _LOCK:
        scans = _KEYS.get(key)
        if scans is None and len(_KEYS) < MAX_KEYS:
            scans = _KEYS[key] = _Scans()
        return scans


def _scans_for(cfg: FoldCfg, args):
    """The call's ``_Scans``, or None where it runs eagerly: CPU operands
    (no graphs there), or a new key past MAX_KEYS."""
    return _entry(scan_key(cfg, args)) if args[0].is_cuda else None


class FoldedDecoder(torch.autograd.Function):
    """Teacher-forced 2-layer-LSTM decoder scan with folded inputs.

    xg_emb (L,B,4H): embedding half of layer-1 gate pre-activations (+b1),
    in the compute dtype. values (B,Te,D_enc) attention values; w_ctx
    (D_enc,4H) the context half of layer-1 w_x, applied per step after the
    context reduction. key (B,Te,D) projected keys; band (Te,Te*Kn) the loc
    operator (None for 'dot'); neg_bias (B,Te): 0 on valid frames, NEG_INF on
    padding. prev0 (B,Te) initial attention; h0/c0 (2,B,H) initial LSTM
    state. Returns (feats (L,B,H), attn (L,B,Te)), both in the compute
    dtype. ``w_lp``, ``w_e`` and ``b_e`` are None for 'dot'.
    """

    @staticmethod
    def forward(ctx, cfg, *args):
        global FWD_CAPTURES, FWD_REPLAYS, FWD_EAGER
        scans = _scans_for(cfg, args)
        hold = scans.take() if scans is not None else None
        if hold is None:
            ops = _operands(cfg, args)
            stacks, table = _fwd_scan(cfg, *ops)
            feats, attn_s = stacks[0], stacks[1]
            FWD_EAGER += 1
            if scans is not None:
                scans.fwd_warm = True
        else:
            if scans.forward(cfg, args):
                FWD_CAPTURES += 1
            else:
                FWD_REPLAYS += 1
            ops = scans.ins
            stacks, table = scans.outs
            feats, attn_s = stacks[0].clone(), stacks[1].clone()
        ctx.cfg, ctx.scans, ctx.hold = cfg, scans, hold
        ctx.dtypes = tuple(None if x is None else x.dtype for x in args)
        o = dict(zip(NAMES, ops))
        # in int8 mode the backward reads the quantized table (half the
        # bytes of the values), not the values themselves
        tab = table if table is not None else (o["values"], None)
        ctx.save_for_backward(*stacks, tab[0], tab[1], *(o[n] for n in (
            "w_ctx", "key", "band", "neg_bias", "prev0", "h0", "c0", "w_q",
            "w_lp", "w_e", "w_h1", "w_x2", "w_h2")))
        return feats, attn_s

    @staticmethod
    def backward(ctx, dfeats, dattn_out):
        global BWD_CAPTURES, BWD_REPLAYS, BWD_EAGER
        saved = ctx.saved_tensors
        scans, hold = ctx.scans, ctx.hold
        if hold is not None and hold.holds() and scans.bwd_warm:
            if scans.backward(ctx.cfg, ctx.dtypes, saved, dfeats, dattn_out):
                BWD_CAPTURES += 1
            else:
                BWD_REPLAYS += 1
            grads = tuple(None if g is None else g.clone()
                          for g in scans.grads)
        else:
            grads = _bwd_scan(ctx.cfg, ctx.dtypes, saved, dfeats, dattn_out)
            BWD_EAGER += 1
            if scans is not None:
                scans.bwd_warm = True
        if hold is not None:
            hold.release()
        return (None, *grads)


def folded_decoder(cfg: FoldCfg, xg_emb, values, w_ctx, key, band, neg_bias,
                   prev0, h0, c0, w_q, b_q, w_lp, w_e, b_e, w_h1, w_x2, b2,
                   w_h2):
    """``FoldedDecoder.apply`` with the JAX package's argument order."""
    return FoldedDecoder.apply(cfg, xg_emb, values, w_ctx, key, band,
                               neg_bias, prev0, h0, c0, w_q, b_q, w_lp, w_e,
                               b_e, w_h1, w_x2, b2, w_h2)
