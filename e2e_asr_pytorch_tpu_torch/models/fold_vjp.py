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

Scope, as in the JAX package: 2-layer LSTM decoder, single-head 'loc' or
'dot' attention, pure teacher forcing, no decoder dropout, no fusion.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q8
from e2e_asr_pytorch_tpu_torch.ops import rnn as R

NEG_INF = -1e30


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
    def forward(ctx, cfg, xg_emb, values, w_ctx, key, band, neg_bias, prev0,
                h0, c0, w_q, b_q, w_lp, w_e, b_e, w_h1, w_x2, b2, w_h2):
        stacks, table = _fwd_scan(cfg, xg_emb, values, w_ctx, key, band,
                                  neg_bias, prev0, h0, c0, w_q, b_q, w_lp,
                                  w_e, b_e, w_h1, w_x2, b2, w_h2)
        feats, attn_s = stacks[0], stacks[1]
        ctx.cfg = cfg
        ctx.v_dtype = values.dtype
        ctx.b_q_dtype, ctx.b2_dtype = b_q.dtype, b2.dtype
        ctx.b_e_dtype = b_e.dtype if b_e is not None else None
        ctx.prev0_dtype = prev0.dtype
        ctx.h0_dtype, ctx.c0_dtype = h0.dtype, c0.dtype
        # in int8 mode the backward reads the quantized table (half the
        # bytes of the values), not the values themselves
        tab = table if table is not None else (values, None)
        ctx.save_for_backward(*stacks, tab[0], tab[1], w_ctx, key, band,
                              neg_bias, prev0, h0, c0, w_q, w_lp, w_e, w_h1,
                              w_x2, w_h2)
        return feats, attn_s

    @staticmethod
    def backward(ctx, dfeats, dattn_out):
        cfg = ctx.cfg
        (feats, attn_s, h1_s, c1_s, c2_s, gates1_s, gates2_s, q_s, ctx_s,
         tab, v_scale, w_ctx, key, band, neg_bias, prev0, h0, c0, w_q, w_lp,
         w_e, w_h1, w_x2, w_h2) = ctx.saved_tensors
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

        def like(g, dtype):
            return None if g is None else g.to(dtype)
        return (None, d_xg_emb, d_values.to(ctx.v_dtype),
                d_w_ctx.to(w_ctx.dtype), d_key.to(key.dtype),
                like(d_band, band.dtype if band is not None else None),
                d_negbias, d_prev0.to(ctx.prev0_dtype),
                d_h0.to(ctx.h0_dtype), d_c0.to(ctx.c0_dtype),
                d_wq.to(w_q.dtype), d_bq.to(ctx.b_q_dtype),
                like(d_wlp, w_lp.dtype if w_lp is not None else None),
                like(d_we, w_e.dtype if w_e is not None else None),
                like(d_be, ctx.b_e_dtype), d_wh1.to(w_h1.dtype),
                d_wx2.to(w_x2.dtype), d_b2.to(ctx.b2_dtype),
                d_wh2.to(w_h2.dtype))


def folded_decoder(cfg: FoldCfg, xg_emb, values, w_ctx, key, band, neg_bias,
                   prev0, h0, c0, w_q, b_q, w_lp, w_e, b_e, w_h1, w_x2, b2,
                   w_h2):
    """``FoldedDecoder.apply`` with the JAX package's argument order."""
    return FoldedDecoder.apply(cfg, xg_emb, values, w_ctx, key, band,
                               neg_bias, prev0, h0, c0, w_q, b_q, w_lp, w_e,
                               b_e, w_h1, w_x2, b2, w_h2)
