"""Batched beam search, joint CTC / attention / LM (port of
e2e_asr_pytorch_tpu/decode/beam.py).

All hypothesis bookkeeping is fixed-shape tensors with a (B,K) beam axis,
gathered by parent index after each expansion; every live hypothesis
advances one token per step, so the decoder state, the attention map, the
LM state and the CTC prefix forward variables all carry the beam axis.
Scoring matches the JAX package: per-step (1-ctc_w)*att +
ctc_w*(psi_t - psi_{t-1}) + lm_w*lm, the CTC term on the per-beam top
int(1.5*beam) attention candidates (scattered at LOG_ZERO elsewhere),
hypotheses ranked by length-averaged total, <eos> accepted only when
logp(eos) > eos_threshold * max logp(other) and t >= min_len, accepted
finals kept in a best-K pool, live beams pooled in at their max-length cap.
The step is a Python loop over ``max_steps``; the CTC prefix state advances
by a log-depth scan over frames (``ops/ctc_prefix.py``), for the one token
each beam took.

Ties in every top-k resolve toward the lower index, as ``lax.top_k`` does:
on the first step only beam 0 is alive and the K*K candidate list is full of
NEG_INF ties, whose order decides which dead-beam tokens can reach the
final ranking.

The embedding-fusion plugin is not ported yet (it raises
NotImplementedError; ROADMAP: joint CTC prefix scoring and emb-fusion in
beam search).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from e2e_asr_pytorch_tpu_torch.models import asr as M
from e2e_asr_pytorch_tpu_torch.models import encoder as E
from e2e_asr_pytorch_tpu_torch.models import lm as LM
from e2e_asr_pytorch_tpu_torch.ops import attention as A
from e2e_asr_pytorch_tpu_torch.ops import ctc_prefix as CP

CTC_BEAM_RATIO = 1.5
LOG_ZERO = -1e7
NEG_INF = -1e30

_NOT_PORTED = ("{} is not ported yet (ROADMAP: joint CTC prefix scoring and "
               "emb-fusion in beam search)")


class BeamConfig(NamedTuple):
    beam_size: int
    min_len_ratio: float
    max_len_ratio: float
    ctc_weight: float = 0.0
    lm_weight: float = 0.0
    eos_threshold: float = 1.5
    max_steps: int = 0          # cap on decode steps

    @property
    def apply_ctc(self) -> bool:
        return self.ctc_weight > 0

    @property
    def apply_lm(self) -> bool:
        return self.lm_weight > 0

    @property
    def ctc_beam_size(self) -> int:
        return int(CTC_BEAM_RATIO * self.beam_size)


def _top_k(x: torch.Tensor, k: int):
    """Top-k on the last axis with ties toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_k(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along beam axis 1 of (B,K,...) with idx (B,K)."""
    ix = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, ix)


def _map_state(fn, state):
    """``fn`` over the leaves of an RNN state: the LSTM's (h, c) tuple or
    the GRU's single tensor."""
    if isinstance(state, tuple):
        return tuple(fn(x) for x in state)
    return fn(state)


def _gather_state(state, idx: torch.Tensor):
    """Gather along beam axis 2 of (L,B,K,H) state leaves with idx (B,K)."""
    def g(x):
        ix = idx[None, :, :, None].expand(x.shape[0], -1, -1, x.shape[-1])
        return torch.gather(x, 2, ix)
    return _map_state(g, state)


def _set_step(tokens: torch.Tensor, t: int, value: torch.Tensor):
    """tokens (B,K,L) with value (B,K) written at position t."""
    out = tokens.clone()
    out[:, :, t] = value
    return out


def _scatter_v(base: torch.Tensor, idx: torch.Tensor,
               val: torch.Tensor) -> torch.Tensor:
    """base (B,K,V) with val (B,K,C) written at idx (B,K,C) on axis -1."""
    return base.scatter(-1, idx, val)


def _encode(params: Dict, spec: M.ASRSpec, feat: torch.Tensor,
            feat_len: torch.Tensor, compute_dtype=torch.float32):
    return E.encoder_apply(params["encoder"], spec.encoder, feat, feat_len,
                           compute_dtype)


@torch.no_grad()
def beam_decode(params: Dict, spec: M.ASRSpec, cfg: BeamConfig,
                feat: torch.Tensor, feat_len: torch.Tensor,
                lm_params: Optional[Dict] = None,
                lm_spec: Optional[LM.LMSpec] = None, emb_reg=None,
                compute_dtype=torch.float32):
    """Beam-decode a padded batch (encode, then the step loop).

    Returns dict: tokens (B,K,L) best-first, avg_scores (B,K), out_len (B,K).
    """
    if not spec.enable_att:
        raise ValueError("beam decoder requires an attention decoder")
    if emb_reg is not None:
        raise NotImplementedError(_NOT_PORTED.format("the emb-fusion plugin"))
    enc_feat, enc_len = _encode(params, spec, feat, feat_len, compute_dtype)
    return _beam_scan(params, spec, cfg, enc_feat, enc_len, feat_len,
                      lm_params, lm_spec, compute_dtype)


def _beam_scan(params: Dict, spec: M.ASRSpec, cfg: BeamConfig,
               enc_feat: torch.Tensor, enc_len: torch.Tensor,
               feat_len: torch.Tensor, lm_params: Optional[Dict] = None,
               lm_spec: Optional[LM.LMSpec] = None,
               compute_dtype=torch.float32):
    b, t_enc = enc_feat.shape[:2]
    k = cfg.beam_size
    c = cfg.ctc_beam_size
    v = spec.vocab_size
    l_max = cfg.max_steps
    dev = enc_feat.device
    cache = A.precompute(params["attention"], spec.attention, enc_feat,
                         enc_len, compute_dtype)

    # min/max output lengths are ratios of the INPUT feature length
    min_len = torch.ceil(feat_len.float() * cfg.min_len_ratio)
    max_len = torch.clamp(torch.ceil(feat_len.float() * cfg.max_len_ratio),
                          1, l_max).long()

    def beams(x):  # (L,B,H) -> (L,B,K,H)
        return x[:, :, None].repeat(1, 1, k, 1)

    def flat(state):  # (L,B,K,H) -> (L,B*K,H)
        return _map_state(
            lambda x: x.reshape(x.shape[0], b * k, x.shape[-1]), state)

    def unflat(state):
        return _map_state(
            lambda x: x.reshape(x.shape[0], b, k, x.shape[-1]), state)

    # CTC posteriors and the prefix state of the empty prefix, per beam
    if cfg.apply_ctc:
        ctc_logp = M.ctc_log_probs(params, spec, enc_feat, compute_dtype)
        r = CP.init_state(ctc_logp, enc_len)[:, None].repeat(1, k, 1, 1)
        psi_prev = torch.zeros(b, k, device=dev)

    # initial beam state: only beam 0 live, to avoid duplicates
    dec_state = _map_state(beams, M.dec_zero_state(spec, b, dev))
    prev_att = A.init_prev_att(enc_len, t_enc, spec.attention.num_head)[
        :, None].repeat(1, k, 1, 1)
    lm_state = (_map_state(beams, LM.lm_zero_state(lm_spec, b, dev))
                if cfg.apply_lm else None)
    tokens = torch.zeros(b, k, l_max, dtype=torch.long, device=dev)
    score_sum = torch.zeros(b, k, device=dev)
    score_sum[:, 1:] = NEG_INF
    alive = torch.zeros(b, k, dtype=torch.bool, device=dev)
    alive[:, 0] = True
    fin_tokens = torch.zeros(b, k, l_max, dtype=torch.long, device=dev)
    fin_scores = torch.full((b, k), NEG_INF, device=dev)
    fin_len = torch.zeros(b, k, dtype=torch.long, device=dev)
    neg_inf = torch.tensor(NEG_INF, device=dev)

    for t in range(l_max):
        last_tok = (tokens[:, :, t - 1] if t > 0
                    else torch.zeros(b, k, dtype=torch.long, device=dev))

        # ---- decoder step: attention on the (B,K) beam axis, RNN flattened
        emb = params["pre_embed"][last_tok]                       # B,K,E
        dec_state_f = flat(dec_state)
        query = M.dec_query(spec, dec_state_f).reshape(b, k, -1)
        context, _, new_prev_att = A.attention_step_beam(
            params["attention"], spec.attention, query, cache, prev_att,
            compute_dtype)
        dec_in = torch.cat([emb, context], dim=-1).reshape(b * k, -1)
        logits, _, dec_state_f = M.decoder_rnn_step(params, spec, dec_in,
                                                    dec_state_f, compute_dtype)
        att_logp = torch.log_softmax(logits, dim=-1).reshape(b, k, v)
        new_dec_state = unflat(dec_state_f)

        # ---- CTC prefix rescoring on the top-C attention candidates: psi
        # is a masked log-sum-exp; the forward variables advance after
        # selection, for the one token each beam took
        cur = att_logp
        if cfg.apply_ctc:
            _, cand = _top_k(att_logp, c)                         # B,K,C
            psi = CP.score_psi(ctc_logp, enc_len, r, last_tok, cand, t)
            scattered = _scatter_v(torch.full_like(att_logp, LOG_ZERO), cand,
                                   psi - psi_prev[:, :, None])
            cur = ((1 - cfg.ctc_weight) * att_logp
                   + cfg.ctc_weight * scattered)

        # block <sos>/<pad>
        cur = cur.clone()
        cur[:, :, 0] = LOG_ZERO

        # ---- LM shallow fusion ----
        if cfg.apply_lm:
            lm_logits, lm_state_f = LM.lm_step(
                lm_params, lm_spec, last_tok.reshape(b * k), flat(lm_state),
                compute_dtype)
            cur = cur + cfg.lm_weight * torch.log_softmax(
                lm_logits, dim=-1).reshape(b, k, v)
            new_lm_state = unflat(lm_state_f)

        # ---- per-beam top-K expansion ----
        topv, topi = _top_k(cur, k)                               # B,K,K
        max_no_eos = att_logp[:, :, 2:].max(dim=-1).values
        eos_ok = att_logp[:, :, 1] > cfg.eos_threshold * max_no_eos
        is_eos = topi == 1
        len_ok = (t >= min_len)[:, None, None]
        in_budget = (t < max_len)[:, None, None]
        eos_taken = is_eos & eos_ok[:, :, None]
        final_mask = eos_taken & len_ok & in_budget & alive[:, :, None]
        # an <eos> that PASSES the threshold is consumed (final or, below
        # min_len, discarded); one that FAILS stays a live hypothesis
        expandable = ~eos_taken & alive[:, :, None] & in_budget
        new_len = float(t + 1)
        cand_sum = score_sum[:, :, None] + topv                   # B,K,K
        cand_avg = torch.where(expandable, cand_sum / new_len, neg_inf)

        # ---- finished pool update (eos finals + max-len cap) ----
        fin_eos_avg = torch.where(
            final_mask.any(dim=-1),
            (score_sum + torch.where(final_mask, topv, neg_inf).max(
                dim=-1).values) / new_len,
            neg_inf)
        fin_eos_tok = _set_step(tokens, t, torch.ones_like(last_tok))
        at_cap = (t == max_len)[:, None] & alive
        cap_avg = torch.where(at_cap, score_sum / max(float(t), 1.0), neg_inf)
        pool_scores = torch.cat([fin_scores, fin_eos_avg, cap_avg], dim=1)
        pool_tokens = torch.cat([fin_tokens, fin_eos_tok, tokens], dim=1)
        pool_len = torch.cat([fin_len, torch.full_like(fin_len, t + 1),
                              torch.full_like(fin_len, t)], dim=1)
        _, keep = _top_k(pool_scores, k)
        fin_scores = torch.gather(pool_scores, 1, keep)
        fin_len = torch.gather(pool_len, 1, keep)
        fin_tokens = _gather_k(pool_tokens, keep)

        # ---- global top-K over (K parents x K candidates) ----
        sel_avg, sel = _top_k(cand_avg.reshape(b, k * k), k)
        parent = torch.div(sel, k, rounding_mode="floor")
        new_tok = torch.gather(topi.reshape(b, k * k), 1, sel)
        alive = sel_avg > NEG_INF / 2
        score_sum = torch.where(
            alive, torch.gather(cand_sum.reshape(b, k * k), 1, sel), neg_inf)
        tokens = _set_step(_gather_k(tokens, parent), t, new_tok)
        dec_state = _gather_state(new_dec_state, parent)
        prev_att = _gather_k(new_prev_att, parent)
        if cfg.apply_lm:
            lm_state = _gather_state(new_lm_state, parent)
        if cfg.apply_ctc:
            # psi of the taken token is recomputed exactly, then r advances
            r_par = _gather_k(r, parent)
            last_par = torch.gather(last_tok, 1, parent)
            psi_prev = CP.score_psi(ctc_logp, enc_len, r_par, last_par,
                                    new_tok[:, :, None], t)[:, :, 0]
            r = CP.advance_state(ctc_logp, enc_len, r_par, last_par, new_tok,
                                 t)

    # ---- final ranking: finished pool + beams alive at l_max ----
    live_avg = torch.where(alive, score_sum / float(l_max), neg_inf)
    all_scores = torch.cat([fin_scores, live_avg], dim=1)
    all_tokens = torch.cat([fin_tokens, tokens], dim=1)
    all_len = torch.cat([fin_len, torch.full_like(fin_len, l_max)], dim=1)
    best, idx = _top_k(all_scores, k)
    return {"tokens": _gather_k(all_tokens, idx), "avg_scores": best,
            "out_len": torch.gather(all_len, 1, idx)}
