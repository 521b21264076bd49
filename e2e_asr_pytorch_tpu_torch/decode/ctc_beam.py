"""Pure-CTC prefix beam search, batched (port of
e2e_asr_pytorch_tpu/decode/ctc_beam.py), for CTC-only models
(``ctc_weight: 1``).

The standard CTC prefix beam search (Graves 2012 / Hannun 2014) as a loop
over encoder frames with a (B,K) beam axis:

  * each prefix carries (p_blank, p_nonblank) in log space; the "stay" path
    folds the blank extension and the repeat without a blank into slot 0,
    and extensions use p_b (after a blank) vs logaddexp(p_b, p_nb) for a
    candidate equal to the last token;
  * each frame, every beam proposes its top-C symbol extensions plus the
    stay case, and a global top-K over K*(C+1) keeps the beam fixed-shape;
  * LM shallow fusion adds lm_weight * logP_LM(c | prefix) on extension;
  * frames past an utterance's enc_len change nothing;
  * prefixes of different parents are not merged (the fixed-shape
    approximation of the JAX package); the blank/repeat merge is exact.

Every top-k breaks ties toward the lower index, as ``lax.top_k`` does, and
the final ranking is a stable sort, as ``jnp.argsort``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from e2e_asr_pytorch_tpu_torch.decode.beam import (_gather_state, _map_state,
                                                   _top_k)
from e2e_asr_pytorch_tpu_torch.models import lm as LM

LOG_ZERO = -1e9
NEG_INF = -1e30


class CTCBeamConfig(NamedTuple):
    beam_size: int
    cand_size: int = 8        # symbol extensions proposed per beam per frame
    max_tokens: int = 0       # output token buffer length
    lm_weight: float = 0.0

    @property
    def apply_lm(self) -> bool:
        return self.lm_weight > 0


@torch.no_grad()
def ctc_beam_decode(ctc_logp: torch.Tensor, enc_len: torch.Tensor,
                    cfg: CTCBeamConfig, lm_params: Optional[Dict] = None,
                    lm_spec: Optional[LM.LMSpec] = None,
                    compute_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Decode a batch of CTC posteriors.

    ctc_logp: (B,T,V) log-softmax CTC output (blank = 0).
    Returns dict: tokens (B,K,L) best-first, scores (B,K), out_len (B,K)."""
    b, _, v = ctc_logp.shape
    k, c, l_max = cfg.beam_size, cfg.cand_size, cfg.max_tokens
    dev = ctc_logp.device
    neg_inf = torch.tensor(NEG_INF, device=dev)

    tokens = torch.zeros(b, k, l_max, dtype=torch.long, device=dev)
    lens = torch.zeros(b, k, dtype=torch.long, device=dev)
    # the empty prefix: p_b = 0 (it emitted nothing), every other beam dead
    p_b = torch.full((b, k), NEG_INF, device=dev)
    p_b[:, 0] = 0.0
    p_nb = torch.full((b, k), NEG_INF, device=dev)
    alive = torch.zeros(b, k, dtype=torch.bool, device=dev)
    alive[:, 0] = True
    lm_state = None
    if cfg.apply_lm:
        lm_state = _map_state(lambda x: x[:, :, None].repeat(1, 1, k, 1),
                              LM.lm_zero_state(lm_spec, b, dev))
    positions = torch.arange(l_max, device=dev)

    # frames past every utterance's enc_len would change nothing
    for t in range(int(enc_len.max())):
        lp = ctc_logp[:, t, :]                                  # B,V
        active = t < enc_len                                    # B

        has_last = lens > 0
        last_tok = torch.where(
            has_last, torch.gather(tokens, 2, torch.clamp(
                lens - 1, min=0)[:, :, None])[:, :, 0], -1)      # B,K
        last_or_0 = torch.clamp(last_tok, min=0)

        # ---- stay case (same prefix): blank path + repeat path
        total = torch.logaddexp(p_b, p_nb)
        stay_b = total + lp[:, None, 0]
        lp_last = torch.gather(lp, 1, last_or_0)
        stay_nb = torch.where(last_tok >= 0, p_nb + lp_last, neg_inf)
        stay_score = torch.where(alive, torch.logaddexp(stay_b, stay_nb),
                                 neg_inf)

        # ---- extension candidates: per-beam top-C non-blank symbols
        lp_masked = lp.clone()
        lp_masked[:, 0] = NEG_INF                               # no blank
        if cfg.apply_lm:
            lm_state_f = _map_state(
                lambda x: x.reshape(x.shape[0], b * k, x.shape[-1]), lm_state)
            lm_logits, lm_state_f = LM.lm_step(
                lm_params, lm_spec, last_or_0.reshape(b * k), lm_state_f,
                compute_dtype)
            lm_lp = torch.log_softmax(lm_logits, dim=-1).reshape(b, k, v)
            ext_base = lp_masked[:, None, :] + cfg.lm_weight * lm_lp
            new_lm_state = _map_state(
                lambda x: x.reshape(x.shape[0], b, k, x.shape[-1]),
                lm_state_f)
        else:
            ext_base = lp_masked[:, None, :].expand(b, k, v)
        cand_lp, cand = _top_k(ext_base, c)                     # B,K,C

        base = torch.where(cand == last_tok[:, :, None], p_b[:, :, None],
                           total[:, :, None])
        ext_nb = torch.where(alive[:, :, None] & (lens < l_max)[:, :, None],
                             base + cand_lp, neg_inf)

        # ---- global top-K over (stay | extensions) = K*(1+C) slots
        all_scores = torch.cat([stay_score[:, :, None], ext_nb],
                               dim=2).reshape(b, k * (1 + c))
        sel_score, sel = _top_k(all_scores, k)
        parent = torch.div(sel, 1 + c, rounding_mode="floor")
        slot = sel % (1 + c)                                    # 0 = stay
        is_stay = slot == 0

        def par(x):
            return torch.gather(x, 1, parent)
        par_tokens = torch.gather(
            tokens, 1, parent[:, :, None].expand(b, k, l_max))
        par_lens = par(lens)
        par_cand = torch.gather(cand, 1, parent[:, :, None].expand(b, k, c))
        new_tok = torch.gather(par_cand, 2, torch.clamp(
            slot - 1, min=0)[:, :, None])[:, :, 0]
        write = ((positions[None, None, :] == par_lens[:, :, None])
                 & ~is_stay[:, :, None])
        new_tokens = torch.where(write, new_tok[:, :, None], par_tokens)
        new_lens = par_lens + (~is_stay).long()

        # stay keeps (p_b', p_nb'); an extension starts with p_b = -inf
        new_p_b = torch.where(is_stay, par(stay_b), neg_inf)
        new_p_nb = torch.where(is_stay, par(stay_nb), sel_score)
        new_alive = sel_score > NEG_INF / 2

        # frames past enc_len change nothing
        def keep(new, old):
            return torch.where(
                active.reshape((b,) + (1,) * (new.ndim - 1)), new, old)
        tokens, lens = keep(new_tokens, tokens), keep(new_lens, lens)
        p_b, p_nb = keep(new_p_b, p_b), keep(new_p_nb, p_nb)
        alive = keep(new_alive, alive)
        if cfg.apply_lm:
            lm_state = _keep_state(active, _gather_state(new_lm_state,
                                                         parent), lm_state)

    scores = torch.where(alive, torch.logaddexp(p_b, p_nb), neg_inf)
    order = torch.argsort(-scores, dim=1, stable=True)
    return {"tokens": torch.gather(tokens, 1,
                                   order[:, :, None].expand(b, k, l_max)),
            "scores": torch.gather(scores, 1, order),
            "out_len": torch.gather(lens, 1, order)}


def _keep_state(active: torch.Tensor, new, old):
    """An RNN state of (L,B,K,H) leaves: ``new`` where the utterance is
    ``active`` (B,), else ``old``."""
    if isinstance(new, tuple):
        return tuple(_keep_state(active, n, o) for n, o in zip(new, old))
    return torch.where(active[None, :, None, None], new, old)
