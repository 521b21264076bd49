"""Batched greedy decoding (port of e2e_asr_pytorch_tpu/decode/greedy.py):
attention argmax feedback, plus the CTC best path with repeat/blank collapse
when the model has a CTC head."""

from __future__ import annotations

from typing import Dict

import torch

from e2e_asr_pytorch_tpu_torch.models import asr as M
from e2e_asr_pytorch_tpu_torch.ops.ctc import ctc_greedy_collapse


@torch.no_grad()
def greedy_decode(params: Dict, spec: M.ASRSpec, feat: torch.Tensor,
                  feat_len: torch.Tensor, decode_step: int, emb_reg=None,
                  compute_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Returns att_tokens (B,L) (if attention enabled) and ctc_tokens (B,T)
    (if CTC enabled; blank-collapsed, left-aligned)."""
    if emb_reg is not None:
        raise NotImplementedError(
            "the embedding-fusion plugin is not ported yet (ROADMAP: joint "
            "CTC prefix scoring and emb-fusion in beam search)")
    ctc_out, enc_len, att_out, _, _ = M.asr_apply(
        params, spec, feat, feat_len, decode_step,
        compute_dtype=compute_dtype)
    out = {}
    if att_out is not None:
        out["att_tokens"] = torch.argmax(att_out, dim=-1).int()
    if ctc_out is not None:
        best = torch.argmax(ctc_out, dim=-1).int()
        mask = (torch.arange(best.shape[1], device=best.device)[None, :]
                < enc_len[:, None])
        best = torch.where(mask, best, torch.zeros_like(best))
        out["ctc_tokens"] = ctc_greedy_collapse(best)
        out["enc_len"] = enc_len
    return out
