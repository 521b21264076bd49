"""Batched greedy decoding (port of e2e_asr_pytorch_tpu/decode/greedy.py):
attention argmax feedback (over the emb-fusion plugin's fused log-probs
when it fuses), plus the CTC best path with repeat/blank collapse when the
model has a CTC head."""

from __future__ import annotations

from typing import Dict

import torch

from e2e_asr_pytorch_tpu_torch.models import asr as M
from e2e_asr_pytorch_tpu_torch.ops.ctc import ctc_greedy_collapse


@torch.no_grad()
def greedy_decode(params: Dict, spec: M.ASRSpec, feat: torch.Tensor,
                  feat_len: torch.Tensor, decode_step: int, emb_reg=None,
                  emb_params=None,
                  compute_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Returns att_tokens (B,L) (if attention enabled) and ctc_tokens (B,T)
    (if CTC enabled; blank-collapsed, left-aligned). ``emb_reg`` (an
    ``EmbeddingRegularizer`` that fuses) with its ``emb_params`` decodes
    over the fused distribution."""
    fuse_fn = None
    if emb_reg is not None and emb_reg.apply_fuse:
        def fuse_fn(d_state, logits):
            return emb_reg.fuse_step(emb_params, d_state, logits)
    ctc_out, enc_len, att_out, _, _ = M.asr_apply(
        params, spec, feat, feat_len, decode_step,
        compute_dtype=compute_dtype, emb_fuse_fn=fuse_fn)
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
