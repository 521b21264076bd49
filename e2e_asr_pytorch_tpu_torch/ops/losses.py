"""Sequence losses: label smoothing and masked cross entropy (port of
e2e_asr_pytorch_tpu/ops/losses.py).

``label_smoothing_loss`` keeps the reference's quirk: it averages over ALL
positions, padding included, unless ``mask_pad`` or ``utt_w`` is given.
``cross_entropy_loss`` ignores the <pad>=0 targets.
"""

from __future__ import annotations

from typing import Optional

import torch


def _row_weights(utt_w: Optional[torch.Tensor], shape2d, dtype):
    """(B,) per-utterance weights broadcast to a flattened (B*T,) mask."""
    if utt_w is None:
        return None
    b, t = shape2d
    return utt_w.to(dtype)[:, None].expand(b, t).reshape(-1)


def _flat(logits: torch.Tensor, targets: torch.Tensor):
    shape2d = (tuple(targets.shape) if targets.dim() == 2
               else (targets.shape[0], 1))
    return (shape2d, logits.reshape(-1, logits.shape[-1]),
            targets.reshape(-1).long())


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         num_classes: int, smoothing: float = 0.1,
                         mask_pad: bool = False, pad_id: int = 0,
                         utt_w: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """logits (N,V) or (B,T,V); targets (N,) or (B,T)."""
    shape2d, logits, targets = _flat(logits, targets)
    logp = torch.log_softmax(logits, dim=-1)
    confidence = 1.0 - smoothing
    smear = smoothing / (num_classes - 1)
    tgt_logp = torch.gather(logp, 1, targets[:, None])[:, 0]
    # sum(-true_dist * logp) = -(confidence - smear)*logp[tgt] - smear*sum(logp)
    per_pos = -(confidence - smear) * tgt_logp - smear * logp.sum(dim=-1)
    if not mask_pad and utt_w is None:
        return per_pos.mean()
    mask = torch.ones_like(per_pos)
    if mask_pad:
        mask = mask * (targets != pad_id).to(per_pos.dtype)
    row_w = _row_weights(utt_w, shape2d, per_pos.dtype)
    if row_w is not None:
        mask = mask * row_w
    return (per_pos * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       ignore_index: int = 0,
                       utt_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over non-ignored positions (torch ignore_index semantics)."""
    shape2d, logits, targets = _flat(logits, targets)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, targets.clamp(min=0)[:, None])[:, 0]
    mask = (targets != ignore_index).to(nll.dtype)
    row_w = _row_weights(utt_w, shape2d, nll.dtype)
    if row_w is not None:
        mask = mask * row_w
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
