"""Sequence losses: label smoothing and masked cross entropy (port of
e2e_asr_pytorch_tpu/ops/losses.py).

``label_smoothing_loss`` keeps the reference's quirk: it averages over ALL
positions, padding included, unless ``mask_pad`` or ``utt_w`` is given.
``cross_entropy_loss`` ignores the <pad>=0 targets, and so does
``nll_loss``, its twin over log-probabilities (the emb-fusion output).

Each loss is a weighted sum over the positions divided by the sum of the
weights (or the mean, where JAX takes ``jnp.mean``), in the dtype of the
log-probabilities, as JAX computes it. Under data parallelism
``global_sum`` (``parallel/mesh.py``) sums that denominator over the data
ranks in its own dtype, so each rank's loss is its share of the global
batch's mean, the ranks' gradients add up to the gradient of the
one-device loss, and a one-rank mesh computes the one-device loss bit for
bit.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _row_weights(utt_w: Optional[torch.Tensor], shape2d, dtype):
    """(B,) per-utterance weights broadcast to a flattened (B*T,) mask."""
    if utt_w is None:
        return None
    b, t = shape2d
    return utt_w.to(dtype)[:, None].expand(b, t).reshape(-1)


def weighted_mean(num: torch.Tensor, den: torch.Tensor,
                  global_sum: Optional[Callable] = None) -> torch.Tensor:
    """num / max(den, 1), the denominator summed over the data ranks first
    when ``global_sum`` is given."""
    if global_sum is not None:
        den = global_sum(den)
    return num / torch.clamp(den, min=1.0)


def _flat(logits: torch.Tensor, targets: torch.Tensor):
    shape2d = (tuple(targets.shape) if targets.dim() == 2
               else (targets.shape[0], 1))
    return (shape2d, logits.reshape(-1, logits.shape[-1]),
            targets.reshape(-1).long())


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         num_classes: int, smoothing: float = 0.1,
                         mask_pad: bool = False, pad_id: int = 0,
                         utt_w: Optional[torch.Tensor] = None,
                         global_sum: Optional[Callable] = None
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
        mean = per_pos.mean()
        if global_sum is None:
            return mean
        # JAX's jnp.mean over the global batch: this rank's mean times its
        # share of the positions (exactly 1 on one rank)
        n = torch.tensor(float(per_pos.numel()), device=per_pos.device)
        return mean * (n / global_sum(n)).to(mean.dtype)
    mask = torch.ones_like(per_pos)
    if mask_pad:
        mask = mask * (targets != pad_id).to(per_pos.dtype)
    row_w = _row_weights(utt_w, shape2d, per_pos.dtype)
    if row_w is not None:
        mask = mask * row_w
    return weighted_mean((per_pos * mask).sum(), mask.sum(), global_sum)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       ignore_index: int = 0,
                       utt_w: Optional[torch.Tensor] = None,
                       global_sum: Optional[Callable] = None) -> torch.Tensor:
    """Mean CE over non-ignored positions (torch ignore_index semantics)."""
    return nll_loss(torch.log_softmax(logits, dim=-1), targets, ignore_index,
                    utt_w, global_sum)


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             ignore_index: int = 0, utt_w: Optional[torch.Tensor] = None,
             global_sum: Optional[Callable] = None) -> torch.Tensor:
    """Mean NLL over non-ignored positions of inputs that already are
    log-probabilities (the emb-fusion output, torch's
    ``NLLLoss(ignore_index=0)``)."""
    shape2d, logp, targets = _flat(log_probs, targets)
    nll = -torch.gather(logp, 1, targets.clamp(min=0)[:, None])[:, 0]
    mask = (targets != ignore_index).to(nll.dtype)
    row_w = _row_weights(utt_w, shape2d, nll.dtype)
    if row_w is not None:
        mask = mask * row_w
    return weighted_mean((nll * mask).sum(), mask.sum(), global_sum)
