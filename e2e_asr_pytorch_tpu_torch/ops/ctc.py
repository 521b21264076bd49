"""CTC loss and greedy collapse (port of e2e_asr_pytorch_tpu/ops/ctc.py).

The loss is the JAX package's log-semiring alpha recursion over time with
the blank-interleaved extended labels, masked for padded frames and labels,
as plain torch ops with autograd through the loop. It keeps the finite
log-zero ``LOG_EPS``, so an impossible alignment gives a huge finite loss
(~1e10 / label length), not inf as ``torch.nn.functional.ctc_loss`` would.
Semantics of torch.nn.CTCLoss(blank=0, reduction='mean'): per-utterance
losses are divided by label length, then averaged over the batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from e2e_asr_pytorch_tpu_torch.ops.losses import weighted_mean

LOG_EPS = -1e10  # effective log-zero (finite to keep grads clean)


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x shifted right by k along the last axis, ``fill`` coming in."""
    return torch.nn.functional.pad(x, (k, 0), value=fill)[..., :x.shape[-1]]


class _EmitGather(torch.autograd.Function):
    """``log_probs`` (B,T,V) read at the extended labels ``ext`` (B,S):
    (B,T,S). The forward is ``torch.gather``; the backward sums each
    label's positions as a product with the labels' one-hot (B,S,V) in a
    fixed order, where gather's own backward scatter-adds S positions into
    V columns (every other one into <blank>) with atomics, whose order,
    and so whose rounding, changes from run to run on the card."""

    @staticmethod
    def forward(ctx, log_probs, ext):
        b, t, v = log_probs.shape
        ctx.save_for_backward(ext)
        ctx.vocab = v
        return torch.gather(log_probs, 2,
                            ext[:, None, :].expand(b, t, ext.shape[1]))

    @staticmethod
    def backward(ctx, grad):
        ext, = ctx.saved_tensors
        onehot = torch.nn.functional.one_hot(ext, ctx.vocab).to(grad.dtype)
        return torch.bmm(grad, onehot), None


def ctc_forward_scores(log_probs: torch.Tensor, input_len: torch.Tensor,
                       labels: torch.Tensor, label_len: torch.Tensor,
                       blank: int = 0) -> torch.Tensor:
    """Per-utterance negative log-likelihood, shape (B,). log_probs (B,T,V)
    log-softmax outputs; labels (B,L) padded with any id."""
    b, t_max, _ = log_probs.shape
    labels = labels.long()
    label_len = label_len.long()
    input_len = input_len.long()
    ext = torch.full((b, 2 * labels.shape[1] + 1), blank, dtype=torch.long,
                     device=labels.device)
    ext[:, 1::2] = labels                                          # (B,S)
    s = ext.shape[1]
    pos = torch.arange(s, device=labels.device)[None, :]
    # the skip transition alpha[s-2] only for non-blank positions whose
    # label differs from the one two steps back
    can_skip = (ext != blank) & (ext != _shift(ext, 2, -1))
    valid_pos = pos < (2 * label_len[:, None] + 1)
    emit = _EmitGather.apply(log_probs, ext.clamp(min=0))
    emit = emit.transpose(0, 1)                                    # (T,B,S)
    eps = torch.full((b, s), LOG_EPS, dtype=log_probs.dtype,
                     device=log_probs.device)
    alpha = eps.clone()
    alpha[:, 0] = emit[0][:, 0]
    if s > 1:  # position 1 exists only if label_len > 0
        alpha[:, 1] = torch.where(label_len > 0, emit[0][:, 1], eps[:, 1])
    alpha = torch.where(valid_pos, alpha, eps)
    for t in range(1, t_max):
        a_prev1 = _shift(alpha, 1, LOG_EPS)
        a_prev2 = torch.where(can_skip, _shift(alpha, 2, LOG_EPS), eps)
        new = torch.logaddexp(torch.logaddexp(alpha, a_prev1),
                              a_prev2) + emit[t]
        new = torch.where(valid_pos, new, eps)
        # freeze once past this utterance's last frame
        alpha = torch.where((t < input_len)[:, None], new, alpha)
    last = 2 * label_len[:, None]
    a_last = torch.gather(alpha, 1, last)[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp(last - 1, min=0))[:, 0]
    a_prev = torch.where(label_len > 0, a_prev, eps[:, 0])
    return -torch.logaddexp(a_last, a_prev)


def ctc_loss(log_probs: torch.Tensor, input_len: torch.Tensor,
             labels: torch.Tensor, label_len: torch.Tensor, blank: int = 0,
             reduction: str = "mean",
             utt_w: Optional[torch.Tensor] = None,
             global_sum=None) -> torch.Tensor:
    """torch.nn.CTCLoss-compatible loss over a padded batch. ``utt_w`` (B,)
    optionally down-weights rows (0 = a padding utterance); ``global_sum``
    sums the weights over the data ranks (``ops/losses.py``)."""
    nll = ctc_forward_scores(log_probs, input_len, labels, label_len, blank)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return (nll if utt_w is None else nll * utt_w).sum()
    per_utt = nll / torch.clamp(label_len, min=1).to(nll.dtype)
    if utt_w is None:
        return per_utt.mean()
    w = utt_w.to(per_utt.dtype)
    return weighted_mean((per_utt * w).sum(), w.sum(), global_sum)


def ctc_greedy_collapse(ids: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Remove repeats then blanks from (B,T) best-path ids; results are
    left-aligned and padded with ``blank``."""
    prev = torch.nn.functional.pad(ids, (1, 0), value=-1)[:, :-1]
    keep = (ids != prev) & (ids != blank)
    # kept tokens scatter to their compacted slot; dropped ones go to an
    # extra column that is cut off
    slot = torch.where(keep, torch.cumsum(keep.long(), dim=1) - 1,
                       torch.full_like(ids, ids.shape[1], dtype=torch.long))
    out = torch.full((ids.shape[0], ids.shape[1] + 1), blank,
                     dtype=ids.dtype, device=ids.device)
    out.scatter_(1, slot, ids)
    return out[:, :-1]
