"""CTC helpers (port of e2e_asr_pytorch_tpu/ops/ctc.py). Only the greedy
collapse that greedy decoding needs is ported; the CTC loss comes with the
training slice."""

from __future__ import annotations

import torch


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
