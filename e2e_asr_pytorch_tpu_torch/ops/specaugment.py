"""SpecAugment: one time mask and one frequency mask per utterance, filled
with the utterance's mean (port of e2e_asr_pytorch_tpu/ops/specaugment.py).

Split in two so the random draws can be fed in: ``draw_masks`` samples the
mask bounds from a ``torch.Generator`` with the JAX package's two-stage
width sampling (width ~ U[0,max), then end ~ start + U[0,width), so the
effective width is ~U(0,width)), and ``apply_masks`` applies given bounds
deterministically. Masks are half-open ranges [start, end); an empty range
masks nothing.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _rand_below(gen: Optional[torch.Generator], hi: torch.Tensor) -> torch.Tensor:
    """Uniform ints in [0, hi) for a (B,) tensor ``hi`` >= 1."""
    u = torch.rand(hi.shape, generator=gen, device=hi.device)
    return torch.floor(u * hi.float()).long()


def draw_masks(gen: Optional[torch.Generator], feat_len: torch.Tensor,
               f_dim: int, max_t: int = 40, max_f: int = 27,
               num_masks: int = 1) -> Dict[str, torch.Tensor]:
    """Mask bounds for a batch: {t_start, t_end, f_start, f_end}, each
    (B, num_masks) int64 on feat_len's device."""
    b = feat_len.shape[0]
    dev = feat_len.device
    lens = feat_len.long()

    def full(v):
        return torch.full((b,), v, dtype=torch.long, device=dev)
    out = {k: [] for k in ("t_start", "t_end", "f_start", "f_end")}
    for _ in range(num_masks):
        width = _rand_below(gen, full(max_t))
        start = _rand_below(gen, torch.clamp(lens - width, min=1))
        end = start + _rand_below(gen, torch.clamp(width, min=1))
        fwidth = _rand_below(gen, full(max_f))
        fstart = _rand_below(gen, torch.clamp(f_dim - fwidth, min=1))
        fend = fstart + _rand_below(gen, torch.clamp(fwidth, min=1))
        for k, v in zip(out, (start, end, fstart, fend)):
            out[k].append(v)
    return {k: torch.stack(v, dim=1) for k, v in out.items()}


def apply_masks(spec: torch.Tensor, feat_len: torch.Tensor,
                masks: Dict[str, torch.Tensor],
                replace_with_zero: bool = False) -> torch.Tensor:
    """Apply drawn masks to a padded batch (B,T,D): each time range, then
    each frequency range, is filled with the utterance's mean over its valid
    frames (computed before masking); the padding is zeroed."""
    b, t_dim, f_dim = spec.shape
    t_idx = torch.arange(t_dim, device=spec.device)
    f_idx = torch.arange(f_dim, device=spec.device)
    valid = (t_idx[None, :] < feat_len[:, None]).to(spec.dtype)   # (B,T)
    if replace_with_zero:
        fill = torch.zeros(b, 1, 1, dtype=spec.dtype, device=spec.device)
    else:
        total = (spec * valid[:, :, None]).sum(dim=(1, 2))
        count = torch.clamp(feat_len.to(spec.dtype) * f_dim, min=1.0)
        fill = (total / count)[:, None, None]
    for i in range(masks["t_start"].shape[1]):
        tmask = ((t_idx[None, :] >= masks["t_start"][:, i:i + 1])
                 & (t_idx[None, :] < masks["t_end"][:, i:i + 1]))
        spec = torch.where(tmask[:, :, None], fill, spec)
        fmask = ((f_idx[None, :] >= masks["f_start"][:, i:i + 1])
                 & (f_idx[None, :] < masks["f_end"][:, i:i + 1]))
        spec = torch.where(fmask[:, None, :], fill, spec)
    return spec * valid[:, :, None]


def spec_augment(spec: torch.Tensor, feat_len: torch.Tensor,
                 gen: Optional[torch.Generator], max_t: int = 40,
                 max_f: int = 27, num_masks: int = 1,
                 replace_with_zero: bool = False) -> torch.Tensor:
    """Draw masks from ``gen`` and apply them to (B,T,D)."""
    masks = draw_masks(gen, feat_len, spec.shape[2], max_t, max_f, num_masks)
    return apply_masks(spec, feat_len, masks, replace_with_zero)
