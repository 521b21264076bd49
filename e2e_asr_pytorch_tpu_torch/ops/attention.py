"""Attention ops for the LAS decoder: scaled-dot and location-aware (port of
e2e_asr_pytorch_tpu/ops/attention.py).

Keys/values and the padding mask are projected once per utterance by
``precompute``; each step maps (params, cache, query, prev_att) to
(context, attn, new_prev_att). The location conv over the previous attention
is a banded matmul against ``loc_band`` (N,T,T*Kn). The beam variants take a
(B,K,...) query and broadcast the beam axis against the UN-replicated
per-utterance tables: they are never repeated K times, which would also sum
K copies of the location features through loc_band's head axis.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from e2e_asr_pytorch_tpu_torch.ops.rnn import (espnet_linear_init, linear,
                                              matmul_f32)

NEG_INF = -1e30


class AttnConfig(NamedTuple):
    mode: str            # 'dot' | 'loc'
    dim: int
    num_head: int
    temperature: float
    v_proj: bool
    v_dim: int           # encoder output dim
    q_dim: int           # query dim (decoder dim * layers)
    loc_kernel_size: int = 100
    loc_kernel_num: int = 10


def attention_init(gen: torch.Generator, cfg: AttnConfig) -> Dict:
    p = {"proj_q": espnet_linear_init(gen, cfg.q_dim, cfg.dim * cfg.num_head),
         "proj_k": espnet_linear_init(gen, cfg.v_dim, cfg.dim * cfg.num_head)}
    if cfg.v_proj:
        p["proj_v"] = espnet_linear_init(gen, cfg.v_dim,
                                         cfg.v_dim * cfg.num_head)
    if cfg.num_head > 1:
        p["merge_head"] = espnet_linear_init(gen, cfg.v_dim * cfg.num_head,
                                             cfg.v_dim)
    if cfg.mode == "loc":
        kw = 2 * cfg.loc_kernel_size + 1
        n_in = cfg.num_head * kw
        p["loc_conv"] = {"w": torch.randn(
            (kw, cfg.num_head, cfg.loc_kernel_num), generator=gen)
            / math.sqrt(n_in)}
        p["loc_proj"] = {"w": torch.randn(
            (cfg.loc_kernel_num, cfg.dim), generator=gen)
            / math.sqrt(cfg.loc_kernel_num)}
        p["gen_energy"] = espnet_linear_init(gen, cfg.dim, 1)
    return p


def init_prev_att(enc_len: torch.Tensor, t: int,
                  num_head: int) -> torch.Tensor:
    """Uniform attention over valid frames (B,N,T)."""
    valid = (torch.arange(t, device=enc_len.device)[None, :]
             < enc_len[:, None]).float()
    att = valid / torch.clamp(enc_len[:, None].float(), min=1.0)
    return att[:, None, :].repeat(1, num_head, 1)


def loc_band_matrix(w_conv: torch.Tensor, t: int) -> torch.Tensor:
    """The location conv as a banded matmul operator: taps (kw,N,Kn) ->
    (N,T,T*Kn) so that loc = prev_att @ M reshaped to (B,T,Kn)."""
    kw, n, kn = w_conv.shape
    pad = kw // 2
    # M[s, t] = w[s - t + pad] inside the band, else 0: with the taps
    # zero-padded to v[i] = w[i - (T-1) + pad] over 2T-1 rows, M[s, t] =
    # v[s + (T-1-t)], the windows of v read backwards. JAX gathers the
    # taps; a gather's gradient scatter-adds T*T rows into kw in no fixed
    # order, where unfold's sums each tap's windows in order.
    v = torch.nn.functional.pad(w_conv.reshape(kw, n * kn),
                                (0, 0, t - 1 - pad, t - kw + pad))
    m = v.unfold(0, t, 1).flip(-1)                        # (T,N*Kn,T)
    return m.reshape(t, n, kn, t).permute(1, 0, 3, 2).reshape(n, t, t * kn)


def precompute(params: Dict, cfg: AttnConfig, enc_feat: torch.Tensor,
               enc_len: torch.Tensor, compute_dtype=torch.float32) -> Dict:
    """Project keys/values once per utterance. enc_feat: (B,T,De)."""
    b, t, _ = enc_feat.shape
    k = torch.tanh(linear(params["proj_k"], enc_feat, compute_dtype,
                          out_dtype=compute_dtype))
    k = k.reshape(b, t, cfg.num_head, cfg.dim)
    if cfg.v_proj:
        v = torch.tanh(linear(params["proj_v"], enc_feat, compute_dtype,
                              out_dtype=compute_dtype))
        v = v.reshape(b, t, cfg.num_head, cfg.v_dim)
    else:
        v = enc_feat[:, :, None, :]
    # The tables are stored once per utterance in the dtype every step
    # reads them in: the context reduction runs in f32 (JAX promotes the
    # compute-dtype values exactly), the location matmul in compute_dtype.
    # The head axis of an un-projected value table is a broadcast view.
    v = v.float().expand(b, t, cfg.num_head, v.shape[-1])
    mask = (torch.arange(t, device=enc_feat.device)[None, :]
            < enc_len[:, None])
    cache = {"key": k, "value": v, "mask": mask}
    if cfg.mode == "loc":
        cache["loc_band"] = loc_band_matrix(params["loc_conv"]["w"],
                                            t).to(compute_dtype)
    return cache


def _energy_to_attn(cfg: AttnConfig, energy: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    energy = energy / cfg.temperature
    energy = torch.where(mask, energy, torch.full_like(energy, NEG_INF))
    return torch.softmax(energy, dim=-1)


def attention_weights_step(params: Dict, cfg: AttnConfig, query: torch.Tensor,
                           cache: Dict, prev_att: Optional[torch.Tensor],
                           compute_dtype=torch.float32):
    """Attention weights for one step: query (B,q_dim) -> (attn (B,N,T),
    new_prev_att)."""
    b = query.shape[0]
    t = cache["key"].shape[1]
    q = torch.tanh(linear(params["proj_q"], query, compute_dtype))
    q = q.reshape(b, cfg.num_head, cfg.dim)
    if cfg.mode == "dot":
        energy = torch.einsum("bnd,btnd->bnt", q, cache["key"].float())
    elif cfg.mode == "loc":
        band = cache["loc_band"]
        loc = matmul_f32(prev_att.reshape(b, -1),
                         band.reshape(-1, band.shape[-1]), compute_dtype)
        loc = loc.reshape(b, t, cfg.loc_kernel_num)
        loc_ctx = torch.tanh(linear(params["loc_proj"], loc, compute_dtype))
        e_in = torch.tanh(cache["key"] + q[:, None, :, :]
                          + loc_ctx[:, :, None, :])
        energy = linear(params["gen_energy"], e_in, compute_dtype)[..., 0]
        energy = energy.transpose(1, 2)                         # B,N,T
    else:
        raise NotImplementedError(cfg.mode)
    attn = _energy_to_attn(cfg, energy, cache["mask"][:, None, :])
    return attn, (attn if cfg.mode == "loc" else prev_att)


def attention_weights_step_beam(params: Dict, cfg: AttnConfig,
                                query: torch.Tensor, cache: Dict,
                                prev_att: Optional[torch.Tensor],
                                compute_dtype=torch.float32):
    """Beam-axis attention weights: query (B,K,q_dim), prev_att (B,K,N,T)
    against the un-replicated cache. Returns (attn (B,K,N,T), new_prev)."""
    b, k = query.shape[:2]
    t = cache["key"].shape[1]
    q = torch.tanh(linear(params["proj_q"], query, compute_dtype))
    q = q.reshape(b, k, cfg.num_head, cfg.dim)
    if cfg.mode == "dot":
        energy = torch.einsum("bknd,btnd->bknt", q, cache["key"].float())
    elif cfg.mode == "loc":
        band = cache["loc_band"]
        loc = matmul_f32(prev_att.reshape(b, k, -1),
                         band.reshape(-1, band.shape[-1]), compute_dtype)
        loc = loc.reshape(b, k, t, cfg.loc_kernel_num)
        loc_ctx = torch.tanh(linear(params["loc_proj"], loc, compute_dtype))
        # (B,K,T,N,D): key broadcast over K, query over T, loc over N
        e_in = torch.tanh(cache["key"][:, None] + q[:, :, None, :, :]
                          + loc_ctx[:, :, :, None, :])
        energy = linear(params["gen_energy"], e_in, compute_dtype)[..., 0]
        energy = energy.transpose(2, 3)                         # B,K,N,T
    else:
        raise NotImplementedError(cfg.mode)
    attn = _energy_to_attn(cfg, energy, cache["mask"][:, None, None, :])
    return attn, (attn if cfg.mode == "loc" else prev_att)


def attention_step_beam(params: Dict, cfg: AttnConfig, query: torch.Tensor,
                        cache: Dict, prev_att: Optional[torch.Tensor],
                        compute_dtype=torch.float32):
    """One beam-axis step: query (B,K,q_dim) -> (context (B,K,v_dim), attn
    (B,K,N,T), new_prev_att). The context contracts the value table once for
    all K beams."""
    b, k = query.shape[:2]
    attn, new_prev = attention_weights_step_beam(params, cfg, query, cache,
                                                 prev_att, compute_dtype)
    context = torch.einsum("bknt,btnd->bknd", attn, cache["value"])
    if cfg.num_head > 1:
        context = linear(params["merge_head"],
                         context.reshape(b, k, cfg.num_head * cfg.v_dim),
                         compute_dtype)
    else:
        context = context[:, :, 0, :]
    return context, attn, new_prev


def attention_step(params: Dict, cfg: AttnConfig, query: torch.Tensor,
                   cache: Dict, prev_att: Optional[torch.Tensor],
                   compute_dtype=torch.float32):
    """One step: query (B,q_dim) -> (context (B,v_dim), attn (B,N,T),
    new_prev_att)."""
    b = query.shape[0]
    attn, new_prev = attention_weights_step(params, cfg, query, cache,
                                            prev_att, compute_dtype)
    context = torch.einsum("bnt,btnd->bnd", attn, cache["value"])
    if cfg.num_head > 1:
        context = linear(params["merge_head"],
                         context.reshape(b, cfg.num_head * cfg.v_dim),
                         compute_dtype)
    else:
        context = context[:, 0, :]
    return context, attn, new_prev
