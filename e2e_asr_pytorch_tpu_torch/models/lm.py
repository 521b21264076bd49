"""RNN language model, tied-embedding LSTM (port of
e2e_asr_pytorch_tpu/models/lm.py): the full-sequence forward for training
(sequences are padded, the loss masks the pads) and the single-token step
for shallow fusion inside beam search."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from e2e_asr_pytorch_tpu_torch.convert import tree_to
from e2e_asr_pytorch_tpu_torch.ops import rnn as R


class LMSpec(NamedTuple):
    vocab_size: int
    emb_tying: bool
    emb_dim: int
    module: str
    dim: int
    n_layers: int
    dropout: float


def build_spec(vocab_size: int, emb_tying: bool, emb_dim: int, module: str,
               dim: int, n_layers: int, dropout: float) -> LMSpec:
    if emb_tying and emb_dim != dim:
        raise ValueError(
            "Output dim of RNN must equal embedding dim when weight tying.")
    return LMSpec(vocab_size, emb_tying, emb_dim, module.upper(), dim,
                  n_layers, dropout)


def lm_init(gen: torch.Generator, spec: LMSpec, device=None) -> Dict:
    """Seeded init (drawn on the CPU from ``gen``, then moved to device)."""
    params = {
        "emb": torch.randn((spec.vocab_size, spec.emb_dim), generator=gen),
        "rnn": R.stacked_init(gen, spec.module, spec.emb_dim, spec.dim,
                              spec.n_layers),
    }
    if not spec.emb_tying:
        params["trans"] = R.espnet_linear_init(gen, spec.dim, spec.vocab_size)
    return tree_to(params, device)


def lm_zero_state(spec: LMSpec, batch: int, device=None):
    return R.stacked_zero_state(spec.module, spec.n_layers, batch, spec.dim,
                                device)


def _output_proj(params: Dict, spec: LMSpec, x: torch.Tensor,
                 compute_dtype=torch.float32,
                 gen: Optional[torch.Generator] = None,
                 train: bool = False) -> torch.Tensor:
    """Dropout (training, with a generator), then the projection onto the
    vocabulary with f32 logits; tied models reuse the embedding matrix."""
    if train and spec.dropout > 0 and gen is not None:
        x = R.dropout(x, spec.dropout, gen)
    if spec.emb_tying:
        return R.matmul_f32(x, params["emb"].t(), compute_dtype)
    return R.linear(params["trans"], x, compute_dtype)


def lm_apply(params: Dict, spec: LMSpec, tokens: torch.Tensor, hidden=None,
             gen: Optional[torch.Generator] = None, train: bool = False,
             compute_dtype=torch.float32):
    """Full-sequence forward: (B,L) -> (logits (B,L,V) f32, final hidden).
    The three dropouts (embedding, between layers, before the projection)
    are drawn from ``gen`` in that order when ``train``; the final hidden is
    None on the stateless (kernel) route."""
    x = params["emb"][tokens]
    if train and spec.dropout > 0 and gen is not None:
        x = R.dropout(x, spec.dropout, gen)
    x, hidden = R.stacked_sequence(params["rnn"], spec.module, x, hidden,
                                   dropout=spec.dropout, gen=gen, train=train,
                                   compute_dtype=compute_dtype)
    return _output_proj(params, spec, x, compute_dtype, gen, train), hidden


def lm_step(params: Dict, spec: LMSpec, token: torch.Tensor, hidden,
            compute_dtype=torch.float32):
    """Single-token step: (B,) -> (logits (B,V) f32, hidden)."""
    x = params["emb"][token]
    out, hidden = R.stacked_step(params["rnn"], spec.module, x, hidden,
                                 compute_dtype=compute_dtype)
    return _output_proj(params, spec, out, compute_dtype), hidden
