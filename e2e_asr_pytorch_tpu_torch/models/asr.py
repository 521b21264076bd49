"""Joint CTC-attention ASR model (port of e2e_asr_pytorch_tpu/models/asr.py,
inference subset).

Ported: the spec, seeded init, the CTC head, the decoder pieces shared by
greedy and beam decoding, and the free-running (``teacher=None``) forward of
``asr_apply``. The teacher-forced training paths (the generic scan and the
folded decoder of ``fold_vjp.py``) come with the training slice.
``value_table``/``dkey_bf16`` are accepted and inert at decode, as in JAX.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from e2e_asr_pytorch_tpu_torch.convert import tree_to
from e2e_asr_pytorch_tpu_torch.models import encoder as E
from e2e_asr_pytorch_tpu_torch.ops import attention as A
from e2e_asr_pytorch_tpu_torch.ops import rnn as R


class DecoderSpec(NamedTuple):
    module: str
    dim: int
    layer: int
    dropout: float
    in_dim: int         # enc_out_dim + emb_dim
    vocab_size: int


class ASRSpec(NamedTuple):
    input_size: int
    vocab_size: int
    ctc_weight: float
    encoder: E.EncoderSpec
    attention: Optional[A.AttnConfig]
    decoder: Optional[DecoderSpec]
    emb_drop: float = 0.0
    value_table: str = "bf16"
    dkey_bf16: bool = False

    @property
    def enable_ctc(self) -> bool:
        return self.ctc_weight > 0

    @property
    def enable_att(self) -> bool:
        return self.ctc_weight != 1


def build_spec(input_size: int, vocab_size: int, ctc_weight: float,
               encoder: Dict, attention: Dict, decoder: Dict,
               emb_drop: float = 0.0, init_adadelta: bool = True,
               value_table: str = "bf16", dkey_bf16: bool = False) -> ASRSpec:
    """Construct the static model spec from the YAML ``model:`` block."""
    if not 0 <= ctc_weight <= 1:
        raise ValueError("ctc_weight must be in [0, 1], got {}".format(
            ctc_weight))
    if value_table not in ("bf16", "int8"):
        raise ValueError("value_table must be bf16 or int8")
    enc = E.make_spec(input_size, **encoder)
    attn_cfg = dec = None
    if ctc_weight != 1:
        if decoder["module"] != "LSTM":
            raise NotImplementedError(
                "only LSTM decoders are ported (ROADMAP: GRU/liGRU, K7/K8)")
        dec_dim = decoder["dim"]
        dec = DecoderSpec(decoder["module"], dec_dim, decoder["layer"],
                          decoder["dropout"], enc.out_dim + dec_dim,
                          vocab_size)
        attn_cfg = A.AttnConfig(
            mode=attention["mode"].lower(), dim=attention["dim"],
            num_head=attention["num_head"],
            temperature=attention["temperature"],
            v_proj=attention["v_proj"], v_dim=enc.out_dim,
            q_dim=dec_dim * decoder["layer"],
            loc_kernel_size=attention.get("loc_kernel_size", 100),
            loc_kernel_num=attention.get("loc_kernel_num", 10))
    return ASRSpec(input_size, vocab_size, ctc_weight, enc, attn_cfg, dec,
                   emb_drop, value_table, dkey_bf16)


def asr_init(gen: torch.Generator, spec: ASRSpec, device=None) -> Dict:
    """Seeded init (drawn on the CPU from ``gen``, then moved to device)."""
    params: Dict = {"encoder": E.encoder_init(gen, spec.encoder)}
    if spec.enable_ctc:
        params["ctc_layer"] = R.espnet_linear_init(gen, spec.encoder.out_dim,
                                                   spec.vocab_size)
    if spec.enable_att:
        dec = spec.decoder
        params["pre_embed"] = torch.randn((spec.vocab_size, dec.dim),
                                          generator=gen)
        params["decoder"] = {
            "layers": R.stacked_init(gen, dec.module, dec.in_dim, dec.dim,
                                     dec.layer, forget_bias=True),
            "char_trans": R.espnet_linear_init(gen, dec.dim, dec.vocab_size),
        }
        params["attention"] = A.attention_init(gen, spec.attention)
    return tree_to(params, device)


# ---------------------------------------------------------------------------
# pieces shared by greedy and beam decoding
# ---------------------------------------------------------------------------

def ctc_log_probs(params: Dict, spec: ASRSpec, enc_feat: torch.Tensor,
                  compute_dtype=torch.float32) -> torch.Tensor:
    logits = torch.relu(R.linear(params["ctc_layer"], enc_feat, compute_dtype))
    return torch.log_softmax(logits, dim=-1)


def dec_zero_state(spec: ASRSpec, batch: int, device=None):
    return R.stacked_zero_state(spec.decoder.module, spec.decoder.layer,
                                batch, spec.decoder.dim, device)


def dec_query(spec: ASRSpec, state) -> torch.Tensor:
    """Concat the hidden states of all decoder layers: (L,B,H) -> (B,L*H)."""
    h = state[0]
    return h.transpose(0, 1).reshape(h.shape[1], -1)


def embed_tokens(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["pre_embed"][tokens]


def decoder_rnn_step(params: Dict, spec: ASRSpec, dec_in: torch.Tensor, state,
                     compute_dtype=torch.float32):
    """One decoder RNN step + vocab projection.
    Returns (char_logits (B,V), d_state (B,H), new_state)."""
    out, new_state = R.stacked_step(params["decoder"]["layers"],
                                    spec.decoder.module, dec_in, state,
                                    compute_dtype=compute_dtype)
    logits = R.linear(params["decoder"]["char_trans"], out, compute_dtype)
    return logits, out, new_state


def attend_and_decode(params: Dict, spec: ASRSpec, cache: Dict,
                      last_emb: torch.Tensor, dec_state, prev_att,
                      compute_dtype=torch.float32):
    """The (attend -> concat -> decoder step) unit."""
    query = dec_query(spec, dec_state)
    context, attn, new_prev_att = A.attention_step(
        params["attention"], spec.attention, query, cache, prev_att,
        compute_dtype)
    dec_in = torch.cat([last_emb, context], dim=-1)
    logits, d_state, new_state = decoder_rnn_step(params, spec, dec_in,
                                                  dec_state, compute_dtype)
    return logits, attn, d_state, new_state, new_prev_att


def asr_apply(params: Dict, spec: ASRSpec, feat: torch.Tensor,
              feat_len: torch.Tensor, decode_step: int,
              compute_dtype=torch.float32):
    """The free-running forward of the JAX ``asr_apply`` (``teacher=None``,
    argmax feedback): returns (ctc_output, encode_len, att_output (B,L,V)
    logits, att_align (B,N,L,T), None)."""
    b = feat.shape[0]
    enc_feat, enc_len = E.encoder_apply(params["encoder"], spec.encoder, feat,
                                        feat_len, compute_dtype)
    ctc_output = (ctc_log_probs(params, spec, enc_feat, compute_dtype)
                  if spec.enable_ctc else None)
    att_output = att_align = None
    if spec.enable_att:
        cache = A.precompute(params["attention"], spec.attention, enc_feat,
                             enc_len, compute_dtype)
        prev_att = A.init_prev_att(enc_len, enc_feat.shape[1],
                                   spec.attention.num_head)
        dec_state = dec_zero_state(spec, b, feat.device)
        last_emb = embed_tokens(params, torch.zeros(b, dtype=torch.long,
                                                    device=feat.device))
        logits_t, attn_t = [], []
        for _ in range(decode_step):
            logits, attn, _, dec_state, prev_att = attend_and_decode(
                params, spec, cache, last_emb, dec_state, prev_att,
                compute_dtype)
            logits_t.append(logits)
            attn_t.append(attn)
            last_emb = embed_tokens(params, torch.argmax(logits, dim=-1))
        att_output = torch.stack(logits_t, dim=1)                 # B,L,V
        att_align = torch.stack(attn_t, dim=2)                    # B,N,L,T
    return ctc_output, enc_len, att_output, att_align, None
