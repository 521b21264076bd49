"""Joint CTC-attention ASR model (port of e2e_asr_pytorch_tpu/models/asr.py).

Ported: the spec, seeded init, the CTC head, the decoder pieces shared by
greedy and beam decoding, the free-running (``teacher=None``) forward of
``asr_apply``, and its teacher-forced training forward on the folded
decoder (``_apply_folded`` -> ``models/fold_vjp.py``): pure teacher forcing,
single-head LSTM decoder, 2 layers, 'loc'/'dot' attention, no decoder
dropout. Outside that envelope the training forward raises
NotImplementedError naming its ROADMAP item (the generic teacher-forced
scan, scheduled sampling, decoder dropout, emb fusion, fix_enc/fix_dec).
``value_table``/``dkey_bf16`` act on the folded decoder only and are inert
at decode, as in JAX.
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


def embed_tokens(params: Dict, tokens: torch.Tensor, emb_drop: float = 0.0,
                 gen: Optional[torch.Generator] = None,
                 train: bool = False) -> torch.Tensor:
    emb = params["pre_embed"][tokens]
    if train and emb_drop > 0:
        emb = R.dropout(emb, emb_drop, gen)
    return emb


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


# ---------------------------------------------------------------------------
# folded teacher-forced decoder (the training forward)
# ---------------------------------------------------------------------------

_GENERIC_SCAN = ("the generic teacher-forced decoder scan is not ported yet "
                 "(ROADMAP: generic scan, scheduled sampling, decoder dropout)")


def _apply_folded(params, spec: ASRSpec, cache, prev_att0, dec_state0,
                  last_emb0, teacher_emb_t, train, compute_dtype, ctc_output,
                  enc_len):
    """Teacher-forced decoder scan with layer-1's input matmul hoisted out:
    the embedding half is one matmul over all steps, the context half is
    applied per step inside ``FoldedDecoder``, and the vocab projection runs
    once over the whole output sequence."""
    from e2e_asr_pytorch_tpu_torch.models import fold_vjp as FV
    dec = spec.decoder
    if not (dec.layer == 2 and spec.attention.mode in ("loc", "dot")
            and (dec.dropout == 0 or not train)):
        raise NotImplementedError(
            "the folded decoder needs a 2-layer decoder, loc/dot attention "
            "and no decoder dropout in training; " + _GENERIC_SCAN)
    cd = compute_dtype
    layers = params["decoder"]["layers"]
    l1 = layers[0]
    emb_dim = dec.dim
    # inputs at step t: [sos_emb, teacher_emb[:-1]]; their gate
    # contribution for every step at once, emitted in compute dtype
    emb_seq = torch.cat([last_emb0[None], teacher_emb_t[:-1]], dim=0)
    xg_emb = (torch.matmul(emb_seq.to(cd), l1["w_x"][:emb_dim].to(cd))
              + l1["b"].to(cd))
    w_ctx = l1["w_x"][emb_dim:]
    values = cache["value"][:, :, 0, :].to(cd)
    ap = params["attention"]
    is_loc = spec.attention.mode == "loc"
    cfg = FV.FoldCfg(spec.attention.mode, spec.attention.temperature, cd,
                     spec.value_table, spec.dkey_bf16)
    neg_bias = torch.where(cache["mask"], 0.0, FV.NEG_INF)
    feats_t, attn_s = FV.folded_decoder(
        cfg, xg_emb, values, w_ctx, cache["key"][:, :, 0, :].to(cd),
        cache["loc_band"][0].to(cd) if is_loc else None, neg_bias,
        prev_att0[:, 0, :], dec_state0[0], dec_state0[1],
        ap["proj_q"]["w"], ap["proj_q"]["b"],
        ap["loc_proj"]["w"] if is_loc else None,
        ap["gen_energy"]["w"] if is_loc else None,
        ap["gen_energy"]["b"] if is_loc else None,
        layers[0]["w_h"], layers[1]["w_x"], layers[1]["b"], layers[1]["w_h"])
    logits_t = R.linear(params["decoder"]["char_trans"], feats_t, cd)
    att_output = logits_t.transpose(0, 1)                          # B,L,V
    att_align = attn_s.permute(1, 0, 2)[:, None]                   # B,1,L,T
    return ctc_output, enc_len, att_output, att_align, None


def asr_apply(params: Dict, spec: ASRSpec, feat: torch.Tensor,
              feat_len: torch.Tensor, decode_step: int,
              teacher: Optional[torch.Tensor] = None,
              gen: Optional[torch.Generator] = None, train: bool = False,
              sample_free: bool = False, compute_dtype=torch.float32):
    """Forward pass: returns (ctc_output, encode_len, att_output (B,L,V)
    logits, att_align (B,N,L,T), None).

    ``teacher=None`` is the free-running forward (argmax feedback).
    ``teacher`` (B,L) with ``sample_free`` (pure teacher forcing) takes the
    folded decoder; ``train`` turns on encoder and embedding dropout, whose
    masks come from ``gen``."""
    b = feat.shape[0]
    enc_feat, enc_len = E.encoder_apply(params["encoder"], spec.encoder, feat,
                                        feat_len, compute_dtype, train, gen)
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
                                                    device=feat.device),
                                spec.emb_drop, gen, train)
        if teacher is not None:
            if not sample_free:
                raise NotImplementedError(
                    "scheduled sampling (tf_start/tf_end < 1) is not ported "
                    "yet; " + _GENERIC_SCAN)
            if (spec.decoder.module != "LSTM"
                    or spec.attention.num_head != 1):
                raise NotImplementedError(
                    "the folded decoder needs a single-head LSTM decoder; "
                    + _GENERIC_SCAN)
            teacher_emb = embed_tokens(params, teacher.long(), spec.emb_drop,
                                       gen, train)
            # pad/truncate the teacher to decode_step along time
            lt = teacher_emb.shape[1]
            if lt < decode_step:
                teacher_emb = torch.nn.functional.pad(
                    teacher_emb, (0, 0, 0, decode_step - lt))
            teacher_emb_t = teacher_emb[:, :decode_step].transpose(0, 1)
            return _apply_folded(params, spec, cache, prev_att, dec_state,
                                 last_emb, teacher_emb_t, train,
                                 compute_dtype, ctc_output, enc_len)
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
