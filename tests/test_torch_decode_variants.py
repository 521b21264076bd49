"""Greedy and beam-8 + LM decoding over the decoders the generic scan opened
for training: a 2-layer GRU decoder and a 2-head attention, against the JAX
package's ``greedy_decode`` / ``beam_decode`` on shared weights. The tokens
are equal and the beam's avg_scores within SCORE_ATOL (f32 throughout; the
model has no listener layers, so no recurrence kernel is involved). The
twin doubles the decoder's top w_h on the port's side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.decode import beam as JB
from e2e_asr_pytorch_tpu.decode import greedy as JG
from e2e_asr_pytorch_tpu.models import asr as JM
from e2e_asr_pytorch_tpu.models import lm as JLM
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.decode import beam as TB
from e2e_asr_pytorch_tpu_torch.decode import greedy as TG
from e2e_asr_pytorch_tpu_torch.models import asr as TM
from e2e_asr_pytorch_tpu_torch.models import lm as TLM

SCORE_ATOL = 1e-4
VOCAB, FEAT = 23, 24
LM_MODEL = dict(emb_tying=True, emb_dim=32, module="LSTM", dim=32,
                n_layers=2, dropout=0.0)
VARIANTS = {
    "gru": dict(module="GRU", heads=1, mode="loc"),
    "two_heads": dict(module="LSTM", heads=2, mode="loc"),
    "gru_two_heads_dot": dict(module="GRU", heads=2, mode="dot")}


def _model(module, heads, mode):
    return dict(
        ctc_weight=0.3,
        encoder=dict(vgg=0, module="LSTM", bidirection=True, dim=[],
                     dropout=[], layer_norm=[], proj=[], sample_rate=[],
                     sample_style="drop"),
        attention=dict(mode=mode, dim=16, num_head=heads, v_proj=False,
                       temperature=0.5, loc_kernel_size=4,
                       loc_kernel_num=3),
        decoder=dict(module=module, dim=32, layer=2, dropout=0.1))


def _setup(name, double_top_w_h=False):
    model = _model(**VARIANTS[name])
    jspec, tspec = (JM.build_spec(FEAT, VOCAB, **model),
                    TM.build_spec(FEAT, VOCAB, **model))
    jp = JM.asr_init(jax.random.PRNGKey(0), jspec)
    jlspec = JLM.build_spec(VOCAB, **LM_MODEL)
    jl = JLM.lm_init(jax.random.PRNGKey(1), jlspec)
    r = np.random.default_rng(0)
    feat = np.tanh(r.standard_normal((3, 40, FEAT))).astype(np.float32)
    feat_len = np.array([40, 33, 21], np.int32)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    if double_top_w_h:
        top = tp["decoder"]["layers"][1]
        top["w_h"] = top["w_h"] * 2.0
    return dict(jspec=jspec, tspec=tspec, jp=jp, tp=tp, jlspec=jlspec,
                jl=jl, tlspec=TLM.build_spec(VOCAB, **LM_MODEL),
                tl=convert.from_jax_params(jax.tree.map(np.asarray, jl)),
                feat=feat, feat_len=feat_len)


def _greedy(s):
    jo = JG.greedy_decode(s["jp"], s["jspec"], jnp.asarray(s["feat"]),
                          jnp.asarray(s["feat_len"]), 10)
    to = TG.greedy_decode(s["tp"], s["tspec"], torch.from_numpy(s["feat"]),
                          torch.from_numpy(s["feat_len"]).long(), 10)
    return np.asarray(jo["att_tokens"]), to["att_tokens"].numpy()


def _beam(s):
    cfg = dict(beam_size=8, min_len_ratio=0.05, max_len_ratio=0.3,
               ctc_weight=0.0, lm_weight=0.3, max_steps=10)
    jo = JB.beam_decode(s["jp"], s["jspec"], JB.BeamConfig(**cfg),
                        jnp.asarray(s["feat"]), jnp.asarray(s["feat_len"]),
                        s["jl"], s["jlspec"])
    to = TB.beam_decode(s["tp"], s["tspec"], TB.BeamConfig(**cfg),
                        torch.from_numpy(s["feat"]),
                        torch.from_numpy(s["feat_len"]).long(), s["tl"],
                        s["tlspec"])
    return jo, to


@pytest.mark.parametrize("name", list(VARIANTS))
def test_greedy_and_beam_8_with_lm_equal_jax(name):
    s = _setup(name)
    j, t = _greedy(s)
    np.testing.assert_array_equal(j, t)
    jo, to = _beam(s)
    np.testing.assert_array_equal(np.asarray(jo["tokens"]),
                                  to["tokens"].numpy())
    np.testing.assert_array_equal(np.asarray(jo["out_len"]),
                                  to["out_len"].numpy())
    err = np.abs(np.asarray(jo["avg_scores"]) - to["avg_scores"].numpy())
    assert float(err.max()) <= SCORE_ATOL
    assert np.isfinite(to["avg_scores"].numpy()[:, 0]).all()


def test_doubled_top_w_h_breaks_the_beam():
    s = _setup("gru", double_top_w_h=True)
    jo, to = _beam(s)
    err = np.abs(np.asarray(jo["avg_scores"]) - to["avg_scores"].numpy())
    assert float(err.max()) > 100 * SCORE_ATOL
