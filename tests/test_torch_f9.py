"""F9: every product the JAX package forms with
``preferred_element_type=float32`` (bf16 operands, f32 sums, an f32 result)
is formed so in the port too (``ops/rnn.py mm_f32`` / ``matmul_f32``), and
not as a bf16 product rounded to bf16 before the f32 sums.

Each repaired site runs at bf16 against its JAX counterpart on the same
parameters and inputs. The bound is what f32 sums in another order give:
max |err| <= SUM_REL x max |JAX|. A recurrent path is held so over its first
positions (before a bf16 rounding of the state can flip and feed back), and
over the whole sequence at WHOLE_REL. Each site has a twin that rounds the
port's products to bf16 again (the fault F9 was): it must break SUM_REL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.models import asr as JM
from e2e_asr_pytorch_tpu.models import fold_vjp as JF
from e2e_asr_pytorch_tpu.models import lm as JLM
from e2e_asr_pytorch_tpu.ops import attention as JA
from e2e_asr_pytorch_tpu.ops import rnn as JR
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.models import asr as TM
from e2e_asr_pytorch_tpu_torch.models import fold_vjp as TF
from e2e_asr_pytorch_tpu_torch.models import lm as TLM
from e2e_asr_pytorch_tpu_torch.ops import attention as TA
from e2e_asr_pytorch_tpu_torch.ops import rnn as TR

# f32 sums of the same exact products in another order: a few f32 ulps of
# the largest value (a bf16-rounded product is off by up to 2^-9 of itself)
SUM_REL = 1e-5
# the first positions of a recurrence, before any bf16(h) rounding flips
FIRST = 2
# a whole recurrence: a flipped bf16(h) rounding feeds back (2^-9 relative)
WHOLE_REL = 2e-2
JBF, TBF = jnp.bfloat16, torch.bfloat16


@pytest.fixture
def rounded_products(monkeypatch):
    """The fault F9 was: each product of bf16 operands rounded to bf16
    before it is read as f32."""
    def rounded(a, b):
        if a.dtype == torch.float32:
            return torch.matmul(a, b)
        return torch.matmul(a, b).float()
    monkeypatch.setattr(TR, "mm_f32", rounded)


def _rel(j, t):
    j = np.asarray(jnp.asarray(j, jnp.float32), np.float64)
    t = t.detach().float().numpy().astype(np.float64)
    return float(np.max(np.abs(j - t)) / max(np.max(np.abs(j)), 1e-30))


def _n(r, *shape, sc=1.0):
    return (sc * r.standard_normal(shape)).astype(np.float32)


def _tree(jtree):
    return convert.from_jax_params(jax.tree.map(np.asarray, jtree))


# --------------------------------------------------------------- the sites
# each returns {name: (JAX value, port value, bound)}

def site_linear():
    """ops/rnn.py linear (the CTC head, char_trans, the untied LM's
    projection, the attention's query and energy projections)."""
    r = np.random.default_rng(0)
    jp = JR.espnet_linear_init(jax.random.PRNGKey(0), 96, 40)
    x = _n(r, 6, 7, 96)
    j = JR.linear(jp, jnp.asarray(x), JBF)
    t = TR.linear(_tree(jp), torch.from_numpy(x), TBF)
    return {"y": (j, t, SUM_REL)}


def site_lstm_cell():
    """ops/rnn.py lstm_cell: the recurrent product h @ w_h."""
    r = np.random.default_rng(1)
    jp = JR.lstm_init(jax.random.PRNGKey(1), 24, 64)
    xg, h, c = _n(r, 5, 256), _n(r, 5, 64, sc=0.5), _n(r, 5, 64)
    jh, jc = JR.lstm_cell(jp, jnp.asarray(xg), jnp.asarray(h),
                          jnp.asarray(c), JBF)
    th, tc = TR.lstm_cell(_tree(jp), torch.from_numpy(xg),
                          torch.from_numpy(h), torch.from_numpy(c), TBF)
    return {"h": (jh, th, SUM_REL), "c": (jc, tc, SUM_REL)}


def site_stacked_step():
    """ops/rnn.py stacked_step's LSTM branch (the decoder's and the LM's
    one-step cells: x @ w_x and h @ w_h of every layer)."""
    r = np.random.default_rng(2)
    jl = JR.stacked_init(jax.random.PRNGKey(2), "LSTM", 80, 48, 3)
    x = _n(r, 4, 80)
    hs, cs = _n(r, 3, 4, 48, sc=0.5), _n(r, 3, 4, 48)
    jo, (jh, jc) = JR.stacked_step(jl, "LSTM", jnp.asarray(x),
                                   (jnp.asarray(hs), jnp.asarray(cs)),
                                   compute_dtype=JBF)
    to, (th, tc) = TR.stacked_step(_tree(jl), "LSTM", torch.from_numpy(x),
                                   (torch.from_numpy(hs),
                                    torch.from_numpy(cs)),
                                   compute_dtype=TBF)
    return {"out": (jo, to, SUM_REL), "c": (jc, tc, SUM_REL)}


def _attn_setup(seed, mode="loc", heads=1):
    r = np.random.default_rng(seed)
    cfg = dict(mode=mode, dim=16, num_head=heads, temperature=0.5,
               v_proj=False, v_dim=24, q_dim=40, loc_kernel_size=4,
               loc_kernel_num=3)
    jcfg, tcfg = JA.AttnConfig(**cfg), TA.AttnConfig(**cfg)
    jp = JA.attention_init(jax.random.PRNGKey(seed), jcfg)
    enc = np.tanh(_n(r, 3, 13, 24))
    enc_len = np.array([13, 9, 6], np.int32)
    jc = JA.precompute(jp, jcfg, jnp.asarray(enc), jnp.asarray(enc_len), JBF)
    tc = TA.precompute(_tree(jp), tcfg, torch.from_numpy(enc),
                       torch.from_numpy(enc_len).long(), TBF)
    prev = np.abs(_n(r, 3, heads, 13))
    prev = prev / prev.sum(-1, keepdims=True)
    return r, jcfg, tcfg, jp, jc, tc, prev


def site_attention_loc():
    """ops/attention.py attention_weights_step: the location features
    prev_att @ loc_band (and the loc_proj / energy linears)."""
    r, jcfg, tcfg, jp, jc, tc, prev = _attn_setup(3)
    q = _n(r, 3, 40, sc=0.5)
    ja, _ = JA.attention_weights_step(jp, jcfg, jnp.asarray(q), jc,
                                      jnp.asarray(prev), JBF)
    ta, _ = TA.attention_weights_step(_tree(jp), tcfg, torch.from_numpy(q),
                                      tc, torch.from_numpy(prev), TBF)
    return {"attn": (ja, ta, SUM_REL)}


def site_attention_loc_beam():
    """ops/attention.py attention_weights_step_beam: the same on the beam
    axis (prev_att (B,K,N,T) against the un-replicated band)."""
    r, jcfg, tcfg, jp, jc, tc, _ = _attn_setup(4)
    q = _n(r, 3, 2, 40, sc=0.5)
    prev = np.abs(_n(r, 3, 2, 1, 13))
    prev = prev / prev.sum(-1, keepdims=True)
    ja, _ = JA.attention_weights_step_beam(jp, jcfg, jnp.asarray(q), jc,
                                           jnp.asarray(prev), JBF)
    ta, _ = TA.attention_weights_step_beam(_tree(jp), tcfg,
                                           torch.from_numpy(q), tc,
                                           torch.from_numpy(prev), TBF)
    return {"attn": (ja, ta, SUM_REL)}


def site_lm_step_tied():
    """models/lm.py _output_proj, tied: out @ emb^T, the flagship decode's
    LM logits (and the LM's one-step cells)."""
    r = np.random.default_rng(5)
    args = (37, True, 48, "LSTM", 48, 2, 0.0)
    jspec, tspec = JLM.build_spec(*args), TLM.build_spec(*args)
    jp = JLM.lm_init(jax.random.PRNGKey(5), jspec)
    tok = np.array([3, 7, 11, 0], np.int32)
    hs, cs = _n(r, 2, 4, 48, sc=0.5), _n(r, 2, 4, 48)
    jl, _ = JLM.lm_step(jp, jspec, jnp.asarray(tok),
                        (jnp.asarray(hs), jnp.asarray(cs)), JBF)
    tl, _ = TLM.lm_step(_tree(jp), tspec, torch.from_numpy(tok).long(),
                        (torch.from_numpy(hs), torch.from_numpy(cs)), TBF)
    return {"logits": (jl, tl, SUM_REL)}


def site_lstm_layer():
    """ops/rnn.py lstm_layer, the loop over lstm_cell: the hoisted x @ w_x
    and every step's h @ w_h."""
    r = np.random.default_rng(6)
    jp = JR.lstm_init(jax.random.PRNGKey(6), 32, 48)
    x = _n(r, 3, 9, 32)
    jy, _ = JR.lstm_layer(jp, jnp.asarray(x), compute_dtype=JBF)
    ty, _ = TR.lstm_layer(_tree(jp), torch.from_numpy(x), compute_dtype=TBF)
    return {"y_first": (jy[:, :FIRST], ty[:, :FIRST], SUM_REL),
            "y": (jy, ty, WHOLE_REL)}


DEC = dict(
    ctc_weight=0.5,
    encoder=dict(vgg=0, module="LSTM", bidirection=True, dim=[12],
                 dropout=[0.0], layer_norm=[False], proj=[True],
                 sample_rate=[1], sample_style="drop"),
    attention=dict(mode="loc", dim=16, num_head=1, v_proj=False,
                   temperature=0.5, loc_kernel_size=4, loc_kernel_num=3),
    decoder=dict(module="LSTM", dim=32, layer=3, dropout=0))


def site_autodiff_decoder():
    """models/asr.py _autodiff_steps (the folded decoder of a depth outside
    the hand-written backward): the context reduction attn @ values, its
    product with w_ctx, and each upper layer's x @ w_x."""
    r = np.random.default_rng(7)
    jspec, tspec = JM.build_spec(8, 11, **DEC), TM.build_spec(8, 11, **DEC)
    jp = JM.asr_init(jax.random.PRNGKey(7), jspec)
    tp = _tree(jp)
    enc = np.tanh(_n(r, 2, 10, 24))
    enc_len = np.array([10, 7], np.int32)
    txt = r.integers(1, 11, (2, 5))
    jc = JA.precompute(jp["attention"], jspec.attention, jnp.asarray(enc),
                       jnp.asarray(enc_len), JBF)
    tc = TA.precompute(tp["attention"], tspec.attention,
                       torch.from_numpy(enc),
                       torch.from_numpy(enc_len).long(), TBF)
    prev = np.tile((np.arange(10)[None] < enc_len[:, None])
                   / enc_len[:, None], (1, 1, 1)).astype(np.float32)
    prev = prev.reshape(2, 1, 10)
    z = np.zeros((3, 2, 32), np.float32)
    emb = np.asarray(jp["pre_embed"])
    sos, teach = emb[np.zeros(2, int)], emb[txt].transpose(1, 0, 2)
    jout = JM._apply_folded(
        jp, jspec, jc, jnp.asarray(prev), (jnp.asarray(z), jnp.asarray(z)),
        jnp.asarray(sos), jnp.asarray(teach),
        jax.random.split(jax.random.PRNGKey(0), 5), False, False, JBF, None,
        None)
    tout = TM._apply_folded(
        tp, tspec, tc, torch.from_numpy(prev),
        (torch.from_numpy(z), torch.from_numpy(z)), torch.from_numpy(sos),
        torch.from_numpy(teach), None, False, False, TBF, None, None)
    return {"logits_first": (jout[2][:, :FIRST], tout[2][:, :FIRST],
                             SUM_REL),
            "logits": (jout[2], tout[2], WHOLE_REL)}


def site_folded_decoder():
    """models/fold_vjp.py: the hand-written decoder's forward products
    (``_mm``, the context reduction) and, with 'dot' attention, every
    cotangent of its backward (``_mm`` there, d_values, d_key)."""
    from test_torch_fold_vjp import CAST, NAMES, _inputs
    out = {}
    for mode in ("loc", "dot"):
        a, cts = _inputs(mode)
        jargs = [None if a[k] is None else
                 jnp.asarray(a[k], JBF if k in CAST else jnp.float32)
                 for k in NAMES]
        jcfg = JF.FoldCfg(mode, 0.5, JBF, "bf16", False)
        jo, vjp = jax.vjp(lambda *x: JF.folded_decoder(jcfg, *x), *jargs)
        targs = [None if a[k] is None else torch.from_numpy(a[k]).to(
            TBF if k in CAST else torch.float32).requires_grad_()
            for k in NAMES]
        to = TF.folded_decoder(TF.FoldCfg(mode, 0.5, TBF, "bf16", False),
                               *targs)
        out[mode + "_feats_first"] = (jo[0][:FIRST].astype(jnp.float32),
                                      to[0][:FIRST], SUM_REL)
        if mode == "dot":
            jg = vjp(tuple(jnp.asarray(c, JBF) for c in cts))
            live = [x for x in targs if x is not None]
            tg = torch.autograd.grad(to, live, grad_outputs=tuple(
                torch.from_numpy(c).to(TBF) for c in cts))
            for name, j, t in zip([k for k in NAMES if a[k] is not None],
                                  [g for g in jg if g is not None], tg):
                if name != "neg_bias":
                    out["dot_d_" + name] = (j.astype(jnp.float32), t,
                                            SUM_REL)
    return out


SITES = [site_linear, site_lstm_cell, site_stacked_step, site_attention_loc,
         site_attention_loc_beam, site_lm_step_tied, site_lstm_layer,
         site_autodiff_decoder, site_folded_decoder]


@pytest.mark.parametrize("site", SITES, ids=lambda f: f.__name__[5:])
def test_f32_sums_of_bf16_products_match_jax(site):
    errs = {k: (_rel(j, t), bound) for k, (j, t, bound) in site().items()}
    assert all(e <= bound for e, bound in errs.values()), errs


@pytest.mark.parametrize("site", SITES, ids=lambda f: f.__name__[5:])
def test_bf16_rounded_products_break_the_bound(site, rounded_products):
    errs = {k: _rel(j, t) for k, (j, t, bound) in site().items()
            if bound == SUM_REL}
    assert max(errs.values()) > 10 * SUM_REL, errs
