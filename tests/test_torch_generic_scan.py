"""The generic decoder scan (``models/asr.py _generic_scan``) against the
JAX package's ``asr_apply(..., fold_decoder=False)`` scan on the same
parameters, in training: GRU and LSTM decoders, one and two attention
heads, 'loc' and 'dot' attention, scheduled sampling and the decoder's
dropout.

The model has no listener layers (the CTC head and the attention read the
features), so what is compared is the decoder side alone. Held: the logits
and attention weights, and every gradient leaf of sum(logits^2) +
sum(attn * w), each as max |err| / max |JAX| within REL (f32 sums in other
orders over a few steps). A leaf whose JAX gradient is under one f32
epsilon of the largest leaf's (the energy bias: a common shift before the
softmax) is zero by construction and left out.

Where JAX draws (the per-step coin, the categorical's Gumbel noise, the
dropout masks), the test re-derives its draws from the key splits of
``asr_apply`` and hands them to the port in the order it takes them
(``ops/rnn.py GivenDraws``). Each parity test has a twin with a planted
fault that must break REL: a coin per utterance in place of one for the
batch, the sampled embedding not dropped out, no decoder dropout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.models import asr as JM
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.models import asr as TM
from e2e_asr_pytorch_tpu_torch.ops import rnn as TR

REL = 1e-4
VOCAB = 13
B, T, L, FEAT = 3, 12, 6, 16


def _model(module="LSTM", heads=1, mode="loc", dec_drop=0.0):
    return dict(
        ctc_weight=0.5,
        encoder=dict(vgg=0, module="LSTM", bidirection=True, dim=[],
                     dropout=[], layer_norm=[], proj=[], sample_rate=[],
                     sample_style="drop"),
        attention=dict(mode=mode, dim=8, num_head=heads, v_proj=False,
                       temperature=0.5, loc_kernel_size=3,
                       loc_kernel_num=2),
        decoder=dict(module=module, dim=16, layer=2, dropout=dec_drop))


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    feat = np.tanh(r.standard_normal((B, T, FEAT))).astype(np.float32)
    feat_len = np.array([T, T - 3, T - 5], np.int32)
    txt = r.integers(1, VOCAB, (B, L - 1)).astype(np.int32)
    w_attn = r.standard_normal((B, 1, L, T)).astype(np.float32)
    return feat, feat_len, txt, w_attn


def jax_draws(key, spec, tf_rate_draws: bool):
    """The JAX scan's draws, in the order the port takes them: the sos and
    teacher embeddings' masks, then per step the decoder's layer masks, its
    output mask, and with scheduled sampling the coin, the Gumbel noise and
    the sampled embedding's mask."""
    dec = spec.decoder
    emb_keep, dec_keep = 1.0 - spec.emb_drop, 1.0 - dec.dropout
    _, rng_dec, rng_emb, rng_tf = jax.random.split(key, 4)
    out = []
    if spec.emb_drop > 0:
        out.append(("mask", jax.random.bernoulli(rng_emb, emb_keep,
                                                 (B, dec.dim))))
        out.append(("mask", jax.random.bernoulli(
            jax.random.fold_in(rng_emb, 1), emb_keep, (B, L - 1, dec.dim))))
    step_rngs = jax.random.split(rng_dec, L)
    coin_rngs = jax.random.split(rng_tf, L)
    for t in range(L):
        if dec.dropout > 0:
            rng = step_rngs[t]
            for _ in range(dec.layer - 1):
                rng, sub = jax.random.split(rng)
                out.append(("mask", jax.random.bernoulli(
                    sub, dec_keep, (B, dec.dim))))
            out.append(("mask", jax.random.bernoulli(
                jax.random.fold_in(step_rngs[t], 1), dec_keep,
                (B, dec.dim))))
        if tf_rate_draws:
            k_coin, k_samp, k_drop = jax.random.split(coin_rngs[t], 3)
            out.append(("uniform", jax.random.uniform(k_coin)))
            out.append(("gumbel", jax.random.gumbel(k_samp, (B, VOCAB),
                                                    jnp.float32)))
            if spec.emb_drop > 0:
                out.append(("mask", jax.random.bernoulli(
                    k_drop, emb_keep, (B, dec.dim))))
    return [(k, np.asarray(v)) for k, v in out]


def jax_folded_draws(key, spec):
    """The draws of JAX's folded decoder outside its hand-written backward
    (``_apply_folded``'s scan): per step a mask for each layer's input
    above the first, each from a split of the step's key, then the top
    output's from ``fold_in(that key, 1)``."""
    dec = spec.decoder
    keep = 1.0 - dec.dropout
    _, rng_dec, _, _ = jax.random.split(key, 4)
    out = []
    for rng in jax.random.split(rng_dec, L):
        for _ in range(dec.layer - 1):
            rng, sub = jax.random.split(rng)
            out.append(("mask", jax.random.bernoulli(sub, keep,
                                                     (B, dec.dim))))
        out.append(("mask", jax.random.bernoulli(
            jax.random.fold_in(rng, 1), keep, (B, dec.dim))))
    return [(k, np.asarray(v)) for k, v in out]


def _run_both(model, tf_rate, emb_drop=0.0, seed=0, given=True,
              edit_params=None, folded=False):
    """{name: rel err} of the logits, the attention weights and every
    gradient leaf; ``given``: the port takes JAX's draws, else its own
    generator's; ``edit_params`` edits the port's parameters in place;
    ``folded``: pure teacher forcing on the folded decoder's path."""
    spec_kw = dict(emb_drop=emb_drop)
    jspec = JM.build_spec(FEAT, VOCAB, **model, **spec_kw)
    tspec = TM.build_spec(FEAT, VOCAB, **model, **spec_kw)
    jp = JM.asr_init(jax.random.PRNGKey(seed), jspec)
    feat, feat_len, txt, w_attn = _inputs(seed)
    key = jax.random.PRNGKey(seed + 1)

    def loss(p):
        out = JM.asr_apply(p, jspec, jnp.asarray(feat), jnp.asarray(feat_len),
                           L, tf_rate, teacher=jnp.asarray(txt), rng=key,
                           train=True, sample_free=folded,
                           fold_decoder=folded)
        return (jnp.sum(out[2] ** 2) + jnp.sum(out[3] * w_attn),
                (out[2], out[3]))
    (_, (jl, ja)), jg = jax.value_and_grad(loss, has_aux=True)(jp)
    names = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    jg = convert.tree_leaves(convert.from_jax_params(
        jax.tree.map(np.asarray, jg)))

    draws = (jax_folded_draws(key, jspec) if folded
             else jax_draws(key, jspec, True))
    gen = TR.GivenDraws(draws) if given else torch.Generator()
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    if edit_params is not None:
        edit_params(tp)
    leaves = convert.tree_map(lambda x: x.detach().requires_grad_(), tp)
    out = TM.asr_apply(leaves, tspec, torch.from_numpy(feat),
                       torch.from_numpy(feat_len).long(), L,
                       teacher=torch.from_numpy(txt).long(), gen=gen,
                       train=True, sample_free=folded, tf_rate=tf_rate,
                       fold_decoder=folded)
    if given:
        assert not gen.draws, "{} draws left".format(len(gen.draws))
    total = (out[2] ** 2).sum() + (out[3] * torch.from_numpy(w_attn)).sum()
    flat = convert.tree_leaves(leaves)
    tg = torch.autograd.grad(total, flat, allow_unused=True)
    errs = {"logits": _rel(jl, out[2]), "attn": _rel(ja, out[3])}
    largest = max(float(np.abs(g.numpy()).max()) for g in jg)
    for n, j, t in zip(names, jg, tg):
        t = torch.zeros_like(j) if t is None else t
        if float(np.abs(j.numpy()).max()) > largest * np.finfo(
                np.float32).eps:
            errs[n] = _rel(j, t)
    return errs


def _rel(j, t):
    j = np.asarray(j, np.float64)
    t = t.detach().numpy().astype(np.float64)
    return float(np.max(np.abs(j - t)) / max(np.max(np.abs(j)), 1e-30))


def _bad(errs):
    return {k: v for k, v in errs.items() if v > REL}


TEACHER_CASES = [(m, h, a) for m in ("LSTM", "GRU") for h in (1, 2)
                 for a in ("loc", "dot")]


@pytest.mark.parametrize("module,heads,mode", TEACHER_CASES)
def test_generic_scan_at_tf_rate_1_matches_jax(module, heads, mode):
    """Every coin picks the teacher: the port's own generator's draws do
    not matter, and the forward and gradients match JAX's."""
    errs = _run_both(_model(module, heads, mode), 1.0, given=False)
    assert sum("decoder" in n for n in errs) >= 2 * 3, sorted(errs)
    assert not _bad(errs), errs


def test_generic_scan_fails_under_a_doubled_w_h():
    """The twin of the teacher-forced parity: the bound catches a wrong
    weight (the GRU's top w_h doubled on the port's side)."""
    def doubled(tp):
        top = tp["decoder"]["layers"][1]
        top["w_h"] = top["w_h"] * 2.0
    errs = _run_both(_model("GRU", 2, "loc"), 1.0, given=False,
                     edit_params=doubled)
    assert errs["logits"] > 10 * REL, errs


SAMPLED_CASES = [("LSTM", 1, "loc"), ("GRU", 2, "loc"), ("GRU", 1, "dot")]


@pytest.mark.parametrize("module,heads,mode", SAMPLED_CASES)
def test_scheduled_sampling_at_tf_rate_0_matches_jax(module, heads, mode):
    """Every step feeds back a token sampled from its logits, with JAX's
    Gumbel noise; the sampled embedding is dropped out with JAX's masks."""
    errs = _run_both(_model(module, heads, mode), 0.0, emb_drop=0.2)
    assert not _bad(errs), errs


def test_scheduled_sampling_at_tf_rate_half_matches_jax():
    """One coin per step for the whole batch picks teacher or sample."""
    errs = _run_both(_model("LSTM", 2, "loc"), 0.5, emb_drop=0.2, seed=3)
    assert not _bad(errs), errs


def test_scheduled_sampling_fails_with_a_coin_per_utterance(monkeypatch):
    """Twin: each utterance tossing its own coin (the first JAX's, the
    others its complement) changes which rows see the teacher."""
    real = TR.uniform

    def per_utterance(gen, device):
        c = real(gen, device)
        return torch.stack([c] + [1.0 - c] * (B - 1))[:, None]
    monkeypatch.setattr(TR, "uniform", per_utterance)
    errs = _run_both(_model("LSTM", 2, "loc"), 0.5, emb_drop=0.2, seed=3)
    assert errs["logits"] > 10 * REL, errs


def test_scheduled_sampling_fails_without_dropout_on_the_sample(
        monkeypatch):
    """Twin: the sampled embedding taken without its dropout mask (the
    mask is still drawn, so every other draw stays aligned)."""
    real = TM.embed_tokens
    calls = []

    def undropped(params, tokens, emb_drop=0.0, gen=None, train=False):
        calls.append(tokens.shape)
        if len(calls) > 2:                  # after the sos and the teacher
            TR.keep_mask((tokens.shape[0], params["pre_embed"].shape[1]),
                         1.0 - emb_drop, gen, tokens.device)
            return real(params, tokens)
        return real(params, tokens, emb_drop, gen, train)
    monkeypatch.setattr(TM, "embed_tokens", undropped)
    errs = _run_both(_model("GRU", 2, "loc"), 0.0, emb_drop=0.2)
    assert errs["logits"] > 10 * REL, errs


@pytest.mark.parametrize("module,heads", [("LSTM", 1), ("GRU", 2)])
def test_decoder_dropout_matches_jax(module, heads):
    """The decoder's dropout in training: a mask after each layer but the
    last and one on the top output, with JAX's masks."""
    errs = _run_both(_model(module, heads, "loc", dec_drop=0.3), 1.0)
    assert not _bad(errs), errs


def test_folded_decoder_dropout_matches_jax():
    """A 2-layer LSTM decoder with dropout under pure teacher forcing: the
    folded decoder's autodiff form (outside the hand-written backward), with
    JAX's masks."""
    errs = _run_both(_model("LSTM", 1, "loc", dec_drop=0.3), 1.0,
                     folded=True)
    assert not _bad(errs), errs


def test_decoder_dropout_fails_when_not_applied(monkeypatch):
    """Twin: the masks taken but not applied."""
    real = TR.dropout

    def drawn_not_applied(x, rate, gen):
        real(x, rate, gen)
        return x
    monkeypatch.setattr(TR, "dropout", drawn_not_applied)
    errs = _run_both(_model("LSTM", 1, "loc", dec_drop=0.3), 1.0)
    assert errs["logits"] > 10 * REL, errs


def test_gru_dec_query_reads_every_layer():
    """A GRU decoder's state is one (L,B,H) tensor: the query is every
    layer's h, as JAX's ``dec_query`` (the beam's ``_map_state`` does the
    same)."""
    spec = TM.build_spec(FEAT, VOCAB, **_model("GRU", 1, "loc"))
    state = torch.arange(2 * 3 * 16, dtype=torch.float32).reshape(2, 3, 16)
    q = TM.dec_query(spec, state)
    assert q.shape == (3, 32)
    assert torch.equal(q, torch.cat([state[0], state[1]], dim=-1))


def test_generic_scan_warns_about_the_perf_flags():
    """JAX's warning: value_table / dkey_bf16 set while the folded fast path
    is not taken (here: a GRU decoder) are ignored, in training only."""
    import warnings
    model = dict(_model("GRU", 1, "loc"), value_table="int8", dkey_bf16=True)
    spec = TM.build_spec(FEAT, VOCAB, **model)
    params = TM.asr_init(torch.Generator().manual_seed(0), spec)
    feat, feat_len, txt, _ = _inputs()
    args = (params, spec, torch.from_numpy(feat),
            torch.from_numpy(feat_len).long(), 3)
    with pytest.warns(UserWarning, match="folded decoder fast path not"):
        TM.asr_apply(*args, teacher=torch.from_numpy(txt).long(),
                     train=True, sample_free=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TM.asr_apply(*args, teacher=torch.from_numpy(txt).long(),
                     train=False, sample_free=True)


@pytest.mark.parametrize("fold", [False, True])
def test_dec_state_and_ctc_logits_match_jax(fold):
    """``get_dec_state`` (the top layer's outputs before the decoder's
    dropout) and ``get_logit`` (the CTC head after its relu, no
    log-softmax), on the generic scan and on the folded decoder."""
    model = _model("LSTM", 1, "loc")
    jspec = JM.build_spec(FEAT, VOCAB, **model)
    tspec = TM.build_spec(FEAT, VOCAB, **model)
    jp = JM.asr_init(jax.random.PRNGKey(4), jspec)
    feat, feat_len, txt, _ = _inputs(4)
    jo = JM.asr_apply(jp, jspec, jnp.asarray(feat), jnp.asarray(feat_len),
                      L, 1.0, teacher=jnp.asarray(txt), sample_free=True,
                      get_dec_state=True, get_logit=True, fold_decoder=fold)
    to = TM.asr_apply(convert.from_jax_params(jax.tree.map(np.asarray, jp)),
                      tspec, torch.from_numpy(feat),
                      torch.from_numpy(feat_len).long(), L,
                      teacher=torch.from_numpy(txt).long(), sample_free=True,
                      get_dec_state=True, get_logit=True, fold_decoder=fold)
    assert to[4].shape == (B, L, 16) and float(to[0].min()) >= 0.0
    errs = {"ctc": _rel(jo[0], to[0]), "dec_state": _rel(jo[4], to[4]),
            "logits": _rel(jo[2], to[2])}
    assert not _bad(errs), errs
