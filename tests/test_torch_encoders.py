"""Port of the GRU, light-GRU and single-direction LSTM layers and encoders,
and of the stacked GRU (decoder/LM form), against the JAX package on shared
weights.

Routes. The JAX package is put on its Pallas kernels (``E2E_ASR_PALLAS=
force``) run in interpret mode, so both sides take the recurrent product
with bf16 operands, as the port's plain versions do on CPU tensors. The
stateful GRU loop and the stacked GRU reach no kernel on either side and are
all f32.

Tolerances (f32 compute unless said): kernel routes 1e-4 (f32 sums in
another order, a rare flipped bf16 rounding of h), over max |y| for the
light GRU whose relu candidates are not bounded by 1; loops 1e-5; a bf16
stream one bf16 ulp at |h| <= 1 through one layer, 1e-2. Every comparison
has a twin with a planted fault that must fail it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.models import encoder as JE
from e2e_asr_pytorch_tpu.models import lm as JLM
from e2e_asr_pytorch_tpu.ops import rnn as JR
from e2e_asr_pytorch_tpu.ops.pallas import gru as PGRU
from e2e_asr_pytorch_tpu.ops.pallas import ligru as PLIGRU
from e2e_asr_pytorch_tpu.ops.pallas import lstm as PL
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.models import encoder as TE
from e2e_asr_pytorch_tpu_torch.models import lm as TLM
from e2e_asr_pytorch_tpu_torch.ops import rnn as TR
from e2e_asr_pytorch_tpu_torch.ops.kernels import gru as KG
from e2e_asr_pytorch_tpu_torch.ops.kernels import ligru as KLG
from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as KL

KERNEL_ATOL = 1e-4
LOOP_ATOL = 1e-5
BF16_ATOL = 1e-2
B, T, D, H = 3, 9, 12, 16


@pytest.fixture
def jax_kernels(monkeypatch):
    """Route the JAX package through its Pallas kernels in interpret mode."""
    monkeypatch.setenv("E2E_ASR_PALLAS", "force")
    for mod in (PL, PGRU, PLIGRU):
        monkeypatch.setattr(mod, "INTERPRET", True)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _err(j, t, relative=False):
    j, t = _np(j), _np(t)
    assert j.shape == t.shape, (j.shape, t.shape)
    scale = max(float(np.max(np.abs(j))), 1.0) if relative else 1.0
    return float(np.max(np.abs(j - t))) / scale


def _direction(kind, d, h, rng):
    """One direction's parameters with non-zero biases (numpy, JAX layout)."""
    g = {"GRU": 3, "liGRU": 2, "LSTM": 4}[kind]
    p = {"w_x": (rng.standard_normal((d, g * h)) / np.sqrt(d)
                 ).astype(np.float32),
         "w_h": (rng.standard_normal((h, g * h)) / np.sqrt(h)
                 ).astype(np.float32)}
    small = lambda: (0.2 * rng.standard_normal(g * h)).astype(np.float32)
    if kind == "GRU":
        p.update(b_x=small(), b_h=small())
    elif kind == "liGRU":
        p.update(bn_scale=1.0 + small(), bn_bias=small())
    else:
        p.update(b=small())
    return p


def _x(seed=1, b=B, t=T, d=D):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


def _pair(p, wh_scale=1.0):
    tp = convert.from_jax_params(p)
    tp["w_h"] = tp["w_h"] * wh_scale
    return jax.tree.map(jnp.asarray, p), tp


# ------------------------------------------------------------- GRU layers
def _gru_kernel_layer(reverse, dt, wh_scale=1.0):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    jp, tp = _pair(_direction("GRU", D, H, np.random.default_rng(2)),
                   wh_scale)
    x = _x()
    jy = JR.gru_layer_pallas(jp, jnp.asarray(x), reverse=reverse,
                             compute_dtype=jd)
    ty = TR.gru_layer_kernel(tp, torch.from_numpy(x), reverse=reverse,
                             compute_dtype=td)
    assert ty.dtype == td and jy.dtype == jd
    # the time-major form is the same layer
    tm = TR.gru_layer_kernel(tp, torch.from_numpy(x).transpose(0, 1),
                             reverse=reverse, compute_dtype=td,
                             time_major=True)
    assert torch.equal(tm.transpose(0, 1), ty)
    return _err(jy, ty)


@pytest.mark.parametrize("dt,atol", [("f32", KERNEL_ATOL),
                                     ("bf16", BF16_ATOL)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_kernel_matches_jax(jax_kernels, reverse, dt, atol):
    assert _gru_kernel_layer(reverse, dt) <= atol


def test_gru_layer_kernel_fails_under_doubled_w_h(jax_kernels):
    assert _gru_kernel_layer(False, "f32", wh_scale=2.0) > 100 * KERNEL_ATOL


def test_gru_layer_kernel_rounds_xg_once():
    """xg is summed in f32, b_x added in f32, and the stream rounded to the
    compute dtype once: a bf16 product followed by a bf16 add rounds twice
    and gives another stream."""
    p = convert.from_jax_params(_direction("GRU", D, H,
                                           np.random.default_rng(2)))
    x = torch.from_numpy(_x()).transpose(0, 1)
    once = (TR.matmul_f32(x, p["w_x"], torch.bfloat16)
            + p["b_x"]).to(torch.bfloat16)
    want = ((x.to(torch.bfloat16).float() @ p["w_x"].to(torch.bfloat16)
             .float()) + p["b_x"]).to(torch.bfloat16)
    assert torch.equal(once, want)
    twice = (torch.matmul(x.to(torch.bfloat16), p["w_x"].to(torch.bfloat16))
             + p["b_x"].to(torch.bfloat16))
    assert not torch.equal(once, twice)


def _bigru(wh_scale=1.0):
    rng = np.random.default_rng(3)
    jf, tf = _pair(_direction("GRU", D, H, rng))
    jb, tb = _pair(_direction("GRU", D, H, rng), wh_scale)
    x = _x(4)
    jy = JR.bigru_layer(jf, jb, jnp.asarray(x))
    ty = TR.bigru_layer(tf, tb, torch.from_numpy(x))
    assert tuple(ty.shape) == (B, T, 2 * H)
    return _err(jy, ty)


def test_bigru_layer_matches_jax(jax_kernels):
    assert _bigru() <= KERNEL_ATOL


def test_bigru_layer_fails_under_doubled_w_h(jax_kernels):
    assert _bigru(wh_scale=2.0) > 100 * KERNEL_ATOL


def _gru_loop(reverse, wh_scale=1.0):
    jp, tp = _pair(_direction("GRU", D, H, np.random.default_rng(5)),
                   wh_scale)
    x = _x(6)
    h0 = np.random.default_rng(7).standard_normal((B, H)).astype(np.float32)
    jy, jh = JR.gru_layer(jp, jnp.asarray(x), jnp.asarray(h0),
                          reverse=reverse)
    ty, th = TR.gru_layer(tp, torch.from_numpy(x), torch.from_numpy(h0),
                          reverse=reverse)
    return max(_err(jy, ty), _err(jh, th))


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_with_state_matches_jax(reverse):
    assert _gru_loop(reverse) <= LOOP_ATOL


def test_gru_layer_with_state_fails_under_doubled_w_h():
    assert _gru_loop(False, wh_scale=2.0) > 1000 * LOOP_ATOL


def test_gru_direction_takes_the_loop_above_the_fit_rule(monkeypatch):
    """Where w_h does not fit the card the layer is the plain loop under
    autograd (all in compute dtype), close to the kernel route's bf16
    product but not the same numbers."""
    p = convert.from_jax_params(_direction("GRU", D, H,
                                           np.random.default_rng(2)))
    x = torch.from_numpy(_x())
    kernel = TR.gru_direction(p, x, True, torch.float32, False)
    monkeypatch.setattr(TR.KG, "fits", lambda h, dev=None: False)
    loop = TR.gru_direction(p, x, True, torch.float32, False)
    want, _ = TR.gru_layer(p, x, reverse=True)
    assert torch.equal(loop, want)
    assert 0 < float((kernel - loop).abs().max()) <= 1e-2


# ------------------------------------------------------- light-GRU layers
def _fixed_bernoulli(monkeypatch, mask):
    """Make the JAX layer draw ``mask`` (a 0/1 array) as its dropout mask."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(mask > 0))


def _ligru(monkeypatch, bi, reverse=False, dropout=0.0, wh_scale=1.0,
           port_mask=True, dt="f32"):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rng = np.random.default_rng(8)
    jf, tf = _pair(_direction("liGRU", D, H, rng), wh_scale)
    jb, tb = _pair(_direction("liGRU", D, H, rng))
    x = _x(9)
    keep = 1.0 - dropout
    drawn = (rng.uniform(size=(B, H)) < keep).astype(np.float32)
    _fixed_bernoulli(monkeypatch, drawn)
    kw = dict(dropout=dropout, rng=jax.random.PRNGKey(0), train=True,
              compute_dtype=jd)
    mask = torch.from_numpy(drawn / keep) if port_mask else None
    tkw = dict(dropout=dropout, train=True, mask=mask, compute_dtype=td)
    if bi:
        jy = JR.biligru_layer(jf, jb, jnp.asarray(x), **kw)
        ty = TR.biligru_layer(tf, tb, torch.from_numpy(x), **tkw)
        assert tuple(ty.shape) == (B, T, 2 * H)
        return _err(jy, ty, relative=True)
    jy, jh = JR.ligru_layer(jf, jnp.asarray(x), reverse=reverse, **kw)
    ty, th = TR.ligru_layer(tf, torch.from_numpy(x), reverse=reverse, **tkw)
    assert ty.dtype == td
    return max(_err(jy, ty, relative=True), _err(jh, th, relative=True))


@pytest.mark.parametrize("dropout", [0.0, 0.4])
@pytest.mark.parametrize("reverse", [False, True])
def test_ligru_layer_matches_jax(jax_kernels, monkeypatch, reverse, dropout):
    assert _ligru(monkeypatch, False, reverse, dropout) <= KERNEL_ATOL


def test_ligru_layer_bf16_stream_matches_jax(jax_kernels, monkeypatch):
    assert _ligru(monkeypatch, False, dt="bf16") <= BF16_ATOL


@pytest.mark.parametrize("dropout", [0.0, 0.4])
def test_biligru_layer_matches_jax(jax_kernels, monkeypatch, dropout):
    assert _ligru(monkeypatch, True, dropout=dropout) <= KERNEL_ATOL


@pytest.mark.parametrize("bi", [False, True])
def test_ligru_layers_fail_under_doubled_w_h(jax_kernels, monkeypatch, bi):
    assert _ligru(monkeypatch, bi, wh_scale=2.0) > 100 * KERNEL_ATOL


@pytest.mark.parametrize("bi", [False, True])
def test_ligru_layers_fail_without_the_drawn_mask(jax_kernels, monkeypatch,
                                                  bi):
    # the port left to its own all-ones mask (no generator) against JAX's
    # drawn one
    assert _ligru(monkeypatch, bi, dropout=0.4,
                  port_mask=False) > 100 * KERNEL_ATOL


def test_ligru_batch_norm_uses_this_batch_at_decode_too():
    """No running statistics: outside training the feed-forward term is
    still normalised with this batch's mean and population variance: a
    scaled and shifted input gives the same output, and an utterance decoded
    alone gives another output than in its batch."""
    p = convert.from_jax_params(_direction("liGRU", D, H,
                                           np.random.default_rng(8)))
    x = torch.from_numpy(_x(9))
    y, _ = TR.ligru_layer(p, x, train=False)
    shifted, _ = TR.ligru_layer(p, 3.0 * x + 1.0, train=False)
    assert float((y - shifted).abs().max()) <= 1e-3
    alone, _ = TR.ligru_layer(p, x[:1], train=False)
    assert float((y[:1] - alone).abs().max()) > 1e-2


def test_ligru_mask_is_drawn_once_for_both_directions():
    gen = torch.Generator().manual_seed(4)
    mask = TR.ligru_mask(B, H, 0.5, gen, True, "cpu")
    assert set(mask.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(TR.ligru_mask(B, H, 0.5, None, True, "cpu"),
                       torch.ones(B, H))
    assert torch.equal(TR.ligru_mask(B, H, 0.5, gen, False, "cpu"),
                       torch.ones(B, H))
    rng = np.random.default_rng(8)
    pf = convert.from_jax_params(_direction("liGRU", D, H, rng))
    pb = convert.from_jax_params(_direction("liGRU", D, H, rng))
    x = torch.from_numpy(_x(9))
    y = TR.biligru_layer(pf, pb, x, dropout=0.5, train=True,
                         gen=torch.Generator().manual_seed(4))
    want = TR.biligru_layer(pf, pb, x, mask=mask)
    assert torch.equal(y, want)
    # a dropped unit's fw and bw candidates are both gone
    fw_only, _ = TR.ligru_layer(pf, x, mask=mask)
    assert torch.equal(y[..., :H], fw_only)


def test_ligru_layer_takes_the_loop_above_the_fit_rule(monkeypatch):
    p = convert.from_jax_params(_direction("liGRU", D, H,
                                           np.random.default_rng(8)))
    x = torch.from_numpy(_x(9))
    mask = TR.ligru_mask(B, H, 0.5, torch.Generator().manual_seed(1), True,
                         "cpu")
    kernel, kh = TR.ligru_layer(p, x, reverse=True, mask=mask)
    monkeypatch.setattr(TR.KLG, "fits", lambda h, dev=None: False)
    loop, lh = TR.ligru_layer(p, x, reverse=True, mask=mask)
    assert torch.equal(lh, loop[:, 0]) and torch.equal(kh, kernel[:, 0])
    scale = float(loop.abs().max())
    assert 0 < float((kernel - loop).abs().max()) <= 1e-2 * scale


def _launch_counts():
    return tuple(getattr(mod, name) for mod in (KG, KLG) for name in (
        "FWD_LAUNCHES", "FWD_PACKED_LAUNCHES", "FWD_SINGLE_LAUNCHES",
        "BWD_LAUNCHES", "BWD_PACKED_LAUNCHES", "BWD_SINGLE_LAUNCHES")) + (
            KL.FWD_LAUNCHES,)


def test_layers_count_no_launch_on_cpu():
    before = _launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_x()).requires_grad_()
    g = convert.from_jax_params(_direction("GRU", D, H, rng))
    l = convert.from_jax_params(_direction("liGRU", D, H, rng))
    y = TR.bigru_layer(g, g, x).sum() + TR.biligru_layer(l, l, x).sum()
    y.backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    assert before == _launch_counts()


@pytest.mark.parametrize("module", ["GRU", "liGRU"])
def test_bidirectional_layer_makes_one_recurrence_call(monkeypatch, module):
    """Both directions of a bidirectional layer go to the kernels' module in
    one call (one packed launch on the card), the backward one's operands
    second, and the layer's output is [fw ; bw] of what it returns."""
    mod, name = ((TR.KG, "bigru_recurrence") if module == "GRU"
                 else (TR.KLG, "biligru_recurrence"))
    calls = []
    sound = getattr(mod, name)

    def spy(*args):
        calls.append(args)
        return sound(*args)
    monkeypatch.setattr(mod, name, spy)
    rng = np.random.default_rng(11)
    pf = convert.from_jax_params(_direction(module, D, H, rng))
    pb = convert.from_jax_params(_direction(module, D, H, rng))
    x = torch.from_numpy(_x(12))
    if module == "GRU":
        y = TR.bigru_layer(pf, pb, x)
        want = [TR.gru_direction(p, x, rev, torch.float32, False)
                for p, rev in ((pf, False), (pb, True))]
    else:
        mask = TR.ligru_mask(B, H, 0.5, torch.Generator().manual_seed(2),
                             True, "cpu")
        y = TR.biligru_layer(pf, pb, x, mask=mask)
        want = [TR.ligru_layer(p, x, reverse=rev, mask=mask)[0]
                for p, rev in ((pf, False), (pb, True))]
    assert len(calls) == 1
    assert calls[0][2] is pf["w_h"] and calls[0][3] is pb["w_h"]
    assert torch.equal(y, torch.cat(want, dim=-1))


@pytest.mark.parametrize("module", ["GRU", "liGRU"])
def test_bidirectional_layer_backward_makes_one_pair_call(monkeypatch,
                                                          module):
    """The backward of a bidirectional layer reaches the kernels' module in
    one call for both directions (one packed launch on the card), and its
    gradients are those of the two directions run as single-direction
    layers."""
    mod, name = ((TR.KG, "gru_bwd_pair") if module == "GRU"
                 else (TR.KLG, "ligru_bwd_pair"))
    calls = []
    sound = getattr(mod, name)

    def spy(*args):
        calls.append(args)
        return sound(*args)
    monkeypatch.setattr(mod, name, spy)
    rng = np.random.default_rng(12)
    pf, pb = (convert.from_jax_params(_direction(module, D, H, rng))
              for _ in range(2))
    for p in (pf, pb):
        p["w_h"] = p["w_h"].clone().requires_grad_()
    x = torch.from_numpy(_x(13)).requires_grad_()
    mask = TR.ligru_mask(B, H, 0.5, torch.Generator().manual_seed(3), True,
                         "cpu")

    def layer(direction):
        if module == "GRU":
            if direction is None:
                return TR.bigru_layer(pf, pb, x)
            p, rev = direction
            return TR.gru_direction(p, x, rev, torch.float32, False)
        if direction is None:
            return TR.biligru_layer(pf, pb, x, mask=mask)
        p, rev = direction
        return TR.ligru_layer(p, x, reverse=rev, mask=mask)[0]
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, T, 2 * H)).astype(np.float32))
    got = torch.autograd.grad(layer(None), (x, pf["w_h"], pb["w_h"]), dy)
    assert len(calls) == 1
    y = torch.cat([layer((pf, False)), layer((pb, True))], dim=-1)
    want = torch.autograd.grad(y, (x, pf["w_h"], pb["w_h"]), dy)
    assert len(calls) == 1        # a single-direction layer does not call it
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


# ------------------------------------------------------ the stacked GRU
def _gru_stack(n_layers, seed):
    rng = np.random.default_rng(seed)
    layers, d = [], D
    for _ in range(n_layers):
        layers.append(_direction("GRU", d, H, rng))
        d = H
    return layers


def _stacked_both(stateful, train, wh_scale=1.0):
    layers = _gru_stack(2, seed=10)
    x = _x(11)
    state = None
    if stateful:
        state = np.random.default_rng(12).standard_normal(
            (2, B, H)).astype(np.float32)
    jy, jstate = JR.stacked_sequence(
        jax.tree.map(jnp.asarray, layers), "GRU", jnp.asarray(x),
        None if state is None else jnp.asarray(state), dropout=0.0,
        rng=jax.random.PRNGKey(0), train=train)
    tl = convert.from_jax_params(layers)
    tl[0]["w_h"] = tl[0]["w_h"] * wh_scale
    ty, tstate = TR.stacked_sequence(
        tl, "GRU", torch.from_numpy(x),
        None if state is None else torch.from_numpy(state), dropout=0.0,
        gen=torch.Generator().manual_seed(0), train=train)
    assert tuple(tstate.shape) == (2, B, H)
    return max(_err(jy, ty), _err(jstate, tstate))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("stateful", [False, True])
def test_stacked_gru_sequence_matches_jax(stateful, train):
    assert _stacked_both(stateful, train) <= LOOP_ATOL


def test_stacked_gru_sequence_fails_under_doubled_w_h():
    assert _stacked_both(True, False, wh_scale=2.0) > 1000 * LOOP_ATOL


def _stacked_step_both(bx_scale=1.0):
    layers = _gru_stack(2, seed=13)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((B, D)).astype(np.float32)
    state = rng.standard_normal((2, B, H)).astype(np.float32)
    jo, js = JR.stacked_step(jax.tree.map(jnp.asarray, layers), "GRU",
                             jnp.asarray(x), jnp.asarray(state))
    tl = convert.from_jax_params(layers)
    tl[1]["b_x"] = tl[1]["b_x"] * bx_scale
    to, ts = TR.stacked_step(tl, "GRU", torch.from_numpy(x),
                             torch.from_numpy(state))
    assert torch.equal(to, ts[-1])
    return max(_err(jo, to), _err(js, ts))


def test_stacked_gru_step_matches_jax():
    assert _stacked_step_both() <= LOOP_ATOL


def test_stacked_gru_step_fails_under_doubled_b_x():
    assert _stacked_step_both(bx_scale=2.0) > 1000 * LOOP_ATOL


def test_stacked_gru_init_and_zero_state():
    layers = TR.stacked_init(torch.Generator().manual_seed(0), "GRU", D, H, 2)
    assert [sorted(p) for p in layers] == [["b_h", "b_x", "w_h", "w_x"]] * 2
    assert tuple(layers[1]["w_x"].shape) == (H, 3 * H)
    z = TR.stacked_zero_state("GRU", 2, B, H)
    assert isinstance(z, torch.Tensor) and tuple(z.shape) == (2, B, H)
    assert isinstance(TR.stacked_zero_state("LSTM", 2, B, H), tuple)
    with pytest.raises(ValueError):
        TR.stacked_init(torch.Generator().manual_seed(0), "liGRU", D, H, 2)


# --------------------------------------------------------------- a GRU LM
LM_MODEL = dict(emb_tying=True, emb_dim=H, module="GRU", dim=H, n_layers=2,
                dropout=0.0)
VOCAB = 31


def _lm_both(stateful, emb_scale=1.0):
    jspec = JLM.build_spec(VOCAB, **LM_MODEL)
    tspec = TLM.build_spec(VOCAB, **LM_MODEL)
    assert tspec.module == jspec.module == "GRU"
    jp = JLM.lm_init(jax.random.PRNGKey(5), jspec)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    tp["emb"] = tp["emb"] * emb_scale
    tok = np.random.default_rng(8).integers(0, VOCAB, (B, 7)).astype(np.int32)
    jh = JLM.lm_zero_state(jspec, B) if stateful else None
    th = TLM.lm_zero_state(tspec, B) if stateful else None
    jl, jh = JLM.lm_apply(jp, jspec, jnp.asarray(tok), jh)
    tl, th = TLM.lm_apply(tp, tspec, torch.from_numpy(tok).long(), th)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 7, VOCAB)
    err = max(_err(jl, tl), _err(jh, th))
    # the single-token step from the sequence's final state
    nxt = np.array([1, 2, 3], np.int32)
    js, jh2 = JLM.lm_step(jp, jspec, jnp.asarray(nxt), jh)
    ts, th2 = TLM.lm_step(tp, tspec, torch.from_numpy(nxt).long(), th)
    return max(err, _err(js, ts), _err(jh2, th2))


@pytest.mark.parametrize("stateful", [False, True])
def test_gru_lm_apply_and_step_match_jax(stateful):
    # logits are sums of 16 products of O(1) embeddings: 5e-5
    assert _lm_both(stateful) <= 5 * LOOP_ATOL


def test_gru_lm_fails_under_doubled_embedding():
    assert _lm_both(False, emb_scale=2.0) > 1000 * LOOP_ATOL


def test_gru_lm_apply_equals_lm_step_unrolled():
    spec = TLM.build_spec(VOCAB, **LM_MODEL)
    params = TLM.lm_init(torch.Generator().manual_seed(2), spec)
    tok = torch.from_numpy(np.random.default_rng(9).integers(0, VOCAB,
                                                             (2, 6)))
    hidden, steps = TLM.lm_zero_state(spec, 2), []
    for i in range(6):
        logit, hidden = TLM.lm_step(params, spec, tok[:, i], hidden)
        steps.append(logit)
    seq, final = TLM.lm_apply(params, spec, tok)
    assert float((seq - torch.stack(steps, dim=1)).abs().max()) <= 1e-5
    assert float((final - hidden).abs().max()) <= 1e-6


# ------------------------------------------------------------ the encoders
ENC = dict(vgg=6, vgg_freq=-1, vgg_low_filt=-1, dim=[16, 16],
           dropout=[0.0, 0.0], layer_norm=[True, False], proj=[False, True],
           sample_rate=[2, 1], sample_style="concat")
KINDS = [(m, bi) for m in ("GRU", "liGRU", "LSTM") for bi in (True, False)]


def _encoder_both(module, bidirection, wh_scale=1.0):
    kw = dict(ENC, module=module, bidirection=bidirection)
    jspec, tspec = JE.make_spec(120, **kw), TE.make_spec(120, **kw)
    assert tspec.out_dim == jspec.out_dim == (32 if bidirection else 16)
    assert tspec.layer_in_dims == jspec.layer_in_dims
    assert tspec.layer_out_dims == jspec.layer_out_dims
    jp = JE.encoder_init(jax.random.PRNGKey(7), jspec)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    own = TE.encoder_init(torch.Generator().manual_seed(0), tspec)
    assert (jax.tree.structure(jax.tree.map(np.asarray, jp))
            == jax.tree.structure(convert.tree_map(lambda a: a.numpy(), own)))
    tp["layers"][1]["fw"]["w_h"] = tp["layers"][1]["fw"]["w_h"] * wh_scale
    rng = np.random.default_rng(0)
    feat = rng.uniform(0.0, 1.0, (2, 37, 120)).astype(np.float32)
    feat_len = np.array([37, 28], np.int32)
    jy, jl = JE.encoder_apply(jp, jspec, jnp.asarray(feat),
                              jnp.asarray(feat_len))
    ty, tl = TE.encoder_apply(tp, tspec, torch.from_numpy(feat),
                              torch.from_numpy(feat_len).long())
    assert tuple(ty.shape) == jy.shape == (2, 5, tspec.out_dim)
    assert np.array_equal(np.asarray(jl), tl.numpy())
    return _err(jy, ty)


@pytest.mark.parametrize("module,bidirection", KINDS)
def test_encoder_kinds_match_jax(jax_kernels, module, bidirection):
    # the stack ends in a tanh projection: |y| <= 1 for every module
    assert _encoder_both(module, bidirection) <= KERNEL_ATOL


@pytest.mark.parametrize("module,bidirection", KINDS)
def test_encoder_kinds_fail_under_doubled_w_h(jax_kernels, module,
                                              bidirection):
    assert _encoder_both(module, bidirection,
                         wh_scale=2.0) > 10 * KERNEL_ATOL


def test_encoder_refuses_an_unknown_module():
    with pytest.raises(ValueError, match="LSTM, GRU or liGRU"):
        TE.make_spec(120, **dict(ENC, module="RNN", bidirection=True))


def test_ligru_encoder_skips_the_per_layer_dropout():
    """The light GRU applies its own recurrent dropout: in train mode the
    generator is asked for one (B,H) mask per layer and nothing else, while
    a GRU encoder draws a mask of its whole output."""
    feat = torch.from_numpy(np.random.default_rng(0).uniform(
        0.0, 1.0, (2, 37, 120)).astype(np.float32))
    feat_len = torch.tensor([37, 28])
    states = {}
    for module in ("liGRU", "GRU"):
        kw = dict(ENC, module=module, bidirection=True, dropout=[0.5, 0.5])
        spec = TE.make_spec(120, **kw)
        params = TE.encoder_init(torch.Generator().manual_seed(0), spec)
        gen = torch.Generator().manual_seed(3)
        y, _ = TE.encoder_apply(params, spec, feat, feat_len, train=True,
                                gen=gen)
        assert bool(torch.isfinite(y).all())
        states[module] = gen.get_state()
        again, _ = TE.encoder_apply(params, spec, feat, feat_len, train=True,
                                    gen=torch.Generator().manual_seed(3))
        assert torch.equal(y, again)
        quiet, _ = TE.encoder_apply(params, spec, feat, feat_len)
        assert not torch.equal(y, quiet)
    want = torch.Generator().manual_seed(3)
    for _ in range(2):                                  # two (B,H) masks
        torch.rand((2, 16), generator=want)
    assert torch.equal(states["liGRU"], want.get_state())
    assert not torch.equal(states["GRU"], want.get_state())


@pytest.mark.parametrize("module,bidirection", [("GRU", True),
                                                ("liGRU", True),
                                                ("LSTM", False)])
def test_cast_matmul_weights_is_the_per_use_cast(module, bidirection):
    """The solver casts w_x / w_h to the compute dtype once; the biases and
    the batch norm's scale and bias stay f32, and a bf16 encoder gives
    exactly what the per-use casts give."""
    kw = dict(ENC, module=module, bidirection=bidirection)
    spec = TE.make_spec(120, **kw)
    params = TE.encoder_init(torch.Generator().manual_seed(0), spec)
    cast = convert.cast_matmul_weights(params, torch.bfloat16)
    fw = cast["layers"][0]["fw"]
    assert fw["w_x"].dtype == fw["w_h"].dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for k, v in fw.items()
               if k not in ("w_x", "w_h"))
    feat = torch.from_numpy(np.random.default_rng(0).uniform(
        0.0, 1.0, (2, 37, 120)).astype(np.float32))
    feat_len = torch.tensor([37, 28])
    a, _ = TE.encoder_apply(params, spec, feat, feat_len, torch.bfloat16)
    b, _ = TE.encoder_apply(cast, spec, feat, feat_len, torch.bfloat16)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
