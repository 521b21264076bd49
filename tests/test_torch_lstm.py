"""Port of the single-direction LSTM recurrences (K5f/K5b resident, K6f/K6b
gate-chunked) against the JAX package's Pallas kernels run in interpret
mode, and the CUDA kernels against their plain PyTorch versions (those skip
without a card).

Tolerances. The plain versions take the same bf16 products as the kernels,
exact in f32, so with an f32 stream ys agrees to 1e-5 (only the order of the
f32 sums differs). With a bf16 stream ys is rounded to bf16: one bf16 ulp at
|h| <= 1 is 2^-8, and a flipped rounding feeds back, so 1e-2. K5b's dxg is
bf16 whatever the stream: one bf16 ulp of its range, 2^-7 * max|dxg|. K6b's
dxg is f32 and unrounded: 1e-5 of its range with an f32 stream. dW_h sums
T*B products of those: the same relative bounds on its range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.ops.pallas import lstm as PL
from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as K

YS_ATOL = {"f32": 1e-5, "bf16": 1e-2}
BF16_ULP_OF_RANGE = 2.0 ** -7
F32_REL = 1e-5
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# (T, B, H): the chunked JAX kernel needs lane-aligned chunks, so H = 128
# with _CHUNK_BYTES patched to 32768 (4 chunks of 128 gate columns)
RESIDENT_SHAPES = [(11, 3, 8), (9, 2, 40)]
CHUNKED_SHAPE = (7, 2, 128)


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode."""
    monkeypatch.setattr(PL, "INTERPRET", True)
    monkeypatch.setattr(PL, "_CHUNK_BYTES", 32768)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    return torch.device("cuda")


def _inputs(t, b, h, seed):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((t, b, 4 * h)).astype(np.float32)
    w_h = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    dy = rng.standard_normal((t, b, h)).astype(np.float32)
    return xg, w_h, dy


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _both(shape, dt, form, reverse=False, wh_scale=1.0):
    """ys, dxg, dW_h of the JAX kernel pair (interpret mode) and of the
    port's autograd Function on CPU tensors (its plain versions)."""
    jd, td = DTYPES[dt]
    xg, w_h, dy = _inputs(*shape, seed=sum(shape))
    if form == "resident":
        jfn = lambda a, w: PL.lstm_recurrence(a, w, reverse=reverse)
        tfn = lambda a, w: K.lstm_recurrence(a, w, reverse=reverse)
    else:
        assert PL._n_chunks(shape[2]) == 4
        jfn, tfn = PL.lstm_recurrence_chunked, K.lstm_recurrence_chunked
    jys, vjp = jax.vjp(jfn, jnp.asarray(xg, jd), jnp.asarray(w_h))
    jdxg, jdwh = vjp(jnp.asarray(dy, jd))
    txg = torch.from_numpy(xg).to(td).requires_grad_()
    twh = torch.from_numpy(w_h * wh_scale).requires_grad_()
    tys = tfn(txg, twh)
    tdxg, tdwh = torch.autograd.grad(tys, (txg, twh),
                                     torch.from_numpy(dy).to(td))
    assert tys.dtype == td and tdxg.dtype == td and tdwh.dtype == torch.float32
    return [(_f32(j), _f32(t)) for j, t in ((jys, tys), (jdxg, tdxg),
                                            (jdwh, tdwh))]


def _check(pairs, dt, form):
    (jys, tys), (jdxg, tdxg), (jdwh, tdwh) = pairs
    assert np.max(np.abs(jys - tys)) <= YS_ATOL[dt]
    rounded = dt == "bf16" or form == "resident"
    rel = BF16_ULP_OF_RANGE if rounded else F32_REL
    assert np.max(np.abs(jdxg - tdxg)) <= rel * np.max(np.abs(jdxg))
    assert np.max(np.abs(jdwh - tdwh)) <= rel * np.max(np.abs(jdwh))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", RESIDENT_SHAPES)
def test_resident_plain_matches_jax_kernel(interpret, shape, reverse, dt):
    _check(_both(shape, dt, "resident", reverse), dt, "resident")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_chunked_plain_matches_jax_kernel(interpret, dt):
    _check(_both(CHUNKED_SHAPE, dt, "chunked"), dt, "chunked")


@pytest.mark.parametrize("form,shape", [("resident", RESIDENT_SHAPES[0]),
                                        ("chunked", CHUNKED_SHAPE)])
def test_plain_vs_jax_fails_under_doubled_w_h(interpret, form, shape):
    (jys, tys), (jdxg, tdxg), _ = _both(shape, "f32", form, wh_scale=2.0)
    assert np.max(np.abs(jys - tys)) > 100 * YS_ATOL["f32"]
    assert (np.max(np.abs(jdxg - tdxg))
            > 10 * BF16_ULP_OF_RANGE * np.max(np.abs(jdxg)))


def test_resident_and_chunked_backwards_round_differently():
    """From the same stashes and an f32 stream, K5b's dxg is bf16 and K6b's
    is f32 and unrounded: they differ by at most one bf16 rounding of the
    value, and they do differ."""
    xg, w_h, dy = (torch.from_numpy(a) for a in _inputs(9, 3, 32, seed=5))
    _, cs, gs = K.lstm_fwd(xg, w_h, stash=True)
    d5 = K.lstm_bwd(w_h, cs, gs, dy)
    d6 = K.lstm_bwd_chunked(w_h, cs, gs, dy)
    assert d5.dtype == torch.bfloat16 and d6.dtype == torch.float32
    assert not torch.equal(d6.to(torch.bfloat16).float(), d6)
    diff = (d5.float() - d6).abs()
    assert diff.max() > 0
    # the last backward step (t = 0 is visited last; t = T-1 first) has no
    # recurrent feedback yet: there d5 is exactly the rounding of d6
    assert torch.equal(d5[-1], d6[-1].to(torch.bfloat16))
    assert bool((diff <= 2.0 ** -7 * d6.abs().max()).all())


def test_chunked_forward_equals_resident_forward():
    """The forward's chunking changes only the order of the f32 sums."""
    xg, w_h, _ = (torch.from_numpy(a) for a in _inputs(6, 2, 96, seed=2))
    a = K.lstm_fwd(xg, w_h, stash=True)
    b = K.lstm_fwd_chunked(xg, w_h, stash=True)
    assert float((a[0] - b[0]).abs().max()) <= 1e-5


@pytest.mark.parametrize("hidden,form", [(1024, "lstm_recurrence"),
                                         (1280, "lstm_recurrence"),
                                         (2048, "lstm_recurrence_chunked"),
                                         (4096, "lstm_recurrence_chunked")])
def test_threshold_sends_each_lm_to_its_kernel(hidden, form):
    """config/librispeech_lm.yaml (4x LSTM-1024) reaches K5 and
    config/librispeech_lm_best.yaml (4x LSTM-2048) K6, from an H100's SM
    count and shared memory."""
    assert K.recurrence_fn(hidden).__name__ == form
    assert K.fits_resident(hidden) == (form == "lstm_recurrence")


def test_padding_keeps_the_result():
    """The wrappers pad H to a multiple of 16 with zero units: the plain
    version on the padded operands gives the unpadded result."""
    xg, w_h, dy = (torch.from_numpy(a) for a in _inputs(5, 2, 20, seed=1))
    ys, cs, gs = K.lstm_recurrence_ref(xg, w_h, stash=True)
    hp = K._padded(20)
    assert hp == 32
    pys, pcs, pgs = K.lstm_recurrence_ref(
        K._pad_units(xg, 20, hp, 4), K._pad_w(w_h, 20, hp).float(),
        stash=True)
    assert float((K._unpad_units(pys, 20, hp, 1) - ys).abs().max()) <= 1e-6
    assert torch.equal(K._unpad_units(pgs, 20, hp, 4), gs)
    assert float(pys[..., 20:].abs().max()) == 0.0
    dxg = K.lstm_recurrence_bwd_ref(w_h, cs, gs, dy)
    pdxg = K.lstm_recurrence_bwd_ref(
        K._pad_w(w_h, 20, hp).float(), K._pad_units(cs, 20, hp, 1),
        K._pad_units(gs, 20, hp, 4), K._pad_units(dy, 20, hp, 1))
    # the padded contraction sums in another order: a bf16 rounding may flip
    err = (K._unpad_units(pdxg, 20, hp, 4).float() - dxg.float()).abs().max()
    assert float(err) <= BF16_ULP_OF_RANGE * float(dxg.float().abs().max())
    assert float(pdxg.reshape(5, 2, 4, hp)[..., 20:].abs().max()) == 0.0


def test_cpu_tensors_take_the_plain_versions():
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES, K.FWD_CHUNKED_LAUNCHES,
              K.BWD_CHUNKED_LAUNCHES)
    xg, w_h, dy = (torch.from_numpy(a) for a in _inputs(5, 2, 8, seed=0))
    ys, cs, gs = K.lstm_fwd(xg, w_h, reverse=True, stash=True)
    ref = K.lstm_recurrence_ref(xg, w_h, reverse=True, stash=True)
    assert all(torch.equal(a, b) for a, b in zip((ys, cs, gs), ref))
    assert torch.equal(K.lstm_bwd(w_h, cs, gs, dy, reverse=True),
                       K.lstm_recurrence_bwd_ref(w_h, cs, gs, dy, True))
    assert torch.equal(K.lstm_fwd_chunked(xg, w_h),
                       K.lstm_recurrence_chunked_ref(xg, w_h))
    assert torch.equal(K.lstm_bwd_chunked(w_h, cs, gs, dy),
                       K.lstm_recurrence_chunked_bwd_ref(w_h, cs, gs, dy))
    assert before == (K.FWD_LAUNCHES, K.BWD_LAUNCHES, K.FWD_CHUNKED_LAUNCHES,
                      K.BWD_CHUNKED_LAUNCHES)


@pytest.mark.parametrize("bad", ["xg_shape", "w_shape", "dtype", "stash"])
def test_wrappers_refuse_bad_operands(bad):
    xg, w_h, dy = (torch.from_numpy(a) for a in _inputs(5, 2, 8, seed=0))
    if bad == "stash":
        _, cs, gs = K.lstm_fwd(xg, w_h, stash=True)
        with pytest.raises(TypeError):
            K.lstm_bwd(w_h, cs.float(), gs, dy)
        return
    if bad == "xg_shape":
        xg = xg[..., :30]
    elif bad == "w_shape":
        w_h = w_h[:4]
    else:
        xg = xg.double()
    for fn in (K.lstm_recurrence, K.lstm_recurrence_chunked):
        with pytest.raises((ValueError, TypeError)):
            fn(xg, w_h)


# ---------------------------------------------------------------- on a card
# ys: as the direction-packed kernels (a flipped rounding of bf16(h) feeds
# back): 2e-3 for f32 streams, 1.6e-2 for bf16; dxg: one bf16 ulp at the top
# of its range, 2^-6 * max|dxg|. Before the first flip kernel and plain
# version agree to f32 noise, so the mean |err| over the first EARLY_STEPS
# steps of each walk holds the bf16-operand contract: sums of up to 8192
# products over 128 rows read 1e-7 to 7e-7 there when sound and 1.7e-5 or
# more with an f32 operand, so the bound is 3e-6.
CUDA_ATOL = {"f32": 2e-3, "bf16": 1.6e-2}
BWD_REL = 2.0 ** -6
EARLY_STEPS = 4
EARLY_MEAN_TOL = 3e-6
CARD_SHAPES = [(37, 3, 200), (5, 2, 16), (48, 130, 256)]
FAULT_SHAPE = (96, 16, 512)


def _card_inputs(cuda, shape, dt):
    xg, w_h, dy = (torch.from_numpy(a).to(cuda)
                   for a in _inputs(*shape, seed=sum(shape)))
    return xg.to(DTYPES[dt][1]), w_h, dy.to(DTYPES[dt][1])


def _errors(out, ref, first_steps_at_end):
    t = out.shape[0]
    k = min(EARLY_STEPS, t)
    d = (out.float() - ref.float()).abs()
    early = d[t - k:] if first_steps_at_end else d[:k]
    return d.max().item(), early.mean().item()


def _card_pair(form, xg, w_h, dy, reverse, ref_w_h=None):
    """(ys errors, dxg errors relative to the range) of kernel vs plain."""
    rw = w_h if ref_w_h is None else ref_w_h
    if form == "resident":
        ys, cs, gs = K.lstm_fwd(xg, w_h, reverse, stash=True)
        dxg = K.lstm_bwd(w_h, cs, gs, dy, reverse)
        torch.cuda.synchronize()
        rys = K.lstm_recurrence_ref(xg, rw, reverse)
        rdxg = K.lstm_recurrence_bwd_ref(rw, cs, gs, dy, reverse)
    else:
        ys, cs, gs = K.lstm_fwd_chunked(xg, w_h, stash=True)
        dxg = K.lstm_bwd_chunked(w_h, cs, gs, dy)
        torch.cuda.synchronize()
        rys = K.lstm_recurrence_chunked_ref(xg, rw)
        rdxg = K.lstm_recurrence_chunked_bwd_ref(rw, cs, gs, dy)
    f_full, f_early = _errors(ys, rys, reverse)
    b_full, b_early = _errors(dxg, rdxg, not reverse)
    return (f_full, f_early), (b_full / rdxg.float().abs().max().item(),
                               b_early)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form,reverse", [("resident", False),
                                          ("resident", True),
                                          ("chunked", False)])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_plain_on_card(cuda, shape, form, reverse, dt):
    xg, w_h, dy = _card_inputs(cuda, shape, dt)
    names = (("FWD_LAUNCHES", "BWD_LAUNCHES") if form == "resident"
             else ("FWD_CHUNKED_LAUNCHES", "BWD_CHUNKED_LAUNCHES"))
    before = [getattr(K, n) for n in names]
    (f_full, f_early), (b_rel, b_early) = _card_pair(form, xg, w_h, dy,
                                                     reverse)
    assert [getattr(K, n) for n in names] == [b + 1 for b in before]
    assert f_full <= CUDA_ATOL[dt] and f_early <= EARLY_MEAN_TOL
    assert b_rel <= BWD_REL and b_early <= EARLY_MEAN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["resident", "chunked"])
@pytest.mark.parametrize("fault", ["w_h_x2", "f32_operand"])
def test_kernels_vs_plain_fail_under_planted_fault(cuda, monkeypatch, form,
                                                   fault):
    xg, w_h, dy = _card_inputs(cuda, FAULT_SHAPE, "bf16")
    ref_w_h = None
    if fault == "w_h_x2":
        ref_w_h = 2 * w_h
    else:
        monkeypatch.setattr(K, "_h_operand", lambda h: h)
        monkeypatch.setattr(K, "_dg_operand", lambda d: d)
    (f_full, f_early), (b_rel, b_early) = _card_pair(form, xg, w_h, dy, False,
                                                     ref_w_h)
    assert f_full > CUDA_ATOL["bf16"] or f_early > EARLY_MEAN_TOL
    assert b_rel > BWD_REL or b_early > EARLY_MEAN_TOL


@pytest.mark.cuda
def test_autograd_functions_on_card_match_cpu(cuda):
    """Both Functions end to end on the card against the CPU plain path."""
    xg, w_h, dy = _inputs(12, 4, 64, seed=9)
    for fn in (K.lstm_recurrence, K.lstm_recurrence_chunked):
        grads = {}
        for where in ("cpu", cuda):
            a = torch.from_numpy(xg).to(where).requires_grad_()
            w = torch.from_numpy(w_h).to(where).requires_grad_()
            ys = fn(a, w)
            grads[str(where)] = [g.cpu() for g in torch.autograd.grad(
                ys, (a, w), torch.from_numpy(dy).to(where))] + [ys.cpu()]
        for c, g in zip(grads["cpu"], grads[str(cuda)]):
            assert float((c - g).abs().max()) <= 2e-3 * max(
                1.0, float(c.abs().max()))
