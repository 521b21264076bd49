"""Port of the single-direction LSTM recurrences (K5f/K5b, in a narrow and
a wide form on the card; K6f/K6b gate-chunked) against the JAX package's
Pallas kernels run in interpret mode, the rule that picks a kernel and a
form, the operand layouts, and the CUDA kernels against their plain
PyTorch versions (those skip without a card).

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
from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as KB
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


# The rule on three cards: an H100 (132 SMs, 232,448 bytes a block), one
# with less shared memory and one with fewer SMs. K5 takes the widths K5f's
# narrow form holds (one direction's 10-unit blocks on the SMs, K1's slab in
# a block's shared memory), and picks the narrow form of K5f for one m16
# tile of rows, the wide one above; any other H is refused with the reason
# and takes K6.
CARDS = {"h100": ((K.H100_SMS, K.H100_SMEM_OPTIN), {200, 1024, 1280}),
         "less_smem": ((132, 100000), {200}),
         "fewer_sms": ((110, 232448), {200, 1024})}


@pytest.mark.parametrize("batch", [3, 8, 16, 128])
@pytest.mark.parametrize("hidden", [200, 1024, 1280, 1536, 2048])
@pytest.mark.parametrize("card", sorted(CARDS))
def test_form_rule_picks_the_kernel_and_the_form(monkeypatch, card, hidden,
                                                 batch):
    numbers, k5_widths = CARDS[card]
    monkeypatch.setattr(K, "_card", lambda device=None: numbers)
    if hidden in k5_widths:
        assert K.fits_resident(hidden)
        assert K.recurrence_fn(hidden) is K.lstm_recurrence
        assert K.form_for(hidden, batch) == ("narrow" if batch <= 16
                                             else "wide")
    else:
        assert not K.fits_resident(hidden)
        assert K.recurrence_fn(hidden) is K.lstm_recurrence_chunked
        with pytest.raises(ValueError, match="does not fit K5"):
            K.form_for(hidden, batch)


@pytest.mark.parametrize("n_steps", [1, 2, 7])
@pytest.mark.parametrize("reverse", [False, True])
def test_time_index_walks_each_step_once(n_steps, reverse):
    """The forward visits t = s, or t = T-1-s reversed; the backward walks
    the same data indices from the other end; each visits every t once."""
    fwd = [K.time_index(s, n_steps, reverse) for s in range(n_steps)]
    bwd = [K.time_index(s, n_steps, reverse, backward=True)
           for s in range(n_steps)]
    assert fwd == ([n_steps - 1 - s for s in range(n_steps)] if reverse
                   else list(range(n_steps)))
    assert bwd == fwd[::-1]
    assert sorted(fwd) == list(range(n_steps))


def test_reversed_plain_version_is_the_forward_one_on_the_flipped_stream():
    """The plain versions walk the map above: a reversed scan is the plain
    scan of the time-flipped stream, flipped back, exactly; so is its
    backward."""
    xg, w_h, dy = (torch.from_numpy(a) for a in _inputs(6, 3, 24, seed=4))
    flip = lambda x: torch.flip(x, [0])  # noqa: E731
    ys, cs, gs = K.lstm_recurrence_ref(xg, w_h, reverse=True, stash=True)
    fys, fcs, fgs = K.lstm_recurrence_ref(flip(xg), w_h, stash=True)
    assert all(torch.equal(a, flip(b)) for a, b in ((ys, fys), (cs, fcs),
                                                    (gs, fgs)))
    assert torch.equal(K.lstm_recurrence_bwd_ref(w_h, cs, gs, dy, True),
                       flip(K.lstm_recurrence_bwd_ref(w_h, fcs, fgs,
                                                      flip(dy))))


# the padded H each form of K5 runs at: K5f's narrow one K1's multiple of
# 80, K5b (and K5f's wide form's backward) the chunked backward's multiple of
# 32 (the chunked forward pads to 128: test_chunked_padding_keeps_the_result)
PADDINGS = {"narrow": (KB._padded, 80), "wide": (K._padded, 32)}


@pytest.mark.parametrize("form", K.FORMS)
def test_padding_keeps_the_result(form):
    """The wrappers pad H with zero units: the plain version on the padded
    operands gives the unpadded result."""
    xg, w_h, dy = (torch.from_numpy(a) for a in _inputs(5, 2, 20, seed=1))
    ys, cs, gs = K.lstm_recurrence_ref(xg, w_h, stash=True)
    pad, want = PADDINGS[form]
    hp = pad(20)
    assert hp == want
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


COUNTERS = ("FWD_LAUNCHES", "FWD_NARROW_LAUNCHES", "FWD_WIDE_LAUNCHES",
            "BWD_LAUNCHES", "FWD_CHUNKED_LAUNCHES", "BWD_CHUNKED_LAUNCHES")


@pytest.mark.parametrize("batch", [2, 16, 17])
def test_cpu_tensors_take_the_plain_versions(batch):
    """Whatever form the rule would give the batch on a card, a CPU tensor
    takes the plain version and launches nothing."""
    before = [getattr(K, n) for n in COUNTERS]
    xg, w_h, dy = (torch.from_numpy(a) for a in _inputs(5, batch, 8, seed=0))
    ys, cs, gs = K.lstm_fwd(xg, w_h, reverse=True, stash=True)
    ref = K.lstm_recurrence_ref(xg, w_h, reverse=True, stash=True)
    assert all(torch.equal(a, b) for a, b in zip((ys, cs, gs), ref))
    assert torch.equal(K.lstm_bwd(w_h, cs, gs, dy, reverse=True),
                       K.lstm_recurrence_bwd_ref(w_h, cs, gs, dy, True))
    assert torch.equal(K.lstm_fwd_chunked(xg, w_h),
                       K.lstm_recurrence_chunked_ref(xg, w_h))
    assert torch.equal(K.lstm_bwd_chunked(w_h, cs, gs, dy),
                       K.lstm_recurrence_chunked_bwd_ref(w_h, cs, gs, dy))
    assert before == [getattr(K, n) for n in COUNTERS]


@pytest.mark.parametrize("bad", ["xg_shape", "w_shape", "dtype", "stash",
                                 "empty"])
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
    elif bad == "empty":
        xg = xg[:, :0]
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
# ragged shapes, then K5's main paths cut in time: the one-direction
# listener (B=16 and B=8 at H=1280) and the 4x LSTM-1024 LM (B=128)
CARD_SHAPES = [(37, 3, 200), (5, 2, 16), (48, 130, 256), (60, 16, 1280),
               (40, 8, 1280), (24, 128, 1024)]
# each form's planted faults at a shape of its own batch
FAULT_SHAPES = {"narrow": (96, 16, 512), "wide": (48, 128, 1024),
                "chunked": (96, 16, 512)}


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
    """(ys errors, dxg errors relative to the range) of kernel vs plain;
    ``form`` is one of K5f's, launched whatever the rule would pick, with
    K5b after it, or "chunked" (K6)."""
    rw = w_h if ref_w_h is None else ref_w_h
    if form in K.FORMS:
        ys, cs, gs = K._launch_fwd(xg, w_h, reverse, True, form)
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


LAUNCH_NAMES = {
    "narrow": ("FWD_LAUNCHES", "FWD_NARROW_LAUNCHES", "BWD_LAUNCHES"),
    "wide": ("FWD_LAUNCHES", "FWD_WIDE_LAUNCHES", "BWD_LAUNCHES"),
    "chunked": ("FWD_CHUNKED_LAUNCHES", "BWD_CHUNKED_LAUNCHES")}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form,reverse", [("narrow", False), ("narrow", True),
                                          ("wide", False), ("wide", True),
                                          ("chunked", False)])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_plain_on_card(cuda, shape, form, reverse, dt):
    """Each form of K5f, forced whatever the rule would pick, with K5b, and
    K6 against the plain versions; every launch is counted under its
    kernel and, for K5f, its form."""
    xg, w_h, dy = _card_inputs(cuda, shape, dt)
    names = LAUNCH_NAMES[form]
    before = {n: getattr(K, n) for n in COUNTERS}
    (f_full, f_early), (b_rel, b_early) = _card_pair(form, xg, w_h, dy,
                                                     reverse)
    assert {n: getattr(K, n) - before[n] for n in COUNTERS} == {
        n: int(n in names) for n in COUNTERS}
    assert f_full <= CUDA_ATOL[dt] and f_early <= EARLY_MEAN_TOL
    assert b_rel <= BWD_REL and b_early <= EARLY_MEAN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(20, 16, 1280), (20, 17, 1024)])
def test_rule_picks_the_form_on_card(cuda, shape):
    """The entry points take the rule's form of K5f: narrow at 16 rows, wide
    at 17."""
    xg, w_h, dy = _card_inputs(cuda, shape, "bf16")
    want = "narrow" if shape[1] <= 16 else "wide"
    assert K.form_for(shape[2], shape[1], cuda) == want
    before = {n: getattr(K, n) for n in COUNTERS}
    _, cs, gs = K.lstm_fwd(xg, w_h, stash=True)
    K.lstm_bwd(w_h, cs, gs, dy)
    torch.cuda.synchronize()
    assert {n: getattr(K, n) - before[n] for n in COUNTERS} == {
        n: int(n in LAUNCH_NAMES[want]) for n in COUNTERS}
    with pytest.raises(ValueError, match="does not fit K5"):
        K.lstm_fwd(torch.zeros(2, 2, 4 * 2048, device=cuda),
                   torch.zeros(2048, 4 * 2048, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["narrow", "wide", "chunked"])
@pytest.mark.parametrize("fault", ["w_h_x2", "f32_operand"])
def test_kernels_vs_plain_fail_under_planted_fault(cuda, monkeypatch, form,
                                                   fault):
    xg, w_h, dy = _card_inputs(cuda, FAULT_SHAPES[form], "bf16")
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


# ------------------------------------------- the chunked forward's layout
# (runs without a card: the packing, the padding and the resident share are
# plain Python; exact comparisons unless stated)

def _unpack_chunked(wp, hidden):
    """``K.pack_chunked`` undone: (Hp/U, Hp/64, 4U, 64) -> bf16 (H, 4H)."""
    n_tiles, n_atoms, cols, _ = wp.shape
    hp, units = n_atoms * 64, cols // 4
    idx = K._swizzle_index(cols, wp.device)  # the swizzle is its own inverse
    rows = torch.arange(cols)[:, None]
    w = wp.reshape(n_tiles, n_atoms, cols, 8, 8)[:, :, rows, idx]
    w = (w.reshape(n_tiles, n_atoms, 4, units, 64).permute(1, 4, 2, 0, 3)
         .reshape(hp, 4, hp))
    return w[:hidden, :, :hidden].reshape(hidden, 4 * hidden)


# the chunked forward's tile widths: K6f's 16 units and K5f's wide form's
FWD_UNITS = sorted({K._CHUNKED_UNITS, K._WIDE_FWD_UNITS})
BWD_UNITS = sorted({K._BWD_CHUNKED_UNITS, K._WIDE_BWD_UNITS})


@pytest.mark.parametrize("units", FWD_UNITS)
@pytest.mark.parametrize("hidden", [16, 200, 256])
def test_chunked_packing_is_a_permutation_the_unpacking_undoes(hidden, units):
    """The chunked forward's operand (K6f's, and K5f's wide form's in its
    own tile width) is w_h in bf16, padded with zeros, its values moved but
    none changed: unpacking gives bf16(w_h) back exactly, the padding is
    zero, and the swizzle puts chunk c of column row n at c ^ n % 8."""
    rng = np.random.default_rng(hidden)
    w_h = torch.from_numpy(rng.standard_normal((hidden, 4 * hidden))
                           .astype(np.float32))
    hp, _, _ = K.chunked_plan(hidden, units=units)
    assert hp % 128 == 0 and hp >= hidden
    wp = K.pack_chunked(w_h, hp, units)
    assert wp.is_contiguous() and wp.dtype == torch.bfloat16
    assert tuple(wp.shape) == (hp // units, hp // 64, 4 * units, 64)
    assert torch.equal(_unpack_chunked(wp, hidden), w_h.to(torch.bfloat16))
    values = wp.flatten().float().sort().values
    assert torch.equal(values[values != 0],
                       w_h.to(torch.bfloat16).flatten().float().sort().values)
    padded = K._pad_w(w_h, hidden, hp)
    n_tiles = hp // units
    for tile, atom, g, j, k in [(0, 0, 0, 0, 0),
                                (n_tiles - 1, hp // 64 - 1, 3, units - 1, 63),
                                (1 % n_tiles, 0, 2, 5, 37)]:
        n = g * units + j
        pos = ((k // 8) ^ (n % 8)) * 8 + k % 8
        assert wp[tile, atom, n, pos] == padded[atom * 64 + k,
                                                g * hp + tile * units + j]


def test_chunked_padding_keeps_the_result():
    """H=200 runs as 256: the plain version on the operands the wrapper
    pads gives the unpadded units' ys within f32 noise (1e-6) and the same
    bf16 gates, and the padded units stay at zero."""
    xg, w_h, _ = (torch.from_numpy(a) for a in _inputs(6, 3, 200, seed=2))
    ys, cs, gs = K.lstm_recurrence_chunked_ref(xg, w_h, stash=True)
    hp, _, _ = K.chunked_plan(200)
    assert hp == 256
    w_back = _unpack_chunked(K.pack_chunked(w_h, hp), hp).float()
    pys, pcs, pgs = K.lstm_recurrence_chunked_ref(
        K._pad_units(xg, 200, hp, 4), w_back, stash=True)
    assert float((K._unpad_units(pys, 200, hp, 1) - ys).abs().max()) <= 1e-6
    assert torch.equal(K._unpad_units(pgs, 200, hp, 4), gs)
    assert float(pys[..., 200:].abs().max()) == 0.0
    assert float(pcs[..., 200:].float().abs().max()) == 0.0


@pytest.mark.parametrize("hidden", list(range(1344, 4097, 64)))
def test_chunked_resident_share_fits_the_shared_memory(hidden):
    """From an H100's numbers: whatever H the chunked forward gets, its
    block stays within the opt-in shared memory, keeps at least one k-tile
    resident and wastes less than one tile's room."""
    hp, tiles_per_block, resident = K.chunked_plan(hidden)
    n_kt = hp // 128
    assert tiles_per_block * K.H100_SMS >= hp // 16
    assert 1 <= resident <= n_kt
    smem = K.chunked_smem_bytes(hidden)
    assert smem <= K.H100_SMEM_OPTIN
    if resident < n_kt:
        assert smem + tiles_per_block * K.w_tile_bytes(16) > K.H100_SMEM_OPTIN
    assert K.chunked_resident_share(hidden) == resident / n_kt


def test_chunked_resident_share_at_the_flagship_lm():
    """H=2048 on an H100: 128 tiles, one a block, 6 of its 16 k-tiles (96 of
    256 KB of the slab) resident: some of w_h, not all."""
    assert K.chunked_plan(2048) == (2048, 1, 6)
    assert 0.0 < K.chunked_resident_share(2048) < 1.0
    assert K.chunked_smem_bytes(2048) == 231424


def test_chunked_plan_follows_the_card(monkeypatch):
    """The share is computed from the card, not fixed for H=2048: a card
    with half the shared memory keeps fewer k-tiles, one with fewer SMs
    gives a block two tiles and halves each tile's share."""
    monkeypatch.setattr(K, "_card", lambda device=None: (132, 163840))
    assert K.chunked_plan(2048) == (2048, 1, 1)
    monkeypatch.setattr(K, "_card", lambda device=None: (100, 232448))
    assert K.chunked_plan(2048) == (2048, 2, 3)
    monkeypatch.setattr(K, "_card", lambda device=None: (132, 100000))
    with pytest.raises(ValueError):
        K.chunked_plan(2048)


# K6f on the card at the shapes its row passes and warpgroups distinguish:
# B=128 (both warpgroups full), B=64 (one), B=3 (one, mostly empty rows),
# B=130 (two passes), H=200 (padded to 256, all k-tiles resident) and H=2048
# (10 of 16 streamed).
K6F_SHAPES = [(24, 128, 2048), (24, 64, 2048), (37, 3, 200), (20, 130, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("stash", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", K6F_SHAPES)
def test_chunked_forward_matches_plain_on_card(cuda, shape, dt, stash):
    xg, w_h, _ = _card_inputs(cuda, shape, dt)
    before = K.FWD_CHUNKED_LAUNCHES
    out = K.lstm_fwd_chunked(xg, w_h, stash=stash)
    torch.cuda.synchronize()
    assert K.FWD_CHUNKED_LAUNCHES == before + 1
    ref = K.lstm_recurrence_chunked_ref(xg, w_h, stash=stash)
    if not stash:
        out, ref = (out,), (ref,)
    assert out[0].dtype == DTYPES[dt][1]
    full, early = _errors(out[0], ref[0], False)
    assert full <= CUDA_ATOL[dt] and early <= EARLY_MEAN_TOL, (full, early)
    for o, r in zip(out[1:], ref[1:]):
        bound = CUDA_ATOL[dt] + r.float().abs() * 2.0 ** -7
        assert ((o.float() - r.float()).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["w_h_x2", "f32_operand"])
@pytest.mark.parametrize("shape", [(24, 128, 2048), (37, 3, 200)])
def test_chunked_forward_vs_plain_fails_under_planted_fault(cuda, monkeypatch,
                                                            shape, fault):
    xg, w_h, _ = _card_inputs(cuda, shape, "f32")
    ys = K.lstm_fwd_chunked(xg, w_h)
    if fault == "w_h_x2":
        w_h = 2 * w_h
    else:
        monkeypatch.setattr(K, "_h_operand", lambda h: h)
    full, early = _errors(ys, K.lstm_recurrence_chunked_ref(xg, w_h), False)
    assert full > CUDA_ATOL["f32"] or early > EARLY_MEAN_TOL, (full, early)


@pytest.mark.cuda
@pytest.mark.parametrize("units", FWD_UNITS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [16, 200, 2048])
def test_pack_kernel_equals_the_plain_packing(cuda, dtype, hidden, units):
    """The wrapper packs w_h with a small kernel of its own; the indexing in
    ``pack_chunked`` is its plain version: equal bit for bit."""
    rng = np.random.default_rng(hidden)
    w_h = torch.from_numpy(rng.standard_normal((hidden, 4 * hidden))
                           .astype(np.float32)).to(cuda, dtype)
    hp, _, _ = K.chunked_plan(hidden, cuda, units)
    assert torch.equal(K.pack_chunked_on_card(w_h, hp, units),
                       K.pack_chunked(w_h, hp, units))


# ------------------------------------------- the chunked backward's layout
# (runs without a card; exact comparisons unless stated). K6b reads w_h's
# rows packed in swizzled 64-value atoms and writes bf16(dgates) into its
# exchange buffer in the same swizzle: both are held against plain
# reconstructions here and, on the card, against what the kernel leaves.

def _unswizzle_atoms(x):
    """``K._swizzle_atoms`` undone (the swizzle is its own inverse)."""
    return K._swizzle_atoms(x)


@pytest.mark.parametrize("units", BWD_UNITS)
@pytest.mark.parametrize("hidden", [16, 200, 256])
def test_chunked_bwd_packing_is_a_permutation_the_unpacking_undoes(hidden,
                                                                   units):
    """The chunked backward's operand (K6b's, and K5b's wide form's in its
    own tile width) is w_h in bf16, padded with zeros, its rows cut into
    atoms of 64 values and each atom's 16-byte chunks swizzled by the row:
    unpacking gives bf16(w_h) back exactly, and chunk c of row j of a tile
    sits at c ^ j % 8."""
    rng = np.random.default_rng(hidden)
    w_h = torch.from_numpy(rng.standard_normal((hidden, 4 * hidden))
                           .astype(np.float32))
    hp = K._padded(hidden)
    wp = K.pack_chunked_bwd(w_h, hp, units)
    assert wp.is_contiguous() and wp.dtype == torch.bfloat16
    assert tuple(wp.shape) == (hp // units, 4 * hp // 64, units, 64)
    back = (_unswizzle_atoms(wp).permute(0, 2, 1, 3).reshape(hp, 4 * hp))
    assert torch.equal(back, K._pad_w(w_h, hidden, hp))
    padded = K._pad_w(w_h, hidden, hp)
    for tile, atom, j, k in [(0, 0, 0, 0),
                             (hp // units - 1, 4 * hp // 64 - 1, units - 1,
                              63), (0, 1, 13, 42)]:
        pos = ((k // 8) ^ (j % 8)) * 8 + k % 8
        assert wp[tile, atom, j, pos] == padded[tile * units + j,
                                                atom * 64 + k]


@pytest.mark.parametrize("batch", [3, 64, 130])
def test_exchange_layout_puts_each_value_where_the_kernel_writes_it(batch):
    """bf16(dgates) of row b, column k sits in the exchange buffer at row
    block b // 64, atom k // 64, row b % 64, chunk position (k % 64 // 8) ^
    (b % 64 % 8): the offset csrc/lstm_bwd.cu computes; rows beyond the
    batch are zero."""
    hp = 96
    rng = np.random.default_rng(batch)
    dg = torch.from_numpy(rng.standard_normal((batch, 4 * hp))
                          .astype(np.float32))
    buf = K.exchange_layout(dg, hp)
    n_rb, n_atoms = -(-batch // 64), 4 * hp // 64
    assert tuple(buf.shape) == (n_rb, n_atoms, 64, 64)
    flat = buf.flatten()
    for b in range(batch):
        for k in (0, 7, 8, 63, 64, 200, 4 * hp - 1):
            rl = b % 64
            off = (((b // 64) * n_atoms + k // 64) * 64 + rl) * 64 \
                + (((k % 64) // 8) ^ (rl % 8)) * 8 + k % 8
            assert flat[off] == dg[b, k].to(torch.bfloat16)
    back = _unswizzle_atoms(buf).permute(0, 2, 1, 3).reshape(n_rb * 64, -1)
    assert torch.equal(back[:batch], dg.to(torch.bfloat16))
    assert not bool(back[batch:].float().abs().gt(0).any())


def test_chunked_bwd_padding_keeps_the_result():
    """H=200 runs as 224: the plain K6b on the operands the wrapper pads
    (w_h unpacked from its packing) gives the real units' f32 dxg within f32
    noise and exact zeros for the padded units."""
    xg, w_h, dy = (torch.from_numpy(a) for a in _inputs(6, 3, 200, seed=2))
    _, cs, gs = K.lstm_recurrence_chunked_ref(xg, w_h, stash=True)
    ref = K.lstm_recurrence_chunked_bwd_ref(w_h, cs, gs, dy)
    hp = K._padded(200)
    assert hp == 224
    w_back = (_unswizzle_atoms(K.pack_chunked_bwd(w_h, hp))
              .permute(0, 2, 1, 3).reshape(hp, 4 * hp).float())
    out = K.lstm_recurrence_chunked_bwd_ref(
        w_back, K._pad_units(cs, 200, hp, 1), K._pad_units(gs, 200, hp, 4),
        K._pad_units(dy, 200, hp, 1))
    assert float((K._unpad_units(out, 200, hp, 4) - ref).abs().max()) <= \
        1e-6 * float(ref.abs().max())
    assert float(out.reshape(6, 3, 4, hp)[..., 200:].abs().max()) == 0.0


@pytest.mark.parametrize("hidden", list(range(1344, 4097, 64)))
def test_chunked_bwd_resident_share_fits_the_shared_memory(hidden):
    """From an H100's numbers at the LM's batch of 128: whatever H the
    chunked backward gets, its block stays within the opt-in shared memory,
    keeps at least one k-tile of its slab resident and wastes less than one
    tile's room."""
    hp, tiles_per_block, resident = K.chunked_bwd_plan(hidden, 128)
    n_kt = 4 * hp // 128
    assert hp % 32 == 0 and hp - 32 < hidden <= hp
    assert tiles_per_block * K.H100_SMS >= (hp // 32) * 2
    assert 1 <= resident <= n_kt
    smem = K.chunked_bwd_smem_bytes(hidden, 128)
    assert smem <= K.H100_SMEM_OPTIN
    if resident < n_kt:
        assert smem + tiles_per_block * K.bwd_w_tile_bytes(32) > \
            K.H100_SMEM_OPTIN


def test_chunked_bwd_plan_at_the_flagship_lm():
    """H=2048, B=128 on an H100: 64 unit tiles x 2 row blocks = 128 tiles,
    one a block; beside the rings 3 of each slab's 64 k-tiles (24 of 512 KB)
    stay resident, so a block takes in 1 MB of dgates rows and 488 KB of its
    slab a step."""
    assert K.chunked_bwd_plan(2048, 128) == (2048, 1, 3)
    assert K.chunked_bwd_smem_bytes(2048, 128) == 231424
    rows = 64 * 4 * 2048 * 2
    slab = (64 - 3) * K.bwd_w_tile_bytes(32)
    assert rows + slab == 1548288
    # B=64 (the T=320 shape): one row block, 64 tiles; B=3: one
    assert K.chunked_bwd_plan(2048, 64) == (2048, 1, 3)
    assert K.chunked_bwd_plan(200, 3) == (224, 1, 3)


def test_chunked_bwd_plan_follows_the_card(monkeypatch):
    """Computed from the card: less shared memory keeps fewer k-tiles, fewer
    SMs than tiles give a block two tiles and halve each tile's share, a
    card without room for the rings is refused."""
    monkeypatch.setattr(K, "_card", lambda device=None: (132, 215040))
    assert K.chunked_bwd_plan(2048, 128) == (2048, 1, 1)
    monkeypatch.setattr(K, "_card", lambda device=None: (100, 232448))
    assert K.chunked_bwd_plan(2048, 128) == (2048, 2, 1)
    monkeypatch.setattr(K, "_card", lambda device=None: (132, 200000))
    with pytest.raises(ValueError):
        K.chunked_bwd_plan(2048, 128)


# K6b on the card at the shapes its tiles distinguish: B=128 (two row
# blocks), B=64 (one), B=130 (three, the last nearly empty), B=3, H=2048 (61
# of 64 k-tiles streamed), H=200 (padded to 224: 7 k-tiles, 3 resident, an
# odd number, so the second warpgroup takes 3) and H=32 (one k-tile, all
# resident: the second warpgroup takes none).
K6B_SHAPES = [(24, 128, 2048), (24, 64, 2048), (20, 130, 256), (37, 3, 200),
              (9, 5, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", K6B_SHAPES)
def test_chunked_backward_matches_plain_on_card(cuda, shape, dt):
    xg, w_h, dy = _card_inputs(cuda, shape, dt)
    _, cs, gs = K.lstm_fwd_chunked(xg, w_h, stash=True)
    before = K.BWD_CHUNKED_LAUNCHES
    dxg = K.lstm_bwd_chunked(w_h, cs, gs, dy)
    torch.cuda.synchronize()
    assert K.BWD_CHUNKED_LAUNCHES == before + 1
    assert dxg.dtype == torch.float32
    ref = K.lstm_recurrence_chunked_bwd_ref(w_h, cs, gs, dy)
    full, early = _errors(dxg, ref, True)
    assert full <= BWD_REL * ref.abs().max().item(), full
    assert early <= EARLY_MEAN_TOL, early


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["w_h_x2", "f32_operand"])
@pytest.mark.parametrize("shape", [(24, 128, 2048), (37, 3, 200)])
def test_chunked_backward_vs_plain_fails_under_planted_fault(
        cuda, monkeypatch, shape, fault):
    xg, w_h, dy = _card_inputs(cuda, shape, "f32")
    _, cs, gs = K.lstm_fwd_chunked(xg, w_h, stash=True)
    dxg = K.lstm_bwd_chunked(w_h, cs, gs, dy)
    if fault == "w_h_x2":
        w_h = 2 * w_h
    else:
        monkeypatch.setattr(K, "_dg_operand", lambda d: d)
    ref = K.lstm_recurrence_chunked_bwd_ref(w_h, cs, gs, dy)
    full, early = _errors(dxg, ref, True)
    assert full > BWD_REL * ref.abs().max().item() or \
        early > EARLY_MEAN_TOL, (full, early)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7, 128, 2048), (6, 130, 256)])
def test_exchange_buffer_holds_the_last_step_s_operand(cuda, shape):
    """After the walk the exchange buffer written at the last step (data
    index 0) holds bf16(dxg[0]) in the layout ``exchange_layout`` gives,
    bit for bit: the kernel's swizzled stores are the plain layout."""
    t, b, h = shape
    xg, w_h, dy = _card_inputs(cuda, shape, "bf16")
    _, cs, gs = K.lstm_fwd_chunked(xg, w_h, stash=True)
    seen = {}
    real_zeros = torch.zeros

    def keep(*size, **kw):
        out = real_zeros(*size, **kw)
        if len(size) == 5 and kw.get("dtype") == torch.bfloat16:
            seen["xbuf"] = out
        return out
    try:
        torch.zeros = keep
        dxg = K.lstm_bwd_chunked(w_h, cs, gs, dy)
    finally:
        torch.zeros = real_zeros
    torch.cuda.synchronize()
    hp = K._padded(h)
    last = seen["xbuf"][t % 2]  # step T-1 writes buffer (T-1) % 2 ^ 1
    want = K.exchange_layout(K._pad_units(dxg[0], h, hp, 4), hp)
    assert torch.equal(last, want)


@pytest.mark.cuda
@pytest.mark.parametrize("units", BWD_UNITS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [16, 200, 2048])
def test_bwd_pack_kernel_equals_the_plain_packing(cuda, dtype, hidden, units):
    """The chunked backward's wrapper packs w_h with a small kernel of its
    own; the indexing in ``pack_chunked_bwd`` is its plain version: equal
    bit for bit."""
    rng = np.random.default_rng(hidden)
    w_h = torch.from_numpy(rng.standard_normal((hidden, 4 * hidden))
                           .astype(np.float32)).to(cuda, dtype)
    hp = K._padded(hidden)
    assert torch.equal(K.pack_chunked_bwd_on_card(w_h, hp, units),
                       K.pack_chunked_bwd(w_h, hp, units))
