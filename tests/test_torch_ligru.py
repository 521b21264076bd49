"""Port of the light-GRU recurrence (K8f/K8b) against the JAX package's
Pallas kernels run in interpret mode, and the CUDA kernels against their
plain PyTorch versions (those skip without a card).

Tolerances. The candidates are relu outputs, so |h| is not bounded by 1 as
an LSTM's or a GRU's is (here it reaches 5-10): every bound is relative to
the reference's range, max |ys| or max |dxg|. The plain versions take the
same bf16 products as the kernels, exact in f32, so with an f32 stream ys and
the gradients agree to 1e-5 of their range (only the order of the f32 sums
differs, and a relu whose argument sits at zero may open on one side only).
With a bf16 stream ys and dxg are rounded to bf16 and a flipped rounding
feeds back: one bf16 ulp of the range, 2^-7 * max. The stash is bf16 in
both: one bf16 ulp of its value.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.ops.pallas import ligru as PG
from e2e_asr_pytorch_tpu_torch.ops.kernels import gru as KG
from e2e_asr_pytorch_tpu_torch.ops.kernels import ligru as K

REL = {"f32": 1e-5, "bf16": 2.0 ** -7}
STASH_REL = 2.0 ** -7
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(11, 3, 8), (9, 2, 40)]          # (T, B, H)


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode."""
    monkeypatch.setattr(PG, "INTERPRET", True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    return torch.device("cuda")


def _inputs(t, b, h, seed, keep=0.7):
    """Gate inputs, weights, a non-trivial (B,H) dropout mask scaled by
    1/keep, and output cotangents."""
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((t, b, 2 * h)).astype(np.float32)
    w_h = (rng.standard_normal((h, 2 * h)) / np.sqrt(h)).astype(np.float32)
    mask = ((rng.uniform(size=(b, h)) < keep) / keep).astype(np.float32)
    dy = rng.standard_normal((t, b, h)).astype(np.float32)
    return xg, w_h, mask, dy


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _rel(j, t):
    return float(np.max(np.abs(j - t)) / np.max(np.abs(j)))


def _both(shape, dt, reverse=False, wh_scale=1.0, ones_mask=False):
    """ys, dxg, dW_h of the JAX kernel pair (interpret mode) under jax.vjp
    and of the port's autograd Function on CPU tensors (its plain
    versions)."""
    jd, td = DTYPES[dt]
    xg, w_h, mask, dy = _inputs(*shape, seed=sum(shape))
    tmask = np.ones_like(mask) if ones_mask else mask
    jys, vjp = jax.vjp(
        lambda a, w: PG.ligru_recurrence(a, w, jnp.asarray(mask),
                                         reverse=reverse),
        jnp.asarray(xg, jd), jnp.asarray(w_h))
    jgrads = vjp(jnp.asarray(dy, jd))
    txg = torch.from_numpy(xg).to(td).requires_grad_()
    twh = torch.from_numpy(w_h * wh_scale).requires_grad_()
    tys = K.ligru_recurrence(txg, twh, torch.from_numpy(tmask),
                             reverse=reverse)
    tgrads = torch.autograd.grad(tys, (txg, twh),
                                 torch.from_numpy(dy).to(td))
    assert tys.dtype == td and tgrads[0].dtype == td
    assert tgrads[1].dtype == torch.float32
    return [(_f32(j), _f32(t)) for j, t in zip((jys, *jgrads),
                                               (tys, *tgrads))]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernel(interpret, shape, reverse, dt):
    for j, t in _both(shape, dt, reverse):       # ys, dxg, dW_h
        assert _rel(j, t) <= REL[dt]


def test_plain_vs_jax_fails_under_doubled_w_h(interpret):
    for j, t in _both(SHAPES[0], "f32", wh_scale=2.0):
        assert _rel(j, t) > 10 * REL["bf16"]


def test_plain_vs_jax_fails_without_the_mask(interpret):
    """The mask scales the candidates in the forward and gates their
    cotangent in the backward: a port that drops it must not pass."""
    for j, t in _both(SHAPES[1], "f32", ones_mask=True):
        assert _rel(j, t) > 10 * REL["bf16"]


def _stash_and_bwd(shape, dt, reverse):
    """The forward's stash and the backward's two results on both sides,
    from the JAX package's own ``_fwd`` / ``_bwd``."""
    jd, td = DTYPES[dt]
    xg, w_h, mask, dy = _inputs(*shape, seed=sum(shape) + 1)
    jxg, jwh, jm = jnp.asarray(xg, jd), jnp.asarray(w_h), jnp.asarray(mask)
    jys, jhgs = PG._fwd(jxg, jwh, jm, reverse)
    jdxg, jdwh = PG._bwd(jxg, jwh, jm, jhgs, jys.astype(jnp.bfloat16),
                         jnp.asarray(dy, jd), reverse)
    txg, twh, tm = (torch.from_numpy(xg).to(td), torch.from_numpy(w_h),
                    torch.from_numpy(mask))
    tys, thgs = K.ligru_fwd(txg, twh, tm, reverse, stash=True)
    ys16 = tys.to(torch.bfloat16)
    tdxg = K.ligru_bwd(txg, twh, tm, thgs, ys16,
                       torch.from_numpy(dy).to(td), reverse)
    assert thgs.dtype == torch.bfloat16 and tdxg.dtype == td
    tdwh = KG.dwh(ys16, tdxg.to(torch.bfloat16), reverse)
    return {"hgs": (_f32(jhgs), _f32(thgs)), "dxg": (_f32(jdxg), _f32(tdxg)),
            "dwh": (_f32(jdwh), _f32(tdwh)), "mask": mask}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_stash_and_backward_match_jax_kernel(interpret, reverse, dt):
    res = _stash_and_bwd((9, 2, 40), dt, reverse)
    jh, th = res["hgs"]
    assert bool(np.all(np.abs(jh - th) <= 1e-6 + STASH_REL * np.abs(jh)))
    for key in ("dxg", "dwh"):
        assert _rel(*res[key]) <= REL[dt], key
    # a dropped unit's candidate gets no cotangent at any step
    dropped = res["mask"] == 0
    assert dropped.any()
    assert float(np.abs(res["dxg"][1][:, :, 40:][:, dropped]).max()) == 0.0


def test_backward_operand_is_rounded_from_the_f32_dxg(monkeypatch):
    """The carry's product takes bf16 of the f32 dxg, not of the emitted
    bf16 one (the same value here) and not the f32 one: with an f32 operand
    the early steps of the walk come out different."""
    xg, w_h, mask, dy = (torch.from_numpy(a) for a in _inputs(7, 2, 16, 3))
    ys, hgs = K.ligru_recurrence_ref(xg, w_h, mask, stash=True)
    ys16 = ys.to(torch.bfloat16)
    sound = K.ligru_recurrence_bwd_ref(xg, w_h, mask, hgs, ys16, dy)
    assert torch.equal(sound, K.ligru_bwd(xg, w_h, mask, hgs, ys16, dy))
    monkeypatch.setattr(K, "_dg_operand", lambda d: d)
    loose = K.ligru_recurrence_bwd_ref(xg, w_h, mask, hgs, ys16, dy)
    assert torch.equal(sound[-1], loose[-1])      # the walk's first step
    assert float((sound[:-1] - loose[:-1]).abs().max()) > 1e-4


def test_padding_keeps_the_result():
    """The wrappers pad H to a multiple of 16 with zero units (zero inputs,
    zero weights, mask 0), which stay at h = 0."""
    xg, w_h, mask, dy = (torch.from_numpy(a) for a in _inputs(5, 2, 20, 1))
    ys, hgs = K.ligru_recurrence_ref(xg, w_h, mask, stash=True)
    hp = KG._padded(20)
    pxg = KG._pad_units(xg, 20, hp, 2)
    pwh = KG.pad_w(w_h, 20, hp, 2).float()
    pmask = KG._pad_units(mask, 20, hp, 1)
    pys, phgs = K.ligru_recurrence_ref(pxg, pwh, pmask, stash=True)
    assert float((KG._unpad_units(pys, 20, hp, 1) - ys).abs().max()) <= 1e-6
    assert float(pys[..., 20:].abs().max()) == 0.0
    dxg = K.ligru_recurrence_bwd_ref(xg, w_h, mask, hgs, ys, dy)
    pdxg = K.ligru_recurrence_bwd_ref(pxg, pwh, pmask, phgs, pys,
                                      KG._pad_units(dy, 20, hp, 1))
    err = (KG._unpad_units(pdxg, 20, hp, 2) - dxg).abs().max()
    assert float(err) <= REL["bf16"] * float(dxg.abs().max())
    wp = KG.pack_w(w_h, 20, hp, 2)
    assert tuple(wp.shape) == (2, 32, 32)
    assert torch.equal(wp[1, 16 + 3, :20],
                       w_h[:, 20 + 16 + 3].to(torch.bfloat16))


def test_cpu_tensors_take_the_plain_versions():
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES, K.FWD_PACKED_LAUNCHES,
              K.FWD_SINGLE_LAUNCHES)
    xg, w_h, mask, dy = (torch.from_numpy(a) for a in _inputs(5, 2, 8, 0))
    ys, hgs = K.ligru_fwd(xg, w_h, mask, reverse=True, stash=True)
    ref = K.ligru_recurrence_ref(xg, w_h, mask, reverse=True, stash=True)
    assert torch.equal(ys, ref[0]) and torch.equal(hgs, ref[1])
    assert torch.equal(K.ligru_fwd(xg, w_h, mask, reverse=True), ys)
    out = K.ligru_bwd(xg, w_h, mask, hgs, ys.to(torch.bfloat16), dy,
                      reverse=True)
    assert torch.equal(out, K.ligru_recurrence_bwd_ref(
        xg, w_h, mask, hgs, ys, dy, True))
    assert before == (K.FWD_LAUNCHES, K.BWD_LAUNCHES, K.FWD_PACKED_LAUNCHES,
                      K.FWD_SINGLE_LAUNCHES)


@pytest.mark.parametrize("bad", ["xg_shape", "w_shape", "mask_shape", "dtype",
                                 "stash", "dy_dtype"])
def test_wrappers_refuse_bad_operands(bad):
    xg, w_h, mask, dy = (torch.from_numpy(a) for a in _inputs(5, 2, 8, 0))
    if bad in ("stash", "dy_dtype"):
        ys, hgs = K.ligru_fwd(xg, w_h, mask, stash=True)
        ys = ys.to(torch.bfloat16)
        with pytest.raises((ValueError, TypeError)):
            if bad == "stash":
                K.ligru_bwd(xg, w_h, mask, hgs.float(), ys, dy)
            else:
                K.ligru_bwd(xg, w_h, mask, hgs, ys, dy.to(torch.bfloat16))
        return
    if bad == "xg_shape":
        xg = xg[..., :15]
    elif bad == "w_shape":
        w_h = w_h[:4]
    elif bad == "mask_shape":
        mask = mask[:, :4]
    else:
        xg = xg.double()
    with pytest.raises((ValueError, TypeError)):
        K.ligru_recurrence(xg, w_h, mask)


# ------------------------------------------------ both directions at once
def _both_pair(shape, dt, swap=False, wh_scale=1.0, ones_mask=False):
    """ys, dxg and dW_h of both directions, one mask for the two: two JAX
    kernel calls (interpret mode; the second reversed) under jax.vjp, and
    the port's ``biligru_recurrence`` (its autograd Function) on CPU
    tensors. Planted faults: ``swap`` hands the port the two directions'
    operands the wrong way round, ``wh_scale`` scales its w_h, ``ones_mask``
    drops its mask."""
    jd, td = DTYPES[dt]
    fw = _inputs(*shape, seed=sum(shape))
    bw = _inputs(*shape, seed=sum(shape) + 100)
    mask = fw[2]
    jys, vjp = jax.vjp(
        lambda af, ab, wf, wb: (
            PG.ligru_recurrence(af, wf, jnp.asarray(mask)),
            PG.ligru_recurrence(ab, wb, jnp.asarray(mask), reverse=True)),
        *(jnp.asarray(a[0], jd) for a in (fw, bw)),
        *(jnp.asarray(a[1]) for a in (fw, bw)))
    jgrads = vjp(tuple(jnp.asarray(a[3], jd) for a in (fw, bw)))
    leaves = ([torch.from_numpy(a[0]).to(td) for a in (fw, bw)]
              + [torch.from_numpy(a[1] * wh_scale) for a in (fw, bw)])
    leaves = [x.requires_grad_() for x in leaves]
    order = [1, 0, 3, 2] if swap else range(4)
    tmask = torch.from_numpy(np.ones_like(mask) if ones_mask else mask)
    tys = K.biligru_recurrence(*(leaves[i] for i in order), tmask)
    tgrads = torch.autograd.grad(tys, leaves, tuple(
        torch.from_numpy(a[3]).to(td) for a in (fw, bw)))
    assert all(y.dtype == td for y in tys)
    assert tgrads[0].dtype == tgrads[1].dtype == td
    return [(_f32(j), _f32(t)) for j, t in zip((*jys, *jgrads),
                                               (*tys, *tgrads))]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bidirectional_matches_jax_kernel(interpret, shape, dt):
    for j, t in _both_pair(shape, dt):   # ys, dxg, dW_h of both directions
        assert _rel(j, t) <= REL[dt]


@pytest.mark.parametrize("fault", ["swap", "w_h_x2", "no_mask"])
def test_bidirectional_vs_jax_fails_under_planted_fault(interpret, fault):
    for j, t in _both_pair(SHAPES[1], "f32", swap=fault == "swap",
                           wh_scale=2.0 if fault == "w_h_x2" else 1.0,
                           ones_mask=fault == "no_mask"):
        assert _rel(j, t) > 10 * REL["bf16"]


def test_bidirectional_entry_is_the_two_plain_walks_on_cpu():
    """On CPU tensors the bidirectional forward is the plain version once
    per direction, the second reversed, one mask for both, and counts no
    launch."""
    before = (K.FWD_LAUNCHES, K.FWD_PACKED_LAUNCHES, K.FWD_SINGLE_LAUNCHES,
              K.BWD_LAUNCHES)
    fw = [torch.from_numpy(a) for a in _inputs(6, 2, 24, 4)]
    bw = [torch.from_numpy(a) for a in _inputs(6, 2, 24, 5)]
    out = K.ligru_fwd_pair(fw[0], bw[0], fw[1], bw[1], fw[2], stash=True)
    f = K.ligru_recurrence_ref(fw[0], fw[1], fw[2], False, stash=True)
    b = K.ligru_recurrence_ref(bw[0], bw[1], fw[2], True, stash=True)
    assert all(torch.equal(x, y) for x, y in zip(out, (f[0], b[0], f[1],
                                                       b[1])))
    ys = K.ligru_fwd_pair(fw[0], bw[0], fw[1], bw[1], fw[2])
    assert torch.equal(ys[0], f[0]) and torch.equal(ys[1], b[0])
    assert before == (K.FWD_LAUNCHES, K.FWD_PACKED_LAUNCHES,
                      K.FWD_SINGLE_LAUNCHES, K.BWD_LAUNCHES)


def _bwd_pair_both(shape, dt, swap=False, wh_scale=1.0):
    """dxg and dW_h of both directions, one mask for the two: jax.vjp of
    two JAX kernel calls (interpret mode; the second reversed), and the
    port's ``ligru_bwd_pair`` on CPU tensors from its own forward's
    stashes, dW_h formed as ``BiLiGRURecurrence`` forms it. Planted faults:
    ``swap`` hands the backward the two directions' operands the wrong way
    round, ``wh_scale`` scales its w_h."""
    jd, td = DTYPES[dt]
    fw = _inputs(*shape, seed=sum(shape) + 7)
    bw = _inputs(*shape, seed=sum(shape) + 107)
    mask = fw[2]
    _, vjp = jax.vjp(
        lambda af, ab, wf, wb: (
            PG.ligru_recurrence(af, wf, jnp.asarray(mask)),
            PG.ligru_recurrence(ab, wb, jnp.asarray(mask), reverse=True)),
        *(jnp.asarray(a[0], jd) for a in (fw, bw)),
        *(jnp.asarray(a[1]) for a in (fw, bw)))
    jgrads = vjp(tuple(jnp.asarray(a[3], jd) for a in (fw, bw)))
    xs = [torch.from_numpy(a[0]).to(td) for a in (fw, bw)]
    ws = [torch.from_numpy(a[1]) for a in (fw, bw)]
    dys = [torch.from_numpy(a[3]).to(td) for a in (fw, bw)]
    tmask = torch.from_numpy(mask)
    ys_f, ys_b, hgs_f, hgs_b = K.ligru_fwd_pair(*xs, *ws, tmask, stash=True)
    ys = [ys_f.to(torch.bfloat16), ys_b.to(torch.bfloat16)]
    hgs = [hgs_f, hgs_b]
    o = [1, 0] if swap else [0, 1]
    dx_f, dx_b = K.ligru_bwd_pair(
        *(xs[i] for i in o), *(wh_scale * ws[i] for i in o), tmask,
        *(hgs[i] for i in o), *(ys[i] for i in o), *(dys[i] for i in o))
    assert dx_f.dtype == dx_b.dtype == td
    tgrads = [dx_f, dx_b] + [KG.dwh(y, d.to(torch.bfloat16), rev)
                             for y, d, rev in ((ys[0], dx_f, False),
                                               (ys[1], dx_b, True))]
    return [(_f32(j), _f32(t)) for j, t in zip(jgrads, tgrads)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_pair_matches_jax_kernel(interpret, shape, dt):
    for j, t in _bwd_pair_both(shape, dt):  # dxg and dW_h, f then b
        assert _rel(j, t) <= REL[dt]


@pytest.mark.parametrize("fault", ["swap", "w_h_x2"])
def test_backward_pair_vs_jax_fails_under_planted_fault(interpret, fault):
    for j, t in _bwd_pair_both(SHAPES[1], "f32", swap=fault == "swap",
                               wh_scale=2.0 if fault == "w_h_x2" else 1.0):
        assert _rel(j, t) > 10 * REL["bf16"]


def test_backward_pair_is_the_two_plain_walks_on_cpu():
    """On CPU tensors the bidirectional backward is the plain version once
    per direction, the second reversed, one mask for both, and counts no
    launch."""
    names = ("BWD_LAUNCHES", "BWD_PACKED_LAUNCHES", "BWD_SINGLE_LAUNCHES",
             "FWD_LAUNCHES")
    before = [getattr(K, n) for n in names]
    fw = [torch.from_numpy(a) for a in _inputs(6, 2, 24, 14)]
    bw = [torch.from_numpy(a) for a in _inputs(6, 2, 24, 15)]
    ys_f, ys_b, hgs_f, hgs_b = K.ligru_fwd_pair(fw[0], bw[0], fw[1], bw[1],
                                                fw[2], stash=True)
    ys_f, ys_b = ys_f.to(torch.bfloat16), ys_b.to(torch.bfloat16)
    out = K.ligru_bwd_pair(fw[0], bw[0], fw[1], bw[1], fw[2], hgs_f, hgs_b,
                           ys_f, ys_b, fw[3], bw[3])
    f = K.ligru_recurrence_bwd_ref(fw[0], fw[1], fw[2], hgs_f, ys_f, fw[3],
                                   False)
    b = K.ligru_recurrence_bwd_ref(bw[0], bw[1], fw[2], hgs_b, ys_b, bw[3],
                                   True)
    assert torch.equal(out[0], f) and torch.equal(out[1], b)
    assert before == [getattr(K, n) for n in names]
    with pytest.raises(ValueError):
        K.ligru_bwd_pair(fw[0], bw[0], fw[1], bw[1], fw[2][:1], hgs_f, hgs_b,
                         ys_f, ys_b, fw[3], bw[3])


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_spread_from_two_k_halves(interpret, reverse):
    """The plain forward with its recurrent product summed in two k halves
    (the card's f32 bound is read from its distance to the one-product
    walk) takes the same products in another f32 order: it still matches
    the JAX kernel, and differs from the one-product walk by f32 rounding
    only."""
    xg, w_h, mask, _ = (torch.from_numpy(a) for a in _inputs(11, 3, 40, 21))
    one = K.ligru_recurrence_ref(xg, w_h, mask, reverse)
    halves = K.ligru_recurrence_ref(xg, w_h, mask, reverse, k_halves=True)
    jys = PG.ligru_recurrence(jnp.asarray(xg.numpy()),
                              jnp.asarray(w_h.numpy()),
                              jnp.asarray(mask.numpy()), reverse=reverse)
    assert _rel(_f32(jys), _f32(halves)) <= REL["f32"]
    spread = float((halves - one).abs().max() / one.abs().max())
    assert 0.0 < spread <= REL["f32"]
    with_stash = K.ligru_recurrence_ref(xg, w_h, mask, reverse, stash=True,
                                        k_halves=True)
    assert torch.equal(with_stash[0], halves)


# ---------------------------------------------------------------- on a card
# Relative to the reference's range (|h| reaches 10 here): ys 2e-3 of max
# |ys| for f32 streams and 1.6e-2 for bf16 ones (a flipped rounding of
# bf16(h) feeds back), dxg one bf16 ulp at the top of its range, 2^-6 * max.
# Before the first flips kernel and plain version agree to f32 noise, so the
# mean |err| over the first EARLY_STEPS steps of each walk, over the range,
# holds the bf16-operand contract on f32 streams: 3e-6 (sound 1e-9 to 1.5e-6,
# an f32 operand far more), and the planted faults are held there. With a
# bf16 stream the outputs themselves are rounded and one flipped rounding
# among the few thousand cells of the small shapes moves the early mean by
# some 1e-6: 2e-5. On f32 streams the whole-sequence bound of ys is
# max(CUDA_REL, 2 x the plain version's own spread on the same operands):
# summed in two k halves in place of one product, the plain version moves
# 1.8e-3 to 2.4e-3 of its range against itself at T >= 200 and H=1280 (|h|
# near 10, every flipped bf16 rounding of h fed back), the width of 2e-3.
CUDA_REL = {"f32": 2e-3, "bf16": 1.6e-2}
BWD_REL = 2.0 ** -6
EARLY_STEPS = 4
EARLY_MEAN_REL = {"f32": 3e-6, "bf16": 2e-5}
CARD_SHAPES = [(37, 3, 200), (5, 2, 16), (48, 18, 256)]
FAULT_SHAPE = (96, 16, 512)


def _card_inputs(cuda, shape, dt, seed=None):
    xg, w_h, mask, dy = (torch.from_numpy(a).to(cuda) for a in _inputs(
        *shape, seed=sum(shape) if seed is None else seed))
    return xg.to(DTYPES[dt][1]), w_h, mask, dy.to(DTYPES[dt][1])


def _errors(out, ref, first_steps_at_end):
    """(max |err|, mean |err| over the walk's first steps), both over the
    reference's range."""
    t = out.shape[0]
    k = min(EARLY_STEPS, t)
    d = (out.float() - ref.float()).abs()
    early = d[t - k:] if first_steps_at_end else d[:k]
    mag = max(ref.float().abs().max().item(), 1.0)
    return d.max().item() / mag, early.mean().item() / mag


def _card_pair(xg, w_h, mask, dy, reverse, ref_w_h=None, ref_mask=None):
    ys, hgs = K.ligru_fwd(xg, w_h, mask, reverse, stash=True)
    return _held(xg, w_h, mask, dy, reverse, ys, hgs, ref_w_h, ref_mask)


_SOUND_H_OPERAND = K._h_operand  # before any test plants a fault in it


def _ys_bound(xg, w_h, mask, reverse):
    """The whole-sequence bound of ys: CUDA_REL, on f32 streams at least 2 x
    the sound plain version's own spread on the kernel's operands (its walk
    summed in two k halves against its one-product walk), whatever fault a
    test plants in the plain version it holds the kernel against."""
    if xg.dtype != torch.float32:
        return CUDA_REL["bf16"]
    with mock.patch.object(K, "_h_operand", _SOUND_H_OPERAND):
        one = K.ligru_recurrence_ref(xg, w_h, mask, reverse)
        halves = K.ligru_recurrence_ref(xg, w_h, mask, reverse,
                                        k_halves=True)
    return max(CUDA_REL["f32"], 2.0 * _errors(halves, one, reverse)[0])


def _held(xg, w_h, mask, dy, reverse, ys, hgs, ref_w_h=None, ref_mask=None):
    """A forward kernel's ys and stash of one direction held against the
    plain version, and K8b run from that stash against its plain version.
    Returns ((max rel, early mean, bound) of ys, (max rel, early mean) of
    dxg, whether the stash and the outputs are sound)."""
    rw = w_h if ref_w_h is None else ref_w_h
    rm = mask if ref_mask is None else ref_mask
    ys16 = ys.to(torch.bfloat16)
    dxg = K.ligru_bwd(xg, w_h, mask, hgs, ys16, dy, reverse)
    torch.cuda.synchronize()
    rys, rhgs = K.ligru_recurrence_ref(xg, rw, rm, reverse, stash=True)
    rdxg = K.ligru_recurrence_bwd_ref(xg, rw, rm, hgs, ys16, dy, reverse)
    mag = max(rhgs.float().abs().max().item(), 1.0)
    stash_ok = bool(((hgs.float() - rhgs.float()).abs()
                     <= CUDA_REL["bf16"] * mag
                     + STASH_REL * rhgs.float().abs()).all())
    finite = bool(torch.isfinite(ys.float()).all()
                  and torch.isfinite(dxg.float()).all())
    return ((*_errors(ys, rys, reverse), _ys_bound(xg, w_h, mask, reverse)),
            _errors(dxg, rdxg, not reverse), stash_ok and finite)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_plain_on_card(cuda, shape, reverse, dt):
    args = _card_inputs(cuda, shape, dt)
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    (f_full, f_early, f_tol), (b_full, b_early), ok = _card_pair(*args,
                                                                 reverse)
    assert (K.FWD_LAUNCHES, K.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert f_full <= f_tol and f_early <= EARLY_MEAN_REL[dt]
    assert b_full <= BWD_REL and b_early <= EARLY_MEAN_REL[dt]
    assert ok


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["w_h_x2", "f32_operand", "no_mask"])
def test_kernels_vs_plain_fail_under_planted_fault(cuda, monkeypatch, fault):
    args = _card_inputs(cuda, FAULT_SHAPE, "f32")
    ref_w_h = ref_mask = None
    if fault == "w_h_x2":
        ref_w_h = 2 * args[1]
    elif fault == "f32_operand":
        monkeypatch.setattr(K, "_h_operand", lambda h: h)
        monkeypatch.setattr(K, "_dg_operand", lambda d: d)
    else:
        ref_mask = torch.ones_like(args[2])
    (f_full, f_early, f_tol), (b_full, b_early), _ = _card_pair(
        *args, False, ref_w_h, ref_mask)
    assert f_full > f_tol or f_early > EARLY_MEAN_REL["f32"]
    assert b_full > BWD_REL or b_early > EARLY_MEAN_REL["f32"]


@pytest.mark.cuda
def test_autograd_function_on_card_matches_cpu(cuda):
    xg, w_h, mask, dy = _inputs(12, 4, 64, seed=9)
    grads = {}
    for where in ("cpu", cuda):
        a = torch.from_numpy(xg).to(where).requires_grad_()
        w = torch.from_numpy(w_h).to(where).requires_grad_()
        ys = K.ligru_recurrence(a, w, torch.from_numpy(mask).to(where),
                                reverse=True)
        grads[str(where)] = [g.cpu() for g in torch.autograd.grad(
            ys, (a, w), torch.from_numpy(dy).to(where))] + [ys.cpu()]
    for c, g in zip(grads["cpu"], grads[str(cuda)]):
        assert float((c - g).abs().max()) <= 2e-3 * max(
            1.0, float(c.abs().max()))


# Both directions through the packed form, one mask for the two, each held
# as the single form is (the backward K8b from the packed launch's stash).
# The listener's width in its dtype, bf16: on f32 streams at T=400 the plain
# version itself moves 2.0-2.2e-3 of its range when only its f32 sum order
# changes (|h| near 10, every flipped bf16 rounding of h fed back), the
# width of the f32 bound, so f32 streams are held at the short shapes. The
# planted faults are held on f32 streams at both widths; a doubled w_h
# overflows the plain version at T=400, which must fail the checks too.
PACKED_SHAPES = [(37, 3, 200, "f32"), (37, 3, 200, "bf16"), (5, 2, 16, "f32"),
                 (5, 2, 16, "bf16"), (400, 16, 1280, "bf16")]
PACKED_FAULT_SHAPES = [FAULT_SHAPE, (400, 16, 1280)]


def _packed_run(cuda, shape, dt, ref_w_scale=1.0, ref_mask=None):
    fw = _card_inputs(cuda, shape, dt)
    bw = _card_inputs(cuda, shape, dt, seed=sum(shape) + 100)
    mask = fw[2]
    before = (K.FWD_LAUNCHES, K.FWD_PACKED_LAUNCHES, K.FWD_SINGLE_LAUNCHES)
    ys_f, ys_b, hgs_f, hgs_b = K._launch_fwd_pair(
        fw[0], bw[0], fw[1], bw[1], mask, True, "packed")
    assert (K.FWD_LAUNCHES, K.FWD_PACKED_LAUNCHES, K.FWD_SINGLE_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2])
    return [_held(a[0], a[1], mask, a[3], rev, ys, hgs, ref_w_scale * a[1],
                  ref_mask)
            for a, rev, ys, hgs in ((fw, False, ys_f, hgs_f),
                                    (bw, True, ys_b, hgs_b))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dt", [(s[:3], s[3]) for s in PACKED_SHAPES])
def test_packed_form_matches_plain_on_card(cuda, shape, dt):
    for (f_full, f_early, f_tol), (b_full, b_early), ok in _packed_run(
            cuda, shape, dt):
        assert f_full <= f_tol and f_early <= EARLY_MEAN_REL[dt]
        assert b_full <= BWD_REL and b_early <= EARLY_MEAN_REL[dt]
        assert ok


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PACKED_FAULT_SHAPES)
@pytest.mark.parametrize("fault", ["w_h_x2", "f32_operand", "no_mask"])
def test_packed_form_vs_plain_fails_under_planted_fault(cuda, monkeypatch,
                                                        shape, fault):
    scale, ref_mask = 1.0, None
    if fault == "w_h_x2":
        scale = 2.0
    elif fault == "f32_operand":
        monkeypatch.setattr(K, "_h_operand", lambda h: h)
        monkeypatch.setattr(K, "_dg_operand", lambda d: d)
    else:
        ref_mask = torch.ones(shape[1], shape[2], device=cuda)
    for (f_full, f_early, f_tol), (b_full, b_early), _ in _packed_run(
            cuda, shape, "f32", scale, ref_mask):
        assert not (f_full <= f_tol and f_early <= EARLY_MEAN_REL["f32"])
        assert not (b_full <= BWD_REL and b_early <= EARLY_MEAN_REL["f32"])


# The packed backward: one launch over both directions from the packed
# forward's stashes, one mask for the two, each direction held against the
# plain backward from its own stash under the single form's bounds; at the
# listener's width, where both forms pad H alike, it must give the single
# form's bits.
PACKED_BWD_SHAPES = [(37, 3, 200), (5, 2, 16), (400, 16, 1280)]


def _packed_bwd_run(cuda, shape, dt, ref_w_scale=1.0, ref_mask=None,
                    swap=False):
    fw = _card_inputs(cuda, shape, dt)
    bw = _card_inputs(cuda, shape, dt, seed=sum(shape) + 100)
    mask = fw[2]
    ys_f, ys_b, hgs_f, hgs_b = K._launch_fwd_pair(
        fw[0], bw[0], fw[1], bw[1], mask, True, "packed")
    ys = [ys_f.to(torch.bfloat16), ys_b.to(torch.bfloat16)]
    hgs = [hgs_f, hgs_b]
    names = ("BWD_LAUNCHES", "BWD_PACKED_LAUNCHES", "BWD_SINGLE_LAUNCHES")
    before = [getattr(K, n) for n in names]
    dx_f, dx_b = K._launch_bwd_pair(fw[0], bw[0], fw[1], bw[1], mask, *hgs,
                                    *ys, fw[3], bw[3], "packed")
    torch.cuda.synchronize()
    assert [getattr(K, n) - b for n, b in zip(names, before)] == [1, 1, 0]
    rm = mask if ref_mask is None else ref_mask
    out = []
    for d, (dx, rev) in enumerate(((dx_f, False), (dx_b, True))):
        r = 1 - d if swap else d          # the other direction's operands
        a = (fw, bw)[r]
        rdx = K.ligru_recurrence_bwd_ref(a[0], ref_w_scale * a[1], rm, hgs[r],
                                         ys[r], a[3], rev)
        out.append((_errors(dx, rdx, not rev),
                    bool(torch.isfinite(dx.float()).all())))
    if shape[2] % 80 == 0 and ref_w_scale == 1.0 and ref_mask is None:
        single = K._launch_bwd_pair(fw[0], bw[0], fw[1], bw[1], mask, *hgs,
                                    *ys, fw[3], bw[3], "single")
        assert torch.equal(dx_f, single[0]) and torch.equal(dx_b, single[1])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", PACKED_BWD_SHAPES)
def test_packed_backward_matches_plain_on_card(cuda, shape, dt):
    for (b_full, b_early), finite in _packed_bwd_run(cuda, shape, dt):
        assert b_full <= BWD_REL and b_early <= EARLY_MEAN_REL[dt]
        assert finite


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PACKED_FAULT_SHAPES)
@pytest.mark.parametrize("fault", ["w_h_x2", "f32_operand", "no_mask",
                                   "swap"])
def test_packed_backward_vs_plain_fails_under_planted_fault(
        cuda, monkeypatch, shape, fault):
    scale, ref_mask = 1.0, None
    if fault == "w_h_x2":
        scale = 2.0
    elif fault == "f32_operand":
        monkeypatch.setattr(K, "_dg_operand", lambda d: d)
    elif fault == "no_mask":
        ref_mask = torch.ones(shape[1], shape[2], device=cuda)
    for (b_full, b_early), _ in _packed_bwd_run(
            cuda, shape, "f32", scale, ref_mask, swap=fault == "swap"):
        assert not (b_full <= BWD_REL and b_early <= EARLY_MEAN_REL["f32"])


@pytest.mark.cuda
def test_bidirectional_backward_takes_the_rules_form_on_card(cuda):
    """H=1280 both directions: one packed backward launch; H=1296, above
    the packed form's grid: two single launches."""
    names = ("BWD_LAUNCHES", "BWD_PACKED_LAUNCHES", "BWD_SINGLE_LAUNCHES")
    for hidden, packed, single in ((1280, 1, 0), (1296, 0, 2)):
        fw = _card_inputs(cuda, (3, 2, hidden), "bf16")
        bw = _card_inputs(cuda, (3, 2, hidden), "bf16", seed=1)
        ys_f, ys_b, hgs_f, hgs_b = K.ligru_fwd_pair(
            fw[0], bw[0], fw[1], bw[1], fw[2], stash=True)
        ys_f, ys_b = ys_f.to(torch.bfloat16), ys_b.to(torch.bfloat16)
        before = [getattr(K, n) for n in names]
        out = K.ligru_bwd_pair(fw[0], bw[0], fw[1], bw[1], fw[2], hgs_f,
                               hgs_b, ys_f, ys_b, fw[3], bw[3])
        assert [getattr(K, n) - b for n, b in zip(names, before)] == [
            packed + single, packed, single]
        ref = K.ligru_recurrence_bwd_ref(bw[0], bw[1], fw[2], hgs_b, ys_b,
                                         bw[3], True)
        assert float((out[1].float() - ref.float()).abs().max()) <= (
            BWD_REL * float(ref.float().abs().max()))


@pytest.mark.cuda
def test_bidirectional_entry_takes_the_rules_form_on_card(cuda):
    """H=1280 both directions: one packed launch; H=1296, above the packed
    form's grid: two single launches."""
    for hidden, packed, single in ((1280, 1, 0), (1296, 0, 2)):
        fw = _card_inputs(cuda, (3, 2, hidden), "bf16")
        bw = _card_inputs(cuda, (3, 2, hidden), "bf16", seed=1)
        before = (K.FWD_LAUNCHES, K.FWD_PACKED_LAUNCHES,
                  K.FWD_SINGLE_LAUNCHES)
        ys_f, ys_b = K.ligru_fwd_pair(fw[0], bw[0], fw[1], bw[1], fw[2])
        assert (K.FWD_LAUNCHES - before[0], K.FWD_PACKED_LAUNCHES - before[1],
                K.FWD_SINGLE_LAUNCHES - before[2]) == (packed + single,
                                                       packed, single)
        ref = K.ligru_recurrence_ref(bw[0], bw[1], fw[2], True)
        scale = max(1.0, float(ref.float().abs().max()))
        assert float((ys_b.float() - ref.float()).abs().max()) <= (
            CUDA_REL["bf16"] * scale)


@pytest.mark.cuda
def test_bidirectional_autograd_on_card_matches_cpu(cuda):
    fw, bw = _inputs(12, 4, 64, seed=9), _inputs(12, 4, 64, seed=10)
    grads = {}
    for where in ("cpu", cuda):
        leaves = [torch.from_numpy(a[i]).to(where).requires_grad_()
                  for i in (0, 1) for a in (fw, bw)]
        ys = K.biligru_recurrence(*leaves, torch.from_numpy(fw[2]).to(where))
        grads[str(where)] = [g.cpu() for g in torch.autograd.grad(
            ys, leaves, tuple(torch.from_numpy(a[3]).to(where)
                              for a in (fw, bw)))] + [y.cpu() for y in ys]
    for c, g in zip(grads["cpu"], grads[str(cuda)]):
        assert float((c - g).abs().max()) <= 2e-3 * max(
            1.0, float(c.abs().max()))
