"""Port of the GRU recurrence (K7f/K7b) against the JAX package's Pallas
kernels run in interpret mode, and the CUDA kernels against their plain
PyTorch versions (those skip without a card).

Tolerances. The plain versions take the same bf16 products as the kernels,
exact in f32, so with an f32 stream ys, the gradients and the stash's f32
source agree to 1e-5 of their range (only the order of the f32 sums
differs). With a bf16 stream ys and dxg are rounded to bf16: one bf16 ulp at
|h| <= 1 is 2^-8, and a flipped rounding feeds back, so 1e-2 for ys and one
bf16 ulp of the range, 2^-7 * max, for dxg and the sums dW_h and db_h made
of it. The stash is bf16 in both: one bf16 ulp of its value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.ops.pallas import gru as PG
from e2e_asr_pytorch_tpu_torch.ops.kernels import gru as K

YS_ATOL = {"f32": 1e-5, "bf16": 1e-2}
GRAD_REL = {"f32": 1e-5, "bf16": 2.0 ** -7}
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


def _inputs(t, b, h, seed):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((t, b, 3 * h)).astype(np.float32)
    w_h = (rng.standard_normal((h, 3 * h)) / np.sqrt(h)).astype(np.float32)
    b_h = (0.3 * rng.standard_normal(3 * h)).astype(np.float32)
    dy = rng.standard_normal((t, b, h)).astype(np.float32)
    return xg, w_h, b_h, dy


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _rel(j, t):
    return float(np.max(np.abs(j - t)) / np.max(np.abs(j)))


def _both(shape, dt, reverse=False, wh_scale=1.0):
    """ys, dxg, dW_h, db_h of the JAX kernel pair (interpret mode) under
    jax.vjp and of the port's autograd Function on CPU tensors (its plain
    versions)."""
    jd, td = DTYPES[dt]
    xg, w_h, b_h, dy = _inputs(*shape, seed=sum(shape))
    jys, vjp = jax.vjp(
        lambda a, w, b: PG.gru_recurrence(a, w, b, reverse=reverse),
        jnp.asarray(xg, jd), jnp.asarray(w_h), jnp.asarray(b_h))
    jgrads = vjp(jnp.asarray(dy, jd))
    txg = torch.from_numpy(xg).to(td).requires_grad_()
    twh = torch.from_numpy(w_h * wh_scale).requires_grad_()
    tbh = torch.from_numpy(b_h).requires_grad_()
    tys = K.gru_recurrence(txg, twh, tbh, reverse=reverse)
    tgrads = torch.autograd.grad(tys, (txg, twh, tbh),
                                 torch.from_numpy(dy).to(td))
    assert tys.dtype == td and tgrads[0].dtype == td
    assert tgrads[1].dtype == tgrads[2].dtype == torch.float32
    return [(_f32(j), _f32(t)) for j, t in zip((jys, *jgrads),
                                               (tys, *tgrads))]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernel(interpret, shape, reverse, dt):
    (jys, tys), *grads = _both(shape, dt, reverse)
    assert np.max(np.abs(jys - tys)) <= YS_ATOL[dt]
    for j, t in grads:                       # dxg, dW_h, db_h
        assert _rel(j, t) <= GRAD_REL[dt]


def test_plain_vs_jax_fails_under_doubled_w_h(interpret):
    (jys, tys), (jdxg, tdxg), _, (jdb, tdb) = _both(SHAPES[0], "f32",
                                                    wh_scale=2.0)
    assert np.max(np.abs(jys - tys)) > 100 * YS_ATOL["f32"]
    assert _rel(jdxg, tdxg) > 10 * GRAD_REL["bf16"]
    assert _rel(jdb, tdb) > 10 * GRAD_REL["bf16"]


def _stash_and_bwd(shape, dt, reverse, **fault):
    """The forward's stash and the backward's three results on both sides,
    from the JAX package's own ``_fwd`` / ``_bwd``."""
    jd, td = DTYPES[dt]
    xg, w_h, b_h, dy = _inputs(*shape, seed=sum(shape) + 1)
    jxg, jwh, jbh = jnp.asarray(xg, jd), jnp.asarray(w_h), jnp.asarray(b_h)
    jys, jhgs = PG._fwd(jxg, jwh, jbh, reverse)
    jdxg, jdwh, jdbh = PG._bwd(jxg, jwh, jhgs, jys.astype(jnp.bfloat16),
                               jnp.asarray(dy, jd), reverse)
    txg, twh, tbh = (torch.from_numpy(xg).to(td), torch.from_numpy(w_h),
                     torch.from_numpy(b_h))
    tys, thgs = K.gru_fwd(txg, twh, tbh, reverse, stash=True)
    ys16 = tys.to(torch.bfloat16)
    args = (txg, twh, thgs, ys16, torch.from_numpy(dy).to(td), reverse)
    tdxg, tdhg = (K.gru_recurrence_bwd_ref(*args, **fault) if fault
                  else K.gru_bwd(*args))
    assert thgs.dtype == torch.bfloat16 and tdhg.dtype == torch.float32
    tdwh = K.dwh(ys16, tdhg.to(torch.bfloat16), reverse)
    return {"hgs": (_f32(jhgs), _f32(thgs)), "dxg": (_f32(jdxg), _f32(tdxg)),
            "dwh": (_f32(jdwh), _f32(tdwh)),
            "dbh": (_f32(jdbh), _f32(tdhg.sum(dim=(0, 1)))),
            "dhg": _f32(tdhg)}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_stash_and_backward_match_jax_kernel(interpret, reverse, dt):
    res = _stash_and_bwd((9, 2, 40), dt, reverse)
    jh, th = res["hgs"]
    assert bool(np.all(np.abs(jh - th) <= 1e-6 + STASH_REL * np.abs(jh)))
    for key in ("dxg", "dwh", "dbh"):
        assert _rel(*res[key]) <= GRAD_REL[dt], key
    # dhg is dxg with the n slot scaled by r, so its r and z slots equal it
    h = 40
    dxg, dhg = res["dxg"][1], res["dhg"]
    tol = GRAD_REL[dt] * np.max(np.abs(dhg))
    assert np.max(np.abs(dhg[..., :2 * h] - dxg[..., :2 * h])) <= tol
    assert (np.max(np.abs(dhg[..., 2 * h:] - dxg[..., 2 * h:]))
            > 0.1 * np.max(np.abs(dhg)))


def test_backward_fails_with_the_n_slot_swapped(interpret):
    """dxn where dxn*r belongs (and back) must not pass: the two outputs
    differ in the n slot only."""
    res = _stash_and_bwd((9, 2, 40), "f32", False, swap_n_slot=True)
    assert _rel(*res["dxg"]) > 10 * GRAD_REL["bf16"]
    assert _rel(*res["dbh"]) > 10 * GRAD_REL["bf16"]
    assert _rel(*res["dwh"]) > 10 * GRAD_REL["bf16"]


def test_backward_reads_the_bf16_stash_and_bf16_h_prev():
    """The backward re-forms its gates from the bf16 stash and bf16 ys, not
    from f32 values: fed the unrounded f32 ones it gives another dxg."""
    xg, w_h, b_h, dy = (torch.from_numpy(a) for a in _inputs(7, 2, 16, 3))
    ys, hgs = K.gru_recurrence_ref(xg, w_h, b_h, stash=True)
    sound = K.gru_recurrence_bwd_ref(xg, w_h, hgs, ys, dy)[0]
    again = K.gru_bwd(xg, w_h, hgs, ys.to(torch.bfloat16), dy)[0]
    assert torch.equal(sound, again)
    # an f32 re-run of the forward's hg, unrounded
    h = torch.zeros(2, 16)
    hg32 = []
    for i in range(7):
        hg = K._h_operand(h) @ w_h.to(torch.bfloat16).float() + b_h
        hg32.append(hg)
        h = ys[i]
    hg32 = torch.stack(hg32)
    assert float((hg32 - hgs.float()).abs().max()) > 0
    assert float((hg32.to(torch.bfloat16).float() - hgs.float()).abs().max()
                 ) <= 1e-6


@pytest.mark.parametrize("hidden,gru,ligru", [
    (1280, True, True), (1792, True, True), (1808, False, True),
    (2112, False, True), (2128, False, False)])
def test_fit_rule_from_an_h100(hidden, gru, ligru):
    """The flagship's 1280 units get both kernels; the GRU's three-gate slab
    stops fitting a block's shared memory above 1792, and the light GRU runs
    out of SMs (one 16-unit tile each) above 2112."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import ligru as KL
    assert K.fits(hidden) == gru
    assert KL.fits(hidden) == ligru
    fwd, bwd = K.block_smem_bytes(3, 1280)
    assert (fwd, bwd) == (2 * 48 * 1288 + 33792 + 24576,
                          2 * 16 * 3848 + 33792 + 8192)


def test_padding_keeps_the_result():
    """The wrappers pad H to a multiple of 16 with zero units, which stay at
    h = 0: the plain version on the padded operands gives the unpadded
    result."""
    xg, w_h, b_h, dy = (torch.from_numpy(a) for a in _inputs(5, 2, 20, 1))
    ys, hgs = K.gru_recurrence_ref(xg, w_h, b_h, stash=True)
    hp = K._padded(20)
    assert hp == 32
    pxg = K._pad_units(xg, 20, hp, 3)
    pwh = K.pad_w(w_h, 20, hp, 3).float()
    pys, phgs = K.gru_recurrence_ref(pxg, pwh, K._pad_units(b_h, 20, hp, 3),
                                     stash=True)
    assert float((K._unpad_units(pys, 20, hp, 1) - ys).abs().max()) <= 1e-6
    assert float(pys[..., 20:].abs().max()) == 0.0
    dxg, dhg = K.gru_recurrence_bwd_ref(xg, w_h, hgs, ys, dy)
    pdxg, pdhg = K.gru_recurrence_bwd_ref(
        pxg, pwh, phgs, pys, K._pad_units(dy, 20, hp, 1))
    err = (K._unpad_units(pdxg, 20, hp, 3) - dxg).abs().max()
    assert float(err) <= GRAD_REL["bf16"] * float(dxg.abs().max())
    assert float(pdhg.reshape(5, 2, 3, hp)[..., 20:].abs().max()) == 0.0
    # the forward kernel's packed operand: tile, gate-major rows, k contiguous
    wp = K.pack_w(w_h, 20, hp, 3)
    assert tuple(wp.shape) == (2, 48, 32)
    assert torch.equal(wp[1, 2 * 16 + 3, :20],
                       w_h[:, 2 * 20 + 16 + 3].to(torch.bfloat16))


@pytest.mark.parametrize("gates", [2, 3])
@pytest.mark.parametrize("hidden", [16, 20, 48])
def test_kernel_operands_are_contiguous(hidden, gates):
    """The kernels read memory, not strides: the packed and padded weights
    must be contiguous (a single tile's pack reshapes to a view)."""
    w_h = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (hidden, gates * hidden)).astype(np.float32))
    hp = K._padded(hidden)
    wp, wh = K.pack_w(w_h, hidden, hp, gates), K.pad_w(w_h, hidden, hp, gates)
    assert wp.is_contiguous() and wh.is_contiguous()
    assert tuple(wp.shape) == (hp // 16, gates * 16, hp)
    for tile, g, j in ((0, 0, 0), (hp // 16 - 1, gates - 1, 3)):
        unit = 16 * tile + j
        want = (w_h[:, g * hidden + unit].to(torch.bfloat16)
                if unit < hidden else torch.zeros(hidden, dtype=torch.bfloat16))
        assert torch.equal(wp[tile, g * 16 + j, :hidden], want)


def test_cpu_tensors_take_the_plain_versions():
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES, K.FWD_PACKED_LAUNCHES,
              K.FWD_SINGLE_LAUNCHES)
    xg, w_h, b_h, dy = (torch.from_numpy(a) for a in _inputs(5, 2, 8, 0))
    ys, hgs = K.gru_fwd(xg, w_h, b_h, reverse=True, stash=True)
    ref = K.gru_recurrence_ref(xg, w_h, b_h, reverse=True, stash=True)
    assert torch.equal(ys, ref[0]) and torch.equal(hgs, ref[1])
    assert torch.equal(K.gru_fwd(xg, w_h, b_h, reverse=True), ys)
    out = K.gru_bwd(xg, w_h, hgs, ys.to(torch.bfloat16), dy, reverse=True)
    want = K.gru_recurrence_bwd_ref(xg, w_h, hgs, ys, dy, True)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert before == (K.FWD_LAUNCHES, K.BWD_LAUNCHES, K.FWD_PACKED_LAUNCHES,
                      K.FWD_SINGLE_LAUNCHES)


@pytest.mark.parametrize("bad", ["xg_shape", "w_shape", "b_shape", "dtype",
                                 "stash", "dy_dtype"])
def test_wrappers_refuse_bad_operands(bad):
    xg, w_h, b_h, dy = (torch.from_numpy(a) for a in _inputs(5, 2, 8, 0))
    if bad in ("stash", "dy_dtype"):
        ys, hgs = K.gru_fwd(xg, w_h, b_h, stash=True)
        ys = ys.to(torch.bfloat16)
        with pytest.raises((ValueError, TypeError)):
            if bad == "stash":
                K.gru_bwd(xg, w_h, hgs.float(), ys, dy)
            else:
                K.gru_bwd(xg, w_h, hgs, ys, dy.to(torch.bfloat16))
        return
    if bad == "xg_shape":
        xg = xg[..., :22]
    elif bad == "w_shape":
        w_h = w_h[:4]
    elif bad == "b_shape":
        b_h = b_h[:8]
    else:
        xg = xg.double()
    with pytest.raises((ValueError, TypeError)):
        K.gru_recurrence(xg, w_h, b_h)


# ------------------------------------------------ both directions at once
def _both_pair(shape, dt, swap=False, wh_scale=1.0):
    """ys, dxg, dW_h and db_h of both directions: two JAX kernel calls
    (interpret mode; the second reversed) under jax.vjp, and the port's
    ``bigru_recurrence`` (its autograd Function) on CPU tensors. Planted
    faults: ``swap`` hands the port the two directions' operands the wrong
    way round, ``wh_scale`` scales its w_h."""
    jd, td = DTYPES[dt]
    fw = _inputs(*shape, seed=sum(shape))
    bw = _inputs(*shape, seed=sum(shape) + 100)
    jys, vjp = jax.vjp(
        lambda af, ab, wf, wb, bf, bb: (
            PG.gru_recurrence(af, wf, bf),
            PG.gru_recurrence(ab, wb, bb, reverse=True)),
        *(jnp.asarray(a[0], jd) for a in (fw, bw)),
        *(jnp.asarray(a[i]) for i in (1, 2) for a in (fw, bw)))
    jgrads = vjp(tuple(jnp.asarray(a[3], jd) for a in (fw, bw)))
    leaves = ([torch.from_numpy(a[0]).to(td) for a in (fw, bw)]
              + [torch.from_numpy(a[1] * wh_scale) for a in (fw, bw)]
              + [torch.from_numpy(a[2]) for a in (fw, bw)])
    leaves = [x.requires_grad_() for x in leaves]
    order = [1, 0, 3, 2, 5, 4] if swap else range(6)
    tys = K.bigru_recurrence(*(leaves[i] for i in order))
    tgrads = torch.autograd.grad(tys, leaves, tuple(
        torch.from_numpy(a[3]).to(td) for a in (fw, bw)))
    assert all(y.dtype == td for y in tys)
    assert tgrads[0].dtype == tgrads[1].dtype == td
    ys = [(_f32(j), _f32(t)) for j, t in zip(jys, tys)]
    grads = [(_f32(j), _f32(t)) for j, t in zip(jgrads, tgrads)]
    return ys, grads  # grads: dxg_f, dxg_b, dW_h f/b, db_h f/b


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bidirectional_matches_jax_kernel(interpret, shape, dt):
    ys, grads = _both_pair(shape, dt)
    for j, t in ys:
        assert np.max(np.abs(j - t)) <= YS_ATOL[dt]
    for j, t in grads:
        assert _rel(j, t) <= GRAD_REL[dt]


@pytest.mark.parametrize("fault", ["swap", "w_h_x2"])
def test_bidirectional_vs_jax_fails_under_planted_fault(interpret, fault):
    ys, grads = _both_pair(SHAPES[1], "f32", swap=fault == "swap",
                           wh_scale=2.0 if fault == "w_h_x2" else 1.0)
    for j, t in ys:
        assert np.max(np.abs(j - t)) > 100 * YS_ATOL["f32"]
    for j, t in grads[:2] + grads[4:]:          # dxg and db_h
        assert _rel(j, t) > 10 * GRAD_REL["bf16"]


def test_bidirectional_entry_is_the_two_plain_walks_on_cpu():
    """On CPU tensors the bidirectional forward is the plain version once
    per direction, the second reversed, and counts no launch."""
    before = (K.FWD_LAUNCHES, K.FWD_PACKED_LAUNCHES, K.FWD_SINGLE_LAUNCHES,
              K.BWD_LAUNCHES)
    fw = [torch.from_numpy(a) for a in _inputs(6, 2, 24, 4)]
    bw = [torch.from_numpy(a) for a in _inputs(6, 2, 24, 5)]
    out = K.gru_fwd_pair(fw[0], bw[0], fw[1], bw[1], fw[2], bw[2],
                         stash=True)
    f = K.gru_recurrence_ref(fw[0], fw[1], fw[2], False, stash=True)
    b = K.gru_recurrence_ref(bw[0], bw[1], bw[2], True, stash=True)
    assert all(torch.equal(x, y) for x, y in zip(out, (f[0], b[0], f[1],
                                                       b[1])))
    ys = K.gru_fwd_pair(fw[0], bw[0], fw[1], bw[1], fw[2], bw[2])
    assert torch.equal(ys[0], f[0]) and torch.equal(ys[1], b[0])
    assert before == (K.FWD_LAUNCHES, K.FWD_PACKED_LAUNCHES,
                      K.FWD_SINGLE_LAUNCHES, K.BWD_LAUNCHES)


@pytest.mark.parametrize("module", ["GRU", "liGRU"])
@pytest.mark.parametrize("hidden,bidirectional,form", [
    (1280, True, "packed"), (1792, True, "single"), (1280, False, "single"),
    (1296, True, "single"), (80, True, "packed"), (16, False, "single")])
def test_form_rule_from_an_h100(module, hidden, bidirectional, form):
    """Both directions share one launch where the layer is bidirectional
    and 2 * H/20 blocks (H padded to 80) fit the 132 SMs with their slab:
    up to the flagship's 1280. H=1296 pads to 1360, 136 blocks. Above the
    kernels' limit the rule refuses, as ``fits`` does."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import ligru as KL
    mod = K if module == "GRU" else KL
    assert mod.form_for(hidden, bidirectional) == form
    above = 1808 if module == "GRU" else 2128
    with pytest.raises(ValueError, match="does not fit"):
        mod.form_for(above, True)
    assert K.packed_smem_bytes(3, 1280) == 2 * 64 * 1288 + 25344
    assert K.packed_smem_bytes(2, 1280) == 2 * 40 * 1288 + 25344


@pytest.mark.parametrize("module", ["GRU", "liGRU"])
@pytest.mark.parametrize("hidden,bidirectional,form", [
    (1280, True, "packed"), (1792, True, "single"), (1280, False, "single")])
def test_backward_form_rule_from_an_h100(module, hidden, bidirectional,
                                         form):
    """The backward's form by the forward's rule, with its own slab: 20
    rows of w_h (G*H + 8 bf16 each) and a 4-deep ring of 16 x (512 + 8)
    bf16, which at H=1280 fit a block's 232,448 bytes (GRU 220,480, light
    GRU 169,280) beside 128 blocks on 132 SMs. H=1792 pads to 1840, 184
    blocks; a unidirectional layer has one direction to walk."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import ligru as KL
    mod = K if module == "GRU" else KL
    assert mod.form_for(hidden, bidirectional, backward=True) == form
    assert K.packed_bwd_smem_bytes(3, 1280) == (2 * 20 * (3 * 1280 + 8)
                                                + 2 * 4 * 16 * 520)
    assert K.packed_bwd_smem_bytes(2, 1280) == (2 * 20 * (2 * 1280 + 8)
                                                + 2 * 4 * 16 * 520)
    assert K.packed_bwd_smem_bytes(3, 1280) == 220480 <= 232448


def _bwd_pair_both(shape, dt, swap=False, wh_scale=1.0):
    """dxg, dW_h and db_h of both directions: jax.vjp of two JAX kernel
    calls (interpret mode; the second reversed), and the port's
    ``gru_bwd_pair`` on CPU tensors from its own forward's stashes, dW_h and
    db_h formed as ``BiGRURecurrence`` forms them. Planted faults: ``swap``
    hands the backward the two directions' operands the wrong way round,
    ``wh_scale`` scales its w_h."""
    jd, td = DTYPES[dt]
    fw = _inputs(*shape, seed=sum(shape) + 7)
    bw = _inputs(*shape, seed=sum(shape) + 107)
    _, vjp = jax.vjp(
        lambda af, ab, wf, wb, bf, bb: (
            PG.gru_recurrence(af, wf, bf),
            PG.gru_recurrence(ab, wb, bb, reverse=True)),
        *(jnp.asarray(a[0], jd) for a in (fw, bw)),
        *(jnp.asarray(a[i]) for i in (1, 2) for a in (fw, bw)))
    jgrads = vjp(tuple(jnp.asarray(a[3], jd) for a in (fw, bw)))
    xs = [torch.from_numpy(a[0]).to(td) for a in (fw, bw)]
    ws = [torch.from_numpy(a[1]) for a in (fw, bw)]
    dys = [torch.from_numpy(a[3]).to(td) for a in (fw, bw)]
    ys_f, ys_b, hgs_f, hgs_b = K.gru_fwd_pair(
        *xs, *ws, *(torch.from_numpy(a[2]) for a in (fw, bw)), stash=True)
    ys = [ys_f.to(torch.bfloat16), ys_b.to(torch.bfloat16)]
    hgs = [hgs_f, hgs_b]
    o = [1, 0] if swap else [0, 1]
    dx_f, dx_b, dhg_f, dhg_b = K.gru_bwd_pair(
        *(xs[i] for i in o), *(wh_scale * ws[i] for i in o),
        *(hgs[i] for i in o), *(ys[i] for i in o), *(dys[i] for i in o))
    assert dx_f.dtype == dx_b.dtype == td
    assert dhg_f.dtype == dhg_b.dtype == torch.float32
    tgrads = [dx_f, dx_b] + [K.dwh(y, d.to(torch.bfloat16), rev)
                             for y, d, rev in ((ys[0], dhg_f, False),
                                               (ys[1], dhg_b, True))] + [
        dhg_f.sum(dim=(0, 1)), dhg_b.sum(dim=(0, 1))]
    return [(_f32(j), _f32(t)) for j, t in zip(jgrads, tgrads)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_pair_matches_jax_kernel(interpret, shape, dt):
    for j, t in _bwd_pair_both(shape, dt):  # dxg, dW_h, db_h, f then b
        assert _rel(j, t) <= GRAD_REL[dt]


@pytest.mark.parametrize("fault", ["swap", "w_h_x2"])
def test_backward_pair_vs_jax_fails_under_planted_fault(interpret, fault):
    grads = _bwd_pair_both(SHAPES[1], "f32", swap=fault == "swap",
                           wh_scale=2.0 if fault == "w_h_x2" else 1.0)
    for j, t in grads[:2] + grads[4:]:          # dxg and db_h
        assert _rel(j, t) > 10 * GRAD_REL["bf16"]


def test_backward_pair_is_the_two_plain_walks_on_cpu():
    """On CPU tensors the bidirectional backward is the plain version once
    per direction, the second reversed, and counts no launch."""
    names = ("BWD_LAUNCHES", "BWD_PACKED_LAUNCHES", "BWD_SINGLE_LAUNCHES",
             "FWD_LAUNCHES")
    before = [getattr(K, n) for n in names]
    fw = [torch.from_numpy(a) for a in _inputs(6, 2, 24, 14)]
    bw = [torch.from_numpy(a) for a in _inputs(6, 2, 24, 15)]
    ys_f, ys_b, hgs_f, hgs_b = K.gru_fwd_pair(fw[0], bw[0], fw[1], bw[1],
                                              fw[2], bw[2], stash=True)
    ys_f, ys_b = ys_f.to(torch.bfloat16), ys_b.to(torch.bfloat16)
    out = K.gru_bwd_pair(fw[0], bw[0], fw[1], bw[1], hgs_f, hgs_b, ys_f,
                         ys_b, fw[3], bw[3])
    f = K.gru_recurrence_bwd_ref(fw[0], fw[1], hgs_f, ys_f, fw[3], False)
    b = K.gru_recurrence_bwd_ref(bw[0], bw[1], hgs_b, ys_b, bw[3], True)
    assert all(torch.equal(x, y) for x, y in zip(out, (f[0], b[0], f[1],
                                                       b[1])))
    assert before == [getattr(K, n) for n in names]
    with pytest.raises(ValueError):
        K.gru_bwd_pair(fw[0], bw[0], fw[1], bw[1], hgs_f, hgs_b[:, :1], ys_f,
                       ys_b, fw[3], bw[3])


@pytest.mark.parametrize("gates", [2, 3])
@pytest.mark.parametrize("hidden", [20, 37, 80])
def test_packed_operand_layout(hidden, gates):
    """The packed form's operand against an explicit index map: per
    direction and 20-unit tile, row g*20 + j is column g*H + 20*tile + j of
    that direction's w_h in bf16 (zero for a padding unit), k contiguous
    and padded to 80; the GRU's 4 rows past its 60 gate columns are zero."""
    rng = np.random.default_rng(hidden + gates)
    ws = [torch.from_numpy(rng.standard_normal(
        (hidden, gates * hidden)).astype(np.float32)) for _ in range(2)]
    wp = K.pack_w_pair(ws[0], ws[1], gates)
    hp = -(-hidden // 80) * 80
    cols = {2: 40, 3: 64}[gates]
    assert tuple(wp.shape) == (2, hp // 20, cols, hp)
    assert wp.dtype == torch.bfloat16 and wp.is_contiguous()
    want = torch.zeros(2, hp // 20, cols, hp, dtype=torch.bfloat16)
    for d in range(2):
        for tile in range(hp // 20):
            for g in range(gates):
                for j in range(20):
                    unit = 20 * tile + j
                    if unit < hidden:
                        want[d, tile, g * 20 + j, :hidden] = (
                            ws[d][:, g * hidden + unit].to(torch.bfloat16))
    assert torch.equal(wp, want)
    if gates == 3:
        assert float(wp[:, :, 60:].float().abs().max()) == 0.0


# ---------------------------------------------------------------- on a card
# ys as the LSTM kernels (a flipped rounding of bf16(h) feeds back): 2e-3 for
# f32 streams, 1.6e-2 for bf16; dxg and dhg: one bf16 ulp at the top of their
# range, 2^-6 * max. Before the first flip kernel and plain version agree to
# f32 noise, so the mean |err| over the first EARLY_STEPS steps of each walk
# holds the bf16-operand contract on f32 streams: 3e-6 (sound 1e-9 to 1.5e-6,
# an f32 operand 8e-6 and more), and the planted faults are held there. With
# a bf16 stream the outputs themselves are rounded and one flipped rounding
# among the few thousand cells of the small shapes moves the early mean by
# some 1e-6: 2e-5.
CUDA_ATOL = {"f32": 2e-3, "bf16": 1.6e-2}
BWD_REL = 2.0 ** -6
EARLY_STEPS = 4
EARLY_MEAN_TOL = {"f32": 3e-6, "bf16": 2e-5}
CARD_SHAPES = [(37, 3, 200), (5, 2, 16), (48, 18, 256)]
FAULT_SHAPE = (96, 16, 512)


def _card_inputs(cuda, shape, dt, seed=None):
    xg, w_h, b_h, dy = (torch.from_numpy(a).to(cuda) for a in _inputs(
        *shape, seed=sum(shape) if seed is None else seed))
    return xg.to(DTYPES[dt][1]), w_h, b_h, dy.to(DTYPES[dt][1])


def _errors(out, ref, first_steps_at_end):
    t = out.shape[0]
    k = min(EARLY_STEPS, t)
    d = (out.float() - ref.float()).abs()
    early = d[t - k:] if first_steps_at_end else d[:k]
    return d.max().item(), early.mean().item()


def _card_pair(xg, w_h, b_h, dy, reverse, ref_w_h=None, **fault):
    """(ys errors, dxg and dhg errors relative to their range) of kernel vs
    plain, the backward of both from the kernel's stash."""
    ys, hgs = K.gru_fwd(xg, w_h, b_h, reverse, stash=True)
    return _held(xg, w_h, b_h, dy, reverse, ys, hgs, ref_w_h, **fault)


def _held(xg, w_h, b_h, dy, reverse, ys, hgs, ref_w_h=None, **fault):
    """A forward kernel's ys and stash of one direction held against the
    plain version, and K7b run from that stash against its plain version."""
    rw = w_h if ref_w_h is None else ref_w_h
    ys16 = ys.to(torch.bfloat16)
    dxg, dhg = K.gru_bwd(xg, w_h, hgs, ys16, dy, reverse)
    torch.cuda.synchronize()
    rys, rhgs = K.gru_recurrence_ref(xg, rw, b_h, reverse, stash=True)
    rdxg, rdhg = K.gru_recurrence_bwd_ref(xg, rw, hgs, ys16, dy, reverse,
                                          **fault)
    stash_ok = bool(((hgs.float() - rhgs.float()).abs()
                     <= CUDA_ATOL["bf16"] + STASH_REL * rhgs.float().abs()
                     ).all())
    f = _errors(ys, rys, reverse)
    bx = _errors(dxg, rdxg, not reverse)
    bh = _errors(dhg, rdhg, not reverse)
    mag = rdxg.float().abs().max().item()
    return f, (max(bx[0], bh[0]) / mag, max(bx[1], bh[1])), stash_ok


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_plain_on_card(cuda, shape, reverse, dt):
    args = _card_inputs(cuda, shape, dt)
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    (f_full, f_early), (b_rel, b_early), stash_ok = _card_pair(*args, reverse)
    assert (K.FWD_LAUNCHES, K.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert f_full <= CUDA_ATOL[dt] and f_early <= EARLY_MEAN_TOL[dt]
    assert b_rel <= BWD_REL and b_early <= EARLY_MEAN_TOL[dt]
    assert stash_ok


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["w_h_x2", "f32_operand", "n_slot"])
def test_kernels_vs_plain_fail_under_planted_fault(cuda, monkeypatch, fault):
    args = _card_inputs(cuda, FAULT_SHAPE, "f32")
    ref_w_h, kw = None, {}
    if fault == "w_h_x2":
        ref_w_h = 2 * args[1]
    elif fault == "f32_operand":
        monkeypatch.setattr(K, "_h_operand", lambda h: h)
        monkeypatch.setattr(K, "_dg_operand", lambda d: d)
    else:
        kw["swap_n_slot"] = True
    (f_full, f_early), (b_rel, b_early), _ = _card_pair(*args, False, ref_w_h,
                                                        **kw)
    if fault != "n_slot":           # the swap is a fault of the backward only
        assert f_full > CUDA_ATOL["f32"] or f_early > EARLY_MEAN_TOL["f32"]
    assert b_rel > BWD_REL or b_early > EARLY_MEAN_TOL["f32"]


@pytest.mark.cuda
def test_autograd_function_on_card_matches_cpu(cuda):
    xg, w_h, b_h, dy = _inputs(12, 4, 64, seed=9)
    grads = {}
    for where in ("cpu", cuda):
        a = torch.from_numpy(xg).to(where).requires_grad_()
        w = torch.from_numpy(w_h).to(where).requires_grad_()
        b = torch.from_numpy(b_h).to(where).requires_grad_()
        ys = K.gru_recurrence(a, w, b, reverse=True)
        grads[str(where)] = [g.cpu() for g in torch.autograd.grad(
            ys, (a, w, b), torch.from_numpy(dy).to(where))] + [ys.cpu()]
    for c, g in zip(grads["cpu"], grads[str(cuda)]):
        assert float((c - g).abs().max()) <= 2e-3 * max(
            1.0, float(c.abs().max()))


# Both directions through the packed form, each held as the single form is
# (the backward K7b from the packed launch's stash); the listener's width
# among the shapes, H=16 and 200 padded to 80 and 240.
PACKED_SHAPES = [(37, 3, 200), (5, 2, 16), (400, 16, 1280)]
PACKED_FAULT_SHAPES = [FAULT_SHAPE, (400, 16, 1280)]


def _packed_run(cuda, shape, dt, ref_w_scale=1.0, **fault):
    """One packed launch over two directions of seeded inputs; per
    direction the errors of ``_held``."""
    fw = _card_inputs(cuda, shape, dt)
    bw = _card_inputs(cuda, shape, dt, seed=sum(shape) + 100)
    before = (K.FWD_LAUNCHES, K.FWD_PACKED_LAUNCHES, K.FWD_SINGLE_LAUNCHES)
    ys_f, ys_b, hgs_f, hgs_b = K._launch_fwd_pair(
        fw[0], bw[0], fw[1], bw[1], fw[2], bw[2], True, "packed")
    assert (K.FWD_LAUNCHES, K.FWD_PACKED_LAUNCHES, K.FWD_SINGLE_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2])
    return [_held(*a, rev, ys, hgs, ref_w_scale * a[1], **fault)
            for a, rev, ys, hgs in ((fw, False, ys_f, hgs_f),
                                    (bw, True, ys_b, hgs_b))]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_form_matches_plain_on_card(cuda, shape, dt):
    for (f_full, f_early), (b_rel, b_early), stash_ok in _packed_run(
            cuda, shape, dt):
        assert f_full <= CUDA_ATOL[dt] and f_early <= EARLY_MEAN_TOL[dt]
        assert b_rel <= BWD_REL and b_early <= EARLY_MEAN_TOL[dt]
        assert stash_ok


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PACKED_FAULT_SHAPES)
@pytest.mark.parametrize("fault", ["w_h_x2", "f32_operand", "n_slot"])
def test_packed_form_vs_plain_fails_under_planted_fault(cuda, monkeypatch,
                                                        shape, fault):
    scale, kw = 1.0, {}
    if fault == "w_h_x2":
        scale = 2.0
    elif fault == "f32_operand":
        monkeypatch.setattr(K, "_h_operand", lambda h: h)
        monkeypatch.setattr(K, "_dg_operand", lambda d: d)
    else:
        kw["swap_n_slot"] = True
    for (f_full, f_early), (b_rel, b_early), _ in _packed_run(
            cuda, shape, "f32", scale, **kw):
        if fault != "n_slot":       # the swap is a fault of the backward only
            assert not (f_full <= CUDA_ATOL["f32"]
                        and f_early <= EARLY_MEAN_TOL["f32"])
        assert not (b_rel <= BWD_REL and b_early <= EARLY_MEAN_TOL["f32"])


# The packed backward: one launch over both directions from the packed
# forward's stashes, each direction held against the plain backward from its
# own stash under the single form's bounds; at the listener's width, where
# both forms pad H alike, it must give the single form's bits.
def _packed_bwd_run(cuda, shape, dt, ref_w_scale=1.0, swap=False, **fault):
    fw = _card_inputs(cuda, shape, dt)
    bw = _card_inputs(cuda, shape, dt, seed=sum(shape) + 100)
    ys_f, ys_b, hgs_f, hgs_b = K._launch_fwd_pair(
        fw[0], bw[0], fw[1], bw[1], fw[2], bw[2], True, "packed")
    ys = [ys_f.to(torch.bfloat16), ys_b.to(torch.bfloat16)]
    hgs = [hgs_f, hgs_b]
    names = ("BWD_LAUNCHES", "BWD_PACKED_LAUNCHES", "BWD_SINGLE_LAUNCHES")
    before = [getattr(K, n) for n in names]
    dx_f, dx_b, dh_f, dh_b = K._launch_bwd_pair(
        fw[0], bw[0], fw[1], bw[1], *hgs, *ys, fw[3], bw[3], "packed")
    torch.cuda.synchronize()
    assert [getattr(K, n) - b for n, b in zip(names, before)] == [1, 1, 0]
    out = []
    for d, (dx, dh, rev) in enumerate(((dx_f, dh_f, False),
                                       (dx_b, dh_b, True))):
        r = 1 - d if swap else d          # the other direction's operands
        a = (fw, bw)[r]
        rdx, rdh = K.gru_recurrence_bwd_ref(a[0], ref_w_scale * a[1], hgs[r],
                                            ys[r], a[3], rev, **fault)
        bx = _errors(dx, rdx, not rev)
        bh = _errors(dh, rdh, not rev)
        mag = rdx.float().abs().max().item()
        finite = bool(torch.isfinite(dx.float()).all()
                      and torch.isfinite(dh).all())
        out.append(((max(bx[0], bh[0]) / mag, max(bx[1], bh[1])), finite))
    if shape[2] % 80 == 0 and not fault and ref_w_scale == 1.0:
        single = K._launch_bwd_pair(fw[0], bw[0], fw[1], bw[1], *hgs, *ys,
                                    fw[3], bw[3], "single")
        assert all(torch.equal(x, y) for x, y in zip(
            (dx_f, dx_b, dh_f, dh_b), single))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_backward_matches_plain_on_card(cuda, shape, dt):
    for (b_rel, b_early), finite in _packed_bwd_run(cuda, shape, dt):
        assert b_rel <= BWD_REL and b_early <= EARLY_MEAN_TOL[dt]
        assert finite


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PACKED_FAULT_SHAPES)
@pytest.mark.parametrize("fault", ["w_h_x2", "f32_operand", "n_slot",
                                   "swap"])
def test_packed_backward_vs_plain_fails_under_planted_fault(
        cuda, monkeypatch, shape, fault):
    scale, kw = 1.0, {}
    if fault == "w_h_x2":
        scale = 2.0
    elif fault == "f32_operand":
        monkeypatch.setattr(K, "_dg_operand", lambda d: d)
    elif fault == "n_slot":
        kw["swap_n_slot"] = True
    for (b_rel, b_early), _ in _packed_bwd_run(
            cuda, shape, "f32", scale, swap=fault == "swap", **kw):
        assert not (b_rel <= BWD_REL and b_early <= EARLY_MEAN_TOL["f32"])


@pytest.mark.cuda
def test_bidirectional_backward_takes_the_rules_form_on_card(cuda):
    """H=1280 both directions: one packed backward launch; H=1296, above
    the packed form's grid: two single launches."""
    names = ("BWD_LAUNCHES", "BWD_PACKED_LAUNCHES", "BWD_SINGLE_LAUNCHES")
    for hidden, packed, single in ((1280, 1, 0), (1296, 0, 2)):
        fw = _card_inputs(cuda, (3, 2, hidden), "bf16")
        bw = _card_inputs(cuda, (3, 2, hidden), "bf16", seed=1)
        ys_f, ys_b, hgs_f, hgs_b = K.gru_fwd_pair(
            fw[0], bw[0], fw[1], bw[1], fw[2], bw[2], stash=True)
        ys_f, ys_b = ys_f.to(torch.bfloat16), ys_b.to(torch.bfloat16)
        before = [getattr(K, n) for n in names]
        out = K.gru_bwd_pair(fw[0], bw[0], fw[1], bw[1], hgs_f, hgs_b, ys_f,
                             ys_b, fw[3], bw[3])
        assert [getattr(K, n) - b for n, b in zip(names, before)] == [
            packed + single, packed, single]
        ref = K.gru_recurrence_bwd_ref(bw[0], bw[1], hgs_b, ys_b, bw[3], True)
        assert float((out[1].float() - ref[0].float()).abs().max()) <= (
            BWD_REL * float(ref[0].float().abs().max()))


@pytest.mark.cuda
def test_bidirectional_entry_takes_the_rules_form_on_card(cuda):
    """H=1280 both directions: one packed launch; H=1296, above the packed
    form's grid: two single launches."""
    for hidden, packed, single in ((1280, 1, 0), (1296, 0, 2)):
        fw = _card_inputs(cuda, (3, 2, hidden), "bf16")
        bw = _card_inputs(cuda, (3, 2, hidden), "bf16", seed=1)
        before = (K.FWD_LAUNCHES, K.FWD_PACKED_LAUNCHES,
                  K.FWD_SINGLE_LAUNCHES)
        ys_f, ys_b = K.gru_fwd_pair(fw[0], bw[0], fw[1], bw[1], fw[2], bw[2])
        assert (K.FWD_LAUNCHES - before[0], K.FWD_PACKED_LAUNCHES - before[1],
                K.FWD_SINGLE_LAUNCHES - before[2]) == (packed + single,
                                                       packed, single)
        ref = K.gru_recurrence_ref(bw[0], bw[1], bw[2], True)
        assert float((ys_b.float() - ref.float()).abs().max()) <= CUDA_ATOL[
            "bf16"]


@pytest.mark.cuda
def test_bidirectional_autograd_on_card_matches_cpu(cuda):
    fw, bw = _inputs(12, 4, 64, seed=9), _inputs(12, 4, 64, seed=10)
    grads = {}
    for where in ("cpu", cuda):
        leaves = [torch.from_numpy(a[i]).to(where).requires_grad_()
                  for i in (0, 1, 2) for a in (fw, bw)]
        xf, xb, wf, wb, bf, bb = leaves
        ys = K.bigru_recurrence(xf, xb, wf, wb, bf, bb)
        grads[str(where)] = [g.cpu() for g in torch.autograd.grad(
            ys, leaves, tuple(torch.from_numpy(a[3]).to(where)
                              for a in (fw, bw)))] + [y.cpu() for y in ys]
    for c, g in zip(grads["cpu"], grads[str(cuda)]):
        assert float((c - g).abs().max()) <= 2e-3 * max(
            1.0, float(c.abs().max()))


# ------------------------------------------------- above the kernels' limit
# H=1808 is the first size the GRU kernel does not take on an H100, H=2128
# the light GRU's: the layer then runs as a plain loop under autograd.
ABOVE = {"GRU": 1808, "liGRU": 2128}


def _layer_above(module, where, reverse):
    """One direction of a layer just above its kernel's limit, T=3, B=2, on
    seeded weights and inputs."""
    from e2e_asr_pytorch_tpu_torch.ops import rnn as R
    hidden = ABOVE[module]
    gen = torch.Generator().manual_seed(3)
    init = R.gru_init if module == "GRU" else R.ligru_init
    params = {k: v.to(where) for k, v in init(gen, 8, hidden).items()}
    x = torch.randn(3, 2, 8, generator=gen).to(where)
    if module == "GRU":
        return R.gru_direction(params, x, reverse, torch.float32, True)
    return R.ligru_layer(params, x, reverse=reverse, time_major=True)[0]


@pytest.mark.parametrize("module", sorted(ABOVE))
def test_layer_above_the_limit_is_the_plain_loop(module, recwarn):
    """On CPU tensors the layer above the limit is the f32 loop (w_h is not
    rounded to bf16 there, as in the JAX package's scan) and says nothing."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import ligru as KL
    counts = (K.FWD_LAUNCHES, KL.FWD_LAUNCHES)
    ys = _layer_above(module, "cpu", False)
    assert tuple(ys.shape) == (3, 2, ABOVE[module]) and ys.dtype == torch.float32
    assert bool(torch.isfinite(ys).all()) and float(ys.abs().max()) > 0
    assert not [w for w in recwarn.list
                if issubclass(w.category, RuntimeWarning)]
    assert counts == (K.FWD_LAUNCHES, KL.FWD_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("module", sorted(ABOVE))
def test_layer_above_the_limit_on_card_warns_and_matches_cpu(cuda, module,
                                                             reverse):
    """On the card the same layer launches no kernel, warns that it lost it,
    and agrees with the CPU loop to f32 sum order; the wrapper itself
    refuses that H."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import ligru as KL
    counts = (K.FWD_LAUNCHES, KL.FWD_LAUNCHES)
    with pytest.warns(RuntimeWarning, match="plain loop"):
        ys = _layer_above(module, cuda, reverse)
    assert counts == (K.FWD_LAUNCHES, KL.FWD_LAUNCHES)
    ref = _layer_above(module, "cpu", reverse)
    assert float((ys.cpu() - ref).abs().max()) <= 1e-4 * max(
        1.0, float(ref.abs().max()))
    hidden = ABOVE[module]
    gates = 3 if module == "GRU" else 2
    xg = torch.zeros(3, 2, gates * hidden, device=cuda)
    w_h = torch.zeros(hidden, gates * hidden, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        if module == "GRU":
            K.gru_recurrence(xg, w_h, torch.zeros(3 * hidden, device=cuda))
        else:
            KL.ligru_recurrence(xg, w_h, torch.ones(2, hidden, device=cuda))
