"""Port of the BLSTM backward (K2) and its autograd Function against the JAX
package's custom_vjp ``bilstm_recurrence`` (Pallas K1/K2 in interpret
mode), and the CUDA K2 against its plain PyTorch version (those skip without
a card).

Tolerances, CPU parity (both sides take bf16(dgates) @ bf16(w_h)^T with f32
sums, only the summation order differs):
  * ys: as the forward, atol 1e-5 (f32 streams) / 1e-2 (bf16 streams);
  * dxg (bf16 on both sides): max |err| <= 2^-7 * max |dxg|, one bf16 ulp
    at the top of the range (a flipped rounding may feed back);
  * dW_h: max |err| <= 1e-3 * max |dW_h| (f32 sums of the same bf16
    products, in another order, over bf16 values that may differ by a flip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.ops import rnn as JR
from e2e_asr_pytorch_tpu.ops.pallas import lstm as PL
from e2e_asr_pytorch_tpu_torch.ops import rnn as TR
from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K

SHAPES = [(11, 3, 8), (9, 2, 40)]
YS_ATOL = {"f32": 1e-5, "bf16": 1e-2}
DXG_REL = 2.0 ** -7
DWH_REL = 1e-3
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
NAMES = ("ys_f", "ys_b", "dxg_f", "dxg_b", "dwh_f", "dwh_b")


@pytest.fixture
def jax_kernel(monkeypatch):
    """Route the JAX package through its Pallas K1/K2 in interpret mode."""
    monkeypatch.setenv("E2E_ASR_PALLAS", "force")
    monkeypatch.setattr(PL, "INTERPRET", True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    return torch.device("cuda")


def _inputs(t, b, h, seed):
    rng = np.random.default_rng(seed)
    xg_f = rng.standard_normal((t, b, 4 * h)).astype(np.float32)
    xg_b = rng.standard_normal((t, b, 4 * h)).astype(np.float32)
    wh_f = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    wh_b = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    dy_f = rng.standard_normal((t, b, h)).astype(np.float32)
    dy_b = rng.standard_normal((t, b, h)).astype(np.float32)
    return (xg_f, xg_b, wh_f, wh_b), (dy_f, dy_b)


def _vjp_both(shape, dt, wh_scale=1.0):
    """{name: (max |err|, max |JAX value|)} of the outputs and the four
    cotangents, the port's w_h_f scaled by ``wh_scale``."""
    jd, td = DTYPES[dt]
    (xg_f, xg_b, wh_f, wh_b), (dy_f, dy_b) = _inputs(*shape, seed=sum(shape))
    jys, vjp = jax.vjp(PL.bilstm_recurrence, jnp.asarray(xg_f, jd),
                       jnp.asarray(xg_b, jd), jnp.asarray(wh_f),
                       jnp.asarray(wh_b))
    jg = vjp((jnp.asarray(dy_f, jd), jnp.asarray(dy_b, jd)))
    args = [torch.from_numpy(xg_f).to(td).requires_grad_(),
            torch.from_numpy(xg_b).to(td).requires_grad_(),
            torch.from_numpy(wh_f * wh_scale).requires_grad_(),
            torch.from_numpy(wh_b).requires_grad_()]
    tys = K.BiLSTMRecurrence.apply(*args)
    tg = torch.autograd.grad(tys, args, grad_outputs=(
        torch.from_numpy(dy_f).to(td), torch.from_numpy(dy_b).to(td)))
    for g, a in zip(tg, args):
        assert g.dtype == a.dtype and g.shape == a.shape
    out = {}
    for name, j, t in zip(NAMES, list(jys) + list(jg),
                          [y.detach() for y in tys] + list(tg)):
        j = np.asarray(j.astype(jnp.float32))
        out[name] = (float(np.max(np.abs(j - t.float().numpy()))),
                     float(np.max(np.abs(j))))
    return out


def _sound(errs, dt):
    ys = all(errs[n][0] <= YS_ATOL[dt] for n in ("ys_f", "ys_b"))
    dxg = all(errs[n][0] <= DXG_REL * errs[n][1] for n in ("dxg_f", "dxg_b"))
    dwh = all(errs[n][0] <= DWH_REL * errs[n][1] for n in ("dwh_f", "dwh_b"))
    return ys and dxg and dwh


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_function_matches_jax_custom_vjp(jax_kernel, shape, dt):
    errs = _vjp_both(shape, dt)
    assert _sound(errs, dt), errs


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_function_vs_jax_fails_under_doubled_w_h(jax_kernel, dt):
    errs = _vjp_both(SHAPES[1], dt, wh_scale=2.0)
    assert not _sound(errs, dt), errs
    # the backward alone is caught too, not only the forward
    assert errs["dxg_f"][0] > DXG_REL * errs["dxg_f"][1], errs


def _layer_grads_both(wh_scale=1.0):
    """Gradients of <bilstm_layer(x), ct> with respect to x and every
    parameter of both directions: dW_x, db and dx come from autograd
    through the input matmuls, dW_h from the Function."""
    rng = np.random.default_rng(5)
    d, h = 12, 16

    def one():
        return {"w_x": (rng.standard_normal((d, 4 * h)) / np.sqrt(d)
                        ).astype(np.float32),
                "w_h": (rng.standard_normal((h, 4 * h)) / np.sqrt(h)
                        ).astype(np.float32),
                "b": (0.1 * rng.standard_normal(4 * h)).astype(np.float32)}
    fw, bw = one(), one()
    x = rng.standard_normal((7, 2, d)).astype(np.float32)          # T,B,D
    ct = rng.standard_normal((7, 2, 2 * h)).astype(np.float32)

    def jloss(fw_, bw_, x_):
        y = JR.bilstm_layer(fw_, bw_, x_, time_major=True)
        return jnp.sum(y * ct)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, fw), jax.tree.map(jnp.asarray, bw),
        jnp.asarray(x))
    tfw = {k: torch.from_numpy(v).requires_grad_() for k, v in fw.items()}
    tbw = {k: torch.from_numpy(v).requires_grad_() for k, v in bw.items()}
    tx = torch.from_numpy(x).requires_grad_()
    fw_used = dict(tfw, w_h=tfw["w_h"] * wh_scale)
    y = TR.bilstm_layer(fw_used, tbw, tx)
    leaves = [tfw[k] for k in sorted(fw)] + [tbw[k] for k in sorted(bw)]
    tg = torch.autograd.grad((y * torch.from_numpy(ct)).sum(),
                             leaves + [tx])
    jl = [jg[0][k] for k in sorted(fw)] + [jg[1][k] for k in sorted(bw)]
    return max(float(np.max(np.abs(np.asarray(j) - t.numpy())))
               / max(float(np.max(np.abs(np.asarray(j)))), 1e-30)
               for j, t in zip(jl + [jg[2]], tg))


def test_bilstm_layer_grads_match_jax(jax_kernel):
    # f32 streams: every leaf within 1e-3 of its largest entry
    assert _layer_grads_both() <= 1e-3


def test_bilstm_layer_grads_fail_under_doubled_w_h(jax_kernel):
    assert _layer_grads_both(wh_scale=2.0) > 1e-1


def test_no_grad_takes_the_plain_recurrence():
    """Without a gradient the layer skips the Function (no stashes kept)."""
    (xg_f, xg_b, wh_f, wh_b), _ = _inputs(5, 2, 8, seed=0)
    args = [torch.from_numpy(a) for a in (xg_f, xg_b, wh_f, wh_b)]
    with torch.no_grad():
        out = K.bilstm_recurrence(*args)
    with torch.enable_grad():
        got = K.BiLSTMRecurrence.apply(*(a.requires_grad_() for a in args))
    assert all(torch.equal(o, g.detach()) for o, g in zip(out, got))


@pytest.mark.parametrize("bad", ["stash_dtype", "dy_shape", "w_shape"])
def test_bwd_wrapper_refuses_bad_operands(bad):
    (xg_f, xg_b, wh_f, wh_b), (dy_f, dy_b) = _inputs(5, 2, 8, seed=0)
    args = [torch.from_numpy(a) for a in (xg_f, xg_b, wh_f, wh_b)]
    _, _, cs_f, cs_b, g_f, g_b = K.bilstm_recurrence(*args, stash=True)
    wf, wb = args[2], args[3]
    dyf, dyb = torch.from_numpy(dy_f), torch.from_numpy(dy_b)
    if bad == "stash_dtype":
        g_f = g_f.float()
    elif bad == "dy_shape":
        dyb = dyb[:, :1]
    else:
        wb = wb[:4]
    with pytest.raises((ValueError, TypeError)):
        K.bilstm_recurrence_bwd(wf, wb, cs_f, cs_b, g_f, g_b, dyf, dyb)


# ---------------------------------------------------------------- on a card
# Kernel vs plain version, both from the same stashes: sums run in another
# order, and a flipped rounding of bf16(dgates) feeds back through dh, so
# the whole-sequence bound is a bf16 ulp at the top of dxg's range:
# max |err| <= 2^-6 * max |dxg|. Before the first flip the two agree to f32
# noise, so the mean |err| of dxg over each direction's first EARLY_STEPS
# backward steps (data T-4..T-1 forward, 0..3 backward) must stay under
# EARLY_MEAN_TOL: that holds the bf16(dgates) contract, which a plain
# version fed f32 dgates breaks there.
CUDA_DXG_REL = 2.0 ** -6
EARLY_STEPS = 4
EARLY_MEAN_TOL = 1e-6
FAULT_SHAPE = (320, 16, 1280)


def _card_case(cuda, shape, dt):
    td = DTYPES[dt][1]
    (xg_f, xg_b, wh_f, wh_b), (dy_f, dy_b) = _inputs(*shape, seed=sum(shape))
    xf, xb = (torch.from_numpy(a).to(cuda, td) for a in (xg_f, xg_b))
    wf, wb = (torch.from_numpy(a).to(cuda) for a in (wh_f, wh_b))
    _, _, cs_f, cs_b, g_f, g_b = K.bilstm_recurrence(xf, xb, wf, wb,
                                                     stash=True)
    dyf, dyb = (torch.from_numpy(a).to(cuda, td) for a in (dy_f, dy_b))
    return [wf, wb, cs_f, cs_b, g_f, g_b, dyf, dyb]


def dxg_errors(out, ref):
    """(max |err| / max |ref| over the sequence, mean |err| over each
    direction's first EARLY_STEPS backward steps)."""
    t = out[0].shape[0]
    k = min(EARLY_STEPS, t)
    d_f = (out[0].float() - ref[0].float()).abs()
    d_b = (out[1].float() - ref[1].float()).abs()
    mag = max(ref[0].float().abs().max().item(),
              ref[1].float().abs().max().item())
    early = torch.cat([d_f[t - k:].flatten(), d_b[:k].flatten()]).mean()
    return max(d_f.max().item(), d_b.max().item()) / mag, early.item()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(37, 3, 200), (5, 2, 4), (64, 16, 256)])
def test_bwd_kernel_matches_plain_on_card(cuda, shape, dt):
    args = _card_case(cuda, shape, dt)
    before = K.BWD_LAUNCHES
    out = K.bilstm_recurrence_bwd(*args)
    torch.cuda.synchronize()
    assert K.BWD_LAUNCHES == before + 1
    assert all(o.dtype == torch.bfloat16 for o in out)
    rel, early = dxg_errors(out, K.bilstm_recurrence_bwd_ref(*args))
    assert rel <= CUDA_DXG_REL and early <= EARLY_MEAN_TOL, (rel, early)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("fault", ["w_h_x2", "f32_dgates"])
def test_bwd_kernel_vs_plain_fails_under_planted_fault(cuda, monkeypatch,
                                                       fault, dt):
    args = _card_case(cuda, FAULT_SHAPE, dt)
    out = K.bilstm_recurrence_bwd(*args)
    if fault == "w_h_x2":
        args[0] = args[0] * 2
    else:
        monkeypatch.setattr(K, "_dg_operand", lambda d: d)
    rel, early = dxg_errors(out, K.bilstm_recurrence_bwd_ref(*args))
    assert rel > CUDA_DXG_REL or early > EARLY_MEAN_TOL, (rel, early)


@pytest.mark.cuda
def test_function_on_card_matches_cpu(cuda):
    """The whole Function (K1 with stashes, K2, dW_h) on the card against
    the same Function on the CPU (plain versions), f32 streams."""
    (xg_f, xg_b, wh_f, wh_b), (dy_f, dy_b) = _inputs(48, 16, 128, seed=1)
    res = {}
    for dev in ("cpu", cuda):
        args = [torch.from_numpy(a).to(dev).requires_grad_()
                for a in (xg_f, xg_b, wh_f, wh_b)]
        ys = K.BiLSTMRecurrence.apply(*args)
        g = torch.autograd.grad(ys, args, grad_outputs=tuple(
            torch.from_numpy(a).to(dev) for a in (dy_f, dy_b)))
        res[str(dev)] = [x.detach().cpu().float() for x in list(ys) + list(g)]
    for a, b in zip(res["cpu"], res[str(cuda)]):
        assert (a - b).abs().max().item() <= 2.0 ** -6 * a.abs().max().item()


# ------------------------------------------------ K2's forms, without a card
# Which form K2 takes is the forward's rule with K2's own slab (20 rows of
# w_h, 4H wide): both limits agree with K1's on an H100.
@pytest.mark.parametrize("hidden,form", [(16, "resident"), (200, "resident"),
                                         (1280, "resident"),
                                         (1296, "streamed"),
                                         (2112, "streamed")])
def test_bwd_form_rule_on_an_h100(hidden, form):
    """H=1280: 128 blocks of 230,464 bytes (the slab 205,120, the ring
    25,344); H=1296 runs as 1360, whose 136 tiles outnumber the SMs; the
    rule is K1's at every width."""
    assert K.form_for(hidden, backward=True) == form
    assert K.form_for(hidden) == form
    assert K.resident_bwd_smem_bytes(1280) == 230464
    assert ((K.resident_bwd_smem_bytes(hidden) <= 232448
             and 2 * (K._padded(hidden) // K.TILE_UNITS) <= 132)
            == (form == "resident"))


def test_bwd_form_rule_follows_the_card(monkeypatch):
    """Fewer SMs than tiles, or less shared memory than the slab and ring,
    send H=1280 to the streamed form; a card with 960 bytes less than K1's
    block needs still holds K2's."""
    monkeypatch.setattr(K, "_card", lambda device=None: (64, 232448))
    assert K.form_for(1280, backward=True) == "streamed"
    assert K.form_for(640, backward=True) == "resident"
    monkeypatch.setattr(K, "_card", lambda device=None: (132, 166912))
    assert K.form_for(1280, backward=True) == "streamed"
    assert K.form_for(800, backward=True) == "resident"
    monkeypatch.setattr(K, "_card", lambda device=None: (132, 230464))
    assert K.form_for(1280, backward=True) == "resident"
    assert K.form_for(1280) == "streamed"


@pytest.mark.parametrize("form,hidden", [("resident", 1296),
                                         ("resident", 2112),
                                         ("packed", 1280)])
def test_bwd_form_is_refused_where_it_cannot_run(form, hidden):
    assert K._resolve_form(None, 1280, backward=True) == "resident"
    assert K._resolve_form("streamed", 1280, backward=True) == "streamed"
    assert K._resolve_form(None, 1296, backward=True) == "streamed"
    with pytest.raises(ValueError, match="K2|form must be"):
        K._resolve_form(form, hidden, backward=True)


def test_bwd_cpu_tensors_take_the_plain_version_whatever_the_form():
    (xg_f, xg_b, wh_f, wh_b), (dy_f, dy_b) = _inputs(5, 2, 8, seed=3)
    args = [torch.from_numpy(a) for a in (xg_f, xg_b, wh_f, wh_b)]
    _, _, cs_f, cs_b, g_f, g_b = K.bilstm_recurrence(*args, stash=True)
    ops = [args[2], args[3], cs_f, cs_b, g_f, g_b, torch.from_numpy(dy_f),
           torch.from_numpy(dy_b)]
    before = (K.BWD_LAUNCHES, K.BWD_RESIDENT_LAUNCHES,
              K.BWD_STREAMED_LAUNCHES)
    ref = K.bilstm_recurrence_bwd_ref(*ops)
    for form in (None, "resident", "streamed"):
        out = K.bilstm_recurrence_bwd(*ops, form=form)
        assert all(torch.equal(o, r) for o, r in zip(out, ref))
    assert before == (K.BWD_LAUNCHES, K.BWD_RESIDENT_LAUNCHES,
                      K.BWD_STREAMED_LAUNCHES)


def test_bwd_padding_keeps_the_result():
    """H=200 runs as 240 in the resident form: the plain K2 on the operands
    the wrapper pads gives the real units' dxg within a bf16 ulp at the top
    of the range (the padded products add zeros, but the f32 sums may run
    in another order) and exact zeros for the padded units."""
    (xg_f, xg_b, wh_f, wh_b), (dy_f, dy_b) = _inputs(6, 3, 200, seed=4)
    args = [torch.from_numpy(a) for a in (xg_f, xg_b, wh_f, wh_b)]
    _, _, cs_f, cs_b, g_f, g_b = K.bilstm_recurrence(*args, stash=True)
    ops = [args[2], args[3], cs_f, cs_b, g_f, g_b, torch.from_numpy(dy_f),
           torch.from_numpy(dy_b)]
    ref = K.bilstm_recurrence_bwd_ref(*ops)
    hp = K._padded(200)
    assert hp == 240
    padded = K.pad_bwd_operands(hp, *ops)
    assert all(x.is_contiguous() for x in padded)
    assert padded[0].dtype == torch.bfloat16
    assert tuple(padded[0].shape) == (240, 960)
    out = K.bilstm_recurrence_bwd_ref(*padded)
    for o, r in zip(out, ref):
        err = (K._unpad_units(o, 200, hp, 4).float() - r.float()).abs()
        assert float(err.max()) <= DXG_REL * float(r.float().abs().max())
        pad = o.reshape(*o.shape[:-1], 4, hp)[..., 200:]
        assert float(pad.float().abs().max()) == 0.0


# dW_h = sum_t h_prev[t]^T dxg[t] as one bf16 product with f32 sums, against
# the JAX package's einsum of the same bf16 operands with
# preferred_element_type=float32: only the order of the f32 sums differs
# (max |err| <= 1e-6 * max |dW_h|); the shift of the wrong direction is
# caught.
DWH_EXACT_REL = 1e-6


def _dwh_both(backward, shift_as=None):
    rng = np.random.default_rng(7 + backward)
    t, b, h = 9, 3, 24
    ys = rng.standard_normal((t, b, h)).astype(np.float32)
    dxg = rng.standard_normal((t, b, 4 * h)).astype(np.float32)
    jys = jnp.asarray(ys, jnp.bfloat16)
    zero = jnp.zeros((1, b, h), jnp.bfloat16)
    yp = (jnp.concatenate([jys[1:], zero], 0) if backward
          else jnp.concatenate([zero, jys[:-1]], 0))
    jd = jnp.einsum("tbh,tbk->hk", yp, jnp.asarray(dxg, jnp.bfloat16),
                    preferred_element_type=jnp.float32)
    tys = torch.from_numpy(ys).to(torch.bfloat16)
    tdxg = torch.from_numpy(dxg).to(torch.bfloat16)
    td = K._dwh(tys, tdxg, backward if shift_as is None else shift_as)
    assert td.dtype == torch.float32 and tuple(td.shape) == (h, 4 * h)
    j = np.asarray(jd)
    return float(np.max(np.abs(j - td.numpy())) / np.max(np.abs(j)))


@pytest.mark.parametrize("backward", [False, True])
def test_dwh_matches_jax_einsum(backward):
    assert _dwh_both(backward) <= DWH_EXACT_REL


@pytest.mark.parametrize("backward", [False, True])
def test_dwh_vs_jax_fails_under_the_other_direction_s_shift(backward):
    assert _dwh_both(backward, shift_as=not backward) > 1e-2


# ---------------------------------------- K2's two forms and dW_h on a card
BWD_FORM_SHAPES = [(24, 16, 1280), (37, 3, 200), (12, 40, 160), (9, 2, 20),
                   (5, 2, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["resident", "streamed"])
@pytest.mark.parametrize("shape", BWD_FORM_SHAPES)
def test_bwd_forms_match_plain_on_card(cuda, shape, form, dt):
    args = _card_case(cuda, shape, dt)
    before = (K.BWD_LAUNCHES, K.BWD_RESIDENT_LAUNCHES,
              K.BWD_STREAMED_LAUNCHES)
    out = K.bilstm_recurrence_bwd(*args, form=form)
    torch.cuda.synchronize()
    res = form == "resident"
    assert (K.BWD_LAUNCHES, K.BWD_RESIDENT_LAUNCHES,
            K.BWD_STREAMED_LAUNCHES) == (before[0] + 1, before[1] + res,
                                         before[2] + (not res))
    rel, early = dxg_errors(out, K.bilstm_recurrence_bwd_ref(*args))
    assert rel <= CUDA_DXG_REL and early <= EARLY_MEAN_TOL, (rel, early)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["resident", "streamed"])
@pytest.mark.parametrize("fault", ["w_h_x2", "f32_dgates"])
def test_bwd_forms_vs_plain_fail_under_planted_fault(cuda, monkeypatch, form,
                                                     fault):
    args = _card_case(cuda, FAULT_SHAPE, "f32")
    out = K.bilstm_recurrence_bwd(*args, form=form)
    if fault == "w_h_x2":
        args[0] = args[0] * 2
    else:
        monkeypatch.setattr(K, "_dg_operand", lambda d: d)
    rel, early = dxg_errors(out, K.bilstm_recurrence_bwd_ref(*args))
    assert rel > CUDA_DXG_REL or early > EARLY_MEAN_TOL, (rel, early)


@pytest.mark.cuda
def test_rule_sends_1296_to_the_streamed_bwd_form_on_card(cuda):
    args = _card_case(cuda, (12, 16, 1296), "bf16")
    before = K.BWD_STREAMED_LAUNCHES
    out = K.bilstm_recurrence_bwd(*args)
    torch.cuda.synchronize()
    assert K.BWD_STREAMED_LAUNCHES == before + 1
    rel, early = dxg_errors(out, K.bilstm_recurrence_bwd_ref(*args))
    assert rel <= CUDA_DXG_REL and early <= EARLY_MEAN_TOL
    with pytest.raises(ValueError):
        K.bilstm_recurrence_bwd(*args, form="resident")


@pytest.mark.cuda
def test_dwh_on_card_matches_cpu(cuda):
    """The card's bf16 product with f32 output against the CPU's f32
    product of the widened operands: the same sums, another order."""
    rng = np.random.default_rng(11)
    ys = torch.from_numpy(rng.standard_normal((400, 16, 1280))
                          .astype(np.float32)).to(torch.bfloat16)
    dxg = torch.from_numpy(rng.standard_normal((400, 16, 5120))
                           .astype(np.float32)).to(torch.bfloat16)
    for backward in (False, True):
        cpu = K._dwh(ys, dxg, backward)
        card = K._dwh(ys.to(cuda), dxg.to(cuda), backward).cpu()
        assert float((cpu - card).abs().max()) <= 1e-5 * float(
            cpu.abs().max())
