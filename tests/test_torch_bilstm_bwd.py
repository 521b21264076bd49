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
