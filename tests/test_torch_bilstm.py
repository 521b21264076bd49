"""Port of the direction-packed BLSTM recurrence (K1) against the JAX
package's Pallas kernel run in interpret mode, and the CUDA kernel against
its plain PyTorch version (those skip without a card).

Tolerances: f32 streams atol 1e-5 (the plain version takes the same bf16
products as the kernel, exact in f32; only the f32 summation order differs),
bf16 streams atol 1e-2 (a couple of bf16 ulps at |h| <= 1).
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
ATOL = {"f32": 1e-5, "bf16": 1e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def jax_kernel(monkeypatch):
    """Route the JAX package through its Pallas K1 in interpret mode."""
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
    return xg_f, xg_b, wh_f, wh_b


def _max_errs(jax_outs, torch_outs):
    return [float(np.max(np.abs(np.asarray(j.astype(jnp.float32))
                                - t.float().numpy())))
            for j, t in zip(jax_outs, torch_outs)]


def _run_both(shape, dt, wh_scale=1.0):
    jd, td = DTYPES[dt]
    xg_f, xg_b, wh_f, wh_b = _inputs(*shape, seed=sum(shape))
    jax_outs = PL._bilstm_fwd_pallas(jnp.asarray(xg_f, jd),
                                     jnp.asarray(xg_b, jd),
                                     jnp.asarray(wh_f), jnp.asarray(wh_b))
    port = K.bilstm_recurrence(torch.from_numpy(xg_f).to(td),
                               torch.from_numpy(xg_b).to(td),
                               torch.from_numpy(wh_f * wh_scale),
                               torch.from_numpy(wh_b), stash=True)
    return _max_errs(jax_outs, port)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernel(jax_kernel, shape, dt):
    errs = _run_both(shape, dt)
    # ys_f, ys_b in the stream dtype; cs/gates stashes are bf16 on both sides
    assert max(errs[:2]) <= ATOL[dt], errs
    assert max(errs[2:]) <= 1e-2, errs


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_vs_jax_fails_under_doubled_w_h(jax_kernel, shape):
    errs = _run_both(shape, "f32", wh_scale=2.0)
    assert errs[0] > 100 * ATOL["f32"], errs


def _layer_params(d, h, seed):
    rng = np.random.default_rng(seed)
    def one():
        return {"w_x": (rng.standard_normal((d, 4 * h)) / np.sqrt(d)
                        ).astype(np.float32),
                "w_h": (rng.standard_normal((h, 4 * h)) / np.sqrt(h)
                        ).astype(np.float32),
                "b": (0.1 * rng.standard_normal(4 * h)).astype(np.float32)}
    return one(), one()


def _layer_both(time_major, wh_scale=1.0):
    """The port's time-major layer against JAX's, with JAX taking x in
    either of its layouts."""
    fw, bw = _layer_params(12, 16, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((7, 2, 12)).astype(np.float32)        # T,B,D
    jx = x if time_major else x.transpose(1, 0, 2)
    jy = JR.bilstm_layer(jax.tree.map(jnp.asarray, fw),
                         jax.tree.map(jnp.asarray, bw), jnp.asarray(jx),
                         time_major=time_major)
    jy = np.asarray(jy)
    if not time_major:
        jy = jy.transpose(1, 0, 2)
    tfw = {k: torch.from_numpy(v) for k, v in fw.items()}
    tfw["w_h"] = tfw["w_h"] * wh_scale
    tbw = {k: torch.from_numpy(v) for k, v in bw.items()}
    ty = TR.bilstm_layer(tfw, tbw, torch.from_numpy(x))
    assert ty.shape == jy.shape
    return float(np.max(np.abs(jy - ty.numpy())))


@pytest.mark.parametrize("time_major", [False, True])
def test_bilstm_layer_matches_jax(jax_kernel, time_major):
    assert _layer_both(time_major) <= ATOL["f32"]


def test_bilstm_layer_fails_under_doubled_w_h(jax_kernel):
    assert _layer_both(True, wh_scale=2.0) > 100 * ATOL["f32"]


def test_cpu_tensors_take_the_plain_version():
    before = K.LAUNCHES
    xg_f, xg_b, wh_f, wh_b = (torch.from_numpy(a)
                              for a in _inputs(5, 2, 8, seed=0))
    ys_f, ys_b = K.bilstm_recurrence(xg_f, xg_b, wh_f, wh_b)
    assert K.LAUNCHES == before
    ref = K.bilstm_recurrence_ref(xg_f, xg_b, wh_f, wh_b)
    assert torch.equal(ys_f, ref[0]) and torch.equal(ys_b, ref[1])


@pytest.mark.parametrize("bad", ["xg_shape", "w_shape", "dtype"])
def test_wrapper_refuses_bad_operands(bad):
    xg_f, xg_b, wh_f, wh_b = (torch.from_numpy(a)
                              for a in _inputs(5, 2, 8, seed=0))
    if bad == "xg_shape":
        xg_b = xg_b[:, :1]
    elif bad == "w_shape":
        wh_b = wh_b[:4]
    else:
        xg_f, xg_b = xg_f.double(), xg_b.double()
    with pytest.raises((ValueError, TypeError)):
        K.bilstm_recurrence(xg_f, xg_b, wh_f, wh_b)


# ---------------------------------------------------------------- on a card
# f32 streams: sums run in another order, and a flipped rounding of bf16(h)
# feeds back through the recurrence, so the bound is a fraction of one bf16
# ulp of h (2e-3) rather than f32 noise; bf16 streams: 1.6e-2 (~4 bf16 ulps
# at |h| <= 1). bf16 stashes: one bf16 ulp of the value plus that bound.
CUDA_ATOL = {"f32": 2e-3, "bf16": 1.6e-2}
# Before the first flip of a bf16(h) rounding the two agree to f32 noise, so
# the mean |err| of ys over each direction's first EARLY_STEPS steps holds
# the precision contract that the whole-sequence bound cannot: a plain
# version fed f32 h instead of bf16(h) reads ~4e-5 there, a sound kernel
# ~1e-8.
EARLY_STEPS = 4
EARLY_MEAN_TOL = 1e-6
FAULT_SHAPE = (320, 8, 1280)


def _card_inputs(cuda, shape, dt):
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(*shape, seed=sum(shape))]
    args[0], args[1] = args[0].to(DTYPES[dt][1]), args[1].to(DTYPES[dt][1])
    return args


def _ys_errors(out, ref):
    """(max |err| of ys over the sequence, mean |err| of ys over each
    direction's first EARLY_STEPS steps)."""
    t = out[0].shape[0]
    k = min(EARLY_STEPS, t)
    d_f = (out[0].float() - ref[0].float()).abs()
    d_b = (out[1].float() - ref[1].float()).abs()
    early = torch.cat([d_f[:k].flatten(), d_b[t - k:].flatten()]).mean()
    return max(d_f.max().item(), d_b.max().item()), early.item()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(37, 3, 200), (5, 2, 4), (64, 8, 256)])
def test_kernel_matches_plain_on_card(cuda, shape, dt):
    args = _card_inputs(cuda, shape, dt)
    before = K.LAUNCHES
    out = K.bilstm_recurrence(*args, stash=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    ref = K.bilstm_recurrence_ref(*args, stash=True)
    assert all(o.dtype == DTYPES[dt][1] for o in out[:2])
    full, early = _ys_errors(out, ref)
    assert full <= CUDA_ATOL[dt] and early <= EARLY_MEAN_TOL, (full, early)
    for o, r in zip(out[2:], ref[2:]):
        bound = CUDA_ATOL[dt] + r.float().abs() * 2.0 ** -7
        assert ((o.float() - r.float()).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("fault", ["w_h_x2", "f32_h"])
def test_kernel_vs_plain_fails_under_planted_fault(cuda, monkeypatch, fault,
                                                   dt):
    args = _card_inputs(cuda, FAULT_SHAPE, dt)
    out = K.bilstm_recurrence(*args)
    if fault == "w_h_x2":
        args[2] = args[2] * 2
    else:
        monkeypatch.setattr(K, "_h_operand", lambda h: h)
    full, early = _ys_errors(out, K.bilstm_recurrence_ref(*args))
    assert full > CUDA_ATOL[dt] or early > EARLY_MEAN_TOL, (full, early)
