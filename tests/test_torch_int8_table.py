"""Port of the int8 attention value table (quantization, and the K3/K4
reductions) against the JAX package, whose Pallas kernels run in interpret
mode here, and the CUDA K3/K4 against their plain PyTorch versions (those
skip without a card).

Tolerances: ``quantize_table`` is exact (same f32 math, round half to
even). The reductions take the same bf16 small operand times int8 values,
products exact in f32, so kernel and plain version differ only by the order
of the f32 sums: max |err| <= 1e-5 * max |ref| (observed ~1e-7 on the card at
T=400, D=2560). An unrounded f32 small operand moves the result by ~1e-3 of
its range, so it is caught.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.ops.pallas import int8_table as JQ
from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q

REL = 1e-5
SHAPES = [(3, 37, 50), (8, 32, 128), (5, 17, 48)]


@pytest.fixture
def jax_kernel(monkeypatch):
    monkeypatch.setattr(JQ, "INTERPRET", True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    return torch.device("cuda")


def _case(b, t, d, seed):
    rng = np.random.default_rng(seed)
    values = np.tanh(1.2 * rng.standard_normal((b, t, d))).astype(np.float32)
    values[0, 1] = 0.0                       # an all-zero row: the 1e-8 floor
    logits = rng.standard_normal((b, t))
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    dctx = (0.1 * rng.standard_normal((b, d))).astype(np.float32)
    return values, attn.astype(np.float32), dctx


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_table_is_exact(shape):
    values, _, _ = _case(*shape, seed=sum(shape))
    jq, js = JQ.quantize_table(jnp.asarray(values))
    tq, ts = Q.quantize_table(torch.from_numpy(values))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    jd = JQ.dequantize_table(jq, js)
    td = Q.dequantize_table(tq, ts)
    np.testing.assert_array_equal(np.asarray(jd.astype(jnp.float32)),
                                  td.float().numpy())


def _reductions_both(shape, scale=1.0):
    """(rel err of context, rel err of d_attn): the port's plain versions
    against the JAX kernels in interpret mode; the port's small operands
    scaled by ``scale`` (a planted fault)."""
    values, attn, dctx = _case(*shape, seed=sum(shape))
    jq, js = JQ.quantize_table(jnp.asarray(values))
    a2 = np.array(jnp.asarray(attn) * js)
    j_ctx = JQ.context_int8(jnp.asarray(a2), jq)
    j_dat = JQ.dattn_int8(jnp.asarray(dctx), jq)
    tq = torch.from_numpy(np.array(jq))
    t_ctx = Q.context_int8(scale * torch.from_numpy(a2), tq)
    t_dat = Q.dattn_int8(scale * torch.from_numpy(dctx), tq)
    assert tuple(t_ctx.shape) == j_ctx.shape
    assert tuple(t_dat.shape) == j_dat.shape
    return _rel(t_ctx.numpy(), j_ctx), _rel(t_dat.numpy(), j_dat)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_reductions_match_jax_kernels(jax_kernel, shape):
    assert max(_reductions_both(shape)) <= REL


def test_plain_reductions_vs_jax_fail_under_doubled_operand(jax_kernel):
    rc, rd = _reductions_both(SHAPES[0], scale=2.0)
    assert rc > 100 * REL and rd > 100 * REL, (rc, rd)


def test_cpu_tensors_take_the_plain_version():
    values, attn, dctx = _case(2, 9, 16, seed=0)
    q, s = Q.quantize_table(torch.from_numpy(values))
    before = (Q.CTX_LAUNCHES, Q.DATTN_LAUNCHES)
    a2 = torch.from_numpy(attn) * s
    assert torch.equal(Q.context_int8(a2, q), Q.context_int8_ref(a2, q))
    g = torch.from_numpy(dctx)
    assert torch.equal(Q.dattn_int8(g, q), Q.dattn_int8_ref(g, q))
    assert (Q.CTX_LAUNCHES, Q.DATTN_LAUNCHES) == before


@pytest.mark.parametrize("bad", ["q_dtype", "small_shape"])
def test_wrappers_refuse_bad_operands(bad):
    values, attn, dctx = _case(2, 9, 16, seed=0)
    q, s = Q.quantize_table(torch.from_numpy(values))
    a2, g = torch.from_numpy(attn) * s, torch.from_numpy(dctx)
    if bad == "q_dtype":
        q = q.float()
    else:
        a2, g = a2[:, :3], g[:1]
    with pytest.raises((ValueError, TypeError)):
        Q.context_int8(a2, q)
    with pytest.raises((ValueError, TypeError)):
        Q.dattn_int8(g, q)


# ---------------------------------------------------------------- on a card
CARD_SHAPES = [(16, 400, 2560), (16, 200, 2560), (3, 37, 50), (5, 17, 48)]


def _card_case(cuda, shape):
    values, attn, dctx = _case(*shape, seed=sum(shape))
    q, s = Q.quantize_table(torch.from_numpy(values).to(cuda))
    return torch.from_numpy(attn).to(cuda) * s, q, \
        torch.from_numpy(dctx).to(cuda)


def _card_rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_plain_on_card(cuda, shape):
    a2, q, g = _card_case(cuda, shape)
    before = (Q.CTX_LAUNCHES, Q.DATTN_LAUNCHES)
    ctx, dat = Q.context_int8(a2, q), Q.dattn_int8(g, q)
    torch.cuda.synchronize()
    assert (Q.CTX_LAUNCHES, Q.DATTN_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)
    assert _card_rel(ctx, Q.context_int8_ref(a2, q)) <= REL
    assert _card_rel(dat, Q.dattn_int8_ref(g, q)) <= REL


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["q_x2", "f32_operand"])
def test_kernels_vs_plain_fail_under_planted_fault(cuda, fault):
    a2, q, g = _card_case(cuda, CARD_SHAPES[0])
    ctx, dat = Q.context_int8(a2, q), Q.dattn_int8(g, q)
    if fault == "q_x2":
        qf = q.float() * 2
        ref_ctx = torch.einsum("bt,btd->bd", Q._small_operand(a2), qf)
        ref_dat = torch.einsum("bd,btd->bt", Q._small_operand(g), qf)
    else:
        ref_ctx = torch.einsum("bt,btd->bd", a2, q.float())
        ref_dat = torch.einsum("bd,btd->bt", g, q.float())
    assert _card_rel(ctx, ref_ctx) > REL
    assert _card_rel(dat, ref_dat) > REL
