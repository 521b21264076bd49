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
# the last: T and D multiples of neither the kernels' parts nor 16
SHAPES = [(3, 37, 50), (8, 32, 128), (5, 17, 48), (3, 41, 80)]


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


# ------------------------------------------------------- the kernels' grid
H100_SMS = 132
GRID_SHAPES = [(16, 400, 2560), (16, 333, 2576), (16, 240, 2560),
               (3, 37, 50), (5, 17, 48), (3, 41, 80), (1, 1, 1),
               (200, 7, 16), (2, 3000, 9000)]


def _check_grid(grid, b, n):
    """``grid`` cuts n chunks or rows into parts that cover [0, n) exactly,
    none empty, in one wave of blocks where the batch rows leave a choice,
    each block within THREADS threads."""
    ranges = [(i * grid.size, min((i + 1) * grid.size, n))
              for i in range(grid.parts)]
    assert grid.parts >= 1 and len(ranges) == grid.parts
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(hi == lo for (_, hi), (lo, _) in zip(ranges, ranges[1:]))
    assert all(lo < hi for lo, hi in ranges)
    assert grid.parts * b <= max(H100_SMS, b)
    assert 1 <= grid.lanes <= Q.LANES and grid.groups >= 1
    assert grid.lanes * grid.groups <= Q.THREADS


@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_ctx_grid_is_valid(shape):
    """K3: D-slices of whole chunks, a lane a chunk of the slice."""
    b, t, d = shape
    grid = Q.ctx_grid(b, t, d, H100_SMS)
    _check_grid(grid, b, -(-d // Q.VEC))
    assert grid.lanes == min(grid.size, Q.LANES)


@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_dattn_grid_is_valid(shape):
    """K4: t-ranges, the lanes whole warps over D's chunks."""
    b, t, d = shape
    grid = Q.dattn_grid(b, t, d, H100_SMS)
    _check_grid(grid, b, t)
    assert grid.lanes % 32 == 0
    assert grid.lanes >= min(-(-d // Q.VEC), Q.LANES)


def test_grids_fill_the_card():
    """At the flagship's (16, 400, 2560): 128 equal blocks on 132 SMs,
    K3 8 slices of 20 chunks (500 threads), K4 8 t-ranges of 50 rows
    (480 threads)."""
    assert Q.ctx_grid(16, 400, 2560, H100_SMS) == (8, 20, 20, 25)
    assert Q.dattn_grid(16, 400, 2560, H100_SMS) == (8, 50, 160, 3)


# ---------------------------------------------------------------- on a card
# (16, 333, 2576): T and D multiples of neither K4's t-ranges, K3's D-slices
# nor a 512-wide slice; (16, 240, 2560): a training batch of chip_smoke.py's
# phase 5
# (2, 64, 5000): K4's lanes in two passes over D, read byte by byte;
# (140, 3, 4208): more batch rows than SMs, K3's one slice in two passes
CARD_SHAPES = [(16, 400, 2560), (16, 200, 2560), (3, 37, 50), (5, 17, 48),
               (16, 333, 2576), (16, 240, 2560), (3, 41, 80), (2, 64, 5000),
               (140, 3, 4208)]
RAGGED_SHAPE = CARD_SHAPES[4]


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


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["context_int8", "dattn_int8"])
def test_kernel_vs_plain_fails_without_an_edge(cuda, kernel):
    """The plain version without the table's last t row (K3) or its last D
    column (K4), the edges of the kernels' t-ranges and column passes."""
    a2, q, g = _card_case(cuda, CARD_SHAPES[0])
    if kernel == "context_int8":
        got = Q.context_int8(a2, q)
        bad = Q.context_int8_ref(a2[:, :-1], q[:, :-1])
    else:
        got = Q.dattn_int8(g, q)
        bad = Q.dattn_int8_ref(g[:, :-1], q[:, :, :-1])
    assert _card_rel(got, bad) > REL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [CARD_SHAPES[0], RAGGED_SHAPE])
def test_kernels_give_the_same_bits_twice(cuda, shape):
    a2, q, g = _card_case(cuda, shape)
    assert torch.equal(Q.context_int8(a2, q), Q.context_int8(a2, q))
    assert torch.equal(Q.dattn_int8(g, q), Q.dattn_int8(g, q))


@pytest.mark.cuda
def test_unaligned_table_takes_the_bytewise_path(cuda):
    """A contiguous table whose base is not 16-byte aligned (a view one byte
    into its storage) is read byte by byte, to the same results."""
    a2, q, g = _card_case(cuda, RAGGED_SHAPE)
    store = torch.empty(q.numel() + 1, dtype=torch.int8, device=cuda)
    shifted = store[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    assert _card_rel(Q.context_int8(a2, shifted),
                     Q.context_int8_ref(a2, q)) <= REL
    assert _card_rel(Q.dattn_int8(g, shifted), Q.dattn_int8_ref(g, q)) <= REL
