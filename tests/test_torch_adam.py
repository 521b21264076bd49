"""Adam's update of every leaf at once (``ops/kernels/adam.py``,
``csrc/adam.cu``).

On the CPU: the chunk planner covers every element of every leaf once with
no chunk crossing a leaf, the launches are cut at the table's rows, the
wrapper's checks refuse what the kernel does not take, and ``Adam.step`` /
``AdamW.step`` off the card run the per-leaf chain and launch nothing.

On the card (``-m cuda``): the kernel gives the bits of the per-leaf chain
it replaces (the optimizer frame's ``_update`` with ``Adam._leaf``) on
every p, mu and nu, at the 4x LSTM-2048 LM's 13 leaves and at odd sizes,
with f32 and bf16 state, the clip active and not; a non-finite gradient
leaves everything as it was; two launches from one state give the same
bits; ``ADAM_LAUNCHES`` counts one launch a step (per table of leaves).
"""

import math

import pytest
import torch

from e2e_asr_pytorch_tpu_torch.ops.kernels import adam as A
from e2e_asr_pytorch_tpu_torch.train import optim as TO

# config/librispeech_lm_best.yaml: the tied 31 x 2048 embedding and four
# LSTM-2048 layers (w_x, w_h, b)
LM_BEST = [(31, 2048)] + [(2048, 8192), (2048, 8192), (8192,)] * 4
# models/apc.py at its defaults' widths (3x LSTM-512 over 80 mels, the
# 80-wide output projection)
APC = [(80, 2048), (512, 2048), (2048,), (512, 2048), (512, 2048), (2048,),
       (512, 2048), (512, 2048), (2048,), (512, 80), (80,)]
ODD = [(1,), (3,), (4097,), (10,), (4096,), (0,), (2, 3, 5)]
MANY = [(7 * k + 1,) for k in range(150)]


def _numel(shape):
    return math.prod(shape)


def _chunks(numels, chunk):
    """(leaf, offset, length) of every chunk, in order, as the kernel reads
    the planner's table."""
    ends = A.plan_chunks(numels, chunk)
    out, leaf = [], 0
    for c in range(ends[-1] if ends else 0):
        while c >= ends[leaf]:
            leaf += 1
        off = (c - (ends[leaf - 1] if leaf else 0)) * chunk
        out.append((leaf, off, min(chunk, numels[leaf] - off)))
    return out


SHAPE_LISTS = {"lm_best": LM_BEST, "apc": APC, "odd": ODD, "many": MANY}


@pytest.mark.parametrize("name,chunk", [
    (name, chunk) for name in SHAPE_LISTS
    for chunk in (A.CHUNK, 65536) + ((12,) if name != "lm_best" else ())])
def test_chunks_cover_every_element_once(name, chunk):
    shapes = SHAPE_LISTS[name]
    numels = [_numel(s) for s in shapes]
    ends = A.plan_chunks(numels, chunk)
    assert len(ends) == len(numels) and ends == sorted(ends)
    seen = [[0] * n for n in numels] if sum(numels) < 10 ** 5 else None
    covered = [0] * len(numels)
    last = {}
    for c, (leaf, off, length) in enumerate(_chunks(numels, chunk)):
        # in order, inside its leaf, chunk-aligned, never empty
        assert 0 < length <= chunk and off % chunk == 0
        assert off + length <= numels[leaf]
        assert (ends[leaf - 1] if leaf else 0) <= c < ends[leaf]
        assert last.get(leaf, -chunk) + chunk == off
        last[leaf] = off
        covered[leaf] += length
        if seen is not None:
            for i in range(off, off + length):
                seen[leaf][i] += 1
    assert covered == numels
    if seen is not None:
        assert all(x == 1 for row in seen for x in row)


def _leaf(shape, p=torch.float32, s=torch.float32):
    return (torch.zeros(shape, dtype=p), torch.zeros(shape, dtype=p),
            torch.zeros(shape, dtype=s), torch.zeros(shape, dtype=s))


def test_launch_groups_cut_at_the_tables_rows():
    leaves = ([_leaf((3,)), _leaf((0,))]
              + [_leaf((2,)) for _ in range(A.MAX_LEAVES + 1)])
    assert A.launch_groups(leaves) == [
        [0] + list(range(2, A.MAX_LEAVES + 1)),
        [A.MAX_LEAVES + 1, A.MAX_LEAVES + 2]]
    assert A.launch_groups(leaves[:A.MAX_LEAVES]) == [
        [0] + list(range(2, A.MAX_LEAVES))]
    assert A.launch_groups([_leaf((0,))]) == []


def _scalars(dev="cpu", gnorm=2.0, clip=True):
    return A.Scalars(torch.tensor(gnorm, device=dev), torch.tensor(True,
                                                                   device=dev),
                     torch.tensor(clip, device=dev),
                     torch.tensor(-1e-3, device=dev),
                     torch.tensor(0.1, device=dev),
                     torch.tensor(0.001, device=dev))


def test_check_accepts_what_the_kernel_takes():
    # a gradient of another layout is read through a contiguous copy
    p, _, mu, nu = _leaf((4, 6))
    A.check([_leaf((4, 3)), _leaf((5,)), (p, torch.zeros(6, 4).t(), mu, nu)],
            _scalars())
    bf16 = torch.bfloat16
    A.check([_leaf((4, 3), s=bf16), _leaf((5,), s=bf16)], _scalars())


@pytest.mark.parametrize("fault", [
    "p_not_contiguous", "mu_not_contiguous", "nu_not_contiguous",
    "g_dtype", "nu_dtype", "half_state", "double_params", "bf16_params",
    "state_mixed_across_leaves", "leaf_on_another_device", "shape",
    "ok_float", "gnorm_not_0dim", "step_size_double"])
def test_check_raises(fault):
    p, g, mu, nu = _leaf((6, 4))
    s = _scalars()
    if fault == "p_not_contiguous":
        p = torch.zeros(4, 6).t()
    elif fault == "nu_not_contiguous":
        nu = torch.zeros(6, 8)[:, ::2]
    elif fault == "mu_not_contiguous":
        mu = torch.zeros(4, 6).t()
    elif fault == "g_dtype":
        g = g.bfloat16()
    elif fault == "nu_dtype":
        nu = nu.bfloat16()
    elif fault == "half_state":
        mu, nu = mu.half(), nu.half()
    elif fault == "double_params":
        p, g = p.double(), g.double()
    elif fault == "bf16_params":
        p, g = p.bfloat16(), g.bfloat16()
    elif fault == "state_mixed_across_leaves":
        mu, nu = mu.bfloat16(), nu.bfloat16()
    elif fault == "leaf_on_another_device":
        g = torch.zeros(6, 4, device="meta")
    elif fault == "shape":
        nu = torch.zeros(24)
    elif fault == "ok_float":
        s = s._replace(ok=torch.tensor(1.0))
    elif fault == "gnorm_not_0dim":
        s = s._replace(gnorm=torch.ones(1))
    elif fault == "step_size_double":
        s = s._replace(step_size=torch.tensor(-1e-3, dtype=torch.float64))
    with pytest.raises((TypeError, ValueError)):
        A.check([_leaf((3,)), (p, g, mu, nu)], s)


def test_adam_update_raises_off_the_card():
    with pytest.raises(ValueError):
        A.adam_update([_leaf((3,))], _scalars(), 1.0, 1e-8)


class ChainAdam(TO.Adam):
    """Adam on the per-leaf chain the kernel replaces, on any device."""

    _update = TO._Optimizer._update


class ChainAdamW(TO.AdamW):
    _update = TO._Optimizer._update


def _optimizers(rule, clip, state):
    kw = dict(lr=3e-3, eps=1e-6, lr_scheduler="warmup",
              grad_clip=1.0 if clip else 1e6, optim_state_dtype=state)
    if rule == "AdamW":
        return (TO.AdamW(weight_decay=0.1, **kw),
                ChainAdamW(weight_decay=0.1, **kw))
    return TO.Adam(**kw), ChainAdam(**kw)


def _tree(shapes, dev, seed, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    return {"l{}".format(i): (scale * torch.randn(s, generator=gen)).to(dev)
            for i, s in enumerate(shapes)}


def _steps(opt, params, shapes, dev, n, nan_at=None):
    state = opt.init(params)
    for step in range(n):
        grads = _tree(shapes, dev, 100 + step, 3.0)
        if step == nan_at:
            grads["l0"].view(-1)[0] = float("nan")
        opt.step(params, grads, state)
    return params, state


def _same(a, b):
    la, lb = TO.tree_leaves(a), TO.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


CPU_SHAPES = [(31, 20), (20, 80), (80,), (1,), (3,), (4097,), (10,)]


@pytest.mark.parametrize("rule", ["Adam", "AdamW"])
@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
@pytest.mark.parametrize("state", [None, "bfloat16"], ids=["f32", "bf16"])
def test_step_on_cpu_runs_the_per_leaf_chain(rule, clip, state,
                                             monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the kernel's wrapper was called off the card")
    monkeypatch.setattr(A, "adam_update", refuse)
    new, _ = _optimizers(rule, clip, state)
    before = A.ADAM_LAUNCHES
    start = _tree(CPU_SHAPES, "cpu", 0)
    params, st = _steps(new, _tree(CPU_SHAPES, "cpu", 0), CPU_SHAPES,
                        "cpu", 3, nan_at=1)
    assert A.ADAM_LAUNCHES == before and int(st["count"]) == 2
    assert all(not torch.equal(a, b) and bool(torch.isfinite(b).all())
               for a, b in zip(TO.tree_leaves(start),
                               TO.tree_leaves(params)))


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _card_leaves(shapes, dev, state, seed, offset=0):
    """(p, g, mu, nu) of each shape on the card, made on the CPU from the
    seed; ``offset`` > 0 puts every leaf at that many elements into a
    larger buffer (an address no vector load takes)."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for shape in shapes:
        n = _numel(shape)

        def make(x, dtype):
            buf = torch.empty(n + offset, dtype=dtype, device=dev)
            leaf = buf[offset:].view(shape)
            leaf.copy_(x.to(dtype))
            return leaf
        p = make(torch.randn(shape, generator=gen), torch.float32)
        g = make(3.0 * torch.randn(shape, generator=gen), torch.float32)
        mu = make(0.1 * torch.randn(shape, generator=gen), state)
        nu = make(torch.rand(shape, generator=gen), state)
        out.append((p, g, mu, nu))
    return out


def _card_scalars(leaves, dev, grad_clip, ok=True):
    gnorm = TO.global_norm([g for _, g, _, _ in leaves])
    if not ok:
        gnorm = gnorm * float("inf")
    n = torch.tensor(3.0, device=dev)
    return A.Scalars(gnorm, torch.isfinite(gnorm), gnorm >= grad_clip,
                     -torch.tensor(1e-4, device=dev),
                     1.0 - torch.pow(torch.tensor(A.ADAM_B1, device=dev), n),
                     1.0 - torch.pow(torch.tensor(A.ADAM_B2, device=dev), n))


def _copy(leaves):
    return [tuple(x.clone() for x in leaf) for leaf in leaves]


def _chain(leaves, s, grad_clip, eps, decay=None):
    """The per-leaf chain the kernel replaces over ``leaves``, in place: the
    optimizer frame's ``_update`` with Adam's (AdamW's) ``_leaf``."""
    opt = (TO.Adam(eps=eps, grad_clip=grad_clip) if decay is None else
           TO.AdamW(eps=eps, grad_clip=grad_clip, weight_decay=decay))
    ps, gs, mus, nus = (list(x) for x in zip(*leaves))
    TO._Optimizer._update(opt, ps, gs, [mus, nus], s.gnorm, s.ok,
                          s.clip_active, s.step_size,
                          {"corr1": s.corr1, "corr2": s.corr2})


CARD_CASES = {"lm_best": LM_BEST, "odd": ODD + [(31, 2048), (5, 7)]}


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", sorted(CARD_CASES))
@pytest.mark.parametrize("state", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
@pytest.mark.parametrize("decay", [None, 0.1], ids=["adam", "adamw"])
def test_kernel_gives_the_per_leaf_chains_bits_on_card(cuda, shapes, state,
                                                        clip, decay):
    leaves = _card_leaves(CARD_CASES[shapes], cuda, state, 1)
    plain = _copy(leaves)
    s = _card_scalars(leaves, cuda, 1.0 if clip else 1e9)
    assert bool(s.clip_active) == clip
    before = A.ADAM_LAUNCHES
    A.adam_update(leaves, s, 1.0 if clip else 1e9, 1e-8, decay)
    assert A.ADAM_LAUNCHES == before + 1
    _chain(plain, s, 1.0 if clip else 1e9, 1e-8, decay)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(leaves, plain)):
        for name, x, y in zip(("p", "g", "mu", "nu"), a, b):
            assert torch.equal(x, y), (shapes, i, name)


@pytest.mark.cuda
def test_unaligned_leaves_give_the_per_leaf_chains_bits_on_card(cuda):
    leaves = _card_leaves(ODD + [(31, 2048)], cuda, torch.float32, 2,
                          offset=1)
    plain = _copy(leaves)
    s = _card_scalars(leaves, cuda, 1.0)
    A.adam_update(leaves, s, 1.0, 1e-8)
    _chain(plain, s, 1.0, 1e-8)
    for a, b in zip(leaves, plain):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_a_transposed_gradient_gives_the_chains_bits_on_card(cuda):
    """The tied embedding's gradient comes from autograd in the transposed
    layout; the kernel reads it through a contiguous copy."""
    leaves = _card_leaves([(31, 2048), (8192,)], cuda, torch.float32, 5)
    p, g, mu, nu = leaves[0]
    leaves[0] = (p, g.t().contiguous().t(), mu, nu)
    assert not leaves[0][1].is_contiguous()
    plain = _copy(leaves)
    s = _card_scalars(leaves, cuda, 1.0)
    A.adam_update(leaves, s, 1.0, 1e-8)
    _chain(plain, s, 1.0, 1e-8)
    for a, b in zip(leaves, plain):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_a_non_finite_norm_leaves_everything_on_card(cuda):
    leaves = _card_leaves(LM_BEST[:4] + ODD, cuda, torch.float32, 3)
    before = _copy(leaves)
    A.adam_update(leaves, _card_scalars(leaves, cuda, 1.0, ok=False), 1.0,
                  1e-8)
    for a, b in zip(leaves, before):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("state", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_two_launches_from_one_state_give_the_same_bits_on_card(cuda, state):
    leaves = _card_leaves(LM_BEST, cuda, state, 4)
    again = _copy(leaves)
    s = _card_scalars(leaves, cuda, 1.0)
    A.adam_update(leaves, s, 1.0, 1e-8)
    A.adam_update(again, s, 1.0, 1e-8)
    for a, b in zip(leaves, again):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["Adam", "AdamW"])
@pytest.mark.parametrize("state", [None, "bfloat16"], ids=["f32", "bf16"])
def test_step_on_card_gives_the_per_leaf_chains_bits(cuda, rule, state):
    """Three steps of the optimizer (the clip active, the second step's
    gradient not finite) against the chain it replaced, on the card; one
    launch a step."""
    shapes = CPU_SHAPES + LM_BEST[:4]
    new, old = _optimizers(rule, True, state)
    before = A.ADAM_LAUNCHES
    p_new, s_new = _steps(new, _tree(shapes, cuda, 0), shapes, cuda, 3,
                          nan_at=1)
    assert A.ADAM_LAUNCHES == before + 3
    p_old, s_old = _steps(old, _tree(shapes, cuda, 0), shapes, cuda, 3,
                          nan_at=1)
    assert A.ADAM_LAUNCHES == before + 3
    assert _same(p_new, p_old) and _same(s_new, s_old)
    assert int(s_new["count"]) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("state", [None, "bfloat16"], ids=["f32", "bf16"])
def test_one_launch_a_step_per_table_of_leaves_on_card(cuda, state):
    opt = TO.Adam(lr=1e-3, optim_state_dtype=state)
    for n, launches in ((3, 1), (A.MAX_LEAVES, 1), (A.MAX_LEAVES + 3, 2)):
        params = {"w{}".format(i): torch.randn(5 + i, device=cuda)
                  for i in range(n)}
        st = opt.init(params)
        before = A.ADAM_LAUNCHES
        for _ in range(2):
            opt.step(params, {k: torch.randn_like(v)
                              for k, v in params.items()}, st)
        assert A.ADAM_LAUNCHES == before + 2 * launches
