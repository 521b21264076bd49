"""Port of the folded teacher-forced decoder and its hand-written backward
(``FoldedDecoder``) against the JAX ``folded_decoder`` custom_vjp: both
outputs and all 18 cotangents, for 'loc' and 'dot' attention, a bf16 or int8
value table (the JAX int8 kernels in interpret mode), and the d_key
accumulator in f32 or bf16.

Every leaf is compared as max |err| / max |JAX leaf|:
  * f32 compute: 1e-5 (the same f32 math summed in other orders);
  * bf16 compute, 'loc': 1e-2 (both sides sum the bf16 products in f32,
    ``preferred_element_type=float32`` in JAX, ``mm_f32`` here; XLA
    evaluates a chain of bf16 elementwise ops in f32 and rounds once where
    torch rounds after each, which moves the energy-MLP cotangents; 5e-2
    before the F9 repair, when the port rounded each product to bf16);
  * bf16 compute, 'dot': 1e-6 (no bf16 elementwise chain: f32 sum order
    alone).
d_b_e is the sum of the softmax cotangent, zero up to rounding on both
sides, so it is held absolutely: |err| <= 1e-3 * max |d_w_e|.

The captured scans (``_Scans``) are held to the eager loops bit for bit:
on the CPU with the capture replaced by a stand-in that re-runs the loop
into the captured outputs (the graphs' static-buffer contract: fixed
addresses in, fixed addresses out), so the keys, the warm-up, the holds,
the fallbacks and the clones are exercised; on the card (``cuda``) with
real CUDA graphs at the flagship decoder's widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.models import fold_vjp as JF
from e2e_asr_pytorch_tpu.ops.pallas import int8_table as JQ
from e2e_asr_pytorch_tpu_torch.models import fold_vjp as TF

NAMES = ("xg_emb", "values", "w_ctx", "key", "band", "neg_bias", "prev0",
         "h0", "c0", "w_q", "b_q", "w_lp", "w_e", "b_e", "w_h1", "w_x2", "b2",
         "w_h2")
CAST = ("xg_emb", "values", "key", "band")    # passed in the compute dtype
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
REL = {"f32": 1e-5, "bf16": 1e-2}
DOT_BF16_REL = 1e-6
BE_REL = 1e-3


@pytest.fixture
def jax_kernel(monkeypatch):
    monkeypatch.setattr(JQ, "INTERPRET", True)


def _inputs(mode, seed=0, L=5, B=3, Te=11, H=8, De=12, D=6, Kn=2):
    r = np.random.default_rng(seed)

    def n(*s, sc=1.0):
        return (sc * r.standard_normal(s)).astype(np.float32)
    lens = np.array([Te, Te - 3, Te - 5])[:B]
    valid = np.arange(Te)[None] < lens[:, None]
    a = dict(xg_emb=n(L, B, 4 * H, sc=0.5), values=np.tanh(n(B, Te, De)),
             w_ctx=n(De, 4 * H, sc=0.3), key=np.tanh(n(B, Te, D)),
             band=n(Te, Te * Kn, sc=0.5),
             neg_bias=np.where(valid, 0.0, -1e30).astype(np.float32),
             prev0=(valid / lens[:, None]).astype(np.float32),
             h0=n(2, B, H, sc=0.3), c0=n(2, B, H, sc=0.3),
             w_q=n(2 * H, D, sc=0.4), b_q=n(D, sc=0.1), w_lp=n(Kn, D, sc=0.5),
             w_e=n(D, 1, sc=0.5), b_e=n(1, sc=0.1), w_h1=n(H, 4 * H, sc=0.35),
             w_x2=n(H, 4 * H, sc=0.35), b2=n(4 * H, sc=0.1),
             w_h2=n(H, 4 * H, sc=0.35))
    if mode == "dot":
        for k in ("band", "w_lp", "w_e", "b_e"):
            a[k] = None
    return a, (n(L, B, H), n(L, B, Te))


def _both(mode, table, dkey_bf16, dt, fault=None):
    """{leaf: (max |err|, max |JAX leaf|)} over the outputs (feats, attn) and
    the cotangents; ``fault`` doubles that input on the port's side."""
    jd, td = DTYPES[dt]
    a, cts = _inputs(mode)
    jargs = [None if a[k] is None else
             jnp.asarray(a[k], jd if k in CAST else jnp.float32)
             for k in NAMES]
    cfg = JF.FoldCfg(mode, 0.5, jd, table, dkey_bf16)
    jout, vjp = jax.vjp(lambda *x: JF.folded_decoder(cfg, *x), *jargs)
    jg = vjp(tuple(jnp.asarray(c, jd) for c in cts))
    targs = [None if a[k] is None else
             torch.from_numpy(a[k] * (2.0 if k == fault else 1.0)).to(
                 td if k in CAST else torch.float32).requires_grad_()
             for k in NAMES]
    tout = TF.folded_decoder(TF.FoldCfg(mode, 0.5, td, table, dkey_bf16),
                             *targs)
    assert all(o.dtype == td for o in tout)
    live = [x for x in targs if x is not None]
    tg = iter(torch.autograd.grad(tout, live, grad_outputs=tuple(
        torch.from_numpy(c).to(td) for c in cts)))
    res = {}
    for name, j, t in zip(("feats", "attn"), jout, tout):
        res[name] = (j, t.detach())
    for name, j, x in zip(NAMES, jg, targs):
        if x is None:
            assert j is None, name
            continue
        t = next(tg)
        # every cotangent comes back in its input's dtype
        assert t.dtype == x.dtype and t.shape == x.shape, name
        res["d_" + name] = (j, t)
    out = {}
    for name, (j, t) in res.items():
        j = np.asarray(j.astype(jnp.float32), np.float64)
        t = t.float().numpy().astype(np.float64)
        out[name] = (float(np.max(np.abs(j - t))), float(np.max(np.abs(j))))
    return out


def _bad_leaves(errs, dt, mode=None):
    rel = DOT_BF16_REL if (dt, mode) == ("bf16", "dot") else REL[dt]
    bad = []
    for name, (err, mag) in errs.items():
        if name == "d_b_e":
            ok = err <= BE_REL * errs["d_w_e"][1]
        elif name == "d_neg_bias":
            ok = err == 0.0
        else:
            ok = err <= rel * mag
        if not ok:
            bad.append(name)
    return bad


CASES = [(m, v, k, dt) for m in ("loc", "dot") for v in ("bf16", "int8")
         for k in (False, True) for dt in ("f32", "bf16")]


@pytest.mark.parametrize("mode,table,dkey_bf16,dt", CASES)
def test_folded_decoder_matches_jax_vjp(jax_kernel, mode, table, dkey_bf16,
                                        dt):
    errs = _both(mode, table, dkey_bf16, dt)
    assert not _bad_leaves(errs, dt, mode), errs


@pytest.mark.parametrize("mode,fault", [("loc", "w_h1"), ("loc", "w_e"),
                                        ("dot", "w_q")])
def test_folded_decoder_vs_jax_fails_under_planted_fault(jax_kernel, mode,
                                                         fault):
    errs = _both(mode, "int8", True, "f32", fault=fault)
    assert _bad_leaves(errs, "f32"), errs


def test_int8_table_goes_through_the_reductions(monkeypatch):
    """In int8 mode each forward step calls context_int8 and each backward
    step dattn_int8 once (the K3/K4 wrappers), and nothing else reads the
    values table per step."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q
    calls = {"ctx": 0, "dattn": 0}
    ctx_fn, dattn_fn = Q.context_int8, Q.dattn_int8

    def ctx(*a):
        calls["ctx"] += 1
        return ctx_fn(*a)

    def dattn(*a):
        calls["dattn"] += 1
        return dattn_fn(*a)
    monkeypatch.setattr(Q, "context_int8", ctx)
    monkeypatch.setattr(Q, "dattn_int8", dattn)
    a, cts = _inputs("loc", L=4)
    args = [None if a[k] is None else torch.from_numpy(a[k]).requires_grad_()
            for k in NAMES]
    out = TF.folded_decoder(TF.FoldCfg("loc", 0.5, torch.float32, "int8"),
                            *args)
    assert calls == {"ctx": 4, "dattn": 0}
    torch.autograd.grad(out, [x for x in args if x is not None],
                        grad_outputs=tuple(torch.from_numpy(c) for c in cts))
    assert calls == {"ctx": 4, "dattn": 4}


# ------------------------------------------------------------ captured scans
COUNTERS = ("FWD_CAPTURES", "FWD_REPLAYS", "FWD_EAGER", "BWD_CAPTURES",
            "BWD_REPLAYS", "BWD_EAGER")


@pytest.fixture
def fresh(monkeypatch):
    """No keys and every counter at zero, restored afterwards."""
    monkeypatch.setattr(TF, "_KEYS", {})
    for name in COUNTERS:
        monkeypatch.setattr(TF, name, 0)


def _counts():
    return {name: getattr(TF, name) for name in COUNTERS}


def _case(mode="loc", dt=torch.float32, seed=0, dev="cpu", wide=False,
          **shape):
    """(operands, cotangents of (feats, attn)) as torch tensors; every
    operand requires grad. ``wide``: the matrices scaled by 1/sqrt(fan-in),
    so that wide layers do not saturate."""
    a, cts = _inputs(mode, seed=seed, **shape)
    for k in ("w_ctx", "w_q", "w_h1", "w_x2", "w_h2", "band", "w_lp", "w_e"):
        if wide and a[k] is not None:
            a[k] = a[k] / np.float32(np.sqrt(a[k].shape[0]))
    args = [None if a[k] is None else torch.from_numpy(a[k]).to(
        dev, dt if k in CAST else torch.float32).requires_grad_()
        for k in NAMES]
    return args, tuple(torch.from_numpy(c).to(dev, dt) for c in cts)


def _grads(cfg, args, cts, out=None):
    """[feats, attn, *18 cotangents] (None where absent) of one call, or of
    the call whose outputs are ``out``."""
    out = TF.folded_decoder(cfg, *args) if out is None else out
    live = [x for x in args if x is not None]
    g = iter(torch.autograd.grad(out, live, grad_outputs=cts))
    return [o.detach() for o in out] + [None if x is None else next(g)
                                        for x in args]


def _equal(got, want):
    """Names of the results whose bits differ."""
    names = ("feats", "attn") + tuple("d_" + n for n in NAMES)
    return [n for n, g, w in zip(names, got, want)
            if not (g is None and w is None
                    or g is not None and w is not None
                    and g.dtype == w.dtype and torch.equal(g, w))]


class _StandIn:
    """A CPU stand-in for a captured graph: ``replay`` re-runs the loop and
    copies its results into the outputs the capture returned."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        for dst, src in zip(_leaves(self.out), _leaves(self.fn())):
            dst.copy_(src)


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def _simulate(monkeypatch):
    """Route CPU calls through the scans, captures made by _StandIn; the
    counters start again from zero."""
    for name in COUNTERS:
        monkeypatch.setattr(TF, name, 0)

    def capture(fn, pool):
        out = fn()
        return out, _StandIn(fn, out)
    monkeypatch.setattr(TF, "_scans_for",
                        lambda cfg, args: TF._entry(TF.scan_key(cfg, args)))
    monkeypatch.setattr(TF, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)


SIM_CASES = [("loc", "int8", True, torch.bfloat16),
             ("loc", "bf16", False, torch.float32),
             ("dot", "int8", False, torch.bfloat16)]


def test_cpu_call_runs_eagerly_and_builds_no_graph(fresh, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a graph was built for a CPU call")
    monkeypatch.setattr(TF, "_capture", refuse)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", refuse)
    cfg = TF.FoldCfg("loc", 0.5, torch.bfloat16, "int8", True)
    args, cts = _case(dt=torch.bfloat16)
    first = _grads(cfg, args, cts)
    assert not _equal(_grads(cfg, args, cts), first)
    assert _counts() == dict.fromkeys(COUNTERS, 0) | {"FWD_EAGER": 2,
                                                      "BWD_EAGER": 2}
    assert TF._KEYS == {}


def _key(cfg, **shape):
    return TF.scan_key(cfg, _case(cfg.mode, cfg.compute_dtype, **shape)[0])


BASE = TF.FoldCfg("loc", 0.5, torch.bfloat16, "int8", True)
KEY_CHANGES = {
    "positions": (BASE, dict(L=4)), "rows": (BASE, dict(B=2)),
    "frames": (BASE, dict(Te=9)), "hidden": (BASE, dict(H=4)),
    "values width": (BASE, dict(De=8)), "filters": (BASE, dict(Kn=3)),
    "compute dtype": (BASE._replace(compute_dtype=torch.float32), {}),
    "mode": (BASE._replace(mode="dot"), {}),
    "temperature": (BASE._replace(temperature=1.0), {}),
    "value table": (BASE._replace(value_table="bf16"), {}),
    "d_key accumulator": (BASE._replace(dkey_bf16=False), {})}


@pytest.mark.parametrize("change", sorted(KEY_CHANGES))
def test_scan_key_tells_apart_what_changes_the_kernels(change):
    cfg, shape = KEY_CHANGES[change]
    assert _key(BASE) == _key(BASE, seed=1)      # the values are not in it
    assert _key(cfg, **shape) != _key(BASE)


def test_scan_key_tells_apart_an_operand_dtype():
    args = _case(dt=torch.bfloat16)[0]
    other = list(args)
    other[NAMES.index("w_q")] = args[NAMES.index("w_q")].double()
    assert TF.scan_key(BASE, other) != TF.scan_key(BASE, args)


@pytest.mark.parametrize("mode,table,dkey_bf16,dt", SIM_CASES)
def test_simulated_replays_match_the_eager_loop(fresh, monkeypatch, mode,
                                                table, dkey_bf16, dt):
    cfg = TF.FoldCfg(mode, 0.5, dt, table, dkey_bf16)
    cases = [_case(mode, dt, seed=s) for s in range(3)]
    want = [_grads(cfg, *c) for c in cases]            # eager (CPU)
    _simulate(monkeypatch)
    got = [_grads(cfg, *c) for c in cases]  # warm-up, capture, replay
    for g, w in zip(got, want):
        assert not _equal(g, w)
    # the capture's results are its own, not the buffers the replay reused
    assert not _equal(got[1], want[1])
    assert _counts() == {"FWD_CAPTURES": 1, "FWD_REPLAYS": 1,
                         "FWD_EAGER": 1, "BWD_CAPTURES": 1,
                         "BWD_REPLAYS": 1, "BWD_EAGER": 1}
    assert len(TF._KEYS) == 1


@pytest.mark.parametrize("a_first", [True, False])
def test_simulated_held_key_runs_the_second_forward_eagerly(
        fresh, monkeypatch, a_first):
    """Two forwards before their backwards: the first replays and holds the
    key, the second finds it held and runs eagerly; neither backward reads
    the other's stashes."""
    cfg = TF.FoldCfg("loc", 0.5, torch.bfloat16, "int8", True)
    cases = [_case(dt=torch.bfloat16, seed=s) for s in range(4)]
    want = [_grads(cfg, *c) for c in cases]
    _simulate(monkeypatch)
    for c in cases[:2]:                                # warm-up, capture
        _grads(cfg, *c)
    out_a = TF.folded_decoder(cfg, *cases[2][0])
    out_b = TF.folded_decoder(cfg, *cases[3][0])
    order = [(2, out_a), (3, out_b)]
    for i, out in order if a_first else order[::-1]:
        assert not _equal(_grads(cfg, *cases[i], out=out), want[i])
    assert _counts() == {"FWD_CAPTURES": 1, "FWD_REPLAYS": 1,
                         "FWD_EAGER": 2, "BWD_CAPTURES": 1,
                         "BWD_REPLAYS": 1, "BWD_EAGER": 2}


def test_simulated_forward_without_grad_holds_nothing(fresh, monkeypatch):
    cfg = TF.FoldCfg("loc", 0.5, torch.bfloat16, "int8", True)
    cases = [_case(dt=torch.bfloat16, seed=s) for s in range(3)]
    want = [_grads(cfg, *c) for c in cases]
    _simulate(monkeypatch)
    _grads(cfg, *cases[0])
    with torch.no_grad():
        feats, attn = TF.folded_decoder(cfg, *cases[1][0])
    assert torch.equal(feats, want[1][0]) and torch.equal(attn, want[1][1])
    assert all(s.held is None or s.held() is None
               for s in TF._KEYS.values())
    assert not _equal(_grads(cfg, *cases[2]), want[2])
    assert _counts() == {"FWD_CAPTURES": 1, "FWD_REPLAYS": 1,
                         "FWD_EAGER": 1, "BWD_CAPTURES": 1,
                         "BWD_REPLAYS": 0, "BWD_EAGER": 1}


def test_simulated_keys_past_the_bound_run_eagerly(fresh, monkeypatch):
    monkeypatch.setattr(TF, "MAX_KEYS", 1)
    cfg = TF.FoldCfg("loc", 0.5, torch.bfloat16, "int8", True)
    small = _case(dt=torch.bfloat16, L=3)
    big = _case(dt=torch.bfloat16)
    want_small, want_big = _grads(cfg, *small), _grads(cfg, *big)
    _simulate(monkeypatch)
    for _ in range(3):
        assert not _equal(_grads(cfg, *small), want_small)
        assert not _equal(_grads(cfg, *big), want_big)
    assert list(TF._KEYS) == [TF.scan_key(cfg, small[0])]
    assert _counts() == {"FWD_CAPTURES": 1, "FWD_REPLAYS": 1,
                         "FWD_EAGER": 4, "BWD_CAPTURES": 1,
                         "BWD_REPLAYS": 1, "BWD_EAGER": 4}


# ------------------------------------------- captured scans on the card
# the flagship decoder's widths (config/librispeech_asr_best.yaml), a few
# rows and positions
WIDE = dict(L=6, B=3, Te=40, H=1024, De=2560, D=300, Kn=10)
CARD_CASES = [("loc", "int8", True), ("loc", "bf16", False),
              ("dot", "int8", False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (captured scans vs the eager loop)")
    return torch.device("cuda")


def _eager_on_card(monkeypatch, cfg, cases):
    """Each case's results from the eager loops on the card (every key past
    a bound of 0), then the bound as it was and the counters at zero."""
    bound = TF.MAX_KEYS
    monkeypatch.setattr(TF, "MAX_KEYS", 0)
    want = [_grads(cfg, *c) for c in cases]
    monkeypatch.setattr(TF, "MAX_KEYS", bound)
    for name in COUNTERS:
        monkeypatch.setattr(TF, name, 0)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("mode,table,dkey_bf16", CARD_CASES)
def test_card_replays_match_the_eager_loop(cuda, fresh, monkeypatch, mode,
                                           table, dkey_bf16):
    """Warm-up, capture, replays: every result equal to the eager loop's bit
    for bit, read after the last call (so no result is a buffer a later
    replay rewrote); one capture a direction, K3 / K4 counted L times a
    call on every path."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q
    cfg = TF.FoldCfg(mode, 0.5, torch.bfloat16, table, dkey_bf16)
    cases = [_case(mode, torch.bfloat16, seed=s, dev=cuda, wide=True, **WIDE)
             for s in range(3)]
    want = _eager_on_card(monkeypatch, cfg, cases)
    got, launches = [], []
    for c in cases + cases[:1]:     # warm-up, capture, replay, replay
        n = (Q.CTX_LAUNCHES, Q.DATTN_LAUNCHES)
        got.append(_grads(cfg, *c))
        launches.append((Q.CTX_LAUNCHES - n[0], Q.DATTN_LAUNCHES - n[1]))
    torch.cuda.synchronize()
    for g, w in zip(got, want + want[:1]):
        assert not _equal(g, w)
    per_call = WIDE["L"] if table == "int8" else 0
    assert launches == [(per_call, per_call)] * 4
    assert _counts() == {"FWD_CAPTURES": 1, "FWD_REPLAYS": 2,
                         "FWD_EAGER": 1, "BWD_CAPTURES": 1,
                         "BWD_REPLAYS": 2, "BWD_EAGER": 1}


@pytest.mark.cuda
def test_card_second_shape_gets_its_own_key(cuda, fresh, monkeypatch):
    cfg = TF.FoldCfg("loc", 0.5, torch.bfloat16, "int8", True)
    long = _case("loc", torch.bfloat16, dev=cuda, wide=True, **WIDE)
    short = _case("loc", torch.bfloat16, dev=cuda, wide=True,
                  **dict(WIDE, L=4))
    want = _eager_on_card(monkeypatch, cfg, [long, short])
    got = [_grads(cfg, *c) for c in (long, short, long, short, long, short)]
    for i, g in enumerate(got):
        assert not _equal(g, want[i % 2])
    assert len(TF._KEYS) == 2
    assert _counts() == {"FWD_CAPTURES": 2, "FWD_REPLAYS": 2,
                         "FWD_EAGER": 2, "BWD_CAPTURES": 2,
                         "BWD_REPLAYS": 2, "BWD_EAGER": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("a_first", [True, False])
def test_card_held_key_runs_the_second_forward_eagerly(cuda, fresh,
                                                       monkeypatch, a_first):
    cfg = TF.FoldCfg("loc", 0.5, torch.bfloat16, "int8", True)
    cases = [_case("loc", torch.bfloat16, seed=s, dev=cuda, wide=True,
                   **WIDE) for s in range(4)]
    want = _eager_on_card(monkeypatch, cfg, cases)
    for c in cases[:2]:                                # warm-up, capture
        _grads(cfg, *c)
    out_a = TF.folded_decoder(cfg, *cases[2][0])
    out_b = TF.folded_decoder(cfg, *cases[3][0])
    order = [(2, out_a), (3, out_b)]
    got = {i: _grads(cfg, *cases[i], out=out)
           for i, out in (order if a_first else order[::-1])}
    torch.cuda.synchronize()
    for i, g in got.items():
        assert not _equal(g, want[i])
    assert _counts() == {"FWD_CAPTURES": 1, "FWD_REPLAYS": 1,
                         "FWD_EAGER": 2, "BWD_CAPTURES": 1,
                         "BWD_REPLAYS": 1, "BWD_EAGER": 2}
