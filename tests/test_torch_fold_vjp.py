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
