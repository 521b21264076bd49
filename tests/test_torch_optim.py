"""AdamW, SGD and RMSprop (``train/optim.py``) against the JAX package's
optax chains (``e2e_asr_pytorch_tpu/train/optim.py build_optimizer``) over
three steps: clip_by_global_norm active (the gradients' norm is above
grad_clip), the second step's gradient non-finite (the whole update and the
count skipped), accumulators stored in bf16, the warmup schedule read at
the update count.

Held: each leaf's total parameter change within REL of the JAX change's
max |.| (the same f32 math; rsqrt and pow may differ by an ulp), the
accumulators within one bf16 ulp of their max |.|, and the count equal.
The twins are the semantics a reader might take for these names and the
bound must catch: torch's RMSprop (alpha 0.99, eps outside the square
root) and AdamW with its decay coupled into the gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e2e_asr_pytorch_tpu.train import optim as JO
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.train import optim as TO

REL = 1e-5
ACC_REL = 2.0 ** -7
HP = dict(lr=0.05, eps=1e-6, lr_scheduler="warmup", weight_decay=0.1,
          grad_clip=1.0, optim_state_dtype="bfloat16")


def _params():
    r = np.random.default_rng(0)
    # keys in sorted order, the order jax.tree rebuilds dicts in
    return {"a": r.standard_normal((5, 4)).astype(np.float32),
            "layers": [{"b": r.standard_normal(3).astype(np.float32),
                        "w": r.standard_normal((3, 3)).astype(np.float32)}]}


def _grads(step):
    r = np.random.default_rng(10 + step)
    g = {"a": 2.0 * r.standard_normal((5, 4)).astype(np.float32),
         "layers": [{"b": r.standard_normal(3).astype(np.float32),
                     "w": r.standard_normal((3, 3)).astype(np.float32)}]}
    if step == 1:
        g["a"][0, 0] = np.nan
    return g


def _jax(name):
    tx, _ = JO.build_optimizer(optimizer=name, **HP)
    p = jax.tree.map(jnp.asarray, _params())
    state = tx.init(p)
    for step in range(3):
        upd, state = tx.update(jax.tree.map(jnp.asarray, _grads(step)),
                               state, p)
        p = optax.apply_updates(p, upd)
    return p, convert.from_jax_opt_state(jax.tree.map(np.asarray, state))


def _port(opt):
    p = convert.from_jax_params(_params())
    state = opt.init(p)
    norms = [float(opt.step(p, convert.from_jax_params(_grads(step)), state))
             for step in range(3)]
    assert norms[0] > HP["grad_clip"] and not np.isfinite(norms[1])
    return p, state


def _errs(name, opt):
    jp, js = _jax(name)
    tp, ts = _port(opt)
    p0 = convert.from_jax_params(_params())
    out = {}
    for i, (a, j, t) in enumerate(zip(convert.tree_leaves(p0),
                                      convert.tree_leaves(
                                          convert.from_jax_params(
                                              jax.tree.map(np.asarray, jp))),
                                      convert.tree_leaves(tp))):
        dj, dt = (j - a).double(), (t - a).double()
        out["p%d" % i] = float((dj - dt).abs().max() / dj.abs().max())
    assert set(js) == set(ts), (sorted(js), sorted(ts))
    assert int(js["count"]) == int(ts["count"]) == 2
    for k in set(js) - {"count"}:
        for i, (j, t) in enumerate(zip(convert.tree_leaves(js[k]),
                                       convert.tree_leaves(ts[k]))):
            assert j.dtype == t.dtype == torch.bfloat16, k
            out["%s%d" % (k, i)] = float(
                (j.double() - t.double()).abs().max()
                / j.double().abs().max()) * REL / ACC_REL
    return out


@pytest.mark.parametrize("name", ["AdamW", "SGD", "RMSprop"])
def test_optimizer_matches_optax(name):
    errs = _errs(name, TO.build_optimizer(optimizer=name, **HP))
    assert errs and all(e <= REL for e in errs.values()), errs


class TorchRMSprop(TO.RMSprop):
    """torch.optim.RMSprop's rule: alpha 0.99, eps outside the root."""

    def _leaf(self, p, g, accs, k):
        nu = 0.01 * g ** 2 + 0.99 * accs[0]
        return g / (torch.sqrt(nu) + self.eps), (nu,)


class CoupledAdamW(TO.AdamW):
    """Adam with L2 regularisation: the decay added to the gradient."""

    def _leaf(self, p, g, accs, k):
        return TO.Adam._leaf(self, p, g + self.weight_decay * p.float(),
                             accs, k)


@pytest.mark.parametrize("name,twin", [
    ("RMSprop", lambda: TorchRMSprop(HP["lr"], HP["eps"], "warmup",
                                     HP["grad_clip"], "bfloat16")),
    ("AdamW", lambda: CoupledAdamW(HP["lr"], HP["eps"], "warmup",
                                   HP["weight_decay"], HP["grad_clip"],
                                   "bfloat16"))])
def test_optimizer_twin_breaks_the_bound(name, twin):
    errs = _errs(name, twin())
    assert max(errs.values()) > 100 * REL, errs


def test_sgd_has_no_accumulators_and_ignores_weight_decay():
    opt = TO.build_optimizer(optimizer="SGD", **HP)
    state = opt.init(convert.from_jax_params(_params()))
    assert set(state) == {"count"}
