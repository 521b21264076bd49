"""The port's CTC prefix scorer (``ops/ctc_prefix.py``) against the JAX
package's on the same numpy inputs: ``init_state``, ``score_psi``,
``advance_state`` (the port's doubling scan against JAX's
``lax.associative_scan``) and ``score_candidates``, at an empty prefix and
at prefixes of 1 and 3 tokens, with candidates that repeat the last token
and <eos>, over ragged ``enc_len``; and the doubling scan against the
per-frame recursion (``advance_state_loop``). Tolerance: rtol 1e-5, atol
1e-3 on the log-probs (f32 sums over up to T terms in other orders), and an
entry at log-zero (<= LOG_ZERO / 2) in one must be at log-zero in the other.
Twins: the repeat rule (``same``) ignored, and a doubled blank column."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.ops import ctc_prefix as JP
from e2e_asr_pytorch_tpu_torch.ops import ctc_prefix as TP

RTOL, ATOL = 1e-5, 1e-3
LZ_HALF = TP.LOG_ZERO / 2
B, T, V, K = 3, 13, 7, 4
ENC_LEN = np.array([13, 9, 4])
# the JAX functions jitted once (prefix_len traced): eager associative scans
# cost a compile for every op
J_ADVANCE = jax.jit(JP.advance_state)
J_PSI = jax.jit(JP.score_psi)


def _agree(ref, got):
    """Whether ``got`` holds ``ref`` at the stated tolerance."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    zero = ref <= LZ_HALF
    if not np.array_equal(zero, got <= LZ_HALF):
        return False
    return bool(np.all(np.abs(ref - got)[~zero]
                       <= ATOL + RTOL * np.abs(ref)[~zero]))


@pytest.fixture(scope="module")
def case():
    """Log-posteriors and, for prefixes of 0, 1 and 3 tokens, the JAX
    forward variables of the prefix, its last token and candidates that
    hold the repeat of the last token and <eos>."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, V)) * 2.0
    logp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    jl, je = jnp.asarray(logp), jnp.asarray(ENC_LEN)
    r = np.repeat(np.asarray(JP.init_state(jl, je))[:, None], K, 1)
    last = np.zeros((B, K), np.int64)
    states = {}
    for plen in range(4):
        cand = np.stack([rng.permutation(np.arange(1, V))[:5]
                         for _ in range(B * K)]).reshape(B, K, 5)
        cand[:, :, 0] = last if plen else 2       # the repeat
        cand[:, :, 1] = 1                         # <eos>
        states[plen] = dict(r=r, last=last, cand=cand)
        tok = cand[:, :, 2]
        r = np.asarray(J_ADVANCE(jl, je, jnp.asarray(r),
                                    jnp.asarray(last), jnp.asarray(tok),
                                    jnp.asarray(plen)))
        last = tok
    return logp, {p: states[p] for p in (0, 1, 3)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _psi_both(logp, st, plen):
    j = J_PSI(jnp.asarray(logp), jnp.asarray(ENC_LEN), jnp.asarray(st["r"]),
              jnp.asarray(st["last"]), jnp.asarray(st["cand"]),
              jnp.asarray(plen))
    t = TP.score_psi(_t(logp), _t(ENC_LEN), _t(st["r"]), _t(st["last"]),
                     _t(st["cand"]), plen)
    return np.asarray(j), t.numpy()


def _advance_args(logp, st, plen):
    tok = st["cand"][:, :, 0]                     # the repeat
    return (logp, ENC_LEN, st["r"], st["last"], tok)


def test_init_state_matches_jax(case):
    logp, _ = case
    j = JP.init_state(jnp.asarray(logp), jnp.asarray(ENC_LEN))
    t = TP.init_state(_t(logp), _t(ENC_LEN))
    assert _agree(j, t)


@pytest.mark.parametrize("plen", [0, 1, 3])
def test_score_psi_matches_jax(case, plen):
    logp, states = case
    j, t = _psi_both(logp, states[plen], plen)
    assert _agree(j, t)
    assert (t[..., 1] > LZ_HALF).all()            # <eos> is scored


@pytest.mark.parametrize("plen", [0, 1, 3])
def test_advance_state_matches_jax_and_the_loop(case, plen):
    logp, states = case
    args = _advance_args(logp, states[plen], plen)
    j = J_ADVANCE(*map(jnp.asarray, args), jnp.asarray(plen))
    t = TP.advance_state(*map(_t, args), plen)
    loop = TP.advance_state_loop(*map(_t, args), plen)
    assert _agree(j, t)
    assert _agree(loop, t)
    # frames past enc_len are frozen at the last valid frame
    for bi, n in enumerate(ENC_LEN):
        assert _agree(t[bi, :, n - 1:n].expand(-1, T - n, -1),
                      t[bi, :, n:])


def test_score_candidates_matches_jax(case):
    logp, states = case
    plen = 3
    st = states[plen]
    jp, jr = jax.jit(JP.score_candidates)(
        jnp.asarray(logp), jnp.asarray(ENC_LEN), jnp.asarray(st["r"]),
        jnp.zeros((B, K)), jnp.asarray(st["last"]), jnp.asarray(st["cand"]),
        jnp.asarray(plen))
    tp, tr = TP.score_candidates(_t(logp), _t(ENC_LEN), _t(st["r"]),
                                 torch.zeros(B, K), _t(st["last"]),
                                 _t(st["cand"]), plen)
    assert tr.shape == (B, K, 5, T, 2)
    assert _agree(jp, tp) and _agree(jr, tr)


def test_psi_vs_jax_fails_when_the_repeat_rule_is_ignored(case, monkeypatch):
    logp, states = case
    sound = TP._phi
    monkeypatch.setattr(TP, "_phi", lambda r, same: sound(
        r, torch.zeros_like(same)))
    j, t = _psi_both(logp, states[3], 3)
    assert not _agree(j, t)


def test_advance_vs_jax_fails_under_a_doubled_blank(case):
    logp, states = case
    args = _advance_args(logp, states[1], 1)
    j = J_ADVANCE(*map(jnp.asarray, args), jnp.asarray(1))
    doubled = logp.copy()
    doubled[..., 0] *= 2.0
    t = TP.advance_state(_t(doubled), *map(_t, args[1:]), 1)
    assert not _agree(j, t)
