"""Port of the location-aware attention (precompute + beam and single-row
steps) against the JAX package on shared weights and inputs, K=3 beams.
Tolerance atol 1e-5: f32 throughout, only summation order differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.ops import attention as JA
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.ops import attention as TA

ATOL = 1e-5
B, K, T, DE, DQ = 2, 3, 13, 24, 20


def _cfg(mode, num_head):
    return JA.AttnConfig(mode=mode, dim=16, num_head=num_head,
                         temperature=0.5, v_proj=False, v_dim=DE, q_dim=DQ,
                         loc_kernel_size=5, loc_kernel_num=3)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, T, DE)).astype(np.float32)
    enc_len = np.array([T, 8], np.int32)
    query = rng.standard_normal((B, K, DQ)).astype(np.float32)
    prev = rng.uniform(0.0, 1.0, (B, K, 1, T)).astype(np.float32)
    prev = prev / prev.sum(-1, keepdims=True)
    return enc, enc_len, query, prev


def _both(mode, num_head=1, loc_scale=1.0):
    cfg = _cfg(mode, num_head)
    tcfg = TA.AttnConfig(*cfg)
    jp = JA.attention_init(jax.random.PRNGKey(5), cfg)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    if mode == "loc":
        tp["loc_conv"]["w"] = tp["loc_conv"]["w"] * loc_scale
    enc, enc_len, query, prev = _inputs()
    prev = np.repeat(prev, num_head, axis=2)
    jc = JA.precompute(jp, cfg, jnp.asarray(enc), jnp.asarray(enc_len))
    tc = TA.precompute(tp, tcfg, torch.from_numpy(enc),
                       torch.from_numpy(enc_len).long())
    errs = {"key": np.abs(np.asarray(jc["key"]) - tc["key"].numpy()).max()}
    jctx, jattn, _ = JA.attention_step_beam(jp, cfg, jnp.asarray(query), jc,
                                            jnp.asarray(prev))
    tctx, tattn, _ = TA.attention_step_beam(tp, tcfg, torch.from_numpy(query),
                                            tc, torch.from_numpy(prev))
    errs["ctx"] = np.abs(np.asarray(jctx) - tctx.numpy()).max()
    errs["attn"] = np.abs(np.asarray(jattn) - tattn.numpy()).max()
    # the single-row step on beam 1
    jctx1, jattn1, _ = JA.attention_step(jp, cfg, jnp.asarray(query[:, 1]),
                                         jc, jnp.asarray(prev[:, 1]))
    tctx1, tattn1, _ = TA.attention_step(tp, tcfg,
                                         torch.from_numpy(query[:, 1]), tc,
                                         torch.from_numpy(prev[:, 1]))
    errs["ctx1"] = np.abs(np.asarray(jctx1) - tctx1.numpy()).max()
    errs["attn1"] = np.abs(np.asarray(jattn1) - tattn1.numpy()).max()
    return {k: float(v) for k, v in errs.items()}


@pytest.mark.parametrize("mode,num_head", [("loc", 1), ("loc", 2),
                                           ("dot", 1)])
def test_attention_matches_jax(mode, num_head):
    errs = _both(mode, num_head)
    assert max(errs.values()) <= ATOL, errs


def test_attention_fails_under_doubled_location_features():
    errs = _both("loc", loc_scale=2.0)
    assert errs["attn"] > 100 * ATOL, errs


def test_beam_rows_equal_single_row_steps():
    # broadcasting the beam axis must equal K independent single-row steps
    cfg = TA.AttnConfig(*_cfg("loc", 1))
    tp = convert.from_jax_params(jax.tree.map(
        np.asarray, JA.attention_init(jax.random.PRNGKey(5), _cfg("loc", 1))))
    enc, enc_len, query, prev = (torch.from_numpy(a) for a in _inputs(1))
    cache = TA.precompute(tp, cfg, enc, enc_len.long())
    ctx, attn, _ = TA.attention_step_beam(tp, cfg, query, cache, prev)
    for k in range(K):
        c1, a1, _ = TA.attention_step(tp, cfg, query[:, k], cache,
                                      prev[:, k])
        assert torch.allclose(ctx[:, k], c1, atol=ATOL)
        assert torch.allclose(attn[:, k], a1, atol=ATOL)


def test_loc_band_matches_jax():
    w = np.random.default_rng(3).standard_normal((11, 2, 3)).astype(
        np.float32)
    jm = JA.loc_band_matrix(jnp.asarray(w), 9)
    tm = TA.loc_band_matrix(torch.from_numpy(w), 9)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
