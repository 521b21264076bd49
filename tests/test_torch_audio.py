"""Port of the audio front-end (``extract_features``) against the JAX
package on the same waveforms. Tolerance atol 1e-4 on features normalized to
[0, 1]: the DFT-basis matmuls and the log of small mel energies are where
f32 sums in another order show. CMVN is held on shared input features: it
divides by per-coefficient std, so it would amplify those upstream f32
differences in low-variance coefficients, which says nothing about CMVN."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu.ops import audio as JA
from e2e_asr_pytorch_tpu_torch.ops import audio as TA

ATOL = 1e-4
CONFIGS = {
    "fbank40_d2": dict(feat_dim=40, delta_order=2),
    "fbank80_d0": dict(feat_dim=80, delta_order=0),
}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(9000) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t)
    wav = np.stack([tone + 0.05 * rng.standard_normal(9000),
                    0.2 * rng.standard_normal(9000)]).astype(np.float32)
    wav_len = np.array([9000, 6123], np.int32)
    return wav, wav_len


def _both(name, mel_scale=1.0):
    wav, wav_len = _batch()
    jcfg = JA.FeatureConfig(**CONFIGS[name])
    tcfg = TA.FeatureConfig(**CONFIGS[name])
    tcfg.mel_fb = tcfg.mel_fb * mel_scale
    jf, jl = JA.extract_features(jcfg, jnp.asarray(wav), jnp.asarray(wav_len))
    tf, tl = TA.extract_features(tcfg, torch.from_numpy(wav),
                                 torch.from_numpy(wav_len).long())
    assert tuple(tf.shape) == jf.shape and tf.dtype == torch.float32
    assert np.array_equal(np.asarray(jl), tl.numpy())
    return float(np.max(np.abs(np.asarray(jf) - tf.numpy())))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_extract_features_matches_jax(name):
    assert _both(name) <= ATOL


def test_extract_features_fails_under_doubled_mel_bank():
    assert _both("fbank40_d2", mel_scale=2.0) > 100 * ATOL


def _cmvn_both(len_scale=1):
    rng = np.random.default_rng(2)
    feat = rng.uniform(0.0, 1.0, (2, 30, 12)).astype(np.float32)
    feat_len = np.array([30, 13], np.int32)
    jy = JA.apply_cmvn(jnp.asarray(feat), jnp.asarray(feat_len))
    ty = TA.apply_cmvn(torch.from_numpy(feat),
                       torch.from_numpy(feat_len * len_scale).long())
    return float(np.max(np.abs(np.asarray(jy) - ty.numpy())))


def test_apply_cmvn_matches_jax():
    assert _cmvn_both() <= ATOL


def test_apply_cmvn_fails_under_doubled_valid_length():
    # (CMVN is invariant to a scale of its input, so the fault doubles the
    # frames its statistics cover instead)
    assert _cmvn_both(len_scale=2) > 100 * ATOL


def test_frames_for_samples_and_constants_match():
    jcfg = JA.FeatureConfig(feat_dim=40, delta_order=2)
    tcfg = TA.FeatureConfig(feat_dim=40, delta_order=2)
    for n in (1, 160, 16000, 204800, 256000):
        assert tcfg.frames_for_samples(n) == jcfg.frames_for_samples(n)
    np.testing.assert_array_equal(tcfg.mel_fb, jcfg.mel_fb)
    np.testing.assert_array_equal(tcfg.delta_f, jcfg.delta_f)
    assert tcfg.out_dim == jcfg.out_dim == 120
