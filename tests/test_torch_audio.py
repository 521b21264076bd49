"""Port of the audio front-end (``extract_features``) against the JAX
package on the same waveforms. Tolerance atol 1e-4 on features normalized to
[0, 1]: the DFT-basis matmuls and the log of small mel energies are where
f32 sums in another order show. CMVN is held on shared input features: it
divides by per-coefficient std, so it would amplify those upstream f32
differences in low-variance coefficients, which says nothing about CMVN.
mfcc (13 and 40 coefficients, with deltas) goes through the same bound; the
mel filterbank's htk / fmin / fmax / norm arguments are held exact; the
inverse path (overlap-add inverse STFT, Griffin-Lim from the JAX initial
phase, ``feat_to_wave``) within WAVE_ATOL."""

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
    "mfcc13_d2": dict(feat_type="mfcc", feat_dim=13, delta_order=2),
    "mfcc40_d2": dict(feat_type="mfcc", feat_dim=40, delta_order=2),
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


def test_mfcc_fails_under_doubled_mel_bank():
    assert _both("mfcc13_d2", mel_scale=2.0) > 100 * ATOL


def test_mfcc_config_matches():
    for dim in (13, 40, 64):
        jcfg = JA.FeatureConfig(feat_type="mfcc", feat_dim=dim,
                                delta_order=2)
        tcfg = TA.FeatureConfig(feat_type="mfcc", feat_dim=dim,
                                delta_order=2)
        assert tcfg.n_mels == jcfg.n_mels == max(40, dim)
        assert tcfg.out_dim == jcfg.out_dim == 3 * dim
        np.testing.assert_array_equal(tcfg.dct, jcfg.dct)
        np.testing.assert_array_equal(tcfg.mel_fb, jcfg.mel_fb)
    assert TA.FeatureConfig().dct is None
    with pytest.raises(ValueError):
        TA.FeatureConfig(feat_type="spectrogram")


MEL_ARGS = {
    "slaney": dict(),
    "htk": dict(htk=True),
    "fmin_fmax": dict(fmin=60.0, fmax=7600.0),
    "htk_unnormalized": dict(htk=True, fmin=20.0, fmax=4000.0, norm=None),
    "slaney_unnormalized": dict(norm=None),
}


@pytest.mark.parametrize("name", sorted(MEL_ARGS))
def test_mel_filterbank_matches_jax(name):
    kw = MEL_ARGS[name]
    for n_mels in (40, 80):
        a = JA.mel_filterbank(16000, 1025, n_mels, **kw)
        b = TA.mel_filterbank(16000, 1025, n_mels, **kw)
        assert b.shape == a.shape == (513, n_mels) and b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for f in (0.0, 700.0, 1000.0, 5000.0):
        for htk in (False, True):
            np.testing.assert_allclose(TA.mel_to_hz(TA.hz_to_mel(f, htk),
                                                    htk), f, atol=1e-9)
            assert TA.hz_to_mel(f, htk) == JA.hz_to_mel(f, htk)


def test_mel_filterbank_arguments_are_not_ignored():
    base = TA.mel_filterbank(16000, 1025, 40)
    for kw in MEL_ARGS.values():
        if kw:
            assert np.abs(TA.mel_filterbank(16000, 1025, 40, **kw)
                          - base).max() > 1e-3


# ------------------------------------------------------- the inverse path
# Griffin-Lim and the overlap-add inverse in f32 over torch.fft and jnp.fft:
# the two FFTs sum in another order, so the bound is 1e-4 on waveforms of
# amplitude <= 1 (measured ~1e-6).
WAVE_ATOL = 1e-4


def _window(cfg):
    win = np.hanning(cfg.win_length + 1)[:-1].astype(np.float32)
    lpad = (cfg.n_fft - cfg.win_length) // 2
    return np.pad(win, (lpad, cfg.n_fft - cfg.win_length - lpad))


def test_istft_round_trip_matches_jax():
    cfg = TA.FeatureConfig(feat_dim=40)
    wav = (0.2 * np.random.default_rng(5).standard_normal(8000)).astype(
        np.float32)
    win = _window(cfg)
    jspec = JA._stft_complex(jnp.asarray(wav), cfg.n_fft, jnp.asarray(win),
                             cfg.hop_length)
    tspec = TA._stft_complex(torch.from_numpy(wav), cfg.n_fft,
                             torch.from_numpy(win), cfg.hop_length)
    assert tuple(tspec.shape) == jspec.shape
    assert np.abs(np.asarray(jspec) - tspec.numpy()).max() <= 1e-3
    jrec = np.asarray(JA._istft(jspec, cfg.n_fft, jnp.asarray(win),
                                cfg.hop_length, len(wav)))
    trec = TA._istft(tspec, cfg.n_fft, torch.from_numpy(win),
                     cfg.hop_length, len(wav)).numpy()
    assert np.abs(jrec - trec).max() <= WAVE_ATOL
    # interior samples reconstruct (the edges lose window coverage)
    sl = slice(cfg.n_fft, len(wav) - cfg.n_fft)
    assert np.abs(trec[sl] - wav[sl]).max() <= 2e-3
    # planted fault: a doubled synthesis window is caught
    bad = TA._istft(tspec, cfg.n_fft, 2 * torch.from_numpy(win),
                    cfg.hop_length, len(wav)).numpy()
    assert np.abs(bad[sl] - wav[sl]).max() > 100 * 2e-3


def _tone_feat(cfg_kw):
    t = np.arange(16000) / 16000
    wav = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    jcfg = JA.FeatureConfig(**cfg_kw)
    feat, feat_len = JA.extract_features(jcfg, jnp.asarray(wav[None]),
                                         jnp.asarray([16000]))
    return jcfg, np.array(feat[0, :int(feat_len[0])])


def _jax_phase(shape):
    """The initial phase the JAX Griffin-Lim draws (key 0)."""
    import jax
    return np.array(jax.random.uniform(jax.random.PRNGKey(0), shape)
                    * 2 * jnp.pi)


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_griffin_lim_matches_jax(shift):
    """Griffin-Lim from the JAX initial phase; the twin starts half a
    radian off and must miss."""
    jcfg, feat = _tone_feat(dict(feat_dim=80))
    tcfg = TA.FeatureConfig(feat_dim=80)
    mag = np.maximum(np.asarray(jnp.asarray(feat) @ jnp.asarray(
        np.linalg.pinv(jcfg.mel_fb))), 0.0)
    length = feat.shape[0] * jcfg.hop_length
    jw = np.asarray(JA.griffin_lim(jcfg, jnp.asarray(mag), length, n_iter=4))
    tw = TA.griffin_lim(tcfg, torch.from_numpy(mag), length, n_iter=4,
                        phase=torch.from_numpy(_jax_phase(mag.shape)
                                               + shift)).numpy()
    err = np.abs(jw - tw).max()
    if shift == 0.0:
        assert err <= WAVE_ATOL * max(1.0, np.abs(jw).max()), err
    else:
        assert err > 100 * WAVE_ATOL * max(1.0, np.abs(jw).max()), err


@pytest.mark.parametrize("name", ["fbank80_d0", "fbank40_d2"])
def test_feat_to_wave_matches_jax(name):
    jcfg, feat = _tone_feat(CONFIGS[name])
    tcfg = TA.FeatureConfig(**CONFIGS[name])
    jw, jsr = JA.feat_to_wave(jcfg, jnp.asarray(feat), n_iter=8)
    phase = _jax_phase((feat.shape[0], 1 + jcfg.n_fft // 2))
    tw, tsr = TA.feat_to_wave(tcfg, torch.from_numpy(feat), n_iter=8,
                              phase=torch.from_numpy(phase))
    jw, tw = np.asarray(jw), tw.numpy()
    assert tsr == jsr == 16000 and tw.shape == jw.shape
    assert np.abs(jw - tw).max() <= WAVE_ATOL
    # the dominant frequency survives the round trip
    spec = np.abs(np.fft.rfft(tw[2000:12000]))
    assert 400 < np.fft.rfftfreq(10000, 1 / 16000)[spec.argmax()] < 480
    # planted fault: a halved de-emphasis coefficient is caught (a doubled
    # one, 1.94, makes the inverse filter unstable)
    tcfg.preemphasis_coeff *= 0.5
    bad, _ = TA.feat_to_wave(tcfg, torch.from_numpy(feat), n_iter=8,
                             phase=torch.from_numpy(phase))
    assert np.abs(jw - bad.numpy()).max() > 100 * WAVE_ATOL


def test_deemphasis_inverts_preemphasis():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 3001)).astype(np.float32))
    y = TA.deemphasis(TA.preemphasis(x, 0.97)[0], 0.97)
    assert float((y - x[0]).abs().max()) <= 1e-5
    loop, acc = [], 0.0
    for v in x[0].tolist():
        acc = v + 0.5 * acc
        loop.append(acc)
    assert float((TA.deemphasis(x[0], 0.5) - torch.tensor(loop)).abs()
                 .max()) <= 1e-5


def test_feat_to_wave_draws_a_seeded_phase():
    _, feat = _tone_feat(dict(feat_dim=40))
    cfg = TA.FeatureConfig(feat_dim=40)
    a, _ = TA.feat_to_wave(cfg, torch.from_numpy(feat), n_iter=2)
    b, _ = TA.feat_to_wave(cfg, torch.from_numpy(feat), n_iter=2)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


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
