"""Time-domain waveform augmentation (the ``time_aug`` config option).

Capability parity with the reference's audiomentations pipeline (reference:
src/audio.py:283-309 ReadAudio / :329-345 Augment_Time): per-utterance random
gaussian noise (p=0.3, amp 1e-3..1e-2), time stretch (p=0.3, rate 0.8..1.25)
and pitch shift (p=0.5, -4..+4 semitones). audiomentations isn't available
here, so these are self-contained numpy implementations applied host-side
before batching (like the reference, which augments inside ReadAudio before
feature extraction). Pitch shift uses the resample+stretch decomposition
(shift = resample by 2^(s/12), then stretch back) with an overlap-add time
stretcher — a standard approximation of the librosa effect.
"""

from __future__ import annotations

import numpy as np


def add_gaussian_noise(wav: np.ndarray, rng: np.random.Generator,
                       min_amp: float = 0.001, max_amp: float = 0.01
                       ) -> np.ndarray:
    amp = rng.uniform(min_amp, max_amp)
    return wav + amp * rng.standard_normal(len(wav)).astype(np.float32)


def _resample(wav: np.ndarray, rate: float) -> np.ndarray:
    n_out = max(int(round(len(wav) / rate)), 2)
    x_out = np.linspace(0.0, len(wav) - 1.0, n_out)
    return np.interp(x_out, np.arange(len(wav)), wav).astype(np.float32)


def time_stretch(wav: np.ndarray, rate: float, frame: int = 1024,
                 hop_frac: float = 0.25) -> np.ndarray:
    """OLA time stretch: speed up (rate>1) or slow down without resampling
    artifacts dominating (simple synchronized overlap-add)."""
    if abs(rate - 1.0) < 1e-3 or len(wav) < 2 * frame:
        return wav
    syn_hop = int(frame * hop_frac)
    ana_hop = int(syn_hop * rate)
    n_frames = max((len(wav) - frame) // ana_hop, 1)
    out_len = syn_hop * n_frames + frame
    out = np.zeros(out_len, np.float32)
    norm = np.zeros(out_len, np.float32)
    win = np.hanning(frame).astype(np.float32)
    for i in range(n_frames):
        a = i * ana_hop
        s = i * syn_hop
        out[s:s + frame] += wav[a:a + frame] * win
        norm[s:s + frame] += win
    return out / np.maximum(norm, 1e-3)


def pitch_shift(wav: np.ndarray, semitones: float) -> np.ndarray:
    """Shift pitch keeping duration: resample by the pitch factor, then
    time-stretch back to the original length."""
    if abs(semitones) < 1e-3:
        return wav
    factor = 2.0 ** (semitones / 12.0)
    # compressing the waveform by `factor` raises pitch by `factor`
    shifted = _resample(wav, factor)            # changes pitch AND duration
    stretched = time_stretch(shifted, len(shifted) / len(wav))
    # pad/crop to the exact original length
    if len(stretched) < len(wav):
        stretched = np.pad(stretched, (0, len(wav) - len(stretched)))
    return stretched[:len(wav)]


def augment_waveform(wav: np.ndarray, rng: np.random.Generator,
                     p_noise: float = 0.3, p_stretch: float = 0.3,
                     p_pitch: float = 0.5) -> np.ndarray:
    """The reference's Compose([...]) with matching probabilities/ranges."""
    wav = np.asarray(wav, np.float32)
    if rng.uniform() < p_noise:
        wav = add_gaussian_noise(wav, rng)
    if rng.uniform() < p_stretch:
        wav = time_stretch(wav, float(rng.uniform(0.8, 1.25)))
    if rng.uniform() < p_pitch:
        wav = pitch_shift(wav, float(rng.uniform(-4.0, 4.0)))
    return wav.astype(np.float32)
