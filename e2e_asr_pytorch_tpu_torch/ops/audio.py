"""Audio front-end: waveform -> normalized log-mel (+delta, CMVN).

Port of e2e_asr_pytorch_tpu/ops/audio.py with the same numerical contract:
centered reflect-padded framing with n_fft=1025 (513 bins), a periodic Hann
window of win_length centred in the frame, the magnitude spectrum as two
windowed-DFT matmuls (not ``torch.stft``, so framing and padding match),
Slaney mel (librosa defaults), 20*log10(clamp(x,1e-5)) - ref_level_db then
clamp((x - min_level_db) / -min_level_db, 0, 1), Kaldi-style deltas in a
channel-major [d0|d1|d2] layout, and per-utterance CMVN over valid frames.
The host-side constants (mel filterbank, delta filters, DFT bases) are numpy
built exactly as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000


# ---------------------------------------------------------------------------
# Host-side constants (numpy)
# ---------------------------------------------------------------------------

# Slaney mel scale: linear below 1 kHz, log above (librosa's default)
_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq: np.ndarray) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    return np.where(freq >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(freq, 1e-10)
                                          / _MIN_LOG_HZ) / _LOGSTEP,
                    freq / _F_SP)


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    return np.where(mels >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)),
                    _F_SP * mels)


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Triangular Slaney-normalized mel filterbank from 0 Hz to sr/2,
    shape (n_freq, n_mels) for right-matmul."""
    n_freq = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freq)
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


def delta_filters(order: int, window_size: int = 2) -> np.ndarray:
    """Kaldi-style delta regression filters, shape (order+1, width), rows
    zero-padded to the widest filter."""
    scales = [np.array([1.0])]
    for _ in range(order):
        prev = scales[-1]
        win = np.arange(-window_size, window_size + 1, dtype=np.float64)
        normalizer = float(np.sum(win ** 2))
        cur = np.zeros(len(prev) + 2 * window_size)
        for j in range(-window_size, window_size + 1):
            cur[j + window_size:j + window_size + len(prev)] += j * prev
        scales.append(cur / normalizer)
    width = len(scales[-1])
    out = np.zeros((order + 1, width), dtype=np.float32)
    for k, s in enumerate(scales):
        pad = (width - len(s)) // 2
        out[k, pad:pad + len(s)] = s
    return out


# ---------------------------------------------------------------------------
# Batched STFT -> log-mel pipeline (tensors)
# ---------------------------------------------------------------------------

def num_frames(num_samples, hop_length: int, n_fft: int):
    """Frame count of a centered STFT: 1 + (L + 2*(n_fft//2) - n_fft) // hop
    (works on ints and integer tensors)."""
    return 1 + (num_samples + 2 * (n_fft // 2) - n_fft) // hop_length


def frame_signal(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Center-pad (reflect) and frame a batch of waveforms: (B,S)->(B,T,n_fft)."""
    pad = n_fft // 2
    wav = torch.nn.functional.pad(wav[:, None, :], (pad, pad),
                                  mode="reflect")[:, 0]
    return wav.unfold(1, n_fft, hop)


@functools.lru_cache(maxsize=4)
def _dft_bases(n_fft: int, win_length: int):
    """Windowed real-DFT bases (n_fft, n_fft//2+1) x2: the Hann window is
    folded into the cosine/sine matrices so |STFT| is two matmuls."""
    win = np.hanning(win_length + 1)[:-1]  # periodic hann
    lpad = (n_fft - win_length) // 2
    win = np.pad(win, (lpad, n_fft - win_length - lpad))
    n = np.arange(n_fft)[:, None]
    k = np.arange(1 + n_fft // 2)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos_b = (np.cos(ang) * win[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * win[:, None]).astype(np.float32)
    return cos_b, sin_b


def stft_magnitude(wav: torch.Tensor, n_fft: int, win_length: int,
                   hop_length: int) -> torch.Tensor:
    """Magnitude STFT of batched waveforms (B,S) -> (B,T,n_fft//2+1), f32."""
    frames = frame_signal(wav, n_fft, hop_length)
    cos_b, sin_b = _dft_bases(n_fft, win_length)
    re = torch.matmul(frames, torch.from_numpy(cos_b).to(wav.device))
    im = torch.matmul(frames, torch.from_numpy(sin_b).to(wav.device))
    return torch.sqrt(re * re + im * im + 1e-30)


def preemphasis(wav: torch.Tensor, coeff: float) -> torch.Tensor:
    """y[0]=x[0]; y[t]=x[t]-coeff*x[t-1]."""
    return torch.cat([wav[:, :1], wav[:, 1:] - coeff * wav[:, :-1]], dim=-1)


def amp_to_db(x: torch.Tensor, minimum: float = 1e-5) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp(x, min=minimum))


def normalize_db(x: torch.Tensor, min_level_db: float) -> torch.Tensor:
    return torch.clamp((x - min_level_db) / -min_level_db, 0.0, 1.0)


class FeatureConfig:
    """Static front-end configuration (the YAML ``audio:`` block), the same
    keys and derived constants as the JAX package's ``FeatureConfig``."""

    def __init__(self, feat_type: str = "fbank", feat_dim: int = 40,
                 frame_length: int = 25, frame_shift: int = 10,
                 ref_level_db: float = 20.0, min_level_db: float = -100.0,
                 preemphasis_coeff: float = 0.97, delta_order: int = 0,
                 delta_window_size: int = 2, apply_cmvn: bool = False,
                 sample_rate: int = SAMPLE_RATE, n_fft: int = 1025,
                 **unused):
        if feat_type != "fbank":
            raise NotImplementedError(
                "feat_type {!r} is not ported yet (ROADMAP: other "
                "frontends)".format(feat_type))
        self.feat_type = feat_type
        self.feat_dim = feat_dim
        self.n_mels = feat_dim
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.win_length = int(frame_length / 1000 * sample_rate)
        self.hop_length = int(frame_shift / 1000 * sample_rate)
        self.ref_level_db = ref_level_db
        self.min_level_db = min_level_db
        self.preemphasis_coeff = preemphasis_coeff
        self.delta_order = delta_order
        self.delta_window_size = delta_window_size
        self.apply_cmvn = apply_cmvn
        self.mel_fb = mel_filterbank(sample_rate, n_fft, self.n_mels)
        self.delta_f = delta_filters(delta_order, delta_window_size)

    @property
    def out_dim(self) -> int:
        return self.feat_dim * (self.delta_order + 1)

    def frames_for_samples(self, n: int) -> int:
        return num_frames(n, self.hop_length, self.n_fft)


def log_mel(cfg: FeatureConfig, wav: torch.Tensor) -> torch.Tensor:
    """(B,S) waveform -> (B,T,n_mels) normalized log-mel in [0,1]."""
    wav = preemphasis(wav, cfg.preemphasis_coeff)
    mag = stft_magnitude(wav, cfg.n_fft, cfg.win_length, cfg.hop_length)
    mel = torch.matmul(mag, torch.from_numpy(cfg.mel_fb).to(wav.device))
    mel = amp_to_db(mel) - cfg.ref_level_db
    return normalize_db(mel, cfg.min_level_db)


def add_deltas(cfg: FeatureConfig, feat: torch.Tensor) -> torch.Tensor:
    """(B,T,D) -> (B,T,(order+1)*D), channel-major [d0|d1|d2] layout; the
    correlation along time is an unrolled sum of shifted slices, with the
    taps in the JAX package's order."""
    if cfg.delta_order == 0:
        return feat
    filt = cfg.delta_f
    width = filt.shape[1]
    pad = (width - 1) // 2
    t = feat.shape[1]
    x = torch.nn.functional.pad(feat, (0, 0, pad, pad))
    outs = []
    for k in range(cfg.delta_order + 1):
        y = None
        for j in range(width):
            w = float(filt[k, j])
            if w != 0.0:
                term = w * x[:, j:j + t]
                y = term if y is None else y + term
        outs.append(y)
    return torch.cat(outs, dim=-1)


def apply_cmvn(feat: torch.Tensor, feat_len: torch.Tensor,
               eps: float = 1e-10) -> torch.Tensor:
    """Per-utterance mean/var normalization over valid frames (B,T,D), with
    the unbiased std like torch.std."""
    mask = (torch.arange(feat.shape[1], device=feat.device)[None, :]
            < feat_len[:, None])
    m = mask[:, :, None].to(feat.dtype)
    denom = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    mean = (feat * m).sum(dim=1, keepdim=True) / denom
    var = (((feat - mean) * m) ** 2).sum(dim=1, keepdim=True) / torch.clamp(
        denom - 1.0, min=1.0)
    return (feat - mean) / (eps + torch.sqrt(var)) * m


def extract_features(cfg: FeatureConfig, wav: torch.Tensor,
                     wav_len: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full front-end: (B,S) f32 waveform + lengths -> (B,T,out_dim) f32
    features + frame lengths. Padding frames are zeroed."""
    feat = log_mel(cfg, wav)
    feat = add_deltas(cfg, feat)
    feat_len = num_frames(wav_len, cfg.hop_length, cfg.n_fft)
    t = feat.shape[1]
    mask = (torch.arange(t, device=feat.device)[None, :]
            < feat_len[:, None]).to(feat.dtype)
    feat = feat * mask[:, :, None]
    if cfg.apply_cmvn:
        feat = apply_cmvn(feat, feat_len)
    return feat, feat_len
