"""Audio front-end: waveform -> normalized log-mel (+delta, CMVN).

Port of e2e_asr_pytorch_tpu/ops/audio.py with the same numerical contract:
centered reflect-padded framing with n_fft=1025 (513 bins), a periodic Hann
window of win_length centred in the frame, the magnitude spectrum as two
windowed-DFT matmuls (not ``torch.stft``, so framing and padding match),
Slaney mel (librosa defaults), 20*log10(clamp(x,1e-5)) - ref_level_db then
clamp((x - min_level_db) / -min_level_db, 0, 1), Kaldi-style deltas in a
channel-major [d0|d1|d2] layout, and per-utterance CMVN over valid frames;
``feat_type: mfcc`` takes a DCT-II of the normalized log-mel. The inverse
path (mel pseudo-inverse + Griffin-Lim, for audio logging) uses ``torch.fft``
as the JAX package uses ``jnp.fft``. The host-side constants (mel
filterbank, DCT, delta filters, DFT bases) are numpy built exactly as in
the JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000


# ---------------------------------------------------------------------------
# Host-side constants (numpy)
# ---------------------------------------------------------------------------

# Slaney mel scale: linear below 1 kHz, log above (librosa's default);
# ``htk`` takes the HTK formula instead
_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq: np.ndarray, htk: bool = False) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    return np.where(freq >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(freq, 1e-10)
                                          / _MIN_LOG_HZ) / _LOGSTEP,
                    freq / _F_SP)


def mel_to_hz(mels: np.ndarray, htk: bool = False) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    return np.where(mels >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)),
                    _F_SP * mels)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, htk: bool = False,
                   norm: Optional[int] = 1) -> np.ndarray:
    """Triangular mel filterbank from ``fmin`` to ``fmax`` (sr/2 when None),
    Slaney area-normalized when ``norm`` is 1, shape (n_freq, n_mels) for
    right-matmul."""
    if fmax is None:
        fmax = sr / 2.0
    n_freq = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freq)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk),
                          n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == 1:
        weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II basis (n_in, n_out) for MFCC extraction."""
    k = np.arange(n_out)[None, :]
    n = np.arange(n_in)[:, None]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    basis *= np.sqrt(2.0 / n_in)
    basis[:, 0] *= np.sqrt(0.5)
    return basis.astype(np.float32)


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


def _hann(n_fft: int, win_length: int) -> np.ndarray:
    """The periodic Hann window of win_length centred in the n_fft frame."""
    win = np.hanning(win_length + 1)[:-1]
    lpad = (n_fft - win_length) // 2
    return np.pad(win, (lpad, n_fft - win_length - lpad))


@functools.lru_cache(maxsize=4)
def _dft_bases(n_fft: int, win_length: int):
    """Windowed real-DFT bases (n_fft, n_fft//2+1) x2: the Hann window is
    folded into the cosine/sine matrices so |STFT| is two matmuls."""
    win = _hann(n_fft, win_length)
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
        if feat_type not in ("fbank", "mfcc"):
            raise ValueError("feat_type must be fbank or mfcc, got {!r}"
                             .format(feat_type))
        self.feat_type = feat_type
        self.feat_dim = feat_dim
        # mfcc: a DCT-II over a log-mel bank of at least 40 bands
        self.n_mels = feat_dim if feat_type == "fbank" else max(40, feat_dim)
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
        self.dct = (dct_matrix(self.n_mels, feat_dim)
                    if feat_type == "mfcc" else None)
        self.delta_f = delta_filters(delta_order, delta_window_size)

    @property
    def out_dim(self) -> int:
        return self.feat_dim * (self.delta_order + 1)

    def frames_for_samples(self, n: int) -> int:
        return num_frames(n, self.hop_length, self.n_fft)


def log_mel(cfg: FeatureConfig, wav: torch.Tensor) -> torch.Tensor:
    """(B,S) waveform -> (B,T,n_mels) normalized log-mel in [0,1], or its
    first feat_dim DCT-II coefficients for mfcc."""
    wav = preemphasis(wav, cfg.preemphasis_coeff)
    mag = stft_magnitude(wav, cfg.n_fft, cfg.win_length, cfg.hop_length)
    mel = torch.matmul(mag, torch.from_numpy(cfg.mel_fb).to(wav.device))
    mel = amp_to_db(mel) - cfg.ref_level_db
    mel = normalize_db(mel, cfg.min_level_db)
    if cfg.dct is not None:
        mel = torch.matmul(mel, torch.from_numpy(cfg.dct).to(wav.device))
    return mel


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


# ---------------------------------------------------------------------------
# Inverse path: normalized log-mel -> waveform (audio logging): mel pinv
# and Griffin-Lim
# ---------------------------------------------------------------------------

def _stft_complex(wav: torch.Tensor, n_fft: int, win: torch.Tensor,
                  hop: int) -> torch.Tensor:
    """(S,) waveform -> (T, n_fft//2+1) complex STFT, centred framing."""
    frames = frame_signal(wav[None], n_fft, hop)[0]
    return torch.fft.rfft(frames * win[None, :], dim=-1)


def _istft(spec: torch.Tensor, n_fft: int, win: torch.Tensor, hop: int,
           length: int) -> torch.Tensor:
    """Overlap-add inverse STFT matching the centred forward framing."""
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win[None, :]
    t = frames.shape[0]
    pad = n_fft // 2
    out_len = (t - 1) * hop + n_fft
    idx = (torch.arange(t, device=spec.device)[:, None] * hop
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    out = torch.zeros(out_len, device=spec.device).index_add_(
        0, idx, frames.reshape(-1))
    norm = torch.zeros(out_len, device=spec.device).index_add_(
        0, idx, (win * win).repeat(t))
    out = out / torch.clamp(norm, min=1e-8)
    return out[pad:pad + length]


def denormalize_db(x: torch.Tensor, min_level_db: float) -> torch.Tensor:
    return min_level_db + torch.clamp(x, 0.0, 1.0) * -min_level_db


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, 0.05 * x)


def griffin_lim(cfg: FeatureConfig, magnitude: torch.Tensor, length: int,
                n_iter: int = 30,
                phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase reconstruction from a (T,F) magnitude spectrogram. ``phase`` is
    the initial phase (T,F) in radians; when None it is drawn uniform in
    [0, 2 pi) from a CPU generator seeded 0."""
    win = torch.from_numpy(_hann(cfg.n_fft, cfg.win_length).astype(
        np.float32)).to(magnitude.device)
    if phase is None:
        phase = (torch.rand(magnitude.shape,
                            generator=torch.Generator().manual_seed(0))
                 * 2 * np.pi).to(magnitude.device)
    spec = magnitude * torch.exp(1j * phase)
    wav = _istft(spec, cfg.n_fft, win, cfg.hop_length, length)
    for _ in range(n_iter):
        rebuilt = _stft_complex(wav, cfg.n_fft, win, cfg.hop_length)
        rebuilt = rebuilt[:magnitude.shape[0]]
        phase_u = rebuilt / torch.clamp(rebuilt.abs(), min=1e-8)
        wav = _istft(magnitude * phase_u, cfg.n_fft, win, cfg.hop_length,
                     length)
    return wav


def deemphasis(x: torch.Tensor, coeff: float) -> torch.Tensor:
    """The inverse of ``preemphasis`` over a (S,) signal, y[t] = x[t] +
    coeff * y[t-1] from y[-1] = 0, as a doubling scan of the affine maps
    y -> a*y + b: ceil(log2 S) rounds of whole-signal ops, no loop over the
    samples."""
    a = torch.full_like(x, coeff)
    b = x
    shift = 1
    while shift < x.shape[0]:
        b = torch.cat([b[:shift], b[shift:] + a[shift:] * b[:-shift]])
        a = torch.cat([a[:shift], a[shift:] * a[:-shift]])
        shift *= 2
    return b


def feat_to_wave(cfg: FeatureConfig, mel_feat: torch.Tensor,
                 n_iter: int = 30, phase: Optional[torch.Tensor] = None):
    """Invert a (T, n_mels) normalized log-mel back to a waveform for audio
    logging: denormalize -> dB to amplitude -> mel pseudo-inverse ->
    Griffin-Lim (initial ``phase`` as ``griffin_lim``) -> de-emphasis.
    Returns (waveform clipped to [-1, 1], sample rate)."""
    mel_feat = mel_feat[:, :cfg.feat_dim]  # drop delta blocks if present
    amp = db_to_amp(denormalize_db(mel_feat, cfg.min_level_db)
                    + cfg.ref_level_db)
    fb_pinv = torch.from_numpy(np.linalg.pinv(cfg.mel_fb)).to(
        mel_feat.device)
    spec = torch.clamp(amp @ fb_pinv, min=0.0)
    # T*hop samples frame back to exactly T centred STFT frames
    length = mel_feat.shape[0] * cfg.hop_length
    wav = griffin_lim(cfg, spec, max(length, cfg.n_fft), n_iter, phase)
    wav = deemphasis(wav, cfg.preemphasis_coeff)
    return torch.clamp(wav, -1.0, 1.0), cfg.sample_rate


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
