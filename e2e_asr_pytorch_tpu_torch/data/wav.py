"""Host-side audio decode.

The reference decodes audio via librosa/libsndfile in DataLoader workers
(reference: src/audio.py:283-309 ReadAudio). This container has neither, so
we provide a self-contained RIFF/WAVE reader (PCM16/24/32 + float32) in
numpy, an optional ``flac`` CLI bridge for FLAC corpora, and a registry so
other decoders can be plugged in. Audio decode is the only host-side stage of
the front-end; everything downstream runs on device (ops/audio.py).
"""

from __future__ import annotations

import io
import os
import shutil
import struct
import subprocess
from typing import Tuple

import numpy as np


def read_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Parse a RIFF/WAVE blob -> (float32 mono waveform in [-1,1], rate)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 3 or (audio_format == 0xFFFE and bits == 32):
        wav = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif bits == 16:
        wav = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 32:
        wav = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8) |
               (b[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        wav = val.astype(np.float32) / float(1 << 23)
    elif bits == 8:
        wav = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError("unsupported WAV bit depth: {}".format(bits))
    if channels > 1:
        wav = wav.reshape(-1, channels).mean(axis=1)
    return wav, rate


def write_wav(path: str, wav: np.ndarray, rate: int = 16000) -> None:
    """Write float32 mono as PCM16 (test fixtures / synthetic corpora)."""
    pcm = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(pcm)) + pcm)


_FLAC_BIN = shutil.which("flac")


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode a .wav or .flac file to (float32 mono, rate).

    FLAC (the LibriSpeech format) prefers the vendored native decoder
    (native/dataloader.cpp), falls back to the pure-Python decoder
    (data/flac.py), then to the `flac` CLI if present."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        with open(path, "rb") as f:
            return read_wav_bytes(f.read())
    if ext == ".flac":
        try:
            from e2e_asr_pytorch_tpu_torch.data import native_loader
            if native_loader.available():
                return native_loader.read_audio_native(path)
        except Exception:
            pass
        try:
            from e2e_asr_pytorch_tpu_torch.data.flac import read_flac
            return read_flac(path)
        except Exception as e:
            if _FLAC_BIN is None:
                raise ValueError(
                    "failed to decode FLAC file %r: %s" % (path, e)) from e
        try:
            out = subprocess.run([_FLAC_BIN, "-d", "-c", "-s", path],
                                 check=True, capture_output=True).stdout
        except subprocess.CalledProcessError as e:
            raise ValueError(
                "failed to decode FLAC file %r (flac CLI rc=%d)"
                % (path, e.returncode)) from e
        return read_wav_bytes(out)
    raise ValueError("unsupported audio format: " + path)


def resample_linear(wav: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Cheap linear resampler (host-side; corpora are normally 16 kHz)."""
    if src_rate == dst_rate:
        return wav
    n_out = int(round(len(wav) * dst_rate / src_rate))
    x_out = np.linspace(0.0, len(wav) - 1.0, n_out)
    return np.interp(x_out, np.arange(len(wav)), wav).astype(np.float32)
