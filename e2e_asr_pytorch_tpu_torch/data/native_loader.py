"""ctypes wrapper for the native C++ async batch loader.

Replaces the reference's DataLoader worker processes (reference:
src/data.py:127) for on-disk WAV corpora: a C++ thread pool decodes and pads
batches off the GIL while the device computes; batches are submitted a few
steps ahead and fetched in order. Falls back to the in-Python decode path
when the native library or the file format isn't available.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List

import numpy as np

from e2e_asr_pytorch_tpu_torch import native

_lib = native.load("dataloader")
if _lib is not None:
    _lib.dl_create.restype = ctypes.c_void_p
    _lib.dl_create.argtypes = [ctypes.c_int]
    _lib.dl_destroy.argtypes = [ctypes.c_void_p]
    _lib.dl_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_char_p),
                               ctypes.c_int64, ctypes.c_int64]
    _lib.dl_wait.restype = ctypes.c_int64
    _lib.dl_wait.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_float),
                             ctypes.POINTER(ctypes.c_int32)]
    _lib.dl_read_wav.restype = ctypes.c_int64
    _lib.dl_read_wav.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_int32)]
    _lib.dl_flac_total_samples.restype = ctypes.c_int64
    _lib.dl_flac_total_samples.argtypes = [ctypes.c_char_p]


def available() -> bool:
    return _lib is not None


def read_wav_native(path: str, cap: int = 16000 * 40):
    """Decode one WAV/FLAC through the native lib: (float32 wave, rate)."""
    assert _lib is not None
    buf = np.zeros((cap,), np.float32)
    rate = ctypes.c_int32(0)
    n = _lib.dl_read_wav(path.encode(), buf.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), cap, ctypes.byref(rate))
    if n < 0:
        raise IOError("native audio decode failed: " + path)
    return buf[:n].copy(), int(rate.value)


def read_audio_native(path: str):
    """One-shot native decode with an exact-size buffer (FLAC length from
    STREAMINFO, WAV bounded by file size)."""
    assert _lib is not None
    if path.endswith(".flac"):
        total = _lib.dl_flac_total_samples(path.encode())
        if total <= 0:
            raise IOError("cannot read FLAC STREAMINFO: " + path)
        cap = int(total)
    else:
        cap = max((os.path.getsize(path) - 44) // 2, 1)
    return read_wav_native(path, cap=cap)


class NativeBatchLoader:
    """Pipelined native batch decoding: submit (paths, cap) jobs ahead,
    fetch padded (B,S) float32 + lengths in order."""

    def __init__(self, n_workers: int = 4):
        assert _lib is not None, "native dataloader unavailable"
        self._h = _lib.dl_create(n_workers)
        self._meta: List[Dict] = []  # FIFO of submitted job shapes
        self._next_id = 0

    def submit(self, paths: List[str], cap_samples: int) -> int:
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        job_id = self._next_id
        self._next_id += 1
        _lib.dl_submit(self._h, job_id, arr, len(paths), cap_samples)
        self._meta.append({"n": len(paths), "cap": cap_samples, "id": job_id})
        return job_id

    def wait(self):
        meta = self._meta.pop(0)
        wav = np.zeros((meta["n"], meta["cap"]), np.float32)
        lens = np.zeros((meta["n"],), np.int32)
        rc = _lib.dl_wait(self._h, wav.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc == -2:
            raise IOError("native decode failed inside batch {}".format(
                meta["id"]))
        return wav, lens

    @property
    def in_flight(self) -> int:
        return len(self._meta)

    def close(self):
        if self._h is not None:
            _lib.dl_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def estimate_pcm16_samples(path: str) -> int:
    """Sample-count estimate: exact STREAMINFO count for FLAC (34-byte
    header read), file size for PCM16 mono WAV; the reference uses the same
    size-as-duration proxy for sorting (corpus/preprocess_librispeech.py:69-74)."""
    if path.endswith(".flac"):
        if _lib is not None:
            n = _lib.dl_flac_total_samples(path.encode())
            if n > 0:
                return int(n)
        from e2e_asr_pytorch_tpu_torch.data.flac import flac_stream_info
        info = flac_stream_info(path)
        if info is not None and info[0] > 0:
            return info[0]
        # ~0.55 bytes/sample typical 16-bit mono FLAC ratio
        return max(int(os.path.getsize(path) * 1.8) // 2, 1)
    return max((os.path.getsize(path) - 44) // 2, 1)
