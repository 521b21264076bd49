"""Error-rate metrics (WER / CER / PER).

Capability parity with the reference's ``cal_er`` (reference:
src/util.py:123-139): decode hypothesis & truth with the tokenizer, split into
words for WER/PER, chars for CER, and average per-utterance normalized edit
distance over the batch. Empty truth counts as error 1.0, CTC outputs collapse
repeats before scoring.

Edit distance runs in native C++ (e2e_asr_pytorch_tpu_torch/native/levenshtein.cpp)
with a pure-Python fallback.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np

from e2e_asr_pytorch_tpu_torch import native

_lib = native.load("levenshtein")
if _lib is not None:
    _lib.levenshtein_i64.restype = ctypes.c_int64
    _lib.levenshtein_i64.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]


def _py_levenshtein(a: Sequence[int], b: Sequence[int]) -> int:
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
    """Levenshtein distance between two token-id sequences."""
    if _lib is None:
        return _py_levenshtein(a, b)
    aa = np.ascontiguousarray(a, dtype=np.int64)
    bb = np.ascontiguousarray(b, dtype=np.int64)
    return int(_lib.levenshtein_i64(
        aa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(aa),
        bb.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(bb)))


def _to_units(s: str, mode: str) -> List[str]:
    # WER/PER operate on space-separated units, CER on characters.
    if mode in ("wer", "per"):
        return s.split(" ")
    return list(s)


def _intern(units: List[str], table: dict) -> List[int]:
    return [table.setdefault(u, len(table)) for u in units]


def cal_er(tokenizer, pred, truth, mode: str = "wer", ctc: bool = False) -> float:
    """Average error rate of a batch.

    ``pred`` may be (B, L) token ids or (B, L, V) logits (argmaxed here);
    ``truth`` is (B, L) token ids padded with 0.
    """
    if pred is None:
        return float("nan")
    pred = np.asarray(pred)
    truth = np.asarray(truth)
    if pred.ndim >= 3:
        pred = pred.argmax(axis=-1)
    errs = []
    for p, t in zip(pred, truth):
        p_str = tokenizer.decode(p.tolist(), ignore_repeat=ctc)
        t_str = tokenizer.decode(t.tolist())
        table: dict = {}
        p_units = _intern(_to_units(p_str, mode), table)
        t_units = _intern(_to_units(t_str, mode), table)
        if len(t_units) == 0:
            errs.append(1.0)
        else:
            errs.append(edit_distance(p_units, t_units) / len(t_units))
    return float(sum(errs) / len(errs))


def wer_strings(hyp: str, ref: str) -> float:
    """Word error rate between two plain strings (offline eval tools)."""
    table: dict = {}
    h = _intern(hyp.split(), table)
    r = _intern(ref.split(), table)
    return 1.0 if len(r) == 0 else edit_distance(h, r) / len(r)


def cer_strings(hyp: str, ref: str) -> float:
    """Char error rate between two plain strings (offline eval tools)."""
    table: dict = {}
    h = _intern(list(hyp), table)
    r = _intern(list(ref), table)
    return 1.0 if len(r) == 0 else edit_distance(h, r) / len(r)
