"""The one traffic generator: host batches, in the form the port's batch
iterators yield them, made from a traffic mix's parameters and the seed.

Every batch of every seed holds the same multiset of lengths (evenly
spaced over the mix's range), dealt to the rows in an order drawn from the
seed, so that seeds change what the rows say and not how much work a step
is. Padding follows the port's shape buckets, whose tables the mix file
carries (a copy of ``TextBatchIterator.TOKEN_BUCKETS`` and of
``DEFAULT_BUCKETS_SEC``).

kind "text"  (LM): rows of ``min_tokens``..``max_tokens`` token ids, the
             last one <eos> (id 1), the others drawn from the vocabulary's
             non-special ids (3..V-1), padded with <pad> (0) to the
             smallest bucket that holds the longest row:
             {"txt": (B,L) int32, "txt_len": (B,) int32}.
kind "audio" (ASR): utterances of ``min_seconds``..``max_seconds`` with
             transcripts of ``min_chars``..``max_chars`` characters plus
             <eos>, the longer transcript to the longer utterance (a
             speaking rate, so that every CTC alignment exists); each
             character is a tone at its own frequency (the
             port's ``SyntheticCorpus`` coding) held for its share of the
             utterance, with white noise, padded to the bucket:
             {"wav", "wav_len", "txt", "txt_len", "utt_w"}.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

EOS = 1
FIRST_ID = 3  # <pad>, <eos>, <unk> come first


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` whole numbers evenly spaced over lo..hi (both ends in)."""
    if n == 1:
        return np.array([hi])
    return np.round(np.linspace(lo, hi, n)).astype(np.int64)


def _bucket(n: int, buckets) -> int:
    for c in buckets:
        if n <= c:
            return c
    return buckets[-1]


def text_batches(p: Dict, vocab_size: int, seed: int, n: int) -> List[Dict]:
    rows = p["rows"]
    lens = spread(p["min_tokens"], p["max_tokens"], rows)
    out = []
    for k in range(n):
        rng = rng_for(seed, 1, k)
        ls = rng.permutation(lens)
        cap = _bucket(int(ls.max()), p["buckets"])
        txt = np.zeros((rows, cap), np.int32)
        for j, l in enumerate(ls):
            txt[j, :l - 1] = rng.integers(FIRST_ID, vocab_size, l - 1)
            txt[j, l - 1] = EOS
        out.append({"txt": txt, "txt_len": ls.astype(np.int32)})
    return out


def tone_frequency(token: np.ndarray, vocab_size: int) -> np.ndarray:
    """The port's synthetic corpus's tone of a token id (mel-like spacing
    from 220 Hz to 6 kHz)."""
    k = (token - FIRST_ID) / max(vocab_size - 4, 1)
    return 220.0 * (6000.0 / 220.0) ** k


def render(chars: np.ndarray, n_samples: int, vocab_size: int,
           sample_rate: int, noise: float, rng) -> np.ndarray:
    per = np.minimum(np.arange(n_samples) * len(chars) // n_samples,
                     len(chars) - 1)
    freq = tone_frequency(chars, vocab_size)[per]
    phase = 2.0 * np.pi * np.cumsum(freq) / sample_rate
    wav = 0.3 * np.sin(phase) + noise * rng.standard_normal(n_samples)
    return wav.astype(np.float32)


def audio_batches(p: Dict, vocab_size: int, seed: int, n: int) -> List[Dict]:
    rows, sr = p["rows"], p["sample_rate"]
    secs = np.linspace(p["min_seconds"], p["max_seconds"], rows)
    samples = np.round(secs * sr).astype(np.int64)
    chars = spread(p["min_chars"], p["max_chars"], rows)
    buckets = [(int(round(s * sr)), l) for s, l in p["buckets_sec"]]
    out = []
    for k in range(n):
        rng = rng_for(seed, 2, k)
        order = rng.permutation(rows)
        ns, nc = samples[order], chars[order]
        max_s, max_l = int(ns.max()), int(nc.max()) + 1
        cap_s, cap_l = next(((s, l) for s, l in buckets
                             if max_s <= s and max_l <= l), buckets[-1])
        wav = np.zeros((rows, cap_s), np.float32)
        txt = np.zeros((rows, cap_l), np.int32)
        for j in range(rows):
            toks = rng.integers(FIRST_ID, vocab_size, nc[j])
            wav[j, :ns[j]] = render(toks, int(ns[j]), vocab_size, sr,
                                    p["noise"], rng)
            txt[j, :nc[j]] = toks
            txt[j, nc[j]] = EOS
        out.append({"wav": wav, "wav_len": ns.astype(np.int32),
                    "txt": txt, "txt_len": (nc + 1).astype(np.int32),
                    "utt_w": np.ones((rows,), np.float32)})
    return out


def batches(p: Dict, vocab_size: int, seed: int, n: int) -> List[Dict]:
    kind = p["kind"]
    if kind == "text":
        return text_batches(p, vocab_size, seed, n)
    if kind == "audio":
        return audio_batches(p, vocab_size, seed, n)
    raise ValueError("traffic kind {!r} is neither text nor audio".format(
        kind))
