"""Corpus adapters: LibriSpeech (audio + text) and a synthetic corpus.

Capability parity with the reference's dataset layer (reference:
corpus/preprocess_librispeech.py:12-151): walk the split directories for
audio, read transcripts from ``*.trans.txt`` (or ``*.phn`` dictionaries for
phone mode), tokenize, sort by file size (a duration proxy; ascending when
curriculum learning), ``subset`` truncation, and the LM text dataset that
mixes transcripts with ``librispeech-lm-norm.txt`` (dropping the longest
REMOVE_TOP_N_TXT lines of the official LM corpus).

The synthetic corpus generates deterministic tone-coded utterances so the
whole framework is exercisable (tests, benches) without LibriSpeech on disk:
each token maps to a distinguishable tone segment, so a model can genuinely
learn the mapping.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

OFFICIAL_TXT_SRC = ["librispeech-lm-norm.txt"]
REMOVE_TOP_N_TXT = 5000000
READ_FILE_THREADS = 16


def read_trans_text(audio_path: str) -> str:
    """Transcript for one utterance from its sibling *.trans.txt."""
    base = os.path.basename(audio_path).rsplit(".", 1)[0]
    trans = "-".join(base.split("-")[:-1]) + ".trans.txt"
    src = os.path.join(os.path.dirname(audio_path), trans)
    with open(src, "r") as f:
        for line in f:
            if line.split(" ")[0] == base:
                return line.rstrip("\n").split(" ", 1)[1]
    raise KeyError("no transcript for " + audio_path)


def read_phoneme(audio_path: str) -> str:
    """Phone transcript from <root>/<split>_from_dict/<utt>.phn."""
    parts = audio_path.split("/")
    task = parts[-4]
    root = "/".join(parts[:-4])
    utt = os.path.basename(audio_path).rsplit(".", 1)[0]
    with open(os.path.join(root, task + "_from_dict", utt + ".phn")) as f:
        return f.readline().rstrip("\n")


class AudioDataset:
    """A sorted list of (audio_path_or_array, token_ids) pairs."""

    def __init__(self, items: List[Tuple[object, List[int]]],
                 durations: List[float]):
        self.items = items
        self.durations = durations  # seconds (or a monotone proxy)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def load_librispeech(path: str, split: Sequence[str], tokenizer,
                     text_mode: str = "character", ascending: bool = False,
                     subset: Optional[int] = None,
                     bytes_per_sec: float = 32000.0) -> AudioDataset:
    """Index LibriSpeech-layout data (.flac or .wav) with transcripts."""
    files: List[Path] = []
    for s in split:
        root = Path(os.path.join(path, s))
        files += sorted(root.rglob("*.flac")) + sorted(root.rglob("*.wav"))
    assert len(files) > 0, "No data found @ {}".format(path)
    if isinstance(subset, int):
        files = files[:subset]

    reader = read_phoneme if text_mode == "phone" else read_trans_text
    with cf.ThreadPoolExecutor(READ_FILE_THREADS) as ex:
        texts = list(ex.map(lambda f: reader(str(f)), files))
        sizes = list(ex.map(os.path.getsize, files))
    tokens = [tokenizer.encode(t) for t in texts]

    order = sorted(range(len(files)), key=lambda i: sizes[i],
                   reverse=not ascending)
    items = [(str(files[i]), tokens[i]) for i in order]
    durs = [sizes[i] / bytes_per_sec for i in order]
    return AudioDataset(items, durs)


def load_text_corpus(path: str, split: Sequence[str], tokenizer,
                     text_mode: str = "character") -> List[List[int]]:
    """Text-only dataset for LM training (transcripts and/or the official
    LM corpus), sorted by length descending."""
    sents: List[str] = []
    official = False
    for s in split:
        if s in OFFICIAL_TXT_SRC:
            official = True
            with open(os.path.join(path, s), "r") as f:
                sents += [l.rstrip("\n") for l in f]
        else:
            root = Path(os.path.join(path, s))
            files = sorted(root.rglob("*.flac")) + sorted(root.rglob("*.wav"))
            with cf.ThreadPoolExecutor(READ_FILE_THREADS) as ex:
                sents += list(ex.map(lambda f: read_trans_text(str(f)), files))
    assert len(sents) > 0, "No text found @ {}".format(path)
    sents.sort(key=len, reverse=True)
    if official:
        del sents[:REMOVE_TOP_N_TXT]
    return [tokenizer.encode(s) for s in sents]


# ---------------------------------------------------------------------------
# Synthetic corpus (framework exercisable without LibriSpeech)
# ---------------------------------------------------------------------------

class SyntheticCorpus:
    """Deterministic tone-coded utterances.

    Token id v is rendered as ``seg_len`` samples of a sine at a
    v-specific frequency; the transcript is the token sequence. A small
    model can fit this mapping, which is what the smoke/integration tests
    and benches rely on.
    """

    def __init__(self, vocab_size: int, sample_rate: int = 16000,
                 seg_ms: int = 160, noise: float = 0.05, seed: int = 0,
                 active_vocab: Optional[int] = None):
        self.vocab_size = vocab_size
        self.sample_rate = sample_rate
        self.seg_len = int(sample_rate * seg_ms / 1000)
        self.noise = noise
        self.seed = seed
        # active_vocab=N restricts transcripts to N evenly spaced token ids
        # (maximally separated tones) — the fast-convergence setting the
        # learning test uses; default keeps every non-special id
        ids = np.arange(3, vocab_size)
        if active_vocab is not None and active_vocab < len(ids):
            ids = np.unique(np.linspace(3, vocab_size - 1,
                                        active_vocab).astype(np.int64))
        self.ids = ids

    def utterance(self, idx: int, n_tokens: int, no_repeat: bool = False):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        # usable ids exclude pad/eos/unk
        toks = rng.choice(self.ids, n_tokens)
        if no_repeat:
            # adjacent repeats of a pure tone are acoustically one long
            # segment (phase-continuous), so a corpus meant to be easily
            # learnable avoids them (CTC would need duration cues to split)
            for j in range(1, n_tokens):
                while toks[j] == toks[j - 1]:
                    toks[j] = rng.choice(self.ids)
        t = np.arange(self.seg_len) / self.sample_rate
        segs = []
        for v in toks:
            # geometric (≈mel-uniform) spacing keeps every token id in a
            # distinct mel band — linear spacing collapses neighbors into
            # one low-frequency bin and caps the learnable accuracy
            k = (int(v) - 3) / max(self.vocab_size - 4, 1)
            freq = 220.0 * (6000.0 / 220.0) ** k
            segs.append(np.sin(2 * np.pi * freq * t).astype(np.float32))
        wav = np.concatenate(segs) * 0.3
        wav += self.noise * rng.standard_normal(len(wav)).astype(np.float32)
        return wav.astype(np.float32), toks.tolist() + [1]  # append <eos>


def load_synthetic(tokenizer, n_utts: int = 64, min_tokens: int = 3,
                   max_tokens: int = 12, ascending: bool = False,
                   subset: Optional[int] = None, seed: int = 0,
                   no_repeat: bool = False, **corpus_kwargs) -> AudioDataset:
    corp = SyntheticCorpus(tokenizer.vocab_size, seed=seed, **corpus_kwargs)
    if isinstance(subset, int):
        n_utts = min(n_utts, subset)
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_tokens, max_tokens + 1, n_utts)
    items, durs = [], []
    for i in range(n_utts):
        wav, toks = corp.utterance(i, int(lens[i]), no_repeat=no_repeat)
        items.append((wav, toks))
        durs.append(len(wav) / corp.sample_rate)
    order = sorted(range(n_utts), key=lambda i: durs[i], reverse=not ascending)
    return AudioDataset([items[i] for i in order], [durs[i] for i in order])


def load_synthetic_text(tokenizer, n_sents: int = 256, min_tokens: int = 3,
                        max_tokens: int = 20, seed: int = 0) -> List[List[int]]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_sents):
        n = int(rng.integers(min_tokens, max_tokens + 1))
        out.append(rng.integers(3, tokenizer.vocab_size, n).tolist() + [1])
    out.sort(key=len, reverse=True)
    return out
