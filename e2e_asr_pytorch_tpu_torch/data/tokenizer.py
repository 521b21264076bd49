"""Text tokenizers.

Capability parity with the reference's text encoders (reference:
src/text.py:10-231): character / word (== phone) / subword modes with the
fixed special ids <pad>=0, <eos>=1, <unk>=2, decode stopping at <eos>, and a
CTC ``ignore_repeat`` collapse option. The factory ``load_text_encoder``
mirrors the reference's YAML ``text:`` block (mode + vocab_file).

Subword mode uses the sentencepiece C++ library when installed; otherwise a
greedy longest-match encoder over a sentencepiece-format ``.vocab`` file is
used so subword configs remain usable in this environment.
"""

from __future__ import annotations

import abc
import os
from typing import List


class BaseTextEncoder(abc.ABC):
    pad_idx = 0
    eos_idx = 1
    unk_idx = 2

    @abc.abstractmethod
    def encode(self, s: str) -> List[int]:
        ...

    @abc.abstractmethod
    def decode(self, ids: List[int], ignore_repeat: bool = False) -> str:
        ...

    @property
    @abc.abstractmethod
    def vocab_size(self) -> int:
        ...

    @property
    @abc.abstractmethod
    def token_type(self) -> str:
        ...

    def __repr__(self):
        return "<{} vocab_size={}>".format(type(self).__name__, self.vocab_size)


class CharacterTextEncoder(BaseTextEncoder):
    """Character-level encoder over a newline-separated vocab file."""

    def __init__(self, vocab_list: List[str]):
        # vocab_list must not contain the specials.
        self._vocab_list = ["<pad>", "<eos>", "<unk>"] + list(vocab_list)
        self._vocab2idx = {v: i for i, v in enumerate(self._vocab_list)}

    @classmethod
    def load_from_file(cls, vocab_file: str) -> "CharacterTextEncoder":
        with open(vocab_file, "r", encoding="UTF-8") as f:
            # keep spaces — a char vocab legitimately contains ' '
            vocab_list = [line.rstrip("\r\n") for line in f]
        return cls(vocab_list)

    def encode(self, s: str) -> List[int]:
        s = s.strip("\r\n ")
        return [self.vocab_to_idx(c) for c in s] + [self.eos_idx]

    def decode(self, ids: List[int], ignore_repeat: bool = False) -> str:
        out = []
        prev = None
        for t, idx in enumerate(ids):
            idx = int(idx)
            if idx == self.eos_idx:
                break
            if idx == self.pad_idx or (ignore_repeat and t > 0 and idx == prev):
                prev = idx
                continue
            out.append(self.idx_to_vocab(idx))
            prev = idx
        return "".join(out)

    @property
    def vocab_size(self) -> int:
        return len(self._vocab_list)

    @property
    def token_type(self) -> str:
        return "character"

    def vocab_to_idx(self, vocab: str) -> int:
        return self._vocab2idx.get(vocab, self.unk_idx)

    def idx_to_vocab(self, idx: int) -> str:
        return self._vocab_list[int(idx)]


class WordTextEncoder(CharacterTextEncoder):
    """Space-delimited word (or phone) encoder."""

    def encode(self, s: str) -> List[int]:
        s = s.strip("\r\n ")
        return [self.vocab_to_idx(w) for w in s.split(" ")] + [self.eos_idx]

    def decode(self, ids: List[int], ignore_repeat: bool = False) -> str:
        out = []
        prev = None
        for t, idx in enumerate(ids):
            idx = int(idx)
            if idx == self.eos_idx:
                break
            if idx == self.pad_idx or (ignore_repeat and t > 0 and idx == prev):
                prev = idx
                continue
            out.append(self.idx_to_vocab(idx))
            prev = idx
        return " ".join(out)

    @property
    def token_type(self) -> str:
        return "word"


class SubwordTextEncoder(BaseTextEncoder):
    """Sentencepiece-backed subword encoder (pad=0, eos=1, unk=2 enforced)."""

    def __init__(self, spm):
        if spm.pad_id() != 0 or spm.eos_id() != 1 or spm.unk_id() != 2:
            raise ValueError(
                "sentencepiece model must be trained with "
                "--pad_id=0 --eos_id=1 --unk_id=2 --bos_id=-1")
        self.spm = spm

    @classmethod
    def load_from_file(cls, filepath: str) -> "BaseTextEncoder":
        try:
            import sentencepiece as splib
        except ImportError:
            splib = None
        if splib is None or filepath.endswith(".vocab"):
            # no sentencepiece C++ lib, or a .vocab listing (which no
            # sentencepiece can load: the shipped subword configs name
            # one): fall back to a greedy matcher over the .vocab file.
            # The segmentations DIFFER from sentencepiece's (different
            # token streams => WER not comparable across the two
            # encoders), so warn loudly.
            import warnings
            vocab_path = os.path.splitext(filepath)[0] + ".vocab"
            target = (vocab_path if os.path.exists(vocab_path) else
                      filepath if filepath.endswith(".vocab") and
                      os.path.exists(filepath) else None)
            if target is None:
                raise ImportError("sentencepiece is not installed and there "
                                  "is no .vocab file beside " + filepath)
            warnings.warn(
                "sentencepiece is not installed — using the greedy "
                "longest-match subword fallback over %r. Token streams "
                "differ from sentencepiece segmentation; error rates are "
                "NOT comparable with sentencepiece-tokenized runs."
                % target if splib is None else
                "%r is a sentencepiece .vocab listing, not a model — using "
                "the greedy longest-match subword fallback over it. Token "
                "streams differ from sentencepiece segmentation; error "
                "rates are NOT comparable with sentencepiece-tokenized runs."
                % target, RuntimeWarning, stacklevel=2)
            return GreedySubwordTextEncoder.load_from_file(target)
        spm = splib.SentencePieceProcessor()
        spm.load(filepath)
        spm.set_encode_extra_options(":eos")
        return cls(spm)

    def encode(self, s: str) -> List[int]:
        return self.spm.encode_as_ids(s)

    def decode(self, ids: List[int], ignore_repeat: bool = False) -> str:
        crop = []
        prev = None
        for t, idx in enumerate(ids):
            idx = int(idx)
            if idx == self.eos_idx:
                break
            if idx == self.pad_idx or (ignore_repeat and t > 0 and idx == prev):
                prev = idx
                continue
            crop.append(idx)
            prev = idx
        return self.spm.decode_ids(crop)

    @property
    def vocab_size(self) -> int:
        return len(self.spm)

    @property
    def token_type(self) -> str:
        return "subword"


class GreedySubwordTextEncoder(BaseTextEncoder):
    """Greedy longest-match subword encoder over a sentencepiece .vocab file.

    Not identical to sentencepiece's unigram/BPE segmentation, but gives a
    working subword pipeline without the native library. Piece ids follow the
    .vocab line order, so models trained with either encoder share a vocab.
    """

    SPM_SPACE = "▁"  # sentencepiece meta symbol for word boundary

    def __init__(self, pieces: List[str]):
        self._pieces = pieces
        self._piece2idx = {p: i for i, p in enumerate(pieces)}
        for sp, idx in (("<pad>", 0), ("<eos>", 1), ("<unk>", 2)):
            if idx >= len(pieces) or pieces[idx] != sp:
                raise ValueError("vocab must start with <pad>, <eos>, <unk>")
        self._max_len = max(len(p) for p in pieces)

    @classmethod
    def load_from_file(cls, vocab_file: str) -> "GreedySubwordTextEncoder":
        pieces = []
        with open(vocab_file, "r", encoding="UTF-8") as f:
            for line in f:
                pieces.append(line.rstrip("\r\n").split("\t")[0])
        return cls(pieces)

    def encode(self, s: str) -> List[int]:
        s = self.SPM_SPACE + s.strip("\r\n ").replace(" ", self.SPM_SPACE)
        ids = []
        i = 0
        while i < len(s):
            match = None
            for l in range(min(self._max_len, len(s) - i), 0, -1):
                cand = s[i:i + l]
                idx = self._piece2idx.get(cand)
                if idx is not None and idx > 2:
                    match = (idx, l)
                    break
            if match is None:
                ids.append(self.unk_idx)
                i += 1
            else:
                ids.append(match[0])
                i += match[1]
        return ids + [self.eos_idx]

    def decode(self, ids: List[int], ignore_repeat: bool = False) -> str:
        out = []
        prev = None
        for t, idx in enumerate(ids):
            idx = int(idx)
            if idx == self.eos_idx:
                break
            if idx == self.pad_idx or (ignore_repeat and t > 0 and idx == prev):
                prev = idx
                continue
            out.append(self._pieces[idx])
            prev = idx
        return "".join(out).replace(self.SPM_SPACE, " ").strip(" ")

    @property
    def vocab_size(self) -> int:
        return len(self._pieces)

    @property
    def token_type(self) -> str:
        return "subword"


BERT_FIRST_IDX = 997    # the 2 ids right before English wordpieces start
BERT_LAST_IDX = 29635   # drop the rest of the BERT vocab


class BertTextEncoder(BaseTextEncoder):
    """BERT wordpiece tokenizer with the reference's index-window remap:
    ids are shifted down by BERT_FIRST_IDX so <pad>/<eos>/<unk> occupy
    0/1/2 and the working vocab is ids 997..29635 (reference src/text.py:7-8,
    159-218). Loads from a HF model name or a local vocab.txt path."""

    def __init__(self, tokenizer):
        self._tok = tokenizer

    @classmethod
    def load_from_file(cls, name_or_path: str) -> "BertTextEncoder":
        from transformers import BertTokenizer
        if name_or_path.endswith(".txt"):
            tok = BertTokenizer(vocab_file=name_or_path)
        else:
            tok = BertTokenizer.from_pretrained(name_or_path)
        return cls(tok)

    def encode(self, s: str) -> List[int]:
        out = []
        for idx in self._tok.encode(s, add_special_tokens=False):
            r = idx - BERT_FIRST_IDX
            out.append(r if r > 0 else self.unk_idx)
        return out + [self.eos_idx]

    def decode(self, ids: List[int], ignore_repeat: bool = False) -> str:
        crop = []
        prev = None
        for t, idx in enumerate(ids):
            idx = int(idx)
            if idx == self.eos_idx:
                break
            if idx == self.pad_idx or (ignore_repeat and t > 0 and idx == prev):
                prev = idx
                continue
            crop.append(idx + BERT_FIRST_IDX)
            prev = idx
        return self._tok.decode(crop)

    @property
    def vocab_size(self) -> int:
        return BERT_LAST_IDX - BERT_FIRST_IDX + 1

    @property
    def token_type(self) -> str:
        return "bert"


def load_text_encoder(mode: str, vocab_file: str) -> BaseTextEncoder:
    """Factory matching the reference's YAML ``text:`` schema."""
    if mode == "character":
        return CharacterTextEncoder.load_from_file(vocab_file)
    if mode == "subword":
        return SubwordTextEncoder.load_from_file(vocab_file)
    if mode in ("word", "phone"):
        return WordTextEncoder.load_from_file(vocab_file)
    if mode.startswith("bert-"):
        return BertTextEncoder.load_from_file(mode)
    raise NotImplementedError("text mode `{}` is not supported".format(mode))
