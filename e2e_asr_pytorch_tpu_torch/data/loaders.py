"""Dataset assembly — the equivalent of the reference's src/data.py (the
port's own copy of e2e_asr_pytorch_tpu/data/loaders.py).

``load_dataset`` / ``load_textset`` consume the YAML ``data:`` block verbatim
(reference: src/data.py:104-199): corpus-name dispatch, bucketing, multi
dev-set support, subset, curriculum (ascending) ordering. They return
shape-bucketed batch iterators over raw waveforms (device-side feature
extraction happens in the solvers) plus tokenizer / dims / info messages.

Corpora: 'librispeech' (.flac via flac CLI or .wav) and 'synthetic'
(tone-coded utterances; lets every pipeline run without data on disk).
"""

from __future__ import annotations

from typing import Dict, List

from e2e_asr_pytorch_tpu_torch.data import librispeech as corpus_lib
from e2e_asr_pytorch_tpu_torch.data.batching import (AudioBatchIterator,
                                               TextBatchIterator)
from e2e_asr_pytorch_tpu_torch.data.tokenizer import load_text_encoder


def _make_audio_ds(name: str, path: str, split, tokenizer, text_mode,
                   ascending: bool, subset, **extra):
    name = name.lower()
    if name == "librispeech":
        return corpus_lib.load_librispeech(path, split, tokenizer, text_mode,
                                           ascending=ascending, subset=subset)
    if name == "synthetic":
        # distinct splits get distinct generator seeds — via a DETERMINISTIC
        # hash: Python's str hash is randomized per process, which would give
        # every process (multi-host!) and every run a different synthetic
        # corpus
        import zlib
        split_seed = zlib.crc32("|".join(split).encode()) % 10007
        return corpus_lib.load_synthetic(tokenizer, ascending=ascending,
                                         subset=subset, seed=split_seed,
                                         **extra)
    raise NotImplementedError("corpus `{}`".format(name))


def _data_msg(name, path, train_split, n_tr, dev_split, n_dv, batch_size,
              bucketing) -> List[str]:
    return [
        "Data spec. | Corpus = {} (from {})".format(name, path),
        "           | Train sets = {}\t| Number of utts = {}".format(
            train_split, n_tr),
        "           | Dev sets = {}\t| Number of utts = {}".format(
            dev_split, n_dv),
        "           | Batch size = {}\t\t| Bucketing = {}".format(
            batch_size, bucketing),
    ]


def _host_rows():
    """Input sharding spec for the TRAIN iterator: on a mesh with more than
    one data rank, (this rank's place on the 'data' axis, n_data): each
    rank decodes only its row slice of each global batch. Otherwise None
    (the default path)."""
    from e2e_asr_pytorch_tpu_torch.parallel import mesh as mesh_lib
    m = mesh_lib.current()
    if m is not None and m.n_data > 1:
        return (m.dp_rank, m.n_data)
    return None


def load_dataset(njobs: int, use_gpu: bool, pin_memory: bool,
                 ascending: bool, corpus: Dict, audio: Dict, text: Dict,
                 mode: str = "train", seed: int = 0, pad_multiple: int = 1):
    """Returns (tr_iter, dv_iter(s), feat_dim, vocab_size, tokenizer, msgs).

    In mode='eval', the first two are (dev_iter, test_iter) like the
    reference (src/data.py:66-80).
    """
    tokenizer = load_text_encoder(**text)
    c = dict(corpus)
    name = c.pop("name")
    path = c.pop("path", "")
    train_split = c.pop("train_split", None)
    dev_split = c.pop("dev_split", None)
    test_split = c.pop("test_split", None)
    bucketing = c.pop("bucketing", True)
    batch_size = c.pop("batch_size", 16)
    subset = c.pop("subset", None)

    feat_dim = audio["feat_dim"] * (audio.get("delta_order", 0) + 1)

    if mode == "train":
        if train_split is None:
            raise ValueError("data.corpus.train_split is required for "
                             "training")
        tr_ds = _make_audio_ds(name, path, train_split, tokenizer,
                               text["mode"], ascending, subset, **c)
        tr_it = AudioBatchIterator(tr_ds, batch_size, "train",
                                   shuffle=not ascending,
                                   drop_last=not ascending, seed=seed,
                                   time_aug=bool(audio.get("time_aug", False)),
                                   pad_multiple=pad_multiple, njobs=njobs,
                                   host_rows=_host_rows())
        if dev_split and isinstance(dev_split[0], list):
            dv_its = []
            n_dv = 0
            for ds_spec in dev_split:
                dv_ds = _make_audio_ds(name, path, ds_spec, tokenizer,
                                       text["mode"], False, subset, **c)
                n_dv += len(dv_ds)
                dv_its.append(AudioBatchIterator(dv_ds, batch_size, "eval",
                                                 seed=seed,
                                                 pad_multiple=pad_multiple,
                                                 njobs=njobs))
            dv_it = dv_its
        else:
            dv_ds = _make_audio_ds(name, path, dev_split, tokenizer,
                                   text["mode"], False, subset, **c)
            n_dv = len(dv_ds)
            dv_it = AudioBatchIterator(dv_ds, batch_size, "eval", seed=seed,
                                       pad_multiple=pad_multiple, njobs=njobs)
        msgs = _data_msg(name, path, str(train_split), len(tr_ds),
                         str(dev_split), n_dv, batch_size, bucketing)
        msgs.append("I/O spec.  | Audio Feature = {}\t| Feature Dim = {}\t| "
                    "Token Type = {}\t| Vocab Size = {}".format(
                        audio.get("feat_type", "fbank"), feat_dim,
                        tokenizer.token_type, tokenizer.vocab_size))
        return tr_it, dv_it, feat_dim, tokenizer.vocab_size, tokenizer, msgs

    # eval mode: (dev, test)
    if dev_split and isinstance(dev_split[0], list):
        dev_split = dev_split[0]
    dv_ds = _make_audio_ds(name, path, dev_split, tokenizer, text["mode"],
                           False, subset, **c)
    tt_ds = _make_audio_ds(name, path, test_split, tokenizer, text["mode"],
                           False, subset, **c)
    dv_it = AudioBatchIterator(dv_ds, batch_size, "eval", seed=seed,
                               pad_multiple=pad_multiple, njobs=njobs)
    tt_it = AudioBatchIterator(tt_ds, batch_size, "eval", seed=seed,
                               pad_multiple=pad_multiple, njobs=njobs)
    msgs = _data_msg(name, path, str(dev_split), len(dv_ds),
                     str(test_split), len(tt_ds), batch_size, False)
    msgs = [m.replace("Dev", "Test").replace("Train", "Dev") for m in msgs]
    return dv_it, tt_it, feat_dim, tokenizer.vocab_size, tokenizer, msgs


def load_textset(njobs: int, use_gpu: bool, pin_memory: bool, corpus: Dict,
                 text: Dict, seed: int = 0, pad_multiple: int = 1):
    """LM datasets: (tr_iter, dv_iter, vocab_size, tokenizer, msgs)."""
    tokenizer = load_text_encoder(**text)
    c = dict(corpus)
    name = c.pop("name").lower()
    path = c.pop("path", "")
    train_split = c.pop("train_split")
    dev_split = c.pop("dev_split")
    c.pop("bucketing", True)
    batch_size = c.pop("batch_size", 64)
    if name == "librispeech":
        tr = corpus_lib.load_text_corpus(path, train_split, tokenizer,
                                         text["mode"])
        dv = corpus_lib.load_text_corpus(path, dev_split, tokenizer,
                                         text["mode"])
    elif name == "synthetic":
        tr = corpus_lib.load_synthetic_text(tokenizer, seed=seed, **c)
        c_dv = dict(c)
        c_dv["n_sents"] = min(64, c.get("n_sents", 64))
        dv = corpus_lib.load_synthetic_text(tokenizer, seed=seed + 1, **c_dv)
    else:
        raise NotImplementedError("corpus `{}`".format(name))
    tr_it = TextBatchIterator(tr, batch_size, "train", seed=seed,
                              pad_multiple=pad_multiple)
    dv_it = TextBatchIterator(dv, batch_size, "eval", seed=seed,
                              pad_multiple=pad_multiple)
    msgs = _data_msg(name, path, str(train_split), len(tr), str(dev_split),
                     len(dv), batch_size, True)
    msgs.append("I/O spec.  | Token type = {}\t| Vocab size = {}".format(
        tokenizer.token_type, tokenizer.vocab_size))
    return tr_it, dv_it, tokenizer.vocab_size, tokenizer, msgs
