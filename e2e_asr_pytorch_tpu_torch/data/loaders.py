"""The training data iterators of the port (counterpart of
``load_dataset(mode="train")`` in e2e_asr_pytorch_tpu/data/loaders.py).

Built from the JAX package's host-only data layer (``_make_audio_ds``,
``AudioBatchIterator``), with the same arguments as its train mode, but
single-process: ``host_rows=None``. The JAX ``load_dataset(mode="train")``
asks ``jax.process_count()`` for its multi-host row split, which would import
JAX; the port never calls it. Multi-GPU data sharding is its own ROADMAP
item.
"""

from __future__ import annotations

from typing import Dict

from e2e_asr_pytorch_tpu.data.batching import AudioBatchIterator
from e2e_asr_pytorch_tpu.data.loaders import _data_msg, _make_audio_ds
from e2e_asr_pytorch_tpu.data.tokenizer import load_text_encoder


def load_train_dataset(njobs: int, ascending: bool, corpus: Dict,
                       audio: Dict, text: Dict, seed: int = 0):
    """Returns (tr_iter, dv_iter or a list of them, feat_dim, vocab_size,
    tokenizer, msgs), as the JAX ``load_dataset`` does in train mode."""
    tokenizer = load_text_encoder(**text)
    c = dict(corpus)
    name = c.pop("name")
    path = c.pop("path", "")
    train_split = c.pop("train_split", None)
    dev_split = c.pop("dev_split", None)
    c.pop("test_split", None)
    bucketing = c.pop("bucketing", True)
    batch_size = c.pop("batch_size", 16)
    subset = c.pop("subset", None)
    if train_split is None:
        raise ValueError("data.corpus.train_split is required for training")
    feat_dim = audio["feat_dim"] * (audio.get("delta_order", 0) + 1)

    tr_ds = _make_audio_ds(name, path, train_split, tokenizer, text["mode"],
                           ascending, subset, **c)
    tr_it = AudioBatchIterator(tr_ds, batch_size, "train",
                               shuffle=not ascending, drop_last=not ascending,
                               seed=seed,
                               time_aug=bool(audio.get("time_aug", False)),
                               pad_multiple=1, njobs=njobs, host_rows=None)

    def dev_iter(split):
        ds = _make_audio_ds(name, path, split, tokenizer, text["mode"], False,
                            subset, **c)
        return ds, AudioBatchIterator(ds, batch_size, "eval", seed=seed,
                                      pad_multiple=1, njobs=njobs)
    if dev_split and isinstance(dev_split[0], list):
        pairs = [dev_iter(s) for s in dev_split]
        n_dv = sum(len(ds) for ds, _ in pairs)
        dv_it = [it for _, it in pairs]
    else:
        dv_ds, dv_it = dev_iter(dev_split)
        n_dv = len(dv_ds)
    msgs = _data_msg(name, path, str(train_split), len(tr_ds),
                     str(dev_split), n_dv, batch_size, bucketing)
    msgs.append("I/O spec.  | Audio Feature = {}\t| Feature Dim = {}\t| "
                "Token Type = {}\t| Vocab Size = {}".format(
                    audio.get("feat_type", "fbank"), feat_dim,
                    tokenizer.token_type, tokenizer.vocab_size))
    return tr_it, dv_it, feat_dim, tokenizer.vocab_size, tokenizer, msgs
