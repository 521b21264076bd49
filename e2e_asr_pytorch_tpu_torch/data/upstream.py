"""Pluggable upstream feature extractors for ``--upstream`` (the port's own
counterpart of e2e_asr_pytorch_tpu/data/upstream.py).

An upstream is a callable (wav (B,S) f32, wav_len (B,)) -> (feat (B,T,D)
f32, feat_len (B,)) on the waveform's device, plus its output dim D. The
solvers call it in place of ``extract_features`` under ``torch.no_grad()``:
its weights are constants, outside the ASR parameters, their optimizer
state and their checkpoints.

Built-ins:
  * ``fbank80`` -- 80-dim log-mel;
  * ``apc``     -- the pretrained APC LSTM encoder (``models/apc.py``),
    weights from $APC_CKPT (default ``ckpt/apc.npz``, the JAX package's
    ``.npz`` layout); when no checkpoint exists one is pretrained on the
    synthetic corpus first (``python -m e2e_asr_pytorch_tpu_torch.train_apc``
    pretrains on a real one).

Register your own with @register_upstream (eager, fixed dim) or
register_upstream_factory (lazy: ``factory(device) -> (fn, dim)`` runs on
first use, given the device the caller runs on).
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict, Tuple


_REGISTRY: Dict[str, Tuple[Callable, int]] = {}
_FACTORIES: Dict[str, Callable] = {}


def register_upstream(name: str, out_dim: int):
    def deco(fn):
        _REGISTRY[name] = (fn, out_dim)
        return fn
    return deco


def register_upstream_factory(name: str, factory):
    """Lazy registration: ``factory(device) -> (fn, out_dim)`` runs on first
    use."""
    _FACTORIES[name] = factory


def get_upstream(name: str, device="cuda"):
    """(fn, out_dim) of a registered upstream; a lazy one is built on first
    use for ``device`` (the card unless the caller asks for the CPU)."""
    if name not in _REGISTRY and name in _FACTORIES:
        _REGISTRY[name] = _FACTORIES[name](device)
    if name not in _REGISTRY:
        raise KeyError(
            "upstream `{}` is not registered (available: {}). Register one "
            "with e2e_asr_pytorch_tpu_torch.data.upstream.register_upstream"
            .format(name, sorted(set(_REGISTRY) | set(_FACTORIES))))
    return _REGISTRY[name]


def _builtin_fbank80():
    from e2e_asr_pytorch_tpu_torch.ops.audio import (FeatureConfig,
                                                     extract_features)
    cfg = FeatureConfig(feat_type="fbank", feat_dim=80, delta_order=0)

    @register_upstream("fbank80", cfg.out_dim)
    def fbank80(wav, wav_len):
        return extract_features(cfg, wav, wav_len)


def _builtin_apc(device):
    """APC upstream: weights from $APC_CKPT (default ckpt/apc.npz); when no
    checkpoint exists one is pretrained on the synthetic corpus on
    ``device`` and written there first."""
    from e2e_asr_pytorch_tpu_torch.models import apc as A
    path = os.environ.get("APC_CKPT", os.path.join("ckpt", "apc.npz"))
    if not os.path.exists(path):
        print("[upstream] no APC checkpoint at `{}` -- auto-pretraining on "
              "the synthetic corpus (for real representations run "
              "python -m e2e_asr_pytorch_tpu_torch.train_apc on LibriSpeech "
              "and/or set $APC_CKPT)".format(path), file=sys.stderr)
        _auto_pretrain_apc(path, device=device)
    params, spec = A.load_apc(path)
    return A.make_upstream(params, spec), spec.hidden


def _auto_pretrain_apc(path: str, steps: int = 150, batch: int = 8,
                       seconds: float = 2.0, device="cuda"):
    """A small but real APC checkpoint (3x LSTM-512 over 80 mels) from
    synthetic audio: ``steps`` steps of ``batch`` random ``seconds`` crops
    of 64 utterances of 4-11 tones (``train_apc``'s corpus and batches)."""
    from e2e_asr_pytorch_tpu_torch import train_apc
    from e2e_asr_pytorch_tpu_torch.models import apc as A

    spec = A.APCSpec(input_dim=80, hidden=512, n_layers=3)
    waves = train_apc.collect_corpus("synthetic", 64)
    params = A.pretrain_apc(train_apc.wav_batches(waves, batch, seconds),
                            spec, steps, lr=1e-3, seed=0, device=device)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    A.save_apc(path, params, spec)


_builtin_fbank80()
register_upstream_factory("apc", _builtin_apc)
