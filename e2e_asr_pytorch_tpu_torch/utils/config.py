"""Experiment configuration.

The YAML schema is identical to the reference's (reference: config/README.md,
main.py:12-63) so its config files port verbatim:

    data:   {corpus: {...}, audio: {...}, text: {mode, vocab_file}}
    hparas: {valid_step, max_step, optimizer, lr, ...}
    model:  {ctc_weight, encoder: {...}, attention: {...}, decoder: {...}}
    emb:    optional embedding-regularizer plugin block
    src:    (test mode) {config, ckpt}
    decode: (test mode) {beam_size, ctc_weight, lm_*, min/max_len_ratio}

Default solver constants mirror reference src/option.py:2-10.
"""

from __future__ import annotations

import argparse
import os
import random
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import yaml

DEFAULT_HPARAS = {
    "GRAD_CLIP": 5.0,       # grad-norm clip threshold
    "PROGRESS_STEP": 100,   # stdout refresh frequency (steps)
    "DEV_STEP_RATIO": 1.2,  # validation decode steps = ratio * label len
    "DEV_N_EXAMPLE": 4,     # examples shown per validation
    "TB_FLUSH_FREQ": 180,   # tensorboard flush period (secs)
}


def load_config(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return yaml.load(f, Loader=yaml.FullLoader)


@dataclass
class Paras:
    """Runtime flags — the argparse surface of the reference's main.py."""

    config: str = ""
    name: Optional[str] = None
    logdir: str = "log/"
    ckpdir: str = "ckpt/"
    outdir: str = "result/"
    load: Optional[str] = None
    seed: int = 0
    cudnn_ctc: bool = False  # accepted for CLI parity; no-op here
    njobs: int = 4
    cpu: bool = False
    no_pin: bool = False
    test: bool = False
    no_msg: bool = False
    lm: bool = False
    amp: bool = False        # accepted for parity; bf16 is a config choice here
    reserve_gpu: float = 0.0  # accepted for parity; XLA manages HBM
    jit: bool = True
    deterministic: bool = False
    profile: bool = False
    upstream: Optional[str] = None
    upstream_feature_selection: Optional[str] = None
    upstream_refresh: bool = False
    upstream_ckpt: Optional[str] = None
    upstream_trainable: bool = False
    n_devices: Optional[int] = None  # restrict the mesh (default: all)
    n_model: int = 1         # tensor-parallel axis size (mesh = data x model)
    override: list = field(default_factory=list)  # dotted config overrides
    verbose: bool = True
    pin_memory: bool = True
    gpu: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="E2E ASR framework (PyTorch/CUDA port).")
    p.add_argument("--config", type=str, help="Path to experiment config.")
    p.add_argument("--name", default=None, type=str, help="Name for logging.")
    p.add_argument("--logdir", default="log/", type=str)
    p.add_argument("--ckpdir", default="ckpt/", type=str)
    p.add_argument("--outdir", default="result/", type=str)
    p.add_argument("--load", default=None, type=str, help="Load pre-trained model")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--cudnn-ctc", action="store_true", dest="cudnn_ctc",
                   help="(parity no-op) CuDNN CTC switch")
    p.add_argument("--njobs", default=4, type=int, help="Host data workers")
    p.add_argument("--cpu", action="store_true", help="Force CPU backend")
    p.add_argument("--no-pin", action="store_true", dest="no_pin")
    p.add_argument("--test", action="store_true", help="Test the model")
    p.add_argument("--no-msg", action="store_true", dest="no_msg")
    p.add_argument("--lm", action="store_true", help="Train LM instead of ASR")
    p.add_argument("--amp", action="store_true", help="(parity) use bf16 compute")
    p.add_argument("--reserve_gpu", default=0, type=float, help="(parity no-op)")
    p.add_argument("--jit", action="store_true", help="(always on) jit compile")
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="Capture a torch.profiler device trace of a few "
                        "training steps into the log dir")
    p.add_argument("--upstream", default=None, type=str,
                   help="Pluggable upstream feature source name")
    p.add_argument("--upstream_feature_selection", default=None, type=str)
    p.add_argument("--upstream_refresh", action="store_true")
    p.add_argument("--upstream_ckpt", default=None, type=str)
    p.add_argument("--upstream_trainable", action="store_true")
    p.add_argument("--n-devices", default=None, type=int, dest="n_devices",
                   help="Restrict the data-parallel mesh to the first N "
                        "devices (default: all visible devices)")
    p.add_argument("--override", default=[], nargs="*",
                   help="Dotted-path config overrides, e.g. "
                        "data.corpus.path=/data/LibriSpeech hparas.lr=0.5")
    p.add_argument("--n-model", default=1, type=int, dest="n_model",
                   help="Tensor-parallel axis size: the mesh becomes "
                        "(n_devices/n_model) x n_model over ('data','model') "
                        "and large weights shard their output dim on 'model'")
    return p


def parse_paras(argv=None) -> Paras:
    args = build_argparser().parse_args(argv)
    paras = Paras(**{k: v for k, v in vars(args).items() if k in Paras.__dataclass_fields__})
    paras.verbose = not args.no_msg
    paras.pin_memory = not args.no_pin
    return paras


def set_seed(seed: int) -> None:
    """Seed python/numpy; torch Generators are derived explicitly from this seed."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ.setdefault("PYTHONHASHSEED", str(seed))


def exp_name(paras: Paras) -> str:
    # default experiment name = config filename + _sd<seed>
    if paras.name is not None:
        return paras.name
    base = os.path.splitext(os.path.basename(paras.config))[0]
    return "{}_sd{}".format(base, paras.seed)


def apply_overrides(config, overrides):
    """Apply --override entries (dotted.path=value, YAML-typed values)."""
    for ov in overrides or []:
        path, _, raw = ov.partition("=")
        assert _, "--override entries must look like dotted.path=value"
        val = yaml.load(raw, Loader=yaml.FullLoader)
        node = config
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val
    return config
