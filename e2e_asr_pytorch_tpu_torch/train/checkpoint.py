"""Torch-native checkpoints with the JAX package's keys.

A checkpoint holds {"model": params tree of tensors, "global_step",
"metric_name", "metric_value"} -- the keys of the JAX checkpoint
(e2e_asr_pytorch_tpu/train/checkpoint.py) -- written with ``torch.save`` to
a sibling temp file and renamed into place, and read back with
``torch.load(weights_only=True)``. Reading the JAX package's flax-msgpack
checkpoints is a later ROADMAP item (training runtime and JAX-checkpoint
import).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

from e2e_asr_pytorch_tpu_torch.convert import tree_to


def save_checkpoint(path: str, params, step: int = 0, metric_name: str = "",
                    metric_value: float = 0.0) -> None:
    payload = {"model": tree_to(params, "cpu"), "global_step": int(step),
               "metric_name": metric_name,
               "metric_value": float(metric_value)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = "{}.tmp.{}".format(path, os.getpid())
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, device=None) -> Dict[str, Any]:
    """Load a checkpoint; the model tree lands on ``device``."""
    payload = torch.load(path, map_location=device or "cpu", weights_only=True)
    if "model" not in payload:
        raise ValueError("{} holds no 'model' entry".format(path))
    return payload
