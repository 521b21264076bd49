"""Torch-native checkpoints with the JAX package's keys (port of
e2e_asr_pytorch_tpu/train/checkpoint.py).

A checkpoint holds {"model": params tree, "optimizer": optimizer state or
None, "global_step", "metric_name", "metric_value"} -- the keys of the JAX
checkpoint -- written with ``torch.save`` to a sibling temp file and renamed
into place, so a crash mid-write never corrupts an existing file, and read
back with ``torch.load(weights_only=True)``. ``AsyncCheckpointWriter``
overlaps the write with training. Reading the JAX package's flax-msgpack
checkpoints is a later ROADMAP item (JAX-checkpoint import).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

import torch


def _snapshot(tree):
    """A host copy of every tensor leaf: never a view of a live tensor (the
    optimizer updates parameters in place), so a background write sees the
    values of the moment it was asked for."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _build_payload(params, opt_state, step: int, metric_name: str,
                   metric_value: float) -> Dict[str, Any]:
    return {"model": _snapshot(params), "optimizer": _snapshot(opt_state),
            "global_step": int(step), "metric_name": metric_name,
            "metric_value": float(metric_value)}


def _atomic_write(path: str, payload: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = "{}.tmp.{}".format(path, os.getpid())
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, params, step: int = 0, metric_name: str = "",
                    metric_value: float = 0.0, opt_state=None) -> None:
    _atomic_write(path, _build_payload(params, opt_state, step, metric_name,
                                       metric_value))


class AsyncCheckpointWriter:
    """``save`` takes the host snapshot synchronously, then hands the
    encoding and the file write to one background thread, and training goes
    on. At most one write is in flight: a new save joins the previous one
    first, so files appear in save order. A failed write is raised by the
    next ``save`` or ``wait``, never swallowed."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[Exception] = None

    def save(self, path: str, params, opt_state, step: int,
             metric_name: str = "", metric_value: float = 0.0) -> None:
        self.wait()
        payload = _build_payload(params, opt_state, step, metric_name,
                                 metric_value)

        def _write():
            try:
                _atomic_write(path, payload)
            except Exception as e:  # raised again by wait()
                self._err = e

        self._thread = threading.Thread(target=_write, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        """Join any in-flight write and raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def load_checkpoint(path: str, device=None) -> Dict[str, Any]:
    """Load a checkpoint; the model tree (and the optimizer state, if any)
    land on ``device``."""
    payload = torch.load(path, map_location=device or "cpu", weights_only=True)
    if "model" not in payload:
        raise ValueError("{} holds no 'model' entry".format(path))
    return payload
