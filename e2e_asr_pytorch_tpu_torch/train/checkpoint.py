"""Torch-native checkpoints with the JAX package's keys, and the JAX
package's own checkpoints read (port of
e2e_asr_pytorch_tpu/train/checkpoint.py).

A checkpoint holds {"model": params tree, "optimizer": optimizer state or
None, "global_step", "metric_name", "metric_value"} -- the keys of the JAX
checkpoint -- written with ``torch.save`` to a sibling temp file and renamed
into place, so a crash mid-write never corrupts an existing file, and read
back with ``torch.load(weights_only=True)``. ``AsyncCheckpointWriter``
overlaps the write with training.

``load_checkpoint`` also reads a checkpoint the JAX package wrote: flax's
msgpack of the state-dict form (lists, tuples and NamedTuples as dicts
keyed '0', '1', ... or by field name; an ndarray as msgpack ext type 1
holding [shape, dtype name, raw bytes]; an array over flax's chunk size
split into a ``__msgpack_chunked_array__`` dict, joined back here).
``unpackb`` decodes the
subset of msgpack flax writes by hand, with no msgpack package; the trees
then go through ``convert.restore_lists`` and ``from_jax_params`` /
``from_jax_opt_state`` into the port's layouts. A ``torch.save`` file
starts with the zip magic ``PK``, a flax one with a msgpack map byte.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from e2e_asr_pytorch_tpu_torch import convert


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


# ---------------------------------------------------------------------------
# the JAX package's flax-msgpack checkpoints
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _ndarray(data):
    """flax's ndarray ext payload: msgpack [shape, dtype name, raw bytes]
    (the bytes stay a view of the file's buffer until converted). bfloat16
    has no numpy dtype: its int16 bits come back as ``convert.BF16Bits``."""
    shape, name, raw = unpackb(data)
    if name == "bfloat16":
        return convert.BF16Bits(np.frombuffer(raw, np.int16).reshape(shape))
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def unpackb(buf) -> Any:
    """Decode one msgpack object: maps, arrays, str, bin, ints, floats,
    bool, nil and ext (flax's ndarray and numpy-scalar types decoded,
    others refused)."""
    view = memoryview(buf)
    obj, end = _unpack(view, 0)
    if end != len(view):
        raise ValueError("{} bytes after the msgpack object".format(
            len(view) - end))
    return obj


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H",
        0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I",
        0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _unpack(v: memoryview, i: int):
    b = v[i]
    i += 1
    if b <= 0x7f:
        return b, i
    if b >= 0xe0:
        return b - 0x100, i
    if 0x80 <= b <= 0x8f:
        return _map(v, i, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _array(v, i, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return str(v[i:i + n], "utf-8"), i + n
    if b == 0xc0:
        return None, i
    if b in (0xc2, 0xc3):
        return b == 0xc3, i
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, v, i)[0], i + struct.calcsize(fmt)
    if b in _FIXEXT:
        return _ext(v, i + 1, v[i], _FIXEXT[b])
    if b not in _LEN:
        raise ValueError("msgpack type byte 0x{:02x} is not one flax "
                         "writes".format(b))
    fmt = _LEN[b]
    n = struct.unpack_from(fmt, v, i)[0]
    i += struct.calcsize(fmt)
    if b <= 0xc6:                                   # bin
        return v[i:i + n], i + n
    if b <= 0xc9:                                   # ext
        return _ext(v, i + 1, v[i], n)
    if b <= 0xdb:                                   # str
        return str(v[i:i + n], "utf-8"), i + n
    if b <= 0xdd:
        return _array(v, i, n)
    return _map(v, i, n)


def _map(v, i, n):
    out = {}
    for _ in range(n):
        k, i = _unpack(v, i)
        out[k], i = _unpack(v, i)
    return out, i


def _array(v, i, n):
    out = []
    for _ in range(n):
        x, i = _unpack(v, i)
        out.append(x)
    return out, i


def _ext(v, i, code, n):
    data = v[i:i + n]
    if code == _EXT_NDARRAY:
        return _ndarray(data), i + n
    if code == _EXT_NPSCALAR:
        x = _ndarray(data)
        return (x if isinstance(x, convert.BF16Bits) else x[()]), i + n
    raise ValueError("msgpack ext type {} is not one the JAX package's "
                     "checkpoints hold".format(code))


def _unchunk(node):
    """flax's chunked form of an array over its chunk size, joined back."""
    if isinstance(node, dict):
        if "__msgpack_chunked_array__" in node:
            shape = [node["shape"][str(i)] for i in range(len(node["shape"]))]
            chunks = [node["chunks"][str(i)]
                      for i in range(len(node["chunks"]))]
            if isinstance(chunks[0], convert.BF16Bits):
                return convert.BF16Bits(np.concatenate(
                    [c.bits for c in chunks]).reshape(shape))
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(x) for k, x in node.items()}
    return node


def is_jax_checkpoint(path: str) -> bool:
    """A flax msgpack payload (a map first) rather than a torch.save zip."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"PK":
        return False
    return len(head) > 0 and (0x80 <= head[0] <= 0x8f
                              or head[0] in (0xde, 0xdf))


def load_jax_checkpoint(path: str, device, params_template,
                        opt_template=None) -> Dict[str, Any]:
    """A checkpoint the JAX package wrote, in the port's trees: the model
    restored against ``params_template`` (the port's parameter tree, which
    gives back its lists) and put in port layouts; the optimizer state,
    when ``opt_template`` is given (its presence asks for it), through
    ``convert.from_jax_opt_state``."""
    if params_template is None:
        raise ValueError("{} is a JAX package checkpoint: it is restored "
                         "against the port's parameter tree, pass "
                         "params_template".format(path))
    with open(path, "rb") as f:
        payload = _unchunk(unpackb(f.read()))
    if "model" not in payload:
        raise ValueError("{} holds no 'model' entry".format(path))
    out = {k: v for k, v in payload.items()
           if k not in ("model", "optimizer", "extra")}
    out["model"] = convert.from_jax_params(
        convert.restore_lists(payload["model"], params_template), device)
    out["optimizer"] = None
    if opt_template is not None and payload.get("optimizer") is not None:
        out["optimizer"] = convert.from_jax_opt_state(
            payload["optimizer"], device, template=params_template)
    return out


def load_checkpoint(path: str, device=None, params_template=None,
                    opt_template=None) -> Dict[str, Any]:
    """Load a checkpoint; the model tree (and the optimizer state, if any)
    land on ``device``. A JAX package checkpoint goes through
    ``load_jax_checkpoint`` with the templates."""
    if is_jax_checkpoint(path):
        return load_jax_checkpoint(path, device, params_template,
                                   opt_template)
    payload = torch.load(path, map_location=device or "cpu", weights_only=True)
    if "model" not in payload:
        raise ValueError("{} holds no 'model' entry".format(path))
    return payload
