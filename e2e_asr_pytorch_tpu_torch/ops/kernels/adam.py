"""Adam's update of a parameter tree's leaves on the card (``train/optim.py``
Adam and AdamW): one launch of the hand-written kernel in ``csrc/adam.cu``
for every leaf.

``adam_update`` launches on CUDA leaves or raises; it updates the
parameters and the moments in place and reads no scalar back to the host.
Its bits are those of the per-leaf chain it replaces, the optimizer frame's
``_update`` with ``Adam._leaf`` (``train/optim.py``), which stays the one
definition of the arithmetic and runs for leaves off the card. The kernel
replaces no TPU kernel (the JAX package leaves optax's chain to XLA); what
it saves is bytes: the chain reads and writes whole f32 tensors some twenty
times a leaf, the kernel each byte once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from e2e_asr_pytorch_tpu_torch.ops.kernels import build

ADAM_B1 = 0.9
ADAM_B2 = 0.999

# launches of the CUDA kernel in this process (the only global state)
ADAM_LAUNCHES = 0

# elements a chunk (a multiple of the kernel's 4-element vectors), and the
# leaves one launch takes (csrc/adam.cu kMaxLeaves)
CHUNK = 4096
MAX_LEAVES = 64

STATE_DTYPES = (torch.float32, torch.bfloat16)


class Scalars(NamedTuple):
    """The step's 0-dim tensors every leaf reads: the gradients' global
    norm, whether it is finite, whether the clip applies, the signed
    learning rate and Adam's two bias corrections."""
    gnorm: torch.Tensor
    ok: torch.Tensor
    clip_active: torch.Tensor
    step_size: torch.Tensor
    corr1: torch.Tensor
    corr2: torch.Tensor


def plan_chunks(numels: Sequence[int], chunk: int = CHUNK) -> List[int]:
    """The chunk table of one launch: entry l is the number of chunks of
    leaves 0..l together. Leaf l's chunks are those c with
    ends[l - 1] <= c < ends[l]: ceil(numel / chunk) of them, chunk c
    starting at element (c - ends[l - 1]) * chunk of the leaf and holding
    what is left of it, at most ``chunk`` elements (csrc/adam.cu reads the
    table so)."""
    ends, total = [], 0
    for n in numels:
        total += -(-int(n) // chunk)
        ends.append(total)
    return ends


def launch_groups(leaves: Sequence[Tuple]) -> List[List[int]]:
    """The leaves' indices by launch: runs of at most MAX_LEAVES (the
    kernel's table), empty leaves left out."""
    idx = [i for i, (p, _, _, _) in enumerate(leaves) if p.numel()]
    return [idx[k:k + MAX_LEAVES] for k in range(0, len(idx), MAX_LEAVES)]


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("adam")
    lib.adam_update.argtypes = (
        [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 6 + [ctypes.c_float] * 6 + [ctypes.c_int,
                                                          ctypes.c_float,
                                                          ctypes.c_void_p])
    lib.adam_update.restype = ctypes.c_int
    return lib


def check(leaves: Sequence[Tuple], s: Scalars):
    """What the kernel takes: every tensor on one device; each leaf's
    p, g, mu and nu of one shape, p, mu and nu contiguous (the kernel
    writes them in place; a gradient of another layout, such as the tied
    embedding's, is read through a contiguous copy), p and g float32, mu
    and nu of every leaf one dtype, float32 or bfloat16; the scalars 0-dim,
    the two flags bool and the rest float32. Raises on anything else."""
    dev, state = leaves[0][0].device, leaves[0][2].dtype
    for name, x in zip(Scalars._fields, s):
        want = torch.bool if name in ("ok", "clip_active") else torch.float32
        if x.device != dev or x.dim() != 0 or x.dtype != want:
            raise ValueError("{} must be a 0-dim {} tensor on {}, got {} {} "
                             "on {}".format(name, want, dev, x.dtype,
                                            tuple(x.shape), x.device))
    for i, (p, g, mu, nu) in enumerate(leaves):
        for name, x in zip(("p", "g", "mu", "nu"), (p, g, mu, nu)):
            if x.device != dev:
                raise ValueError("leaf {}: {} is on {}, not {}".format(
                    i, name, x.device, dev))
            if x.shape != p.shape:
                raise ValueError("leaf {}: {} has shape {}, p {}".format(
                    i, name, tuple(x.shape), tuple(p.shape)))
            if name != "g" and not x.is_contiguous():
                raise ValueError("leaf {}: {} is not contiguous".format(
                    i, name))
        if p.dtype != torch.float32 or g.dtype != torch.float32 or \
                mu.dtype != state or nu.dtype != state or \
                state not in STATE_DTYPES:
            raise TypeError("leaf {}: p, g must be float32 and mu, nu every "
                            "leaf's one dtype, float32 or bfloat16; got {}, "
                            "{}, {}, {}".format(i, p.dtype, g.dtype, mu.dtype,
                                                nu.dtype))


def _launch(leaves: Sequence[Tuple], s: Scalars, grad_clip: float,
            eps: float, weight_decay: Optional[float]):
    global ADAM_LAUNCHES
    lib = _library()
    index = leaves[0][0].get_device()
    # the raw handle of the device's current stream (torch.cuda's Stream
    # object costs microseconds a call)
    stream = torch._C._cuda_getCurrentRawStream(index)
    consts = (grad_clip, 1.0 - ADAM_B1, ADAM_B1, 1.0 - ADAM_B2, ADAM_B2, eps,
              int(weight_decay is not None), weight_decay or 0.0)
    for idx in launch_groups(leaves):
        group = [(p, g.contiguous(), mu, nu)
                 for p, g, mu, nu in (leaves[i] for i in idx)]
        ends = plan_chunks([p.numel() for p, _, _, _ in group])
        rows = (ctypes.c_longlong * (6 * len(group)))(*[
            v for (p, g, mu, nu), end in zip(group, ends)
            for v in (p.data_ptr(), g.data_ptr(), mu.data_ptr(),
                      nu.data_ptr(), p.numel(), end)])
        args = (len(group), ctypes.addressof(rows), CHUNK,
                int(leaves[0][2].dtype == torch.bfloat16),
                *(x.data_ptr() for x in s), *consts, stream)
        if index == torch.cuda.current_device():
            err = lib.adam_update(*args)
        else:
            with torch.cuda.device(index):
                err = lib.adam_update(*args)
        if err != 0:
            raise RuntimeError("adam_update launch failed: cudaError "
                               "{}".format(err))
        ADAM_LAUNCHES += 1


def adam_update(leaves: Sequence[Tuple], s: Scalars, grad_clip: float,
                eps: float, weight_decay: Optional[float] = None):
    """Each (p, g, mu, nu) of the CUDA ``leaves`` updated in place by Adam's
    rule (AdamW's with ``weight_decay``): one launch of the kernel per
    MAX_LEAVES leaves, after ``check``."""
    if leaves:
        if leaves[0][0].device.type != "cuda":
            raise ValueError("adam_update runs on cuda, got {}".format(
                leaves[0][0].device))
        check(leaves, s)
        _launch(leaves, s, grad_clip, eps, weight_decay)
