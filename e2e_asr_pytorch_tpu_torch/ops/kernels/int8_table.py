"""The int8 attention value table of the folded decoder (counterpart of
e2e_asr_pytorch_tpu/ops/pallas/int8_table.py).

``quantize_table`` stores a (B,T,D) value table as int8 with a per-(b,t)
symmetric scale, once per training step. Every decode step then reduces the
raw int8 table twice, with the scale folded into the small operand:

  * ``context_int8`` (K3): ctx[b,:] = sum_t attn2[b,t] * q[b,t,:], where
    attn2 = attn * scale;
  * ``dattn_int8`` (K4): draw[b,t] = sum_d dctx[b,d] * q[b,t,d], the caller
    applying d_attn = draw * scale afterwards.

Both round the small operand to bf16 before the product and sum in f32, as
the TPU kernels do. Each dispatches on the tensors' device: a CPU tensor
goes to the plain PyTorch version (``*_ref``), a CUDA tensor to the
hand-written kernel in ``csrc/int8_table.cu`` (or raises). The TPU version's
tile padding (``pad_table``) has no counterpart: the CUDA kernels take any
(B,T,D) and mask their own edges.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from e2e_asr_pytorch_tpu_torch.ops.kernels import build

# launches of the CUDA kernels in this process (the only global state)
CTX_LAUNCHES = 0
DATTN_LAUNCHES = 0


def quantize_table(values: torch.Tensor):
    """Per-(b,t) symmetric int8 quantization of a (B,T,D) value table.
    Returns (q int8 (B,T,D), scale f32 (B,T)) with q * scale ~= values."""
    v = values.float()
    absmax = v.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(v / scale), -127.0, 127.0).to(torch.int8)
    return q, scale[..., 0]


def dequantize_table(q: torch.Tensor, scale: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """(B,T,D) int8 + (B,T) scale -> (B,T,D) ``dtype`` values."""
    return (q.float() * scale[..., None]).to(dtype)


def _small_operand(x: torch.Tensor) -> torch.Tensor:
    """bf16(x), the reductions' small operand, held exactly in f32."""
    return x.to(torch.bfloat16).float()


def context_int8_ref(attn2: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: bf16 attention weights, f32 sums."""
    return torch.einsum("bt,btd->bd", _small_operand(attn2), q.float())


def dattn_int8_ref(dctx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: bf16 context cotangent, f32 sums."""
    return torch.einsum("bd,btd->bt", _small_operand(dctx), q.float())


# The CUDA kernels' grids (csrc/int8_table.cu). THREADS and LANES are the
# source's kThreads and kLanesMax.
VEC = 16
THREADS = 512
LANES = 256


class Grid(NamedTuple):
    parts: int   # blocks a batch row: K3's D-slices, K4's t-ranges
    size: int    # a slice's 16-column chunks, a t-range's rows (the last
                 # part may hold fewer)
    lanes: int   # the block (lanes, groups): a lane a 16-column chunk, a
    groups: int  # group every groups-th row


def _parts(b: int, n: int, n_sm: int):
    """(parts, size): n cut into as many equal parts as one wave of blocks
    allows, one block an SM (a second block on an SM would double that
    SM's share), none of them empty."""
    parts = max(1, min(n_sm // b, n))
    size = -(-n // parts)
    return -(-n // size), size


@functools.lru_cache(maxsize=None)
def ctx_grid(b: int, t: int, d: int, n_sm: int) -> Grid:
    """K3's launch geometry for a (b, t, d) table on ``n_sm`` SMs: D-slices,
    each block all T rows of one slice of one batch row (so no block needs
    another's sums); a lane a chunk of the slice, the groups filling the
    block up to THREADS."""
    parts, size = _parts(b, -(-d // VEC), n_sm)
    lanes = min(size, LANES)
    return Grid(parts, size, lanes, THREADS // lanes)


@functools.lru_cache(maxsize=None)
def dattn_grid(b: int, t: int, d: int, n_sm: int) -> Grid:
    """K4's launch geometry: t-ranges, each block one t-range of one batch
    row, all of D (so no block needs another's sums); the lanes cover D's
    chunks in whole warps (in passes where there are more than LANES)."""
    parts, size = _parts(b, t, n_sm)
    lanes = min(-(-d // (32 * VEC)) * 32, LANES)
    return Grid(parts, size, lanes, THREADS // lanes)


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("int8_table")
    for fn in (lib.context_int8, lib.dattn_int8):
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(small: torch.Tensor, q: torch.Tensor, axis: int, name: str):
    shape = q.shape
    if len(shape) != 3 or q.dtype != torch.int8:
        raise TypeError("q must be an int8 (B,T,D) table, got {} {}".format(
            q.dtype, tuple(shape)))
    got = small.shape
    if len(got) != 2 or got[0] != shape[0] or got[1] != shape[axis]:
        raise ValueError("{} must be {}, got {}".format(
            name, (shape[0], shape[axis]), tuple(got)))
    if small.device != q.device:
        raise ValueError("{} and q must share a device, got {} and {}".format(
            name, small.device, q.device))
    if min(shape) < 1:
        raise ValueError("empty table: {}".format(tuple(shape)))


def _launch(fn, rule, small: torch.Tensor, q: torch.Tensor, out_cols: int):
    """One launch of K3 or K4 (``fn``, its grid ``rule``) on q's device and
    its current stream. The kernels read their operands contiguous and
    small as f32; an unaligned table takes their byte-by-byte path."""
    if small.dtype != torch.float32 or not small.is_contiguous():
        small = small.float().contiguous()
    if not q.is_contiguous():
        q = q.contiguous()
    b, t, d = q.shape
    index = q.get_device()
    out = torch.empty(b, out_cols, dtype=torch.float32, device=q.device)
    args = (small.data_ptr(), q.data_ptr(), out.data_ptr(), b, t, d,
            *rule(b, t, d, _sm_count(index)),
            # the raw handle of the device's current stream: torch.cuda's
            # Stream object costs microseconds a call, hundreds a step
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError("{} launch failed: cudaError {}".format(
            fn.__name__, err))
    return out


def _on_card(q: torch.Tensor, name: str) -> bool:
    """Whether q's reduction launches the kernel (cuda) or runs the plain
    version (cpu); any other device is refused."""
    if q.is_cuda:
        return True
    if q.device.type != "cpu":
        raise ValueError("{} runs on cpu (plain version) or cuda (kernel), "
                         "got {}".format(name, q.device))
    return False


def context_int8(attn2: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """ctx[b,:] = sum_t bf16(attn2[b,t]) * q[b,t,:]. attn2 (B,T) f32 with the
    dequant scale folded in, q (B,T,D) int8. Returns (B,D) f32."""
    global CTX_LAUNCHES
    _check(attn2, q, 1, "attn2")
    if not _on_card(q, "context_int8"):
        return context_int8_ref(attn2, q)
    out = _launch(_library().context_int8, ctx_grid, attn2, q, q.shape[2])
    CTX_LAUNCHES += 1
    return out


def dattn_int8(dctx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """draw[b,t] = sum_d bf16(dctx[b,d]) * q[b,t,d] (the caller multiplies by
    the scale). dctx (B,D) f32, q (B,T,D) int8. Returns (B,T) f32."""
    global DATTN_LAUNCHES
    _check(dctx, q, 2, "dctx")
    if not _on_card(q, "dattn_int8"):
        return dattn_int8_ref(dctx, q)
    out = _launch(_library().dattn_int8, dattn_grid, dctx, q, q.shape[1])
    DATTN_LAUNCHES += 1
    return out
