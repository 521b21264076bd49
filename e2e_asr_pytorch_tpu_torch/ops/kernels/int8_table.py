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


def _library():
    lib = build.load("int8_table")
    for fn in (lib.context_int8, lib.dattn_int8):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(small: torch.Tensor, q: torch.Tensor, axis: int, name: str):
    if q.dim() != 3 or q.dtype != torch.int8:
        raise TypeError("q must be an int8 (B,T,D) table, got {} {}".format(
            q.dtype, tuple(q.shape)))
    want = (q.shape[0], q.shape[axis])
    if small.dim() != 2 or tuple(small.shape) != want:
        raise ValueError("{} must be {}, got {}".format(
            name, want, tuple(small.shape)))
    if small.device != q.device:
        raise ValueError("{} and q must share a device, got {} and {}".format(
            name, small.device, q.device))
    if min(q.shape) < 1:
        raise ValueError("empty table: {}".format(tuple(q.shape)))


def _launch(fn, small: torch.Tensor, q: torch.Tensor, out_cols: int):
    b, t, d = q.shape
    small = small.float().contiguous()
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()  # the kernels' 16-byte loads want an aligned base
    out = torch.empty(b, out_cols, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(small.data_ptr(), q.data_ptr(), out.data_ptr(), b, t, d,
                 stream)
    if err != 0:
        raise RuntimeError("{} launch failed: cudaError {}".format(
            fn.__name__, err))
    return out


def context_int8(attn2: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """ctx[b,:] = sum_t bf16(attn2[b,t]) * q[b,t,:]. attn2 (B,T) f32 with the
    dequant scale folded in, q (B,T,D) int8. Returns (B,D) f32."""
    global CTX_LAUNCHES
    _check(attn2, q, 1, "attn2")
    if q.device.type == "cpu":
        return context_int8_ref(attn2, q)
    if q.device.type != "cuda":
        raise ValueError("context_int8 runs on cpu (plain version) or cuda "
                         "(kernel), got {}".format(q.device))
    out = _launch(_library().context_int8, attn2, q, q.shape[2])
    CTX_LAUNCHES += 1
    return out


def dattn_int8(dctx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """draw[b,t] = sum_d bf16(dctx[b,d]) * q[b,t,d] (the caller multiplies by
    the scale). dctx (B,D) f32, q (B,T,D) int8. Returns (B,T) f32."""
    global DATTN_LAUNCHES
    _check(dctx, q, 2, "dctx")
    if q.device.type == "cpu":
        return dattn_int8_ref(dctx, q)
    if q.device.type != "cuda":
        raise ValueError("dattn_int8 runs on cpu (plain version) or cuda "
                         "(kernel), got {}".format(q.device))
    out = _launch(_library().dattn_int8, dctx, q, q.shape[1])
    DATTN_LAUNCHES += 1
    return out
