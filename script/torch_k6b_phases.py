#!/usr/bin/env python3
"""Where a step of the chunked LSTM backward (K6b) goes, on the card.

    python3 script/torch_k6b_phases.py

Builds copies of csrc/lstm_bwd.cu with the products switched off, the copies
switched off (the ring's barriers still complete, the tiles hold garbage),
or both, and times each against the kernel as it is at T=160 B=128 H=2048
bf16 (the flagship LM's shape), the kernel alone, w_h packed beforehand.
The copies' results are wrong by construction: only their times are read.
The production source is not touched: each copy is built beside the
package's other libraries, in the build directory git ignores.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "e2e_asr_pytorch_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "e2e_asr_pytorch_tpu_torch", "ops", "kernels",
                   "_build", "k6b_phases")

NO_PRODUCTS = [("wgmma_k16(acc[kk % kChains], da + 2 * kk, db + 2 * kk);",
                "(void)da; (void)db;")]
NO_COPIES = [("""          if (lane == 0) {
            const bool streamed = !walk.resident();""",
              """          if (lane == 0) { mbar_arrive(full + st); } if (false) {
            const bool streamed = !walk.resident();""")]
VARIANTS = {"as is": [], "no products": NO_PRODUCTS, "no copies": NO_COPIES,
            "neither": NO_PRODUCTS + NO_COPIES}


def _build(name, patches):
    from e2e_asr_pytorch_tpu_torch.ops.kernels import build
    src = open(os.path.join(CSRC, "lstm_bwd.cu")).read()
    for old, new in patches:
        if old not in src:
            raise RuntimeError("the source no longer has the text to patch "
                               "for '{}'".format(name))
        src = src.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    tag = name.replace(" ", "_")
    path = os.path.join(OUT, "lstm_bwd_{}.cu".format(tag))
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(OUT, "lib_{}.so".format(tag))
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", CSRC, "-o",
                          lib, path], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-3000:])
    out = ctypes.CDLL(lib)
    out.lstm_bwd_chunked.argtypes = ([ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    out.lstm_bwd_chunked.restype = ctypes.c_int
    return out


def main():
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as K
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(5)
    t, b, h = 160, 128, 2048
    xg = torch.randn(t, b, 4 * h, generator=gen).to(dev, torch.bfloat16)
    w_h = (torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to(dev)
    dy = torch.randn(t, b, h, generator=gen).to(dev, torch.bfloat16)
    _, cs, gs = K.lstm_fwd_chunked(xg, w_h, stash=True)
    hp, tiles_per_block, resident = K.chunked_bwd_plan(h, b, dev)
    wp = K.pack_chunked_bwd(w_h, hp)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for name, patches in VARIANTS.items():
        lib = _build(name, patches)

        def run():
            dxg = torch.empty(t, b, 4 * h, dtype=torch.float32, device=dev)
            xbuf = torch.zeros(2, -(-b // 64), 4 * hp // 64, 64, 64,
                               dtype=torch.bfloat16, device=dev)
            step = torch.zeros(1, dtype=torch.int32, device=dev)
            dc = torch.zeros(b, hp, dtype=torch.float32, device=dev)
            err = lib.lstm_bwd_chunked(
                gs.data_ptr(), wp.data_ptr(), cs.data_ptr(), dy.data_ptr(),
                dxg.data_ptr(), xbuf.data_ptr(), dc.data_ptr(),
                step.data_ptr(), t, b, hp, tiles_per_block, resident, 0,
                K._BWD_CHUNKED_UNITS, 1, 0,
                torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError("launch failed: cudaError {}".format(err))
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = sorted(times)[len(times) // 2]
        print("K6b {}: {:.3f} ms, {:.2f} us a step".format(name, ms,
                                                         ms * 1e3 / t),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
