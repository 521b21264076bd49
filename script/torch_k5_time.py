#!/usr/bin/env python3
"""Time the resident LSTM kernels, forward (K5f) and backward (K5b), at their
main paths' shapes on the card.

    python3 script/torch_k5_time.py

Prints the median of 20 launches of each (CUDA events, bf16 streams, the
forward with stashes, the backward from them) at the single-direction
listener's shapes and the 4x LSTM-1024 LM's. To compare two commits, unpack
the other one beside this checkout, copy this file into its script/ and run
both in turns in one go on one card: the kernels share csrc/lstm_common.cuh,
csrc/lstm_fwd.cu and csrc/lstm_bwd.cu with kernels that change.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = [(400, 16, 1280), (160, 128, 1024), (200, 8, 1280)]


def _median_ms(fn, start, end):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main():
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as K
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(5)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for t, b, h in SHAPES:
        xg = torch.randn(t, b, 4 * h, generator=gen).to(dev, torch.bfloat16)
        w_h = (torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to(dev)
        dy = torch.randn(t, b, h, generator=gen).to(dev, torch.bfloat16)
        _, cs, gs = K.lstm_fwd(xg, w_h, False, stash=True)
        f_ms = _median_ms(lambda: K.lstm_fwd(xg, w_h, False, stash=True),
                          start, end)
        b_ms = _median_ms(lambda: K.lstm_bwd(w_h, cs, gs, dy, False), start,
                          end)
        out.append("T={} B={} H={}: K5f {:.4f} ms, K5b {:.4f} ms".format(
            t, b, h, f_ms, b_ms))
    print("K5 in {}: {}".format(os.path.basename(ROOT), " | ".join(out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
