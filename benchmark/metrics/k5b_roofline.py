"""K5b, the backward LSTM recurrence of a hidden size K5 holds
(``lstm_bwd_chunked_kernel<T, D, 16>``, ``csrc/lstm_bwd.cu``: K6b's
template in tiles of 16 units): one launch a layer over (T,B,H), bound
from the shapes over its device time, in %. K6b's launches (tiles of 32)
are not counted."""

from harness import flops, instances

NAME, UNITS = "lstm_bwd_chunked_kernel", 16


def read(ctx):
    if ctx.family != "lm":
        return None
    h = ctx.prog.model["dim"]
    return instances.roofline_pct(
        ctx, NAME, UNITS, lambda s: flops.lstm_bound(s["T"], s["B"], h, 1)[0])
