"""K5f in its wide form, the forward LSTM recurrence of a hidden size K5
holds (``lstm_fwd_chunked_kernel<T, 8>``, ``csrc/lstm_fwd.cu``: K6f's
template in tiles of 8 units): one launch a layer over (T,B,H), bound
from the shapes over its device time, in %. K6f's launches (tiles of 16)
are not counted."""

from harness import flops, instances

NAME, UNITS = "lstm_fwd_chunked_kernel", 8


def read(ctx):
    if ctx.family != "lm":
        return None
    h = ctx.prog.model["dim"]
    return instances.roofline_pct(
        ctx, NAME, UNITS, lambda s: flops.lstm_bound(s["T"], s["B"], h, 1)[0])
