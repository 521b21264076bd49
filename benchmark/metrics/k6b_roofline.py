"""K6b, the chunked backward LSTM recurrence (``lstm_bwd_chunked_kernel``,
``csrc/lstm_bwd.cu``): one launch a layer over (T,B,H), bound from the
shapes over its device time, in %."""

from harness import flops, readers

NAMES = ("lstm_bwd_chunked_kernel",)


def read(ctx):
    if ctx.family != "lm":
        return None
    h = ctx.prog.model["dim"]
    return readers.roofline_pct(
        ctx, NAMES, lambda s: flops.lstm_bound(s["T"], s["B"], h, 1)[0])
