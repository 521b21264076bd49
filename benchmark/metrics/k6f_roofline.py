"""K6f, the chunked forward LSTM recurrence (``lstm_fwd_chunked_kernel``,
``csrc/lstm_fwd.cu``): one launch a layer over (T,B,H), bound from the
shapes over its device time, in %."""

from harness import flops, readers

NAMES = ("lstm_fwd_chunked_kernel",)


def read(ctx):
    if ctx.family != "lm":
        return None
    h = ctx.prog.model["dim"]
    return readers.roofline_pct(
        ctx, NAMES, lambda s: flops.lstm_bound(s["T"], s["B"], h, 1)[0])
