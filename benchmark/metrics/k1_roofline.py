"""K1, the direction-packed BLSTM forward (``bilstm_resident_kernel`` or
its streamed form ``bilstm_fwd_kernel``, ``csrc/bilstm_fwd.cu``): one
launch an encoder layer over both directions of (T,B,H), bound from the
shapes over its device time, in %."""

from harness import flops, readers

NAMES = ("bilstm_resident_kernel", "bilstm_fwd_kernel")


def read(ctx):
    if ctx.family != "asr":
        return None
    dims = ctx.prog.model["encoder"]["dim"]
    return readers.roofline_pct(
        ctx, NAMES, lambda s: sum(flops.lstm_bound(s["T"], s["B"], h, 2)[0]
                                  for h in dims) / len(dims))
