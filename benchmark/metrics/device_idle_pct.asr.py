"""The share of the ASR cell's traced window in which the card ran no
kernel, copy or memset, in %."""

from harness import readers


def read(ctx):
    return readers.idle_pct(ctx, "asr")
