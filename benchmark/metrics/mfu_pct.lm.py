"""The LM step's model FLOPs (stacked LSTM and output projection, forward
and backward, at the batch's padded shape) over the traced window and
989 TFLOP/s, in %."""

from harness import readers


def read(ctx):
    return readers.mfu_pct(ctx, "lm")
