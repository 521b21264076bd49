"""The ASR step's model FLOPs (VGG frontend, BLSTM layers and projections,
CTC head, attention and decoder over every position, output projection;
forward and backward, at the batch's padded shape) over the traced window
and 989 TFLOP/s, in %."""

from harness import readers


def read(ctx):
    return readers.mfu_pct(ctx, "asr")
