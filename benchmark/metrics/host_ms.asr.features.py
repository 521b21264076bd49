"""Host milliseconds a step inside the ASR step's ``features`` span: fbank
features with deltas and SpecAugment (``train_asr.features``); over the ASR
cell's traced window."""

from harness import readers


def read(ctx):
    return readers.span_ms(ctx, "asr", "features")
