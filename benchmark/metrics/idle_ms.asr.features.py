"""Device-idle milliseconds a step in the gaps the trace names after the ASR
step's ``features`` span (the host inside it at a gap's middle): fbank
features with deltas and SpecAugment (``train_asr.features``); over the ASR
cell's traced window."""

from harness import span_idle


def read(ctx):
    return span_idle.idle_ms(ctx, "asr", "features")
