"""Device-idle milliseconds a step in the gaps the trace names after the ASR
step's ``optimizer`` span (the host inside it at a gap's middle):
Adadelta's step over every leaf (``optimizer.step`` in
``train_asr.train_step``); over the ASR cell's traced window."""

from harness import span_idle


def read(ctx):
    return span_idle.idle_ms(ctx, "asr", "optimizer")
