"""Device-idle milliseconds a step in the gaps the trace names after the ASR
step's ``place`` span (the host inside it at a gap's middle): the batch's
copy to the card (``train_asr.to_device``); over the ASR cell's traced
window."""

from harness import span_idle


def read(ctx):
    return span_idle.idle_ms(ctx, "asr", "place")
