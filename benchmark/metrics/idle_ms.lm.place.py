"""Device-idle milliseconds a step in the gaps the trace names after the LM
step's ``place`` span (the host inside it at a gap's middle): the batch's
copy to the card (``train_lm._to_device``); over the LM cell's traced
window."""

from harness import span_idle


def read(ctx):
    return span_idle.idle_ms(ctx, "lm", "place")
