"""Device-idle milliseconds a step in the gaps the trace names after the LM
step's ``optimizer`` span (the host inside it at a gap's middle):
``optimizer.step`` in ``train_lm.train_step``; over the LM cell's traced
window."""

from harness import span_idle


def read(ctx):
    return span_idle.idle_ms(ctx, "lm", "optimizer")
