"""Host milliseconds a step inside the LM step's ``optimizer`` span:
``optimizer.step`` in ``train_lm.train_step``; over the LM cell's traced
window."""

from harness import readers


def read(ctx):
    return readers.span_ms(ctx, "lm", "optimizer")
