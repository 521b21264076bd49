"""Host milliseconds a step inside the LM step's ``place`` span: the batch's
copy to the card (``train_lm._to_device``); over the LM cell's traced
window."""

from harness import readers


def read(ctx):
    return readers.span_ms(ctx, "lm", "place")
