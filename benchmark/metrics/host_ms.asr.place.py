"""Host milliseconds a step inside the ASR step's ``place`` span: the
batch's copy to the card (``train_asr.to_device``); over the ASR cell's
traced window."""

from harness import readers


def read(ctx):
    return readers.span_ms(ctx, "asr", "place")
