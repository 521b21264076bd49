"""Host milliseconds a step inside the program's ``forward`` span
(``record_function`` in ``train/train_asr.py``), over the ASR cell's
traced window."""

from harness import readers


def read(ctx):
    return readers.span_ms(ctx, "asr", "forward")
