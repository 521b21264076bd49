"""Device-idle milliseconds a step in the gaps the trace names after the ASR
step's ``forward`` span (the host inside it at a gap's middle): the losses'
forward pass, ``asr_apply`` (frontend, encoder, CTC head, attention
decoder) and the CTC and label-smoothed losses (``train_asr.losses``); over
the ASR cell's traced window."""

from harness import span_idle


def read(ctx):
    return span_idle.idle_ms(ctx, "asr", "forward")
