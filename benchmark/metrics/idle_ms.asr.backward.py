"""Device-idle milliseconds a step in the gaps the trace names after the ASR
step's ``backward`` span (the host inside it at a gap's middle):
``torch.autograd.grad`` in ``train_asr.loss_and_grads``, the K2 and decoder
autograd nodes with it; over the ASR cell's traced window."""

from harness import span_idle


def read(ctx):
    return span_idle.idle_ms(ctx, "asr", "backward")
