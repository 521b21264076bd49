"""Device-idle milliseconds a step in the gaps the trace names after the LM
step's ``backward`` span (the host inside it at a gap's middle):
``torch.autograd.grad`` in ``train_lm.loss_and_grads``; over the LM cell's
traced window."""

from harness import span_idle


def read(ctx):
    return span_idle.idle_ms(ctx, "lm", "backward")
