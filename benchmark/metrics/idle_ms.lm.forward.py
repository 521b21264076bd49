"""Device-idle milliseconds a step in the gaps the trace names after the LM
step's ``forward`` span (the host inside it at a gap's middle): the leaves
made differentiable, the shifted inputs, ``lm_apply`` and the loss
(``train_lm.loss_and_grads``); over the LM cell's traced window."""

from harness import span_idle


def read(ctx):
    return span_idle.idle_ms(ctx, "lm", "forward")
