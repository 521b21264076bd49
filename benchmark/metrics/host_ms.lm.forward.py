"""Host milliseconds a step inside the LM step's ``forward`` span: the leaves
made differentiable, the shifted inputs, ``lm_apply`` and the loss
(``train_lm.loss_and_grads``); over the LM cell's traced window."""

from harness import readers


def read(ctx):
    return readers.span_ms(ctx, "lm", "forward")
