"""Host milliseconds a step inside the LM step's ``backward`` span:
``torch.autograd.grad`` in ``train_lm.loss_and_grads``; over the LM cell's
traced window."""

from harness import readers


def read(ctx):
    return readers.span_ms(ctx, "lm", "backward")
