"""Adam's update of every leaf in one launch (``adam_multi_tensor_kernel``,
``csrc/adam.cu``): the bytes the window's updates need (each leaf's p, g,
mu and nu read once, p, mu and nu written once, at the solver's dtypes)
over the card's bandwidth, against the kernel's device time, in %. None
where the kernel did not launch (a program without it) or the solver's
optimizer keeps no Adam moments."""

from harness import flops, trace, weights

NAMES = ("adam_multi_tensor_kernel",)


def step_bytes(params, mu) -> int:
    """Bytes of one update: numel x (2 x param bytes + grad bytes + 2 x 2 x
    state bytes) a leaf, the gradient in the parameter's dtype."""
    total = 0
    for k, p in weights.flatten(params).items():
        s = mu[k]
        total += p.numel() * (3 * p.element_size() + 4 * s.element_size())
    return total


def read(ctx):
    state = getattr(getattr(ctx.prog, "solver", None), "opt_state", None)
    if not ctx.steps or not isinstance(state, dict) or "mu" not in state:
        return None
    t, n = trace.kernel_time(ctx.summary, NAMES)
    if n == 0 or t <= 0.0:
        return None
    nbytes = ctx.steps * step_bytes(ctx.prog.solver.params,
                                    weights.flatten(state["mu"]))
    return 100.0 * nbytes / flops.PEAK_BYTES / t
