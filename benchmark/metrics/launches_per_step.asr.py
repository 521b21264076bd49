"""Device kernels launched in the ASR cell's traced window over its steps
(copies and memsets not counted): the host's dispatch work a step."""


def read(ctx):
    if ctx.family != "asr" or not ctx.steps:
        return None
    return ctx.summary.n_kernels / ctx.steps
