"""What the per-layer readers share: a model's share of the card's peak
over the traced window, the device's idle share, and a recurrence
kernel's share of its roofline. Each returns None where the trace holds
nothing to read (another family's cell, a kernel that did not launch)."""

from __future__ import annotations

from harness import flops, trace


def mfu_pct(ctx, family: str):
    """Model FLOPs of the window's steps at their shapes over the traced
    window and the bf16 peak, in %."""
    if ctx.family != family or not ctx.steps:
        return None
    total = sum(ctx.prog.step_flops(s) for s in ctx.shapes)
    return 100.0 * total / ctx.summary.window_s / flops.PEAK_BF16


def idle_pct(ctx, family: str):
    """Share of the traced window in which no kernel, copy or memset ran."""
    if ctx.family != family:
        return None
    s = ctx.summary
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def roofline_pct(ctx, names, launch_bound):
    """The bound of the kernel's launches over their device time, in %:
    ``launch_bound(shape)`` is the least ms of one launch in a step of that
    shape, averaged over the window's steps and counted once a launch."""
    t, n = trace.kernel_time(ctx.summary, names)
    if n == 0 or not ctx.shapes:
        return None
    per = sum(launch_bound(s) for s in ctx.shapes) / len(ctx.shapes)
    return 100.0 * per * 1e-3 * n / t


def span_ms(ctx, family: str, span: str):
    """Host ms a step inside one of the program's spans."""
    if ctx.family != family or not ctx.steps or span not in ctx.summary.spans:
        return None
    return 1e3 * ctx.summary.spans[span][0] / ctx.steps
