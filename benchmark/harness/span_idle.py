"""The device-idle time the trace assigns to one of the program's spans
(``record_function``): ``trace.summarize`` names each idle gap after the
innermost span the host was in at the gap's middle."""

from __future__ import annotations


def idle_ms(ctx, family: str, span: str):
    """Device-idle ms a step in gaps named after ``span``: 0.0 where the
    span ran and no gap fell in it, None where the cell is another
    family's, the window ran no step, or the span is absent from the
    trace."""
    if ctx.family != family or not ctx.steps or span not in ctx.summary.spans:
        return None
    return 1e3 * dict(ctx.summary.gaps).get(span, 0.0) / ctx.steps
