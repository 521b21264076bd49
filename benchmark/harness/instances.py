"""One instantiation of a kernel template in the trace: the launches whose
function is ``name`` and whose last template argument is ``last``, as in
``lstm_fwd_chunked_kernel<__nv_bfloat16, 8>``. ``trace.kernel_time`` sums
every instantiation of a name; two kernels built from one template (K5f
wide and K6f, K5b and K6b) differ only in their tile's units."""

from __future__ import annotations

from typing import Tuple

from harness import trace


def last_argument(kernel: str):
    """The last template argument of a kernel's short name as an int, or
    None where it has no template arguments or the last is no number."""
    if "<" not in kernel:
        return None
    last = kernel.split("<", 1)[1].rsplit(">", 1)[0].split(",")[-1].strip()
    return int(last) if last.isdigit() else None


def instance_time(summary: trace.Summary, name: str,
                  last: int) -> Tuple[float, int]:
    """Device seconds and launches of ``name<..., last>``."""
    t, c = 0.0, 0
    for k, (s, n) in summary.kernels.items():
        if (k.split("<", 1)[0].split("::")[-1] == name
                and last_argument(k) == last):
            t += s
            c += n
    return t, c


def roofline_pct(ctx, name: str, last: int, launch_bound):
    """``readers.roofline_pct`` over one instantiation: the bound of its
    launches (``launch_bound(shape)`` ms one, averaged over the window's
    steps) over their device time, in %; None where none launched."""
    t, n = instance_time(ctx.summary, name, last)
    if n == 0 or t <= 0.0 or not ctx.shapes:
        return None
    per = sum(launch_bound(s) for s in ctx.shapes) / len(ctx.shapes)
    return 100.0 * per * 1e-3 * n / t
