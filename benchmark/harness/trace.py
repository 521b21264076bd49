"""The traced run: torch.profiler over the measured window, reduced to what
the per-layer readers and the result's ``breakdown`` read.

The window is bracketed by a span of the benchmark's own
(``WINDOW_SPAN``), so the trace gives its length on its own clock. Device
time is the union of the intervals in which a kernel, a copy or a memset
ran (overlapping streams count once); a ``record_function`` span of the
program appears on the device too, over the kernels it encloses, and is no
device work. The reduction reads the profiler's raw events
(``kineto_results.events()``), which is linear in their number, rather
than ``key_averages()``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

WINDOW_SPAN = "benchmark.window"


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]   # name -> (device s, launches)
    n_kernels: int                          # kernel launches (no copies)
    spans: Dict[str, Tuple[float, int]]     # program span -> (host s, count)
    gaps: List[Tuple[str, float]]           # idle device time by host work


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0][:120] or name[:120]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _top_level(ops):
    """The ops no other op of their thread encloses, sorted by start."""
    by_thread = defaultdict(list)
    for s, e, name, tid in ops:
        by_thread[tid].append((s, -e, name))
    top = []
    for items in by_thread.values():
        items.sort()
        end = None
        for s, neg_e, name in items:
            if end is None or s >= end:
                top.append((s, -neg_e, name))
                end = -neg_e
    top.sort()
    return top


def _covering(sorted_iv, starts, t, look=16):
    """The latest-starting interval of ``sorted_iv`` (s, e, name) that
    covers ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look, -1), -1):
        s, e, name = sorted_iv[j]
        if s <= t <= e:
            return name
    return None


def _kinds(events, cuda):
    """Each event's kind: "kernel", "copy" (a memcpy or memset), "device
    span" (a program span shown on the device), "span" (a host span) or
    "op". Read from ``activity_type()`` where the build has it, else from
    ``is_user_annotation()`` and the names."""
    if events and hasattr(events[0], "activity_type"):
        table = {"kernel": "kernel", "gpu_memcpy": "copy",
                 "gpu_memset": "copy", "gpu_user_annotation": "device span",
                 "user_annotation": "span"}
        return [table.get(e.activity_type(),
                          "kernel" if e.device_type() == cuda else "op")
                for e in events]

    def host_span(e):
        if hasattr(e, "is_user_annotation"):
            return e.is_user_annotation()
        n = e.name()
        return "::" not in n and not n.startswith(("cuda", "cu", "Memcpy",
                                                   "Memset"))
    spans = {e.name() for e in events
             if e.device_type() != cuda and host_span(e)}
    out = []
    for e in events:
        n = e.name()
        if e.device_type() == cuda:
            out.append("device span" if n in spans else
                       "copy" if n.startswith(("Memcpy", "Memset")) else
                       "kernel")
        else:
            out.append("span" if n in spans else "op")
    return out


def summarize(prof, min_gap_us: float = 5.0) -> Summary:
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    window = None
    dev, spans_iv, host_ops = [], [], []
    kernels = defaultdict(lambda: [0.0, 0])
    spans = defaultdict(lambda: [0.0, 0])
    n_kernels = 0
    for e, kind in zip(events, _kinds(events, cuda)):
        s, d = e.start_ns(), e.duration_ns()
        if kind in ("kernel", "copy"):
            dev.append((s, s + d))
            name = short_name(e.name())
            kernels[name][0] += d * 1e-9
            kernels[name][1] += 1
            n_kernels += kind == "kernel"
        elif kind == "span":
            if e.name() == WINDOW_SPAN:
                window = (s, s + d)
                continue
            spans[e.name()][0] += d * 1e-9
            spans[e.name()][1] += 1
            spans_iv.append((s, s + d, e.name()))
        elif kind == "op":
            host_ops.append((s, s + d, e.name(), e.start_thread_id()))
    if window is None:
        raise RuntimeError("the trace holds no {} span".format(WINDOW_SPAN))
    w0, w1 = window
    busy = _merge([(max(s, w0), min(e, w1)) for s, e in dev
                   if e > w0 and s < w1])
    busy_ns = sum(e - s for s, e in busy)

    # idle gaps inside the window, named by what the host was doing at
    # their middle: the innermost program span, else the outermost op
    spans_iv.sort()
    span_starts = [s for s, _, _ in spans_iv]
    top = _top_level(host_ops)
    top_starts = [s for s, _, _ in top]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a < min_gap_us * 1e3:
            continue
        mid = (a + b) // 2
        name = (_covering(spans_iv, span_starts, mid)
                or _covering(top, top_starts, mid) or "host, no op")
        gaps[name] += (b - a) * 1e-9
    return Summary((w1 - w0) * 1e-9, busy_ns * 1e-9,
                   {k: (v[0], v[1]) for k, v in kernels.items()}, n_kernels,
                   {k: (v[0], v[1]) for k, v in spans.items()},
                   sorted(gaps.items(), key=lambda kv: -kv[1]))


def breakdown(summary: Summary, n: int = 10) -> Dict:
    ops = sorted(summary.kernels.items(), key=lambda kv: -kv[1][0])[:n]
    return {"device_ops": [[k, v[0]] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in summary.gaps[:n]]}


def kernel_time(summary: Summary, names) -> Tuple[float, int]:
    """Device seconds and launches of the kernels named one of ``names``
    (their function name, without namespace or template arguments)."""
    t, c = 0.0, 0
    for k, (s, n) in summary.kernels.items():
        if k.split("<", 1)[0].split("::")[-1] in names:
            t += s
            c += n
    return t, c
