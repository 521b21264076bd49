"""The port's benchmark: one cell of ``BENCHMARK.json`` on this machine.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Set-up builds the port's training step for
the cell's configuration (its weights and batches made from the seed),
runs the first steps, whose readings the plain reference checks, and warms
every shape the window uses; the window then calls the step back to back
for ``--seconds`` and synchronises once at its end. ``--trace 1`` runs the
same window under torch.profiler and reports the cell's per-layer metrics
instead of its end-to-end ones. Once the window has closed and the peak
memory is read, the program is freed and the reference follows the first
steps; ``correct`` is the comparison's verdict.

The last line of standard output is the result (one JSON object); the line
before it records the card and the host. The numbers compared, each beside
its limit, are the last lines of standard error and the result's last key.
The run refuses (exit 2, no result) without the CUDA devices the cell
asks for, and (exit 3, no result) when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import guard  # noqa: E402

guard.quiet_libraries()


def process_age() -> float:
    """Seconds between this process's start and ``T_START``'s reading
    (the interpreter's own start-up), 0 where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - start / os.sysconf("SC_CLK_TCK")
        return max(0.0, age - (time.perf_counter() - T_START))
    except (OSError, ValueError, IndexError):
        return 0.0


PRE_START = process_age()


def number(x: float):
    """A float as JSON can hold it (a number not finite as its name)."""
    return x if x == x and abs(x) != float("inf") else str(x)


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def fixed_caches():
    """Kernel and build caches at fixed paths inside the checkout, so that
    only a checkout's first run builds (the port's own CUDA libraries go
    to ``ops/kernels/_build`` beside its sources)."""
    cache = BENCH / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def window(prog, seconds: float, traced: bool):
    """Steps back to back for ``seconds``, one synchronisation at the end;
    (steps, units, seconds, shapes, profiler or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from harness.trace import WINDOW_SPAN
    sync = (torch.cuda.synchronize if prog.device.type == "cuda"
            else (lambda: None))
    sync()
    prof = None
    if traced:
        acts = [ProfilerActivity.CPU]
        if prog.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    shapes, units, n = [], 0, 0
    with record_function(WINDOW_SPAN):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            shapes.append(prog.shape_at(prog.step_index))
            units += prog.step()
            n += 1
        sync()
        t1 = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    return n, units, t1 - t0, shapes, prof, t0


def per_layer(cell, prog, n, shapes, summary):
    """The cell's per-layer metrics that their readers found in the trace."""
    from harness.manifest import metric_reader
    ctx = SimpleNamespace(cell=cell, prog=prog, family=cell.config["family"],
                          steps=n, shapes=shapes, summary=summary)
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(cell, seed: int, seconds: float, traced: bool, device,
            chips: int = 1):
    """Set-up, the window and the comparison of one run of ``cell`` on
    ``device``: the result line's object."""
    import torch
    from harness import compare, device as devrec, trace
    from harness.manifest import family_module
    fam = family_module(cell)
    workdir = tempfile.mkdtemp(prefix="benchmark_")
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.cuda.init()
            torch.cuda.reset_peak_memory_stats()
        prog = fam.Program(cell, seed, device, workdir)
        prog_read = prog.check_steps()
        n, units, secs, shapes, prof, t0 = window(prog, seconds, traced)
        setup_s = PRE_START + (t0 - T_START)
        say("benchmark: set-up {:.1f} s, window {:.2f} s, {} steps".format(
            setup_s, secs, n))
        failed = prog.failed()
        peak = (torch.cuda.max_memory_allocated()
                if device.type == "cuda" else 0)
        result = {"correct": False, "attempted": n, "failed": failed}
        t1 = time.perf_counter()
        if traced:
            summary = trace.summarize(prof)
            del prof
            say("benchmark: trace read in {:.1f} s".format(
                time.perf_counter() - t1))
            result["metrics"] = per_layer(cell, prog, n, shapes, summary)
            result["breakdown"] = trace.breakdown(summary)
        else:
            summary = None
            result["metrics"] = {
                fam.RATE_METRIC: {"value": units / secs,
                                  "unit": fam.RATE_UNIT},
                "setup_s": {"value": setup_s, "unit": "s"}}
        prog.free()
        gc.collect()
        t1 = time.perf_counter()
        ref_read = fam.reference_readings(prog)
        say("benchmark: reference in {:.1f} s".format(
            time.perf_counter() - t1))
        nums = compare.numbers(prog_read, ref_read)
        ok, checks = compare.judge(nums, cell.limits["limits"])
        result["correct"] = bool(ok and failed == 0)
        if device.type == "cuda":
            result["device"] = devrec.record(chips, peak)
            if traced:
                result["device"]["busy_s"] = summary.busy_s
                result["device"]["window_s"] = summary.window_s
        else:
            result["device"] = {"platform": "cpu", "kind": "cpu",
                                "count": 1, "memory_peak_bytes": 0}
        result["checks"] = {k: {"value": number(v), "limit": lim,
                                "where": nums[k][1]}
                            for k, (v, lim) in checks.items()}
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def refuse_forbidden(when: str) -> bool:
    """Name on standard error any JAX or JAX-package module loaded."""
    loaded = guard.forbidden_loaded()
    if loaded:
        say("benchmark: {} {} loaded; no result".format(
            ", ".join(loaded), when))
    return bool(loaded)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if refuse_forbidden("before set-up"):
        return 3
    from harness.manifest import load_cell
    cell = load_cell(args.workload)
    chips = int(cell.entry["chips"])
    fixed_caches()
    from harness import device as devrec
    why = devrec.cuda_ready(chips)
    if why is not None:
        say("benchmark: refusing to run {}: {}".format(args.workload, why))
        return 2
    import torch
    print(json.dumps({"device_detail": devrec.detail(chips)}), flush=True)
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), chips)
    if refuse_forbidden("once the window closed"):
        return 3
    for name, c in result["checks"].items():
        say("check {} {!r} limit {!r} ({})".format(name, c["value"],
                                                  c["limit"], c["where"]))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
