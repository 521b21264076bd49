"""The readings the limits of a cell's comparison are set from, on the
chip at the cell's own size, in one process:

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds ...] [--faults half_batch,...] [--fault-seeds ...]

For each seed: the program's first steps against the reference (the lower
reading is the largest over sound seeds); the control, the reference in
float8 against the reference in float32 (the upper reading is its
smallest); each planted fault of the family (``FAULTS``) against the
reference. One JSON line a reading on standard output, and appended to
``--out`` when given. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import guard  # noqa: E402

guard.quiet_libraries()


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def reading(cell, fam, seed, device, kind, fault=None):
    """(program or control) numbers of one seed, as a dict."""
    import torch
    from harness import compare
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="benchmark_cal_") as workdir:
        plant = fam.FAULTS[fault]() if fault else contextlib.nullcontext()
        with plant:
            prog = fam.Program(cell, seed, device, workdir)
            got = prog.check_steps() if kind != "control" else None
        prog.free()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = fam.reference_readings(prog, "f32")
        if kind == "control":
            got = fam.reference_readings(prog, "fp8")
    nums = compare.numbers(got, ref)
    return {"cell": cell.name, "kind": kind, "fault": fault, "seed": seed,
            "numbers": {k: v[0] for k, v in nums.items()},
            "where": {k: v[1] for k, v in nums.items()},
            "losses": got["loss"], "ref_losses": ref["loss"],
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None,
                    help="a JSON-lines file the readings are appended to")
    args = ap.parse_args(argv)
    import torch
    from harness.manifest import family_module, load_cell
    cell = load_cell(args.workload)
    fam = family_module(cell)
    device = torch.device("cpu" if args.cpu else "cuda")
    sink = open(args.out, "a") if args.out else None
    jobs = [(s, "program", None) for s in args.seeds]
    jobs += [(s, "control", None) for s in args.control_seeds]
    for f in [f for f in args.faults.split(",") if f]:
        jobs += [(s, "fault", f) for s in args.fault_seeds]
    for seed, kind, fault in jobs:
        row = reading(cell, fam, seed, device, kind, fault)
        line = json.dumps(row)
        print(line, flush=True)
        if sink is not None:
            sink.write(line + "\n")
            sink.flush()
    if sink is not None:
        sink.close()


if __name__ == "__main__":
    main()
