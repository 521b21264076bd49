#!/usr/bin/env python3
"""Time the int8 value-table reductions K3 (context_int8) and K4
(dattn_int8) on the card.

    python3 script/torch_k34_time.py [--against DIR [--pairs N]] [--steps]

Prints the card's name and power limit (nvidia-smi), then for each kernel
at B=16 T=400 D=2560 (the flagship's 16 s bucket) its device time a launch
with a warm L2 and with a cold one (a 64 MiB buffer written before each
launch, as chip_smoke.py reads it, and read instead of written), the
wrapper's host time a call, and the
library call beside it (torch.einsum over the table widened to bf16
beforehand: the port's ``value_table: 'bf16'`` path); then the device time
at phase 5's median training batch (B=16 T=240 D=2560), and K1 / K2 (the
BLSTM forward and backward at T=400 B=16 H=1280) as a control. The times
are chip_smoke.py's readings of this checkout (``_time_ms``, ``_cold_ms``,
``_host_ms``), whatever tree the kernels come from. With ``--steps``, also
two training steps of the flagship through the tree's own CLI (phase 5's
configuration, batch 16), then two more under torch.profiler: device time
a step, the busy share, and K3's and K4's rows. With ``--against DIR``
(another checkout, say an unpacked parent commit) the same runs four times
in turns, each in a process of its own on the same card: DIR, this
checkout, this checkout, DIR; ``--pairs N`` repeats that order N times.
"""

import argparse
import importlib.util
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(16, 400, 2560), (16, 240, 2560)]


def _timing():
    """This checkout's chip_smoke.py, for its readings."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_readings", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(dev, gen, b, t, d):
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q
    values = torch.tanh(1.2 * torch.randn(b, t, d, generator=gen)).to(dev)
    q, scale = Q.quantize_table(values)
    attn = torch.softmax(torch.randn(b, t, generator=gen), -1).to(dev)
    dctx = (0.1 * torch.randn(b, d, generator=gen)).to(dev)
    return q, attn * scale, dctx


def _cold_read_ms(cs, fn, reps):
    """As chip_smoke's _cold_ms, the L2 flushed by reading a 64 MiB buffer
    (a sum) in place of writing one: no dirty lines for the call's reads
    to write back first."""
    import torch
    flush = torch.ones(64 << 18, dtype=torch.float32, device="cuda")
    both = cs._time_ms(lambda: (flush.sum(), fn()), reps)
    return both - cs._time_ms(flush.sum, reps)


def _steps(cs, dev):
    """Two flagship training steps, then two more under torch.profiler."""
    import tempfile
    from e2e_asr_pytorch_tpu_torch.main import main
    with tempfile.TemporaryDirectory() as tmp:
        train_cfg, _, name = cs._write_train_configs(tmp, steps=2)
        solver = main(["--config", train_cfg, "--name", name, "--njobs", "0",
                       "--seed", "0", "--logdir", os.path.join(tmp, "log"),
                       "--ckpdir", os.path.join(tmp, "ckpt"), "--no-msg"])
        prof = cs._step_breakdown(solver, dev, asr=True,
                                  watch=("int8_kernel",))
    rows = "; ".join("{} {:.3f} ms a step over {:.0f} launches = {:.2f} us a "
                     "launch".format(n, ms, k, ms * 1e3 / k)
                     for n, ms, k in prof["watch"]) or "no int8 kernel row"
    return ("flagship step: traced {:.4f} s a step, device {:.2f} ms a step, "
            "busy {:.3f}; {}".format(prof["wall_s_per_step"],
                                     prof["device_ms_per_step"],
                                     prof["busy_share"], rows))


def time_tree(tree, steps=False):
    """Times K3 and K4 of the checkout at ``tree``; returns the line."""
    sys.path.insert(0, tree)
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q
    from torch_k5_time import _time_k1k2
    if not Q.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError("imported {} instead of {}'s".format(Q.__file__,
                                                                 tree))
    cs = _timing()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(10)
    out = []
    for i, (b, t, d) in enumerate(SHAPES):
        q, a2, dctx = _operands(dev, gen, b, t, d)
        Q.context_int8(a2, q), Q.dattn_int8(dctx, q)  # built before timing
        torch.cuda.synchronize()
        for name, fn, small, eq in (
                ("K3", Q.context_int8, a2, "bt,btd->bd"),
                ("K4", Q.dattn_int8, dctx, "bd,btd->bt")):
            warm = cs._time_ms(lambda: fn(small, q), 200)
            if i:
                out.append("{} B={} T={} D={}: {:.5f} ms".format(
                    name, b, t, d, warm))
                continue
            cold = cs._cold_ms(lambda: fn(small, q), 50)
            cold_read = _cold_read_ms(cs, lambda: fn(small, q), 50)
            host = cs._host_ms(lambda: fn(small, q), 200)
            wide = (small.to(torch.bfloat16), q.to(torch.bfloat16))
            lib = cs._time_ms(lambda: torch.einsum(eq, *wide), 200)
            out.append("{} B={} T={} D={}: warm {:.5f} ms, cold {:.5f} ms "
                       "(after reads {:.5f} ms), host {:.5f} ms a call, "
                       "library {:.5f} ms".format(name, b, t, d, warm, cold,
                                                  cold_read, host, lib))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    k1 = _time_k1k2(dev, start, end)
    out.append("K1 {:.4f} ms, K2 {:.4f} ms ({})".format(*k1))
    if steps:
        out.append(_steps(cs, dev))
    return "{}: {}".format(os.path.abspath(tree), " | ".join(out))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout, timed in turns")
    ap.add_argument("--pairs", type=int, default=1,
                    help="times to run the order DIR, this, this, DIR")
    ap.add_argument("--steps", action="store_true",
                    help="also the flagship's training step, traced")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    trees = ((os.path.abspath(args.against), ROOT, ROOT,
              os.path.abspath(args.against)) * args.pairs
             if args.against else (ROOT,))
    for tree in trees:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree-run", tree] + ["--steps"] * args.steps,
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--tree-run":
        print(time_tree(sys.argv[2], "--steps" in sys.argv), flush=True)
        sys.exit(0)
    sys.exit(main())
