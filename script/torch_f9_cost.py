#!/usr/bin/env python3
"""Time the flagship decode and training step of a checkout on the card,
to read what a change to their products costs (the one-step cells' and
the heads' f32-summed products of the F9 repair, ROADMAP queue 3, for
one).

    python3 script/torch_f9_cost.py [--against DIR [--pairs N]] [--lm]
    python3 script/torch_f9_cost.py --products

Runs chip_smoke.py's phase 5 (6 training steps of the flagship at batch
16, then more under torch.profiler) and phase 4 (the flagship's beam 8 +
LM 0.3 and greedy decodes of 32 synthetic utterances) from the
checkout's own chip_smoke.py and package, and prints one line: the beam
and greedy RTF and decode seconds, the median step seconds, the traced
step's seconds and device time. With ``--against DIR`` (another checkout,
say an unpacked parent commit under probes/) the same runs four times in
turns, each in a process of its own on the same card: DIR, this checkout,
this checkout, DIR; ``--pairs N`` repeats that order N times. The card's
name and power limit come first. ``--lm`` adds phase 6 (6 steps of each LM
at batch 128, config/librispeech_lm_best.yaml and librispeech_lm.yaml,
then 2 more of each under torch.profiler): each LM's median step seconds,
tokens/s, traced device ms a step and busy share.

``--products`` times one product of bf16 operands with an f32 result in
each form, at the decode step's and the training step's shapes: the bf16
product rounded and read as f32 (the fault F9 was), ``torch.mm`` with
``out_dtype`` (``ops/rnn.py mm_f32``), the f32 product of the widened
operands, and ``matmul_f32`` as the cells call it. Host microseconds a
call (1000 calls, one sync at the end), device microseconds a call
(chip_smoke.py's ``_time_ms``: a device-side head start, then one event
pair around 200 calls) and each form's max |err| against ``mm_f32``'s over
max |ref|.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_tree(tree, lm=False):
    sys.path.insert(0, tree)
    import torch
    import chip_smoke
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q
    for build in (K._library, K._bwd_library, Q._library):
        build()  # before any timing
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros((), device=dev)  # the card's context, as a decode makes
    # the training step first, in a process that has run nothing else
    _, train = chip_smoke.phase_train(0, dev)
    _, dec = chip_smoke.phase_slice(0)
    prof = train["breakdown"]
    out = {"beam8_lm_rtf": dec["beam"]["rtf"],
           "beam8_lm_decode_s": dec["beam"]["decode_s"],
           "greedy_rtf": dec["greedy"]["rtf"],
           "greedy_decode_s": dec["greedy"]["decode_s"],
           "median_step_s": train["median_step_s"],
           "traced_step_s": prof["wall_s_per_step"],
           "device_ms_per_step": prof["device_ms_per_step"],
           "busy_share": prof["busy_share"]}
    if lm:
        _, lms, _ = chip_smoke.phase_lm(0, dev)
        for key, res in lms.items():
            out[key] = {"median_step_s": res["median_step_s"],
                        "tokens_per_s": res["tokens_per_s"],
                        "device_ms_per_step":
                            res["breakdown"]["device_ms_per_step"],
                        "busy_share": res["breakdown"]["busy_share"]}
    return "F9 cost in {}: {}".format(tree, json.dumps(out))


# (rows, inner, cols) of the products a step takes: the beam's decoder cell
# (B*K = 8 x 8 rows, 2 x 1024 -> 4 x 1024), the flagship LM's cell (4 x
# 2048 gates) and tied logits, the CTC head over a training batch, the
# query projection, and the beam's location features (prev_att @ loc_band
# at T=400), their projection and the energy (B*K*T rows)
PRODUCT_SHAPES = [(64, 1024, 4096), (64, 2048, 8192), (64, 2048, 31),
                  (6400, 2560, 31), (16, 2048, 300), (64, 400, 4000),
                  (25600, 10, 300), (25600, 300, 1)]


def time_products():
    import time
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from e2e_asr_pytorch_tpu_torch.ops import rnn as R
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    forms = {
        "bf16_rounded": lambda a, b: torch.matmul(a, b).float(),
        "mm_out_dtype": R.mm_f32,
        "f32_widened": lambda a, b: torch.matmul(a.float(), b.float()),
        "matmul_f32": lambda a, b: R.matmul_f32(a, b, torch.bfloat16)}
    out = []
    for m, k, n in PRODUCT_SHAPES:
        a = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16)
        b = (torch.randn(k, n, generator=gen) / k ** 0.5).to(
            dev, torch.bfloat16)
        ref = R.mm_f32(a, b)
        row = []
        with torch.no_grad():
            for name, fn in forms.items():
                for _ in range(20):
                    fn(a, b)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(1000):
                    y = fn(a, b)
                torch.cuda.synchronize()
                host_us = (time.perf_counter() - t0) * 1e3
                dev_us = chip_smoke._time_ms(lambda: fn(a, b), 200) * 1e3
                err = float((y - ref).abs().max() / ref.abs().max())
                row.append("{} {:.2f} us host, {:.2f} us device, err "
                           "{:.1e}".format(name, host_us,
                                           dev_us, err))
        out.append("({}, {}) @ ({}, {}): {}".format(m, k, k, n,
                                                    "; ".join(row)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout, timed in turns")
    ap.add_argument("--pairs", type=int, default=1,
                    help="times to run the order DIR, this, this, DIR")
    ap.add_argument("--products", action="store_true",
                    help="time the product forms instead")
    ap.add_argument("--lm", action="store_true",
                    help="time both LMs' steps (phase 6) too")
    ap.add_argument("--tree", default=ROOT, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.products:
        print("\n".join(time_products()), flush=True)
        return 0
    if args.against is None:
        print(time_tree(os.path.abspath(args.tree), args.lm), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("card: " + smi, flush=True)
    other = os.path.abspath(args.against)
    for tree in (other, ROOT, ROOT, other) * args.pairs:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", tree] + ["--lm"] * args.lm,
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-3000:] + res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        print([ln for ln in res.stdout.splitlines()
               if ln.startswith("F9 cost in")][-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
