#!/usr/bin/env python3
"""Time the GRU and light-GRU kernels K7f, K8f, K7b and K8b over both
directions of a listener layer on the card, beside the BLSTM kernels.

    python3 script/torch_k78_time.py [--against DIR [--pairs N]] [--steps]

Prints the card's name and power limit (nvidia-smi), then, at T=400 B=16
H=1280 (the flagship listener's shape) with bf16 streams and stashes, the
median of 20 runs (CUDA events) of: both directions' forward in the form
the checkout's rule gives a bidirectional layer (one packed launch; a
checkout without the packed form launches the single-direction kernel
twice, forward and reversed), and where the checkout has forms, each form
and the packing of both w_h alone; both directions' backward from the
forward's stashes, likewise (a checkout without the packed backward
launches K7b / K8b twice), and one direction's alone; K1 and K2 (the BLSTM
forward and backward) as a control. With ``--steps``, also two training
steps of the flagship with a GRU and with a light-GRU listener through the
checkout's own CLI (chip_smoke.py's phase-7 configuration, batch 16), then
two more under torch.profiler: device time a step, the busy share, and the
forward and backward kernels' device time a step. With ``--against DIR`` (another checkout of the repository, say an
unpacked parent commit) the same runs four times in turns, each in a
process of its own on the same card: DIR, this checkout, this checkout,
DIR; ``--pairs N`` repeats that order N times.
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (400, 16, 1280)


def _inputs(kind, dev, gen):
    """Both directions' seeded operands: xg, w_h and small (b_h, or the
    light GRU's mask, shared) of each, and dy of the forward one."""
    import torch
    t, b, h = SHAPE
    g = 3 if kind == "gru" else 2
    xs = [torch.randn(t, b, g * h, generator=gen).to(dev, torch.bfloat16)
          for _ in range(2)]
    ws = [(torch.randn(h, g * h, generator=gen) / h ** 0.5).to(dev)
          for _ in range(2)]
    if kind == "gru":
        small = [(0.3 * torch.randn(3 * h, generator=gen)).to(dev)
                 for _ in range(2)]
    else:
        mask = ((torch.rand(b, h, generator=gen) < 0.7).float() / 0.7).to(dev)
        small = [mask, mask]
    dy = torch.randn(t, b, h, generator=gen).to(dev, torch.bfloat16)
    return xs, ws, small, dy


def _time_k78(kind, dev, gen, median):
    """The line of one kernel family: both directions' forward, then both
    directions' backward from its stashes (each in the rule's form, and in
    each form where there are forms), and the backward over one
    direction."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import gru as KG
    from e2e_asr_pytorch_tpu_torch.ops.kernels import ligru as KLG
    K = KG if kind == "gru" else KLG
    xs, ws, small, dy = _inputs(kind, dev, gen)
    args = ((small[0], small[1]) if kind == "gru" else (small[0],))

    def one(reverse, i):
        if kind == "gru":
            return K.gru_fwd(xs[i], ws[i], small[i], reverse, stash=True)
        return K.ligru_fwd(xs[i], ws[i], small[i], reverse, stash=True)
    pair = (K.gru_fwd_pair if kind == "gru" else K.ligru_fwd_pair)(
        xs[0], xs[1], ws[0], ws[1], *args, stash=True)
    ys16 = [y.to(dy.dtype) for y in pair[:2]]
    hgs = pair[2:]
    dys = [dy, dy.flip(0).contiguous()]

    def bwd(i, reverse):
        if kind == "gru":
            return K.gru_bwd(xs[i], ws[i], hgs[i], ys16[i], dys[i], reverse)
        return K.ligru_bwd(xs[i], ws[i], small[0], hgs[i], ys16[i], dys[i],
                           reverse)
    mask = (small[0],) if kind == "ligru" else ()
    bwd_ops = (xs[0], xs[1], ws[0], ws[1], *mask, *hgs, *ys16, *dys)
    out = []
    if hasattr(K, "_launch_fwd_pair"):
        form = K.form_for(SHAPE[2], True, dev)
        by_form = {f: median(lambda f=f: K._launch_fwd_pair(
            xs[0], xs[1], ws[0], ws[1], *args, True, f)) for f in KG.FORMS}
        pack = median(lambda: KG.pack_w_pair(ws[0], ws[1],
                                             3 if kind == "gru" else 2))
        out.append("both directions {:.4f} ms ({}; {}; packing both w_h "
                   "{:.4f} ms)".format(by_form[form], form, ", ".join(
                       "{} {:.4f}".format(f, v) for f, v in by_form.items()),
                       pack))
    else:
        ms = median(lambda: (one(False, 0), one(True, 1)))
        out.append("both directions {:.4f} ms (two single-direction "
                   "launches)".format(ms))
    if hasattr(K, "_launch_bwd_pair"):
        form = K.form_for(SHAPE[2], True, dev, backward=True)
        by_form = {f: median(lambda f=f: K._launch_bwd_pair(*bwd_ops, f))
                   for f in KG.FORMS}
        out.append("backward both directions {:.4f} ms ({}; {})".format(
            by_form[form], form, ", ".join(
                "{} {:.4f}".format(f, v) for f, v in by_form.items())))
    else:
        ms = median(lambda: (bwd(0, False), bwd(1, True)))
        out.append("backward both directions {:.4f} ms (two "
                   "single-direction launches)".format(ms))
    out.append("backward {:.4f} ms one direction".format(
        median(lambda: bwd(0, False))))
    return "{}: {}".format("K7 (GRU)" if kind == "gru" else "K8 (liGRU)",
                           ", ".join(out))


def _listener_steps(dev, module):
    """Two training steps of the flagship with a ``module`` listener through
    the checkout's CLI, then two more under torch.profiler."""
    import tempfile
    import yaml
    import chip_smoke
    from e2e_asr_pytorch_tpu_torch.main import main
    with open(os.path.join(chip_smoke.ROOT, "config",
                           "librispeech_asr_best.yaml")) as f:
        model = yaml.safe_load(f)["model"]
    model = dict(model, encoder=dict(model["encoder"], module=module))
    with tempfile.TemporaryDirectory() as tmp:
        train_cfg, _, name = chip_smoke._write_train_configs(tmp, model=model,
                                                             steps=2)
        solver = main(["--config", train_cfg, "--name", name, "--njobs", "0",
                       "--seed", "0", "--logdir", os.path.join(tmp, "log"),
                       "--ckpdir", os.path.join(tmp, "ckpt"), "--no-msg"])
        prof = chip_smoke._step_breakdown(solver, dev, asr=True)
    rows = {way: "; ".join("{} {:.2f} ms x{:.0f} a step".format(*r)
                           for r in prof["top"] if way + "_kernel" in r[0])
            or "not among the ten rows with the most device time"
            for way in ("fwd", "bwd")}
    return ("{} listener: traced {:.4f} s a step, device {:.2f} ms a step, "
            "busy {:.3f}; forward kernel {}; backward kernel {}".format(
                module, prof["wall_s_per_step"], prof["device_ms_per_step"],
                prof["busy_share"], rows["fwd"], rows["bwd"]))


def time_tree(tree, steps=False):
    """Times the K7/K8 of the checkout at ``tree`` (and with ``steps`` its
    GRU and light-GRU listener steps); returns the printed line."""
    sys.path.insert(0, tree)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import gru as KG
    from torch_k5_time import _median_ms, _time_k1k2
    if not KG.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError("imported {} instead of {}'s".format(KG.__file__,
                                                                 tree))
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(8)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    median = lambda fn: _median_ms(fn, start, end)
    out = [_time_k78(kind, dev, gen, median) for kind in ("gru", "ligru")]
    k1 = _time_k1k2(dev, start, end)
    out.append("K1 {:.4f} ms, K2 {:.4f} ms ({})".format(*k1))
    if steps:
        out += [_listener_steps(dev, m) for m in ("GRU", "liGRU")]
    return "T={} B={} H={} bf16 in {}: {}".format(
        *SHAPE, os.path.abspath(tree), " | ".join(out))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout, timed in turns")
    ap.add_argument("--pairs", type=int, default=1,
                    help="times to run the order DIR, this, this, DIR")
    ap.add_argument("--steps", action="store_true",
                    help="also the GRU and light-GRU listener steps")
    ap.add_argument("--tree", default=ROOT, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.against is None:
        print(time_tree(args.tree, args.steps), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    other = os.path.abspath(args.against)
    for tree in (other, ROOT, ROOT, other) * args.pairs:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", tree] + ["--steps"] * args.steps,
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
