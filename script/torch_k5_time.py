#!/usr/bin/env python3
"""Time the single-direction LSTM kernels K5f (forward) and K5b (backward) at
their main paths' shapes on the card.

    python3 script/torch_k5_time.py [--against DIR [--pairs N]] [--lm]

Prints the median of 20 launches of each (CUDA events, bf16 streams, the
forward with stashes, the backward from them) at the single-direction
listener's shapes and the 4x LSTM-1024 LM's, with the form each took where
the checkout has forms, and of K1 / K2 (the BLSTM forward and backward;
K5f's narrow form is K1's kernel) at the flagship listener's shape,
T=400 B=16 H=1280, in the form their rule picks, timed both before and
after the K5 runs of the process. With ``--lm``, also the 4x LSTM-1024
LM's training step through the checkout's own CLI (chip_smoke.py's phase-6 run: 3 steps
at batch 128, then two more under torch.profiler): median step seconds,
tokens/s, device time a step and the busy share. With ``--against DIR``
(another checkout of the repository, say an unpacked parent commit) the
same runs four times in turns, each in a process of its own on the same
card: DIR, this checkout, this checkout, DIR; ``--pairs N`` repeats that
order N times.
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(400, 16, 1280), (160, 128, 1024), (200, 8, 1280)]


def _median_ms(fn, start, end):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _time_k1k2(dev, start, end):
    """K1 and K2 (the BLSTM forward and backward) at T=400 B=16 H=1280,
    bf16, on inputs made from one seed: (K1 ms, K2 ms, their forms)."""
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as KB
    gen = torch.Generator().manual_seed(6)
    t, b, h = SHAPES[0]
    xg_f, xg_b = (torch.randn(t, b, 4 * h, generator=gen).to(dev,
                                                            torch.bfloat16)
                  for _ in range(2))
    wh_f, wh_b = ((torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to(dev)
                  for _ in range(2))
    dy_f, dy_b = (torch.randn(t, b, h, generator=gen).to(dev, torch.bfloat16)
                  for _ in range(2))
    _, _, cs_f, cs_b, g_f, g_b = KB.bilstm_recurrence(xg_f, xg_b, wh_f, wh_b,
                                                      stash=True)
    f_ms = _median_ms(lambda: KB.bilstm_recurrence(xg_f, xg_b, wh_f, wh_b,
                                                   stash=True), start, end)
    b_ms = _median_ms(lambda: KB.bilstm_recurrence_bwd(
        wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f, dy_b), start, end)
    return f_ms, b_ms, "{} / {}".format(KB.form_for(h, dev),
                                        KB.form_for(h, dev, backward=True))


def time_tree(tree, lm=False):
    """Times the K5 of the checkout at ``tree`` (and with ``lm`` its 4x
    LSTM-1024 LM step); returns the printed line."""
    sys.path.insert(0, tree)
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as K
    if not K.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError("imported {} instead of {}'s".format(K.__file__,
                                                                 tree))
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(5)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    k1_first = _time_k1k2(dev, start, end)
    for t, b, h in SHAPES:
        xg = torch.randn(t, b, 4 * h, generator=gen).to(dev, torch.bfloat16)
        w_h = (torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to(dev)
        dy = torch.randn(t, b, h, generator=gen).to(dev, torch.bfloat16)
        _, cs, gs = K.lstm_fwd(xg, w_h, False, stash=True)
        f_ms = _median_ms(lambda: K.lstm_fwd(xg, w_h, False, stash=True),
                          start, end)
        b_ms = _median_ms(lambda: K.lstm_bwd(w_h, cs, gs, dy, False), start,
                          end)
        form = (" ({})".format(K.form_for(h, b, dev))
                if hasattr(K, "form_for") else "")
        out.append("T={} B={} H={}{}: K5f {:.4f} ms, K5b {:.4f} ms".format(
            t, b, h, form, f_ms, b_ms))
    k1_after = _time_k1k2(dev, start, end)
    t, b, h = SHAPES[0]
    out.append("T={} B={} H={} ({}): K1 {:.4f} ms first, {:.4f} ms after K5; "
               "K2 {:.4f} ms first, {:.4f} ms after K5".format(
                   t, b, h, k1_first[2], k1_first[0], k1_after[0],
                   k1_first[1], k1_after[1]))
    if lm:
        import tempfile
        import chip_smoke
        with tempfile.TemporaryDirectory() as tmp:
            solver, _, res, _ = chip_smoke._run_lm(
                tmp, 0, dev, "librispeech_lm.yaml", "lm", 3, 3, "lstm_fwd",
                "lstm_bwd")
            prof = chip_smoke._step_breakdown(solver, dev, asr=False)
        out.append("4x LSTM-1024 LM: median step {:.4f} s, {:.0f} tokens/s; "
                   "traced {:.4f} s a step, device {:.2f} ms a step, busy "
                   "{:.3f}".format(res["median_step_s"], res["tokens_per_s"],
                                   prof["wall_s_per_step"],
                                   prof["device_ms_per_step"],
                                   prof["busy_share"]))
    return "K5 in {}: {}".format(os.path.abspath(tree), " | ".join(out))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout, timed in turns")
    ap.add_argument("--pairs", type=int, default=1,
                    help="times to run the order DIR, this, this, DIR")
    ap.add_argument("--lm", action="store_true",
                    help="also the 4x LSTM-1024 LM's training step")
    ap.add_argument("--tree", default=ROOT, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.against is None:
        print(time_tree(args.tree, args.lm), flush=True)
        return 0
    other = os.path.abspath(args.against)
    for tree in (other, ROOT, ROOT, other) * args.pairs:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", tree] + ["--lm"] * args.lm,
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
