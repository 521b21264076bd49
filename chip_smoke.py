#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (each prints its lines; any failure raises and exits non-zero, and
no result line is printed):

1. device  -- the card's name and power limit (nvidia-smi) and
              torch.cuda.get_device_name(); refuses to run without CUDA.
2. build   -- compiles the five CUDA sources for sm_90a, one nvcc each, all
              started together: bilstm_fwd.cu (K1), bilstm_bwd.cu (K2),
              int8_table.cu (K3, K4), lstm_fwd.cu (K5f, K6f) and lstm_bwd.cu
              (K5b, K6b).
3. kernel  -- every kernel against its plain PyTorch version on the card,
              with the tolerances stated at the top of this file and
              CUDA-event times for both:
              K1 at the decode shapes (T=400/200 from the 16 s / 8 s
              buckets, B=8, H=1280), the training shape (T=400, B=16, bf16,
              stashes on), T=320 and a ragged T=37/B=3/H=200;
              K2 at T=400/200, B=16, H=1280 and the ragged shape;
              K3/K4 at B=16, T=400/200, D=2560 and two ragged shapes.
              K5f/K5b at the 4x LSTM-1024 LM's shape (T=160, B=128, H=1024,
              bf16), forward and reversed, and the ragged shape; K6f/K6b at
              the flagship LM's shapes (T=160, B=128 and T=320, B=64, H=2048,
              bf16) and the ragged shape.
              Each is also shown to fail against a plain version with
              planted faults (K1, K5f, K6f: doubled w_h, f32 h; K2, K5b, K6b:
              doubled w_h, f32 dgates; K3/K4: doubled table, f32 small
              operand). Beside the LSTM kernels one library call is timed and
              used nowhere else: torch.nn.LSTM on cuDNN in bf16 at the same
              T, B, H (forward for the forward kernels, forward + backward
              for the backward ones; it includes the input projection, so
              the xg matmul's own time is printed beside it).
4. slice   -- the port's own CLI (``main --test``) at the flagship's full
              width (VGG-LN + 5x BLSTM-1280, loc attention, 2x LSTM-1024
              decoder; 4x LSTM-2048 tied LM) with seeded weights written as
              port checkpoints, over the synthetic tone corpus (16 utts per
              split, 20-80 tokens = 3.2-12.8 s, batch 8): beam 8 + LM 0.3,
              then greedy. Checks the CSVs, the vocabulary, that every
              parameter is on the card, and that K1 launched exactly 5 times
              per encoded batch (counts reset just before the run).
5. train   -- the port's own CLI in train mode with the flagship's model
              and hparas blocks verbatim (dropout 0.3, int8 value table,
              bf16 d_key, Adadelta with bf16 state, label smoothing,
              SpecAugment on), batch 16 on the synthetic corpus (96 utts,
              20-80 tokens), TRAIN_STEPS steps with validation at the first
              and the last. Checks finite losses and grad norms, that the
              parameters moved, bf16 optimizer state, exact launch counts
              (K1 = 5 x (steps + validation batches), K2 = 5 x steps,
              K3 = K4 = the sum of the steps' decode lengths; counts reset
              just before the run), then decodes last_att_dev.pth with the
              port's --test greedy path. Prints the median step time after
              the first, utts/s, audio seconds per second and the peak
              allocated memory.
6. lm      -- the port's own CLI with --lm: the model and hparas blocks of
              config/librispeech_lm_best.yaml verbatim (tied 2048, 4x
              LSTM-2048, dropout 0.5, Adam 1e-4), batch 128, synthetic text
              (2048 sentences of 40-300 tokens: buckets 48-320, batches over
              150 tokens halve to 64), LM_STEPS steps with validation every
              LM_VALID. Checks finite losses and grad norms, that every
              parameter leaf moved, parameters and Adam state on the card,
              exact launch counts (K6f = 4 x (steps + validation batches),
              K6b = 4 x steps; counts reset just before), last_ppx.pth; then
              holds lm_apply (K6f) against lm_step run token by token on one
              dev batch of the checkpoint, and traces two more steps with
              torch.profiler for the step's device-time breakdown and busy
              share. Then LM_K5_STEPS steps of
              config/librispeech_lm.yaml's 4x LSTM-1024 (K5f, K5b). Prints
              median step time after the first, tokens/s and peak memory.
7. agree   -- a small model beam-decoded on the card (kernel, f32) and on
              the CPU (plain version, f32) gives the same tokens.

The kernels line gives each kernel's launches summed over the main paths
(phases 4, 5 and 6; each driven with the counts reset just before and read
just after), its worst max |err| against the plain version in phase 3, its
kernel and plain times at its main path's shape, the least time the card
could take for the same work (bound_ms: the larger of operations / 989
TFLOP/s and bytes / 3.35 TB/s, each input read once and each output written
once) and the library call's time where there is one. The line before the
last is the card as nvidia-smi names it; the last line is
{"ok": true, "device": {...}}.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel vs plain: f32 streams differ by sum order, and a flipped rounding
# of bf16(h) feeds back through the recurrence, so the bound is a fraction
# of one bf16 ulp of h; bf16 streams: ~4 bf16 ulps at |h| <= 1. The bf16
# stashes may differ by one bf16 ulp of their value on top.
TOL = {"float32": 2e-3, "bfloat16": 1.6e-2}
STASH_REL = 2.0 ** -7
# Before the first flip of a bf16(h) rounding the two agree to f32 noise, so
# the mean |err| of ys over each direction's first EARLY_STEPS steps holds
# the bf16(h) @ bf16(w_h) contract that the whole-sequence bound cannot.
EARLY_STEPS = 4
EARLY_MEAN_TOL = 1e-6
FAULT_SHAPE = (320, 8, 1280)
SHAPES = [(400, 16, 1280, "bfloat16"), (400, 8, 1280, "bfloat16"),
          (200, 8, 1280, "bfloat16"), (320, 8, 1280, "float32"),
          (320, 8, 1280, "bfloat16"), (37, 3, 200, "float32"),
          (37, 3, 200, "bfloat16")]
MAIN_SHAPE = SHAPES[0]
# K2 vs plain, both from the same stashes: a flipped rounding of
# bf16(dgates) feeds back through dh, so the whole-sequence bound is a bf16
# ulp at the top of dxg's range (max |err| <= 2^-6 * max |dxg|); before the
# first flip the two agree to f32 noise, so the mean |err| of dxg over each
# direction's first EARLY_STEPS backward steps must stay under
# EARLY_MEAN_TOL, which holds the bf16(dgates) @ bf16(w_h)^T contract.
BWD_REL = 2.0 ** -6
BWD_SHAPES = [(400, 16, 1280, "bfloat16"), (200, 16, 1280, "bfloat16"),
              (37, 3, 200, "float32"), (37, 3, 200, "bfloat16")]
BWD_FAULT_SHAPE = (200, 16, 1280, "bfloat16")
# K3/K4 vs plain: the same bf16 small operand times int8 values, products
# exact in f32, only the order of the f32 sums differs: max |err| <= 1e-5 *
# max |ref| (an unrounded f32 operand moves the result by ~1e-3 of it).
INT8_REL = 1e-5
INT8_SHAPES = [(16, 400, 2560), (16, 200, 2560), (3, 37, 50), (5, 17, 48)]
TRAIN_STEPS = 6
# K5/K6 vs plain: ys and the stashes as K1 (TOL, STASH_REL, the early mean
# over the walk's first EARLY_STEPS steps), dxg as K2 (BWD_REL of max |dxg|,
# the early mean over the first backward steps). The LM's products sum 1024
# to 8192 terms over 128 rows, so the early means of a sound kernel reach
# 1e-7 to 7e-7 where K1/K2 read 1e-7; the f32-operand fault reads 1.7e-5 to
# 3.6e-5: the bound sits between, at 3e-6. (T, B, H, dtype, reverse)
LSTM_EARLY_MEAN_TOL = 3e-6
LSTM_SHAPES = {
    "resident": [(160, 128, 1024, "bfloat16", False),
                 (160, 128, 1024, "bfloat16", True),
                 (37, 3, 200, "float32", False), (37, 3, 200, "float32", True),
                 (37, 3, 200, "bfloat16", False)],
    "chunked": [(160, 128, 2048, "bfloat16", False),
                (320, 64, 2048, "bfloat16", False),
                (37, 3, 200, "float32", False),
                (37, 3, 200, "bfloat16", False)]}
LM_STEPS = 6
LM_VALID = 3
LM_K5_STEPS = 3
# lm_apply (bf16 xg and hidden streams through K6f) against lm_step token by
# token (f32 streams, the same bf16 matmul operands) on one dev batch: the
# streams' bf16 roundings (2^-9 relative per layer) reach the logits, sums
# of 2048 products: max |err| <= 5% of max |logit|, mean |err| <= 0.5%.
LM_LOGIT_MAX_REL = 5e-2
LM_LOGIT_MEAN_REL = 5e-3
# published peaks of one H100 SXM: dense bf16 FLOP/s, HBM bytes/s
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def _say(phase, msg):
    print("[{}] {}".format(phase, msg), flush=True)


def _nvidia_smi():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()  # warm-up
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _ys_errors(out, ref):
    """(max |err| of ys over the sequence, mean |err| of ys over each
    direction's first EARLY_STEPS steps)."""
    import torch
    t = out[0].shape[0]
    k = min(EARLY_STEPS, t)
    d_f = (out[0].float() - ref[0].float()).abs()
    d_b = (out[1].float() - ref[1].float()).abs()
    early = torch.cat([d_f[:k].flatten(), d_b[t - k:].flatten()]).mean()
    return max(d_f.max().item(), d_b.max().item()), early.item()


def _sound(dt, full, early):
    return full <= TOL[dt] and early <= EARLY_MEAN_TOL


def check_planted_faults(K, out, args, dt):
    """The kernel's output held against a plain version with a planted
    fault must fail the checks that the sound plain version passes."""
    xg_f, xg_b, wh_f, wh_b = args
    faults = {"w_h x2": lambda: K.bilstm_recurrence_ref(xg_f, xg_b, 2 * wh_f,
                                                         wh_b)}

    def f32_h():
        sound_operand = K._h_operand
        K._h_operand = lambda h: h
        try:
            return K.bilstm_recurrence_ref(*args)
        finally:
            K._h_operand = sound_operand
    faults["f32 h"] = f32_h
    for name, ref_fn in faults.items():
        full, early = _ys_errors(out, ref_fn())
        if _sound(dt, full, early):
            raise AssertionError("planted fault '{}' passed the checks at {}: "
                                 "max {:.3e}, early mean {:.3e}".format(
                                     name, dt, full, early))
        _say("fault", "T={} B={} H={} {}, plain version with {}: max|err| ys "
             "{:.3e} (tol {}), early mean {:.3e} (tol {}) -> caught".format(
                 *FAULT_SHAPE, dt, name, full, TOL[dt], early,
                 EARLY_MEAN_TOL))


def phase_kernel(dev):
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    gen = torch.Generator().manual_seed(0)
    worst, main_ms, main_plain_ms = 0.0, None, None
    for t, b, h, dt in SHAPES:
        dtype = getattr(torch, dt)
        xg_f = torch.randn(t, b, 4 * h, generator=gen).to(dev, dtype)
        xg_b = torch.randn(t, b, 4 * h, generator=gen).to(dev, dtype)
        wh_f = (torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to(dev)
        wh_b = (torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to(dev)
        args = (xg_f, xg_b, wh_f, wh_b)
        out = K.bilstm_recurrence(*args, stash=True)
        torch.cuda.synchronize()
        ref = K.bilstm_recurrence_ref(*args, stash=True)
        errs = [(o.float() - r.float()).abs().max().item()
                for o, r in zip(out, ref)]
        ys_err, early = _ys_errors(out, ref)
        if not _sound(dt, ys_err, early):
            raise AssertionError(
                "kernel ys differ from the plain version at {}: max {:.3e} "
                "(tol {}), early mean {:.3e} (tol {})".format(
                    (t, b, h, dt), ys_err, TOL[dt], early, EARLY_MEAN_TOL))
        for o, r in zip(out[2:], ref[2:]):
            bound = TOL[dt] + r.float().abs() * STASH_REL
            if not bool(((o.float() - r.float()).abs() <= bound).all()):
                raise AssertionError("kernel stash differs at {}".format(
                    (t, b, h, dt)))
        worst = max(worst, ys_err)
        if (t, b, h) == FAULT_SHAPE:
            check_planted_faults(K, out[:2], args, dt)
        ms = _time_ms(lambda: K.bilstm_recurrence(*args), 10)
        plain_ms = _time_ms(lambda: K.bilstm_recurrence_ref(*args), 3)
        if (t, b, h, dt) == MAIN_SHAPE:
            main_ms, main_plain_ms = ms, plain_ms
        _say("kernel", "T={} B={} H={} {}: max|err| ys {:.3e} (tol {}), "
             "early mean {:.3e} (tol {}), cs {:.3e} gates {:.3e}; kernel "
             "{:.3f} ms, plain {:.3f} ms".format(
                 t, b, h, dt, ys_err, TOL[dt], early, EARLY_MEAN_TOL,
                 max(errs[2:4]), max(errs[4:]), ms, plain_ms))
    return worst, main_ms, main_plain_ms


def _dxg_errors(out, ref):
    """(max |err| / max |ref| of dxg over the sequence, mean |err| over each
    direction's first EARLY_STEPS backward steps, max |err|)."""
    import torch
    t = out[0].shape[0]
    k = min(EARLY_STEPS, t)
    d_f = (out[0].float() - ref[0].float()).abs()
    d_b = (out[1].float() - ref[1].float()).abs()
    mag = max(ref[0].float().abs().max().item(),
              ref[1].float().abs().max().item())
    full = max(d_f.max().item(), d_b.max().item())
    early = torch.cat([d_f[t - k:].flatten(), d_b[:k].flatten()]).mean()
    return full / mag, early.item(), full


def phase_bwd(dev):
    """K2 against its plain version, from stashes made by K1."""
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    gen = torch.Generator().manual_seed(2)
    worst, main = 0.0, None
    for t, b, h, dt in BWD_SHAPES:
        dtype = getattr(torch, dt)
        xg_f = torch.randn(t, b, 4 * h, generator=gen).to(dev, dtype)
        xg_b = torch.randn(t, b, 4 * h, generator=gen).to(dev, dtype)
        wh_f = (torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to(dev)
        wh_b = (torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to(dev)
        _, _, cs_f, cs_b, g_f, g_b = K.bilstm_recurrence(xg_f, xg_b, wh_f,
                                                         wh_b, stash=True)
        dy_f = torch.randn(t, b, h, generator=gen).to(dev, dtype)
        dy_b = torch.randn(t, b, h, generator=gen).to(dev, dtype)
        args = [wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f, dy_b]
        out = K.bilstm_recurrence_bwd(*args)
        torch.cuda.synchronize()
        rel, early, full = _dxg_errors(out, K.bilstm_recurrence_bwd_ref(*args))
        if rel > BWD_REL or early > EARLY_MEAN_TOL:
            raise AssertionError(
                "K2 dxg differs from the plain version at {}: max rel {:.3e} "
                "(tol {:.3e}), early mean {:.3e} (tol {})".format(
                    (t, b, h, dt), rel, BWD_REL, early, EARLY_MEAN_TOL))
        worst = max(worst, full)
        if (t, b, h, dt) == BWD_FAULT_SHAPE:
            faults = {"w_h x2": lambda: K.bilstm_recurrence_bwd_ref(
                2 * wh_f, *args[1:])}

            def f32_dgates():
                sound_operand = K._dg_operand
                K._dg_operand = lambda d: d
                try:
                    return K.bilstm_recurrence_bwd_ref(*args)
                finally:
                    K._dg_operand = sound_operand
            faults["f32 dgates"] = f32_dgates
            for name, ref_fn in faults.items():
                f_rel, f_early, _ = _dxg_errors(out, ref_fn())
                if f_rel <= BWD_REL and f_early <= EARLY_MEAN_TOL:
                    raise AssertionError(
                        "planted fault '{}' passed the K2 checks".format(name))
                _say("fault", "K2 T={} B={} H={} {}, plain version with {}: "
                     "max rel {:.3e} (tol {:.3e}), early mean {:.3e} (tol "
                     "{}) -> caught".format(t, b, h, dt, name, f_rel, BWD_REL,
                                            f_early, EARLY_MEAN_TOL))
        ms = _time_ms(lambda: K.bilstm_recurrence_bwd(*args), 10)
        plain_ms = _time_ms(lambda: K.bilstm_recurrence_bwd_ref(*args), 2)
        if main is None:
            main = (ms, plain_ms)
        _say("kernel", "K2 T={} B={} H={} {}: max|err| dxg {:.3e} (rel "
             "{:.3e}, tol {:.3e}), early mean {:.3e} (tol {}); kernel {:.3f} "
             "ms, plain {:.3f} ms".format(t, b, h, dt, full, rel, BWD_REL,
                                          early, EARLY_MEAN_TOL, ms,
                                          plain_ms))
    return worst, main[0], main[1]


def phase_int8(dev):
    """K3 and K4 against their plain versions."""
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q
    gen = torch.Generator().manual_seed(3)
    res = {"context_int8": [0.0, None, None], "dattn_int8": [0.0, None, None]}
    for b, t, d in INT8_SHAPES:
        values = torch.tanh(1.2 * torch.randn(b, t, d, generator=gen)).to(dev)
        q, scale = Q.quantize_table(values)
        attn = torch.softmax(torch.randn(b, t, generator=gen), -1).to(dev)
        a2 = attn * scale
        dctx = (0.1 * torch.randn(b, d, generator=gen)).to(dev)
        cases = {"context_int8": (Q.context_int8, Q.context_int8_ref, a2,
                                  "bt,btd->bd"),
                 "dattn_int8": (Q.dattn_int8, Q.dattn_int8_ref, dctx,
                                "bd,btd->bt")}
        line = []
        for name, (fn, ref_fn, small, eq) in cases.items():
            out = fn(small, q)
            torch.cuda.synchronize()
            ref = ref_fn(small, q)
            err = (out - ref).abs().max().item()
            mag = ref.abs().max().item()
            if err > INT8_REL * mag:
                raise AssertionError("{} differs from the plain version at "
                                     "{}: max|err| {:.3e} vs |ref| {:.3e}"
                                     .format(name, (b, t, d), err, mag))
            res[name][0] = max(res[name][0], err)
            if (b, t, d) == INT8_SHAPES[0]:
                faults = {
                    "q x2": torch.einsum(eq, Q._small_operand(small),
                                         2 * q.float()),
                    "f32 operand": torch.einsum(eq, small, q.float())}
                for fault, bad in faults.items():
                    f_err = (out - bad).abs().max().item()
                    if f_err <= INT8_REL * bad.abs().max().item():
                        raise AssertionError("planted fault '{}' passed the "
                                             "{} check".format(fault, name))
                    _say("fault", "{} B={} T={} D={}, plain version with {}: "
                         "max|err| {:.3e} (tol {:.3e}) -> caught".format(
                             name, b, t, d, fault, f_err,
                             INT8_REL * bad.abs().max().item()))
            ms = _time_ms(lambda: fn(small, q), 20)
            plain_ms = _time_ms(lambda: ref_fn(small, q), 20)
            if res[name][1] is None:
                res[name][1:] = [ms, plain_ms]
            line.append("{} max|err| {:.3e} (tol {:.3e}), kernel {:.4f} ms, "
                        "plain {:.4f} ms".format(name, err, INT8_REL * mag, ms,
                                                 plain_ms))
        _say("kernel", "B={} T={} D={}: {}".format(b, t, d, "; ".join(line)))
    return res


def _bound(flops, nbytes):
    """(the least ms the card could take, which of the two binds)."""
    by_ops, by_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def _lstm_bound(t, b, h, dirs, out_bytes):
    """One direction's recurrence over its streams, forward or backward:
    2*T*B*H*4H operations; bytes = the (T,B,4H) bf16 gate stream in, the
    (T,B,4H) stream out (out_bytes each), two (T,B,H) bf16 streams and the
    bf16 w_h. The forward reads xg and writes ys, cs, gates; the backward
    reads gates, cs, dy and writes dxg."""
    flops = dirs * 2.0 * t * b * h * 4 * h
    nbytes = dirs * (t * b * 4 * h * (2 + out_bytes) + 2 * t * b * h * 2
                     + h * 4 * h * 2)
    return _bound(flops, nbytes)


def _library_lstm(dev, t, b, in_dim, h, bidirectional):
    """torch.nn.LSTM on cuDNN in bf16 at (T,B,in_dim) -> H: ms of the
    forward, of forward + backward, and of the input-projection matmul that
    both include. Timed only; the port never calls it."""
    import torch
    lstm = torch.nn.LSTM(in_dim, h, 1, bidirectional=bidirectional).to(
        dev, torch.bfloat16)
    x = torch.randn(t, b, in_dim, device=dev, dtype=torch.bfloat16)
    dirs = 2 if bidirectional else 1
    dy = torch.randn(t, b, dirs * h, device=dev, dtype=torch.bfloat16)
    w_x = torch.randn(in_dim, dirs * 4 * h, device=dev, dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            lstm(x)

    def fwd_bwd():
        xr = x.detach().requires_grad_()
        out, _ = lstm(xr)
        out.backward(dy)
        lstm.zero_grad(set_to_none=True)
    return (_time_ms(fwd, 5), _time_ms(fwd_bwd, 5),
            _time_ms(lambda: torch.matmul(x, w_x), 5))


def phase_lstm(dev):
    """K5f/K5b and K6f/K6b against their plain versions, the backward from
    the stashes its forward kernel made. Returns per kernel its worst max
    |err| and, at its main path's shape (the first of its list), the kernel,
    plain, bound and library times."""
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as K
    gen = torch.Generator().manual_seed(5)
    names = {"resident": ("lstm_fwd", "lstm_bwd"),
             "chunked": ("lstm_fwd_chunked", "lstm_bwd_chunked")}
    res = {n: {"max_abs_err": 0.0} for pair in names.values() for n in pair}

    def errors(out, ref, first_at_end):
        t = out.shape[0]
        k = min(EARLY_STEPS, t)
        d = (out.float() - ref.float()).abs()
        return d.max().item(), (d[t - k:] if first_at_end else d[:k]
                                ).mean().item()

    for form, shapes in LSTM_SHAPES.items():
        f_name, b_name = names[form]
        for t, b, h, dt, reverse in shapes:
            xg = torch.randn(t, b, 4 * h, generator=gen).to(
                dev, getattr(torch, dt))
            w_h = (torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to(dev)
            dy = torch.randn(t, b, h, generator=gen).to(dev,
                                                        getattr(torch, dt))
            if form == "resident":
                fwd = lambda w=w_h: K.lstm_fwd(xg, w, reverse, stash=True)
                fwd_ref = lambda w=w_h: K.lstm_recurrence_ref(
                    xg, w, reverse, stash=True)
                bwd = lambda w=w_h: K.lstm_bwd(w, cs, gs, dy, reverse)
                bwd_ref = lambda w=w_h: K.lstm_recurrence_bwd_ref(
                    w, cs, gs, dy, reverse)
            else:
                fwd = lambda w=w_h: K.lstm_fwd_chunked(xg, w, stash=True)
                fwd_ref = lambda w=w_h: K.lstm_recurrence_chunked_ref(
                    xg, w, stash=True)
                bwd = lambda w=w_h: K.lstm_bwd_chunked(w, cs, gs, dy)
                bwd_ref = lambda w=w_h: K.lstm_recurrence_chunked_bwd_ref(
                    w, cs, gs, dy)
            where = "T={} B={} H={} {}{}".format(t, b, h, dt,
                                                 " reversed" * reverse)
            out = fwd()
            torch.cuda.synchronize()
            ys, cs, gs = out
            ref = fwd_ref()
            full, early = errors(ys, ref[0], reverse)
            if full > TOL[dt] or early > LSTM_EARLY_MEAN_TOL:
                raise AssertionError(
                    "{} ys differ from the plain version at {}: max {:.3e} "
                    "(tol {}), early mean {:.3e} (tol {})".format(
                        f_name, where, full, TOL[dt], early, LSTM_EARLY_MEAN_TOL))
            for o, r in zip(out[1:], ref[1:]):
                bound = TOL[dt] + r.float().abs() * STASH_REL
                if not bool(((o.float() - r.float()).abs() <= bound).all()):
                    raise AssertionError("{} stash differs at {}".format(
                        f_name, where))
            dxg = bwd()
            torch.cuda.synchronize()
            rdxg = bwd_ref()
            b_full, b_early = errors(dxg, rdxg, not reverse)
            b_rel = b_full / rdxg.float().abs().max().item()
            if b_rel > BWD_REL or b_early > LSTM_EARLY_MEAN_TOL:
                raise AssertionError(
                    "{} dxg differs from the plain version at {}: max rel "
                    "{:.3e} (tol {:.3e}), early mean {:.3e} (tol {})".format(
                        b_name, where, b_rel, BWD_REL, b_early,
                        LSTM_EARLY_MEAN_TOL))
            res[f_name]["max_abs_err"] = max(res[f_name]["max_abs_err"], full)
            res[b_name]["max_abs_err"] = max(res[b_name]["max_abs_err"],
                                             b_full)
            main_shape = (t, b, h, dt, reverse) == shapes[0]
            if main_shape:
                _lstm_planted_faults(K, where, dt, reverse, ys, dxg, w_h,
                                     fwd_ref, bwd_ref, errors, f_name, b_name)
            ms = _time_ms(fwd, 10)
            b_ms = _time_ms(bwd, 10)
            plain_ms = _time_ms(fwd_ref, 2)
            b_plain_ms = _time_ms(bwd_ref, 2)
            _say("kernel", "{} {}: max|err| ys {:.3e} (tol {}), early mean "
                 "{:.3e} (tol {}); kernel {:.3f} ms, plain {:.3f} ms | {}: "
                 "max|err| dxg {:.3e} (rel {:.3e}, tol {:.3e}), early mean "
                 "{:.3e}; kernel {:.3f} ms, plain {:.3f} ms".format(
                     f_name, where, full, TOL[dt], early, LSTM_EARLY_MEAN_TOL, ms,
                     plain_ms, b_name, b_full, b_rel, BWD_REL, b_early, b_ms,
                     b_plain_ms))
            if main_shape:
                lib_f, lib_fb, lib_xg = _library_lstm(dev, t, b, h, h, False)
                f_bound = _lstm_bound(t, b, h, 1, 2)
                b_bound = _lstm_bound(t, b, h, 1, dxg.element_size())
                res[f_name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_f,
                                   library_xg_ms=lib_xg, bound_ms=f_bound[0],
                                   bound_by=f_bound[1])
                res[b_name].update(ms=b_ms, plain_ms=b_plain_ms,
                                   library_ms=lib_fb, library_xg_ms=lib_xg,
                                   bound_ms=b_bound[0], bound_by=b_bound[1])
                _say("kernel", "{} / {} at {}: bound {:.3f} ms ({}) / {:.3f} "
                     "ms ({}); library call torch.nn.LSTM (cuDNN, bf16, input "
                     "projection included) forward {:.3f} ms, forward + "
                     "backward {:.3f} ms; the xg matmul alone {:.3f} ms"
                     .format(f_name, b_name, where, f_bound[0], f_bound[1],
                             b_bound[0], b_bound[1], lib_f, lib_fb, lib_xg))
    return res


def _lstm_planted_faults(K, where, dt, reverse, ys, dxg, w_h, fwd_ref,
                         bwd_ref, errors, f_name, b_name):
    """The kernels' outputs held against plain versions with a doubled w_h
    and with an f32 operand in place of the bf16 one must fail."""
    def unrounded(ref_fn):
        sound = K._h_operand, K._dg_operand
        K._h_operand = K._dg_operand = lambda x: x
        try:
            return ref_fn()
        finally:
            K._h_operand, K._dg_operand = sound
    faults = {"w_h x2": (lambda: fwd_ref(2 * w_h)[0],
                         lambda: bwd_ref(2 * w_h)),
              "f32 operand": (lambda: unrounded(fwd_ref)[0],
                              lambda: unrounded(bwd_ref))}
    for fault, (bad_fwd, bad_bwd) in faults.items():
        full, early = errors(ys, bad_fwd(), reverse)
        if full <= TOL[dt] and early <= LSTM_EARLY_MEAN_TOL:
            raise AssertionError("planted fault '{}' passed the {} checks at "
                                 "{}".format(fault, f_name, where))
        bad = bad_bwd()
        b_full, b_early = errors(dxg, bad, not reverse)
        b_rel = b_full / bad.float().abs().max().item()
        if b_rel <= BWD_REL and b_early <= LSTM_EARLY_MEAN_TOL:
            raise AssertionError("planted fault '{}' passed the {} checks at "
                                 "{}".format(fault, b_name, where))
        _say("fault", "{} at {}, plain version with {}: max|err| ys {:.3e} "
             "(tol {}), early mean {:.3e} (tol {}) -> caught | {}: max rel "
             "{:.3e} (tol {:.3e}), early mean {:.3e} -> caught".format(
                 f_name, where, fault, full, TOL[dt], early, LSTM_EARLY_MEAN_TOL,
                 b_name, b_rel, BWD_REL, b_early))


def _write_slice_configs(tmp, model=None):
    """The flagship model block (or ``model``), the published decode block
    and the LM model block, over the synthetic corpus. Returns the test
    config's path and the ASR and LM model blocks; the checkpoints it names
    come from _write_checkpoints."""
    import yaml

    def load(name):
        with open(os.path.join(ROOT, "config", name)) as f:
            return yaml.safe_load(f)
    asr_cfg = load("librispeech_asr_best.yaml")
    test_cfg = load("librispeech_test.yaml")
    lm_cfg = load("librispeech_lm_best.yaml")
    text = dict(asr_cfg["data"]["text"])
    text["vocab_file"] = os.path.join(ROOT, text["vocab_file"])
    corpus = {"name": "synthetic", "path": "", "batch_size": 8,
              "n_utts": 16, "min_tokens": 20, "max_tokens": 80}
    train = {"data": {"corpus": dict(corpus, train_split=["train"],
                                     dev_split=["dev"], bucketing=True),
                      "audio": asr_cfg["data"]["audio"], "text": text},
             "model": model or asr_cfg["model"]}
    decode = dict(test_cfg["decode"],
                  lm_config=os.path.join(tmp, "lm.yaml"),
                  lm_path=os.path.join(tmp, "lm.pth"))
    test = {"data": {"corpus": dict(corpus, dev_split=["dev"],
                                    test_split=["test"], bucketing=False)},
            "src": {"config": os.path.join(tmp, "train.yaml"),
                    "ckpt": os.path.join(tmp, "asr.pth")},
            "decode": decode}
    for name, cfg in (("train", train), ("lm", {"model": lm_cfg["model"]}),
                      ("test", test)):
        with open(os.path.join(tmp, name + ".yaml"), "w") as f:
            yaml.safe_dump(cfg, f)
    return os.path.join(tmp, "test.yaml"), train["model"], lm_cfg["model"]


def _write_checkpoints(tmp, seed, feat_dim, vocab_size, model, lm_model):
    """Seeded ASR and LM weights as port checkpoints in ``tmp``."""
    import torch
    from e2e_asr_pytorch_tpu_torch.models import asr as M
    from e2e_asr_pytorch_tpu_torch.models import lm as LM
    from e2e_asr_pytorch_tpu_torch.train.checkpoint import save_checkpoint
    gen = torch.Generator().manual_seed(seed)
    spec = M.build_spec(feat_dim, vocab_size, **model)
    save_checkpoint(os.path.join(tmp, "asr.pth"), M.asr_init(gen, spec))
    lm_spec = LM.build_spec(vocab_size, **lm_model)
    save_checkpoint(os.path.join(tmp, "lm.pth"), LM.lm_init(gen, lm_spec))
    return spec, lm_spec


def _check_csvs(outdir, name, beam, vocab_chars):
    for split in ("dev", "test"):
        path = os.path.join(outdir, "{}_{}_output.csv".format(name, split))
        with open(path) as f:
            rows = f.read().splitlines()
        if rows[0] != "idx\thyp\ttruth" or len(rows) != 1 + 16:
            raise AssertionError("bad {}: {} rows".format(path, len(rows)))
        hyps = [r.split("\t") for r in rows[1:]]
        if any(len(r) != 3 for r in hyps):
            raise AssertionError("bad columns in " + path)
        for _, hyp, _ in hyps:
            extra = set(hyp.replace("<unk>", "")) - vocab_chars
            if extra:
                raise AssertionError("hyp outside the vocab: {!r}".format(
                    sorted(extra)))
        bpath = os.path.join(outdir, "{}_{}_beam.csv".format(name, split))
        if beam > 1:
            with open(bpath) as f:
                brows = f.read().splitlines()
            if (brows[0] != "idx\tbeam\thyp\ttruth"
                    or len(brows) != 1 + 16 * beam
                    or any(len(r.split("\t")) != 4 for r in brows[1:])):
                raise AssertionError("bad " + bpath)
        elif os.path.exists(bpath):
            raise AssertionError("greedy wrote " + bpath)


def phase_slice(seed):
    import torch
    from e2e_asr_pytorch_tpu_torch import convert
    from e2e_asr_pytorch_tpu_torch.main import build_solver, main
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K

    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        cfg, model, lm_model = _write_slice_configs(tmp)
        outdir = os.path.join(tmp, "out")
        argv = ["--test", "--config", cfg, "--outdir", outdir, "--njobs",
                "0", "--seed", str(seed), "--no-msg"]
        # the vocabulary and feature width, as the port's solver reads them
        data = build_solver(argv + ["--name", "data"])
        spec, lm_spec = _write_checkpoints(tmp, seed, data.feat_dim,
                                           data.vocab_size, model, lm_model)
        _say("slice", "seeded checkpoints written in {:.1f} s (ASR {} "
             "encoder layers x BLSTM-{}, LM {}x LSTM-{})".format(
                 time.perf_counter() - t0, len(spec.encoder.dim),
                 spec.encoder.dim[0], lm_spec.n_layers, lm_spec.dim))
        K.LAUNCHES = 0  # counts reset just before the main path
        runs = [("beam", 8, main(argv + ["--name", "beam"]))]
        after_beam = K.LAUNCHES
        runs.append(("greedy", 1, main(argv + ["--name", "greedy",
                                               "--override",
                                               "decode.beam_size=1"])))
        launches = K.LAUNCHES  # read just after
        per_mode = {"beam": after_beam, "greedy": launches - after_beam}
        for mode, beam, solver in runs:
            n_batches = len(solver.dv_set) + len(solver.tt_set)
            n_layers = len(solver.spec.encoder.dim)
            if per_mode[mode] != n_layers * n_batches:
                raise AssertionError(
                    "{}: kernel launched {} times for {} batches x {} "
                    "layers".format(mode, per_mode[mode], n_batches,
                                    n_layers))
            leaves = convert.tree_leaves(solver.params)
            if solver.lm_params is not None:
                leaves += convert.tree_leaves(solver.lm_params)
            if not all(x.is_cuda for x in leaves):
                raise AssertionError(mode + ": a parameter is not on cuda")
            if solver.compute_dtype != torch.bfloat16:
                raise AssertionError(mode + ": compute dtype is not bf16")
            vocab_chars = set(solver.tokenizer._vocab_list[3:])
            _check_csvs(outdir, mode, beam, vocab_chars)
            rtf = solver.decode_seconds / solver.audio_seconds
            results[mode] = dict(
                utts=solver.n_utts, batches=n_batches,
                audio_s=solver.audio_seconds,
                decode_s=solver.decode_seconds,
                utts_per_s=solver.n_utts / solver.decode_seconds, rtf=rtf,
                launches=per_mode[mode])
            _say("slice", "{}: {} utts in {} batches, {:.1f} s of audio, "
                 "decoded in {:.3f} s -> {:.2f} utts/s, RTF {:.5f}; kernel "
                 "launches {} (= {} layers x {} batches); CSVs ok".format(
                     mode, solver.n_utts, n_batches, solver.audio_seconds,
                     solver.decode_seconds, results[mode]["utts_per_s"], rtf,
                     per_mode[mode], n_layers, n_batches))
    _say("slice", json.dumps(results))
    return launches, results


def _write_train_configs(tmp, model=None, steps=TRAIN_STEPS, utts=96,
                         batch=16):
    """The flagship's data.audio, hparas and model blocks verbatim (or
    ``model``), over the synthetic corpus, with max_step and valid_step set
    to ``steps``; and a greedy test config that decodes the run's
    last_att_dev.pth. Returns (train config, test config, experiment
    name)."""
    import yaml
    with open(os.path.join(ROOT, "config", "librispeech_asr_best.yaml")) as f:
        asr_cfg = yaml.safe_load(f)
    text = dict(asr_cfg["data"]["text"])
    text["vocab_file"] = os.path.join(ROOT, text["vocab_file"])
    corpus = {"name": "synthetic", "path": "", "batch_size": batch,
              "n_utts": utts, "min_tokens": 20, "max_tokens": 80}
    train = {"data": {"corpus": dict(corpus, train_split=["train"],
                                     dev_split=["dev"], bucketing=True),
                      "audio": asr_cfg["data"]["audio"], "text": text},
             "hparas": dict(asr_cfg["hparas"], max_step=steps,
                            valid_step=steps),
             "model": model or asr_cfg["model"]}
    name = "train"
    test = {"data": {"corpus": dict(corpus, n_utts=16, batch_size=8,
                                    dev_split=["dev"], test_split=["test"],
                                    bucketing=False)},
            "src": {"config": os.path.join(tmp, "train.yaml"),
                    "ckpt": os.path.join(tmp, "ckpt", name,
                                         "last_att_dev.pth")},
            "decode": {"ctc_weight": 0.0, "beam_size": 1,
                       "min_len_ratio": 0.01, "max_len_ratio": 0.3,
                       "lm_weight": 0.0}}
    for fname, cfg in (("train", train), ("train_test", test)):
        with open(os.path.join(tmp, fname + ".yaml"), "w") as f:
            yaml.safe_dump(cfg, f)
    return (os.path.join(tmp, "train.yaml"),
            os.path.join(tmp, "train_test.yaml"), name)


def _reset_counts():
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as KL
    K.LAUNCHES = K.BWD_LAUNCHES = 0
    Q.CTX_LAUNCHES = Q.DATTN_LAUNCHES = 0
    KL.FWD_LAUNCHES = KL.BWD_LAUNCHES = 0
    KL.FWD_CHUNKED_LAUNCHES = KL.BWD_CHUNKED_LAUNCHES = 0


def _read_counts():
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as KL
    return {"bilstm_fwd": K.LAUNCHES, "bilstm_bwd": K.BWD_LAUNCHES,
            "context_int8": Q.CTX_LAUNCHES, "dattn_int8": Q.DATTN_LAUNCHES,
            "lstm_fwd": KL.FWD_LAUNCHES, "lstm_bwd": KL.BWD_LAUNCHES,
            "lstm_fwd_chunked": KL.FWD_CHUNKED_LAUNCHES,
            "lstm_bwd_chunked": KL.BWD_CHUNKED_LAUNCHES}


def phase_train(seed, dev):
    """The flagship training step through the port's CLI, then a greedy
    decode of the checkpoint it wrote."""
    import torch
    from e2e_asr_pytorch_tpu_torch import convert
    from e2e_asr_pytorch_tpu_torch.main import main
    from e2e_asr_pytorch_tpu_torch.models import asr as M
    from e2e_asr_pytorch_tpu_torch.train.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train_cfg, test_cfg, name = _write_train_configs(tmp)
        argv = ["--config", train_cfg, "--name", name, "--njobs", "0",
                "--seed", str(seed), "--logdir", os.path.join(tmp, "log"),
                "--ckpdir", os.path.join(tmp, "ckpt"), "--no-msg"]
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        _reset_counts()  # counts reset just before the main path
        solver = main(argv)
        counts = _read_counts()  # read just after
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)

        steps = solver.step
        n_layers = len(solver.spec.encoder.dim)
        want = dict.fromkeys(counts, 0)
        want.update({
            "bilstm_fwd": n_layers * (steps + solver.n_valid_batches),
            "bilstm_bwd": n_layers * steps,
            "context_int8": sum(solver.decode_lengths),
            "dattn_int8": sum(solver.decode_lengths)})
        if steps != TRAIN_STEPS or counts != want:
            raise AssertionError("train: {} steps, launches {} where {} were "
                                 "expected".format(steps, counts, want))
        for i, st in enumerate(solver.step_stats):
            if not all(math.isfinite(st[k]) for k in ("total", "gnorm",
                                                      "ctc", "att")):
                raise AssertionError("train step {}: {}".format(i + 1, st))
        if solver.compute_dtype != torch.bfloat16:
            raise AssertionError("train: compute dtype is not bf16")
        leaves = convert.tree_leaves(solver.params)
        if not all(x.is_cuda for x in leaves):
            raise AssertionError("train: a parameter is not on cuda")
        init = convert.tree_leaves(M.asr_init(
            torch.Generator().manual_seed(seed), solver.spec, dev))
        moved = sum(not torch.equal(a, b) for a, b in zip(init, leaves))
        if moved < len(leaves) // 2:
            raise AssertionError("train: only {} of {} parameter leaves "
                                 "moved".format(moved, len(leaves)))
        acc = (convert.tree_leaves(solver.opt_state["e_g"])
               + convert.tree_leaves(solver.opt_state["e_x"]))
        if not all(x.dtype == torch.bfloat16 for x in acc):
            raise AssertionError("train: optimizer state is not bf16")

        ckpt_path = os.path.join(tmp, "ckpt", name, "last_att_dev.pth")
        ckpt = load_checkpoint(ckpt_path, dev)
        if (ckpt["global_step"] != steps
                or int(ckpt["optimizer"]["count"]) != steps):
            raise AssertionError("train: checkpoint at step {}, {} updates"
                                 .format(ckpt["global_step"],
                                         int(ckpt["optimizer"]["count"])))
        outdir = os.path.join(tmp, "out")
        tester = main(["--test", "--config", test_cfg, "--name", "greedy",
                       "--njobs", "0", "--seed", str(seed), "--outdir",
                       outdir, "--no-msg"])
        _check_csvs(outdir, "greedy", 1,
                    set(tester.tokenizer._vocab_list[3:]))

    secs = solver.step_seconds[1:]
    med = statistics.median(secs)
    utts_s = sum(solver.step_utts[1:]) / sum(secs)
    audio_s = sum(solver.step_audio_seconds[1:]) / sum(secs)
    res = {"steps": steps, "valid_batches": solver.n_valid_batches,
           "first_step_s": solver.step_seconds[0], "median_step_s": med,
           "utts_per_s": utts_s, "audio_s_per_s": audio_s,
           "peak_mem_gb": peak / 2 ** 30, "wall_s": wall,
           "decode_lengths": solver.decode_lengths,
           "losses": [round(st["total"], 4) for st in solver.step_stats],
           "gnorms": [round(st["gnorm"], 4) for st in solver.step_stats],
           "launches": counts, "moved_leaves": moved,
           "n_leaves": len(leaves)}
    _say("train", "{} steps at batch 16 of the flagship (5x BLSTM-1280, "
         "int8 table, bf16 d_key, Adadelta bf16 state, SpecAugment, dropout "
         "0.3): losses {}, grad norms {}; first step {:.3f} s, median step "
         "after it {:.4f} s -> {:.2f} utts/s, {:.2f} s of audio per s; peak "
         "allocated {:.2f} GiB; launches {} (= expected); {} of {} leaves "
         "moved; checkpoint at step {} decoded greedily, CSVs ok".format(
             steps, res["losses"], res["gnorms"], res["first_step_s"], med,
             utts_s, audio_s, res["peak_mem_gb"], counts, moved, len(leaves),
             steps))
    _say("train", json.dumps(res))
    return counts, res


def _write_lm_config(tmp, source, steps, valid):
    """The model and hparas blocks of config/<source> verbatim over the
    synthetic text corpus at batch 128, with max_step and valid_step set.
    Returns the config's path and the model block."""
    import yaml
    with open(os.path.join(ROOT, "config", source)) as f:
        src = yaml.safe_load(f)
    text = dict(src["data"]["text"])
    text["vocab_file"] = os.path.join(ROOT, text["vocab_file"])
    cfg = {"data": {"corpus": {"name": "synthetic", "path": "",
                               "train_split": ["lm-train"],
                               "dev_split": ["lm-dev"], "bucketing": True,
                               "batch_size": 128, "n_sents": 2048,
                               "min_tokens": 40, "max_tokens": 300},
                    "text": text},
           "hparas": dict(src["hparas"], max_step=steps, valid_step=valid),
           "model": src["model"]}
    path = os.path.join(tmp, source)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, src["model"]


def _run_lm(tmp, seed, dev, source, name, steps, valid, fwd_key, bwd_key):
    """``main --lm`` on one config with the counts reset just before and
    read just after; the checks every LM run must pass."""
    import torch
    from e2e_asr_pytorch_tpu_torch import convert
    from e2e_asr_pytorch_tpu_torch.main import main
    from e2e_asr_pytorch_tpu_torch.models import lm as LM
    cfg, _ = _write_lm_config(tmp, source, steps, valid)
    argv = ["--lm", "--config", cfg, "--name", name, "--njobs", "0",
            "--seed", str(seed), "--logdir", os.path.join(tmp, "log"),
            "--ckpdir", os.path.join(tmp, "ckpt"), "--no-msg"]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _reset_counts()  # counts reset just before the main path
    solver = main(argv)
    counts = _read_counts()  # read just after
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)

    n_layers = solver.lm_spec.n_layers
    want = dict.fromkeys(counts, 0)
    want[fwd_key] = n_layers * (solver.step + solver.n_valid_batches)
    want[bwd_key] = n_layers * solver.step
    if solver.step != steps or counts != want:
        raise AssertionError("{}: {} steps, launches {} where {} were "
                             "expected".format(name, solver.step, counts,
                                               want))
    if solver.n_valid_batches != (steps // valid) * len(solver.dv_set):
        raise AssertionError("{}: {} validation batches".format(
            name, solver.n_valid_batches))
    for i, st in enumerate(solver.step_stats):
        if not all(math.isfinite(v) for v in st.values()):
            raise AssertionError("{} step {}: {}".format(name, i + 1, st))
    if solver.compute_dtype != torch.bfloat16:
        raise AssertionError(name + ": compute dtype is not bf16")
    leaves = convert.tree_leaves(solver.params)
    state = (convert.tree_leaves(solver.opt_state["mu"])
             + convert.tree_leaves(solver.opt_state["nu"])
             + [solver.opt_state["count"]])
    if not all(x.is_cuda for x in leaves + state):
        raise AssertionError(name + ": a parameter or a piece of the Adam "
                             "state is not on cuda")
    init = convert.tree_leaves(LM.lm_init(
        torch.Generator().manual_seed(seed), solver.lm_spec, dev))
    moved = sum(not torch.equal(a, b) for a, b in zip(init, leaves))
    if moved != len(leaves) or int(solver.opt_state["count"]) != steps:
        raise AssertionError("{}: {} of {} parameter leaves moved, {} "
                             "updates".format(name, moved, len(leaves),
                                              int(solver.opt_state["count"])))
    ckpt = os.path.join(tmp, "ckpt", name, "last_ppx.pth")
    if not os.path.exists(ckpt):
        raise AssertionError(name + ": last_ppx.pth was not written")
    secs = solver.step_seconds[1:]
    res = {"steps": steps, "valid_batches": solver.n_valid_batches,
           "first_step_s": solver.step_seconds[0],
           "median_step_s": statistics.median(secs),
           "step_s": [round(x, 4) for x in solver.step_seconds],
           "step_tokens": solver.step_tokens,
           "tokens_per_s": sum(solver.step_tokens[1:]) / sum(secs),
           "peak_mem_gb": peak / 2 ** 30, "wall_s": wall,
           "losses": [round(st["loss"], 4) for st in solver.step_stats],
           "gnorms": [round(st["gnorm"], 4) for st in solver.step_stats],
           "dev_ppx": solver.best_ppx, "launches": counts,
           "moved_leaves": moved}
    return solver, counts, res, ckpt


def _lm_breakdown(solver, dev, n_steps=2):
    """Where a training step's time goes: ``n_steps`` more steps of the
    solver's own ``train_step`` under torch.profiler (after the counts were
    read). Returns the device-busy share of the window and the kernels with
    the most device time, as (name, ms per step, launches per step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from e2e_asr_pytorch_tpu_torch.train.train_lm import train_step
    batches = []
    for data, _ in zip(iter(solver.tr_set), range(n_steps)):
        batches.append(torch.from_numpy(data["txt"]).to(dev).long())
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for txt in batches:
            train_step(solver.step_cfg, solver.params, solver.opt_state, txt,
                       solver.gen)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        raise AssertionError("lm: the profiler saw no device time")
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    rows = [(e.key[:70], e.self_device_time_total / 1e3 / n_steps,
             e.count / n_steps) for e in top]
    return {"steps": n_steps, "wall_s_per_step": wall / n_steps,
            "device_ms_per_step": total_us / 1e3 / n_steps,
            "busy_share": total_us / 1e6 / wall, "top": rows}


def phase_lm(seed, dev):
    """LM training through the port's CLI at the flagship LM's full width
    (K6f, K6b), its checkpoint's lm_apply against lm_step, then a few steps
    of the 4x LSTM-1024 LM (K5f, K5b)."""
    import torch
    from e2e_asr_pytorch_tpu_torch.convert import cast_matmul_weights
    from e2e_asr_pytorch_tpu_torch.models import lm as LM
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as KL
    from e2e_asr_pytorch_tpu_torch.train.checkpoint import load_checkpoint
    from e2e_asr_pytorch_tpu_torch.train.train_lm import shift_inputs

    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        solver, counts, res, ckpt_path = _run_lm(
            tmp, seed, dev, "librispeech_lm_best.yaml", "lm_best", LM_STEPS,
            LM_VALID, "lstm_fwd_chunked", "lstm_bwd_chunked")
        results["lm_best"] = res
        spec = solver.lm_spec
        _say("lm", "{} steps at batch 128 of the flagship LM (tied {}, {}x "
             "LSTM-{}, dropout {}, Adam): losses {}, grad norms {}; first "
             "step {:.3f} s, median step after it {:.4f} s -> {:.0f} "
             "tokens/s; peak allocated {:.2f} GiB; dev ppx {:.2f}; launches "
             "{} (= expected); {} leaves moved; last_ppx.pth written".format(
                 res["steps"], spec.emb_dim, spec.n_layers, spec.dim,
                 spec.dropout, res["losses"], res["gnorms"],
                 res["first_step_s"], res["median_step_s"],
                 res["tokens_per_s"], res["peak_mem_gb"], res["dev_ppx"],
                 {k: v for k, v in counts.items() if v}, res["moved_leaves"]))

        # the checkpoint as the decode path loads it: lm_apply through K6f
        # against lm_step token by token (plain ops) on one dev batch
        ckpt = load_checkpoint(ckpt_path, dev)
        if (ckpt["global_step"] != LM_STEPS
                or sorted(ckpt["optimizer"]) != ["count", "mu", "nu"]):
            raise AssertionError("lm: checkpoint at step {} with state {}"
                                 .format(ckpt["global_step"],
                                         sorted(ckpt["optimizer"])))
        txt = torch.from_numpy(next(iter(solver.dv_set))["txt"]).to(dev).long()
        inp, _ = shift_inputs(txt)
        before = KL.FWD_CHUNKED_LAUNCHES
        with torch.no_grad():
            by_kernel, _ = LM.lm_apply(ckpt["model"], spec, inp,
                                       compute_dtype=solver.compute_dtype)
            if KL.FWD_CHUNKED_LAUNCHES != before + spec.n_layers:
                raise AssertionError("lm: lm_apply did not go through K6f")
            params = cast_matmul_weights(ckpt["model"], solver.compute_dtype)
            hidden = LM.lm_zero_state(spec, inp.shape[0], dev)
            by_step = []
            for i in range(inp.shape[1]):
                logit, hidden = LM.lm_step(params, spec, inp[:, i], hidden,
                                           compute_dtype=solver.compute_dtype)
                by_step.append(logit)
            by_step = torch.stack(by_step, dim=1)
        err = (by_kernel - by_step).abs()
        mag = by_step.abs().max().item()
        if (not bool(torch.isfinite(by_kernel).all())
                or tuple(by_kernel.shape) != (*inp.shape, spec.vocab_size)
                or err.max().item() > LM_LOGIT_MAX_REL * mag
                or err.mean().item() > LM_LOGIT_MEAN_REL * mag):
            raise AssertionError(
                "lm: lm_apply and lm_step disagree: max|err| {:.3e}, mean "
                "{:.3e} at max|logit| {:.3e}".format(
                    err.max().item(), err.mean().item(), mag))
        results["lm_best"]["logit_err"] = [err.max().item(),
                                           err.mean().item(), mag]
        _say("lm", "checkpoint of step {}: lm_apply (K6f, {} x {} tokens) "
             "against lm_step token by token: max|err| {:.3e} (tol {:.3e}), "
             "mean|err| {:.3e} (tol {:.3e}) at max|logit| {:.3f}".format(
                 LM_STEPS, *inp.shape, err.max().item(),
                 LM_LOGIT_MAX_REL * mag, err.mean().item(),
                 LM_LOGIT_MEAN_REL * mag, mag))
        prof = _lm_breakdown(solver, dev)
        results["lm_best"]["breakdown"] = prof
        _say("lm", "2 more steps under torch.profiler: {:.4f} s per step, "
             "device time {:.1f} ms per step (busy share {:.2f}); most device "
             "time per step: {}".format(
                 prof["wall_s_per_step"], prof["device_ms_per_step"],
                 prof["busy_share"], "; ".join(
                     "{} {:.2f} ms x{:.0f}".format(*row)
                     for row in prof["top"])))
        del ckpt, params, solver

        solver, counts5, res5, _ = _run_lm(
            tmp, seed, dev, "librispeech_lm.yaml", "lm", LM_K5_STEPS,
            LM_K5_STEPS, "lstm_fwd", "lstm_bwd")
        results["lm"] = res5
        _say("lm", "{} steps of the 4x LSTM-{} LM: losses {}; median step "
             "after the first {:.4f} s -> {:.0f} tokens/s; peak allocated "
             "{:.2f} GiB; launches {} (= expected)".format(
                 res5["steps"], solver.lm_spec.dim, res5["losses"],
                 res5["median_step_s"], res5["tokens_per_s"],
                 res5["peak_mem_gb"], {k: v for k, v in counts5.items() if v}))
    _say("lm", json.dumps(results))
    return {k: counts[k] + counts5[k] for k in counts}, results


def phase_agree(dev):
    """A small model decoded on the card (kernel, f32) and on the CPU
    (plain version, f32): same tokens, scores within 1e-3."""
    import torch
    from e2e_asr_pytorch_tpu_torch.convert import tree_to
    from e2e_asr_pytorch_tpu_torch.decode.beam import BeamConfig, beam_decode
    from e2e_asr_pytorch_tpu_torch.models import asr as M
    from e2e_asr_pytorch_tpu_torch.models import lm as LM
    from e2e_asr_pytorch_tpu_torch.ops.audio import (FeatureConfig,
                                                     extract_features)
    model = dict(
        ctc_weight=0.5,
        encoder=dict(vgg=5, dim=[64, 64], dropout=[0.0, 0.0],
                     layer_norm=[False, False], proj=[True, True],
                     sample_rate=[1, 1], sample_style="drop"),
        attention=dict(mode="loc", dim=32, num_head=1, v_proj=False,
                       temperature=0.5, loc_kernel_size=20,
                       loc_kernel_num=5),
        decoder=dict(module="LSTM", dim=64, layer=2, dropout=0.0))
    gen = torch.Generator().manual_seed(1)
    spec = M.build_spec(120, 31, **model)
    params = M.asr_init(gen, spec)
    lm_spec = LM.build_spec(31, True, 64, "LSTM", 64, 2, 0.0)
    lm_params = LM.lm_init(gen, lm_spec)
    fcfg = FeatureConfig(feat_dim=40, delta_order=2)
    wav = 0.3 * torch.randn(4, 32000, generator=gen)
    wav_len = torch.tensor([32000, 30000, 21000, 16000])
    cfg = BeamConfig(beam_size=4, min_len_ratio=0.01, max_len_ratio=0.1,
                     lm_weight=0.3, max_steps=20)
    outs = {}
    for where in ("cpu", dev):
        feat, feat_len = extract_features(fcfg, wav.to(where),
                                          wav_len.to(where))
        out = beam_decode(tree_to(params, where), spec, cfg, feat, feat_len,
                          tree_to(lm_params, where), lm_spec)
        outs[str(where)] = {k: v.cpu() for k, v in out.items()}
    a, b = outs["cpu"], outs[str(dev)]
    score_err = (a["avg_scores"] - b["avg_scores"]).abs().max().item()
    if not torch.equal(a["tokens"], b["tokens"]) or score_err > 1e-3:
        raise AssertionError("card and CPU decodes differ: score err "
                             "{:.3e}".format(score_err))
    _say("agree", "beam-4 + LM on a 2x BLSTM-64 model: card (kernel) and "
         "CPU (plain) tokens equal, max|score err| {:.3e}".format(score_err))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    from e2e_asr_pytorch_tpu_torch.ops.kernels import build

    smi = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    _say("device", "nvidia-smi: {} | torch: {} (torch {}, CUDA {}), {} "
         "card(s)".format(smi, name, torch.__version__, torch.version.cuda,
                          torch.cuda.device_count()))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from concurrent.futures import ThreadPoolExecutor
    from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as KL
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(5) as pool:
        list(pool.map(lambda f: f(), (K._library, K._bwd_library, Q._library,
                                      KL._fwd_library, KL._bwd_library)))
    _say("build", "{} built for sm_90a in {:.2f} s".format(
        ", ".join(build.library_path(n).name for n in (
            "bilstm_fwd", "bilstm_bwd", "int8_table", "lstm_fwd",
            "lstm_bwd")),
        time.perf_counter() - t0))

    k1_err, k1_ms, k1_plain = phase_kernel(dev)
    k2_err, k2_ms, k2_plain = phase_bwd(dev)
    q8 = phase_int8(dev)
    k56 = phase_lstm(dev)
    # the yardsticks of K1-K4 at their main path's shapes: the bound from the
    # shapes, and for K1/K2 the cuDNN BLSTM of the same T, B, H fed the
    # encoder's 2H-wide input (K3/K4 have no single PyTorch call)
    t, b, h, _ = MAIN_SHAPE
    bi_f, bi_fb, bi_xg = _library_lstm(dev, t, b, 2 * h, h, True)
    bi_bound = _lstm_bound(t, b, h, 2, 2)
    _say("kernel", "K1 / K2 at T={} B={} H={}: bound {:.3f} ms ({}); library "
         "call torch.nn.LSTM (cuDNN, bf16, bidirectional, input projection "
         "included) forward {:.3f} ms, forward + backward {:.3f} ms; the two "
         "xg matmuls alone {:.3f} ms".format(t, b, h, *bi_bound, bi_f, bi_fb,
                                             bi_xg))
    qb, qt, qd = INT8_SHAPES[0]
    q_bound = {"context_int8": _bound(2.0 * qb * qt * qd,
                                      qb * qt * qd + 4 * qb * (qt + qd)),
               "dattn_int8": _bound(2.0 * qb * qt * qd,
                                    qb * qt * qd + 4 * qb * (qt + qd))}
    decode_launches, _ = phase_slice(args.seed)
    train_counts, _ = phase_train(args.seed, dev)
    lm_counts, _ = phase_lm(args.seed, dev)
    phase_agree(dev)

    src = "e2e_asr_pytorch_tpu_torch/csrc/"
    tpu = "e2e_asr_pytorch_tpu/ops/pallas/"
    kernels = [
        dict(name="bilstm_fwd", source=src + "bilstm_fwd.cu",
             replaces=tpu + "lstm.py:458",
             launches=decode_launches + train_counts["bilstm_fwd"],
             max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain,
             bound_ms=bi_bound[0], bound_by=bi_bound[1], library_ms=bi_f,
             library_xg_ms=bi_xg),
        dict(name="bilstm_bwd", source=src + "bilstm_bwd.cu",
             replaces=tpu + "lstm.py:536",
             launches=train_counts["bilstm_bwd"], max_abs_err=k2_err,
             ms=k2_ms, plain_ms=k2_plain, bound_ms=bi_bound[0],
             bound_by=bi_bound[1], library_ms=bi_fb, library_xg_ms=bi_xg),
        dict(name="context_int8", source=src + "int8_table.cu",
             replaces=tpu + "int8_table.py:105",
             launches=train_counts["context_int8"],
             max_abs_err=q8["context_int8"][0], ms=q8["context_int8"][1],
             plain_ms=q8["context_int8"][2],
             bound_ms=q_bound["context_int8"][0],
             bound_by=q_bound["context_int8"][1], library_ms=None),
        dict(name="dattn_int8", source=src + "int8_table.cu",
             replaces=tpu + "int8_table.py:115",
             launches=train_counts["dattn_int8"],
             max_abs_err=q8["dattn_int8"][0], ms=q8["dattn_int8"][1],
             plain_ms=q8["dattn_int8"][2], bound_ms=q_bound["dattn_int8"][0],
             bound_by=q_bound["dattn_int8"][1], library_ms=None)]
    for kname, source, line in (("lstm_fwd", "lstm_fwd.cu", 76),
                               ("lstm_bwd", "lstm_bwd.cu", 106),
                               ("lstm_fwd_chunked", "lstm_fwd.cu", 278),
                               ("lstm_bwd_chunked", "lstm_bwd.cu", 347)):
        kernels.append(dict(name=kname, source=src + source,
                            replaces="{}lstm.py:{}".format(tpu, line),
                            launches=lm_counts[kname], **k56[kname]))
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError("{} was never launched by the main paths"
                                 .format(k["name"]))
    print(json.dumps({"kernels": [dict(k, route="cuda") for k in kernels]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
