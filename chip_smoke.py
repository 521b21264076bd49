#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (each prints its lines; any failure raises and exits non-zero, and
no result line is printed):

1. device  -- the card's name and power limit (nvidia-smi) and
              torch.cuda.get_device_name(); refuses to run without CUDA.
2. build   -- compiles the BLSTM kernel (csrc/bilstm_fwd.cu) for sm_90a.
3. kernel  -- the kernel against its plain PyTorch version on the card, at
              the decode path's shapes (T=400/200 from the 16 s / 8 s
              batch buckets, B=8, H=1280), at T=320 and at a ragged
              T=37/B=3/H=200, with f32 and bf16 streams and the stashes on;
              max abs errors against stated tolerances, CUDA-event times.
              At T=320/B=8/H=1280 the same checks are shown to fail against
              a plain version with a planted fault (doubled w_h; f32 h in
              place of bf16(h)).
4. slice   -- the port's own CLI (``main --test``) at the flagship's full
              width (VGG-LN + 5x BLSTM-1280, loc attention, 2x LSTM-1024
              decoder; 4x LSTM-2048 tied LM) with seeded weights written as
              port checkpoints, over the synthetic tone corpus (16 utts per
              split, 20-80 tokens = 3.2-12.8 s, batch 8): beam 8 + LM 0.3,
              then greedy. Checks the CSVs, the vocabulary, that every
              parameter is on the card, and that the kernel launched exactly
              5 times per encoded batch (counts reset just before the run).
5. agree   -- a small model beam-decoded on the card (kernel, f32) and on
              the CPU (plain version, f32) gives the same tokens.

The line before the last is the card as nvidia-smi names it; the last line
is {"ok": true, "device": {...}}.
"""

import argparse
import json
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
SHAPES = [(400, 8, 1280, "bfloat16"), (200, 8, 1280, "bfloat16"),
          (320, 8, 1280, "float32"), (320, 8, 1280, "bfloat16"),
          (37, 3, 200, "float32"), (37, 3, 200, "bfloat16")]
MAIN_SHAPE = SHAPES[0]


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

    t0 = time.perf_counter()
    K._library()
    _say("build", "{} built for sm_90a in {:.2f} s".format(
        build.library_path("bilstm_fwd").name, time.perf_counter() - t0))

    worst, ms, plain_ms = phase_kernel(dev)
    launches, results = phase_slice(args.seed)
    phase_agree(dev)

    print(json.dumps({"kernels": [{
        "name": "bilstm_fwd", "route": "cuda",
        "source": "e2e_asr_pytorch_tpu_torch/csrc/bilstm_fwd.cu",
        "replaces": "e2e_asr_pytorch_tpu/ops/pallas/lstm.py:458",
        "launches": launches, "max_abs_err": worst, "ms": ms,
        "plain_ms": plain_ms}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
