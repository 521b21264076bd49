#!/usr/bin/env python3
"""Is a training step of the port bit-reproducible on the card?

    python3 script/torch_determinism.py [--paths asr,lm_best,...]
        [--repeats N] [--strict] [--tree DIR] [--out FILE]

For each path the script builds the solver through the port's CLI
(``main.build_solver`` + ``set_model``, on chip_smoke.py's configs over
the synthetic corpora), takes its first training batch and computes the
step's loss and gradients N times from the same parameters and the same
generator seed (``train_asr.loss_and_grads``, ``train_lm.loss_and_grads``,
``models/apc.py apc_loss``). For every repeat after the first it prints
the gradient leaves that differ from the first repeat's in any bit (their
count, the largest |diff| and that leaf's largest |gradient|), whether
the loss kept its bits, and the same for the gradients that reach named
intermediate tensors: each VGG convolution's output, the frontend's, each
encoder layer's, the CTC log-probs and the attention logits (ASR); the
embedding lookup, the recurrent stack's output and the logits (LM). The
first tensor, walking back from the loss, whose gradient differs names
the op that drifts.

Paths: ``asr`` (config/librispeech_asr_best.yaml, batch 16), ``generic``
(the same with ``tf_end: 0.8``: the generic decoder scan with scheduled
sampling at rate 0.9), ``plugin`` (the same with chip_smoke.py's emb
plugin block), ``lm_best`` (config/librispeech_lm_best.yaml, batch 128),
``lm`` (config/librispeech_lm.yaml's 4x LSTM-1024) and ``apc`` (one step
of APC's pretraining, 3x LSTM-512 over 8 crops of 2 s); ``mesh`` holds
the flagship step on a one-rank NCCL mesh against the plain path stage by
stage (``run_mesh``). ``--paths time`` (not in the default list) times
what the repair touched instead (``time_ops``): the VGG frontend with
cuDNN's deterministic setting off and on, the CTC loss with the ordered
read and with a plain gather, the location band, and the flagship step
under each pairing of the two.

``--strict`` calls ``torch.use_deterministic_algorithms(True)`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before torch is imported) first:
an op with no deterministic form then raises, and the error names it.
``--cudnn`` sets ``torch.backends.cudnn.deterministic`` first.
``--tree DIR`` imports the package and chip_smoke.py of another checkout
(an unpacked parent commit), so one chip call reads both. ``--out`` writes
the readings as JSON. The card's name and power limit come first.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("asr", "generic", "plugin", "lm_best", "lm", "apc", "mesh")


class Taps:
    """Gradient hooks on the outputs of wrapped functions: each call's
    floating outputs that require grad get a hook that keeps a copy of the
    gradient reaching them, under '<label>#<call>'."""

    def __init__(self):
        self.grads = {}
        self.calls = {}
        self.undo = []

    def wrap(self, module, name, label=None):
        import torch
        fn = getattr(module, name)
        label = label or name

        def tapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            i = self.calls.get(label, 0)
            self.calls[label] = i + 1
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for j, o in enumerate(outs):
                if (isinstance(o, torch.Tensor) and o.requires_grad
                        and o.is_floating_point()):
                    key = "{}#{}.{}".format(label, i, j)

                    def keep(g, key=key):
                        self.grads[key] = g.detach().clone()
                    o.register_hook(keep)
            return out
        setattr(module, name, tapped)
        self.undo.append((module, name, fn))

    def reset(self):
        self.grads, self.calls = {}, {}

    def restore(self):
        for module, name, fn in reversed(self.undo):
            setattr(module, name, fn)
        self.undo = []


def _diff(a, b):
    """(bitwise equal, max |a - b|, max |a|)."""
    import torch
    if torch.equal(a, b):
        return True, 0.0, float(a.float().abs().max()) if a.numel() else 0.0
    return (False, float((a.float() - b.float()).abs().max()),
            float(a.float().abs().max()))


def _compare(first, again):
    """{name: [max |diff|, max |value|]} of the entries that differ."""
    out = {}
    for k, a in first.items():
        same, d, scale = _diff(a, again[k])
        if not same:
            out[k] = [d, scale]
    return out


def _asr_solver(tmp, seed, extra=None, hparas=None, argv=(), utts=32):
    import chip_smoke
    from e2e_asr_pytorch_tpu_torch.main import build_solver
    train_cfg, _, name = chip_smoke._write_train_configs(
        tmp, steps=1, utts=utts, extra=extra, hparas=hparas)
    solver = build_solver([
        "--config", train_cfg, "--name", name, "--njobs", "0", "--seed",
        str(seed), "--logdir", os.path.join(tmp, "log"), "--ckpdir",
        os.path.join(tmp, "ckpt"), "--no-msg", *argv])
    solver.set_model()
    return solver


def _lm_solver(tmp, seed, source):
    import chip_smoke
    from e2e_asr_pytorch_tpu_torch.main import build_solver
    cfg, _ = chip_smoke._write_lm_config(tmp, source, 1, 1)
    solver = build_solver([
        "--lm", "--config", cfg, "--name", "lm", "--njobs", "0", "--seed",
        str(seed), "--logdir", os.path.join(tmp, "log"), "--ckpdir",
        os.path.join(tmp, "ckpt"), "--no-msg"])
    solver.set_model()
    return solver


def _asr_taps(taps):
    from e2e_asr_pytorch_tpu_torch.models import asr as M
    from e2e_asr_pytorch_tpu_torch.models import encoder as E
    from e2e_asr_pytorch_tpu_torch.models import frontend as Fr
    taps.wrap(Fr, "_conv", "vgg_conv")
    taps.wrap(Fr, "frontend_apply", "frontend")
    taps.wrap(E, "_rnn_layer_apply", "encoder_layer")
    taps.wrap(M, "ctc_log_probs", "ctc_log_probs")
    taps.wrap(M, "asr_apply", "asr_apply")


def _lm_taps(taps):
    from e2e_asr_pytorch_tpu_torch.models import lm as LM
    from e2e_asr_pytorch_tpu_torch.ops import rnn as R
    taps.wrap(R, "dropout", "dropout")
    taps.wrap(R, "stacked_sequence", "rnn_stack")
    taps.wrap(LM, "_output_proj", "logits")


def _step_fn(path, tmp, seed, dev):
    """(a function of a generator -> (loss, {leaf: grad}), the generator,
    the function that installs the path's taps)."""
    import torch
    import chip_smoke
    from e2e_asr_pytorch_tpu_torch import convert
    from e2e_asr_pytorch_tpu_torch.train import train_asr, train_lm
    if path in ("asr", "generic", "plugin"):
        extra = hparas = None
        tf_rate = 1.0
        if path == "generic":
            hparas = {"tf_end": 0.8, "tf_step": 2}
            tf_rate = 0.9
        if path == "plugin":
            extra = {"emb": chip_smoke._plugin_emb(tmp, seed)}
        solver = _asr_solver(tmp, seed, extra, hparas)
        data = solver.put_batch(next(iter(solver.tr_set)))
        batch = train_asr.to_device(data, dev)

        def fn(gen):
            loss, _, grads = train_asr.loss_and_grads(
                solver.step_cfg, solver.params, batch, gen, tf_rate, True)
            return loss, grads
        return fn, solver.gen, _asr_taps
    if path in ("lm_best", "lm"):
        solver = _lm_solver(tmp, seed, "librispeech_{}.yaml".format(
            "lm_best" if path == "lm_best" else "lm"))
        data = next(iter(solver.tr_set))
        txt = torch.from_numpy(data["txt"]).to(dev).long()

        def fn(gen):
            return train_lm.loss_and_grads(solver.step_cfg, solver.params,
                                           txt, gen)
        return fn, solver.gen, _lm_taps
    if path == "apc":
        import numpy as np
        from e2e_asr_pytorch_tpu_torch import train_apc
        from e2e_asr_pytorch_tpu_torch.models import apc as A
        from e2e_asr_pytorch_tpu_torch.ops.audio import extract_features
        spec = A.APCSpec(input_dim=80, hidden=512, n_layers=3)
        params = A.apc_init(torch.Generator().manual_seed(seed), spec, dev)
        wav, wav_len = next(train_apc.wav_batches(
            train_apc.collect_corpus("synthetic", 64), 8, 2.0))
        feat, feat_len = extract_features(
            spec.feature_config, torch.as_tensor(np.asarray(wav)).to(dev),
            torch.as_tensor(np.asarray(wav_len)).long().to(dev))

        def fn(gen):
            leaves = convert.tree_map(
                lambda p: p.detach().requires_grad_(), params)
            with torch.enable_grad():
                loss = A.apc_loss(leaves, spec, feat, feat_len, train=True,
                                  gen=gen, compute_dtype=torch.bfloat16)
                flat = convert.tree_leaves(leaves)
                grads = iter(torch.autograd.grad(loss, flat))
            return loss.detach(), convert.tree_map(lambda _: next(grads),
                                                   params)
        return fn, torch.Generator(device=dev), lambda taps: None
    raise ValueError(path)


def run_path(path, seed, repeats, dev):
    import torch
    import chip_smoke
    taps = Taps()
    res = {"path": path}
    with tempfile.TemporaryDirectory(prefix="det_") as tmp:
        fn, gen, install = _step_fn(path, tmp, seed, dev)
        install(taps)
        try:
            first = None
            res["repeats"] = []
            for r in range(repeats):
                taps.reset()
                gen.manual_seed(seed + 1234)
                loss, grads = fn(gen)
                torch.cuda.synchronize(dev)
                leaves = chip_smoke._leaf_paths(grads)
                now = {"loss": loss.detach().clone(),
                       "leaves": {k: v.detach().clone()
                                  for k, v in leaves.items()},
                       "taps": dict(taps.grads)}
                if first is None:
                    first = now
                    res["n_leaves"] = len(leaves)
                    res["taps"] = sorted(taps.grads)
                    res["loss"] = float(loss)
                    continue
                leaf_d = _compare(first["leaves"], now["leaves"])
                tap_d = _compare(first["taps"], now["taps"])
                res["repeats"].append({
                    "loss_bitwise": bool(torch.equal(first["loss"],
                                                     now["loss"])),
                    "loss_diff": float((first["loss"].float()
                                        - now["loss"].float()).abs()),
                    "leaves_off": len(leaf_d), "leaves": leaf_d,
                    "taps_off": len(tap_d), "taps": tap_d})
        finally:
            taps.restore()
    return res


def _layout(g):
    return "{} stride {} ptr%512 {}".format(
        "contiguous" if g.is_contiguous() else "strided", tuple(g.stride()),
        g.data_ptr() % 512)


def run_mesh(seed, dev):
    """The flagship step on the plain path and on a one-rank NCCL mesh
    (``--n-devices 1``: a solver built under ``mesh.init``), stage by
    stage: the gradients of ``loss_and_grads``, the reduced gradients
    (``Mesh.reduce_grads``), each leaf's sum of squares and the global
    norm (``optim.global_norm`` / ``Mesh.grad_norm``), and the parameters
    after one ``train_step`` each from the same state."""
    import torch
    import chip_smoke
    from e2e_asr_pytorch_tpu_torch.parallel import mesh as mesh_lib
    from e2e_asr_pytorch_tpu_torch.train import optim as O
    from e2e_asr_pytorch_tpu_torch.train import train_asr
    res = {"path": "mesh"}
    with tempfile.TemporaryDirectory(prefix="det_mesh_") as tmp:
        os.makedirs(os.path.join(tmp, "p"))
        os.makedirs(os.path.join(tmp, "m"))
        plain = _asr_solver(os.path.join(tmp, "p"), seed)
        mesh = mesh_lib.init(1, 1, 0, "tcp://localhost:{}".format(
            mesh_lib.free_port()), False)
        try:
            ranked = _asr_solver(os.path.join(tmp, "m"), seed,
                                 argv=("--n-devices", "1"))
            data = plain.put_batch(next(iter(plain.tr_set)))
            batch = train_asr.to_device(data, dev)
            grads = {}
            for name, s in (("plain", plain), ("mesh", ranked)):
                s.gen.manual_seed(seed + 1234)
                loss, _, g = train_asr.loss_and_grads(
                    s.step_cfg, s.params, batch, s.gen, 1.0, True)
                grads[name] = (loss, g)
            gp = chip_smoke._leaf_paths(grads["plain"][1])
            gm = chip_smoke._leaf_paths(grads["mesh"][1])
            res["loss_bitwise"] = bool(torch.equal(grads["plain"][0],
                                                   grads["mesh"][0]))
            res["grads_off"] = _compare(gp, gm)
            reduced = mesh.reduce_grads(grads["mesh"][1], ranked.param_specs)
            gr = chip_smoke._leaf_paths(reduced)
            res["reduced_off"] = _compare(gp, gr)
            sq = {}
            for k in gp:
                a = torch.sum(torch.square(gp[k].float()))
                b = torch.sum(torch.square(gr[k].float()))
                if not torch.equal(a, b):
                    sq[k] = [float(a), float(b), _layout(gp[k]),
                             _layout(gr[k])]
            res["sumsq_off"] = sq
            norms = {"plain_global_norm": O.global_norm(grads["plain"][1]),
                     "reduced_global_norm": O.global_norm(reduced),
                     "mesh_grad_norm": mesh.grad_norm(reduced,
                                                      ranked.param_specs)}
            res["norms"] = {k: float(v) for k, v in norms.items()}
            res["norms_bitwise"] = {
                k: bool(torch.equal(v, norms["plain_global_norm"]))
                for k, v in norms.items()}
            res["plain_layouts"] = {k: _layout(g) for k, g in gp.items()
                                    if not g.is_contiguous()}
            for name, s in (("plain", plain), ("mesh", ranked)):
                s.gen.manual_seed(seed + 1234)
                train_asr.train_step(s.step_cfg, s.params, s.opt_state,
                                     batch, s.gen, 1.0, True)
            torch.cuda.synchronize(dev)
            pp = chip_smoke._leaf_paths(plain.params)
            pm = chip_smoke._leaf_paths(ranked.params)
            res["params_off_after_step"] = len(_compare(pp, pm))
            res["n_leaves"] = len(pp)
        finally:
            mesh_lib.shutdown()
    return res


def time_ops(dev, reps=3):
    """Host seconds (to a device sync) of the ops the repair touched, at
    the flagship's shapes: the VGG frontend's forward + backward over a
    sweep of frame counts (each count a new shape for cuDNN, then the same
    counts again) with cuDNN's deterministic setting off and on, the CTC
    loss's forward + backward with the ordered read (``_EmitGather``) and
    with a plain gather, and the location band's forward + backward."""
    import time
    import torch
    from e2e_asr_pytorch_tpu_torch.convert import tree_leaves, tree_map
    from e2e_asr_pytorch_tpu_torch.models import frontend as TF
    from e2e_asr_pytorch_tpu_torch.ops import attention as TA
    from e2e_asr_pytorch_tpu_torch.ops import ctc as TC
    gen = torch.Generator().manual_seed(0)
    out = {}

    def clock(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    spec = TF.make_spec(5, 120)
    params = tree_map(lambda x: x.to(dev), TF.frontend_init(gen, spec))
    frames = [1200, 1216, 1232, 1248, 1264, 1280]

    def frontend(t):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        feat = torch.randn(16, t, 120, device=dev)
        y, _ = TF.frontend_apply(leaves, spec, feat,
                                 torch.full((16,), t, device=dev),
                                 torch.bfloat16)
        torch.autograd.grad(y.float().square().sum(), tree_leaves(leaves))
    for det in (False, True, False, True):
        torch.backends.cudnn.deterministic = det
        key = "frontend_deterministic_{}".format(det)
        new = [clock(lambda: frontend(t)) for t in frames]
        again = [clock(lambda: frontend(t)) for t in frames]
        out.setdefault(key, []).append({"new_shapes_s": new,
                                        "same_shapes_s": again})
        frames = [t + 8 for t in frames]     # unseen counts next round
    b, t, v, l = 16, 400, 31, 80
    logits = torch.randn(b, t, v, device=dev)
    labels = torch.randint(1, v, (b, l), device=dev)
    lens = torch.full((b,), l, device=dev)
    in_lens = torch.full((b,), t, device=dev)
    ordered = TC._EmitGather

    class Gather:
        """The plain gather, whose backward is a scatter-add."""
        apply = staticmethod(lambda lp, ext: torch.gather(
            lp, 2, ext[:, None, :].expand(lp.shape[0], lp.shape[1],
                                          ext.shape[1])))

    def ctc():
        x = logits.clone().requires_grad_()
        loss = TC.ctc_loss(torch.log_softmax(x, -1), in_lens, labels, lens,
                           utt_w=torch.ones(b, device=dev))
        torch.autograd.grad(loss, x)
    try:
        for name, read in (("ordered", ordered), ("gather", Gather)):
            TC._EmitGather = read
            out["ctc_" + name] = [clock(ctc) for _ in range(reps + 1)]
    finally:
        TC._EmitGather = ordered
    # the flagship's training step over its first batches (phase 5's
    # bucket shapes), each pairing of the cuDNN setting and the CTC read
    from e2e_asr_pytorch_tpu_torch.train import train_asr
    with tempfile.TemporaryDirectory(prefix="det_time_") as tmp:
        solver = _asr_solver(tmp, 0, utts=96)
        batches = [train_asr.to_device(solver.put_batch(d), dev)
                   for d, _ in zip(iter(solver.tr_set), range(6))]
        try:
            for det, read in ((False, Gather), (True, Gather),
                              (False, ordered), (True, ordered),
                              (False, Gather), (True, ordered)):
                torch.backends.cudnn.deterministic = det
                TC._EmitGather = read
                key = "step_deterministic_{}_{}".format(
                    det, "ordered" if read is ordered else "gather")
                out.setdefault(key, []).append([clock(
                    lambda: train_asr.train_step(
                        solver.step_cfg, solver.params, solver.opt_state,
                        batch, solver.gen, 1.0, True)) for batch in batches])
        finally:
            TC._EmitGather = ordered
    w = torch.randn(100, 1, 10, device=dev)

    def band():
        x = w.clone().requires_grad_()
        m = TA.loc_band_matrix(x, 400)
        torch.autograd.grad(m.square().sum(), x)
    out["loc_band"] = [clock(band) for _ in range(reps + 1)]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strict", action="store_true",
                    help="torch.use_deterministic_algorithms(True) first")
    ap.add_argument("--cudnn", action="store_true",
                    help="torch.backends.cudnn.deterministic = True first")
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose package and chip_smoke.py run")
    ap.add_argument("--out", help="write the readings here as JSON")
    args = ap.parse_args(argv)
    if args.strict:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("card: {}; tree {}; strict {}; cudnn {}; torch {} CUDA {}".format(
        smi, tree, args.strict, args.cudnn, torch.__version__,
        torch.version.cuda),
        flush=True)
    if args.strict:
        torch.use_deterministic_algorithms(True)
    if args.cudnn:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", 0)
    out = {"card": smi, "tree": tree, "strict": args.strict, "paths": []}
    for path in args.paths.split(","):
        try:
            res = (run_mesh(args.seed, dev) if path == "mesh" else
                   {"path": path, **time_ops(dev)} if path == "time" else
                   run_path(path, args.seed, args.repeats, dev))
        except Exception as e:  # report and go on to the next path
            res = {"path": path, "error": "{}: {}".format(
                type(e).__name__, str(e)[:600]),
                "where": traceback.format_exc()[-1500:]}
        out["paths"].append(res)
        short = {k: v for k, v in res.items() if k not in ("taps",)}
        for rep in short.get("repeats", []):
            rep["leaves"] = dict(sorted(
                rep["leaves"].items(), key=lambda kv: -kv[1][0])[:12])
            rep["taps"] = dict(sorted(rep["taps"].items())[:40])
        print("determinism {}".format(json.dumps(short)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
