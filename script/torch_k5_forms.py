#!/usr/bin/env python3
"""Each form of the single-direction LSTM forward K5f, and the backward
K5b, beside the geometries they were chosen over, on the card.

    python3 script/torch_k5_forms.py

At the single-direction listener's shapes (T=400 B=16 and T=200 B=8 at
H=1280) and the 4x LSTM-1024 LM's (T=160 B=128 H=1024), bf16 streams, the
forward with stashes and the backward from them, prints the median of 20
launches (CUDA events) of each as built and of:

  K5f narrow  20 units a block (K1's tile, launched over one direction
              through the same entry point), and 10 units with a 6-stage
              cp.async ring in place of 3;
  K5f wide    K6f's 16-unit tiles;
  K5b         K6b's 32-unit tiles.

Each variant is first held against the plain version (ys max |err| 1.6e-2,
dxg 2^-6 of its range, early means 3e-6, as chip_smoke.py). Each form of
K5f is launched whatever the rule would pick. The deeper ring and the
32-unit backward tiles with a bf16 dxg are not built in the package: they
come from patched copies of its sources, built beside its libraries in the
build directory git ignores. The production sources are not touched.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "e2e_asr_pytorch_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "e2e_asr_pytorch_tpu_torch", "ops", "kernels",
                   "_build", "k5_forms")
SHAPES = [(400, 16, 1280), (200, 8, 1280), (160, 128, 1024)]
RING = ("constexpr int kResRing = 3;", "constexpr int kResRing = {};")
BF16_32 = ("  if (dxg_bf16 && units == 16) LSTM_BWD_CASE(bf16, 16);",
           "  if (dxg_bf16 && units == 16) LSTM_BWD_CASE(bf16, 16);\n"
           "  if (dxg_bf16 && units == 32) LSTM_BWD_CASE(bf16, 32);")


def _build(name, source, patch):
    """A copy of csrc/<source> with one text replaced, built and loaded."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import build
    src = open(os.path.join(CSRC, source)).read()
    if src.count(patch[0]) != 1:
        raise RuntimeError("{} no longer has the text to patch for '{}'"
                           .format(source, name))
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, name + ".cu")
    with open(path, "w") as f:
        f.write(src.replace(*patch))
    lib = os.path.join(OUT, "lib{}.so".format(name))
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", CSRC, "-o",
                          lib, path], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-3000:])
    return ctypes.CDLL(lib)


def _median_ms(fn):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def main():
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as KB
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as K
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    jobs = {"fwd_ring6": ("bilstm_fwd.cu", (RING[0], RING[1].format(6))),
            "bwd_wide32": ("lstm_bwd.cu", BF16_32)}
    with ThreadPoolExecutor(len(jobs) + 3) as pool:
        own = [pool.submit(f) for f in (KB._library, K._fwd_library,
                                         K._bwd_library)]
        libs = dict(zip(jobs, pool.map(lambda kv: _build(kv[0], *kv[1]),
                                       jobs.items())))
        [f.result() for f in own]
    # the patched libraries take the package's argument types
    for name, own in (("fwd_ring6", KB._library()),
                      ("bwd_wide32", K._bwd_library())):
        for fn in ("bilstm_fwd_resident", "lstm_bwd_chunked",
                   "lstm_pack_chunked_bwd"):
            if hasattr(own, fn):
                getattr(libs[name], fn).argtypes = getattr(own, fn).argtypes
                getattr(libs[name], fn).restype = ctypes.c_int

    # each variant: (kernel, label, K5f's form, module attribute patches)
    variants = [
        ("K5f", "narrow as built, 10 units", "narrow", {}),
        ("K5f", "narrow, 20 units", "narrow", {(K, "_NARROW_UNITS"): 20}),
        ("K5f", "narrow, 10 units, 6-stage ring", "narrow",
         {(KB, "_library"): lambda: libs["fwd_ring6"]}),
        ("K5f", "wide as built, 8 units", "wide", {}),
        ("K5f", "wide, 16 units (K6f's tile)", "wide",
         {(K, "_WIDE_FWD_UNITS"): 16}),
        ("K5b", "as built, 16 units", None, {}),
        ("K5b", "32 units (K6b's tile)", None,
         {(K, "_WIDE_BWD_UNITS"): 32,
          (K, "_bwd_library"): lambda: libs["bwd_wide32"]})]
    gen = torch.Generator().manual_seed(5)
    for t, b, h in SHAPES:
        xg = torch.randn(t, b, 4 * h, generator=gen).to("cuda", torch.bfloat16)
        w_h = (torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to("cuda")
        dy = torch.randn(t, b, h, generator=gen).to("cuda", torch.bfloat16)
        ref = K.lstm_recurrence_ref(xg, w_h, stash=True)
        _, cs, gs = K.lstm_fwd(xg, w_h, stash=True)
        rdxg = K.lstm_recurrence_bwd_ref(w_h, cs, gs, dy)
        rule = K.form_for(h, b, torch.device("cuda"))
        for kernel, label, form, patches in variants:
            saved = {key: getattr(*key) for key in patches}
            try:
                for (mod, attr), value in patches.items():
                    setattr(mod, attr, value)
                if kernel == "K5f":
                    fn = lambda: K._launch_fwd(xg, w_h, False, True, form)  # noqa: E731
                    out = fn()[0]
                    torch.cuda.synchronize()
                    d = (out.float() - ref[0].float()).abs()
                    ok = (d.max().item() <= 1.6e-2
                          and d[:4].mean().item() <= 3e-6)
                else:
                    fn = lambda: K.lstm_bwd(w_h, cs, gs, dy)  # noqa: E731
                    out = fn()
                    torch.cuda.synchronize()
                    d = (out.float() - rdxg.float()).abs()
                    ok = (d.max().item()
                          <= 2.0 ** -6 * rdxg.float().abs().max().item()
                          and d[-4:].mean().item() <= 3e-6)
                if not ok:
                    raise AssertionError("{} {} differs from the plain "
                                         "version at T={} B={} H={}".format(
                                             kernel, label, t, b, h))
                ms = _median_ms(fn)
            finally:
                for (mod, attr), value in saved.items():
                    setattr(mod, attr, value)
            print("T={} B={} H={} (K5f's rule takes {}): {} {}: {:.4f} ms "
                  "({:.2f} us a step)".format(t, b, h, rule, kernel, label,
                                              ms, ms * 1e3 / t), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
