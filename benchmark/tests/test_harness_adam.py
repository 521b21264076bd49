"""The reader of ``adam_roofline``: None on a trace without the Adam
kernel's rows, and the bytes of the window's updates over the card's
bandwidth against the rows' device time with one planted, at the 4x
LSTM-2048 LM's leaves (134,313,984 f32 parameters, 28 bytes each at f32
state, 20 at bf16)."""

from types import SimpleNamespace

import pytest
import torch

from harness import manifest, trace

LM_BEST = [(31, 2048)] + [(2048, 8192), (2048, 8192), (8192,)] * 4
ROW = "adam_multi_tensor_kernel<float, float>"


def _ctx(state_dtype=torch.float32, kernels=None, steps=10, family="lm"):
    params = {"l{}".format(i): torch.empty(s, device="meta")
              for i, s in enumerate(LM_BEST)}
    mu = {k: torch.empty(v.shape, dtype=state_dtype, device="meta")
          for k, v in params.items()}
    solver = SimpleNamespace(params=params, opt_state={"count": None,
                                                       "mu": mu, "nu": mu})
    kernels = {"lstm_fwd_chunked_kernel<__nv_bfloat16, 16>": (0.5, 40)} \
        if kernels is None else kernels
    s = trace.Summary(1.0, 0.9, kernels, 0, {}, [])
    return SimpleNamespace(family=family, steps=steps, summary=s,
                           prog=SimpleNamespace(solver=solver))


def _read(ctx):
    return manifest.metric_reader("adam_roofline").read(ctx)


def test_declared_for_both_lm_cells():
    declared = {m["name"]: m for m in manifest.manifest()["per_layer"]}
    m = declared["adam_roofline"]
    assert (m["source"], m["unit"], m["better"], m["layer"], m["moves"]) == (
        "device_trace", "%", "higher", "optimizer", "lm_tokens_per_s")
    assert m["workloads"] == ["lm_best.train", "lm_best.short"]


def test_none_without_the_kernels_rows():
    assert _read(_ctx()) is None
    assert _read(_ctx(kernels={})) is None


@pytest.mark.parametrize("state_dtype,per", [(torch.float32, 28),
                                              (torch.bfloat16, 20)],
                         ids=["f32", "bf16"])
def test_percentage_with_a_planted_row(state_dtype, per):
    n = 134_313_984
    # 10 steps whose launches took 1.4 ms each on the card
    ctx = _ctx(state_dtype, kernels={ROW: (0.014, 10), "other": (2.0, 5)})
    want = 100.0 * 10 * n * per / 3.35e12 / 0.014
    assert _read(ctx) == pytest.approx(want, rel=1e-12)
    if per == 28:
        assert _read(ctx) == pytest.approx(80.19, abs=0.01)


def test_none_without_adam_moments_or_steps():
    ctx = _ctx(kernels={ROW: (0.014, 10)})
    ctx.prog.solver.opt_state = {"count": None, "e_g": {}, "e_x": {}}
    assert _read(ctx) is None
    assert _read(_ctx(kernels={ROW: (0.014, 10)}, steps=0)) is None
