"""The port's profiler spans and step timing, on the CPU at debug widths.

The LM step opens ``place`` (the batch's copy, ``train_lm._to_device``),
``forward``, ``backward`` and ``optimizer`` once a step, in that order and
without overlap, and computes bit for bit what it computes without the
profiler; the ASR step keeps its spans, ``place`` among them. ``--profile``
traces a few steps under ``--lm`` as under the ASR solver (one
implementation, ``train/solver.py``), and the progress line's ``sec/step``
is one step's seconds.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.models import lm as TLM
from e2e_asr_pytorch_tpu_torch.train import optim as TO
from e2e_asr_pytorch_tpu_torch.train import solver as TS
from e2e_asr_pytorch_tpu_torch.train import train_lm as TT
from e2e_asr_pytorch_tpu_torch.utils import timer as TTimer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_SPANS = ["place", "forward", "backward", "optimizer"]
ASR_SPANS = ["place", "features", "forward", "backward", "optimizer"]
VOCAB, ROWS, LEN, STEPS = 31, 4, 12, 2


def _lm_setup():
    spec = TLM.build_spec(VOCAB, emb_tying=True, emb_dim=16, module="LSTM",
                          dim=16, n_layers=2, dropout=0.2)
    params = TLM.lm_init(torch.Generator().manual_seed(0), spec)
    opt = TO.build_optimizer(optimizer="Adam", lr=1e-3, grad_clip=5.0)
    cfg = TT.StepConfig(spec, opt)
    rng = np.random.default_rng(0)
    batches = [{"txt": rng.integers(1, VOCAB, (ROWS, LEN)).astype(np.int32)}
               for _ in range(STEPS)]
    return cfg, params, opt.init(params), batches


def _lm_steps(profiled: bool):
    """``STEPS`` LM steps from one seeded state: (losses, grad norms,
    params, opt_state, the spans (name, start, end) in start order)."""
    cfg, params, opt_state, batches = _lm_setup()
    gen = torch.Generator()
    prof = profile(activities=[ProfilerActivity.CPU]) if profiled else None
    if prof is not None:
        prof.__enter__()
    losses, norms = [], []
    for k, data in enumerate(batches):
        gen.manual_seed(100 + k)
        txt = TT._to_device(data, torch.device("cpu"))
        params, opt_state, loss, gnorm = TT.train_step(cfg, params,
                                                       opt_state, txt, gen)
        losses.append(loss)
        norms.append(gnorm)
    spans = []
    if prof is not None:
        prof.__exit__(None, None, None)
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.name in LM_SPANS + ["reduce"])
    return losses, norms, params, opt_state, [(n, s, e)
                                              for s, e, n in spans]


def test_lm_step_opens_its_four_spans_once_each_in_order():
    *_, spans = _lm_steps(profiled=True)
    assert [n for n, _, _ in spans] == LM_SPANS * STEPS
    ends = [(s, e) for _, s, e in spans]
    assert all(s < e for s, e in ends)
    # one after the other, none inside another
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(ends, ends[1:]))


def test_lm_step_computes_the_same_bits_with_the_profiler_on():
    off = _lm_steps(profiled=False)
    on = _lm_steps(profiled=True)
    for a, b in zip(off[0] + off[1], on[0] + on[1]):
        assert torch.equal(a, b)
    for tree in (2, 3):
        left = convert.tree_leaves(off[tree])
        right = convert.tree_leaves(on[tree])
        assert len(left) == len(right) > 0
        assert all(torch.equal(a, b) for a, b in zip(left, right))
    # the steps did train: the state moved from its initial value
    _, params0, _, _ = _lm_setup()
    assert not all(torch.equal(a, b) for a, b in zip(
        convert.tree_leaves(params0), convert.tree_leaves(off[2])))


def _trace_names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events
            if e.get("cat") == "user_annotation"]


def _lm_config(tmp_path, steps):
    with open(os.path.join(ROOT, "config", "synthetic_lm.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["text"]["vocab_file"] = os.path.join(
        ROOT, cfg["data"]["text"]["vocab_file"])
    cfg["hparas"].update(max_step=steps, valid_step=steps)
    cfg["model"].update(emb_dim=16, dim=16)
    path = str(tmp_path / "lm.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _asr_config(tmp_path, steps):
    with open(os.path.join(ROOT, "config", "synthetic_debug.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["text"]["vocab_file"] = os.path.join(
        ROOT, cfg["data"]["text"]["vocab_file"])
    cfg["data"]["corpus"].update(batch_size=2, n_utts=8, max_tokens=6)
    cfg["hparas"].update(max_step=steps, valid_step=steps)
    m = cfg["model"]
    m["encoder"].update(dim=[16])
    m["attention"].update(dim=8, loc_kernel_size=5, loc_kernel_num=3)
    m["decoder"].update(dim=16)
    path = str(tmp_path / "asr.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _run(tmp_path, path, extra):
    from e2e_asr_pytorch_tpu_torch.main import main
    return main(extra + ["--cpu", "--config", path, "--name", "traced",
                         "--njobs", "0", "--logdir", str(tmp_path / "log"),
                         "--ckpdir", str(tmp_path / "ckpt"), "--no-msg",
                         "--profile"])


def test_profile_under_lm_traces_the_window_with_the_four_spans(
        tmp_path, monkeypatch):
    monkeypatch.setattr(TS, "PROFILE_STEPS", (1, 2))
    solver = _run(tmp_path, _lm_config(tmp_path, steps=4), ["--lm"])
    assert solver.step == 4
    logdir = tmp_path / "log" / "traced"
    assert (logdir / "profile.txt").stat().st_size > 0
    names = _trace_names(logdir / "trace.json")
    # steps 1 and 2 only: two of each span
    assert sorted(names) == sorted(LM_SPANS * 2)


def test_profile_under_asr_keeps_its_spans_and_adds_place(tmp_path,
                                                         monkeypatch):
    # step 1 alone: the solver validates after steps 1 and 3
    monkeypatch.setattr(TS, "PROFILE_STEPS", (1, 1))
    solver = _run(tmp_path, _asr_config(tmp_path, steps=3), [])
    assert solver.step == 3
    names = _trace_names(tmp_path / "log" / "traced" / "trace.json")
    assert sorted(names) == sorted(ASR_SPANS)


def test_progress_line_reads_one_steps_seconds(monkeypatch):
    """Three steps as the solvers stamp them (``rd``, then ``fw`` once the
    step has synchronised, then the logs outside the count), each 0.25 s
    of batch read and 0.5 s of step: 0.75 sec/step."""
    now = [1000.0]
    monkeypatch.setattr(TTimer.time, "time", lambda: now[0])
    t = TTimer.Timer()
    t.set()
    for _ in range(3):
        now[0] += 0.25
        t.cnt("rd")
        now[0] += 0.5
        t.cnt("fw")
        now[0] += 7.0       # logging and validation: not a step's time
        t.set()
    assert t.show() == "0.750 sec/step (rd 33.3% | fw 66.7% | bw 0.0%)"
    # show() starts the next count
    now[0] += 0.1
    t.cnt("rd")
    now[0] += 0.3
    t.cnt("fw")
    assert t.show().startswith("0.400 sec/step")


@pytest.mark.parametrize("lm", [True, False], ids=["lm", "asr"])
def test_solvers_count_a_timer_step_per_train_step(tmp_path, monkeypatch,
                                                   lm):
    """The solvers' own stamps: after three steps the timer counts three."""
    seen = []
    real = TTimer.Timer.show

    def spy(self):
        seen.append(self.click)
        return real(self)
    monkeypatch.setattr(TTimer.Timer, "show", spy)
    monkeypatch.setitem(TS.DEFAULT_HPARAS, "PROGRESS_STEP", 3)
    path = (_lm_config(tmp_path, steps=3) if lm
            else _asr_config(tmp_path, steps=3))
    from e2e_asr_pytorch_tpu_torch.main import main
    main((["--lm"] if lm else []) + [
        "--cpu", "--config", path, "--name", "timed", "--njobs", "0",
        "--logdir", str(tmp_path / "log"), "--ckpdir",
        str(tmp_path / "ckpt"), "--no-msg"])
    # the progress line of step 1, then of step 3 over steps 2 and 3
    assert seen == [1, 2]
