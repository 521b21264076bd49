"""The plain references agree with themselves at debug widths on the CPU:
the same readings twice, the gradient against a finite difference, the
ASR batch in blocks of rows against one block, the control's rounding.
And the port at debug widths agrees with them through a whole run."""

import pytest
import torch

from debug_cells import asr_cell, lm_cell
from families import asr as fam_asr, base, lm as fam_lm
from harness import compare, traffic, weights
from reference import asr as ref_asr, common, lm as ref_lm

CPU = torch.device("cpu")


def _lm_inputs(cell, seed=3):
    cfg = base.run_config(cell.config)
    model = cfg["model"]
    pool = traffic.batches(cell.traffic, 31, seed, 3)
    txt = [torch.from_numpy(b["txt"]).long() for b in pool]
    table = ref_lm.param_table(model, 31)
    return cfg, model, txt, table


def test_lm_readings_repeat_exactly():
    cfg, model, txt, table = _lm_inputs(lm_cell())
    w0 = weights.make(table, 3, CPU)
    seeds = [base.gen_seed(3, k) for k in range(3)]
    a = ref_lm.readings(w0, model, cfg["hparas"], txt, seeds)
    b = ref_lm.readings(w0, model, cfg["hparas"], txt, seeds)
    assert a == b
    assert len(a["loss"]) == 3 and set(a["grad1"]) == {p for p, _, _ in table}


def test_lm_gradient_matches_a_finite_difference():
    _, model, txt, table = _lm_inputs(lm_cell())
    model = dict(model, dropout=0.0)
    w = {k: v.double() for k, v in weights.make(table, 4, CPU).items()}
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    loss = ref_lm.loss_fn(leaves, model, txt[0], None)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    direction = {k: torch.randn_like(v) for k, v in w.items()}
    slope = sum((g * direction[k]).sum() for k, g in zip(leaves, grads))
    eps = 1e-6
    up = ref_lm.loss_fn({k: v + eps * direction[k] for k, v in w.items()},
                        model, txt[0], None)
    down = ref_lm.loss_fn({k: v - eps * direction[k] for k, v in w.items()},
                          model, txt[0], None)
    assert float(slope) == pytest.approx(float((up - down) / (2 * eps)),
                                         rel=1e-6)


def test_reverse_recurrence_is_the_forward_one_flipped():
    g = torch.Generator().manual_seed(0)
    xg = torch.randn(7, 3, 16, generator=g)
    w_h = torch.randn(4, 16, generator=g) * 0.5
    back = common.lstm_seq(xg, w_h, "f32", reverse=True)
    flipped = common.lstm_seq(xg.flip(0), w_h, "f32").flip(0)
    assert torch.allclose(back, flipped, atol=1e-6)


def test_the_control_rounds_to_float8():
    x = torch.linspace(-3, 5, 1001)
    q = common.operand(x, "fp8")
    assert q.abs().max() <= 5.0 + 1e-6
    rel = ((q - x).abs() / x.abs().clamp(min=5.0 / 448 * 2 ** -6))
    assert rel.max() <= 2 ** -4 + 1e-6
    assert (q != x).any()
    assert torch.equal(common.operand(x, "f32"), x)


def test_asr_rows_in_blocks_agree_with_one_block():
    cell = asr_cell()
    cfg = base.run_config(cell.config)
    model = cfg["model"]
    table = ref_asr.param_table(model, 31, 120)
    pool = traffic.batches(cell.traffic, 31, 9, 2)
    batches = [{k: torch.from_numpy(b[k]).long() if k != "wav" else
                torch.from_numpy(b[k]) for k in ("wav", "wav_len", "txt",
                                                  "txt_len")} for b in pool]
    w0 = weights.make(table, 9, CPU)
    seeds = [base.gen_seed(9, k) for k in range(2)]
    whole = ref_asr.readings(w0, model, cfg["data"]["audio"], cfg["hparas"],
                             batches, seeds, rows_per_block=4)
    parts = ref_asr.readings(w0, model, cfg["data"]["audio"], cfg["hparas"],
                             batches, seeds, rows_per_block=1)
    nums = compare.numbers(parts, whole)
    assert nums["loss"][0] < 1e-5
    assert nums["grad1"][0] < 1e-4


@pytest.mark.parametrize("family,make", [(fam_lm, lm_cell),
                                         (fam_asr, asr_cell)],
                         ids=["lm", "asr"])
def test_the_port_follows_the_reference_at_debug_widths(family, make,
                                                        tmp_path):
    cell = make()
    prog = family.Program(cell, 2 ** 31 + 11, CPU, str(tmp_path))
    got = prog.check_steps()
    prog.free()
    ref = family.reference_readings(prog)
    nums = compare.numbers(got, ref)
    # the first step's loss: the port on the CPU computes in float32
    assert nums["loss1"][0] < 1e-4
    assert nums["grad1"][0] < cell.limits["limits"]["grad1"]
