"""The comparison catches what it is there to catch.

On the CPU at debug widths: a whole run (set-up, checked steps, window,
reference, verdict) with the port's step broken underneath comes out
``correct: false`` under the cell's own limits, for each fault a training
cell can have: the step returns its state unchanged; it trains on half the
batch, the mean taken over the rest. The same run unbroken comes out
``correct: true``.

On the card (``cuda``), at the cell's own size: the control, the
reference computed with float8 operands, fails the cell's limits on three
seeds.
"""

import pytest
import torch

import run
from debug_cells import asr_cell, lm_cell
from families import asr as fam_asr, lm as fam_lm
from harness import compare
from harness.manifest import family_module, load_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 101


@pytest.mark.parametrize("make", [lm_cell, asr_cell], ids=["lm", "asr"])
def test_a_sound_run_is_correct(make):
    res = run.execute(make(), SEED, 0.2, False, CPU)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "frozen_state"])
@pytest.mark.parametrize("family,make", [(fam_lm, lm_cell),
                                         (fam_asr, asr_cell)],
                         ids=["lm", "asr"])
def test_a_broken_step_is_not_correct(family, make, fault):
    with family.FAULTS[fault]():
        res = run.execute(make(), SEED, 0.2, False, CPU)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lm_best.train", "lm_best.short"])
def test_the_control_fails_at_the_cells_size(card, name, tmp_path):
    cell = load_cell(name)
    fam = family_module(cell)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        prog = fam.Program(cell, seed, card, str(tmp_path))
        prog.free()
        ref = fam.reference_readings(prog, "f32")
        ctl = fam.reference_readings(prog, "fp8")
        ok, checks = compare.judge(compare.numbers(ctl, ref),
                                   cell.limits["limits"])
        assert not ok, checks
