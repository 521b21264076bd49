"""The character RNN LM's training step, driven through the port.

Set-up is the port's own: its ``train_lm.Solver`` (the process settings of
``BaseSolver``: TF32 off, deterministic cuDNN, bf16 compute on the card)
and ``set_model`` for the configuration (the LM spec, the optimizer and its
state, the step's ``StepConfig``); then the benchmark's weights, made on
the card from the seed, are copied into the solver's leaves. The timed
call is ``train_lm.train_step``, each batch placed by the solver's
``put_batch`` and the port's ``_to_device``, each step's dropout drawn from
a generator the benchmark seeds.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from families import base
from harness import flops, weights
from reference import lm as ref_lm

RATE_METRIC, RATE_UNIT = "lm_tokens_per_s", "tokens/s"


class Program(base.TrainingProgram):
    """The port's LM solver at the cell's configuration, its weights the
    benchmark's, its batches the cell's traffic."""

    def __init__(self, cell, seed: int, device, workdir: str):
        super().__init__(cell, seed, device)
        from e2e_asr_pytorch_tpu_torch.data.tokenizer import load_text_encoder
        from e2e_asr_pytorch_tpu_torch.train import train_lm
        self.T = train_lm
        self.cfg = base.run_config(cell.config)
        solver = train_lm.Solver(
            self.cfg, base.paras(cell, seed, device, workdir, ["--lm"]),
            "train")
        tok = load_text_encoder(**self.cfg["data"]["text"])
        solver.tokenizer, solver.vocab_size = tok, tok.vocab_size
        solver.set_model()
        self.vocab = tok.vocab_size
        self.model = self.cfg["model"]
        self.setup(solver, ref_lm.param_table(self.model, self.vocab),
                   self.vocab)

    def _step(self, data, gen):
        s = self.solver
        txt = self.T._to_device(s.put_batch(data), self.device)
        s.params, s.opt_state, loss, gnorm = self.T.train_step(
            s.step_cfg, s.params, s.opt_state, txt, gen)
        return loss, gnorm

    @staticmethod
    def units(data) -> int:
        """Loss tokens: the targets that are no padding."""
        return int(data["txt_len"].sum())

    @staticmethod
    def shape(data) -> Dict:
        return {"B": data["txt"].shape[0], "T": data["txt"].shape[1]}

    def step_flops(self, shape: Dict) -> float:
        return flops.lm_step_flops(self.model, self.vocab, shape["T"],
                                   shape["B"])

    def first_gradient(self) -> Dict:
        """Adam's first moment after one step is (1 - b1) g."""
        from e2e_asr_pytorch_tpu_torch.train import optim
        mu = weights.flatten(self.solver.opt_state["mu"])
        return {k: torch.linalg.vector_norm(v.double()) / (1.0 - optim.ADAM_B1)
                for k, v in mu.items()}


def reference_readings(prog: Program, prec: str = "f32") -> Dict:
    batches = [torch.from_numpy(prog.pool[k]["txt"]).long().to(prog.device)
               for k in range(base.CHECKED_STEPS)]
    w0 = weights.make(prog.table, prog.seed, prog.device)
    return ref_lm.readings(w0, prog.model, prog.cfg["hparas"], batches,
                           prog.reference_seeds(), prec)


# ------------------------------------------------------------ planted faults
@contextlib.contextmanager
def _patched(make):
    from e2e_asr_pytorch_tpu_torch.train import train_lm
    real = train_lm.train_step
    train_lm.train_step = make(real, train_lm)
    try:
        yield
    finally:
        train_lm.train_step = real


def half_batch():
    """The step trains on the first half of the batch's rows only, the
    loss the mean over them."""
    return _patched(lambda real, _: (
        lambda cfg, params, opt_state, txt, gen:
        real(cfg, params, opt_state, txt[:txt.shape[0] // 2], gen)))


def frozen_state():
    """The step returns the parameters and the optimizer state as they
    were (its loss still computed)."""
    def make(real, train_lm):
        def broken(cfg, params, opt_state, txt, gen):
            loss, _ = train_lm.loss_and_grads(cfg, params, txt, gen)
            return params, opt_state, loss, torch.zeros_like(loss)
        return broken
    return _patched(make)


FAULTS = {"half_batch": half_batch, "frozen_state": frozen_state}
