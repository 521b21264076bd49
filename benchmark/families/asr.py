"""The joint CTC-attention ASR training step, driven through the port.

Set-up is the port's own: its ``train_asr.Solver`` (the process settings of
``BaseSolver``) and ``set_model`` for the configuration (the model spec,
the feature front-end, Adadelta and its bf16 state, the step's
``StepConfig``), given the vocabulary and feature sizes ``load_data`` would
read from a corpus; then the benchmark's weights, made on the card from the
seed, are copied into the solver's leaves. The timed call is
``train_asr.train_step`` under pure teacher forcing, each batch placed by
the solver's ``put_batch`` and the port's ``to_device``, each step's
SpecAugment and dropout drawn from a generator the benchmark seeds.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from families import base
from harness import flops, weights
from reference import asr as ref_asr

RATE_METRIC, RATE_UNIT = "asr_utts_per_s", "utts/s"
HOP = 160


class Program(base.TrainingProgram):
    """The port's ASR solver at the cell's configuration, its weights the
    benchmark's, its batches the cell's traffic."""

    def __init__(self, cell, seed: int, device, workdir: str):
        super().__init__(cell, seed, device)
        from e2e_asr_pytorch_tpu_torch.data.tokenizer import load_text_encoder
        from e2e_asr_pytorch_tpu_torch.train import train_asr
        self.T = train_asr
        self.cfg = base.run_config(cell.config)
        solver = train_asr.Solver(
            self.cfg, base.paras(cell, seed, device, workdir), "train")
        tok = load_text_encoder(**self.cfg["data"]["text"])
        audio = self.cfg["data"]["audio"]
        # what load_data reads from the corpus and the audio block
        solver.tokenizer, solver.vocab_size = tok, tok.vocab_size
        solver.feat_dim = audio["feat_dim"] * (audio.get("delta_order", 0)
                                               + 1)
        solver.upstream = None
        solver.set_model()
        self.vocab = tok.vocab_size
        self.feat_dim = solver.feat_dim
        self.model = self.cfg["model"]
        self.setup(solver, ref_asr.param_table(self.model, self.vocab,
                                               self.feat_dim), self.vocab)

    def _step(self, data, gen):
        s = self.solver
        batch = self.T.to_device(s.put_batch(data), self.device)
        s.params, s.opt_state, metrics, _, _ = self.T.train_step(
            s.step_cfg, s.params, s.opt_state, batch, gen,
            s.tf_rate(self.step_index), s.spec.enable_ctc)
        return metrics["total"], metrics["gnorm"]

    @staticmethod
    def units(data) -> int:
        """Utterances trained on (rows that are no padding)."""
        return int(data["utt_w"].sum())

    @staticmethod
    def shape(data) -> Dict:
        frames = 1 + (data["wav"].shape[1] - 1) // HOP
        return {"B": data["wav"].shape[0], "frames": frames,
                "T": frames // 4, "L": data["txt"].shape[1]}

    def step_flops(self, shape: Dict) -> float:
        return flops.asr_step_flops(self.model, self.vocab, self.feat_dim,
                                    shape["B"], shape["frames"], shape["L"])

    def first_gradient(self) -> Dict:
        """Adadelta's squared-gradient average after one step is
        (1 - rho) g^2, kept in the state's dtype."""
        from e2e_asr_pytorch_tpu_torch.train import optim
        e_g = weights.flatten(self.solver.opt_state["e_g"])
        return {k: torch.sqrt(v.double().sum() / (1.0 - optim.RHO))
                for k, v in e_g.items()}


def reference_readings(prog: Program, prec: str = "f32") -> Dict:
    batches = []
    for k in range(base.CHECKED_STEPS):
        d = prog.pool[k]
        batches.append({n: torch.from_numpy(d[n]).to(prog.device).long()
                        if n != "wav" else
                        torch.from_numpy(d[n]).to(prog.device)
                        for n in ("wav", "wav_len", "txt", "txt_len")})
    w0 = weights.make(prog.table, prog.seed, prog.device)
    return ref_asr.readings(w0, prog.model, prog.cfg["data"]["audio"],
                            prog.cfg["hparas"], batches,
                            prog.reference_seeds(), prec)


# ------------------------------------------------------------ planted faults
@contextlib.contextmanager
def _patched(make):
    from e2e_asr_pytorch_tpu_torch.train import train_asr
    real = train_asr.train_step
    train_asr.train_step = make(real, train_asr)
    try:
        yield
    finally:
        train_asr.train_step = real


def half_batch():
    """The step trains on the first half of the batch's rows only, the
    losses the means over them."""
    def make(real, _):
        def broken(cfg, params, opt_state, batch, gen, *args):
            half = batch["wav"].shape[0] // 2
            return real(cfg, params, opt_state,
                        {k: v[:half] for k, v in batch.items()}, gen, *args)
        return broken
    return _patched(make)


def frozen_state():
    """The step returns the parameters and the optimizer state as they
    were (its losses still computed)."""
    def make(real, train_asr):
        def broken(cfg, params, opt_state, batch, gen, tf_rate, use_ctc=True,
                   y_emb=None):
            total, _, _ = train_asr.loss_and_grads(cfg, params, batch, gen,
                                                   tf_rate, use_ctc, y_emb)
            return params, opt_state, {"total": total,
                                       "gnorm": torch.zeros_like(total)}, \
                None, None
        return broken
    return _patched(make)


FAULTS = {"half_batch": half_batch, "frozen_state": frozen_state}
