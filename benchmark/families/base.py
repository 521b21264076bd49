"""What the training families share: the pool of batches made from the
seed, the steps' generators, the first steps whose readings the reference
checks, and the losses and norms kept on the device until the window has
closed."""

from __future__ import annotations

from typing import Dict

import torch

from harness import traffic, weights
from harness.manifest import ROOT

# the first steps of the run, compared with the reference; then one more,
# so that the window starts warm
CHECKED_STEPS = 3
WARM_STEPS = 1


def gen_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator (dropout, SpecAugment)."""
    return (int(seed) * 1000003 + 11 + step) % 2 ** 63


def run_config(config: Dict) -> Dict:
    """The configuration as the port reads its YAML, with the vocabulary
    file found from the checkout's root."""
    cfg = dict(config["run"])
    text = dict(cfg["data"]["text"])
    text["vocab_file"] = str(ROOT / text["vocab_file"])
    cfg["data"] = dict(cfg["data"], text=text)
    return cfg


def paras(cell, seed: int, device, workdir: str, extra=()):
    """The port's run flags: logs and checkpoints under ``workdir``."""
    from e2e_asr_pytorch_tpu_torch.utils.config import parse_paras
    return parse_paras(
        list(extra) + ["--config", cell.config_entry["file"], "--name",
                       "benchmark", "--logdir", workdir, "--ckpdir", workdir,
                       "--seed", str(seed), "--no-msg", "--njobs", "0"]
        + (["--cpu"] if device.type == "cpu" else []))


class TrainingProgram:
    """A port solver after ``set_model``, its leaves filled with the
    benchmark's weights, stepping over the cell's pool of batches.
    Subclasses set ``self.solver``, ``self.table`` and ``self.pool`` and
    define ``_step(batch, gen) -> (loss, gnorm)``, ``units(batch)``,
    ``shape(batch)`` and ``first_gradient()``."""

    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.seed = seed
        self.device = device
        self.gen = torch.Generator(device=device)
        self.step_index = 0
        self.outs = []

    def setup(self, solver, table, vocab: int):
        self.solver = solver
        self.table = table
        weights.install(solver.params, weights.make(table, self.seed,
                                                    self.device))
        self.pool = traffic.batches(self.cell.traffic, vocab, self.seed,
                                    self.cell.traffic["pool"])
        self.pool_units = [self.units(b) for b in self.pool]

    def step(self) -> int:
        """One training step on the next batch of the pool; returns the
        units of work it did (what the cell's rate counts)."""
        k = self.step_index % len(self.pool)
        self.gen.manual_seed(gen_seed(self.seed, self.step_index))
        self.outs.append(self._step(self.pool[k], self.gen))
        self.step_index += 1
        return self.pool_units[k]

    def shape_at(self, step: int) -> Dict:
        return self.shape(self.pool[step % len(self.pool)])

    def check_steps(self) -> Dict:
        """The first steps, with the readings the comparison takes: each
        loss, the first gradient per leaf as the optimizer's state after one
        step holds it, the change per leaf after the steps."""
        losses = []
        for i in range(CHECKED_STEPS):
            self.step()
            losses.append(self.outs[-1][0])
            if i == 0:
                grad1 = self.first_gradient()
        w0 = weights.make(self.table, self.seed, self.device)
        now = weights.flatten(self.solver.params)
        delta = {k: torch.linalg.vector_norm((now[k] - w0[k]).double())
                 for k in now}
        del w0
        out = {"loss": [float(x) for x in losses],
               "grad1": {k: float(v) for k, v in grad1.items()},
               "delta3": {k: float(v) for k, v in delta.items()}}
        for _ in range(WARM_STEPS):
            self.step()
        return out

    def failed(self) -> int:
        """Steps whose loss or gradient norm was not finite (one read, at
        the end)."""
        if not self.outs:
            return 0
        x = torch.stack([torch.stack([a.float(), b.float()])
                         for a, b in self.outs])
        return int((~torch.isfinite(x)).any(dim=1).sum())

    def free(self):
        """Drop the program's state (parameters, optimizer state, step
        outputs) before the reference runs."""
        self.solver = None
        self.outs = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_seeds(self):
        return [gen_seed(self.seed, k) for k in range(CHECKED_STEPS)]
