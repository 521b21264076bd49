"""BaseSolver: the experiment lifecycle shared by the solvers (port of
e2e_asr_pytorch_tpu/train/solver.py, single device).

Experiment naming (<config>_sd<seed>), the device and compute dtype, and
per mode: in train mode the log and checkpoint dirs, the JAX package's
``Logger`` (stdout plus a TensorBoard writer, none when tensorboardX is
missing), ``valid_step``/``max_step``, the step ``Timer``, asynchronous
checkpoint saves and ``--load`` resume with the optimizer state; in test
mode the output dir and loading the model from config['src']['ckpt'].
Transfer learning (the config's ``transfer`` block) is not ported.
"""

from __future__ import annotations

import abc
import os
from typing import Any, Dict, Optional

import torch

from e2e_asr_pytorch_tpu_torch.utils.config import DEFAULT_HPARAS, exp_name
from e2e_asr_pytorch_tpu_torch.utils.logger import Logger
from e2e_asr_pytorch_tpu_torch.utils.timer import Timer, human_format
from e2e_asr_pytorch_tpu_torch.train import checkpoint as ckpt_lib


def select_device(cpu: bool) -> torch.device:
    """--cpu selects the CPU; otherwise CUDA, which must be present."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --cpu to run on the "
                           "CPU")
    return torch.device("cuda")


class BaseSolver(abc.ABC):
    def __init__(self, config: Dict[str, Any], paras, mode: str):
        if mode not in ("train", "test"):
            raise ValueError("mode must be train or test, got " + mode)
        self.config = config
        self.paras = paras
        self.mode = mode
        for k, v in DEFAULT_HPARAS.items():
            setattr(self, k, v)
        self.device = select_device(paras.cpu)
        # f32 stays f32 on the card: matmuls already default to full f32, but
        # cuDNN would run f32 convolutions in TF32 unless told not to
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # bf16 compute on the accelerator (or with --amp), f32 on the CPU
        use_bf16 = getattr(paras, "amp", False) or self.device.type == "cuda"
        self.compute_dtype = torch.bfloat16 if use_bf16 else torch.float32
        self.step = 0
        self.timer = Timer()

        self.exp_name = exp_name(paras)
        if mode == "train":
            if config.get("transfer") is not None:
                raise NotImplementedError(
                    "transfer learning is not ported yet (ROADMAP: training "
                    "runtime)")
            self.logdir = os.path.join(paras.logdir, self.exp_name)
            self.ckpdir = os.path.join(paras.ckpdir, self.exp_name)
            os.makedirs(self.ckpdir, exist_ok=True)
            self.log = Logger(self.logdir, paras.verbose, self.TB_FLUSH_FREQ)
            hp = self.config["hparas"]
            self.valid_step = hp.get("valid_step", 2000)
            self.max_step = hp.get("max_step", 100000)
        else:
            os.makedirs(paras.outdir, exist_ok=True)
            self.ckpdir = paras.ckpdir
            self.log = Logger(None, paras.verbose)
        self._ckpt_writer = ckpt_lib.AsyncCheckpointWriter()
        self.verbose("Experiment {} on 1 device(s): {} ({})".format(
            self.exp_name, self.device.type,
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else "host"))

    # ------------------------------------------------------------------ io
    def verbose(self, msg):
        self.log.verbose(msg)

    def progress(self, msg):
        self.log.progress(msg)

    def write_log(self, name, value):
        self.log.write_log(name, value, self.step)

    def step_gen(self) -> torch.Generator:
        """``self.gen`` seeded for the step about to run from (seed + 1,
        step) alone, as the JAX solvers key a step on ``fold_in(base_rng,
        step)``: a run resumed at step N draws at step N the SpecAugment and
        dropout masks an uninterrupted run draws there."""
        return self.gen.manual_seed(
            ((self.paras.seed + 1) * 2 ** 32 + self.step) % 2 ** 63)

    # ------------------------------------------------------------ chkpoint
    def save_checkpoint(self, fname: str, metric: str, score: float,
                        show_msg: bool = True):
        """Save params + optimizer state asynchronously: the host snapshot
        is taken here, the write overlaps the next steps."""
        path = os.path.join(self.ckpdir, fname)
        self._ckpt_writer.save(path, self.params, self.opt_state, self.step,
                               metric, score)
        if show_msg:
            self.verbose("Saved checkpoint (step = {}, {} = {:.2f}) and "
                         "status @ {}".format(human_format(self.step), metric,
                                              score, path))

    def ckpt_wait(self):
        """Join any in-flight checkpoint write (call before exit/re-read)."""
        self._ckpt_writer.wait()

    def load_ckpt(self) -> Optional[Dict[str, Any]]:
        """Load the model (and in train mode the optimizer state and step)
        from --load (train) or config['src']['ckpt'] (test) onto the device;
        None when no path is set (the caller keeps the seeded init)."""
        self.ckpt_wait()
        load_path = (self.paras.load if self.mode == "train"
                     else self.config["src"]["ckpt"])
        if not load_path:
            return None
        ckpt = ckpt_lib.load_checkpoint(load_path, self.device)
        self.params = ckpt["model"]
        if self.mode == "train":
            if ckpt.get("optimizer") is not None:
                self.opt_state = ckpt["optimizer"]
            self.step = int(ckpt.get("global_step", 0))
            self.verbose("Load ckpt from {}, restarting at step {}".format(
                load_path, self.step))
        else:
            self.verbose("Evaluating ckpt from {} (step {})".format(
                load_path, ckpt.get("global_step", "?")))
        return ckpt

    # ------------------------------------------------------------- phases
    @abc.abstractmethod
    def load_data(self):
        ...

    @abc.abstractmethod
    def set_model(self):
        ...

    @abc.abstractmethod
    def exec(self):
        ...
