"""BaseSolver, test-mode subset (port of e2e_asr_pytorch_tpu/train/solver.py).

Experiment naming (<config>_sd<seed>), output dir, stdout logging, the
device and compute dtype, and loading the model from config['src']['ckpt'].
Training (and its TensorBoard logging, optimizer state and async checkpoint
writer) comes with the training slice.
"""

from __future__ import annotations

import abc
import os
from typing import Any, Dict, Optional

import torch

from e2e_asr_pytorch_tpu.utils.config import DEFAULT_HPARAS, exp_name
from e2e_asr_pytorch_tpu.utils.logger import Logger
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
        if mode != "test":
            raise NotImplementedError(
                "training is not ported yet (ROADMAP: flagship training step, "
                "training runtime)")
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

        self.exp_name = exp_name(paras)
        os.makedirs(paras.outdir, exist_ok=True)
        self.ckpdir = paras.ckpdir
        self.log = Logger(None, paras.verbose)
        self.verbose("Experiment {} on 1 device(s): {} ({})".format(
            self.exp_name, self.device.type,
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else "host"))

    # ------------------------------------------------------------------ io
    def verbose(self, msg):
        self.log.verbose(msg)

    def progress(self, msg):
        self.log.progress(msg)

    # ------------------------------------------------------------ chkpoint
    def load_ckpt(self) -> Optional[Dict[str, Any]]:
        """Load the model from config['src']['ckpt'] onto the device; None
        when no path is set (the caller then uses the seeded init)."""
        load_path = self.config["src"]["ckpt"]
        if not load_path:
            return None
        ckpt = ckpt_lib.load_checkpoint(load_path, self.device)
        self.params = ckpt["model"]
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
