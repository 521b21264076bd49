"""BaseSolver: the experiment lifecycle shared by the solvers (port of
e2e_asr_pytorch_tpu/train/solver.py).

Experiment naming (<config>_sd<seed>), the device and compute dtype, and
per mode: in train mode the log and checkpoint dirs, the JAX package's
``Logger`` (stdout plus a TensorBoard writer, none when tensorboardX is
missing), ``valid_step``/``max_step``, the step ``Timer``, asynchronous
checkpoint saves and ``--load`` resume with the optimizer state; in test
mode the output dir and loading the model from config['src']['ckpt'].
Either path may name a checkpoint the JAX package wrote (flax msgpack,
``train/checkpoint.py``). The config's ``transfer`` block sets transfer
learning: ``train_enc`` lists the encoder rnn layers that keep training
(``fix_enc`` the others), ``train_dec: False`` freezes the decoder side
(``fix_dec``), checkpoint names carry ``save_name``, and a ``--load``ed
checkpoint's optimizer state is not restored.

On a mesh (``--n-devices`` / ``--n-model``, ``parallel/mesh.py``) each
rank runs a solver on its own device: ``put_batch`` keeps this rank's rows
of a global batch, ``to_host`` gathers the data ranks' rows back,
``host_slice`` cuts this rank's rows out of a gathered array, and
``place_model`` shards the wide leaves and their optimizer state over
'model' (``full_params`` gathers them for use). Only rank 0 writes logs,
checkpoints and CSVs; the other ranks wait for it at ``ckpt_wait``.
"""

from __future__ import annotations

import abc
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from e2e_asr_pytorch_tpu_torch.utils.config import DEFAULT_HPARAS, exp_name
from e2e_asr_pytorch_tpu_torch.utils.logger import Logger
from e2e_asr_pytorch_tpu_torch.utils.timer import Timer, human_format
from e2e_asr_pytorch_tpu_torch.parallel import mesh as mesh_lib
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
        # the mesh this process is a rank of (None: one process, one device)
        self.mesh = mesh_lib.current()
        if self.mesh is None and (getattr(paras, "n_devices", None)
                                  is not None
                                  or getattr(paras, "n_model", 1) != 1):
            raise RuntimeError(
                "--n-devices / --n-model run the solver on the ranks of a "
                "mesh: start it through main.main(), which launches them")
        if self.mesh is None:
            self.device = select_device(paras.cpu)
            self.n_data, self.n_model, self.rank = 1, 1, 0
        else:
            self.device = self.mesh.device
            self.n_data, self.n_model = self.mesh.n_data, self.mesh.n_model
            self.rank = self.mesh.rank
        self.is_writer = self.rank == 0
        self.param_specs = self.opt_specs = None
        # f32 stays f32 on the card: matmuls already default to full f32, but
        # cuDNN would run f32 convolutions in TF32 unless told not to
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # one seed, one result on the card as on the TPU: left to its
        # heuristics, cuDNN picks backward convolution algorithms that sum
        # with atomics, whose rounding changes from run to run
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        # bf16 compute on the accelerator (or with --amp), f32 on the CPU
        use_bf16 = getattr(paras, "amp", False) or self.device.type == "cuda"
        self.compute_dtype = torch.bfloat16 if use_bf16 else torch.float32
        self.step = 0
        self.timer = Timer()

        self.exp_name = exp_name(paras)
        if mode == "train":
            self.logdir = os.path.join(paras.logdir, self.exp_name)
            self.ckpdir = os.path.join(paras.ckpdir, self.exp_name)
            os.makedirs(self.ckpdir, exist_ok=True)
            self.log = Logger(self.logdir if self.is_writer else None,
                              paras.verbose and self.is_writer,
                              self.TB_FLUSH_FREQ)
            hp = self.config["hparas"]
            self.valid_step = hp.get("valid_step", 2000)
            self.max_step = hp.get("max_step", 100000)
        else:
            os.makedirs(paras.outdir, exist_ok=True)
            self.ckpdir = paras.ckpdir
            self.log = Logger(None, paras.verbose and self.is_writer)
        self._ckpt_writer = ckpt_lib.AsyncCheckpointWriter()
        self.transfer_learning = (mode == "train"
                                  and config.get("transfer") is not None)
        self.save_name = ""
        if self.transfer_learning:
            t = config["transfer"]
            self.train_enc = list(t["train_enc"])
            n_enc = len(config["model"]["encoder"]["dim"])
            self.fix_enc = [i for i in range(n_enc)
                            if i not in self.train_enc]
            self.train_dec = bool(t["train_dec"])
            self.fix_dec = not self.train_dec
            self.save_name = "_tune-{}-{}".format(
                "".join(str(l) for l in self.train_enc),
                "1" if self.train_dec else "0")
            if paras.seed > 0:
                self.save_name += "-sd" + str(paras.seed)
        self.verbose("Experiment {} on {} device(s): {} ({}){}".format(
            self.exp_name, self.n_data * self.n_model, self.device.type,
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else "host",
            "" if self.mesh is None else ", mesh data {} x model {}".format(
                self.n_data, self.n_model)))

    # -------------------------------------------------------------- mesh io
    def place_model(self):
        """On a mesh, cut the wide leaves of the parameters and of the
        optimizer state to this rank's 'model' slice (their specs kept for
        ``full_params`` and the gradient reduction). One process: as is."""
        if self.mesh is None:
            return
        self.params, self.param_specs = mesh_lib.place_params(self.params,
                                                              self.mesh)
        if getattr(self, "opt_state", None) is not None:
            self.opt_state, self.opt_specs = mesh_lib.place_opt_state(
                self.opt_state, self.mesh)

    def full_params(self):
        """The whole parameter tree (the sharded leaves all-gathered over
        'model'), what the kernels and the decoders take."""
        if self.mesh is None:
            return self.params
        return self.mesh.gather(self.params, self.param_specs)

    def put_batch(self, data: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a host batch. A batch the iterator already
        cut to this rank (``host_rows``: it has ``global_batch``) is kept;
        a global one (padded to a multiple of n_data) is sliced."""
        if self.n_data == 1 or "global_batch" in data:
            return data
        rows = self.mesh.rows(len(data["txt"]))
        return {k: (v[rows] if isinstance(v, np.ndarray) else v)
                for k, v in data.items()}

    def to_host(self, x: torch.Tensor) -> np.ndarray:
        """A per-row device tensor -> host numpy of the global batch's rows
        (the data ranks' rows gathered in order)."""
        if self.n_data > 1:
            x = self.mesh.gather_rows(x)
        return x.float().cpu().numpy() if x.is_floating_point() \
            else x.cpu().numpy()

    def host_slice(self, x: np.ndarray, n_local: int) -> np.ndarray:
        """This rank's contiguous rows of a gathered global batch, when the
        batch was cut per rank (``n_local`` rows each); a gathered global
        batch of ``n_local`` rows is all this rank's."""
        if self.n_data == 1 or len(x) == n_local:
            return x
        p = self.mesh.dp_rank
        return x[p * n_local:(p + 1) * n_local]

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
        is taken here, the write overlaps the next steps. On a mesh every
        rank joins the gather of the sharded leaves and rank 0 writes."""
        path = os.path.join(self.ckpdir, fname)
        params = self.full_params()
        opt_state = self.opt_state
        if self.mesh is not None and opt_state is not None:
            opt_state = self.mesh.gather(opt_state, self.opt_specs)
        if not self.is_writer:
            return
        self._ckpt_writer.save(path, params, opt_state, self.step,
                               metric, score)
        if show_msg:
            self.verbose("Saved checkpoint (step = {}, {} = {:.2f}) and "
                         "status @ {}".format(human_format(self.step), metric,
                                              score, path))

    def ckpt_wait(self):
        """Join any in-flight checkpoint write (call before exit/re-read);
        on a mesh the other ranks wait until rank 0's write is done."""
        self._ckpt_writer.wait()
        if self.mesh is not None:
            self.mesh.barrier()

    def load_ckpt(self, params_template=None) -> Optional[Dict[str, Any]]:
        """Load the model (and in train mode the optimizer state and step)
        from --load (train) or config['src']['ckpt'] (test) onto the device;
        None when no path is set (the caller keeps the seeded init). A JAX
        package checkpoint is restored against ``params_template`` (else
        ``self.params``), its optimizer state converted in train mode.
        Under transfer learning the optimizer state is not restored."""
        self.ckpt_wait()
        load_path = (self.paras.load if self.mode == "train"
                     else self.config["src"]["ckpt"])
        if not load_path:
            return None
        template = (params_template if params_template is not None
                    else getattr(self, "params", None))
        want_opt = self.mode == "train" and not self.transfer_learning
        ckpt = ckpt_lib.load_checkpoint(
            load_path, self.device, template,
            getattr(self, "opt_state", None) if want_opt else None)
        self.params = ckpt["model"]
        if self.mode == "train":
            if ckpt.get("optimizer") is not None and want_opt:
                if set(ckpt["optimizer"]) != set(self.opt_state):
                    raise ValueError(
                        "{}'s optimizer state holds {}, this run's optimizer "
                        "{}".format(load_path, sorted(ckpt["optimizer"]),
                                    sorted(self.opt_state)))
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
