"""RNNLM training solver (port of e2e_asr_pytorch_tpu/train/train_lm.py).

<sos>(=<pad> id 0)-prepended text, masked cross entropy on the shifted
targets, perplexity logging and best-ppx checkpointing. The
step is ``train_step``: the LM's full-sequence forward (the stacked LSTM
through the single-direction recurrence kernels, ``ops/kernels/lstm.py``),
the loss, autograd backward and the optimizer update, all eager PyTorch. The
checkpoints hold the same ``model`` tree the decode path loads as its LM.
The step's profiler spans (``record_function``) carry the ASR step's names:
``place`` (the batch's copy to the device, ``_to_device``), ``forward``,
``backward``, ``optimizer`` and, on a mesh, ``reduce``.

Validation runs when the step count is a multiple of ``valid_step``, as in
the JAX solver; training stops once ``max_step`` steps are done.

On a mesh (``parallel/mesh.py``) each rank takes its rows of every global
batch (padded with all-<pad> rows to a multiple of n_data), divides its
loss by the token count summed over the data ranks, and steps on the
reduced gradients of its leaves; validation sums the NLL and the token
counts over the data ranks.
"""

from __future__ import annotations

import math
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from e2e_asr_pytorch_tpu_torch.convert import tree_leaves, tree_map
from e2e_asr_pytorch_tpu_torch.data.batching import prefetch
from e2e_asr_pytorch_tpu_torch.data.loaders import load_textset
from e2e_asr_pytorch_tpu_torch.models import lm as LM
from e2e_asr_pytorch_tpu_torch.ops import losses as L
from e2e_asr_pytorch_tpu_torch.train import optim as O
from e2e_asr_pytorch_tpu_torch.train.solver import BaseSolver
from e2e_asr_pytorch_tpu_torch.utils.timer import human_format


class StepConfig(NamedTuple):
    """What an LM step needs besides the parameters and the batch."""
    spec: LM.LMSpec
    optimizer: object
    compute_dtype: torch.dtype = torch.float32
    # the rank's mesh and the parameters' shard specs (parallel/mesh.py)
    mesh: Optional[object] = None
    param_specs: Optional[object] = None


def shift_inputs(txt: torch.Tensor):
    """Prepend <sos> (id 0) and predict the sequence: inputs txt[:, :-1]
    with 0 up front, targets txt."""
    return F.pad(txt, (1, 0))[:, :-1], txt


def loss_and_grads(cfg: StepConfig, params, txt: torch.Tensor, gen):
    """The masked cross entropy of the training forward (dropout drawn from
    ``gen``) and its gradient with respect to every parameter leaf."""
    with torch.enable_grad():
        with record_function("forward"):
            inp, tgt = shift_inputs(txt)
            leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
            logits, _ = LM.lm_apply(leaves, cfg.spec, inp, gen=gen,
                                    train=True,
                                    compute_dtype=cfg.compute_dtype)
            loss = L.cross_entropy_loss(
                logits, tgt, global_sum=cfg.mesh.global_sum
                if cfg.mesh is not None else None)
        flat = tree_leaves(leaves)
        with record_function("backward"):
            grads = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def train_step(cfg: StepConfig, params, opt_state, txt: torch.Tensor, gen):
    """One training step. Updates ``params`` and ``opt_state`` in place and
    returns (params, opt_state, loss, grad norm before clipping), the last
    two as 0-dim device tensors. On a mesh the leaves are this rank's, the
    gradients reduced onto them, and the loss the global batch's."""
    mesh = cfg.mesh
    if mesh is None:
        loss, grads = loss_and_grads(cfg, params, txt, gen)
        with record_function("optimizer"):
            gnorm = cfg.optimizer.step(params, grads, opt_state)
        return params, opt_state, loss, gnorm
    loss, grads = loss_and_grads(cfg, mesh.gather(params, cfg.param_specs),
                                 txt, gen)
    with record_function("reduce"):
        grads = mesh.reduce_grads(grads, cfg.param_specs)
    with record_function("optimizer"):
        gnorm = cfg.optimizer.step(
            params, grads, opt_state,
            lambda g: mesh.grad_norm(g, cfg.param_specs))
    return params, opt_state, mesh.global_sum(loss), gnorm


@torch.no_grad()
def valid_step(cfg: StepConfig, params, txt: torch.Tensor):
    """Per-token NLL sum and token count of a batch (for the exact corpus
    perplexity)."""
    inp, tgt = shift_inputs(txt)
    logits, _ = LM.lm_apply(params, cfg.spec, inp, train=False,
                            compute_dtype=cfg.compute_dtype)
    lp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(lp, 2, tgt[:, :, None])[:, :, 0]
    mask = (tgt != 0).float()
    return torch.sum(nll * mask), torch.sum(mask)


def _to_device(data: Dict, device) -> torch.Tensor:
    with record_function("place"):
        return torch.from_numpy(np.asarray(data["txt"])).to(device).long()


class Solver(BaseSolver):
    def __init__(self, config, paras, mode="train"):
        super().__init__(config, paras, mode)
        self.best_ppx = math.inf
        # the reference tracks best dev loss starting at 10
        self.best_loss = 10.0
        # what exec() ran: per train step its loss and grad norm as floats,
        # its tokens (B x L, padding included) and wall seconds (the step
        # ends in a device sync); the validation batches scored
        self.step_stats = []
        self.step_tokens = []
        self.step_seconds = []
        self.n_valid_batches = 0

    _shift_inputs = staticmethod(shift_inputs)

    def load_data(self):
        self.tr_set, self.dv_set, self.vocab_size, self.tokenizer, msg = \
            load_textset(self.paras.njobs, self.paras.gpu,
                         self.paras.pin_memory, self.config["data"]["corpus"],
                         self.config["data"]["text"], seed=self.paras.seed,
                         pad_multiple=self.n_data)
        self.verbose(msg)

    def set_model(self):
        hp = self.config["hparas"]
        self.lm_spec = LM.build_spec(self.vocab_size, **self.config["model"])
        self.params = LM.lm_init(
            torch.Generator().manual_seed(self.paras.seed), self.lm_spec,
            self.device)
        self.verbose("Model spec.| RNNLM weight tying = {}, # of layers = {}, "
                     "dim = {}".format(self.lm_spec.emb_tying,
                                       self.lm_spec.n_layers,
                                       self.lm_spec.dim))
        self.optimizer = O.build_optimizer(grad_clip=self.GRAD_CLIP, **hp)
        self.opt_state = self.optimizer.init(self.params)
        self.verbose(O.create_msg(**hp))
        if self.paras.load:
            self.load_ckpt()
        self.place_model()
        self.step_cfg = StepConfig(self.lm_spec, self.optimizer,
                                   self.compute_dtype, self.mesh,
                                   self.param_specs)
        # the step's randomness (the three dropouts), on the device, seeded for each
        # step by step_gen
        self.gen = torch.Generator(device=self.device)

    def exec(self):
        self.verbose("Total training steps {}.".format(
            human_format(self.max_step)))
        self.timer.set()

        while self.step < self.max_step:
            # host text batching runs ahead of the device
            for data in prefetch(iter(self.tr_set), size=2):
                self.timer.cnt("rd")
                self._profile_window()
                t0 = time.perf_counter()
                txt = _to_device(self.put_batch(data), self.device)
                self.params, self.opt_state, loss, gnorm = train_step(
                    self.step_cfg, self.params, self.opt_state, txt,
                    self.step_gen())
                self._sync()
                self.step_seconds.append(time.perf_counter() - t0)
                self.step_stats.append({"loss": float(loss),
                                        "gnorm": float(gnorm)})
                self.step_tokens.append(int(txt.numel()))
                self.step += 1
                self.timer.cnt("fw")

                if self.step == 1 or self.step % self.PROGRESS_STEP == 0:
                    loss_v = float(loss)
                    ppx = math.exp(min(loss_v, 50))
                    self.progress("Tr stat | Loss - {:.2f} | Grad. Norm - "
                                  "{:.2f} | {}".format(loss_v, float(gnorm),
                                                       self.timer.show()))
                    self.write_log("entropy", {"tr": loss_v})
                    self.write_log("perplexity", {"tr": ppx})

                if self.step % self.valid_step == 0:
                    self.validate()
                self.timer.set()
                if self.step >= self.max_step:
                    break

        self._profile_window(stop=True)
        self.ckpt_wait()
        self.log.close()
        self.verbose("Finished training after {} steps.".format(
            human_format(self.max_step)))

    def validate(self):
        total_nll, total_tok = 0.0, 0.0
        n_batches = len(self.dv_set)
        params = self.full_params()
        for i, data in enumerate(prefetch(iter(self.dv_set), size=2)):
            self.progress("Valid step - {}/{}".format(i + 1, n_batches))
            nll, cnt = valid_step(self.step_cfg, params, _to_device(
                self.put_batch(data), self.device))
            if self.mesh is not None:
                nll, cnt = self.mesh.global_sum(torch.stack([nll, cnt]))
            self.n_valid_batches += 1
            total_nll += float(nll)
            total_tok += float(cnt)
        dev_loss = total_nll / max(total_tok, 1.0)
        dev_ppx = math.exp(min(dev_loss, 50))
        self.verbose("Valid | dev loss {:.4f} | dev ppx {:.4f}".format(
            dev_loss, dev_ppx))
        self.write_log("entropy", {"dv": dev_loss})
        self.write_log("perplexity", {"dv": dev_ppx})
        if dev_loss < self.best_loss:
            self.best_loss = dev_loss
            self.best_ppx = dev_ppx
            self.save_checkpoint("best_ppx.pth", "ppx", dev_ppx)
        if self.step >= self.max_step:
            self.save_checkpoint("last_ppx.pth", "ppx", dev_ppx)
