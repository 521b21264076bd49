"""Adadelta and Adam with the JAX package's optax semantics, over a parameter
dict (port of e2e_asr_pytorch_tpu/train/optim.py; AdamW, SGD and RMSprop are
not ported).

``torch.optim`` cannot give those semantics. Adadelta's update here is
optax's chain clip_by_global_norm(grad_clip) -> add_decayed_weights ->
scale_by_adadelta(rho=0.9, eps) -> scale_by_learning_rate(schedule); Adam's
is clip_by_global_norm(grad_clip) -> scale_by_adam(b1=0.9, b2=0.999, eps,
bias-corrected by the update count) -> scale_by_learning_rate(schedule).
Both with

  * float accumulators stored in ``optim_state_dtype`` (bf16 for the
    flagship) and the math in f32: cast on read, cast back on write;
  * the whole update (parameters, accumulators and the step count) skipped
    when the gradient's global norm is not finite;
  * the schedule read at the update count before it is incremented.

The non-finite test and the schedule stay on the device (a 0-dim ``count``
tensor), so a step needs no host sync. Adadelta's state is
{"count": int64 0-dim, "e_g": tree, "e_x": tree}, Adam's {"count", "mu",
"nu"}, the trees mirroring the parameters.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from e2e_asr_pytorch_tpu_torch.convert import tree_leaves, tree_map

WARMUP_STEP = 4000.0
SELF_DEFINED_START = 100000   # first decay applies at this step
SELF_DEFINED_EVERY = 2000
SELF_DEFINED_FACTOR = 0.85
RHO = 0.9
ADAM_B1 = 0.9
ADAM_B2 = 0.999


def tf_rate_fn(tf_start: float = 1.0, tf_end: float = 1.0, tf_step: int = 1,
               tf_step_start: int = 0) -> Callable[[int], float]:
    """Scheduled-sampling teacher-forcing rate: linear tf_start -> tf_end
    over tf_step steps from tf_step_start."""
    def fn(step: int) -> float:
        if step < tf_step_start:
            return 1.0
        return max(tf_end, tf_start - (tf_start - tf_end)
                   * (step - tf_step_start) / tf_step)
    return fn


def lr_schedule(lr: float, lr_scheduler: Optional[str]) -> Callable:
    """step (0-dim tensor or int) -> learning rate ('fixed', 'warmup' (Noam,
    4000 steps) or 'self_defined' (x0.85 every 2k steps from step 100k))."""
    if lr_scheduler == "warmup":
        def noam(step):
            s = torch.as_tensor(step, dtype=torch.float32) + 1.0
            return lr * WARMUP_STEP ** 0.5 * torch.minimum(
                s * WARMUP_STEP ** -1.5, s ** -0.5)
        return noam
    if lr_scheduler == "self_defined":
        def decay(step):
            step = torch.as_tensor(step)
            decays = torch.clamp(
                torch.div(step, SELF_DEFINED_EVERY, rounding_mode="floor")
                - (SELF_DEFINED_START // SELF_DEFINED_EVERY - 1), min=0)
            return lr * torch.pow(torch.tensor(
                SELF_DEFINED_FACTOR, device=decays.device), decays.float())
        return decay
    return lambda step: torch.as_tensor(lr, dtype=torch.float32)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (f32, on the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


class Adadelta:
    """Functional Adadelta; ``step`` updates the parameter tensors and the
    state's accumulators IN PLACE (the trees keep their tensors)."""

    def __init__(self, lr: float = 1.0, eps: float = 1e-8,
                 lr_scheduler: Optional[str] = "fixed",
                 weight_decay: float = 0.0, grad_clip: float = 5.0,
                 optim_state_dtype: Optional[str] = None):
        self.schedule = lr_schedule(lr, lr_scheduler)
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.grad_clip = float(grad_clip)
        self.state_dtype = (getattr(torch, optim_state_dtype)
                            if optim_state_dtype else None)

    def init(self, params) -> Dict:
        def zeros(p):
            return torch.zeros_like(p, dtype=self.state_dtype or p.dtype)
        dev = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int64, device=dev),
                "e_g": tree_map(zeros, params), "e_x": tree_map(zeros, params)}

    @torch.no_grad()
    def step(self, params, grads, state) -> torch.Tensor:
        """One update; returns the gradients' global norm before clipping."""
        gnorm = global_norm(grads)
        ok = torch.isfinite(gnorm)
        # clip_by_global_norm: t if norm < clip else t / norm * clip
        clip_active = gnorm >= self.grad_clip
        step_size = -self.schedule(state["count"]).to(gnorm.device)
        one_minus_rho = 1.0 - RHO

        def leaf(p, g, e_g, e_x):
            g = g.float()
            g = torch.where(clip_active, g / gnorm * self.grad_clip, g)
            if self.weight_decay:
                g = g + self.weight_decay * p.float()
            eg_new = one_minus_rho * g ** 2 + RHO * e_g.float()
            u = torch.sqrt(e_x.float() + self.eps) / torch.sqrt(
                eg_new + self.eps) * g
            ex_new = one_minus_rho * u ** 2 + RHO * e_x.float()
            # the skipped update leaves everything as it was
            e_g.copy_(torch.where(ok, eg_new.to(e_g.dtype), e_g))
            e_x.copy_(torch.where(ok, ex_new.to(e_x.dtype), e_x))
            new_p = (p.float() + step_size * u).to(p.dtype)
            p.copy_(torch.where(ok, new_p, p))

        tree_map(leaf, params, grads, state["e_g"], state["e_x"])
        state["count"].add_(ok.to(torch.int64))
        return gnorm


class Adam:
    """Functional Adam (optax.adam); ``step`` updates the parameter tensors
    and the state's moments IN PLACE (the trees keep their tensors)."""

    def __init__(self, lr: float = 1e-3, eps: float = 1e-8,
                 lr_scheduler: Optional[str] = "fixed",
                 grad_clip: float = 5.0,
                 optim_state_dtype: Optional[str] = None):
        self.schedule = lr_schedule(lr, lr_scheduler)
        self.eps = float(eps)
        self.grad_clip = float(grad_clip)
        self.state_dtype = (getattr(torch, optim_state_dtype)
                            if optim_state_dtype else None)

    def init(self, params) -> Dict:
        def zeros(p):
            return torch.zeros_like(p, dtype=self.state_dtype or p.dtype)
        dev = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int64, device=dev),
                "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def step(self, params, grads, state) -> torch.Tensor:
        """One update; returns the gradients' global norm before clipping."""
        gnorm = global_norm(grads)
        ok = torch.isfinite(gnorm)
        clip_active = gnorm >= self.grad_clip
        step_size = -self.schedule(state["count"]).to(gnorm.device)
        # bias correction at the incremented count, in f32 as optax does
        n = (state["count"] + 1).to(torch.float32)
        corr1 = 1.0 - torch.pow(torch.tensor(ADAM_B1, device=n.device), n)
        corr2 = 1.0 - torch.pow(torch.tensor(ADAM_B2, device=n.device), n)

        def leaf(p, g, mu, nu):
            g = g.float()
            g = torch.where(clip_active, g / gnorm * self.grad_clip, g)
            mu_new = (1.0 - ADAM_B1) * g + ADAM_B1 * mu.float()
            nu_new = (1.0 - ADAM_B2) * g ** 2 + ADAM_B2 * nu.float()
            u = (mu_new / corr1) / (torch.sqrt(nu_new / corr2) + self.eps)
            # the skipped update leaves everything as it was
            mu.copy_(torch.where(ok, mu_new.to(mu.dtype), mu))
            nu.copy_(torch.where(ok, nu_new.to(nu.dtype), nu))
            new_p = (p.float() + step_size * u).to(p.dtype)
            p.copy_(torch.where(ok, new_p, p))

        tree_map(leaf, params, grads, state["mu"], state["nu"])
        state["count"].add_(ok.to(torch.int64))
        return gnorm


def build_optimizer(optimizer: str = "Adadelta", lr: float = 1.0,
                    eps: float = 1e-8, lr_scheduler: str = "fixed",
                    weight_decay: float = 0.0, grad_clip: float = 5.0,
                    optim_state_dtype: Optional[str] = None,
                    **unused):
    """The optimizer from the YAML ``hparas`` block (extra keys ignored):
    Adadelta (the flagship ASR's) or Adam (the LM's)."""
    name = optimizer.lower()
    if name == "adadelta":
        return Adadelta(lr, eps, lr_scheduler, weight_decay, grad_clip,
                        optim_state_dtype)
    if name == "adam":
        return Adam(lr, eps, lr_scheduler, grad_clip, optim_state_dtype)
    raise NotImplementedError(
        "optimizer `{}` is not ported yet (ROADMAP: training runtime); only "
        "Adadelta and Adam are".format(optimizer))


def create_msg(optimizer: str, lr: float, lr_scheduler: str,
               tf_start: float = 1.0, tf_end: float = 1.0, **unused):
    return ["Optim.spec.| Algo. = {}\t| Lr = {}\t (schedule = {})| "
            "Scheduled sampling = {}".format(optimizer, lr, lr_scheduler,
                                             tf_end != 1)]
