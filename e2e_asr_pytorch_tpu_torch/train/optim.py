"""Adadelta, Adam, AdamW, SGD and RMSprop with the JAX package's optax
semantics, over a parameter dict (port of
e2e_asr_pytorch_tpu/train/optim.py).

``torch.optim`` cannot give those semantics (its RMSprop, for one, decays
by 0.99 and adds eps outside the square root). Every optimizer here is
optax's chain clip_by_global_norm(grad_clip) -> the rule ->
scale_by_learning_rate(schedule):

  Adadelta  add_decayed_weights -> scale_by_adadelta(rho=0.9, eps)
  Adam      scale_by_adam(b1=0.9, b2=0.999, eps), bias-corrected by the
            update count
  AdamW     scale_by_adam -> add_decayed_weights(weight_decay): the decay
            is decoupled, added after the Adam scaling
  SGD       nothing (no momentum): -lr * g
  RMSprop   scale_by_rms(decay=0.9, eps inside the square root, no bias
            correction): g / sqrt(nu + eps)

all with

  * float accumulators stored in ``optim_state_dtype`` (bf16 for the
    flagship) and the math in f32: cast on read, cast back on write;
  * the whole update (parameters, accumulators and the step count) skipped
    when the gradient's global norm is not finite;
  * the schedule read at the update count before it is incremented (the
    count optax's ``scale_by_learning_rate`` keeps).

The non-finite test and the schedule stay on the device (a 0-dim ``count``
tensor), so a step needs no host sync. On a mesh (``parallel/mesh.py``) the
step takes this rank's leaves of the reduced gradients, parameters and
state (a 'model' slice of the wide ones) and ``norm_fn``, the global norm
over the mesh: the clip and the skip are decided on the same reduced value
on every rank, and the elementwise update of a slice is the slice of the
update. The state is {"count": int64 0-dim}
plus the rule's accumulator trees, mirroring the parameters: "e_g", "e_x"
(Adadelta), "mu", "nu" (Adam, AdamW), "nu" (RMSprop), none (SGD).
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
RMS_DECAY = 0.9


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


class _Optimizer:
    """The frame every rule shares: clip_by_global_norm, the rule's update
    of each leaf (``_leaf``), the learning rate, and the skip of a step
    whose gradient norm is not finite. ``step`` updates the parameter
    tensors and the state's accumulators IN PLACE (the trees keep their
    tensors)."""

    ACCS = ()  # the names of the rule's accumulator trees

    def __init__(self, lr: float, eps: float = 1e-8,
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
        state = {"count": torch.zeros((), dtype=torch.int64, device=dev)}
        for name in self.ACCS:
            state[name] = tree_map(zeros, params)
        return state

    def _constants(self, count: torch.Tensor) -> Dict:
        """What every leaf's update reads at this count."""
        return {}

    def _leaf(self, p, g, accs, k):
        """(update u, new accumulators) of one leaf from its clipped f32
        gradient g and its accumulators read as f32; the parameter moves
        by -lr * u."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, params, grads, state, norm_fn=None) -> torch.Tensor:
        """One update; returns the gradients' global norm before clipping
        (``norm_fn(grads)`` when given: a mesh's norm over every rank's
        leaves)."""
        gnorm = global_norm(grads) if norm_fn is None else norm_fn(grads)
        ok = torch.isfinite(gnorm)
        # clip_by_global_norm: t if norm < clip else t / norm * clip
        clip_active = gnorm >= self.grad_clip
        step_size = -self.schedule(state["count"]).to(gnorm.device)
        k = self._constants(state["count"])

        def leaf(p, g, *accs):
            g = g.float()
            g = torch.where(clip_active, g / gnorm * self.grad_clip, g)
            u, new = self._leaf(p, g, [a.float() for a in accs], k)
            # the skipped update leaves everything as it was
            for a, n in zip(accs, new):
                a.copy_(torch.where(ok, n.to(a.dtype), a))
            new_p = (p.float() + step_size * u).to(p.dtype)
            p.copy_(torch.where(ok, new_p, p))

        tree_map(leaf, params, grads, *(state[n] for n in self.ACCS))
        state["count"].add_(ok.to(torch.int64))
        return gnorm


class Adadelta(_Optimizer):
    """optax.adadelta(rho=0.9, eps, weight_decay)."""

    ACCS = ("e_g", "e_x")

    def __init__(self, lr: float = 1.0, eps: float = 1e-8,
                 lr_scheduler: Optional[str] = "fixed",
                 weight_decay: float = 0.0, grad_clip: float = 5.0,
                 optim_state_dtype: Optional[str] = None):
        super().__init__(lr, eps, lr_scheduler, weight_decay, grad_clip,
                         optim_state_dtype)

    def _leaf(self, p, g, accs, k):
        e_g, e_x = accs
        if self.weight_decay:
            g = g + self.weight_decay * p.float()
        eg_new = (1.0 - RHO) * g ** 2 + RHO * e_g
        u = torch.sqrt(e_x + self.eps) / torch.sqrt(eg_new + self.eps) * g
        ex_new = (1.0 - RHO) * u ** 2 + RHO * e_x
        return u, (eg_new, ex_new)


class Adam(_Optimizer):
    """optax.adam(b1=0.9, b2=0.999, eps)."""

    ACCS = ("mu", "nu")

    def __init__(self, lr: float = 1e-3, eps: float = 1e-8,
                 lr_scheduler: Optional[str] = "fixed",
                 grad_clip: float = 5.0,
                 optim_state_dtype: Optional[str] = None):
        super().__init__(lr, eps, lr_scheduler, 0.0, grad_clip,
                         optim_state_dtype)

    def _constants(self, count):
        # bias correction at the incremented count, in f32 as optax does
        n = (count + 1).to(torch.float32)
        return {"corr1": 1.0 - torch.pow(torch.tensor(ADAM_B1,
                                                      device=n.device), n),
                "corr2": 1.0 - torch.pow(torch.tensor(ADAM_B2,
                                                      device=n.device), n)}

    def _leaf(self, p, g, accs, k):
        mu, nu = accs
        mu_new = (1.0 - ADAM_B1) * g + ADAM_B1 * mu
        nu_new = (1.0 - ADAM_B2) * g ** 2 + ADAM_B2 * nu
        u = (mu_new / k["corr1"]) / (torch.sqrt(nu_new / k["corr2"])
                                      + self.eps)
        return u, (mu_new, nu_new)


class AdamW(Adam):
    """optax.adamw(b1=0.9, b2=0.999, eps, weight_decay): Adam's update plus
    weight_decay * p, decoupled from the moments."""

    def __init__(self, lr: float = 1e-3, eps: float = 1e-8,
                 lr_scheduler: Optional[str] = "fixed",
                 weight_decay: float = 0.0, grad_clip: float = 5.0,
                 optim_state_dtype: Optional[str] = None):
        super().__init__(lr, eps, lr_scheduler, grad_clip, optim_state_dtype)
        self.weight_decay = float(weight_decay)

    def _leaf(self, p, g, accs, k):
        u, new = super()._leaf(p, g, accs, k)
        return u + self.weight_decay * p.float(), new


class SGD(_Optimizer):
    """optax.sgd without momentum: -lr * g."""

    def __init__(self, lr: float = 1e-2, lr_scheduler: Optional[str] = "fixed",
                 grad_clip: float = 5.0,
                 optim_state_dtype: Optional[str] = None):
        super().__init__(lr, 0.0, lr_scheduler, 0.0, grad_clip,
                         optim_state_dtype)

    def _leaf(self, p, g, accs, k):
        return g, ()


class RMSprop(_Optimizer):
    """optax.rmsprop(decay=0.9, eps): nu = 0.9 nu + 0.1 g^2, no bias
    correction, update g / sqrt(nu + eps)."""

    ACCS = ("nu",)

    def __init__(self, lr: float = 1e-2, eps: float = 1e-8,
                 lr_scheduler: Optional[str] = "fixed",
                 grad_clip: float = 5.0,
                 optim_state_dtype: Optional[str] = None):
        super().__init__(lr, eps, lr_scheduler, 0.0, grad_clip,
                         optim_state_dtype)

    def _leaf(self, p, g, accs, k):
        nu_new = (1.0 - RMS_DECAY) * g ** 2 + RMS_DECAY * accs[0]
        return torch.rsqrt(nu_new + self.eps) * g, (nu_new,)


def build_optimizer(optimizer: str = "Adadelta", lr: float = 1.0,
                    eps: float = 1e-8, lr_scheduler: str = "fixed",
                    weight_decay: float = 0.0, grad_clip: float = 5.0,
                    optim_state_dtype: Optional[str] = None,
                    **unused):
    """The optimizer from the YAML ``hparas`` block (extra keys ignored):
    Adadelta (the flagship ASR's), Adam (the LM's), AdamW, SGD or RMSprop,
    as the JAX package builds them (weight_decay reaches Adadelta and
    AdamW only)."""
    name = optimizer.lower()
    if name == "adadelta":
        return Adadelta(lr, eps, lr_scheduler, weight_decay, grad_clip,
                        optim_state_dtype)
    if name == "adam":
        return Adam(lr, eps, lr_scheduler, grad_clip, optim_state_dtype)
    if name == "adamw":
        return AdamW(lr, eps, lr_scheduler, weight_decay, grad_clip,
                     optim_state_dtype)
    if name == "sgd":
        return SGD(lr, lr_scheduler, grad_clip, optim_state_dtype)
    if name == "rmsprop":
        return RMSprop(lr, eps, lr_scheduler, grad_clip, optim_state_dtype)
    raise NotImplementedError("optimizer `{}`".format(optimizer))


def create_msg(optimizer: str, lr: float, lr_scheduler: str,
               tf_start: float = 1.0, tf_end: float = 1.0, **unused):
    return ["Optim.spec.| Algo. = {}\t| Lr = {}\t (schedule = {})| "
            "Scheduled sampling = {}".format(optimizer, lr, lr_scheduler,
                                             tf_end != 1)]
