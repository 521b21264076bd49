"""Pieces the plain references share, in plain PyTorch: products at the
reference's precision or the control's, the LSTM recurrence, inverted
dropout from a seeded generator, and the optimizers with optax's
semantics (clip by global norm, then the rule, then -lr).

Precisions: "f32" is float32 with TF32 off (set by ``exact_matmuls``);
"fp8" is the control, every product's two operands rounded to float8
e4m3 with a per-tensor scale (the amax at 448) before an f32 product, the
gradient passing the rounding unchanged.
"""

from __future__ import annotations

from typing import Dict

import torch

FP8_MAX = 448.0


def exact_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return x
    if prec == "fp8":
        return _fp8(x)
    raise ValueError("precision {!r}".format(prec))


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return torch.matmul(operand(a, prec), operand(b, prec))


def keep_mask(shape, keep: float, gen, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) < keep


def dropout(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    keep = 1.0 - rate
    return x * keep_mask(x.shape, keep, gen, x.device) / keep


def lstm_seq(xg: torch.Tensor, w_h: torch.Tensor, prec: str,
             reverse: bool = False) -> torch.Tensor:
    """h over a time-major gate stream xg (T,B,4H) = x @ w_x + b from zero
    state, gate order i, f, g, o: c' = f c + i g, h' = o tanh(c')."""
    t_len, b, four_h = xg.shape
    hid = four_h // 4
    w = operand(w_h, prec)
    h = xg.new_zeros(b, hid)
    c = xg.new_zeros(b, hid)
    ys = [None] * t_len
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        g = xg[t] + torch.matmul(operand(h, prec), w)
        i = torch.sigmoid(g[:, :hid])
        f = torch.sigmoid(g[:, hid:2 * hid])
        gg = torch.tanh(g[:, 2 * hid:3 * hid])
        o = torch.sigmoid(g[:, 3 * hid:])
        c = f * c + i * gg
        h = o * torch.tanh(c)
        ys[t] = h
    return torch.stack(ys)


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values()))


def clip(grads: Dict[str, torch.Tensor], max_norm: float):
    """optax clip_by_global_norm: g if norm < max else g / norm * max."""
    n = global_norm(grads)
    if float(n) >= max_norm:
        return {k: (g.double() / n * max_norm).float()
                for k, g in grads.items()}, n
    return grads, n


class Adam:
    """optax.adam(b1=0.9, b2=0.999, eps), bias-corrected by the count."""

    def __init__(self, lr: float, eps: float):
        self.lr, self.eps, self.n = lr, eps, 0
        self.mu, self.nu = {}, {}

    def update(self, w: Dict, g: Dict):
        self.n += 1
        c1, c2 = 1 - 0.9 ** self.n, 1 - 0.999 ** self.n
        for k in w:
            self.mu[k] = 0.1 * g[k] + 0.9 * self.mu.get(k, 0.0)
            self.nu[k] = 0.001 * g[k] ** 2 + 0.999 * self.nu.get(k, 0.0)
            u = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)
            w[k] = w[k] - self.lr * u


class Adadelta:
    """optax.adadelta(rho=0.9, eps) with the accumulators stored in
    ``state_dtype`` between steps (the math in f32)."""

    def __init__(self, lr: float, eps: float, state_dtype=torch.float32,
                 weight_decay: float = 0.0):
        self.lr, self.eps, self.dtype = lr, eps, state_dtype
        self.wd = weight_decay
        self.eg, self.ex = {}, {}

    def update(self, w: Dict, g: Dict):
        for k in w:
            gk = g[k] + self.wd * w[k] if self.wd else g[k]
            eg = self.eg.get(k)
            ex = self.ex.get(k)
            eg = 0.1 * gk ** 2 + (0.9 * eg.float() if eg is not None else 0.0)
            ex0 = ex.float() if ex is not None else torch.zeros_like(gk)
            u = torch.sqrt(ex0 + self.eps) / torch.sqrt(eg + self.eps) * gk
            ex = 0.1 * u ** 2 + 0.9 * ex0
            self.eg[k], self.ex[k] = eg.to(self.dtype), ex.to(self.dtype)
            w[k] = w[k] - self.lr * u


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tree)
    norms = torch.stack([torch.linalg.vector_norm(tree[k].double())
                         for k in names]).cpu().tolist()
    return dict(zip(names, norms))
