"""Plain reference of the character RNN LM's training step (the upstream
recipe's RNNLM: a tied embedding, stacked LSTMs, dropout on the embedding,
between the layers and before the projection, the masked cross entropy
of <sos>-shifted text, Adam with the global norm clipped at 5).

Float32 throughout ("f32") or with every product's operands rounded to
float8 ("fp8", the control). Its readings are those of
``harness/compare.py``: the loss of each step, each leaf's clipped first
gradient and each leaf's change after the steps.

Draw order of the dropout masks, one ``torch.rand`` of the stream's shape
each, from the step's generator: the embedded input, the output of every
layer but the last, the top output.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from reference.common import (Adam, clip, dropout, exact_matmuls, leaf_norms,
                              lstm_seq, mm)


def param_table(model: Dict, vocab: int):
    """(path, shape, init) of every leaf, in the upstream model's inits:
    the embedding N(0, 1), each LSTM's w_x N(0, 1/in), w_h N(0, 1/H), b 0."""
    emb, hid = model["emb_dim"], model["dim"]
    table = [("emb", (vocab, emb), ("normal", 1.0))]
    d = emb
    for layer in range(model["n_layers"]):
        p = "rnn.{}.".format(layer)
        table += [(p + "w_x", (d, 4 * hid), ("normal", d ** -0.5)),
                  (p + "w_h", (hid, 4 * hid), ("normal", hid ** -0.5)),
                  (p + "b", (4 * hid,), ("zeros",))]
        d = hid
    return table


def loss_fn(w: Dict, model: Dict, txt: torch.Tensor, gen,
            prec: str = "f32") -> torch.Tensor:
    """Masked cross entropy of one (B,L) batch (0 = <pad>), predicting
    txt from <sos> (id 0) + txt[:, :-1]."""
    rate = model["dropout"]
    inp = torch.nn.functional.pad(txt, (1, 0))[:, :-1]
    x = dropout(w["emb"][inp], rate, gen)
    n = model["n_layers"]
    x = x.transpose(0, 1)                                  # (L,B,D)
    for layer in range(n):
        p = "rnn.{}.".format(layer)
        xg = mm(x, w[p + "w_x"], prec) + w[p + "b"]
        x = lstm_seq(xg, w[p + "w_h"], prec)
        if layer < n - 1:
            x = dropout(x.transpose(0, 1), rate, gen).transpose(0, 1)
    x = dropout(x.transpose(0, 1), rate, gen)              # (B,L,H)
    logits = mm(x, w["emb"].t(), prec)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 2, txt[:, :, None])[:, :, 0]
    mask = (txt != 0).float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def readings(w0: Dict, model: Dict, hparas: Dict, batches: List,
             gen_seeds: List[int], prec: str = "f32",
             grad_clip: float = 5.0) -> Dict:
    """The first len(batches) steps of Adam from ``w0`` on the given (B,L)
    token batches and generator seeds."""
    exact_matmuls()
    device = batches[0].device
    w = {k: v.detach().clone() for k, v in w0.items()}
    opt = Adam(float(hparas["lr"]), float(hparas["eps"]))
    losses, grad1 = [], None
    for txt, gs in zip(batches, gen_seeds):
        gen = torch.Generator(device=device).manual_seed(gs)
        leaves = {k: v.requires_grad_() for k, v in w.items()}
        loss = loss_fn(leaves, model, txt, gen, prec)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        losses.append(float(loss.detach()))
        grads, _ = clip(grads, grad_clip)
        if grad1 is None:
            grad1 = leaf_norms(grads)
        w = {k: v.detach() for k, v in w.items()}
        opt.update(w, grads)
        del loss, leaves, grads
    delta = leaf_norms({k: w[k] - w0[k] for k in w})
    return {"loss": losses, "grad1": grad1, "delta3": delta}
