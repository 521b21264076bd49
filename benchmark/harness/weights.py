"""Weights made on the card from the seed, in one draw, as a table of
leaves gives them: ``(path, shape, init)`` with ``init`` one of

  ("normal", std)      N(0, std^2)
  ("zeros",)           0
  ("ones",)            1
  ("forget", hidden)   0 but for the LSTM forget gate's block (gate order
                       i, f, g, o), which is 1

Both sides get the same tensors: the program's leaves are filled in place
from them, the reference starts from a fresh copy made again from the
seed. ``flatten`` names a nested dict / list tree's leaves by dotted path
("rnn.0.w_x"), the names the tables use.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

WEIGHT_STREAM = 7


def flatten(tree, prefix: str = "") -> Dict:
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(flatten(v, "{}{}".format(prefix + "." if prefix else "",
                                            k)))
    return out


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make(table: List[Tuple], seed: int, device) -> Dict:
    """{path: f32 tensor on ``device``} from one draw of a generator on the
    device seeded from ``seed``."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + WEIGHT_STREAM) % 2 ** 63)
    total = sum(numel(shape) for _, shape, _ in table)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for path, shape, init in table:
        n = numel(shape)
        x = flat[off:off + n].view(shape)
        off += n
        if init[0] == "normal":
            out[path] = x * init[1]
        elif init[0] == "zeros":
            out[path] = torch.zeros(shape, device=device)
        elif init[0] == "ones":
            out[path] = torch.ones(shape, device=device)
        elif init[0] == "forget":
            h = init[1]
            b = torch.zeros(shape, device=device)
            b[h:2 * h] = 1.0
            out[path] = b
        else:
            raise ValueError("unknown init {!r} of {}".format(init, path))
    return out


def install(tree, made: Dict):
    """Fill the program's leaves in place from ``made``; the two must name
    the same leaves with the same shapes."""
    import torch
    leaves = flatten(tree)
    if set(leaves) != set(made):
        raise KeyError("the program's leaves and the table differ: only in "
                       "the program {}, only in the table {}".format(
                           sorted(set(leaves) - set(made))[:8],
                           sorted(set(made) - set(leaves))[:8]))
    with torch.no_grad():
        for path, leaf in leaves.items():
            if tuple(leaf.shape) != tuple(made[path].shape):
                raise ValueError("{}: program {} table {}".format(
                    path, tuple(leaf.shape), tuple(made[path].shape)))
            leaf.copy_(made[path])
