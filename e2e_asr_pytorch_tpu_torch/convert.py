"""Carry JAX parameter trees into the port, and move trees between devices.

``from_jax_params`` takes the JAX package's ASR or LM parameters as a nested
dict/list of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns
the same tree of torch tensors. The port keeps the JAX layouts, so nearly
every leaf is ``torch.from_numpy`` of a copy:

  lstm         w_x (in,4H), w_h (H,4H), b (4H,); gate order i,f,g,o
  gru          w_x (in,3H), w_h (H,3H), b_x, b_h (3H,); gate order r,z,n
  ligru        w_x (in,2H), w_h (H,2H), bn_scale, bn_bias (2H,); order z,a
  espnet_linear  {w (in,out), b (out,)}
  loc_conv     w (kw,N,Kn) taps; loc_proj w (Kn,D)
  embeddings   pre_embed / emb (V,E)
  emb_plugin   net1, net2 as espnet_linear; fuse_lambda, temp (1,) or
               (V,); emb_table (V,D), absent with on-line BERT targets

The one exception is the VGG conv weights: HWIO in the JAX frontend
(kernel height over time, width over frequency), OIHW here for
``torch.nn.functional.conv2d`` on (B,C,T,F).

``from_jax_opt_state`` does the same for the JAX optax Adadelta, Adam,
AdamW, SGD or RMSprop state, whose accumulators mirror the parameter tree,
and ``restore_lists`` brings a checkpoint file's state-dict form back to
the port's lists.
"""

from __future__ import annotations

import numpy as np
import torch


class BF16Bits:
    """A bfloat16 array as its int16 bits (numpy has no bfloat16 without
    ml_dtypes): what the port's checkpoint reader gives for one."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits


def _is_conv(key, value) -> bool:
    return key == "w" and np.ndim(value.bits if isinstance(value, BF16Bits)
                                  else value) == 4


def _hwio_to_oihw(value):
    if isinstance(value, BF16Bits):
        return BF16Bits(np.transpose(value.bits, (3, 2, 0, 1)))
    return np.transpose(np.asarray(value), (3, 2, 0, 1))


def from_jax_params(tree, device=None):
    """numpy tree (JAX layouts) -> torch tree (port layouts) on ``device``."""
    def conv(node):
        if isinstance(node, dict):
            out = {}
            for key, value in node.items():
                if _is_conv(key, value):
                    value = _hwio_to_oihw(value)
                out[key] = conv(value)
            return out
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if isinstance(node, BF16Bits):
            return torch.from_numpy(np.array(node.bits, copy=True)).view(
                torch.bfloat16)
        arr = np.array(node, copy=True)
        if arr.dtype.name == "bfloat16":  # ml_dtypes: same bits, via int16
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)
    return tree_to(conv(tree), device)


def restore_lists(node, template):
    """A tree in flax's state-dict form (what a JAX checkpoint file holds:
    lists and tuples written as dicts keyed '0', '1', ...) back in the form
    of ``template``, the port's own tree (``asr_init`` / ``lm_init``): its
    dicts stay dicts and its lists become lists again. A missing or extra
    key raises."""
    if not isinstance(template, (dict, list, tuple)):
        return node
    keys = (list(template) if isinstance(template, dict)
            else [str(i) for i in range(len(template))])
    if not isinstance(node, dict) or set(node) != set(keys):
        raise ValueError("the checkpoint's tree has keys {} where the model "
                         "has {}".format(sorted(node) if isinstance(node, dict)
                                         else type(node).__name__, keys))
    if isinstance(template, dict):
        return {k: restore_lists(node[k], v) for k, v in template.items()}
    return [restore_lists(node[k], t) for k, t in zip(keys, template)]


# the accumulator trees of each optax state the port reads, in the order a
# node is tried: Adadelta's, Adam's / AdamW's, RMSprop's
_ACCS = (("e_g", "e_x"), ("mu", "nu"), ("nu",))


def from_jax_opt_state(state, device=None, template=None):
    """The JAX package's optimizer state -> the port's (``train/optim.py``):
    {"count", "e_g", "e_x"} (Adadelta), {"count", "mu", "nu"} (Adam,
    AdamW), {"count", "nu"} (RMSprop) or {"count"} (SGD), the accumulators
    in port layouts with their stored dtype kept.

    ``state`` is the optax state as a tree of numpy arrays
    (``jax.tree.map(np.asarray, opt_state)``, NamedTuples kept), or its
    state-dict form from a checkpoint file (NamedTuples and tuples as
    dicts), for which ``template``, the port's parameter tree, gives the
    accumulators their lists back. The state is optax's chain
    (clip_by_global_norm, the rule, scale_by_learning_rate), possibly
    wrapped by the accumulator cast and the non-finite skip: the first node
    holding a rule's accumulators holds them, and the first with ``count``
    the update count."""
    found = {}

    def fields(node):
        if hasattr(node, "_fields"):                  # a NamedTuple state
            return {k: getattr(node, k) for k in node._fields}
        if isinstance(node, dict):
            return node
        return None

    def walk(node):
        f = fields(node)
        if f is not None:
            for names in _ACCS:
                if "acc" not in found and all(n in f for n in names):
                    found["acc"] = {n: f[n] for n in names}
            if "count" in f and "count" not in found:
                found["count"] = f["count"]
            children = f.values()
        elif isinstance(node, (list, tuple)):
            children = node
        else:
            return
        for v in children:
            walk(v)
    walk(state)
    if "count" not in found:
        raise ValueError("not an optax Adadelta, Adam, AdamW, SGD or RMSprop "
                         "state: found {}".format(sorted(found)))
    out = {"count": tree_to(torch.tensor(int(np.asarray(found["count"])),
                                         dtype=torch.int64), device)}
    for name, tree in found.get("acc", {}).items():
        if template is not None:
            tree = restore_lists(tree, template)
        out[name] = from_jax_params(tree, device)
    return out


def tree_map(fn, *trees):
    """``fn`` over the leaves of one or more nested dict/list trees of the
    same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_to(tree, device):
    """Move every tensor leaf of a nested dict/list to ``device``."""
    if device is None:
        return tree
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


# leaves that are only ever read through ``.to(compute_dtype)`` (or, by the
# recurrence kernels, ``.to(bfloat16)``) as a matmul or conv operand:
# espnet_linear / conv / loc taps "w", LSTM / GRU / liGRU "w_x"/"w_h". The
# GRU's b_x/b_h and the liGRU's bn_scale/bn_bias are added in f32 and stay.
MATMUL_WEIGHTS = ("w", "w_x", "w_h")


def cast_matmul_weights(tree, dtype):
    """Cast the matmul/conv weight leaves to ``dtype`` once, so the per-use
    ``.to(compute_dtype)`` is a no-op instead of a cast every decode step.
    Values are exactly what the per-use cast gives; biases, LayerNorm
    parameters and embeddings keep their f32."""
    if isinstance(tree, dict):
        return {k: (v.to(dtype) if k in MATMUL_WEIGHTS
                    and isinstance(v, torch.Tensor)
                    else cast_matmul_weights(v, dtype))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_matmul_weights(v, dtype) for v in tree)
    return tree


def tree_leaves(tree):
    """All tensor leaves of a nested dict/list, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
