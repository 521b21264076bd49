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

The one exception is the VGG conv weights: HWIO in the JAX frontend
(kernel height over time, width over frequency), OIHW here for
``torch.nn.functional.conv2d`` on (B,C,T,F).

``from_jax_opt_state`` does the same for the JAX optax Adadelta or Adam
state, whose accumulators mirror the parameter tree.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_conv(key, value) -> bool:
    return key == "w" and np.ndim(value) == 4


def from_jax_params(tree, device=None):
    """numpy tree (JAX layouts) -> torch tree (port layouts) on ``device``."""
    def conv(node):
        if isinstance(node, dict):
            out = {}
            for key, value in node.items():
                if _is_conv(key, value):
                    value = np.transpose(np.asarray(value), (3, 2, 0, 1))
                out[key] = conv(value)
            return out
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        arr = np.array(node, copy=True)
        if arr.dtype.name == "bfloat16":  # ml_dtypes: same bits, via int16
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)
    return tree_to(conv(tree), device)


def from_jax_opt_state(state, device=None):
    """The JAX package's Adadelta or Adam optimizer state (a tree of numpy
    arrays, ``jax.tree.map(np.asarray, opt_state)``) -> the port's
    {"count", "e_g", "e_x"} or {"count", "mu", "nu"} (``train/optim.py``),
    with the accumulators in port layouts and their stored dtype kept.

    The JAX state is optax's chain (clip_by_global_norm, then
    add_decayed_weights + scale_by_adadelta or scale_by_adam, then
    scale_by_learning_rate) possibly wrapped by the accumulator cast and the
    non-finite skip: the first node with ``e_g`` and ``e_x`` (Adadelta) or
    ``mu`` and ``nu`` (Adam) holds the accumulators and the first with
    ``count`` the update count."""
    found = {}

    def walk(node):
        if hasattr(node, "_fields"):                  # a NamedTuple state
            names = node._fields
            for a, b in (("e_g", "e_x"), ("mu", "nu")):
                if a in names and b in names and "acc" not in found:
                    found["acc"] = {a: getattr(node, a), b: getattr(node, b)}
            if "count" in names and "count" not in found:
                found["count"] = node.count
            for v in node:
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(state)
    if not {"acc", "count"} <= set(found):
        raise ValueError("not an optax Adadelta or Adam state: found {}"
                         .format(sorted(found)))
    out = {"count": tree_to(torch.tensor(int(np.asarray(found["count"])),
                                         dtype=torch.int64), device)}
    for name, tree in found["acc"].items():
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
