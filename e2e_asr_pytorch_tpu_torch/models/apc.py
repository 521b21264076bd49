"""Autoregressive Predictive Coding (APC) upstream feature extractor (port
of e2e_asr_pytorch_tpu/models/apc.py).

APC (Chung et al., 2019) is a stack of unidirectional LSTMs over log-mel
features trained to predict the features ``time_shift`` frames ahead with an
L1 objective; the last layer's hidden states are the representation that
``--upstream apc`` (``data/upstream.py``) feeds the ASR model.

Each layer computes what the JAX package's scan form of an LSTM layer
computes: the input projection emitted in f32 with an f32 bias (the
``preferred_element_type=float32`` product), then bf16(h) @ bf16(w_h) with
f32 sums and f32 carries from a zero state at bf16, plain f32 at f32. At
bf16 that recurrence is K5's contract, so it runs through
``ops/rnn.py lstm_layer_kernel`` on the f32 stream (``xg_f32``): K5f
forward and K5b backward under autograd on a CUDA tensor, their plain
versions on a CPU one. A CUDA tensor at f32 takes K5 too, whose h and w_h
operands are bf16 whatever the dtype, as in every LSTM layer of the port;
a CPU tensor at f32 takes the plain f32 loop (``ops/rnn.py lstm_layer``).

Checkpoints are the JAX package's ``.npz`` layout (``spec``, ``dropout``,
``layer%d/<leaf>``, ``head/<leaf>``), read and written with numpy alone, so
a checkpoint of either package loads in the other.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from e2e_asr_pytorch_tpu_torch.convert import tree_leaves, tree_map, tree_to
from e2e_asr_pytorch_tpu_torch.ops import rnn as R
from e2e_asr_pytorch_tpu_torch.ops.audio import (FeatureConfig,
                                                 extract_features)
from e2e_asr_pytorch_tpu_torch.train import optim as O


class APCSpec(NamedTuple):
    input_dim: int = 80      # log-mel bank size
    hidden: int = 512
    n_layers: int = 3
    time_shift: int = 3      # predict n frames ahead
    dropout: float = 0.0

    @property
    def feature_config(self) -> FeatureConfig:
        return FeatureConfig(feat_type="fbank", feat_dim=self.input_dim,
                             delta_order=0, apply_cmvn=True)


def apc_init(gen: torch.Generator, spec: APCSpec, device=None) -> Dict:
    layers = []
    in_dim = spec.input_dim
    for _ in range(spec.n_layers):
        layers.append(R.lstm_init(gen, in_dim, spec.hidden))
        in_dim = spec.hidden
    head = R.espnet_linear_init(gen, spec.hidden, spec.input_dim)
    return tree_to({"layers": layers, "head": head}, device)


def apc_layer(params: Dict, x: torch.Tensor,
              compute_dtype=torch.float32) -> torch.Tensor:
    """One forward LSTM layer over (B,T,D) from a zero state -> (B,T,H) f32,
    xg emitted in f32 with the f32 bias: the kernel route on the card or at
    bf16, the plain f32 loop on the CPU at f32."""
    if x.is_cuda or compute_dtype != torch.float32:
        return R.lstm_layer_kernel(params, x, compute_dtype=compute_dtype,
                                   xg_f32=True)
    return R.lstm_layer(params, x, compute_dtype=compute_dtype)[0]


def apc_encode(params: Dict, spec: APCSpec, feat: torch.Tensor,
               train: bool = False, gen: Optional[torch.Generator] = None,
               compute_dtype=torch.float32) -> torch.Tensor:
    """(B,T,input_dim) features -> (B,T,hidden) last-layer hidden states;
    in training, dropout between layers with masks drawn from ``gen``."""
    outs = feat
    for l, p in enumerate(params["layers"]):
        outs = apc_layer(p, outs, compute_dtype)
        if train and spec.dropout > 0 and l < spec.n_layers - 1 \
                and gen is not None:
            outs = R.dropout(outs, spec.dropout, gen)
    return outs


def apc_loss(params: Dict, spec: APCSpec, feat: torch.Tensor,
             feat_len: torch.Tensor, train: bool = True,
             gen: Optional[torch.Generator] = None,
             compute_dtype=torch.float32) -> torch.Tensor:
    """Masked L1 between head(hidden[t]) and feat[t + time_shift]."""
    h = apc_encode(params, spec, feat, train=train, gen=gen,
                   compute_dtype=compute_dtype)
    pred = R.linear(params["head"], h, compute_dtype)
    n = spec.time_shift
    err = (pred[:, :-n] - feat[:, n:]).abs()
    t = err.shape[1]
    # frame t is supervised iff t + n is a real frame
    valid = (torch.arange(t, device=feat.device)[None, :]
             < (feat_len[:, None] - n))
    err = err * valid[:, :, None]
    denom = torch.clamp(valid.sum(), min=1) * feat.shape[-1]
    return err.sum() / denom


def make_upstream(params: Dict, spec: APCSpec):
    """The (wav (B,S) f32, wav_len (B,)) -> (feat (B,T,hidden) f32,
    feat_len) upstream callable: log-mel + CMVN, then the APC stack at bf16
    under ``torch.no_grad()``. The weights are constants, moved once to each
    device the callable sees."""
    cfg = spec.feature_config
    on_device = {}

    def apc_upstream(wav, wav_len):
        dev = wav.device
        if dev not in on_device:
            on_device[dev] = tree_map(lambda p: p.detach().to(dev), params)
        with torch.no_grad():
            feat, feat_len = extract_features(cfg, wav, wav_len)
            reps = apc_encode(on_device[dev], spec, feat, train=False,
                              compute_dtype=torch.bfloat16)
        return reps.float(), feat_len

    return apc_upstream


# ------------------------------------------------------------ persistence

def save_apc(path: str, params: Dict, spec: APCSpec) -> None:
    flat = {"spec": np.array([spec.input_dim, spec.hidden, spec.n_layers,
                              spec.time_shift], np.int64),
            "dropout": np.float64(spec.dropout)}
    for l, p in enumerate(params["layers"]):
        for k, v in p.items():
            flat["layer%d/%s" % (l, k)] = v.detach().float().cpu().numpy()
    for k, v in params["head"].items():
        flat["head/%s" % k] = v.detach().float().cpu().numpy()
    np.savez(path, **flat)


def load_apc(path: str, device=None) -> Tuple[Dict, APCSpec]:
    z = np.load(path)
    si = z["spec"]
    spec = APCSpec(int(si[0]), int(si[1]), int(si[2]), int(si[3]),
                   float(z["dropout"]))
    layers = []
    for l in range(spec.n_layers):
        pre = "layer%d/" % l
        layers.append({k[len(pre):]: torch.from_numpy(np.array(z[k]))
                       for k in z.files if k.startswith(pre)})
    head = {k[5:]: torch.from_numpy(np.array(z[k])) for k in z.files
            if k.startswith("head/")}
    return tree_to({"layers": layers, "head": head}, device), spec


# --------------------------------------------------------------- training

def pretrain_apc(batches, spec: APCSpec, steps: int, lr: float = 1e-3,
                 seed: int = 0, log_every: int = 50, verbose=print,
                 device=None, params: Optional[Dict] = None) -> Dict:
    """Pretrain APC over an iterable of (wav (B,S) f32, wav_len (B,) int)
    host batches (cycled if exhausted), at bf16 with bare Adam (the
    solver's ``Adam`` without clipping: ``optax.adam``, but for its skip
    of a non-finite step), on ``device`` (the card when None). Starts from ``params`` when given,
    else from ``apc_init`` seeded with ``seed``. Returns the trained
    parameters (f32, on ``device``)."""
    device = torch.device("cuda" if device is None else device)
    cfg = spec.feature_config
    if params is None:
        params = apc_init(torch.Generator().manual_seed(seed), spec)
    params = tree_map(lambda p: p.detach().float().clone().to(device),
                      params)
    opt = O.Adam(lr, grad_clip=math.inf)
    state = opt.init(params)
    gen = torch.Generator(device=device)
    it = iter(batches)
    first_loss = last_loss = None
    for step in range(steps):
        try:
            wav, wav_len = next(it)
        except StopIteration:
            it = iter(batches)
            wav, wav_len = next(it)
        wav = torch.as_tensor(np.asarray(wav)).to(device)
        wav_len = torch.as_tensor(np.asarray(wav_len)).long().to(device)
        feat, feat_len = extract_features(cfg, wav, wav_len)
        gen.manual_seed((seed + 1) * 1000003 + step)
        leaves = tree_map(lambda p: p.requires_grad_(), params)
        with torch.enable_grad():
            loss = apc_loss(leaves, spec, feat, feat_len, train=True,
                            gen=gen, compute_dtype=torch.bfloat16)
            flat = tree_leaves(leaves)
            grads = iter(torch.autograd.grad(loss, flat))
        loss = loss.detach()
        for p in flat:
            p.requires_grad_(False)
        opt.step(params, tree_map(lambda _: next(grads), params), state)
        if step == 0:
            first_loss = float(loss)
        if step % log_every == 0 or step == steps - 1:
            last_loss = float(loss)
            verbose("APC pretrain step {}/{} | L1 {:.4f}".format(
                step + 1, steps, last_loss))
    if first_loss is not None and last_loss is not None:
        verbose("APC pretrain done: L1 {:.4f} -> {:.4f}".format(
            first_loss, last_loss))
    return params
