"""Word-embedding regularization / fusion plugin (port of
e2e_asr_pytorch_tpu/models/plugin.py).

An MLP maps decoder states into a pretrained embedding space; the auxiliary
loss is the CosEmb or MSE distance to the target embedding (pad-masked,
per-utterance length-normalized, weighted by ``utt_w`` over the batch);
optionally the decoder output distribution is fused with an
embedding-similarity distribution

  log((1-λ)·softmax(dec) + λ·softmax(relu(τ)·emb_logit))

with fixed / learnable / vocab-wise λ and τ.

Embedding targets come from a fasttext-format table or, when the ``bert``
key is set, from an on-line ``BertEmbeddingPredictor`` run on the host
(``models/bert_embedding.py``), whose (B,L,D) targets enter the step as
data. Fusion needs a static table and is refused in BERT mode.

The parameters are a plain dict that lives in the model's tree under
``emb_plugin``: ``net1``, ``net2`` ({w (in,out), b (out,)}), ``fuse_lambda``
and ``temp`` ((1,) or (V,)), and ``emb_table`` (V,D) in table mode. Where
the JAX package stops a gradient, the port detaches: a frozen table, a
fixed λ, a fixed τ and the BERT targets get no gradient, so the optimizer
leaves them as they are. Every product is f32, as in JAX.

As in the JAX package, the training loss projects the decoder states
without a random draw, so ``dropout:`` has no effect in training (ROADMAP
queue 3, F11).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from e2e_asr_pytorch_tpu_torch.ops.rnn import espnet_linear_init, linear


def load_embedding_table(tokenizer, path: str) -> np.ndarray:
    """Parse a fasttext-format text embedding file into a (V,D) table
    aligned with the tokenizer ids; unseen ids stay zero, <unk> gets the
    average of all OOV vectors, malformed rows are skipped."""
    with open(path, "r") as f:
        head = f.readline().strip().split()
        emb_dim = int(head[1])
        table = np.zeros((tokenizer.vocab_size, emb_dim), np.float32)
        unk_count = 0
        for line in f:
            vocab, _, emb = line.rstrip("\n").partition(" ")
            if not vocab or len(emb.split(" ")) != emb_dim:
                continue  # malformed row (e.g. a literal-space token)
            if vocab == "</s>":
                vocab = "<eos>"
            specials = {"<pad>": tokenizer.pad_idx, "<eos>": tokenizer.eos_idx,
                        "<unk>": tokenizer.unk_idx}
            if vocab in specials:
                idx = specials[vocab]
            else:
                idx = tokenizer.encode(vocab)[0]
            vec = np.asarray([float(x) for x in emb.split(" ")], np.float32)
            if idx == tokenizer.unk_idx:
                unk_count += 1
                table[idx] += vec
            else:
                table[idx] = vec
        if unk_count:
            table[tokenizer.unk_idx] /= unk_count
    return table


class EmbPluginSpec(NamedTuple):
    dim: int                 # embedding dim
    dec_dim: int
    distance: str            # 'CosEmb' | 'MSE'
    weight: float
    fuse: float              # 0 off, -1 learnable, -2 vocab-wise, else fixed
    temperature: float       # -1 learnable, -2 elementwise, else fixed
    freeze: bool
    fuse_normalize: bool
    dropout: float
    vocab_size: int

    @property
    def apply_fuse(self) -> bool:
        return self.fuse != 0

    @property
    def fuse_learnable(self) -> bool:
        return self.fuse in (-1, -2)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def _pad_mask(label: torch.Tensor, dtype) -> torch.Tensor:
    """1 at the real positions of a (B,L) label batch, 0 at <pad>."""
    return (label != 0).to(dtype)


class EmbeddingRegularizer:
    """The static spec and the target predictor; the parameters live in the
    model's tree (under 'emb_plugin'), so they train and are checkpointed
    with the model."""

    def __init__(self, spec: EmbPluginSpec, params: Dict, predictor=None):
        self.spec = spec
        self.params = params
        self.weight = spec.weight
        self.apply_fuse = spec.apply_fuse
        self.fuse_learnable = spec.fuse_learnable
        # on-line BERT target predictor (host); None = table targets
        self.predictor = predictor

    def predict_targets(self, label_np) -> Optional[np.ndarray]:
        """Host-side contextual target embeddings for a (B,L) id batch, or
        None when this plugin uses table targets."""
        if self.predictor is None:
            return None
        return self.predictor.predict(np.asarray(label_np)).astype(np.float32)

    def create_msg(self):
        msg = ["Plugin.    | Word embedding regularization enabled "
               "(type:{}, weight:{})".format(self.spec.distance, self.weight)]
        if self.apply_fuse:
            msg.append("           | Embedding-fusion decoder enabled "
                       "( temp. = {}, lambda = {} )".format(
                           self.spec.temperature, self.spec.fuse))
        return msg

    def get_weight(self, params=None) -> float:
        p = params or self.params
        if self.fuse_learnable:
            return float(torch.sigmoid(p["fuse_lambda"].float()).mean())
        return float(p["fuse_lambda"][0])

    def get_temp(self, params=None) -> float:
        p = params or self.params
        return float(torch.relu(p["temp"].float()).mean())

    def emb_project(self, params: Dict, dec_state: torch.Tensor,
                    gen=None, train: bool = False) -> torch.Tensor:
        """Decoder states (..., H) -> embedding space (..., D), in f32. In
        training with a generator the input is dropped out first."""
        x = dec_state
        if train and self.spec.dropout > 0 and gen is not None:
            keep = 1.0 - self.spec.dropout
            x = x * (torch.rand(x.shape, generator=gen, device=x.device)
                     < keep) / keep
        h = torch.relu(linear(params["net1"], x))
        return linear(params["net2"], h)

    def _table(self, params: Dict) -> torch.Tensor:
        table = params["emb_table"]
        return table.detach() if self.spec.freeze else table

    def fuse_prob(self, params: Dict, x_emb: torch.Tensor,
                  dec_logit: torch.Tensor) -> torch.Tensor:
        """log((1-λ) softmax(dec_logit) + λ softmax(relu(τ) emb_logit))."""
        table = self._table(params)
        if self.spec.fuse_normalize:
            x_n = x_emb / (_norm(x_emb)[..., None] + 1e-8)
            t_n = table / (_norm(table)[..., None] + 1e-8)
            emb_logit = torch.einsum("...d,vd->...v", x_n, t_n)
        else:
            emb_logit = torch.einsum("...d,vd->...v", x_emb, table)
        emb_prob = torch.softmax(self._temperature(params) * emb_logit, -1)
        dec_prob = torch.softmax(dec_logit.float(), -1)
        lam = self._lambda(params)
        fused = (1 - lam) * dec_prob + lam * emb_prob
        return torch.log(fused + 1e-8)

    def _temperature(self, params: Dict) -> torch.Tensor:
        """relu(τ); a fixed τ is a buffer (no gradient)."""
        temp = params["temp"]
        if self.spec.temperature not in (-1, -2):
            temp = temp.detach()
        return torch.relu(temp)

    def _lambda(self, params: Dict) -> torch.Tensor:
        """sigmoid(λ) when learnable; a fixed λ is a buffer."""
        lam = params["fuse_lambda"]
        return torch.sigmoid(lam) if self.fuse_learnable else lam.detach()

    def loss(self, params: Dict, dec_state: torch.Tensor,
             dec_logit: torch.Tensor, label: torch.Tensor,
             utt_w: Optional[torch.Tensor] = None,
             y_emb: Optional[torch.Tensor] = None,
             global_sum: Optional[Callable] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(emb regression loss, fused log-prob or None).

        dec_state: (B,L,H) decoder states; label: (B,L) target ids; utt_w:
        optional (B,) weights (0 = a padding row, excluded); y_emb: optional
        (B,L,D) precomputed contextual targets (the on-line BERT path),
        otherwise targets come from the table. ``global_sum`` sums the
        weights over the data-parallel ranks, so the loss is the weighted
        mean over the global batch (each rank's share of it)."""
        x_emb = self.emb_project(params, dec_state, train=True)
        if y_emb is None:
            y_emb = self._table(params)[label.long()]
        else:
            y_emb = y_emb.detach()
        if self.spec.distance == "CosEmb":
            num = torch.sum(x_emb * y_emb, -1)
            den = _norm(x_emb) * _norm(y_emb) + 1e-8
            per_pos = 1.0 - num / den
        elif self.spec.distance == "MSE":
            per_pos = torch.mean((x_emb - y_emb) ** 2, dim=-1)
        else:
            raise NotImplementedError(self.spec.distance)
        mask = _pad_mask(label, per_pos.dtype)
        per_utt = (torch.sum(per_pos * mask, -1)
                   / torch.clamp(mask.sum(-1), min=1.0))
        if utt_w is None:
            w_sum = torch.tensor(float(per_utt.shape[0]),
                                 device=per_utt.device)
            num_sum = per_utt.sum()
        else:
            w = utt_w.to(per_utt.dtype)
            w_sum = w.sum()
            num_sum = torch.sum(per_utt * w)
        if global_sum is not None:
            w_sum = global_sum(w_sum)
        loss = num_sum / (torch.clamp(w_sum, min=1.0) if utt_w is not None
                          else w_sum)
        fused = (self.fuse_prob(params, x_emb, dec_logit)
                 if self.apply_fuse else None)
        return loss, fused

    def fuse_step(self, params: Dict, dec_state: torch.Tensor,
                  dec_logit: torch.Tensor) -> torch.Tensor:
        """Inference-time fusion (decode path): (B,H),(B,V) -> log prob."""
        x_emb = self.emb_project(params, dec_state, train=False)
        return self.fuse_prob(params, x_emb, dec_logit)


def build(emb_cfg: Dict, tokenizer, dec_dim: int, gen: torch.Generator,
          device=None) -> EmbeddingRegularizer:
    """Construct from the YAML ``emb:`` block (the JAX package's keys); the
    parameters are drawn from ``gen`` and put on ``device``."""
    cfg = dict(emb_cfg)
    cfg.pop("enable", None)
    src = cfg.pop("src", None)
    bert = cfg.pop("bert", None)
    predictor = None
    if bert is not None:
        # `bert` flags the mode, `src` is the (fine-tuned) local model path
        from e2e_asr_pytorch_tpu_torch.models.bert_embedding import \
            BertEmbeddingPredictor
        if cfg.get("fuse", 0) != 0:
            raise ValueError("embedding fusion needs table targets; it is "
                             "unavailable with on-line BERT targets (same "
                             "restriction as the reference)")
        predictor = BertEmbeddingPredictor(src, tokenizer)
        vocab_size, emb_dim = tokenizer.vocab_size, predictor.hidden_size
        table = None
    else:
        table = load_embedding_table(tokenizer, src)
        vocab_size, emb_dim = table.shape
    spec = EmbPluginSpec(
        dim=emb_dim, dec_dim=dec_dim, distance=cfg.pop("distance", "CosEmb"),
        weight=cfg.pop("weight", 1.0), fuse=cfg.pop("fuse", 0),
        temperature=cfg.pop("temperature", 1.0),
        freeze=cfg.pop("freeze", True),
        fuse_normalize=cfg.pop("fuse_normalize", False),
        dropout=cfg.pop("dropout", 0.0), vocab_size=vocab_size)
    hidden = (emb_dim + dec_dim) // 2
    params = {
        "net1": espnet_linear_init(gen, dec_dim, hidden),
        "net2": espnet_linear_init(gen, hidden, emb_dim),
        "fuse_lambda": (torch.full((vocab_size,), 0.5) if spec.fuse == -2
                        else torch.tensor([0.5 if spec.fuse == -1
                                           else float(spec.fuse)])),
        "temp": (torch.ones(vocab_size) if spec.temperature == -2
                 else torch.tensor([1.0 if spec.temperature == -1
                                    else float(spec.temperature)])),
    }
    if table is not None:
        params["emb_table"] = torch.from_numpy(table)
    if device is not None:
        params = {k: (v.to(device) if isinstance(v, torch.Tensor)
                      else {n: t.to(device) for n, t in v.items()})
                  for k, v in params.items()}
    return EmbeddingRegularizer(spec, params, predictor=predictor)
