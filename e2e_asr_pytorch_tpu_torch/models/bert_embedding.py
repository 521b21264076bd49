"""BERT-based target embeddings for the embedding regularizer (the port's
own copy of e2e_asr_pytorch_tpu/models/bert_embedding.py, host torch code
already).

Wraps a fine-tuned masked-LM BERT, resizes its embeddings to a
sentencepiece vocab, and produces target embeddings as the sum of all
encoder layers' hidden states. Weights must exist locally (no network).
Two consumption modes:

  * ON-LINE: models/plugin.py holds the predictor and the training solver
    calls ``predict`` per batch on the host; the (B,L,D) contextual targets
    enter the step as data, so BERT itself never joins the trained model.
  * OFFLINE: ``embedding_table``/``export_fasttext_table`` dump a (V,D)
    per-token table once, consumed as a regular `src` table.
"""

from __future__ import annotations

import os

import numpy as np


class BertEmbeddingPredictor:
    """Lazily loads a local BertForMaskedLM; call ``embedding_table`` to
    export per-token target embeddings for the plugin."""

    def __init__(self, model_path: str, tokenizer):
        # transformers would otherwise import its TensorFlow and JAX / Flax
        # backends where they are installed: the port runs on torch alone
        os.environ.setdefault("USE_TF", "0")
        os.environ.setdefault("USE_FLAX", "0")
        try:
            import torch  # noqa: F401
            from transformers import BertForMaskedLM
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "BERT target embeddings need torch + transformers") from e
        from transformers import BertForMaskedLM
        self.model = BertForMaskedLM.from_pretrained(
            model_path, local_files_only=True, output_hidden_states=True)
        self.model.eval()
        self.tokenizer = tokenizer
        if hasattr(tokenizer, "spm"):
            # sentencepiece vocab: resize BERT's embedding matrix like the
            # reference (src/bert_embedding.py:23-30)
            self.model.resize_token_embeddings(tokenizer.vocab_size)

    @property
    def hidden_size(self) -> int:
        return int(self.model.config.hidden_size)

    def predict(self, token_ids: np.ndarray) -> np.ndarray:
        """(B,L) ids -> (B,L,D) summed-all-layers hidden states."""
        import torch
        with torch.no_grad():
            out = self.model(input_ids=torch.from_numpy(
                np.asarray(token_ids, np.int64)))
            return sum(out.hidden_states).numpy()

    def embedding_table(self) -> np.ndarray:
        """(V,D) per-token target table: each vocab id embedded in
        isolation. Export once, feed to models/plugin.py as `src`."""
        v = self.tokenizer.vocab_size
        ids = np.arange(v, dtype=np.int64)[:, None]
        chunks = [self.predict(ids[i:i + 256])[:, 0, :]
                  for i in range(0, v, 256)]
        return np.concatenate(chunks, axis=0)


def export_fasttext_table(predictor: BertEmbeddingPredictor, tokenizer,
                          out_path: str) -> None:
    """Write the BERT table in fasttext format for plugin.load_embedding_table."""
    table = predictor.embedding_table()
    with open(out_path, "w") as f:
        f.write("{} {}\n".format(*table.shape))
        for i in range(table.shape[0]):
            piece = (tokenizer.spm.id_to_piece(i)
                     if hasattr(tokenizer, "spm") else str(i))
            f.write(piece + " " + " ".join("%.5f" % x for x in table[i]) + "\n")
