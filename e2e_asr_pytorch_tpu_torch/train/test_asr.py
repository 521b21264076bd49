"""ASR test solver: batched greedy / beam decoding over dev + test sets (port
of e2e_asr_pytorch_tpu/train/test_asr.py).

Rebuilds the model from the training config pointed at by ``src:``, loads
the checkpoint (or uses the seeded init when none is set), decodes both
splits and writes ``<outdir>/<exp>_<split>_output.csv`` (idx/hyp/truth TSV)
plus ``_beam.csv`` (idx/beam/hyp/truth) when beam > 1, byte for byte in the
JAX solver's formats, which ``eval.py`` (the JAX package's, or this
package's own) reads. A beam > 1 runs the joint CTC / attention / LM beam
search, or for a CTC-only model (``ctc_weight: 1``) the CTC prefix beam
search with LM fusion.
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import torch

from e2e_asr_pytorch_tpu_torch.data.batching import prefetch
from e2e_asr_pytorch_tpu_torch.data.loaders import load_dataset
from e2e_asr_pytorch_tpu_torch.utils.config import load_config
from e2e_asr_pytorch_tpu_torch.convert import cast_matmul_weights
from e2e_asr_pytorch_tpu_torch.decode.beam import BeamConfig, beam_decode
from e2e_asr_pytorch_tpu_torch.decode.ctc_beam import (CTCBeamConfig,
                                                       ctc_beam_decode)
from e2e_asr_pytorch_tpu_torch.decode.greedy import greedy_decode
from e2e_asr_pytorch_tpu_torch.models import asr as M
from e2e_asr_pytorch_tpu_torch.models import encoder as E
from e2e_asr_pytorch_tpu_torch.models import lm as LM
from e2e_asr_pytorch_tpu_torch.ops.audio import (FeatureConfig,
                                                 extract_features)
from e2e_asr_pytorch_tpu_torch.train import checkpoint as ckpt_lib
from e2e_asr_pytorch_tpu_torch.train.solver import BaseSolver


class Solver(BaseSolver):
    def __init__(self, config, paras, mode):
        super().__init__(config, paras, mode)
        decode_cfg = dict(self.config["decode"])
        self.greedy = decode_cfg.get("beam_size", 1) == 1
        self.beam_size = decode_cfg.get("beam_size", 1)
        self.dec_ctc_weight = decode_cfg.get("ctc_weight", 0.0)
        self.lm_weight = decode_cfg.get("lm_weight", 0.0)
        self.lm_path = decode_cfg.get("lm_path", "")
        self.lm_config = decode_cfg.get("lm_config", "")
        self.min_len_ratio = decode_cfg.get("min_len_ratio", 0.0)
        self.max_len_ratio = decode_cfg.get("max_len_ratio", 1.0)
        self.output_file = os.path.join(
            paras.outdir, "{}_{{}}_{{}}.csv".format(self.exp_name))
        # what exec() decoded: real utterances, their seconds of audio, and
        # the wall seconds it took (data, features, encode, search, CSVs)
        self.n_utts = 0
        self.audio_seconds = 0.0
        self.decode_seconds = 0.0

    def load_data(self):
        if self.paras.upstream is not None:
            raise NotImplementedError(
                "--upstream features are not ported yet (ROADMAP: plugins "
                "and extras)")
        self.dv_set, self.tt_set, self.feat_dim, self.vocab_size, \
            self.tokenizer, msg = load_dataset(
                self.paras.njobs, self.paras.gpu, self.paras.pin_memory,
                False, **self.config["data"], mode="eval",
                seed=self.paras.seed, pad_multiple=1)
        self.verbose(msg)

    def set_model(self):
        audio_cfg = dict(self.config["data"].get("audio", {}))
        self.feat_cfg = FeatureConfig(**audio_cfg)
        self.spec = M.build_spec(self.feat_dim, self.vocab_size,
                                 **self.config["model"])
        if "emb" in self.config and self.config["emb"].get("enable"):
            raise NotImplementedError(
                "the embedding-fusion plugin is not ported yet (ROADMAP: "
                "joint CTC prefix scoring and emb-fusion in beam search)")
        if self.load_ckpt() is None:
            self.params = M.asr_init(
                torch.Generator().manual_seed(self.paras.seed), self.spec,
                self.device)
        self.params = cast_matmul_weights(self.params, self.compute_dtype)

        self.lm_params, self.lm_spec = None, None
        if self.lm_weight > 0:
            lm_cfg = load_config(self.lm_config)
            self.lm_spec = LM.build_spec(self.vocab_size, **lm_cfg["model"])
            ck = ckpt_lib.load_checkpoint(self.lm_path, self.device)
            self.lm_params = cast_matmul_weights(ck["model"],
                                                 self.compute_dtype)
            self.verbose("LM loaded from {} (ppx {:.2f})".format(
                self.lm_path, ck.get("metric_value", float("nan"))))

        msg = ["Decode spec| Beam size = {}\t| Min/Max len ratio = {}/{}"
               .format(self.beam_size, self.min_len_ratio, self.max_len_ratio)]
        if self.dec_ctc_weight > 0:
            msg.append("           |Joint CTC decoding enabled \t| weight = "
                       "{:.2f}".format(self.dec_ctc_weight))
        if self.lm_weight > 0:
            msg.append("           |Joint LM decoding enabled \t| weight = "
                       "{:.2f}\t| src = {}".format(self.lm_weight,
                                                  self.lm_path))
        self.verbose(msg)

    def _max_steps_for(self, n_samples: int) -> int:
        # the ratio applies to the INPUT feature frame count
        frames = self.feat_cfg.frames_for_samples(n_samples)
        return max(1, int(math.ceil(frames * self.max_len_ratio)))

    def exec(self):
        start = time.perf_counter()
        for s, ds in zip(["dev", "test"], [self.dv_set, self.tt_set]):
            out_path = self.output_file.format(s, "output")
            beam_path = self.output_file.format(s, "beam")
            with open(out_path, "w") as f:
                f.write("idx\thyp\ttruth\n")
            if self.greedy:
                self.verbose("Performing batch-wise greedy decoding on {} "
                             "set, num of batch = {}.".format(s, len(ds)))
            else:
                with open(beam_path, "w") as f:
                    f.write("idx\tbeam\thyp\ttruth\n")
                self.verbose("Performing batched on-device beam decoding on "
                             "{} set, num of batch = {}.".format(s, len(ds)))
            for i, data in enumerate(prefetch(iter(ds), size=2)):
                self.progress("Decode step - {}/{}".format(i + 1, len(ds)))
                self._decode_batch(data, out_path,
                                   None if self.greedy else beam_path)
            self.verbose("Results stored at {}".format(out_path))
        # every batch ended in a device-to-host copy of its tokens, so the
        # device work is done when the clock is read
        self.decode_seconds = time.perf_counter() - start
        self.verbose("All done ! {} utts ({:.1f} s of audio) in {:.2f} s"
                     .format(self.n_utts, self.audio_seconds,
                             self.decode_seconds))

    def _decode_batch(self, data, out_path: str, beam_path: Optional[str]):
        wav = torch.from_numpy(data["wav"]).to(self.device)
        wav_len = torch.from_numpy(data["wav_len"]).long().to(self.device)
        feat, feat_len = extract_features(self.feat_cfg, wav, wav_len)
        names = [os.path.basename(str(n)).rsplit(".", 1)[0]
                 for n in data["name"]]
        truths = [self.tokenizer.decode(t.tolist())
                  for t in data["txt"][:len(names)]]
        self.n_utts += len(names)
        self.audio_seconds += float(data["wav_len"][:len(names)].sum()
                                    / self.feat_cfg.sample_rate)

        if self.greedy:
            # decode budget from INPUT frames like the beam path
            decode_step = self._max_steps_for(int(wav.shape[1]))
            out = greedy_decode(self.params, self.spec, feat, feat_len,
                                decode_step, compute_dtype=self.compute_dtype)
            ctc_mode = "att_tokens" not in out
            toks = out["ctc_tokens" if ctc_mode else "att_tokens"].cpu()
            toks = toks.numpy()[:len(names)]
            with open(out_path, "a") as f:
                for name, hyp_ids, truth in zip(names, toks, truths):
                    hyp = self.tokenizer.decode(hyp_ids.tolist(),
                                                ignore_repeat=ctc_mode)
                    f.write("\t".join([name, hyp, truth]) + "\n")
            return

        if not self.spec.enable_att:
            # the CTC prefix beam search over the encoder's frames
            with torch.no_grad():
                enc_feat, enc_len = E.encoder_apply(
                    self.params["encoder"], self.spec.encoder, feat, feat_len,
                    self.compute_dtype)
                logp = M.ctc_log_probs(self.params, self.spec, enc_feat,
                                       self.compute_dtype)
            ccfg = CTCBeamConfig(
                beam_size=self.beam_size,
                cand_size=min(self.vocab_size - 1, 8),
                max_tokens=self._max_steps_for(int(wav.shape[1])),
                lm_weight=self.lm_weight)
            out = ctc_beam_decode(logp, enc_len, ccfg, self.lm_params,
                                  self.lm_spec,
                                  compute_dtype=self.compute_dtype)
        else:
            cfg = BeamConfig(
                beam_size=self.beam_size, min_len_ratio=self.min_len_ratio,
                max_len_ratio=self.max_len_ratio,
                ctc_weight=self.dec_ctc_weight, lm_weight=self.lm_weight,
                max_steps=self._max_steps_for(int(wav.shape[1])))
            out = beam_decode(self.params, self.spec, cfg, feat, feat_len,
                              self.lm_params, self.lm_spec,
                              compute_dtype=self.compute_dtype)
        tokens = out["tokens"].cpu().numpy()[:len(names)]          # B,K,L
        with open(out_path, "a") as f, open(beam_path, "a") as fb:
            for bi, (name, truth) in enumerate(zip(names, truths)):
                hyps = [self.tokenizer.decode(tokens[bi, ki].tolist())
                        for ki in range(tokens.shape[1])]
                f.write("\t".join([name, hyps[0], truth]) + "\n")
                for ki, hyp in enumerate(hyps):
                    fb.write("\t".join([name, str(ki), hyp, truth]) + "\n")
