"""ASR training solver (port of e2e_asr_pytorch_tpu/train/train_asr.py).

The joint CTC + attention objective with label smoothing, SpecAugment,
per-dev-set best-checkpoint tracking for both heads, curriculum relaunch,
CTC early stopping and the 'self_defined' LR decay. The step
is ``train_step``: features + SpecAugment + forward + losses + autograd
backward (the encoder's BLSTM through K1/K2, a 2-layer decoder through the
folded decoder's hand-written backward with K3/K4, a decoder of any other
depth through its autodiff form) + the Adadelta update, all eager PyTorch.
With ``--upstream NAME`` the features come from a registered upstream
(``data/upstream.py``: ``fbank80``, the pretrained APC encoder ``apc``)
instead of the config's ``data.audio`` block, SpecAugment after it; the
upstream's weights are constants, outside the parameters, the optimizer
state and the checkpoints. Scheduled sampling (``tf_start`` / ``tf_end``
below 1, the generic decoder scan of ``models/asr.py``) gets each step's
teacher-forcing rate; the ``transfer`` block freezes the encoder layers it
does not list and, with ``train_dec: False``, the decoder side, whose
leaves still pass through the optimizer with zero gradients, as in JAX.

The config's ``emb:`` block adds the embedding regularizer
(``models/plugin.py``): its parameters join the tree under ``emb_plugin``
before the optimizer state is built, its loss is added at its ``weight``,
and when it fuses, the attention loss is the NLL of the fused log-probs
(not label smoothing) and validation decodes over them. On-line BERT
targets are computed on the host per batch and enter the step as data.

On a mesh (``--n-devices`` / ``--n-model``, ``parallel/mesh.py``) each
rank decodes its rows of every global batch, gathers the wide leaves,
divides its losses by the weights summed over the data ranks, reduces the
gradients onto its leaves and steps the optimizer on them; the logged
metrics are the global batch's.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from e2e_asr_pytorch_tpu_torch.data.batching import prefetch
from e2e_asr_pytorch_tpu_torch.utils.logger import feat_to_fig
from e2e_asr_pytorch_tpu_torch.utils.metrics import cal_er
from e2e_asr_pytorch_tpu_torch.utils.timer import human_format
from e2e_asr_pytorch_tpu_torch.convert import tree_leaves, tree_map
from e2e_asr_pytorch_tpu_torch.data.loaders import load_dataset
from e2e_asr_pytorch_tpu_torch.models import asr as M
from e2e_asr_pytorch_tpu_torch.models import plugin as P
from e2e_asr_pytorch_tpu_torch.ops import ctc as ctc_ops
from e2e_asr_pytorch_tpu_torch.ops import losses as L
from e2e_asr_pytorch_tpu_torch.ops.audio import (FeatureConfig,
                                                 extract_features)
from e2e_asr_pytorch_tpu_torch.ops.specaugment import spec_augment
from e2e_asr_pytorch_tpu_torch.train import optim as O
from e2e_asr_pytorch_tpu_torch.train.solver import BaseSolver


# --profile traces these train steps (counted from 0), as the JAX package's
# trainer traces steps 10-13
PROFILE_STEPS = (10, 13)


class StepConfig(NamedTuple):
    """What a training step needs besides the parameters and the batch."""
    spec: M.ASRSpec
    feat_cfg: FeatureConfig
    optimizer: O.Adadelta
    compute_dtype: torch.dtype = torch.float32
    augment: bool = False
    label_smoothing: bool = False
    sample_free: bool = True
    # transfer learning: the encoder layers (-1: the frontend) and whether
    # the decoder side are frozen
    fix_enc: tuple = ()
    fix_dec: bool = False
    # (wav, wav_len) -> (feat, feat_len) in place of extract_features
    upstream: Optional[Callable] = None
    # the embedding regularizer / fusion plugin, its params under
    # params["emb_plugin"]
    emb: Optional[P.EmbeddingRegularizer] = None
    # the rank's mesh and the parameters' shard specs (parallel/mesh.py)
    mesh: Optional[object] = None
    param_specs: Optional[object] = None


def to_device(data: Dict, device) -> Dict[str, torch.Tensor]:
    """The host batch's arrays as tensors on ``device`` (names dropped)."""
    out = {}
    for k in ("wav", "wav_len", "txt", "txt_len", "utt_w"):
        if k in data:
            x = torch.from_numpy(np.asarray(data[k]))
            out[k] = x.to(device, non_blocking=True)
    out["wav_len"] = out["wav_len"].long()
    out["txt"] = out["txt"].long()
    out["txt_len"] = out["txt_len"].long()
    return out


def features(cfg: StepConfig, wav, wav_len, gen, train: bool):
    """The step's features: the upstream's (a constant function, run without
    autograd) or the config's front-end, then SpecAugment in training."""
    if cfg.upstream is not None:
        with torch.no_grad():
            feat, feat_len = cfg.upstream(wav, wav_len)
    else:
        feat, feat_len = extract_features(cfg.feat_cfg, wav, wav_len)
    if train and cfg.augment:
        feat = spec_augment(feat, feat_len, gen)
    return feat, feat_len


def losses(cfg: StepConfig, params, feat, feat_len, txt, txt_len, gen,
           use_ctc: bool, train: bool, utt_w=None, tf_rate: float = 1.0,
           y_emb=None):
    """(total, (ctc_loss, att_loss, emb_loss, ctc_out, att_out, enc_len))
    of the teacher-forced forward (scheduled sampling at ``tf_rate`` unless
    the run is ``sample_free``). With the emb plugin its loss joins the
    total (``y_emb``: on-line BERT targets, else the table's) and a fusing
    plugin's log-probs replace ``att_out``. On a mesh each loss is this
    rank's share of the global batch's."""
    spec = cfg.spec
    emb = cfg.emb
    gsum = cfg.mesh.global_sum if cfg.mesh is not None else None
    ctc_out, enc_len, att_out, _, dec_state = M.asr_apply(
        params, spec, feat, feat_len, txt.shape[1], teacher=txt, gen=gen,
        train=train, sample_free=cfg.sample_free,
        compute_dtype=cfg.compute_dtype, tf_rate=tf_rate,
        fix_enc_layers=cfg.fix_enc, fix_dec=cfg.fix_dec,
        get_dec_state=emb is not None)
    total = torch.zeros((), device=feat.device)
    ctc_l = att_l = emb_l = None
    if emb is not None:
        emb_l, fused = emb.loss(params["emb_plugin"], dec_state, att_out, txt,
                                utt_w=utt_w, y_emb=y_emb, global_sum=gsum)
        total = total + emb.weight * emb_l
        if emb.apply_fuse:
            att_out = fused
    if ctc_out is not None and use_ctc:
        ctc_l = ctc_ops.ctc_loss(ctc_out, enc_len, txt, txt_len, utt_w=utt_w,
                                 global_sum=gsum)
        total = total + ctc_l * spec.ctc_weight
    if att_out is not None:
        if emb is not None and emb.apply_fuse:
            att_l = L.nll_loss(att_out, txt, utt_w=utt_w, global_sum=gsum)
        elif cfg.label_smoothing:
            att_l = L.label_smoothing_loss(att_out, txt, spec.vocab_size, 0.1,
                                           utt_w=utt_w, global_sum=gsum)
        else:
            att_l = L.cross_entropy_loss(att_out, txt, utt_w=utt_w,
                                         global_sum=gsum)
        total = total + att_l * (1 - spec.ctc_weight)
    return total, (ctc_l, att_l, emb_l, ctc_out, att_out, enc_len)


def loss_and_grads(cfg: StepConfig, params, batch: Dict, gen, tf_rate: float,
                   use_ctc: bool = True, y_emb=None):
    """Features (with SpecAugment), forward, losses and the gradient of the
    total with respect to every parameter leaf (zeros for unused and
    frozen leaves). ``tf_rate`` is the step's teacher-forcing rate,
    ``y_emb`` the emb plugin's on-line targets."""
    with record_function("features"):
        feat, feat_len = features(cfg, batch["wav"], batch["wav_len"], gen,
                                  True)
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        with record_function("forward"):
            total, aux = losses(cfg, leaves, feat, feat_len, batch["txt"],
                                batch["txt_len"], gen, use_ctc, True,
                                utt_w=batch.get("utt_w"), tf_rate=tf_rate,
                                y_emb=y_emb)
        flat = tree_leaves(leaves)
        with record_function("backward"):
            # every leaf frozen (transfer learning): all gradients are zero
            grads = (torch.autograd.grad(total, flat, allow_unused=True)
                     if total.requires_grad else [None] * len(flat))
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(flat, grads)])
    return total.detach(), aux, tree_map(lambda _: next(grads), params)


def mask_ctc(ctc_out, enc_len):
    """Padded frames (>= enc_len) emit <blank>, so host-side metric decoding
    never reads the unsupervised padding region."""
    if ctc_out is None:
        return None
    t = ctc_out.shape[1]
    valid = (torch.arange(t, device=ctc_out.device)[None, :]
             < enc_len[:, None])[:, :, None]
    blank = torch.zeros(ctc_out.shape[-1], dtype=ctc_out.dtype,
                        device=ctc_out.device)
    blank[0] = 1.0
    return torch.where(valid, ctc_out, blank)


def train_step(cfg: StepConfig, params, opt_state, batch: Dict, gen,
               tf_rate: float, use_ctc: bool = True, y_emb=None):
    """One training step. Updates ``params`` and ``opt_state`` in place (and
    returns them) and returns (params, opt_state, metrics, ctc_out, att_out);
    the metrics are 0-dim device tensors (total, gnorm before clipping, ctc,
    att, emb), read by the caller only when it logs. On a mesh ``params``
    and ``opt_state`` are this rank's leaves: the sharded ones are gathered
    for the forward, the gradients reduced onto them, and the metrics are
    the global batch's."""
    mesh = cfg.mesh
    full = params if mesh is None else mesh.gather(params, cfg.param_specs)
    total, aux, grads = loss_and_grads(cfg, full, batch, gen, tf_rate,
                                       use_ctc, y_emb)
    norm_fn = None
    if mesh is not None:
        with record_function("reduce"):
            grads = mesh.reduce_grads(grads, cfg.param_specs)

        def norm_fn(g):
            return mesh.grad_norm(g, cfg.param_specs)
    with record_function("optimizer"):
        gnorm = cfg.optimizer.step(params, grads, opt_state, norm_fn)
    ctc_l, att_l, emb_l, ctc_out, att_out, enc_len = aux
    nan = torch.full((), float("nan"), device=total.device)
    metrics = {"total": total, "gnorm": gnorm,
               "ctc": ctc_l.detach() if ctc_l is not None else nan,
               "att": att_l.detach() if att_l is not None else nan,
               "emb": emb_l.detach() if emb_l is not None else nan}
    if mesh is not None:
        names = ("total", "ctc", "att", "emb")
        summed = mesh.global_sum(torch.stack([metrics[n] for n in names]))
        metrics.update(zip(names, summed))
    ctc_out = mask_ctc(ctc_out.detach(), enc_len) if ctc_out is not None \
        else None
    att_out = att_out.detach() if att_out is not None else None
    return params, opt_state, metrics, ctc_out, att_out


def _n_real(data) -> int:
    """Number of real (non-padding) utterances in a host batch."""
    w = data.get("utt_w")
    return int(w.sum()) if w is not None else len(data["txt"])


def _opt(x) -> Optional[float]:
    v = float(x)
    return None if math.isnan(v) else v


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Solver(BaseSolver):
    def __init__(self, config, paras, mode="train"):
        super().__init__(config, paras, mode)
        hp = self.config["hparas"]
        self.curriculum = hp.get("curriculum", 0)
        self.val_mode = hp.get("val_mode", "wer").lower()
        self.WER = "per" if self.val_mode == "per" else "wer"
        # what exec() ran: per train step its metrics as floats, its decode
        # length (the folded decoder's steps), utterances, seconds of audio
        # and wall seconds (the step ends in a device sync); the validation
        # batches decoded
        self.step_stats = []
        self.decode_lengths = []
        self.step_utts = []
        self.step_audio_seconds = []
        self.step_seconds = []
        self.n_valid_batches = 0
        self._prof = None

    # ------------------------------------------------------------- data
    def load_data(self):
        self.upstream = None
        if self.paras.upstream is not None:
            from e2e_asr_pytorch_tpu_torch.data.upstream import get_upstream
            self.upstream, up_dim = get_upstream(self.paras.upstream,
                                                 self.device)
            self.verbose("Using upstream feature source `{}` (dim {})"
                         .format(self.paras.upstream, up_dim))
        self.tr_set, self.dv_set, self.feat_dim, self.vocab_size, \
            self.tokenizer, msg = load_dataset(
                self.paras.njobs, self.paras.gpu, self.paras.pin_memory,
                self.curriculum > 0, **self.config["data"],
                seed=self.paras.seed, pad_multiple=self.n_data)
        if self.upstream is not None:
            self.feat_dim = up_dim
        self.verbose(msg)
        dev_split = self.config["data"]["corpus"].get("dev_split", ["dev"])
        if isinstance(self.dv_set, list):
            self.dv_names = [ds[0] for ds in dev_split]
        else:
            self.dv_names = dev_split[0] if isinstance(dev_split[0], str) \
                else "dev"
        names = [self.dv_names] if isinstance(self.dv_names, str) \
            else self.dv_names
        self.best_wer = {"att": {n: 3.0 for n in names},
                         "ctc": {n: 3.0 for n in names}}

    # ------------------------------------------------------------ model
    def set_model(self):
        hp = self.config["hparas"]
        audio_cfg = dict(self.config["data"].get("audio", {}))
        self.feat_cfg = FeatureConfig(**audio_cfg)
        self.spec = M.build_spec(self.feat_dim, self.vocab_size,
                                 **self.config["model"])
        self.params = M.asr_init(
            torch.Generator().manual_seed(self.paras.seed), self.spec,
            self.device)
        self.verbose(self._model_msg())
        self.optimizer = O.build_optimizer(grad_clip=self.GRAD_CLIP, **hp)
        self.tf_rate = O.tf_rate_fn(hp.get("tf_start", 1.0),
                                    hp.get("tf_end", 1.0),
                                    hp.get("tf_step", 1),
                                    hp.get("tf_step_start", 0))
        self.verbose(O.create_msg(**hp))
        # the embedding-regularizer plugin: its params join the tree BEFORE
        # the optimizer state is built
        self.emb_reg = bool(self.config.get("emb", {}).get("enable"))
        self.emb_decoder = None
        if self.emb_reg:
            self.emb_decoder = P.build(
                self.config["emb"], self.tokenizer, self.spec.decoder.dim,
                torch.Generator().manual_seed(self.paras.seed + 99),
                self.device)
            self.params["emb_plugin"] = self.emb_decoder.params
            self.verbose(self.emb_decoder.create_msg())
        self.opt_state = self.optimizer.init(self.params)
        if self.transfer_learning:
            self.verbose("Apply transfer learning: ")
            self.verbose("      Train encoder layers: {}".format(
                self.train_enc))
            self.verbose("      Train decoder:        {}".format(
                self.train_dec))
        if self.paras.load:
            self.load_ckpt()
        self.place_model()
        self.step_cfg = StepConfig(
            self.spec, self.feat_cfg, self.optimizer, self.compute_dtype,
            augment=bool(audio_cfg.get("augment", False)),
            label_smoothing=bool(hp.get("label_smoothing", False)),
            sample_free=(hp.get("tf_start", 1.0) == 1.0
                         and hp.get("tf_end", 1.0) == 1.0),
            upstream=self.upstream,
            fix_enc=tuple(self.fix_enc) if self.transfer_learning else (),
            fix_dec=self.fix_dec if self.transfer_learning else False,
            emb=self.emb_decoder, mesh=self.mesh,
            param_specs=self.param_specs)
        # the step's randomness (SpecAugment, dropout), on the device, seeded for each
        # step by step_gen
        self.gen = torch.Generator(device=self.device)

    def _model_msg(self):
        msg = ["Model spec.| Encoder's downsampling rate of time axis is {}."
               .format(self.spec.encoder.total_sample_rate)]
        if self.spec.encoder.frontend is not None:
            msg.append("           | Frontend vgg code = {} (time/{})".format(
                self.spec.encoder.frontend.vgg,
                self.spec.encoder.frontend.sample_rate))
        if self.spec.enable_ctc:
            msg.append("           | CTC training on encoder enabled "
                       "( lambda = {}).".format(self.spec.ctc_weight))
        if self.spec.enable_att:
            msg.append("           | {} attention decoder enabled "
                       "( lambda = {}).".format(self.spec.attention.mode,
                                                1 - self.spec.ctc_weight))
        return msg

    # -------------------------------------------------------------- exec
    def exec(self):
        self.verbose("Total training steps {}.".format(
            human_format(self.max_step)))
        self.n_epochs = 0
        self.timer.set()
        early_stopping = self.config["hparas"].get("early_stopping", False)
        stop_step = len(self.tr_set) * 10  # ~10 epochs of updates
        use_ctc = self.spec.enable_ctc

        while self.step < self.max_step:
            if self.curriculum > 0 and self.n_epochs == self.curriculum:
                self.verbose("Curriculum learning ends after {} epochs, "
                             "starting random sampling.".format(self.n_epochs))
                self.tr_set = load_dataset(
                    self.paras.njobs, self.paras.gpu, self.paras.pin_memory,
                    False, **self.config["data"], seed=self.paras.seed,
                    pad_multiple=self.n_data)[0]
                self.curriculum = 0
            # host decode/pad runs 2 batches ahead of the device
            for data in prefetch(iter(self.tr_set), size=2):
                tf_rate = self.tf_rate(self.step)
                if early_stopping and self.step > stop_step:
                    use_ctc = False
                self.timer.cnt("rd")
                self._profile_window()
                t0 = time.perf_counter()
                data = self.put_batch(data)
                batch = to_device(data, self.device)
                # on-line BERT targets (host), entering the step as data
                y_emb = None
                if self.emb_reg and self.emb_decoder.predictor is not None:
                    y_emb = torch.from_numpy(self.emb_decoder.predict_targets(
                        data["txt"])).to(self.device)
                self.params, self.opt_state, metrics, ctc_out, att_out = \
                    train_step(self.step_cfg, self.params, self.opt_state,
                               batch, self.step_gen(), tf_rate, use_ctc,
                               y_emb)
                _sync(self.device)
                self.step_seconds.append(time.perf_counter() - t0)
                self.step_stats.append(dict({k: float(v) for k, v in
                                             metrics.items()},
                                            tf_rate=tf_rate))
                self.decode_lengths.append(int(data["txt"].shape[1]))
                n_real = _n_real(data)
                self.step_utts.append(n_real)
                self.step_audio_seconds.append(float(
                    np.asarray(data["wav_len"])[:n_real].sum()
                    / self.feat_cfg.sample_rate))
                self.step += 1
                self.timer.cnt("fw")

                if self.step == 1 or self.step % self.PROGRESS_STEP == 0:
                    self._log_train(data, metrics, ctc_out, att_out, use_ctc)
                if self.step == 1 or self.step % self.valid_step == 0:
                    if isinstance(self.dv_set, list):
                        for dv_id in range(len(self.dv_set)):
                            self.validate(self.dv_set[dv_id],
                                          self.dv_names[dv_id])
                    else:
                        self.validate(self.dv_set, self.dv_names)
                self.timer.set()
                if self.step >= self.max_step:
                    break
            self.n_epochs += 1

        self._profile_window(stop=True)
        self.ckpt_wait()
        self.log.close()
        self.verbose("Finished training after {} steps.".format(
            human_format(self.max_step)))

    def _profile_window(self, stop: bool = False):
        """--profile: a torch.profiler trace of steps PROFILE_STEPS (host
        spans features/forward/backward/optimizer and the device kernels),
        written to the log dir as a Chrome trace plus tables of ops by
        device time and by host time."""
        if not getattr(self.paras, "profile", False):
            return
        first, last = PROFILE_STEPS
        if self._prof is None and self.step == first and not stop:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        elif self._prof is not None and (stop or self.step == last + 1):
            _sync(self.device)
            self._prof.__exit__(None, None, None)
            os.makedirs(self.logdir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.logdir, "trace.json"))
            table = self._prof.key_averages().table
            with open(os.path.join(self.logdir, "profile.txt"), "w") as f:
                if self.device.type == "cuda":
                    f.write(table(sort_by="self_device_time_total",
                                  row_limit=40) + "\n")
                f.write(table(sort_by="cpu_time_total", row_limit=40))
            self.verbose("Profiler trace (steps {}-{}) written to {}".format(
                first, last, self.logdir))
            self._prof = None

    def _log_train(self, data, metrics, ctc_out, att_out, use_ctc):
        self.progress("Tr stat | Loss - {:.2f} | Grad. Norm - {:.2f} | {}"
                      .format(float(metrics["total"]),
                              float(metrics["gnorm"]), self.timer.show()))
        txt_np = data["txt"][:_n_real(data)]
        n = len(txt_np)
        n_local = len(data["txt"])
        self.write_log("emb_loss", {"tr": _opt(metrics["emb"])})
        att_np = ctc_np = None
        if att_out is not None:
            att_np = self.host_slice(self.to_host(att_out), n_local)[:n]
        if ctc_out is not None and use_ctc:
            ctc_np = self.host_slice(self.to_host(ctc_out), n_local)[:n]
        if not self.is_writer:
            return  # (its rows may all be padding) nothing is written
        if att_np is not None:
            self.write_log("loss", {"tr_att": _opt(metrics["att"])})
            self.write_log(self.WER, {"tr_att": cal_er(
                self.tokenizer, att_np, txt_np, mode=self.WER)})
            self.write_log("cer", {"tr_att": cal_er(
                self.tokenizer, att_np, txt_np, mode="cer")})
        if ctc_np is not None:
            self.write_log("loss", {"tr_ctc": _opt(metrics["ctc"])})
            self.write_log(self.WER, {"tr_ctc": cal_er(
                self.tokenizer, ctc_np, txt_np, mode=self.WER, ctc=True)})
            self.write_log("cer", {"tr_ctc": cal_er(
                self.tokenizer, ctc_np, txt_np, mode="cer", ctc=True)})
            self.write_log("ctc_text_train", self.tokenizer.decode(
                ctc_np[0].argmax(-1).tolist(), ignore_repeat=True))
        self.write_log("lr", {"tr": float(self.optimizer.schedule(
            self.step))})

    # -------------------------------------------------------- validation
    @torch.no_grad()
    def validate(self, dv_set, name):
        dev_wer = {"att": [], "ctc": []}
        dev_cer = {"att": [], "ctc": []}
        dev_er = {"att": [], "ctc": []}
        n_batches = len(dv_set)
        for i, data in enumerate(prefetch(iter(dv_set), size=2)):
            self.progress("Valid step - {}/{}".format(i + 1, n_batches))
            decode_step = int(np.ceil(data["txt"].shape[1]
                                      * self.DEV_STEP_RATIO))
            batch = to_device(self.put_batch(data), self.device)
            feat, feat_len = features(self.step_cfg, batch["wav"],
                                      batch["wav_len"], None, False)
            params = self.full_params()
            fuse_fn = None
            if self.emb_reg and self.emb_decoder.apply_fuse:
                def fuse_fn(d_state, logits):
                    return self.emb_decoder.fuse_step(params["emb_plugin"],
                                                      d_state, logits)
            ctc_out, enc_len, att_out, att_align, _ = M.asr_apply(
                params, self.spec, feat, feat_len, decode_step,
                compute_dtype=self.compute_dtype, emb_fuse_fn=fuse_fn)
            ctc_out = mask_ctc(ctc_out, enc_len)
            self.n_valid_batches += 1
            n_real = _n_real(data)
            n_local = len(data["txt"])
            txt_np = data["txt"][:n_real]
            att_np = ctc_np = None
            if att_out is not None:
                att_np = self.host_slice(self.to_host(att_out),
                                         n_local)[:n_real]
                dev_wer["att"].append(cal_er(self.tokenizer, att_np, txt_np,
                                             mode="wer"))
                dev_cer["att"].append(cal_er(self.tokenizer, att_np, txt_np,
                                             mode="cer"))
                dev_er["att"].append(cal_er(self.tokenizer, att_np, txt_np,
                                            mode=self.val_mode))
            if ctc_out is not None:
                ctc_np = self.host_slice(self.to_host(ctc_out),
                                         n_local)[:n_real]
                for store, mode in ((dev_wer, "wer"), (dev_cer, "cer"),
                                    (dev_er, self.val_mode)):
                    store["ctc"].append(cal_er(self.tokenizer, ctc_np,
                                               txt_np, mode=mode, ctc=True))
            if i == n_batches // 2 and (self.log.writer is not None
                                        or self.n_data > 1):
                # (a gather every rank joins; skipped when nothing is
                # written)
                align_np = (self.host_slice(self.to_host(att_align),
                                            n_local)
                            if att_out is not None else None)
                self._log_examples(name, txt_np, att_np, align_np, ctc_np)

        for task in [t for t in ("att", "ctc") if dev_er[t]]:
            er = sum(dev_er[task]) / len(dev_er[task])
            wer = sum(dev_wer[task]) / len(dev_wer[task])
            cer = sum(dev_cer[task]) / len(dev_cer[task])
            if er < self.best_wer[task][name]:
                self.best_wer[task][name] = er
                self.save_checkpoint("best_{}_{}.pth".format(
                    task, name + self.save_name), self.val_mode, er)
            if self.step >= self.max_step:
                self.save_checkpoint("last_{}_{}.pth".format(
                    task, name + self.save_name), self.val_mode, er)
            self.write_log(self.WER, {"dv_" + task + "_" + name.lower(): wer})
            self.write_log("cer", {"dv_" + task + "_" + name.lower(): cer})

    def _log_examples(self, name, txt_np, att_np, align_np, ctc_np):
        """Example hypotheses and alignments (host arrays of the global
        batch's rows)."""
        if self.log.writer is None:
            return  # nothing would be written
        for j in range(min(len(txt_np), self.DEV_N_EXAMPLE)):
            if self.step == 1:
                self.write_log("true_text_{}_{}".format(name, j),
                               self.tokenizer.decode(txt_np[j].tolist()))
            if att_np is not None:
                self.write_log("att_align_{}_{}".format(name, j),
                               feat_to_fig(align_np[j, 0]))
                self.write_log("att_text_{}_{}".format(name, j),
                               self.tokenizer.decode(
                                   att_np[j].argmax(-1).tolist()))
            if ctc_np is not None:
                self.write_log("ctc_text_{}_{}".format(name, j),
                               self.tokenizer.decode(
                                   ctc_np[j].argmax(-1).tolist(),
                                   ignore_repeat=True))
