"""Plain reference of the joint CTC-attention LAS training step (the
upstream recipe behind the published WER: fbank features with deltas,
SpecAugment, a VGG frontend with layer norm over frequency, BLSTM layers
with tanh projections and dropout, a CTC head, location-aware attention
over the encoder's outputs, a 2-layer LSTM decoder under teacher forcing,
label smoothing, Adadelta with the global norm clipped at 5).

The step's definitions are those of the configuration as the port states
it: the centred 1025-point magnitude STFT with a 400-sample Hann window,
Slaney mel, 20 log10 - ref_level_db normalised by min_level_db, deltas
over zero-padded frames; the value table of the attention quantized per
frame to int8 (``value_table: int8``) with the gradient passing the
rounding; the label-smoothed loss averaged over every position of the
padded transcripts; Adadelta's accumulators stored in bf16
(``optim_state_dtype``). Everything else is float32 ("f32") or, for the
control, every product's operands rounded to float8 ("fp8").

The batch runs in blocks of rows (each block's mean loss and gradient
weighted by its share of the rows), so that the autograd graph of the
plain loops fits beside nothing else on the card. The random draws are
made for the whole batch first, in the order the step takes them from its
generator: SpecAugment's six (B,) uniforms (time width, start, end, then
frequency width, start, end), then one (T,B,2H) uniform per encoder layer
for its dropout.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from reference.common import (Adadelta, clip, exact_matmuls, leaf_norms,
                              lstm_seq, mm, operand)

SR = 16000
N_FFT = 1025
NEG_INF = -1e30


# ------------------------------------------------------------- the leaves
def param_table(model: Dict, vocab: int, feat_dim: int):
    """(path, shape, init) of every leaf with the upstream inits: weights
    N(0, 1/fan_in), biases 0, layer norms 1 / 0, the embedding N(0, 1),
    the decoder LSTMs' forget-gate biases 1."""
    enc, att, dec = model["encoder"], model["attention"], model["decoder"]
    freq, ch = 40, feat_dim // 40
    t = []

    def linear(p, d_in, d_out, bias=True):
        t.append((p + ".w", (d_in, d_out), ("normal", d_in ** -0.5)))
        if bias:
            t.append((p + ".b", (d_out,), ("zeros",)))

    def lstm(p, d_in, h, forget=False):
        t.extend([(p + ".w_x", (d_in, 4 * h), ("normal", d_in ** -0.5)),
                  (p + ".w_h", (h, 4 * h), ("normal", h ** -0.5)),
                  (p + ".b", (4 * h,), ("forget", h) if forget
                   else ("zeros",))])
    fe = "encoder.frontend."
    for i, (cin, cout, f) in enumerate(((ch, 64, freq), (64, 64, freq),
                                        (64, 128, freq // 2),
                                        (128, 128, freq // 2)), 1):
        t.append((fe + "conv%d.w" % i, (cout, cin, 3, 3),
                  ("normal", (cin * 9) ** -0.5)))
        t.append((fe + "conv%d.b" % i, (cout,), ("zeros",)))
        t.append((fe + "ln%d.scale" % i, (f,), ("ones",)))
        t.append((fe + "ln%d.bias" % i, (f,), ("zeros",)))
    d = (freq // 4) * 128
    for layer, h in enumerate(enc["dim"]):
        p = "encoder.layers.%d." % layer
        lstm(p + "fw", d, h)
        lstm(p + "bw", d, h)
        linear(p + "pj", 2 * h, 2 * h)
        d = 2 * h
    linear("ctc_layer", d, vocab)
    hd = dec["dim"]
    t.append(("pre_embed", (vocab, hd), ("normal", 1.0)))
    lstm("decoder.layers.0", d + hd, hd, forget=True)
    for layer in range(1, dec["layer"]):
        lstm("decoder.layers.%d" % layer, hd, hd, forget=True)
    linear("decoder.char_trans", hd, vocab)
    linear("attention.proj_q", hd * dec["layer"], att["dim"])
    linear("attention.proj_k", d, att["dim"])
    kw = 2 * att["loc_kernel_size"] + 1
    t.append(("attention.loc_conv.w", (kw, 1, att["loc_kernel_num"]),
              ("normal", kw ** -0.5)))
    t.append(("attention.loc_proj.w", (att["loc_kernel_num"], att["dim"]),
              ("normal", att["loc_kernel_num"] ** -0.5)))
    linear("attention.gen_energy", att["dim"], 1)
    return t


# ---------------------------------------------------------------- features
def _mel_filterbank(n_mels: int) -> np.ndarray:
    """Slaney-scale triangular filters with area normalisation (librosa's
    default), (n_fft//2 + 1, n_mels)."""
    def to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4)
                                                               / 27.0)
        return np.where(f >= 1000.0, log, lin)

    def to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0,
                        1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                        m * (200.0 / 3))
    bins = np.linspace(0.0, SR / 2, N_FFT // 2 + 1)
    edges = to_hz(np.linspace(to_mel(0.0), to_mel(SR / 2), n_mels + 2))
    fb = np.zeros((n_mels, len(bins)))
    for m in range(n_mels):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        up = (bins - lo) / (mid - lo)
        down = (hi - bins) / (hi - mid)
        fb[m] = np.maximum(0.0, np.minimum(up, down)) * 2.0 / (hi - lo)
    return fb.T.astype(np.float32)


def _delta_taps(order: int, win: int) -> List[np.ndarray]:
    """Regression taps of each delta order, read as a correlation over the
    zero-padded frames: order k is order k-1 convolved with
    (-win..win)/sum(n^2)."""
    base = np.arange(-win, win + 1, dtype=np.float64)
    base /= np.sum(base ** 2)
    taps = [np.array([1.0])]
    for _ in range(order):
        taps.append(np.convolve(taps[-1], base))
    return taps


def features(audio: Dict, wav: torch.Tensor, wav_len: torch.Tensor):
    """(B,S) waveform -> (B,T,feat_dim*(order+1)) normalised log-mel with
    deltas, padding frames zero, and the frame counts."""
    wav = torch.cat([wav[:, :1], wav[:, 1:] - audio["preemphasis_coeff"]
                     * wav[:, :-1]], dim=1)
    win_len = int(audio["frame_length"] / 1000 * SR)
    hop = int(audio["frame_shift"] / 1000 * SR)
    spec = torch.stft(wav, N_FFT, hop, win_len,
                      torch.hann_window(win_len, periodic=True,
                                        device=wav.device),
                      center=True, pad_mode="reflect", return_complex=True)
    mag = spec.abs().transpose(1, 2)                             # (B,T,F)
    fb = torch.from_numpy(_mel_filterbank(audio["feat_dim"])).to(wav.device)
    mel = mag @ fb
    db = 20.0 * torch.log10(torch.clamp(mel, min=1e-5)) - audio["ref_level_db"]
    x = torch.clamp((db - audio["min_level_db"]) / -audio["min_level_db"],
                    0.0, 1.0)
    t = x.shape[1]
    outs = []
    for taps in _delta_taps(audio["delta_order"],
                            audio["delta_window_size"]):
        pad = len(taps) // 2
        xp = F.pad(x, (0, 0, pad, pad))
        outs.append(sum(float(w) * xp[:, j:j + t]
                        for j, w in enumerate(taps) if w != 0.0))
    feat = torch.cat(outs, dim=-1)
    feat_len = 1 + (wav_len + 2 * (N_FFT // 2) - N_FFT) // hop
    valid = torch.arange(t, device=wav.device)[None, :] < feat_len[:, None]
    return feat * valid[:, :, None].float(), feat_len


def draw(gen, shape, device):
    return torch.rand(shape, generator=gen, device=device)


def spec_augment(feat, feat_len, u, max_t=40, max_f=27):
    """One time and one frequency mask an utterance, filled with the
    utterance's mean over its valid frames: width ~ [0, max), start ~
    [0, len - width), end ~ start + [0, width), from the drawn uniforms
    ``u`` (six (B,) tensors)."""
    b, t, f = feat.shape

    def below(ui, hi):
        return torch.floor(ui * hi.float()).long()
    lens = feat_len.long()
    width = below(u[0], torch.full_like(lens, max_t))
    start = below(u[1], torch.clamp(lens - width, min=1))
    end = start + below(u[2], torch.clamp(width, min=1))
    fw = below(u[3], torch.full_like(lens, max_f))
    fs = below(u[4], torch.clamp(f - fw, min=1))
    fe = fs + below(u[5], torch.clamp(fw, min=1))
    ti = torch.arange(t, device=feat.device)[None, :]
    fi = torch.arange(f, device=feat.device)[None, :]
    valid = (ti < feat_len[:, None]).float()
    fill = ((feat * valid[:, :, None]).sum(dim=(1, 2))
            / torch.clamp(feat_len.float() * f, min=1.0))[:, None, None]
    tm = (ti >= start[:, None]) & (ti < end[:, None])
    feat = torch.where(tm[:, :, None], fill, feat)
    fm = (fi >= fs[:, None]) & (fi < fe[:, None])
    feat = torch.where(fm[:, None, :], fill, feat)
    return feat * valid[:, :, None]


# ------------------------------------------------------------------ model
def _ln_freq(x, scale, bias):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + 1e-5) * scale + bias


def _pool(x):
    """2x2 max pool over (T,F) of (B,C,T,F), the ragged edge trimmed, the
    gradient shared among tied maxima."""
    b, c, t, f = x.shape
    x = x[:, :, :t - t % 2, :f - f % 2]
    return x.reshape(b, c, t // 2, 2, f // 2, 2).amax(dim=(3, 5))


def _conv(x, w, b, prec):
    return F.conv2d(operand(x, prec), operand(w, prec), b, padding=1)


def frontend(w, feat, feat_len, prec):
    """VGG with layer norm over frequency: (B,T,3*40) -> (B,T/4,1280)."""
    b, t, d = feat.shape
    t = t // 4 * 4
    x = feat[:, :t].reshape(b, t, d // 40, 40).permute(0, 2, 1, 3)
    p = "encoder.frontend."
    for i in (1, 2, 3, 4):
        x = _conv(x, w[p + "conv%d.w" % i], w[p + "conv%d.b" % i], prec)
        x = torch.relu(_ln_freq(x, w[p + "ln%d.scale" % i],
                                w[p + "ln%d.bias" % i]))
        if i in (2, 4):
            x = _pool(x)
    b, c, t2, f2 = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t2, c * f2), feat_len // 4


def encoder(w, model, x, drop_u, prec):
    """BLSTM layers over time-major x (T,B,D), each: [fw ; bw], dropout
    with the drawn uniforms ``drop_u[layer]``, tanh projection."""
    enc = model["encoder"]
    for layer in range(len(enc["dim"])):
        p = "encoder.layers.%d." % layer
        ys = []
        for d, rev in (("fw", False), ("bw", True)):
            xg = mm(x, w[p + d + ".w_x"], prec) + w[p + d + ".b"]
            ys.append(lstm_seq(xg, w[p + d + ".w_h"], prec, reverse=rev))
        y = torch.cat(ys, dim=-1)
        rate = enc["dropout"][layer]
        if rate > 0:
            y = y * (drop_u[layer] < 1.0 - rate) / (1.0 - rate)
        x = torch.tanh(mm(y, w[p + "pj.w"], prec) + w[p + "pj.b"])
    return x


def _int8_values(v):
    """Per-frame symmetric int8 of the value table, straight through."""
    with torch.no_grad():
        scale = v.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
        q = torch.clamp(torch.round(v / scale), -127, 127) * scale
    return v + (q - v).detach()


def _lstm_cell(g, c, hid):
    i = torch.sigmoid(g[:, :hid])
    f = torch.sigmoid(g[:, hid:2 * hid])
    gg = torch.tanh(g[:, 2 * hid:3 * hid])
    o = torch.sigmoid(g[:, 3 * hid:])
    c = f * c + i * gg
    return o * torch.tanh(c), c


def decoder(w, model, enc_out, enc_len, txt, prec):
    """Teacher-forced location-aware attention decoder: (B,L,V) logits."""
    att, dec = model["attention"], model["decoder"]
    b, t, _ = enc_out.shape
    hid, n_layers = dec["dim"], dec["layer"]
    key = torch.tanh(mm(enc_out, w["attention.proj_k.w"], prec)
                     + w["attention.proj_k.b"])
    values = enc_out
    if model.get("value_table", "bf16") == "int8":
        values = _int8_values(values)
    values = operand(values, prec)
    valid = torch.arange(t, device=enc_out.device)[None, :] < enc_len[:, None]
    prev = valid.float() / torch.clamp(enc_len[:, None].float(), min=1.0)
    taps = w["attention.loc_conv.w"]                     # (kw, 1, Kn)
    conv_w = operand(taps[:, 0, :].t()[:, None, :], prec)  # (Kn, 1, kw)
    pad = taps.shape[0] // 2
    emb = w["pre_embed"][txt]                           # (B,L,H)
    inp = torch.cat([w["pre_embed"][torch.zeros_like(txt[:, :1])],
                     emb[:, :-1]], dim=1)
    hs = [enc_out.new_zeros(b, hid) for _ in range(n_layers)]
    cs = [enc_out.new_zeros(b, hid) for _ in range(n_layers)]
    outs = []
    for step in range(txt.shape[1]):
        q = torch.tanh(mm(torch.cat(hs, dim=-1), w["attention.proj_q.w"],
                          prec) + w["attention.proj_q.b"])
        loc = F.conv1d(operand(prev[:, None, :], prec), conv_w,
                       padding=pad).transpose(1, 2)            # (B,T,Kn)
        loc_ctx = torch.tanh(mm(loc, w["attention.loc_proj.w"], prec))
        e_in = torch.tanh(key + q[:, None, :] + loc_ctx)
        energy = (mm(e_in, w["attention.gen_energy.w"], prec)[..., 0]
                  + w["attention.gen_energy.b"]) / att["temperature"]
        energy = torch.where(valid, energy, torch.full_like(energy, NEG_INF))
        attn = torch.softmax(energy, dim=-1)
        ctx = torch.bmm(operand(attn[:, None, :], prec), values)[:, 0]
        x = torch.cat([inp[:, step], ctx], dim=-1)
        for layer in range(n_layers):
            p = "decoder.layers.%d." % layer
            g = (mm(x, w[p + "w_x"], prec) + w[p + "b"]
                 + mm(hs[layer], w[p + "w_h"], prec))
            hs[layer], cs[layer] = _lstm_cell(g, cs[layer], hid)
            x = hs[layer]
        outs.append(x)
        prev = attn
    feats = torch.stack(outs, dim=1)
    return mm(feats, w["decoder.char_trans.w"], prec) + w["decoder.char_trans.b"]


def block_loss(w, model, audio, wav, wav_len, txt, txt_len, spec_u, drop_u,
               prec, smoothing=0.1):
    """The joint loss of a block of rows: ctc_weight * CTC (per-utterance
    NLL over its label count, mean over rows) + (1 - ctc_weight) * the
    label-smoothed cross entropy over every position."""
    feat, feat_len = features(audio, wav, wav_len)
    if audio.get("augment", False):
        feat = spec_augment(feat, feat_len, spec_u)
    x, enc_len = frontend(w, feat, feat_len, prec)
    x = encoder(w, model, x.transpose(0, 1), drop_u, prec).transpose(0, 1)
    vocab = w["ctc_layer.w"].shape[1]
    ctc_lp = torch.log_softmax(torch.relu(mm(x, w["ctc_layer.w"], prec)
                                          + w["ctc_layer.b"]), dim=-1)
    ctc = F.ctc_loss(ctc_lp.transpose(0, 1), txt, enc_len, txt_len, blank=0,
                     reduction="mean", zero_infinity=False)
    logits = decoder(w, model, x, enc_len, txt, prec)
    logp = torch.log_softmax(logits, dim=-1).reshape(-1, vocab)
    tgt = txt.reshape(-1)
    smear = smoothing / (vocab - 1)
    per_pos = (-(1.0 - smoothing - smear) * logp.gather(1, tgt[:, None])[:, 0]
               - smear * logp.sum(dim=-1))
    cw = model["ctc_weight"]
    return cw * ctc + (1.0 - cw) * per_pos.mean()


def readings(w0: Dict, model: Dict, audio: Dict, hparas: Dict,
             batches: List[Dict], gen_seeds: List[int], prec: str = "f32",
             rows_per_block: int = 32, grad_clip: float = 5.0) -> Dict:
    """The first len(batches) Adadelta steps from ``w0`` on the given
    device batches ({"wav", "wav_len", "txt", "txt_len"} tensors) and
    generator seeds."""
    exact_matmuls()
    w = {k: v.detach().clone() for k, v in w0.items()}
    state_dtype = getattr(torch, hparas.get("optim_state_dtype") or
                          "float32")
    opt = Adadelta(float(hparas["lr"]), float(hparas["eps"]), state_dtype,
                   float(hparas.get("weight_decay", 0.0)))
    enc = model["encoder"]
    losses, grad1 = [], None
    for batch, gs in zip(batches, gen_seeds):
        dev = batch["wav"].device
        b = batch["wav"].shape[0]
        gen = torch.Generator(device=dev).manual_seed(gs)
        spec_u = [draw(gen, (b,), dev) for _ in range(6)]
        n_frames = 1 + (batch["wav"].shape[1] - 1) // int(
            audio["frame_shift"] / 1000 * SR)
        t_enc = n_frames // 4
        drop_u = [draw(gen, (t_enc, b, 2 * h), dev) for h in enc["dim"]]
        names = list(w)
        total, grads = 0.0, None
        for r0 in range(0, b, rows_per_block):
            rows = slice(r0, min(b, r0 + rows_per_block))
            share = (rows.stop - rows.start) / b
            leaves = {k: w[k].detach().requires_grad_() for k in names}
            loss = block_loss(leaves, model, audio, batch["wav"][rows],
                              batch["wav_len"][rows], batch["txt"][rows],
                              batch["txt_len"][rows],
                              [u[rows] for u in spec_u],
                              [u[:, rows] for u in drop_u], prec) * share
            got = torch.autograd.grad(loss, [leaves[k] for k in names],
                                      allow_unused=True)
            got = [torch.zeros_like(w[k]) if g is None else g
                   for k, g in zip(names, got)]
            grads = got if grads is None else [a + g for a, g in
                                               zip(grads, got)]
            total += float(loss.detach())
            del loss, leaves, got
        grads = dict(zip(names, grads))
        losses.append(total)
        grads, _ = clip(grads, grad_clip)
        if grad1 is None:
            grad1 = leaf_norms(grads)
        opt.update(w, grads)
        del grads
    delta = leaf_norms({k: w[k] - w0[k] for k in w})
    return {"loss": losses, "grad1": grad1,
            "delta3": delta if math.isfinite(sum(delta.values())) else
            {k: math.inf for k in delta}}
