"""Pretrain the APC upstream feature extractor and save loadable weights
(the port's twin of util/train_apc.py).

    python -m e2e_asr_pytorch_tpu_torch.train_apc --corpus /path/to/LibriSpeech \\
        --out ckpt/apc.npz
    python -m e2e_asr_pytorch_tpu_torch.train_apc --corpus synthetic --steps 200

The checkpoint is the JAX package's ``.npz`` layout, so either package's
``--upstream apc`` loads it (point $APC_CKPT at it). Then train ASR on top:

    python -m e2e_asr_pytorch_tpu_torch.main \\
        --config config/librispeech_asr_upstream.yaml --upstream apc

It runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def wav_batches(paths_or_waves, batch: int, seconds: float, seed: int = 0,
                sample_rate: int = 16000):
    """Yield (B,S) float32 crops + lengths, forever (random crop / pad)."""
    from e2e_asr_pytorch_tpu_torch.data.wav import read_audio, resample_linear
    rng = np.random.default_rng(seed)
    n_s = int(seconds * sample_rate)
    while True:
        wav = np.zeros((batch, n_s), np.float32)
        wav_len = np.zeros((batch,), np.int32)
        for i in range(batch):
            item = paths_or_waves[rng.integers(len(paths_or_waves))]
            if isinstance(item, str):
                w, sr = read_audio(item)
                w = resample_linear(w, sr, sample_rate)
            else:
                w = np.asarray(item, np.float32)
            if len(w) > n_s:
                ofs = int(rng.integers(0, len(w) - n_s + 1))
                w = w[ofs:ofs + n_s]
            wav[i, :len(w)] = w
            wav_len[i] = len(w)
        yield wav, wav_len


def collect_corpus(corpus: str, n_utts: int):
    """The synthetic corpus' waveforms, or the .flac / .wav paths under a
    directory (at most ``n_utts``)."""
    if corpus == "synthetic":
        from e2e_asr_pytorch_tpu_torch.data.librispeech import SyntheticCorpus
        corp = SyntheticCorpus(31)
        rng = np.random.default_rng(0)
        return [corp.utterance(i, int(rng.integers(4, 12)))[0]
                for i in range(n_utts)]
    paths = []
    for dirpath, _, files in os.walk(corpus):
        for f in sorted(files):
            if f.endswith((".flac", ".wav")):
                paths.append(os.path.join(dirpath, f))
        if len(paths) >= n_utts:
            break
    if not paths:
        raise SystemExit("no .flac/.wav under " + corpus)
    return paths[:n_utts]


def main(argv=None):
    ap = argparse.ArgumentParser(description="APC upstream pretraining")
    ap.add_argument("--corpus", required=True,
                    help="LibriSpeech-layout dir, or `synthetic`")
    ap.add_argument("--out", default="ckpt/apc.npz")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--shift", type=int, default=3)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mel", type=int, default=80)
    ap.add_argument("--n-utts", type=int, default=100000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from e2e_asr_pytorch_tpu_torch.models import apc as A
    from e2e_asr_pytorch_tpu_torch.train.solver import select_device
    device = select_device(args.cpu)
    spec = A.APCSpec(input_dim=args.mel, hidden=args.hidden,
                     n_layers=args.layers, time_shift=args.shift,
                     dropout=args.dropout)
    items = collect_corpus(args.corpus, args.n_utts)
    print("[apc] {} utterances from {}".format(len(items), args.corpus))
    batches = wav_batches(items, args.batch, args.seconds, args.seed)
    params = A.pretrain_apc(batches, spec, args.steps, lr=args.lr,
                            seed=args.seed, device=device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    A.save_apc(args.out, params, spec)
    print("[apc] saved to {} (use --upstream apc with APC_CKPT={})".format(
        args.out, args.out))
    return params, spec


if __name__ == "__main__":
    main()
