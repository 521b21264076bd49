"""Static-shape bucketed batching with host prefetch.

TPU-native replacement for the reference's DataLoader/collate machinery
(reference: src/data.py:104-199, src/collect_batch.py:10-93). Differences by
design:

  * batches are padded to a SMALL FIXED SET of (samples, tokens) shape
    buckets so XLA compiles a handful of programs instead of one per batch
    (the reference pads to the per-batch max, which on TPU would cause a
    recompile storm);
  * the reference's dynamic batch halving for long utterances
    (HALF_BATCHSIZE_AUDIO_LEN=800 frames, src/collect_batch.py:21-24) is kept,
    but becomes deterministic per shape bucket (sorted data => the whole
    bucket is long), so each bucket still has a single static batch shape;
  * audio decode is the only host work; features are computed on device, so
    batches carry raw padded waveforms;
  * an async prefetch thread overlaps host decode with device compute
    (replaces DataLoader worker processes), double-buffering via
    the host-to-device copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from e2e_asr_pytorch_tpu_torch.data.wav import read_audio, resample_linear

HALF_BATCHSIZE_AUDIO_LEN = 800   # frames; reference src/collect_batch.py:6
HALF_BATCHSIZE_TEXT_LEN = 150    # tokens; reference src/collect_batch.py:8
SAMPLE_RATE = 16000
HOP = 160

# default shape buckets: (seconds, max_tokens). Token caps sized for
# char-level LibriSpeech (~14 chars/sec plus headroom).
DEFAULT_BUCKETS_SEC: Tuple[Tuple[float, int], ...] = (
    (2.0, 48), (4.0, 80), (8.0, 144), (16.0, 272), (35.0, 560))


class ShapeBuckets:
    def __init__(self, buckets_sec=DEFAULT_BUCKETS_SEC,
                 sample_rate: int = SAMPLE_RATE):
        self.buckets = [(int(s * sample_rate), l) for s, l in buckets_sec]

    def lookup(self, n_samples: int, n_tokens: int) -> Tuple[int, int]:
        for cap_s, cap_l in self.buckets:
            if n_samples <= cap_s and n_tokens <= cap_l:
                return cap_s, cap_l
        return self.buckets[-1]

    def clip(self, n_samples: int, n_tokens: int) -> Tuple[int, int]:
        cap_s, cap_l = self.buckets[-1]
        return min(n_samples, cap_s), min(n_tokens, cap_l)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _decode(item) -> np.ndarray:
    wav = item
    if isinstance(wav, str):
        wav, sr = read_audio(wav)
        wav = resample_linear(wav, sr, SAMPLE_RATE)
    return np.asarray(wav, np.float32)


class AudioBatchIterator:
    """Iterate shape-bucketed batches over a (sorted) AudioDataset.

    Emits dicts: wav (B,S) f32, wav_len (B,) i32, txt (B,L) i32,
    txt_len (B,) i32, plus the utterance names. B is static per bucket:
    batch_size, or batch_size//2 when the bucket exceeds
    HALF_BATCHSIZE_AUDIO_LEN frames in train mode.
    """

    def __init__(self, dataset, batch_size: int, mode: str = "train",
                 shuffle: Optional[bool] = None, drop_last: Optional[bool] = None,
                 buckets: Optional[ShapeBuckets] = None, seed: int = 0,
                 half_batch: bool = True, time_aug: bool = False,
                 pad_multiple: int = 1, njobs: int = 0,
                 host_rows: Optional[Tuple[int, int]] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.mode = mode
        # multi-host input sharding: host p of n decodes only its contiguous
        # row slice of every global batch (all hosts iterate the SAME group
        # order — same seed required across hosts); the solver reassembles
        # the global array on the device.
        # None or (0,1) = single-host (the default decode-first path).
        self.host_rows = None if host_rows in (None, (0, 1)) else host_rows
        # --njobs parity (reference src/data.py:127): number of host decode
        # workers; 0 = synchronous single worker
        self.njobs = max(0, njobs)
        # batch axis padded up to a multiple of the mesh 'data' axis so the
        # batch always shards evenly; padding rows replicate row 0 (real data,
        # so no NaN pathways) and carry utt_w = 0 (excluded from every loss)
        self.pad_multiple = max(1, pad_multiple)
        self.time_aug = time_aug and mode == "train"
        self.shuffle = (mode == "train") if shuffle is None else shuffle
        self.drop_last = self.shuffle if drop_last is None else drop_last
        self.buckets = buckets or ShapeBuckets()
        self.rng = np.random.default_rng(seed)
        self.half_batch = half_batch
        # contiguous groups over the duration-sorted dataset = bucketing
        n = len(dataset)
        self.groups: List[List[int]] = [
            list(range(i, min(i + batch_size, n)))
            for i in range(0, n, batch_size)]
        if self.drop_last and len(self.groups) > 1 and \
                len(self.groups[-1]) < batch_size:
            self.groups.pop()

    def __len__(self):
        return len(self.groups)

    def _decode_pool(self):
        if getattr(self, "_pool", None) is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=self.njobs)
        return self._pool

    def _emit(self, idxs: List[int]) -> Dict[str, np.ndarray]:
        items = [self.ds[i] for i in idxs]
        names = [it[0] if isinstance(it[0], str) else "utt%d" % i
                 for i, it in zip(idxs, items)]
        if self.njobs > 1 and isinstance(items[0][0], str):
            # --njobs worker threads overlap the audio decode (the flac
            # subprocess path in data/wav.py releases the GIL)
            wavs = list(self._decode_pool().map(_decode,
                                                [it[0] for it in items]))
        else:
            wavs = [_decode(it[0]) for it in items]
        txts = [np.asarray(it[1], np.int32) for it in items]
        if self.time_aug:
            # time-domain augmentation before features, like the reference's
            # ReadAudio (src/audio.py:303-305); sequential so the RNG draw
            # order stays deterministic regardless of njobs
            from e2e_asr_pytorch_tpu_torch.data.augment_time import augment_waveform
            wavs = [augment_waveform(w, self.rng) for w in wavs]

        max_s = max(len(w) for w in wavs)
        max_l = max(len(t) for t in txts)
        frames = max_s // HOP
        if (self.half_batch and self.mode == "train"
                and frames > HALF_BATCHSIZE_AUDIO_LEN and len(idxs) > 1):
            wavs, txts, names = wavs[::2], txts[::2], names[::2]

        cap_s, cap_l = self.buckets.lookup(max_s, max_l)
        n_real = len(wavs)
        b = _round_up(n_real, self.pad_multiple)
        wav = np.zeros((b, cap_s), np.float32)
        txt = np.zeros((b, cap_l), np.int32)
        wav_len = np.zeros((b,), np.int32)
        txt_len = np.zeros((b,), np.int32)
        for j, (w, t) in enumerate(zip(wavs, txts)):
            s, l = min(len(w), cap_s), min(len(t), cap_l)
            wav[j, :s] = w[:s]
            txt[j, :l] = t[:l]
            wav_len[j] = s
            txt_len[j] = int((t[:l] != 0).sum())
        if b > n_real:  # replicate row 0 into the padding rows
            wav[n_real:] = wav[0]
            txt[n_real:] = txt[0]
            wav_len[n_real:] = wav_len[0]
            txt_len[n_real:] = txt_len[0]
        utt_w = np.zeros((b,), np.float32)
        utt_w[:n_real] = 1.0
        return {"name": names, "wav": wav, "wav_len": wav_len,
                "txt": txt, "txt_len": txt_len, "utt_w": utt_w}

    def _item_samples(self, item) -> int:
        """Header-level length estimate (exact for wav/flac/arrays)."""
        if isinstance(item, str):
            from e2e_asr_pytorch_tpu_torch.data.native_loader import \
                estimate_pcm16_samples
            return estimate_pcm16_samples(item)
        return len(item)

    def _emit_hosted(self, idxs: List[int]) -> Dict[str, np.ndarray]:
        """Per-host emission: same global plan (halving, bucket caps,
        padded global batch) on every host, but only this host's contiguous
        row slice is decoded and returned."""
        p, n = self.host_rows
        sizes = [self._item_samples(self.ds[i][0]) for i in idxs]
        frames = max(sizes) // HOP
        if (self.half_batch and self.mode == "train"
                and frames > HALF_BATCHSIZE_AUDIO_LEN and len(idxs) > 1):
            idxs, sizes = idxs[::2], sizes[::2]
        max_l = max(len(self.ds[i][1]) for i in idxs)
        cap_s, cap_l = self.buckets.lookup(max(sizes), max_l)
        n_real = len(idxs)
        b_global = _round_up(_round_up(n_real, n), self.pad_multiple)
        rows = b_global // n
        lo = p * rows
        local_idxs = idxs[lo:min(lo + rows, n_real)]

        wav = np.zeros((rows, cap_s), np.float32)
        txt = np.zeros((rows, cap_l), np.int32)
        wav_len = np.zeros((rows,), np.int32)
        txt_len = np.zeros((rows,), np.int32)
        utt_w = np.zeros((rows,), np.float32)
        names = []
        # rng draw order must match across hosts -> one fold per global batch
        aug_rng = (np.random.default_rng(self.rng.integers(2 ** 31))
                   if self.time_aug else None)
        if not local_idxs:
            # all-padding slice: decode one real row so features stay finite
            local_idxs = [idxs[0]]
            pad_only = True
        else:
            pad_only = False
        items = [self.ds[i] for i in local_idxs]
        if self.njobs > 1 and isinstance(items[0][0], str):
            wavs = list(self._decode_pool().map(_decode,
                                                [it[0] for it in items]))
        else:
            wavs = [_decode(it[0]) for it in items]
        if aug_rng is not None:
            from e2e_asr_pytorch_tpu_torch.data.augment_time import augment_waveform
            wavs = [augment_waveform(w, aug_rng) for w in wavs]
        for j, (it, w) in enumerate(zip(items, wavs)):
            t = np.asarray(it[1], np.int32)
            s, l = min(len(w), cap_s), min(len(t), cap_l)
            wav[j, :s] = w[:s]
            txt[j, :l] = t[:l]
            wav_len[j] = s
            txt_len[j] = int((t[:l] != 0).sum())
            utt_w[j] = 0.0 if pad_only else 1.0
            names.append(it[0] if isinstance(it[0], str)
                         else "utt%d" % local_idxs[j])
        n_local = len(items)
        if n_local < rows:  # replicate the first local row into padding
            wav[n_local:] = wav[0]
            txt[n_local:] = txt[0]
            wav_len[n_local:] = wav_len[0]
            txt_len[n_local:] = txt_len[0]
        return {"name": names, "wav": wav, "wav_len": wav_len,
                "txt": txt, "txt_len": txt_len, "utt_w": utt_w,
                "global_batch": b_global}

    def _native_usable(self) -> bool:
        if self.time_aug or len(self.ds) == 0:
            return False
        item0 = self.ds[0][0]
        if not (isinstance(item0, str)
                and item0.endswith((".wav", ".flac"))):
            return False
        from e2e_asr_pytorch_tpu_torch.data import native_loader
        return native_loader.available()

    def _iter_native(self, order, depth: int = 3):
        """Pipelined iteration through the C++ loader: decode+pad runs in
        native worker threads `depth` batches ahead of the consumer."""
        from e2e_asr_pytorch_tpu_torch.data import native_loader as NL
        loader = NL.NativeBatchLoader(n_workers=max(1, self.njobs))
        try:
            plans = []
            for gi in order:
                idxs = list(self.groups[gi])
                paths = [self.ds[i][0] for i in idxs]
                est = max(NL.estimate_pcm16_samples(p) for p in paths)
                frames = est // HOP
                if (self.half_batch and self.mode == "train"
                        and frames > HALF_BATCHSIZE_AUDIO_LEN
                        and len(idxs) > 1):
                    idxs = idxs[::2]
                    paths = paths[::2]
                cap_s, cap_l = self.buckets.lookup(
                    est, max(len(self.ds[i][1]) for i in idxs))
                plans.append((idxs, paths, cap_s, cap_l))

            n = len(plans)
            submitted = 0
            for k in range(min(depth, n)):
                loader.submit(plans[k][1], plans[k][2])
                submitted += 1
            for j in range(n):
                idxs, paths, cap_s, cap_l = plans[j]
                wav, wav_len = loader.wait()
                if submitted < n:
                    loader.submit(plans[submitted][1], plans[submitted][2])
                    submitted += 1
                n_real = len(idxs)
                b = _round_up(n_real, self.pad_multiple)
                txt = np.zeros((b, cap_l), np.int32)
                txt_len = np.zeros((b,), np.int32)
                for row, i in enumerate(idxs):
                    t = np.asarray(self.ds[i][1], np.int32)
                    l = min(len(t), cap_l)
                    txt[row, :l] = t[:l]
                    txt_len[row] = int((t[:l] != 0).sum())
                if b > n_real:
                    wav = np.concatenate(
                        [wav, np.broadcast_to(wav[0], (b - n_real,) + wav.shape[1:])])
                    wav_len = np.concatenate(
                        [wav_len, np.broadcast_to(wav_len[0], (b - n_real,))])
                    txt[n_real:] = txt[0]
                    txt_len[n_real:] = txt_len[0]
                utt_w = np.zeros((b,), np.float32)
                utt_w[:n_real] = 1.0
                yield {"name": paths, "wav": wav, "wav_len": wav_len,
                       "txt": txt, "txt_len": txt_len, "utt_w": utt_w}
        finally:
            loader.close()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.groups))
        if self.shuffle:
            self.rng.shuffle(order)
        if self.host_rows is not None:
            for gi in order:
                yield self._emit_hosted(self.groups[gi])
            return
        if self._native_usable():
            yield from self._iter_native(order)
            return
        for gi in order:
            yield self._emit(self.groups[gi])


class TextBatchIterator:
    """LM batches: (B,L) int32 padded token ids, shape-bucketed by length.

    Keeps the reference's halving of very long text batches
    (HALF_BATCHSIZE_TEXT_LEN, src/collect_batch.py:87-88).
    """

    TOKEN_BUCKETS = (24, 48, 96, 160, 320, 640)

    def __init__(self, texts: List[List[int]], batch_size: int,
                 mode: str = "train", seed: int = 0, pad_multiple: int = 1):
        self.texts = texts
        self.batch_size = batch_size
        self.mode = mode
        # all-<pad> padding rows: masked CE / ppx token counts ignore them,
        # so no explicit weight vector is needed on the text path
        self.pad_multiple = max(1, pad_multiple)
        self.rng = np.random.default_rng(seed)
        n = len(texts)
        self.groups = [list(range(i, min(i + batch_size, n)))
                       for i in range(0, n, batch_size)]
        if mode == "train" and len(self.groups) > 1 and \
                len(self.groups[-1]) < batch_size:
            self.groups.pop()

    def __len__(self):
        return len(self.groups)

    def _bucket(self, l: int) -> int:
        for c in self.TOKEN_BUCKETS:
            if l <= c:
                return c
        return self.TOKEN_BUCKETS[-1]

    def __iter__(self):
        order = np.arange(len(self.groups))
        if self.mode == "train":
            self.rng.shuffle(order)
        for gi in order:
            idxs = self.groups[gi]
            seqs = [self.texts[i] for i in idxs]
            if self.mode == "train" and len(seqs[0]) > HALF_BATCHSIZE_TEXT_LEN:
                seqs = seqs[:max(1, len(seqs) // 2)]
            cap = self._bucket(max(len(s) for s in seqs))
            b = _round_up(len(seqs), self.pad_multiple)
            txt = np.zeros((b, cap), np.int32)
            txt_len = np.zeros((b,), np.int32)
            for j, s in enumerate(seqs):
                l = min(len(s), cap)
                txt[j, :l] = s[:l]
                txt_len[j] = l
            yield {"txt": txt, "txt_len": txt_len}


def prefetch(iterator, size: int = 2, to_device=None):
    """Run an iterator in a background thread, optionally moving batches to
    device (the host-to-device copy), keeping `size` batches in flight.

    Worker exceptions (corrupt audio file, loader OOM, ...) are captured and
    re-raised in the consumer thread — a failure must abort the epoch loudly,
    never silently truncate it (training infra discipline; the reference
    inherits the same property from torch DataLoader worker propagation).
    """
    q: "queue.Queue" = queue.Queue(maxsize=size)
    _END = object()
    _ERR = object()

    def worker():
        try:
            for batch in iterator:
                if to_device is not None:
                    batch = to_device(batch)
                q.put(batch)
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            q.put((_ERR, e))
        else:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
            raise RuntimeError(
                "prefetch worker failed while producing a batch"
            ) from item[1]
        yield item
