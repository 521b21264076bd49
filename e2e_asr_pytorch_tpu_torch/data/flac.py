"""Pure-Python FLAC codec (RFC 9639 subset).

LibriSpeech ships as FLAC; the reference reaches libsndfile through librosa
(reference: src/audio.py:289) — neither exists in this environment, so the
framework vendors its own decoder. The production path is the C++ decoder in
native/dataloader.cpp (same format subset, GIL-free, used by the batch
loader); this module is

  * the dependency-free FALLBACK decoder for `data.wav.read_audio`, and
  * a FLAC ENCODER used to build test fixtures that exercise every decoder
    path (constant / verbatim / fixed / LPC subframes, RICE residuals with
    multi-partition orders and escape codes, wasted bits are decode-only).

Decoder support: 8/12/16/20/24-bit, 1-8 channels (downmixed to mono float32),
fixed+variable blocking, left/right/mid-side decorrelation, RICE + RICE2.
Frame CRCs are written correctly by the encoder but not verified on decode.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

_FIXED_COEF = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


# ------------------------------------------------------------------ CRC

def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


# ----------------------------------------------------------- bit reader

class _BitReader:
    def __init__(self, data: bytes, byte: int = 0):
        self.data = data
        self.byte = byte
        self.bit = 0

    def bits(self, n: int) -> int:
        v = 0
        while n > 0:
            cur = self.data[self.byte]
            avail = 8 - self.bit
            take = min(n, avail)
            shift = avail - take
            v = (v << take) | ((cur >> shift) & ((1 << take) - 1))
            self.bit += take
            n -= take
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
        return v

    def sbits(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.bits(n)
        sign = 1 << (n - 1)
        return v - (sign << 1) if v & sign else v

    def unary(self) -> int:
        q = 0
        while True:
            cur = self.data[self.byte] & (0xFF >> self.bit)
            if cur == 0:
                q += 8 - self.bit
                self.bit = 0
                self.byte += 1
                continue
            lead = 8 - cur.bit_length()  # leading zeros within the byte
            q += lead - self.bit
            self.bit = lead + 1
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
            return q

    def align(self):
        if self.bit:
            self.bit = 0
            self.byte += 1

    def utf8_num(self) -> int:
        b0 = self.bits(8)
        if not b0 & 0x80:
            return b0
        n = 0
        m = 0x40
        while b0 & m:
            n += 1
            m >>= 1
        v = b0 & (m - 1)
        for _ in range(n):
            v = (v << 6) | (self.bits(8) & 0x3F)
        return v


# -------------------------------------------------------------- decoder

def _read_residual(br: _BitReader, blocksize: int, order: int) -> List[int]:
    method = br.bits(2)
    if method > 1:
        raise ValueError("reserved residual method")
    plen, escape = (4, 15) if method == 0 else (5, 31)
    po = br.bits(4)
    parts = 1 << po
    psize = blocksize >> po
    res: List[int] = []
    for p in range(parts):
        count = psize - (order if p == 0 else 0)
        param = br.bits(plen)
        if param == escape:
            raw = br.bits(5)
            res.extend(br.sbits(raw) if raw else 0 for _ in range(count))
        else:
            for _ in range(count):
                u = (br.unary() << param) | br.bits(param)
                res.append((u >> 1) ^ -(u & 1))
    return res


def _read_subframe(br: _BitReader, blocksize: int, bps: int) -> List[int]:
    if br.bits(1):
        raise ValueError("bad subframe padding bit")
    stype = br.bits(6)
    wasted = (br.unary() + 1) if br.bits(1) else 0
    bps -= wasted

    if stype == 0:  # CONSTANT
        smp = [br.sbits(bps)] * blocksize
    elif stype == 1:  # VERBATIM
        smp = [br.sbits(bps) for _ in range(blocksize)]
    elif (stype & 0x38) == 0x08 and (stype & 0x07) <= 4:  # FIXED
        order = stype & 0x07
        smp = [br.sbits(bps) for _ in range(order)]
        smp += _read_residual(br, blocksize, order)
        coef = _FIXED_COEF[order]
        for i in range(order, blocksize):
            smp[i] += sum(c * smp[i - 1 - j] for j, c in enumerate(coef))
    elif stype & 0x20:  # LPC
        order = (stype & 0x1F) + 1
        smp = [br.sbits(bps) for _ in range(order)]
        precision = br.bits(4) + 1
        shift = br.sbits(5)
        if precision == 16 or shift < 0:
            raise ValueError("invalid LPC parameters")
        coef = [br.sbits(precision) for _ in range(order)]
        smp += _read_residual(br, blocksize, order)
        for i in range(order, blocksize):
            acc = sum(c * smp[i - 1 - j] for j, c in enumerate(coef))
            smp[i] += acc >> shift
    else:
        raise ValueError("reserved subframe type %d" % stype)
    if wasted:
        smp = [s << wasted for s in smp]
    return smp


def decode_flac_bytes(data: bytes) -> Tuple[np.ndarray, int, int]:
    """FLAC blob -> (int32 samples (N, channels), sample_rate, bps)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    rate = channels = bps = 0
    total = 0
    last = False
    while not last:
        hdr = data[pos]
        last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        length = int.from_bytes(data[pos + 1:pos + 4], "big")
        pos += 4
        if btype == 0:
            si = data[pos:pos + 34]
            rate = (si[10] << 12) | (si[11] << 4) | (si[12] >> 4)
            channels = ((si[12] >> 1) & 0x07) + 1
            bps = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1
            total = ((si[13] & 0x0F) << 32) | int.from_bytes(si[14:18], "big")
        pos += length
    if not rate:
        raise ValueError("missing STREAMINFO")

    br = _BitReader(data, pos)
    out: List[List[int]] = []
    size_tab = {0: bps, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
    while br.byte + 2 < len(data):
        if br.bits(15) != 0x7FFC:
            raise ValueError("lost frame sync")
        br.bits(1)
        bs_code = br.bits(4)
        sr_code = br.bits(4)
        ch_asgn = br.bits(4)
        sz_code = br.bits(3)
        br.bits(1)
        br.utf8_num()
        if bs_code == 1:
            blocksize = 192
        elif 2 <= bs_code <= 5:
            blocksize = 576 << (bs_code - 2)
        elif bs_code == 6:
            blocksize = br.bits(8) + 1
        elif bs_code == 7:
            blocksize = br.bits(16) + 1
        elif bs_code >= 8:
            blocksize = 256 << (bs_code - 8)
        else:
            raise ValueError("reserved block size code")
        if sr_code == 12:
            br.bits(8)
        elif sr_code in (13, 14):
            br.bits(16)
        br.bits(8)  # header crc
        fbps = size_tab[sz_code]

        n_ch = ch_asgn + 1 if ch_asgn < 8 else 2
        chans = []
        for c in range(n_ch):
            extra = int((ch_asgn == 8 and c == 1) or (ch_asgn == 9 and c == 0)
                        or (ch_asgn == 10 and c == 1))
            chans.append(_read_subframe(br, blocksize, fbps + extra))
        br.align()
        br.bits(16)  # frame crc

        if ch_asgn == 8:    # left/side
            chans[1] = [l - s for l, s in zip(chans[0], chans[1])]
        elif ch_asgn == 9:  # side/right
            chans[0] = [s + r for s, r in zip(chans[0], chans[1])]
        elif ch_asgn == 10:  # mid/side
            left, right = [], []
            for m, s in zip(chans[0], chans[1]):
                m = (m << 1) | (s & 1)
                left.append((m + s) >> 1)
                right.append((m - s) >> 1)
            chans = [left, right]
        out.extend(zip(*chans))
        if total and len(out) >= total:
            break
    arr = np.asarray(out, np.int32)
    if total:
        arr = arr[:total]
    return arr, rate, bps


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode .flac -> (float32 mono in [-1,1), rate). Fallback path; the
    native C++ decoder (native/dataloader.cpp) is preferred when built."""
    with open(path, "rb") as f:
        samples, rate, bps = decode_flac_bytes(f.read())
    wav = samples.astype(np.float32).mean(axis=1) / float(1 << (bps - 1))
    return wav, rate


def flac_stream_info(path: str) -> Optional[Tuple[int, int, int, int]]:
    """Header-only (total_samples, rate, channels, bps); None if not FLAC."""
    with open(path, "rb") as f:
        head = f.read(42)
    if head[:4] != b"fLaC" or (head[4] & 0x7F) != 0:
        return None
    si = head[8:42]
    rate = (si[10] << 12) | (si[11] << 4) | (si[12] >> 4)
    channels = ((si[12] >> 1) & 0x07) + 1
    bps = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1
    total = ((si[13] & 0x0F) << 32) | int.from_bytes(si[14:18], "big")
    return total, rate, channels, bps


# -------------------------------------------------------------- encoder

class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def bits(self, v: int, n: int):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def unary(self, q: int):
        while q >= 32:
            self.bits(0, 32)
            q -= 32
        self.bits(1, q + 1)

    def align(self):
        if self.nbits:
            self.bits(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _utf8_num(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    out = []
    n = 1
    while v >= (1 << (6 - n)) << (6 * n) and n < 6:
        n += 1
    lead = (0xFF << (7 - n)) & 0xFF
    out.append(lead | (v >> (6 * n)))
    for i in range(n - 1, -1, -1):
        out.append(0x80 | ((v >> (6 * i)) & 0x3F))
    return bytes(out)


def _best_rice_param(res: np.ndarray) -> int:
    if len(res) == 0:
        return 0
    mean = float(np.abs(res).mean())
    p = 0
    while (1 << (p + 1)) < mean + 1 and p < 14:
        p += 1
    return p


def _write_residual(bw: _BitWriter, res: np.ndarray, blocksize: int,
                    order: int, partition_order: int):
    if blocksize % (1 << partition_order) != 0 or \
            (blocksize >> partition_order) <= order:
        partition_order = 0
    bw.bits(0, 2)  # RICE, 4-bit params
    bw.bits(partition_order, 4)
    parts = 1 << partition_order
    psize = blocksize >> partition_order
    start = 0
    for p in range(parts):
        count = psize - (order if p == 0 else 0)
        chunk = res[start:start + count]
        start += count
        param = _best_rice_param(chunk)
        # escape to raw encoding when rice would explode (rare; exercises
        # the decoder's escape path when fed pathological inputs)
        u = (np.abs(chunk.astype(np.int64)) << 1)
        worst = int((u >> param).sum()) + (param + 1) * count
        raw_bits = int(np.abs(chunk).max()).bit_length() + 1 if count else 1
        if worst > raw_bits * count + 5:
            bw.bits(15, 4)
            bw.bits(raw_bits, 5)
            for v in chunk:
                bw.bits(int(v) & ((1 << raw_bits) - 1), raw_bits)
        else:
            bw.bits(param, 4)
            for v in chunk:
                v = int(v)
                uz = (v << 1) ^ (v >> 63) if v < 0 else v << 1
                bw.unary(uz >> param)
                bw.bits(uz & ((1 << param) - 1), param)


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _lpc_coefs(x: np.ndarray, order: int,
               precision: int = 14) -> Optional[Tuple[List[int], int]]:
    """Levinson-Durbin + uniform quantization -> (int coefs, shift)."""
    xf = x.astype(np.float64)
    n = len(xf)
    if n <= order:
        return None
    ac = np.array([np.dot(xf[:n - k], xf[k:]) for k in range(order + 1)])
    if ac[0] == 0:
        return None
    err = ac[0]
    lpc = np.zeros(order)
    for i in range(order):
        acc = ac[i + 1] - np.dot(lpc[:i], ac[i:0:-1][:i])
        k = acc / err
        lpc[:i] = lpc[:i] - k * lpc[:i][::-1]
        lpc[i] = k
        err *= 1.0 - k * k
        if err <= 0:
            return None
    cmax = float(np.abs(lpc).max())
    if cmax == 0:
        return None
    shift = min(15, max(1, precision - 1 - int(np.ceil(np.log2(cmax + 1e-9)))))
    q = np.clip(np.round(lpc * (1 << shift)),
                -(1 << (precision - 1)), (1 << (precision - 1)) - 1)
    return [int(c) for c in q], shift


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int,
                     partition_order: int, use_lpc: bool,
                     force: Optional[str] = None):
    xi = x.astype(np.int64)
    if force == "verbatim":
        bw.bits(0, 1)
        bw.bits(1, 6)
        bw.bits(0, 1)
        for v in xi:
            bw.bits(int(v), bps)
        return
    if force == "constant" or (len(xi) and bool(np.all(xi == xi[0]))
                               and force is None):
        bw.bits(0, 1)
        bw.bits(0, 6)
        bw.bits(0, 1)
        bw.bits(int(xi[0]), bps)
        return

    # candidate predictors: fixed orders 0-2 (+LPC-8); pick min |residual|
    best = ("fixed", 0, _fixed_residual(xi, 0), None)
    cost = float(np.abs(best[2]).sum())
    for order in (1, 2, 3, 4):
        if len(xi) <= order:
            break
        r = _fixed_residual(xi, order)
        c = float(np.abs(r).sum())
        if c < cost:
            best, cost = ("fixed", order, r, None), c
    if use_lpc and len(xi) > 16:
        q = _lpc_coefs(xi, order=8)
        if q is not None:
            coefs, shift = q
            pred = np.zeros(len(xi), np.int64)
            for j, c in enumerate(coefs):
                pred[8:] += c * xi[8 - 1 - j:len(xi) - 1 - j]
            r = xi[8:] - (pred[8:] >> shift)
            c = float(np.abs(r).sum())
            if c < cost:
                best, cost = ("lpc", 8, r, (coefs, shift)), c

    kind, order, res, extra = best
    bw.bits(0, 1)
    if kind == "fixed":
        bw.bits(0x08 | order, 6)
        bw.bits(0, 1)  # no wasted bits
        for v in xi[:order]:
            bw.bits(int(v), bps)
    else:
        bw.bits(0x20 | (order - 1), 6)
        bw.bits(0, 1)
        coefs, shift = extra
        for v in xi[:order]:
            bw.bits(int(v), bps)
        bw.bits(14 - 1, 4)  # precision 14
        bw.bits(shift, 5)
        for c in coefs:
            bw.bits(c, 14)
    _write_residual(bw, res, len(xi), order, partition_order)


def encode_flac(pcm: np.ndarray, rate: int = 16000, bps: int = 16,
                blocksize: int = 4096, partition_order: int = 2,
                use_lpc: bool = True, stereo_mode: str = "independent",
                force_subframe: Optional[str] = None) -> bytes:
    """Encode int PCM (N,) or (N,C) -> FLAC blob. Fixture-grade encoder:
    correct CRCs, fixed blocking, per-block best of fixed-order/LPC-8
    prediction (or `force_subframe` in {'constant','verbatim'})."""
    pcm = np.asarray(pcm)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, channels = pcm.shape
    assert channels in (1, 2)

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.bits(blocksize, 16)
    si.bits(blocksize, 16)
    si.bits(0, 24)
    si.bits(0, 24)
    si.bits(rate, 20)
    si.bits(channels - 1, 3)
    si.bits(bps - 1, 5)
    si.bits(n, 36)
    for _ in range(16):
        si.bits(0, 8)  # md5 unset (permitted)
    body = si.bytes()
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    for fi, start in enumerate(range(0, n, blocksize)):
        block = pcm[start:start + blocksize]
        bs = len(block)
        ch_asgn = channels - 1
        subs = [block[:, c].astype(np.int64) for c in range(channels)]
        sub_bps = [bps] * channels
        if channels == 2 and stereo_mode != "independent":
            left, right = subs
            side = left - right
            if stereo_mode == "left_side":
                ch_asgn, subs, sub_bps = 8, [left, side], [bps, bps + 1]
            elif stereo_mode == "right_side":
                ch_asgn, subs, sub_bps = 9, [side, right], [bps + 1, bps]
            elif stereo_mode == "mid_side":
                mid = (left + right) >> 1
                ch_asgn, subs, sub_bps = 10, [mid, side], [bps, bps + 1]

        hdr = bytearray()
        hdr += struct.pack(">H", (0x3FFE << 2) | 0)  # sync+reserved+fixed-bs
        bs_code = 6 if bs <= 256 else 7
        hdr.append((bs_code << 4) | 0)  # sample rate code 0: from STREAMINFO
        sz_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}[bps]
        hdr.append((ch_asgn << 4) | (sz_code << 1))
        hdr += _utf8_num(fi)
        hdr += bytes([bs - 1]) if bs_code == 6 else struct.pack(">H", bs - 1)
        hdr.append(_crc8(bytes(hdr)))

        bw = _BitWriter()
        for s, b in zip(subs, sub_bps):
            _encode_subframe(bw, s, b, partition_order, use_lpc,
                             force=force_subframe)
        bw.align()
        frame = bytes(hdr) + bw.bytes()
        out += frame + struct.pack(">H", _crc16(frame))
    return bytes(out)


def write_flac(path: str, pcm: np.ndarray, rate: int = 16000, **kw) -> None:
    with open(path, "wb") as f:
        f.write(encode_flac(pcm, rate, **kw))
