"""Kodak DCR/KDC compression 65000 codec (behavioral reference).

The reference app decodes Kodak RAWs through the ``rawloader`` crate
(reference: raw/loader.rs:50-54); the bitstream is the published
dcraw-lineage "kodak 65000" scheme:

- each image row is coded in independent 256-sample segments with a
  fresh predictor pair (even/odd columns alternate accumulators);
- a segment starts with nibble-packed per-sample bit lengths (the
  segment size rounded up to a multiple of 4); any length above 12
  marks an *uncompressed* segment instead: the decoder rewinds and
  reads groups of six little-endian u16s that carry eight 12-bit
  values (the two extra values are assembled from the six top
  nibbles);
- compressed payloads are consumed LSB-first out of a bit buffer
  refilled 32 bits at a time from big-endian u16 words in
  little-endian word order (the published ``(j ^ 8)`` refill); a
  segment whose rounded size is ``≡ 4 (mod 8)`` pre-reads one u16;
- residuals use the JPEG category mapping (raw top bit set → positive,
  else ``raw - (2^len - 1)``), accumulated onto the per-parity
  predictor; decoded samples must fit 12 bits.

This module is the scalar Python reference; the C++ extension carries
the fast decode path, and tests assert array equality. The encoder is
exact (lossless) for 12-bit data.

Provenance note: no camera files exist in this environment; decoding
is validated by round-trip against this encoder. docs/formats.md
records the risk.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

SEGMENT = 256


class _ByteStream:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("kodak65000: stream truncated")
        b = self.data[self.pos]
        self.pos += 1
        return b


def _decode_segment(src: _ByteStream, length: int) -> Tuple[bool, List[int]]:
    """One segment → (absolute?, values). ``absolute`` mirrors the
    published decoder's return: True = the uncompressed-shorts path
    (values are final), False = residuals for the predictor."""
    save = src.pos
    bsize = (length + 3) & ~3
    blen = [0] * (bsize + 1)
    for i in range(0, bsize, 2):
        c = src.byte()
        blen[i] = c & 15
        blen[i + 1] = c >> 4
        if blen[i] > 12 or blen[i + 1] > 12:
            # Uncompressed segment: rewind, read 6 LE u16s per 8 values.
            src.pos = save
            out = [0] * bsize
            for i in range(0, bsize, 8):
                raw = []
                for _ in range(6):
                    lo = src.byte()
                    hi = src.byte()
                    raw.append(lo | (hi << 8))
                out[i] = ((raw[0] >> 12) << 8 | (raw[2] >> 12) << 4
                          | (raw[4] >> 12))
                out[i + 1] = ((raw[1] >> 12) << 8 | (raw[3] >> 12) << 4
                              | (raw[5] >> 12))
                for j in range(6):
                    if i + 2 + j < bsize:
                        out[i + 2 + j] = raw[j] & 0xFFF
            return True, out[:length]

    bitbuf = 0
    bits = 0
    if bsize & 7 == 4:
        bitbuf = (src.byte() << 8) | src.byte()
        bits = 16
    out = []
    for i in range(bsize):
        ln = blen[i]
        if bits < ln:
            # 32-bit refill: big-endian u16 words, LE word order
            # (the published (j ^ 8) byte placement).
            for j in (8, 0, 24, 16):
                bitbuf += src.byte() << (bits + j)
            bits += 32
        diff = bitbuf & ((1 << ln) - 1)
        bitbuf >>= ln
        bits -= ln
        if ln and not (diff & (1 << (ln - 1))):
            diff -= (1 << ln) - 1
        out.append(diff)
    return False, out[:length]


def decode_kodak65000(data: bytes, width: int, height: int) -> np.ndarray:
    """Decode a compression-65000 payload to an (H, W) u16 mosaic."""
    src = _ByteStream(data)
    out = np.zeros((height, width), np.uint16)
    for row in range(height):
        for col in range(0, width, SEGMENT):
            length = min(SEGMENT, width - col)
            absolute, vals = _decode_segment(src, length)
            pred = [0, 0]
            for i, v in enumerate(vals):
                if absolute:
                    pix = v
                else:
                    pred[i & 1] += v
                    pix = pred[i & 1]
                if pix >> 12:
                    raise ValueError(
                        f"kodak65000 sample {pix} out of range")
                out[row, col + i] = pix
    return out


class _SegWriter:
    """Inverse of the segment bit consumer: LSB-first bits packed into
    big-endian u16 words, LE word order, optional leading lone u16."""

    def __init__(self, lead16: bool):
        self.bits: List[int] = []  # LSB-first
        self.lead16 = lead16

    def put(self, value: int, ln: int):
        for k in range(ln):
            self.bits.append((value >> k) & 1)

    def flush(self) -> bytes:
        words = []
        bits = self.bits
        if self.lead16 and not bits:
            # The decoder pre-reads the lone u16 unconditionally.
            bits = [0] * 16
        take = 16 if self.lead16 else 32
        pos = 0
        while pos < len(bits):
            chunk = bits[pos : pos + take]
            chunk += [0] * (take - len(chunk))
            v = 0
            for k, b in enumerate(chunk):
                v |= b << k
            if take == 16:
                words.append(v)
            else:
                words.append(v & 0xFFFF)
                words.append(v >> 16)
            pos += take
            take = 32
        out = bytearray()
        for wv in words:
            out += bytes([(wv >> 8) & 0xFF, wv & 0xFF])  # big-endian u16
        return bytes(out)


def encode_kodak65000(mosaic: np.ndarray) -> bytes:
    """Exact inverse of :func:`decode_kodak65000` (compressed segments
    only; 12-bit samples)."""
    mosaic = np.asarray(mosaic, np.int64)
    height, width = mosaic.shape
    if mosaic.min(initial=0) < 0 or mosaic.max(initial=0) > 0xFFF:
        raise ValueError("kodak65000 samples must fit 12 bits")
    out = bytearray()
    for row in range(height):
        for col in range(0, width, SEGMENT):
            length = min(SEGMENT, width - col)
            bsize = (length + 3) & ~3
            pred = [0, 0]
            diffs = []
            for i in range(length):
                v = int(mosaic[row, col + i])
                diffs.append(v - pred[i & 1])
                pred[i & 1] = v
            diffs += [0] * (bsize - length)
            lens = []
            for d in diffs:
                ln = (abs(d)).bit_length()
                if ln > 12:
                    raise ValueError("residual exceeds 12 bits")
                lens.append(ln)
            for i in range(0, bsize, 2):
                out.append(lens[i] | (lens[i + 1] << 4))
            wtr = _SegWriter(lead16=(bsize & 7) == 4)
            for d, ln in zip(diffs, lens):
                if ln == 0:
                    continue
                raw = d if d >= 0 else d + (1 << ln) - 1
                wtr.put(raw, ln)
            out += wtr.flush()
    return bytes(out)
