"""Samsung SRW v1 codec (compression 32770) — behavioral reference.

The reference app decodes Samsung RAWs through the ``rawloader`` crate
(reference: raw/loader.rs:50-54). The v1 bitstream is the published
dcraw-lineage scheme:

- each image row is an independently-addressed bit stream (a per-row
  u32 offset table, relative to the sensor data start, lives at the
  file position named by TIFF tag 0xA010);
- the bit reader is the Phase-One style getter: a 64-bit buffer
  refilled 32 bits at a time from little-endian u32 words, consumed
  MSB-first;
- rows are coded in 16-pixel blocks: a direction bit (0 = horizontal
  prediction from the previous same-parity pixel, 128 at the row
  start; 1 = vertical — even pixels from the row above, odd pixels
  from two rows above), then four 2-bit opcodes adjusting the four
  group bit lengths (0 keep, 1 increment, 2 decrement, 3 = explicit
  4-bit length), where the groups are (even/odd pixel parity) x
  (first/second half of the block);
- the sixteen residuals follow with even pixels first then odd (the
  published ``c == 14 -> c = -1`` loop), each a sign-extended
  ``len``-bit value;
- rows 0 and 1 start with group lengths 7, later rows with 4;
- after decoding, same-CFA pixels are re-aligned by swapping
  ``(r, c+1)`` with ``(r+1, c)`` for even ``r``/``c`` (an involution,
  so the encoder pre-applies the same swap).

Samples are 12-bit. This module is the scalar Python reference; the
C++ extension carries the fast decode path and tests assert array
equality. The encoder is exact (it always uses opcode 3 with the
minimal group length, and vertical prediction on alternating blocks
from row 2 down, so both predictors are exercised).

Provenance note: no camera files exist in this environment; decoding
is validated by round-trip against this encoder (risk recorded in
docs/formats.md). The v3 scheme (compression 32772/alien variants) is
NOT implemented — its published details could not be reconstructed
with confidence.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

WHITE = 4095  # v1 cameras record 12 bits


class _Ph1Reader:
    """64-bit buffer, 32-bit LE-word refills, MSB-first consumption."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.nbits = 0

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        while self.nbits < n:
            if self.pos + 4 > len(self.data):
                raise ValueError("srw1: bit stream truncated")
            word = int.from_bytes(self.data[self.pos:self.pos + 4],
                                  "little")
            self.pos += 4
            self.buf = ((self.buf << 32) | word) & 0xFFFFFFFFFFFFFFFF
            self.nbits += 32
        self.nbits -= n
        return (self.buf >> self.nbits) & ((1 << n) - 1)


def _signed(v: int, n: int) -> int:
    if n == 0:
        return 0
    return v - (1 << n) if v & (1 << (n - 1)) else v


def _cfa_swap(m: np.ndarray) -> np.ndarray:
    out = m.copy()
    a = out[0:-1:2, 1::2].copy()
    out[0:-1:2, 1::2] = out[1::2, 0:-1:2]
    out[1::2, 0:-1:2] = a
    return out


_GROUP = [((c & 1) << 1) | (c >> 3) for c in range(16)]
_ORDER = list(range(0, 16, 2)) + list(range(1, 16, 2))


def decode_srw1(data: bytes, offsets: Sequence[int], width: int,
                height: int) -> np.ndarray:
    """Decode the sensor region ``data`` using the per-row ``offsets``
    (relative to the start of ``data``)."""
    if width % 16 or width <= 0 or height <= 0:
        raise ValueError("srw1: width must be a positive multiple of 16")
    if len(offsets) < height:
        raise ValueError("srw1: row offset table truncated")
    out = np.zeros((height, width), np.int32)
    for row in range(height):
        off = int(offsets[row])
        if not 0 <= off <= len(data):
            raise ValueError("srw1: row offset out of range")
        rd = _Ph1Reader(data, off)
        lens = [7, 7, 7, 7] if row < 2 else [4, 4, 4, 4]
        for col in range(0, width, 16):
            direction = rd.bits(1)
            ops = [rd.bits(2) for _ in range(4)]
            for g in range(4):
                if ops[g] == 3:
                    lens[g] = rd.bits(4)
                elif ops[g] == 2:
                    lens[g] -= 1
                elif ops[g] == 1:
                    lens[g] += 1
                if not 0 <= lens[g] <= 15:
                    raise ValueError("srw1: group length out of range")
            for c in _ORDER:
                n = lens[_GROUP[c]]
                diff = _signed(rd.bits(n), n)
                if direction:
                    # even pixels predict from the row above, odd from
                    # two rows above (the published (~c | -2) index)
                    pr = row - 1 if c % 2 == 0 else row - 2
                    if pr < 0:
                        raise ValueError(
                            "srw1: vertical prediction before row 2")
                    pred = int(out[pr, col + c])
                else:
                    pred = int(out[row, col + c - 2]) if col else 128
                v = pred + diff
                if not 0 <= v <= WHITE:
                    raise ValueError("srw1: sample out of 12-bit range")
                out[row, col + c] = v
    return _cfa_swap(out.astype(np.uint16))


class _Ph1Writer:
    def __init__(self):
        self.words: List[int] = []
        self.acc = 0
        self.nbits = 0

    def put(self, v: int, n: int) -> None:
        if n == 0:
            return
        self.acc = ((self.acc << n) | (v & ((1 << n) - 1)))
        self.nbits += n
        while self.nbits >= 32:
            self.nbits -= 32
            self.words.append((self.acc >> self.nbits) & 0xFFFFFFFF)
        self.acc &= (1 << self.nbits) - 1

    def flush(self) -> bytes:
        if self.nbits:
            self.words.append((self.acc << (32 - self.nbits)) & 0xFFFFFFFF)
            self.acc = 0
            self.nbits = 0
        return b"".join(w.to_bytes(4, "little") for w in self.words)


def _group_len(diffs: Sequence[int]) -> int:
    n = 0
    for d in diffs:
        need = 0 if d == 0 else (d.bit_length() + 1 if d > 0
                                 else (-d - 1).bit_length() + 1)
        n = max(n, need)
    if n > 15:
        raise ValueError("srw1: residual exceeds 15 bits")
    return n


def encode_srw1(mosaic: np.ndarray) -> Tuple[bytes, List[int]]:
    """Exact encoder; returns (sensor bytes, per-row offsets)."""
    mosaic = np.asarray(mosaic, np.uint16)
    height, width = mosaic.shape
    if width % 16 or width == 0:
        raise ValueError("srw1: width must be a positive multiple of 16")
    if mosaic.max(initial=0) > WHITE:
        raise ValueError("srw1: samples must be 12-bit")
    pre = _cfa_swap(mosaic).astype(np.int32)
    chunks: List[bytes] = []
    offsets: List[int] = []
    pos = 0
    for row in range(height):
        wr = _Ph1Writer()
        for col in range(0, width, 16):
            # vertical prediction on alternating blocks once legal
            direction = 1 if (row >= 2 and (col // 16 + row) % 2 == 0) \
                else 0
            diffs = [0] * 16
            for c in range(16):
                if direction:
                    pred = int(pre[row - 1 if c % 2 == 0 else row - 2,
                                   col + c])
                else:
                    pred = int(pre[row, col + c - 2]) if col else 128
                diffs[c] = int(pre[row, col + c]) - pred
            glen = [
                _group_len([diffs[c] for c in range(16) if _GROUP[c] == g])
                for g in range(4)
            ]
            wr.put(direction, 1)
            for g in range(4):
                wr.put(3, 2)  # opcode 3: explicit length follows
            for g in range(4):
                wr.put(glen[g], 4)
            for c in _ORDER:
                wr.put(diffs[c], glen[_GROUP[c]])
        blob = wr.flush()
        offsets.append(pos)
        chunks.append(blob)
        pos += len(blob)
    return b"".join(chunks), offsets
