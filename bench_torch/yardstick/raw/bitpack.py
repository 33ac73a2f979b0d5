"""Vectorized variable-length bitfield concatenation.

Entropy encoders emit per-sample (value, bit-length) pairs; packing
them serially in Python is ~100 µs/sample. This builds the whole
bitstream with O(max_len) vectorized passes instead.
"""

from __future__ import annotations

import numpy as np


class MsbReader:
    """MSB-first bit reader (no byte stuffing); past-the-end reads as
    zeros, like the published decoders at EOF. Shared by the scalar
    Olympus/Pentax reference decoders."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        out = 0
        data = self.data
        nbytes = len(data)
        for _ in range(n):
            byte = self.pos >> 3
            bit = (data[byte] >> (7 - (self.pos & 7))) & 1 \
                if byte < nbytes else 0
            self.pos += 1
            out = (out << 1) | bit
        return out

    def peek(self, n: int) -> int:
        out = 0
        data = self.data
        nbytes = len(data)
        for k in range(n):
            byte = (self.pos + k) >> 3
            bit = (data[byte] >> (7 - ((self.pos + k) & 7))) & 1 \
                if byte < nbytes else 0
            out = (out << 1) | bit
        return out


class MsbWriter:
    """MSB-first bit writer, zero-padded tail (inverse of MsbReader)."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, length: int):
        if length <= 0:
            return
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)
        # Keep only the undrained low bits: without this the
        # accumulator is an ever-growing bigint on long streams.
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.out.append((self.acc << (8 - self.n)) & 0xFF)
            self.n = 0
        return bytes(self.out)


def concat_bitfields(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """MSB-first concatenation of variable-width fields.

    values: (N,) unsigned ints (only the low `lengths[i]` bits used).
    lengths: (N,) ints >= 0.
    Returns the packed bytes (zero-padded to a byte boundary).
    """
    values = np.asarray(values, dtype=np.uint64)
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return b""
    out = np.zeros(total, np.uint8)
    ends = np.cumsum(lengths)
    starts = ends - lengths
    for b in range(int(lengths.max())):
        sel = lengths > b
        pos = starts[sel] + b
        shift = (lengths[sel] - 1 - b).astype(np.uint64)
        out[pos] = ((values[sel] >> shift) & 1).astype(np.uint8)
    return np.packbits(out).tobytes()


def interleave_code_and_raw(codes, code_lens, raws, raw_lens) -> bytes:
    """Per sample emit (huffman code, then raw bits): the universal
    entropy-coding layout. All arrays (N,)."""
    n = len(codes)
    values = np.empty(2 * n, np.uint64)
    lengths = np.empty(2 * n, np.int64)
    values[0::2] = np.asarray(codes, np.uint64)
    values[1::2] = np.asarray(raws, np.uint64)
    lengths[0::2] = np.asarray(code_lens, np.int64)
    lengths[1::2] = np.asarray(raw_lens, np.int64)
    return concat_bitfields(values, lengths)


def huffman_encode(diffs: np.ndarray, code_tab: np.ndarray,
                   clen_tab: np.ndarray, max_raw_cat: int = 63) -> bytes:
    """Category-code residuals: per sample emit the category's Huffman
    code then ``cat`` raw magnitude bits (none for categories above
    ``max_raw_cat`` — JPEG's 16 case). MSB-first, zero-padded tail.

    Uses the C++ packer when available (the NumPy path is O(total
    bits) and takes minutes at 24 MP); both produce identical bytes
    (test_bitpack: native/NumPy equality).

    code_tab/clen_tab are indexed by category; clen 0 marks a category
    the tree cannot represent (raises ValueError).
    """
    diffs = np.asarray(diffs)
    if diffs.dtype not in (np.int16, np.int32, np.int64):
        diffs = diffs.astype(np.int64)
    diffs = np.ascontiguousarray(diffs)
    code_tab = np.ascontiguousarray(code_tab, np.uint64)
    clen_tab64 = np.ascontiguousarray(clen_tab, np.int64)

    from bench_torch.yardstick.native import get_rawkit

    kit = get_rawkit()
    if kit is not None and hasattr(kit, "huffman_pack"):
        return kit.huffman_pack(
            diffs, diffs.dtype.itemsize, code_tab,
            np.ascontiguousarray(clen_tab64, np.int32),
            int(max_raw_cat),
        )

    cats = category_of(diffs)
    if cats.max(initial=0) >= len(clen_tab64) or (
        clen_tab64[cats] <= 0
    ).any():
        raise ValueError("residual category not in tree")
    raws = raw_bits_of(diffs, cats)
    raw_lens = np.where(cats > max_raw_cat, 0, cats)
    raws = np.where(cats > max_raw_cat, 0, raws)
    return interleave_code_and_raw(
        code_tab[cats], clen_tab64[cats], raws, raw_lens
    )


def category_of(diffs: np.ndarray) -> np.ndarray:
    """JPEG difference category: bit length of |diff| (exact for
    |diff| < 2^53 via frexp)."""
    mag = np.abs(diffs.astype(np.int64))
    return np.frexp(mag.astype(np.float64))[1].astype(np.int64)


def raw_bits_of(diffs: np.ndarray, cats: np.ndarray) -> np.ndarray:
    """The category-coded magnitude: d >= 0 → d, else d + 2^cat - 1."""
    d = diffs.astype(np.int64)
    return np.where(d >= 0, d, d + (np.int64(1) << cats) - 1).astype(
        np.uint64
    )
