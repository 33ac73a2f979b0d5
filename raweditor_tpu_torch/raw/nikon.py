"""Nikon compressed NEF (TIFF compression 34713) codec.

Nikon's in-house sensor compression: Huffman-coded horizontal/vertical
prediction residuals with hard-coded code tables selected by bit depth
and compression variant, plus a linearization curve stored in MakerNote
tag 0x0096. The algorithm is long-public (dcraw/libraw lineage,
`nikon_load_raw`); this is an independent implementation of that
published scheme — the Python behavioral reference, mirrored by the
fast C++ version in the native extension.

Caveat: no real Nikon files exist in this environment, so the Huffman
tables and curve parsing are validated by round-trip against our own
encoder (raw/synth.py writes structurally-faithful compressed NEFs),
not against camera output.

Bitstream layout (big-endian bits, no JPEG byte stuffing):
  per pixel: tree code → leaf byte (len = low nibble, shl = high
  nibble), then (len - shl) raw bits; residual reconstruction is
  JPEG-style category sign extension with the `shl` low-bit shortcut
  used by the lossy variants. First two columns of each row predict
  vertically (vpred), the rest horizontally by Bayer phase (hpred).

Curve metadata (MakerNote 0x0096, container byte order):
  ver0 ver1 | [2110-byte skip for 0x49/0x58] | vpred[2][2] u16 |
  csize u16 | curve samples | (lossy type 2: split u16 at offset 562).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

# Hard-coded code-length trees, indexed: 0 = 12-bit lossy,
# 1 = 12-bit lossy after split, 2 = 12-bit lossless, 3..5 = the same
# three for 14-bit. Format: (bits[1..16], leaf values).
NIKON_TREES = (
    ((0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0),
     (5, 4, 3, 6, 2, 7, 1, 0, 8, 9, 11, 10, 12)),
    ((0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0),
     (0x39, 0x5A, 0x38, 0x27, 0x16, 5, 4, 3, 2, 1, 0, 11, 12, 12)),
    ((0, 1, 4, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0),
     (5, 4, 6, 3, 7, 2, 8, 1, 9, 0, 10, 11, 12)),
    ((0, 1, 4, 3, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0),
     (5, 6, 4, 7, 8, 3, 9, 2, 1, 0, 10, 11, 12, 13, 14)),
    ((0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0),
     (8, 0x5C, 0x4B, 0x3A, 0x29, 7, 6, 5, 4, 3, 2, 1, 0, 13, 14)),
    ((0, 1, 4, 2, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0),
     (7, 6, 8, 5, 9, 4, 10, 3, 11, 12, 2, 0, 1, 13, 14)),
)


def _canonical(tree) -> dict:
    """(length, code) -> leaf value. Leaf lists shorter than sum(bits)
    are implicitly zero-padded (the published tables are 32-byte
    zero-filled arrays; tree 0 relies on a trailing 0 leaf)."""
    bits, values = tree
    table = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[(length, code)] = values[k] if k < len(values) else 0
            code += 1
            k += 1
        code <<= 1
    return table


def _reverse(tree) -> dict:
    """leaf value -> (code, length), for the synthetic encoder."""
    return {v: (c, l) for (l, c), v in _canonical(tree).items()}


class LinearizationInfo:
    """Parsed MakerNote 0x0096 payload."""

    def __init__(self, vpred, curve, split, tree_index, max_value):
        self.vpred = vpred  # (2, 2) int
        self.curve = curve  # (>= max) u16 LUT
        self.split = split  # row where lossy streams switch trees (0 = no)
        self.tree_index = tree_index
        self.max_value = max_value


def parse_linearization(meta: bytes, bps: int, big_endian: bool = False
                        ) -> LinearizationInfo:
    """Decode the 0x0096 blob (see module docstring for layout)."""
    u16 = (">H" if big_endian else "<H")
    pos = 0
    ver0, ver1 = meta[0], meta[1]
    pos = 2
    if ver0 == 0x49 or ver1 == 0x58:
        pos += 2110
    tree = 0
    if ver0 == 0x46:
        tree = 2
    if bps == 14:
        tree += 3

    vpred = np.zeros((2, 2), np.int32)
    for i in range(2):
        for j in range(2):
            vpred[i, j] = struct.unpack_from(u16, meta, pos)[0]
            pos += 2
    max_value = (1 << bps) & 0x7FFF
    csize = struct.unpack_from(u16, meta, pos)[0]
    pos += 2
    step = max_value // (csize - 1) if csize > 1 else 0

    curve = np.arange(max_value, dtype=np.int64)
    split = 0
    if ver0 == 0x44 and ver1 == 0x20 and step > 0:
        samples = np.frombuffer(
            meta, dtype=(">u2" if big_endian else "<u2"), count=csize,
            offset=pos,
        ).astype(np.int64)
        # Linear interpolation between the sampled points.
        idx = np.arange(max_value, dtype=np.int64)
        lo = idx // step
        frac = idx % step
        lo_val = samples[np.minimum(lo, csize - 1)]
        hi_val = samples[np.minimum(lo + 1, csize - 1)]
        curve = (lo_val * (step - frac) + hi_val * frac) // step
        split = struct.unpack_from(u16, meta, 562)[0]
    elif ver0 != 0x46 and csize <= 0x4001:
        curve = np.frombuffer(
            meta, dtype=(">u2" if big_endian else "<u2"), count=csize,
            offset=pos,
        ).astype(np.int64)
        max_value = csize
    # Trailing plateau trim (flat tail of the LUT marks the true white
    # point).
    while max_value > 2 and curve[max_value - 2] == curve[max_value - 1]:
        max_value -= 1

    return LinearizationInfo(vpred, curve.astype(np.uint16), split, tree,
                             max_value)


class _BitReader:
    """MSB-first over raw bytes (no marker stuffing)."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.idx = 0

    def read_bit(self) -> int:
        if self.idx >= len(self.bits):
            return 0
        b = int(self.bits[self.idx])
        self.idx += 1
        return b

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v


def _gethuff(rdr: _BitReader, table: dict) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | rdr.read_bit()
        leaf = table.get((length, code))
        if leaf is not None:
            return leaf
    raise ValueError("invalid Nikon Huffman code")


def _decode_diff(rdr: _BitReader, leaf: int) -> int:
    length = leaf & 15
    shl = leaf >> 4
    if length == 0:
        return 0
    raw = rdr.read_bits(length - shl)
    diff = ((raw << 1) + 1) << shl >> 1
    if (diff & (1 << (length - 1))) == 0:
        diff -= (1 << length) - (0 if shl else 1)
    return diff


def decode_nikon(strip: bytes, width: int, height: int, bps: int,
                 info: LinearizationInfo) -> np.ndarray:
    """Decode the compressed strip to the (H, W) u16 mosaic."""
    rdr = _BitReader(strip)
    table = _canonical(NIKON_TREES[info.tree_index])
    vpred = info.vpred.copy()
    curve = info.curve
    cmax = len(curve)
    out = np.zeros((height, width), np.uint16)
    hpred = [0, 0]
    for row in range(height):
        if info.split and row == info.split:
            table = _canonical(NIKON_TREES[info.tree_index + 1])
        for col in range(width):
            diff = _decode_diff(rdr, _gethuff(rdr, table))
            if col < 2:
                vpred[row & 1, col] += diff
                hpred[col] = int(vpred[row & 1, col])
            else:
                hpred[col & 1] += diff
            out[row, col] = curve[min(max(hpred[col & 1], 0), cmax - 1)]
    return out


# ---------------------------------------------------------------------------
# Synthetic encoder (fixtures/benchmarks): writes the same bitstream and
# metadata the decoder consumes.
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, value: int, length: int):
        if length <= 0:
            return
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)

    def flush(self) -> bytes:
        if self.n:
            self.out.append((self.acc << (8 - self.n)) & 0xFF)
            self.n = 0
        return bytes(self.out)


def _encode_diff(wtr: _BitWriter, diff: int, codes: dict):
    """Category-encode one residual with shl == 0 leaves (the lossless
    trees carry only plain lengths)."""
    length = diff.bit_length() if diff >= 0 else (-diff).bit_length()
    if length not in codes:
        raise ValueError(f"residual category {length} not in tree")
    code, clen = codes[length]
    wtr.write(code, clen)
    if length:
        raw = diff if diff >= 0 else diff + (1 << length) - 1
        wtr.write(raw, length)


def encode_nikon(mosaic: np.ndarray, bps: int,
                 vpred_init: int = 0) -> Tuple[bytes, bytes]:
    """Encode a mosaic as a lossless Nikon stream.

    Returns (strip_bytes, meta_0x96_bytes) — identity curve, lossless
    tree for the given bit depth. Little-endian metadata (pair with an
    'II' container).
    """
    mosaic = np.asarray(mosaic, dtype=np.int32)
    h, w = mosaic.shape
    if mosaic.max(initial=0) >= (1 << bps):
        raise ValueError("sample exceeds bit depth")
    tree_index = 2 + (3 if bps == 14 else 0)
    codes = _reverse(NIKON_TREES[tree_index])

    # Vectorized residuals: cols >= 2 predict from two columns left
    # (same Bayer phase); cols 0-1 predict vertically from two rows up
    # (vpred chains), seeded with vpred_init.
    from raweditor_tpu_torch.raw import bitpack

    diffs = np.empty_like(mosaic)
    diffs[:, 2:] = mosaic[:, 2:] - mosaic[:, :-2]
    diffs[:2, :2] = mosaic[:2, :2] - vpred_init
    if h > 2:
        diffs[2:, :2] = mosaic[2:, :2] - mosaic[:-2, :2]
    flat = diffs.reshape(-1)
    max_cat = max(codes)
    code_tab = np.zeros(max_cat + 1, np.uint64)
    clen_tab = np.zeros(max_cat + 1, np.int64)
    for s, (code, length) in codes.items():
        code_tab[s], clen_tab[s] = code, length
    try:
        stream = bitpack.huffman_encode(flat, code_tab, clen_tab)
    except ValueError as exc:
        raise ValueError(f"residual category not in tree: {exc}") from exc

    # Metadata: ver0=0x46 (lossless), ver1=0x30, vpred, identity curve.
    max_value = (1 << bps) & 0x7FFF
    meta = bytearray()
    meta += bytes([0x46, 0x30])
    for i in range(2):
        for j in range(2):
            meta += struct.pack("<H", vpred_init)
    meta += struct.pack("<H", max_value)  # csize
    meta += np.arange(max_value, dtype="<u2").tobytes()  # identity curve
    return stream, bytes(meta)
