"""Canon CRW (CIFF container + the original Canon CRW codec).

The reference app decodes Canon RAWs through the ``rawloader`` crate
(reference: raw/loader.rs:50-54), which includes the old CRW format —
though ``.crw`` is absent from the app's own import filter
(reference: main.rs:1852-1855), so this closes the rawloader
capability set rather than an import-path gap.

Container: CIFF ("Camera Image File Format", Canon's published heap
format). A 26-byte header (``II``/``MM``, u32 heap start, magic
``HEAPCCDR``) is followed by one root heap; the last 4 bytes of a heap
give the offset of its record directory (u16 count then 10-byte
records: u16 type, u32 length, u32 offset). Records with type bit
0x4000 store up to 8 data bytes inline; type bits 0x2800/0x3000 mark
sub-heaps, walked recursively.

Codec: the published dcraw-lineage Canon decompressor —

- samples are coded as 64-entry difference blocks, JPEG-style: a
  Huffman leaf is either an end-of-block (0x00 with a non-zero index),
  a 0xff filler, or ``(zero_run << 4) | bit_length`` followed by
  ``bit_length`` raw bits holding the JPEG-category residual;
- the first entry of every block uses a dedicated "first" tree (plain
  bit lengths 0..11 — it also carries the inter-block DC carry, which
  doubles its range); the other 63 use the "second" tree whose 162
  values are exactly {EOB, ZRL(0xf0)} plus every run 0..15 ×
  length 1..10 combination;
- decoded differences accumulate onto an even/odd-column predictor
  pair that resets to 512 at each row start; samples are 10 bits;
- rows are processed in bands of 8; the bit stream is MSB-first with
  JPEG-style 0x00 stuffing after 0xff bytes;
- the compressed stream sits at file offset 540 (after the optional
  low-bits plane); cameras that record 12 bits store the 2 LSBs of
  each sample as a packed plane at file offset 26, four samples per
  byte, LSB-first.

Tables: three first/second tree pairs (selected by the CIFF 0x1835
DecoderTable record). The count rows and value sets of all six tables
reproduce the published dcraw-lineage constants and are structurally
self-validating (``validate_tables``): every second tree is a
permutation of the full 162-value run/size set, every first tree of
lengths 0..11 + filler. Within ``second tree 1`` the ordering of 18
positions deep in its uniform 16-bit bucket could not be reproduced
byte-exactly and was repaired set-consistently (marked below); all
codes in that bucket share one bit length, so round-trip exactness is
unaffected — only real-stream compatibility of table 1's rarest codes
carries extra risk. No camera files exist in this environment; decode
is validated by round-trip against the exact encoder in this module
(risk recorded in docs/formats.md).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from raweditor_tpu_torch.raw.types import RawImage

HEADER_LEN = 26
STREAM_OFFSET = 540  # compressed sensor stream (published constant)
LOWBITS_OFFSET = 26  # 2-LSB plane for 12-bit cameras

# --- decision-tree tables --------------------------------------------------

FIRST_TREES: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...] = (
    ((0, 1, 4, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0),
     (0x04, 0x03, 0x05, 0x06, 0x02, 0x07, 0x01, 0x08, 0x09, 0x00,
      0x0a, 0x0b, 0xff)),
    ((0, 2, 2, 3, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0, 0),
     (0x03, 0x02, 0x04, 0x01, 0x05, 0x00, 0x06, 0x07, 0x09, 0x08,
      0x0a, 0x0b, 0xff)),
    ((0, 0, 6, 3, 1, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0),
     (0x06, 0x05, 0x07, 0x04, 0x08, 0x03, 0x09, 0x02, 0x00, 0x0a,
      0x01, 0x0b, 0xff)),
)

SECOND_TREES: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...] = (
    ((0, 2, 2, 2, 1, 4, 2, 1, 2, 5, 1, 1, 0, 0, 0, 139),
     (0x03, 0x04, 0x02, 0x05, 0x01, 0x06, 0x07, 0x08,
      0x12, 0x13, 0x11, 0x14, 0x09, 0x15, 0x22, 0x00, 0x21, 0x16,
      0x0a, 0xf0,
      0x23, 0x17, 0x24, 0x31, 0x32, 0x18, 0x19, 0x33, 0x25, 0x41,
      0x34, 0x42, 0x35, 0x51, 0x36, 0x37, 0x38, 0x29, 0x79, 0x26,
      0x1a, 0x39, 0x56, 0x57, 0x28, 0x27, 0x52, 0x55, 0x58, 0x43,
      0x76, 0x59, 0x77, 0x54, 0x61, 0xf9, 0x71, 0x78, 0x75, 0x96,
      0x97, 0x49, 0xb7, 0x53, 0xd7, 0x74, 0xb6, 0x98, 0x47, 0x48,
      0x95, 0x69, 0x99, 0x91, 0xfa, 0xb8, 0x68, 0xb5, 0xb9, 0xd6,
      0xf7, 0xd8, 0x67, 0x46, 0x45, 0x94, 0x89, 0xf8, 0x81, 0xd5,
      0xf6, 0xb4, 0x88, 0xb1, 0x2a, 0x44, 0x72, 0xd9, 0x87, 0x66,
      0xd4, 0xf5, 0x3a, 0xa7, 0x73, 0xa9, 0xa8, 0x86, 0x62, 0xc7,
      0x65, 0xc8, 0xc9, 0xa1, 0xf4, 0xd1, 0xe9, 0x5a, 0x92, 0x85,
      0xa6, 0xe7, 0x93, 0xe8, 0xc1, 0xc6, 0x7a, 0x64, 0xe1, 0x4a,
      0x6a, 0xe6, 0xb3, 0xf1, 0xd3, 0xa5, 0x8a, 0xb2, 0x9a, 0xba,
      0x84, 0xa4, 0x63, 0xe5, 0xc5, 0xf3, 0xd2, 0xc4, 0x82, 0xaa,
      0xda, 0xe4, 0xf2, 0xca, 0x83, 0xa3, 0xa2, 0xc3, 0xea, 0xc2,
      0xe2, 0xe3)),
    # Positions 102..161 of this table's 16-bit bucket are the
    # set-consistent repair described in the module docstring.
    ((0, 2, 2, 1, 4, 1, 4, 1, 3, 3, 1, 0, 0, 0, 0, 140),
     (0x02, 0x03, 0x01, 0x04, 0x05, 0x12, 0x11, 0x06, 0x13, 0x07,
      0x08, 0x14, 0x22, 0x09, 0x21, 0x00, 0x23, 0x15, 0x31, 0x32,
      0x0a, 0x16, 0xf0, 0x24, 0x33, 0x41, 0x42, 0x19, 0x17, 0x25,
      0x18, 0x51, 0x34, 0x43, 0x52, 0x29, 0x35, 0x61, 0x39, 0x71,
      0x62, 0x36, 0x53, 0x26, 0x38, 0x1a, 0x37, 0x81, 0x27, 0x91,
      0x79, 0x55, 0x45, 0x28, 0x72, 0x59, 0xa1, 0xb1, 0x44, 0x69,
      0x54, 0x58, 0xd1, 0xfa, 0x57, 0xe1, 0xf1, 0xb9, 0x49, 0x47,
      0x63, 0x6a, 0xf9, 0x56, 0x46, 0xa8, 0x2a, 0x4a, 0x78, 0x99,
      0x3a, 0x75, 0x74, 0x86, 0x65, 0xc1, 0x76, 0xb6, 0x96, 0xd6,
      0x89, 0x85, 0xc9, 0xf5, 0x95, 0xb4, 0xc7, 0x73, 0x8a, 0x66,
      0xd8, 0x87, 0xf2, 0xe8, 0xd7, 0x98, 0xb7, 0xe7, 0x48, 0xa6,
      0x67, 0x68, 0xd9, 0x64, 0xba, 0x97, 0xa5, 0xc5, 0x5a, 0xe9,
      0xda, 0xa4, 0xea, 0xf3, 0xca, 0x88, 0xb5, 0x7a, 0xf7, 0x77,
      0xf4, 0x94, 0xe6, 0xf6, 0xc6, 0xaa, 0xa9, 0x82, 0x92, 0x9a,
      0xf8, 0xc4, 0xc3, 0xd5, 0xd4, 0xe4, 0xa7, 0xe5, 0xa2, 0xb2,
      0xe3, 0xb8, 0xb3, 0xe2, 0xc2, 0xa3, 0xc8, 0x93, 0x84, 0xd3,
      0xd2, 0x83)),
    ((0, 0, 6, 2, 1, 3, 3, 2, 5, 1, 2, 2, 8, 10, 0, 117),
     (0x04, 0x05, 0x03, 0x06, 0x02, 0x07, 0x01, 0x08, 0x09, 0x12,
      0x13, 0x14, 0x11, 0x15, 0x0a, 0x16, 0x17, 0xf0, 0x00, 0x22,
      0x21, 0x18, 0x23, 0x19, 0x24, 0x32, 0x31, 0x25, 0x33, 0x38,
      0x37, 0x34, 0x35, 0x36, 0x39, 0x79, 0x57, 0x58, 0x59, 0x28,
      0x56, 0x78, 0x27, 0x41, 0x29, 0x77, 0x26, 0x42, 0x76, 0x99,
      0x1a, 0x55, 0x98, 0x97, 0xf9, 0x48, 0x54, 0x96, 0x89, 0x47,
      0xb7, 0x49, 0xfa, 0x75, 0x68, 0xb6, 0x67, 0x69, 0xb9, 0xb8,
      0xd8, 0x52, 0xd7, 0x88, 0xb5, 0x74, 0x51, 0x46, 0xd9, 0xf8,
      0x3a, 0xd6, 0x87, 0x45, 0x7a, 0x95, 0xd5, 0xf6, 0x86, 0xb4,
      0xa9, 0x94, 0x53, 0x2a, 0xa8, 0x43, 0xf5, 0xf7, 0xd4, 0x66,
      0xa7, 0x5a, 0x44, 0x8a, 0xc9, 0xe8, 0xc8, 0xe7, 0x9a, 0x6a,
      0x73, 0x4a, 0x61, 0xc7, 0xf4, 0xc6, 0x65, 0xe9, 0x72, 0xe6,
      0x71, 0x91, 0x93, 0xa6, 0xda, 0x92, 0x85, 0x62, 0xf3, 0xc5,
      0xb2, 0xa4, 0x84, 0xba, 0x64, 0xa5, 0xb3, 0xd2, 0x81, 0xe5,
      0xd3, 0xaa, 0xc4, 0xca, 0xf2, 0xb1, 0xe4, 0xd1, 0x83, 0x63,
      0xea, 0xc3, 0xe2, 0x82, 0xf1, 0xa3, 0xc2, 0xa1, 0xc1, 0xe3,
      0xa2, 0xe1)),
)


def validate_tables() -> None:
    """Structural self-check: count rows sum to the value counts and
    the value multisets are exactly the sets the codec's value ranges
    require. Raises AssertionError on violation (pinned by tests)."""
    exp_first = set(range(0x0C)) | {0xFF}
    exp_second = {0x00, 0xF0} | {
        (r << 4) | s for r in range(16) for s in range(1, 11)
    }
    for trees, expected in ((FIRST_TREES, exp_first),
                            (SECOND_TREES, exp_second)):
        for counts, values in trees:
            assert len(counts) == 16
            assert sum(counts) == len(values)
            assert len(set(values)) == len(values)
            assert set(values) == expected


# --- canonical Huffman build ----------------------------------------------


def _build_codes(spec) -> Tuple[Dict[Tuple[int, int], int],
                                Dict[int, Tuple[int, int]]]:
    """Canonical code assignment: lengths ascending, values in listed
    order (the published LUT construction). Returns
    (decode {(length, code): value}, encode {value: (length, code)})."""
    counts, values = spec
    decode: Dict[Tuple[int, int], int] = {}
    encode: Dict[int, Tuple[int, int]] = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            v = values[k]
            decode[(length, code)] = v
            encode.setdefault(v, (length, code))
            k += 1
            code += 1
        code <<= 1
    return decode, encode


_TABLE_CACHE: Dict[int, Tuple] = {}


def _tables(table: int):
    table = min(max(int(table), 0), 2)
    if table not in _TABLE_CACHE:
        _TABLE_CACHE[table] = (_build_codes(FIRST_TREES[table]),
                               _build_codes(SECOND_TREES[table]))
    return _TABLE_CACHE[table]


# --- bit IO (MSB-first, JPEG-style 0x00 stuffing after 0xff) ---------------


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.buf = 0
        self.nbits = 0

    def _fill_byte(self) -> None:
        if self.pos >= len(self.data):
            raise ValueError("canon crw: bit stream truncated")
        c = self.data[self.pos]
        self.pos += 1
        if c == 0xFF:
            if self.pos >= len(self.data):
                raise ValueError("canon crw: bit stream truncated")
            if self.data[self.pos] != 0x00:
                # ff followed by non-zero = end of data in the
                # published reader; hitting it mid-decode is corrupt.
                raise ValueError("canon crw: unexpected marker in stream")
            self.pos += 1
        self.buf = ((self.buf << 8) | c) & 0xFFFFFFFF
        self.nbits += 8

    def bits(self, n: int) -> int:
        while self.nbits < n:
            self._fill_byte()
        self.nbits -= n
        return (self.buf >> self.nbits) & ((1 << n) - 1)

    def huff(self, decode: Dict[Tuple[int, int], int]) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.bits(1)
            v = decode.get((length, code))
            if v is not None:
                return v
        raise ValueError("canon crw: invalid huffman code")


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, value: int, length: int) -> None:
        if length == 0:
            return
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            self.nbits -= 8
            b = (self.acc >> self.nbits) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)
        self.acc &= (1 << self.nbits) - 1

    def flush(self) -> bytes:
        if self.nbits:
            b = (self.acc << (8 - self.nbits)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)
            self.acc = 0
            self.nbits = 0
        return bytes(self.out)


# --- the codec -------------------------------------------------------------


def _check_band_shape(width: int, height: int) -> None:
    row = 0
    while row < height:
        band = min(8, height - row)
        if (band * width) % 64:
            raise ValueError(
                "canon crw: band of %d rows x %d cols is not 64-sample "
                "aligned" % (band, width)
            )
        row += band


def decode_canon_stream(data: bytes, width: int, height: int,
                        table: int = 0) -> np.ndarray:
    """Decode the compressed stream into the (H, W) 10-bit high-order
    sample plane (low-bits merging is the caller's job)."""
    return _decode_canon_stream(data, width, height, table)[0]


def _decode_canon_stream(data: bytes, width: int, height: int,
                         table: int) -> Tuple[np.ndarray, int]:
    """(mosaic, bytes consumed) — the consumption count lets the
    file-level decoder reject a mode guess that only decodes a prefix
    of the sensor payload (see ``decode_crw``)."""
    _check_band_shape(width, height)
    (first_dec, _), (second_dec, _) = _tables(table)
    br = _BitReader(data)
    out = np.empty(height * width, np.uint16)
    carry = 0
    pnum = 0
    base = [0, 0]
    row = 0
    while row < height:
        band = min(8, height - row)
        npix = band * width
        pos0 = row * width
        for block in range(npix >> 6):
            diffbuf = [0] * 64
            i = 0
            while i < 64:
                leaf = br.huff(first_dec if i == 0 else second_dec)
                if leaf == 0 and i:
                    break
                if leaf != 0xFF:
                    i += leaf >> 4
                    ln = leaf & 15
                    if ln:
                        diff = br.bits(ln)
                        if not (diff & (1 << (ln - 1))):
                            diff -= (1 << ln) - 1
                        if i < 64:
                            diffbuf[i] = diff
                i += 1
            diffbuf[0] += carry
            carry = diffbuf[0]
            boff = pos0 + (block << 6)
            for i in range(64):
                if pnum % width == 0:
                    base[0] = base[1] = 512
                pnum += 1
                base[i & 1] += diffbuf[i]
                v = base[i & 1]
                if v >> 10:
                    raise ValueError("canon crw: sample out of 10-bit range")
                out[boff + i] = v
        row += band
    return out.reshape(height, width), br.pos


def _category(diff: int) -> int:
    return abs(diff).bit_length()


def encode_canon_stream(high: np.ndarray, table: int = 0) -> bytes:
    """Exact encoder for the 10-bit high-order plane (inverse of
    ``decode_canon_stream``; lossless)."""
    height, width = high.shape
    _check_band_shape(width, height)
    if high.max(initial=0) > 1023:
        raise ValueError("canon crw: high-order plane must be 10-bit")
    (_, first_enc), (_, second_enc) = _tables(table)
    bw = _BitWriter()
    vals = np.asarray(high, np.int32).reshape(-1)
    carry = 0
    pnum = 0
    base = [0, 0]
    total = height * width

    def put_leaf(enc, leaf):
        length, code = enc[leaf]
        bw.put(code, length)

    def put_residual(diff, n):
        bw.put(diff if diff >= 0 else diff + (1 << n) - 1, n)

    for boff in range(0, total, 64):
        diffbuf = [0] * 64
        for i in range(64):
            if pnum % width == 0:
                base[0] = base[1] = 512
            pnum += 1
            v = int(vals[boff + i])
            diffbuf[i] = v - base[i & 1]
            base[i & 1] = v
        t0 = diffbuf[0] - carry
        carry = diffbuf[0]
        n = _category(t0)
        put_leaf(first_enc, n)
        put_residual(t0, n)
        run = 0
        for i in range(1, 64):
            d = diffbuf[i]
            if d == 0:
                run += 1
                continue
            while run >= 16:
                put_leaf(second_enc, 0xF0)
                run -= 16
            n = _category(d)
            put_leaf(second_enc, (run << 4) | n)
            put_residual(d, n)
            run = 0
        if run:
            put_leaf(second_enc, 0x00)  # EOB
    return bw.flush()


def pack_lowbits(low: np.ndarray) -> bytes:
    """2-LSB plane, four samples per byte, LSB-first (the published
    layout read back at file offset 26)."""
    flat = np.asarray(low, np.uint8).reshape(-1)
    if flat.size % 4:
        raise ValueError("canon crw: sample count not a multiple of 4")
    g = flat.reshape(-1, 4)
    packed = g[:, 0] | (g[:, 1] << 2) | (g[:, 2] << 4) | (g[:, 3] << 6)
    return packed.astype(np.uint8).tobytes()


def unpack_lowbits(data: bytes, count: int) -> np.ndarray:
    need = (count + 3) // 4
    if len(data) < need:
        raise ValueError("canon crw: low-bits plane truncated")
    b = np.frombuffer(data, np.uint8, count=need)
    out = np.empty(need * 4, np.uint8)
    out[0::4] = b & 3
    out[1::4] = (b >> 2) & 3
    out[2::4] = (b >> 4) & 3
    out[3::4] = (b >> 6) & 3
    return out[:count]


def canon_has_lowbits(data: bytes) -> bool:
    """The published heuristic: scan bytes 540..16K; the first 0xff
    followed by 0x00 means a low-bits plane is present; 0xff bytes
    never followed by 0x00 mean none; no 0xff defaults to present.
    ``decode_crw`` additionally falls back to trial decode because
    synthetic planes lack real sensor-noise statistics."""
    window = data[STREAM_OFFSET:0x4000]
    ret = True
    for i in range(len(window) - 1):
        if window[i] == 0xFF:
            if window[i + 1] == 0x00:
                return True
            ret = False
    return ret


# --- CIFF container --------------------------------------------------------

TAG_RAW_DATA = 0x2005
TAG_JPG_FROM_RAW = 0x2007
TAG_THUMBNAIL = 0x2008
TAG_SENSOR_INFO = 0x1031
TAG_DECODER_TABLE = 0x1835
TAG_WHITE_BALANCE = 0x10A9
TAG_MAKE_MODEL = 0x080A

_SUBHEAP_DTYPES = (0x2800, 0x3000)


def is_ciff(data: bytes) -> bool:
    return (len(data) >= 14 and data[0:2] in (b"II", b"MM")
            and data[6:14] == b"HEAPCCDR")


class CiffFile:
    """Recursive CIFF heap walk. ``records`` maps tag id -> payload
    bytes (shallowest-first occurrence wins)."""

    def __init__(self, data: bytes):
        if not is_ciff(data):
            raise ValueError("not a CIFF file")
        self.data = data
        self.order = "<" if data[0:2] == b"II" else ">"
        (self.heap_start,) = struct.unpack_from(self.order + "I", data, 2)
        if not HEADER_LEN <= self.heap_start <= len(data) - 4:
            raise ValueError("CIFF: implausible heap start")
        self.records: Dict[int, bytes] = {}
        self._walk(self.heap_start, len(data), 0)

    def _u16(self, off: int) -> int:
        return struct.unpack_from(self.order + "H", self.data, off)[0]

    def _u32(self, off: int) -> int:
        return struct.unpack_from(self.order + "I", self.data, off)[0]

    def _walk(self, start: int, end: int, depth: int) -> None:
        if depth > 4 or end - start < 6:
            return
        dir_off = start + self._u32(end - 4)
        if not start <= dir_off <= end - 6:
            if depth == 0:
                raise ValueError("CIFF: directory offset out of range")
            return
        n = self._u16(dir_off)
        pos = dir_off + 2
        for _ in range(n):
            if pos + 10 > end:
                break
            t = self._u16(pos)
            tag = t & 0x3FFF
            if t & 0x4000:  # data stored in the record itself
                self.records.setdefault(tag, self.data[pos + 2:pos + 10])
            else:
                length = self._u32(pos + 2)
                off = self._u32(pos + 6)
                s = start + off
                e = s + length
                if start <= s <= e <= end:
                    self.records.setdefault(tag, self.data[s:e])
                    if (t & 0x3800) in _SUBHEAP_DTYPES:
                        self._walk(s, e, depth + 1)
            pos += 10

    # --- typed accessors ---------------------------------------------------

    def words(self, tag: int) -> Tuple[int, ...]:
        raw = self.records.get(tag, b"")
        n = len(raw) // 2
        return struct.unpack_from(self.order + "%dH" % n, raw, 0)

    def dimensions(self) -> Optional[Tuple[int, int]]:
        """(height, width) from SensorInfo words 1/2."""
        w = self.words(TAG_SENSOR_INFO)
        if len(w) >= 3 and w[1] > 0 and w[2] > 0:
            return int(w[2]), int(w[1])
        return None

    def decoder_table(self) -> int:
        raw = self.records.get(TAG_DECODER_TABLE)
        if raw is not None and len(raw) >= 4:
            return struct.unpack_from(self.order + "I", raw, 0)[0]
        return 0

    def wb_multipliers(self) -> Optional[np.ndarray]:
        """0x10a9 levels, stored R,G,G2,B (the published read swizzles
        word c into channel c ^ (c >> 1))."""
        w = self.words(TAG_WHITE_BALANCE)
        if len(w) >= 4 and all(v > 0 for v in w[:4]):
            r, g, g2, b = (float(v) for v in w[:4])
            return RawImage.normalize_wb([r, g, b, g2])
        return None

    def make_model(self) -> Tuple[str, str]:
        raw = self.records.get(TAG_MAKE_MODEL, b"")
        parts = raw.split(b"\0")
        make = parts[0].decode("ascii", "replace") if parts else ""
        model = parts[1].decode("ascii", "replace") if len(parts) > 1 else ""
        return make, model

    def preview_jpeg(self) -> Optional[bytes]:
        for tag in (TAG_JPG_FROM_RAW, TAG_THUMBNAIL):
            raw = self.records.get(tag)
            if raw and raw[:2] == b"\xff\xd8":
                return raw
        return None


# --- file-level decode / encode -------------------------------------------


def _merge_lowbits(high: np.ndarray, data: bytes) -> np.ndarray:
    h, w = high.shape
    low = unpack_lowbits(data[LOWBITS_OFFSET:], h * w).reshape(h, w)
    val = (high.astype(np.uint16) << 2) | low
    if w == 2672:
        # Published camera quirk for this sensor width.
        val = np.where(val < 512, val + 2, val)
    return val.astype(np.uint16)


def decode_crw(data: bytes, source_path: str = "") -> RawImage:
    """Full CRW decode: CIFF metadata + the published fixed-offset
    sensor layout (low-bits plane at 26, compressed stream at
    540 + plane size)."""
    cf = CiffFile(data)
    dims = cf.dimensions()
    if dims is None:
        raise ValueError("CRW without SensorInfo dimensions")
    height, width = dims
    if width * height > 16 * max(len(data), 1):
        raise ValueError(
            "implausible dimensions %dx%d for %d-byte file"
            % (width, height, len(data))
        )
    table = cf.decoder_table()
    raw_rec = cf.records.get(TAG_RAW_DATA)
    end = len(data)
    if raw_rec is not None:
        end = min(end, HEADER_LEN + len(raw_rec))
    plane = width * height // 4

    bounded = raw_rec is not None
    from raweditor_tpu_torch.native import get_rawkit

    rk = get_rawkit()
    use_native = rk is not None and hasattr(rk, "decode_canon_crw")

    def attempt(lowbits: bool) -> np.ndarray:
        off = STREAM_OFFSET + (plane if lowbits else 0)
        if off >= end:
            raise ValueError("canon crw: sensor payload truncated")
        payload = data[off:end]
        if use_native:
            raw, consumed = rk.decode_canon_crw(
                payload, width, height, min(max(int(table), 0), 2))
            high = np.frombuffer(raw, np.uint16).reshape(height, width)
        else:
            high, consumed = _decode_canon_stream(payload, width, height,
                                                  table)
        if bounded and consumed < len(payload) - 64:
            # A mode guess that only decodes a prefix of the bounded
            # sensor payload is the other mode's plane being
            # misread — reject it rather than return garbage.
            raise ValueError("canon crw: stream under-consumed")
        return _merge_lowbits(high, data) if lowbits else high

    first_guess = canon_has_lowbits(data)
    try:
        mosaic = attempt(first_guess)
        lowbits = first_guess
    except ValueError:
        mosaic = attempt(not first_guess)
        lowbits = not first_guess
    make, model = cf.make_model()
    wb = cf.wb_multipliers()
    return RawImage(
        mosaic=mosaic,
        wb_multipliers=(wb if wb is not None
                        else np.ones(4, np.float32)),
        wb_is_default=wb is None,
        xyz_to_cam=np.eye(3, dtype=np.float32),
        black_level=0.0,
        white_level=4095.0 if lowbits else 1023.0,
        cfa_pattern="RGGB",
        camera_make=make or "Canon",
        camera_model=model,
        source_path=source_path,
    )


def write_crw(path, mosaic: np.ndarray, *, table: int = 0,
              lowbits: bool = True,
              wb: Optional[Tuple[float, float, float, float]] = None,
              make: str = "Canon", model: str = "PowerShot Synth",
              preview_jpeg: Optional[bytes] = None) -> bytes:
    """Synthetic CRW writer (structurally faithful: CIFF header, the
    fixed sensor-payload offsets, heap directory at EOF). ``mosaic``
    is 12-bit with ``lowbits`` (2 LSBs packed into the offset-26
    plane) or 10-bit without."""
    mosaic = np.asarray(mosaic, np.uint16)
    height, width = mosaic.shape
    _check_band_shape(width, height)
    if width == 2672:
        raise ValueError("width 2672 triggers the published camera quirk; "
                         "use another synth width")
    if lowbits:
        if mosaic.max(initial=0) > 4095:
            raise ValueError("12-bit mosaic required with lowbits")
        stream = encode_canon_stream(mosaic >> 2, table)
        plane = pack_lowbits(mosaic & 3)
    else:
        if mosaic.max(initial=0) > 1023:
            raise ValueError("10-bit mosaic required without lowbits")
        stream = encode_canon_stream(mosaic, table)
        plane = b""

    out = bytearray()
    out += b"II"
    out += struct.pack("<I", HEADER_LEN)
    out += b"HEAPCCDR"
    out += struct.pack("<I", 0x00010002)
    out += bytes(8)
    assert len(out) == HEADER_LEN
    out += plane
    pad_to = STREAM_OFFSET + len(plane)
    out += bytes(pad_to - len(out))
    out += stream
    raw_len = len(out) - HEADER_LEN

    # heap blobs + directory ------------------------------------------------
    records: List[Tuple[int, int, int]] = [
        (TAG_RAW_DATA, raw_len, 0),
    ]

    def add_blob(tag: int, payload: bytes):
        records.append((tag, len(payload), len(out) - HEADER_LEN))
        out.extend(payload)

    if preview_jpeg:
        add_blob(TAG_JPG_FROM_RAW, preview_jpeg)
    add_blob(TAG_MAKE_MODEL,
             make.encode("ascii") + b"\0" + model.encode("ascii") + b"\0")
    add_blob(TAG_SENSOR_INFO,
             struct.pack("<8H", 8, width, height, width, height, 0, 0, 0))
    add_blob(TAG_DECODER_TABLE, struct.pack("<2I", table, 0))
    if wb is not None:
        r, g, b, g2 = (float(x) for x in wb)
        scale = 1024.0
        add_blob(TAG_WHITE_BALANCE,
                 struct.pack("<4H", *(int(round(x * scale))
                                      for x in (r, g, g2, b))))
    dir_off = len(out) - HEADER_LEN
    out += struct.pack("<H", len(records))
    for tag, length, off in records:
        out += struct.pack("<HII", tag, length, off)
    out += struct.pack("<I", dir_off)

    blob = bytes(out)
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob
