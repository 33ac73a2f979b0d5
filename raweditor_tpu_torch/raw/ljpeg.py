"""Lossless JPEG (ITU-T T.81 process 14, SOF3) codec.

This is the compression used inside DNG lossless, CR2, and many other
RAW containers (TIFF Compression=7). The reference gets it for free from
``rawloader``; we implement it ourselves — a Python reference codec here
(used for tests/fixtures and as the fallback path), mirrored by a fast
C++ implementation in the native extension.

Only what RAW files use is implemented: SOF3, one DC Huffman table per
component, predictors 1-7, point transform 0, no restart markers,
8-16 bit precision.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

SOI = 0xFFD8
EOI = 0xFFD9
SOF3 = 0xFFC3
DHT = 0xFFC4
SOS = 0xFFDA

# Canonical Huffman code-length table for difference categories 0..16,
# used by the encoder (decoders read whatever DHT says): three 2-bit
# codes then one code per length. Kraft sum = 1 - 2^-16 (valid, and the
# all-ones max-length code stays unused as JPEG requires).
_ENC_BITS = [0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]
_ENC_VALUES = list(range(17))


def _canonical_codes(bits: List[int], values: List[int]) -> Dict[int, Tuple[int, int]]:
    """symbol -> (code, length) from a DHT BITS/VALUES spec."""
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length] if length < len(bits) else 0):
            codes[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, length: int) -> None:
        if length == 0:
            return
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            self.nbits -= 8
            byte = (self.acc >> self.nbits) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:  # byte stuffing
                self.out.append(0x00)

    def flush(self) -> bytes:
        if self.nbits:
            pad = 8 - self.nbits
            self.acc = (self.acc << pad) | ((1 << pad) - 1)  # pad with 1s
            self.nbits += pad
            self.write(0, 0)
            byte = self.acc & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)
            self.nbits = 0
        return bytes(self.out)


class _BitReader:
    """MSB-first bit reader over stuffed entropy-coded data."""

    def __init__(self, data: bytes, pos: int):
        # De-stuff once up front: 0xFF 0x00 -> 0xFF. A marker (0xFF xx,
        # xx != 0) ends the scan.
        buf = bytearray()
        n = len(data)
        while pos < n:
            b = data[pos]
            if b == 0xFF:
                if pos + 1 < n and data[pos + 1] == 0x00:
                    buf.append(0xFF)
                    pos += 2
                    continue
                break  # marker: end of entropy data
            buf.append(b)
            pos += 1
        self.end_pos = pos
        self.bits = np.unpackbits(np.frombuffer(bytes(buf), np.uint8))
        self.idx = 0

    def read_bit(self) -> int:
        # Past the entropy data, keep the JPEG all-ones padding
        # convention (T.81 pads the final byte with 1s; the native
        # reader does the same) so both implementations agree on
        # truncated streams.
        if self.idx >= len(self.bits):
            self.idx += 1
            return 1
        b = int(self.bits[self.idx])
        self.idx += 1
        return b

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        v = 0
        bits = self.bits[self.idx : self.idx + n]
        self.idx += n
        for b in bits:
            v = (v << 1) | int(b)
        for _ in range(n - len(bits)):  # all-ones past the end
            v = (v << 1) | 1
        return v


def _category(diff: int) -> int:
    return int(diff).bit_length() if diff >= 0 else int(-diff).bit_length()


def _extend(value: int, s: int) -> int:
    """Sign-extend an s-bit difference magnitude (T.81 F.2.2.1)."""
    if s == 0:
        return 0
    if value < (1 << (s - 1)):
        return value - (1 << s) + 1
    return value


def _predict(comp: np.ndarray, x: int, y: int, psv: int, precision: int) -> int:
    """T.81 H.1.2.1 prediction. comp holds already-reconstructed samples."""
    if y == 0 and x == 0:
        return 1 << (precision - 1)
    if y == 0:
        return int(comp[0, x - 1])  # first line: left
    if x == 0:
        return int(comp[y - 1, 0])  # first column: above
    a = int(comp[y, x - 1])
    b = int(comp[y - 1, x])
    c = int(comp[y - 1, x - 1])
    if psv == 1:
        return a
    if psv == 2:
        return b
    if psv == 3:
        return c
    if psv == 4:
        return a + b - c
    if psv == 5:
        return a + ((b - c) >> 1)
    if psv == 6:
        return b + ((a - c) >> 1)
    if psv == 7:
        return (a + b) >> 1
    raise ValueError(f"unsupported predictor {psv}")


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _predictor1_diffs(plane: np.ndarray, precision: int) -> np.ndarray:
    """Vectorized predictor-1 residuals (left; first column from above;
    first sample from 2^(P-1)), wrapped to the int16 ring the scan
    encodes."""
    p = plane.astype(np.int32)
    d = np.empty_like(p)
    d[:, 1:] = p[:, 1:] - p[:, :-1]
    d[0, 0] = p[0, 0] - (1 << (precision - 1))
    if p.shape[0] > 1:
        d[1:, 0] = p[1:, 0] - p[:-1, 0]
    # Wrap to the int16 ring the scan encodes; a plain narrowing cast
    # is the mod-65536 signed wrap (and 4x less data than the int64
    # mask-and-shift chain — this is 24 MP-hot fixture code).
    return d.astype(np.int16)


def encode_lossless(components: np.ndarray, precision: int,
                    predictor: int = 1) -> bytes:
    """Encode (C, H, W) u16 component planes as an SOF3 lossless JPEG.

    Components are interleaved sample-by-sample per MCU as RAW files do.
    Predictor 1 is fully vectorized (fixture-scale images encode in
    milliseconds); predictors 2-7 take the scalar path.
    """
    comps = np.asarray(components)
    if comps.ndim == 2:
        comps = comps[None]
    nc, h, w = comps.shape
    if not 2 <= precision <= 16:
        raise ValueError("precision out of range")
    if comps.max(initial=0) >= (1 << precision):
        raise ValueError("sample exceeds precision")

    codes = _canonical_codes([0] + _ENC_BITS[1:], _ENC_VALUES)

    out = bytearray()
    out += struct.pack(">H", SOI)
    # DHT: one table (id 0) shared by all components.
    bits = _ENC_BITS[1:]
    payload = bytes([0x00]) + bytes(bits) + bytes(_ENC_VALUES)
    out += struct.pack(">HH", DHT, 2 + len(payload)) + payload
    # SOF3.
    sof = struct.pack(">BHHB", precision, h, w, nc)
    for ci in range(nc):
        sof += bytes([ci, 0x11, 0])  # id, 1x1 sampling, quant 0
    out += struct.pack(">HH", SOF3, 2 + len(sof)) + sof
    # SOS: Ss = predictor selection value, Se = 0, Ah/Al = 0.
    sos = bytes([nc])
    for ci in range(nc):
        sos += bytes([ci, 0x00])
    sos += bytes([predictor, 0, 0])
    out += struct.pack(">HH", SOS, 2 + len(sos)) + sos

    if predictor == 1:
        from raweditor_tpu_torch.raw import bitpack

        # (h, w, nc) sample order, matching the interleaved scan.
        diffs = np.stack(
            [_predictor1_diffs(comps[ci], precision) for ci in range(nc)],
            axis=-1,
        ).reshape(-1)
        code_tab = np.zeros(17, np.uint64)
        clen_tab = np.zeros(17, np.int64)
        for s, (code, length) in codes.items():
            code_tab[s], clen_tab[s] = code, length
        # Category 16 carries no raw bits (T.81 H.2: the 32768 case).
        body = bitpack.huffman_encode(diffs, code_tab, clen_tab,
                                      max_raw_cat=15)
        # Byte-stuff the entropy stream (0xFF -> 0xFF 0x00).
        body = body.replace(b"\xff", b"\xff\x00")
        out += body
    else:
        wtr = _BitWriter()
        comps_i = comps.astype(np.int32)
        for y in range(h):
            for x in range(w):
                for ci in range(nc):
                    pred = _predict(comps_i[ci], x, y, predictor, precision)
                    diff = (int(comps_i[ci, y, x]) - pred) & 0xFFFF
                    if diff >= 0x8000:
                        diff -= 0x10000
                    s = _category(diff)
                    code, length = codes[s]
                    wtr.write(code, length)
                    if s and s < 16:
                        v = diff if diff >= 0 else diff + (1 << s) - 1
                        wtr.write(v, s)
        out += wtr.flush()
    out += struct.pack(">H", EOI)
    return bytes(out)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


class _HuffTable:
    """Max-length LUT huffman decoder built from DHT BITS/VALUES."""

    def __init__(self, bits: List[int], values: List[int]):
        if sum(bits) != len(values):
            raise ValueError("invalid Huffman table: truncated values")
        code = 0
        for length in range(1, 17):
            n = bits[length - 1] if length - 1 < len(bits) else 0
            code += n
            if code > (1 << length):
                raise ValueError("invalid Huffman table: code overflow")
            code <<= 1
        # (length, code) -> symbol, built canonically straight from
        # BITS/VALUES. Do NOT key by symbol first: a (fuzzed) DHT may
        # assign the same symbol to several codes, and collapsing them
        # would drop codes the native LUT decoder accepts (found by
        # the round-3 differential soak).
        self.by_len: Dict[Tuple[int, int], int] = {}
        self.max_len = 0
        code = 0
        k = 0
        for length in range(1, 17):
            n = bits[length - 1] if length - 1 < len(bits) else 0
            for _ in range(n):
                self.by_len[(length, code)] = values[k]
                k += 1
                code += 1
                self.max_len = length
            code <<= 1

    def decode(self, rdr: _BitReader) -> int:
        code = 0
        for length in range(1, self.max_len + 1):
            code = (code << 1) | rdr.read_bit()
            sym = self.by_len.get((length, code))
            if sym is not None:
                return sym
        raise ValueError("invalid Huffman code in scan data")


def decode_lossless(data: bytes):
    """Decode an SOF3 lossless JPEG.

    Returns (planes, precision): planes is (C, H, W) uint16.
    """
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG: missing SOI")
    pos = 2
    tables: Dict[int, _HuffTable] = {}
    precision = h = w = nc = 0
    comp_ids: List[int] = []
    comp_tables: List[int] = []
    predictor = 1
    pt = 0

    while pos + 4 <= len(data):
        marker, seg_len = struct.unpack_from(">HH", data, pos)
        if marker == EOI:
            break
        seg = data[pos + 4 : pos + 2 + seg_len]
        if marker == DHT:
            off = 0
            while off < len(seg):
                # Low two bits, matching the native path (Th is 0..3;
                # fuzzed ids above 3 alias down — differential parity)
                table_id = seg[off] & 0x03
                bits = list(seg[off + 1 : off + 17])
                nvals = sum(bits)
                values = list(seg[off + 17 : off + 17 + nvals])
                tables[table_id] = _HuffTable(bits, values)
                off += 17 + nvals
            pos += 2 + seg_len
        elif marker == SOF3:
            precision, h, w, nc = struct.unpack_from(">BHHB", seg, 0)
            # Same guards as the native path (differential parity):
            # a fuzzed precision of 0/1/17+ corrupts the predictor
            # seed and the sample range.
            if h < 1 or w < 1:
                raise ValueError("bad SOF3 dimensions")
            if not 2 <= precision <= 16:
                raise ValueError("bad SOF3 precision")
            comp_ids = [seg[5 + 3 * i] for i in range(nc)]
            pos += 2 + seg_len
        elif marker == SOS:
            ns = seg[0]
            comp_tables = [(seg[2 + 2 * i] >> 4) & 0x0F for i in range(ns)]
            predictor = seg[1 + 2 * ns]
            pt = seg[3 + 2 * ns] & 0x0F
            pos += 2 + seg_len
            break  # entropy data follows
        elif marker == SOI:
            pos += 2
        elif (marker >> 8) == 0xFF:
            pos += 2 + seg_len  # skip APPn/COM/etc.
        else:
            raise ValueError(f"bad marker 0x{marker:04x}")

    if not h or not w or not nc:
        raise ValueError("missing SOF3 header")
    if pt:
        raise ValueError("point transform not supported")

    rdr = _BitReader(data, pos)
    planes = np.zeros((nc, h, w), dtype=np.int32)
    huffs = []
    for t in (comp_tables or [0] * nc):
        t &= 3  # Td is 0..3; mask like the native path (differential)
        if t not in tables:
            raise ValueError("missing Huffman table")
        huffs.append(tables[t])
    for y in range(h):
        for x in range(w):
            for ci in range(nc):
                s = huffs[ci].decode(rdr)
                if s > 16:  # T.81: ssss is 0..16; larger = corrupt DHT
                    raise ValueError("invalid ssss category in scan")
                if s == 16:
                    diff = 32768
                else:
                    diff = _extend(rdr.read_bits(s), s)
                pred = _predict(planes[ci], x, y, predictor, precision)
                planes[ci, y, x] = (pred + diff) & 0xFFFF
    return planes.astype(np.uint16), precision
