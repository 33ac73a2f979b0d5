"""Kodak RADC codec (DC40/DC50-class "Rapid Advanced Digital
Compression") — behavioral reference.

The reference app reaches Kodak RAWs through the ``rawloader`` crate
(reference: raw/loader.rs:50-54). RADC is the published
dcraw-lineage scheme; the structure, as reconstructed here:

- one continuous MSB-first bit stream; tokens come from nineteen
  256-entry byte-indexed prefix-code tables (peek 8 bits, consume the
  code length, yield a signed value);
- the image is coded in 4-row bands. Each band starts with three
  6-bit channel multipliers, then three channel passes: channel 0
  (the luma checkerboard, coded twice per band) and channels 1-2 (the
  chroma checkerboards, once each), every pass covering two
  half-width rows right-to-left in column pairs;
- each pass keeps a persistent 3×(W/2+2) prediction buffer seeded at
  2048, rescaled at every band by the ratio of successive multipliers
  (``((0x1000000/last + 0x7ff) >> 12) * mul``, shifted down by 10 or
  12), with the right boundary of the two working rows seeded to
  ``mul << 7``;
- per column pair a *tree token* (tables 0-8, where the table is the
  previous token — a transition chain) selects: 0 = a run of
  predictor-exact pairs (run lengths from table 9, 1-9 with 9 as
  continuation, plus a step offset from table 10 added on odd
  repetitions), 1-7 = four residuals from magnitude-class table
  10+k, each ``token*16 + PREDICTOR``, or 8 = four direct absolute
  samples from table 18 (quantized 8-bit, ``(uchar)token * mul``);
- the predictor is ``(above + right) / 2`` for chroma and
  ``(above-right + 2*above + right) / 3`` for luma (C truncating
  division), with channel 0's buffer shifting one column per sub-row
  (the diagonal sampling of the luma checkerboard);
- plane samples are ``(buf << 4) / mul`` clamped at 0; after the
  three channel passes the chroma checkerboard positions are
  reconstructed as ``(stored - 2048)*2 + (left + right)/2`` from
  their horizontal luma neighbours; finally every sample maps
  through the fixed five-segment tone curve (knots (0,0) (1280,1344)
  (2320,3616) (3328,8000) (4095,16383), flat 16383 above), so the
  output white level is 0x3fff.

**Provenance.** The band/channel structure, predictors, run
semantics, rescale arithmetic, checkerboard reconstruction and tone
curve follow the published algorithm. The nineteen code tables are
only partially recoverable from public constants: tables 0-4 and the
structural properties of the rest (table 0 lacks the run token —
consecutive runs are impossible by construction; tables 1-8 are
complete over the token alphabet 0-8; table 9 is the run-length
alphabet; table 10 the non-negative step alphabet) are preserved,
and the remaining tables are THIS MODULE'S reconstruction: complete
prefix codes with the published tables' shape (symmetric signed
magnitude classes for 11-17). Real Kodak streams are therefore
expected to quarantine at the entropy layer (any inconsistency
raises) until a camera-file corpus exists — the same caveat class as
CR3/CRX (docs/formats.md). Round-trip against this module's encoder
is exact on representable mosaics (``radc_representable``), and the
C++ extension mirrors this reference bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from raweditor_tpu_torch.raw import bitpack

WHITE = 0x3FFF

# (code length, value) pairs per table; each table is a complete
# prefix code (the Kraft sums are asserted by tests). Tables 0-4 and
# 10 follow the published constants; 5-9 and 11-17 are this module's
# reconstruction (see the module docstring).
_TABLE_SPEC: List[List[Tuple[int, int]]] = [
    # 0: transition after a run — note: no value 0 (runs cannot chain)
    [(1, 1), (2, 3), (3, 4), (4, 2), (5, 7), (6, 5), (7, 6), (7, 8)],
    # 1-8: transition tables, complete over 0..8
    [(1, 0), (2, 1), (3, 3), (4, 4), (5, 2), (6, 7), (7, 6), (8, 5),
     (8, 8)],
    [(2, 1), (2, 3), (3, 0), (3, 2), (3, 4), (4, 6), (5, 5), (6, 7),
     (6, 8)],
    [(2, 0), (2, 1), (2, 3), (3, 2), (4, 4), (5, 6), (6, 7), (7, 5),
     (7, 8)],
    [(2, 1), (2, 4), (3, 0), (3, 2), (3, 3), (4, 7), (5, 5), (6, 6),
     (6, 8)],
    [(2, 4), (2, 5), (3, 3), (3, 6), (4, 0), (4, 2), (4, 7), (5, 1),
     (5, 8)],
    [(2, 5), (2, 6), (3, 4), (3, 7), (4, 0), (4, 3), (4, 8), (5, 1),
     (5, 2)],
    [(2, 6), (2, 7), (3, 5), (3, 8), (4, 0), (4, 4), (4, 3), (5, 1),
     (5, 2)],
    [(1, 8), (3, 7), (3, 6), (4, 5), (4, 4), (5, 3), (5, 2), (5, 0),
     (5, 1)],
    # 9: run lengths (value+1 repetitions, 8 = continuation)
    [(1, 0), (2, 1), (3, 2), (4, 3), (5, 4), (6, 5), (7, 6), (8, 7),
     (8, 8)],
    # 10: step offsets (published: non-negative, short codes first)
    [(2, 0), (2, 1), (2, 2), (3, 3), (4, 4), (5, 5), (6, 6), (7, 7),
     (7, 8)],
    # 11-17: signed magnitude classes 1..7 (reconstruction)
    [(1, 0), (2, 1), (2, -1)],
    [(1, 0), (3, 1), (3, -1), (3, 2), (3, -2)],
    [(1, 0), (3, 1), (3, -1), (4, 2), (4, -2), (4, 3), (4, -3)],
    [(1, 0), (3, 1), (3, -1), (4, 2), (4, -2), (5, 3), (5, -3),
     (5, 4), (5, -4)],
    [(2, 0), (3, 1), (3, -1), (4, 2), (4, -2), (4, 3), (4, -3),
     (4, 4), (4, -4), (4, 5), (4, -5)],
    [(2, 0), (3, 1), (3, -1), (4, 2), (4, -2), (4, 3), (4, -3),
     (4, 4), (4, -4), (5, 5), (5, -5), (5, 6), (5, -6)],
    [(2, 0), (3, 1), (3, -1), (4, 2), (4, -2), (4, 3), (4, -3),
     (5, 4), (5, -4), (5, 5), (5, -5), (5, 6), (5, -6), (5, 7),
     (5, -7)],
]

_DIRECT_SHIFT = 3  # table 18: direct samples quantized to 8s (+4)


def _build_tables():
    """256-entry (length, value) lookup per table, dcraw-style, plus
    the canonical (code, length) per value for the encoder."""
    luts = []
    enc: List[Dict[int, Tuple[int, int]]] = []
    for spec in _TABLE_SPEC:
        assert sum(256 >> ln for ln, _ in spec) == 256, spec
        lut = np.zeros((256, 2), np.int16)
        codes: Dict[int, Tuple[int, int]] = {}
        s = 0
        for ln, val in spec:
            codes[val] = (s >> (8 - ln), ln)
            for _ in range(256 >> ln):
                lut[s] = (ln, val)
                s += 1
        luts.append(lut)
        enc.append(codes)
    # Table 18: direct 8-bit samples quantized to the published
    # midpoint lattice (q = (c >> s << s) | 1 << (s-1), 8-s bit code).
    s = _DIRECT_SHIFT
    lut = np.zeros((256, 2), np.int16)
    for c in range(256):
        lut[c] = (8 - s, (c >> s << s) | (1 << (s - 1)))
    luts.append(lut)
    enc.append({})  # direct values are emitted as raw 8-s bit codes
    return luts, enc

_LUTS, _ENC = _build_tables()

_CURVE_PT = (0, 0, 1280, 1344, 2320, 3616, 3328, 8000, 4095, 16383,
             65535, 16383)


def _build_curve() -> np.ndarray:
    pt = _CURVE_PT
    curve = np.zeros(65536, np.uint16)
    for i in range(2, 12, 2):
        lo, hi = pt[i - 2], pt[i]
        out_lo, out_hi = pt[i - 1], pt[i + 1]
        for c in range(lo, hi + 1):
            curve[c] = int((c - lo) / (hi - lo) * (out_hi - out_lo)
                           + out_lo + 0.5)
    return curve

_CURVE = _build_curve()


def _cdiv(a: int, b: int) -> int:
    """C truncating integer division."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


class _MsbReader:
    """MSB-first bit reader. An 8-bit table peek may look past the
    final byte (zero-filled) — the code actually consumed never does;
    consuming past the real end raises (truncation quarantine)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.n = 0
        self.consumed = 0
        self.total = len(data) * 8

    def _fill(self, k: int) -> None:
        while self.n < k:
            byte = (self.data[self.pos] if self.pos < len(self.data)
                    else 0)
            self.pos += 1
            self.acc = (self.acc << 8) | byte
            self.n += 8

    def peek8(self) -> int:
        self._fill(8)
        return (self.acc >> (self.n - 8)) & 0xFF

    def drop(self, k: int) -> None:
        self.consumed += k
        if self.consumed > self.total:
            raise ValueError("radc: bit stream truncated")
        self.n -= k
        self.acc &= (1 << self.n) - 1

    def bits(self, k: int) -> int:
        self._fill(k)
        self.consumed += k
        if self.consumed > self.total:
            raise ValueError("radc: bit stream truncated")
        self.n -= k
        v = (self.acc >> self.n) & ((1 << k) - 1)
        self.acc &= (1 << self.n) - 1
        return v


def _token(rd: _MsbReader, table: int) -> int:
    ln, val = _LUTS[table][rd.peek8()]
    rd.drop(int(ln))
    return int(val)


class _MsbWriter(bitpack.MsbWriter):
    """bitpack.MsbWriter plus the RADC token table lookup."""

    def put_token(self, table: int, val: int) -> None:
        code, ln = _ENC[table][val]
        self.put(code, ln)

    def tobytes(self) -> bytes:
        return self.flush()


def _predictor(buf: List[List[int]], c: int, y: int, x: int) -> int:
    if c:
        return _cdiv(buf[y - 1][x] + buf[y][x + 1], 2)
    return _cdiv(buf[y - 1][x + 1] + 2 * buf[y - 1][x] + buf[y][x + 1], 3)


def _out_positions(c: int, r: int, row: int, y: int,
                   x: int) -> Tuple[int, int]:
    """Mosaic position written by plane sample (y, x) of pass (c, r)."""
    if c:
        return row + y * 2 + c - 1, x * 2 + 2 - c
    return row + r * 2 + y, x * 2 + y


def _rescale(buf: List[List[int]], last: int, mul: int) -> None:
    val = ((0x1000000 // last + 0x7FF) >> 12) * mul
    s = 10 if val > 65564 else 12
    x = ~(-1 << (s - 1))
    val <<= 12 - s
    for rowbuf in buf:
        for i in range(len(rowbuf)):
            v = (rowbuf[i] * val + x) >> s
            # Adversarial streams can pump the multiplier ratio every
            # band; bound the state so the C++ mirror's fixed-width
            # arithmetic stays bit-identical (quarantine contract).
            if not -(1 << 20) <= v <= (1 << 20):
                raise ValueError("radc: prediction state out of range")
            rowbuf[i] = v


def decode_radc(data: bytes, width: int, height: int) -> np.ndarray:
    """Decode a RADC stream into an (H, W) u16 mosaic (tone curve
    applied, white 0x3fff). Raises ValueError on stream inconsistency
    — the quarantine contract."""
    if width <= 0 or height <= 0 or width % 4 or height % 4:
        raise ValueError("radc: dimensions must be positive multiples "
                         "of 4")
    w2 = width // 2
    rd = _MsbReader(data)
    raw = np.zeros((height, width), np.int32)
    bufs = [[[2048] * (w2 + 2) for _ in range(3)] for _ in range(3)]
    last = [16, 16, 16]
    for row in range(0, height, 4):
        mul = [rd.bits(6) for _ in range(3)]
        if 0 in mul:
            raise ValueError("radc: zero channel multiplier")
        for c in range(3):
            buf = bufs[c]
            _rescale(buf, last[c], mul[c])
            last[c] = mul[c]
            for r in range(2 if c == 0 else 1):
                buf[1][w2] = buf[2][w2] = mul[c] << 7
                tree = 1
                col = w2
                while col > 0:
                    tree = _token(rd, tree)
                    if tree:
                        col -= 2
                        if tree == 8:
                            for y in (1, 2):
                                for x in (col + 1, col):
                                    buf[y][x] = (_token(rd, 18) & 0xFF) \
                                        * mul[c]
                        else:
                            for y in (1, 2):
                                for x in (col + 1, col):
                                    buf[y][x] = _token(rd, tree + 10) \
                                        * 16 + _predictor(buf, c, y, x)
                    else:
                        while True:
                            nreps = (_token(rd, 9) + 1) if col > 2 else 1
                            rep = 0
                            while rep < 8 and rep < nreps and col > 0:
                                col -= 2
                                for y in (1, 2):
                                    for x in (col + 1, col):
                                        buf[y][x] = _predictor(
                                            buf, c, y, x)
                                if rep & 1:
                                    step = _token(rd, 10) << 4
                                    for y in (1, 2):
                                        for x in (col + 1, col):
                                            buf[y][x] += step
                                rep += 1
                            if nreps != 9:
                                break
                for y in range(2):
                    for x in range(w2):
                        val = _cdiv(buf[y + 1][x] << 4, mul[c])
                        if val < 0:
                            val = 0
                        ry, rx = _out_positions(c, r, row, y, x)
                        raw[ry, rx] = val
                if c:
                    buf[0] = list(buf[2])
                else:
                    # channel 0 shifts one column per sub-row (the
                    # diagonal luma checkerboard sampling)
                    buf[0] = [buf[0][0]] + buf[2][:w2 + 1]
        # chroma checkerboard reconstruction from luma neighbours
        for y in range(row, row + 4):
            for x in range(width):
                if (x + y) & 1:
                    left = x - 1 if x else x + 1
                    right = x + 1 if x + 1 < width else x - 1
                    val = (int(raw[y, x]) - 2048) * 2 + _cdiv(
                        int(raw[y, left]) + int(raw[y, right]), 2)
                    raw[y, x] = max(val, 0)
    np.clip(raw, 0, 65535, out=raw)
    return _CURVE[raw.astype(np.uint16)]


# Inverse tone curve: nearest pre-curve sample for every reachable
# output value (the curve is strictly increasing on 0..4095).
def _build_inv_curve() -> np.ndarray:
    fwd = _CURVE[:4096].astype(np.int64)
    idx = np.searchsorted(fwd, np.arange(WHITE + 1))
    idx = np.minimum(idx, 4095)
    lo = np.maximum(idx - 1, 0)
    pick_lo = (np.abs(fwd[lo] - np.arange(WHITE + 1))
               <= np.abs(fwd[idx] - np.arange(WHITE + 1)))
    return np.where(pick_lo, lo, idx).astype(np.int32)

_INV_CURVE = _build_inv_curve()


def _snap16(d: int) -> int:
    """Nearest residual token (unclamped): round(d / 16) half-up."""
    return (d + 8) >> 4


class _PassEncoder:
    """Encodes one channel pass, mirroring the decoder's state so
    lattice snapping yields exactly what decoding will produce."""

    def __init__(self, wr: _MsbWriter, buf: List[List[int]], c: int,
                 mul: int, w2: int):
        self.wr = wr
        self.buf = buf
        self.c = c
        self.mul = mul
        self.w2 = w2

    def _run_length(self, targets, col: int) -> int:
        """Consecutive predictor-exact pairs from ``col`` leftward,
        evaluated in decoder order on a trial copy."""
        trial = [list(r) for r in self.buf]
        run = 0
        while col > 0:
            ok = True
            for y in (1, 2):
                for x in (col - 1, col - 2):
                    pred = _predictor(trial, self.c, y, x)
                    if targets[y - 1][x] != pred:
                        ok = False
                        break
                    trial[y][x] = pred
                if not ok:
                    break
            if not ok:
                break
            run += 1
            col -= 2
        return run

    def _plan_pair(self, targets, col: int):
        """(use_direct, k) for the pair below ``col``, from a stateful
        trial walk in decoder order."""
        trial = [list(r) for r in self.buf]
        kmax = 0
        for y in (1, 2):
            for x in (col - 1, col - 2):
                pred = _predictor(trial, self.c, y, x)
                t = _snap16(targets[y - 1][x] - pred)
                if abs(t) > 7:
                    return True, 0
                kmax = max(kmax, abs(t))
                trial[y][x] = pred + t * 16
        return False, max(kmax, 1)

    def encode(self, targets: List[List[int]]) -> None:
        buf, c, mul, w2 = self.buf, self.c, self.mul, self.w2
        wr = self.wr
        buf[1][w2] = buf[2][w2] = mul << 7
        tree = 1
        col = w2
        while col > 0:
            run = self._run_length(targets, col) if tree else 0
            if run > 0:
                # enter run mode; chunked per the decoder's do-while
                wr.put_token(tree, 0)
                tree = 0
                left = run
                while True:
                    if col <= 2:
                        nreps = 1
                    else:
                        v9 = 8 if left > 8 else left - 1
                        wr.put_token(9, v9)
                        nreps = v9 + 1
                    rep = 0
                    while rep < 8 and rep < nreps and col > 0:
                        col -= 2
                        for y in (1, 2):
                            for x in (col + 1, col):
                                buf[y][x] = _predictor(buf, c, y, x)
                        if rep & 1:
                            wr.put_token(10, 0)  # step 0: exact
                        rep += 1
                        left -= 1
                    if nreps != 9:
                        break
                continue
            use_direct, k = self._plan_pair(targets, col)
            col -= 2
            if use_direct:
                wr.put_token(tree, 8)
                tree = 8
                s = _DIRECT_SHIFT
                for y in (1, 2):
                    for x in (col + 1, col):
                        q = max(0, min(255,
                                       _cdiv(targets[y - 1][x], mul)))
                        code = q >> s
                        wr.put(code, 8 - s)
                        buf[y][x] = ((code << s) | (1 << (s - 1))) * mul
            else:
                wr.put_token(tree, k)
                tree = k
                for y in (1, 2):
                    for x in (col + 1, col):
                        pred = _predictor(buf, c, y, x)
                        t = _snap16(targets[y - 1][x] - pred)
                        t = max(-k, min(k, t))
                        wr.put_token(10 + k, t)
                        buf[y][x] = pred + t * 16


def encode_radc(mosaic: np.ndarray, muls: Optional[List[int]] = None
                ) -> bytes:
    """Encode a mosaic (post-curve space, as :func:`decode_radc`
    returns) into a RADC stream. Lossy in general — values snap to
    the token lattice; exact on the image of :func:`decode_radc`
    (see ``radc_representable``)."""
    mosaic = np.asarray(mosaic, np.uint16)
    height, width = mosaic.shape
    if width <= 0 or height <= 0 or width % 4 or height % 4:
        raise ValueError("radc: dimensions must be positive multiples "
                         "of 4")
    if mosaic.max(initial=0) > WHITE:
        raise ValueError("radc: samples must be <= 0x3fff")
    if muls is None:
        muls = [16, 16, 16]
    if len(muls) != 3 or any(not 1 <= m <= 63 for m in muls):
        raise ValueError("radc: multipliers must be three of 1..63")
    w2 = width // 2
    # Invert the output pipeline: tone curve, then the chroma
    # checkerboard (luma neighbours are final after curve inversion).
    pre = _INV_CURVE[mosaic.astype(np.int32)].astype(np.int64)
    stored = pre.copy()
    for y in range(height):
        for x in range(width):
            if (x + y) & 1:
                left = x - 1 if x else x + 1
                right = x + 1 if x + 1 < width else x - 1
                nb = _cdiv(int(pre[y, left]) + int(pre[y, right]), 2)
                s = _cdiv(int(pre[y, x]) - nb, 2) + 2048
                stored[y, x] = max(s, 0)
    wr = _MsbWriter()
    bufs = [[[2048] * (w2 + 2) for _ in range(3)] for _ in range(3)]
    last = [16, 16, 16]
    for row in range(0, height, 4):
        for c in range(3):
            wr.put(muls[c], 6)
        for c in range(3):
            buf = bufs[c]
            _rescale(buf, last[c], muls[c])
            last[c] = muls[c]
            for r in range(2 if c == 0 else 1):
                targets = [[0] * (w2 + 2) for _ in range(2)]
                for y in range(2):
                    for x in range(w2):
                        ry, rx = _out_positions(c, r, row, y, x)
                        targets[y][x] = int(stored[ry, rx])
                _PassEncoder(wr, buf, c, muls[c], w2).encode(targets)
                if c:
                    buf[0] = list(buf[2])
                else:
                    buf[0] = [buf[0][0]] + buf[2][:w2 + 1]
    return wr.tobytes()


def radc_representable(mosaic: np.ndarray) -> np.ndarray:
    """Nearby mosaic in the codec's representable lattice: encode
    (with snapping) and decode, iterated to a fixed point — the
    RW2/ARW2 quantizing-fixture pattern. A single pass suffices away
    from saturation; saturated checkerboard regions (outputs pinned
    at 0 or 0x3fff by the tone curve's flat segment) may move the
    prediction state between generations, so iterate until
    ``decode(encode(m)) == m`` holds exactly."""
    m = np.minimum(np.asarray(mosaic, np.uint16), WHITE)
    h, w = m.shape
    for _ in range(16):
        out = decode_radc(encode_radc(m), w, h)
        if np.array_equal(out, m):
            return out
        m = out
    raise ValueError("radc: representable fixed point did not converge")
