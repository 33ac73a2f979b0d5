"""Olympus ORF compressed-sensor codec (behavioral reference).

The reference app decodes ORF through the ``rawloader`` crate
(reference: raw/loader.rs:50-54); the sensor entropy coding itself is
the well-published dcraw-lineage Olympus scheme, re-derived here from
the public algorithm description:

- per-pixel residual = ``pred + ((diff << 2) | low)`` where ``pred`` is
  a 2-column/2-row gradient-adaptive predictor (same-phase Bayer
  neighbors W, N, NW);
- ``diff`` is carried through a per-parity adaptive state
  (``carry0/carry1/carry2``) that sets the raw-bit width ``nbits`` from
  the previous magnitude;
- the "Huffman" table is a unary code: symbol ``s`` is ``s`` zeros and
  a one (s = 0..11), twelve zeros is the escape that switches to a
  ``16 - nbits``-bit literal.

The compressed payload begins with 7 padding bytes (skipped), then a
plain MSB-first bitstream — no JPEG byte stuffing.

This module is the scalar Python reference; the C++ extension carries
the fast path for both directions (``native/rawkit.cpp``), and tests
assert byte/array equality between the two. The encoder is exact
(lossless) for any mosaic whose samples fit 16 bits with headroom for
the escape literal — all real 12/14-bit data qualifies.

Provenance note: no camera files exist in this environment; decoding
is validated by round-trip against this encoder plus hand-derived
bitstream fixtures (tests/golden). docs/formats.md records the risk.
"""

from __future__ import annotations

import numpy as np


from raweditor_tpu_torch.raw.bitpack import MsbReader as _MsbReader
from raweditor_tpu_torch.raw.bitpack import MsbWriter as _BitWriter


class _BitReader(_MsbReader):
    """Shared MSB reader plus the Olympus unary code."""

    def unary_symbol(self) -> int:
        """Count leading zeros: s zeros + a one = symbol s (s < 12);
        twelve zeros = symbol 12 (escape), consuming exactly 12 bits."""
        zeros = 0
        while zeros < 12:
            if self.get(1):
                return zeros
            zeros += 1
        return 12


def _nbits_for(carry0: int, carry2: int):
    """The adaptive raw-bit width: derived from the *previous* carry0
    magnitude (cast to u16) and whether the recent run was small."""
    i = 2 if carry2 < 3 else 0
    nbits = 2 + i
    while (carry0 & 0xFFFF) >> (nbits + i):
        nbits += 1
    return nbits


def _predict(out: np.ndarray, row: int, col: int) -> int:
    """Gradient-adaptive predictor over same-phase neighbors."""
    if row < 2 and col < 2:
        return 0
    if row < 2:
        return int(out[row, col - 2])
    if col < 2:
        return int(out[row - 2, col])
    w = int(out[row, col - 2])
    n = int(out[row - 2, col])
    nw = int(out[row - 2, col - 2])
    if (w < nw < n) or (n < nw < w):
        if abs(w - nw) > 32 or abs(n - nw) > 32:
            return w + n - nw
        return (w + n) >> 1
    return w if abs(w - nw) > abs(n - nw) else n


def decode_olympus(data: bytes, width: int, height: int) -> np.ndarray:
    """Decode an Olympus compressed sensor payload to (H, W) u16."""
    if len(data) < 7:  # same guard as the native path (differential)
        raise ValueError("olympus strip too short")
    rdr = _BitReader(data[7:])  # 7 padding bytes precede the stream
    out = np.zeros((height, width), np.uint16)
    for row in range(height):
        acarry = [[0, 0, 0], [0, 0, 0]]
        for col in range(width):
            carry = acarry[col & 1]
            nbits = _nbits_for(carry[0], carry[2])
            sign3 = rdr.get(3)
            low = sign3 & 3
            sign = -1 if sign3 & 4 else 0
            high = rdr.unary_symbol()
            if high == 12:
                high = rdr.get(16 - nbits) >> 1
            carry[0] = (high << nbits) | rdr.get(nbits)
            diff = (carry[0] ^ sign) + carry[1]
            carry[1] = (diff * 3 + carry[1]) >> 5
            carry[2] = 0 if carry[0] > 16 else carry[2] + 1
            pred = _predict(out, row, col)
            out[row, col] = (pred + ((diff << 2) | low)) & 0xFFFF
    return out


def encode_olympus(mosaic: np.ndarray) -> bytes:
    """Exact inverse of ``decode_olympus`` (lossless round-trip)."""
    mosaic = np.asarray(mosaic, dtype=np.int64)
    height, width = mosaic.shape
    out = np.zeros((height, width), np.uint16)
    wtr = _BitWriter()
    for row in range(height):
        acarry = [[0, 0, 0], [0, 0, 0]]
        for col in range(width):
            carry = acarry[col & 1]
            nbits = _nbits_for(carry[0], carry[2])
            pred = _predict(out, row, col)
            delta = int(mosaic[row, col]) - pred
            low = delta & 3
            diff = delta >> 2
            d = diff - carry[1]
            if d >= 0:
                sign = 0
                carry0 = d
            else:
                sign = -1
                carry0 = ~d  # == -d - 1
            high = carry0 >> nbits
            raw = carry0 & ((1 << nbits) - 1)
            wtr.put((4 if sign else 0) | low, 3)
            if high < 12:
                wtr.put(1, high + 1)  # `high` zeros then a one
            else:
                if high >= (1 << (15 - nbits)):
                    raise ValueError(
                        "residual too large for the Olympus escape field"
                    )
                wtr.put(0, 12)
                wtr.put(high << 1, 16 - nbits)
            wtr.put(raw, nbits)
            carry[0] = carry0
            carry[1] = (diff * 3 + carry[1]) >> 5
            carry[2] = 0 if carry[0] > 16 else carry[2] + 1
            out[row, col] = (pred + ((diff << 2) | low)) & 0xFFFF
    if not np.array_equal(out, mosaic.astype(np.uint16)):
        raise ValueError("olympus encoder failed to represent the mosaic")
    return b"\0" * 7 + wtr.flush()
