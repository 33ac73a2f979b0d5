"""Panasonic RW2 v4 sensor codec (behavioral reference).

The reference app decodes RW2 through the ``rawloader`` crate
(reference: raw/loader.rs:50-54); the bitstream itself is the
published dcraw-lineage Panasonic v4 scheme, re-derived here from the
public algorithm description:

- the payload is a sequence of 0x4000-byte blocks; within a block the
  bit reader addresses 16-byte groups in reverse byte order (the
  ``(vbits >> 3) ^ 0x3ff0`` mapping) with fields packed little-endian;
  the first 0x2008 bytes of each block are stored rotated to the end
  (``load_flags``);
- pixels are coded in 14-pixel groups: the first pixel of each column
  parity is a literal (8-bit high | 4-bit low), later pixels are
  predictor deltas ``j`` scaled by a shift ``sh`` selected by a 2-bit
  field at in-group positions 2, 5, 8 and 11;
- a 14-pixel group in the literal+delta layout is exactly 128 bits,
  which is what makes the 16-byte group addressing line up.

Values above 4098 are invalid (the published decoder treats them as
data errors); sensor data is 12-bit.

The encoder uses the fixed ``sh=4`` policy: deltas are exact whenever
consecutive same-parity pixels agree mod 16 and every pixel is >= 16.
``rw2_representable`` quantizes an arbitrary mosaic to the nearest
such stream (max error 15 codes); tests round-trip quantized mosaics
exactly. The C++ extension carries the fast decode/encode paths; this
module is the scalar reference.

Provenance note: no camera files exist in this environment; decode is
validated by round-trip against this encoder plus hand-derived
bitstream fixtures (tests/golden). docs/formats.md records the risk.
"""

from __future__ import annotations

import numpy as np

BLOCK = 0x4000
LOAD_FLAGS = 0x2008
PIXELS_PER_BLOCK = (BLOCK * 8 // 128) * 14  # 1024 groups of 14


class _PanaBits:
    """The blocked, group-reversed bit reader."""

    def __init__(self, data: bytes):
        self.data = data
        self.off = 0
        self.vbits = 0
        self.buf = bytearray(BLOCK + 1)  # +1: guard for the word read

    def __call__(self, nbits: int) -> int:
        if nbits == 0:
            self.vbits = 0
            return 0
        if self.vbits == 0:
            chunk = self.data[self.off : self.off + BLOCK]
            chunk = chunk + b"\0" * (BLOCK - len(chunk))
            self.off += BLOCK
            # File stores each block rotated by LOAD_FLAGS bytes.
            self.buf[LOAD_FLAGS:BLOCK] = chunk[: BLOCK - LOAD_FLAGS]
            self.buf[:LOAD_FLAGS] = chunk[BLOCK - LOAD_FLAGS :]
        self.vbits = (self.vbits - nbits) & 0x1FFFF
        byte = (self.vbits >> 3) ^ 0x3FF0
        word = self.buf[byte] | (self.buf[byte + 1] << 8)
        return (word >> (self.vbits & 7)) & ((1 << nbits) - 1)


def decode_rw2(data: bytes, width: int, height: int) -> np.ndarray:
    """Decode a Panasonic v4 payload to an (H, W) u16 mosaic."""
    bits = _PanaBits(data)
    bits(0)
    out = np.zeros((height, width), np.uint16)
    sh = 0
    pred = [0, 0]
    nonz = [0, 0]
    for row in range(height):
        for col in range(width):
            i = col % 14
            if i == 0:
                pred = [0, 0]
                nonz = [0, 0]
            if i % 3 == 2:
                sh = 4 >> (3 - bits(2))
            if nonz[i & 1]:
                j = bits(8)
                if j:
                    pred[i & 1] -= 0x80 << sh
                    if pred[i & 1] < 0 or sh == 4:
                        pred[i & 1] &= ~(-1 << sh)
                    pred[i & 1] += j << sh
            else:
                nonz[i & 1] = bits(8)
                if nonz[i & 1] or i > 11:
                    pred[i & 1] = (nonz[i & 1] << 4) | bits(4)
            v = pred[col & 1]
            if v > 4098:
                raise ValueError(f"RW2 sample {v} out of range")
            out[row, col] = v
    return out


class _PanaBitWriter:
    """Inverse of _PanaBits: collects blocks, same addressing."""

    def __init__(self):
        self.blocks = []
        self.buf = None
        self.vbits = 0

    def put(self, value: int, nbits: int):
        if nbits == 0:
            return
        if self.vbits == 0:
            self.buf = bytearray(BLOCK + 1)
            self.blocks.append(self.buf)
        self.vbits = (self.vbits - nbits) & 0x1FFFF
        byte = (self.vbits >> 3) ^ 0x3FF0
        word = (value & ((1 << nbits) - 1)) << (self.vbits & 7)
        self.buf[byte] |= word & 0xFF
        self.buf[byte + 1] |= word >> 8
        if self.buf[BLOCK]:
            raise ValueError("RW2 field crossed a block boundary")

    def flush(self) -> bytes:
        out = bytearray()
        for buf in self.blocks:
            # Un-rotate: buf[LOAD_FLAGS:] is stored first in the file.
            out += buf[LOAD_FLAGS:BLOCK]
            out += buf[:LOAD_FLAGS]
        return bytes(out)


def encode_rw2(mosaic: np.ndarray) -> bytes:
    """Encode a mosaic as a Panasonic v4 stream (fixed sh=4 policy).

    Raises ValueError if the mosaic is not exactly representable —
    run it through :func:`rw2_representable` first."""
    mosaic = np.asarray(mosaic, dtype=np.int64)
    height, width = mosaic.shape
    if width % 14:
        raise ValueError("RW2 width must be a multiple of 14")
    if mosaic.min(initial=16) < 16 or mosaic.max(initial=0) > 4095:
        raise ValueError("RW2 samples must be in [16, 4095]")
    wtr = _PanaBitWriter()
    pred = [0, 0]
    for row in range(height):
        for col in range(width):
            v = int(mosaic[row, col])
            i = col % 14
            if i == 0:
                pred = [0, 0]
            if i % 3 == 2:
                wtr.put(3, 2)  # sh = 4 >> (3 - 3) = 4
            if i < 2:
                # Literal: high byte then low nibble (enters delta mode
                # because v >= 16 makes the high byte nonzero).
                wtr.put(v >> 4, 8)
                wtr.put(v & 15, 4)
                pred[i & 1] = v
            else:
                p = pred[i & 1]
                if v == p:
                    wtr.put(0, 8)
                    continue
                # sh == 4 decode: pred = (pred - 0x800) & 15, then
                # += j << 4; (p - 0x800) & 15 == p & 15.
                base = p & 15
                if (v - base) % 16 or not 1 <= (v - base) >> 4 <= 255:
                    raise ValueError(
                        f"sample {v} not representable from pred {p} "
                        "(quantize with rw2_representable first)"
                    )
                wtr.put((v - base) >> 4, 8)
                pred[i & 1] = v
    return wtr.flush()


def rw2_representable(mosaic: np.ndarray) -> np.ndarray:
    """Quantize a mosaic to the nearest stream the fixed-sh=4 encoder
    can represent exactly (error <= 15 codes): pixels clipped to
    [16, 4095]; within each 14-pixel group, same-parity pixels after
    the first inherit its low nibble."""
    m = np.clip(np.asarray(mosaic, np.int64), 16, 4095)
    height, width = m.shape
    pad = (-width) % 14
    if pad:
        m = np.pad(m, ((0, 0), (0, pad)), mode="edge")
    g = m.reshape(height, -1, 14)
    # Parity leaders: positions 0 and 1 of each group.
    low = np.empty_like(g)
    low[:, :, 0::2] = (g[:, :, 0] & 15)[:, :, None]
    low[:, :, 1::2] = (g[:, :, 1] & 15)[:, :, None]
    q = (g & ~np.int64(15)) | low
    # Keep followers in range: a follower quantized below 16+low means
    # its delta j would be 0 yet value != pred; bump into range.
    q = np.maximum(q, 16 + low)
    q[:, :, 0] = g[:, :, 0]
    q[:, :, 1] = g[:, :, 1]
    q = q.reshape(height, -1)[:, : width]
    return q.astype(np.uint16)
