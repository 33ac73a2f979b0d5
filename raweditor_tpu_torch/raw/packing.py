"""Bit-packed mosaic (un)packing: TIFF-style MSB-first sample packing
for 10/12/14-bit CFA strips, rows padded to byte boundaries.

Vectorized with ``np.unpackbits`` — ~100×  faster than a scalar loop and
plenty for the Python fallback path (the native extension does the same
with shifts).
"""

from __future__ import annotations

import numpy as np


def unpack_bits(data: bytes, width: int, height: int, bpp: int,
                big_endian: bool = True) -> np.ndarray:
    """(H, W) uint16 from MSB-first packed rows.

    ``big_endian`` applies only to whole-sample (16-bit) data, which
    follows the TIFF container byte order; sub-byte packing is MSB-first
    regardless of container order (TIFF 6.0 §"Image File Format").
    """
    from raweditor_tpu_torch.native import get_rawkit

    rk = get_rawkit()
    if rk is not None and hasattr(rk, "unpack_bits2"):
        raw = rk.unpack_bits2(data, width, height, bpp, int(big_endian))
        return np.frombuffer(raw, dtype=np.uint16).reshape(height, width)
    if bpp == 16:
        dt = ">u2" if big_endian else "<u2"
        a = np.frombuffer(data, dtype=dt, count=width * height)
        return a.astype(np.uint16).reshape(height, width)
    if bpp == 8:
        a = np.frombuffer(data, dtype=np.uint8, count=width * height)
        return a.astype(np.uint16).reshape(height, width)
    row_bytes = (width * bpp + 7) // 8
    need = row_bytes * height
    if len(data) < need:
        raise ValueError(f"packed data too short: {len(data)} < {need}")
    rows = np.frombuffer(data, dtype=np.uint8, count=need).reshape(
        height, row_bytes
    )
    bits = np.unpackbits(rows, axis=1)[:, : width * bpp]
    bits = bits.reshape(height, width, bpp).astype(np.uint16)
    weights = (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint16)
    return (bits * weights).sum(axis=2, dtype=np.uint32).astype(np.uint16)


def pack_bits(mosaic: np.ndarray, bpp: int,
              big_endian: bool = True) -> bytes:
    """Inverse of unpack_bits (fixture writer)."""
    mosaic = np.asarray(mosaic, dtype=np.uint16)
    h, w = mosaic.shape
    if mosaic.max(initial=0) >= (1 << bpp):
        raise ValueError("sample exceeds bit depth")
    if bpp == 16:
        return mosaic.astype(">u2" if big_endian else "<u2").tobytes()
    if bpp == 8:
        return mosaic.astype(np.uint8).tobytes()
    if bpp == 12 and w % 2 == 0:
        # Fast path for the dominant case: 2 pixels → 3 bytes.
        v0 = mosaic[:, 0::2].astype(np.uint16)
        v1 = mosaic[:, 1::2].astype(np.uint16)
        out = np.empty((h, (w // 2) * 3), np.uint8)
        out[:, 0::3] = (v0 >> 4).astype(np.uint8)
        out[:, 1::3] = (((v0 & 0xF) << 4) | (v1 >> 8)).astype(np.uint8)
        out[:, 2::3] = (v1 & 0xFF).astype(np.uint8)
        return out.tobytes()
    vals = mosaic.reshape(h, w, 1)
    shifts = np.arange(bpp - 1, -1, -1, dtype=np.uint16)
    bits = ((vals >> shifts) & 1).astype(np.uint8).reshape(h, w * bpp)
    pad = (-bits.shape[1]) % 8
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    return np.packbits(bits, axis=1).tobytes()
