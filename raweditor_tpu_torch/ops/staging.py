"""Bit-packed host-to-device staging of mosaics.

The batch exporter (``pipeline/export.py``) stages each decoded mosaic
to the card from its decode workers. A 12-bit mosaic travels bit-packed
at 1.5 bytes a pixel (``pack12_rows``), a 14-bit one at 1.75
(``pack14_rows``); the flush unpacks them on the device
(``unpack12_rows``, ``unpack14_rows``) before the develop kernel reads
the u16 batch.

The packers are the JAX package's (``raweditor_tpu/ops/staging.py``),
through ``_rawkit`` when it is there, else numpy, with the same bytes.
The unpackers are plain torch over u8 tensors on any device: the JAX
unpack is an XLA elementwise pass, with no Pallas kernel behind it. The
byte arithmetic runs in int32 and is cast to uint16 at the end, since
torch on the CPU has no shifts for unsigned types.
"""

from __future__ import annotations

import numpy as np
import torch


def _check_packable(m: np.ndarray, bits: int, align: int,
                    peak=None) -> None:
    """Enforce the documented pack preconditions — out-of-range samples
    would otherwise wrap silently on the u8 assignment and reconstruct
    as different pixels on the device. ``peak`` lets a
    caller that already scanned the mosaic (the exporter picks the pack
    format from it) skip the second full-memory pass — it matters on
    single-core hosts where the decode thread shares the core."""
    if m.ndim != 2 or m.shape[1] % align:
        raise ValueError(
            f"pack{bits}_rows needs a 2-D mosaic with width % {align}"
            f" == 0, got {m.shape}")
    if peak is None:
        peak = m.max() if m.size else 0
    if int(peak) >= (1 << bits):
        raise ValueError(
            f"pack{bits}_rows: sample >= 2^{bits} would wrap")


def _native_pack(m: np.ndarray, attr: str):
    """C++ pack (GIL-released; ~15x the numpy path on 24 MP — decode
    workers keep streaming instead of serializing on a 200 ms
    GIL-held numpy pass). None if the extension is unavailable."""
    from raweditor_tpu_torch.native import get_rawkit

    rk = get_rawkit()
    if rk is None or not hasattr(rk, attr):
        return None
    h, w = m.shape
    m = np.ascontiguousarray(m, dtype=np.uint16)
    packed = getattr(rk, attr)(m, h, w)
    return np.frombuffer(packed, np.uint8).reshape(h, -1)


def pack12_rows(mosaic, peak=None):
    """Host-side: (H, W) u16 with samples < 4096 and even W → a
    (H, W//2*3) u8 buffer, two samples per three bytes. Cuts the
    host→device staging of 12-bit mosaics (the dominant sensor depth)
    by 25%; :func:`unpack12_rows` inverts it on device. ``peak``:
    optional precomputed ``mosaic.max()`` (skips the range re-scan)."""
    m = np.asarray(mosaic)
    _check_packable(m, 12, 2, peak)
    native = _native_pack(m, "pack12_rows")
    if native is not None:
        return native
    h, w = m.shape
    e = m[:, 0::2].astype(np.uint32)
    o = m[:, 1::2].astype(np.uint32)
    out = np.empty((h, w // 2, 3), np.uint8)
    out[..., 0] = e >> 4
    out[..., 1] = ((e & 0xF) << 4) | (o >> 8)
    out[..., 2] = o & 0xFF
    return out.reshape(h, -1)


def pack14_rows(mosaic, peak=None):
    """Host-side: (H, W) u16 with samples < 16384 and W % 4 == 0 →
    (H, W//4*7) u8, four samples per seven bytes (12.5% saved). Byte
    math only — the device inverse needs no 64-bit ops. ``peak`` as in
    :func:`pack12_rows`."""
    m = np.asarray(mosaic)
    _check_packable(m, 14, 4, peak)
    native = _native_pack(m, "pack14_rows")
    if native is not None:
        return native
    h, w = m.shape
    s = m.reshape(h, w // 4, 4).astype(np.uint32)
    out = np.empty((h, w // 4, 7), np.uint8)
    out[..., 0] = s[..., 0] >> 6
    out[..., 1] = ((s[..., 0] & 0x3F) << 2) | (s[..., 1] >> 12)
    out[..., 2] = (s[..., 1] >> 4) & 0xFF
    out[..., 3] = ((s[..., 1] & 0xF) << 4) | (s[..., 2] >> 10)
    out[..., 4] = (s[..., 2] >> 2) & 0xFF
    out[..., 5] = ((s[..., 2] & 0x3) << 6) | (s[..., 3] >> 8)
    out[..., 6] = s[..., 3] & 0xFF
    return out.reshape(h, -1)


def _groups(packed: torch.Tensor, size: int) -> torch.Tensor:
    """(..., H, G*size) u8 as (..., H, G, size) int32."""
    if not isinstance(packed, torch.Tensor) or packed.dtype != torch.uint8:
        raise TypeError("packed rows must be a torch.uint8 tensor")
    if packed.dim() < 2 or packed.shape[-1] % size:
        raise ValueError(f"packed rows of {size}-byte groups expected, got "
                         f"{tuple(packed.shape)}")
    return packed.reshape(packed.shape[:-1]
                          + (packed.shape[-1] // size, size)).to(torch.int32)


def _samples(parts, shape) -> torch.Tensor:
    """Stacked int32 samples, interleaved back into rows of u16."""
    return torch.stack(parts, dim=-1).reshape(shape[:-1] + (-1,)).to(
        torch.uint16)


def unpack12_rows(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack12_rows` for (..., H, W//2*3) u8 on any
    device → (..., H, W) u16."""
    t = _groups(packed, 3)
    e = (t[..., 0] << 4) | (t[..., 1] >> 4)
    o = ((t[..., 1] & 0xF) << 8) | t[..., 2]
    return _samples([e, o], packed.shape)


def unpack14_rows(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack14_rows` for (..., H, W//4*7) u8 on any
    device → (..., H, W) u16."""
    t = _groups(packed, 7)
    s0 = (t[..., 0] << 6) | (t[..., 1] >> 2)
    s1 = ((t[..., 1] & 0x3) << 12) | (t[..., 2] << 4) | (t[..., 3] >> 4)
    s2 = ((t[..., 3] & 0xF) << 10) | (t[..., 4] << 2) | (t[..., 5] >> 6)
    s3 = ((t[..., 5] & 0x3F) << 8) | t[..., 6]
    return _samples([s0, s1, s2, s3], packed.shape)
