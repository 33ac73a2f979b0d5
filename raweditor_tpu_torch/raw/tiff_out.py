"""Minimal 16-bit RGB TIFF writer for high-bit-depth export.

The reference exports 8-bit JPEG/PNG only (reference: main.rs:1744-1799);
16-bit output is a beyond-reference capability for print/archival
workflows. Uncompressed, little-endian, striped, PlanarConfig=chunky —
readable by every TIFF consumer (and by our own raw/tiff.py walker,
which the tests use for the round trip).
"""

from __future__ import annotations

import numpy as np

from raweditor_tpu_torch.raw import tiff as T
from raweditor_tpu_torch.raw.synth import _TYPE_LONG, _TYPE_SHORT, _TiffWriter

PLANAR_CONFIG = 284  # chunky/planar tag (not needed by the readers
                     # in raw/tiff.py, so it lives here)


def write_tiff16(path, rgb: np.ndarray, make: str = "",
                 model: str = "", orientation: int = 1,
                 software: str = "", icc: bytes = None) -> str:
    """Write an (H, W, 3) uint16 array as an uncompressed RGB TIFF.

    Optional camera metadata lands as standard baseline tags (Make/
    Model/Orientation/Software) so archival exports keep provenance;
    ``icc`` embeds an ICC profile (tag 34675 — wide-gamut outputs must
    carry one, raweditor_tpu/icc.py)."""
    from raweditor_tpu_torch.raw.synth import _TYPE_ASCII, _TYPE_UNDEF

    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint16:
        # Mirror write_dng's strictness: a silent cast would turn
        # normalized-float input into an all-black "successful" export.
        raise ValueError(f"rgb must be uint16, got {rgb.dtype}")
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) u16, got {rgb.shape}")
    rgb = np.ascontiguousarray(rgb)
    h, w, _ = rgb.shape
    tw = _TiffWriter()
    strip = tw.add_blob(rgb.astype("<u2").tobytes())
    ifd = [
        (T.IMAGE_WIDTH, _TYPE_LONG, [w]),
        (T.IMAGE_LENGTH, _TYPE_LONG, [h]),
        (T.BITS_PER_SAMPLE, _TYPE_SHORT, [16, 16, 16]),
        (T.COMPRESSION, _TYPE_SHORT, [1]),
        (T.PHOTOMETRIC, _TYPE_SHORT, [2]),  # RGB
        (T.STRIP_OFFSETS, _TYPE_LONG, ("blob", strip)),
        (T.SAMPLES_PER_PIXEL, _TYPE_SHORT, [3]),
        (T.ROWS_PER_STRIP, _TYPE_LONG, [h]),
        (T.STRIP_BYTE_COUNTS, _TYPE_LONG, [h * w * 6]),
        (PLANAR_CONFIG, _TYPE_SHORT, [1]),
    ]
    if make:
        ifd.append((T.MAKE, _TYPE_ASCII, make))
    if model:
        ifd.append((T.MODEL, _TYPE_ASCII, model))
    if orientation in range(1, 9) and orientation != 1:
        ifd.append((T.ORIENTATION, _TYPE_SHORT, [orientation]))
    if software:
        ifd.append((0x0131, _TYPE_ASCII, software))
    if icc:
        ifd.append((34675, _TYPE_UNDEF, icc))
    ifd.sort(key=lambda e: e[0])
    data = tw.build([ifd])
    import os

    path = os.fspath(path)
    with open(path, "wb") as f:
        f.write(data)
    return path
