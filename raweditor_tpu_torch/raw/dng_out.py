"""Archival DNG export: write any decoded RAW back out as a DNG.

Beyond-reference capability (the reference app exports developed
JPEG/PNG only, reference: main.rs:1744-1799): ``write_dng`` serializes
a :class:`~raweditor_tpu_torch.raw.types.RawImage` — the mosaic plus every
piece of color metadata the develop pipeline consumes — as a
TIFF/EP-style DNG, so users can convert a vendor-format archive
(NEF/ORF/RW2/...) into one self-describing format. The conversion is
*linearized* like Adobe's DNG converter: vendor tone curves are already
folded into the decoded mosaic, and the recovered white level is
written as the DNG WhiteLevel, so developing the DNG renders
identically to developing the source file.

Round-trip contract (enforced by tests/test_dng_out.py): for any
decodable input, ``decode_raw(write_dng(decode_raw(x)))`` reproduces
the mosaic bit-exactly and the WB/matrix/black/white/CFA/orientation
metadata to rational-quantization precision.

Layout: IFD0 carries the camera/DNG metadata and points at the sensor
plane through SubIFDs (the structure our own reader and mainstream DNG
consumers walk). Sensor data is either lossless JPEG (SOF3, predictor
1 — the standard DNG compression, written at the source's native bit
depth) or uncompressed 16-bit little-endian strips.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from raweditor_tpu_torch.raw import tiff as T
from raweditor_tpu_torch.raw.ljpeg import encode_lossless
from raweditor_tpu_torch.raw.synth import (_TYPE_ASCII, _TYPE_BYTE, _TYPE_LONG,
                                     _TYPE_RATIONAL, _TYPE_SHORT,
                                     _TYPE_SRATIONAL, _TiffWriter)
from raweditor_tpu_torch.raw.types import RawImage

# Tags not needed by the readers in raw/tiff.py (write-side only).
TAG_SOFTWARE = 0x0131
TAG_DATE_TIME = 0x0132
TAG_DNG_BACKWARD_VERSION = 50707
TAG_UNIQUE_CAMERA_MODEL = 50708

_CFA_CODE = {"R": 0, "G": 1, "B": 2}


def _rat(x: float, den: int = 10000):
    return (int(round(float(x) * den)), den)


def _precision_for(img: RawImage) -> int:
    """Smallest JPEG precision covering both the recorded white level
    and the actual sample range (curve-mapped mosaics can exceed the
    nominal bit depth)."""
    peak = max(int(img.white_level), int(img.mosaic.max(initial=0)), 1)
    bits = int(peak).bit_length()
    return min(max(bits, 8), 16)


def write_dng(path, img: RawImage, *, compression: str = "ljpeg",
              preview_jpeg: Optional[bytes] = None,
              software: str = "", datetime_str: str = "") -> bytes:
    """Serialize ``img`` as a DNG. Returns the bytes (also written to
    ``path`` unless None).

    compression: 'ljpeg' (lossless JPEG, the DNG standard) or 'none'
    (uncompressed 16-bit LE). Both are bit-exact.
    preview_jpeg: optional embedded JPEG preview (e.g. carried over
    from the source file) stored as the classic JPEGInterchange blob.
    """
    mosaic = np.ascontiguousarray(img.mosaic)
    if mosaic.dtype != np.uint16:
        raise ValueError(f"mosaic must be uint16, got {mosaic.dtype}")
    if compression not in ("ljpeg", "none"):
        raise ValueError(f"compression {compression!r}")

    linear = img.is_linear
    if linear:
        if mosaic.ndim != 3 or mosaic.shape[2] != 3:
            raise ValueError(f"linear mosaic must be (H, W, 3), got "
                             f"{mosaic.shape}")
        h, w = mosaic.shape[:2]
    else:
        if mosaic.ndim != 2:
            raise ValueError(f"CFA mosaic must be (H, W), got "
                             f"{mosaic.shape}")
        h, w = mosaic.shape
        cfa = img.cfa_pattern.upper()
        if len(cfa) not in (4, 36) or any(c not in _CFA_CODE for c in cfa):
            raise ValueError(f"unsupported CFA pattern {img.cfa_pattern!r}")

    if compression == "ljpeg":
        bpp = _precision_for(img)
        payload = (np.moveaxis(mosaic, -1, 0) if linear else mosaic)
        sensor = encode_lossless(payload, bpp, predictor=1)
        comp_tag = T.COMPRESSION_LJPEG
    else:
        bpp = 16
        sensor = mosaic.astype("<u2").tobytes()
        comp_tag = T.COMPRESSION_NONE

    wtr = _TiffWriter()
    sensor_idx = wtr.add_blob(sensor)
    preview_idx = (wtr.add_blob(preview_jpeg)
                   if preview_jpeg else None)

    unique = " ".join(s for s in (img.camera_make, img.camera_model) if s)
    ifd0 = [
        (T.NEW_SUBFILE_TYPE, _TYPE_LONG, [1]),
        (T.SUB_IFDS, _TYPE_LONG, ("ifd", 1)),
        (T.DNG_VERSION, _TYPE_BYTE, [1, 4, 0, 0]),
        (TAG_DNG_BACKWARD_VERSION, _TYPE_BYTE, [1, 1, 0, 0]),
        (T.COLOR_MATRIX_1, _TYPE_SRATIONAL,
         [_rat(v) for v in np.asarray(img.xyz_to_cam,
                                      dtype=np.float64).ravel()[:9]]),
    ]
    if img.orientation in range(1, 9) and img.orientation != 1:
        ifd0.append((T.ORIENTATION, _TYPE_SHORT, [img.orientation]))
    if img.camera_make:
        ifd0.append((T.MAKE, _TYPE_ASCII, img.camera_make))
    if img.camera_model:
        ifd0.append((T.MODEL, _TYPE_ASCII, img.camera_model))
    if unique:
        ifd0.append((TAG_UNIQUE_CAMERA_MODEL, _TYPE_ASCII, unique))
    if software:
        ifd0.append((TAG_SOFTWARE, _TYPE_ASCII, software))
    if datetime_str:
        ifd0.append((TAG_DATE_TIME, _TYPE_ASCII, datetime_str))
    if not img.wb_is_default:
        # AsShotNeutral is the camera-space white: the reciprocal of the
        # green-normalized multipliers (decode.py:_wb_from_neutral
        # inverts this exactly, up to the 1e-6 rational quantization).
        mult = np.asarray(img.wb_multipliers, dtype=np.float64)
        if mult.shape[0] >= 3 and np.all(mult[:3] > 0):
            ifd0.append((T.AS_SHOT_NEUTRAL, _TYPE_RATIONAL,
                         [_rat(1.0 / v, 1000000) for v in mult[:3]]))
    if preview_idx is not None:
        ifd0 += [
            (T.JPEG_INTERCHANGE, _TYPE_LONG, ("blob", preview_idx)),
            (T.JPEG_INTERCHANGE_LEN, _TYPE_LONG, [len(preview_jpeg)]),
        ]
    ifd0.sort(key=lambda e: e[0])

    sensor_ifd = [
        (T.NEW_SUBFILE_TYPE, _TYPE_LONG, [0]),
        (T.IMAGE_WIDTH, _TYPE_LONG, [w]),
        (T.IMAGE_LENGTH, _TYPE_LONG, [h]),
        (T.COMPRESSION, _TYPE_SHORT, [comp_tag]),
        (T.STRIP_OFFSETS, _TYPE_LONG, ("blob", sensor_idx)),
        (T.ROWS_PER_STRIP, _TYPE_LONG, [h]),
        (T.STRIP_BYTE_COUNTS, _TYPE_LONG, [len(sensor)]),
        (T.WHITE_LEVEL, _TYPE_LONG, [int(img.white_level)]),
    ]
    if linear:
        sensor_ifd += [
            (T.BITS_PER_SAMPLE, _TYPE_SHORT, [bpp, bpp, bpp]),
            (T.PHOTOMETRIC, _TYPE_SHORT, [T.PHOTOMETRIC_LINEAR_RAW]),
            (T.SAMPLES_PER_PIXEL, _TYPE_SHORT, [3]),
        ]
    else:
        dim = 2 if len(cfa) == 4 else 6
        sensor_ifd += [
            (T.BITS_PER_SAMPLE, _TYPE_SHORT, [bpp]),
            (T.PHOTOMETRIC, _TYPE_SHORT, [T.PHOTOMETRIC_CFA]),
            (T.SAMPLES_PER_PIXEL, _TYPE_SHORT, [1]),
            (T.CFA_REPEAT_DIM, _TYPE_SHORT, [dim, dim]),
            (T.CFA_PATTERN, _TYPE_BYTE, [_CFA_CODE[c] for c in cfa]),
        ]
    if img.black_per_site is not None and not linear:
        site = np.asarray(img.black_per_site, dtype=np.float64).reshape(4)
        sensor_ifd += [
            (T.BLACK_LEVEL_REPEAT_DIM, _TYPE_SHORT, [2, 2]),
            (T.BLACK_LEVEL, _TYPE_RATIONAL, [_rat(v, 100) for v in site]),
        ]
    elif img.black_level:
        sensor_ifd.append(
            (T.BLACK_LEVEL, _TYPE_RATIONAL, [_rat(img.black_level, 100)]))
    sensor_ifd.sort(key=lambda e: e[0])

    data = wtr.build([ifd0, sensor_ifd], chain=(0,))
    if path is not None:
        from raweditor_tpu_torch.pipeline.export import _atomic_write

        path = os.fspath(path)

        def write(tmp_path):
            with open(tmp_path, "wb") as f:
                f.write(data)

        _atomic_write(path, write)
    return data
