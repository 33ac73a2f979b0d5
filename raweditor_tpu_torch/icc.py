"""Minimal ICC profiles for wide-gamut export tagging.

An export in Display P3 or Adobe RGB without an embedded profile is
WORSE than sRGB — every consumer assumes sRGB and renders the colors
desaturated/shifted. So the wide-gamut paths (color.cam_to_output_matrix)
always embed a profile; this module builds them from the same
chromaticities color.py derives its matrices from (single source of
truth — the profile can't drift from the math).

Profiles are ICC v2 three-component matrix/TRC display profiles — the
smallest widely-interoperable shape (lcms/ImageCms, macOS, browsers):

- header (128 B): 'mntr' / 'RGB ' / 'XYZ ' with the D50 PCS illuminant
- 'desc', 'cprt' text tags
- 'wtpt' media white (D65) + 'chad' Bradford D65→D50 adaptation
- 'rXYZ'/'gXYZ'/'bXYZ' colorants, Bradford-adapted to D50 (the v2
  convention: colorants live in the PCS)
- 'rTRC'/'gTRC'/'bTRC': a u8Fixed8 gamma for Adobe RGB (563/256
  exactly) and a 1024-entry decode table for the sRGB curve (P3)

Embedding: JPEG APP2 via :func:`splice_icc_jpeg` (native encoder
path), PIL's ``icc_profile=`` kwarg (PIL JPEG/PNG paths), TIFF tag
34675 (raw/tiff_out.py).
"""

from __future__ import annotations

import struct
from functools import lru_cache

import numpy as np

# Bradford cone response (ICC chromatic adaptation).
_BRADFORD = np.array([
    [0.8951, 0.2664, -0.1614],
    [-0.7502, 1.7135, 0.0367],
    [0.0389, -0.0685, 1.0296],
])
# The ICC-spec PCS illuminant (0x0000F6D6/0x00010000/0x0000D32D =
# 0.9642/1.0/0.8249), NOT CIE's 0.96422/0.82521: the colorant sums
# must agree with the header illuminant exactly or strict CMMs flag
# the profile inconsistent (code-review r3).
_D50_XYZ = np.array([0.9642, 1.0, 0.8249])


def _s15f16(v: float) -> bytes:
    return struct.pack(">i", int(round(v * 65536.0)))


def _xyz_tag(xyz) -> bytes:
    return b"XYZ \0\0\0\0" + b"".join(_s15f16(v) for v in xyz)


def _desc_tag(text: str) -> bytes:
    ascii_ = text.encode("ascii") + b"\0"
    # Tail per the v2 textDescriptionType layout: Unicode lang (4) +
    # Unicode count (4) + ScriptCode code (2) + count (1) + 67-byte
    # Mac name = 78 bytes (a 79-byte tail is tolerated by lcms but
    # rejected by strict CMMs; code-review r3).
    return (b"desc\0\0\0\0" + struct.pack(">I", len(ascii_)) + ascii_
            + b"\0" * 11 + b"\0" * 67)


def _text_tag(text: str) -> bytes:
    return b"text\0\0\0\0" + text.encode("ascii") + b"\0"


def _curv_gamma(gamma: float) -> bytes:
    # u8Fixed8 gamma entry (count = 1).
    return (b"curv\0\0\0\0" + struct.pack(">I", 1)
            + struct.pack(">H", int(round(gamma * 256.0))))


def _curv_table(decode_fn, n: int = 1024) -> bytes:
    xs = np.linspace(0.0, 1.0, n)
    ys = np.clip(np.asarray(decode_fn(xs), np.float64), 0.0, 1.0)
    vals = np.round(ys * 65535.0).astype(">u2")
    return (b"curv\0\0\0\0" + struct.pack(">I", n) + vals.tobytes())


def _bradford_adaptation(src_white_xyz) -> np.ndarray:
    src = _BRADFORD @ np.asarray(src_white_xyz, np.float64)
    dst = _BRADFORD @ _D50_XYZ
    return np.linalg.inv(_BRADFORD) @ np.diag(dst / src) @ _BRADFORD


def _build_profile(desc: str, rgb_to_xyz: np.ndarray, trc: bytes) -> bytes:
    """Assemble the v2 matrix/TRC display profile."""
    white_d65 = rgb_to_xyz @ np.ones(3)
    adapt = _bradford_adaptation(white_d65)
    colorants = adapt @ rgb_to_xyz  # columns now sum to D50

    tags = [
        (b"desc", _desc_tag(desc)),
        (b"cprt", _text_tag("raweditor-tpu, derived from public "
                            "chromaticities; no rights reserved")),
        (b"wtpt", _xyz_tag(white_d65)),
        (b"chad", b"sf32\0\0\0\0" + b"".join(
            _s15f16(v) for v in adapt.reshape(-1))),
        (b"rXYZ", _xyz_tag(colorants[:, 0])),
        (b"gXYZ", _xyz_tag(colorants[:, 1])),
        (b"bXYZ", _xyz_tag(colorants[:, 2])),
        (b"rTRC", trc),
        (b"gTRC", trc),
        (b"bTRC", trc),
    ]

    table_len = 4 + 12 * len(tags)
    offset = 128 + table_len
    table = struct.pack(">I", len(tags))
    body = b""
    seen = {}  # identical tag data shares one offset (spec-legal —
    # the three TRC curves are the same table, and duplicating a
    # 1024-entry curv tripled every embedded profile; code-review r3)
    for sig, data in tags:
        if data in seen:
            table += sig + struct.pack(">II", seen[data], len(data))
            continue
        pad = (-len(data)) % 4
        seen[data] = offset + len(body)
        table += sig + struct.pack(">II", offset + len(body),
                                   len(data))
        body += data + b"\0" * pad

    size = 128 + table_len + len(body)
    header = struct.pack(
        ">I4sI4s4s4s12x4s4sIII",
        size,            # profile size
        b"none",         # CMM
        0x02400000,      # version 2.4
        b"mntr",         # device class: display
        b"RGB ",         # data color space
        b"XYZ ",         # PCS
        b"acsp",         # magic
        b"\0\0\0\0",     # platform
        0, 0, 0,         # flags, manufacturer, model
    )
    header += b"\0" * 8                     # attributes
    header += struct.pack(">I", 0)          # rendering intent
    header += (_s15f16(0.9642) + _s15f16(1.0) + _s15f16(0.8249))
    header += b"\0" * (128 - len(header))   # creator + reserved
    return header + table + body


@lru_cache(maxsize=None)
def profile_bytes(color_space: str) -> bytes:
    """The embedded ICC profile for an output color space."""
    from raweditor_tpu_torch.color import (ADOBE_GAMMA, ADOBE_RGB_TO_XYZ,
                                     DISPLAY_P3_TO_XYZ, SRGB_TO_XYZ,
                                     srgb_decode)

    if color_space == "display-p3":
        return _build_profile("Display P3", DISPLAY_P3_TO_XYZ,
                              _curv_table(srgb_decode))
    if color_space == "adobe-rgb":
        return _build_profile("Adobe RGB (1998) compatible",
                              ADOBE_RGB_TO_XYZ,
                              _curv_gamma(ADOBE_GAMMA))
    if color_space == "srgb":
        return _build_profile("sRGB", SRGB_TO_XYZ.astype(np.float64),
                              _curv_table(srgb_decode))
    raise ValueError(f"unknown color space {color_space!r}")


def splice_icc_jpeg(jpeg: bytes, icc: bytes) -> bytes:
    """Insert an ICC profile as APP2 ``ICC_PROFILE`` segment(s) after
    SOI (and after an APP1/EXIF segment when present, per the spec's
    ordering convention). Chunks at the 64 KB marker limit."""
    if len(jpeg) < 2 or jpeg[:2] != b"\xff\xd8":
        return jpeg
    pos = 2
    # Skip an APP0/APP1 block (JFIF/EXIF) so ICC lands after it.
    while (pos + 4 <= len(jpeg) and jpeg[pos] == 0xFF
           and jpeg[pos + 1] in (0xE0, 0xE1)):
        seg_len = struct.unpack(">H", jpeg[pos + 2 : pos + 4])[0]
        pos += 2 + seg_len
    max_data = 65533 - 16  # marker budget minus the chunk header
    chunks = [icc[i : i + max_data] for i in range(0, len(icc), max_data)]
    out = [jpeg[:pos]]
    for i, chunk in enumerate(chunks):
        payload = (b"ICC_PROFILE\0" + bytes([i + 1, len(chunks)])
                   + chunk)
        out.append(b"\xff\xe2" + struct.pack(">H", len(payload) + 2)
                   + payload)
    out.append(jpeg[pos:])
    return b"".join(out)
