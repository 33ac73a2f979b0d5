"""EXIF APP1 metadata for exported images (beyond the reference).

The reference exports bare JPEG/PNG with no metadata
(reference: main.rs:1765-1791 saves pixel data only), so a shot from a
rotated camera displays sideways in every viewer. Exports here carry a
minimal, universally-readable EXIF block: camera Make/Model (decoded
from the RAW container), the Orientation tag (so viewers rotate — or
1 when ``auto_orient`` already rotated the pixels), and the Software
tag.

The block is a little-endian TIFF with a single IFD0, wrapped as
``Exif\\0\\0`` for JPEG APP1 (:func:`splice_exif` inserts the segment
straight after SOI for the native JFIF encoder's output; PIL's
``save(exif=...)`` consumes the same bytes). The payload is built by
hand — six fixed tags — rather than through raw/synth.py's writer, so
this module has no dependency on the fixture machinery.
"""

from __future__ import annotations

import struct
from typing import Optional

from raweditor_tpu_torch.version import __version__

_ASCII = 2
_SHORT = 3

_MAKE = 0x010F
_MODEL = 0x0110
_ORIENTATION = 0x0112
_SOFTWARE = 0x0131
_DESCRIPTION = 0x010E

SOFTWARE = f"raweditor-tpu {__version__}"


def build_exif(make: str = "", model: str = "", orientation: int = 1,
               software: str = SOFTWARE,
               description: Optional[str] = None) -> bytes:
    """``Exif\\0\\0`` + TIFF payload with IFD0 metadata tags.

    Suitable for PIL's ``save(exif=...)`` (JPEG APP1 / PNG eXIf) and
    for :func:`splice_exif` on native-encoded JPEGs."""
    if orientation not in range(1, 9):
        orientation = 1
    entries = []  # (tag, type, count, value_bytes)
    for tag, text in ((_MAKE, make), (_MODEL, model),
                      (_SOFTWARE, software), (_DESCRIPTION, description)):
        if text:
            raw = text.encode("utf-8", "replace") + b"\0"
            entries.append((tag, _ASCII, len(raw), raw))
    entries.append((_ORIENTATION, _SHORT, 1,
                    struct.pack("<H", orientation)))
    entries.sort(key=lambda e: e[0])  # TIFF requires ascending tags

    header = b"II*\0" + struct.pack("<I", 8)  # IFD0 at offset 8
    ifd_len = 2 + 12 * len(entries) + 4
    out_of_line_at = 8 + ifd_len
    ifd = struct.pack("<H", len(entries))
    tail = b""
    for tag, typ, count, raw in entries:
        if len(raw) <= 4:
            value = raw + b"\0" * (4 - len(raw))
        else:
            value = struct.pack("<I", out_of_line_at + len(tail))
            # TIFF requires word-aligned value offsets; pad odd-length
            # values so the next one starts even (padding is not
            # counted in the entry's count field).
            tail += raw + (b"\0" if len(raw) % 2 else b"")
        ifd += struct.pack("<HHI", tag, typ, count) + value
    ifd += struct.pack("<I", 0)  # no next IFD
    return b"Exif\0\0" + header + ifd + tail


def splice_exif(jpeg: bytes, exif: bytes) -> bytes:
    """Insert ``exif`` as an APP1 segment right after SOI. Returns the
    input unchanged if it isn't a JPEG or the segment would overflow
    the 64 KB marker limit."""
    if len(jpeg) < 2 or jpeg[:2] != b"\xff\xd8" or len(exif) + 2 > 0xFFFF:
        return jpeg
    seg = b"\xff\xe1" + struct.pack(">H", len(exif) + 2) + exif
    return jpeg[:2] + seg + jpeg[2:]
