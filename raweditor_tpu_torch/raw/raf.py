"""Fuji RAF container wrapper.

RAF is not a TIFF: a "FUJIFILMCCD-RAW" header with a fixed-position
offset table pointing at an embedded JPEG preview, a CFA metadata
record section, and the sensor data. The layout here follows the
long-public description (exiftool/libraw lineage):

    0x00  "FUJIFILMCCD-RAW " magic (16 bytes)
    0x10  format version (4 ASCII)
    0x14  camera number id (8)
    0x1C  camera model name (32, NUL-padded)
    0x3C  directory version (4 ASCII)
    0x40  20 unknown bytes
    0x54  u32 BE jpeg_offset      0x58  u32 BE jpeg_length
    0x5C  u32 BE meta_offset      0x60  u32 BE meta_length
    0x64  u32 BE cfa_offset       0x68  u32 BE cfa_length

Meta section: u32 BE record count, then records of (u16 tag, u16 size,
payload). Tags used: 0x0100 = raw height/width (2×u16), 0x2FF0 = WB
levels (4×u16, G R B G order), 0x0130/0x0131 = CFA layout.

Modern RAFs embed a full TIFF at cfa_offset (decoded by the normal
pipeline); older ones store a bare big-endian u16 mosaic of the 0x0100
dimensions. Both are handled. As with the other decoders, no camera
files exist in this environment: validated by round-trip against
``write_raf`` below.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

MAGIC = b"FUJIFILMCCD-RAW "

TAG_DIMS = 0x0100
TAG_WB_GRB = 0x2FF0


def is_raf(data: bytes) -> bool:
    return data[: len(MAGIC)] == MAGIC


class RafFile:
    def __init__(self, data: bytes):
        if not is_raf(data):
            raise ValueError("not a RAF: bad magic")
        if len(data) < 0x6C:
            raise ValueError("RAF too short")
        self.data = data
        self.model = data[0x1C:0x3C].split(b"\0")[0].decode(
            "ascii", "replace"
        )
        (self.jpeg_offset, self.jpeg_length,
         self.meta_offset, self.meta_length,
         self.cfa_offset, self.cfa_length) = struct.unpack_from(
            ">6I", data, 0x54
        )
        for off, ln in ((self.jpeg_offset, self.jpeg_length),
                        (self.meta_offset, self.meta_length),
                        (self.cfa_offset, self.cfa_length)):
            if off + ln > len(data):
                raise ValueError("RAF section out of bounds")
        self.records = self._parse_meta()

    def _parse_meta(self) -> dict:
        out = {}
        if not self.meta_length:
            return out
        pos = self.meta_offset
        end = self.meta_offset + self.meta_length
        try:
            (count,) = struct.unpack_from(">I", self.data, pos)
            pos += 4
            for _ in range(count):
                if pos + 4 > end:
                    raise ValueError(
                        "RAF metadata record overruns meta section")
                tag, size = struct.unpack_from(">HH", self.data, pos)
                pos += 4
                if pos + size > end:
                    raise ValueError(
                        "RAF metadata record overruns meta section")
                out[tag] = self.data[pos : pos + size]
                pos += size
        except struct.error as e:
            raise ValueError(f"truncated RAF metadata: {e}") from e
        return out

    def jpeg(self) -> Optional[bytes]:
        if not self.jpeg_length:
            return None
        return self.data[self.jpeg_offset : self.jpeg_offset
                         + self.jpeg_length]

    def dimensions(self) -> Optional[Tuple[int, int]]:
        rec = self.records.get(TAG_DIMS)
        if rec is None or len(rec) < 4:
            return None
        h, w = struct.unpack_from(">HH", rec, 0)
        return h, w

    def wb_multipliers(self) -> Optional[np.ndarray]:
        """G R B G record → [R, G, B, G2] green-normalized."""
        rec = self.records.get(TAG_WB_GRB)
        if rec is None or len(rec) < 8:
            return None
        g, r, b, g2 = struct.unpack_from(">4H", rec, 0)
        if g == 0:
            return None
        from raweditor_tpu_torch.raw.types import RawImage

        return RawImage.normalize_wb([r, g, b, g2])

    def cfa_section(self) -> bytes:
        return self.data[self.cfa_offset : self.cfa_offset
                         + self.cfa_length]


def write_raf(mosaic: np.ndarray, model: str = "X-Synth",
              jpeg: bytes = b"", wb_grbg=(302, 624, 466, 302),
              embed_tiff: Optional[bytes] = None) -> bytes:
    """Synthetic RAF writer (fixtures): bare BE u16 mosaic or an
    embedded TIFF CFA section."""
    mosaic = np.asarray(mosaic, np.uint16)
    h, w = mosaic.shape
    meta = bytearray()
    records = [
        (TAG_DIMS, struct.pack(">HH", h, w)),
        (TAG_WB_GRB, struct.pack(">4H", *wb_grbg)),
    ]
    meta += struct.pack(">I", len(records))
    for tag, payload in records:
        meta += struct.pack(">HH", tag, len(payload)) + payload

    cfa = embed_tiff if embed_tiff is not None else mosaic.astype(
        ">u2"
    ).tobytes()

    header_len = 0x6C
    jpeg_offset = header_len
    meta_offset = jpeg_offset + len(jpeg)
    cfa_offset = meta_offset + len(meta)

    out = bytearray()
    out += MAGIC
    out += b"0201"  # format version
    out += b"SYNTH001"  # camera number
    out += model.encode("ascii")[:32].ljust(32, b"\0")
    out += b"0100"  # directory version
    out += b"\0" * 20
    out += struct.pack(">6I", jpeg_offset, len(jpeg), meta_offset,
                       len(meta), cfa_offset, len(cfa))
    assert len(out) == header_len
    out += jpeg
    out += meta
    out += cfa
    return bytes(out)
