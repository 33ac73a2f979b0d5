"""Minimal TIFF/IFD container walker.

RAW formats in scope (NEF, DNG, CR2, and friends) are TIFF containers:
an IFD chain with tagged entries, sub-IFDs, and strips/tiles of sensor
data. The reference delegates all of this to the ``rawloader`` crate
(reference: raw/loader.rs:50-54); this is our own implementation. Pure
Python here — the hot paths (Huffman decode, byte scans) live in the
native extension; container parsing is microseconds of tag reads.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional

# Tag ids we care about.
NEW_SUBFILE_TYPE = 254
IMAGE_WIDTH = 256
IMAGE_LENGTH = 257
BITS_PER_SAMPLE = 258
COMPRESSION = 259
PHOTOMETRIC = 262
MAKE = 271
MODEL = 272
ORIENTATION = 274
STRIP_OFFSETS = 273
SAMPLES_PER_PIXEL = 277
ROWS_PER_STRIP = 278
STRIP_BYTE_COUNTS = 279
SUB_IFDS = 330
JPEG_INTERCHANGE = 513
JPEG_INTERCHANGE_LEN = 514
TILE_WIDTH = 322
TILE_LENGTH = 323
TILE_OFFSETS = 324
TILE_BYTE_COUNTS = 325
SAMPLE_FORMAT = 339
CFA_REPEAT_DIM = 33421
CFA_PATTERN = 33422
EXIF_IFD = 34665
MAKER_NOTE = 37500
DNG_VERSION = 50706
BLACK_LEVEL_REPEAT_DIM = 50713
BLACK_LEVEL = 50714
WHITE_LEVEL = 50717
COLOR_MATRIX_1 = 50721
COLOR_MATRIX_2 = 50722
AS_SHOT_NEUTRAL = 50728
CR2_SLICE = 50752  # 0xC640: Canon CR2 vertical slice layout

PHOTOMETRIC_CFA = 32803
PHOTOMETRIC_LINEAR_RAW = 34892
COMPRESSION_NONE = 1
COMPRESSION_LJPEG = 7  # "new-style" JPEG; SOF3 lossless in RAWs
COMPRESSION_NIKON = 34713
COMPRESSION_ARW2 = 32767
COMPRESSION_PENTAX = 65535
COMPRESSION_KODAK65000 = 65000
COMPRESSION_SRW1 = 32770
COMPRESSION_SRW3 = 32772  # Samsung NX1/NX500 class (samsung v3)
COMPRESSION_RADC = 65200  # Kodak DC40/DC50-class RADC

# Samsung SRW tags (ExifTool-published ids; reference decodes them via
# rawloader's srw module, reference: raw/loader.rs:50-54).
SRW_ROW_OFFSETS = 0xA010  # LONG: file offset of the per-row u32 table
SRW_WB_RGGB = 0xA021      # 4x LONG: WB levels R,G,G2,B
SRW_BLACK_RGGB = 0xA028   # 4x LONG: per-site black levels

# Panasonic RW2 IFD0 tags (the RW2 container reuses the TIFF structure
# with its own tag vocabulary; ids per the published dcraw/exiftool
# PanasonicRaw maps).
PANA_SENSOR_WIDTH = 0x0002
PANA_SENSOR_HEIGHT = 0x0003
PANA_CFA_PATTERN = 0x0009  # 1=RGGB 2=GRBG 3=GBRG 4=BGGR
PANA_BPS = 0x000A
PANA_BLACK_R = 0x001C
PANA_BLACK_G = 0x001D
PANA_BLACK_B = 0x001E
PANA_WB_RED = 0x0024
PANA_WB_GREEN = 0x0025
PANA_WB_BLUE = 0x0026
PANA_JPG_FROM_RAW = 0x002E
PANA_RAW_OFFSET = 0x0118  # LONG: v4 payload offset, runs to EOF

# TIFF magic variants: ORF keeps the II/MM order mark but replaces the
# 42 with 'RO'/'SR'; RW2 uses 0x55 (and a raw-offset tag instead of
# strips). The IFD layout is standard TIFF in all of them.
MAGIC_TIFF = 42
MAGIC_ORF_RO = 0x4F52
MAGIC_ORF_SR = 0x5352
MAGIC_RW2 = 0x55

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d"}


@dataclasses.dataclass
class Tag:
    tag: int
    type: int
    count: int
    value: object  # scalar, tuple, bytes, or str
    offset: int  # absolute file offset of the payload


@dataclasses.dataclass
class IFD:
    offset: int
    tags: Dict[int, Tag]
    sub_ifds: List["IFD"] = dataclasses.field(default_factory=list)
    exif: Optional["IFD"] = None

    def get(self, tag: int, default=None):
        t = self.tags.get(tag)
        return t.value if t is not None else default

    def get_scalar(self, tag: int, default=None):
        v = self.get(tag, default)
        if isinstance(v, tuple):
            return v[0] if v else default
        return v

    def walk(self):
        """This IFD and all nested sub/exif IFDs, depth-first."""
        yield self
        for s in self.sub_ifds:
            yield from s.walk()
        if self.exif is not None:
            yield from self.exif.walk()


class TiffFile:
    """Parsed TIFF container over an in-memory byte buffer.

    All malformed-input failures raise ValueError (the contract
    decode_raw converts to RawDecodeError); truncated structures must
    never leak struct.error."""

    def __init__(self, data: bytes):
        self.data = data
        if len(data) < 8:
            raise ValueError("not a TIFF: too short")
        order = data[:2]
        if order == b"II":
            self.endian = "<"
        elif order == b"MM":
            self.endian = ">"
        else:
            raise ValueError("not a TIFF: bad byte-order mark")
        try:
            magic = self._u16(2)
            if magic == MAGIC_TIFF:
                self.variant = "tiff"
            elif magic in (MAGIC_ORF_RO, MAGIC_ORF_SR):
                self.variant = "orf"
            elif magic == MAGIC_RW2:
                self.variant = "rw2"
            else:
                raise ValueError(f"not a TIFF: magic {magic}")
            self.ifds: List[IFD] = []
            next_off = self._u32(4)
            seen = set()
            while next_off and next_off not in seen and next_off < len(data):
                seen.add(next_off)
                ifd, next_off = self._parse_ifd(next_off, seen)
                self.ifds.append(ifd)
        except struct.error as e:
            raise ValueError(f"truncated TIFF structure: {e}") from e

    # -- primitive reads ------------------------------------------------
    def _u16(self, off: int) -> int:
        return struct.unpack_from(self.endian + "H", self.data, off)[0]

    def _u32(self, off: int) -> int:
        return struct.unpack_from(self.endian + "I", self.data, off)[0]

    # -- IFD parsing -----------------------------------------------------
    def _parse_ifd(self, offset: int, seen: set):
        n = self._u16(offset)
        tags: Dict[int, Tag] = {}
        pos = offset + 2
        for _ in range(n):
            try:
                tag = self._parse_entry(pos)
            except (struct.error, ValueError, IndexError):
                tag = None
            if tag is not None:
                tags[tag.tag] = tag
            pos += 12
        next_off = self._u32(pos) if pos + 4 <= len(self.data) else 0
        ifd = IFD(offset=offset, tags=tags)

        sub = tags.get(SUB_IFDS)
        if sub is not None:
            offs = sub.value if isinstance(sub.value, tuple) else (sub.value,)
            for so in offs:
                if isinstance(so, int) and so and so not in seen and so < len(self.data):
                    seen.add(so)
                    child, _ = self._parse_ifd(so, seen)
                    ifd.sub_ifds.append(child)
        exif = tags.get(EXIF_IFD)
        if exif is not None:
            eo = exif.value if isinstance(exif.value, int) else None
            if eo and eo not in seen and eo < len(self.data):
                seen.add(eo)
                ifd.exif, _ = self._parse_ifd(eo, seen)
        return ifd, next_off

    def _parse_entry(self, pos: int) -> Optional[Tag]:
        tag, typ, count = struct.unpack_from(self.endian + "HHI", self.data, pos)
        size = _TYPE_SIZES.get(typ)
        if size is None:
            return None
        total = size * count
        if total <= 4:
            payload_off = pos + 8
        else:
            payload_off = self._u32(pos + 8)
            if payload_off + total > len(self.data):
                return None
        value = self._decode_value(typ, count, payload_off)
        return Tag(tag=tag, type=typ, count=count, value=value,
                   offset=payload_off)

    def _decode_value(self, typ: int, count: int, off: int):
        if typ == 2:  # ASCII
            raw = self.data[off : off + count]
            return raw.split(b"\0")[0].decode("ascii", "replace")
        if typ in (7,):  # UNDEFINED: keep raw bytes
            return self.data[off : off + count]
        if typ in (5, 10):  # RATIONAL
            fmt = self.endian + ("II" if typ == 5 else "ii")
            vals = []
            for i in range(count):
                num, den = struct.unpack_from(fmt, self.data, off + 8 * i)
                vals.append(num / den if den else 0.0)
            if count == 0:
                return ()
            return tuple(vals) if count > 1 else vals[0]
        fmt = _TYPE_FMT.get(typ)
        if fmt is None:
            return self.data[off : off + _TYPE_SIZES[typ] * count]
        vals = struct.unpack_from(self.endian + fmt * count, self.data, off)
        if count == 0:
            return ()
        return vals if count > 1 else vals[0]

    # -- RAW-specific helpers -------------------------------------------
    def all_ifds(self):
        for top in self.ifds:
            yield from top.walk()

    def find_linear_ifd(self) -> Optional[IFD]:
        """A LinearRaw (34892) RGB sensor plane, if present (DNGs from
        demosaiced/sRAW sources)."""
        linear = [
            i
            for i in self.all_ifds()
            if i.get_scalar(PHOTOMETRIC) == PHOTOMETRIC_LINEAR_RAW
            and i.get_scalar(SAMPLES_PER_PIXEL, 1) == 3
        ]
        if not linear:
            return None
        return max(
            linear,
            key=lambda i: (i.get_scalar(IMAGE_WIDTH, 0) or 0)
            * (i.get_scalar(IMAGE_LENGTH, 0) or 0),
        )

    def find_cfa_ifd(self) -> Optional[IFD]:
        """The sensor-data IFD: CFA photometric if tagged, else the
        largest image plane that isn't an obvious preview."""
        cfa = [
            i
            for i in self.all_ifds()
            if i.get_scalar(PHOTOMETRIC) == PHOTOMETRIC_CFA
        ]
        if cfa:
            return max(
                cfa,
                key=lambda i: (i.get_scalar(IMAGE_WIDTH, 0) or 0)
                * (i.get_scalar(IMAGE_LENGTH, 0) or 0),
            )
        candidates = [
            i
            for i in self.all_ifds()
            if (i.get(STRIP_OFFSETS) is not None
                or i.get(TILE_OFFSETS) is not None)
            and i.get_scalar(SAMPLES_PER_PIXEL, 1) == 1
        ]
        if not candidates:
            return None
        return max(
            candidates,
            key=lambda i: (i.get_scalar(IMAGE_WIDTH, 0) or 0)
            * (i.get_scalar(IMAGE_LENGTH, 0) or 0),
        )

    @staticmethod
    def _offset_list(offs, lens, what: str):
        """Validate offset/byte-count tag values (fuzzed files can carry
        arbitrary types here — e.g. RATIONAL tuples)."""
        if offs is None or lens is None:
            raise ValueError(f"IFD has no {what} data")
        if not isinstance(offs, tuple):
            offs, lens = (offs,), (lens,)
        try:
            pairs = [(int(o), int(n)) for o, n in zip(offs, lens)]
        except (TypeError, ValueError) as e:
            raise ValueError(f"malformed {what} offsets: {e}") from e
        if any(o < 0 or n < 0 for o, n in pairs):
            raise ValueError(f"negative {what} offsets")
        return pairs

    def strip_data(self, ifd: IFD) -> List[bytes]:
        pairs = self._offset_list(
            ifd.get(STRIP_OFFSETS), ifd.get(STRIP_BYTE_COUNTS), "strip"
        )
        return [self.data[o : o + n] for o, n in pairs]

    def tile_data(self, ifd: IFD) -> List[bytes]:
        pairs = self._offset_list(
            ifd.get(TILE_OFFSETS), ifd.get(TILE_BYTE_COUNTS), "tile"
        )
        return [self.data[o : o + n] for o, n in pairs]

    def is_tiled(self, ifd: IFD) -> bool:
        return ifd.get(TILE_OFFSETS) is not None
