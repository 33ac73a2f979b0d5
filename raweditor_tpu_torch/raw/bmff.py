"""ISO-BMFF container walk for Canon CR3 (and HEIF-style) files.

The reference app imports ``.cr3`` (reference: main.rs:1852-1855) but
its rawloader backend cannot decode the CRX sensor codec — previews
come from the byte-window JPEG scan (reference: raw/thumbnail.rs,
raw/processor.rs:92-125). This module gives the rebuild a *structured*
path to the same data and more: the box tree is walked properly, the
Canon metadata boxes (``CMT1``..``CMT4`` — each a complete little TIFF
holding IFD0 / Exif / MakerNote / GPS) are parsed with the normal TIFF
machinery, the ``THMB``/``PRVW`` preview payloads are extracted
directly, and the ``CNCV`` compressor-version string is surfaced in
the quarantine message. CRX sensor decode itself remains a documented
gap (docs/formats.md).

Parsing is deliberately conservative: every ``uuid`` box is treated as
a potential container (no Canon-UUID matching — the child walk either
yields well-formed boxes or is abandoned), and preview payloads are
located by JPEG marker scan inside the THMB/PRVW boxes rather than by
fixed header offsets, so minor layout variants cannot break it.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

# Box types that contain child boxes directly.
_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf",
               b"edts"}
# Canon leaf boxes of interest (all live under moov/uuid in real CR3s,
# but we collect them wherever they appear).
_CANON_TIFF_BOXES = (b"CMT1", b"CMT2", b"CMT3", b"CMT4")


def is_bmff(data: bytes) -> bool:
    return len(data) >= 12 and data[4:8] == b"ftyp"


def _plausible_child(data: bytes, start: int, end: int) -> bool:
    """A child box needs a sane size and a printable fourcc."""
    if end - start < 8:
        return False
    (size,) = struct.unpack_from(">I", data, start)
    fourcc = data[start + 4:start + 8]
    if size != 1 and (size < 8 or start + size > end):
        # size 0 (= to end) only appears as a last top-level box; treat
        # it as implausible inside uuid payloads.
        return False
    return all(0x20 <= c < 0x7F for c in fourcc)


class BmffFile:
    """Recursive box walk; ``boxes`` maps fourcc -> list of payload
    byte ranges (offset, length) into ``data``."""

    def __init__(self, data: bytes):
        if not is_bmff(data):
            raise ValueError("not an ISO-BMFF file")
        self.data = data
        self.boxes: Dict[bytes, List[Tuple[int, int]]] = {}
        # Body spans of each moov/trak, so sample-table boxes (stsd,
        # stsz, co64) can be matched within ONE track rather than
        # globally across all of them.
        self.trak_spans: List[Tuple[int, int]] = []
        self._walk(0, len(data), 0)

    def _add(self, fourcc: bytes, start: int, end: int) -> None:
        self.boxes.setdefault(fourcc, []).append((start, end - start))

    def _walk(self, start: int, end: int, depth: int) -> None:
        if depth > 8:
            return
        pos = start
        while pos + 8 <= end:
            (size,) = struct.unpack_from(">I", self.data, pos)
            fourcc = self.data[pos + 4:pos + 8]
            body = pos + 8
            if size == 1:
                if body + 8 > end:
                    break
                (size,) = struct.unpack_from(">Q", self.data, body)
                body += 8
                if size < 16:
                    break
                box_end = pos + size
            elif size == 0:
                box_end = end
            elif size < 8:
                break
            else:
                box_end = pos + size
            if box_end > end:
                break
            if fourcc == b"uuid" and box_end - body >= 16:
                inner = body + 16
                # A Canon metadata uuid holds well-formed child boxes;
                # other uuids (binary payloads) fail the plausibility
                # check and are kept as opaque leaves.
                if _plausible_child(self.data, inner, box_end):
                    self._walk(inner, box_end, depth + 1)
                else:
                    self._add(fourcc, inner, box_end)
            elif fourcc in _CONTAINERS:
                if fourcc == b"trak":
                    self.trak_spans.append((body, box_end))
                self._walk(body, box_end, depth + 1)
            else:
                self._add(fourcc, body, box_end)
            pos = box_end

    def payloads(self, fourcc: bytes) -> List[bytes]:
        return [self.data[o:o + n] for o, n in self.boxes.get(fourcc, [])]

    # --- Canon CR3 accessors ------------------------------------------------

    def brand(self) -> str:
        p = self.payloads(b"ftyp")
        if p and len(p[0]) >= 4:
            return p[0][:4].decode("ascii", "replace").strip()
        return ""

    def codec_version(self) -> str:
        """CNCV — the Canon compressor version string."""
        p = self.payloads(b"CNCV")
        return p[0].decode("ascii", "replace").strip() if p else ""

    def metadata_tiff(self, which: int):
        """CMT<which> parsed as a TiffFile, or None."""
        from raweditor_tpu_torch.raw import tiff as T

        name = b"CMT%d" % which
        for blob in self.payloads(name):
            try:
                return T.TiffFile(blob)
            except ValueError:
                continue
        return None

    def camera_info(self) -> Dict[str, object]:
        """make/model/orientation from CMT1 (IFD0), sensor dims from
        CMT2 (the Exif IFD's PixelX/YDimension)."""
        out: Dict[str, object] = {}
        tf = self.metadata_tiff(1)
        if tf is not None:
            for ifd in tf.all_ifds():
                make = ifd.get(0x010F)
                model = ifd.get(0x0110)
                orient = ifd.get_scalar(0x0112)
                if isinstance(make, str) and "make" not in out:
                    out["make"] = make.strip("\0 ")
                if isinstance(model, str) and "model" not in out:
                    out["model"] = model.strip("\0 ")
                if isinstance(orient, int) and "orientation" not in out:
                    out["orientation"] = orient
        tf2 = self.metadata_tiff(2)
        if tf2 is not None:
            for ifd in tf2.all_ifds():
                w = ifd.get_scalar(0xA002)
                h = ifd.get_scalar(0xA003)
                if isinstance(w, int) and isinstance(h, int):
                    out.setdefault("width", w)
                    out.setdefault("height", h)
        return out

    def raw_track(self) -> Optional[Tuple[bytes, int, int]]:
        """Locate the CRX sensor sample: scan each trak's sample table
        for a ``CRAW`` stsd entry, return (CMP1 payload, sample offset,
        sample size) into ``data`` — offset/size from the track's own
        stsz + co64/stco. None when no CRAW track exists."""
        for span_start, span_end in self.trak_spans:
            sub = BmffFile.__new__(BmffFile)
            sub.data = self.data
            sub.boxes = {}
            sub.trak_spans = []
            sub._walk(span_start, span_end, 1)
            cmp1 = None
            for off, n in sub.boxes.get(b"stsd", []):
                cmp1 = _craw_cmp1(self.data, off, off + n)
                if cmp1 is not None:
                    break
            if cmp1 is None:
                continue
            size = _first_sample_size(sub, self.data)
            offset = _first_chunk_offset(sub, self.data)
            if size is None or offset is None:
                raise ValueError("CRAW track without stsz/co64 tables")
            if offset + size > len(self.data):
                raise ValueError("CRAW sample extends past EOF")
            return cmp1, offset, size
        return None

    def preview_jpeg(self) -> Optional[bytes]:
        """Largest decodable-looking JPEG across the PRVW/THMB preview
        boxes (marker scan inside the payload — robust to the small
        header in front of the JPEG bytes)."""
        from raweditor_tpu_torch.raw.jpeg_scan import extract_largest_jpeg

        best = None
        for fourcc in (b"PRVW", b"THMB"):
            for blob in self.payloads(fourcc):
                jpeg = extract_largest_jpeg(blob)
                if jpeg and (best is None or len(jpeg) > len(best)):
                    best = jpeg
        return best


# 8-byte sample-entry preamble + 6 reserved + u16 dref index + the
# 70-byte fixed video-sample-entry fields = child boxes start at +86.
_VIDEO_ENTRY_FIXED = 86


def _craw_cmp1(data: bytes, start: int, end: int) -> Optional[bytes]:
    """CMP1 payload of the first CRAW entry in an stsd box body."""
    if end - start < 8:
        return None
    (count,) = struct.unpack_from(">I", data, start + 4)
    pos = start + 8
    for _ in range(min(count, 16)):
        if pos + 8 > end:
            return None
        (esize,) = struct.unpack_from(">I", data, pos)
        if esize < 16 or pos + esize > end:
            return None
        if data[pos + 4:pos + 8] == b"CRAW":
            child = pos + _VIDEO_ENTRY_FIXED
            entry_end = pos + esize
            while child + 8 <= entry_end:
                (csize,) = struct.unpack_from(">I", data, child)
                if csize < 8 or child + csize > entry_end:
                    break
                if data[child + 4:child + 8] == b"CMP1":
                    return data[child + 8:child + csize]
                child += csize
            return None
        pos += esize
    return None


def _first_sample_size(sub: "BmffFile", data: bytes) -> Optional[int]:
    for off, n in sub.boxes.get(b"stsz", []):
        if n < 12:
            continue
        fixed, count = struct.unpack_from(">II", data, off + 4)
        if fixed:
            return fixed
        if count >= 1 and n >= 16:
            return struct.unpack_from(">I", data, off + 12)[0]
    return None


def _first_chunk_offset(sub: "BmffFile", data: bytes) -> Optional[int]:
    for off, n in sub.boxes.get(b"co64", []):
        if n >= 16 and struct.unpack_from(">I", data, off + 4)[0] >= 1:
            return struct.unpack_from(">Q", data, off + 8)[0]
    for off, n in sub.boxes.get(b"stco", []):
        if n >= 12 and struct.unpack_from(">I", data, off + 4)[0] >= 1:
            return struct.unpack_from(">I", data, off + 8)[0]
    return None


def describe(data: bytes) -> Dict[str, object]:
    """Best-effort structured description for CLI ``info`` on BMFF
    containers the sensor decoder quarantines."""
    out: Dict[str, object] = {}
    try:
        bf = BmffFile(data)
    except ValueError:
        return out
    out["container"] = "ISO-BMFF"
    if bf.brand():
        out["brand"] = bf.brand()
    if bf.codec_version():
        out["codec"] = bf.codec_version()
    out.update(bf.camera_info())
    jpeg = bf.preview_jpeg()
    if jpeg:
        out["preview_bytes"] = len(jpeg)
    return out


# --- synthetic writer --------------------------------------------------------

# Published Canon box UUIDs (the parser does not match on them; they
# make the synthetic files structurally faithful).
_CANON_META_UUID = bytes.fromhex("85c0b687820f11e08111f4ce462b6a48")
_CANON_PRVW_UUID = bytes.fromhex("eaf42b5e1c984b88b9fbb7dc406e4d16")


def _box(fourcc: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc + payload


def _mini_tiff(entries) -> bytes:
    """Minimal little-endian TIFF: one IFD0 with the given
    (tag, type, values/string) entries."""
    # type 2 = ASCII, 3 = SHORT, 4 = LONG
    hdr = b"II*\x00" + struct.pack("<I", 8)
    n = len(entries)
    ifd_size = 2 + 12 * n + 4
    data_off = 8 + ifd_size
    table = struct.pack("<H", n)
    tail = b""
    for tag, typ, val in sorted(entries, key=lambda e: e[0]):
        if typ == 2:
            raw = val.encode("ascii") + b"\0"
            count = len(raw)
            if count <= 4:
                field = raw.ljust(4, b"\0")
            else:
                field = struct.pack("<I", data_off + len(tail))
                tail += raw
        elif typ == 3:
            vals = val if isinstance(val, (list, tuple)) else [val]
            count = len(vals)
            raw = struct.pack("<%dH" % count, *vals)
            if len(raw) <= 4:
                field = raw.ljust(4, b"\0")
            else:
                field = struct.pack("<I", data_off + len(tail))
                tail += raw
        else:  # LONG
            vals = val if isinstance(val, (list, tuple)) else [val]
            count = len(vals)
            raw = struct.pack("<%dI" % count, *vals)
            if len(raw) <= 4:
                field = raw.ljust(4, b"\0")
            else:
                field = struct.pack("<I", data_off + len(tail))
                tail += raw
        table += struct.pack("<HHI", tag, typ, count) + field
    table += struct.pack("<I", 0)  # no next IFD
    return hdr + table + tail


def _craw_trak(cmp1_payload: bytes, width: int, height: int,
               sample_size: int, sample_offset: int) -> bytes:
    """Minimal CRAW video track: stsd holding a video sample entry of
    format 'CRAW' with a CMP1 child, stsz with the one sample's size,
    co64 with its absolute mdat offset."""
    entry_body = (b"\0" * 6 + struct.pack(">H", 1)  # dref index
                  + b"\0" * 16
                  + struct.pack(">HH", width, height)
                  + struct.pack(">IIIH", 0x480000, 0x480000, 0, 1)
                  + b"\0" * 32
                  + struct.pack(">Hh", 24, -1))
    entry_body += _box(b"CMP1", cmp1_payload)
    entry = _box(b"CRAW", entry_body)
    stsd = _box(b"stsd", struct.pack(">II", 0, 1) + entry)
    stsz = _box(b"stsz", struct.pack(">III", 0, sample_size, 1))
    co64 = _box(b"co64", struct.pack(">IIQ", 0, 1, sample_offset))
    stbl = _box(b"stbl", stsd + stsz + co64)
    return _box(b"trak", _box(b"mdia", _box(b"minf", stbl)))


def write_synthetic_cr3(path, *, make: str = "Canon",
                        model: str = "EOS Synth R",
                        width: int = 6000, height: int = 4000,
                        preview_jpeg: bytes = b"",
                        thumb_jpeg: bytes = b"",
                        codec: str = "CanonCR3_001/01.09.00/01.00.00",
                        mdat: bytes = b"\0" * 64,
                        mosaic=None, n_bits: int = 14,
                        tile_cols: int = 1, tile_rows: int = 1,
                        levels: int = 0, q_detail: int = 1) -> bytes:
    """Structurally-faithful CR3: ftyp(crx) + moov holding the Canon
    metadata uuid (CNCV, CMT1, CMT2, THMB) and — when ``mosaic`` is
    given — a CRAW track (stsd/CMP1 + stsz + co64) whose CRX-encoded
    sensor sample lands in mdat; plus a PRVW uuid and mdat."""
    if mosaic is not None:
        from raweditor_tpu_torch.raw.crx import encode_crx, make_cmp1

        height, width = mosaic.shape
        cmp1 = make_cmp1(width, height, n_bits=n_bits,
                         tile_cols=tile_cols, tile_rows=tile_rows,
                         levels=levels)
        mdat = encode_crx(mosaic, cmp1, q_detail=q_detail)
    cmt1 = _mini_tiff([(0x010F, 2, make), (0x0110, 2, model),
                       (0x0112, 3, 1)])
    cmt2 = _mini_tiff([(0xA002, 4, width), (0xA003, 4, height)])
    meta_children = _box(b"CNCV", codec.encode("ascii"))
    meta_children += _box(b"CMT1", cmt1)
    meta_children += _box(b"CMT2", cmt2)
    if thumb_jpeg:
        head = struct.pack(">IHHI2H", 0, 160, 120, len(thumb_jpeg), 0, 0)
        meta_children += _box(b"THMB", head + thumb_jpeg)

    def assemble(sample_offset: int) -> bytes:
        moov_children = _box(b"uuid", _CANON_META_UUID + meta_children)
        if mosaic is not None:
            moov_children += _craw_trak(cmp1.pack(), width, height,
                                        len(mdat), sample_offset)
        moov = _box(b"moov", moov_children)
        out = _box(b"ftyp", b"crx " + struct.pack(">I", 1) + b"crx isom")
        out += moov
        if preview_jpeg:
            head = struct.pack(">IHHHHI", 0, 0, 1620, 1080, 0,
                               len(preview_jpeg))
            prvw = _box(b"PRVW", head + preview_jpeg)
            out += _box(b"uuid", _CANON_PRVW_UUID + prvw)
        return out

    # The co64 offset is absolute; sizes don't change between passes,
    # so assemble once to measure, then again with the real offset.
    head_len = len(assemble(0)) + 8  # + the mdat box header
    out = assemble(head_len) + _box(b"mdat", mdat)
    if path is not None:
        with open(path, "wb") as f:
            f.write(out)
    return out
