"""Synthetic RAW file writer (test fixtures + benchmarks).

No real camera files ship with this repo, so the decoder test strategy
is round-trip: write structurally-valid TIFF/DNG/NEF-style containers
with known mosaics and metadata, then decode them back. The writer
covers the container features the decoder supports: uncompressed and
bit-packed CFA strips, SOF3 lossless-JPEG strips, CFA tags, DNG color
metadata (AsShotNeutral / ColorMatrix1 / Black-WhiteLevel), and an
embedded JPEG preview for the tier-cache pipeline.
"""

from __future__ import annotations

import io
import struct
from typing import List, Optional, Tuple

import numpy as np

from raweditor_tpu_torch.raw import tiff as T
from raweditor_tpu_torch.raw.ljpeg import encode_lossless
from raweditor_tpu_torch.raw.packing import pack_bits

_TYPE_BYTE, _TYPE_ASCII, _TYPE_SHORT, _TYPE_LONG = 1, 2, 3, 4
_TYPE_RATIONAL, _TYPE_UNDEF, _TYPE_SRATIONAL = 5, 7, 10


class _TiffWriter:
    """Little-endian TIFF builder: IFDs of (tag, type, values) entries
    plus opaque data blobs, resolved in one layout pass."""

    def __init__(self):
        self.blobs: List[bytes] = []
        self._blob_offsets: Optional[List[int]] = None

    def add_blob(self, data: bytes) -> int:
        """Register a data blob; returns its index (resolved later)."""
        self.blobs.append(data)
        return len(self.blobs) - 1

    @staticmethod
    def _encode_values(typ: int, values) -> bytes:
        if typ == _TYPE_ASCII:
            # Lenient: decoded camera strings can carry U+FFFD (the
            # reader itself decodes Make/Model with errors="replace",
            # raw/tiff.py), and a strict encode would make write_dng/
            # write_tiff16 crash on them. '?' per char keeps the byte
            # count equal to _count()'s len(values).
            return values.encode("ascii", "replace") + b"\0"
        if typ in (_TYPE_BYTE, _TYPE_UNDEF):
            return bytes(values)
        if typ == _TYPE_SHORT:
            return struct.pack(f"<{len(values)}H", *values)
        if typ == _TYPE_LONG:
            return struct.pack(f"<{len(values)}I", *values)
        if typ == _TYPE_RATIONAL:
            out = b""
            for num, den in values:
                out += struct.pack("<II", num, den)
            return out
        if typ == _TYPE_SRATIONAL:
            out = b""
            for num, den in values:
                out += struct.pack("<ii", num, den)
            return out
        raise ValueError(f"type {typ}")

    @staticmethod
    def _count(typ: int, values) -> int:
        if typ == _TYPE_ASCII:
            return len(values) + 1
        if typ in (_TYPE_RATIONAL, _TYPE_SRATIONAL):
            return len(values)
        return len(values)

    def build(self, ifds: List[List[tuple]], chain=(0,),
              magic: int = 42) -> bytes:
        """ifds: list of entry lists. Entry = (tag, type, values) or
        (tag, type, ("blob", idx)) for offsets into a registered blob,
        or (tag, type, ("ifd", i)) pointing at another IFD (SubIFDs).
        ``chain`` lists the IFD indices linked as the top-level chain.
        ``magic`` overrides the 42 (ORF/RW2 variants).
        """
        header = 8
        # Layout: header | IFD tables | overflow values | blobs.
        ifd_sizes = [2 + 12 * len(entries) + 4 for entries in ifds]
        ifd_offsets = []
        pos = header
        for s in ifd_sizes:
            ifd_offsets.append(pos)
            pos += s

        # First pass: compute overflow sizes.
        overflow_offsets = []
        for entries in ifds:
            per_entry = []
            for tag, typ, values in entries:
                if isinstance(values, tuple) and values and values[0] in (
                    "blob", "ifd",
                ):
                    per_entry.append(0)
                    continue
                if isinstance(values, tuple) and values and values[0] == "blob_multi":
                    size = 4 * len(values[2])
                    per_entry.append(size if size > 4 else 0)
                    continue
                data = self._encode_values(typ, values)
                per_entry.append(len(data) if len(data) > 4 else 0)
            overflow_offsets.append(per_entry)

        overflow_start = pos
        for per_entry in overflow_offsets:
            for i, size in enumerate(per_entry):
                if size:
                    per_entry[i] = pos
                    pos += size + (pos & 1)  # keep even alignment

        blob_offsets = []
        for blob in self.blobs:
            pos += pos & 1
            blob_offsets.append(pos)
            pos += len(blob)
        self._blob_offsets = blob_offsets

        # Emit.
        out = bytearray(b"II" + struct.pack("<H", magic))
        out += struct.pack("<I", ifd_offsets[chain[0]])
        for idx, entries in enumerate(ifds):
            assert len(out) <= ifd_offsets[idx]
            out += b"\0" * (ifd_offsets[idx] - len(out))
            out += struct.pack("<H", len(entries))
            for eidx, (tag, typ, values) in enumerate(entries):
                if isinstance(values, tuple) and values and values[0] == "blob":
                    # Offset into blob: ("blob", idx[, extra_off[, count]]).
                    # count defaults to 1 (LONG offset tags like
                    # StripOffsets); UNDEFINED payloads pass their byte
                    # length so readers slice correctly.
                    blob_idx = values[1]
                    extra = values[2] if len(values) > 2 else 0
                    resolved = blob_offsets[blob_idx] + extra
                    payload = struct.pack("<I", resolved)
                    count = values[3] if len(values) > 3 else 1
                elif isinstance(values, tuple) and values and values[0] == "ifd":
                    resolved = ifd_offsets[values[1]]
                    payload = struct.pack("<I", resolved)
                    count = 1
                elif isinstance(values, tuple) and values and values[0] == "blob_multi":
                    # ("blob_multi", idx, [rel_offsets]): LONG array of
                    # absolute offsets into a blob (tile offsets).
                    base = blob_offsets[values[1]]
                    resolved_list = [base + r for r in values[2]]
                    payload = struct.pack(
                        f"<{len(resolved_list)}I", *resolved_list
                    )
                    count = len(resolved_list)
                    if len(payload) > 4:
                        off = overflow_offsets[idx][eidx]
                        payload = struct.pack("<I", off)
                else:
                    payload = self._encode_values(typ, values)
                    count = self._count(typ, values)
                    if len(payload) > 4:
                        off = overflow_offsets[idx][eidx]
                        payload = struct.pack("<I", off)
                    else:
                        payload = payload.ljust(4, b"\0")
                out += struct.pack("<HHI", tag, typ, count) + payload
            # next-IFD pointer: chain top-level IFDs in order.
            try:
                ci = chain.index(idx)
                nxt = ifd_offsets[chain[ci + 1]] if ci + 1 < len(chain) else 0
            except ValueError:
                nxt = 0
            out += struct.pack("<I", nxt)

        for per_entry, entries in zip(overflow_offsets, ifds):
            for off, (tag, typ, values) in zip(per_entry, entries):
                if off:
                    out += b"\0" * (off - len(out))
                    if isinstance(values, tuple) and values and values[0] == "blob_multi":
                        base = blob_offsets[values[1]]
                        out += struct.pack(
                            f"<{len(values[2])}I",
                            *[base + r for r in values[2]],
                        )
                    else:
                        out += self._encode_values(typ, values)
        for off, blob in zip(blob_offsets, self.blobs):
            out += b"\0" * (off - len(out))
            out += blob
        return bytes(out)


def make_preview_jpeg(width: int = 64, height: int = 42) -> bytes:
    """A small camera-preview-style JPEG (a fixed gradient UNRELATED
    to any mosaic — use only via ``uncorrelated_preview=True``; the
    writers' default preview is rendered from the mosaic so
    synth → validate demonstrates the ok path, VERDICT r4 item 5)."""
    from PIL import Image

    yy, xx = np.mgrid[0:height, 0:width]
    rgb = np.stack(
        [
            (255 * xx / width),
            (255 * yy / height),
            np.full_like(xx, 128),
        ],
        axis=-1,
    ).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def preview_from_mosaic(mosaic: np.ndarray,
                        wb_neutral=(0.5, 1.0, 0.7),
                        black_level: int = 0,
                        white_level: Optional[int] = None,
                        bpp: int = 12,
                        cfa: str = "RGGB",
                        max_edge: int = 512,
                        quality: int = 90) -> bytes:
    """A preview JPEG actually DEVELOPED from the mosaic — half-res
    2×2-quad demosaic + WB (gains = 1/neutral, green-normalized) +
    1/2.2 gamma — so the structural-agreement score in
    pipeline/validate.py sees what a real camera embeds: a render of
    the same sensor data. Cameras embed exactly this (a developed
    small JPEG); the old fixed-gradient preview made the repo's own
    fixtures report a red `mismatch` on the validation harness's
    first run (VERDICT r4 item 5).

    (h, w, 3) input (linear-RGB DNG writers) renders directly.
    Non-Bayer CFA strings fall back to a box-downsampled gray render —
    the harness's correlation is luma-only, so the score still works.
    """
    from PIL import Image

    m = np.asarray(mosaic, np.float32)
    if white_level is None:
        white_level = (1 << bpp) - 1
    # Per-CFA-site black levels (tuple) collapse to their mean — the
    # preview only needs structural agreement, not level exactness.
    blk = float(np.mean(black_level))
    lin = np.clip((m - blk) / max(float(white_level) - blk, 1.0),
                  0.0, 1.0)
    gains = np.array([1.0 / max(float(v), 1e-6) for v in wb_neutral],
                     np.float32)
    gains /= max(gains[1], 1e-6)  # green-normalized, like the decoders
    if lin.ndim == 3 and lin.shape[-1] == 3:
        rgb = lin * gains
    else:
        h2, w2 = lin.shape[0] - lin.shape[0] % 2, \
            lin.shape[1] - lin.shape[1] % 2
        lin = lin[:h2, :w2]
        quads = (lin[0::2, 0::2], lin[0::2, 1::2],
                 lin[1::2, 0::2], lin[1::2, 1::2])
        pat = (cfa or "").upper()
        planes = {"R": [], "G": [], "B": []}
        if len(pat) == 4 and set(pat) <= set("RGB"):
            for ch, q in zip(pat, quads):
                planes[ch].append(q)
        if all(planes[c] for c in "RGB"):
            rgb = np.stack(
                [np.mean(planes[c], axis=0) * gains[i]
                 for i, c in enumerate("RGB")], axis=-1)
        else:  # X-Trans / exotic: gray render, structure intact
            gray = np.mean(quads, axis=0)
            rgb = np.stack([gray, gray, gray], axis=-1)
    srgbish = np.clip(rgb, 0.0, 1.0) ** np.float32(1.0 / 2.2)
    img = Image.fromarray(
        np.round(srgbish * 255.0).astype(np.uint8))
    if max(img.size) > max_edge:
        scale = max_edge / max(img.size)
        img = img.resize((max(1, int(img.size[0] * scale)),
                          max(1, int(img.size[1] * scale))),
                         Image.LANCZOS)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_synthetic_raw(
    path,
    mosaic: np.ndarray,
    bpp: int = 12,
    compression: str = "none",
    wb_neutral: Tuple[float, float, float] = (0.5, 1.0, 0.7),
    xyz_to_cam: Optional[np.ndarray] = None,
    black_level=0,
    white_level: Optional[int] = None,
    make: str = "SynthCam",
    model: str = "S1",
    preview_jpeg: Optional[bytes] = None,
    predictor: int = 1,
    tile_size: Optional[Tuple[int, int]] = None,
    float_samples: bool = False,
    wb_in_makernote: bool = False,
    cr2_slices: Optional[Tuple[int, int, int]] = None,
    cfa: str = "RGGB",
    orientation: int = 1,
    rows_per_strip: Optional[int] = None,
    nikon_encrypted_wb: Optional[dict] = None,
    srw_wb: bool = False,
    srw_black: Optional[Tuple[int, int, int, int]] = None,
    srw3_optflags: int = 0,
    uncorrelated_preview: bool = False,
) -> bytes:
    """Write a DNG/NEF-style CFA TIFF. Returns the bytes (also written
    to ``path`` unless None).

    tile_size=(tw, th) writes a tiled plane instead of one strip (DNG
    lossless layout). float_samples stores the mosaic as f32 in [0, 1]
    (DNG SampleFormat=3; values mosaic/(2^bpp-1)).

    The embedded preview defaults to a render OF THE MOSAIC
    (preview_from_mosaic) so the validation harness's structural score
    sees camera-like agreement; ``uncorrelated_preview=True`` embeds
    the old fixed gradient instead (the harness's mismatch tests)."""
    mosaic = np.asarray(mosaic, dtype=np.uint16)
    h, w = mosaic.shape
    if white_level is None:
        white_level = (1 << bpp) - 1
    if xyz_to_cam is None:
        xyz_to_cam = np.eye(3, dtype=np.float32)
    if preview_jpeg is None:
        if uncorrelated_preview:
            preview_jpeg = make_preview_jpeg()
        else:
            preview_jpeg = preview_from_mosaic(
                mosaic, wb_neutral=wb_neutral, black_level=black_level,
                white_level=white_level, bpp=bpp, cfa=cfa)

    makernote = None
    tiles: Optional[list] = None
    strip_lens: Optional[list] = None
    srw_offsets: Optional[list] = None
    sample_format = 1
    if rows_per_strip and compression != "ljpeg":
        raise ValueError(
            "rows_per_strip is only supported with compression='ljpeg'"
        )
    if float_samples:
        if compression != "none" or tile_size is not None:
            raise ValueError("float samples: uncompressed strips only")
        comp_tag = T.COMPRESSION_NONE
        sample_format = 3
        vals = mosaic.astype(np.float32) / np.float32((1 << bpp) - 1)
        sensor = vals.astype("<f4").tobytes()
        bpp = 32
    elif tile_size is not None:
        tw, th = tile_size
        comp_tag = (T.COMPRESSION_NONE if compression == "none"
                    else T.COMPRESSION_LJPEG)
        if compression not in ("none", "ljpeg"):
            raise ValueError("tiled: compression must be none or ljpeg")
        tiles = []
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                tile = np.zeros((th, tw), np.uint16)
                part = mosaic[y0 : y0 + th, x0 : x0 + tw]
                tile[: part.shape[0], : part.shape[1]] = part
                tiles.append(
                    pack_bits(tile, bpp, big_endian=False)
                    if compression == "none"
                    else encode_lossless(tile, bpp, predictor=predictor)
                )
        sensor = b""
    elif compression == "none":
        comp_tag = T.COMPRESSION_NONE
        # 'II' container: 16-bit samples are little-endian per TIFF.
        sensor = pack_bits(mosaic, bpp, big_endian=False)
    elif compression == "ljpeg4":
        # Four-component quadrant scan (DNG/NEF lossless layout).
        comp_tag = T.COMPRESSION_LJPEG
        if h % 2 or w % 2:
            raise ValueError("ljpeg4 needs even dimensions")
        comps = np.stack([
            mosaic[0::2, 0::2], mosaic[0::2, 1::2],
            mosaic[1::2, 0::2], mosaic[1::2, 1::2],
        ])
        sensor = encode_lossless(comps, bpp, predictor=predictor)
    elif compression == "ljpeg" and rows_per_strip:
        comp_tag = T.COMPRESSION_LJPEG
        if h % rows_per_strip:
            raise ValueError("rows_per_strip must divide height")
        tiles = None
        strips = [
            encode_lossless(mosaic[y : y + rows_per_strip], bpp,
                            predictor=predictor)
            for y in range(0, h, rows_per_strip)
        ]
        sensor = b"".join(strips)
        strip_lens = [len(x) for x in strips]
    elif compression == "ljpeg":
        comp_tag = T.COMPRESSION_LJPEG
        payload = mosaic
        if cr2_slices is not None:
            # Canon slice layout: consecutive vertical-slice pixel runs.
            n_s, wa, wb = cr2_slices
            if n_s * wa + wb != w:
                raise ValueError("cr2_slices must sum to width")
            runs = []
            x0 = 0
            for ws in [wa] * n_s + [wb]:
                runs.append(mosaic[:, x0 : x0 + ws].reshape(-1))
                x0 += ws
            payload = np.concatenate(runs).reshape(h, w)
        sensor = encode_lossless(payload, bpp, predictor=predictor)
    elif compression == "arw2":
        from raweditor_tpu_torch.raw.arw2 import encode_arw2

        comp_tag = T.COMPRESSION_ARW2
        sensor = encode_arw2(mosaic)
    elif compression == "kodak65000":
        from raweditor_tpu_torch.raw.kodak import encode_kodak65000

        comp_tag = T.COMPRESSION_KODAK65000
        sensor = encode_kodak65000(mosaic)
    elif compression == "srw1":
        from raweditor_tpu_torch.raw.samsung import encode_srw1

        comp_tag = T.COMPRESSION_SRW1
        sensor, srw_offsets = encode_srw1(mosaic)
    elif compression == "srw3":
        from raweditor_tpu_torch.raw.samsung3 import encode_srw3

        comp_tag = T.COMPRESSION_SRW3
        sensor = encode_srw3(mosaic, optflags=srw3_optflags, depth=bpp)
    elif compression == "radc":
        from raweditor_tpu_torch.raw.kodak_radc import encode_radc

        comp_tag = T.COMPRESSION_RADC
        sensor = encode_radc(mosaic)  # pass radc_representable mosaics
        white_level = 0x3FFF  # RADC output is tone-curve mapped
    elif compression == "pentax":
        from raweditor_tpu_torch.raw.pentax import encode_pentax

        comp_tag = T.COMPRESSION_PENTAX
        sensor, huff_spec = encode_pentax(mosaic, bpp)
        makernote = _build_pentax_makernote(
            huff_spec,
            wb_rggb=(_neutral_to_rggb(wb_neutral)
                     if wb_in_makernote else None),
        )
    elif compression == "nikon":
        from raweditor_tpu_torch.raw.nikon import encode_nikon

        comp_tag = T.COMPRESSION_NIKON
        sensor, meta_0x96 = encode_nikon(mosaic, bpp)
        makernote = _build_nikon_makernote(
            meta_0x96,
            wb_rbgg=_neutral_to_rbgg(wb_neutral) if wb_in_makernote else None,
            encrypted_wb=nikon_encrypted_wb,
        )
    else:
        raise ValueError(f"compression {compression!r}")
    if (wb_in_makernote or nikon_encrypted_wb) and makernote is None:
        makernote = _build_nikon_makernote(
            None,
            wb_rbgg=(_neutral_to_rbgg(wb_neutral) if wb_in_makernote
                     else None),
            encrypted_wb=nikon_encrypted_wb,
        )

    wtr = _TiffWriter()
    preview_idx = wtr.add_blob(preview_jpeg)
    if tiles is not None:
        tile_blob = b"".join(tiles)
        sensor_idx = wtr.add_blob(tile_blob)
    else:
        sensor_idx = wtr.add_blob(sensor)
    srw_table_idx = None
    if srw_offsets is not None:
        srw_table_idx = wtr.add_blob(
            b"".join(int(o).to_bytes(4, "little") for o in srw_offsets)
        )

    def rat(x, den=10000):
        return (int(round(x * den)), den)

    ifd0 = [
        (T.NEW_SUBFILE_TYPE, _TYPE_LONG, [1]),
        (T.ORIENTATION, _TYPE_SHORT, [orientation]),
        (T.MAKE, _TYPE_ASCII, make),
        (T.MODEL, _TYPE_ASCII, model),
        (T.SUB_IFDS, _TYPE_LONG, ("ifd", 1)),
        (T.JPEG_INTERCHANGE, _TYPE_LONG, ("blob", preview_idx)),
        (T.JPEG_INTERCHANGE_LEN, _TYPE_LONG, [len(preview_jpeg)]),
        (T.DNG_VERSION, _TYPE_BYTE, [1, 4, 0, 0]),
        (
            T.COLOR_MATRIX_1,
            _TYPE_SRATIONAL,
            [rat(float(v)) for v in np.asarray(xyz_to_cam).ravel()],
        ),
        (
            T.AS_SHOT_NEUTRAL,
            _TYPE_RATIONAL,
            [rat(float(v), 1000000) for v in wb_neutral],
        ),
    ]
    if wb_in_makernote or nikon_encrypted_wb:
        # Real NEFs carry WB in the MakerNote, not AsShotNeutral.
        ifd0 = [e for e in ifd0 if e[0] != T.AS_SHOT_NEUTRAL]
    if srw_wb:
        # Real SRWs carry WB as 0xA021 levels (R, G, G2, B).
        ifd0 = [e for e in ifd0 if e[0] != T.AS_SHOT_NEUTRAL]
        r, g, b = (1.0 / v for v in wb_neutral[:3])
        scale = 1024.0 / g
        ifd0.append((T.SRW_WB_RGGB, _TYPE_LONG,
                     [int(round(r * scale)), 1024, 1024,
                      int(round(b * scale))]))
    if srw_black is not None:
        ifd0.append((T.SRW_BLACK_RGGB, _TYPE_LONG,
                     [int(v) for v in srw_black]))
    ifds_extra = []
    if makernote is not None:
        # Exif IFD (index 2) holding the Nikon MakerNote with the
        # 0x0096 linearization blob the compressed-NEF decoder needs.
        ifd0.append((T.EXIF_IFD, _TYPE_LONG, ("ifd", 2)))
        ifds_extra.append([(T.MAKER_NOTE, _TYPE_UNDEF, makernote)])
    ifd0.sort(key=lambda e: e[0])

    sensor_ifd = [
        (T.NEW_SUBFILE_TYPE, _TYPE_LONG, [0]),
        (T.IMAGE_WIDTH, _TYPE_LONG, [w]),
        (T.IMAGE_LENGTH, _TYPE_LONG, [h]),
        (T.BITS_PER_SAMPLE, _TYPE_SHORT, [bpp]),
        (T.COMPRESSION, _TYPE_SHORT, [comp_tag]),
        (T.PHOTOMETRIC, _TYPE_SHORT, [T.PHOTOMETRIC_CFA]),
        (T.SAMPLES_PER_PIXEL, _TYPE_SHORT, [1]),
        (T.CFA_REPEAT_DIM, _TYPE_SHORT,
         [2, 2] if len(cfa) == 4 else [6, 6]),
        # 0=R 1=G 2=B (see ops/demosaic.py for the Bayer site table).
        (T.CFA_PATTERN, _TYPE_BYTE,
         [{"R": 0, "G": 1, "B": 2}[c] for c in cfa.upper()]),
        (T.WHITE_LEVEL, _TYPE_SHORT, [white_level]),
    ]
    if srw_black is None:
        # Real SRWs carry black as 0xA028, not a DNG BlackLevel tag.
        sensor_ifd.append(
            (T.BLACK_LEVEL, _TYPE_SHORT,
             list(black_level) if isinstance(black_level, (tuple, list))
             else [black_level]))
    if isinstance(black_level, (tuple, list)):
        sensor_ifd.append(
            (T.BLACK_LEVEL_REPEAT_DIM, _TYPE_SHORT, [2, 2])
        )
    if srw_table_idx is not None:
        sensor_ifd.append(
            (T.SRW_ROW_OFFSETS, _TYPE_LONG, ("blob", srw_table_idx))
        )
    if sample_format != 1:
        sensor_ifd.append((T.SAMPLE_FORMAT, _TYPE_SHORT, [sample_format]))
    if cr2_slices is not None:
        sensor_ifd.append((T.CR2_SLICE, _TYPE_SHORT, list(cr2_slices)))
    if tiles is not None:
        rel = []
        pos = 0
        for t in tiles:
            rel.append(pos)
            pos += len(t)
        tw, th = tile_size
        sensor_ifd += [
            (T.TILE_WIDTH, _TYPE_LONG, [tw]),
            (T.TILE_LENGTH, _TYPE_LONG, [th]),
            (T.TILE_OFFSETS, _TYPE_LONG, ("blob_multi", sensor_idx, rel)),
            (T.TILE_BYTE_COUNTS, _TYPE_LONG, [len(t) for t in tiles]),
        ]
    elif strip_lens is not None:
        rel = []
        pos = 0
        for ln in strip_lens:
            rel.append(pos)
            pos += ln
        sensor_ifd += [
            (T.STRIP_OFFSETS, _TYPE_LONG,
             ("blob_multi", sensor_idx, rel)),
            (T.ROWS_PER_STRIP, _TYPE_LONG, [rows_per_strip]),
            (T.STRIP_BYTE_COUNTS, _TYPE_LONG, strip_lens),
        ]
    else:
        sensor_ifd += [
            (T.STRIP_OFFSETS, _TYPE_LONG, ("blob", sensor_idx)),
            (T.ROWS_PER_STRIP, _TYPE_LONG, [h]),
            (T.STRIP_BYTE_COUNTS, _TYPE_LONG, [len(sensor)]),
        ]
    sensor_ifd.sort(key=lambda e: e[0])

    data = wtr.build([ifd0, sensor_ifd] + ifds_extra, chain=(0,))
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def _neutral_to_rbgg(wb_neutral) -> Tuple[float, float, float, float]:
    """AsShotNeutral (camera-space white) → the R,B,G,G2 multiplier
    order of MakerNote 0x000C."""
    r, g, b = (1.0 / v for v in wb_neutral[:3])
    return (r, b, g, g)


def _neutral_to_rggb(wb_neutral) -> Tuple[int, int, int, int]:
    """AsShotNeutral → Pentax 0x0201 u16 levels in R, G, G2, B order
    (scaled so green = 8192, a typical level base)."""
    r, g, b = (1.0 / v for v in wb_neutral[:3])
    scale = 8192.0 / g
    return (int(round(r * scale)), 8192, 8192, int(round(b * scale)))


def _build_pentax_makernote(huff_spec: bytes, wb_rggb=None) -> bytes:
    """Pentax-style MakerNote: "AOC\\0" signature + an embedded TIFF
    whose IFD carries 0x0220 (huffman spec) and optionally 0x0201
    (WhitePoint R,G,G2,B levels). Offsets relative to the embedded
    header (the Nikon-style convention; see find_pentax_makernote for
    the real-file caveat)."""
    inner = _TiffWriter()
    blob = inner.add_blob(huff_spec)
    entries = [(0x0220, _TYPE_UNDEF, ("blob", blob, 0, len(huff_spec)))]
    if wb_rggb is not None:
        entries.append((0x0201, _TYPE_SHORT, [int(v) for v in wb_rggb]))
    entries.sort(key=lambda e: e[0])
    return b"AOC\x00" + inner.build([entries], chain=(0,))


def write_synthetic_linear_dng(
    path,
    rgb: "np.ndarray",
    bpp: int = 16,
    compression: str = "none",
    wb_neutral: Tuple[float, float, float] = (0.5, 1.0, 0.7),
    black_level: int = 0,
    white_level: Optional[int] = None,
    uncorrelated_preview: bool = False,
) -> bytes:
    """Write a LinearRaw DNG: (H, W, 3) u16 RGB, photometric 34892."""
    rgb = np.asarray(rgb, dtype=np.uint16)
    h, w, _ = rgb.shape
    if white_level is None:
        white_level = (1 << bpp) - 1
    if compression == "none":
        comp_tag = T.COMPRESSION_NONE
        sensor = rgb.astype("<u2").tobytes()
    elif compression == "ljpeg":
        comp_tag = T.COMPRESSION_LJPEG
        comps = np.stack([rgb[..., 0], rgb[..., 1], rgb[..., 2]])
        sensor = encode_lossless(comps, bpp)
    else:
        raise ValueError(f"compression {compression!r}")

    wtr = _TiffWriter()
    preview = (make_preview_jpeg() if uncorrelated_preview
               else preview_from_mosaic(
                   rgb, wb_neutral=wb_neutral, black_level=black_level,
                   white_level=white_level, bpp=bpp))
    preview_idx = wtr.add_blob(preview)
    sensor_idx = wtr.add_blob(sensor)

    def rat(x, den=1000000):
        return (int(round(x * den)), den)

    ifd0 = [
        (T.NEW_SUBFILE_TYPE, _TYPE_LONG, [1]),
        (T.MAKE, _TYPE_ASCII, "SynthCam"),
        (T.MODEL, _TYPE_ASCII, "LinearS1"),
        (T.SUB_IFDS, _TYPE_LONG, ("ifd", 1)),
        (T.JPEG_INTERCHANGE, _TYPE_LONG, ("blob", preview_idx)),
        (T.JPEG_INTERCHANGE_LEN, _TYPE_LONG, [len(preview)]),
        (T.DNG_VERSION, _TYPE_BYTE, [1, 4, 0, 0]),
        (T.AS_SHOT_NEUTRAL, _TYPE_RATIONAL,
         [rat(float(v)) for v in wb_neutral]),
    ]
    ifd0.sort(key=lambda e: e[0])
    sensor_ifd = [
        (T.NEW_SUBFILE_TYPE, _TYPE_LONG, [0]),
        (T.IMAGE_WIDTH, _TYPE_LONG, [w]),
        (T.IMAGE_LENGTH, _TYPE_LONG, [h]),
        (T.BITS_PER_SAMPLE, _TYPE_SHORT, [bpp, bpp, bpp]),
        (T.COMPRESSION, _TYPE_SHORT, [comp_tag]),
        (T.PHOTOMETRIC, _TYPE_SHORT, [T.PHOTOMETRIC_LINEAR_RAW]),
        (T.STRIP_OFFSETS, _TYPE_LONG, ("blob", sensor_idx)),
        (T.SAMPLES_PER_PIXEL, _TYPE_SHORT, [3]),
        (T.ROWS_PER_STRIP, _TYPE_LONG, [h]),
        (T.STRIP_BYTE_COUNTS, _TYPE_LONG, [len(sensor)]),
        (T.BLACK_LEVEL, _TYPE_SHORT, [black_level]),
        (T.WHITE_LEVEL, _TYPE_SHORT, [white_level]),
    ]
    sensor_ifd.sort(key=lambda e: e[0])
    data = wtr.build([ifd0, sensor_ifd], chain=(0,))
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def _build_olympus_makernote(wb_rb: Tuple[float, float]) -> bytes:
    """Olympus MakerNote: "OLYMPUS\\0II\\x03\\0" signature, then an IFD
    (offsets relative to the MakerNote start) whose ImageProcessing
    sub-IFD (0x2040) carries WB_RBLevels 0x0100 = [R*256, B*256]."""
    sig = b"OLYMPUS\x00II\x03\x00"
    ifd0_off = len(sig)
    ifd0_size = 2 + 12 + 4
    sub_off = ifd0_off + ifd0_size
    r = max(1, min(0xFFFF, int(round(wb_rb[0] * 256))))
    b = max(1, min(0xFFFF, int(round(wb_rb[1] * 256))))
    ifd0 = struct.pack("<H", 1)
    ifd0 += struct.pack("<HHII", 0x2040, 4, 1, sub_off)
    ifd0 += struct.pack("<I", 0)
    sub = struct.pack("<H", 1)
    sub += struct.pack("<HHIHH", 0x0100, 3, 2, r, b)
    sub += struct.pack("<I", 0)
    return sig + ifd0 + sub


def write_synthetic_orf(
    path,
    mosaic: np.ndarray,
    compression: str = "olympus",
    wb_rb: Tuple[float, float] = (2.0, 1.5),
    black_level: int = 0,
    model: str = "E-M10",
    cfa: str = "RGGB",
    preview_jpeg: Optional[bytes] = None,
    uncorrelated_preview: bool = False,
) -> bytes:
    """Write an ORF-style container: TIFF structure with the 'RO'
    magic, sensor plane in IFD0 with compression marked 1 regardless
    (matching real ORFs), WB in the Olympus MakerNote.

    compression: "olympus" (entropy-coded) or "none16" (unpacked
    16-bit samples)."""
    mosaic = np.asarray(mosaic, dtype=np.uint16)
    h, w = mosaic.shape
    if preview_jpeg is None:
        if uncorrelated_preview:
            preview_jpeg = make_preview_jpeg()
        else:
            # wb_rb are gains at g=1 → neutral is their reciprocal.
            preview_jpeg = preview_from_mosaic(
                mosaic,
                wb_neutral=(1.0 / max(wb_rb[0], 1e-6), 1.0,
                            1.0 / max(wb_rb[1], 1e-6)),
                black_level=black_level, white_level=4095, cfa=cfa)
    if compression == "olympus":
        from raweditor_tpu_torch.native import get_rawkit

        rk = get_rawkit()
        if rk is not None and hasattr(rk, "encode_olympus"):
            sensor = rk.encode_olympus(np.ascontiguousarray(mosaic), w, h)
        else:
            from raweditor_tpu_torch.raw.olympus import encode_olympus

            sensor = encode_olympus(mosaic)
        if len(sensor) == h * w * 2:
            # The decoder dispatches unpacked-16 on an exact size match
            # (real ORFs distinguish the same way); nudge with padding.
            sensor += b"\0"
    elif compression == "none16":
        sensor = mosaic.astype("<u2").tobytes()
    else:
        raise ValueError(f"compression {compression!r}")

    wtr = _TiffWriter()
    preview_idx = wtr.add_blob(preview_jpeg)
    sensor_idx = wtr.add_blob(sensor)
    makernote = _build_olympus_makernote(wb_rb)
    ifd0 = [
        (T.IMAGE_WIDTH, _TYPE_LONG, [w]),
        (T.IMAGE_LENGTH, _TYPE_LONG, [h]),
        (T.BITS_PER_SAMPLE, _TYPE_SHORT, [12]),
        (T.COMPRESSION, _TYPE_SHORT, [T.COMPRESSION_NONE]),
        (T.PHOTOMETRIC, _TYPE_SHORT, [T.PHOTOMETRIC_CFA]),
        (T.MAKE, _TYPE_ASCII, "OLYMPUS IMAGING CORP."),
        (T.MODEL, _TYPE_ASCII, model),
        (T.SAMPLES_PER_PIXEL, _TYPE_SHORT, [1]),
        (T.CFA_REPEAT_DIM, _TYPE_SHORT, [2, 2]),
        (T.CFA_PATTERN, _TYPE_BYTE,
         [{"R": 0, "G": 1, "B": 2}[c] for c in cfa.upper()]),
        (T.BLACK_LEVEL, _TYPE_SHORT, [black_level]),
        (T.WHITE_LEVEL, _TYPE_SHORT, [4095]),
        (T.STRIP_OFFSETS, _TYPE_LONG, ("blob", sensor_idx)),
        (T.ROWS_PER_STRIP, _TYPE_LONG, [h]),
        (T.STRIP_BYTE_COUNTS, _TYPE_LONG, [len(sensor)]),
        (T.JPEG_INTERCHANGE, _TYPE_LONG, ("blob", preview_idx)),
        (T.JPEG_INTERCHANGE_LEN, _TYPE_LONG, [len(preview_jpeg)]),
        (T.EXIF_IFD, _TYPE_LONG, ("ifd", 1)),
    ]
    ifd0.sort(key=lambda e: e[0])
    exif_ifd = [(T.MAKER_NOTE, _TYPE_UNDEF, makernote)]
    data = wtr.build([ifd0, exif_ifd], chain=(0,), magic=T.MAGIC_ORF_RO)
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def write_synthetic_rw2(
    path,
    mosaic: np.ndarray,
    wb_rgb: Tuple[int, int, int] = (520, 256, 390),
    black_rgb: Tuple[int, int, int] = (0, 0, 0),
    cfa: str = "RGGB",
    model: str = "DMC-GX8",
    preview_jpeg: Optional[bytes] = None,
    uncorrelated_preview: bool = False,
) -> bytes:
    """Write an RW2-style container: TIFF structure with the 0x55
    magic, PanasonicRaw tag vocabulary, v4 payload at tag 0x0118
    running to end of file.

    The mosaic must be exactly representable by the fixed-sh encoder —
    quantize with :func:`raweditor_tpu_torch.raw.panasonic.rw2_representable`
    first."""
    mosaic = np.asarray(mosaic, dtype=np.uint16)
    h, w = mosaic.shape
    if preview_jpeg is None:
        if uncorrelated_preview:
            preview_jpeg = make_preview_jpeg()
        else:
            # wb_rgb are 256-scale gains → neutral = 256/gain.
            preview_jpeg = preview_from_mosaic(
                mosaic,
                wb_neutral=tuple(256.0 / max(float(v), 1e-6)
                                 for v in wb_rgb),
                black_level=float(np.mean(black_rgb)),
                white_level=4095, cfa=cfa)
    from raweditor_tpu_torch.native import get_rawkit

    rk = get_rawkit()
    if rk is not None and hasattr(rk, "encode_rw2"):
        sensor = rk.encode_rw2(np.ascontiguousarray(mosaic), w, h)
    else:
        from raweditor_tpu_torch.raw.panasonic import encode_rw2

        sensor = encode_rw2(mosaic)

    cfa_code = {"RGGB": 1, "GRBG": 2, "GBRG": 3, "BGGR": 4}[cfa.upper()]
    wtr = _TiffWriter()
    # The sensor payload must be the LAST blob: tag 0x0118 has no byte
    # count — the payload runs to end of file.
    _ = wtr.add_blob(preview_jpeg)
    sensor_idx = wtr.add_blob(sensor)
    ifd0 = [
        (T.PANA_SENSOR_WIDTH, _TYPE_SHORT, [w]),
        (T.PANA_SENSOR_HEIGHT, _TYPE_SHORT, [h]),
        (T.PANA_CFA_PATTERN, _TYPE_SHORT, [cfa_code]),
        (T.PANA_BPS, _TYPE_SHORT, [12]),
        (T.PANA_BLACK_R, _TYPE_SHORT, [black_rgb[0]]),
        (T.PANA_BLACK_G, _TYPE_SHORT, [black_rgb[1]]),
        (T.PANA_BLACK_B, _TYPE_SHORT, [black_rgb[2]]),
        (T.PANA_WB_RED, _TYPE_SHORT, [wb_rgb[0]]),
        (T.PANA_WB_GREEN, _TYPE_SHORT, [wb_rgb[1]]),
        (T.PANA_WB_BLUE, _TYPE_SHORT, [wb_rgb[2]]),
        (T.PANA_JPG_FROM_RAW, _TYPE_UNDEF, preview_jpeg),
        (T.MAKE, _TYPE_ASCII, "Panasonic"),
        (T.MODEL, _TYPE_ASCII, model),
        (T.PANA_RAW_OFFSET, _TYPE_LONG, ("blob", sensor_idx)),
    ]
    ifd0.sort(key=lambda e: e[0])
    data = wtr.build([ifd0], chain=(0,), magic=T.MAGIC_RW2)
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def _build_nikon_makernote(meta_0x96: Optional[bytes],
                           wb_rbgg=None,
                           encrypted_wb: Optional[dict] = None) -> bytes:
    """Nikon-format MakerNote: "Nikon\\0" + version, then an embedded
    TIFF whose IFD carries tag 0x0096 (linearization) and optionally
    0x000C (WB R/B levels), offsets relative to the embedded header as
    in real NEFs.

    ``encrypted_wb`` emits the modern-body layout instead of 0x000C:
    an encrypted 0x0097 ColorBalance block plus the 0x001D serial and
    0x00A7 shutter count that key it (see raw/nikon_crypt.py);
    keys: ver, wb_rgbg, serial (str), count (int), xlat0, xlat1."""
    inner = _TiffWriter()
    entries = []
    if meta_0x96 is not None:
        blob = inner.add_blob(meta_0x96)
        entries.append(
            (0x0096, _TYPE_UNDEF, ("blob", blob, 0, len(meta_0x96)))
        )
    if wb_rbgg is not None:
        entries.append(
            (0x000C, _TYPE_RATIONAL,
             [(int(round(v * 1000000)), 1000000) for v in wb_rbgg])
        )
    if encrypted_wb is not None:
        from raweditor_tpu_torch.raw import nikon_crypt

        block = nikon_crypt.encrypt_color_balance(
            encrypted_wb["ver"], encrypted_wb["wb_rgbg"],
            nikon_crypt.serial_key(encrypted_wb["serial"]),
            encrypted_wb["count"],
            encrypted_wb["xlat0"], encrypted_wb["xlat1"],
            big_endian=False,
        )
        bidx = inner.add_blob(block)
        entries.append((0x001D, _TYPE_ASCII, encrypted_wb["serial"]))
        entries.append((0x0097, _TYPE_UNDEF,
                        ("blob", bidx, 0, len(block))))
        entries.append((0x00A7, _TYPE_LONG, [encrypted_wb["count"]]))
    entries.sort(key=lambda e: e[0])
    tiff = inner.build([entries], chain=(0,))
    return b"Nikon\x00\x02\x10\x00\x00" + tiff
