"""RAW file decoding: container walk → sensor mosaic + color metadata.

The host-side replacement for the reference's rawloader call
(reference: raw/loader.rs:42-152). Dispatch prefers the native C++
extension when built; this module is the complete Python fallback.

Supported sensor encodings:
- uncompressed / bit-packed CFA strips (8/10/12/14/16-bit) and
  DNG float samples (SampleFormat=3)
- lossless JPEG (SOF3) strips and tiles — DNG lossless; CR2-style
  two-component scans and vertical slice layout (tag 0xC640)
- Nikon compressed NEF (34713) via the MakerNote linearization table
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Union

import numpy as np

from raweditor_tpu_torch.raw import tiff as T
from raweditor_tpu_torch.raw.ljpeg import decode_lossless
from raweditor_tpu_torch.raw.packing import unpack_bits
from raweditor_tpu_torch.raw.types import RawImage


class RawDecodeError(Exception):
    pass


class UnsupportedRawError(RawDecodeError):
    pass


def _read(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return f.read()


def _decode_lossless_any(strip: bytes):
    """SOF3 decode via the native extension when built, else Python."""
    from raweditor_tpu_torch.native import get_rawkit

    rk = get_rawkit()
    if rk is not None:
        try:
            raw, nc, h, w, prec = rk.decode_ljpeg(strip)
        except ValueError as e:
            raise RawDecodeError(str(e)) from e
        return np.frombuffer(raw, np.uint16).reshape(nc, h, w), prec
    return decode_lossless(strip)


def _mosaic_from_ljpeg(strips: List[bytes], width: int, height: int):
    """Reassemble SOF3 strips into the (H, W) mosaic. Two-component
    scans interleave columns (CR2 style); four-component scans map one
    component per Bayer quadrant at half width/height (common DNG/NEF
    lossless layout)."""
    rows = []
    for strip in strips:
        planes, _prec = _decode_lossless_any(strip)
        nc, h, w = planes.shape
        if nc == 1:
            part = planes[0]
            if part.shape[1] != width and part.size % width == 0:
                part = part.reshape(-1, width)
        elif nc == 2:
            part = np.empty((h, 2 * w), dtype=np.uint16)
            part[:, 0::2] = planes[0]
            part[:, 1::2] = planes[1]
        elif nc == 4:
            part = np.empty((2 * h, 2 * w), dtype=np.uint16)
            part[0::2, 0::2] = planes[0]
            part[0::2, 1::2] = planes[1]
            part[1::2, 0::2] = planes[2]
            part[1::2, 1::2] = planes[3]
        else:
            raise UnsupportedRawError(f"{nc}-component lossless scan")
        rows.append(part)
    mosaic = np.vstack(rows) if len(rows) > 1 else rows[0]
    if mosaic.shape != (height, width):
        raise RawDecodeError(
            f"decoded {mosaic.shape}, expected {(height, width)}"
        )
    return mosaic


def _float_mosaic(data: bytes, width: int, height: int, bpp: int,
                  endian: str) -> np.ndarray:
    """Floating-point sensor data (DNG SampleFormat=3): normalize
    0.0-1.0 floats to u16 exactly like the reference
    (reference: raw/loader.rs:67-72: *65535, clamped)."""
    if bpp == 32:
        dt = endian + "f4"
    elif bpp == 16:
        dt = endian + "f2"
    else:
        raise UnsupportedRawError(f"float sample with {bpp} bits")
    vals = np.frombuffer(data, dtype=dt, count=width * height).astype(
        np.float32
    )
    out = np.clip(vals * 65535.0, 0.0, 65535.0).astype(np.uint16)
    return out.reshape(height, width)


def _native_mosaic(attr: str, py_fn, native_args: tuple,
                   py_args: tuple, width: int, height: int) -> np.ndarray:
    """Native-preferred codec dispatch: call ``rawkit.<attr>`` when the
    extension provides it (its ValueError becomes the RawDecodeError
    quarantine), else the Python behavioral reference. Both produce an
    (H, W) u16 mosaic. One helper so the error contract can't drift
    between the ~8 codec call sites (code-review r3)."""
    from raweditor_tpu_torch.native import get_rawkit

    rk = get_rawkit()
    if rk is not None and hasattr(rk, attr):
        try:
            raw = getattr(rk, attr)(*native_args)
        except ValueError as e:
            raise RawDecodeError(str(e)) from e
        return np.frombuffer(raw, np.uint16).reshape(height, width)
    return py_fn(*py_args)


def _mosaic_from_tiles(tf: T.TiffFile, ifd: T.IFD, width: int, height: int,
                       bpp: int, comp: int) -> np.ndarray:
    """Reassemble a tiled CFA plane (DNG lossless is typically tiled).

    Tiles are laid out row-major, each padded to the full tile size;
    edge tiles are cropped after decode (TIFF 6.0 / DNG spec)."""
    tw = ifd.get_scalar(T.TILE_WIDTH)
    th = ifd.get_scalar(T.TILE_LENGTH)
    # Type-check, not just truthiness: a corrupt tag can carry a str
    # (TypeError escape) or a negative SLONG (silent all-zero mosaic).
    if (not isinstance(tw, int) or not isinstance(th, int)
            or tw <= 0 or th <= 0):
        raise RawDecodeError("tiled IFD missing/corrupt tile dimensions")
    tiles = tf.tile_data(ifd)
    tiles_across = (width + tw - 1) // tw
    tiles_down = (height + th - 1) // th
    if len(tiles) < tiles_across * tiles_down:
        raise RawDecodeError(
            f"expected {tiles_across * tiles_down} tiles, got {len(tiles)}"
        )
    out = np.zeros((height, width), np.uint16)
    for ty in range(tiles_down):
        for tx in range(tiles_across):
            data = tiles[ty * tiles_across + tx]
            if comp == T.COMPRESSION_NONE:
                tile = unpack_bits(data, tw, th, bpp,
                                   big_endian=(tf.endian == ">"))
            elif comp == T.COMPRESSION_LJPEG:
                planes, _prec = _decode_lossless_any(data)
                nc, h0, w0 = planes.shape
                if nc == 1:
                    tile = planes[0]
                elif nc == 2:
                    tile = np.empty((h0, 2 * w0), np.uint16)
                    tile[:, 0::2] = planes[0]
                    tile[:, 1::2] = planes[1]
                else:
                    raise UnsupportedRawError(f"{nc}-component tile")
                if tile.shape != (th, tw):
                    raise RawDecodeError(
                        f"tile decoded {tile.shape}, expected {(th, tw)}"
                    )
            else:
                raise UnsupportedRawError(f"tiled compression {comp}")
            y0, x0 = ty * th, tx * tw
            ys = min(th, height - y0)
            xs = min(tw, width - x0)
            out[y0 : y0 + ys, x0 : x0 + xs] = tile[:ys, :xs]
    return out


def _cr2_deslice(mosaic: np.ndarray, slices, width: int,
                 height: int) -> np.ndarray:
    """Canon CR2 vertical slicing (tag 0xC640 = [n, w_a, w_b]): the
    lossless scan stores n slices of width w_a then one of width w_b as
    consecutive pixel runs; rebuild the true (H, W) plane."""
    if not isinstance(slices, tuple) or len(slices) != 3:
        raise RawDecodeError(f"bad CR2 slice tag: {slices!r}")
    n, wa, wb = (int(v) for v in slices)
    if n * wa + wb != width:
        raise RawDecodeError(
            f"CR2 slices {n}x{wa}+{wb} != width {width}"
        )
    flat = mosaic.reshape(-1)
    out = np.empty((height, width), np.uint16)
    pos = 0
    x0 = 0
    for ws in [wa] * n + [wb]:
        count = height * ws
        out[:, x0 : x0 + ws] = flat[pos : pos + count].reshape(height, ws)
        pos += count
        x0 += ws
    return out


def find_nikon_makernote(tf: T.TiffFile) -> Optional[T.TiffFile]:
    """Locate and parse the Nikon MakerNote's embedded TIFF (tag
    offsets are relative to its own header, 10 bytes in)."""
    for ifd in tf.all_ifds():
        mn = ifd.get(T.MAKER_NOTE)
        if isinstance(mn, (bytes, bytearray)) and mn[:6] == b"Nikon\x00":
            try:
                return T.TiffFile(bytes(mn[10:]))
            except ValueError:
                return None
    return None


def _decode_nikon_strips(tf: T.TiffFile, strips: List[bytes], width: int,
                         height: int, bpp: int) -> np.ndarray:
    """Nikon compression 34713: linearization metadata from MakerNote
    tag 0x0096 + the hard-coded Huffman trees (see raw/nikon.py)."""
    from raweditor_tpu_torch.raw import nikon

    mn = find_nikon_makernote(tf)
    if mn is None:
        raise UnsupportedRawError("compressed NEF without Nikon MakerNote")
    meta = None
    for ifd in mn.all_ifds():
        meta = ifd.get(0x0096)
        if meta is not None:
            break
    if not isinstance(meta, (bytes, bytearray)):
        raise UnsupportedRawError(
            "compressed NEF without 0x0096 linearization table"
        )
    try:
        info = nikon.parse_linearization(
            bytes(meta), bpp, big_endian=(tf.endian == ">")
        )
    except Exception as e:
        raise RawDecodeError(f"bad 0x0096 linearization table: {e}") from e
    strip = b"".join(strips)
    curve_white = float(info.curve[info.max_value - 1])

    mosaic = _native_mosaic(
        "decode_nikon", nikon.decode_nikon,
        (strip, width, height, bpp, info.tree_index, int(info.split),
         info.vpred.astype(np.int32).tobytes(),
         info.curve.astype(np.uint16).tobytes()),
        (strip, width, height, bpp, info), width, height)
    return mosaic, curve_white


def _decode_orf_strips(tf: T.TiffFile, data: bytes, width: int,
                       height: int, bpp: int) -> np.ndarray:
    """Olympus ORF sensor payload. The container marks compression 1
    regardless; the published decoders distinguish 16-bit unpacked from
    the Olympus entropy coding by payload size (rawloader does the
    same through its camera table — reference: raw/loader.rs:50-54)."""
    if len(data) == width * height * 2:
        return unpack_bits(data, width, height, 16,
                           big_endian=(tf.endian == ">"))

    from raweditor_tpu_torch.raw.olympus import decode_olympus

    return _native_mosaic("decode_olympus", decode_olympus,
                          (data, width, height), (data, width, height),
                          width, height)


def find_pentax_makernote(tf: T.TiffFile) -> Optional[T.TiffFile]:
    """Pentax MakerNote ("AOC\\0" header): our synth layout embeds a
    full TIFF after the 4-byte signature (offsets relative to it, the
    Nikon-style convention). Real AOC notes omit the TIFF header and
    use EXIF-absolute offsets — handled when a corpus exists
    (docs/formats.md)."""
    for ifd in tf.all_ifds():
        mn = ifd.get(T.MAKER_NOTE)
        if isinstance(mn, (bytes, bytearray)) and bytes(mn[:4]) == (
            b"AOC\x00"
        ):
            try:
                return T.TiffFile(bytes(mn[4:]))
            except ValueError:
                return None
    return None


def _decode_pentax_strips(tf: T.TiffFile, data: bytes, width: int,
                          height: int, bpp: int) -> np.ndarray:
    """Pentax compression 65535: Huffman spec from MakerNote 0x0220
    (see raw/pentax.py)."""
    mn = find_pentax_makernote(tf)
    spec = None
    if mn is not None:
        for ifd in mn.all_ifds():
            spec = ifd.get(0x0220)
            if spec is not None:
                break
    if not isinstance(spec, (bytes, bytearray)):
        raise UnsupportedRawError(
            "compressed PEF without 0x0220 huffman table"
        )
    from raweditor_tpu_torch.raw.pentax import decode_pentax

    return _native_mosaic(
        "decode_pentax",
        lambda *a: decode_pentax(*a, big_endian_spec=(tf.endian == ">")),
        (data, width, height, bpp, bytes(spec),
         1 if tf.endian == ">" else 0),
        (data, width, height, bpp, bytes(spec)), width, height)


def _wb_from_pentax_makernote(tf: T.TiffFile):
    """Pentax MakerNote 0x0201 (WhitePoint): four u16 levels in file
    order R, G, G2, B (the published cam_mul[c ^ (c >> 1)] swizzle),
    green-normalized."""
    mn = find_pentax_makernote(tf)
    if mn is None:
        return None
    for ifd in mn.all_ifds():
        v = ifd.get(0x0201)
        if isinstance(v, tuple) and len(v) >= 4:
            r, g, g2, b = (float(x) for x in v[:4])
            if g <= 0 or r <= 0 or b <= 0:
                return None
            return RawImage.normalize_wb([r, g, b, g2 if g2 > 0 else g])
    return None


def _wb_from_olympus_makernote(tf: T.TiffFile):
    """Olympus MakerNote WB: ImageProcessing sub-IFD (0x2040) tag
    0x0100 WB_RBLevels = [R*256, B*256] with green at 256 (published
    exiftool/dcraw semantics). Offsets inside the MakerNote are
    relative to its own start."""
    for ifd in tf.all_ifds():
        mn = ifd.get(T.MAKER_NOTE)
        if isinstance(mn, (bytes, bytearray)) and bytes(mn[:8]) == (
            b"OLYMPUS\x00"
        ):
            return _parse_olympus_wb(bytes(mn))
    return None


def _parse_olympus_wb(mn: bytes):
    import struct as _struct

    if len(mn) < 14 or mn[8:10] not in (b"II", b"MM"):
        return None
    e = "<" if mn[8:10] == b"II" else ">"

    def u16(off):
        return _struct.unpack_from(e + "H", mn, off)[0]

    def u32(off):
        return _struct.unpack_from(e + "I", mn, off)[0]

    def walk_ifd(off, want_tag):
        if off + 2 > len(mn):
            return None
        n = u16(off)
        for k in range(n):
            pos = off + 2 + 12 * k
            if pos + 12 > len(mn):
                return None
            tag, typ, count = (u16(pos), u16(pos + 2), u32(pos + 4))
            if tag == want_tag:
                return pos, typ, count
        return None

    try:
        hit = walk_ifd(12, 0x2040)  # ImageProcessing
        if hit is None:
            return None
        pos, typ, _count = hit
        sub_off = u32(pos + 8)
        hit = walk_ifd(sub_off, 0x0100)  # WB_RBLevels
        if hit is None:
            return None
        pos, typ, count = hit
        if typ != 3 or count < 2:
            return None
        voff = pos + 8 if count * 2 <= 4 else u32(pos + 8)
        r, b = u16(voff), u16(voff + 2)
    except _struct.error:
        return None
    if r == 0 or b == 0:
        return None
    return RawImage.normalize_wb([r / 256.0, 1.0, b / 256.0, 1.0])


def _decode_srw1_container(tf: T.TiffFile, ifd: T.IFD, data: bytes,
                           width: int, height: int) -> np.ndarray:
    """Samsung SRW v1 (compression 32770): tag 0xA010 names the file
    offset of a per-row u32 offset table; the row offsets are relative
    to the sensor strip start (the published layout — see
    raw/samsung.py for the codec)."""
    table_off = None
    for i in tf.all_ifds():
        v = i.get_scalar(T.SRW_ROW_OFFSETS)
        if isinstance(v, int):
            table_off = v
            break
    if table_off is None:
        raise UnsupportedRawError("SRW v1 without a row offset table")
    if table_off + 4 * height > len(data):
        raise RawDecodeError("SRW row offset table truncated")
    offsets = np.frombuffer(data, "<u4", count=height,
                            offset=table_off).tolist()
    sensor = b"".join(tf.strip_data(ifd))
    from raweditor_tpu_torch.raw.samsung import decode_srw1

    return _native_mosaic(
        "decode_srw1", decode_srw1,
        (sensor, np.asarray(offsets, "<u4").tobytes(), width, height),
        (sensor, offsets, width, height), width, height)


def _decode_rw2_container(tf: T.TiffFile, source_path: str) -> RawImage:
    """Panasonic RW2: sensor dims and color metadata come from the
    PanasonicRaw tag vocabulary; the v4 payload starts at tag 0x0118
    and runs to end of file."""
    if not tf.ifds:
        raise RawDecodeError("RW2 without IFD0")
    ifd = tf.ifds[0]
    width = ifd.get_scalar(T.PANA_SENSOR_WIDTH)
    height = ifd.get_scalar(T.PANA_SENSOR_HEIGHT)
    bpp = ifd.get_scalar(T.PANA_BPS, 12)
    if (not isinstance(width, int) or not isinstance(height, int)
            or width <= 0 or height <= 0):
        raise RawDecodeError("RW2 missing sensor dimensions")
    if bpp != 12:
        raise UnsupportedRawError(f"RW2 with {bpp}-bit samples")
    if width * height > 16 * max(len(tf.data), 1):
        raise RawDecodeError(
            f"implausible dimensions {width}x{height} for "
            f"{len(tf.data)}-byte file"
        )
    off = ifd.get_scalar(T.PANA_RAW_OFFSET)
    if isinstance(off, int) and 0 < off < len(tf.data):
        payload = tf.data[off:]
    else:
        try:
            payload = b"".join(tf.strip_data(ifd))
        except ValueError as e:
            raise RawDecodeError(f"RW2 without sensor payload: {e}") from e

    try:
        from raweditor_tpu_torch.raw.panasonic import decode_rw2

        mosaic = _native_mosaic("decode_rw2", decode_rw2,
                                (payload, width, height),
                                (payload, width, height), width, height)
    except RawDecodeError:
        raise
    except (ValueError, TypeError, IndexError, struct.error) as e:
        raise RawDecodeError(f"corrupt sensor data: {e}") from e

    try:
        wb = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
        wb_default = True
        wr = ifd.get_scalar(T.PANA_WB_RED)
        wg = ifd.get_scalar(T.PANA_WB_GREEN)
        wbl = ifd.get_scalar(T.PANA_WB_BLUE)
        if all(isinstance(v, int) and v > 0 for v in (wr, wg, wbl)):
            wb = RawImage.normalize_wb(
                [float(wr), float(wg), float(wbl), float(wg)]
            )
            wb_default = False
        blacks = [
            ifd.get_scalar(t, 0)
            for t in (T.PANA_BLACK_R, T.PANA_BLACK_G, T.PANA_BLACK_B)
        ]
        black = float(np.mean([float(b) for b in blacks]))
        cfa_code = ifd.get_scalar(T.PANA_CFA_PATTERN, 1)
        cfa = {1: "RGGB", 2: "GRBG", 3: "GBRG", 4: "BGGR"}.get(
            cfa_code if isinstance(cfa_code, int) else 1, "RGGB"
        )
        if wb_default:
            _warn_neutral_wb(tf, source_path)
        return RawImage(
            mosaic=mosaic,
            wb_multipliers=wb,
            xyz_to_cam=np.eye(3, dtype=np.float32),
            black_level=black,
            white_level=4095.0,
            cfa_pattern=cfa,
            camera_make=_find_tag(tf, T.MAKE) or "Panasonic",
            camera_model=_find_tag(tf, T.MODEL) or "",
            source_path=source_path,
            wb_is_default=wb_default,
        )
    except RawDecodeError:
        raise
    except (ValueError, TypeError, IndexError) as e:
        raise RawDecodeError(f"corrupt color metadata: {e}") from e


def _find_tag(tf: T.TiffFile, tag: int):
    for ifd in tf.all_ifds():
        v = ifd.get(tag)
        if v is not None:
            return v
    return None


def _wb_from_nikon_makernote(tf: T.TiffFile):
    """Nikon MakerNote WB: tag 0x000C (WB R/B levels) when present,
    else the encrypted 0x0097 ColorBalance block keyed by serial
    (0x001D) + shutter count (0x00A7) — decrypted only when the xlat
    substitution tables have been provided (see raw/nikon_crypt.py).
    Otherwise None and the caller falls back to neutral, like the
    reference does when rawloader has no coefficients
    (reference: raw/loader.rs:93-97)."""
    mn = find_nikon_makernote(tf)
    if mn is None:
        return None
    for ifd in mn.all_ifds():
        v = ifd.get(0x000C)
        if isinstance(v, tuple) and len(v) >= 3:
            r, b, g = float(v[0]), float(v[1]), float(v[2])
            g2 = float(v[3]) if len(v) > 3 else g
            if g <= 0:
                return None
            return RawImage.normalize_wb([r, g, b, g2])
    return _wb_from_nikon_0x97(mn)


def _wb_from_nikon_0x97(mn: T.TiffFile):
    from raweditor_tpu_torch.raw import nikon_crypt

    block = serial_text = count = None
    for ifd in mn.all_ifds():
        if block is None:
            b = ifd.get(0x0097)
            if isinstance(b, (bytes, bytearray)):
                block = bytes(b)
        if serial_text is None:
            s = ifd.get(0x001D)
            if isinstance(s, str):
                serial_text = s
            elif isinstance(s, (bytes, bytearray)):
                serial_text = bytes(s).split(b"\0")[0].decode(
                    "ascii", "replace")
        if count is None:
            c = ifd.get_scalar(0x00A7)
            if isinstance(c, int):
                count = c
    if block is None or serial_text is None or count is None:
        return None
    return nikon_crypt.wb_from_color_balance(
        block, nikon_crypt.serial_key(serial_text), count,
        big_endian=(mn.endian == ">"),
    )


def _warn_neutral_wb(tf: T.TiffFile, source_path: str) -> None:
    """One loud WARNING when WB falls back to neutral. Distinguishes
    the actionable case — an encrypted Nikon 0x0097 ColorBalance
    present but no xlat tables injected (reference:
    raw/loader.rs:78-110 gets these via rawloader's built-in tables)
    — from plain missing metadata, and names the fix."""
    from raweditor_tpu_torch.utils.logging import get_logger

    log = get_logger("raweditor_tpu_torch.raw")
    name = source_path or "<bytes>"
    mn = find_nikon_makernote(tf)
    has_97 = False
    if mn is not None:
        for ifd in mn.all_ifds():
            if isinstance(ifd.get(0x0097), (bytes, bytearray)):
                has_97 = True
                break
    if has_97:
        from raweditor_tpu_torch.raw import nikon_crypt

        if nikon_crypt.load_xlat_tables() is None:
            log.warning(
                "%s: white balance is encrypted (Nikon MakerNote "
                "0x0097) and no xlat tables are available - using "
                "neutral WB. Provide the 512-byte table file via "
                "--xlat FILE / RAWEDITOR_NIKON_XLAT=FILE to get the "
                "camera's WB (see docs/formats.md).", name)
        else:
            log.warning(
                "%s: Nikon 0x0097 ColorBalance present but WB "
                "extraction failed - using neutral WB.", name)
    else:
        log.info("%s: no parsable white-balance metadata - using "
                 "neutral WB.", name)


def _wb_from_neutral(neutral):
    """DNG AsShotNeutral (camera-space white) → multipliers, then
    green-normalized with the reference's fallback rules
    (reference: raw/loader.rs:78-110). Returns None for a degenerate
    tag (short count, non-positive component) so the caller's
    MakerNote fallbacks / neutral-WB warning / ``wb_is_default`` flag
    all still run (code-review r3: returning neutral here silently
    masked every fallback)."""
    vals = [float(v) for v in (neutral if isinstance(neutral, tuple) else (neutral,))]
    if len(vals) < 3 or any(v <= 0 for v in vals[:3]):
        return None
    coeffs = [1.0 / v for v in vals[:3]]
    return RawImage.normalize_wb(coeffs)


def decode_raw(path_or_bytes: Union[str, os.PathLike, bytes],
               source_path: str = "") -> RawImage:
    """Decode a RAW file into a RawImage."""
    data = _read(path_or_bytes)
    if not isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        source_path = str(path_or_bytes)

    from raweditor_tpu_torch.raw import raf as _raf

    if _raf.is_raf(data):
        return _decode_raf(data, source_path)
    from raweditor_tpu_torch.raw import ciff as _ciff

    if _ciff.is_ciff(data):
        # Canon CRW: CIFF heap + the original Canon codec.
        try:
            return _ciff.decode_crw(data, source_path)
        except (ValueError, TypeError, IndexError, struct.error) as e:
            raise RawDecodeError(f"corrupt CRW: {e}") from e
    if len(data) >= 12 and data[4:8] == b"ftyp":
        # ISO-BMFF container (Canon CR3 'crx ', HEIF, ...). Files with
        # a CRAW track decode through the lossless CRX codec
        # (raw/crx.py — beyond the reference, whose rawloader backend
        # has no CR3 support). Containers without one still get the
        # box-tree metadata and THMB/PRVW previews (raw/bmff.py).
        from raweditor_tpu_torch.raw import bmff as _bmff
        from raweditor_tpu_torch.raw import crx as _crx

        try:
            img = _crx.decode_cr3(data, source_path)
        except (ValueError, TypeError, IndexError, struct.error) as e:
            raise RawDecodeError(f"corrupt CR3: {e}") from e
        if img is not None:
            return img

        brand = data[8:12].decode("ascii", "replace").strip()
        detail = ""
        try:
            d = _bmff.describe(data)
            parts = [str(d[k]) for k in ("make", "model") if k in d]
            if d.get("codec"):
                parts.append(f"codec {d['codec']}")
            if parts:
                detail = " [" + ", ".join(parts) + "]"
        except Exception:  # noqa: BLE001 - best-effort description only
            pass
        raise UnsupportedRawError(
            f"ISO-BMFF container (brand {brand!r}){detail}: sensor "
            "decode not supported (metadata/previews/tiers still work)"
        )
    try:
        tf = T.TiffFile(data)
    except ValueError as e:
        raise RawDecodeError(str(e)) from e

    if tf.variant == "rw2":
        return _decode_rw2_container(tf, source_path)

    linear_ifd = tf.find_linear_ifd()
    ifd = tf.find_cfa_ifd()
    if linear_ifd is not None:
        try:
            return _decode_linear(tf, linear_ifd, source_path)
        except RawDecodeError:
            # Hybrid DNGs can carry both an enhanced LinearRaw plane
            # (possibly tiled/compressed beyond our support) and the
            # original CFA plane — fall back rather than hard-fail.
            if ifd is None:
                raise
    if ifd is None:
        raise UnsupportedRawError("no CFA sensor IFD found")

    width = ifd.get_scalar(T.IMAGE_WIDTH)
    height = ifd.get_scalar(T.IMAGE_LENGTH)
    bpp = ifd.get_scalar(T.BITS_PER_SAMPLE, 16)
    comp = ifd.get_scalar(T.COMPRESSION, T.COMPRESSION_NONE)
    if (not isinstance(width, int) or not isinstance(height, int)
            or width <= 0 or height <= 0):
        raise RawDecodeError("sensor IFD missing dimensions")
    if not isinstance(bpp, int) or not 1 <= bpp <= 32:
        # A corrupt BitsPerSample otherwise reaches 1 << bpp (found by
        # the soak fuzz: OverflowError instead of the quarantine).
        raise RawDecodeError(f"implausible BitsPerSample {bpp!r}")
    # Plausibility: even heavily compressed sensor data needs >1 bit per
    # 8 pixels; corrupt dimension tags otherwise send the decoders into
    # multi-gigapixel allocations/loops.
    if width * height > 16 * max(len(data), 1):
        raise RawDecodeError(
            f"implausible dimensions {width}x{height} for "
            f"{len(data)}-byte file"
        )

    curve_white = None  # white point recovered from a Nikon curve
    sample_format = ifd.get_scalar(T.SAMPLE_FORMAT, 1)
    if sample_format not in (1, 3):
        raise UnsupportedRawError(
            f"SampleFormat {sample_format!r} not supported")
    # unpack_bits is an integer <=16-bit unpack; float tiles and wide
    # integer samples would decode to plausible-shaped garbage through
    # it instead of quarantining (code-review r3).
    if sample_format == 3 and tf.is_tiled(ifd):
        raise UnsupportedRawError("tiled float sensor data not supported")
    # No integer sensor path carries >16-bit samples (LJPEG precision
    # caps at 16 too) — a mutated tag otherwise sets white_level to
    # 2^bpp-1 and develops a silent near-black image (code-review r3).
    if sample_format == 1 and bpp > 16:
        raise UnsupportedRawError(
            f"integer BitsPerSample {bpp} > 16 not supported")
    try:
        if tf.is_tiled(ifd):
            mosaic = _mosaic_from_tiles(tf, ifd, width, height, bpp, comp)
        elif tf.variant == "orf":
            # ORF marks compression 1 even for entropy-coded payloads;
            # pick the codec by payload size like the published
            # decoders do (the container has no reliable tag).
            mosaic = _decode_orf_strips(
                tf, b"".join(tf.strip_data(ifd)), width, height, bpp
            )
        elif comp == T.COMPRESSION_NONE:
            if sample_format == 3:
                mosaic = _float_mosaic(b"".join(tf.strip_data(ifd)), width,
                                       height, bpp, tf.endian)
            else:
                mosaic = unpack_bits(b"".join(tf.strip_data(ifd)), width,
                                     height, bpp,
                                     big_endian=(tf.endian == ">"))
        elif comp == T.COMPRESSION_LJPEG:
            mosaic = _mosaic_from_ljpeg(tf.strip_data(ifd), width, height)
            slices = ifd.get(T.CR2_SLICE)
            if slices is not None:
                mosaic = _cr2_deslice(mosaic, slices, width, height)
        elif comp == T.COMPRESSION_NIKON:
            mosaic, curve_white = _decode_nikon_strips(
                tf, tf.strip_data(ifd), width, height, bpp
            )
        elif comp == T.COMPRESSION_ARW2:
            from raweditor_tpu_torch.raw.arw2 import decode_arw2

            mosaic = decode_arw2(b"".join(tf.strip_data(ifd)), width,
                                 height)
        elif comp == T.COMPRESSION_PENTAX:
            mosaic = _decode_pentax_strips(
                tf, b"".join(tf.strip_data(ifd)), width, height, bpp
            )
        elif comp == T.COMPRESSION_SRW1:
            mosaic = _decode_srw1_container(tf, ifd, data, width, height)
        elif comp == T.COMPRESSION_SRW3:
            payload = b"".join(tf.strip_data(ifd))
            from raweditor_tpu_torch.raw.samsung3 import (decode_srw3,
                                                    parse_header)

            _opt, depth3, _init = parse_header(payload)
            if bpp in (12, 14) and depth3 != bpp:
                raise RawDecodeError(
                    "SRW v3 header depth disagrees with BitsPerSample")
            mosaic = _native_mosaic("decode_srw3", decode_srw3,
                                    (payload, width, height),
                                    (payload, width, height),
                                    width, height)
        elif comp == T.COMPRESSION_RADC:
            from raweditor_tpu_torch.raw.kodak_radc import decode_radc

            payload = b"".join(tf.strip_data(ifd))
            mosaic = _native_mosaic("decode_radc", decode_radc,
                                    (payload, width, height),
                                    (payload, width, height),
                                    width, height)
            # RADC output is tone-curve mapped; its white point is the
            # curve top regardless of the sensor depth tag.
            curve_white = 0x3FFF
        elif comp == T.COMPRESSION_KODAK65000:
            from raweditor_tpu_torch.raw.kodak import decode_kodak65000

            data_k = b"".join(tf.strip_data(ifd))
            mosaic = _native_mosaic("decode_kodak65000",
                                    decode_kodak65000,
                                    (data_k, width, height),
                                    (data_k, width, height),
                                    width, height)
        else:
            raise UnsupportedRawError(f"compression {comp}")
    except RawDecodeError:
        raise
    except (ValueError, TypeError, IndexError, struct.error) as e:
        # Corrupt sensor payloads must surface as RawDecodeError — the
        # batch quarantine path depends on this contract.
        raise RawDecodeError(f"corrupt sensor data: {e}") from e

    # --- color metadata (same error contract as the sensor block) -------
    try:
        return _finish_raw_image(tf, mosaic, curve_white, bpp, ifd,
                                 source_path)
    except RawDecodeError:
        raise
    except (ValueError, TypeError, IndexError) as e:
        raise RawDecodeError(f"corrupt color metadata: {e}") from e


def _finish_raw_image(tf, mosaic, curve_white, bpp, ifd, source_path):
    neutral = _find_tag(tf, T.AS_SHOT_NEUTRAL)
    wb = _wb_from_neutral(neutral) if neutral is not None else None
    if wb is None:
        wb = _wb_from_nikon_makernote(tf)
        if wb is None:
            wb = _wb_from_olympus_makernote(tf)
        if wb is None:
            wb = _wb_from_pentax_makernote(tf)
        if wb is None:
            # Samsung SRW levels (R, G, G2, B; rawloader srw parity).
            levels = _find_tag(tf, T.SRW_WB_RGGB)
            if (isinstance(levels, tuple) and len(levels) >= 4
                    and all(isinstance(v, int) and v > 0
                            for v in levels[:4])):
                r, g, g2, b = (float(v) for v in levels[:4])
                wb = RawImage.normalize_wb([r, g, b, g2])
    wb_default = wb is None
    if wb is None:
        # Neutral fallback (reference: raw/loader.rs:93-97). For
        # modern NEFs this is the encrypted-0x0097-without-xlat path:
        # warn loudly so users know WB is a placeholder and how to
        # inject the tables (raw/nikon_crypt.py, `--xlat`).
        wb = np.array([1.0, 1.0, 1.0, 1.0], dtype=np.float32)
        _warn_neutral_wb(tf, source_path)

    cm = _find_tag(tf, T.COLOR_MATRIX_1)
    if cm is not None and isinstance(cm, tuple) and len(cm) >= 9:
        xyz_to_cam = np.array(cm[:9], dtype=np.float32).reshape(3, 3)
        # Degenerate metadata → identity, like the reference
        # (reference: raw/loader.rs:115-134).
        if xyz_to_cam[0, 0] == 0.0 and xyz_to_cam[1, 1] == 0.0:
            xyz_to_cam = np.eye(3, dtype=np.float32)
    else:
        xyz_to_cam = np.eye(3, dtype=np.float32)

    black = _find_tag(tf, T.BLACK_LEVEL)
    black_per_site = None
    if isinstance(black, tuple) and not all(
            isinstance(v, (int, float)) for v in black):
        black = None  # mutated tag type (e.g. ASCII) — quarantine-safe
    if isinstance(black, tuple):
        repeat = _find_tag(tf, T.BLACK_LEVEL_REPEAT_DIM)
        if (len(black) == 4 and isinstance(repeat, tuple)
                and len(repeat) >= 2
                and all(isinstance(v, (int, float)) for v in repeat[:2])
                and tuple(int(v) for v in repeat[:2]) == (2, 2)):
            # Exactly a 2x2 per-CFA-site grid.
            black_per_site = np.array(
                [float(v) for v in black], np.float32
            ).reshape(2, 2)
            black = float(np.mean(black_per_site))
        elif black:
            # Other repeat shapes (per-row/column, per-sample): use the
            # mean as the scalar, no per-site fold.
            black = float(np.mean([float(v) for v in black]))
        else:
            black = None  # corrupt zero-count tag (soak fuzz: NaN mean)
    if black is None:
        srw_black = _find_tag(tf, T.SRW_BLACK_RGGB)
        if (isinstance(srw_black, tuple) and len(srw_black) == 4
                and all(isinstance(v, int) for v in srw_black)):
            black_per_site = np.array(
                [float(v) for v in srw_black], np.float32
            ).reshape(2, 2)
            black = float(np.mean(black_per_site))
    white = _find_tag(tf, T.WHITE_LEVEL)
    if isinstance(white, tuple):
        white = white[0] if white else None
    if white is not None and not isinstance(white, (int, float)):
        white = None  # mutated tag type
    if white is None and curve_white is not None:
        # Nikon linearization curves plateau at the true sensor white;
        # the trimmed curve value is the white point when no explicit
        # WhiteLevel tag exists (real NEFs have none).
        white = curve_white

    cfa = _cfa_pattern_string(ifd)
    orientation = _find_tag(tf, T.ORIENTATION)
    if not isinstance(orientation, int) or orientation not in (
        1, 2, 3, 4, 5, 6, 7, 8,
    ):
        orientation = 1

    return RawImage(
        mosaic=mosaic,
        wb_multipliers=wb,
        wb_is_default=wb_default,
        xyz_to_cam=xyz_to_cam,
        black_level=float(black) if black is not None else 0.0,
        black_per_site=black_per_site,
        white_level=float(white) if white is not None else float((1 << bpp) - 1),
        cfa_pattern=cfa,
        orientation=orientation,
        camera_make=_find_tag(tf, T.MAKE) or "",
        camera_model=_find_tag(tf, T.MODEL) or "",
        source_path=source_path,
    )


def _decode_linear(tf: T.TiffFile, ifd: T.IFD,
                   source_path: str) -> RawImage:
    """DNG LinearRaw (photometric 34892, SPP=3): already-demosaiced RGB
    sensor data — uncompressed interleaved u16 or 3-component lossless
    JPEG strips."""
    width = ifd.get_scalar(T.IMAGE_WIDTH)
    height = ifd.get_scalar(T.IMAGE_LENGTH)
    bpp = ifd.get_scalar(T.BITS_PER_SAMPLE, 16)
    comp = ifd.get_scalar(T.COMPRESSION, T.COMPRESSION_NONE)
    if (not isinstance(width, int) or not isinstance(height, int)
            or width <= 0 or height <= 0):
        raise RawDecodeError("linear IFD missing dimensions")
    if width * height * 3 > 16 * max(len(tf.data), 1):
        raise RawDecodeError("implausible linear dimensions")
    if tf.is_tiled(ifd):
        raise UnsupportedRawError("tiled LinearRaw not supported")
    if not isinstance(bpp, int) or not 8 <= bpp <= 16:
        raise UnsupportedRawError(f"LinearRaw with {bpp}-bit samples")
    try:
        if comp == T.COMPRESSION_NONE:
            # Sub-16-bit linear samples are stored in whole bytes:
            # u8 for 8-bit, u16 containers for 9..16-bit.
            if bpp == 8:
                dt = np.uint8
            else:
                dt = (">u2" if tf.endian == ">" else "<u2")
            data = b"".join(tf.strip_data(ifd))
            rgb = np.frombuffer(
                data, dtype=dt, count=width * height * 3
            ).astype(np.uint16).reshape(height, width, 3)
        elif comp == T.COMPRESSION_LJPEG:
            rows = []
            for strip in tf.strip_data(ifd):
                planes, _prec = _decode_lossless_any(strip)
                nc, h0, w0 = planes.shape
                if nc != 3:
                    raise UnsupportedRawError(
                        f"{nc}-component linear scan"
                    )
                rows.append(np.moveaxis(planes, 0, -1))
            rgb = np.vstack(rows) if len(rows) > 1 else rows[0]
            if rgb.shape != (height, width, 3):
                raise RawDecodeError(
                    f"linear decoded {rgb.shape}, expected "
                    f"{(height, width, 3)}"
                )
        else:
            raise UnsupportedRawError(f"linear compression {comp}")
    except RawDecodeError:
        raise
    except (ValueError, TypeError, IndexError, struct.error) as e:
        raise RawDecodeError(f"corrupt linear sensor data: {e}") from e
    try:
        return _finish_raw_image(tf, rgb, None, bpp, ifd, source_path)
    except RawDecodeError:
        raise
    except (ValueError, TypeError, IndexError) as e:
        raise RawDecodeError(f"corrupt color metadata: {e}") from e


def _decode_raf(data: bytes, source_path: str) -> RawImage:
    """Fuji RAF wrapper: embedded-TIFF CFA sections reuse the normal
    pipeline; bare sections decode as BE u16 mosaics of the recorded
    dimensions. X-Trans sensors then develop via the generic CFA path
    (the pattern defaults to X-Trans for Fuji models without explicit
    layout records)."""
    from raweditor_tpu_torch.ops.cfa_generic import XTRANS_PATTERN
    from raweditor_tpu_torch.raw import raf as _raf

    try:
        rf = _raf.RafFile(data)
    except ValueError as e:
        raise RawDecodeError(str(e)) from e

    cfa = rf.cfa_section()
    if cfa[:4] in (b"II*\x00", b"MM\x00*"):
        raw = decode_raw(cfa, source_path=source_path)
    else:
        dims = rf.dimensions()
        if dims is None:
            raise UnsupportedRawError("RAF without dimension record")
        h, w = dims
        if h <= 0 or w <= 0 or h * w * 2 > len(cfa):
            raise RawDecodeError(
                f"RAF CFA section too small for {w}x{h}"
            )
        mosaic = np.frombuffer(cfa, dtype=">u2", count=h * w).astype(
            np.uint16
        ).reshape(h, w)
        raw = RawImage(
            mosaic=mosaic,
            wb_multipliers=np.ones(4, np.float32),
            wb_is_default=True,
            xyz_to_cam=np.eye(3, dtype=np.float32),
            white_level=float(mosaic.max(initial=1)),
            cfa_pattern=XTRANS_PATTERN,
            source_path=source_path,
        )
    wb = rf.wb_multipliers()
    if wb is not None:
        raw.wb_multipliers = wb
        raw.wb_is_default = False
    raw.camera_make = "FUJIFILM"
    raw.camera_model = rf.model
    return raw


def _cfa_pattern_string(ifd: T.IFD) -> str:
    """Pattern string sized by CFARepeatPatternDim: 4 chars for Bayer,
    36 for X-Trans."""
    pat = ifd.get(T.CFA_PATTERN)
    if pat is None:
        return "RGGB"
    dim = ifd.get(T.CFA_REPEAT_DIM)
    n = 4
    if isinstance(dim, tuple) and len(dim) == 2:
        try:
            n = int(dim[0]) * int(dim[1])
        except (TypeError, ValueError):
            n = 4
    if isinstance(pat, (bytes, bytearray, tuple)):
        vals = list(pat)[:n]
    else:
        return "RGGB"
    letters = {0: "R", 1: "G", 2: "B"}
    try:
        out = "".join(letters[v] for v in vals)
    except (KeyError, TypeError):
        return "RGGB"
    return out if len(out) in (4, 36) else "RGGB"


def extract_preview_jpeg(path_or_bytes) -> Optional[bytes]:
    """Largest embedded JPEG, via container tags when present (fast
    path) with the whole-file marker scan as fallback
    (reference: raw/processor.rs:92-125)."""
    data = _read(path_or_bytes)
    from raweditor_tpu_torch.raw import raf as _raf

    if _raf.is_raf(data):
        try:
            jpeg = _raf.RafFile(data).jpeg()
            if jpeg and jpeg[:2] == b"\xff\xd8":
                return jpeg
        except ValueError:
            pass
    from raweditor_tpu_torch.raw import ciff as _ciff

    if _ciff.is_ciff(data):
        try:
            jpeg = _ciff.CiffFile(data).preview_jpeg()
            if jpeg:
                return jpeg
        except (ValueError, struct.error):
            pass
    from raweditor_tpu_torch.raw import bmff as _bmff

    if _bmff.is_bmff(data):
        try:
            jpeg = _bmff.BmffFile(data).preview_jpeg()
            if jpeg:
                return jpeg
        except (ValueError, struct.error):
            pass
    best = None
    try:
        tf = T.TiffFile(data)
        for ifd in tf.all_ifds():
            off = ifd.get_scalar(T.JPEG_INTERCHANGE)
            ln = ifd.get_scalar(T.JPEG_INTERCHANGE_LEN)
            if (isinstance(off, int) and isinstance(ln, int)
                    and off > 0 and ln > 0 and off + ln <= len(data)):
                cand = data[off : off + ln]
                # SOI check like every other fast path here: corrupt
                # tags pointing at in-bounds garbage must not suppress
                # the marker-scan fallback (the tiers pipeline would
                # mark the image 'failed' on the undecodable blob).
                if cand[:2] == b"\xff\xd8" and (
                        best is None or len(cand) > len(best)):
                    best = cand
            # Panasonic embeds the full preview as tag bytes.
            jfr = ifd.get(T.PANA_JPG_FROM_RAW)
            if (tf.variant == "rw2"
                    and isinstance(jfr, (bytes, bytearray))
                    and jfr[:2] == b"\xff\xd8"
                    and (best is None or len(jfr) > len(best))):
                best = bytes(jfr)
    except (ValueError, TypeError):
        # TypeError: corrupt tag types reaching arithmetic — the
        # marker-scan fallback below must still run (code-review r3).
        pass
    if best is not None:
        return best
    from raweditor_tpu_torch.raw.jpeg_scan import extract_largest_jpeg

    return extract_largest_jpeg(data)
