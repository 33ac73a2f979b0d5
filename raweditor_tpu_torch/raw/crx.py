"""Canon CR3 CRX sensor codec (lossless path, behavioral reference).

The reference app imports ``.cr3`` (reference: main.rs:1852-1855) but
cannot decode the CRX sensor payload — rawloader has no CR3 support,
so the reference only ever shows embedded previews
(reference: raw/thumbnail.rs). This module goes beyond the reference:
it decodes the lossless CRX codec, wired through the ISO-BMFF track
tables (raw/bmff.py) so real-file *structure* is honored end to end.

Structure (per the public reverse-engineering of the CRX format —
marker layout and field meanings as published; see docs/formats.md
for the provenance/validation caveat):

- The CRAW sample entry in ``moov/trak/mdia/minf/stbl/stsd`` carries a
  ``CMP1`` box with the codec parameters (frame/tile dims, bit depth,
  plane count, CFA layout, encoding type, wavelet level count).
- The sensor sample in ``mdat`` (located via ``stsz``/``co64``) is a
  sequence of big-endian marker headers — ``0xFF01`` tile, ``0xFF02``
  plane, ``0xFF03`` subband — each carrying a payload size, followed by
  the concatenated entropy-coded payloads.
- Lossless CRX (encType 0, imageLevels 0) codes each Bayer subplane
  (4 planes for a 2x2 CFA) independently: MED/LOCO-I prediction
  (median of W, N, W+N-NW), zigzag residual mapping, and adaptive
  Golomb-Rice coding — unary quotient, ``k`` low bits, with a 41-zeros
  escape to a 21-bit literal and the CRX ``k`` adaptation rule
  (grow when the code overshoots 2^k by 2x/5x, shrink when under half).

Exact bit-level subfield packing inside the marker headers follows
this module's writer; no camera files exist in this environment to
validate against, so like every decoder here (docs/formats.md) the
codec is validated by synth round-trip plus hand-authored golden
bitstreams (tests/golden). The entropy layer and marker walk are
written defensively: any inconsistency raises ``ValueError`` (mapped
to the quarantine contract by the caller).

The scalar Python here is the behavioral reference; ``native/rawkit.cpp``
carries the C++ fast path (``decode_crx_plane``) and tests assert
array equality between the two.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from raweditor_tpu_torch.raw.bitpack import MsbReader, MsbWriter

# Marker signatures (big-endian u16) for the in-mdat header chain.
MKR_TILE = 0xFF01
MKR_PLANE = 0xFF02
MKR_BAND = 0xFF03

# Golomb-Rice escape: this many zeros in the unary prefix switches the
# symbol to a raw literal of ESC_BITS bits.
ESC_ZEROS = 41
ESC_BITS = 21
K_MAX = 15

CMP1_HEADER_SIZE = 0x30


class Cmp1:
    """Parsed CMP1 codec-parameter box."""

    __slots__ = ("version", "f_width", "f_height", "tile_width",
                 "tile_height", "n_bits", "n_planes", "cfa_layout",
                 "enc_type", "image_levels")

    def __init__(self, data: bytes):
        if len(data) < CMP1_HEADER_SIZE:
            raise ValueError("CMP1 box too short")
        (_, hdr_size, version) = struct.unpack_from(">HHH", data, 0)
        if hdr_size < CMP1_HEADER_SIZE - 8 or version != 0x0100:
            raise ValueError(
                f"unsupported CMP1 (hdr {hdr_size:#x}, ver {version:#x})")
        (self.f_width, self.f_height, self.tile_width,
         self.tile_height) = struct.unpack_from(">iiii", data, 8)
        self.version = version
        self.n_bits = data[24]
        self.n_planes = data[25] >> 4
        self.cfa_layout = data[25] & 0xF
        self.enc_type = data[26] >> 4
        self.image_levels = data[26] & 0xF
        if not (0 < self.f_width <= 65536 and 0 < self.f_height <= 65536):
            raise ValueError("CMP1: implausible frame dimensions")
        if not (0 < self.tile_width <= self.f_width
                and 0 < self.tile_height <= self.f_height):
            raise ValueError("CMP1: implausible tile dimensions")
        if not 8 <= self.n_bits <= 16:
            raise ValueError(f"CMP1: {self.n_bits}-bit samples")

    def pack(self) -> bytes:
        out = struct.pack(
            ">HHHHiiii", 0, CMP1_HEADER_SIZE - 8, self.version, 0,
            self.f_width, self.f_height, self.tile_width,
            self.tile_height)
        out += bytes([self.n_bits,
                      (self.n_planes << 4) | self.cfa_layout,
                      (self.enc_type << 4) | self.image_levels, 0])
        return out.ljust(CMP1_HEADER_SIZE, b"\0")


def make_cmp1(width: int, height: int, *, n_bits: int = 14,
              tile_cols: int = 1, tile_rows: int = 1,
              levels: int = 0) -> Cmp1:
    if not 0 <= levels <= 3:
        raise ValueError("imageLevels must be 0..3")
    c = Cmp1.__new__(Cmp1)
    c.version = 0x0100
    c.f_width, c.f_height = width, height
    if width % (2 * tile_cols) or height % (2 * tile_rows):
        raise ValueError("tile grid must split the frame on even pixels")
    c.tile_width = width // tile_cols
    c.tile_height = height // tile_rows
    c.n_bits = n_bits
    c.n_planes = 4
    c.cfa_layout = 0  # RGGB
    c.enc_type = 0
    c.image_levels = levels
    return c


# --- adaptive Golomb-Rice entropy layer --------------------------------------


def _adapt_k(k: int, code: int) -> int:
    """CRX k adaptation: grow when the mapped residual overshoots
    2^k by >2x / >5x, shrink when it is under 2^k / 2."""
    k += (code >> k > 2) + (code >> k > 5) - ((code << 1) < (1 << k))
    if k < 0:
        return 0
    return K_MAX if k > K_MAX else k


class _RiceReader(MsbReader):
    def zeros(self, limit: int) -> int:
        n = 0
        total_bits = len(self.data) * 8
        while n < limit:
            if self.pos >= total_bits:
                raise ValueError("crx: bitstream exhausted in unary run")
            if self.get(1):
                return n
            n += 1
        return n


def _decode_plane(data: bytes, width: int, height: int,
                  n_bits: int, k_init: int) -> np.ndarray:
    """Decode one entropy-coded subplane to (height, width) u16."""
    if width <= 0 or height <= 0:
        raise ValueError("crx: empty plane")
    rdr = _RiceReader(data)
    out = np.zeros((height, width), np.int32)
    k = k_init
    mask = (1 << n_bits) - 1
    half = 1 << (n_bits - 1)
    for row in range(height):
        line = out[row]
        above = out[row - 1] if row else None
        for col in range(width):
            if row == 0:
                pred = int(line[col - 1]) if col else half
            elif col == 0:
                pred = int(above[0])
            else:
                w = int(line[col - 1])
                n = int(above[col])
                nw = int(above[col - 1])
                mx, mn = (w, n) if w >= n else (n, w)
                if nw >= mx:
                    pred = mn
                elif nw <= mn:
                    pred = mx
                else:
                    pred = w + n - nw
            q = rdr.zeros(ESC_ZEROS)
            if q >= ESC_ZEROS:
                u = rdr.get(ESC_BITS)
            else:
                u = (q << k) | rdr.get(k)
            k = _adapt_k(k, u)
            err = (u >> 1) ^ -(u & 1)  # zigzag unmap
            val = pred + err
            if val != (val & mask):
                raise ValueError("crx: sample out of range")
            line[col] = val
    return out.astype(np.uint16)


def _encode_plane(plane: np.ndarray, n_bits: int,
                  k_init: int) -> bytes:
    """Exact inverse of :func:`_decode_plane`."""
    plane = np.asarray(plane, np.int64)
    height, width = plane.shape
    if plane.min(initial=0) < 0 or plane.max(initial=0) >= (1 << n_bits):
        raise ValueError(f"samples exceed {n_bits}-bit range")
    wtr = MsbWriter()
    k = k_init
    half = 1 << (n_bits - 1)
    for row in range(height):
        line = plane[row]
        above = plane[row - 1] if row else None
        for col in range(width):
            if row == 0:
                pred = int(line[col - 1]) if col else half
            elif col == 0:
                pred = int(above[0])
            else:
                w = int(line[col - 1])
                n = int(above[col])
                nw = int(above[col - 1])
                mx, mn = (w, n) if w >= n else (n, w)
                if nw >= mx:
                    pred = mn
                elif nw <= mn:
                    pred = mx
                else:
                    pred = w + n - nw
            err = int(line[col]) - pred
            u = (err << 1) ^ (err >> 63)  # zigzag
            q = u >> k
            if q >= ESC_ZEROS:
                if u >= (1 << ESC_BITS):
                    raise ValueError("residual exceeds the escape field")
                wtr.put(0, ESC_ZEROS)
                wtr.put(u, ESC_BITS)
            else:
                wtr.put(1, q + 1)  # q zeros then a one
                wtr.put(u, k)
            k = _adapt_k(k, u)
    return wtr.flush()


def _decode_band(data: bytes, width: int, height: int,
                 k_init: int) -> np.ndarray:
    """Decode one wavelet-subband payload to (height, width) i32:
    plain adaptive Golomb-Rice over zigzag-mapped signed coefficients
    (no spatial prediction — subbands are zero-mean/zero-heavy)."""
    if width < 0 or height < 0:
        raise ValueError("crx: negative band dimensions")
    if width * height == 0:
        # Degenerate detail band of a 1-wide/1-tall subplane level —
        # legitimately empty (the lifting emits no d coefficients).
        return np.empty((height, width), np.int32)
    from raweditor_tpu_torch.native import get_rawkit

    rk = get_rawkit()
    if rk is not None and hasattr(rk, "decode_crx_band"):
        raw = rk.decode_crx_band(data, width, height, k_init)
        return np.frombuffer(raw, np.int32).reshape(height, width).copy()
    rdr = _RiceReader(data)
    out = np.empty((height, width), np.int32)
    k = k_init
    for row in range(height):
        for col in range(width):
            q = rdr.zeros(ESC_ZEROS)
            if q >= ESC_ZEROS:
                u = rdr.get(ESC_BITS)
            else:
                u = (q << k) | rdr.get(k)
            k = _adapt_k(k, u)
            out[row, col] = (u >> 1) ^ -(u & 1)
    return out


def _encode_band(band: np.ndarray, k_init: int) -> bytes:
    """Exact inverse of :func:`_decode_band`."""
    band = np.asarray(band, np.int64)
    wtr = MsbWriter()
    k = k_init
    for v in band.reshape(-1):
        v = int(v)
        u = (v << 1) ^ (v >> 63)
        q = u >> k
        if q >= ESC_ZEROS:
            if u >= (1 << ESC_BITS):
                raise ValueError("coefficient exceeds the escape field")
            wtr.put(0, ESC_ZEROS)
            wtr.put(u, ESC_BITS)
        else:
            wtr.put(1, q + 1)
            wtr.put(u, k)
        k = _adapt_k(k, u)
    return wtr.flush()


# --- LeGall 5/3 integer lifting (the C-RAW wavelet) --------------------------
#
# Reversible JPEG2000-style lifting with symmetric extension:
#   d[i] = x[2i+1] - floor((x[2i] + x[2i+2]) / 2)
#   s[i] = x[2i]   + floor((d[i-1] + d[i] + 2) / 4)
# Vectorized along an axis; exact integer round-trip (tested).


def _neighbors(even: np.ndarray, d: np.ndarray):
    """The lifting neighbor vectors, symmetric-extended:
    right[i] = x[2i+2] for i < len(d); dm1[i] = d[i-1], dcur[i] = d[i]
    for i < len(even), with d[-1] := d[0] and d[no] := d[no-1]."""
    ne, no = even.shape[-1], d.shape[-1]
    if ne == no:  # even length: x[n] mirrors to x[n-2] = even[-1]
        right = np.concatenate([even[..., 1:], even[..., -1:]], axis=-1)
    else:  # odd length: every odd sample has a real right neighbor
        right = even[..., 1:]
    dm1 = np.concatenate([d[..., :1], d], axis=-1)[..., :ne]
    dcur = (d if no == ne
            else np.concatenate([d, d[..., -1:]], axis=-1))
    return right, dm1, dcur


def _lift53_axis(a: np.ndarray, axis: int):
    a = np.swapaxes(np.asarray(a, np.int64), axis, -1)
    if a.shape[-1] == 1:
        return (np.swapaxes(a, axis, -1),
                np.swapaxes(a[..., :0], axis, -1))
    even = a[..., 0::2]
    odd = a[..., 1::2]
    no = odd.shape[-1]
    right = _neighbors(even, odd)[0]  # only needs the geometry
    d = odd - ((even[..., :no] + right) >> 1)
    _, dm1, dcur = _neighbors(even, d)
    s = even + ((dm1 + dcur + 2) >> 2)
    return np.swapaxes(s, axis, -1), np.swapaxes(d, axis, -1)


def _unlift53_axis(s: np.ndarray, d: np.ndarray, axis: int) -> np.ndarray:
    s = np.swapaxes(np.asarray(s, np.int64), axis, -1)
    d = np.swapaxes(np.asarray(d, np.int64), axis, -1)
    ne, no = s.shape[-1], d.shape[-1]
    if no == 0:
        return np.swapaxes(s, axis, -1)
    _, dm1, dcur = _neighbors(s, d)
    even = s - ((dm1 + dcur + 2) >> 2)
    right = _neighbors(even, d)[0]
    odd = d + ((even[..., :no] + right) >> 1)
    out = np.empty(s.shape[:-1] + (ne + no,), np.int64)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return np.swapaxes(out, axis, -1)


def dwt53_forward(a: np.ndarray):
    """One 2-D level: returns (LL, HL, LH, HH) int64 arrays."""
    lo, hi = _lift53_axis(a, axis=1)       # along width
    ll, lh = _lift53_axis(lo, axis=0)      # along height
    hl, hh = _lift53_axis(hi, axis=0)
    return ll, hl, lh, hh


def dwt53_inverse(ll, hl, lh, hh) -> np.ndarray:
    lo = _unlift53_axis(ll, lh, axis=0)
    hi = _unlift53_axis(hl, hh, axis=0)
    return _unlift53_axis(lo, hi, axis=1)


def _band_shapes(h: int, w: int, levels: int):
    """Stream-ordered band shapes: LL_L, then per level L..1 the
    HL/LH/HH detail shapes."""
    dims = []
    ch, cw = h, w
    detail = []
    for _ in range(levels):
        sh, dh = (ch + 1) // 2, ch // 2
        sw, dw = (cw + 1) // 2, cw // 2
        detail.append([(sh, dw), (dh, sw), (dh, dw)])  # HL, LH, HH
        ch, cw = sh, sw
    dims.append((ch, cw))  # LL of the coarsest level
    for lvl in reversed(detail):
        dims.extend(lvl)
    return dims


# --- marker-header chain ------------------------------------------------------


def _marker(sig: int, data_size: int, aux: int) -> bytes:
    return struct.pack(">HHII", sig, 8, data_size, aux)


class _HdrReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def next(self, expect: int) -> Tuple[int, int]:
        if self.pos + 12 > len(self.data):
            raise ValueError("crx: truncated marker chain")
        sig, size, data_size, aux = struct.unpack_from(
            ">HHII", self.data, self.pos)
        if sig != expect:
            raise ValueError(
                f"crx: expected marker {expect:#x}, got {sig:#x}")
        if size != 8:
            raise ValueError(f"crx: unsupported marker size {size}")
        self.pos += 12
        return data_size, aux

    def peek_sig(self) -> Optional[int]:
        if self.pos + 2 > len(self.data):
            return None
        return struct.unpack_from(">H", self.data, self.pos)[0]


def decode_crx(payload: bytes, cmp1: Cmp1) -> np.ndarray:
    """Decode a CRX sensor sample to the full (f_height, f_width) u16
    Bayer mosaic. encType 0 with imageLevels 0 is the lossless
    predictive path; imageLevels 1..3 is the C-RAW wavelet path
    (LeGall 5/3 subbands, per-band quantizers from the band headers)."""
    if cmp1.enc_type != 0 or cmp1.image_levels > 3:
        raise ValueError(
            f"crx: only lossless/C-RAW (encType 0, levels <= 3) is "
            f"supported, got encType {cmp1.enc_type}, levels "
            f"{cmp1.image_levels}")
    if cmp1.n_planes != 4 or cmp1.cfa_layout != 0:
        raise ValueError(
            f"crx: unsupported plane layout ({cmp1.n_planes} planes, "
            f"cfa {cmp1.cfa_layout})")
    tiles_x = -(-cmp1.f_width // cmp1.tile_width)
    tiles_y = -(-cmp1.f_height // cmp1.tile_height)
    if tiles_x * tiles_y > 64:
        raise ValueError("crx: implausible tile count")
    # Rice coding emits >= 1 bit/sample; dimensions a corrupt CMP1
    # claims beyond that bound cannot be real (keeps the scalar
    # decoder from grinding through garbage before erroring).
    if cmp1.f_width * cmp1.f_height > 8 * max(len(payload), 1):
        raise ValueError("crx: dimensions exceed the payload bound")

    levels = cmp1.image_levels
    n_bands = 1 if levels == 0 else 3 * levels + 1

    # Pass 1: the header chain (all tile headers precede all payloads,
    # and within a tile the plane/band headers precede the plane data).
    hdr = _HdrReader(payload)
    tiles = []
    for _ in range(tiles_x * tiles_y):
        tile_size, _aux = hdr.next(MKR_TILE)
        planes = []
        for _p in range(cmp1.n_planes):
            plane_size, _paux = hdr.next(MKR_PLANE)
            bands = []
            for _b in range(n_bands):
                band_size, baux = hdr.next(MKR_BAND)
                k_init = (baux >> 24) & 0xF
                qstep = (baux >> 8) & 0xFFFF
                bands.append((band_size, k_init, max(qstep, 1)))
            if sum(b[0] for b in bands) > plane_size:
                raise ValueError("crx: bands larger than their plane")
            planes.append(bands)
        if sum(b[0] for bands in planes for b in bands) > tile_size:
            raise ValueError("crx: planes overflow their tile")
        tiles.append((tile_size, planes))

    mosaic = np.zeros((cmp1.f_height, cmp1.f_width), np.uint16)
    pos = hdr.pos
    from raweditor_tpu_torch.native import get_rawkit

    rk = get_rawkit()
    native = rk is not None and hasattr(rk, "decode_crx_plane")
    mask = (1 << cmp1.n_bits) - 1
    for t, (tile_size, planes) in enumerate(tiles):
        ty, tx = divmod(t, tiles_x)
        y0 = ty * cmp1.tile_height
        x0 = tx * cmp1.tile_width
        th = min(cmp1.tile_height, cmp1.f_height - y0)
        tw = min(cmp1.tile_width, cmp1.f_width - x0)
        if th <= 0 or tw <= 0 or th % 2 or tw % 2:
            raise ValueError("crx: bad tile geometry")
        ph, pw = th // 2, tw // 2
        shapes = _band_shapes(ph, pw, levels) if levels else [(ph, pw)]
        for p, bands in enumerate(planes):
            if levels == 0:
                band_size, k_init, _q = bands[0]
                if pos + band_size > len(payload):
                    raise ValueError("crx: plane payload truncated")
                if ph * pw > 8 * band_size + 64:
                    raise ValueError(
                        "crx: plane smaller than 1 bit/sample")
                blob = payload[pos:pos + band_size]
                if native:
                    raw = rk.decode_crx_plane(blob, pw, ph,
                                              cmp1.n_bits, k_init)
                    plane = np.frombuffer(raw, np.uint16).reshape(ph, pw)
                else:
                    plane = _decode_plane(blob, pw, ph,
                                          cmp1.n_bits, k_init)
                pos += band_size
            else:
                coeffs = []
                for (band_size, k_init, qstep), (bh, bw) in zip(
                        bands, shapes):
                    if pos + band_size > len(payload):
                        raise ValueError("crx: band payload truncated")
                    if bh * bw > 8 * band_size + 64:
                        raise ValueError(
                            "crx: band smaller than 1 bit/sample")
                    band = _decode_band(payload[pos:pos + band_size],
                                        bw, bh, k_init)
                    coeffs.append(band.astype(np.int64) * qstep)
                    pos += band_size
                ll = coeffs[0]
                idx = 1
                for _lvl in range(levels):
                    hl, lh, hh = coeffs[idx:idx + 3]
                    idx += 3
                    ll = dwt53_inverse(ll, hl, lh, hh)
                plane = np.clip(ll, 0, mask).astype(np.uint16)
            dy, dx = divmod(p, 2)  # cfaLayout 0: row-major 2x2
            mosaic[y0 + dy:y0 + th:2, x0 + dx:x0 + tw:2] = plane
    return mosaic


def decode_cr3(data: bytes, source_path: str = ""):
    """Decode a CR3 file's CRX sensor track to a RawImage, or return
    None when the container has no CRAW track (caller falls back to
    the metadata/preview-only path). Canon stores WB and black level
    in the CMT3 MakerNote ColorData blob, which is per-model; until a
    real-file corpus exists those stay at neutral/zero defaults
    (docs/formats.md)."""
    from raweditor_tpu_torch.raw.bmff import BmffFile
    from raweditor_tpu_torch.raw.types import RawImage

    bf = BmffFile(data)
    track = bf.raw_track()
    if track is None:
        return None
    cmp1_payload, offset, size = track
    cmp1 = Cmp1(cmp1_payload)
    mosaic = decode_crx(data[offset:offset + size], cmp1)
    info = bf.camera_info()
    return RawImage(
        mosaic=mosaic,
        wb_multipliers=np.ones(4, np.float32),
        wb_is_default=True,  # CMT3 ColorData unparsed (docs/formats.md)
        xyz_to_cam=np.eye(3, dtype=np.float32),
        black_level=0.0,
        white_level=float((1 << cmp1.n_bits) - 1),
        cfa_pattern="RGGB",
        orientation=int(info.get("orientation", 1)),
        camera_make=str(info.get("make", "Canon")),
        camera_model=str(info.get("model", "")),
        source_path=source_path,
    )


def encode_crx(mosaic: np.ndarray, cmp1: Cmp1, k_init: int = 3,
               q_detail: int = 1) -> bytes:
    """Inverse of :func:`decode_crx`. Lossless for imageLevels 0, and
    for imageLevels > 0 with ``q_detail=1`` (the 5/3 lifting is
    reversible); larger ``q_detail`` quantizes the detail subbands —
    the C-RAW rate/quality trade. The LL band is never quantized."""
    mosaic = np.asarray(mosaic, np.uint16)
    if mosaic.shape != (cmp1.f_height, cmp1.f_width):
        raise ValueError("mosaic does not match CMP1 dimensions")
    if not 1 <= q_detail <= 0xFFFF:
        raise ValueError("q_detail out of range")
    levels = cmp1.image_levels
    tiles_x = -(-cmp1.f_width // cmp1.tile_width)
    tiles_y = -(-cmp1.f_height // cmp1.tile_height)
    headers: List[bytes] = []
    payloads: List[bytes] = []
    for t in range(tiles_x * tiles_y):
        ty, tx = divmod(t, tiles_x)
        y0 = ty * cmp1.tile_height
        x0 = tx * cmp1.tile_width
        th = min(cmp1.tile_height, cmp1.f_height - y0)
        tw = min(cmp1.tile_width, cmp1.f_width - x0)
        tile_parts = []
        tile_hdrs = []
        for p in range(cmp1.n_planes):
            dy, dx = divmod(p, 2)
            plane = mosaic[y0 + dy:y0 + th:2, x0 + dx:x0 + tw:2]
            if levels == 0:
                blob = _encode_plane(plane, cmp1.n_bits, k_init)
                tile_hdrs.append(_marker(MKR_PLANE, len(blob), p << 28))
                tile_hdrs.append(_marker(MKR_BAND, len(blob),
                                         (k_init & 0xF) << 24))
                tile_parts.append(blob)
            else:
                ll = plane.astype(np.int64)
                details = []
                for _ in range(levels):
                    ll, hl, lh, hh = dwt53_forward(ll)
                    details.append((hl, lh, hh))
                bands = [(ll, 1)]
                for hl, lh, hh in reversed(details):
                    bands += [(hl, q_detail), (lh, q_detail),
                              (hh, q_detail)]
                blobs = []
                band_hdrs = []
                for band, q in bands:
                    if q > 1:
                        # Mid-tread quantizer, round-half-away.
                        band = np.sign(band) * (
                            (np.abs(band) + q // 2) // q)
                    blob = _encode_band(band, k_init)
                    band_hdrs.append(_marker(
                        MKR_BAND, len(blob),
                        ((k_init & 0xF) << 24) | ((q & 0xFFFF) << 8)))
                    blobs.append(blob)
                plane_payload = b"".join(blobs)
                tile_hdrs.append(_marker(MKR_PLANE, len(plane_payload),
                                         p << 28))
                tile_hdrs.extend(band_hdrs)
                tile_parts.append(plane_payload)
        tile_payload = b"".join(tile_parts)
        headers.append(_marker(MKR_TILE, len(tile_payload), t << 24))
        headers.extend(tile_hdrs)
        payloads.append(tile_payload)
    return b"".join(headers) + b"".join(payloads)
