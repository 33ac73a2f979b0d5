"""Pentax PEF compressed sensor codec (behavioral reference).

The reference app decodes PEF through the ``rawloader`` crate
(reference: raw/loader.rs:50-54); the bitstream is the published
dcraw-lineage Pentax scheme:

- the MakerNote (header ``AOC\\0``) carries a Huffman spec in tag
  0x0220: ``dep`` symbol count, 12 skipped bytes, then per symbol a
  u16 12-bit-aligned code prefix and a u8 code length;
- the entropy stream is MSB-first; each symbol is a JPEG difference
  category, followed by ``cat`` raw magnitude bits (T.81 H.2 mapping);
- prediction is the Nikon-style column-pair chain: columns 0-1 chain
  vertically from ``vpred`` (zero-initialized, alternating row
  parity), later columns accumulate onto the value two to the left
  (``hpred``); decoded values above ``2^bps - 1`` are data errors;
- the container is plain TIFF with compression 65535; uncompressed
  PEFs (16-bit or 12-bit packed) are distinguished by payload size.

This module is the scalar Python reference; the C++ extension carries
the fast paths, and tests assert byte/array equality. The synthetic
encoder emits a canonical table (lengths chosen per category) in the
same spec layout the decoder consumes.

Provenance note: no camera files exist in this environment; decoding
is validated by round-trip against this encoder. docs/formats.md
records the risk.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np


def parse_huff_spec(spec: bytes, big_endian: bool = False
                    ) -> List[Tuple[int, int]]:
    """Tag 0x0220 payload → [(code_prefix_12bit, length)] per
    category symbol. Layout: u16 dep (low 4 bits + 12), 12 bytes
    skipped, dep u16 prefixes, dep u8 lengths."""
    e = ">" if big_endian else "<"
    if len(spec) < 2:
        raise ValueError("pentax huffman spec too short")
    dep = (struct.unpack_from(e + "H", spec, 0)[0] + 12) & 15
    off = 2 + 12
    if len(spec) < off + dep * 3:
        raise ValueError("pentax huffman spec truncated")
    prefixes = struct.unpack_from(f"{e}{dep}H", spec, off)
    lengths = spec[off + 2 * dep : off + 3 * dep]
    table = []
    for c in range(dep):
        ln = lengths[c]
        if not 1 <= ln <= 12:
            raise ValueError(f"pentax code length {ln} out of range")
        table.append((prefixes[c], ln))
    return table


def _decode_lut(table: List[Tuple[int, int]]) -> Dict[int, Tuple[int, int]]:
    """12-bit-window LUT: prefix window → (category, length)."""
    lut = {}
    for cat, (prefix, ln) in enumerate(table):
        span = 4096 >> ln
        # The published fill: entries prefix..prefix+span-1 (mod 4096).
        for k in range(span):
            lut[(prefix + k) & 4095] = (cat, ln)
    return lut


from raweditor_tpu_torch.raw.bitpack import MsbReader as _MsbReader


def decode_pentax(data: bytes, width: int, height: int, bps: int,
                  spec: bytes, big_endian_spec: bool = False
                  ) -> np.ndarray:
    """Decode a Pentax compressed payload to (H, W) u16."""
    lut = _decode_lut(parse_huff_spec(spec, big_endian_spec))
    rdr = _MsbReader(data)
    out = np.zeros((height, width), np.uint16)
    vpred = [[0, 0], [0, 0]]
    hpred = [0, 0]
    top = 1 << bps
    for row in range(height):
        for col in range(width):
            hit = lut.get(rdr.peek(12))
            if hit is None:
                raise ValueError("pentax stream: no code matches")
            cat, ln = hit
            rdr.pos += ln
            if cat:
                raw = rdr.get(cat)
                diff = raw if raw >= (1 << (cat - 1)) else (
                    raw - (1 << cat) + 1)
            else:
                diff = 0
            if col < 2:
                vpred[row & 1][col] += diff
                hpred[col] = vpred[row & 1][col]
            else:
                hpred[col & 1] += diff
            v = hpred[col & 1]
            if v < 0 or v >= top:
                raise ValueError(f"pentax sample {v} out of range")
            out[row, col] = v
    return out


# Canonical synthetic table: category c gets length clamp(c+1, 2, 12)
# with JPEG-canonical code assignment — the spec block the encoder
# writes and the decoder parses back.
def make_huff_spec(dep: int = 13, big_endian: bool = False) -> bytes:
    lengths = [max(2, min(12, c + 1)) for c in range(dep)]
    # Canonical codes ordered by (length, category).
    order = sorted(range(dep), key=lambda c: (lengths[c], c))
    codes = {}
    code = 0
    prev_len = lengths[order[0]]
    for c in order:
        code <<= lengths[c] - prev_len
        prev_len = lengths[c]
        codes[c] = code
        code += 1
    e = ">" if big_endian else "<"
    out = bytearray(struct.pack(e + "H", (dep - 12) & 0xFFFF))
    out += b"\0" * 12
    for c in range(dep):
        out += struct.pack(e + "H",
                           (codes[c] << (12 - lengths[c])) & 4095)
    out += bytes(lengths)
    return bytes(out)


def encode_pentax(mosaic: np.ndarray, bps: int = 12,
                  spec: Optional[bytes] = None,
                  big_endian: bool = False) -> Tuple[bytes, bytes]:
    """Encode a mosaic as (stream, huff_spec). Lossless.

    Same residual structure as the Nikon encoder (cols 0-1 chain
    vertically from zero-initialized vpred, later columns predict two
    left), so the packing goes through the shared vectorized/native
    ``bitpack.huffman_encode``."""
    if spec is None:
        spec = make_huff_spec(dep=15 if bps > 12 else 13,
                              big_endian=big_endian)
    table = parse_huff_spec(spec, big_endian=big_endian)
    mosaic = np.asarray(mosaic, np.int32)
    h, w = mosaic.shape
    if mosaic.max(initial=0) >= (1 << bps):
        raise ValueError("sample exceeds bit depth")

    diffs = np.empty_like(mosaic)
    diffs[:, 2:] = mosaic[:, 2:] - mosaic[:, :-2]
    diffs[:2, :2] = mosaic[:2, :2]  # vpred starts at 0
    if h > 2:
        diffs[2:, :2] = mosaic[2:, :2] - mosaic[:-2, :2]

    code_tab = np.zeros(len(table), np.uint64)
    clen_tab = np.zeros(len(table), np.int64)
    for cat, (prefix, ln) in enumerate(table):
        code_tab[cat] = prefix >> (12 - ln)
        clen_tab[cat] = ln

    from raweditor_tpu_torch.raw import bitpack

    try:
        stream = bitpack.huffman_encode(diffs.reshape(-1), code_tab,
                                        clen_tab)
    except ValueError as exc:
        raise ValueError(f"residual category not in table: {exc}") from exc
    return stream, spec
