"""Samsung SRW v3 codec (compression 32772, NX1/NX500 class) —
behavioral reference.

The reference app decodes Samsung RAWs through the ``rawloader`` crate
(reference: raw/loader.rs:50-54), whose v3 path follows the published
dcraw/rawspeed-lineage reverse engineering. The scheme, as
reconstructed here:

- a 16-byte header precedes the bit stream: 9 reserved bytes, one
  optimization-flags byte, a u16 bit depth, and a u16 initial value
  (the left-edge predictor seed); each image row's bit stream then
  starts at the next 16-byte boundary relative to the payload start;
- the optimization flags gate three stream features:
  ``OPT_SKIP`` (1) — every block carries explicit diff-length flags
  (no per-block "reuse previous lengths" bit); ``OPT_MV`` (2) —
  motion is a 1-bit choice between modes 7 and 3 instead of an
  optional 3-bit mode; ``OPT_QP`` (4) — quantization-scale updates
  are absent (scale stays 0);
- pixels are coded in 16-pixel blocks, three sections per block:
  1. every 64 columns (unless ``OPT_QP``), a 2-bit quantization
     opcode: 0 keep, 1 scale-2, 2 scale+2, 3 = explicit 12-bit scale;
  2. a motion mode: mode 7 predicts every pixel from the previous
     block's last two pixels (by column parity; the header's initial
     value at the row start). Modes 0-6 predict from one of the two
     previous rows through a sliding window: same-CFA-row-parity
     pixels ("green class") from ``row-1``, the others from ``row-2``,
     at column offset {-4,-2,-2,0,0,2,4}[mode], with modes 2 and 4
     averaging the reference pixel with its same-color neighbor two
     columns right. Modes other than 7 are illegal before row 2;
  3. per-quartet residual bit lengths — four 2-bit flags (0 keep,
     1 increment, 2 decrement, 3 = explicit 4-bit length) against a
     two-deep adaptive history kept per color context (3 contexts;
     quartets 0-1 cover one CFA color of the block, 2-3 the other),
     seeded at 7 for rows 0-1 and 4 below — then the sixteen
     sign-extended residuals, scaled ``diff*(2*scale+1)+scale``.
     Residual ``i`` lands on block column ``((i&7)<<1)|((i>>3)^
     (row&1))`` — one color plane first, then the other.

Samples are 12- or 14-bit (the header's depth). The word order of the
bit stream and the green-class row-1 parity adjustment (+1 on even
rows, -1 on odd) follow this module's writer; they are the parts of
the published description this rebuild could not pin down exactly, so
real-camera streams may quarantine at those points rather than
decode wrongly (every inconsistency raises — see docs/formats.md).
The C++ extension carries the fast decode path and tests assert array
equality against this reference.

Provenance note: no camera files exist in this environment; decoding
is validated by round-trip against this encoder plus hand-derived
golden blocks (risk recorded in docs/formats.md).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from raweditor_tpu_torch.raw.samsung import _Ph1Reader, _Ph1Writer, _signed

OPT_SKIP = 1  # no per-block reuse bit: lengths always explicit
OPT_MV = 2  # 1-bit motion (modes 7/3) instead of optional 3-bit
OPT_QP = 4  # no quantization-scale updates (scale pinned to 0)

_MOTION_OFFSET = (-4, -2, -2, 0, 0, 2, 4)
_MOTION_AVERAGE = (0, 0, 1, 0, 1, 0, 0)

HEADER_LEN = 16


def _target(i: int, row: int) -> int:
    """Block column written by residual ``i``: one color plane first
    (offsets of the row's CFA parity), then the other."""
    return ((i & 7) << 1) | ((i >> 3) ^ (row & 1))


def _ctx(j: int, row: int) -> int:
    """Adaptive-length color context of residual quartet ``j``.
    Quartets 0-1 are the row's first color plane, 2-3 the second;
    even and odd rows see different colors at those planes, giving
    three contexts across the green/red/blue split."""
    return (j >> 1) if (row & 1) else ((j >> 1) + 2) % 3


def _clamp_parity(col: int, width: int) -> int:
    """Clamp a reference column into the row, preserving its CFA
    column parity (edge blocks slide their window inward)."""
    while col < 0:
        col += 2
    while col >= width:
        col -= 2
    return col


def _base_predictions(out: np.ndarray, row: int, col: int, motion: int,
                      init: int, width: int) -> List[int]:
    base = [0] * 16
    if motion == 7:
        for t in range(16):
            base[t] = init if col == 0 else int(out[row, col - 2 + (t & 1)])
        return base
    if row < 2:
        raise ValueError("srw3: motion prediction before row 2")
    slide = _MOTION_OFFSET[motion]
    avg = _MOTION_AVERAGE[motion]
    for t in range(16):
        if (t & 1) == (row & 1):
            # Green class: nearest same-color sites on row-1 sit at
            # the opposite column parity (+1 even rows, -1 odd rows).
            ref_row = row - 1
            rc = col + t + slide + (1 - 2 * (row & 1))
        else:
            ref_row = row - 2
            rc = col + t + slide
        rc = _clamp_parity(rc, width)
        v = int(out[ref_row, rc])
        if avg:
            v = (v + int(out[ref_row, _clamp_parity(rc + 2, width)]) + 1) >> 1
        base[t] = v
    return base


def parse_header(data: bytes) -> Tuple[int, int, int]:
    """(optflags, bit depth, initial value) from the 16-byte header."""
    if len(data) < HEADER_LEN:
        raise ValueError("srw3: payload shorter than its header")
    opt = data[9]
    depth = int.from_bytes(data[10:12], "little")
    init = int.from_bytes(data[12:14], "little")
    if opt > 7:
        raise ValueError("srw3: unknown optimization flags")
    if depth not in (12, 14):
        raise ValueError("srw3: bit depth must be 12 or 14")
    if init > (1 << depth) - 1:
        raise ValueError("srw3: initial value exceeds the bit depth")
    return opt, depth, init


def decode_srw3(data: bytes, width: int, height: int) -> np.ndarray:
    """Decode a compression-32772 sensor payload (header + aligned
    row streams) to an (H, W) u16 mosaic. Raises ValueError on any
    stream inconsistency — the quarantine contract."""
    if width <= 0 or height <= 0 or width % 16:
        raise ValueError("srw3: width must be a positive multiple of 16")
    opt, depth, init = parse_header(data)
    white = (1 << depth) - 1
    out = np.zeros((height, width), np.int32)
    pos = HEADER_LEN
    for row in range(height):
        pos = (pos + 15) & ~15
        if pos >= len(data):
            raise ValueError("srw3: row streams truncated")
        rd = _Ph1Reader(data, pos)
        scale = 0
        seed = 7 if row < 2 else 4
        mode = [[seed, seed] for _ in range(3)]
        diff_bits: Optional[List[int]] = None
        for col in range(0, width, 16):
            if not (opt & OPT_QP) and col % 64 == 0:
                code = rd.bits(2)
                if code == 1:
                    scale -= 2
                elif code == 2:
                    scale += 2
                elif code == 3:
                    scale = rd.bits(12)
                if not 0 <= scale <= 4095:
                    raise ValueError("srw3: quantization scale out of range")
            if opt & OPT_MV:
                motion = 3 if rd.bits(1) else 7
            elif rd.bits(1) == 0:
                motion = rd.bits(3)
            else:
                motion = 7
            base = _base_predictions(out, row, col, motion, init, width)
            if (opt & OPT_SKIP) or rd.bits(1) == 0:
                diff_bits = [0] * 4
                for j in range(4):
                    flag = rd.bits(2)
                    ctx = _ctx(j, row)
                    if flag == 0:
                        nb = mode[ctx][0]
                    elif flag == 1:
                        nb = mode[ctx][0] + 1
                    elif flag == 2:
                        nb = mode[ctx][0] - 1
                    else:
                        nb = rd.bits(4)
                    if not 0 <= nb <= depth + 1:
                        raise ValueError(
                            "srw3: residual length out of range")
                    mode[ctx][0] = mode[ctx][1]
                    mode[ctx][1] = nb
                    diff_bits[j] = nb
            elif diff_bits is None:
                raise ValueError(
                    "srw3: length reuse before any lengths were coded")
            for i in range(16):
                n = diff_bits[i >> 2]
                d = _signed(rd.bits(n), n)
                d = d * (2 * scale + 1) + scale
                t = _target(i, row)
                v = base[t] + d
                if not 0 <= v <= white:
                    raise ValueError("srw3: sample out of range")
                out[row, col + t] = v
        pos = rd.pos
    return out.astype(np.uint16)


def _residual_len(diffs: List[int]) -> int:
    n = 0
    for d in diffs:
        need = 0 if d == 0 else (d.bit_length() + 1 if d > 0
                                 else (-d - 1).bit_length() + 1)
        n = max(n, need)
    return n


def encode_srw3(mosaic: np.ndarray, optflags: int = 0,
                init: Optional[int] = None,
                depth: int = 12) -> bytes:
    """Exact encoder (scale stays 0): header + 16-byte-aligned row
    streams, the inverse of :func:`decode_srw3`. Exercises the
    prediction modes by cycling the vertical windows on alternating
    blocks from row 2, and the adaptive-length flags whenever the
    history matches."""
    mosaic = np.asarray(mosaic, np.uint16)
    height, width = mosaic.shape
    if width % 16 or width == 0:
        raise ValueError("srw3: width must be a positive multiple of 16")
    if depth not in (12, 14):
        raise ValueError("srw3: depth must be 12 or 14")
    white = (1 << depth) - 1
    if mosaic.max(initial=0) > white:
        raise ValueError(f"srw3: samples must be {depth}-bit")
    if not 0 <= optflags <= 7:
        raise ValueError("srw3: optflags out of range")
    if init is None:
        init = 1 << (depth - 1)
    out = mosaic.astype(np.int32)
    header = bytes(9) + bytes([optflags]) + \
        depth.to_bytes(2, "little") + int(init).to_bytes(2, "little") + \
        bytes(HEADER_LEN - 14)
    chunks: List[bytes] = [header]
    pos = HEADER_LEN
    for row in range(height):
        pad = (-pos) % 16
        chunks.append(bytes(pad))
        pos += pad
        wr = _Ph1Writer()
        seed = 7 if row < 2 else 4
        mode = [[seed, seed] for _ in range(3)]
        prev_bits: Optional[List[int]] = None
        for col in range(0, width, 16):
            if not (optflags & OPT_QP) and col % 64 == 0:
                wr.put(0, 2)  # scale stays 0: exact
            if row >= 2 and (col // 16 + row) % 2 == 0:
                motion = 3 if (optflags & OPT_MV) \
                    else (col // 16 + row) % 7
            else:
                motion = 7
            if optflags & OPT_MV:
                wr.put(1 if motion == 3 else 0, 1)
            elif motion == 7:
                wr.put(1, 1)
            else:
                wr.put(0, 1)
                wr.put(motion, 3)
            base = _base_predictions(out, row, col, motion, int(init),
                                     width)
            diffs = [0] * 16
            for i in range(16):
                t = _target(i, row)
                diffs[i] = int(out[row, col + t]) - base[t]
            want = [
                _residual_len(diffs[j * 4:j * 4 + 4]) for j in range(4)
            ]
            if want == prev_bits and not (optflags & OPT_SKIP):
                wr.put(1, 1)  # reuse the previous block's lengths
            else:
                if not (optflags & OPT_SKIP):
                    wr.put(0, 1)
                for j in range(4):
                    nb = want[j]
                    if nb > depth + 1:
                        raise ValueError("srw3: residual exceeds "
                                         f"{depth + 1} bits")
                    ctx = _ctx(j, row)
                    if nb == mode[ctx][0]:
                        wr.put(0, 2)
                    elif nb == mode[ctx][0] + 1:
                        wr.put(1, 2)
                    elif nb == mode[ctx][0] - 1:
                        wr.put(2, 2)
                    else:
                        wr.put(3, 2)
                        wr.put(nb, 4)
                    mode[ctx][0] = mode[ctx][1]
                    mode[ctx][1] = nb
                prev_bits = want
            for i in range(16):
                wr.put(diffs[i], want[i >> 2])
        blob = wr.flush()
        chunks.append(blob)
        pos += len(blob)
    return b"".join(chunks)
