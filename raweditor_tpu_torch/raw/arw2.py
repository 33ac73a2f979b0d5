"""Sony ARW2 compressed RAW (TIFF compression 32767) codec.

Sony's lossy block compression, long-public via the dcraw lineage
(`sony_arw2_load_raw`): each 16-byte block packs 16 samples of one
Bayer column-phase — an 11-bit max, 11-bit min, 4-bit argmax/argmin,
then fourteen 7-bit deltas shifted by a per-block shift chosen from the
block's dynamic range. Two consecutive blocks interleave across a
32-column span (first block the even columns, second the odd).

This is an independent implementation of that published layout, numpy-
vectorized (the whole plane decodes in a handful of array passes). As
with the Nikon codec, there are no camera files in this environment:
validation is round-trip against our own encoder on representable data
(blocks whose dynamic range needs no shift are bit-exact; wider blocks
are lossy by design). The camera's tone curve is a caller-supplied LUT;
default is the identity expansion ``pix << 1 >> 2`` of the 11-bit
samples into 12-bit space without a curve.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Delta bit offsets within a 128-bit block: 14 slots from bit 30,
# LSB-first bit numbering within little-endian bytes.
_DELTA_BITS = [30 + 7 * k for k in range(14)]


def decode_arw2(data: bytes, width: int, height: int,
                curve: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode the packed plane: ``height`` rows of ``width`` bytes each
    → (H, W) u16 mosaic. ``width`` must be a multiple of 32."""
    if width % 32:
        raise ValueError(f"ARW2 width {width} not a multiple of 32")
    need = width * height
    if len(data) < need:
        raise ValueError(f"ARW2 data too short: {len(data)} < {need}")

    from raweditor_tpu_torch.native import get_rawkit

    rk = get_rawkit()
    if rk is not None and hasattr(rk, "decode_arw2"):
        raw = rk.decode_arw2(data, width, height)
        out = np.frombuffer(raw, np.uint16).reshape(height, width)
        if curve is not None:
            return curve[np.clip(out, 0, len(curve) - 1)]
        return out
    rows = np.frombuffer(data, np.uint8, count=need).reshape(height, width)
    blocks = rows.reshape(height, width // 16, 16)  # 16 bytes/block

    hdr = (
        blocks[..., 0].astype(np.uint32)
        | (blocks[..., 1].astype(np.uint32) << 8)
        | (blocks[..., 2].astype(np.uint32) << 16)
        | (blocks[..., 3].astype(np.uint32) << 24)
    )
    vmax = (hdr & 0x7FF).astype(np.int32)
    vmin = ((hdr >> 11) & 0x7FF).astype(np.int32)
    imax = ((hdr >> 22) & 0x0F).astype(np.int64)
    imin = ((hdr >> 26) & 0x0F).astype(np.int64)
    rng = vmax - vmin
    sh = np.zeros_like(rng)
    for s in range(4):
        sh += (0x80 << s) <= rng  # same loop rule as the reference algo

    # 14 delta slots; each reads 7 LSB-first bits at a fixed offset.
    b16 = blocks.astype(np.uint16)
    deltas = np.empty(blocks.shape[:2] + (14,), np.int32)
    for k, bit in enumerate(_DELTA_BITS):
        byte = bit >> 3
        shift = bit & 7
        word = b16[..., byte] | (b16[..., byte + 1] << 8) if byte + 1 < 16 \
            else b16[..., byte]
        deltas[..., k] = (word >> shift).astype(np.int32) & 0x7F

    # Reconstruct the 16 slots directly: slot i is vmax at imax, vmin at
    # imin, else the k-th delta where k counts the non-excluded slots
    # before i. (Degenerate imax==imin blocks have 15 delta slots but
    # only 14 deltas; the 15th falls back to vmin.) Closed-form k avoids
    # a per-decode argsort — ~20× faster than scatter.
    expanded = np.minimum(
        (deltas << sh[..., None]) + vmin[..., None], 0x7FF
    )  # (H, B, 14)
    degenerate = imax == imin
    pix = np.empty(blocks.shape[:2] + (16,), np.int32)
    for i in range(16):
        k = i - (i > imax).astype(np.int64) - (i > imin).astype(np.int64)
        k_deg = i - (i > imax).astype(np.int64)
        k = np.where(degenerate, k_deg, k)
        overflow = k > 13
        kc = np.clip(k, 0, 13)
        val = np.take_along_axis(expanded, kc[..., None], axis=-1)[..., 0]
        val = np.where(overflow, vmin, val)
        pix[..., i] = np.where(
            i == imax, vmax, np.where(i == imin, vmin, val)
        )

    # Column interleave: block pairs cover 32 columns (even then odd).
    out = np.empty((height, width), np.uint16)
    vals = pix.reshape(height, -1, 16)
    n_blocks = width // 16
    pair = np.arange(n_blocks)
    base = 32 * (pair // 2) + (pair % 2)
    cols = base[:, None] + 2 * np.arange(16)[None, :]  # (n_blocks, 16)
    out[:, cols.reshape(-1)] = vals.reshape(height, -1)

    if curve is not None:
        return curve[np.clip(pix_to_12bit(out), 0, len(curve) - 1)]
    return pix_to_12bit(out)


def pix_to_12bit(pix11: np.ndarray) -> np.ndarray:
    """The reference algorithm's output mapping without a tone curve:
    curve[pix << 1] >> 2 with identity curve == (pix << 1) >> 2... which
    would lose bits; instead expose the 11-bit samples scaled to 12-bit
    space (pix << 1), the identity-curve equivalent before the >>2
    requantization."""
    return (pix11.astype(np.uint16) << 1).astype(np.uint16)


def encode_arw2(mosaic12: np.ndarray) -> bytes:
    """Encode a (H, W) mosaic of 12-bit-space samples (LSB ignored —
    values are ``pix << 1``) into ARW2 blocks. Blocks whose 11-bit
    dynamic range is below 128 encode losslessly; wider blocks are
    quantized exactly like a camera would."""
    m = np.asarray(mosaic12, np.int32) >> 1  # back to 11-bit samples
    h, w = m.shape
    if w % 32:
        raise ValueError("width must be a multiple of 32")
    if m.max(initial=0) > 0x7FF or m.min(initial=0) < 0:
        raise ValueError("samples exceed 11-bit range")

    out = bytearray()
    for y in range(h):
        for pair in range(w // 32):
            for phase in range(2):
                cols = pair * 32 + phase + 2 * np.arange(16)
                pix = m[y, cols]
                vmin = int(pix.min())
                vmax = int(pix.max())
                imin = int(np.argmin(pix))
                imax = int(np.argmax(pix))
                if imax == imin:  # constant block: distinct slots
                    imax = (imin + 1) % 16
                sh = 0
                while sh < 4 and (0x80 << sh) <= vmax - vmin:
                    sh += 1
                hdr = (vmax & 0x7FF) | ((vmin & 0x7FF) << 11) \
                    | (imax << 22) | (imin << 26)
                block = bytearray(16)
                block[0:4] = hdr.to_bytes(4, "little")
                bit = 30
                for i in range(16):
                    if i in (imax, imin):
                        continue
                    delta = min((int(pix[i]) - vmin) >> sh, 0x7F)
                    byte = bit >> 3
                    shift = bit & 7
                    cur = block[byte] | (block[byte + 1] << 8 if byte + 1 < 16 else 0)
                    cur |= delta << shift
                    block[byte] = cur & 0xFF
                    if byte + 1 < 16:
                        block[byte + 1] = (cur >> 8) & 0xFF
                    bit += 7
                out += block
    return bytes(out)
