"""Nikon encrypted ColorBalance (MakerNote 0x0097) WB decryption.

Modern Nikon bodies store white balance only in the 0x0097 block,
encrypted with a camera-serial / shutter-count keyed stream cipher
(the published dcraw-lineage algorithm):

- key bytes: ``ci = xlat0[serial & 0xff]``,
  ``cj = xlat1[b0 ^ b1 ^ b2 ^ b3]`` (the four shutter-count bytes),
  ``ck = 0x60``;
- stream: per byte, ``cj = (cj + ci * ck) & 0xff``, ``ck += 1``,
  ``out = in ^ cj`` (XOR: encrypt == decrypt);
- the block starts with a 4-digit ASCII version; for versions >= 200
  the encrypted 324-byte window begins 280 bytes after the version
  (except version 205, where it begins immediately);
- the WB word offset inside the window is the published per-version
  table ``"66666>666;6A;:;55"`` (versions 200..216), and the four
  u16 values land in ``cam_mul[c ^ (c>>1) ^ (i&1)]`` order
  (R, G, B, G2 after the swizzle).

The two 256-byte ``xlat`` substitution tables are NOT reproduced here:
they are camera-firmware constants that cannot be reliably sourced in
this environment, and guessing them would silently corrupt WB
(ROADMAP item 2). They are **injectable** instead: place the 512-byte
concatenation (xlat0 then xlat1) at the path named by the
``RAWEDITOR_NIKON_XLAT`` environment variable, or call
``set_xlat_tables()``. Without tables, decode falls back to neutral
WB exactly like the reference does when rawloader yields nothing
(reference: raw/loader.rs:93-97).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

# Per-version WB word offsets, versions 200..216 (published table).
_VERSION_OFFSETS = "66666>666;6A;:;55"

XLAT_ENV = "RAWEDITOR_NIKON_XLAT"

_injected: Optional[Tuple[bytes, bytes]] = None


def set_xlat_tables(xlat0: Optional[bytes], xlat1: Optional[bytes] = None):
    """Inject the substitution tables programmatically (tests, or a
    host app that ships them). Pass None to clear."""
    global _injected
    if xlat0 is None:
        _injected = None
        return
    if len(xlat0) != 256 or xlat1 is None or len(xlat1) != 256:
        raise ValueError("xlat tables must be two 256-byte blocks")
    _injected = (bytes(xlat0), bytes(xlat1))


def inject_xlat_file(path: str) -> str:
    """Load and inject the 512-byte xlat file (xlat0 ‖ xlat1), the
    `--xlat FILE` CLI workflow. Validates the format loudly — a wrong
    file must not silently corrupt WB — and returns the tables'
    SHA-256 hex digest so users can cross-check the exact bytes in
    use (it is also logged at INFO)."""
    import hashlib

    with open(path, "rb") as f:
        data = f.read()
    if len(data) != 512:
        raise ValueError(
            f"xlat file must be exactly 512 bytes "
            f"(xlat0 then xlat1, 256 each); got {len(data)}")
    x0, x1 = data[:256], data[256:]
    # Firmware substitution tables are high-entropy permutation-like
    # byte maps; a near-constant block is certainly the wrong file.
    if len(set(x0)) < 16 or len(set(x1)) < 16:
        raise ValueError(
            "xlat tables look degenerate (fewer than 16 distinct "
            "byte values) - not firmware substitution tables")
    set_xlat_tables(x0, x1)
    digest = hashlib.sha256(data).hexdigest()
    from raweditor_tpu_torch.utils.logging import get_logger

    get_logger("raweditor_tpu_torch.raw").info(
        "injected Nikon xlat tables from %s (sha256 %s)", path, digest)
    return digest


def load_xlat_tables() -> Optional[Tuple[bytes, bytes]]:
    """The injected tables, else the 512-byte file named by
    $RAWEDITOR_NIKON_XLAT, else None."""
    if _injected is not None:
        return _injected
    path = os.environ.get(XLAT_ENV)
    if not path or not os.path.isfile(path):
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if len(data) < 512:
        return None
    return data[:256], data[256:512]


def serial_key(serial_text: str) -> int:
    """The published digit-fold of the SerialNumber string (tag
    0x001D): each character contributes digit value, or char % 10 for
    non-digits."""
    key = 0
    for ch in serial_text:
        key = key * 10 + (int(ch) if ch.isdigit() else ord(ch) % 10)
    return key & 0xFFFFFFFF


def keystream(n: int, serial: int, count: int, xlat0: bytes,
              xlat1: bytes) -> bytes:
    ci = xlat0[serial & 0xFF]
    cj = xlat1[(count ^ (count >> 8) ^ (count >> 16) ^ (count >> 24))
               & 0xFF]
    ck = 0x60
    out = bytearray(n)
    for i in range(n):
        cj = (cj + ci * ck) & 0xFF
        ck = (ck + 1) & 0xFF
        out[i] = cj
    return bytes(out)


def crypt(data: bytes, serial: int, count: int, xlat0: bytes,
          xlat1: bytes) -> bytes:
    """XOR stream cipher: one function for both directions."""
    ks = keystream(len(data), serial, count, xlat0, xlat1)
    return bytes(a ^ b for a, b in zip(data, ks))


def wb_from_color_balance(block: bytes, serial: int, count: int,
                          big_endian: bool) -> Optional[np.ndarray]:
    """Decrypt a 0x0097 payload and extract [R, G, B, G2] multipliers
    (green-normalized). None when the tables are absent, the version
    is outside 200..216, or the block is too short."""
    tables = load_xlat_tables()
    if tables is None or len(block) < 4:
        return None
    try:
        ver = int(block[:4].decode("ascii"))
    except (UnicodeDecodeError, ValueError):
        return None
    if not 200 <= ver <= 216:
        return None
    start = 4 if ver == 205 else 4 + 280
    if len(block) < start + 324:
        return None
    buf = crypt(block[start : start + 324], serial, count, *tables)
    i = ord(_VERSION_OFFSETS[ver - 200]) - ord("0")
    dt = ">u2" if big_endian else "<u2"
    words = np.frombuffer(buf, dtype=dt,
                          count=4, offset=i & -2).astype(np.float64)
    cam_mul = np.zeros(4, np.float64)
    for c in range(4):
        cam_mul[c ^ (c >> 1) ^ (i & 1)] = words[c]
    # cam_mul is [R, G, B, G2]; normalize to green like the reference.
    if cam_mul[1] <= 0 or cam_mul[0] <= 0 or cam_mul[2] <= 0:
        return None
    from raweditor_tpu_torch.raw.types import RawImage

    return RawImage.normalize_wb(
        [cam_mul[0], cam_mul[1], cam_mul[2],
         cam_mul[3] if cam_mul[3] > 0 else cam_mul[1]]
    )


def encrypt_color_balance(ver: int, wb_rgbg: Tuple[float, float, float,
                                                   float],
                          serial: int, count: int, xlat0: bytes,
                          xlat1: bytes, big_endian: bool = False,
                          scale: float = 256.0) -> bytes:
    """Build an encrypted 0x0097 block (synthetic fixtures): inverse
    of :func:`wb_from_color_balance` for a given version."""
    if not 200 <= ver <= 216:
        raise ValueError("version out of the supported 200..216 range")
    i = ord(_VERSION_OFFSETS[ver - 200]) - ord("0")
    plain = bytearray(324)
    words = np.zeros(4, np.uint16)
    cam_mul = [wb_rgbg[0], wb_rgbg[1], wb_rgbg[2], wb_rgbg[3]]
    for c in range(4):
        words[c] = np.uint16(round(cam_mul[c ^ (c >> 1) ^ (i & 1)]
                                   * scale))
    dt = ">u2" if big_endian else "<u2"
    plain[i & -2 : (i & -2) + 8] = words.astype(dt).tobytes()
    enc = crypt(bytes(plain), serial, count, xlat0, xlat1)
    pad = b"" if ver == 205 else b"\0" * 280
    return f"{ver:04d}".encode("ascii") + pad + enc
