"""Embedded-JPEG scanning inside RAW files.

RAW containers carry camera-rendered JPEG previews; the reference finds
them by scanning the whole file for SOI/EOI marker pairs, validating
each candidate decodes, and keeping the largest
(reference: raw/processor.rs:92-125). Same semantics here. The Python
path uses ``bytes.find`` (memchr under the hood — already ~GB/s); the
native extension provides the SIMD scan for the batch import path.
"""

from __future__ import annotations

import io
from typing import List, Optional, Tuple

SOI = b"\xff\xd8"
EOI = b"\xff\xd9"


def find_jpeg_spans(data: bytes) -> List[Tuple[int, int]]:
    """All (start, end_exclusive) candidate JPEG spans, as the reference
    pairs them: each SOI with the first EOI at/after it
    (reference: raw/processor.rs:107-120)."""
    from raweditor_tpu_torch.native import get_rawkit

    rk = get_rawkit()
    if rk is not None:
        return [tuple(s) for s in rk.scan_jpeg_spans(data)]
    spans = []
    pos = 0
    while True:
        start = data.find(SOI, pos)
        if start < 0:
            break
        end = data.find(EOI, start)
        if end < 0:
            break
        spans.append((start, end + 2))
        pos = start + 1
    return spans


def _decodable(candidate: bytes) -> bool:
    try:
        from PIL import Image

        with Image.open(io.BytesIO(candidate)) as im:
            im.verify()
        return True
    except Exception:
        return False


def extract_largest_jpeg(data: bytes) -> Optional[bytes]:
    """Largest decodable embedded JPEG, or None
    (reference: raw/processor.rs:92-125)."""
    best = None
    for start, end in find_jpeg_spans(data):
        if best is not None and end - start <= len(best):
            continue
        candidate = data[start:end]
        if _decodable(candidate):
            best = candidate
    return best


# Escalation windows of the reference's legacy thumbnail generator
# (reference: raw/thumbnail.rs:26-52,89-103): scan progressively larger
# prefixes before falling back to the whole file.
SCAN_TIERS = (256 * 1024, 512 * 1024, 5 * 1024 * 1024)


def extract_jpeg_escalating(data: bytes,
                            min_size: int = 8 * 1024) -> Optional[bytes]:
    """Thumbnail-grade fast path: most cameras put a preview JPEG in the
    first few hundred KB, so scan 256 KB → 512 KB → 5 MB prefixes and
    return the first adequate (≥ min_size, decodable) hit; only scan the
    whole file when the prefixes yield nothing
    (reference: raw/thumbnail.rs tier escalation)."""
    for limit in SCAN_TIERS:
        if limit >= len(data):
            break
        window = data[:limit]
        for start, end in find_jpeg_spans(window):
            if end - start >= min_size and _decodable(window[start:end]):
                return window[start:end]
    return extract_largest_jpeg(data)
