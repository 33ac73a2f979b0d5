"""A written JPEG judged by a decoder that is not the program's.

The program encodes with its own native JFIF encoder. The check decodes
the file with libjpeg, through PIL, into Y, Cb and Cr without colour
conversion, and compares them with the reference's 4:2:0 planes: the
luma directly, the chroma after the reference's planes are upsampled as
libjpeg upsamples 4:2:0 chroma (``fancy_upsample``). What remains is the
encoder's quantisation error, which the traffic mix's limit bounds; and
the quantisation tables the file carries must be libjpeg's at the
configuration's quality (``tables_differ``)."""

from __future__ import annotations

import numpy as np


def _open(src):
    """A JPEG as PIL opens it, from a path or from its bytes."""
    import io

    from PIL import Image

    return Image.open(io.BytesIO(src) if isinstance(src, bytes) else src)


def decode_ycbcr(src) -> np.ndarray:
    """(H, W, 3) u8 Y, Cb, Cr of a baseline JPEG (a path or its bytes),
    chroma upsampled by libjpeg."""
    with _open(src) as im:
        im.draft("YCbCr", im.size)
        if im.mode != "YCbCr":
            raise ValueError(f"decoded as {im.mode}, not YCbCr")
        return np.asarray(im)


def tables_differ(src, quality: int) -> bool:
    """Whether a JPEG's quantisation tables differ from those libjpeg
    writes at ``quality`` (the IJG tables, scaled): the quality the
    configuration states."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (16, 16)).save(buf, format="JPEG", quality=int(quality))
    with _open(buf.getvalue()) as want, _open(src) as got:
        return got.quantization != want.quantization


def luma_max_lsb(src, rgb) -> int:
    """The largest difference of a JPEG's luma decoded by libjpeg from the
    JFIF luma of an (h, w, 3) u8 frame (an odd frame, whose chroma the
    encoder subsamples with edges of its own); 255 when the sizes
    disagree."""
    got = decode_ycbcr(src)[..., 0]
    if got.shape != rgb.shape[:2]:
        return 255
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    want = np.clip(np.round(0.299 * r + 0.587 * g + 0.114 * b), 0, 255)
    return int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())


def fancy_upsample(c: np.ndarray) -> np.ndarray:
    """(2h, 2w) u8 from an (h, w) chroma plane by libjpeg's h2v2 "fancy"
    triangle filter (``jdsample.c``, ``h2v2_fancy_upsample``): each output
    sample weighs its nearest input 9/16, the two next 3/16 each and the
    diagonal 1/16, the edges repeated, rounding biases 8 and 7
    alternating along the row."""
    c = c.astype(np.int32)
    up = np.vstack([c[:1], c[:-1]])
    down = np.vstack([c[1:], c[-1:]])
    out = np.empty((2 * c.shape[0], 2 * c.shape[1]), np.int32)
    for v, near in ((0, up), (1, down)):
        col = 3 * c + near
        left = np.hstack([col[:, :1], col[:, :-1]])
        right = np.hstack([col[:, 1:], col[:, -1:]])
        out[v::2, 0::2] = (3 * col + left + 8) >> 4
        out[v::2, 1::2] = (3 * col + right + 7) >> 4
    return out.astype(np.uint8)


def max_lsb(src, planes) -> int:
    """The largest difference, in 8-bit steps, of a JPEG (a path or its
    bytes) decoded by libjpeg from the reference's (Y, Cb, Cr) 4:2:0
    planes; 255 when the sizes disagree."""
    y, cb, cr = planes
    got = decode_ycbcr(src)
    if got.shape != y.shape + (3,):
        return 255
    worst = 0
    for i, want in enumerate((y, fancy_upsample(cb), fancy_upsample(cr))):
        d = np.abs(got[..., i].astype(np.int16) - want.astype(np.int16))
        worst = max(worst, int(d.max()))
    return worst
