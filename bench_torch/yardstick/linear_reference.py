"""The plain f32 reference that decides ``correct`` for LinearRaw frames.

Built only on the frozen copies beside it (``COPIES.json``): it imports
nothing of the program and takes nothing the program made. It develops
the (H, W, 3) samples the traffic wrote, with the metadata the traffic
wrote, so a fault in the program's LinearRaw decode shows here too.

- ``export_planes``: one file as the exporter's plain LinearRaw lane
  develops it for a JPEG (``ops/develop.develop_linear`` to RGBA words,
  then for an edit with finish extras the extras kernel's plain version
  to 4:2:0 planes, else the plain 4:2:0 conversion of the words).

It gives no slider-session entry point, so a LinearRaw configuration makes
export cells alone (``core.serves``). It develops one image a call, so
that it fits beside what the program leaves on the device."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from bench_torch.yardstick.ops import develop as _dv
from bench_torch.yardstick.ops import fused_extras as _fx
from bench_torch.yardstick.ops import jpeg as _jpeg
from bench_torch.yardstick.params import EditParams


@contextlib.contextmanager
def _true_f32():
    """No TF32 in any matmul or convolution while the reference runs; the
    process's own settings come back after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def export_planes(frame, params: EditParams, device, flags: dict):
    """(Y, Cb, Cr) u8 planes of one LinearRaw file as the exporter hands
    them to its JPEG encoder (4:2:0, even frame, no point curve).
    ``frame`` is a ``reference.Frame`` whose ``mosaic`` is (H, W, 3)."""
    mode = flags["mode"]
    with _true_f32():
        rgb = torch.from_numpy(np.ascontiguousarray(frame.mosaic)).to(device)
        words = _dv.develop_linear(
            rgb, params, frame.wb, frame.cam(mode, flags["color_space"]),
            white_level=frame.white, black_level=frame.black,
            matrix_transpose=mode == "parity", transfer=flags["transfer"],
            rgba=True)[None]
        table, mixer_on, grading_on, stencils = _fx.pack_extras([params])
        if params.has_finish_extras() and (mixer_on or grading_on
                                           or stencils):
            y, cbcr = _fx.finish_extras_plain(words, table.to(device),
                                              mixer_on, grading_on,
                                              stencils, "ycbcr420")
            planes = (y, cbcr[..., 0::2], cbcr[..., 1::2])
        else:
            planes = _jpeg.rgba_words_to_ycbcr420(words)
    return tuple(p[0].cpu().numpy() for p in planes)
