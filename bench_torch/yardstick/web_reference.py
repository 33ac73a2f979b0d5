"""The plain f32 reference that decides ``correct`` for a web export: one
RAW file developed as the exporter's kernel route develops a shaped flush,
resized to the export's long edge and converted to 4:2:0 planes.

Built on the frozen copies beside it and on a resize of its own: it
imports nothing of the program and takes nothing the program made.

- ``shaped_planes``: one file as the exporter hands it to its JPEG encoder
  with ``long_edge`` (``flags["long_edge"]``): the develop kernel's plain
  version to RGBA words, then for an edit with finish extras the extras
  kernel's plain version to words, then ``resize_rgb`` to the long edge,
  then the plain 4:2:0 conversion;
- ``resize_rgb``: ``jax.image.resize(x, shape, "lanczos3",
  antialias=True)`` written from its published semantics, not from the
  program's ``ops/resize.py``. Per axis the Lanczos-3 kernel is widened
  by ``1/scale`` when it shrinks, each output's weights are normalised by
  their sum over the input samples that exist, and an output whose
  sample point lies outside the input gets weight 0; then round half to
  even and clamp to 0..255.

Departures from ``jax.image.resize``, each below a LSB before rounding:
the weights are computed in float64 and rounded to f32 once (JAX computes
them in f32); the rows are resized first, then the columns (JAX lets
``einsum`` order the two contractions); and each output is summed tap by
tap over its band (JAX contracts a dense matrix).

It gives no other entry point, so its configuration makes cells only
under mixes whose driver checks shaped planes (``core.serves``)."""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.yardstick import color
from bench_torch.yardstick.linear_reference import _true_f32
from bench_torch.yardstick.ops import develop as _dv
from bench_torch.yardstick.ops import fused_develop as _fd
from bench_torch.yardstick.ops import fused_extras as _fx
from bench_torch.yardstick.ops import jpeg as _jpeg
from bench_torch.yardstick.parallel.batch import pack_params
from bench_torch.yardstick.params import EditParams

RADIUS = 3  # Lanczos-3
_EPS32 = float(np.finfo(np.float32).eps)


def long_edge_shape(h: int, w: int, long_edge: int):
    """(out_h, out_w): the longer side ``long_edge``, the other rounded
    to the aspect (half to even); (h, w) when the frame already fits."""
    if long_edge <= 0 or max(h, w) <= long_edge:
        return h, w
    if w >= h:
        return max(1, round(h * long_edge / w)), long_edge
    return long_edge, max(1, round(w * long_edge / h))


def lanczos3(x: np.ndarray) -> np.ndarray:
    """The Lanczos-3 kernel at distances ``x`` >= 0 (float64): 1 within
    1e-3 of 0, 0 beyond 3."""
    out = np.ones_like(x)
    far = x > 1e-3
    t = np.pi * x[far]
    out[far] = RADIUS * np.sin(t) * np.sin(t / RADIUS) / (t * t)
    out[x > RADIUS] = 0.0
    return out


def taps(in_size: int, out_size: int):
    """(index, weight), each (out_size, T): the input samples each output
    of one axis sums and their f32 weights. Indices that fall outside the
    input carry weight 0 (and a clamped index)."""
    scale = out_size / in_size
    widen = max(1.0 / scale, 1.0)
    support = RADIUS * widen
    centre = (np.arange(out_size) + 0.5) / scale - 0.5
    first = np.floor(centre - support).astype(np.int64)
    index = first[:, None] + np.arange(int(np.ceil(2 * support)) + 2)
    weight = lanczos3(np.abs(centre[:, None] - index) / widen)
    weight[(index < 0) | (index >= in_size)] = 0.0
    total = weight.sum(axis=1, keepdims=True)
    weight = np.where(np.abs(total) > 1000.0 * _EPS32,
                      weight / np.where(total != 0, total, 1.0), 0.0)
    inside = (centre >= -0.5) & (centre <= in_size - 0.5)
    weight[~inside] = 0.0
    return np.clip(index, 0, in_size - 1), weight.astype(np.float32)


def _along(x: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """``x`` resampled along ``axis`` (-2 rows, -1 columns) to
    ``out_size``, summed tap by tap."""
    in_size = x.shape[axis]
    if out_size == in_size:
        return x
    index, weight = taps(in_size, out_size)
    index = torch.from_numpy(index).to(x.device)
    weight = torch.from_numpy(weight).to(x.device)
    shape = [1] * x.dim()
    shape[axis] = out_size
    out = None
    for t in range(index.shape[1]):
        term = (torch.index_select(x, x.dim() + axis, index[:, t])
                * weight[:, t].reshape(shape))
        out = term if out is None else out + term
    return out


def resize_f32(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W) f32 to (..., out_h, out_w) f32: the rows, then the
    columns."""
    return _along(_along(x, out_h, -2), out_w, -1)


def resize_rgb(rgb: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(C, H, W) f32 samples in 0..255 to (C, out_h, out_w) u8, rounded
    half to even and clamped."""
    y = resize_f32(rgb, out_h, out_w)
    return torch.clamp(torch.round(y), 0.0, 255.0).to(torch.uint8)


def _words(frame, params: EditParams, device, flags: dict) -> torch.Tensor:
    """(1, H, W) u32 RGBA words of one file as the kernel route leaves a
    shaped flush's image: the develop to words, the extras to words."""
    mode = flags["mode"]
    m = torch.from_numpy(np.ascontiguousarray(frame.mosaic)).to(device)[None]
    scal = pack_params([params], frame.wb[None],
                       frame.cam(mode, flags["color_space"])[None],
                       [frame.white], [frame.black],
                       matrix_transpose=mode == "parity").to(device)
    words = _fd.develop_rgba_folded_plain(
        m, scal, cfa_phase=frame.phase,
        gamma=color.kernel_gamma_for(flags["transfer"]),
        output="rgba", demosaic=flags["demosaic_method"])
    table, mixer_on, grading_on, stencils = _fx.pack_extras([params])
    if params.has_finish_extras() and (mixer_on or grading_on or stencils):
        words = _fx.finish_extras_plain(words, table.to(device), mixer_on,
                                        grading_on, stencils, "rgba")
    return words


def shaped_planes(frame, params: EditParams, device, flags: dict):
    """(Y, Cb, Cr) u8 planes of one Bayer file exported at
    ``flags["long_edge"]`` as the exporter hands them to its JPEG encoder
    (an even output, 4:2:0). ``frame`` is a ``reference.Frame``."""
    with _true_f32():
        words = _words(frame, params, device, flags)
        h, w = words.shape[-2:]
        out_h, out_w = long_edge_shape(h, w, int(flags["long_edge"]))
        rgb = torch.stack([c.to(torch.float32)
                           for c in _dv.unpack_rgba(words[0])])
        small = resize_rgb(rgb, out_h, out_w)
        planes = _jpeg.rgb_u8_to_ycbcr420(torch.movedim(small, 0, -1))
    return tuple(p.cpu().numpy() for p in planes)
