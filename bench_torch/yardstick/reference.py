"""The plain f32 reference that decides ``correct``.

Built only on the frozen copies beside it (the port's plain lane as it
stood at commit e13d09fb7b94, ``COPIES.json``): it imports nothing of the
program and takes nothing the program made. It develops the mosaic the
traffic wrote, with the metadata the traffic wrote, so a fault in the
program's decode shows as a difference here too.

- ``export_planes``: one file as the exporter's kernel route develops it
  for a JPEG (the develop kernel's plain version, then for an edit with
  finish extras the extras kernel's plain version), to 4:2:0 planes;
- ``preview``, ``preview_planes`` and ``histogram``: the session's
  ``frame`` (the sampled preview; for an even preview its 4:2:0 planes)
  and ``histogram`` at a zoom and pan;
- ``bin_shift``: how far the counts of one histogram lie from another's.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.yardstick import color
from bench_torch.yardstick.ops import develop as _dv
from bench_torch.yardstick.ops import fused_develop as _fd
from bench_torch.yardstick.ops import fused_extras as _fx
from bench_torch.yardstick.ops import jpeg as _jpeg
from bench_torch.yardstick.ops import sampling as _sampling
from bench_torch.yardstick.ops.cfa_generic import generic_cfa_method
from bench_torch.yardstick.parallel.batch import pack_params
from bench_torch.yardstick.params import EditParams


class Frame:
    """A mosaic and the metadata its file carries, as the program's
    decoder must read it back: white-balance gains (3,), the XYZ-to-camera
    matrix, white and black levels, and the CFA (a Bayer phase, or a
    36-letter X-Trans pattern)."""

    def __init__(self, mosaic, wb, xyz_to_cam, white, black, phase=(0, 0),
                 pattern=None):
        self.mosaic = mosaic
        self.wb = np.asarray(wb, np.float32)[:3]
        self.xyz_to_cam = np.asarray(xyz_to_cam, np.float32)
        self.white, self.black = float(white), float(black)
        self.phase, self.pattern = tuple(phase), pattern

    def cam(self, mode: str, space: str) -> np.ndarray:
        return color.cam_to_output_matrix(self.xyz_to_cam, mode, space)


def export_planes(frame: Frame, params: EditParams, device, flags: dict):
    """(Y, Cb, Cr) u8 planes of one file as the exporter hands them to
    its JPEG encoder (4:2:0, even frame, kernel route, no point curve)."""
    mode = flags["mode"]
    gamma = color.kernel_gamma_for(flags["transfer"])
    m = torch.from_numpy(np.ascontiguousarray(frame.mosaic)).to(device)[None]
    scal = pack_params([params], frame.wb[None],
                       frame.cam(mode, flags["color_space"])[None],
                       [frame.white], [frame.black],
                       matrix_transpose=mode == "parity").to(device)
    table, mixer_on, grading_on, stencils = _fx.pack_extras([params])
    extras = params.has_finish_extras() and (mixer_on or grading_on
                                             or stencils)
    cfa = (dict(pattern=frame.pattern,
                demosaic=generic_cfa_method(flags["demosaic_method"]))
           if frame.pattern else dict(cfa_phase=frame.phase,
                                      demosaic=flags["demosaic_method"]))
    out = _fd.develop_rgba_folded_plain(
        m, scal, gamma=gamma, output="rgba" if extras else "ycbcr420", **cfa)
    if extras:
        out = _fx.finish_extras_plain(out, table.to(device), mixer_on,
                                      grading_on, stencils, "ycbcr420")
    y, cbcr = out
    return (y[0].cpu().numpy(), cbcr[0, :, 0::2].cpu().numpy(),
            cbcr[0, :, 1::2].cpu().numpy())


def _view(frame: Frame, params: EditParams, flags: dict, zoom, pan):
    cfa = (dict(pattern=frame.pattern) if frame.pattern
           else dict(cfa_phase=frame.phase))
    return dict(zoom=float(zoom), pan_x=float(pan[0]), pan_y=float(pan[1]),
                white_level=frame.white, black_level=frame.black,
                matrix_transpose=flags["mode"] == "parity",
                transfer=flags["transfer"],
                extras=params.finish_extras_mode(), **cfa)


def preview(frame: Frame, mosaic_dev, params: EditParams, flags: dict,
            zoom=1.0, pan=(0.0, 0.0)):
    """The session's preview, (h, w, 3) u8 on the mosaic's device."""
    h, w = frame.mosaic.shape
    pw, ph = _sampling.preview_shape(w, h, flags["max_preview_width"])
    fn = _dv.develop_xtrans_preview if frame.pattern else _dv.develop_preview
    return fn(mosaic_dev, params, frame.wb,
              frame.cam(flags["mode"], flags["color_space"]), pw, ph,
              **_view(frame, params, flags, zoom, pan))


def preview_planes(rgb):
    """(Y, Cb, Cr) u8 4:2:0 planes of an even preview, as the session's
    ``frame`` hands them to the JPEG encoder."""
    return tuple(p.cpu().numpy() for p in _jpeg.rgb_u8_to_ycbcr420(rgb))


def histogram(frame: Frame, mosaic_dev, params: EditParams, flags: dict,
              zoom=1.0, pan=(0.0, 0.0)) -> np.ndarray:
    """(3, 256) counts of the session's ``histogram`` reply."""
    h, w = frame.mosaic.shape
    hw, hh = _sampling.histogram_shape(w, h, flags["histogram_width"])
    fn = (_dv.develop_xtrans_histogram if frame.pattern
          else _dv.develop_histogram)
    return fn(mosaic_dev, params, frame.wb,
              frame.cam(flags["mode"], flags["color_space"]), hw, hh,
              **_view(frame, params, flags, zoom, pan)).cpu().numpy()


def bin_shift(got, want) -> int:
    """The fewest bins each sample must be allowed to move for the
    (3, 256) counts ``got`` to be ``want``'s (256 when their totals
    differ): the least T with want's cumulative counts at k - T <= got's
    at k <= want's at k + T for every bin k and channel."""
    got = np.cumsum(np.asarray(got, np.int64), axis=1)
    want = np.cumsum(np.asarray(want, np.int64), axis=1)
    if not np.array_equal(got[:, -1], want[:, -1]):
        return 256
    for t in range(256):
        lo = np.pad(want, ((0, 0), (t, 0)))[:, :256]
        hi = np.pad(want[:, t:], ((0, 0), (0, t)), mode="edge")
        if ((lo <= got) & (got <= hi)).all():
            return t
    return 256
