"""Interactive develop session for one decoded Bayer frame.

The PyTorch counterpart of the JAX package's ``DevelopEngine``: the u16
mosaic stays on the device, and the slider tick (a sampled preview plus
the live histogram), the full-resolution develop and the export are
launches over it. ``mode="parity"`` reproduces the reference editor
(identity matrix, /4096, the WGSL matrix transpose); ``mode="accurate"``
uses the camera matrix, the real levels and the CFA phase.

``use_kernel`` is the JAX engine's ``use_pallas`` (the CLI's ``--fast``):
the full-resolution develop and the JPEG planes come from the fused CUDA
kernel (``ops/fused_develop.py``, within 1 LSB of the parity lane). With
a CUDA device the kernel runs or the call raises; nothing demotes to
another lane.

Not ported yet: ``open(path)`` (RAW decode), X-Trans and LinearRaw
frames, non-nearest demosaic, finish extras, local adjustments, point
curves, highlight recovery, the pipelined tick, tiers, TIFF16, geometry
and EXIF metadata in exports.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from raweditor_tpu_torch.color import cam_to_srgb_matrix, kernel_gamma_for
from raweditor_tpu_torch.ops import develop as _develop
from raweditor_tpu_torch.ops import fused_develop as _fused
from raweditor_tpu_torch.ops import jpeg as _jpeg
from raweditor_tpu_torch.ops.demosaic import CFA_PHASES, phase_of
from raweditor_tpu_torch.ops.sampling import histogram_shape, preview_shape
from raweditor_tpu_torch.params import EditParams
from raweditor_tpu_torch.raw.types import RawImage
from raweditor_tpu_torch.utils.device import resolve_device

MAX_PREVIEW_WIDTH = 1280
HISTOGRAM_WIDTH = 128


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class DevelopEngine:
    """Device-resident develop session for a decoded RawImage."""

    def __init__(self, raw: RawImage, mode: str = "parity",
                 use_kernel: bool = False, fast_gamma: bool = False,
                 transfer: str = "gamma22", device="cuda",
                 max_preview_width: int = MAX_PREVIEW_WIDTH,
                 histogram_width: int = HISTOGRAM_WIDTH):
        if mode not in ("parity", "accurate"):
            raise ValueError(f"unknown mode {mode!r}")
        if raw.is_linear:
            raise NotImplementedError("not ported yet: LinearRaw frames")
        self.device = resolve_device(device)
        self.mode = mode
        self.use_kernel = use_kernel
        # The fast transfers: a polynomial in place of the pow, within
        # 1 LSB after u8 quantisation.
        if fast_gamma and transfer == "gamma22":
            transfer = "gamma22_poly"
        elif fast_gamma and transfer == "srgb":
            transfer = "srgb_poly"
        kernel_gamma_for(transfer)  # validates the name
        self.transfer = transfer
        self.raw = raw
        self.width, self.height = raw.width, raw.height
        self.preview_w, self.preview_h = preview_shape(
            raw.width, raw.height, max_preview_width)
        self.histogram_w, self.histogram_h = histogram_shape(
            raw.width, raw.height, histogram_width)
        self.mosaic = torch.from_numpy(
            np.ascontiguousarray(raw.mosaic, dtype=np.uint16)).to(self.device)
        self.wb = raw.wb_rgb()
        self.cam_matrix = cam_to_srgb_matrix(raw.xyz_to_cam, mode=mode)
        self.matrix_transpose = mode == "parity"
        if mode == "parity":
            self.white_level, self.black_level = 4096.0, 0.0
            self.cfa_phase = (0, 0)
        else:
            self.white_level = float(raw.white_level)
            self.black_level = float(raw.black_level)
            if raw.cfa_pattern.upper() not in CFA_PHASES:
                raise NotImplementedError(
                    f"not ported yet: CFA pattern {raw.cfa_pattern!r}")
            self.cfa_phase = phase_of(raw.cfa_pattern)

    # -- slider tick -----------------------------------------------------
    def _view_kwargs(self, zoom, pan):
        return dict(zoom=float(zoom), pan_x=float(pan[0]),
                    pan_y=float(pan[1]), white_level=self.white_level,
                    black_level=self.black_level,
                    matrix_transpose=self.matrix_transpose,
                    transfer=self.transfer, cfa_phase=self.cfa_phase)

    def preview_device(self, params: EditParams, zoom: float = 1.0,
                       pan: Tuple[float, float] = (0.0, 0.0)):
        """(preview_h, preview_w, 3) u8 preview, left on the device."""
        return _develop.develop_preview(
            self.mosaic, params, self.wb, self.cam_matrix,
            self.preview_w, self.preview_h, **self._view_kwargs(zoom, pan))

    def preview_tick(self, params: EditParams, zoom: float = 1.0,
                     pan: Tuple[float, float] = (0.0, 0.0)):
        """The slider hot path: the device preview, returned once the
        device has finished it (a CUDA event recorded after the launches
        and waited on)."""
        out = self.preview_device(params, zoom, pan)
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        return out

    def preview(self, params: EditParams, zoom: float = 1.0,
                pan: Tuple[float, float] = (0.0, 0.0)) -> np.ndarray:
        """(preview_h, preview_w, 3) u8 on the host."""
        return self.preview_device(params, zoom, pan).cpu().numpy()

    def histogram(self, params: EditParams, zoom: float = 1.0,
                  pan: Tuple[float, float] = (0.0, 0.0)) -> np.ndarray:
        """(3, 256) int32 live histogram of a histogram_w-wide render."""
        return _develop.develop_histogram(
            self.mosaic, params, self.wb, self.cam_matrix,
            self.histogram_w, self.histogram_h,
            **self._view_kwargs(zoom, pan)).cpu().numpy()

    def preview_jpeg(self, params: EditParams, zoom: float = 1.0,
                     pan: Tuple[float, float] = (0.0, 0.0),
                     quality: int = 80) -> Tuple[bytes, int, int]:
        """The preview as JFIF bytes: (data, width, height). Even
        previews convert to 4:2:0 planes on the device and go through
        the native encoder."""
        dev = self.preview_device(params, zoom, pan)
        h, w = int(dev.shape[0]), int(dev.shape[1])
        if h % 2 or w % 2:
            return self._pil_jpeg(dev.cpu().numpy(), quality), w, h
        planes = _jpeg.rgb_u8_to_ycbcr420(dev)
        return self._encode_420(planes, w, h, quality), w, h

    # -- full resolution -------------------------------------------------
    def scalars(self, params: EditParams) -> torch.Tensor:
        """(24,) folded scalars of ``params`` on the device."""
        return _fused.fold_scalars(
            params, self.wb, self.cam_matrix, self.white_level,
            self.black_level, self.matrix_transpose).to(self.device)

    def full_rgba_device(self, params: EditParams):
        """Full-resolution develop to (H, W) u32 packed RGBA on the
        device: the fused kernel with ``use_kernel``, else the parity
        lane."""
        if self.use_kernel:
            _develop.require_ported(params)
            return _fused.fused_develop_rgba(
                self.mosaic, self.scalars(params), self.cfa_phase,
                kernel_gamma_for(self.transfer))
        return _develop.develop_rgba(
            self.mosaic, params, self.wb, self.cam_matrix,
            white_level=self.white_level, black_level=self.black_level,
            matrix_transpose=self.matrix_transpose, transfer=self.transfer,
            cfa_phase=self.cfa_phase)

    def full_device(self, params: EditParams):
        """Full-resolution (H, W, 3) u8 develop on the device (the parity
        lane)."""
        return _develop.develop(
            self.mosaic, params, self.wb, self.cam_matrix,
            white_level=self.white_level, black_level=self.black_level,
            matrix_transpose=self.matrix_transpose, transfer=self.transfer,
            cfa_phase=self.cfa_phase)

    def full(self, params: EditParams) -> np.ndarray:
        return self.full_device(params).cpu().numpy()

    def jpeg_planes(self, params: EditParams):
        """Full-resolution JPEG 4:2:0 planes (Y (H, W), Cb and Cr
        (H/2, W/2), u8, on the device) for even frames. With
        ``use_kernel`` they come straight from the fused kernel, else
        from the parity lane's RGBA words."""
        if self.height % 2 or self.width % 2:
            raise ValueError("ycbcr420 requires even dimensions")
        if not self.use_kernel:
            return _jpeg.rgba_words_to_ycbcr420(self.full_rgba_device(params))
        _develop.require_ported(params)
        y, cbcr = _fused.fused_batch_develop_rgba(
            self.mosaic[None], self.scalars(params)[None], self.cfa_phase,
            kernel_gamma_for(self.transfer), output="ycbcr420")
        return y[0], cbcr[0, :, 0::2], cbcr[0, :, 1::2]

    # -- export ----------------------------------------------------------
    @staticmethod
    def _encode_420(planes, w: int, h: int, quality: int) -> bytes:
        from raweditor_tpu_torch.native import get_rawkit

        y, cb, cr = (np.ascontiguousarray(p.cpu().numpy()) for p in planes)
        # optimize=False, restart_rows=0, threads=0 (all host cores).
        return get_rawkit().encode_jpeg_420(y, cb, cr, w, h, int(quality),
                                            False, 0, 0)

    @staticmethod
    def _pil_jpeg(rgb: np.ndarray, quality: int) -> bytes:
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="JPEG", quality=int(quality))
        return buf.getvalue()

    def export(self, path: os.PathLike, params: EditParams,
               quality: int = 95) -> str:
        """Full-resolution develop written as JPEG (``.jpg``/``.jpeg``,
        4:2:0 planes and the native encoder; odd frames through PIL) or
        PNG (``.png``, PIL). Written atomically; returns the path."""
        path = os.fspath(path)
        ext = os.path.splitext(path)[1].lower()
        if ext in (".tif", ".tiff"):
            raise NotImplementedError("not ported yet: 16-bit TIFF export")
        if ext not in (".jpg", ".jpeg", ".png"):
            raise ValueError(
                f"unsupported export extension {ext!r} (use .jpg/.jpeg/.png)")
        if ext != ".png" and self.height % 2 == 0 and self.width % 2 == 0:
            data = self._encode_420(self.jpeg_planes(params), self.width,
                                    self.height, quality)
        else:
            import io

            from PIL import Image

            rgb = np.ascontiguousarray(
                _develop.rgba_view(self.full_rgba_device(params))[..., :3])
            if ext == ".png":
                buf = io.BytesIO()
                Image.fromarray(rgb).save(buf, format="PNG")
                data = buf.getvalue()
            else:
                data = self._pil_jpeg(rgb, quality)
        _atomic_write(path, data)
        return path
