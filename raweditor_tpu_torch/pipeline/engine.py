"""The interactive develop engine for one decoded Bayer or X-Trans frame.

The PyTorch counterpart of the JAX package's ``DevelopEngine``: the u16
mosaic stays on the device, and the slider tick (a sampled preview plus
the live histogram), the full-resolution develop and the export are
launches over it. ``mode="parity"`` reproduces the reference editor
(identity matrix, /4096, the WGSL matrix transpose); ``mode="accurate"``
uses the camera matrix, the real levels and the CFA phase.

``demosaic_method`` (the JAX name) picks the full-resolution Bayer
demosaic: ``"nearest"`` (the parity stencil), ``"bilinear"``,
``"malvar"`` or ``"grad"``, in either mode. The preview and histogram
keep the nearest-sampled stencil, as in the JAX engine.

A frame whose ``cfa_pattern`` has 36 letters (the 6x6 X-Trans grid) is
developed in accurate mode through the generic-CFA path
(``xtrans_pattern`` is set; parity mode ignores the pattern, as the JAX
engine does): the preview and histogram sample the nearest-site stencil
(``develop_xtrans_preview``), and the full-resolution develop runs the
tier ``generic_cfa_method(demosaic_method)``: nearest, ``"smooth"``
(also what bilinear and malvar map to) or grad. ``"smooth"`` is a
generic-CFA tier only; on a Bayer frame it raises ``ValueError``.

``use_kernel`` is the JAX engine's ``use_pallas`` (the CLI's ``--fast``):
the full-resolution develop and the JPEG planes come from the fused CUDA
kernels (``ops/fused_develop.py``, within 1 LSB of the plain lane), which
take ``demosaic_method`` as their ``demosaic``: nearest, bilinear and
Malvar run ``csrc/develop.cu``, grad ``csrc/develop_grad.cu``; on an
X-Trans frame nearest and smooth run the generic-CFA kernel of
``csrc/develop.cu`` and grad ``csrc/develop_grad_generic.cu`` (all three
tiers take the kernel; the JAX engine keeps nearest and smooth on its
XLA lane for reasons of TPU speed that do not carry over). With a
CUDA device the kernel runs or the call raises; nothing demotes to
another lane. Without ``use_kernel`` the plain lane (``ops/develop.py``
with ``ops/demosaic.py`` or ``ops/cfa_generic.py``) renders the same
method.

Accurate mode uploads the mosaic with its per-CFA-site black levels
folded out (``RawImage.fold_site_blacks``), as the JAX engine does.

Finish extras (sharpen, denoise, the 4-region tone curve, vignette, the
HSL mixer, colour grading) and the point curve render on every entry
point, routed as the JAX engine routes them:

- the slider tick, ``preview`` and ``histogram`` run them in the plain
  chain on the sampled grid (``extras=params.finish_extras_mode()``);
- the full-resolution develop writes RGBA words, then the finish-extras
  post-pass runs over them: with ``use_kernel`` the B8 kernel
  (``ops/fused_extras.fused_finish_extras_rgba``; with a CUDA device it
  runs or the call raises), else its plain version
  (``finish_extras_plain``). ``full_device``/``full`` unpack those
  words; ``jpeg_planes`` and JPEG export take the kernel's 4:2:0 planes;
- a point curve routes the develop to the plain lane even with
  ``use_kernel`` (the develop kernels never compute it, as in the JAX
  engine); the extras post-pass after it is still the kernel.

``DevelopEngine.open(path, mode, **kwargs)`` decodes a RAW file
(``raw/decode.decode_raw``) and builds the engine on it; ``device`` and
the other keywords go to the constructor, so it runs on the card unless
the caller asks for the CPU.

Not ported yet: LinearRaw frames, CFA
patterns other than the four Bayer phases and 36-letter grids, clarity, dehaze, grain, local adjustments, highlight recovery
(each raises ``NotImplementedError`` naming it), wide-gamut output, the
pipelined tick, tiers, TIFF16 and geometry in exports.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from raweditor_tpu_torch.color import cam_to_srgb_matrix, kernel_gamma_for
from raweditor_tpu_torch.ops import develop as _develop
from raweditor_tpu_torch.ops import fused_develop as _fused
from raweditor_tpu_torch.ops import fused_extras as _fx
from raweditor_tpu_torch.ops import jpeg as _jpeg
from raweditor_tpu_torch.ops.cfa_generic import generic_cfa_method, is_xtrans
from raweditor_tpu_torch.ops.demosaic import (CFA_PHASES, DEMOSAIC_METHODS,
                                              phase_of)
from raweditor_tpu_torch.ops.sampling import histogram_shape, preview_shape
from raweditor_tpu_torch.params import EditParams
from raweditor_tpu_torch.pipeline.export import (_atomic_write,
                                                 _refuse_geometry)
from raweditor_tpu_torch.raw.types import RawImage
from raweditor_tpu_torch.utils.device import resolve_device

MAX_PREVIEW_WIDTH = 1280
HISTOGRAM_WIDTH = 128


class DevelopEngine:
    """Device-resident develop session for a decoded RawImage."""

    def __init__(self, raw: RawImage, mode: str = "parity",
                 use_kernel: bool = False, fast_gamma: bool = False,
                 transfer: str = "gamma22", device="cuda",
                 max_preview_width: int = MAX_PREVIEW_WIDTH,
                 histogram_width: int = HISTOGRAM_WIDTH,
                 demosaic_method: str = "nearest",
                 auto_orient: bool = False):
        if mode not in ("parity", "accurate"):
            raise ValueError(f"unknown mode {mode!r}")
        if demosaic_method not in DEMOSAIC_METHODS + ("smooth",):
            raise ValueError(f"unknown demosaic method {demosaic_method!r}")
        if raw.is_linear:
            raise NotImplementedError("not ported yet: LinearRaw frames")
        self.device = resolve_device(device)
        self.mode = mode
        self.use_kernel = use_kernel
        self.demosaic_method = demosaic_method
        # Exports rotate the pixels by the frame's TIFF orientation and
        # tag them upright; otherwise they stay as stored and carry the
        # orientation tag.
        self.auto_orient = auto_orient
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
        # Per-CFA-site black levels are folded out here, so the develop
        # keeps one scalar black level.
        mosaic = np.ascontiguousarray(
            raw.fold_site_blacks() if mode == "accurate" else raw.mosaic,
            dtype=np.uint16)
        if not mosaic.flags.writeable:  # a decoder's view of file bytes
            mosaic = mosaic.copy()
        self.mosaic = torch.from_numpy(mosaic).to(self.device)
        self.wb = raw.wb_rgb()
        self.cam_matrix = cam_to_srgb_matrix(raw.xyz_to_cam, mode=mode)
        self.matrix_transpose = mode == "parity"
        self.xtrans_pattern = None  # set for 6x6 CFAs in accurate mode
        if mode == "parity":
            self.white_level, self.black_level = 4096.0, 0.0
            self.cfa_phase = (0, 0)
        else:
            self.white_level = float(raw.white_level)
            self.black_level = float(raw.black_level)
            if is_xtrans(raw.cfa_pattern):
                self.xtrans_pattern = raw.cfa_pattern
                self.cfa_phase = (0, 0)
            elif raw.cfa_pattern.upper() in CFA_PHASES:
                self.cfa_phase = phase_of(raw.cfa_pattern)
            else:
                raise NotImplementedError(
                    f"not ported yet: CFA pattern {raw.cfa_pattern!r} "
                    "(neither a 2x2 Bayer phase nor a 36-letter grid)")
        if demosaic_method == "smooth" and self.xtrans_pattern is None:
            raise ValueError("'smooth' is the generic-CFA tier; Bayer uses "
                             "bilinear/malvar/grad")

    # -- slider tick -----------------------------------------------------
    def _view_kwargs(self, params, zoom, pan):
        """The sampled render's keywords: the pattern for an X-Trans
        frame (``develop_xtrans_preview``), else the Bayer phase."""
        cfa = (dict(cfa_phase=self.cfa_phase) if self.xtrans_pattern is None
               else dict(pattern=self.xtrans_pattern))
        return dict(zoom=float(zoom), pan_x=float(pan[0]),
                    pan_y=float(pan[1]), white_level=self.white_level,
                    black_level=self.black_level,
                    matrix_transpose=self.matrix_transpose,
                    transfer=self.transfer,
                    extras=params.finish_extras_mode(), **cfa)

    def preview_device(self, params: EditParams, zoom: float = 1.0,
                       pan: Tuple[float, float] = (0.0, 0.0)):
        """(preview_h, preview_w, 3) u8 preview, left on the device."""
        preview = (_develop.develop_preview if self.xtrans_pattern is None
                   else _develop.develop_xtrans_preview)
        return preview(self.mosaic, params, self.wb, self.cam_matrix,
                       self.preview_w, self.preview_h,
                       **self._view_kwargs(params, zoom, pan))

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
        histogram = (_develop.develop_histogram
                     if self.xtrans_pattern is None
                     else _develop.develop_xtrans_histogram)
        return histogram(self.mosaic, params, self.wb, self.cam_matrix,
                         self.histogram_w, self.histogram_h,
                         **self._view_kwargs(params, zoom, pan)).cpu().numpy()

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
        return self._encode_planes(planes, w, h, quality), w, h

    # -- full resolution -------------------------------------------------
    def scalars(self, params: EditParams) -> torch.Tensor:
        """(24,) folded scalars of ``params`` on the device."""
        return _fused.fold_scalars(
            params, self.wb, self.cam_matrix, self.white_level,
            self.black_level, self.matrix_transpose).to(self.device)

    def _kernel_demosaic(self):
        """``demosaic=`` and ``pattern=`` of the fused kernels."""
        if self.xtrans_pattern is None:
            return dict(demosaic=self.demosaic_method)
        return dict(demosaic=generic_cfa_method(self.demosaic_method),
                    pattern=self.xtrans_pattern)

    def _plain_develop(self, params: EditParams, rgba: bool):
        """The plain lane's full-resolution develop: (H, W) u32 words
        with ``rgba``, else (H, W, 3) u8."""
        levels = dict(white_level=self.white_level,
                      black_level=self.black_level,
                      matrix_transpose=self.matrix_transpose,
                      transfer=self.transfer)
        if self.xtrans_pattern is not None:
            return _develop.develop_xtrans(
                self.mosaic, params, self.wb, self.cam_matrix,
                pattern=self.xtrans_pattern, rgba=rgba,
                demosaic_method=generic_cfa_method(self.demosaic_method),
                **levels)
        develop = _develop.develop_rgba if rgba else _develop.develop
        return develop(self.mosaic, params, self.wb, self.cam_matrix,
                       demosaic_method=self.demosaic_method,
                       cfa_phase=self.cfa_phase, **levels)

    def _develop_words(self, params: EditParams):
        """The develop before the extras post-pass, (H, W) u32 words: the
        fused kernel with ``use_kernel``, else the plain lane. A point
        curve takes the plain lane (which applies it) even with
        ``use_kernel``: the develop kernels never compute it."""
        _develop.require_ported(params)
        if self.use_kernel and not params.point_curve:
            return _fused.fused_develop_rgba(
                self.mosaic, self.scalars(params), self.cfa_phase,
                kernel_gamma_for(self.transfer), **self._kernel_demosaic())
        return self._plain_develop(params, rgba=True)

    def _extras_post(self, words, params: EditParams, output: str = "rgba"):
        """The finish-extras post-pass over developed words (the JAX
        engine's ``_maybe_extras_post``): the B8 kernel with
        ``use_kernel`` (its plain version for a CPU tensor), else
        ``finish_extras_plain``; words pass unchanged when no extra is
        on. ``output="ycbcr420"`` (``use_kernel`` only) returns the
        Y, Cb, Cr planes."""
        table, mixer_on, grading_on, stencils = _fx.pack_extras([params])
        flags = dict(mixer_on=mixer_on, grading_on=grading_on,
                     stencils=stencils)
        if self.use_kernel:
            out = _fx.fused_finish_extras_rgba(
                words, table[0].to(self.device), output=output, **flags)
            return out if output == "rgba" else (
                out[0], out[1][:, 0::2], out[1][:, 1::2])
        return _fx.finish_extras_plain(words[None], table.to(self.device),
                                       **flags)[0]

    def full_rgba_device(self, params: EditParams):
        """Full-resolution develop to (H, W) u32 packed RGBA on the
        device: the develop (``_develop_words``), then the finish-extras
        post-pass when the edit has extras."""
        words = self._develop_words(params)
        if not params.finish_extras_mode():
            return words
        return self._extras_post(words, params)

    def full_device(self, params: EditParams):
        """Full-resolution (H, W, 3) u8 develop on the device: the plain
        lane, or with extras the unpacked words of
        ``full_rgba_device`` (the post-pass semantics of every export)."""
        if params.finish_extras_mode():
            return torch.stack([c.to(torch.uint8) for c in _develop.unpack_rgba(
                self.full_rgba_device(params))], dim=-1)
        return self._plain_develop(params, rgba=False)

    def full(self, params: EditParams) -> np.ndarray:
        return self.full_device(params).cpu().numpy()

    def jpeg_planes(self, params: EditParams):
        """Full-resolution JPEG 4:2:0 planes (Y (H, W), Cb and Cr
        (H/2, W/2), u8, on the device) for even frames. With
        ``use_kernel`` they come straight from a kernel: the finish-extras
        kernel after the develop when the edit has extras, else the
        develop kernel (a point curve without extras converts the plain
        lane's words). Without ``use_kernel``, from the plain lane's
        RGBA words."""
        if self.height % 2 or self.width % 2:
            raise ValueError("ycbcr420 requires even dimensions")
        if not self.use_kernel:
            return _jpeg.rgba_words_to_ycbcr420(self.full_rgba_device(params))
        if params.finish_extras_mode():
            return self._extras_post(self._develop_words(params), params,
                                     "ycbcr420")
        if params.point_curve:
            return _jpeg.rgba_words_to_ycbcr420(self._develop_words(params))
        _develop.require_ported(params)
        y, cbcr = _fused.fused_batch_develop_rgba(
            self.mosaic[None], self.scalars(params)[None], self.cfa_phase,
            kernel_gamma_for(self.transfer), output="ycbcr420",
            **self._kernel_demosaic())
        return y[0], cbcr[0, :, 0::2], cbcr[0, :, 1::2]

    # -- export ----------------------------------------------------------
    @staticmethod
    def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
        """Apply a TIFF orientation (1/3/6/8 rotations; the mirrored
        values 2/4/5/7 flip) to an (H, W[, C]) host array."""
        if orientation == 2:
            return img[:, ::-1]
        if orientation == 3:
            return img[::-1, ::-1]
        if orientation == 4:
            return img[::-1]
        if orientation == 5:
            return np.rot90(img, k=-1)[:, ::-1]
        if orientation == 6:
            return np.rot90(img, k=-1)
        if orientation == 7:
            return np.rot90(img, k=1)[:, ::-1]
        if orientation == 8:
            return np.rot90(img, k=1)
        return img

    def _exif_bytes(self) -> bytes:
        """Export metadata: camera make and model and the orientation tag
        (1 when ``auto_orient`` has rotated the pixels, else the stored
        orientation, so that viewers rotate)."""
        from raweditor_tpu_torch.raw.exif import build_exif

        orientation = 1 if self.auto_orient else self.raw.orientation
        return build_exif(self.raw.camera_make, self.raw.camera_model,
                          orientation)

    @staticmethod
    def _encode_planes(planes, w: int, h: int, quality: int,
                       optimize: bool = False, chroma: str = "420",
                       restart_rows: int = 0) -> bytes:
        """JFIF bytes of (Y, Cb, Cr) u8 planes through ``_rawkit``:
        4:2:0 planes, or full-size chroma for ``chroma="444"``."""
        from raweditor_tpu_torch.native import require_rawkit

        rk = require_rawkit()
        encode = rk.encode_jpeg_444 if chroma == "444" else rk.encode_jpeg_420
        y, cb, cr = (np.ascontiguousarray(p.cpu().numpy()) for p in planes)
        # threads=0: the restart segments spread over every host core
        # (byte-identical for any count); without restart markers the
        # stream is one segment, coded on one thread.
        return encode(y, cb, cr, w, h, int(quality), bool(optimize),
                      max(0, int(restart_rows)), 0)

    @staticmethod
    def _pil_jpeg(rgb: np.ndarray, quality: int, exif: bytes = b"",
                  optimize: bool = False, chroma: str = "420",
                  restart_rows: int = 0) -> bytes:
        """JFIF bytes of an (H, W, 3) u8 frame through PIL, with the
        native encoder's flags: 4:4:4 (``subsampling=0``), restart
        markers every ``restart_rows`` MCU rows, optimised tables."""
        import io

        from PIL import Image

        kw = {"subsampling": 0} if chroma == "444" else {}
        if restart_rows > 0:
            kw["restart_marker_rows"] = int(restart_rows)
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="JPEG", quality=int(quality),
                                  exif=exif, optimize=bool(optimize), **kw)
        return buf.getvalue()

    def export(self, path: os.PathLike, params: EditParams,
               quality: int = 95, long_edge: int = None,
               jpeg_optimize: bool = False, chroma: str = "420",
               jpeg_restart_rows: int = 0, rotate: float = 0.0, crop=None,
               lens=None, perspective=None) -> str:
        """Full-resolution develop written as JPEG (``.jpg``/``.jpeg``) or
        RGBA PNG (``.png``, PIL), atomically; returns the path. Every file
        carries the EXIF block of ``_exif_bytes``.

        A JPEG goes through device YCbCr planes and the native encoder:
        4:2:0 planes of even frames (``jpeg_planes``), or with
        ``chroma="444"`` full-size chroma of any frame
        (``rgba_words_to_ycbcr444`` over ``full_rgba_device``). Odd 4:2:0
        frames and frames that ``auto_orient`` rotates go through PIL with
        the same flags. ``jpeg_restart_rows`` > 0 writes DRI/RSTn restart
        markers every that many MCU rows; ``jpeg_optimize`` writes
        optimised Huffman tables. ``long_edge``, ``rotate``, ``crop``,
        ``lens``, ``perspective`` and 16-bit TIFF are not ported yet and
        raise ``NotImplementedError`` naming themselves."""
        path = os.fspath(path)
        if chroma not in ("420", "444"):
            raise ValueError(f"chroma must be '420' or '444', got {chroma!r}")
        _refuse_geometry(long_edge, rotate, crop, lens, perspective)
        ext = os.path.splitext(path)[1].lower()
        if ext in (".tif", ".tiff"):
            raise NotImplementedError("not ported yet: 16-bit TIFF export")
        if ext not in (".jpg", ".jpeg", ".png"):
            raise ValueError(
                f"unsupported export extension {ext!r} (use .jpg/.jpeg/.png)")
        rotates = self.auto_orient and self.raw.orientation != 1
        exif = self._exif_bytes()
        flags = dict(optimize=jpeg_optimize, chroma=chroma,
                     restart_rows=jpeg_restart_rows)
        even = self.height % 2 == 0 and self.width % 2 == 0
        if ext != ".png" and not rotates and (chroma == "444" or even):
            from raweditor_tpu_torch.raw.exif import splice_exif

            planes = (_jpeg.rgba_words_to_ycbcr444(
                self.full_rgba_device(params)) if chroma == "444"
                else self.jpeg_planes(params))
            data = splice_exif(self._encode_planes(
                planes, self.width, self.height, quality, **flags), exif)
        else:
            words = np.ascontiguousarray(_develop.rgba_view(
                self.full_rgba_device(params)))
            if rotates:
                words = np.ascontiguousarray(
                    self.apply_orientation(words, self.raw.orientation))
            if ext == ".png":
                import io

                from PIL import Image

                buf = io.BytesIO()
                Image.fromarray(words).save(buf, format="PNG", exif=exif)
                data = buf.getvalue()
            else:
                data = self._pil_jpeg(
                    np.ascontiguousarray(words[..., :3]), quality, exif,
                    **flags)

        def write(tmp_path):
            with open(tmp_path, "wb") as f:
                f.write(data)

        _atomic_write(path, write)
        return path

    # -- convenience -----------------------------------------------------
    @classmethod
    def open(cls, path: os.PathLike, mode: str = "parity",
             **kwargs) -> "DevelopEngine":
        """Decode the RAW file at ``path`` and build an engine on it;
        ``kwargs`` (``device``, ``use_kernel``, ``demosaic_method``, ...)
        go to the constructor."""
        from raweditor_tpu_torch.raw.decode import decode_raw

        return cls(decode_raw(path), mode=mode, **kwargs)
