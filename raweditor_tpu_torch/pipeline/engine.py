"""The interactive develop engine for one decoded Bayer, X-Trans or
LinearRaw frame.

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
the caller asks for the CPU (``device="cpu"``, or with no device named
``RAWEDITOR_TPU_PLATFORM=cpu``: ``utils/device.default_device``).

The interactive session (``pipeline/session.py``) drives the slider in
the JAX engine's latest-wins pipelined mode: ``preview_tick_pipelined``
dispatches the preview and records a CUDA event after it, a background
syncer waits on the newest event (a stream runs in order, so that proves
every earlier tick too) and publishes its frame; ``flush_pipeline``
waits for the tail, ``newest_pipelined_frame`` reads the newest proven
frame and ``preview_jpeg(frame=...)`` encodes it. ``pick_wb`` is the
white-balance eyedropper, ``before_after`` the before/after toggle, and
``ctor_kwargs`` the as-constructed keywords a sibling engine is built
from.

``color_space`` picks the output space: "srgb", or in accurate mode the
wide gamuts "display-p3" and "adobe-rgb" (``color.cam_to_output_matrix``;
parity raises ``ValueError``). A wide space mandates its transfer (sRGB's
for P3, the 563/256 power for Adobe RGB), ``fast_gamma`` then applies,
and every export embeds the space's ICC profile (``icc.py``): a JPEG APP2
segment, PNG ``iCCP``, TIFF tag 34675. The develop kernels have no lane
for the Adobe transfer, so with ``use_kernel`` an Adobe RGB develop takes
the plain lane (a route chosen by the transfer, as for a point curve);
extras still run B8 over its words.

A non-zero ``highlight_recovery`` reconstructs the clipped sites of the
mosaic (``ops/highlights.py``, plain torch on the device) before every
render: the preview, histogram, full develop, JPEG planes and TIFF take
``_render_mosaic(params)``, which keeps the last reconstruction per amount.
The white-balance eyedropper reads the original mosaic.

``export`` writes 16-bit RGB TIFF for ``.tif``/``.tiff``
(``export_tiff16``: the plain lane's ``develop_u16`` or
``develop_xtrans(bits=16)`` with the exact transfer, then the copied
``raw/tiff_out.write_tiff16``).

A LinearRaw frame (DNG photometric 34892, an (H, W, 3) u16 frame that is
already demosaiced; ``self.linear``) develops through the plain lane's
``develop_linear``, ``develop_linear_preview`` and
``develop_linear_histogram`` on every entry point, with or without
``use_kernel`` (no develop kernel runs: the JAX engine develops it in XLA
too); with extras its words take the finish-extras post-pass, B8 with
``use_kernel``. Recovery reconstructs it with
``ops/highlights.reconstruct_linear_highlights``. In accurate mode a
pattern that is neither a Bayer phase nor a 36-letter grid raises the
JAX engine's ``ValueError`` (``ops/demosaic.phase_of``).

``export`` and ``export_tiff16`` take the output geometry (``rotate``,
``crop``, ``lens``, ``perspective``: ``ops/geometry.py``) and
``long_edge`` (``ops/resize.py``, Lanczos3, never upscales), in that
order, on the developed RGBA words (or 16-bit frame) on the device; a
JPEG then converts the shaped words to YCbCr planes on the device, and an
odd 4:2:0 output goes through PIL. ``develop_tiers`` resizes the
full-resolution develop to the preview tiers on the device.

Not ported yet: clarity, dehaze, grain and local adjustments (each
raises ``NotImplementedError`` naming it).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from raweditor_tpu_torch.color import (COLOR_SPACES, TRANSFER_BY_SPACE,
                                       cam_to_output_matrix, kernel_gamma_for,
                                       transfer16_for)
from raweditor_tpu_torch.ops import develop as _develop
from raweditor_tpu_torch.ops import fused_develop as _fused
from raweditor_tpu_torch.ops import fused_extras as _fx
from raweditor_tpu_torch.ops import geometry as _geometry
from raweditor_tpu_torch.ops import jpeg as _jpeg
from raweditor_tpu_torch.ops import resize as _resize
from raweditor_tpu_torch.ops.demosaic import DEMOSAIC_METHODS
from raweditor_tpu_torch.ops.sampling import histogram_shape, preview_shape
from raweditor_tpu_torch.params import EditParams
from raweditor_tpu_torch.pipeline.frame import classify, kernel_route
from raweditor_tpu_torch.raw.types import RawImage
from raweditor_tpu_torch.utils.device import resolve_device
from raweditor_tpu_torch.utils.shared import _atomic_write, _record_event
from raweditor_tpu_torch.utils.timing import StageTimer

MAX_PREVIEW_WIDTH = 1280
HISTOGRAM_WIDTH = 128


class DevelopEngine:
    """Device-resident develop session for a decoded RawImage."""

    def __init__(self, raw: RawImage, mode: str = "parity",
                 use_kernel: bool = False, fast_gamma: bool = False,
                 transfer: str = "gamma22", device=None,
                 max_preview_width: int = MAX_PREVIEW_WIDTH,
                 histogram_width: int = HISTOGRAM_WIDTH,
                 demosaic_method: str = "nearest",
                 auto_orient: bool = False, color_space: str = "srgb"):
        # The as-constructed keywords (``device`` as passed, not
        # resolved), so a sibling engine for another image is built the
        # same way and two engines built alike compare equal
        # (``DevelopSession.open`` and its prefetch slot).
        self.ctor_kwargs = dict(
            mode=mode, max_preview_width=max_preview_width,
            histogram_width=histogram_width, use_kernel=use_kernel,
            fast_gamma=fast_gamma, demosaic_method=demosaic_method,
            transfer=transfer, auto_orient=auto_orient,
            color_space=color_space, device=device)
        if mode not in ("parity", "accurate"):
            raise ValueError(f"unknown mode {mode!r}")
        color_space = (color_space or "srgb").lower()
        if color_space not in COLOR_SPACES:
            raise ValueError(f"unknown color space {color_space!r}; "
                             f"expected one of {COLOR_SPACES}")
        self.color_space = color_space
        # A wide space mandates its transfer; fast_gamma applies after.
        transfer = TRANSFER_BY_SPACE.get(color_space, transfer)
        if demosaic_method not in DEMOSAIC_METHODS + ("smooth",):
            raise ValueError(f"unknown demosaic method {demosaic_method!r}")
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
        self.cam_matrix = cam_to_output_matrix(raw.xyz_to_cam, mode=mode,
                                               color_space=color_space)
        self.matrix_transpose = mode == "parity"
        # The frame's kind (pipeline/frame.py), kept also as the JAX
        # engine's three attributes.
        self.kind, self.white_level, self.black_level = classify(raw, mode)
        self.cfa_phase = self.kind.cfa_phase
        self.xtrans_pattern = self.kind.xtrans_pattern
        self.linear = self.kind.linear
        if (demosaic_method == "smooth" and self.xtrans_pattern is None
                and not self.linear):
            raise ValueError("'smooth' is the generic-CFA tier; Bayer uses "
                             "bilinear/malvar/grad")
        # State of the pipelined slider mode's background syncer
        # (preview_tick_pipelined), created at its first tick.
        self._pipe = None
        # (amount, device mosaic) of the last highlight reconstruction
        # (_render_mosaic): a drag redoes it only when the amount moves.
        self._hl_cache = None

    def _render_mosaic(self, params: EditParams):
        """The mosaic the renders develop: the device mosaic, or with a
        non-zero ``highlight_recovery`` the reconstructed one (same shape
        and dtype), cached per amount. Clipping is detected at the
        mode's levels, the ones the develop normalises by (and the
        exporter reconstructs at), so engine and exporter agree."""
        amt = float(params.highlight_recovery)
        if amt == 0.0:
            return self.mosaic
        if self._hl_cache is not None and self._hl_cache[0] == amt:
            return self._hl_cache[1]
        from raweditor_tpu_torch.ops import highlights as _hl

        if self.linear:
            m = _hl.reconstruct_linear_highlights(
                self.mosaic, self.wb, amt, self.white_level, self.black_level)
        else:
            m = _hl.reconstruct_mosaic_highlights(
                self.mosaic, self.wb, amt, self.white_level,
                self.black_level, cfa_phase=self.cfa_phase,
                xtrans_pattern=self.xtrans_pattern)
        self._hl_cache = (amt, m)
        return m

    # -- slider tick -----------------------------------------------------
    def _view_kwargs(self, params, zoom, pan):
        """The sampled render's keywords: the pattern for an X-Trans
        frame (``develop_xtrans_preview``), none for a LinearRaw frame,
        else the Bayer phase."""
        cfa = ({} if self.linear
               else dict(cfa_phase=self.cfa_phase)
               if self.xtrans_pattern is None
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
        preview = (_develop.develop_linear_preview if self.linear
                   else _develop.develop_preview
                   if self.xtrans_pattern is None
                   else _develop.develop_xtrans_preview)
        return preview(self._render_mosaic(params), params, self.wb,
                       self.cam_matrix, self.preview_w, self.preview_h,
                       **self._view_kwargs(params, zoom, pan))

    def preview_tick(self, params: EditParams, zoom: float = 1.0,
                     pan: Tuple[float, float] = (0.0, 0.0)):
        """The slider hot path: the device preview, returned once the
        device has finished it (a CUDA event recorded after the launches
        and waited on)."""
        out = self.preview_device(params, zoom, pan)
        done = _record_event(self.device)
        if done is not None:
            done.synchronize()
        return out

    def preview_tick_pipelined(self, params: EditParams, zoom: float = 1.0,
                               pan: Tuple[float, float] = (0.0, 0.0),
                               depth: int = 2):
        """Steady-state slider mode: dispatch this tick and return the
        newest proven frame without waiting for the device.

        The preview is launched on the caller's current stream and a CUDA
        event recorded after it; the (frame, event) pair replaces the
        pending one, and the background syncer waits on the newest
        pending event outside the lock (latest wins: a stream runs in
        order, so that event proves every earlier tick too, whose frames
        are skipped). A CPU tensor is complete when it returns; the
        syncer retires it at once. Edits with extras or a point curve
        pipeline the same way.

        Returns the newest proven device frame, or None while nothing is
        proven yet (always None on the first tick after a start).
        ``depth`` is kept for the JAX signature: latest-wins bounds the
        syncs in flight at one."""
        frame = self.preview_device(params, zoom, pan)
        done = _record_event(self.device)
        st = self._pipe_state()
        with st["lock"]:
            st["pending"] = (frame, done)
            st["seq"] += 1
            st["wake"].notify_all()
            return st["completed"]

    def _pipe_state(self):
        """The background syncer's state, starting the syncer at the
        first call."""
        st = self._pipe
        if st is not None:
            return st
        import threading

        lock = threading.Lock()
        st = {
            "lock": lock,
            "wake": threading.Condition(lock),
            "idle": threading.Condition(lock),
            "pending": None,    # newest dispatched (frame, event), unsynced
            "completed": None,  # newest proven frame
            "seq": 0,           # dispatch counter
            "synced_seq": 0,    # seq the syncer has proven through
            "stop": False,
        }

        def syncer():
            while True:
                with st["lock"]:
                    while st["pending"] is None and not st["stop"]:
                        st["wake"].wait()
                    if st["stop"]:
                        return
                    item, seq = st["pending"], st["seq"]
                    st["pending"] = None
                # Wait outside the lock: ticks keep landing (and
                # superseding) while this one syncs.
                err = None
                try:
                    if item[1] is not None:
                        item[1].synchronize()
                except Exception as e:  # noqa: BLE001 - re-raised by
                    # flush_pipeline; a dead syncer would leave every
                    # later fetch waiting for synced_seq forever
                    err = e
                with st["lock"]:
                    if err is None:
                        st["completed"] = item[0]
                    else:
                        st["error"] = err
                    # Advance even on failure: flush raises the recorded
                    # error instead of hanging.
                    st["synced_seq"] = max(st["synced_seq"], seq)
                    st["idle"].notify_all()

        t = threading.Thread(target=syncer, daemon=True,
                             name="raweditor-pipe-sync")
        st["thread"] = t
        self._pipe = st
        t.start()
        return st

    def flush_pipeline(self):
        """Wait until every pipelined tick dispatched so far is proven
        and return the newest proven frame (None if the pipeline was
        never used). A failed sync is re-raised here as ``RuntimeError``,
        once; the syncer keeps running."""
        st = self._pipe
        if st is None:
            return None
        with st["lock"]:
            while st["synced_seq"] < st["seq"]:
                st["idle"].wait()
            err = st.pop("error", None)
            if err is not None:
                raise RuntimeError("pipelined preview sync failed") from err
            return st["completed"]

    def close_pipeline(self):
        """Stop the background syncer after proving the tail. Safe to
        call repeatedly; the next pipelined tick starts it again. A
        failed tail sync does not prevent the shutdown."""
        st = self._pipe
        if st is None:
            return
        try:
            self.flush_pipeline()
        except RuntimeError:
            pass  # the sync's error; the thread still stops
        with st["lock"]:
            st["stop"] = True
            st["wake"].notify_all()
        st["thread"].join(timeout=10.0)
        self._pipe = None

    def newest_pipelined_frame(self):
        """The newest proven device frame of the pipelined mode, or None
        (pipeline unused or nothing proven yet). Waits for nothing: the
        syncer proved it already; it lags the newest tick."""
        st = self._pipe
        if st is None:
            return None
        with st["lock"]:
            return st["completed"]

    def preview(self, params: EditParams, zoom: float = 1.0,
                pan: Tuple[float, float] = (0.0, 0.0)) -> np.ndarray:
        """(preview_h, preview_w, 3) u8 on the host."""
        return self.preview_device(params, zoom, pan).cpu().numpy()

    def histogram(self, params: EditParams, zoom: float = 1.0,
                  pan: Tuple[float, float] = (0.0, 0.0)) -> np.ndarray:
        """(3, 256) int32 live histogram of a histogram_w-wide render."""
        histogram = (_develop.develop_linear_histogram if self.linear
                     else _develop.develop_histogram
                     if self.xtrans_pattern is None
                     else _develop.develop_xtrans_histogram)
        return histogram(self._render_mosaic(params), params, self.wb,
                         self.cam_matrix, self.histogram_w, self.histogram_h,
                         **self._view_kwargs(params, zoom, pan)).cpu().numpy()

    def pick_wb(self, x: float, y: float,
                radius: float = 0.02) -> Tuple[float, float]:
        """White-balance eyedropper: the (temperature, tint) slider values
        that neutralise the patch at frame-normalised ``(x, y)`` (0-1 of
        the full sensor), in the chain's own model: post-WB channel means
        (r, g, b) of the patch through the temperature/tint gains
        r(1+0.3t), b(1-0.3t), g(1+0.3u), solving r' = b' for t, then
        g' = r' for u, each clamped to -1..1:

            t = (b - r) / (0.3 (r + b))
            u = ((1 + 0.3t) r / g - 1) / 0.3

        Only the mosaic window comes to the host. Channel means are per
        CFA site (the Bayer phase, or the X-Trans grid's channel map) or,
        on a LinearRaw frame, per channel plane, black-subtracted, times
        the camera WB gains. Raises
        ``ValueError`` for a point outside the frame and for a patch
        that misses a channel, is clipped or is black."""
        h, w = self.height, self.width
        if not (0.0 <= x <= 1.0 and 0.0 <= y <= 1.0):
            raise ValueError("pick point must be inside 0..1")
        r_px = max(2, int(radius * max(h, w)))
        cy, cx = int(y * (h - 1)), int(x * (w - 1))
        y0, y1 = max(0, cy - r_px), min(h, cy + r_px + 1)
        x0, x1 = max(0, cx - r_px), min(w, cx + r_px + 1)
        win = self.mosaic[y0:y1, x0:x1].cpu().numpy().astype(np.float32)
        black = float(self.black_level)
        white = float(self.white_level)
        lin = np.clip(win - black, 0.0, None) / max(white - black, 1.0)
        if self.linear:
            means = [float(lin[..., c].mean()) for c in range(3)]
        else:
            means = self._site_means(lin, y0, y1, x0, x1)
        if max(means) >= 0.98:
            raise ValueError("patch is clipped - pick a dimmer neutral")
        if max(means) <= 1e-4:
            raise ValueError("patch is black - pick a brighter neutral")
        wbv = np.asarray(self.wb, np.float32)
        r, g, b = (means[0] * float(wbv[0]), means[1] * float(wbv[1]),
                   means[2] * float(wbv[2]))
        t = (b - r) / (0.3 * max(r + b, 1e-6))
        t = float(np.clip(t, -1.0, 1.0))
        u = ((1.0 + 0.3 * t) * r / max(g, 1e-6) - 1.0) / 0.3
        u = float(np.clip(u, -1.0, 1.0))
        return t, u

    def _site_means(self, lin, y0, y1, x0, x1):
        """Per-channel means of a mosaic window over its CFA sites."""
        yy, xx = np.mgrid[y0:y1, x0:x1]
        if self.xtrans_pattern is not None:
            from raweditor_tpu_torch.ops.cfa_generic import channel_grid

            idx = channel_grid(self.xtrans_pattern)[yy % 6, xx % 6]
            masks = [idx == c for c in range(3)]
        else:
            py, px = self.cfa_phase
            ye = ((yy + py) % 2) == 0
            xe = ((xx + px) % 2) == 0
            is_r = ye & xe
            is_b = (~ye) & (~xe)
            masks = [is_r, ~(is_r | is_b), is_b]
        means = []
        for msk in masks:
            if not msk.any():
                raise ValueError("patch too small for this CFA - pick "
                                 "elsewhere or enlarge radius")
            means.append(float(lin[msk].mean()))
        return means

    def before_after(self, params: EditParams, zoom: float = 1.0,
                     pan: Tuple[float, float] = (0.0, 0.0)):
        """(before, after) host previews: default params, then
        ``params``."""
        return (self.preview(EditParams(), zoom, pan),
                self.preview(params, zoom, pan))

    def preview_jpeg(self, params: EditParams, zoom: float = 1.0,
                     pan: Tuple[float, float] = (0.0, 0.0),
                     quality: int = 80,
                     frame=None, stages=None) -> Tuple[bytes, int, int]:
        """The preview as JFIF bytes: (data, width, height). Even
        previews convert to 4:2:0 planes on the device and go through
        the native encoder (which must be present); odd ones go through
        PIL. ``frame`` is an already-proven device preview (the session's
        ``frame latest``) to encode in place of a new render. ``stages``
        (a ``utils.timing.StageTimer``, the session's) times the render,
        the fetch of the planes and the encode as ``frame.render``,
        ``frame.fetch`` and ``frame.encode``."""
        rec = stages or StageTimer()
        with rec.span("frame.render"):
            dev = (frame if frame is not None
                   else self.preview_device(params, zoom, pan))
            h, w = int(dev.shape[0]), int(dev.shape[1])
            odd = bool(h % 2 or w % 2)
            planes = dev if odd else _jpeg.rgb_u8_to_ycbcr420(dev)
        with rec.span("frame.fetch"):
            host = (planes.cpu().numpy() if odd
                    else tuple(p.cpu() for p in planes))
        with rec.span("frame.encode"):
            if odd:
                return self._pil_jpeg(host, quality), w, h
            return self._encode_planes(host, w, h, quality), w, h

    # -- full resolution -------------------------------------------------
    def scalars(self, params: EditParams) -> torch.Tensor:
        """(24,) folded scalars of ``params`` on the device."""
        return _fused.fold_scalars(
            params, self.wb, self.cam_matrix, self.white_level,
            self.black_level, self.matrix_transpose).to(self.device)

    def _kernel_demosaic(self):
        """``demosaic=`` and ``pattern=`` of the fused kernels."""
        return dict(demosaic=self.kind.demosaic(self.demosaic_method),
                    pattern=self.xtrans_pattern)

    def _plain_develop(self, params: EditParams, rgba: bool):
        """The plain lane's full-resolution develop: (H, W) u32 words
        with ``rgba``, else (H, W, 3) u8."""
        levels = dict(white_level=self.white_level,
                      black_level=self.black_level,
                      matrix_transpose=self.matrix_transpose,
                      transfer=self.transfer)
        if self.linear:
            return _develop.develop_linear(
                self._render_mosaic(params), params, self.wb,
                self.cam_matrix, rgba=rgba, **levels)
        if self.xtrans_pattern is not None:
            return _develop.develop_xtrans(
                self._render_mosaic(params), params, self.wb,
                self.cam_matrix, pattern=self.xtrans_pattern, rgba=rgba,
                demosaic_method=self.kind.demosaic(self.demosaic_method),
                **levels)
        develop = _develop.develop_rgba if rgba else _develop.develop
        return develop(self._render_mosaic(params), params, self.wb,
                       self.cam_matrix, demosaic_method=self.demosaic_method,
                       cfa_phase=self.cfa_phase, **levels)

    def _kernel_route(self, params: EditParams) -> bool:
        """Whether the develop runs a fused kernel
        (``pipeline/frame.kernel_route``)."""
        return kernel_route(self.use_kernel, self.kind, self.transfer,
                            params)

    def _develop_words(self, params: EditParams):
        """The develop before the extras post-pass, (H, W) u32 words: the
        fused kernel on its route (``_kernel_route``), else the plain
        lane."""
        _develop.require_ported(params)
        if self._kernel_route(params):
            return _fused.fused_develop_rgba(
                self._render_mosaic(params), self.scalars(params),
                self.cfa_phase, kernel_gamma_for(self.transfer),
                **self._kernel_demosaic())
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
        develop kernel (a point curve or the Adobe RGB transfer without
        extras converts the plain lane's words). Without ``use_kernel``,
        from the plain lane's RGBA words."""
        if self.height % 2 or self.width % 2:
            raise ValueError("ycbcr420 requires even dimensions")
        if not self.use_kernel:
            return _jpeg.rgba_words_to_ycbcr420(self.full_rgba_device(params))
        if params.finish_extras_mode():
            return self._extras_post(self._develop_words(params), params,
                                     "ycbcr420")
        if not self._kernel_route(params):
            return _jpeg.rgba_words_to_ycbcr420(self._develop_words(params))
        _develop.require_ported(params)
        y, cbcr = _fused.fused_batch_develop_rgba(
            self._render_mosaic(params)[None], self.scalars(params)[None],
            self.cfa_phase,
            kernel_gamma_for(self.transfer), output="ycbcr420",
            **self._kernel_demosaic())
        return y[0], cbcr[0, :, 0::2], cbcr[0, :, 1::2]

    # -- export ----------------------------------------------------------
    def _icc_bytes(self):
        """The ICC profile an export embeds: None for sRGB (consumers
        assume it, and the sRGB export bytes stay as they were), else
        ``icc.profile_bytes`` of the output space."""
        if self.color_space == "srgb":
            return None
        from raweditor_tpu_torch.icc import profile_bytes

        return profile_bytes(self.color_space)

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
                  restart_rows: int = 0, icc: bytes = None) -> bytes:
        """JFIF bytes of an (H, W, 3) u8 frame through PIL, with the
        native encoder's flags: 4:4:4 (``subsampling=0``), restart
        markers every ``restart_rows`` MCU rows, optimised tables, and
        the ``icc`` profile when given."""
        import io

        from PIL import Image

        kw = {"subsampling": 0} if chroma == "444" else {}
        if restart_rows > 0:
            kw["restart_marker_rows"] = int(restart_rows)
        if icc:
            kw["icc_profile"] = icc
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="JPEG", quality=int(quality),
                                  exif=exif, optimize=bool(optimize), **kw)
        return buf.getvalue()

    def _guard_geometry(self, rotate, crop) -> None:
        """Geometry applies in the stored sensor frame: with
        ``auto_orient`` on a rotated shot a rotation or a rectangle would
        land on the wrong part of the upright picture, so it raises
        ``ValueError`` (the JAX engine's rule)."""
        if ((rotate or crop is not None) and self.auto_orient
                and self.raw.orientation != 1):
            raise ValueError(
                "rotate/crop with auto_orient on a rotated shot "
                f"(orientation {self.raw.orientation}) is not "
                "supported: geometry applies in the stored sensor "
                "frame - disable auto_orient or crop in stored "
                "coordinates")

    def export(self, path: os.PathLike, params: EditParams,
               quality: int = 95, long_edge: int = None,
               jpeg_optimize: bool = False, chroma: str = "420",
               jpeg_restart_rows: int = 0, rotate: float = 0.0, crop=None,
               lens=None, perspective=None) -> str:
        """Full-resolution develop written as JPEG (``.jpg``/``.jpeg``),
        RGBA PNG (``.png``, PIL) or 16-bit RGB TIFF (``.tif``/``.tiff``,
        ``export_tiff16``), atomically; returns the path. Every JPEG and
        PNG carries the EXIF block of ``_exif_bytes``, and a wide-gamut
        export its ICC profile (``_icc_bytes``).

        ``rotate`` (degrees, clockwise on screen), ``crop`` ((left, top,
        width, height), or None for the largest upright rectangle of the
        source aspect), ``lens`` ((k1, k2, ca_r, ca_b)) and
        ``perspective`` ((kv, kh)) reshape the developed RGBA words on the
        device, in the stored sensor frame, and ``long_edge`` then resizes
        them (Lanczos3, never upscaling): ``ops/geometry.shape_output``.
        A rotation or
        crop with ``auto_orient`` on a rotated shot raises ``ValueError``.

        A JPEG goes through device YCbCr planes and the native encoder:
        4:2:0 planes of even frames (``jpeg_planes`` when nothing reshapes
        the frame, else the shaped words converted on the device), or
        with ``chroma="444"`` full-size chroma of any frame
        (``rgba_words_to_ycbcr444``). Odd 4:2:0 outputs and frames that
        ``auto_orient`` rotates go through PIL with the same flags.
        ``jpeg_restart_rows`` > 0 writes DRI/RSTn restart markers every
        that many MCU rows; ``jpeg_optimize`` writes optimised Huffman
        tables."""
        path = os.fspath(path)
        if chroma not in ("420", "444"):
            raise ValueError(f"chroma must be '420' or '444', got {chroma!r}")
        self._guard_geometry(rotate, crop)
        lens = _geometry._resolve_lens(lens)
        ext = os.path.splitext(path)[1].lower()
        if ext not in (".tif", ".tiff", ".jpg", ".jpeg", ".png"):
            raise ValueError(f"unsupported export extension {ext!r} "
                             "(use .jpg/.jpeg/.png/.tif/.tiff)")
        if ext in (".tif", ".tiff"):
            return self.export_tiff16(path, params, long_edge=long_edge,
                                      rotate=rotate, crop=crop, lens=lens,
                                      perspective=perspective)
        rotates = self.auto_orient and self.raw.orientation != 1
        exif = self._exif_bytes()
        icc = self._icc_bytes()
        flags = dict(optimize=jpeg_optimize, chroma=chroma,
                     restart_rows=jpeg_restart_rows)
        words_dev = None
        out_h, out_w = self.height, self.width
        if _geometry.reshapes((out_h, out_w), long_edge, rotate, crop, lens,
                              perspective):
            words_dev = _geometry.shape_output(
                self.full_rgba_device(params), "words", long_edge, rotate,
                crop, lens, perspective)
            out_h, out_w = words_dev.shape
        even = out_h % 2 == 0 and out_w % 2 == 0
        if ext != ".png" and not rotates and (chroma == "444" or even):
            from raweditor_tpu_torch.raw.exif import splice_exif

            if words_dev is not None:
                planes = (_jpeg.rgba_words_to_ycbcr444(words_dev)
                          if chroma == "444"
                          else _jpeg.rgba_words_to_ycbcr420(words_dev))
            elif chroma == "444":
                planes = _jpeg.rgba_words_to_ycbcr444(
                    self.full_rgba_device(params))
            else:
                planes = self.jpeg_planes(params)
            data = splice_exif(self._encode_planes(
                planes, out_w, out_h, quality, **flags), exif)
            if icc:
                from raweditor_tpu_torch.icc import splice_icc_jpeg

                data = splice_icc_jpeg(data, icc)
        else:
            if words_dev is None:
                words_dev = self.full_rgba_device(params)
            words = np.ascontiguousarray(_develop.rgba_view(words_dev))
            if rotates:
                words = np.ascontiguousarray(
                    self.apply_orientation(words, self.raw.orientation))
            if ext == ".png":
                import io

                from PIL import Image

                buf = io.BytesIO()
                ikw = {"icc_profile": icc} if icc else {}
                Image.fromarray(words).save(buf, format="PNG", exif=exif,
                                            **ikw)
                data = buf.getvalue()
            else:
                data = self._pil_jpeg(
                    np.ascontiguousarray(words[..., :3]), quality, exif,
                    icc=icc, **flags)

        def write(tmp_path):
            with open(tmp_path, "wb") as f:
                f.write(data)

        _atomic_write(path, write)
        return path

    def export_tiff16(self, path: os.PathLike, params: EditParams,
                      long_edge: int = None, rotate: float = 0.0, crop=None,
                      lens=None, perspective=None) -> str:
        """Full-resolution develop at 16 bits a channel to an uncompressed
        RGB TIFF (the copied ``raw/tiff_out.write_tiff16``), atomically,
        with make, model, the orientation tag (1 when ``auto_orient``
        rotated the pixels), the software tag and the ICC profile of a
        wide space; returns the path. The develop is the plain lane with
        the exact transfer (``transfer16_for``) and the extras in the
        chain, as the JAX engine's; the geometry and ``long_edge`` then
        reshape the 16-bit frame on the device
        (``ops/geometry.shape_output``)."""
        from raweditor_tpu_torch.raw.exif import SOFTWARE
        from raweditor_tpu_torch.raw.tiff_out import write_tiff16

        self._guard_geometry(rotate, crop)
        _develop.require_ported(params)
        levels = dict(white_level=self.white_level,
                      black_level=self.black_level,
                      matrix_transpose=self.matrix_transpose,
                      transfer=transfer16_for(self.transfer),
                      extras=params.finish_extras_mode())
        mosaic = self._render_mosaic(params)
        if self.linear:
            rgb = _develop.develop_linear(
                mosaic, params, self.wb, self.cam_matrix, bits=16, **levels)
        elif self.xtrans_pattern is not None:
            rgb = _develop.develop_xtrans(
                mosaic, params, self.wb, self.cam_matrix,
                pattern=self.xtrans_pattern, bits=16,
                demosaic_method=self.kind.demosaic(self.demosaic_method),
                **levels)
        else:
            rgb = _develop.develop_u16(
                mosaic, params, self.wb, self.cam_matrix,
                demosaic_method=self.demosaic_method,
                cfa_phase=self.cfa_phase, **levels)
        rgb = _geometry.shape_output(rgb, "u16", long_edge, rotate, crop,
                                     lens, perspective).cpu().numpy()
        if self.auto_orient and self.raw.orientation != 1:
            rgb = np.ascontiguousarray(
                self.apply_orientation(rgb, self.raw.orientation))
        path = os.fspath(path)
        _atomic_write(path, lambda tmp: write_tiff16(
            tmp, np.ascontiguousarray(rgb), make=self.raw.camera_make,
            model=self.raw.camera_model,
            orientation=1 if self.auto_orient else self.raw.orientation,
            software=SOFTWARE, icc=self._icc_bytes()))
        return path

    def develop_tiers(self, params: EditParams, widths=(256, 384, 1280)):
        """Preview tiers of the developed image (``full_device``), resized
        on the device (Lanczos3, ``ops/resize.develop_tiers``): host
        (h, w, 3) u8 arrays, one per width."""
        return [t.cpu().numpy()
                for t in _resize.develop_tiers(self.full_device(params),
                                               widths)]

    # -- convenience -----------------------------------------------------
    @classmethod
    def open(cls, path: os.PathLike, mode: str = "parity",
             **kwargs) -> "DevelopEngine":
        """Decode the RAW file at ``path`` and build an engine on it;
        ``kwargs`` (``device``, ``use_kernel``, ``demosaic_method``, ...)
        go to the constructor."""
        from raweditor_tpu_torch.raw.decode import decode_raw

        return cls(decode_raw(path), mode=mode, **kwargs)
