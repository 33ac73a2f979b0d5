"""Batch export on one card: RAW files to developed JPEG, PNG or 16-bit
TIFF files.

The PyTorch port of the JAX package's ``pipeline/export.py`` on its
single-device route (``mesh=None``)::

    decode pool ──▶ staging ──▶ shape buckets ──▶ one develop per ──▶ fetch ──▶ encode
    (host threads,  (bit-packed, (up to batch_size flush: the fused    thread   pool
     raw/decode)     pinned, own  images, launched batch kernel, B8             (_rawkit
                     CUDA stream) at their length) after it for extras)         or PIL)

- Decode workers run ahead of the card through a bounded window. Each
  mosaic is bit-packed on the host (``ops/staging.py``: 12-bit at 1.5
  bytes a pixel, 14-bit at 1.75) and handed to one upload thread, which
  copies it into pinned memory and on to the card with ``non_blocking``
  on a CUDA stream of its own and records an event. The flush makes the
  compute stream wait on that event, then fills the (n, H, W) u16 batch
  from the staged buffers in one launch of the staging kernel
  (``ops/staging.unpack_into_batch``).
  The staged bytes are held under the call's budget (``_StageBudget``
  of ``_STAGE_BUDGET`` bytes); over it, a mosaic uploads at flush time
  instead.
- Mosaics are bucketed by shape, CFA kind (``pipeline/frame.FrameKind``),
  extras, locals structure and point-curve length (``_Batcher``). A
  bucket flushes when it holds ``batch_size`` images, and at the end of
  the call with what it holds; every flush is staged, developed and
  fetched at its own length n (the kernels take the batch from the
  mosaics' first dimension), so no slot is developed for an image that
  is never written.
- Each flush launches one develop. With ``use_kernel`` and no point
  curve in the bucket (``pipeline/frame.kernel_route``, the engine's
  rule too) it is the fused batch kernel
  (``ops/fused_develop.fused_batch_develop_rgba``, B1-B7), which emits
  JPEG 4:2:0 planes for an all-JPEG run of even frames without extras,
  else RGBA words. A bucket with finish extras then runs the
  finish-extras kernel over the words (``ops/fused_extras``, B8), to
  planes or words, with or without ``use_kernel``, as the JAX exporter
  does. Without ``use_kernel``, or for a point-curve bucket, the develop
  is the plain lane (``parallel/batch.py``). Unlike the JAX exporter,
  X-Trans nearest and smooth buckets take their kernels too (B5, B6):
  the JAX exporter keeps them on XLA for reasons of TPU speed that do not
  carry over, and the port's engine routes them the same way.
  ``chroma="444"`` converts the words to full-size planes on the card.
  The kernels have no lane for the Adobe RGB transfer: such a run takes
  the plain lane (a route by transfer, as the JAX exporter's
  ``pallas_ok``), and its extras still run B8.
- LinearRaw files (DNG photometric 34892, (H, W, 3) u16 frames already
  demosaiced) form buckets of their own (``FrameKind(linear=True)``, the
  JAX ``"__linear__"`` key) and stage unpacked. With ``use_kernel``, a
  transfer the kernels compute and no point curve in the bucket, a flush
  develops in one launch of the LinearRaw kernel
  (``ops/fused_linear.fused_batch_develop_linear``), to planes or words
  as the fused kernel above, bit for bit the plain lane's output; else
  through the plain lane's ``parallel/batch.batch_develop_linear_rgba``
  (the JAX exporter runs XLA there). Their extras take the B8 post-pass
  like any other bucket's.
- A flush with any non-zero ``highlight_recovery`` first reconstructs
  the clipped sites of its stacked mosaics
  (``ops/highlights.batch_reconstruct_mosaic``, or
  ``batch_reconstruct_linear`` for LinearRaw frames; per-image amounts; a
  zero-amount image passes through bit-exactly), before any develop.
- ``rotate``, ``crop``, ``lens`` and ``perspective`` (the same geometry
  for every image, ``ops/geometry.py``) and a ``long_edge`` below a
  bucket's longer side (``ops/resize.py``) force RGBA words out of the
  develop (and out of B8); the geometry then shapes each image on the
  card, and one banded resize shapes the flush
  (``ops/fused_resize.py``: a kernel on the card, which hands an
  all-JPEG run's even output straight to 4:2:0 planes; 16-bit frames
  take ``ops/geometry.shape_output`` image by image), and an all-JPEG
  run converts any shaped words to YCbCr planes on the card, so every
  file equals the engine's export.
- ``color_space`` "display-p3" or "adobe-rgb" (accurate mode) develops
  into the wide space with its mandated transfer
  (``color.cam_to_output_matrix``) and every encoder embeds its ICC
  profile (``icc.py``).
- ``bits=16`` develops each flush through the 16-bit plain lane
  (``parallel/batch.batch_develop_u16``, exact transfer, extras in the
  chain) and writes uncompressed RGB TIFFs (``_encode_one_tiff16``).
- A fetch thread waits on an event recorded after the flush's launches
  (not on a device-wide sync, which would also wait for the next flush's
  upload) and copies the batch to the host on a stream of its own; an
  encode pool writes the files:
  ``_rawkit``'s JFIF encoder for planes, PIL for RGBA PNG and odd 4:2:0
  JPEG. All launches stay on the calling thread. An all-JPEG run
  requires the native encoder before it reads a file; it never hands
  words to PIL in place of the planes.
- Each call is one ``_ExportRun``, whose methods are the stages below.
- Each call records its stages in one ``utils/timing.StageTimer``: spans
  on the threads that do the work (``decode``, ``stage.pack``,
  ``upload``, ``fetch.wait``, ``fetch.copy``, ``encode``; on the calling
  thread ``export.wait_decode``, ``export.flush`` with its
  ``export.wait_upload``, ``export.stage`` and ``export.launch`` (and
  in the launch ``export.develop``, the develop call on its route, and
  for a shaped flush ``export.shape``, the output stage and the
  conversion of its words to planes),
  ``export.wait_fetch``, ``export.hand_off``, ``export.wait_encode``,
  ``export.trim``), the queue waits ``queue.batch`` (decode end to the
  image's flush) and ``queue.encode`` (fetch end to the encode), and
  counters of bytes moved through pinned and pageable memory, of batch
  slots developed (one an image) and of those a flush short of
  ``batch_size`` left unfilled (``slots.unfilled``: what a fixed-shape
  launch would have developed and no kernel touches), of the slots the
  staging kernel unpacked from packed bytes and copied from u16 samples
  and of those uploaded at flush straight into the batch, of the slots
  the extras kernel ran over against the images that asked for extras,
  and of the slots each develop route ran over
  (``develop.slots.<route>``: the kernel's demosaic and output, as
  ``grad.planes`` or ``cfa_grad.rgba``, or the plain lane's ``plain``
  and ``linear``; one counter a route that ran, summing to the slots
  developed; of the ``cfa_grad`` slots, those on the X-Trans grad
  kernel's period-6 march also as ``cfa_grad.period6_slots``, and of
  the ``linear`` slots, those the LinearRaw kernel developed also as
  ``linear.kernel_slots``; of a shaped flush, its images and their
  pixels before and after the output stage as ``shape.images``,
  ``shape.in_pixels`` and ``shape.out_pixels``, and the images the
  resize kernel resized as ``resize.kernel_images``).
  ``ExportReport``'s seconds are reads of those spans, and
  ``report.stages`` holds them all (the CLI's one report line). The
  span log, each span with its thread, image id, flush number and
  parent on ``torch.profiler``'s clock, is kept with
  ``trace_spans=True`` or while a profiler is open (the CLI's ``export
  --trace-out``); the calling thread's waits then also enter
  ``record_function`` ranges, so a profiler trace names what the host
  was waiting on. ``LAST_REPORT`` holds the newest finished
  call's ``as_dict()``.
- One bad file fails its own job (``report.failed``, ``"decode: ..."``;
  a CFA pattern that is neither a Bayer phase nor a 36-letter grid among
  them). A develop that raises fails its batch (``"develop: ..."``; an
  invalid lens, keystone or crop among them, as in the JAX exporter): a
  kernel that fails to build or launch is never routed around, and no
  later flush avoids it. A failed encode fails its image
  (``"encode: ..."``).

Not ported yet, each refused with ``NotImplementedError`` naming itself
before any file is read: ``mesh``, and any job whose edit has clarity,
dehaze, grain or local adjustments.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raweditor_tpu_torch.color import (COLOR_SPACES,
                                       KERNEL_GAMMA_BY_TRANSFER,
                                       TRANSFER_BY_SPACE,
                                       cam_to_output_matrix, encoder_for,
                                       kernel_gamma_for, transfer16_for)
from raweditor_tpu_torch.ops import fused_develop as _fused
from raweditor_tpu_torch.ops import fused_extras as _fx
from raweditor_tpu_torch.ops import fused_linear as _linear
from raweditor_tpu_torch.ops import fused_resize as _fused_resize
from raweditor_tpu_torch.ops import geometry as _geometry
from raweditor_tpu_torch.ops import jpeg as _jpeg
from raweditor_tpu_torch.ops import resize as _resize
from raweditor_tpu_torch.params import EditParams
from raweditor_tpu_torch.parallel.batch import (
    batch_develop_linear_rgba,
    batch_develop_rgba,
    batch_develop_u16,
    batch_develop_xtrans_rgba,
    pack_extras,
    pack_params,
)
from raweditor_tpu_torch.pipeline.frame import (FrameKind, classify,
                                                kernel_route)
from raweditor_tpu_torch.utils.shared import (_atomic_write, _on,
                                              _record_event)
from raweditor_tpu_torch.utils.timing import StageTimer


# The newest finished ``run_batch_export`` call's ``ExportReport.
# as_dict()``, or None before the first.
LAST_REPORT: Optional[dict] = None

# The counters every call reports, 0 where nothing was counted.
COUNTERS = ("transfer.pinned_bytes", "transfer.pageable_bytes",
            "slots.developed", "slots.unfilled", "extras.slots",
            "extras.asked", "staging.slots_unpacked", "staging.slots_copied",
            "staging.slots_uploaded")


@dataclasses.dataclass
class ExportJob:
    raw_path: str
    out_path: str
    params: EditParams = dataclasses.field(default_factory=EditParams)
    image_id: Optional[int] = None


@dataclasses.dataclass
class ExportReport:
    total: int = 0
    succeeded: int = 0
    skipped: int = 0
    failed: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    seconds: float = 0.0
    # Sum of per-image codec+metadata time on the decode workers (can
    # exceed wall clock with several threads: it is the host-CPU
    # budget, not a wall split; the ``decode`` spans). decode_megapixels
    # is the matching numerator for a per-codec MP/s.
    decode_seconds: float = 0.0
    decode_megapixels: float = 0.0
    # Host staging work split out of decode: the bit-pack and the hand-off
    # to the upload thread, on the decode workers (``stage.pack``).
    stage_seconds: float = 0.0
    # The fetch thread's wait on the event recorded after each flush's
    # launches (``fetch.wait``): what the card still had to do when the
    # fetch thread reached the batch, the batch's uploads included.
    device_seconds: float = 0.0
    # The calling thread's waits on its encode pool (``export.wait_encode``).
    encode_seconds: float = 0.0
    # Device-to-host copy of the developed batches (``fetch.copy``).
    fetch_seconds: float = 0.0
    fetch_bytes: int = 0
    # Host-to-device staging: the bytes uploaded, and the host's wait for
    # the upload thread plus the flush-time fill of the batch (0 when the
    # uploads overlapped the decode; ``export.wait_upload`` and
    # ``export.stage``).
    upload_seconds: float = 0.0
    upload_bytes: int = 0
    # Every span's total and count and every counter of the call
    # (``StageTimer.report()``), and the recorder itself, whose ``log``
    # holds the spans when the call kept them.
    stages: dict = dataclasses.field(default_factory=dict)
    timer: Optional[StageTimer] = dataclasses.field(default=None,
                                                    repr=False)

    @property
    def develops_per_sec(self) -> float:
        return self.succeeded / self.seconds if self.seconds > 0 else 0.0

    @property
    def fetch_mbps(self) -> float:
        return (self.fetch_bytes / 1e6 / self.fetch_seconds
                if self.fetch_seconds > 0 else 0.0)

    @property
    def decode_mps(self) -> float:
        """Per-codec decode rate in MP/s per worker-second."""
        return (self.decode_megapixels / self.decode_seconds
                if self.decode_seconds > 0 else 0.0)

    def as_dict(self) -> dict:
        return {
            "total": self.total,
            "succeeded": self.succeeded,
            "skipped": self.skipped,
            "failed": len(self.failed),
            "seconds": round(self.seconds, 3),
            "develops_per_sec": round(self.develops_per_sec, 2),
            "decode_seconds": round(self.decode_seconds, 3),
            "decode_mps": round(self.decode_mps, 1),
            "stage_seconds": round(self.stage_seconds, 3),
            "device_seconds": round(self.device_seconds, 3),
            "fetch_seconds": round(self.fetch_seconds, 3),
            "fetch_mb": round(self.fetch_bytes / 1e6, 1),
            "fetch_mbps": round(self.fetch_mbps, 1),
            "upload_seconds": round(self.upload_seconds, 3),
            "upload_mb": round(self.upload_bytes / 1e6, 1),
            "encode_seconds": round(self.encode_seconds, 3),
            "stages": self.stages,
        }



@dataclasses.dataclass
class _Decoded:
    job: ExportJob
    mosaic: np.ndarray
    wb: np.ndarray
    cam_matrix: np.ndarray
    white_level: float
    black_level: float
    # The frame's CFA kind (pipeline/frame.py), part of the bucket key.
    kind: FrameKind
    # Staging started from the decode worker (a Future of the upload
    # thread's ``(tensor, event, pinned)``), so the upload overlaps the
    # next file's decode. 12- and 14-bit mosaics stage bit-packed
    # (ops/staging.py) and unpack on the card at flush.
    staged: object = None
    staged_fmt: str = "raw"  # "raw" | "u12" | "u14"
    staged_nbytes: int = 0
    # The image's id in the call's spans, and the end of its decode
    # (``perf_counter_ns``), where its wait for a full batch begins.
    image: object = None
    decoded_ns: int = 0
    # Export metadata (raw/exif.py): camera provenance and the stored
    # orientation tag, so viewers rotate the output.
    make: str = ""
    model: str = ""
    orientation: int = 1


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``, copied when numpy cannot lend it (a
    decoder's read-only view of file bytes, a strided view)."""
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr)


# The upload thread's pinned buffers: packed bytes, or a u16 mosaic's
# int16 view.
_PINNED_DTYPES = {np.dtype(np.uint8): torch.uint8,
                  np.dtype(np.int16): torch.int16}


class _Uploader:
    """The upload thread. ``submit(host_buf, image)`` returns a Future of
    ``(tensor, event, pinned)``: on a CUDA device the buffer is copied
    into pinned memory, then to the card with ``non_blocking`` on a
    stream of its own (a copy from pageable memory would be
    synchronous), and ``event`` is recorded after the copy; the flush
    makes its stream wait on it. On the CPU the tensor is the buffer and
    the event None. Each upload is an ``upload`` span of ``rec``."""

    def __init__(self, pool: ThreadPoolExecutor, device: torch.device,
                 rec: Optional[StageTimer] = None):
        self.pool, self.device = pool, device
        self.rec = rec or StageTimer()
        self.stream = None
        if device.type == "cuda":
            with torch.cuda.device(device):
                self.stream = torch.cuda.Stream()

    def submit(self, host_buf: np.ndarray, image=None) -> Future:
        return self.pool.submit(self._put, host_buf, image)

    def _put(self, host_buf: np.ndarray, image=None):
        with self.rec.span("upload", image=image):
            if self.stream is None:
                return _host_tensor(host_buf), None, None
            # u16 mosaics travel as their int16 view (the same bytes).
            src = host_buf.view(np.int16) if host_buf.dtype == np.uint16 \
                else host_buf
            pinned = torch.empty(src.shape, dtype=_PINNED_DTYPES[src.dtype],
                                 pin_memory=True)
            pinned.numpy()[...] = src
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                dev = pinned.to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
            self.rec.count("transfer.pinned_bytes", src.nbytes)
            if host_buf.dtype == np.uint16:
                dev = dev.view(torch.uint16)
            return dev, done, pinned


def _decode_job(job: ExportJob, mode: str, upload_pool=None, budget=None,
                color_space: str = "srgb",
                rec: Optional[StageTimer] = None, image=None) -> _Decoded:
    """The job's file decoded (the ``decode`` span of ``rec``: the codec
    and metadata work only, so the report's decode split reflects the
    per-codec MP/s), then, with an ``upload_pool``, staged within
    ``budget`` (``stage.pack``). The upload itself runs on
    ``upload_pool`` (an ``_Uploader``: one thread with its own stream),
    not here: a decode worker blocked on a transfer would stall the
    decode pool. The flush resolves the resulting future."""
    rec = rec or StageTimer()
    with rec.span("decode", image=image) as dec:
        decoded = _decode(job, mode, color_space)
    decoded.image, decoded.decoded_ns = image, dec.end_ns
    with rec.span("stage.pack", image=image):
        if upload_pool is not None:
            _stage(decoded, upload_pool, image, budget)
    return decoded


def _decode(job: ExportJob, mode: str, color_space: str) -> _Decoded:
    """The job's file decoded, with its kind, levels and output matrix."""
    from raweditor_tpu_torch.raw.decode import decode_raw

    raw = decode_raw(job.raw_path)
    kind, white, black = classify(raw, mode)
    return _Decoded(
        job=job,
        mosaic=raw.fold_site_blacks() if mode == "accurate" else raw.mosaic,
        wb=raw.wb_rgb(),
        cam_matrix=cam_to_output_matrix(raw.xyz_to_cam, mode, color_space),
        white_level=white,
        black_level=black,
        kind=kind,
        make=raw.camera_make,
        model=raw.camera_model,
        orientation=raw.orientation,
    )


def _stage(decoded: _Decoded, upload_pool, image,
           budget: "_StageBudget") -> None:
    """Bit-pack the mosaic and hand it to the upload thread, within the
    staging budget; over it, the mosaic uploads at flush time."""
    m = decoded.mosaic
    fmt = "raw"
    if m.ndim == 2 and m.dtype == np.uint16:
        peak = m.max(initial=0)
        if peak < 4096 and m.shape[1] % 2 == 0:
            fmt = "u12"  # 1.5 B/px (the dominant sensor depth)
        elif peak < 16384 and m.shape[1] % 4 == 0:
            fmt = "u14"  # 1.75 B/px
    nbytes = {"u12": m.nbytes * 3 // 4,
              "u14": m.nbytes * 7 // 8}.get(fmt, m.nbytes)
    # Budget check BEFORE the pack so a pegged budget costs no host
    # work; a staging failure (e.g. device memory) resolves at flush
    # time: budget released there, the image uploads at flush.
    if not budget.acquire(nbytes):
        return
    try:
        from raweditor_tpu_torch.ops.staging import (pack12_rows,
                                                     pack14_rows)

        # `peak` was scanned above to pick the format; passing it skips
        # the pack's own range re-scan.
        if fmt == "u12":
            host_buf = pack12_rows(m, peak)
        elif fmt == "u14":
            host_buf = pack14_rows(m, peak)
        else:
            host_buf = np.ascontiguousarray(m)
        decoded.staged = upload_pool.submit(host_buf, image)
        decoded.staged_fmt = fmt
        decoded.staged_nbytes = nbytes
    except Exception:
        budget.release(nbytes)
        decoded.staged = None
        decoded.staged_fmt = "raw"
        decoded.staged_nbytes = 0


# Staged mosaics waiting in the decode window hold device (and pinned
# host) memory; each call caps them at this many bytes so deep windows on
# big images cannot exhaust it. Over budget, images upload at flush time
# instead; the result is the same. It fits one default batch of packed
# 24 MP mosaics (8 x 36 MB) with headroom.
_STAGE_BUDGET = 512_000_000


class _StageBudget:
    """The staged bytes one call holds, up to ``limit``: the decode
    workers acquire, the flush releases."""

    def __init__(self, limit: int):
        self.limit = limit
        self.used = 0
        self._lock = threading.Lock()

    def acquire(self, nbytes: int) -> bool:
        with self._lock:
            if self.used + nbytes > self.limit:
                return False
            self.used += nbytes
            return True

    def release(self, nbytes: int) -> None:
        with self._lock:
            self.used -= nbytes


def _encode_one(out_path: str, rgba_words: np.ndarray, quality: int,
                exif: bytes = b"", optimize: bool = False,
                chroma: str = "420", restart_rows: int = 0,
                icc: bytes = None) -> None:
    """Encode a (H, W) u32 packed-RGBA image through PIL: an RGBA PNG,
    or a JPEG with the alpha stripped on the host, as the reference does
    (reference: main.rs:1778-1781). ``exif`` carries the camera
    provenance and orientation (raw/exif.py), ``icc`` the profile of a
    wide-gamut space. A JPEG honours chroma='444' (subsampling=0),
    ``optimize`` and ``restart_rows`` (PIL's restart_marker_rows is the
    same MCU-row unit as the native encoder's)."""
    from PIL import Image

    h, w = rgba_words.shape
    img = Image.frombuffer(
        "RGBA", (w, h), np.ascontiguousarray(rgba_words).tobytes(),
        "raw", "RGBA", 0, 1,
    )

    ext = os.path.splitext(out_path)[1].lower()
    if ext not in (".png", ".jpg", ".jpeg"):
        # JPEG bytes under a .tif name (etc.) would report success and
        # poison skip_existing reruns.
        raise ValueError(f"unsupported 8-bit export extension {ext!r} "
                         "(use .jpg/.jpeg/.png, or bits=16 for .tif)")

    def write(tmp_path):
        ikw = {"icc_profile": icc} if icc else {}
        if ext == ".png":
            img.save(tmp_path, format="PNG", exif=exif, **ikw)
        else:
            kw = {"subsampling": 0} if chroma == "444" else {}
            if restart_rows > 0:
                kw["restart_marker_rows"] = int(restart_rows)
            img.convert("RGB").save(tmp_path, format="JPEG",
                                    quality=quality, exif=exif,
                                    optimize=optimize, **kw, **ikw)

    _atomic_write(out_path, write)


class _Batcher:
    """Shape-bucketed batching: ``add`` returns a bucket once it holds
    ``batch_size`` images, ``drain`` the rest, each at its own length."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.buckets: Dict[Tuple[int, int], List[_Decoded]] = {}

    def add(self, item: _Decoded) -> Optional[List[_Decoded]]:
        # Finish extras split the bucket: an extras-enabled graph shifts
        # zero-amount images by ±1 LSB, so mixing would make an unedited
        # image's bytes depend on which jobs share its batch. Locals and
        # the point-curve length split it too: their structure is uniform
        # per batch in the JAX package's programs.
        key = (item.mosaic.shape, item.kind,
               item.job.params.has_finish_extras(),
               tuple(m.kind for m in item.job.params.locals),
               len(item.job.params.point_curve))
        bucket = self.buckets.setdefault(key, [])
        bucket.append(item)
        if len(bucket) >= self.batch_size:
            return self.buckets.pop(key)
        return None

    def drain(self):
        while self.buckets:
            _, bucket = self.buckets.popitem()
            yield bucket


def _encode_one_jpeg420(out_path: str, y: np.ndarray, cb: np.ndarray,
                        cr: np.ndarray, quality: int,
                        exif: bytes = b"",
                        optimize: bool = False,
                        chroma: str = "420",
                        restart_rows: int = 0,
                        icc: bytes = None) -> None:
    """Encode device-produced YCbCr planes (4:2:0, or full-size chroma
    for '444') through the native baseline JFIF encoder, with no host
    colorspace pass; ``icc`` is spliced in as APP2 segments. Atomic like
    the PIL path. ``restart_rows`` > 0 writes DRI/RSTn resilient streams;
    one thread per image, because the encode pool already spreads the
    images over the host cores."""
    from raweditor_tpu_torch.native import require_rawkit

    rk = require_rawkit()
    h, w = y.shape
    encode = rk.encode_jpeg_444 if chroma == "444" else rk.encode_jpeg_420
    data = encode(
        np.ascontiguousarray(y), np.ascontiguousarray(cb),
        np.ascontiguousarray(cr), w, h, quality, optimize,
        max(0, int(restart_rows)), 1)
    if exif:
        from raweditor_tpu_torch.raw.exif import splice_exif

        data = splice_exif(data, exif)
    if icc:
        from raweditor_tpu_torch.icc import splice_icc_jpeg

        data = splice_icc_jpeg(data, icc)

    def write(tmp_path):
        with open(tmp_path, "wb") as f:
            f.write(data)

    _atomic_write(out_path, write)


def _encode_one_tiff16(out_path: str, rgb_u16: np.ndarray,
                       make: str = "", model: str = "",
                       orientation: int = 1,
                       icc: bytes = None) -> None:
    """Encode an (H, W, 3) u16 frame as an uncompressed 16-bit RGB TIFF
    (the copied ``raw/tiff_out.write_tiff16``), atomically."""
    ext = os.path.splitext(out_path)[1].lower()
    if ext not in (".tif", ".tiff"):
        # TIFF bytes under a .jpg/.png name would report success and
        # poison skip_existing reruns.
        raise ValueError(f"unsupported 16-bit export extension {ext!r} "
                         "(bits=16 writes .tif/.tiff)")
    from raweditor_tpu_torch.raw.exif import SOFTWARE
    from raweditor_tpu_torch.raw.tiff_out import write_tiff16

    _atomic_write(out_path, lambda tmp: write_tiff16(
        tmp, rgb_u16, make=make, model=model, orientation=orientation,
        software=SOFTWARE, icc=icc))


def _refuse_unported(mesh, bits, color_space, mode, jobs) -> None:
    """``NotImplementedError`` naming each argument, and each edit, that
    this port cannot export yet, and ``ValueError`` for arguments the
    JAX exporter refuses too (checked before any file is read)."""
    from raweditor_tpu_torch.ops.develop import require_ported

    if mesh is not None:
        raise NotImplementedError("not ported yet: mesh (multi-device "
                                  "export)")
    if bits not in (8, 16):
        raise ValueError("bits must be 8 or 16")
    if color_space not in COLOR_SPACES:
        raise ValueError(f"unknown color space {color_space!r}; expected "
                         f"one of {COLOR_SPACES}")
    if color_space != "srgb" and mode != "accurate":
        raise ValueError("wide-gamut output requires mode='accurate' "
                         "(parity is defined as the reference's sRGB bytes)")
    for job in jobs:
        require_ported(job.params)


class _ExportRun:
    """One ``run_batch_export`` call: its resolved settings, recorder,
    report and staging budget, its pools and streams, the batches in
    flight and the encodes queued. Its methods are the stages the spans
    name: ``run`` (the decode window, ``export.wait_decode``), ``flush``
    (``export.flush``: ``stage_batch``, then ``develop`` under
    ``export.launch``, its develop call under ``export.develop``, a
    shaped flush's output stage under ``export.shape``),
    ``fetch_batch`` (the fetch thread's
    ``fetch.wait`` and ``fetch.copy``), ``drain_inflight``
    (``export.wait_fetch``), ``hand_off`` (``export.hand_off``),
    ``encode`` (an encode worker's ``encode``) and ``wait_encode``
    (``export.wait_encode``)."""

    def __init__(self, work, report: ExportReport, rec: StageTimer,
                 device: torch.device, *, batch_size, decode_threads,
                 encode_threads, quality, mode, matrix_transpose, transfer,
                 demosaic_method, use_kernel, bits, jpeg_optimize, chroma,
                 jpeg_restart_rows, color_space, shaping, icc,
                 jpeg_planes_ok, arena_cap, on_progress):
        self.report, self.rec = report, rec
        self.device, self.cuda = device, device.type == "cuda"
        self.batch_size, self.bits = batch_size, bits
        self.mode, self.color_space = mode, color_space
        self.matrix_transpose, self.transfer = matrix_transpose, transfer
        self.demosaic_method, self.use_kernel = demosaic_method, use_kernel
        # The output stage's arguments, in ``shape_output``'s order:
        # long_edge, rotate, crop, lens, perspective.
        self.shaping = shaping
        self.quality, self.chroma, self.icc = quality, chroma, icc
        self.jpeg_optimize = jpeg_optimize
        self.jpeg_restart_rows = jpeg_restart_rows
        self.jpeg_planes_ok = jpeg_planes_ok
        self.arena_cap = arena_cap
        self.on_progress = on_progress
        self.budget = _StageBudget(_STAGE_BUDGET)
        self.fetch_stream = None
        if self.cuda:
            with torch.cuda.device(device):
                self.fetch_stream = torch.cuda.Stream()
        self.t_start = time.perf_counter()
        self.progress_last = 0.0
        self.decode_pool = ThreadPoolExecutor(decode_threads)
        self.encode_pool = ThreadPoolExecutor(encode_threads)
        self.fetch_pool = ThreadPoolExecutor(1)
        self.upload_pool = ThreadPoolExecutor(1)
        self.uploader = _Uploader(self.upload_pool, device, rec)
        self.window = max(2 * batch_size, decode_threads * 2)
        # Backpressure: the card outruns host JPEG encode; without a
        # bound the queue would pin unbounded host buffers.
        self.max_encodes = 4 * encode_threads
        self.jobs = iter(work)
        self.pending: List[Tuple[Future, ExportJob, object]] = []
        # Batches in flight: the develop is launched asynchronously; the
        # fetch thread pulls results one batch behind, so the card's
        # work, host decode and encode, and both copies overlap.
        self.inflight: List[tuple] = []
        self.encode_futures: List[Tuple[Future, ExportJob]] = []
        self.flush_numbers = itertools.count()

    def run(self) -> ExportReport:
        """Decode through a bounded window, flush each full bucket and
        then the rest, fetch every batch and wait for every encode."""
        rec, report = self.rec, self.report
        with self.decode_pool, self.encode_pool, self.fetch_pool, \
                self.upload_pool, _on(self.device):
            for _ in range(self.window):
                if not self.submit_decode():
                    break
            batcher = _Batcher(self.batch_size)
            while self.pending:
                fut, job, image = self.pending.pop(0)
                try:
                    with rec.span("export.wait_decode", image=image,
                                  profiler=True):
                        decoded = fut.result()
                except Exception as e:
                    report.failed.append((job.raw_path, f"decode: {e}"))
                    self.note_progress()
                else:
                    report.decode_megapixels += (
                        decoded.mosaic.shape[0] * decoded.mosaic.shape[1]
                        / 1e6)
                    full = batcher.add(decoded)
                    if full is not None:
                        self.flush(full)
                self.submit_decode()
            for bucket in batcher.drain():
                self.flush(bucket)
            self.drain_inflight(depth=0)
            with rec.span("export.wait_encode", profiler=True):
                for fut, job in self.encode_futures:
                    self.wait_encode(fut, job)
                    self.note_progress()
            self.note_progress(force=True)
        report.seconds = time.perf_counter() - self.t_start
        # One measurement per boundary: the report's seconds are the
        # spans'.
        total = rec.totals.get
        report.decode_seconds = total("decode", 0.0)
        report.stage_seconds = total("stage.pack", 0.0)
        report.device_seconds = total("fetch.wait", 0.0)
        report.fetch_seconds = total("fetch.copy", 0.0)
        report.upload_seconds = (total("export.wait_upload", 0.0)
                                 + total("export.stage", 0.0))
        report.encode_seconds = total("export.wait_encode", 0.0)
        report.stages = rec.report()
        report.timer = rec
        return report

    def submit_decode(self) -> bool:
        """Start the next job's decode; False when none is left."""
        image, job = next(self.jobs, (None, None))
        if job is None:
            return False
        self.pending.append((self.decode_pool.submit(
            _decode_job, job, self.mode, self.uploader, self.budget,
            self.color_space, self.rec, image), job, image))
        return True

    def note_progress(self, force: bool = False) -> None:
        """Rate-limited completion callback (≥1 s apart unless forced);
        never raises into the run."""
        if self.on_progress is None:
            return
        now = time.perf_counter()
        if not force and now - self.progress_last < 1.0:
            return
        self.progress_last = now
        try:
            self.on_progress(self.report.succeeded, len(self.report.failed),
                             self.report.total, now - self.t_start)
        except Exception:  # noqa: BLE001 - observability must not
            pass           # fail the export

    def to_device(self, t: torch.Tensor, out=None) -> torch.Tensor:
        """A flush-time copy of a host tensor in pageable memory, into
        ``out`` where given."""
        if self.cuda:
            self.rec.count("transfer.pageable_bytes",
                           t.numel() * t.element_size())
        return t.to(self.device) if out is None else out.copy_(t)

    def flush(self, batch: List[_Decoded]) -> None:
        """``export.flush``: the batch staged and developed at its own
        length, then handed to the fetch thread; results are taken one
        batch behind."""
        rec, seq = self.rec, next(self.flush_numbers)
        try:
            with rec.span("export.flush", image=[d.image for d in batch],
                          batch=seq) as span:
                for d in batch:
                    rec.interval("queue.batch", d.decoded_ns, span.start_ns,
                                 image=d.image, batch=seq)
                mosaics = self.stage_batch(batch, seq)
                with rec.span("export.launch", batch=seq,
                              parent="export.flush"):
                    rec.count("slots.developed", len(batch))
                    rec.count("slots.unfilled", self.batch_size - len(batch))
                    out, done = self.develop(batch, mosaics, seq)
        except Exception as e:  # a develop or kernel failure:
            # quarantine the batch like any per-image failure instead of
            # killing a long run; never route around the kernel.
            for d in batch:
                self.report.failed.append((d.job.raw_path, f"develop: {e}"))
                self.note_progress()
            return
        finally:
            # Release the staging budget only now: until dispatch the
            # staged buffers were the live copies.
            for d in batch:
                if d.staged is not None:
                    self.budget.release(d.staged_nbytes)
                    d.staged = None
                    d.staged_nbytes = 0
        self.inflight.append((self.fetch_pool.submit(
            self.fetch_batch, out, batch, done, seq), batch, seq))
        self.drain_inflight(depth=1)
        if self.arena_cap:
            from raweditor_tpu_torch.utils.memory import trim_malloc

            # The batch's host buffers were just freed; hand the pages
            # back instead of letting arenas retain them.
            with rec.span("export.trim", batch=seq, profiler=True):
                trim_malloc()

    def stage_batch(self, batch, seq) -> torch.Tensor:
        """The (n, H, W) u16 batch on the device, a slot an image: the
        staged buffers (waited for on this thread's stream) unpacked or
        copied into their slots in one launch, a mosaic with none
        uploaded into its slot; else, with nothing staged, one flush-time
        upload of the n mosaics."""
        from raweditor_tpu_torch.ops.staging import unpack_into_batch

        # Resolve the upload futures first: one the upload thread
        # finished costs nothing; one still running is waited for
        # (upload time); a failed one degrades to a flush-time upload.
        with self.rec.span("export.wait_upload", batch=seq,
                      parent="export.flush", profiler=True):
            for d in batch:
                if isinstance(d.staged, Future):
                    fut, d.staged = d.staged, None
                    try:
                        d.staged = fut.result()
                    except Exception:
                        self.budget.release(d.staged_nbytes)
                        d.staged_fmt = "raw"
                        d.staged_nbytes = 0
        with self.rec.span("export.stage", batch=seq, parent="export.flush"):
            if not any(d.staged is not None for d in batch):
                return self.to_device(_host_tensor(np.stack(
                    [d.mosaic for d in batch])))
            # Use every staged buffer (an over-budget straggler must not
            # discard the bytes already copied); items without one upload
            # into their slot here, before the launch.
            mosaics = torch.empty((len(batch),) + batch[0].mosaic.shape,
                                  dtype=torch.uint16, device=self.device)
            sources, fmts = [], []
            late_bytes = 0
            for i, d in enumerate(batch):
                src, fmt = None, None
                if d.staged is not None:
                    buf, done, _ = d.staged
                    if done is not None:
                        # The copy ran on the upload stream: this stream
                        # waits for it, and the allocator must not hand
                        # the buffer back to the upload stream while this
                        # stream still reads it.
                        stream = torch.cuda.current_stream(self.device)
                        stream.wait_event(done)
                        buf.record_stream(stream)
                    src = buf
                    fmt = "u16" if d.staged_fmt == "raw" else d.staged_fmt
                else:
                    late = _host_tensor(d.mosaic)
                    late_bytes += late.numel() * late.element_size()
                    self.to_device(late, mosaics[i])
                sources.append(src)
                fmts.append(fmt)
            unpack_into_batch(mosaics, sources, fmts)
            self.rec.count("staging.slots_unpacked",
                      sum(f in ("u12", "u14") for f in fmts))
            self.rec.count("staging.slots_copied", fmts.count("u16"))
            self.rec.count("staging.slots_uploaded", fmts.count(None))
        self.report.upload_bytes += late_bytes + sum(
            d.staged_nbytes for d in batch if d.staged is not None)
        return mosaics

    def develop(self, batch, mosaics, seq):
        """``export.launch``: the flush's develop on its route (module
        docstring) under ``export.develop``, then the extras post-pass,
        the output stage and the JPEG planes. Returns the output and an
        event recorded after it."""
        kind = batch[0].kind
        params = [d.job.params for d in batch]
        wbs = np.stack([d.wb for d in batch])
        whites = np.array([d.white_level for d in batch], np.float32)
        blacks = np.array([d.black_level for d in batch], np.float32)
        # Clipped-highlight reconstruction, gated on the flush: the
        # per-image amounts keep zero-amount images bit-exact, so a mixed
        # batch needs no split. Every route below sees a plain u16 batch.
        if any(float(d.job.params.highlight_recovery) != 0.0
               for d in batch):
            mosaics = self.reconstruct(kind, batch, mosaics, wbs, whites,
                                       blacks)
        # The per-image inputs every develop lane takes after the mosaics.
        inputs = (params, wbs, np.stack([d.cam_matrix for d in batch]),
                  whites, blacks)
        # Finish extras: the batch's static flags, ORed over its images
        # (zero-amount images inside such a batch develop within 1 LSB
        # of their extras-off render).
        ex_on = any(d.job.params.has_finish_extras() for d in batch)
        if ex_on:
            table, mixer_on, grading_on, stencils = pack_extras(params)
            ex_on = mixer_on or grading_on or stencils
        # The output stage (geometry, then resize) takes words, or the
        # 16-bit frames, image by image.
        shaped = _geometry.reshapes(tuple(mosaics.shape[1:3]), *self.shaping)
        if self.bits == 16:
            # The 16-bit lane: extras in the chain (the words pass is
            # 8-bit), the exact transfer.
            self.route("linear" if kind.linear else "plain", len(batch))
            mode16 = "+".join(
                part for part, on in (("base", ex_on and stencils),
                                      ("mixer", ex_on and mixer_on),
                                      ("grading", ex_on and grading_on))
                if on) or False
            with self.develop_span(seq):
                out = batch_develop_u16(
                    mosaics, *inputs, matrix_transpose=self.matrix_transpose,
                    cfa_phase=kind.cfa_phase, pattern=kind.xtrans_pattern,
                    transfer=transfer16_for(self.transfer),
                    demosaic_method=kind.demosaic(self.demosaic_method),
                    extras=mode16, linear=kind.linear)
            if shaped:
                with self.shape_span(seq):
                    out = self.shape(out, "u16")
            return out, _record_event(self.device)
        planes = ("rgba_words" if shaped
                  else self.planes_for(*mosaics.shape[1:3]))
        # The fused kernel where it computes the edit and the frame, and
        # the LinearRaw kernel for LinearRaw frames; point curves and the
        # Adobe RGB transfer ride the plain lane.
        output = ("ycbcr420" if planes == "ycbcr420" and not ex_on
                  else "rgba")
        with self.develop_span(seq):
            if kernel_route(self.use_kernel, kind, self.transfer,
                            batch[0].job.params):
                out = self.develop_kernel(kind, mosaics, inputs, output)
            elif self.linear_kernel_route(kind, batch):
                out = self.develop_linear_kernel(mosaics, inputs, output)
            else:
                out = self.develop_plain(kind, mosaics, inputs,
                                         "rgba_words" if ex_on else planes)
        if ex_on:
            # Extras on every route run the post-pass kernel over the
            # develop's words (its plain version for CPU tensors), every
            # slot of the batch.
            self.rec.count("extras.slots", len(batch))
            self.rec.count("extras.asked", sum(
                d.job.params.has_finish_extras() for d in batch))
            out = _fx.fused_finish_extras_rgba(
                out, self.to_device(table), mixer_on=mixer_on,
                grading_on=grading_on, stencils=stencils,
                output="ycbcr420" if planes == "ycbcr420" else "rgba")
        if shaped:
            with self.shape_span(seq):
                out = self.shape(out, "words")
        else:
            out = self.jpeg_planes(out, planes)
        return out, _record_event(self.device)

    def jpeg_planes(self, out, planes: str):
        """The flush's RGBA words converted on the card to the JPEG planes
        ``planes`` names; planes, or words that stay words, as they are."""
        if planes == "rgba_words" or isinstance(out, tuple):
            return out
        return (_jpeg.rgba_words_to_ycbcr444(out) if planes == "ycbcr444"
                else _jpeg.rgba_words_to_ycbcr420(out))

    def develop_span(self, seq):
        """``export.develop``, a child of ``export.launch``: the develop
        call alone on whichever route the flush takes (the kernel, the
        plain lane or the 16-bit lane), without the reconstruction before
        it or the extras post-pass and output stage after it. It encloses
        launches, so it never enters a profiler range."""
        return self.rec.span("export.develop", batch=seq,
                             parent="export.launch")

    def reconstruct(self, kind: FrameKind, batch, mosaics, wbs, whites,
                    blacks) -> torch.Tensor:
        """The flush's mosaics with their clipped highlights
        reconstructed at each image's amount (``ops/highlights.py``)."""
        from raweditor_tpu_torch.ops import highlights as _hl

        amounts = np.array([float(d.job.params.highlight_recovery)
                            for d in batch], np.float32)
        if kind.linear:
            return _hl.batch_reconstruct_linear(mosaics, wbs, amounts,
                                                whites, blacks)
        return _hl.batch_reconstruct_mosaic(
            mosaics, wbs, amounts, whites, blacks, cfa_phase=kind.cfa_phase,
            xtrans_pattern=kind.xtrans_pattern)

    def develop_kernel(self, kind: FrameKind, mosaics, inputs, output: str):
        """The fused batch kernel (B1-B7) over the flush, to RGBA words
        or 4:2:0 planes."""
        demosaic = kind.demosaic(self.demosaic_method)
        scal = self.to_device(pack_params(*inputs, self.matrix_transpose))
        self.route(_fused.variant(demosaic, kind.xtrans_pattern) + (
            ".planes" if output == "ycbcr420" else ".rgba"), len(mosaics))
        if (kind.xtrans_pattern is not None and demosaic == "grad"
                and _fused.period6_march(kind.xtrans_pattern)):
            self.rec.count("cfa_grad.period6_slots", len(mosaics))
        return _fused.fused_batch_develop_rgba(
            mosaics, scal, cfa_phase=kind.cfa_phase,
            gamma=kernel_gamma_for(self.transfer), output=output,
            demosaic=demosaic, pattern=kind.xtrans_pattern)

    def linear_kernel_route(self, kind: FrameKind, batch) -> bool:
        """Whether a LinearRaw flush takes the LinearRaw kernel:
        ``use_kernel``, a transfer the kernels compute and no point curve
        in the bucket (``kernel_route``'s rule, for frames that need no
        demosaic)."""
        return (kind.linear and self.use_kernel
                and self.transfer in KERNEL_GAMMA_BY_TRANSFER
                and not any(d.job.params.point_curve for d in batch))

    def develop_linear_kernel(self, mosaics, inputs, output: str):
        """The LinearRaw kernel (``ops/fused_linear.py``) over the flush, to
        RGBA words or 4:2:0 planes, bit for bit the plain lane's. Its
        slots count as the lane's route, ``linear``, and again as
        ``linear.kernel_slots``."""
        n = len(mosaics)
        self.route("linear", n)
        self.rec.count("linear.kernel_slots", n)
        return _linear.fused_batch_develop_linear(
            mosaics, *inputs, matrix_transpose=self.matrix_transpose,
            gamma=kernel_gamma_for(self.transfer), output=output)

    def develop_plain(self, kind: FrameKind, mosaics, inputs, output: str):
        """The plain lane (``parallel/batch.py``) over the flush. A
        LinearRaw flush takes it without ``use_kernel``, with a point
        curve or with a transfer the kernels do not compute, as the JAX
        exporter's XLA lane."""
        lane = dict(matrix_transpose=self.matrix_transpose,
                    transfer=self.transfer, output=output)
        if kind.linear:
            self.route("linear", len(mosaics))
            return batch_develop_linear_rgba(mosaics, *inputs, **lane)
        self.route("plain", len(mosaics))
        if kind.xtrans_pattern is not None:
            return batch_develop_xtrans_rgba(
                mosaics, *inputs, pattern=kind.xtrans_pattern,
                demosaic_method=kind.demosaic(self.demosaic_method), **lane)
        return batch_develop_rgba(
            mosaics, *inputs, cfa_phase=kind.cfa_phase,
            demosaic_method=self.demosaic_method, **lane)

    def route(self, name: str, n: int) -> None:
        """Count the flush's n slots under its develop route
        (``develop.slots.<route>``)."""
        self.rec.count("develop.slots." + name, n)

    def planes_for(self, h: int, w: int) -> str:
        """What an h x w output leaves the card as: the JPEG planes of an
        all-JPEG run (4:4:4, or 4:2:0 of an even frame), else RGBA
        words."""
        if self.jpeg_planes_ok and self.chroma == "444":
            return "ycbcr444"
        if self.jpeg_planes_ok and h % 2 == 0 and w % 2 == 0:
            return "ycbcr420"
        return "rgba_words"

    def shape_span(self, seq):
        """``export.shape``, a child of ``export.launch``: the output
        stage of a shaped flush and, for JPEG planes, the conversion of
        its shaped words. It encloses launches, so it never enters a
        profiler range."""
        return self.rec.span("export.shape", batch=seq,
                             parent="export.launch")

    def shape(self, out, kind: str):
        """The output stage of the flush's images, counted as
        ``shape.images`` and their pixels in and out. 16-bit frames take
        ``ops/geometry.shape_output`` image by image. Words take the
        geometry image by image, then one resize of the flush
        (``ops/fused_resize.resize_words``; the images its kernel resized
        counted as ``resize.kernel_images``), and leave as ``planes_for``
        says: the kernel's 4:2:0 planes straight from the resize where
        that is what they leave as."""
        n, h, w = out.shape[:3]
        if kind == "u16":
            out = torch.stack([_geometry.shape_output(img, kind,
                                                      *self.shaping)
                               for img in out])
            oh, ow = out.shape[1:3]
        else:
            long_edge, rotate, crop, lens, perspective = self.shaping
            out = _geometry.rotate_crop_rgba_words_batch(
                out, float(rotate), crop, lens=lens, perspective=perspective)
            gh, gw = out.shape[1:3]
            oh, ow = _resize.long_edge_shape(gh, gw, long_edge or 0)
            planes = self.planes_for(oh, ow)
            if (oh, ow) != (gh, gw):
                out = _fused_resize.resize_words(
                    out, ow, oh, output=("ycbcr420" if planes == "ycbcr420"
                                         else "rgba"))
                if self.cuda:
                    self.rec.count("resize.kernel_images", n)
            out = self.jpeg_planes(out, planes)
        self.rec.count("shape.images", n)
        self.rec.count("shape.in_pixels", n * h * w)
        self.rec.count("shape.out_pixels", n * oh * ow)
        return out

    def fetch_batch(self, out, batch, done, seq):
        """Runs on the fetch thread: wait for the flush's event, then
        copy the batch to the host on the fetch stream. Returns the host
        arrays, their bytes and the copy's end."""
        rec, images = self.rec, [d.image for d in batch]
        with rec.span("fetch.wait", image=images, batch=seq):
            if done is not None:
                done.synchronize()
        with rec.span("fetch.copy", image=images, batch=seq) as copy, \
                _on(self.device, self.fetch_stream):
            if isinstance(out, tuple):  # YCbCr planes
                host = tuple(p.cpu().numpy() for p in out)
                nbytes = sum(p.nbytes for p in host)
            else:
                host = out.cpu().numpy()
                nbytes = host.nbytes
        if self.cuda:
            rec.count("transfer.pageable_bytes", nbytes)
        return host, nbytes, copy.end_ns

    def drain_inflight(self, depth: int) -> None:
        """``export.wait_fetch``: take fetched batches, oldest first,
        until ``depth`` remain in flight, and hand each off."""
        while len(self.inflight) > depth:
            fut, batch, seq = self.inflight.pop(0)
            try:
                with self.rec.span("export.wait_fetch",
                                   image=[d.image for d in batch],
                                   batch=seq, profiler=True):
                    host, nbytes, ready_ns = fut.result()
            except Exception as e:  # device failure: the batch
                # quarantines like any other per-image failure.
                for d in batch:
                    self.report.failed.append(
                        (d.job.raw_path, f"device: {e}"))
                self.note_progress()
                continue
            self.report.fetch_bytes += nbytes
            self.hand_off(batch, host, seq, ready_ns)

    def hand_off(self, batch, host, seq, ready_ns) -> None:
        """``export.hand_off``: one encode an image on the encode pool,
        then the backpressure wait on the oldest."""
        from raweditor_tpu_torch.raw.exif import build_exif

        with self.rec.span("export.hand_off", image=[d.image for d in batch],
                           batch=seq, profiler=True):
            for i, d in enumerate(batch):
                # Per-image copies: an encode job must not pin the whole
                # (B, H, W) batch array while it waits in the queue.
                exif = build_exif(d.make, d.model, d.orientation)
                flags = (self.quality, exif, self.jpeg_optimize,
                         self.chroma, self.jpeg_restart_rows, self.icc)
                if isinstance(host, tuple):  # YCbCr planes
                    planes = tuple(p[i] for p in host)
                    if len(planes) == 2:
                        # Kernel planes: Y + NV12-interleaved CbCr,
                        # de-interleaved by two strided copies of
                        # H/2·W/2 bytes on the host.
                        y, cbcr = planes
                        planes = (y, cbcr[:, 0::2], cbcr[:, 1::2])
                    fn, args = _encode_one_jpeg420, (
                        *(p.copy() for p in planes), *flags)
                elif self.bits == 16:
                    fn, args = _encode_one_tiff16, (
                        host[i].copy(), d.make, d.model, d.orientation,
                        self.icc)
                else:
                    fn, args = _encode_one, (host[i].copy(), *flags)
                fut = self.encode_pool.submit(self.encode, fn, d.image, seq,
                                              ready_ns, d.job.out_path,
                                              *args)
                self.encode_futures.append((fut, d.job))
        while len(self.encode_futures) > self.max_encodes:
            fut, job = self.encode_futures.pop(0)
            with self.rec.span("export.wait_encode", profiler=True):
                self.wait_encode(fut, job)
            self.note_progress()

    def encode(self, fn, image, seq, ready_ns, *args) -> None:
        """Runs on an encode worker: the image's wait in the encode queue
        since its fetch, then the encoder."""
        self.rec.interval("queue.encode", ready_ns, time.perf_counter_ns(),
                          image=image, batch=seq)
        with self.rec.span("encode", image=image, batch=seq):
            fn(*args)

    def wait_encode(self, fut: Future, job: ExportJob) -> None:
        try:
            fut.result()
            self.report.succeeded += 1
        except Exception as e:
            self.report.failed.append((job.raw_path, f"encode: {e}"))


def run_batch_export(
    jobs: Sequence[ExportJob],
    mesh=None,
    batch_size: int = 8,
    decode_threads: int = 4,
    encode_threads: int = 4,
    quality: int = 95,
    mode: str = "parity",
    matrix_transpose: Optional[bool] = None,
    skip_existing: bool = False,
    fast_gamma: bool = False,
    demosaic_method: str = "nearest",
    use_kernel: bool = False,
    transfer: str = None,
    bits: int = 8,
    long_edge: Optional[int] = None,
    jpeg_optimize: bool = False,
    chroma: str = "420",
    jpeg_restart_rows: int = 0,
    color_space: str = "srgb",
    rotate: float = 0.0,
    crop=None,
    lens=None,
    perspective=None,
    on_progress=None,
    device=None,
    trace_spans: bool = False,
) -> ExportReport:
    """Develop and encode every job on one device; returns a report with
    throughput and the per-image quarantine list.

    ``use_kernel`` is the JAX exporter's ``use_pallas`` (routes in the
    module docstring). ``on_progress(done, failed, total, seconds)`` is
    called (at most ~1/s) as images complete; exceptions from it are
    swallowed: observability must never fail the run.

    ``skip_existing`` makes a rerun resume where it stopped: jobs whose
    output file already exists are counted as skipped, the analogue of
    the reference's resumable pending-queue cache loop
    (reference: main.rs:404-434).

    ``device`` is where the develop runs: the card unless the caller
    asks for ``"cpu"`` (the kernels' plain versions); None takes
    ``utils.device.default_device()``.

    ``trace_spans`` keeps the call's span log (``report.timer.log``, and
    ``report.timer.chrome_trace()``) even with no profiler open."""
    from raweditor_tpu_torch.native import require_rawkit
    from raweditor_tpu_torch.ops.demosaic import DEMOSAIC_METHODS
    from raweditor_tpu_torch.utils.device import resolve_device
    from raweditor_tpu_torch.utils.memory import (arena_cap_from_env,
                                                  cap_malloc_arenas)

    color_space = (color_space or "srgb").lower()
    if mode not in ("parity", "accurate"):
        raise ValueError(f"unknown mode {mode!r}")
    _refuse_unported(mesh, bits, color_space, mode, jobs)
    if demosaic_method not in DEMOSAIC_METHODS + ("smooth",):
        raise ValueError(f"unknown demosaic method {demosaic_method!r}")
    if chroma not in ("420", "444"):
        raise ValueError(f"chroma must be '420' or '444', got {chroma!r}")
    if matrix_transpose is None:
        matrix_transpose = mode == "parity"
    # A wide space mandates its transfer; the fast forms apply after.
    transfer = TRANSFER_BY_SPACE.get(color_space, transfer)
    # Polynomial forms of the transfers: within 1 LSB after u8
    # quantisation, so 16-bit output demotes them (transfer16).
    if transfer is None:
        transfer = "gamma22_poly" if fast_gamma else "gamma22"
    elif fast_gamma and transfer == "srgb":
        transfer = "srgb_poly"
    encoder_for(transfer)  # validated up front, not deep in a flush
    icc = None
    if color_space != "srgb":
        from raweditor_tpu_torch.icc import profile_bytes

        icc = profile_bytes(color_space)
    device = resolve_device(device)
    # glibc arena retention made long-run RSS track cumulative decode
    # volume instead of the working set; cap arenas before the pools
    # can create them, and trim between flushes (utils/memory.py). 0
    # disables both.
    arena_cap = arena_cap_from_env()
    if arena_cap:
        cap_malloc_arenas(arena_cap)

    report = ExportReport(total=len(jobs))
    # The call's recorder: the span log is kept for a trace (the CLI's
    # --trace-out) or while a profiler is open, whose ranges then name
    # the calling thread's waits.
    profiling = bool(getattr(torch.autograd.profiler,
                             "_is_profiler_enabled", False))
    rec = StageTimer(keep_log=trace_spans or profiling, profiler=profiling)
    for name in COUNTERS:
        rec.count(name, 0)

    # Each image's id in the spans: its catalog id, else its index in
    # the call.
    work = [(job.image_id if job.image_id is not None else i, job)
            for i, job in enumerate(jobs)]
    if skip_existing:
        work = [(image, job) for image, job in work
                if not os.path.exists(job.out_path)]
        report.skipped = len(jobs) - len(work)
        jobs = [job for _, job in work]

    # JPEG planes on the card and the native JFIF encoder whenever every
    # output still to be written is a JPEG (decided after the
    # skip_existing prune, from the extensions alone): 1.5 bytes a pixel
    # cross to the host for 4:2:0 (3 for 4:4:4) instead of 4, and the
    # encoder skips its colorspace pass. PNG runs and odd 4:2:0 frames
    # keep RGBA words and PIL. The encoder is required here, before any
    # file is read: a missing one raises naming its file instead of
    # moving the colour conversion to the host (RAWEDITOR_TPU_NO_NATIVE
    # switches the decoders' codec only).
    jpeg_planes_ok = bits == 8 and bool(jobs) and all(
        j.out_path.lower().endswith((".jpg", ".jpeg")) for j in jobs)
    if jpeg_planes_ok:
        require_rawkit()
    report = _ExportRun(
        work, report, rec, device, batch_size=batch_size,
        decode_threads=decode_threads, encode_threads=encode_threads,
        quality=quality, mode=mode, matrix_transpose=matrix_transpose,
        transfer=transfer, demosaic_method=demosaic_method,
        use_kernel=use_kernel, bits=bits, jpeg_optimize=jpeg_optimize,
        chroma=chroma, jpeg_restart_rows=jpeg_restart_rows,
        color_space=color_space,
        shaping=(long_edge, rotate, crop, lens, perspective), icc=icc,
        jpeg_planes_ok=jpeg_planes_ok, arena_cap=arena_cap,
        on_progress=on_progress).run()
    global LAST_REPORT
    LAST_REPORT = report.as_dict()
    return report


def jobs_from_catalog(lib, out_dir: os.PathLike,
                      image_ids: Optional[Sequence[int]] = None,
                      ext: str = "jpg") -> List[ExportJob]:
    """Build export jobs from catalog rows + their stored edit params —
    the non-destructive edit replay (reference: main.rs:510-517)."""
    images = lib.get_all_images()
    if image_ids is not None:
        wanted = set(image_ids)
        images = [i for i in images if i.id in wanted]
    jobs = []
    taken = set()
    for img in images:
        if img.is_deleted():
            continue
        stem = os.path.splitext(img.filename)[0]
        # Distinct source files can share a stem (IMG_0001.NEF in two
        # folders); disambiguate with the catalog id so one export
        # never silently overwrites another.
        name = f"{stem}.{ext}"
        if name.lower() in taken:
            name = f"{stem}_{img.id}.{ext}"
        taken.add(name.lower())
        jobs.append(
            ExportJob(
                raw_path=img.path,
                out_path=os.path.join(os.fspath(out_dir), name),
                params=lib.load_edit_params(img.id),
                image_id=img.id,
            )
        )
    return jobs

