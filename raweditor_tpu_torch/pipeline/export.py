"""Batch export on one card: RAW files to developed JPEG or PNG files.

The PyTorch port of the JAX package's ``pipeline/export.py`` on its
single-device route (``mesh=None``, 8-bit, sRGB)::

    decode pool ──▶ staging ──▶ shape buckets ──▶ one develop per ──▶ fetch ──▶ encode
    (host threads,  (bit-packed, (padded to a      flush: the fused    thread   pool
     raw/decode)     pinned, own  fixed batch      batch kernel, B8             (_rawkit
                     CUDA stream) shape)           after it for extras)         or PIL)

- Decode workers run ahead of the card through a bounded window. Each
  mosaic is bit-packed on the host (``ops/staging.py``: 12-bit at 1.5
  bytes a pixel, 14-bit at 1.75) and handed to one upload thread, which
  copies it into pinned memory and on to the card with ``non_blocking``
  on a CUDA stream of its own and records an event. The flush makes the
  compute stream wait on that event, then unpacks and stacks the batch.
  The staged bytes are held under a budget (``_STAGE_BUDGET``); over it,
  a mosaic uploads at flush time instead.
- Mosaics are bucketed by shape, CFA, extras, locals structure and
  point-curve length (``_Batcher``) and each batch is padded to a fixed
  size by replaying its first frame, whose copies are never encoded.
- Each flush launches one develop. With ``use_kernel`` and no point
  curve in the bucket it is the fused batch kernel
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
- A fetch thread waits on an event recorded after the flush's launches
  (not on a device-wide sync, which would also wait for the next flush's
  upload), slices the padding off on the card and copies the rest to
  the host on a stream of its own; an encode pool writes the files:
  ``_rawkit``'s JFIF encoder for planes, PIL for RGBA PNG and odd 4:2:0
  JPEG. All launches stay on the calling thread. An all-JPEG run
  requires the native encoder before it reads a file; it never hands
  words to PIL in place of the planes.
- One bad file fails its own job (``report.failed``, ``"decode: ..."``;
  a LinearRaw file or a CFA pattern that is neither a Bayer phase nor a
  36-letter grid among them). A develop that raises fails its batch
  (``"develop: ..."``): a kernel that fails to build or launch is never
  routed around, and no later flush avoids it. A failed encode fails
  its image (``"encode: ..."``).

Not ported yet, each refused with ``NotImplementedError`` naming itself
before any file is read: ``mesh``, ``bits=16``, a ``color_space`` other
than sRGB, ``long_edge``, ``rotate``, ``crop``, ``lens``, ``perspective``,
and any job whose edit has clarity, dehaze, grain, local adjustments or
highlight recovery.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raweditor_tpu_torch.color import (cam_to_srgb_matrix, encoder_for,
                                       kernel_gamma_for)
from raweditor_tpu_torch.ops import fused_develop as _fused
from raweditor_tpu_torch.ops import fused_extras as _fx
from raweditor_tpu_torch.ops.cfa_generic import generic_cfa_method
from raweditor_tpu_torch.params import EditParams
from raweditor_tpu_torch.parallel.batch import (
    batch_develop_rgba,
    batch_develop_xtrans_rgba,
    pack_extras,
    pack_params,
)

# The JAX package's output spaces; the port writes sRGB only so far.
_COLOR_SPACES = ("srgb", "display-p3", "adobe-rgb")


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
    # budget, not a wall split). decode_megapixels is the matching
    # numerator for a per-codec MP/s.
    decode_seconds: float = 0.0
    decode_megapixels: float = 0.0
    # Host staging work split out of decode: the bit-pack and the hand-off
    # to the upload thread, on the decode workers.
    stage_seconds: float = 0.0
    # Dispatch to retire on the fetch thread (the event recorded after
    # the flush's launches): an upper bound that includes the card's
    # wait for the batch's uploads, not pure kernel time.
    device_seconds: float = 0.0
    encode_seconds: float = 0.0
    # Device-to-host copy of the developed batches (padding sliced off
    # on the card first).
    fetch_seconds: float = 0.0
    fetch_bytes: int = 0
    # Host-to-device staging: the bytes uploaded, and the host's wait for
    # the upload thread plus the flush-time unpack and stack (0 when the
    # uploads overlapped the decode).
    upload_seconds: float = 0.0
    upload_bytes: int = 0

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
        }


@dataclasses.dataclass
class _Decoded:
    job: ExportJob
    mosaic: np.ndarray
    wb: np.ndarray
    cam_matrix: np.ndarray
    white_level: float
    black_level: float
    cfa_phase: tuple = (0, 0)
    # Staging started from the decode worker (a Future of the upload
    # thread's ``(tensor, event, pinned)``), so the upload overlaps the
    # next file's decode. 12- and 14-bit mosaics stage bit-packed
    # (ops/staging.py) and unpack on the card at flush.
    staged: object = None
    staged_fmt: str = "raw"  # "raw" | "u12" | "u14"
    staged_nbytes: int = 0
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
    """The upload thread. ``submit(host_buf)`` returns a Future of
    ``(tensor, event, pinned)``: on a CUDA device the buffer is copied
    into pinned memory, then to the card with ``non_blocking`` on a
    stream of its own (a copy from pageable memory would be
    synchronous), and ``event`` is recorded after the copy; the flush
    makes its stream wait on it. On the CPU the tensor is the buffer and
    the event None."""

    def __init__(self, pool: ThreadPoolExecutor, device: torch.device):
        self.pool, self.device = pool, device
        self.stream = None
        if device.type == "cuda":
            with torch.cuda.device(device):
                self.stream = torch.cuda.Stream()

    def submit(self, host_buf: np.ndarray) -> Future:
        return self.pool.submit(self._put, host_buf)

    def _put(self, host_buf: np.ndarray):
        if self.stream is None:
            return _host_tensor(host_buf), None, None
        # u16 mosaics travel as their int16 view (the same bytes).
        src = host_buf.view(np.int16) if host_buf.dtype == np.uint16 \
            else host_buf
        pinned = torch.empty(src.shape, dtype=_PINNED_DTYPES[src.dtype],
                             pin_memory=True)
        pinned.numpy()[...] = src
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            dev = pinned.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        if host_buf.dtype == np.uint16:
            dev = dev.view(torch.uint16)
        return dev, done, pinned


def _decode_job(job: ExportJob, mode: str, upload_pool=None):
    """Returns (decoded, decode_seconds, stage_seconds).

    decode_seconds covers the codec and metadata work only; the staging
    pack is timed separately, so the report's decode split reflects the
    per-codec MP/s. The upload itself runs on ``upload_pool`` (an
    ``_Uploader``: one thread with its own stream), not here: a decode
    worker blocked on a transfer would stall the decode pool. The flush
    resolves the resulting future."""
    from raweditor_tpu_torch.raw.decode import decode_raw

    t0 = time.perf_counter()
    raw = decode_raw(job.raw_path)
    if raw.is_linear:
        raise NotImplementedError("not ported yet: LinearRaw frames")
    if mode == "parity":
        # The reference hardcodes 4096 and the RGGB stencil
        # (gpu/shaders.rs:110-125).
        white, black = 4096.0, 0.0
        phase = (0, 0)
    else:
        from raweditor_tpu_torch.ops.cfa_generic import is_xtrans
        from raweditor_tpu_torch.ops.demosaic import phase_of

        white, black = float(raw.white_level), float(raw.black_level)
        if is_xtrans(raw.cfa_pattern):
            # X-Trans buckets carry the pattern string instead of a
            # Bayer phase; flush routes them to the generic-CFA develop.
            phase = raw.cfa_pattern
        else:
            phase = phase_of(raw.cfa_pattern)
    decoded = _Decoded(
        job=job,
        mosaic=raw.fold_site_blacks() if mode == "accurate" else raw.mosaic,
        wb=raw.wb_rgb(),
        cam_matrix=cam_to_srgb_matrix(raw.xyz_to_cam, mode),
        white_level=white,
        black_level=black,
        cfa_phase=phase,
        make=raw.camera_make,
        model=raw.camera_model,
        orientation=raw.orientation,
    )
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if upload_pool is not None:
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
        if _stage_budget_acquire(nbytes):
            try:
                from raweditor_tpu_torch.ops.staging import (pack12_rows,
                                                             pack14_rows)

                # `peak` was scanned above to pick the format; passing it
                # skips the pack's own range re-scan.
                if fmt == "u12":
                    host_buf = pack12_rows(m, peak)
                elif fmt == "u14":
                    host_buf = pack14_rows(m, peak)
                else:
                    host_buf = np.ascontiguousarray(m)
                decoded.staged = upload_pool.submit(host_buf)
                decoded.staged_fmt = fmt
                decoded.staged_nbytes = nbytes
            except Exception:
                _stage_budget_release(nbytes)
                decoded.staged = None
                decoded.staged_fmt = "raw"
                decoded.staged_nbytes = 0
    return decoded, decode_s, time.perf_counter() - t0


# Staged mosaics waiting in the decode window hold device (and pinned
# host) memory; cap them so deep windows on big images cannot exhaust
# it. Over budget, images upload at flush time instead; the result is
# the same. The default fits one default batch of packed 24 MP mosaics
# (8 x 36 MB) with headroom.
_STAGE_BUDGET = int(os.environ.get(
    "RAWEDITOR_TPU_STAGE_BUDGET_MB", "512")) * 1_000_000
# Module-level construction: a lazily built lock would itself need a lock.
_stage_lock = threading.Lock()
_stage_used = 0
_stage_runs = 0  # active run_batch_export calls (leak self-healing)


def _stage_run_begin() -> None:
    """Mark a run active; if no other run holds staging, clear any
    budget leaked by an aborted previous run (its buffers are long
    garbage-collected — only the counter survived)."""
    global _stage_runs, _stage_used
    with _stage_lock:
        if _stage_runs == 0:
            _stage_used = 0
        _stage_runs += 1


def _stage_run_end() -> None:
    global _stage_runs
    with _stage_lock:
        _stage_runs = max(0, _stage_runs - 1)


def _stage_budget_acquire(nbytes: int) -> bool:
    global _stage_used
    with _stage_lock:
        if _stage_used + nbytes > _STAGE_BUDGET:
            return False
        _stage_used += nbytes
        return True


def _stage_budget_release(nbytes: int) -> None:
    global _stage_used
    with _stage_lock:
        _stage_used = max(0, _stage_used - nbytes)


def _atomic_write(out_path: str, write_fn) -> None:
    """Write via a temp name + rename so an interrupted run never
    leaves a partial file that ``skip_existing`` would later trust.
    ``write_fn(tmp_path)`` produces the file."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp_path = (f"{out_path}.{os.getpid()}."
                f"{threading.get_ident()}.tmp")
    try:
        write_fn(tmp_path)
        os.replace(tmp_path, out_path)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)


def _encode_one(out_path: str, rgba_words: np.ndarray, quality: int,
                exif: bytes = b"", optimize: bool = False,
                chroma: str = "420", restart_rows: int = 0) -> None:
    """Encode a (H, W) u32 packed-RGBA image through PIL: an RGBA PNG,
    or a JPEG with the alpha stripped on the host, as the reference does
    (reference: main.rs:1778-1781). ``exif`` carries the camera
    provenance and orientation (raw/exif.py). A JPEG honours
    chroma='444' (subsampling=0), ``optimize`` and ``restart_rows``
    (PIL's restart_marker_rows is the same MCU-row unit as the native
    encoder's)."""
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
                         "(use .jpg/.jpeg/.png)")

    def write(tmp_path):
        if ext == ".png":
            img.save(tmp_path, format="PNG", exif=exif)
        else:
            kw = {"subsampling": 0} if chroma == "444" else {}
            if restart_rows > 0:
                kw["restart_marker_rows"] = int(restart_rows)
            img.convert("RGB").save(tmp_path, format="JPEG",
                                    quality=quality, exif=exif,
                                    optimize=optimize, **kw)

    _atomic_write(out_path, write)


class _Batcher:
    """Shape-bucketed batching with pad-to-fixed-size semantics."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.buckets: Dict[Tuple[int, int], List[_Decoded]] = {}

    def add(self, item: _Decoded) -> Optional[List[_Decoded]]:
        # Finish extras split the bucket: an extras-enabled graph shifts
        # zero-amount images by ±1 LSB, so mixing would make an unedited
        # image's bytes depend on which jobs share its batch. Locals and
        # the point-curve length split it too: their structure is uniform
        # per batch in the JAX package's programs.
        key = (item.mosaic.shape, item.cfa_phase,
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
                        restart_rows: int = 0) -> None:
    """Encode device-produced YCbCr planes (4:2:0, or full-size chroma
    for '444') through the native baseline JFIF encoder, with no host
    colorspace pass. Atomic like the PIL path. ``restart_rows`` > 0
    writes DRI/RSTn resilient streams; one thread per image, because the
    encode pool already spreads the images over the host cores."""
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

    def write(tmp_path):
        with open(tmp_path, "wb") as f:
            f.write(data)

    _atomic_write(out_path, write)


def _refuse_unported(mesh, bits, color_space, long_edge, rotate, crop, lens,
                     perspective, jobs) -> None:
    """``NotImplementedError`` naming each argument, and each edit, that
    this port cannot export yet (checked before any file is read)."""
    from raweditor_tpu_torch.ops.develop import require_ported

    if mesh is not None:
        raise NotImplementedError("not ported yet: mesh (multi-device "
                                  "export)")
    if bits not in (8, 16):
        raise ValueError("bits must be 8 or 16")
    if bits == 16:
        raise NotImplementedError("not ported yet: bits=16 (16-bit TIFF)")
    if color_space not in _COLOR_SPACES:
        raise ValueError(f"unknown color space {color_space!r}; expected "
                         f"one of {_COLOR_SPACES}")
    if color_space != "srgb":
        raise NotImplementedError(
            f"not ported yet: color_space={color_space!r}")
    _refuse_geometry(long_edge, rotate, crop, lens, perspective)
    for job in jobs:
        require_ported(job.params)


def _refuse_geometry(long_edge, rotate, crop, lens, perspective) -> None:
    """``NotImplementedError`` naming the first output-geometry argument
    that is set: the resize and the geometry stages are not ported yet
    (the engine's ``export`` refuses them the same way)."""
    for name, value in (("long_edge", long_edge), ("rotate", rotate)):
        if value:
            raise NotImplementedError(f"not ported yet: {name}")
    for name, value in (("crop", crop), ("lens", lens),
                        ("perspective", perspective)):
        if value is not None:
            raise NotImplementedError(f"not ported yet: {name}")


@contextlib.contextmanager
def _on(device: torch.device, stream=None):
    """The CUDA device (and ``stream``) current for a thread's work; a
    no-op on the CPU."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), (torch.cuda.stream(stream)
                                     if stream is not None
                                     else contextlib.nullcontext()):
        yield


def _record_event(device: torch.device):
    """An event recorded on the device's current stream, or None on the
    CPU (where every op has finished when it returns)."""
    if device.type != "cuda":
        return None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return done


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
    device="cuda",
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
    asks for ``"cpu"`` (the kernels' plain versions)."""
    from raweditor_tpu_torch.native import require_rawkit
    from raweditor_tpu_torch.ops.demosaic import DEMOSAIC_METHODS
    from raweditor_tpu_torch.ops.jpeg import (rgba_words_to_ycbcr420,
                                              rgba_words_to_ycbcr444)
    from raweditor_tpu_torch.raw.exif import build_exif
    from raweditor_tpu_torch.utils.device import resolve_device
    from raweditor_tpu_torch.utils.memory import (
        arena_cap_from_env, cap_malloc_arenas, trim_malloc)

    color_space = (color_space or "srgb").lower()
    _refuse_unported(mesh, bits, color_space, long_edge, rotate, crop, lens,
                     perspective, jobs)
    if mode not in ("parity", "accurate"):
        raise ValueError(f"unknown mode {mode!r}")
    if demosaic_method not in DEMOSAIC_METHODS + ("smooth",):
        raise ValueError(f"unknown demosaic method {demosaic_method!r}")
    if chroma not in ("420", "444"):
        raise ValueError(f"chroma must be '420' or '444', got {chroma!r}")
    if matrix_transpose is None:
        matrix_transpose = mode == "parity"
    # Polynomial forms of the transfers: within 1 LSB after u8
    # quantisation.
    if transfer is None:
        transfer = "gamma22_poly" if fast_gamma else "gamma22"
    elif fast_gamma and transfer == "srgb":
        transfer = "srgb_poly"
    encoder_for(transfer)  # validated up front, not deep in a flush
    gamma = kernel_gamma_for(transfer)
    device = resolve_device(device)
    # glibc arena retention made long-run RSS track cumulative decode
    # volume instead of the working set; cap arenas before the pools
    # below can create them, and trim between flushes (utils/memory.py).
    # 0 disables both.
    _arena_cap = arena_cap_from_env()
    if _arena_cap:
        cap_malloc_arenas(_arena_cap)

    report = ExportReport(total=len(jobs))
    t_start_progress = time.perf_counter()
    _progress_last = [0.0]

    def _note_progress(force: bool = False):
        """Rate-limited completion callback (≥1 s apart unless forced);
        never raises into the run."""
        if on_progress is None:
            return
        now = time.perf_counter()
        if not force and now - _progress_last[0] < 1.0:
            return
        _progress_last[0] = now
        try:
            on_progress(report.succeeded, len(report.failed),
                        report.total, now - t_start_progress)
        except Exception:  # noqa: BLE001 - observability must not
            pass           # fail the export

    if skip_existing:
        remaining = []
        for job in jobs:
            if os.path.exists(job.out_path):
                report.skipped += 1
            else:
                remaining.append(job)
        jobs = remaining

    # JPEG planes on the card and the native JFIF encoder whenever every
    # output still to be written is a JPEG (decided after the
    # skip_existing prune, from the extensions alone): 1.5 bytes a pixel
    # cross to the host for 4:2:0 (3 for 4:4:4) instead of 4, and the
    # encoder skips its colorspace pass. PNG runs and odd 4:2:0 frames
    # keep RGBA words and PIL. The encoder is required here, before any
    # file is read: a missing one raises naming its file instead of
    # moving the colour conversion to the host (RAWEDITOR_TPU_NO_NATIVE
    # switches the decoders' codec only).
    jpeg_planes_ok = bool(jobs) and all(
        j.out_path.lower().endswith((".jpg", ".jpeg")) for j in jobs)
    if jpeg_planes_ok:
        require_rawkit()
    fetch_stream = None
    if device.type == "cuda":
        with torch.cuda.device(device):
            fetch_stream = torch.cuda.Stream()
    t_start = time.perf_counter()
    _stage_run_begin()
    try:
        encode_futures: List[Tuple[Future, ExportJob]] = []
        # Batches in flight: the develop is launched asynchronously; the
        # fetch thread pulls results one batch behind, so the card's
        # work, host decode and encode, and both copies overlap.
        inflight: List[tuple] = []

        def submit_encodes(batch, host, encode_pool):
            for i, d in enumerate(batch):
                # Per-image copies: an encode job must not pin the whole
                # (B, H, W) batch array while it waits in the queue.
                exif = build_exif(d.make, d.model, d.orientation)
                if isinstance(host, tuple) and len(host) == 2:
                    # Kernel planes: Y + NV12-interleaved CbCr. The
                    # strided de-interleave copies are 2×(H/2·W/2) bytes
                    # on the host, noise next to the encode.
                    y, cbcr = host[0][i], host[1][i]
                    fut = encode_pool.submit(
                        _encode_one_jpeg420, d.job.out_path, y.copy(),
                        cbcr[:, 0::2].copy(), cbcr[:, 1::2].copy(),
                        quality, exif, jpeg_optimize, chroma,
                        jpeg_restart_rows
                    )
                elif isinstance(host, tuple):  # YCbCr plane triple
                    y, cb, cr = (p[i] for p in host)
                    fut = encode_pool.submit(
                        _encode_one_jpeg420, d.job.out_path, y.copy(),
                        cb.copy(), cr.copy(), quality, exif,
                        jpeg_optimize, chroma, jpeg_restart_rows
                    )
                else:
                    fut = encode_pool.submit(
                        _encode_one, d.job.out_path, host[i].copy(),
                        quality, exif, jpeg_optimize, chroma,
                        jpeg_restart_rows
                    )
                encode_futures.append((fut, d.job))
            # Backpressure: the card outruns host JPEG encode; without a
            # bound the queue would pin unbounded host buffers.
            max_inflight = 4 * encode_threads
            while len(encode_futures) > max_inflight:
                fut, job = encode_futures.pop(0)
                t_enc = time.perf_counter()
                try:
                    fut.result()
                    report.succeeded += 1
                except Exception as e:
                    report.failed.append((job.raw_path, f"encode: {e}"))
                report.encode_seconds += time.perf_counter() - t_enc
                _note_progress()

        def _fetch_batch(out, batch, t0, done):
            """Runs on the fetch thread: wait for the flush's event, then
            slice the padding off on the card (a drain-time bucket of 1
            would otherwise copy the replayed frames) and copy the rest
            to the host on the fetch stream."""
            if done is not None:
                done.synchronize()
            dev_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            n = len(batch)
            with _on(device, fetch_stream):
                if isinstance(out, tuple):  # YCbCr planes
                    host = tuple(p[:n].cpu().numpy() for p in out)
                    nbytes = sum(p.nbytes for p in host)
                else:
                    host = out[:n].cpu().numpy()
                    nbytes = host.nbytes
            return host, dev_s, time.perf_counter() - t1, nbytes

        def drain_inflight(encode_pool, depth: int):
            while len(inflight) > depth:
                fut, batch = inflight.pop(0)
                try:
                    host, dev_s, fetch_s, nbytes = fut.result()
                except Exception as e:  # device failure: the batch
                    # quarantines like any other per-image failure.
                    for d in batch:
                        report.failed.append(
                            (d.job.raw_path, f"device: {e}"))
                    _note_progress()
                    continue
                report.device_seconds += dev_s
                report.fetch_seconds += fetch_s
                report.fetch_bytes += nbytes
                submit_encodes(batch, host, encode_pool)

        def _stage_batch(batch, padded):
            """The (B, H, W) u16 batch on the device: staged buffers
            (waited for on this thread's stream and unpacked), else a
            flush-time upload."""
            from raweditor_tpu_torch.ops.staging import (unpack12_rows,
                                                         unpack14_rows)

            unpack = {"u12": unpack12_rows, "u14": unpack14_rows}
            # Resolve the upload futures first: one the upload thread
            # finished costs nothing; one still running is waited for
            # (upload time); a failed one degrades to a flush-time upload.
            t_res = time.perf_counter()
            for d in batch:
                if isinstance(d.staged, Future):
                    fut, d.staged = d.staged, None
                    try:
                        d.staged = fut.result()
                    except Exception:
                        _stage_budget_release(d.staged_nbytes)
                        d.staged_fmt = "raw"
                        d.staged_nbytes = 0
            report.upload_seconds += time.perf_counter() - t_res
            if not any(d.staged is not None for d in batch):
                return _host_tensor(np.stack(
                    [d.mosaic for d in padded])).to(device)
            # Use every staged buffer (an over-budget straggler must not
            # discard the bytes already copied); items without one upload
            # here.
            t_up = time.perf_counter()
            parts = []
            late_bytes = 0
            built = {}  # padding replays batch[0]: upload/unpack once
            for d in padded:
                if id(d) not in built:
                    if d.staged is None:
                        late = _host_tensor(d.mosaic)
                        late_bytes += late.numel() * late.element_size()
                        built[id(d)] = late.to(device)
                    else:
                        buf, done, _ = d.staged
                        if done is not None:
                            # The copy ran on the upload stream: this
                            # stream waits for it, and the allocator must
                            # not hand the buffer back to the upload
                            # stream while this stream still reads it.
                            stream = torch.cuda.current_stream(device)
                            stream.wait_event(done)
                            buf.record_stream(stream)
                        built[id(d)] = (unpack[d.staged_fmt](buf)
                                        if d.staged_fmt != "raw" else buf)
                parts.append(built[id(d)])
            mosaics = torch.stack(parts)
            report.upload_seconds += time.perf_counter() - t_up
            report.upload_bytes += late_bytes + sum(
                d.staged_nbytes for d in batch if d.staged is not None)
            return mosaics

        def _flush_dispatch(batch: List[_Decoded]):
            # Pad to the fixed batch shape; padding replays item 0 and is
            # dropped before encode.
            padded = batch + [batch[0]] * (batch_size - len(batch))
            mosaics = _stage_batch(batch, padded)
            params = [d.job.params for d in padded]
            wbs = np.stack([d.wb for d in padded])
            cms = np.stack([d.cam_matrix for d in padded])
            whites = np.array([d.white_level for d in padded], np.float32)
            blacks = np.array([d.black_level for d in padded], np.float32)
            phase = batch[0].cfa_phase
            xtrans = isinstance(phase, str)
            # Finish extras: the batch's static flags, ORed over its
            # images (zero-amount images inside such a batch develop
            # within 1 LSB of their extras-off render).
            ex_on = any(d.job.params.has_finish_extras() for d in batch)
            if ex_on:
                table, mixer_on, grading_on, stencils = pack_extras(params)
                ex_on = mixer_on or grading_on or stencils
            # Point curves ride the plain lane's finish; the develop
            # kernels do not compute them.
            curve_on = bool(batch[0].job.params.point_curve)
            h_m, w_m = mosaics.shape[1], mosaics.shape[2]
            planes = "rgba_words"
            if jpeg_planes_ok:
                if chroma == "444":
                    planes = "ycbcr444"
                elif h_m % 2 == 0 and w_m % 2 == 0:
                    planes = "ycbcr420"
            t0 = time.perf_counter()
            if use_kernel and not curve_on:
                cfa = (dict(pattern=phase,
                            demosaic=generic_cfa_method(demosaic_method))
                       if xtrans else dict(cfa_phase=phase,
                                           demosaic=demosaic_method))
                scal = pack_params(params, wbs, cms, whites, blacks,
                                   matrix_transpose).to(device)
                out = _fused.fused_batch_develop_rgba(
                    mosaics, scal, gamma=gamma,
                    output=("ycbcr420" if planes == "ycbcr420"
                            and not ex_on else "rgba"), **cfa)
            else:
                lane = dict(matrix_transpose=matrix_transpose,
                            transfer=transfer,
                            output="rgba_words" if ex_on else planes)
                if xtrans:
                    out = batch_develop_xtrans_rgba(
                        mosaics, params, wbs, cms, whites, blacks,
                        pattern=phase,
                        demosaic_method=generic_cfa_method(demosaic_method),
                        **lane)
                else:
                    out = batch_develop_rgba(
                        mosaics, params, wbs, cms, whites, blacks,
                        cfa_phase=phase, demosaic_method=demosaic_method,
                        **lane)
            if ex_on:
                # Extras on every route run the post-pass kernel over the
                # develop's words (its plain version for CPU tensors).
                out = _fx.fused_finish_extras_rgba(
                    out, table.to(device), mixer_on=mixer_on,
                    grading_on=grading_on, stencils=stencils,
                    output="ycbcr420" if planes == "ycbcr420" else "rgba")
            if planes != "rgba_words" and not isinstance(out, tuple):
                out = (rgba_words_to_ycbcr444(out) if planes == "ycbcr444"
                       else rgba_words_to_ycbcr420(out))
            return out, t0, _record_event(device)

        def flush(batch: List[_Decoded], encode_pool: ThreadPoolExecutor):
            try:
                out, t0, done = _flush_dispatch(batch)
            except Exception as e:  # a develop or kernel failure:
                # quarantine the batch like any per-image failure instead
                # of killing a long run; never route around the kernel.
                for d in batch:
                    report.failed.append((d.job.raw_path, f"develop: {e}"))
                    _note_progress()
                return
            finally:
                # Release the staging budget only now: until dispatch the
                # staged buffers were the live copies.
                for d in batch:
                    if d.staged is not None:
                        _stage_budget_release(d.staged_nbytes)
                        d.staged = None
                        d.staged_nbytes = 0
            inflight.append(
                (fetch_pool.submit(_fetch_batch, out, batch, t0, done),
                 batch))
            drain_inflight(encode_pool, depth=1)
            if _arena_cap:
                # The batch's host buffers were just freed; hand the pages
                # back instead of letting arenas retain them.
                trim_malloc()

        with ThreadPoolExecutor(decode_threads) as decode_pool, \
                ThreadPoolExecutor(encode_threads) as encode_pool, \
                ThreadPoolExecutor(1) as fetch_pool, \
                ThreadPoolExecutor(1) as upload_pool, \
                _on(device):
            uploader = _Uploader(upload_pool, device)
            batcher = _Batcher(batch_size)
            window = max(2 * batch_size, decode_threads * 2)
            pending: List[Tuple[Future, ExportJob]] = []
            job_iter = iter(jobs)

            def submit_next() -> bool:
                job = next(job_iter, None)
                if job is None:
                    return False
                pending.append(
                    (decode_pool.submit(_decode_job, job, mode, uploader),
                     job)
                )
                return True

            for _ in range(window):
                if not submit_next():
                    break

            while pending:
                fut, job = pending.pop(0)
                try:
                    decoded, decode_s, stage_s = fut.result()
                except Exception as e:
                    report.failed.append((job.raw_path, f"decode: {e}"))
                    _note_progress()
                else:
                    # Sum of worker time (can exceed wall clock with
                    # several decode threads: the host-CPU budget).
                    report.decode_seconds += decode_s
                    report.stage_seconds += stage_s
                    report.decode_megapixels += (
                        decoded.mosaic.shape[0] * decoded.mosaic.shape[1]
                        / 1e6)
                    full = batcher.add(decoded)
                    if full is not None:
                        flush(full, encode_pool)
                submit_next()

            for bucket in batcher.drain():
                flush(bucket, encode_pool)
            drain_inflight(encode_pool, depth=0)

            t0 = time.perf_counter()
            for fut, job in encode_futures:
                try:
                    fut.result()
                    report.succeeded += 1
                except Exception as e:
                    report.failed.append((job.raw_path, f"encode: {e}"))
                _note_progress()
            report.encode_seconds += time.perf_counter() - t0
            _note_progress(force=True)

    finally:
        # Always balance the run counter: an exception escaping this
        # function must not leave _stage_runs stuck above 0 (that would
        # disable the leaked-budget self-healing in _stage_run_begin).
        _stage_run_end()
    report.seconds = time.perf_counter() - t_start
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
