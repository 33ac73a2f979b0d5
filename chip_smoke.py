#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--profile-export]

Builds the CUDA kernels from ``raweditor_tpu_torch/csrc`` (one nvcc per
source, four sources started together), makes seeded 24 MP 12-bit frames
(4016x6016 Bayer, 4000x6000 X-Trans), and drives four paths through the
entry points a user calls, each with the launch counts set to 0 just
before it and read just after:

- the parity path: ``DevelopEngine`` slider ticks with histogram, the
  full-resolution kernel develop for the four transfers, JPEG export,
  and a batch of four frames to JPEG planes (nearest stencil);
- the accurate path: for the bilinear, Malvar and gradient demosaics
  with the sRGB transfer and its polynomial form, ``full_rgba_device``,
  ``jpeg_planes`` and ``export(".jpg")`` of the D3300-matrix frame, and
  a batch of four frames to JPEG planes with ``demosaic="grad"``;
- the extras path: an edit with sharpen, denoise, the tone curve,
  vignette, six HSL-mixer sliders and two grading wheels through slider
  ticks and the histogram, ``full_rgba_device``, ``jpeg_planes`` and
  ``export(".jpg")`` of the parity and the accurate Malvar engine (the
  develop kernel, then the finish-extras kernel), a mixer-only edit, an
  edit with a point curve (plain develop lane, then the extras kernel),
  and a batch of four frames: develop words, then the extras kernel to
  JPEG planes with per-image amounts;
- the X-Trans path: an accurate-mode frame whose ``cfa_pattern`` is the
  6x6 X-Trans grid, for the nearest, smooth and grad tiers with the sRGB
  transfer and its polynomial form: slider ticks, the histogram,
  ``full_rgba_device``, ``jpeg_planes`` and ``export(".jpg")``, once
  more with the extras edit (the generic-CFA develop kernel, then the
  extras kernel), and a batch of four frames to JPEG planes per tier;
- the file path: the port's writers make a 4016x6016 lossless-JPEG DNG
  and a 4000x6000 X-Trans RAF, ``Library.import_folder`` imports them,
  ``DevelopEngine.open`` decodes each (native codec) for three demosaics
  (DNG nearest, Malvar, grad; RAF nearest, smooth, grad), and
  ``full_rgba_device`` develops it with the slider edit and the extras
  edit: each call must launch its own kernel once and no other (B8 too
  with extras), and every result must be bit-equal to an engine built
  from the written fields in memory; the opened DNG is exported to JPEG
  with its make and model in the EXIF, and the extras edit goes through
  the catalog and back. It prints the write, decode, open, import and
  first-develop times (host clock, medians of three);
- the batch export path (``batch_export()``): the port's writers make
  five 12-bit and four 14-bit uncompressed 4016x6016 DNGs, three
  4000x6000 X-Trans RAFs (a seeded scene of gradients, discs and 1%
  noise) and one truncated file; ``Library.import_folder`` imports them,
  slider edits go on the 12-bit files and the extras edit (one flag set,
  amounts per file) on the 14-bit ones, and ``jobs_from_catalog`` feeds
  ``run_batch_export`` three times with batches of four: accurate grad
  (run A), parity nearest with restart markers and optimised tables (run
  B), run A again with ``skip_existing`` (run C). Each run must give its
  expected successes, skips and the one ``"decode: ..."`` failure and
  launch exactly its kernels (A: B4 planes twice, B4 words and B8 planes
  once each, B7 planes once; B: B2 planes three times, B1 words and B8
  planes once each; C: nothing), and every JPEG must equal, byte for
  byte, ``DevelopEngine.open(...).export(...)`` of the same file and edit
  with the same flags. It prints each run's ``ExportReport``. With
  ``--profile-export`` it repeats run A once under ``torch.profiler``
  (outside the counted runs) and prints the device's busy time and idle
  share of that profiled run.

Then it holds every kernel against its plain PyTorch version (at the four
Bayer phases and on an odd 4015x6013 frame; the extras kernel for every
flag set, on the odd frame, a 33x17 batch and at 24 MP; the generic-CFA
kernels at 24 MP, on the odd frame and on small frames around the tile
and period edges; the Bayer quad kernel (nearest, bilinear, Malvar) on 117
RGBA and 11 planes frames around its 128x16 tile and 64-row block and at each
width modulo its four columns a thread; the two grad kernels on 64 frames around their
strip and band edges, at the four Bayer phases and for periods 2, 3 and
6; the extras kernel and the generic-CFA nearest and smooth kernels on 49
RGBA and 6 planes frames each around theirs) and against the plain lane:
every develop kernel and the extras kernel must equal its plain version
exactly (0 LSB), the kernel route and the plain lane within 1 LSB. The
develop kernels quantise through an exact table derived from the plain
quantiser on the card: it is swept against that quantiser over every
f32 value in [0, 1] for each of the four transfers (1,065,353,217
values), values above 1, +inf, -0.0, negatives and denormals, and no
value may differ. It compares small frames on the card with the CPU,
times each kernel beside its plain version with CUDA events, and prints:

- a line ``{"kernels": [...]}`` with each kernel's launches on its path
  (and on the file path and in each export run), its largest difference
  from the plain version, both times, and its
  bound (the larger of bytes over 3.35 TB/s and f32 operations over
  67 TFLOP/s, the H100 SXM data-sheet rates);
- the seconds of each phase, the build included;
- the card's name and power limit as nvidia-smi reports them;
- as the last line ``{"ok": true, "device": {...}}``.

Any failure raises, so the exit code is not 0 and no result line is
printed. Exits with 2 when torch sees no CUDA device.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H, W = 4016, 6016  # Nikon D3300 full frame
SEED = 20261016
BATCH = 4
TIMING_REPS = 10
ACCURATE = ("bilinear", "malvar", "grad")
PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))
XH, XW = 4000, 6000  # the 24 MP frame of Fujifilm's X-Trans III bodies
XT_TIERS = ("nearest", "smooth", "grad")
# RGBA frames around the 32x16 tile, the 2x2 quad and the 6x6 period.
XT_SMALL = ((1, 1), (5, 7), (6, 6), (16, 32), (17, 33), (31, 45), (36, 48),
            (37, 65))
# Frames around the grad kernels' strip (56 output columns of a warp's 64)
# and band (64 output rows): one below, at and one above each and their
# doubles, and frames narrower or shorter than one; every height with
# every width. Periods 2, 3 and 6 for the generic-CFA kernel.
GRAD_EDGE_W = (1, 7, 55, 56, 57, 111, 112, 113)
GRAD_EDGE_H = (1, 9, 63, 64, 65, 127, 128, 129)
GRAD_EDGE_EVEN = ((2, 2), (62, 54), (64, 56), (66, 58), (128, 112),
                  (130, 114))
GRAD_PATTERNS = ("GRBG", "RGBGBRBRG")  # beside the 6x6 X-Trans grid
# The extras kernel (B8) marches a strip of 60 output columns (halo 2) in
# bands of 64 rows; the generic-CFA smooth kernel (B6) 62 columns (halo 1)
# in bands of 24 rows (csrc/extras.cu kStripW, kBandH; csrc/develop.cu
# kCfaStripW, kCfaBandH; a test holds these four against the sources).
EXTRAS_STRIP, EXTRAS_BAND = 60, 64
CFA_STRIP, CFA_BAND = 62, 24
# The Bayer quad kernel (B1-B3): a block of threads covers tiles of 128
# columns and 16 rows, four tiles down (64 rows), a thread four columns
# (two quads) of two rows (csrc/develop.cu kBayerTileW, kBayerTileH,
# kBayerBlockH, kThreadCols; a test holds them against it).
BAYER_TILE_W, BAYER_TILE_H, BAYER_BLOCK_H = 128, 16, 64
BAYER_THREAD_COLS = 4


def around(unit):
    """Sizes around a strip width or band height: a single pixel, one
    below, at and one above the unit and its double."""
    return (1, unit - 1, unit, unit + 1, 2 * unit - 1, 2 * unit, 2 * unit + 1)


def around_even(band, strip):
    """Even (h, w) frames around a band and strip, for 4:2:0 planes."""
    return ((2, 2), (band - 2, strip - 2), (band, strip),
            (band + 2, strip + 2), (2 * band, 2 * strip),
            (2 * band + 2, 2 * strip + 2))


EXTRAS_EDGE_W, EXTRAS_EDGE_H = around(EXTRAS_STRIP), around(EXTRAS_BAND)
EXTRAS_EDGE_EVEN = around_even(EXTRAS_BAND, EXTRAS_STRIP)
CFA_EDGE_W, CFA_EDGE_H = around(CFA_STRIP), around(CFA_BAND)
CFA_EDGE_EVEN = around_even(CFA_BAND, CFA_STRIP)
# Widths around the tile and two more that are 2 modulo the thread's four
# columns (a thread whose second quad lies past the edge).
BAYER_EDGE_W = around(BAYER_TILE_W) + (BAYER_TILE_W - 2, BAYER_TILE_W + 2)
BAYER_EDGE_H = around(BAYER_TILE_H) + around(BAYER_BLOCK_H)[1:]
BAYER_EDGE_EVEN = (around_even(BAYER_TILE_H, BAYER_TILE_W)
                   + around_even(BAYER_BLOCK_H, BAYER_TILE_W)[1:])
# The sweep of the table quantiser: chunks of f32 bit patterns, and f32 1.0.
SWEEP_CHUNK = 1 << 26
ONE_BITS = 0x3F800000
# The quad stencils' tiers and the patterns each takes beside the X-Trans
# grid (a Bayer grid's nearest B of an R site lies on a diagonal, which is
# not one of the nearest kernel's five taps).
CFA_EDGE_PATTERNS = {"nearest": ("RGBGBRBRG",),
                     "smooth": ("GRBG", "RGBGBRBRG")}
SRC = {"develop": "raweditor_tpu_torch/csrc/develop.cu",
       "grad": "raweditor_tpu_torch/csrc/develop_grad.cu",
       "cfa_grad": "raweditor_tpu_torch/csrc/develop_grad_generic.cu",
       "extras": "raweditor_tpu_torch/csrc/extras.cu"}
TPU_KERNEL = "raweditor_tpu/ops/pallas_develop.py"
# The TPU function each kernel variant replaces (file:line).
REPLACES = {("nearest", "rgba"): 983, ("nearest", "ycbcr420"): 879,
            "bilinear": 199, "malvar": 199, "grad": 412,
            "cfa_nearest": 753, "cfa_smooth": 495, "cfa_grad": 565,
            "extras_rgba": 1379, "extras_ycbcr420": 1258}
# The extras path's edit: every band-local extra, six mixer sliders and
# two grading wheels.
XEDIT = dict(sharpen=60.0, denoise=40.0, curve_shadows=30.0,
             curve_darks=-20.0, curve_lights=15.0, curve_highlights=-40.0,
             vignette=-30.0, hue_red=25.0, hue_orange=-15.0, sat_yellow=30.0,
             sat_blue=-40.0, lum_green=35.0, lum_magenta=-25.0,
             grade_shadow_hue=210.0, grade_shadow_sat=40.0,
             grade_high_hue=45.0, grade_high_sat=30.0)
MIXER_ONLY = dict(hue_red=25.0, hue_orange=-15.0, sat_yellow=30.0,
                  sat_blue=-40.0, lum_green=35.0, lum_magenta=-25.0)
POINT_CURVE = ((0.0, 0.02), (0.35, 0.3), (0.7, 0.8), (1.0, 0.97))
FLAG_SETS = [(m, g, s) for m in (False, True) for g in (False, True)
             for s in (False, True)]
# The batch export path: files of each kind, and the batch size.
EXPORT_FILES = {"dng12": 5, "dng14": 4, "raf": 3}
EXPORT_BATCH = 4
# Nikon D3300 ColorMatrix (dcraw adobe_coeff, x10000) for the accurate frame.
D3300_XYZ_TO_CAM = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                             [-1485, 2204, 7318]], np.float32) / 10000.0
# Fujifilm X-T2 (X-Trans III) ColorMatrix, the same source.
XT2_XYZ_TO_CAM = np.array([[11434, -4948, -1210], [-3746, 12042, 1903],
                           [-666, 1479, 5235]], np.float32) / 10000.0

# The bound: H100 SXM data-sheet rates (HBM, f32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per pixel, counted in the kernels' source with each
# shared subexpression once and averaged over the four Bayer sites;
# powf, sqrtf and a division count one each, so this is a lower bound.
DEMOSAIC_OPS = {"nearest": 1.0,    # raw * scale
                "bilinear": 7.0,   # + the neighbour sums and means
                "malvar": 24.5,    # + the four 5x5 filters, 3 floors
                "grad": 52.0,      # G 8.5, R/B 6.5, 2 refinements 36
                # The generic-CFA tiers (cfa_nearest, cfa_smooth,
                # cfa_grad) are counted from the pattern itself by
                # cfa_demosaic_ops() when the run starts.
                }
FINISH_OPS = 60.0                  # matrix, tone, saturation/vibrance
QUANT_OPS = {"pow": 6.0, "poly": 18.0, "srgb": 10.0, "srgb_poly": 20.0}
YCBCR_OPS = 23.5                   # Y, Cb, Cr and the 2x2 chroma box
# The extras kernel per output pixel (csrc/extras.cu, halo recompute not
# counted): unpack and quantise 12; the stencil stages 172 (two chroma
# tents 28, chroma blend 6, the bilateral's 8 taps 69, tone curve 28,
# vignette 11, sharpen 10, split/rebuild 14, clamps 6); the mixer 200
# (hue 23, nine hats 63, three interpolations 51, back-convert and blend
# 63); grading 56.
EXTRAS_OPS = {"io": 12.0, "stencils": 172.0, "mixer": 200.0,
              "grading": 56.0}


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def lsb_diff(a, b):
    """(max abs per-channel difference, share of differing pixels) of two
    packed RGBA word tensors."""
    from raweditor_tpu_torch.ops.develop import unpack_rgba

    d = torch.stack([(x - y).abs() for x, y in zip(unpack_rgba(a),
                                                   unpack_rgba(b))])
    return int(d.max()), float((d.amax(0) > 0).float().mean())


def plane_diff(a, b):
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return int(d.max()), float((d > 0).float().mean())


def planes_diff(a, b):
    """Largest difference over matching JPEG planes."""
    return max(plane_diff(x, y)[0] for x, y in zip(a, b))


def cuda_ms(fn, reps):
    """Per-run milliseconds (CUDA events) of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def host_ms(fn, reps):
    """Median host-clock milliseconds of ``fn`` plus a device sync, after
    one warm-up: what a caller of the entry point waits."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def cfa_demosaic_ops(grid):
    """f32 operations per pixel that the generic-CFA demosaics need on the
    channel grid ``grid`` (side x side of 0/1/2 = R/G/B), averaged over the
    period's cells: {"cfa_nearest", "cfa_smooth", "cfa_grad"}.

    Only the taps the pattern fills are counted. A masked tap is an exact
    zero, and adding it, doubling it or dividing by a denominator of one
    changes no bit, so a kernel need not do it; the kernels' factored
    order (column sums (a + b*2) + c, then the row sum) is kept, a select
    and an abs are free, a division counts one."""
    side = grid.shape[0]
    tent_w = (1, 2, 1)

    def at(y, x, chan):
        return bool(grid[y % side, x % side] == chan)

    def sum3(a, b, c):
        """(ops, nonzero) of (a + b*2) + c over known-zero flags."""
        return int(b) + int(a and b) + int((a or b) and c), a or b or c

    def tent2(y, x, chan):
        """The masked 3x3 tent of ``chan`` around (y, x), its division
        included."""
        ops, cols, den = 0, [], 0
        for dx in (-1, 0, 1):
            fill = [at(y + dy, x + dx, chan) for dy in (-1, 0, 1)]
            n, nz = sum3(*fill)
            ops += n
            cols.append(nz)
            den += tent_w[dx + 1] * sum(w for w, f in zip(tent_w, fill) if f)
        n, nz = sum3(*cols)
        return ops + n + int(nz and den != 1)

    def tent1(y, x, dy, dx):
        """The masked 1-D G tent along (dy, dx) at a non-G cell: (ops,
        nonzero)."""
        a, c = at(y - dy, x - dx, 1), at(y + dy, x + dx, 1)
        return int(a and c) + int(a + c > 1), a or c

    smooth = grad = 0
    for y in range(side):
        for x in range(side):
            here = int(grid[y, x])
            smooth += sum(tent2(y, x, c) for c in range(3) if c != here)
            if here != 1:
                # G: the two directional tents, the two gradient weights
                # (sub, add, div), the blend (two products, their sum,
                # the weights' sum, the division); then value - G.
                (nh, zh), (nv, zv) = tent1(y, x, 0, 1), tent1(y, x, 1, 0)
                grad += nh + nv + 6 + int(zh) + int(zv) + int(zh and zv) + 2
                grad += 1
            # R and B where missing: the tent of value - G, then + G.
            grad += sum(tent2(y, x, c) + 1 for c in (0, 2) if c != here)
    cells = float(side * side)
    # cfa_nearest: raw * scale; cfa_grad: + the two chroma refinements on
    # dense planes, 36 as for the Bayer kernel.
    return {"cfa_nearest": 1.0, "cfa_smooth": 1.0 + smooth / cells,
            "cfa_grad": 1.0 + grad / cells + 36.0}


def bound(n_px, demosaic, gamma, output):
    """(ms, "bytes" or "operations"): the least time the card could take
    for ``n_px`` pixels of one kernel variant."""
    out_bytes = 4.0 if output == "rgba" else 1.5
    ops = (DEMOSAIC_OPS[demosaic] + FINISH_OPS + 3 * QUANT_OPS[gamma]
           + (YCBCR_OPS if output == "ycbcr420" else 0.0))
    t_bytes = n_px * (2.0 + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n_px * ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def extras_bound(n_px, mixer_on, grading_on, stencils, output):
    """(ms, "bytes" or "operations") for the extras kernel: 4 B/px read,
    4 (RGBA) or 1.5 (planes) B/px written."""
    ops = (EXTRAS_OPS["io"] + EXTRAS_OPS["stencils"] * stencils
           + EXTRAS_OPS["mixer"] * mixer_on
           + EXTRAS_OPS["grading"] * grading_on
           + (YCBCR_OPS if output == "ycbcr420" else 0.0))
    out_bytes = 4.0 if output == "rgba" else 1.5
    t_bytes = n_px * (4.0 + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n_px * ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset(launches):
    for k in launches:
        launches[k] = 0


def host_once(fn):
    """(result, host-clock ms) of ``fn`` with a device sync before and
    after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def exif_of(jpeg):
    """The EXIF payload of a JPEG's first segment (APP1 right after SOI,
    where the exporter splices it), or b"" when there is none."""
    if jpeg[:4] != b"\xff\xd8\xff\xe1":
        return b""
    n = int.from_bytes(jpeg[4:6], "big")
    body = jpeg[6: 4 + n]
    return body if body.startswith(b"Exif\0\0") else b""


def file_path(tmpdir, mosaic, edit, xedit, smi):
    """The path from a file on disk: the port's writers make a 4016x6016
    12-bit lossless-JPEG DNG (D3300 matrix, black 150, white 4095) and a
    4000x6000 X-Trans RAF from the seeded mosaic; ``Library`` imports the
    folder (a second import skips both); ``DevelopEngine.open`` each file
    with the native codec for three demosaics; ``full_rgba_device`` with
    the slider edit and the extras edit; ``export(".jpg")`` of the DNG
    with its EXIF; the extras edit saved to and loaded from the catalog.

    The launch counts are reset just before and read just after the path;
    each develop must raise exactly its kernel's count by one (B8 too with
    the extras edit). Then, outside the counted path: every output is held
    bit-equal to an engine built from the written fields in memory. Returns
    (the path's launch counts, its host times)."""
    from raweditor_tpu_torch import (DevelopEngine, Library, RawImage,
                                     decode_raw)
    from raweditor_tpu_torch.native import get_rawkit
    from raweditor_tpu_torch.ops import fused_develop as fused
    from raweditor_tpu_torch.ops import fused_extras as fx
    from raweditor_tpu_torch.raw import raf, synth

    rk = get_rawkit()
    check(rk is not None, "no native codec: the timed decode would be the "
          "pure-Python one")
    xtrans = fused.cfa_generic.XTRANS_PATTERN
    files = os.path.join(tmpdir, "files")
    os.makedirs(files)
    gray = np.full((16, 16), 128, np.uint8)
    chroma = np.full((8, 8), 128, np.uint8)
    preview = rk.encode_jpeg_420(gray, chroma, chroma, 16, 16, 90, False, 0,
                                 0)
    # What is written, as the decoder must read it back: WB from the
    # as-shot neutral (0.5, 1, 0.625) and the GRBG record (256, 512, 384,
    # 256) are exact in both containers; the bare RAF has no levels or
    # matrix, so its white is the mosaic's maximum.
    xt_mosaic = np.ascontiguousarray(mosaic[:XH, :XW])
    written = {
        os.path.join(files, "DSC_0001.dng"): dict(
            mosaic=mosaic, wb_multipliers=[2.0, 1.0, 1.6, 1.0],
            xyz_to_cam=D3300_XYZ_TO_CAM, black_level=150.0,
            white_level=4095.0, cfa_pattern="RGGB",
            camera_make="NIKON CORPORATION", camera_model="NIKON D3300"),
        os.path.join(files, "DSCF0001.RAF"): dict(
            mosaic=xt_mosaic, wb_multipliers=[2.0, 1.0, 1.5, 1.0],
            xyz_to_cam=np.eye(3, dtype=np.float32), black_level=0.0,
            white_level=float(xt_mosaic.max()), cfa_pattern=xtrans,
            camera_make="FUJIFILM", camera_model="X-T2"),
    }
    dng_path, raf_path = written
    times = {}
    _, times["write_dng_ms"] = host_once(lambda: synth.write_synthetic_raw(
        dng_path, mosaic, bpp=12, compression="ljpeg",
        wb_neutral=(0.5, 1.0, 0.625), xyz_to_cam=D3300_XYZ_TO_CAM,
        black_level=150, white_level=4095, make="NIKON CORPORATION",
        model="NIKON D3300", preview_jpeg=preview))
    data, times["write_raf_ms"] = host_once(lambda: raf.write_raf(
        xt_mosaic, model="X-T2", wb_grbg=(256, 512, 384, 256)))
    with open(raf_path, "wb") as f:
        f.write(data)
    del data
    sizes = {os.path.basename(p): os.path.getsize(p) for p in written}

    def same_frame(raw, path):
        want = written[path]
        for name, value in want.items():
            got = getattr(raw, name)
            if isinstance(value, (np.ndarray, list)):
                value = np.asarray(value, np.asarray(got).dtype)
                check(np.array_equal(got, value), f"{path}: decoded {name} "
                      "differs from the one written")
            else:
                check(got == value, f"{path}: decoded {name} {got!r}, "
                      f"written {value!r}")

    for path in written:
        raws = [host_once(lambda: decode_raw(path)) for _ in range(3)]
        same_frame(raws[0][0], path)
        times[f"decode_{path[-3:].lower()}_ms"] = statistics.median(
            ms for _, ms in raws)
        del raws
    def import_into(db):
        with Library(os.path.join(tmpdir, db)) as timed:
            return timed.import_folder(files)

    imports = [host_once(lambda: import_into(f"catalog_t{i}.db"))
               for i in range(3)]
    check(all(r == {"imported": 2, "skipped": 0} for r, _ in imports),
          f"timed imports {[r for r, _ in imports]}")
    times["import_folder_ms"] = statistics.median(ms for _, ms in imports)

    def launching(want, fn, *args):
        """``fn(*args)``, which must add one launch to each key of
        ``want`` and to no other key."""
        before = {**fused.LAUNCHES, **fx.LAUNCHES}
        out = fn(*args)
        moved = {k: v - before[k] for k, v in {**fused.LAUNCHES,
                                               **fx.LAUNCHES}.items()
                 if v != before[k]}
        check(moved == {k: 1 for k in want},
              f"{fn.__name__} launched {moved}, expected one each of "
              f"{want}")
        return out

    methods = {dng_path: ("nearest", "malvar", "grad"),
               raf_path: ("nearest", "smooth", "grad")}
    out = {}
    # -- the counted path: counts reset just before, read just after ------
    reset(fused.LAUNCHES)
    reset(fx.LAUNCHES)
    t0 = time.perf_counter()
    lib = Library(os.path.join(tmpdir, "catalog.db"))
    first = lib.import_folder(files)
    second = lib.import_folder(files)
    check(first == {"imported": 2, "skipped": 0}
          and second == {"imported": 0, "skipped": 2},
          f"imports {first}, then {second}")
    open_ms, first_ms = {p: [] for p in written}, {p: [] for p in written}
    for path, ms in methods.items():
        pattern = xtrans if path == raf_path else None
        for m in ms:
            eng, t = host_once(lambda: DevelopEngine.open(
                path, mode="accurate", use_kernel=True, demosaic_method=m))
            open_ms[path].append(t)
            same_frame(eng.raw, path)
            check(eng.xtrans_pattern == pattern, f"{path}: routed as "
                  f"{eng.xtrans_pattern!r}")
            key = fused.launch_key("rgba", m, pattern)
            words, t = host_once(lambda: launching(
                [key], eng.full_rgba_device, edit))
            first_ms[path].append(t)
            x_words = launching([key, "extras_rgba"], eng.full_rgba_device,
                                xedit)
            out[path, m] = (words, x_words)
            if (path, m) == (dng_path, "nearest"):
                kept = eng
            del eng
    jpg = launching(["develop_ycbcr420"], kept.export,
                    os.path.join(tmpdir, "opened.jpg"), edit)
    with open(jpg, "rb") as f:
        jpeg = f.read()
    image_id = next(i.id for i in lib.get_all_images() if i.path == dng_path)
    lib.save_edit_params(image_id, xedit)
    lib.close()
    with Library(os.path.join(tmpdir, "catalog.db")) as again:
        loaded = again.load_edit_params(image_id)
    loaded_words = launching(["develop_rgba", "extras_rgba"],
                             kept.full_rgba_device, loaded)
    torch.cuda.synchronize()
    path_launches = {k: v for k, v in {**fused.LAUNCHES,
                                       **fx.LAUNCHES}.items() if v}
    log(f"file path: {time.perf_counter() - t0:.2f} s, launches "
        f"{path_launches}; files {sizes} bytes")

    # -- checks outside the counted path ----------------------------------
    exif = exif_of(jpeg)
    check(jpeg[-2:] == b"\xff\xd9" and len(jpeg) > mosaic.size // 4
          and b"NIKON CORPORATION\0" in exif and b"NIKON D3300\0" in exif,
          f"export of the opened DNG: {len(jpeg)} bytes, EXIF {exif[:64]!r}")
    check(loaded == xedit, "the edit loaded from the catalog differs")
    check(torch.equal(loaded_words, out[dng_path, "nearest"][1]),
          "the loaded edit develops to other words")
    for (path, m), (words, x_words) in out.items():
        fields = {k: v for k, v in written[path].items()
                  if not k.startswith("camera_")}
        mem = DevelopEngine(RawImage.from_fields(fields), mode="accurate",
                            use_kernel=True, demosaic_method=m)
        check(torch.equal(words, mem.full_rgba_device(edit))
              and torch.equal(x_words, mem.full_rgba_device(xedit)),
              f"{os.path.basename(path)} {m}: opened frame develops unlike "
              "the same fields in memory")
        del mem
    del out, loaded_words
    torch.cuda.empty_cache()
    for path in written:
        ext = path[-3:].lower()
        times[f"open_{ext}_ms"] = statistics.median(open_ms[path])
        times[f"first_full_rgba_{ext}_ms"] = statistics.median(first_ms[path])
    log("file path: six opens bit-equal to the same fields in memory, with "
        "and without extras; export EXIF make/model present; edit "
        f"round-tripped; times (host clock, median of 3, device synced): "
        f"{json.dumps(times)} [{smi}]")
    return path_launches


def scene(rng, h, w, top):
    """A seeded picture rather than noise, as u16 samples in 0..top: smooth
    gradients, discs of flat tone and about 1% noise."""
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = 0.1 + 0.45 * x + 0.3 * y * (1.0 - x)
    for _ in range(6):
        cy, cx = rng.uniform(0.1, 0.9, 2)
        r = rng.uniform(0.04, 0.15)
        disc = (y - np.float32(cy)) ** 2 + ((x - np.float32(cx)) * (w / h)) ** 2
        img = np.where(disc < r * r, np.float32(rng.uniform(0.05, 0.95)), img)
    img += rng.standard_normal((h, w), dtype=np.float32) * np.float32(0.01)
    return np.clip(img * top, 0, top).astype(np.uint16)


def profile_run_a(lib, tmpdir, kw, n_ok, timed_seconds, smi):
    """Run A once more, outside the counted runs, under the profiler: the
    device's busy time (the union of its kernels' and copies' intervals)
    and idle share, both of this profiled run alone; the counted run's
    wall clock beside it says how much the profiler slows the run."""
    from torch.profiler import ProfilerActivity, profile

    from raweditor_tpu_torch.pipeline.export import (jobs_from_catalog,
                                                     run_batch_export)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep = run_batch_export(jobs_from_catalog(
            lib, os.path.join(tmpdir, "export_profiled")),
            batch_size=EXPORT_BATCH, use_kernel=True, quality=95, **kw)
        torch.cuda.synchronize()
    check(rep.succeeded == n_ok, f"profiled run A: {rep.as_dict()}")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda t: -t[1])[:10]
    log("batch export run A under the profiler: "
        + (f"device busy {busy_us / 1e3:.3f} ms in {len(spans)} device "
           f"events over {rep.seconds * 1e3:.1f} ms, idle share "
           f"{1.0 - busy_us / 1e6 / rep.seconds:.5f} of this profiled run; "
           f"the counted run A took {timed_seconds * 1e3:.1f} ms unprofiled;"
           f" device ms by name {json.dumps(by_name)}" if spans else
           "the profiler saw no device event: device busy not measured")
        + f" [{smi}]")


def batch_export(tmpdir, edit, xedit, smi, profile=False):
    """The batch exporter from a catalog: files written by the port's own
    writers (``EXPORT_FILES`` of a seeded scene, rolled per file, and one
    truncated DNG), imported into a ``Library`` with per-file edits, then
    ``run_batch_export`` of ``jobs_from_catalog`` three times (runs A, B,
    C; module docstring). Each run is counted alone (launch counts reset
    just before it, read just after) and must launch exactly its kernels;
    then, outside the counted runs, every JPEG is held byte-equal to the
    engine's export of the same file and edit with the same flags. With
    ``profile``, run A is repeated once under the profiler for the
    device's busy time. Returns {run: launches}."""
    from concurrent.futures import ThreadPoolExecutor

    from raweditor_tpu_torch import DevelopEngine, Library
    from raweditor_tpu_torch.native import get_rawkit
    from raweditor_tpu_torch.ops import fused_develop as fused
    from raweditor_tpu_torch.ops import fused_extras as fx
    from raweditor_tpu_torch.pipeline.export import (jobs_from_catalog,
                                                     run_batch_export)
    from raweditor_tpu_torch.raw import raf, synth

    xtrans = fused.cfa_generic.XTRANS_PATTERN
    rk = get_rawkit()
    gray = np.full((16, 16), 128, np.uint8)
    chroma = np.full((8, 8), 128, np.uint8)
    preview = rk.encode_jpeg_420(gray, chroma, chroma, 16, 16, 90, False, 0,
                                 0)
    folder = os.path.join(tmpdir, "export_files")
    os.makedirs(folder)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 1)
    bases = {"dng12": scene(rng, H, W, 4095), "dng14": scene(rng, H, W, 16383),
             "raf": scene(rng, XH, XW, 4095)}

    def write(kind, i):
        m = np.roll(bases[kind], (97 * i, 211 * i), axis=(0, 1))
        if kind == "raf":
            path = os.path.join(folder, f"DSCF{i + 1:04d}.RAF")
            with open(path, "wb") as f:
                f.write(raf.write_raf(m, model="X-T2",
                                      wb_grbg=(256, 512, 384, 256)))
            return path
        bits = 12 if kind == "dng12" else 14
        path = os.path.join(folder, f"D{bits}_{i + 1:04d}.dng")
        synth.write_synthetic_raw(
            path, m, bpp=bits, xyz_to_cam=D3300_XYZ_TO_CAM,
            black_level=150 if bits == 12 else 600,
            white_level=(1 << bits) - 1, wb_neutral=(0.5, 1.0, 0.625),
            make="NIKON CORPORATION", model="NIKON D3300",
            preview_jpeg=preview)
        return path

    with ThreadPoolExecutor(4) as pool:
        paths = list(pool.map(lambda a: write(*a), [
            (k, i) for k, n in EXPORT_FILES.items() for i in range(n)]))
    del bases
    truncated = os.path.join(folder, "D12_9999.dng")
    with open(paths[0], "rb") as f, open(truncated, "wb") as g:
        g.write(f.read()[: os.path.getsize(paths[0]) // 2])
    write_s = time.perf_counter() - t0
    sizes = {os.path.basename(p): os.path.getsize(p) for p in paths[:1]
             + paths[EXPORT_FILES["dng12"]:][:1] + paths[-1:]}

    lib = Library(os.path.join(tmpdir, "export.db"))
    imported = lib.import_folder(folder)
    check(imported == {"imported": len(paths) + 1, "skipped": 0},
          f"export catalog import {imported}")
    for img in lib.get_all_images():
        i = int(img.filename[4:8]) - 1
        if img.filename.startswith("D12_") and img.path != truncated:
            lib.save_edit_params(img.id, edit.replace(
                exposure=-0.4 + 0.2 * i, saturation=10.0 * i,
                temperature=0.05 * i))
        elif img.filename.startswith("D14_"):
            lib.save_edit_params(img.id, xedit.replace(**{
                k: v * (0.5 + 0.25 * i) for k, v in XEDIT.items()}))
    runs = {
        "A": dict(mode="accurate", demosaic_method="grad"),
        "B": dict(mode="parity", demosaic_method="nearest",
                  jpeg_restart_rows=8, jpeg_optimize=True),
        "C": dict(mode="accurate", demosaic_method="grad",
                  skip_existing=True),
    }
    want = {
        "A": {fused.launch_key("ycbcr420", "grad"): 2,
              fused.launch_key("rgba", "grad"): 1, "extras_ycbcr420": 1,
              fused.launch_key("ycbcr420", "grad", xtrans): 1},
        "B": {"develop_ycbcr420": 3, "develop_rgba": 1,
              "extras_ycbcr420": 1},
        "C": {},
    }
    n_ok = len(paths)
    launched, jobs_of = {}, {}
    for name, kw in runs.items():
        out = os.path.join(tmpdir, "export_" + ("A" if name == "C" else name))
        jobs = jobs_from_catalog(lib, out)
        check(len(jobs) == n_ok + 1, f"run {name}: {len(jobs)} jobs")
        # -- the counted run: counts reset just before, read just after --
        reset(fused.LAUNCHES)
        reset(fx.LAUNCHES)
        rep = run_batch_export(jobs, batch_size=EXPORT_BATCH, use_kernel=True,
                               quality=95, **kw)
        torch.cuda.synchronize()
        launched[name] = {k: v for k, v in {**fused.LAUNCHES,
                                            **fx.LAUNCHES}.items() if v}
        log(f"batch export run {name} {json.dumps(kw)}: "
            f"{json.dumps(rep.as_dict())}; develops_per_sec "
            f"{rep.develops_per_sec!r}; launches {launched[name]}; host "
            f"{os.cpu_count()} cores, torch threads {torch.get_num_threads()}"
            f" [{smi}]")
        skipped = n_ok if name == "C" else 0
        check((rep.total, rep.succeeded, rep.skipped) == (
            n_ok + 1, n_ok - skipped, skipped),
            f"run {name}: total/succeeded/skipped {rep.total}, "
            f"{rep.succeeded}, {rep.skipped}")
        check(len(rep.failed) == 1 and rep.failed[0][0] == truncated
              and rep.failed[0][1].startswith("decode: "),
              f"run {name}: failures {rep.failed}")
        check(launched[name] == want[name],
              f"run {name} launched {launched[name]}, expected {want[name]}")
        jobs_of[name] = jobs
        if name == "A":
            timed_seconds = rep.seconds
    if profile:
        profile_run_a(lib, tmpdir, runs["A"], n_ok, timed_seconds, smi)

    # -- each JPEG against the engine's export of the same file ----------
    def engine_bytes(name, job):
        kw = runs[name]
        eng = DevelopEngine.open(job.raw_path, kw["mode"], use_kernel=True,
                                 demosaic_method=kw["demosaic_method"])
        ref = eng.export(
            os.path.join(tmpdir, f"engine_{name}_{job.image_id}.jpg"),
            job.params, quality=95,
            **{k: v for k, v in kw.items() if k.startswith("jpeg_")})
        with open(ref, "rb") as f, open(job.out_path, "rb") as g:
            return job.out_path, f.read() == g.read()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        same = list(pool.map(lambda a: engine_bytes(*a), [
            (name, job) for name in ("A", "B") for job in jobs_of[name]
            if job.raw_path != truncated]))
    for path, equal in same:
        check(equal, f"{path} differs from the engine's export")
    lib.close()
    torch.cuda.empty_cache()
    log(f"batch export: {len(same)} JPEGs byte-equal to the engine's export "
        f"({time.perf_counter() - t0:.2f} s, four threads); files written "
        f"in {write_s:.2f} s, sizes {sizes} bytes")
    return launched


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-export", action="store_true",
                    help="repeat export run A under torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_s, lap_at = {}, [t_start]

    def lap(name):
        """Seconds since the previous phase ended, under ``name``."""
        now = time.perf_counter()
        phase_s[name] = round(now - lap_at[0], 2)
        lap_at[0] = now
    from raweditor_tpu_torch import DevelopEngine, EditParams, RawImage
    from raweditor_tpu_torch.color import cam_to_srgb_matrix, kernel_gamma_for
    from raweditor_tpu_torch.native import get_rawkit
    from raweditor_tpu_torch.ops import _build
    from raweditor_tpu_torch.ops import fused_develop as fused
    from raweditor_tpu_torch.ops import fused_extras as fx
    from raweditor_tpu_torch.parallel.batch import (
        batch_develop_rgba, batch_develop_xtrans_rgba, pack_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    lap("build")

    # -- inputs -----------------------------------------------------------
    rng = np.random.default_rng(SEED)
    mosaic = rng.integers(0, 4096, size=(H, W), dtype=np.uint16)
    wb4 = np.array([2.0, 1.0, 1.5, 1.0], np.float32)
    parity_raw = RawImage(mosaic, wb4, np.eye(3, dtype=np.float32))
    accurate_raw = RawImage(mosaic, wb4, D3300_XYZ_TO_CAM, black_level=150.0,
                            white_level=4095.0, cfa_pattern="RGGB")
    engines = {
        "gamma22": DevelopEngine(parity_raw, "parity", use_kernel=True,
                                 device="cuda"),
        "gamma22_poly": DevelopEngine(parity_raw, "parity", use_kernel=True,
                                      fast_gamma=True, device="cuda"),
        "srgb": DevelopEngine(accurate_raw, "accurate", use_kernel=True,
                              transfer="srgb", device="cuda"),
        "srgb_poly": DevelopEngine(accurate_raw, "accurate", use_kernel=True,
                                   transfer="srgb", fast_gamma=True,
                                   device="cuda"),
    }
    eng = engines["gamma22"]
    accurate = {(m, fast): DevelopEngine(
        accurate_raw, "accurate", use_kernel=True, transfer="srgb",
        fast_gamma=fast, demosaic_method=m, device="cuda")
        for m in ACCURATE for fast in (False, True)}
    edit = EditParams(exposure=0.4, contrast=6.0, highlights=-0.3,
                      shadows=0.25, whites=1.05, blacks=0.03,
                      saturation=20.0, vibrance=0.4, temperature=0.1,
                      tint=-0.05)
    batch_params = [edit, EditParams(),
                    EditParams(exposure=-1.2, saturation=-40.0),
                    EditParams(exposure=1.1, contrast=-5.0, vibrance=-0.5,
                               temperature=-0.3)]
    batch_np = np.stack([mosaic] + [rng.integers(0, 4096, size=(H, W),
                                                 dtype=np.uint16)
                                    for _ in range(BATCH - 1)])
    batch = torch.from_numpy(batch_np).cuda()
    batch_wb = np.array([[2.0, 1.0, 1.5], [1.8, 1.0, 1.4], [2.2, 1.0, 1.3],
                         [1.0, 1.0, 1.0]], np.float32)
    batch_cm = np.tile(np.eye(3, dtype=np.float32), (BATCH, 1, 1))
    batch_scal = pack_params(batch_params, batch_wb, batch_cm,
                             white_levels=[4096.0, 4096.0, 4095.0, 4000.0],
                             black_levels=[0.0, 0.0, 150.0, 64.0]).cuda()
    # The accurate batch as the batch exporter folds it: camera matrix,
    # real levels, no WGSL transpose.
    acc_levels = dict(white_levels=[4095.0, 4095.0, 4000.0, 16383.0],
                      black_levels=[150.0, 150.0, 64.0, 512.0])
    acc_cm = np.tile(cam_to_srgb_matrix(D3300_XYZ_TO_CAM, "accurate"),
                     (BATCH, 1, 1))
    acc_scal = pack_params(batch_params, batch_wb, acc_cm,
                           matrix_transpose=False, **acc_levels).cuda()
    # The extras path: its edit, a mixer-only edit (no stencils), an edit
    # with a point curve, and a batch with per-image amounts (one image
    # at zero, the mixer on only some).
    xedit = edit.replace(**XEDIT)
    mix_edit = edit.replace(**MIXER_ONLY)
    pc_edit = xedit.replace(point_curve=POINT_CURVE)
    x_batch_params = [xedit, EditParams(), mix_edit,
                      EditParams(sharpen=100.0, vignette=50.0,
                                 grade_mid_hue=120.0, grade_mid_sat=-40.0)]
    x_table, *x_flags = fx.pack_extras(x_batch_params)
    x_table = x_table.cuda()
    x_kw = dict(zip(("mixer_on", "grading_on", "stencils"), x_flags))
    x_engines = {"parity": eng, "malvar": accurate["malvar", False]}
    # The X-Trans path: a 4000x6000 frame on the 6x6 grid, accurate mode,
    # the X-T2 matrix, the accurate path's levels; one engine per tier
    # and transfer form; a batch of four with per-image scalars.
    xtrans = fused.cfa_generic.XTRANS_PATTERN
    DEMOSAIC_OPS.update(cfa_demosaic_ops(
        fused.cfa_generic.channel_grid(xtrans)))
    log("demosaic f32 operations per pixel for the bounds: "
        f"{json.dumps(DEMOSAIC_OPS)}")
    xt_raw = RawImage(np.ascontiguousarray(mosaic[:XH, :XW]), wb4,
                      XT2_XYZ_TO_CAM, black_level=150.0, white_level=4095.0,
                      cfa_pattern=xtrans)
    xt_engines = {(t, fast): DevelopEngine(
        xt_raw, "accurate", use_kernel=True, transfer="srgb",
        fast_gamma=fast, demosaic_method=t, device="cuda")
        for t in XT_TIERS for fast in (False, True)}
    xt_batch = batch[:, :XH, :XW].contiguous()
    xt_cm = np.tile(cam_to_srgb_matrix(XT2_XYZ_TO_CAM, "accurate"),
                    (BATCH, 1, 1))
    xt_scal = pack_params(batch_params, batch_wb, xt_cm,
                          matrix_transpose=False, **acc_levels).cuda()
    rk = get_rawkit()

    def encode(y, cbcr):
        return [rk.encode_jpeg_420(
            np.ascontiguousarray(y[i].cpu().numpy()),
            np.ascontiguousarray(cbcr[i, :, 0::2].cpu().numpy()),
            np.ascontiguousarray(cbcr[i, :, 1::2].cpu().numpy()),
            y.shape[2], y.shape[1], 95, False, 0, 0)
            for i in range(y.shape[0])]

    torch.cuda.synchronize()
    launches = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmpdir = tmp.name

    # -- the parity path: counts reset just before, read just after -------
    reset(fused.LAUNCHES)
    t0 = time.perf_counter()
    tick_ms = []
    for i in range(20):
        p = edit.replace(exposure=-1.0 + 0.1 * i, saturation=5.0 * i)
        zoom = (1.0, 1.5, 2.0, 3.7)[i % 4]
        pan = (0.02 * (i % 5) - 0.04, 0.01 * (i % 3))
        t = time.perf_counter()
        prev = eng.preview_tick(p, zoom=zoom, pan=pan)
        tick_ms.append((time.perf_counter() - t) * 1e3)
    hist = eng.histogram(edit)
    full = {tr: e.full_rgba_device(edit) for tr, e in engines.items()}
    jpg_path = eng.export(os.path.join(tmpdir, "frame.jpg"), edit)
    with open(jpg_path, "rb") as f:
        data = f.read()
    y_b, cbcr_b = fused.fused_batch_develop_rgba(batch, batch_scal,
                                                 output="ycbcr420")
    batch_jpegs = encode(y_b, cbcr_b)
    torch.cuda.synchronize()
    parity_launches = dict(fused.LAUNCHES)
    log(f"parity path: {time.perf_counter() - t0:.2f} s, launches "
        f"{parity_launches}, preview tick median "
        f"{statistics.median(tick_ms):.3f} ms (host clock, first tick "
        "included)")
    for k in ("develop_rgba", "develop_ycbcr420"):
        check(parity_launches[k] > 0, f"{k} never launched")
        launches[k] = parity_launches[k]

    # -- the accurate path: counts reset just before, read just after -----
    reset(fused.LAUNCHES)
    t0 = time.perf_counter()
    acc_words, acc_planes, acc_jpegs = {}, {}, {}
    for (m, fast), e in accurate.items():
        acc_words[m, fast] = e.full_rgba_device(edit)
        acc_planes[m, fast] = e.jpeg_planes(edit)
        path = e.export(os.path.join(tmpdir, f"{m}_{int(fast)}.jpg"), edit)
        with open(path, "rb") as f:
            acc_jpegs[m, fast] = f.read()
    y_g, cbcr_g = fused.fused_batch_develop_rgba(
        batch, acc_scal, gamma="srgb", output="ycbcr420", demosaic="grad")
    grad_jpegs = encode(y_g, cbcr_g)
    torch.cuda.synchronize()
    acc_launches = dict(fused.LAUNCHES)
    log(f"accurate path: {time.perf_counter() - t0:.2f} s, launches "
        f"{acc_launches}")
    for m in ACCURATE:
        for out in ("rgba", "ycbcr420"):
            k = fused.launch_key(out, m)
            check(acc_launches[k] > 0, f"{k} never launched")
            launches[k] = acc_launches[k]

    # -- the extras path: counts reset just before, read just after -------
    reset(fused.LAUNCHES)
    reset(fx.LAUNCHES)
    t0 = time.perf_counter()
    xtick_ms = []
    for i in range(20):
        p = xedit.replace(exposure=-1.0 + 0.1 * i, sharpen=5.0 * i)
        zoom = (1.0, 1.5, 2.0, 3.7)[i % 4]
        pan = (0.02 * (i % 5) - 0.04, 0.01 * (i % 3))
        t = time.perf_counter()
        xprev = eng.preview_tick(p, zoom=zoom, pan=pan)
        xtick_ms.append((time.perf_counter() - t) * 1e3)
    xhist = eng.histogram(xedit)
    x_words, x_planes, x_jpegs = {}, {}, {}
    for name, e in x_engines.items():
        x_words[name] = e.full_rgba_device(xedit)
        x_planes[name] = e.jpeg_planes(xedit)
        path = e.export(os.path.join(tmpdir, f"x_{name}.jpg"), xedit)
        with open(path, "rb") as f:
            x_jpegs[name] = f.read()
    x_mix_words = eng.full_rgba_device(mix_edit)
    before_pc = dict(fused.LAUNCHES), fx.LAUNCHES["extras_rgba"]
    x_pc_words = eng.full_rgba_device(pc_edit)
    torch.cuda.synchronize()
    pc_moved = (dict(fused.LAUNCHES) != before_pc[0],
                fx.LAUNCHES["extras_rgba"] - before_pc[1])
    xb_words = fused.fused_batch_develop_rgba(batch, batch_scal)
    y_x, cbcr_x = fx.fused_finish_extras_rgba(xb_words, x_table,
                                              output="ycbcr420", **x_kw)
    x_batch_jpegs = encode(y_x, cbcr_x)
    torch.cuda.synchronize()
    x_launches = dict(fx.LAUNCHES)
    log(f"extras path: {time.perf_counter() - t0:.2f} s, launches "
        f"{x_launches} (develop {dict(fused.LAUNCHES)}), preview tick "
        f"median {statistics.median(xtick_ms):.3f} ms (host clock, first "
        "tick included)")
    check(pc_moved == (False, 1),
          f"point curve: develop kernel moved / extras launches {pc_moved}")
    for k in fx.LAUNCHES:
        check(x_launches[k] > 0, f"{k} never launched")
        launches[k] = x_launches[k]

    # -- the X-Trans path: counts reset just before, read just after ------
    reset(fused.LAUNCHES)
    reset(fx.LAUNCHES)
    t0 = time.perf_counter()
    xt_tick_ms = []
    xt_words, xt_planes, xt_jpegs, xt_x_words, xt_x_planes = {}, {}, {}, {}, {}
    xt_batch_planes = {}

    def launching(out, tier, fn, *args, **kw):
        """``fn(*args)``, which must launch the X-Trans kernel of
        ``out`` and ``tier`` exactly once."""
        k = fused.launch_key(out, tier, xtrans)
        n = fused.LAUNCHES[k]
        res = fn(*args, **kw)
        check(fused.LAUNCHES[k] == n + 1,
              f"{fn.__name__} launched {k} {fused.LAUNCHES[k] - n} times")
        return res

    for (tier, fast), e in xt_engines.items():
        for i in range(4):
            p = edit.replace(exposure=-1.0 + 0.4 * i, saturation=20.0 * i)
            t = time.perf_counter()
            xt_prev = e.preview_tick(p, zoom=(1.0, 1.5, 2.0, 3.7)[i],
                                     pan=(0.02 * i - 0.04, 0.01 * i))
            xt_tick_ms.append((time.perf_counter() - t) * 1e3)
        xt_hist = e.histogram(edit)
        xt_words[tier, fast] = launching("rgba", tier, e.full_rgba_device,
                                         edit)
        xt_planes[tier, fast] = launching("ycbcr420", tier, e.jpeg_planes,
                                          edit)
        path = launching(
            "ycbcr420", tier, e.export,
            os.path.join(tmpdir, f"xt_{tier}_{int(fast)}.jpg"), edit)
        with open(path, "rb") as f:
            xt_jpegs[tier, fast] = f.read()
    for tier in XT_TIERS:
        e = xt_engines[tier, False]
        # With extras both forms run the RGBA develop kernel, then B8.
        xt_x_words[tier] = launching("rgba", tier, e.full_rgba_device, xedit)
        xt_x_planes[tier] = launching("rgba", tier, e.jpeg_planes, xedit)
        xt_batch_planes[tier] = launching(
            "ycbcr420", tier, fused.fused_batch_develop_rgba, xt_batch,
            xt_scal, gamma="srgb", output="ycbcr420", demosaic=tier,
            pattern=xtrans)
    xt_batch_jpegs = encode(*xt_batch_planes["grad"])
    torch.cuda.synchronize()
    xt_launches = dict(fused.LAUNCHES)
    xt_fx_launches = dict(fx.LAUNCHES)
    log(f"X-Trans path: {time.perf_counter() - t0:.2f} s, launches "
        f"{ {k: v for k, v in xt_launches.items() if v} } (extras "
        f"{xt_fx_launches}), preview tick median "
        f"{statistics.median(xt_tick_ms):.3f} ms (host clock, each "
        "engine's first tick included)")
    for tier in XT_TIERS:
        for out in ("rgba", "ycbcr420"):
            # Two engines' full frames and the two extras forms; two
            # engines' planes and exports and the batch call. Previews
            # and histograms take the plain lane.
            k = fused.launch_key(out, tier, xtrans)
            check(xt_launches[k] == (4 if out == "rgba" else 5),
                  f"{k} launched {xt_launches[k]} times")
            launches[k] = xt_launches[k]
    check(all(v == 0 for k, v in xt_launches.items() if "_cfa_" not in k),
          f"a Bayer kernel ran on the X-Trans path: {xt_launches}")
    check(xt_fx_launches == {"extras_rgba": len(XT_TIERS),
                             "extras_ycbcr420": len(XT_TIERS)},
          f"X-Trans extras launches {xt_fx_launches}")

    # -- the file path (counts reset and read inside) ---------------------
    lap("inputs and the four paths")
    file_launches = file_path(tmpdir, mosaic, edit, xedit, smi)
    file_keys = ([fused.launch_key("rgba", m) for m in ("nearest", "malvar",
                                                       "grad")]
                 + [fused.launch_key("rgba", t, xtrans) for t in XT_TIERS]
                 + ["develop_ycbcr420", "extras_rgba"])
    for k in file_keys:
        check(file_launches.get(k, 0) > 0, f"file path: {k} never launched")

    # -- the batch export path (each run counted alone inside) ------------
    lap("file path")
    export_launches = batch_export(tmpdir, edit, xedit, smi,
                                   args.profile_export)
    lap("batch export")

    # -- outputs ----------------------------------------------------------
    check(tuple(prev.shape) == (854, 1280, 3) and prev.dtype == torch.uint8,
          f"preview shape {tuple(prev.shape)}")
    check(hist.shape == (3, 256), f"histogram shape {hist.shape}")
    check((hist.sum(axis=1) == 128 * 85).all(),
          f"histogram sums {hist.sum(axis=1)}")
    for j in [data] + list(acc_jpegs.values()):
        check(j[:2] == b"\xff\xd8" and j[-2:] == b"\xff\xd9"
              and len(j) > 100_000, f"export JFIF ({len(j)} bytes)")
    for j in batch_jpegs + grad_jpegs + x_batch_jpegs:
        check(j[:2] == b"\xff\xd8" and j[-2:] == b"\xff\xd9",
              "batch JFIF markers")
    check(tuple(xprev.shape) == (854, 1280, 3), "extras preview shape")
    check((xhist.sum(axis=1) == 128 * 85).all(),
          f"extras histogram sums {xhist.sum(axis=1)}")
    for j in x_jpegs.values():
        check(j[:2] == b"\xff\xd8" and j[-2:] == b"\xff\xd9"
              and len(j) > 100_000, f"extras export JFIF ({len(j)} bytes)")
    log(f"extras exports { {k: len(j) for k, j in x_jpegs.items()} }, batch "
        f"JPEGs {[len(j) for j in x_batch_jpegs]} bytes")
    check(tuple(xt_prev.shape) == (853, 1280, 3)
          and xt_prev.dtype == torch.uint8,
          f"X-Trans preview shape {tuple(xt_prev.shape)}")
    check(xt_hist.shape == (3, 256)
          and (xt_hist.sum(axis=1) == 128 * 85).all(),
          f"X-Trans histogram sums {xt_hist.sum(axis=1)}")
    for j in list(xt_jpegs.values()) + xt_batch_jpegs:
        check(j[:2] == b"\xff\xd8" and j[-2:] == b"\xff\xd9"
              and len(j) > 100_000, f"X-Trans JFIF ({len(j)} bytes)")
    log(f"X-Trans exports "
        f"{ {f'{t}/{int(f)}': len(j) for (t, f), j in xt_jpegs.items()} }, "
        f"batch JPEGs {[len(j) for j in xt_batch_jpegs]} bytes")
    log(f"export: {len(data)} bytes; accurate exports "
        f"{ {f'{m}/{int(f)}': len(j) for (m, f), j in acc_jpegs.items()} }; "
        f"batch JPEGs {[len(j) for j in batch_jpegs]} and "
        f"{[len(j) for j in grad_jpegs]} bytes")

    errs = {k: 0 for k in launches}

    def note(key, mx, what):
        check(mx <= 1, f"{what}: {mx} LSB")
        errs[key] = max(errs[key], mx)

    for tr, e in engines.items():
        words = full[tr]
        check(tuple(words.shape) == (H, W) and words.dtype == torch.uint32,
              f"{tr} words shape")
        gamma = kernel_gamma_for(e.transfer)
        plain = fused.develop_rgba_folded_plain(
            e.mosaic[None], e.scalars(edit)[None], e.cfa_phase, gamma)[0]
        mx, share = lsb_diff(words, plain)
        note("develop_rgba", mx, f"{tr}: kernel vs plain")
        e.use_kernel = False
        lane = e.full_rgba_device(edit)
        e.use_kernel = True
        mx2, share2 = lsb_diff(words, lane)
        check(mx2 <= 1, f"{tr}: kernel vs parity lane {mx2} LSB")
        log(f"{tr}: kernel vs plain max {mx} LSB, differing {share:.3e}; "
            f"vs parity lane max {mx2} LSB, differing {share2:.3e}")

    # Every accurate result against its plain version and the plain lane.
    for (m, fast), e in accurate.items():
        gamma = kernel_gamma_for(e.transfer)
        words = acc_words[m, fast]
        check(tuple(words.shape) == (H, W), f"{m} words shape")
        sc = e.scalars(edit)[None]
        mx, share = lsb_diff(words, fused.develop_rgba_folded_plain(
            e.mosaic[None], sc, e.cfa_phase, gamma, demosaic=m)[0])
        note(fused.launch_key("rgba", m), mx, f"{m}/{gamma} kernel vs plain")
        y, cbcr = fused.develop_rgba_folded_plain(
            e.mosaic[None], sc, e.cfa_phase, gamma, output="ycbcr420",
            demosaic=m)
        mxp = planes_diff(acc_planes[m, fast],
                          (y[0], cbcr[0, :, 0::2], cbcr[0, :, 1::2]))
        note(fused.launch_key("ycbcr420", m), mxp,
             f"{m}/{gamma} planes kernel vs plain")
        e.use_kernel = False
        lane = e.full_rgba_device(edit)
        lane_planes = e.jpeg_planes(edit)
        e.use_kernel = True
        mx2, share2 = lsb_diff(words, lane)
        mxp2 = planes_diff(acc_planes[m, fast], lane_planes)
        check(mx2 <= 1 and mxp2 <= 1,
              f"{m}/{gamma}: kernel vs plain lane {mx2} LSB, planes {mxp2}")
        log(f"{m}/{gamma}: kernel vs plain max {mx} LSB ({share:.3e}), "
            f"planes {mxp}; vs plain lane max {mx2} LSB ({share2:.3e}), "
            f"planes {mxp2}")
        del lane, lane_planes

    # Four phases and an odd frame, every kernel variant.
    scal_acc = accurate["grad", False].scalars(edit)[None]
    one = eng.mosaic[None]
    odd = eng.mosaic[None, : H - 1, : W - 3].contiguous()
    for m in ("nearest",) + ACCURATE:
        sc = eng.scalars(edit)[None] if m == "nearest" else scal_acc
        gamma = "pow" if m == "nearest" else "srgb"
        key = fused.launch_key("rgba", m)
        worst = 0
        for phase in PHASES[1:] if m == "nearest" else PHASES:
            mx, _ = lsb_diff(
                fused.fused_batch_develop_rgba(one, sc, phase, gamma,
                                               demosaic=m),
                fused.develop_rgba_folded_plain(one, sc, phase, gamma,
                                                demosaic=m))
            note(key, mx, f"{m} phase {phase}")
            worst = max(worst, mx)
        mx, _ = lsb_diff(
            fused.fused_batch_develop_rgba(odd, sc, (1, 0), gamma,
                                           demosaic=m),
            fused.develop_rgba_folded_plain(odd, sc, (1, 0), gamma,
                                            demosaic=m))
        note(key, mx, f"{m} odd frame")
        log(f"{m}: phases max {worst} LSB; odd {H - 1}x{W - 3} frame "
            f"max {mx} LSB")

    y_p, cbcr_p = fused.develop_rgba_folded_plain(batch, batch_scal,
                                                  output="ycbcr420")
    for name, a, b in (("Y", y_b, y_p), ("CbCr", cbcr_b, cbcr_p)):
        mx, share = plane_diff(a, b)
        note("develop_ycbcr420", mx, f"batch {name} plane")
        log(f"batch {name}: kernel vs plain max {mx}, differing {share:.3e}")
    del y_p, cbcr_p
    y_p, cbcr_p = fused.develop_rgba_folded_plain(
        batch, acc_scal, gamma="srgb", output="ycbcr420", demosaic="grad")
    lane = batch_develop_rgba(batch, batch_params, batch_wb, acc_cm,
                              matrix_transpose=False, transfer="srgb",
                              demosaic_method="grad", output="ycbcr420",
                              **acc_levels)
    for name, a, b, c in (("Y", y_g, y_p, lane[0]),
                          ("Cb", cbcr_g[..., 0::2], cbcr_p[..., 0::2], lane[1]),
                          ("Cr", cbcr_g[..., 1::2], cbcr_p[..., 1::2], lane[2])):
        mx, share = plane_diff(a, b)
        note("develop_ycbcr420_grad", mx, f"grad batch {name} plane")
        mx2, share2 = plane_diff(a, c)
        check(mx2 <= 1, f"grad batch {name} vs plain lane: {mx2}")
        log(f"grad batch {name}: kernel vs plain max {mx} ({share:.3e}); "
            f"vs plain lane max {mx2} ({share2:.3e})")
    del y_p, cbcr_p, lane

    # A constant frame through grad develops to one colour.
    flat = torch.full((1, 64, 96), 2000, dtype=torch.uint16, device="cuda")
    check(torch.unique(fused.fused_batch_develop_rgba(
        flat, scal_acc, gamma="srgb", demosaic="grad")).numel() == 1,
        "constant mosaic through grad is not uniform")

    # The extras kernel against its plain version on the develop kernel's
    # own words (0 LSB expected), and the engine's kernel route against
    # its plain lane. The two routes' develop words differ by up to 1 LSB
    # (folded scalars), and the extras' gains turn such a step into up to
    # 4 LSB for this edit (the tone curve's steepest segment 1.3 times the
    # sharpen's 1.45 times the mixer's luminance 1.2). So that comparison
    # holds the develop words within 1 LSB and every differing output
    # pixel within the extras' radius, 2, of a pixel whose develop words
    # differ (a chroma sample: of one of its four pixels).
    def develop_words(e, p):
        return fused.fused_develop_rgba(e.mosaic, e.scalars(p), e.cfa_phase,
                                        kernel_gamma_for(e.transfer),
                                        demosaic=e.demosaic_method)

    def near(diff_out, diff_in, radius):
        """Every True of diff_out lies within ``radius`` of a True of
        diff_in (both (H, W) bool, or diff_out at half size for a
        chroma plane)."""
        grown = torch.nn.functional.max_pool2d(
            diff_in[None, None].float(), 2 * radius + 1, stride=1,
            padding=radius)[0, 0]
        if diff_out.shape != grown.shape:
            grown = torch.nn.functional.max_pool2d(grown[None, None], 2)[0, 0]
        return not bool((diff_out & (grown == 0)).any())

    def differs(a, b):
        return a.view(torch.int32) != b.view(torch.int32)

    one_table, *one_flags = fx.pack_extras([xedit])
    one_table = one_table.cuda()
    for name, e in x_engines.items():
        words = develop_words(e, xedit)[None]
        mx, share = lsb_diff(x_words[name], fx.finish_extras_plain(
            words, one_table, *one_flags)[0])
        note("extras_rgba", mx, f"extras {name} kernel vs plain")
        y, cbcr = fx.finish_extras_plain(words, one_table, *one_flags,
                                         output="ycbcr420")
        mxp = planes_diff(x_planes[name], (y[0], cbcr[0, :, 0::2],
                                           cbcr[0, :, 1::2]))
        note("extras_ycbcr420", mxp, f"extras {name} planes kernel vs plain")
        e.use_kernel = False
        lane_dev = e._develop_words(xedit)
        lane = e.full_rgba_device(xedit)
        lane_planes = e.jpeg_planes(xedit)
        e.use_kernel = True
        mxd, shared = lsb_diff(words[0], lane_dev)
        dev_diff = differs(words[0], lane_dev)
        mx2, share2 = lsb_diff(x_words[name], lane)
        mxp2 = planes_diff(x_planes[name], lane_planes)
        check(mxd <= 1, f"extras {name}: develop kernel vs lane {mxd} LSB")
        check(near(differs(x_words[name], lane), dev_diff, 2),
              f"extras {name}: RGBA differs away from a develop difference")
        for a, b in zip(x_planes[name], lane_planes):
            check(near(a != b, dev_diff, 2),
                  f"extras {name}: planes differ away from a develop "
                  "difference")
        log(f"extras {name}: kernel vs plain max {mx} LSB ({share:.3e}), "
            f"planes {mxp}; kernel route vs plain lane max {mx2} LSB "
            f"({share2:.3e}), planes {mxp2}, from develop words max {mxd} "
            f"LSB ({shared:.3e}), every difference within reach of one")
        del words, lane, lane_planes, lane_dev, dev_diff
    mix_table, *mix_flags = fx.pack_extras([mix_edit])
    mx, share = lsb_diff(x_mix_words, fx.finish_extras_plain(
        develop_words(eng, mix_edit)[None], mix_table.cuda(), *mix_flags)[0])
    note("extras_rgba", mx, "mixer-only kernel vs plain")
    pc_words = eng._develop_words(pc_edit)[None]
    mx2, share2 = lsb_diff(x_pc_words, fx.finish_extras_plain(
        pc_words, one_table, *one_flags)[0])
    note("extras_rgba", mx2, "point curve kernel vs plain")
    log(f"extras mixer-only {mix_flags}: max {mx} LSB ({share:.3e}); point "
        f"curve (plain develop lane, then the kernel): max {mx2} LSB "
        f"({share2:.3e})")
    y_p, cbcr_p = fx.finish_extras_plain(xb_words, x_table, *x_flags,
                                         output="ycbcr420")
    for name, a, b in (("Y", y_x, y_p), ("CbCr", cbcr_x, cbcr_p)):
        mx, share = plane_diff(a, b)
        note("extras_ycbcr420", mx, f"extras batch {name} plane")
        log(f"extras batch {name}: kernel vs plain max {mx} ({share:.3e})")
    del y_p, cbcr_p, pc_words
    # Every flag set: RGBA on the odd frame and a 33x17 batch, planes at
    # 24 MP and on a 34x18 batch, per-image amounts in the batches.
    odd_w = x_words["parity"][None, : H - 1, : W - 3].contiguous()
    full_w = x_words["parity"][None]
    cases = (("rgba", odd_w, one_table),
             ("rgba", xb_words[:, :33, :17].contiguous(), x_table),
             ("ycbcr420", full_w, one_table),
             ("ycbcr420", xb_words[:, :34, :18].contiguous(), x_table))
    worst = {}
    for flags in FLAG_SETS:
        kw = dict(zip(("mixer_on", "grading_on", "stencils"), flags))
        for out, wd, tb in cases:
            got = fx.fused_finish_extras_rgba(wd, tb, output=out, **kw)
            want = fx.finish_extras_plain(wd, tb, *flags, output=out)
            if out == "rgba":
                mx = lsb_diff(got, want)[0]
            else:
                mx = planes_diff(got, want)
            note("extras_" + out, mx,
                 f"extras {out} {tuple(wd.shape)} flags {flags}")
            worst[flags] = max(worst.get(flags, 0), mx)
        torch.cuda.empty_cache()
    log(f"extras flag sets (mixer, grading, stencils) worst LSB: "
        f"{ {''.join(str(int(f)) for f in k): v for k, v in worst.items()} }")

    # The generic-CFA kernels: every X-Trans result against its plain
    # version (0 LSB expected) and the engine's kernel route against its
    # plain lane (the folded scalars: at most 1 LSB).
    def cfa_plain(mos, sc, gamma, tier, output="rgba"):
        return fused.develop_rgba_folded_plain(
            mos, sc, gamma=gamma, output=output, demosaic=tier,
            pattern=xtrans)

    def cfa_kernel(mos, sc, gamma, tier, output="rgba"):
        return fused.fused_batch_develop_rgba(
            mos, sc, gamma=gamma, output=output, demosaic=tier,
            pattern=xtrans)

    for (tier, fast), e in xt_engines.items():
        gamma = kernel_gamma_for(e.transfer)
        words = xt_words[tier, fast]
        check(tuple(words.shape) == (XH, XW) and words.dtype == torch.uint32,
              f"X-Trans {tier} words shape")
        sc = e.scalars(edit)[None]
        mx, share = lsb_diff(words, cfa_plain(e.mosaic[None], sc, gamma,
                                              tier)[0])
        note(fused.launch_key("rgba", tier, xtrans), mx,
             f"X-Trans {tier}/{gamma} kernel vs plain")
        y, cbcr = cfa_plain(e.mosaic[None], sc, gamma, tier, "ycbcr420")
        mxp = planes_diff(xt_planes[tier, fast],
                          (y[0], cbcr[0, :, 0::2], cbcr[0, :, 1::2]))
        note(fused.launch_key("ycbcr420", tier, xtrans), mxp,
             f"X-Trans {tier}/{gamma} planes kernel vs plain")
        e.use_kernel = False
        lane = e.full_rgba_device(edit)
        lane_planes = e.jpeg_planes(edit)
        e.use_kernel = True
        mx2, share2 = lsb_diff(words, lane)
        mxp2 = planes_diff(xt_planes[tier, fast], lane_planes)
        check(mx2 <= 1 and mxp2 <= 1, f"X-Trans {tier}/{gamma}: kernel vs "
              f"plain lane {mx2} LSB, planes {mxp2}")
        log(f"X-Trans {tier}/{gamma}: kernel vs plain max {mx} LSB "
            f"({share:.3e}), planes {mxp}; vs plain lane max {mx2} LSB "
            f"({share2:.3e}), planes {mxp2}")
        del lane, lane_planes, y, cbcr
        torch.cuda.empty_cache()
    # The odd frame, small frames around the tile and period edges, the
    # batch of four to planes (per-image sliders, WB and levels) also
    # against the plain lane, the extras after the develop, a constant
    # frame.
    xt_sc = xt_engines["grad", False].scalars(edit)[None]
    for tier in XT_TIERS:
        key = fused.launch_key("rgba", tier, xtrans)
        mx_odd, _ = lsb_diff(cfa_kernel(odd, xt_sc, "srgb", tier),
                             cfa_plain(odd, xt_sc, "srgb", tier))
        note(key, mx_odd, f"X-Trans {tier} odd frame")
        worst = 0
        for h, w in XT_SMALL:
            small_b = batch[:, 7: 7 + h, 5: 5 + w].contiguous()
            for gamma in fused.GAMMAS:
                mx, _ = lsb_diff(cfa_kernel(small_b, xt_scal, gamma, tier),
                                 cfa_plain(small_b, xt_scal, gamma, tier))
                note(key, mx, f"X-Trans {tier} {h}x{w} {gamma}")
                worst = max(worst, mx)
        y_p, cbcr_p = cfa_plain(xt_batch, xt_scal, "srgb", tier, "ycbcr420")
        lane = batch_develop_xtrans_rgba(
            xt_batch, batch_params, batch_wb, xt_cm, pattern=xtrans,
            transfer="srgb", demosaic_method=tier, output="ycbcr420",
            **acc_levels)
        y_k, cbcr_k = xt_batch_planes[tier]
        mxb, mxl = 0, 0
        for a, b, c in ((y_k, y_p, lane[0]),
                        (cbcr_k[..., 0::2], cbcr_p[..., 0::2], lane[1]),
                        (cbcr_k[..., 1::2], cbcr_p[..., 1::2], lane[2])):
            mxb = max(mxb, plane_diff(a, b)[0])
            mxl = max(mxl, plane_diff(a, c)[0])
        note(fused.launch_key("ycbcr420", tier, xtrans), mxb,
             f"X-Trans {tier} batch planes")
        check(mxl <= 1, f"X-Trans {tier} batch planes vs plain lane: {mxl}")
        del y_p, cbcr_p, lane
        e = xt_engines[tier, False]
        dev_words = cfa_kernel(e.mosaic[None], e.scalars(xedit)[None],
                               "srgb", tier)
        mxx, _ = lsb_diff(xt_x_words[tier], fx.finish_extras_plain(
            dev_words, one_table, *one_flags)[0])
        note("extras_rgba", mxx, f"X-Trans {tier} extras kernel vs plain")
        y, cbcr = fx.finish_extras_plain(dev_words, one_table, *one_flags,
                                         output="ycbcr420")
        mxxp = planes_diff(xt_x_planes[tier], (y[0], cbcr[0, :, 0::2],
                                               cbcr[0, :, 1::2]))
        note("extras_ycbcr420", mxxp, f"X-Trans {tier} extras planes")
        check(torch.unique(cfa_kernel(flat, xt_sc, "srgb",
                                      tier)).numel() == 1,
              f"constant mosaic through X-Trans {tier} is not uniform")
        log(f"X-Trans {tier}: odd {H - 1}x{W - 3} frame max {mx_odd} LSB; "
            f"small frames {XT_SMALL} x four transfers max {worst} LSB; "
            f"batch planes vs plain max {mxb}, vs plain lane max {mxl}; "
            f"extras after it vs plain max {mxx} LSB, planes {mxxp}")
        del dev_words, y, cbcr
        torch.cuda.empty_cache()

    # The grad kernels march a warp down a 64-column strip in bands of 64
    # rows: frames around those edges, two images with their own scalars,
    # Bayer at the four phases, the generic-CFA kernel at periods 2, 3
    # and 6; words on every frame, planes on the even ones.
    grad_cases = [(None, ph) for ph in PHASES] + [
        (pat, (0, 0)) for pat in (xtrans,) + GRAD_PATTERNS]
    edge_sc = xt_scal[:2].contiguous()
    grad_worst = {"develop_rgba_grad": 0, "develop_rgba_cfa_grad": 0,
             "develop_ycbcr420_grad": 0, "develop_ycbcr420_cfa_grad": 0}
    n_edge = 0
    for out, shapes in (("rgba", [(h, w) for h in GRAD_EDGE_H
                                  for w in GRAD_EDGE_W]),
                        ("ycbcr420", GRAD_EDGE_EVEN)):
        for h, w in shapes:
            small_b = batch[:2, 3: 3 + h, 9: 9 + w].contiguous()
            for pat, ph in grad_cases:
                kw = dict(cfa_phase=ph, gamma="srgb", output=out,
                          demosaic="grad", pattern=pat)
                got = fused.fused_batch_develop_rgba(small_b, edge_sc, **kw)
                want = fused.develop_rgba_folded_plain(small_b, edge_sc, **kw)
                mx = (lsb_diff(got, want)[0] if out == "rgba"
                      else planes_diff(got, want))
                key = fused.launch_key(out, "grad", pat)
                check(mx == 0, f"{key} {h}x{w} phase {ph} period "
                      f"{pat and int(len(pat) ** 0.5)}: {mx} LSB from plain")
                note(key, mx, f"{key} {h}x{w}")
                grad_worst[key] = max(grad_worst[key], mx)
                n_edge += 1
    log(f"grad kernels on {len(GRAD_EDGE_H) * len(GRAD_EDGE_W)} RGBA and "
        f"{len(GRAD_EDGE_EVEN)} planes frames around the strip and band "
        f"edges, four phases and periods 6, 2, 3 ({n_edge} comparisons): "
        f"worst LSB {grad_worst}")

    # The Bayer quad kernel around its 128x16 tile and its block of four
    # tiles down: every frame with each
    # demosaic at one of the four phases in turn (nearest with the power
    # transfer, the others with sRGB); the frames of the diagonal and the
    # planes at every phase with every transfer.
    quad_worst = {}
    n_edge = 0
    rgba_shapes = [(h, w) for h in BAYER_EDGE_H for w in BAYER_EDGE_W]
    diagonal = set(zip(BAYER_EDGE_H, BAYER_EDGE_W))
    for out, shapes in (("rgba", rgba_shapes),
                        ("ycbcr420", BAYER_EDGE_EVEN)):
        for i, (h, w) in enumerate(shapes):
            small_b = batch[:2, 3: 3 + h, 9: 9 + w].contiguous()
            every = out == "ycbcr420" or (h, w) in diagonal
            for m in ("nearest", "bilinear", "malvar"):
                own = ("pow" if m == "nearest" else "srgb",)
                for ph in PHASES if every else (PHASES[i % 4],):
                    for gamma in fused.GAMMAS if every else own:
                        kw = dict(cfa_phase=ph, gamma=gamma, output=out,
                                  demosaic=m)
                        got = fused.fused_batch_develop_rgba(small_b, edge_sc,
                                                             **kw)
                        want = fused.develop_rgba_folded_plain(
                            small_b, edge_sc, **kw)
                        mx = (lsb_diff(got, want)[0] if out == "rgba"
                              else planes_diff(got, want))
                        key = fused.launch_key(out, m)
                        check(mx == 0, f"{key} {h}x{w} phase {ph} {gamma}: "
                              f"{mx} LSB from plain")
                        note(key, mx, f"{key} {h}x{w}")
                        quad_worst[key] = max(quad_worst.get(key, 0), mx)
                        n_edge += 1
    log(f"Bayer quad kernel on {len(rgba_shapes)} RGBA and "
        f"{len(BAYER_EDGE_EVEN)} planes frames around its tile "
        f"({BAYER_TILE_W}x{BAYER_TILE_H}) and block ({BAYER_BLOCK_H} rows), "
        f"four phases ({n_edge} "
        f"comparisons): worst LSB {quad_worst}")

    # The extras kernel marches like the grad kernels (strips of 60 output
    # columns, bands of 64 rows): two images with their own amounts on
    # every frame, the all-on flag set everywhere and all eight on the
    # frames of the diagonal; words on every size, planes on the even ones.
    edge_params = [xedit, EditParams(sharpen=100.0, vignette=50.0,
                                     grade_mid_hue=120.0,
                                     grade_mid_sat=-40.0)]
    edge_table = fx.pack_extras(edge_params)[0].cuda()
    x_edge_worst = {"extras_rgba": 0, "extras_ycbcr420": 0}
    n_edge = 0
    rgba_shapes = [(h, w) for h in EXTRAS_EDGE_H for w in EXTRAS_EDGE_W]
    diagonal = set(zip(EXTRAS_EDGE_H, EXTRAS_EDGE_W))
    for out, shapes in (("rgba", rgba_shapes),
                        ("ycbcr420", EXTRAS_EDGE_EVEN)):
        for h, w in shapes:
            wd = xb_words[:2, 11: 11 + h, 5: 5 + w].contiguous()
            every = out == "ycbcr420" or (h, w) in diagonal
            for flags in FLAG_SETS if every else [(True, True, True)]:
                kw = dict(zip(("mixer_on", "grading_on", "stencils"), flags))
                got = fx.fused_finish_extras_rgba(wd, edge_table, output=out,
                                                  **kw)
                want = fx.finish_extras_plain(wd, edge_table, *flags,
                                              output=out)
                mx = (lsb_diff(got, want)[0] if out == "rgba"
                      else planes_diff(got, want))
                key = "extras_" + out
                check(mx == 0, f"{key} {h}x{w} flags {flags}: {mx} LSB from "
                      "plain")
                note(key, mx, f"{key} {h}x{w}")
                x_edge_worst[key] = max(x_edge_worst[key], mx)
                n_edge += 1
    log(f"extras kernel on {len(rgba_shapes)} RGBA and "
        f"{len(EXTRAS_EDGE_EVEN)} planes frames around the strip "
        f"({EXTRAS_STRIP}) and band ({EXTRAS_BAND}) edges, the eight flag "
        f"sets on {len(diagonal) + len(EXTRAS_EDGE_EVEN)} of them "
        f"({n_edge} comparisons): worst LSB {x_edge_worst}")

    # The generic-CFA nearest and smooth kernels around the smooth march's
    # strips (62 output columns) and bands (24 rows), periods 6, 2 and 3;
    # the sRGB transfer everywhere, all four on the diagonal and the planes.
    cfa_edge_worst = {}
    n_edge = 0
    rgba_shapes = [(h, w) for h in CFA_EDGE_H for w in CFA_EDGE_W]
    diagonal = set(zip(CFA_EDGE_H, CFA_EDGE_W))
    for out, shapes in (("rgba", rgba_shapes), ("ycbcr420", CFA_EDGE_EVEN)):
        for h, w in shapes:
            small_b = batch[:2, 3: 3 + h, 9: 9 + w].contiguous()
            every = out == "ycbcr420" or (h, w) in diagonal
            for tier, more in CFA_EDGE_PATTERNS.items():
                for pat in (xtrans,) + more:
                    for gamma in fused.GAMMAS if every else ("srgb",):
                        kw = dict(gamma=gamma, output=out, demosaic=tier,
                                  pattern=pat)
                        got = fused.fused_batch_develop_rgba(small_b, edge_sc,
                                                             **kw)
                        want = fused.develop_rgba_folded_plain(
                            small_b, edge_sc, **kw)
                        mx = (lsb_diff(got, want)[0] if out == "rgba"
                              else planes_diff(got, want))
                        key = fused.launch_key(out, tier, pat)
                        check(mx == 0, f"{key} {h}x{w} period "
                              f"{int(len(pat) ** 0.5)} {gamma}: {mx} LSB "
                              "from plain")
                        note(key, mx, f"{key} {h}x{w}")
                        cfa_edge_worst[key] = max(cfa_edge_worst.get(key, 0),
                                                  mx)
                        n_edge += 1
    log(f"generic-CFA nearest and smooth kernels on {len(rgba_shapes)} RGBA "
        f"and {len(CFA_EDGE_EVEN)} planes frames around the strip "
        f"({CFA_STRIP}) and band ({CFA_BAND}) edges, periods 6, 2 and 3 "
        f"({n_edge} comparisons): worst LSB {cfa_edge_worst}")

    lap("24 MP and edge frames against the plain versions")
    # The develop kernels' table quantiser (fused_quantize: the same
    # table and lookup as their tail) against the plain quantiser on the
    # card: every f32 in [0, 1] in chunks, then the first 2**20 values
    # above 1.0 and every 4096th pattern from there to +inf, -0.0 and the
    # first 2**20 negative patterns (denormals) and every 4096th to -inf.
    i32 = torch.int32
    extra = torch.cat([
        torch.arange(ONE_BITS + 1, ONE_BITS + (1 << 20), dtype=i32),
        torch.arange(ONE_BITS + (1 << 20), 0x7F800001, 4096, dtype=i32),
        torch.tensor([0x7F800000], dtype=i32),  # +inf
        torch.arange(-2**31, -2**31 + (1 << 20), dtype=i32),  # -0.0, ...
        torch.arange(-2**31 + (1 << 20), -0x00800000 + 1, 4096, dtype=i32),
        torch.tensor([-0x00800000], dtype=i32),  # -inf
    ]).cuda().view(torch.float32)
    t0 = time.perf_counter()
    sweep = {}
    for gamma in fused.GAMMAS:
        swept = bad = 0
        for start in range(0, ONE_BITS + 1, SWEEP_CHUNK):
            c = torch.arange(start, min(start + SWEEP_CHUNK, ONE_BITS + 1),
                             dtype=i32, device="cuda").view(torch.float32)
            bad += int((fused.fused_quantize(c, gamma) != fused._quantize(
                c, gamma).to(torch.uint8)).sum())
            swept += c.numel()
        bad_x = int((fused.fused_quantize(extra, gamma) != fused._quantize(
            extra, gamma).to(torch.uint8)).sum())
        sweep[gamma] = dict(unit=swept, mismatches=bad, beyond=extra.numel(),
                            beyond_mismatches=bad_x)
        check(swept == ONE_BITS + 1 and bad == 0 and bad_x == 0,
              f"table quantiser {gamma}: {sweep[gamma]}")
    torch.cuda.synchronize()
    del c, extra
    torch.cuda.empty_cache()
    log(f"table quantiser vs plain on the card ({time.perf_counter() - t0:.2f}"
        f" s): {json.dumps(sweep)}")

    lap("quantiser sweep")
    # Small inputs: the card against the same code on the CPU (which the
    # CPU tests hold against the JAX package), parity and accurate with
    # per-site black levels.
    small = RawImage(mosaic[:256, :384].copy(), wb4, parity_raw.xyz_to_cam)
    gpu_eng = DevelopEngine(small, device="cuda")
    cpu_eng = DevelopEngine(small, device="cpu")
    pv = (np.abs(gpu_eng.preview(edit, 1.5, (0.05, 0.0)).astype(int)
                 - cpu_eng.preview(edit, 1.5, (0.05, 0.0)).astype(int)))
    mx, _ = lsb_diff(gpu_eng.full_rgba_device(edit).cpu(),
                     cpu_eng.full_rgba_device(edit))
    check(pv.max() <= 1 and mx <= 1, f"card vs CPU: {pv.max()}, {mx}")
    log(f"small parity frame card vs CPU: preview max {pv.max()}, "
        f"full max {mx}")
    small_acc = RawImage(mosaic[:256, :384].copy(), wb4, D3300_XYZ_TO_CAM,
                         black_level=150.0, white_level=4095.0,
                         cfa_pattern="GBRG",
                         black_per_site=np.array([[146.0, 153.0],
                                                  [151.0, 150.0]],
                                                 np.float32))
    for m in ACCURATE:
        kw = dict(mode="accurate", use_kernel=True, transfer="srgb",
                  demosaic_method=m)
        g_e = DevelopEngine(small_acc, device="cuda", **kw)
        c_e = DevelopEngine(small_acc, device="cpu", **kw)
        mx, _ = lsb_diff(g_e.full_rgba_device(edit).cpu(),
                         c_e.full_rgba_device(edit))
        mxp = planes_diff([p.cpu() for p in g_e.jpeg_planes(edit)],
                          c_e.jpeg_planes(edit))
        check(mx <= 1 and mxp <= 1, f"{m} card vs CPU: {mx}, {mxp}")
        log(f"small accurate {m} frame card vs CPU: full max {mx}, "
            f"planes max {mxp}")
    small_x = dict(use_kernel=True, max_preview_width=192)
    g_e = DevelopEngine(small, device="cuda", **small_x)
    c_e = DevelopEngine(small, device="cpu", **small_x)
    pv = np.abs(g_e.preview(xedit, 1.3, (0.02, 0.0)).astype(int)
                - c_e.preview(xedit, 1.3, (0.02, 0.0)).astype(int)).max()
    mx, _ = lsb_diff(g_e.full_rgba_device(xedit).cpu(),
                     c_e.full_rgba_device(xedit))
    mxp = planes_diff([p.cpu() for p in g_e.jpeg_planes(xedit)],
                      c_e.jpeg_planes(xedit))
    check(pv <= 1 and mx <= 1 and mxp <= 1,
          f"extras card vs CPU: {pv}, {mx}, {mxp}")
    log(f"small extras frame card vs CPU: preview max {pv}, full max {mx}, "
        f"planes max {mxp}")
    small_xt = RawImage(mosaic[:252, :390].copy(), wb4, XT2_XYZ_TO_CAM,
                        black_level=150.0, white_level=4095.0,
                        cfa_pattern=xtrans)
    for tier in XT_TIERS:
        kw = dict(mode="accurate", use_kernel=True, transfer="srgb",
                  demosaic_method=tier, max_preview_width=192)
        g_e = DevelopEngine(small_xt, device="cuda", **kw)
        c_e = DevelopEngine(small_xt, device="cpu", **kw)
        pv = np.abs(g_e.preview(edit, 1.3, (0.02, 0.0)).astype(int)
                    - c_e.preview(edit, 1.3, (0.02, 0.0)).astype(int)).max()
        mx, _ = lsb_diff(g_e.full_rgba_device(edit).cpu(),
                         c_e.full_rgba_device(edit))
        mxp = planes_diff([p.cpu() for p in g_e.jpeg_planes(edit)],
                          c_e.jpeg_planes(edit))
        check(pv <= 1 and mx <= 1 and mxp <= 1,
              f"X-Trans {tier} card vs CPU: {pv}, {mx}, {mxp}")
        log(f"small X-Trans {tier} frame card vs CPU: preview max {pv}, "
            f"full max {mx}, planes max {mxp}")

    lap("small frames, card against CPU")
    # -- times at 24 MP, kernel and plain in turns ------------------------
    scal = eng.scalars(edit)[None]
    timed = {  # key: (mosaics, scalars, gamma, output, demosaic, pattern)
        "develop_rgba": (one, scal, "pow", "rgba", "nearest", None),
        "develop_ycbcr420": (batch, batch_scal, "pow", "ycbcr420",
                             "nearest", None),
    }
    for m in ACCURATE:
        timed[fused.launch_key("rgba", m)] = (one, scal_acc, "srgb", "rgba", m,
                                              None)
        timed[fused.launch_key("ycbcr420", m)] = (batch, acc_scal, "srgb",
                                                  "ycbcr420", m, None)
    xt_one = xt_engines["grad", False].mosaic[None]
    for tier in XT_TIERS:
        timed[fused.launch_key("rgba", tier, xtrans)] = (
            xt_one, xt_sc, "srgb", "rgba", tier, xtrans)
        timed[fused.launch_key("ycbcr420", tier, xtrans)] = (
            xt_batch, xt_scal, "srgb", "ycbcr420", tier, xtrans)
    times = {}
    for key, (mos, sc, gamma, out, m, pat) in timed.items():
        def kern():
            return fused.fused_batch_develop_rgba(
                mos, sc, gamma=gamma, output=out, demosaic=m, pattern=pat)

        def plain():
            return fused.develop_rgba_folded_plain(
                mos, sc, gamma=gamma, output=out, demosaic=m, pattern=pat)

        k_ms, p_ms = [], []
        for _ in range(2):
            k_ms += cuda_ms(kern, TIMING_REPS // 2)
            p_ms += cuda_ms(plain, 2)
        torch.cuda.empty_cache()
        n_px = mos.numel()
        b_ms, b_by = bound(n_px, fused.variant(m, pat), gamma, out)
        times[key] = dict(ms=statistics.median(k_ms),
                          plain_ms=statistics.median(p_ms), bound_ms=b_ms,
                          bound_by=b_by, frames=mos.shape[0])
        log(f"time {key} ({mos.shape[0]} frame(s), {gamma}): kernel "
            f"{times[key]['ms']:.4f} ms, plain {times[key]['plain_ms']:.4f} "
            f"ms, bound {b_ms:.4f} ms by {b_by} [{smi}]")
    x_timed = {"extras_rgba": (full_w, one_table, "rgba"),
               "extras_ycbcr420": (xb_words, x_table, "ycbcr420")}
    for key, (wd, tb, out) in x_timed.items():
        def kern():
            return fx.fused_finish_extras_rgba(wd, tb, output=out, **x_kw)

        def plain():
            return fx.finish_extras_plain(wd, tb, *x_flags, output=out)

        k_ms, p_ms = [], []
        for _ in range(2):
            k_ms += cuda_ms(kern, TIMING_REPS // 2)
            p_ms += cuda_ms(plain, 2)
        torch.cuda.empty_cache()
        b_ms, b_by = extras_bound(wd.shape[0] * H * W, *x_flags, out)
        times[key] = dict(ms=statistics.median(k_ms),
                          plain_ms=statistics.median(p_ms), bound_ms=b_ms,
                          bound_by=b_by, frames=wd.shape[0])
        log(f"time {key} ({wd.shape[0]} frame(s), mixer+grading+stencils): "
            f"kernel {times[key]['ms']:.4f} ms, plain "
            f"{times[key]['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
            f"[{smi}]")
    by_flags = {}
    for flags in FLAG_SETS:
        kw = dict(zip(("mixer_on", "grading_on", "stencils"), flags))
        by_flags["".join(str(int(f)) for f in flags)] = dict(
            ms=statistics.median(cuda_ms(
                lambda kw=kw: fx.fused_finish_extras_rgba(full_w, one_table,
                                                          **kw), 6)),
            bound_ms=extras_bound(H * W, *flags, "rgba")[0])
    log(f"time extras_rgba kernel by flag set (mixer, grading, stencils; "
        f"one 24 MP frame): {json.dumps(by_flags)} [{smi}]")
    by_gamma = {}
    for m in ("nearest",) + ACCURATE:
        sc = scal if m == "nearest" else scal_acc
        by_gamma[m] = {g: statistics.median(cuda_ms(
            lambda g=g: fused.fused_batch_develop_rgba(one, sc, gamma=g,
                                                       demosaic=m), 6))
            for g in fused.GAMMAS}
    for tier in XT_TIERS:
        by_gamma[fused.variant(tier, xtrans)] = {g: statistics.median(cuda_ms(
            lambda g=g: fused.fused_batch_develop_rgba(
                xt_one, xt_sc, gamma=g, demosaic=tier, pattern=xtrans), 6))
            for g in fused.GAMMAS}
    log(f"time rgba kernel by demosaic and gamma (ms): {json.dumps(by_gamma)}")

    lap("kernel and plain times")
    e2e = {
        "preview_tick_ms": host_ms(
            lambda: eng.preview_tick(edit, 1.5, (0.01, 0.0)), 20),
        "histogram_ms": host_ms(lambda: eng.histogram(edit), 10),
        "full_rgba_ms": host_ms(lambda: eng.full_rgba_device(edit), 10),
        "jpeg_planes_ms": host_ms(lambda: eng.jpeg_planes(edit), 10),
        "export_jpeg_ms": host_ms(lambda: eng.export(
            os.path.join(tmpdir, "t.jpg"), edit), 3),
    }
    for m in ACCURATE:
        e = accurate[m, False]
        e2e[f"{m}_full_rgba_ms"] = host_ms(lambda: e.full_rgba_device(edit),
                                           10)
        e2e[f"{m}_jpeg_planes_ms"] = host_ms(lambda: e.jpeg_planes(edit), 10)
        e2e[f"{m}_export_jpeg_ms"] = host_ms(lambda: e.export(
            os.path.join(tmpdir, "t.jpg"), edit), 3)
    for name, e in x_engines.items():
        e2e[f"extras_{name}_full_rgba_ms"] = host_ms(
            lambda: e.full_rgba_device(xedit), 10)
        e2e[f"extras_{name}_jpeg_planes_ms"] = host_ms(
            lambda: e.jpeg_planes(xedit), 10)
        e2e[f"extras_{name}_export_jpeg_ms"] = host_ms(lambda: e.export(
            os.path.join(tmpdir, "t.jpg"), xedit), 3)
    e2e["extras_preview_tick_ms"] = host_ms(
        lambda: eng.preview_tick(xedit, 1.5, (0.01, 0.0)), 20)
    e2e["extras_histogram_ms"] = host_ms(lambda: eng.histogram(xedit), 10)
    for tier in XT_TIERS:
        e = xt_engines[tier, False]
        e2e[f"xtrans_{tier}_full_rgba_ms"] = host_ms(
            lambda: e.full_rgba_device(edit), 10)
        e2e[f"xtrans_{tier}_jpeg_planes_ms"] = host_ms(
            lambda: e.jpeg_planes(edit), 10)
        e2e[f"xtrans_{tier}_export_jpeg_ms"] = host_ms(lambda: e.export(
            os.path.join(tmpdir, "t.jpg"), edit), 3)
        e2e[f"xtrans_{tier}_extras_full_rgba_ms"] = host_ms(
            lambda: e.full_rgba_device(xedit), 10)
    e = xt_engines["grad", False]
    e2e["xtrans_preview_tick_ms"] = host_ms(
        lambda: e.preview_tick(edit, 1.5, (0.01, 0.0)), 20)
    e2e["xtrans_histogram_ms"] = host_ms(lambda: e.histogram(edit), 10)
    log(f"end to end (host clock, median): {json.dumps(e2e)} [{smi}]")
    tmp.cleanup()
    lap("end to end")

    # Every develop kernel (B1-B7) and the extras kernel keep their plain
    # versions' arithmetic bit for bit: no differing pixel in any
    # comparison above, at 24 MP, on the odd frame, at the four phases, in
    # the batch planes or on the edges.
    for key in (*quad_worst, *grad_worst, *x_edge_worst, *cfa_edge_worst):
        check(errs[key] == 0, f"{key}: {errs[key]} LSB from its plain version")

    kernels = []
    for key, (_, _, _, out, m, pat) in timed.items():
        m = fused.variant(m, pat)
        line = REPLACES.get((m, out), REPLACES.get(m))
        kernels.append({
            "name": key, "route": "cuda",
            "source": SRC.get(m, SRC["develop"]),
            "replaces": f"{TPU_KERNEL}:{line}", "launches": launches[key],
            "max_abs_err": errs[key], "ms": times[key]["ms"],
            "plain_ms": times[key]["plain_ms"],
            "bound_ms": times[key]["bound_ms"],
            "bound_by": times[key]["bound_by"], "library_ms": None,
            "frames": times[key]["frames"],
            "file_path_launches": file_launches.get(key, 0),
            "export_launches": {run: n.get(key, 0)
                                for run, n in export_launches.items()}})
    for key in x_timed:
        kernels.append({
            "name": key, "route": "cuda", "source": SRC["extras"],
            "replaces": f"{TPU_KERNEL}:{REPLACES[key]}",
            "launches": launches[key], "max_abs_err": errs[key],
            "ms": times[key]["ms"], "plain_ms": times[key]["plain_ms"],
            "bound_ms": times[key]["bound_ms"],
            "bound_by": times[key]["bound_by"], "library_ms": None,
            "frames": times[key]["frames"],
            "file_path_launches": file_launches.get(key, 0),
            "export_launches": {run: n.get(key, 0)
                                for run, n in export_launches.items()}})
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
        f"build included; seconds by phase {json.dumps(phase_s)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
