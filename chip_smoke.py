#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from ``raweditor_tpu_torch/csrc``, develops a
seeded 24 MP (4016x6016) 12-bit Bayer frame through ``DevelopEngine``
(slider ticks with histogram, full-resolution kernel develop for the four
transfers, JPEG export) and a batch of four frames to JPEG planes, then
holds every kernel result against its plain PyTorch version, times each
kernel beside its plain version with CUDA events, and prints:

- a line ``{"kernels": [...]}`` with each kernel's launches on the main
  path, its largest difference from the plain version and both times;
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
TIMING_REPS = 20
SRC = "raweditor_tpu_torch/csrc/develop.cu"
TPU_KERNEL = "raweditor_tpu/ops/pallas_develop.py"
# Nikon D3300 ColorMatrix (dcraw adobe_coeff, x10000) for the accurate frame.
D3300_XYZ_TO_CAM = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                             [-1485, 2204, 7318]], np.float32) / 10000.0


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from raweditor_tpu_torch import DevelopEngine, EditParams, RawImage
    from raweditor_tpu_torch.color import kernel_gamma_for
    from raweditor_tpu_torch.native import get_rawkit
    from raweditor_tpu_torch.ops import _build
    from raweditor_tpu_torch.ops import fused_develop as fused
    from raweditor_tpu_torch.parallel.batch import pack_params

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

    # -- inputs -----------------------------------------------------------
    rng = np.random.default_rng(SEED)
    mosaic = rng.integers(0, 4096, size=(H, W), dtype=np.uint16)
    parity_raw = RawImage(mosaic, np.array([2.0, 1.0, 1.5, 1.0], np.float32),
                          np.eye(3, dtype=np.float32))
    accurate_raw = RawImage(mosaic, np.array([2.0, 1.0, 1.5, 1.0], np.float32),
                            D3300_XYZ_TO_CAM, black_level=150.0,
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
    torch.cuda.synchronize()

    # -- the main path: counts reset just before, read just after --------
    for k in fused.LAUNCHES:
        fused.LAUNCHES[k] = 0
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmpdir:
        jpg_path = eng.export(os.path.join(tmpdir, "frame.jpg"), edit)
        with open(jpg_path, "rb") as f:
            data = f.read()
    y_b, cbcr_b = fused.fused_batch_develop_rgba(batch, batch_scal,
                                                 output="ycbcr420")
    rk = get_rawkit()
    batch_jpegs = [rk.encode_jpeg_420(
        np.ascontiguousarray(y_b[i].cpu().numpy()),
        np.ascontiguousarray(cbcr_b[i, :, 0::2].cpu().numpy()),
        np.ascontiguousarray(cbcr_b[i, :, 1::2].cpu().numpy()),
        W, H, 95, False, 0, 0) for i in range(BATCH)]
    torch.cuda.synchronize()
    launches = dict(fused.LAUNCHES)
    log(f"main path: {time.perf_counter() - t0:.2f} s, launches {launches}, "
        f"preview tick median {statistics.median(tick_ms):.3f} ms "
        "(host clock, first tick included)")
    check(launches["develop_rgba"] > 0, "RGBA kernel never launched")
    check(launches["develop_ycbcr420"] > 0, "YCbCr kernel never launched")

    # -- outputs ----------------------------------------------------------
    check(tuple(prev.shape) == (854, 1280, 3) and prev.dtype == torch.uint8,
          f"preview shape {tuple(prev.shape)}")
    check(hist.shape == (3, 256), f"histogram shape {hist.shape}")
    check((hist.sum(axis=1) == 128 * 85).all(),
          f"histogram sums {hist.sum(axis=1)}")
    check(data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
          and len(data) > 100_000, f"export JFIF ({len(data)} bytes)")
    for j in batch_jpegs:
        check(j[:2] == b"\xff\xd8" and j[-2:] == b"\xff\xd9",
              "batch JFIF markers")
    log(f"export: {len(data)} bytes; batch JPEGs "
        f"{[len(j) for j in batch_jpegs]} bytes")

    errs = {"develop_rgba": 0, "develop_ycbcr420": 0}
    for tr, e in engines.items():
        words = full[tr]
        check(tuple(words.shape) == (H, W) and words.dtype == torch.uint32,
              f"{tr} words shape")
        gamma = kernel_gamma_for(e.transfer)
        plain = fused.develop_rgba_folded_plain(
            e.mosaic[None], e.scalars(edit)[None], e.cfa_phase, gamma)[0]
        mx, share = lsb_diff(words, plain)
        check(mx <= 1, f"{tr}: kernel vs plain {mx} LSB")
        errs["develop_rgba"] = max(errs["develop_rgba"], mx)
        e.use_kernel = False
        parity = e.full_rgba_device(edit)
        e.use_kernel = True
        mx2, share2 = lsb_diff(words, parity)
        check(mx2 <= 1, f"{tr}: kernel vs parity lane {mx2} LSB")
        log(f"{tr}: kernel vs plain max {mx} LSB, differing {share:.3e}; "
            f"vs parity lane max {mx2} LSB, differing {share2:.3e}")
    scal = eng.scalars(edit)[None]
    for phase in ((0, 1), (1, 0), (1, 1)):
        k = fused.fused_batch_develop_rgba(eng.mosaic[None], scal, phase)
        p = fused.develop_rgba_folded_plain(eng.mosaic[None], scal, phase)
        mx, share = lsb_diff(k, p)
        check(mx <= 1, f"phase {phase}: {mx} LSB")
        errs["develop_rgba"] = max(errs["develop_rgba"], mx)
        log(f"phase {phase}: kernel vs plain max {mx} LSB, "
            f"differing {share:.3e}")
    odd = eng.mosaic[None, : H - 1, : W - 3].contiguous()
    mx, _ = lsb_diff(fused.fused_batch_develop_rgba(odd, scal),
                     fused.develop_rgba_folded_plain(odd, scal))
    check(mx <= 1, f"odd frame: {mx} LSB")
    log(f"odd {H - 1}x{W - 3} frame: kernel vs plain max {mx} LSB")

    y_p, cbcr_p = fused.develop_rgba_folded_plain(batch, batch_scal,
                                                  output="ycbcr420")
    for name, a, b in (("Y", y_b, y_p), ("CbCr", cbcr_b, cbcr_p)):
        mx, share = plane_diff(a, b)
        check(mx <= 1, f"{name} plane: {mx}")
        errs["develop_ycbcr420"] = max(errs["develop_ycbcr420"], mx)
        log(f"batch {name}: kernel vs plain max {mx}, differing {share:.3e}")

    # Small input: the card's parity lane against the same code on the
    # CPU (which the CPU tests hold against the JAX package).
    small = RawImage(mosaic[:256, :384].copy(), parity_raw.wb_multipliers,
                     parity_raw.xyz_to_cam)
    gpu_eng = DevelopEngine(small, device="cuda")
    cpu_eng = DevelopEngine(small, device="cpu")
    pv = (np.abs(gpu_eng.preview(edit, 1.5, (0.05, 0.0)).astype(int)
                 - cpu_eng.preview(edit, 1.5, (0.05, 0.0)).astype(int)))
    mx, _ = lsb_diff(gpu_eng.full_rgba_device(edit).cpu(),
                     cpu_eng.full_rgba_device(edit))
    check(pv.max() <= 1 and mx <= 1, f"card vs CPU: {pv.max()}, {mx}")
    log(f"small frame card vs CPU: preview max {pv.max()}, full max {mx}")

    # -- times at 24 MP, kernel and plain in turns ------------------------
    one = eng.mosaic[None]
    rgba_k, rgba_p, yc_k, yc_p = [], [], [], []
    for _ in range(2):
        rgba_k += cuda_ms(lambda: fused.fused_batch_develop_rgba(one, scal),
                          TIMING_REPS // 2)
        rgba_p += cuda_ms(lambda: fused.develop_rgba_folded_plain(one, scal),
                          TIMING_REPS // 2)
        yc_p += cuda_ms(lambda: fused.develop_rgba_folded_plain(
            batch, batch_scal, output="ycbcr420"), TIMING_REPS // 2)
        yc_k += cuda_ms(lambda: fused.fused_batch_develop_rgba(
            batch, batch_scal, output="ycbcr420"), TIMING_REPS // 2)
    times = {k: statistics.median(v) for k, v in (
        ("rgba", rgba_k), ("rgba_plain", rgba_p), ("ycbcr", yc_k),
        ("ycbcr_plain", yc_p))}
    mb = {"rgba": H * W * 6 / 1e6, "ycbcr": BATCH * H * W * 3.5 / 1e6}
    for k in ("rgba", "ycbcr"):
        log(f"time {k}: kernel {times[k]:.4f} ms "
            f"({mb[k] / times[k]:.1f} GB/s), plain {times[k + '_plain']:.4f} "
            f"ms [{smi}]")
    by_gamma = {g: statistics.median(cuda_ms(
        lambda g=g: fused.fused_batch_develop_rgba(one, scal, gamma=g), 10))
        for g in fused.GAMMAS}
    log(f"time rgba kernel by gamma (ms): {json.dumps(by_gamma)}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmpdir:
        e2e = {
            "preview_tick_ms": host_ms(
                lambda: eng.preview_tick(edit, 1.5, (0.01, 0.0)), 20),
            "histogram_ms": host_ms(lambda: eng.histogram(edit), 10),
            "full_rgba_ms": host_ms(lambda: eng.full_rgba_device(edit), 10),
            "jpeg_planes_ms": host_ms(lambda: eng.jpeg_planes(edit), 10),
            "export_jpeg_ms": host_ms(lambda: eng.export(
                os.path.join(tmpdir, "t.jpg"), edit), 3),
        }
    log(f"end to end (host clock, median): {json.dumps(e2e)} [{smi}]")

    kernels = [
        {"name": "develop_rgba", "route": "cuda", "source": SRC,
         "replaces": f"{TPU_KERNEL}:983",
         "launches": launches["develop_rgba"],
         "max_abs_err": errs["develop_rgba"], "ms": times["rgba"],
         "plain_ms": times["rgba_plain"]},
        {"name": "develop_ycbcr420", "route": "cuda", "source": SRC,
         "replaces": f"{TPU_KERNEL}:879",
         "launches": launches["develop_ycbcr420"],
         "max_abs_err": errs["develop_ycbcr420"], "ms": times["ycbcr"],
         "plain_ms": times["ycbcr_plain"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
