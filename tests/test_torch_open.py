"""``DevelopEngine.open(path)`` on the CPU device against the JAX
engine's ``open`` on the same file: a Bayer DNG (GBRG, the D3300 matrix,
black 150, white 4095) and an X-Trans RAF, in parity and accurate mode.

Tolerances are the engine tests' (``tests/test_torch_engine.py``,
``tests/test_torch_xtrans.py``): the slider tick and the full develop
within 1 LSB of 8-bit sRGB, histograms with equal sums (equal bins where
the tick is bit-equal). A frame opened from a file develops exactly like
the same fields handed in (``RawImage.from_fields``).
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.pipeline.engine import DevelopEngine as JaxEngine
from raweditor_tpu_torch import DevelopEngine, EditParams, RawImage
from raweditor_tpu_torch.ops import fused_develop as fd
from raweditor_tpu_torch.ops.cfa_generic import XTRANS_PATTERN
from raweditor_tpu_torch.ops.develop import rgba_view
from raweditor_tpu_torch.raw import raf, synth
from raweditor_tpu_torch.utils import device as device_mod

SLIDERS = dict(exposure=0.5, contrast=6.0, highlights=-0.3, shadows=0.2,
               whites=1.05, blacks=0.03, saturation=30.0, vibrance=0.4,
               temperature=0.15, tint=-0.1)
EXTRAS = dict(SLIDERS, sharpen=60.0, denoise=40.0, vignette=-30.0,
              hue_red=25.0, grade_shadow_hue=210.0, grade_shadow_sat=40.0)
D3300 = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                  [-1485, 2204, 7318]], np.float32) / 10000.0
VIEW = dict(max_preview_width=48, histogram_width=24)


def _write(tmp_path, kind):
    rng = np.random.default_rng(4242)
    mosaic = rng.integers(0, 4096, size=(48, 72), dtype=np.uint16)
    if kind == "dng":
        path = tmp_path / "frame.dng"
        synth.write_synthetic_raw(
            path, mosaic, compression="ljpeg", xyz_to_cam=D3300,
            black_level=150, white_level=4095, wb_neutral=(0.5, 1.0, 0.625),
            cfa="GBRG", make="NIKON CORPORATION", model="NIKON D3300",
            preview_jpeg=b"")
    else:
        path = tmp_path / "frame.raf"
        path.write_bytes(raf.write_raf(mosaic, model="X-T2",
                                       wb_grbg=(256, 512, 384, 256)))
    return path, mosaic


def _diff(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("mode", ["parity", "accurate"])
@pytest.mark.parametrize("kind", ["dng", "raf"])
def test_open_matches_jax(kind, mode, tmp_path):
    path, _ = _write(tmp_path, kind)
    method = "grad" if mode == "accurate" else "nearest"
    port = DevelopEngine.open(path, mode=mode, device="cpu",
                              demosaic_method=method, **VIEW)
    ref = JaxEngine.open(path, mode=mode, demosaic_method=method, **VIEW)
    assert port.raw.source_path == ref.raw.source_path == str(path)
    assert (port.xtrans_pattern, port.cfa_phase) == (ref.xtrans_pattern,
                                                    ref.cfa_phase)
    assert port.xtrans_pattern == (XTRANS_PATTERN if kind == "raf"
                                   and mode == "accurate" else None)
    for edit in (SLIDERS, EXTRAS):
        p, jp = EditParams(**edit), JaxParams(**edit)
        for zoom, pan in ((1.0, (0.0, 0.0)), (2.0, (0.1, -0.05))):
            mx, share = _diff(port.preview_tick(p, zoom, pan).numpy(),
                              ref.preview(jp, zoom, pan))
            print(f"{kind} {mode} tick zoom {zoom}: max {mx} LSB, "
                  f"differing {share:.2e}")
            assert mx <= 1
            gh, wh = port.histogram(p, zoom, pan), ref.histogram(jp, zoom,
                                                                 pan)
            assert gh.sum() == wh.sum()
            if mx == 0:
                np.testing.assert_array_equal(gh, wh)
        mx, share = _diff(port.full(p), np.asarray(ref.full(jp)))
        print(f"{kind} {mode} full: max {mx} LSB, differing {share:.2e}")
        assert mx <= 1


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("kind", ["dng", "raf"])
def test_a_file_develops_like_the_same_fields_in_memory(kind, use_kernel,
                                                        tmp_path):
    """The frame decoded from the file is the one written, and develops
    bit for bit like an engine built from those fields in memory (on the
    CPU ``use_kernel`` runs the kernels' plain versions)."""
    path, mosaic = _write(tmp_path, kind)
    kw = dict(mode="accurate", device="cpu", use_kernel=use_kernel, **VIEW)
    opened = DevelopEngine.open(path, **kw)
    raw = opened.raw
    np.testing.assert_array_equal(raw.mosaic, mosaic)
    if kind == "dng":
        want = dict(wb_multipliers=[2.0, 1.0, 1.6, 1.0], xyz_to_cam=D3300,
                    black_level=150.0, white_level=4095.0, cfa_pattern="GBRG")
    else:
        want = dict(wb_multipliers=[2.0, 1.0, 1.5, 1.0],
                    xyz_to_cam=np.eye(3), black_level=0.0,
                    white_level=float(mosaic.max()), cfa_pattern=XTRANS_PATTERN)
    for name, value in want.items():
        np.testing.assert_array_equal(getattr(raw, name),
                                      np.asarray(value, np.float32)
                                      if isinstance(value, (list, np.ndarray))
                                      else value)
    memory = DevelopEngine(RawImage.from_fields(dataclasses.asdict(raw)),
                           **kw)
    for edit in (SLIDERS, EXTRAS):
        p = EditParams(**edit)
        assert torch.equal(opened.full_rgba_device(p),
                           memory.full_rgba_device(p))
        np.testing.assert_array_equal(rgba_view(opened.full_rgba_device(p)),
                                      rgba_view(memory.full_rgba_device(p)))


def test_open_routes_xtrans_to_the_generic_cfa_tiers(tmp_path, monkeypatch):
    """An opened RAF runs the generic-CFA tier of its demosaic, never a
    Bayer one: on the CPU the wrapper's plain version is called with the
    RAF's pattern."""
    path, _ = _write(tmp_path, "raf")
    seen = []
    real = fd.develop_rgba_folded_plain
    signature = inspect.signature(real)

    def spy(*args, **kw):
        given = signature.bind(*args, **kw).arguments
        seen.append((given["demosaic"], given["pattern"]))
        return real(*args, **kw)

    monkeypatch.setattr(fd, "develop_rgba_folded_plain", spy)
    for method, tier in (("nearest", "nearest"), ("malvar", "smooth"),
                         ("grad", "grad")):
        DevelopEngine.open(path, mode="accurate", device="cpu",
                           use_kernel=True, demosaic_method=method,
                           **VIEW).full_rgba_device(EditParams(**SLIDERS))
        assert seen[-1] == (tier, XTRANS_PATTERN)


def test_open_of_linear_raw_is_not_ported(tmp_path):
    path = tmp_path / "linear.dng"
    synth.write_synthetic_linear_dng(
        path, np.random.default_rng(3).integers(0, 65536, (16, 24, 3),
                                                dtype=np.uint16))
    for device in ("cpu", "cuda"):
        with pytest.raises(NotImplementedError, match="LinearRaw"):
            DevelopEngine.open(path, mode="accurate", device=device)


def test_open_defaults_to_the_card(tmp_path, monkeypatch):
    """With no device named, ``open`` asks for CUDA and raises without
    one; nothing falls back to the CPU."""
    path, _ = _write(tmp_path, "dng")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        DevelopEngine.open(path)
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
