"""The port's DevelopEngine on the CPU device against the JAX engine on
the same decoded frame: slider tick, histogram, full-resolution develop
(parity lane and the fused kernel's plain version) and JPEG export."""

import io

import numpy as np
import pytest
import torch

from raweditor_tpu.ops.develop import rgba_view as jax_rgba_view
from raweditor_tpu.ops.jpeg import rgba_words_to_ycbcr420
from raweditor_tpu.ops.pallas_develop import (pallas_batch_develop_rgba,
                                              pallas_develop_rgba)
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.parallel.batch import pack_params as jax_pack_params
from raweditor_tpu.pipeline.engine import DevelopEngine as JaxEngine
from raweditor_tpu.raw.types import RawImage as JaxRaw
from raweditor_tpu_torch import DevelopEngine, EditParams, RawImage
from raweditor_tpu_torch.ops import fused_develop as fd
from raweditor_tpu_torch.ops.develop import rgba_view
from raweditor_tpu_torch.utils import device as device_mod

SLIDERS = dict(exposure=0.5, contrast=6.0, highlights=-0.3, shadows=0.2,
               whites=1.05, blacks=0.03, saturation=30.0, vibrance=0.4,
               temperature=0.15, tint=-0.1)
D3300 = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                  [-1485, 2204, 7318]], np.float32)
# mode, transfer, fast_gamma, cfa pattern
SETUPS = [("parity", "gamma22", False, "RGGB"),
          ("parity", "gamma22", True, "RGGB"),
          ("accurate", "srgb", False, "GBRG"),
          ("accurate", "srgb", True, "BGGR")]


def _raws(rng, pattern, h=80, w=120):
    fields = dict(
        mosaic=rng.integers(0, 4096, size=(h, w), dtype=np.uint16),
        wb_multipliers=np.array([2.1, 1.0, 1.4, 1.0], np.float32),
        xyz_to_cam=D3300, black_level=128.0, white_level=4000.0,
        cfa_pattern=pattern)
    return RawImage(**fields), JaxRaw(**fields)


def _engines(rng, setup, **kw):
    mode, transfer, fast, pattern = setup
    raw, jraw = _raws(rng, pattern)
    port = DevelopEngine(raw, mode=mode, transfer=transfer, fast_gamma=fast,
                         device="cpu", max_preview_width=96,
                         histogram_width=40, **kw)
    ref = JaxEngine(jraw, mode=mode, transfer=transfer, fast_gamma=fast,
                    max_preview_width=96, histogram_width=40)
    return port, ref


def _max_diff(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("setup", SETUPS, ids=lambda s: f"{s[0]}-{s[1]}-{s[2]}")
def test_tick_and_histogram(setup, rng):
    port, ref = _engines(rng, setup)
    assert (port.preview_w, port.preview_h) == (ref.preview_w, ref.preview_h)
    for zoom, pan in ((1.0, (0.0, 0.0)), (2.0, (0.12, -0.08))):
        got = port.preview_tick(EditParams(**SLIDERS), zoom, pan)
        want = ref.preview(JaxParams(**SLIDERS), zoom, pan)
        mx, share = _max_diff(got.numpy(), want)
        print(f"{setup} tick zoom {zoom}: max {mx} LSB, differing {share:.2e}")
        assert mx <= 1
        gh = port.histogram(EditParams(**SLIDERS), zoom, pan)
        wh = ref.histogram(JaxParams(**SLIDERS), zoom, pan)
        assert gh.sum() == wh.sum()
        if mx == 0:
            np.testing.assert_array_equal(gh, wh)


@pytest.mark.parametrize("setup", SETUPS, ids=lambda s: f"{s[0]}-{s[1]}-{s[2]}")
def test_full_rgba(setup, rng):
    port, ref = _engines(rng, setup)
    p, jp = EditParams(**SLIDERS), JaxParams(**SLIDERS)
    # Parity lane against the JAX engine's XLA lane.
    mx, share = _max_diff(rgba_view(port.full_rgba_device(p)),
                          jax_rgba_view(ref.full_rgba_device(jp)))
    print(f"{setup} parity lane: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1
    np.testing.assert_array_equal(
        port.full(p), rgba_view(port.full_rgba_device(p))[..., :3])
    # use_kernel (on the CPU: the kernel's plain version) against the TPU
    # kernel in interpret mode with the engine's resolved settings.
    port.use_kernel = True
    want = pallas_develop_rgba(
        ref.mosaic, jp, ref.wb, ref.cam_matrix, white_level=ref.white_level,
        black_level=ref.black_level, matrix_transpose=ref.matrix_transpose,
        cfa_phase=ref.cfa_phase, gamma={"gamma22": "pow",
                                        "gamma22_poly": "poly"}.get(
                                            ref.transfer, ref.transfer),
        interpret=True)
    mx, share = _max_diff(rgba_view(port.full_rgba_device(p)),
                          jax_rgba_view(want))
    print(f"{setup} kernel lane: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1


@pytest.mark.parametrize("use_kernel", [False, True])
def test_jpeg_export(use_kernel, rng, tmp_path):
    port, ref = _engines(rng, SETUPS[0], use_kernel=use_kernel)
    p, jp = EditParams(**SLIDERS), JaxParams(**SLIDERS)
    planes = [t.numpy() for t in port.jpeg_planes(p)]
    if use_kernel:
        y, cbcr = pallas_batch_develop_rgba(
            ref.mosaic[None], jax_pack_params([jp]), ref.wb[None],
            ref.cam_matrix[None], interpret=True, output="ycbcr420")
        want = (y[0], cbcr[0, :, 0::2], cbcr[0, :, 1::2])
    else:
        want = rgba_words_to_ycbcr420(ref.full_rgba_device(jp))
    for name, g, w in zip("Y Cb Cr".split(), planes, want):
        mx, share = _max_diff(g, w)
        print(f"export planes {name} (kernel={use_kernel}): max {mx}, "
              f"differing {share:.2e}")
        assert g.shape == np.asarray(w).shape and mx <= 1
    path = port.export(tmp_path / "out.jpg", p, quality=90)
    data = (tmp_path / "out.jpg").read_bytes()
    assert path.endswith("out.jpg") and data[:2] == b"\xff\xd8"
    from PIL import Image

    img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert img.shape == (port.height, port.width, 3)
    # The JAX engine's JPEG (same encoder; its planes from its XLA lane)
    # decodes to the same pixels up to the planes' difference.
    ref.export(tmp_path / "ref.jpg", jp, quality=90)
    want = np.asarray(Image.open(tmp_path / "ref.jpg").convert("RGB"))
    mx, share = _max_diff(img, want)
    print(f"decoded export vs JAX export: max {mx}, differing {share:.2e}")
    assert np.abs(img.astype(int) - want.astype(int)).mean() < 0.05
    port.export(tmp_path / "out.png", p)
    png = np.asarray(Image.open(tmp_path / "out.png"))
    np.testing.assert_array_equal(
        png, rgba_view(port.full_rgba_device(p))[..., :3])
    assert sorted(x.name for x in tmp_path.iterdir()) == [
        "out.jpg", "out.png", "ref.jpg"]


def test_preview_jpeg(rng):
    port, ref = _engines(rng, SETUPS[0])
    data, w, h = port.preview_jpeg(EditParams(**SLIDERS))
    assert (w, h) == (port.preview_w, port.preview_h)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"


def test_unported_and_invalid(rng, tmp_path, monkeypatch):
    port, _ = _engines(rng, SETUPS[0], use_kernel=True)
    for p in (EditParams(sharpen=20.0), EditParams(hue_red=10.0)):
        with pytest.raises(NotImplementedError):
            port.full_rgba_device(p)
        with pytest.raises(NotImplementedError):
            port.preview_tick(p)
    with pytest.raises(NotImplementedError):
        port.export(tmp_path / "x.tif", EditParams())
    with pytest.raises(ValueError):
        port.export(tmp_path / "x.webp", EditParams())
    raw, _ = _raws(rng, "RGGB")
    raw.cfa_pattern = "GGRGGB" * 6
    with pytest.raises(NotImplementedError):
        DevelopEngine(raw, mode="accurate", device="cpu")
    raw.mosaic = np.zeros((4, 4, 3), np.uint16)
    with pytest.raises(NotImplementedError):
        DevelopEngine(raw, device="cpu")
    with pytest.raises(ValueError):
        DevelopEngine(raw, mode="fast", device="cpu")
    # An explicit CUDA device never falls back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        device_mod.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        DevelopEngine(_raws(rng, "RGGB")[0], device="cuda")
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_mod.resolve_device("meta")


def test_rawkit_loaded_by_path():
    from raweditor_tpu_torch.native import get_rawkit, rawkit_path

    rk = get_rawkit()
    assert rk.__name__ == "_rawkit" and hasattr(rk, "encode_jpeg_420")
    assert rawkit_path().parent.name == "native"
    assert fd.N_SCALARS == 24
