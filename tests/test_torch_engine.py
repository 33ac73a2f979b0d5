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
    # The PNG keeps the alpha channel, as the JAX engine's does: same
    # mode, and the pixels within the lanes' 1 LSB (equal for this seed
    # on the plain lane).
    port.export(tmp_path / "out.png", p)
    ref.export(tmp_path / "ref.png", jp)
    png, ref_png = (Image.open(tmp_path / n) for n in ("out.png", "ref.png"))
    assert png.mode == ref_png.mode == "RGBA"
    mx, share = _max_diff(np.asarray(png), np.asarray(ref_png))
    print(f"PNG vs JAX PNG (kernel={use_kernel}): max {mx}, differing "
          f"{share:.2e}")
    assert np.asarray(png).shape == (port.height, port.width, 4)
    assert mx <= 1 and (use_kernel or mx == 0)
    np.testing.assert_array_equal(
        np.asarray(png), rgba_view(port.full_rgba_device(p)))
    assert sorted(x.name for x in tmp_path.iterdir()) == [
        "out.jpg", "out.png", "ref.jpg", "ref.png"]


def _tags(path):
    """(make, model, orientation) from a file's EXIF block."""
    from PIL import Image

    exif = Image.open(path).getexif()
    return exif.get(271), exif.get(272), exif.get(274)


@pytest.mark.parametrize("auto_orient", [False, True])
@pytest.mark.parametrize("ext", [".jpg", ".png"])
def test_export_metadata_and_orientation(ext, auto_orient, rng, tmp_path):
    """A frame shot on its side (orientation 6): both engines write the
    same make, model and orientation tag, and with ``auto_orient`` the
    same rotated picture tagged upright."""
    from PIL import Image

    raw, jraw = _raws(rng, "RGGB")
    for r in (raw, jraw):
        r.orientation = 6
        r.camera_make, r.camera_model = "NIKON CORPORATION", "NIKON D3300"
    port = DevelopEngine(raw, device="cpu", auto_orient=auto_orient)
    ref = JaxEngine(jraw, auto_orient=auto_orient)
    p, jp = EditParams(**SLIDERS), JaxParams(**SLIDERS)
    port.export(tmp_path / ("out" + ext), p)
    ref.export(tmp_path / ("ref" + ext), jp)
    got, want = _tags(tmp_path / ("out" + ext)), _tags(tmp_path / ("ref" + ext))
    assert got == want == ("NIKON CORPORATION", "NIKON D3300",
                           1 if auto_orient else 6)
    a = Image.open(tmp_path / ("out" + ext))
    b = Image.open(tmp_path / ("ref" + ext))
    assert a.mode == b.mode and a.size == b.size
    assert a.size == ((raw.height, raw.width) if auto_orient
                      else (raw.width, raw.height))
    mx, share = _max_diff(np.asarray(a), np.asarray(b))
    print(f"{ext} auto_orient={auto_orient}: max {mx}, differing {share:.2e}")
    if ext == ".png" or auto_orient:
        # PNG, and the rotated JPEG (PIL on both sides): the same pixels.
        assert mx == 0
    else:
        assert np.abs(np.asarray(a).astype(int)
                      - np.asarray(b).astype(int)).mean() < 0.05


def test_apply_orientation_matches_jax():
    img = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    for orientation in range(0, 10):
        np.testing.assert_array_equal(
            DevelopEngine.apply_orientation(img, orientation),
            JaxEngine.apply_orientation(img, orientation))


def test_export_makes_directory_and_leaves_no_temporary(rng, tmp_path,
                                                        monkeypatch):
    """The atomic write makes the parent directory, names its temporary
    file by process and thread, and leaves only the export behind."""
    import os
    import pathlib
    import threading

    from raweditor_tpu_torch.pipeline import engine as engine_mod

    port, _ = _engines(rng, SETUPS[0])
    out = tmp_path / "not" / "there" / "yet" / "out.jpg"
    assert port.export(out, EditParams()) == str(out)
    assert [x.name for x in out.parent.iterdir()] == ["out.jpg"]
    seen = []
    real_replace = os.replace

    def spy(src, dst):
        seen.append(os.path.basename(src))
        return real_replace(src, dst)

    gate = threading.Barrier(4)  # all four alive at once: no reused ident

    def write(i):
        gate.wait()
        engine_mod._atomic_write(
            str(tmp_path / "same.bin"),
            lambda tmp: pathlib.Path(tmp).write_bytes(bytes([i]) * 1000))
        gate.wait()

    monkeypatch.setattr(os, "replace", spy)
    threads = [threading.Thread(target=write, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    monkeypatch.undo()
    assert len(set(seen)) == 4
    assert all(n.startswith(f"same.bin.{os.getpid()}.") for n in seen)
    data = (tmp_path / "same.bin").read_bytes()
    assert len(data) == 1000 and len(set(data)) == 1
    assert sorted(x.name for x in tmp_path.iterdir()) == ["not", "same.bin"]


def test_preview_jpeg(rng):
    port, ref = _engines(rng, SETUPS[0])
    data, w, h = port.preview_jpeg(EditParams(**SLIDERS))
    assert (w, h) == (port.preview_w, port.preview_h)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"


def test_preview_jpeg_of_an_odd_preview(rng):
    """An odd preview height cannot be 4:2:0 planes: it goes through PIL
    and decodes to the preview's size."""
    from PIL import Image

    raw, _ = _raws(rng, "RGGB", h=52, w=120)
    port = DevelopEngine(raw, device="cpu", max_preview_width=40)
    assert port.preview_h % 2 == 1
    data, w, h = port.preview_jpeg(EditParams(**SLIDERS))
    assert (w, h) == (port.preview_w, port.preview_h)
    assert Image.open(io.BytesIO(data)).size == (w, h)


def test_unported_and_invalid(rng, tmp_path, monkeypatch):
    port, _ = _engines(rng, SETUPS[0], use_kernel=True)
    for p in (EditParams(clarity=20.0), EditParams(grain=10.0)):
        with pytest.raises(NotImplementedError):
            port.full_rgba_device(p)
        with pytest.raises(NotImplementedError):
            port.preview_tick(p)
    with pytest.raises(NotImplementedError):
        port.export(tmp_path / "x.tif", EditParams())
    with pytest.raises(ValueError):
        port.export(tmp_path / "x.webp", EditParams())
    raw, _ = _raws(rng, "RGGB")
    # Neither a Bayer phase nor a 36-letter grid (those develop as
    # X-Trans: tests/test_torch_xtrans.py).
    for pattern in ("RGGG" "GGGG" "GGGB" "GGGG", "RGBG", "GGRGGB" * 4):
        raw.cfa_pattern = pattern
        with pytest.raises(NotImplementedError, match="CFA pattern"):
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


class _EncodeRecorder:
    """``_rawkit`` with its JFIF encoders recorded: (name, planes,
    the remaining arguments)."""

    def __init__(self, rk):
        self._rk, self.calls = rk, []

    def __getattr__(self, name):
        fn = getattr(self._rk, name)
        if not name.startswith("encode_jpeg"):
            return fn

        def record(*args):
            self.calls.append((name, [np.array(a) for a in args[:3]],
                               tuple(args[3:])))
            return fn(*args)

        return record


def _sampling(data: bytes):
    """(h, v) sampling factors of the first component of a JPEG's SOF."""
    i = min(j for j in (data.find(m) for m in (b"\xff\xc0", b"\xff\xc2"))
            if j >= 0)
    return data[i + 11] >> 4, data[i + 11] & 15


@pytest.mark.parametrize("flags", [
    dict(chroma="444"), dict(jpeg_optimize=True), dict(jpeg_restart_rows=2),
    dict(chroma="444", jpeg_optimize=True, jpeg_restart_rows=1)],
    ids=["444", "optimize", "restart", "all"])
@pytest.mark.parametrize("shape", [(80, 120), (47, 75)], ids=["even", "odd"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_export_jpeg_flags(flags, shape, use_kernel, rng, tmp_path,
                           monkeypatch):
    """``chroma``, ``jpeg_optimize`` and ``jpeg_restart_rows`` as in the
    JAX engine: 4:4:4 takes the planes path for even and odd frames alike
    (odd 4:2:0 goes through PIL), and the encoder gets the JAX engine's
    planes within 1 LSB (measured 0) and the same arguments. The flags
    show in the bytes: the SOF's sampling factors, a DRI marker, and
    optimised tables make a smaller file of the same picture."""
    import raweditor_tpu.native as jax_native
    import raweditor_tpu_torch.native as port_native
    from PIL import Image

    raw, jraw = _raws(rng, "RGGB", *shape)
    port = DevelopEngine(raw, device="cpu", use_kernel=use_kernel)
    ref = JaxEngine(jraw)
    p, jp = EditParams(**SLIDERS), JaxParams(**SLIDERS)
    got_rk = _EncodeRecorder(port_native.require_rawkit())
    want_rk = _EncodeRecorder(jax_native.get_rawkit())
    monkeypatch.setattr(port_native, "require_rawkit", lambda: got_rk)
    monkeypatch.setattr(jax_native, "get_rawkit", lambda: want_rk)
    port.export(tmp_path / "out.jpg", p, quality=90, **flags)
    ref.export(tmp_path / "ref.jpg", jp, quality=90, **flags)
    planes_path = flags.get("chroma") == "444" or shape[0] % 2 == 0
    assert len(got_rk.calls) == len(want_rk.calls) == int(planes_path)
    worst = 0
    for (name, planes, args), (jname, jplanes, jargs) in zip(
            got_rk.calls, want_rk.calls):
        assert name == jname == ("encode_jpeg_444" if flags.get("chroma")
                                 == "444" else "encode_jpeg_420")
        assert args == jargs
        for a, b in zip(planes, jplanes):
            assert a.shape == b.shape
            worst = max(worst, _max_diff(a, b)[0])
    assert worst <= 1
    data = (tmp_path / "out.jpg").read_bytes()
    ref_data = (tmp_path / "ref.jpg").read_bytes()
    if worst == 0:
        assert data == ref_data
    assert _sampling(data) == ((1, 1) if flags.get("chroma") == "444"
                               else (2, 2))
    assert (b"\xff\xdd" in data) == bool(flags.get("jpeg_restart_rows"))
    if flags.get("jpeg_optimize"):
        port.export(tmp_path / "base.jpg", p, quality=90,
                    **{k: v for k, v in flags.items() if k != "jpeg_optimize"})
        assert len(data) < (tmp_path / "base.jpg").stat().st_size
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "out.jpg")),
            np.asarray(Image.open(tmp_path / "base.jpg")))
    print(f"{shape} {flags} kernel={use_kernel}: planes max {worst} LSB")


@pytest.mark.parametrize("flags", [
    dict(chroma="444"), dict(jpeg_optimize=True), dict(jpeg_restart_rows=1)],
    ids=["444", "optimize", "restart"])
def test_pil_export_honours_the_jpeg_flags(flags, rng, tmp_path):
    """A frame that ``auto_orient`` rotates goes through PIL in both
    engines with the same flags: the same bytes (same pixels, same
    encoder), 4:4:4 sampling, restart markers."""
    raw, jraw = _raws(rng, "RGGB")
    for r in (raw, jraw):
        r.orientation = 6
    port = DevelopEngine(raw, device="cpu", auto_orient=True)
    ref = JaxEngine(jraw, auto_orient=True)
    port.export(tmp_path / "out.jpg", EditParams(**SLIDERS), **flags)
    ref.export(tmp_path / "ref.jpg", JaxParams(**SLIDERS), **flags)
    data = (tmp_path / "out.jpg").read_bytes()
    assert data == (tmp_path / "ref.jpg").read_bytes()
    assert _sampling(data) == ((1, 1) if "chroma" in flags else (2, 2))
    assert (b"\xff\xdd" in data) == ("jpeg_restart_rows" in flags)


@pytest.mark.parametrize("kw", [
    dict(long_edge=64), dict(rotate=2.0), dict(crop=(0, 0, 40, 40)),
    dict(lens=(0.01, 0.0, 0.0, 0.0)), dict(perspective=(0.1, 0.0)),
    dict(chroma="422")], ids=lambda kw: next(iter(kw)))
def test_export_refuses_unported_arguments(kw, rng, tmp_path):
    """``long_edge`` and the geometry arguments raise
    ``NotImplementedError`` naming themselves; an unknown ``chroma``
    raises ``ValueError``, as in the JAX engine. Nothing is written."""
    port, _ = _engines(rng, SETUPS[0])
    name = next(iter(kw))
    err = ValueError if name == "chroma" else NotImplementedError
    with pytest.raises(err, match=name):
        port.export(tmp_path / "out.jpg", EditParams(), **kw)
    assert not list(tmp_path.iterdir())
