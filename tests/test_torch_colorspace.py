"""Wide-gamut output in the port (``color.py``'s output spaces, the copied
``icc.py``, and ``color_space`` through ``DevelopEngine`` and
``run_batch_export``) against the JAX package on the CPU.

Tolerances: the matrices are equal to 0 ulp and the ICC profiles byte
for byte; the transfers within 4 ulp of 1.0 on torch (XLA's and
PyTorch's CPU ``pow`` round apart) and equal on numpy; developed pixels
within 1 LSB of 8-bit output, as ``tests/test_torch_engine.py`` holds
them (measured maxima printed); the exporter's encoder inputs within 1
LSB with equal arguments, the profile among them.
"""

import io
import os

import numpy as np
import pytest
import torch

from raweditor_tpu import color as jcolor
from raweditor_tpu import icc as jicc
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.pipeline import export as jex
from raweditor_tpu.pipeline.engine import DevelopEngine as JaxEngine
from raweditor_tpu.raw.types import RawImage as JaxRaw
from raweditor_tpu_torch import DevelopEngine, EditParams, RawImage
from raweditor_tpu_torch import color as tcolor
from raweditor_tpu_torch import icc as ticc
from raweditor_tpu_torch.ops import fused_develop as fd
from raweditor_tpu_torch.ops.develop import rgba_view
from raweditor_tpu_torch.pipeline import export as pex
from raweditor_tpu_torch.raw import synth

SPACES = ("srgb", "display-p3", "adobe-rgb")
D3300 = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                  [-1485, 2204, 7318]], np.float32)
MATRICES = {
    "identity": np.eye(3),
    "scaled": D3300.astype(np.float64),                  # x10000 in metadata
    "unscaled": D3300.astype(np.float64) / 10000.0,
    "degenerate": np.zeros((3, 3)),
    "wild": np.full((3, 3), 0.5),
}
SLIDERS = dict(exposure=0.4, contrast=6.0, saturation=30.0, vibrance=0.3,
               temperature=0.1, tint=-0.05)
EXTRAS = dict(sharpen=40.0, vignette=-20.0, hue_red=20.0,
              grade_shadow_hue=200.0, grade_shadow_sat=30.0)


def test_spaces_and_tables_equal_jax():
    assert tcolor.COLOR_SPACES == jcolor.COLOR_SPACES
    assert tcolor.TRANSFER_BY_SPACE == jcolor.TRANSFER_BY_SPACE
    assert tcolor.TRANSFER16_BY_TRANSFER == jcolor.TRANSFER16_BY_TRANSFER
    assert tcolor.ADOBE_GAMMA == jcolor.ADOBE_GAMMA
    for name in ("DISPLAY_P3_TO_XYZ", "ADOBE_RGB_TO_XYZ"):
        got, want = getattr(tcolor, name), getattr(jcolor, name)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    prim = ((0.64, 0.33), (0.3, 0.6), (0.15, 0.06))
    assert (tcolor._rgb_to_xyz_from_chromaticities(prim, (0.3127, 0.329))
            .tobytes() == jcolor._rgb_to_xyz_from_chromaticities(
                prim, (0.3127, 0.329)).tobytes())
    for t in ("gamma22", "gamma22_poly", "srgb", "srgb_poly", "gamma_adobe"):
        assert tcolor.transfer16_for(t) == jcolor.transfer16_for(t)
    # The kernels have no Adobe lane: validated, no lane; unknown raises.
    assert tcolor.kernel_gamma_for("gamma_adobe") is None
    assert tcolor.kernel_gamma_for("srgb_poly") == "srgb_poly"
    with pytest.raises(ValueError):
        tcolor.kernel_gamma_for("bogus")


@pytest.mark.parametrize("matrix", list(MATRICES))
@pytest.mark.parametrize("space", SPACES)
def test_cam_to_output_matrix_is_the_jax_matrix(space, matrix):
    """0 ulp for every space, including the sRGB-to-target bridge that
    identity, degenerate and wild metadata fall back on; parity refuses
    the wide spaces."""
    m = MATRICES[matrix]
    got = tcolor.cam_to_output_matrix(m, "accurate", space)
    want = jcolor.cam_to_output_matrix(m, "accurate", space)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    if space == "srgb":
        assert (tcolor.cam_to_output_matrix(m, "parity", space).tobytes()
                == jcolor.cam_to_output_matrix(m, "parity", space).tobytes())
    else:
        for mod in (tcolor, jcolor):
            with pytest.raises(ValueError, match="accurate"):
                mod.cam_to_output_matrix(m, "parity", space)
    with pytest.raises(ValueError, match="unknown color space"):
        tcolor.cam_to_output_matrix(m, "accurate", "rec2020")


@pytest.mark.parametrize("fn", ["adobe_gamma_encode", "srgb_decode"])
def test_adobe_encode_and_srgb_decode(fn):
    """On torch against the jitted JAX function (within 4 ulp of 1.0);
    on numpy float64, as ``icc.py`` calls ``srgb_decode``, equal to the
    JAX numpy branch in value and dtype."""
    import jax

    x = np.linspace(-0.1, 1.2, 20001, dtype=np.float32)
    want = np.asarray(jax.jit(getattr(jcolor, fn))(x))
    got = getattr(tcolor, fn)(torch.from_numpy(x)).numpy()
    err = float(np.abs(got - want).max())
    print(f"{fn} torch: max abs diff {err:.3g}")
    assert got.dtype == np.float32 and err <= 4 * np.finfo(np.float32).eps
    for xs in (np.linspace(0.0, 1.0, 1024), x):
        got, want = getattr(tcolor, fn)(xs), getattr(jcolor, fn)(xs)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
    if fn == "adobe_gamma_encode":
        assert tcolor.encoder_for("gamma_adobe") is tcolor.adobe_gamma_encode


@pytest.mark.parametrize("space", SPACES)
def test_profile_bytes_are_the_jax_bytes(space):
    got = ticc.profile_bytes(space)
    assert got == jicc.profile_bytes(space)
    assert got[36:40] == b"acsp" and len(got) % 4 == 0
    with pytest.raises(ValueError):
        ticc.profile_bytes("rec2020")


def test_splice_icc_jpeg_matches(rng):
    from raweditor_tpu_torch.raw.exif import build_exif, splice_exif

    jpeg = b"\xff\xd8\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01" \
        b"\x00\x00\xff\xdb\x00\x02\xff\xd9"
    with_exif = splice_exif(jpeg, build_exif("Make", "Model", 6))
    big = rng.integers(0, 256, 200000, dtype=np.uint8).tobytes()
    for data in (jpeg, with_exif, b"not a jpeg"):
        for icc in (ticc.profile_bytes("adobe-rgb"), big):
            out = ticc.splice_icc_jpeg(data, icc)
            assert out == jicc.splice_icc_jpeg(data, icc)
    assert ticc.splice_icc_jpeg(jpeg, big).count(b"ICC_PROFILE\0") == 4


def _raws(rng, h=48, w=72, **extra):
    fields = dict(
        mosaic=rng.integers(0, 4096, size=(h, w), dtype=np.uint16),
        wb_multipliers=np.array([2.1, 1.0, 1.4, 1.0], np.float32),
        xyz_to_cam=D3300, black_level=128.0, white_level=4000.0,
        cfa_pattern="GBRG", camera_make="NIKON CORPORATION",
        camera_model="NIKON D3300", **extra)
    return RawImage(**fields), JaxRaw(**fields)


def _max_diff(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("space", ["display-p3", "adobe-rgb"])
def test_engine_develops_and_exports_the_jax_space(space, fast, rng,
                                                   tmp_path):
    """``full_rgba_device`` (plain lane and kernel route), the tick, and
    ``export`` to JPEG and PNG against the JAX engine: pixels within 1
    LSB, the ICC profile in the APP2 segment and the PNG ``iCCP`` chunk
    equal to the JAX file's."""
    from PIL import Image

    raw, jraw = _raws(rng)
    kw = dict(mode="accurate", demosaic_method="malvar", color_space=space,
              fast_gamma=fast, max_preview_width=64, histogram_width=32)
    port = DevelopEngine(raw, device="cpu", **kw)
    ref = JaxEngine(jraw, **kw)
    assert port.transfer == ref.transfer
    assert port.cam_matrix.tobytes() == ref.cam_matrix.tobytes()
    p, jp = EditParams(**SLIDERS), JaxParams(**SLIDERS)
    want = np.asarray(ref.full_rgba_device(jp)).view(np.uint8).reshape(
        48, 72, 4)
    worst = {"plain": _max_diff(rgba_view(port.full_rgba_device(p)), want),
             "tick": _max_diff(port.preview_tick(p).numpy(), ref.preview(jp))}
    port.use_kernel = True
    worst["kernel"] = _max_diff(rgba_view(port.full_rgba_device(p)), want)
    print(f"{space} fast={fast}: {worst}")
    assert all(v[0] <= 1 for v in worst.values())
    for ext in ("jpg", "png"):
        port.export(tmp_path / f"p.{ext}", p)
        ref.export(tmp_path / f"j.{ext}", jp)
        a, b = (Image.open(tmp_path / f"{n}.{ext}") for n in "pj")
        assert a.info["icc_profile"] == b.info["icc_profile"] == \
            ticc.profile_bytes(space)
        assert a.getexif() == b.getexif()
        mx, share = _max_diff(np.asarray(a), np.asarray(b))
        print(f"{space} export .{ext}: max {mx}, differing {share:.2e}")
        assert mx <= 1
    # The sRGB default embeds nothing.
    DevelopEngine(raw, device="cpu", mode="accurate").export(
        tmp_path / "s.jpg", p)
    assert b"ICC_PROFILE" not in (tmp_path / "s.jpg").read_bytes()


def test_adobe_with_use_kernel_takes_the_plain_develop(rng, monkeypatch):
    """The kernels have no Adobe RGB lane: with ``use_kernel`` the Adobe
    develop is the plain lane (a route by transfer, not by failure),
    bit-equal to ``use_kernel=False``; the extras post-pass still runs
    B8's wrapper. A P3 develop takes the kernel."""
    from raweditor_tpu_torch.ops import fused_extras as fx

    raw, _ = _raws(rng)
    launched = []
    for name in ("fused_develop_rgba", "fused_batch_develop_rgba"):
        real = getattr(fd, name)

        def spy(*a, _real=real, _name=name, **k):
            launched.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(fd, name, spy)
    real_fx = fx.fused_finish_extras_rgba

    def spy_fx(*a, **k):
        launched.append("extras")
        return real_fx(*a, **k)

    monkeypatch.setattr(fx, "fused_finish_extras_rgba", spy_fx)
    adobe = DevelopEngine(raw, device="cpu", mode="accurate",
                          color_space="adobe-rgb", use_kernel=True)
    plain = DevelopEngine(raw, device="cpu", mode="accurate",
                          color_space="adobe-rgb")
    p, px = EditParams(**SLIDERS), EditParams(**SLIDERS, **EXTRAS)
    assert torch.equal(adobe.full_rgba_device(p), plain.full_rgba_device(p))
    for a, b in zip(adobe.jpeg_planes(p), plain.jpeg_planes(p)):
        assert torch.equal(a, b)
    assert launched == []
    adobe.jpeg_planes(px)
    assert launched == ["extras"]
    launched.clear()
    DevelopEngine(raw, device="cpu", mode="accurate", color_space="display-p3",
                  use_kernel=True).jpeg_planes(p)
    assert launched == ["fused_batch_develop_rgba"]


@pytest.mark.parametrize("route", ["p3-kernel", "adobe-kernel", "p3-png"])
def test_batch_export_color_space_matches_the_jax_exporter(route, rng,
                                                           tmp_path,
                                                           monkeypatch):
    """What each exporter hands its encoder, profile included, within 1
    LSB; the port's JPEG file carries the profile and equals the engine's
    export of the same job."""
    space = "adobe-rgb" if route.startswith("adobe") else "display-p3"
    ext = ".png" if route.endswith("png") else ".jpg"
    d = tmp_path / "raw"
    d.mkdir()
    paths = []
    for i in range(3):
        p = d / f"b{i}.dng"
        synth.write_synthetic_raw(
            p, rng.integers(0, 4096, size=(24, 32), dtype=np.uint16),
            xyz_to_cam=D3300, black_level=150, white_level=4095,
            wb_neutral=(0.5, 1.0, 0.625), cfa="GBRG",
            make="NIKON CORPORATION", model="NIKON D3300", preview_jpeg=b"")
        paths.append(str(p))
    edits = [dict(SLIDERS), dict(SLIDERS, **EXTRAS), {}]
    seen = {"port": {}, "jax": {}}
    real = {"port": (pex._encode_one_jpeg420, pex._encode_one)}
    for pkg, mod in (("port", pex), ("jax", jex)):
        def planes(out_path, y, cb, cr, *args, store=seen[pkg], pkg=pkg):
            store[os.path.basename(out_path)] = ((y, cb, cr), args)
            if pkg == "port":
                real["port"][0](out_path, y, cb, cr, *args)

        def words(out_path, rgba, *args, store=seen[pkg]):
            store[os.path.basename(out_path)] = (
                (np.ascontiguousarray(rgba).view(np.uint8),), args)

        monkeypatch.setattr(mod, "_encode_one_jpeg420", planes)
        monkeypatch.setattr(mod, "_encode_one", words)
    port_jobs = [pex.ExportJob(p, str(tmp_path / "p" / (f"b{i}" + ext)),
                               EditParams(**e))
                 for i, (p, e) in enumerate(zip(paths, edits))]
    ref_jobs = [jex.ExportJob(p, str(tmp_path / "j" / (f"b{i}" + ext)),
                              JaxParams(**e))
                for i, (p, e) in enumerate(zip(paths, edits))]
    kw = dict(batch_size=2, mode="accurate", demosaic_method="grad",
              color_space=space)
    rep = pex.run_batch_export(port_jobs, device="cpu", use_kernel=True, **kw)
    ref = jex.run_batch_export(ref_jobs, **kw)
    assert rep.succeeded == ref.succeeded == 3, rep.failed
    assert seen["port"].keys() == seen["jax"].keys()
    worst = 0
    for k, (arrays, args) in seen["jax"].items():
        got_arrays, got_args = seen["port"][k]
        assert got_args == args and args[-1] == ticc.profile_bytes(space)
        worst = max([worst] + [_max_diff(g, w)[0]
                               for g, w in zip(got_arrays, arrays)])
    print(f"{route}: max {worst} LSB")
    assert worst <= 1
    if ext == ".jpg":
        from PIL import Image

        eng = DevelopEngine.open(paths[1], mode="accurate", device="cpu",
                                 demosaic_method="grad", color_space=space,
                                 use_kernel=True)
        eng.export(tmp_path / "e.jpg", port_jobs[1].params)
        data = open(port_jobs[1].out_path, "rb").read()
        assert data == (tmp_path / "e.jpg").read_bytes()
        assert Image.open(io.BytesIO(data)).info["icc_profile"] == \
            ticc.profile_bytes(space)
