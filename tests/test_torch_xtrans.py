"""The X-Trans (generic-CFA) path of the port against the JAX package, on
the CPU: the pattern tables, the three demosaic tiers of
``ops/cfa_generic.py``, ``develop_xtrans`` with its preview, histogram
and batch form, and ``DevelopEngine`` on a 36-letter ``cfa_pattern``.

Contracts (each test prints its measured difference):

- tables and demosaics: bit-equal to the JAX helpers and functions;
- ``develop_xtrans`` and the engine's entry points: <= 1 LSB of 8-bit
  output (the transfer's ``pow`` and the mixer's ``exp2`` round an ulp
  apart between XLA and PyTorch on the CPU);
- with ``use_kernel`` on the CPU the kernels' plain versions run, and a
  failing kernel wrapper makes the engine call raise.

The kernels' plain versions against the TPU kernels are
tests/test_torch_fused_xtrans.py; the kernels themselves run only on the
card: tests/test_torch_cuda.py.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from raweditor_tpu.ops import cfa_generic as jcg
from raweditor_tpu.ops import develop as jd
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.parallel.batch import \
    batch_develop_xtrans_rgba as jax_batch_xtrans
from raweditor_tpu.parallel.batch import pack_params as jax_pack_params
from raweditor_tpu.pipeline.engine import DevelopEngine as JaxEngine
from raweditor_tpu.raw.types import RawImage as JaxRaw
from raweditor_tpu_torch import DevelopEngine, EditParams, RawImage
from raweditor_tpu_torch.ops import _build
from raweditor_tpu_torch.ops import cfa_generic as tcg
from raweditor_tpu_torch.ops import demosaic as tdm
from raweditor_tpu_torch.ops import develop as td
from raweditor_tpu_torch.ops import fused_develop as fd
from raweditor_tpu_torch.parallel.batch import batch_develop_xtrans_rgba
from raweditor_tpu_torch.pipeline import engine as engine_mod

XTRANS = jcg.XTRANS_PATTERN
SPARSE = "RGGG" "GGGG" "GGGB" "GGGG"  # R/B smooth radius 2 on this 4x4
PATTERNS = {"xtrans": XTRANS, "rggb": "RGGB", "sparse4": SPARSE}
TIERS = ("nearest", "smooth", "grad")
SHAPES = ((24, 36), (40, 48), (25, 31), (7, 5), (1, 1))
WB = np.array([2.07, 1.0, 1.32], np.float32)
REAL_MATRIX = np.array([[0.9, 0.2, -0.1], [-0.15, 1.1, 0.05],
                        [0.02, -0.3, 1.28]], np.float32)
FULL = dict(exposure=0.6, contrast=8.0, highlights=-0.4, shadows=0.3,
            whites=1.05, blacks=0.04, saturation=25.0, vibrance=0.5,
            temperature=0.2, tint=-0.1)
EXTRAS = dict(sharpen=60.0, denoise=40.0, curve_shadows=30.0,
              curve_darks=-20.0, curve_lights=15.0, curve_highlights=-40.0,
              vignette=-30.0, hue_red=25.0, hue_blue=-40.0, sat_orange=30.0,
              lum_yellow=40.0, grade_shadow_hue=210.0, grade_shadow_sat=40.0,
              grade_high_hue=45.0, grade_high_sat=30.0)
CURVE = ((0.0, 0.02), (0.35, 0.3), (0.7, 0.8), (1.0, 0.97))
EDITS = {"sliders": FULL, "extras": dict(FULL, **EXTRAS),
         "curve": dict(FULL, sharpen=80.0, point_curve=CURVE)}
# X-Trans III (X-T2) ColorMatrix, x10000 (dcraw's adobe_coeff).
XT2 = np.array([[11434, -4948, -1210], [-3746, 12042, 1903],
                [-666, 1479, 5235]], np.float32)


def _diff(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return int(d.max()), float((d > 0).mean())


def _lsb(got_words, want_words):
    return _diff(td.rgba_view(got_words)[..., :3],
                 jd.rgba_view(np.asarray(want_words))[..., :3])


def _normalized(rng, shape, white=15871.0, black=1008.0):
    raw = rng.integers(0, int(white), size=shape, dtype=np.uint16)
    return ((raw.astype(np.float32) - np.float32(black))
            / (np.float32(white) - np.float32(black)))


# -- the pattern tables ------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_pattern_tables_match_jax(name):
    """channel_grid, nearest_offsets, the radii and the tent denominators
    equal the JAX helpers'; the kernels' tables (``fd.cfa_tables``) equal
    the arrays the TPU kernel tiles at offsets (0, -1), (-1, 0), (-1, -1)."""
    pattern = PATTERNS[name]
    side = td._square_period(pattern)
    grid = tcg.channel_grid(pattern, side, side)
    np.testing.assert_array_equal(grid, jcg.channel_grid(pattern, side, side))
    assert grid.dtype == np.int32
    assert (tcg.nearest_offsets(pattern, side, side)
            == jcg.nearest_offsets(pattern, side, side))
    for chan in range(3):
        assert (tcg._smooth_radius(pattern, side, side, chan)
                == jcg._smooth_radius(pattern, side, side, chan))
        for radius in (1, 2):
            np.testing.assert_array_equal(
                tcg._periodic_den_2d(grid, chan, radius),
                jcg._periodic_den_2d(grid, chan, radius))
            for axis in (0, 1):
                assert (tcg._dir_radius(pattern, side, side, chan, axis)
                        == jcg._dir_radius(pattern, side, side, chan, axis))
                np.testing.assert_array_equal(
                    tcg._periodic_den_1d(grid, chan, radius, axis),
                    jcg._periodic_den_1d(grid, chan, radius, axis))
    tables = fd.cfa_tables(pattern)
    assert tables.side == side
    np.testing.assert_array_equal(tables.grid, grid)

    def jax_tile(core, off_y, off_x):
        return np.asarray(jcg._tile_periodic(core, side, side, off_y, off_x,
                                             np.float32))

    g = jcg._CHAN["G"]
    np.testing.assert_array_equal(
        tables.den_h, jax_tile(jcg._periodic_den_1d(grid, g, 1, 1), 0, -1))
    np.testing.assert_array_equal(
        tables.den_v, jax_tile(jcg._periodic_den_1d(grid, g, 1, 0), -1, 0))
    for chan in range(3):
        np.testing.assert_array_equal(
            tables.den2[chan],
            jax_tile(jcg._periodic_den_2d(grid, chan, 1), -1, -1))
    offsets = jcg.nearest_offsets(pattern, side, side)
    if all(o in fd.NEAREST_TAP_CODES for o in offsets.values()):
        for (py, px, chan), off in offsets.items():
            assert tables.taps[chan, py, px] == fd.NEAREST_TAP_CODES[off]
    else:
        assert tables.taps is None and tables.bad_offset is not None
    print(f"{name}: side {side}, nearest offsets "
          f"{sorted(set(offsets.values()))}")


def test_xtrans_nearest_offsets_are_the_five_taps():
    offsets = set(tcg.nearest_offsets(XTRANS, 6, 6).values())
    assert offsets == set(fd.NEAREST_TAP_CODES)


def test_channel_grid_validates():
    np.testing.assert_array_equal(tcg.channel_grid(),
                                  jcg.channel_grid())
    np.testing.assert_array_equal(tcg.channel_grid(XTRANS.lower(), 6, 6),
                                  tcg.channel_grid(XTRANS, 6, 6))
    with pytest.raises(ValueError, match="length"):
        tcg.channel_grid("RGGB", 3, 2)
    with pytest.raises(ValueError, match="letters"):
        tcg.channel_grid("RGGX", 2, 2)
    with pytest.raises(ValueError):
        tcg.nearest_offsets("RGGG", 2, 2)  # no B site
    with pytest.raises(ValueError, match="not square"):
        td._square_period("RGBRGB")
    assert td._square_period(XTRANS) == 6 == jd._square_period(XTRANS)


def test_generic_method_names():
    assert tcg.XTRANS_PATTERN == XTRANS
    for m in ("nearest", "smooth", "grad", "bilinear", "malvar", "vng"):
        assert tcg.generic_cfa_method(m) == jcg.generic_cfa_method(m)
    assert tcg.is_xtrans(XTRANS) and not tcg.is_xtrans("RGGB")
    assert tcg.is_xtrans(XTRANS) == jcg.is_xtrans(XTRANS)


# -- the demosaic tiers --------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("tier", TIERS)
def test_generic_demosaic_matches_jax(tier, shape, rng):
    m = _normalized(rng, shape)
    name = f"demosaic_{tier}_generic"
    got = getattr(tcg, name)(torch.from_numpy(m), XTRANS, 6, 6)
    want = getattr(jcg, name)(m, XTRANS, 6, 6)
    worst = 0.0
    for g, w in zip(got, want):
        assert g.shape == shape and g.dtype == torch.float32
        worst = max(worst, float(np.max(np.abs(g.numpy() - np.asarray(w)))))
    print(f"{name} {shape}: max abs diff {worst:.3e}")
    assert worst == 0.0


@pytest.mark.parametrize("tier", TIERS)
def test_generic_demosaic_other_patterns(tier, rng):
    """The sparse 4x4 grid (radius-2 tents for R and B, nearest offsets
    beyond +-1) and a Bayer grid through the same functions."""
    m = _normalized(rng, (21, 26))
    name = f"demosaic_{tier}_generic"
    for pattern in (SPARSE, "GRBG"):
        side = td._square_period(pattern)
        got = getattr(tcg, name)(torch.from_numpy(m), pattern, side, side)
        want = getattr(jcg, name)(m, pattern, side, side)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_xtrans_nearest_entry(rng):
    m = _normalized(rng, (13, 20))
    for g, w in zip(tcg.demosaic_xtrans(torch.from_numpy(m)),
                    jcg.demosaic_xtrans(m)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nearest_sampled_matches_jax(rng):
    """Sampled sites in and out of the frame, repeated and unsorted."""
    m = _normalized(rng, (31, 44))
    yi = np.array([-3, 0, 0, 5, 17, 30, 30, 36, 12], np.int32)
    xi = np.array([43, -1, 0, 7, 7, 22, 50, 13], np.int32)
    for pattern in (XTRANS, SPARSE):
        side = td._square_period(pattern)
        got = tcg.demosaic_nearest_generic_sampled(
            torch.from_numpy(m), torch.from_numpy(yi).long(),
            torch.from_numpy(xi).long(), pattern, side, side)
        want = jcg.demosaic_nearest_generic_sampled(m, yi, xi, pattern, side,
                                                    side)
        for g, w in zip(got, want):
            assert tuple(g.shape) == (len(yi), len(xi))
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # In the frame it is the full-resolution stencil, sampled.
    full = tcg.demosaic_nearest_generic(torch.from_numpy(m), XTRANS, 6, 6)
    ys, xs = torch.tensor([2, 9, 30]), torch.tensor([0, 11, 43])
    part = tcg.demosaic_nearest_generic_sampled(torch.from_numpy(m), ys, xs,
                                                XTRANS, 6, 6)
    for f, p in zip(full, part):
        assert torch.equal(f[ys][:, xs], p)


def test_smooth_on_bayer_is_bilinear(rng):
    """On an RGGB grid the radius-1 normalised convolution is the
    bilinear demosaic (the JAX package pins the same)."""
    m = torch.from_numpy(_normalized(rng, (24, 32)))
    worst = 0.0
    for pattern, phase in tdm.CFA_PHASES.items():
        got = tcg.demosaic_smooth_generic(m, pattern, 2, 2)
        want = tdm.demosaic_bilinear(m, phase)
        worst = max(worst, max(float((g - w).abs().max())
                               for g, w in zip(got, want)))
    print(f"smooth on Bayer vs bilinear: max abs diff {worst:.3e}")
    assert worst <= 1e-6


@pytest.mark.parametrize("tier", TIERS)
def test_constant_mosaic_is_uniform(tier):
    m = torch.full((20, 27), 0.37)
    for plane in getattr(tcg, f"demosaic_{tier}_generic")(m, XTRANS, 6, 6):
        assert torch.equal(plane, m)


# -- develop_xtrans --------------------------------------------------------------

@pytest.mark.parametrize("edit", sorted(EDITS))
@pytest.mark.parametrize("tier", TIERS)
def test_develop_xtrans_matches_jax(tier, edit, rng):
    """The words and the planes-of-3 forms, with extras in the chain and
    with a point curve, on an even and an odd frame."""
    p, jp = EditParams(**EDITS[edit]), JaxParams(**EDITS[edit])
    mode = p.finish_extras_mode()
    assert mode == jp.finish_extras_mode()
    worst, shares = 0, []
    for shape in ((36, 48), (25, 31)):
        mosaic = rng.integers(0, 4000, size=shape, dtype=np.uint16)
        kw = dict(white_level=4000.0, black_level=128.0, pattern=XTRANS,
                  transfer="srgb", demosaic_method=tier, extras=mode)
        want = jd.develop_xtrans(mosaic, jp, WB, REAL_MATRIX, rgba=True, **kw)
        got = td.develop_xtrans(torch.from_numpy(mosaic), p, WB, REAL_MATRIX,
                                rgba=True, **kw)
        assert got.dtype == torch.uint32 and tuple(got.shape) == shape
        mx, share = _lsb(got, want)
        worst = max(worst, mx)
        shares.append(share)
        rgb = td.develop_xtrans(torch.from_numpy(mosaic), p, WB, REAL_MATRIX,
                                **kw)
        assert rgb.dtype == torch.uint8 and tuple(rgb.shape) == shape + (3,)
        np.testing.assert_array_equal(rgb.numpy(),
                                      td.rgba_view(got)[..., :3])
        mx3, _ = _diff(rgb.numpy(), jd.develop_xtrans(mosaic, jp, WB,
                                                     REAL_MATRIX, **kw))
        worst = max(worst, mx3)
    print(f"develop_xtrans {tier} {edit}: max {worst} LSB, differing at "
          f"most {max(shares):.2e}")
    assert worst <= 1


def test_develop_xtrans_defaults_and_errors(rng):
    """Parity-style defaults (4096, 0, the X-Trans grid, gamma 2.2) and
    the argument checks."""
    mosaic = rng.integers(0, 4096, size=(24, 36), dtype=np.uint16)
    t = torch.from_numpy(mosaic)
    mx, share = _diff(td.develop_xtrans(t, EditParams(**FULL), WB,
                                        np.eye(3, dtype=np.float32)).numpy(),
                      jd.develop_xtrans(mosaic, JaxParams(**FULL), WB,
                                        np.eye(3, dtype=np.float32)))
    print(f"develop_xtrans defaults: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1
    args = (t, EditParams(), WB, REAL_MATRIX)
    with pytest.raises(NotImplementedError, match="16-bit"):
        td.develop_xtrans(*args, bits=16)
    with pytest.raises(ValueError, match="mutually exclusive"):
        td.develop_xtrans(*args, rgba=True, bits=16)
    with pytest.raises(ValueError, match="unknown generic-CFA"):
        td.develop_xtrans(*args, demosaic_method="malvar")
    with pytest.raises(ValueError, match="not square"):
        td.develop_xtrans(*args, pattern="RGBRGB")
    with pytest.raises(NotImplementedError, match="clarity"):
        td.develop_xtrans(t, EditParams(clarity=10.0), WB, REAL_MATRIX)


@pytest.mark.parametrize("edit", sorted(EDITS))
def test_develop_xtrans_preview_and_histogram(edit, rng):
    mosaic = rng.integers(0, 4000, size=(60, 90), dtype=np.uint16)
    p, jp = EditParams(**EDITS[edit]), JaxParams(**EDITS[edit])
    kw = dict(white_level=4000.0, black_level=128.0, pattern=XTRANS,
              transfer="srgb", extras=p.finish_extras_mode())
    for zoom, pan_x, pan_y in ((1.0, 0.0, 0.0), (1.7, 0.1, -0.05),
                               (0.6, -0.2, 0.3)):
        view = dict(kw, zoom=zoom, pan_x=pan_x, pan_y=pan_y)
        want = np.asarray(jd.develop_xtrans_preview(
            mosaic, jp, WB, REAL_MATRIX, out_w=40, out_h=26, **view))
        got = td.develop_xtrans_preview(torch.from_numpy(mosaic), p, WB,
                                        REAL_MATRIX, 40, 26, **view).numpy()
        mx, share = _diff(got, want)
        print(f"develop_xtrans_preview {edit} zoom {zoom}: max {mx} LSB, "
              f"differing {share:.2e}")
        assert got.shape == (26, 40, 3) and mx <= 1
        th = td.develop_xtrans_histogram(torch.from_numpy(mosaic), p, WB,
                                         REAL_MATRIX, 40, 26, **view).numpy()
        np.testing.assert_array_equal(
            th, td.histogram_256(torch.from_numpy(got)).numpy())
        wh = np.asarray(jd.develop_xtrans_histogram(
            mosaic, jp, WB, REAL_MATRIX, out_w=40, out_h=26, **view))
        assert th.shape == (3, 256) and th.sum() == wh.sum()
        if mx == 0:
            np.testing.assert_array_equal(th, wh)


@pytest.mark.parametrize("tier", TIERS)
def test_batch_develop_xtrans_rgba(tier, rng):
    n, h, w = 3, 24, 36
    mosaics = rng.integers(0, 3800, size=(n, h, w), dtype=np.uint16)
    plist = [FULL, {}, dict(exposure=-1.1, saturation=-50.0, sharpen=0.0)]
    wbs = np.stack([WB, np.array([1.8, 1.0, 1.5], np.float32),
                    np.ones(3, np.float32)])
    cms = np.stack([REAL_MATRIX, np.eye(3, dtype=np.float32), REAL_MATRIX])
    whites = np.array([4096.0, 4000.0, 3900.0], np.float32)
    blacks = np.array([0.0, 128.0, 60.0], np.float32)
    kw = dict(pattern=XTRANS, transfer="srgb", demosaic_method=tier)
    jp = jax_pack_params([JaxParams(**d) for d in plist])
    want = jax_batch_xtrans(mosaics, jp, wbs, cms, whites, blacks, **kw)
    got = batch_develop_xtrans_rgba(torch.from_numpy(mosaics),
                                    [EditParams(**d) for d in plist], wbs,
                                    cms, whites, blacks, **kw)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (n, h, w)
    mx, share = _lsb(got, want)
    print(f"batch xtrans {tier} words: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1
    want = jax_batch_xtrans(mosaics, jp, wbs, cms, whites, blacks,
                            output="ycbcr420", **kw)
    got = batch_develop_xtrans_rgba(torch.from_numpy(mosaics),
                                    [EditParams(**d) for d in plist], wbs,
                                    cms, whites, blacks, output="ycbcr420",
                                    **kw)
    for name, g, t in zip("Y Cb Cr".split(), got, want):
        mxp, sharep = _diff(g.numpy(), t)
        print(f"batch xtrans {tier} {name}: max {mxp}, differing "
              f"{sharep:.2e}")
        assert g.shape == np.asarray(t).shape and mxp <= 1
    with pytest.raises(ValueError, match="unknown output"):
        batch_develop_xtrans_rgba(torch.from_numpy(mosaics),
                                  [EditParams()] * n, wbs, cms,
                                  output="nv21")


# -- the engine ----------------------------------------------------------------

def _frame(rng, h=60, w=96, pattern=XTRANS, **kw):
    return dict(mosaic=rng.integers(0, 4000, size=(h, w), dtype=np.uint16),
                wb_multipliers=np.array([1.9, 1.0, 1.6, 1.0], np.float32),
                xyz_to_cam=XT2, black_level=128.0, white_level=4000.0,
                cfa_pattern=pattern, **kw)


def _engines(rng, method, use_kernel=False, **frame_kw):
    fields = _frame(rng, **frame_kw)
    kw = dict(mode="accurate", transfer="srgb", demosaic_method=method,
              max_preview_width=64, histogram_width=32)
    port = DevelopEngine(RawImage(**fields), device="cpu",
                         use_kernel=use_kernel, **kw)
    ref = JaxEngine(JaxRaw(**fields), **kw)
    return port, ref


@pytest.mark.parametrize("edit", ["sliders", "extras"])
@pytest.mark.parametrize("method", ["nearest", "malvar", "grad"])
def test_engine_entry_points_against_jax(method, edit, rng, tmp_path):
    """Preview, histogram, full, full_rgba_device, jpeg_planes, JPEG and
    PNG export of an accurate-mode X-Trans frame, on the plain lane and
    with ``use_kernel`` (on the CPU: the kernels' plain versions)."""
    from PIL import Image

    from raweditor_tpu.ops.jpeg import rgba_words_to_ycbcr420

    p, jp = EditParams(**EDITS[edit]), JaxParams(**EDITS[edit])
    port, ref = _engines(rng, method)
    assert port.xtrans_pattern == ref.xtrans_pattern == XTRANS
    assert port.cfa_phase == ref.cfa_phase == (0, 0)
    assert (port.preview_w, port.preview_h) == (ref.preview_w, ref.preview_h)
    for zoom, pan in ((1.0, (0.0, 0.0)), (2.0, (0.12, -0.08))):
        mx, share = _diff(port.preview_tick(p, zoom, pan).numpy(),
                          ref.preview(jp, zoom, pan))
        print(f"{method} {edit} tick zoom {zoom}: max {mx} LSB, differing "
              f"{share:.2e}")
        assert mx <= 1
        gh, wh = port.histogram(p, zoom, pan), ref.histogram(jp, zoom, pan)
        assert gh.sum() == wh.sum()
        if mx == 0:
            np.testing.assert_array_equal(gh, wh)
    want_words = ref.full_rgba_device(jp)
    want_rgb = np.asarray(ref.full(jp))
    want_planes = rgba_words_to_ycbcr420(want_words)
    ref.export(tmp_path / "ref.jpg", jp, quality=90)
    want_img = np.asarray(Image.open(tmp_path / "ref.jpg").convert("RGB"))
    ref.export(tmp_path / "ref.png", jp)
    want_png = np.asarray(Image.open(tmp_path / "ref.png"))
    for use_kernel in (False, True):
        port.use_kernel = use_kernel
        words = port.full_rgba_device(p)
        mx, share = _lsb(words, want_words)
        mx_full, _ = _diff(port.full(p), want_rgb)
        planes = port.jpeg_planes(p)
        mxp = max(_diff(g.numpy(), w)[0] for g, w in zip(planes, want_planes))
        path = port.export(tmp_path / f"k{int(use_kernel)}.jpg", p,
                           quality=90)
        img = np.asarray(Image.open(io.BytesIO(open(path, "rb").read()))
                         .convert("RGB"))
        mean = float(np.abs(img.astype(int) - want_img.astype(int)).mean())
        port.export(tmp_path / "out.png", p)
        png = np.asarray(Image.open(tmp_path / "out.png"))
        print(f"engine {method} {edit} kernel={use_kernel}: words max {mx} "
              f"LSB ({share:.2e}), full max {mx_full}, planes max {mxp}, "
              f"decoded JPEG mean diff {mean:.2e}")
        assert mx <= 1 and mx_full <= 1 and mxp <= 1
        assert img.shape == want_img.shape and mean < 0.05
        # The PNG keeps the alpha channel, as the JAX engine's does.
        np.testing.assert_array_equal(png, td.rgba_view(words))
        assert png.shape == want_png.shape
        assert _diff(png, want_png)[0] == mx


@pytest.mark.parametrize("method", ["nearest", "bilinear", "smooth", "grad"])
def test_engine_use_kernel_runs_plain_versions_on_cpu(method, rng,
                                                      monkeypatch):
    """On the CPU ``use_kernel`` runs the tier's plain version through the
    wrapper: no build, no launch count, the wrapper's own result."""
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "load", no_build)
    fields = _frame(rng)
    port = DevelopEngine(RawImage(**fields), mode="accurate",
                         transfer="srgb", demosaic_method=method,
                         use_kernel=True, device="cpu")
    p = EditParams(**FULL)
    before = dict(fd.LAUNCHES)
    words = port.full_rgba_device(p)
    planes = port.jpeg_planes(p)
    assert fd.LAUNCHES == before
    tier = tcg.generic_cfa_method(method)
    want = fd.develop_rgba_folded_plain(
        port.mosaic[None], port.scalars(p)[None], gamma="srgb",
        demosaic=tier, pattern=XTRANS)[0]
    assert torch.equal(words, want)
    y, cbcr = fd.develop_rgba_folded_plain(
        port.mosaic[None], port.scalars(p)[None], gamma="srgb",
        output="ycbcr420", demosaic=tier, pattern=XTRANS)
    for g, w in zip(planes, (y[0], cbcr[0, :, 0::2], cbcr[0, :, 1::2])):
        assert torch.equal(g, w)
    # A point curve takes the plain lane.
    curve = p.replace(point_curve=CURVE)
    assert torch.equal(port.full_rgba_device(curve), td.develop_xtrans(
        port.mosaic, curve, port.wb, port.cam_matrix, port.white_level,
        port.black_level, pattern=XTRANS, transfer="srgb", rgba=True,
        demosaic_method=tier))


@pytest.mark.parametrize("method", ["nearest", "malvar", "grad"])
def test_engine_never_demotes_a_failing_kernel(method, rng, monkeypatch):
    """A wrapper that raises makes every kernel-route entry point raise:
    nothing moves quietly to the plain lane."""
    port = DevelopEngine(RawImage(**_frame(rng)), mode="accurate",
                         transfer="srgb", demosaic_method=method,
                         use_kernel=True, device="cpu")
    calls = []

    def failing(*a, **kw):
        calls.append(kw.get("demosaic"))
        raise RuntimeError("generic-CFA develop kernel: CUDA error 700")

    monkeypatch.setattr(engine_mod._fused, "fused_batch_develop_rgba",
                        failing)
    p = EditParams(**FULL)
    x = EditParams(**EDITS["extras"])
    for call in (lambda: port.full_rgba_device(p),
                 lambda: port.full_rgba_device(x),
                 lambda: port.full(x), lambda: port.jpeg_planes(p),
                 lambda: port.jpeg_planes(x)):
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            call()
    assert calls == [tcg.generic_cfa_method(method)] * 5
    assert not hasattr(port, "_pallas_grad_failed")
    # and again: no memo turned the route off
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        port.full_rgba_device(p)


def test_engine_smooth_and_parity(rng):
    """``smooth`` is what bilinear and malvar map to on X-Trans and a
    ``ValueError`` on Bayer; parity mode ignores the pattern, as the JAX
    engine does."""
    fields = _frame(rng)
    p, jp = EditParams(**FULL), JaxParams(**FULL)
    kw = dict(mode="accurate", transfer="srgb", device="cpu")
    smooth = DevelopEngine(RawImage(**fields), demosaic_method="smooth", **kw)
    for other in ("bilinear", "malvar"):
        e = DevelopEngine(RawImage(**fields), demosaic_method=other, **kw)
        assert torch.equal(e.full_rgba_device(p), smooth.full_rgba_device(p))
    for mode in ("parity", "accurate"):
        with pytest.raises(ValueError, match="smooth"):
            DevelopEngine(RawImage(**_frame(rng, pattern="RGGB")), mode=mode,
                          demosaic_method="smooth", device="cpu")
    with pytest.raises(ValueError, match="smooth"):
        DevelopEngine(RawImage(**fields), demosaic_method="smooth",
                      device="cpu")  # parity mode: the Bayer stencils
    port = DevelopEngine(RawImage(**fields), device="cpu")
    ref = JaxEngine(JaxRaw(**fields))
    assert port.xtrans_pattern is None and ref.xtrans_pattern is None
    mx, share = _lsb(port.full_rgba_device(p), ref.full_rgba_device(jp))
    print(f"parity mode on an X-Trans frame: max {mx} LSB, differing "
          f"{share:.2e}")
    assert mx <= 1


def test_from_fields_carries_a_jax_xtrans_frame(rng):
    """A JAX X-Trans ``RawImage`` and its edit reach the port unchanged."""
    jraw = JaxRaw(**_frame(rng, camera_make="FUJIFILM",
                           camera_model="X-T2", orientation=8))
    raw = RawImage.from_fields(dataclasses.asdict(jraw))
    assert raw.cfa_pattern == XTRANS and tcg.is_xtrans(raw.cfa_pattern)
    for f in dataclasses.fields(JaxRaw):
        a, b = getattr(raw, f.name), getattr(jraw, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    jp = JaxParams(**EDITS["extras"])
    p = EditParams(**dataclasses.asdict(jp))
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    port = DevelopEngine(raw, mode="accurate", transfer="srgb",
                         demosaic_method="grad", device="cpu")
    ref = JaxEngine(jraw, mode="accurate", transfer="srgb",
                    demosaic_method="grad")
    np.testing.assert_array_equal(port.mosaic.numpy(), np.asarray(ref.mosaic))
    np.testing.assert_array_equal(port.cam_matrix, np.asarray(ref.cam_matrix))
    assert (port.white_level, port.black_level) == (ref.white_level,
                                                    ref.black_level)
