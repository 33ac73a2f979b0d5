"""The accurate Bayer lane of the port against the JAX package, on the
CPU: the bilinear, Malvar-He-Cutler and gradient-weighted demosaics, the
develop chain that runs them, the fused kernels' plain versions against
the TPU kernel in Pallas interpret mode, the engine with
``demosaic_method``, and the per-CFA-site black levels.

Contracts (each test prints its measured difference):

- demosaics: bit-equal to the JAX XLA lane expected; limit 1e-6;
- ``develop_rgba`` and the engine's plain lane: <= 1 LSB of 8-bit output;
- the kernels' plain versions against the Pallas kernel: <= 1 LSB with
  at least 97% of values exact (the TPU kernel's own contract,
  tests/test_pallas_develop.py), in RGBA and YCbCr 4:2:0.

The kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import dataclasses
import io
import sys

import numpy as np
import pytest
import torch

from raweditor_tpu.ops import demosaic as jdm
from raweditor_tpu.ops import develop as jd
from raweditor_tpu.ops.cfa_generic import \
    demosaic_grad_generic as jax_grad_generic
from raweditor_tpu.ops.jpeg import rgba_words_to_ycbcr420
from raweditor_tpu.ops.pallas_develop import (pallas_batch_develop_rgba,
                                              pallas_develop_rgba)
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.parallel.batch import pack_params as jax_pack_params
from raweditor_tpu.pipeline.engine import DevelopEngine as JaxEngine
from raweditor_tpu.raw.types import RawImage as JaxRaw
from raweditor_tpu_torch import DevelopEngine, EditParams, RawImage
from raweditor_tpu_torch.ops import _build
from raweditor_tpu_torch.ops import cfa_generic as tcg
from raweditor_tpu_torch.ops import demosaic as tdm
from raweditor_tpu_torch.ops import develop as td
from raweditor_tpu_torch.ops import fused_develop as fd
from raweditor_tpu_torch.parallel.batch import pack_params

METHODS = ("bilinear", "malvar", "grad")
PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))
SHAPES = ((32, 48), (32, 128), (250, 32), (1, 1), (2, 3), (3, 5))
WB = np.array([2.07, 1.0, 1.32], np.float32)
REAL_MATRIX = np.array([[0.9, 0.2, -0.1], [-0.15, 1.1, 0.05],
                        [0.02, -0.3, 1.28]], np.float32)
FULL = dict(exposure=0.6, contrast=8.0, highlights=-0.4, shadows=0.3,
            whites=1.05, blacks=0.04, saturation=25.0, vibrance=0.5,
            temperature=0.2, tint=-0.1)
D3300 = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                  [-1485, 2204, 7318]], np.float32)
# (white, black, matrix_transpose): unit levels, and real 14-bit levels
# (tests/test_pallas_develop.py's offset-invariance case).
LEVELS = {"unit": (4096.0, 0.0, True), "real": (15871.0, 1008.0, False)}


def _lsb(got_words, want_words):
    d = np.abs(td.rgba_view(got_words).astype(int)
               - jd.rgba_view(np.asarray(want_words)).astype(int))[..., :3]
    return int(d.max()), float((d > 0).mean())


def _plane_diff(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    return int(d.max()), float((d > 0).mean())


def _normalized(rng, shape, white=15871.0, black=1008.0):
    raw = rng.integers(0, int(white), size=shape, dtype=np.uint16)
    return ((raw.astype(np.float32) - np.float32(black))
            / (np.float32(white) - np.float32(black)))


# -- the XLA-lane demosaics -----------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("method", METHODS)
def test_demosaic_matches_jax(method, shape, rng):
    m = _normalized(rng, shape)
    fns = {"bilinear": (tdm.demosaic_bilinear, jdm.demosaic_bilinear),
           "malvar": (tdm.demosaic_malvar, jdm.demosaic_malvar)}
    worst = 0.0
    for phase in PHASES:
        if method == "grad":
            got = tdm.demosaic(torch.from_numpy(m), "grad", phase)
            want = jdm.demosaic(m, "grad", phase)
        else:
            tf, jf = fns[method]
            got = tf(torch.from_numpy(m), phase)
            want = jf(m, phase)
        for g, w in zip(got, want):
            assert g.shape == shape and g.dtype == torch.float32
            worst = max(worst, float(np.max(np.abs(g.numpy()
                                                   - np.asarray(w)))))
    print(f"demosaic {method} {shape}: max abs diff {worst:.3e}")
    assert worst <= 1e-6


@pytest.mark.parametrize("pattern", ["RGGB", "GRBG", "GBRG", "BGGR"])
def test_grad_generic_matches_jax(pattern, rng):
    """The generic-CFA entry point itself, on each 2x2 pattern string."""
    m = _normalized(rng, (24, 40))
    got = tcg.demosaic_grad_generic(torch.from_numpy(m), pattern, 2, 2)
    want = jax_grad_generic(m, pattern, 2, 2)
    worst = max(float(np.max(np.abs(g.numpy() - np.asarray(w))))
                for g, w in zip(got, want))
    print(f"grad generic {pattern}: max abs diff {worst:.3e}")
    assert worst <= 1e-6
    assert tcg.channel_grid(pattern, 2, 2).tolist() == [
        [tcg._CHAN[c] for c in pattern[:2]], [tcg._CHAN[c] for c in pattern[2:]]]


def test_generic_helpers_match_jax():
    from raweditor_tpu.ops import cfa_generic as jcg

    for pattern in ("RGGB", "GBRG", jcg.XTRANS_PATTERN):
        side = int(len(pattern) ** 0.5)
        grid = tcg.channel_grid(pattern, side, side)
        np.testing.assert_array_equal(grid,
                                      jcg.channel_grid(pattern, side, side))
        for chan in range(3):
            assert (tcg._smooth_radius(pattern, side, side, chan)
                    == jcg._smooth_radius(pattern, side, side, chan))
            for axis in (0, 1):
                assert (tcg._dir_radius(pattern, side, side, chan, axis)
                        == jcg._dir_radius(pattern, side, side, chan, axis))
                np.testing.assert_array_equal(
                    tcg._periodic_den_1d(grid, chan, 1, axis),
                    jcg._periodic_den_1d(grid, chan, 1, axis))
            np.testing.assert_array_equal(
                tcg._periodic_den_2d(grid, chan, 2),
                jcg._periodic_den_2d(grid, chan, 2))
            mask = tcg._periodic_mask(grid, chan, 7, 9, ((2, 1), (0, 3)),
                                      "cpu")
            want = jcg._periodic_mask(grid, chan, 7, 9, ((2, 1), (0, 3)),
                                      np.float32)
            np.testing.assert_array_equal(mask.numpy(), np.asarray(want))


def test_grad_fallback_not_ported(rng):
    """A pattern too sparse for 1-D G windows takes the isotropic
    fallback (``demosaic_smooth_generic``), as the JAX function does.
    (The name dates from when the port raised here instead.)"""
    from raweditor_tpu.ops import cfa_generic as jcg

    m = _normalized(rng, (14, 18))
    assert tcg._dir_radius("RBGG", 2, 2, 1, 1) == 0
    got = tcg.demosaic_grad_generic(torch.from_numpy(m), "RBGG", 2, 2)
    want = jax_grad_generic(m, "RBGG", 2, 2)
    smooth = jcg.demosaic_smooth_generic(m, "RBGG", 2, 2)
    for g, w, sm in zip(got, want, smooth):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(np.asarray(w), np.asarray(sm))


# -- the develop chain ----------------------------------------------------

@pytest.mark.parametrize("levels", sorted(LEVELS))
@pytest.mark.parametrize("method", METHODS)
def test_develop_rgba_matches_jax(method, levels, rng):
    white, black, transpose = LEVELS[levels]
    mosaic = rng.integers(0, int(white), size=(32, 48), dtype=np.uint16)
    worst, shares = 0, []
    for phase in PHASES:
        kw = dict(white_level=white, black_level=black,
                  demosaic_method=method, matrix_transpose=transpose,
                  transfer="srgb", cfa_phase=phase)
        want = jd.develop_rgba(mosaic, JaxParams(**FULL), WB, REAL_MATRIX,
                               **kw)
        got = td.develop_rgba(torch.from_numpy(mosaic), EditParams(**FULL),
                              WB, REAL_MATRIX, **kw)
        mx, share = _lsb(got, want)
        worst = max(worst, mx)
        shares.append(share)
        rgb = td.develop(torch.from_numpy(mosaic), EditParams(**FULL), WB,
                         REAL_MATRIX, **kw)
        np.testing.assert_array_equal(rgb.numpy(), td.rgba_view(got)[..., :3])
    print(f"develop_rgba {method} {levels}: max {worst} LSB, differing "
          f"{max(shares):.2e}")
    assert worst <= 1


def test_malvar_black_floor_develop(rng):
    """The Malvar undershoot clamp sits at the black level (the XLA lane
    clamps the normalised value at 0; the kernels at sc[19])."""
    mosaic = rng.integers(200, 4096, size=(16, 32), dtype=np.uint16)
    mosaic[::2, ::2] = 200
    kw = dict(white_level=4000.0, black_level=200.0)
    want = jd.develop_rgba(mosaic, JaxParams(), WB, REAL_MATRIX,
                           demosaic_method="malvar", transfer="srgb", **kw)
    got = td.develop_rgba(torch.from_numpy(mosaic), EditParams(), WB,
                          REAL_MATRIX, demosaic_method="malvar",
                          transfer="srgb", **kw)
    mx, share = _lsb(got, want)
    scal = fd.fold_scalars(EditParams(), WB, REAL_MATRIX, 4000.0, 200.0)
    plain = fd.fused_develop_rgba(torch.from_numpy(mosaic), scal,
                                  gamma="srgb", demosaic="malvar")
    kernel = pallas_develop_rgba(mosaic, JaxParams(), WB, REAL_MATRIX,
                                 demosaic="malvar", gamma="srgb",
                                 interpret=True, **kw)
    mx2, share2 = _lsb(plain, kernel)
    mx3, _ = _lsb(plain, want)
    print(f"malvar floor: develop_rgba vs JAX max {mx} LSB ({share:.2e}); "
          f"plain kernel form vs Pallas max {mx2} ({share2:.2e}); "
          f"plain kernel form vs XLA lane max {mx3}")
    assert mx <= 1 and mx2 <= 1 and share2 <= 0.03 and mx3 <= 1


# -- the kernels' plain versions against the TPU kernel ---------------------

@pytest.mark.parametrize("gamma", ["srgb", "srgb_poly"])
@pytest.mark.parametrize("method", METHODS)
def test_plain_matches_pallas_single(method, gamma, rng):
    """Four phases on 32x48 with real levels; 32x128 and the 250-row
    frame (no multiple-of-8 divisor: the TPU kernel's height-pad rescue,
    whose clone rows once leaked into grad) at two phases."""
    cases = [((32, 48), "real", PHASES), ((32, 128), "unit", PHASES[::3]),
             ((250, 32), "unit", PHASES[::3])]
    worst, shares = 0, []
    for shape, levels, phases in cases:
        white, black, transpose = LEVELS[levels]
        mosaic = rng.integers(0, int(white), size=shape, dtype=np.uint16)
        scal = fd.fold_scalars(EditParams(**FULL), WB, REAL_MATRIX, white,
                               black, transpose)
        for phase in phases:
            want = pallas_develop_rgba(
                mosaic, JaxParams(**FULL), WB, REAL_MATRIX,
                white_level=white, black_level=black,
                matrix_transpose=transpose, demosaic=method, gamma=gamma,
                cfa_phase=phase, interpret=True)
            got = fd.fused_develop_rgba(torch.from_numpy(mosaic), scal,
                                        phase, gamma, demosaic=method)
            mx, share = _lsb(got, want)
            worst = max(worst, mx)
            shares.append(share)
    print(f"plain vs Pallas {method} {gamma}: max {worst} LSB, differing "
          f"at most {max(shares):.2e}")
    assert worst <= 1 and max(shares) <= 0.03


@pytest.mark.parametrize("method", METHODS)
def test_plain_ycbcr420_matches_pallas_batch(method, rng):
    n, h, w = 3, 32, 48
    mosaics = rng.integers(0, 4096, size=(n, h, w), dtype=np.uint16)
    plist = [FULL, {}, dict(exposure=-1.1, saturation=-50.0)]
    wbs = np.stack([WB, np.array([1.8, 1.0, 1.5], np.float32),
                    np.ones(3, np.float32)])
    cms = np.stack([REAL_MATRIX, np.eye(3, dtype=np.float32), REAL_MATRIX])
    whites = np.array([4096.0, 4000.0, 3900.0], np.float32)
    blacks = np.array([0.0, 128.0, 60.0], np.float32)
    scal = pack_params([EditParams(**d) for d in plist], wbs, cms, whites,
                       blacks)
    jp = jax_pack_params([JaxParams(**d) for d in plist])
    for gamma in ("srgb", "srgb_poly"):
        wy, wc = pallas_batch_develop_rgba(
            mosaics, jp, wbs, cms, whites, blacks, interpret=True,
            cfa_phase=(1, 0), gamma=gamma, demosaic=method,
            output="ycbcr420")
        gy, gc = fd.fused_batch_develop_rgba(
            torch.from_numpy(mosaics), scal, (1, 0), gamma,
            demosaic=method, output="ycbcr420")
        assert tuple(gy.shape) == (n, h, w) and tuple(gc.shape) == (n, h // 2, w)
        for name, g, t in (("Y", gy, wy), ("CbCr", gc, wc)):
            mx, share = _plane_diff(g.numpy(), t)
            print(f"ycbcr420 {method} {gamma} {name}: max {mx}, "
                  f"differing {share:.2e}")
            assert mx <= 1 and share <= 0.03


@pytest.mark.parametrize("method", METHODS)
def test_plain_kernel_form_vs_xla_lane(method, rng):
    """The two plain forms (kernel arithmetic on raw * scale, the XLA
    lane on the normalised mosaic) round apart by at most 1 LSB, also on
    the tiny and odd shapes the TPU kernel refuses."""
    worst = 0
    for shape in SHAPES:
        mosaic = rng.integers(0, 15871, size=shape, dtype=np.uint16)
        scal = fd.fold_scalars(EditParams(**FULL), WB, REAL_MATRIX, 15871.0,
                               1008.0, False)
        for phase in PHASES:
            got = fd.fused_develop_rgba(torch.from_numpy(mosaic), scal,
                                        phase, "srgb", demosaic=method)
            want = jd.develop_rgba(mosaic, JaxParams(**FULL), WB,
                                   REAL_MATRIX, white_level=15871.0,
                                   black_level=1008.0,
                                   demosaic_method=method,
                                   matrix_transpose=False, transfer="srgb",
                                   cfa_phase=phase)
            worst = max(worst, _lsb(got, want)[0])
    print(f"kernel form vs JAX XLA lane, {method}, shapes {SHAPES}: "
          f"max {worst} LSB")
    assert worst <= 1


def test_batch_equals_single(rng):
    mosaics = rng.integers(0, 4096, size=(3, 20, 34), dtype=np.uint16)
    scal = pack_params([EditParams(exposure=0.2 * i) for i in range(3)],
                       np.tile(WB, (3, 1)), np.tile(REAL_MATRIX, (3, 1, 1)))
    for method in METHODS:
        batch = fd.fused_batch_develop_rgba(torch.from_numpy(mosaics), scal,
                                            (0, 1), "srgb", demosaic=method)
        for i in range(3):
            single = fd.fused_develop_rgba(torch.from_numpy(mosaics[i]),
                                           scal[i], (0, 1), "srgb",
                                           demosaic=method)
            assert torch.equal(batch[i], single)


def test_grad_constant_mosaic_is_uniform():
    """A constant mosaic develops to one uniform colour: the clamp-to-edge
    invariant, which also pins the refinement's site classes."""
    mosaic = np.full((20, 30), 2000, np.uint16)
    scal = fd.fold_scalars(EditParams(), WB, REAL_MATRIX, 4000.0, 100.0)
    for phase in PHASES:
        plain = fd.fused_develop_rgba(torch.from_numpy(mosaic), scal, phase,
                                      "srgb", demosaic="grad")
        xla = td.develop_rgba(torch.from_numpy(mosaic), EditParams(), WB,
                              REAL_MATRIX, white_level=4000.0,
                              black_level=100.0, demosaic_method="grad",
                              transfer="srgb", cfa_phase=phase)
        for words in (plain, xla):
            assert torch.unique(words).numel() == 1
        assert torch.equal(plain, xla)


# -- the engine -----------------------------------------------------------

def _frame(rng, pattern="GBRG", h=48, w=64, black_per_site=None):
    return dict(mosaic=rng.integers(0, 4096, size=(h, w), dtype=np.uint16),
                wb_multipliers=np.array([2.1, 1.0, 1.4, 1.0], np.float32),
                xyz_to_cam=D3300, black_level=128.0,
                black_per_site=black_per_site, white_level=4000.0,
                cfa_pattern=pattern)


@pytest.mark.parametrize("fast_gamma", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_engine_full_rgba(method, fast_gamma, rng):
    fields = _frame(rng)
    ref = JaxEngine(JaxRaw(**fields), mode="accurate", transfer="srgb",
                    fast_gamma=fast_gamma, demosaic_method=method)
    want = ref.full_rgba_device(JaxParams(**FULL))
    for use_kernel in (False, True):
        port = DevelopEngine(RawImage(**fields), mode="accurate",
                             transfer="srgb", fast_gamma=fast_gamma,
                             use_kernel=use_kernel, demosaic_method=method,
                             device="cpu")
        got = port.full_rgba_device(EditParams(**FULL))
        mx, share = _lsb(got, want)
        print(f"engine {method} fast={fast_gamma} kernel={use_kernel}: "
              f"max {mx} LSB, differing {share:.2e}")
        assert mx <= 1
        if not use_kernel:
            np.testing.assert_array_equal(port.full(EditParams(**FULL)),
                                          td.rgba_view(got)[..., :3])


@pytest.mark.parametrize("method", METHODS)
def test_engine_jpeg_export(method, rng, tmp_path):
    from PIL import Image

    fields = _frame(rng, "RGGB")
    ref = JaxEngine(JaxRaw(**fields), mode="accurate", transfer="srgb",
                    demosaic_method=method)
    ref.export(tmp_path / "ref.jpg", JaxParams(**FULL), quality=90)
    want_img = np.asarray(Image.open(tmp_path / "ref.jpg").convert("RGB"))
    want_planes = rgba_words_to_ycbcr420(ref.full_rgba_device(
        JaxParams(**FULL)))
    for use_kernel in (False, True):
        port = DevelopEngine(RawImage(**fields), mode="accurate",
                             transfer="srgb", use_kernel=use_kernel,
                             demosaic_method=method, device="cpu")
        planes = port.jpeg_planes(EditParams(**FULL))
        worst = max(_plane_diff(g.numpy(), w)[0]
                    for g, w in zip(planes, want_planes))
        path = port.export(tmp_path / f"k{int(use_kernel)}.jpg",
                           EditParams(**FULL), quality=90)
        img = np.asarray(Image.open(io.BytesIO(open(path, "rb").read()))
                         .convert("RGB"))
        mx, share = _plane_diff(img, want_img)
        mean = float(np.abs(img.astype(int) - want_img.astype(int)).mean())
        print(f"export {method} kernel={use_kernel}: planes max {worst}; "
              f"decoded max {mx}, mean {mean:.2e}, differing {share:.2e}")
        assert img.shape == want_img.shape and worst <= 1
        if worst == 0:
            np.testing.assert_array_equal(img, want_img)
        assert mean < 0.05


def test_engine_demosaic_method_names(rng):
    raw = RawImage(**_frame(rng))
    for mode in ("parity", "accurate"):
        for m in tdm.DEMOSAIC_METHODS:
            assert DevelopEngine(raw, mode=mode, demosaic_method=m,
                                 device="cpu").demosaic_method == m
        for bad in ("smooth", "Malvar", "vng"):
            with pytest.raises(ValueError):
                DevelopEngine(raw, mode=mode, demosaic_method=bad,
                              device="cpu")


def test_parity_mode_with_accurate_demosaic(rng):
    """JAX ties no method to one mode: parity mode with Malvar renders
    Malvar over the parity levels."""
    fields = _frame(rng)
    ref = JaxEngine(JaxRaw(**fields), demosaic_method="malvar")
    port = DevelopEngine(RawImage(**fields), demosaic_method="malvar",
                         device="cpu")
    mx, share = _lsb(port.full_rgba_device(EditParams(**FULL)),
                     ref.full_rgba_device(JaxParams(**FULL)))
    print(f"parity + malvar: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1
    # The preview stays on the nearest-sampled stencil.
    np.testing.assert_array_equal(
        port.preview(EditParams(**FULL)),
        DevelopEngine(RawImage(**fields), device="cpu").preview(
            EditParams(**FULL)))


# -- per-CFA-site black levels ---------------------------------------------

SITE_BLACKS = np.array([[120.0, 131.0], [126.0, 135.0]], np.float32)


def test_from_fields_carries_a_jax_frame(rng):
    jraw = JaxRaw(**_frame(rng, black_per_site=SITE_BLACKS),
                  camera_make="Nikon", camera_model="D3300",
                  wb_is_default=True, orientation=6)
    raw = RawImage.from_fields(dataclasses.asdict(jraw))
    for f in dataclasses.fields(JaxRaw):
        a, b = getattr(raw, f.name), getattr(jraw, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        else:
            assert a == b, f.name
    got, want = raw.fold_site_blacks(), jraw.fold_site_blacks()
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, raw.mosaic)
    with pytest.raises(TypeError):
        RawImage.from_fields(dict(dataclasses.asdict(jraw), iso=100))
    # Nothing to fold: the mosaic itself.
    flat = RawImage.from_fields(dict(dataclasses.asdict(jraw),
                                     black_per_site=np.full((2, 2), 128.0)))
    assert flat.fold_site_blacks() is flat.mosaic


@pytest.mark.parametrize("method", ["nearest", "grad"])
def test_site_blacks_develop_like_jax(method, rng):
    """Accurate mode folds the per-site blacks before the upload, as the
    JAX engine does. Without the fold (the port before it carried
    ``black_per_site``) the result differs by several LSB."""
    jraw = JaxRaw(**_frame(rng, black_per_site=SITE_BLACKS))
    ref = JaxEngine(jraw, mode="accurate", transfer="srgb",
                    demosaic_method=method)
    want = ref.full_rgba_device(JaxParams(**FULL))
    fields = dataclasses.asdict(jraw)
    for use_kernel in (False, True):
        port = DevelopEngine(RawImage.from_fields(fields), mode="accurate",
                             transfer="srgb", use_kernel=use_kernel,
                             demosaic_method=method, device="cpu")
        mx, share = _lsb(port.full_rgba_device(EditParams(**FULL)), want)
        print(f"site blacks {method} kernel={use_kernel}: max {mx} LSB, "
              f"differing {share:.2e}")
        assert mx <= 1
    unfolded = DevelopEngine(
        RawImage.from_fields(dict(fields, black_per_site=None)),
        mode="accurate", transfer="srgb", demosaic_method=method,
        device="cpu")
    mx, share = _lsb(unfolded.full_rgba_device(EditParams(**FULL)), want)
    print(f"without the fold: max {mx} LSB, differing {share:.2e}")
    assert mx > 1
    # Parity mode ignores the per-site blacks, as the JAX engine does.
    parity = DevelopEngine(RawImage.from_fields(fields), device="cpu")
    np.testing.assert_array_equal(parity.mosaic.numpy(), jraw.mosaic)


# -- no fallback ------------------------------------------------------------

def test_every_source_is_built():
    names = [p.name for p in _build._sources()]
    assert names == ["develop.cu", "develop_grad.cu",
                     "develop_grad_generic.cu", "extras.cu", "linear.cu",
                     "resize.cu", "staging.cu"]
    header = _build.CSRC / "develop_common.cuh"
    assert header.exists()
    # Every develop and extras kernel shares the finish tail (the
    # LinearRaw kernel its quantiser and store helpers); the resize
    # kernel and the staging kernel (integer unpacking) stand alone.
    for src in names[:-2]:
        assert '#include "develop_common.cuh"' in (_build.CSRC / src).read_text()
    for src in ("resize.cu", "staging.cu"):
        assert '#include "' not in (_build.CSRC / src).read_text()
    # The generic-CFA kernels share their tables, the grad kernels their
    # stages, and every band kernel the warp march.
    for src, shared in (("develop.cu", "cfa_tables.cuh"),
                        ("develop_grad_generic.cu", "cfa_tables.cuh"),
                        ("develop_grad.cu", "grad_tile.cuh"),
                        ("develop_grad_generic.cu", "grad_tile.cuh"),
                        ("grad_tile.cuh", "band_march.cuh"),
                        ("develop.cu", "band_march.cuh"),
                        ("extras.cu", "band_march.cuh")):
        assert (_build.CSRC / shared).exists()
        assert f'#include "{shared}"' in (_build.CSRC / src).read_text()


def test_build_raises_when_a_source_fails(monkeypatch, tmp_path):
    """A failing nvcc (here a Python stand-in that rejects
    develop_grad.cu and writes the other object) makes the build raise:
    no library, no partial load."""
    fake = ("import sys; a = sys.argv; "
            "sys.exit('error: expected a ;') if 'develop_grad.cu' in ' '.join(a) "
            "else open(a[-1], 'wb').close()")
    monkeypatch.setattr(_build, "_nvcc", lambda: sys.executable)
    monkeypatch.setattr(_build, "NVCC_FLAGS", ("-c", fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError,
                       match=r"csrc/develop_grad\.cu -o \S+\nerror: expected"):
        _build.build()
    assert not (tmp_path / "build" / _build.LIB_NAME).exists()


def test_digest_covers_the_shared_header(monkeypatch, tmp_path):
    for name in ("develop.cu", "develop_grad.cu", "develop_common.cuh"):
        (tmp_path / name).write_text((_build.CSRC / name).read_text())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    srcs = _build._sources()
    before = _build._digest(srcs)
    (tmp_path / "develop_common.cuh").write_text("// changed\n")
    assert _build._digest(srcs) != before


@pytest.mark.parametrize("method", tdm.DEMOSAIC_METHODS)
def test_other_devices_never_run_plain(method, rng):
    """Only a CPU tensor runs the plain version: a tensor on any other
    non-CUDA device raises."""
    m = torch.from_numpy(rng.integers(0, 4096, (1, 8, 8), dtype=np.uint16))
    before = dict(fd.LAUNCHES)
    with pytest.raises(ValueError, match="unsupported device"):
        fd.fused_batch_develop_rgba(m.to("meta"), torch.zeros(
            1, fd.N_SCALARS, device="meta"), demosaic=method)
    assert fd.LAUNCHES == before
