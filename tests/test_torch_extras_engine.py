"""The extras path end to end on the CPU: the port's develop functions,
``DevelopEngine`` and batch routes with finish extras and point curves,
against the JAX package's on the same frames.

Contract: <= 1 LSB of 8-bit output (the mixer's luminance ``exp2`` and
the transfer's ``pow`` round apart by an ulp between XLA and PyTorch on
the CPU); exports decode within 1. Each test prints its measured
difference.
"""

import io

import numpy as np
import pytest
import torch

from raweditor_tpu.ops import develop as jd
from raweditor_tpu.ops.pallas_develop import (pallas_batch_develop_rgba,
                                              pallas_develop_rgba,
                                              pallas_finish_extras_rgba)
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.parallel.batch import batch_develop_rgba as jax_batch
from raweditor_tpu.parallel.batch import pack_params as jax_pack_params
from raweditor_tpu.pipeline.engine import DevelopEngine as JaxEngine
from raweditor_tpu.raw.types import RawImage as JaxRaw
from raweditor_tpu_torch import DevelopEngine, EditParams, RawImage
from raweditor_tpu_torch.ops import develop as td
from raweditor_tpu_torch.ops import fused_develop as fd
from raweditor_tpu_torch.ops import fused_extras as fx
from raweditor_tpu_torch.parallel.batch import (batch_develop_rgba,
                                                pack_extras, pack_params)

SLIDERS = dict(exposure=0.5, contrast=6.0, highlights=-0.3, shadows=0.2,
               whites=1.05, blacks=0.03, saturation=30.0, vibrance=0.4,
               temperature=0.15, tint=-0.1)
EXTRAS = dict(sharpen=60.0, denoise=40.0, curve_shadows=30.0,
              curve_darks=-20.0, curve_lights=15.0, curve_highlights=-40.0,
              vignette=-30.0, hue_red=25.0, hue_blue=-40.0, sat_orange=30.0,
              sat_green=-50.0, lum_yellow=40.0, lum_purple=-35.0,
              grade_shadow_hue=210.0, grade_shadow_sat=40.0,
              grade_high_hue=45.0, grade_high_sat=30.0, grade_balance=-20.0)
CURVE = ((0.0, 0.02), (0.35, 0.3), (0.7, 0.8), (1.0, 0.97))
D3300 = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                  [-1485, 2204, 7318]], np.float32)
WB = np.array([2.07, 1.0, 1.32], np.float32)
REAL = np.array([[1.6, -0.3, -0.3], [-0.2, 1.5, -0.3], [0.0, -0.4, 1.4]],
                np.float32)
# (name, edit): all extras; mixer only (no stencils); stencils with a
# point curve.
EDITS = [("all", dict(SLIDERS, **EXTRAS)),
         ("mixer", dict(SLIDERS, hue_green=30.0, sat_aqua=-60.0,
                        lum_red=50.0)),
         ("curve", dict(SLIDERS, sharpen=80.0, vignette=40.0,
                        point_curve=CURVE))]


def _params(d):
    return EditParams(**d), JaxParams(**d)


def _engines(rng, mode="parity", transfer="gamma22", **kw):
    fields = dict(
        mosaic=rng.integers(0, 4096, size=(64, 96), dtype=np.uint16),
        wb_multipliers=np.array([2.1, 1.0, 1.4, 1.0], np.float32),
        xyz_to_cam=D3300, black_level=128.0, white_level=4000.0,
        cfa_pattern="GRBG")
    port = DevelopEngine(RawImage(**fields), mode=mode, transfer=transfer,
                         device="cpu", max_preview_width=80,
                         histogram_width=40, **kw)
    ref = JaxEngine(JaxRaw(**fields), mode=mode, transfer=transfer,
                    max_preview_width=80, histogram_width=40)
    return port, ref


def _max_diff(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("name,edit", EDITS, ids=[e[0] for e in EDITS])
def test_develop_functions_with_extras(name, edit, rng):
    """develop_rgba, develop_preview and develop_histogram with the
    extras in the chain (the JAX ``extras`` mode) and point curves."""
    mosaic = rng.integers(0, 4096, size=(48, 72), dtype=np.uint16)
    p, jp = _params(edit)
    mode = p.finish_extras_mode()
    assert mode == jp.finish_extras_mode()
    kw = dict(white_level=4000.0, black_level=128.0, matrix_transpose=False,
              cfa_phase=(1, 0), transfer="srgb", extras=mode)
    want = jd.develop_rgba(mosaic, jp, WB, REAL, **kw)
    got = td.develop_rgba(torch.from_numpy(mosaic), p, WB, REAL, **kw)
    mx, share = _max_diff(td.rgba_view(got), jd.rgba_view(want))
    print(f"develop_rgba {name}: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1
    view = dict(kw, zoom=1.7, pan_x=0.1, pan_y=-0.05)
    want = np.asarray(jd.develop_preview(mosaic, jp, WB, REAL, out_w=40,
                                         out_h=26, **view))
    got = td.develop_preview(torch.from_numpy(mosaic), p, WB, REAL, 40, 26,
                             **view).numpy()
    mx, share = _max_diff(got, want)
    print(f"develop_preview {name}: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1
    th = td.develop_histogram(torch.from_numpy(mosaic), p, WB, REAL, 40, 26,
                              **view).numpy()
    np.testing.assert_array_equal(
        th, td.histogram_256(torch.from_numpy(got)).numpy())
    if mx == 0:
        np.testing.assert_array_equal(th, np.asarray(jd.develop_histogram(
            mosaic, jp, WB, REAL, out_w=40, out_h=26, **view)))


@pytest.mark.parametrize("name,edit", EDITS, ids=[e[0] for e in EDITS])
def test_engine_extras_against_jax(name, edit, rng):
    """The slider tick, histogram and full develop (plain lane, then the
    plain post-pass) against the JAX engine."""
    port, ref = _engines(rng, "accurate", "srgb")
    p, jp = _params(edit)
    for zoom, pan in ((1.0, (0.0, 0.0)), (2.0, (0.1, -0.08))):
        mx, share = _max_diff(port.preview_tick(p, zoom, pan).numpy(),
                              ref.preview(jp, zoom, pan))
        print(f"{name} tick zoom {zoom}: max {mx} LSB, differing {share:.2e}")
        assert mx <= 1
        gh, wh = port.histogram(p, zoom, pan), ref.histogram(jp, zoom, pan)
        assert gh.sum() == wh.sum()
        if mx == 0:
            np.testing.assert_array_equal(gh, wh)
    mx, share = _max_diff(td.rgba_view(port.full_rgba_device(p)),
                          jd.rgba_view(ref.full_rgba_device(jp)))
    print(f"{name} full_rgba_device: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1
    np.testing.assert_array_equal(
        port.full(p), td.rgba_view(port.full_rgba_device(p))[..., :3])


def test_engine_kernel_route_against_pallas(rng):
    """use_kernel on the CPU (the kernels' plain versions): the develop
    kernel's words, then the B8 post-pass, against the TPU kernels in
    interpret mode; the JPEG planes come from the post-pass."""
    port, ref = _engines(rng, use_kernel=True)
    p, jp = _params(EDITS[0][1])
    words = pallas_develop_rgba(ref.mosaic, jp, ref.wb, ref.cam_matrix,
                                interpret=True)
    table = pack_extras([p])[0].numpy()
    kw = dict(mixer=table[:, fx.MIXER_COL:fx.GRADING_COL],
              grading=table[:, fx.GRADING_COL:], interpret=True)
    args = (table[:, 0], table[:, 1], tuple(table[:, 2 + k]
                                            for k in range(4)), table[:, 6])
    want = pallas_finish_extras_rgba(words, *args, **kw)
    before = dict(fd.LAUNCHES), dict(fx.LAUNCHES)
    mx, share = _max_diff(td.rgba_view(port.full_rgba_device(p)),
                          jd.rgba_view(want))
    print(f"kernel route full: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1
    y, cbcr = pallas_finish_extras_rgba(words, *args, output="ycbcr420", **kw)
    for pname, g, w in zip(("Y", "Cb", "Cr"), port.jpeg_planes(p),
                           (y, cbcr[:, 0::2], cbcr[:, 1::2])):
        mx, share = _max_diff(g.numpy(), w)
        print(f"kernel route planes {pname}: max {mx}, differing {share:.2e}")
        assert mx <= 1
    # CPU tensors ran the plain versions: no launch counted.
    assert (dict(fd.LAUNCHES), dict(fx.LAUNCHES)) == before


def test_jpeg_export_with_point_curve(rng, tmp_path):
    """A point curve with extras through export(".jpg"): the develop takes
    the plain lane (as the JAX engine's does), the extras the post-pass;
    the file decodes to the JAX engine's export within 1."""
    from PIL import Image

    for use_kernel in (False, True):
        port, ref = _engines(rng, use_kernel=use_kernel)
        p, jp = _params(dict(EDITS[0][1], point_curve=CURVE))
        port.export(tmp_path / "port.jpg", p, quality=92)
        ref.export(tmp_path / "ref.jpg", jp, quality=92)
        got = np.asarray(Image.open(tmp_path / "port.jpg").convert("RGB"))
        want = np.asarray(Image.open(tmp_path / "ref.jpg").convert("RGB"))
        mx, share = _max_diff(got, want)
        print(f"export with curve (use_kernel={use_kernel}): decoded max "
              f"{mx}, differing {share:.2e}")
        assert got.shape == (64, 96, 3) and mx <= 1
        # The PNG keeps the alpha channel, as the JAX engine's does.
        port.export(tmp_path / "port.png", p)
        ref.export(tmp_path / "ref.png", jp)
        png = np.asarray(Image.open(tmp_path / "port.png"))
        ref_png = np.asarray(Image.open(tmp_path / "ref.png"))
        np.testing.assert_array_equal(
            png, td.rgba_view(port.full_rgba_device(p)))
        assert png.shape == ref_png.shape == (64, 96, 4)
        assert _max_diff(png, ref_png)[0] <= 2  # the extras post-pass
        data = (tmp_path / "port.jpg").read_bytes()
        assert np.asarray(Image.open(io.BytesIO(data))).shape == got.shape


def test_batch_routes_against_jax(rng):
    """The plain batch lane (per-image extras in the chain, per-image
    point curves) and the kernel route (develop words, then B8 to JPEG
    planes) against the JAX batch paths."""
    mosaics = rng.integers(0, 4096, size=(3, 32, 48), dtype=np.uint16)
    # The JAX batch packs point curves of one length per batch.
    edits = [dict(SLIDERS, **EXTRAS, point_curve=CURVE),
             dict(point_curve=((0.0, 0.0), (0.3, 0.3), (0.6, 0.6),
                               (1.0, 1.0))),
             dict(exposure=-0.4, sharpen=90.0, grade_mid_hue=100.0,
                  grade_mid_sat=30.0,
                  point_curve=((0.0, 0.1), (0.5, 0.4), (0.8, 0.9),
                               (1.0, 1.0)))]
    params = [EditParams(**e) for e in edits]
    jparams = [JaxParams(**e) for e in edits]
    wbs = np.stack([WB, np.ones(3, np.float32), WB[::-1].copy()])
    cms = np.stack([np.eye(3, dtype=np.float32), REAL, REAL])
    mode = "base+mixer+grading"
    want = jax_batch(mosaics, jax_pack_params(jparams), wbs, cms,
                     output="ycbcr420", extras=mode)
    got = batch_develop_rgba(torch.from_numpy(mosaics), params, wbs, cms,
                             output="ycbcr420", extras=mode)
    for g, w in zip(got, want):
        mx, share = _max_diff(g.numpy(), w)
        print(f"batch plain lane: max {mx}, differing {share:.2e}")
        assert mx <= 1
    # Kernel route: curves are not in the develop kernels, so this batch
    # has none.
    plain = [p.replace(point_curve=()) for p in params]
    jplain = [JaxParams(**{k: v for k, v in e.items() if k != "point_curve"})
              for e in edits]
    words = fd.fused_batch_develop_rgba(torch.from_numpy(mosaics),
                                        pack_params(plain, wbs, cms))
    table, mixer_on, grading_on, stencils = pack_extras(plain)
    y, cbcr = fx.fused_finish_extras_rgba(words, table, mixer_on=mixer_on,
                                          grading_on=grading_on,
                                          stencils=stencils,
                                          output="ycbcr420")
    jwords = pallas_batch_develop_rgba(mosaics, jax_pack_params(jplain), wbs,
                                       cms, interpret=True)
    t = table.numpy()
    wy, wc = pallas_finish_extras_rgba(
        jwords, t[:, 0], t[:, 1], tuple(t[:, 2 + k] for k in range(4)),
        t[:, 6], mixer=t[:, fx.MIXER_COL:fx.GRADING_COL],
        grading=t[:, fx.GRADING_COL:], interpret=True, output="ycbcr420")
    for g, w in ((y, wy), (cbcr, wc)):
        mx, share = _max_diff(g.numpy(), w)
        print(f"batch kernel route: max {mx}, differing {share:.2e}")
        assert mx <= 1


@pytest.mark.parametrize("edit,name", [
    (dict(clarity=20.0), "clarity"), (dict(dehaze=10.0), "dehaze"),
    (dict(grain=15.0), "grain"), (dict(highlight_recovery=50.0),
                                  "highlight recovery"),
    (dict(locals=({"kind": "radial"},)), "local adjustments")])
def test_unported_fields_raise_on_every_entry_point(edit, name, rng,
                                                    tmp_path):
    port, ref = _engines(rng, use_kernel=True)
    p = EditParams(sharpen=30.0).replace(**edit)
    if name == "highlight recovery":
        # Ported: every entry point renders the reconstructed mosaic,
        # bit-equal to the JAX reconstruction run op by op (the JAX
        # engine's jitted one rounds up to 1 LSB of u16 apart:
        # tests/test_torch_highlights.py); the tick within 1 LSB.
        from raweditor_tpu.ops.highlights import (
            reconstruct_mosaic_highlights)

        jp = JaxParams(sharpen=30.0, **edit)
        np.testing.assert_array_equal(
            port._render_mosaic(p).numpy(),
            np.asarray(reconstruct_mosaic_highlights(
                ref.mosaic, ref.wb, 50.0, ref.white_level, ref.black_level,
                cfa_phase=ref.cfa_phase)))
        mx, share = _max_diff(port.preview_tick(p).numpy(), ref.preview(jp))
        print(f"recovered tick: max {mx}, differing {share:.2e}")
        assert mx <= 1
        assert port.histogram(p).sum() == ref.histogram(jp).sum()
        words = port.full_rgba_device(p)
        assert not torch.equal(words, port.full_rgba_device(
            p.replace(highlight_recovery=0.0)))
        np.testing.assert_array_equal(port.full(p),
                                      td.rgba_view(words)[..., :3])
        assert len(port.jpeg_planes(p)) == 3
        port.export(tmp_path / "x.jpg", p)
        assert (tmp_path / "x.jpg").exists()
        return
    for call in (lambda: port.preview_tick(p), lambda: port.histogram(p),
                 lambda: port.full_rgba_device(p), lambda: port.full(p),
                 lambda: port.jpeg_planes(p),
                 lambda: port.export(tmp_path / "x.jpg", p),
                 lambda: pack_extras([p]) if name in (
                     "clarity", "dehaze", "grain") else td.develop_rgba(
                         port.mosaic, p, WB, REAL)):
        with pytest.raises(NotImplementedError, match=name):
            call()
    assert not (tmp_path / "x.jpg").exists()
