"""LinearRaw frames (DNG photometric 34892: (H, W, 3) u16, already
demosaiced) in the port against the JAX package on the CPU: the plain
develop functions, the batch lane, every entry point of
``DevelopEngine`` (exports with each geometry argument and ``long_edge``
among them), ``develop_tiers``, ``run_batch_export`` and
``tiers.generate_tiers``.

Frames are made with numpy from a seed and written by the port's
``write_synthetic_linear_dng``. Tolerances: 8-bit outputs within 1 LSB
and 16-bit outputs within 1 LSB of u16 of the JAX package's, with the
differing share printed (the JAX functions are jitted, and XLA's CPU
backend contracts ``a * b + c`` into fused multiply-adds; measured
maxima in the prints); histograms with equal sums, equal where the
previews are; JPEG files with equal headers (everything before the
scan) and decoded pixels within a mean of 0.05; every other byte of a
PNG or TIFF equal. The JAX engine's JPEG export with ``perspective`` and
no rotation raises ``ValueError`` (it sizes the planes without the
keystone's shrink); the port writes the file, held against the JAX
engine's PNG pixels through the port's 4:2:0 conversion and encoder.
"""

import io
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from raweditor_tpu.ops import develop as jdev
from raweditor_tpu.ops.jpeg import rgba_words_to_ycbcr420 as j_ycbcr420
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.parallel import batch as jbatch
from raweditor_tpu.pipeline import export as jex
from raweditor_tpu.pipeline.engine import DevelopEngine as JaxEngine
from raweditor_tpu_torch import DevelopEngine, EditParams
from raweditor_tpu_torch.ops import develop as dev
from raweditor_tpu_torch.parallel import batch as pbatch
from raweditor_tpu_torch.pipeline import export as pex
from raweditor_tpu_torch.pipeline.frame import FrameKind
from raweditor_tpu_torch.raw import synth

SLIDERS = dict(exposure=0.4, contrast=6.0, highlights=-0.3, shadows=0.2,
               whites=1.05, blacks=0.03, saturation=20.0, vibrance=0.3,
               temperature=0.1, tint=-0.05)
EXTRAS = dict(sharpen=50.0, denoise=30.0, curve_shadows=20.0,
              vignette=-25.0, hue_red=20.0, grade_shadow_hue=200.0,
              grade_shadow_sat=30.0)
D3300 = np.array([[0.6988, -0.1384, -0.0714], [-0.5631, 1.3410, 0.2447],
                  [-0.1485, 0.2204, 0.7318]], np.float32)
# name: (export keywords); the geometry cases of the engine and exporter
GEOMETRY = {
    "none": {}, "long_edge": dict(long_edge=40), "rotate": dict(rotate=3.0),
    "crop": dict(crop=(4, 6, 50, 30)),
    "lens": dict(lens=(0.02, 0.0, 1.0, -1.0)),
    "perspective": dict(perspective=(0.1, 0.0)),
    "rotate_long_edge": dict(rotate=-2.0, long_edge=31),
}


def _diff(a, b):
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    return int(d.max()), float((d > 0).mean())


def _frame(rng, h=48, w=72, top=4095, clipped=False):
    """A seeded (h, w, 3) u16 picture: gradients per channel, 2% noise,
    and with ``clipped`` a disc at the white level in green."""
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    base = np.array([0.3, 0.5, 0.4], np.float32)
    img = base * (0.3 + 0.6 * x + 0.3 * y * (1 - x))
    img = img + rng.standard_normal((h, w, 3)).astype(np.float32) * 0.02
    out = np.clip(img * top, 0, top).astype(np.uint16)
    if clipped:
        yy, xx = np.mgrid[:h, :w]
        disc = (yy - h // 2) ** 2 + (xx - w // 3) ** 2 < (h // 4) ** 2
        out[disc, 1] = top
        out[disc, 0] = np.minimum(out[disc, 0] + top // 3, top)
    return out


def _dng(tmp_path, rng, name="lin.dng", **kw):
    path = tmp_path / name
    synth.write_synthetic_linear_dng(
        path, _frame(rng, **kw), bpp=12, wb_neutral=(0.55, 1.0, 0.7),
        black_level=64)
    return str(path)


@pytest.mark.parametrize("mode", ["parity", "accurate"])
def test_develop_functions_equal_jax(mode, rng):
    frame = _frame(rng)
    wb = np.array([1.8, 1.0, 1.4], np.float32)
    cm = np.eye(3, dtype=np.float32) if mode == "parity" else D3300
    lv = ((4096.0, 0.0) if mode == "parity" else (4095.0, 64.0))
    mt = mode == "parity"
    transfer = "gamma22" if mode == "parity" else "srgb"
    t, j = torch.from_numpy(frame), frame
    for edit, ex in ((SLIDERS, False), (dict(SLIDERS, **EXTRAS), None)):
        p, jp = EditParams(**edit), JaxParams(**edit)
        ex = p.finish_extras_mode() if ex is None else ex
        kw = dict(white_level=lv[0], black_level=lv[1], matrix_transpose=mt,
                  transfer=transfer, extras=ex)
        for form in (dict(rgba=True), {}, dict(bits=16)):
            got = dev.develop_linear(t, p, wb, cm, **form, **kw)
            want = np.asarray(jdev.develop_linear(j, jp, wb, cm, **form, **kw))
            if form.get("rgba"):
                got, want = dev.rgba_view(got), jdev.rgba_view(want)
            elif form.get("bits"):
                assert got.dtype == torch.uint16
                got = got.view(torch.int16).numpy().view(np.uint16)
            assert tuple(got.shape) == want.shape
            mx, share = _diff(got, want)
            print(f"{mode} extras={ex} {form}: max {mx}, differing "
                  f"{share:.2e}")
            assert mx <= 1
        for zoom, pan in ((1.0, (0.0, 0.0)), (2.5, (0.1, -0.07))):
            vkw = dict(kw, zoom=zoom, pan_x=pan[0], pan_y=pan[1])
            got = dev.develop_linear_preview(t, p, wb, cm, 40, 27, **vkw)
            want = np.asarray(jdev.develop_linear_preview(
                j, jp, wb, cm, 40, 27, **vkw))
            mx, share = _diff(got.numpy(), want)
            print(f"{mode} preview zoom {zoom}: max {mx}, differing "
                  f"{share:.2e}")
            assert got.shape == want.shape and mx <= 1
            gh = dev.develop_linear_histogram(t, p, wb, cm, 20, 13, **vkw)
            wh = np.asarray(jdev.develop_linear_histogram(
                j, jp, wb, cm, 20, 13, **vkw))
            assert gh.shape == (3, 256) and int(gh.sum()) == int(wh.sum())
    with pytest.raises(ValueError):
        dev.develop_linear(t, EditParams(), wb, cm, rgba=True, bits=16)
    with pytest.raises(NotImplementedError, match="clarity"):
        dev.develop_linear(t, EditParams(clarity=10.0), wb, cm)


@pytest.mark.parametrize("output", ["rgba_words", "ycbcr420"])
def test_batch_develop_linear_rgba_equals_jax(output, rng):
    frames = np.stack([_frame(rng) for _ in range(3)])
    edits = [SLIDERS, {}, dict(exposure=-0.5, temperature=-0.2)]
    wbs = np.array([[1.8, 1.0, 1.4], [2.0, 1.0, 1.2], [1.0, 1.0, 1.0]],
                   np.float32)
    cms = np.stack([D3300] * 3)
    whites, blacks = [4095.0, 4095.0, 4000.0], [64.0, 0.0, 100.0]
    got = pbatch.batch_develop_linear_rgba(
        torch.from_numpy(frames), [EditParams(**e) for e in edits], wbs, cms,
        whites, blacks, transfer="srgb", output=output)
    want = jbatch.batch_develop_linear_rgba(
        frames, jbatch.pack_params([JaxParams(**e) for e in edits]), wbs,
        cms, np.array(whites, np.float32), np.array(blacks, np.float32),
        transfer="srgb", output=output)
    if output == "rgba_words":
        got, want = (dev.rgba_view(got),), (jdev.rgba_view(np.asarray(want)),)
    worst = 0
    for g, w in zip(got, want):
        g = g if isinstance(g, np.ndarray) else g.numpy()
        assert g.shape == np.asarray(w).shape
        worst = max(worst, _diff(g, w)[0])
    print(f"batch {output}: max {worst} LSB")
    assert worst <= 1


def _engines(path, mode, **kw):
    port = DevelopEngine.open(path, mode, device="cpu", max_preview_width=40,
                              histogram_width=20, **kw)
    use = kw.pop("use_kernel", False)
    ref = JaxEngine.open(path, mode, max_preview_width=40,
                         histogram_width=20, use_pallas=use, **kw)
    return port, ref


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("mode", ["parity", "accurate"])
def test_engine_entry_points_equal_jax(mode, use_kernel, rng, tmp_path):
    path = _dng(tmp_path, rng, clipped=True)
    port, ref = _engines(path, mode, use_kernel=use_kernel)
    assert port.linear and ref.linear and port.cfa_phase == (0, 0)
    assert (port.white_level, port.black_level) == (ref.white_level,
                                                    ref.black_level)
    worst = {}

    def hold(name, got, want):
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert np.asarray(got).shape == np.asarray(want).shape, name
        worst[name] = _diff(got, want)
        assert worst[name][0] <= 1, (name, worst[name])

    for edit in (SLIDERS, dict(SLIDERS, **EXTRAS),
                 dict(SLIDERS, highlight_recovery=60.0)):
        p, jp = EditParams(**edit), JaxParams(**edit)
        tag = ("extras" if "sharpen" in edit else "recovery"
               if "highlight_recovery" in edit else "sliders")
        for zoom, pan in ((1.0, (0.0, 0.0)), (2.0, (0.1, 0.05))):
            hold(f"{tag} tick {zoom}", port.preview_tick(p, zoom, pan),
                 ref.preview(jp, zoom, pan))
            gh, wh = port.histogram(p, zoom, pan), ref.histogram(jp, zoom, pan)
            assert gh.sum() == wh.sum()
            if worst[f"{tag} tick {zoom}"][0] == 0:
                np.testing.assert_array_equal(gh, wh)
        hold(f"{tag} full_rgba", dev.rgba_view(port.full_rgba_device(p)),
             jdev.rgba_view(np.asarray(ref.full_rgba_device(jp))))
        hold(f"{tag} full", port.full(p), ref.full(jp))
        want = j_ycbcr420(ref.full_rgba_device(jp))
        for name, g, w in zip(("Y", "Cb", "Cr"), port.jpeg_planes(p), want):
            hold(f"{tag} planes {name}", g, np.asarray(w))
    assert port.pick_wb(0.8, 0.2) == pytest.approx(ref.pick_wb(0.8, 0.2),
                                                   abs=1e-6)
    with pytest.raises(ValueError):
        port.pick_wb(0.3, 0.5)  # the clipped disc
    print(f"{mode} kernel={use_kernel}: (max LSB, differing share) "
          f"{worst}")


def _jpeg_head(data):
    return data[:data.index(b"\xff\xda")]


def _tiff_parts(data):
    from raweditor_tpu_torch.raw import tiff as T

    ifd = T.TiffFile(data).ifds[0]
    off = ifd.get_scalar(T.STRIP_OFFSETS)
    h, w = ifd.get_scalar(T.IMAGE_LENGTH), ifd.get_scalar(T.IMAGE_WIDTH)
    n = h * w * 6
    pix = np.frombuffer(data[off:off + n], "<u2").reshape(h, w, 3)
    return pix, data[:off] + data[off + n:]


def hold_exports(port, ref, tmp_path, kw, p, jp, tag=""):
    """The port's JPEG, PNG and TIFF exports against the JAX engine's with
    the same keywords; returns {format: (max LSB, differing share)}."""
    out = {}
    d = tmp_path / f"exports{tag}"
    d.mkdir(exist_ok=True)
    for ext in (".png", ".tif", ".jpg"):
        a, b = d / f"port{ext}", d / f"jax{ext}"
        port.export(a, p, **kw)
        jax_raises = ext == ".jpg" and "perspective" in kw \
            and not kw.get("rotate")
        if jax_raises:
            with pytest.raises(ValueError, match="plane buffer"):
                ref.export(b, jp, **kw)
            # The JAX engine's pixels (its PNG) through the port's 4:2:0
            # conversion and encoder.
            from raweditor_tpu_torch.ops.jpeg import rgba_words_to_ycbcr420

            rgba = np.array(Image.open(d / "jax.png"))
            words = torch.from_numpy(rgba.view(np.int32)[..., 0]).view(
                torch.uint32)
            h, w = words.shape
            data = port._encode_planes(rgba_words_to_ycbcr420(words), w, h,
                                       95)
            ga = a.read_bytes()
            assert _jpeg_head(ga)[-200:] == _jpeg_head(data)[-200:]
            got = np.asarray(Image.open(a).convert("RGB")).astype(int)
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            assert got.shape == want.shape == (h, w, 3)
            assert np.abs(got - want).mean() < 0.05
            continue
        ref.export(b, jp, **kw)
        ga, gb = a.read_bytes(), b.read_bytes()
        if ext == ".tif":
            (pa, ra), (pb, rb) = _tiff_parts(ga), _tiff_parts(gb)
            assert pa.shape == pb.shape and ra == rb
            out[ext] = _diff(pa, pb)
        else:
            ia, ib = Image.open(io.BytesIO(ga)), Image.open(io.BytesIO(gb))
            assert ia.size == ib.size and ia.mode == ib.mode
            assert ia.getexif() == ib.getexif()
            pa, pb = np.asarray(ia).astype(int), np.asarray(ib).astype(int)
            if ext == ".jpg":
                assert _jpeg_head(ga) == _jpeg_head(gb)
                assert np.abs(pa - pb).mean() < 0.05
            out[ext] = _diff(pa, pb)
        assert out[ext][0] <= 1 or ext == ".jpg", (ext, out[ext])
    return out


@pytest.mark.parametrize("case", list(GEOMETRY))
def test_engine_exports_with_geometry_equal_jax(case, rng, tmp_path):
    path = _dng(tmp_path, rng)
    port, ref = _engines(path, "accurate", use_kernel=True)
    p, jp = EditParams(**SLIDERS), JaxParams(**SLIDERS)
    got = hold_exports(port, ref, tmp_path, GEOMETRY[case], p, jp)
    print(f"LinearRaw export {case}: {got}")


def test_develop_tiers_equal_jax(rng, tmp_path):
    port, ref = _engines(_dng(tmp_path, rng), "accurate")
    p, jp = EditParams(**SLIDERS), JaxParams(**SLIDERS)
    for widths in ((16, 24, 40), (72, 100)):
        for g, w in zip(port.develop_tiers(p, widths),
                        ref.develop_tiers(jp, widths)):
            assert g.shape == w.shape
            mx, share = _diff(g, w)
            print(f"tier {w.shape}: max {mx}, differing {share:.2e}")
            assert mx <= 1


def _recorders(monkeypatch):
    seen = {"port": {}, "jax": {}}
    for pkg, mod in (("port", pex), ("jax", jex)):
        store = seen[pkg]

        def planes(out_path, y, cb, cr, *args, store=store):
            store[os.path.basename(out_path)] = (y.copy(), cb.copy(),
                                                 cr.copy()), args

        def words(out_path, rgba_words, *args, store=store):
            store[os.path.basename(out_path)] = (
                np.ascontiguousarray(rgba_words).view(np.uint8),), args

        monkeypatch.setattr(mod, "_encode_one_jpeg420", planes)
        monkeypatch.setattr(mod, "_encode_one", words)
    return seen


def _export_files(tmp_path, rng):
    """Two LinearRaw DNGs (one with a clipped disc) and two Bayer DNGs."""
    paths = [_dng(tmp_path, rng, "l0.dng", clipped=True),
             _dng(tmp_path, rng, "l1.dng")]
    for i in range(2):
        p = tmp_path / f"b{i}.dng"
        synth.write_synthetic_raw(
            p, rng.integers(0, 4096, size=(48, 72), dtype=np.uint16),
            black_level=150, white_level=4095, wb_neutral=(0.5, 1.0, 0.625),
            preview_jpeg=b"")
        paths.append(str(p))
    return paths


RUNS = {
    "jpeg": dict(), "recovery_extras": dict(extras=True, recovery=True),
    "bits16": dict(bits=16), "rotate": dict(rotate=2.0),
    "long_edge": dict(long_edge=40), "geometry_extras": dict(
        extras=True, rotate=-3.0, long_edge=50),
    "crop_bits16": dict(bits=16, crop=(2, 2, 60, 40), long_edge=50),
    "lens_png": dict(ext=".png", lens=(0.03, 0.0, 1.0, -1.0)),
    "perspective": dict(perspective=(0.0, 0.12)),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_batch_export_linear_and_geometry_equal_jax(run, rng, tmp_path,
                                                    monkeypatch):
    """LinearRaw files bucket on their own beside Bayer ones; with and
    without recovery and extras, 16-bit, and with each geometry argument
    and ``long_edge``: both exporters hand their encoders the same arrays
    within 1 LSB (u16 for TIFF), and the port's files equal its engine's
    exports byte for byte."""
    spec = dict(RUNS[run])
    paths = _export_files(tmp_path, rng)
    ext = spec.pop("ext", ".tif" if spec.get("bits") == 16 else ".jpg")
    extras, recovery = spec.pop("extras", False), spec.pop("recovery", False)
    port_jobs, ref_jobs = [], []
    for i, path in enumerate(paths):
        edit = dict(SLIDERS, exposure=0.1 * i)
        if extras and i % 2 == 0:
            edit.update(EXTRAS)
        if recovery and i % 2 == 0:
            edit["highlight_recovery"] = 60.0
        name = f"{os.path.splitext(os.path.basename(path))[0]}{ext}"
        port_jobs.append(pex.ExportJob(path, str(tmp_path / "port" / name),
                                       EditParams(**edit)))
        ref_jobs.append(jex.ExportJob(path, str(tmp_path / "jax" / name),
                                      JaxParams(**edit)))
    kw = dict(batch_size=2, mode="accurate", demosaic_method="malvar",
              **spec)
    if ext == ".tif":
        rep = pex.run_batch_export(port_jobs, device="cpu", use_kernel=True,
                                   **kw)
        ref = jex.run_batch_export(ref_jobs, **kw)
        assert rep.succeeded == ref.succeeded == len(paths), rep.failed
        worst = 0
        for a, b in zip(port_jobs, ref_jobs):
            (pa, ra), (pb, rb) = (_tiff_parts(open(j.out_path, "rb").read())
                                  for j in (a, b))
            assert pa.shape == pb.shape and ra == rb
            worst = max(worst, _diff(pa, pb)[0])
        print(f"{run}: TIFF pixels max {worst} LSB of u16")
        assert worst <= 1
    else:
        seen = _recorders(monkeypatch)
        rep = pex.run_batch_export(port_jobs, device="cpu", use_kernel=True,
                                   **kw)
        ref = jex.run_batch_export(ref_jobs, **kw)
        assert rep.succeeded == ref.succeeded == len(paths), rep.failed
        assert rep.fetch_bytes == ref.fetch_bytes
        assert rep.upload_bytes == ref.upload_bytes
        assert seen["port"].keys() == seen["jax"].keys()
        worst = 0
        for name, (arrays, args) in seen["port"].items():
            ref_arrays, ref_args = seen["jax"][name]
            assert args == ref_args, name
            assert len(arrays) == len(ref_arrays), name
            for g, w in zip(arrays, ref_arrays):
                assert g.shape == w.shape, name
                worst = max(worst, _diff(g, w)[0])
        print(f"{run}: encoder inputs max {worst} LSB")
        assert worst <= 1
        monkeypatch.undo()
        rep = pex.run_batch_export(port_jobs, device="cpu", use_kernel=True,
                                   **kw)
        assert rep.succeeded == len(paths)
    # The port's files against its engine's exports of the same jobs.
    geo = {k: v for k, v in spec.items() if k != "bits"}
    for job in port_jobs:
        eng = DevelopEngine.open(job.raw_path, "accurate", device="cpu",
                                 use_kernel=True, demosaic_method="malvar")
        ref_path = eng.export(tmp_path / f"engine{ext}", job.params,
                              quality=95, **geo)
        assert open(ref_path, "rb").read() == open(job.out_path, "rb").read(), \
            job.out_path


def test_generate_tiers_of_a_linear_dng_without_a_jpeg(rng, tmp_path,
                                                       monkeypatch):
    """The developed fallback of ``tiers.generate_tiers`` opens the
    LinearRaw file through the engine: the same tier files as the JAX
    package's, within the lanes' 1 LSB before PIL's resize."""
    from raweditor_tpu.pipeline import tiers as jtiers
    from raweditor_tpu.raw import decode as jdecode
    from raweditor_tpu_torch.pipeline import tiers
    from raweditor_tpu_torch.raw import decode as pdecode

    monkeypatch.setenv("RAWEDITOR_TPU_PLATFORM", "cpu")
    for mod in (jdecode, pdecode):
        monkeypatch.setattr(mod, "extract_preview_jpeg", lambda p: None)
    path = _dng(tmp_path, rng, h=300, w=460)
    got = tiers.generate_tiers(path, 7, cache_dir=tmp_path / "port")
    want = jtiers.generate_tiers(path, 7, cache_dir=tmp_path / "jax")
    for g, w in zip(got, want):
        a, b = (np.asarray(Image.open(x).convert("RGB")).astype(int)
                for x in (g, w))
        assert a.shape == b.shape
        print(f"tier {a.shape}: mean |diff| {np.abs(a - b).mean():.4f}")
        assert np.abs(a - b).mean() < 0.05


def test_staging_passes_a_linear_frame_unpacked(rng, tmp_path):
    """A LinearRaw frame stages unpacked and bit-exact (the JAX exporter
    packs only 2-D u16 mosaics), with the upload bytes of the JAX run."""
    path = _dng(tmp_path, rng)
    frame = pex._decode_job(pex.ExportJob(path, "x.jpg"), "accurate")
    assert frame.kind == FrameKind(linear=True)
    budget = pex._StageBudget(pex._STAGE_BUDGET)
    with ThreadPoolExecutor(1) as pool:
        up = pex._Uploader(pool, torch.device("cpu"))
        d = pex._decode_job(pex.ExportJob(path, "x.jpg"), "accurate", up,
                            budget)
        assert d.staged_fmt == "raw" and d.staged_nbytes == d.mosaic.nbytes
        assert budget.used == d.staged_nbytes
        t, event, _ = d.staged.result()
    assert event is None and t.dtype == torch.uint16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  frame.mosaic)
