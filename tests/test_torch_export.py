"""The port's batch exporter (``pipeline/export.run_batch_export``) on the
CPU device against the JAX package's exporter on the same files and jobs.

Files are written under ``tmp_path`` by the port's writers: 12-bit DNGs
of 24x32 (three, so that ``batch_size=2`` gives a full bucket and a drain
of one padded frame), 32x48 and an odd 23x31, and two 24x36 X-Trans RAFs.
What each exporter hands its encoder is recorded by replacing
``_encode_one_jpeg420`` and ``_encode_one`` in both modules.

Tolerances (measured maxima in the comments):

- the plain lane (``use_kernel=False``; JAX ``use_pallas=False``): PNG
  pixels equal; JPEG planes and RGBA words within 1 LSB, as
  ``tests/test_torch_engine.py::test_jpeg_export`` holds them (measured:
  0 on every case here);
- ``use_kernel=True`` (the kernels' plain versions on the CPU) against
  JAX's XLA lane: within 1 LSB (measured: 0);
- a bucket with finish extras against JAX's post-pass: within 2 LSB, the
  extras kernel's stated tolerance against the in-chain form (measured:
  0 on every case here).
"""

import os
import types

import numpy as np
import pytest
import torch

from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.pipeline import export as jex
from raweditor_tpu_torch import EditParams
from raweditor_tpu_torch.ops import fused_develop as fd
from raweditor_tpu_torch.ops import fused_extras as fx
from raweditor_tpu_torch.pipeline import export as pex
from raweditor_tpu_torch.raw import raf, synth

D3300 = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                  [-1485, 2204, 7318]], np.float32) / 10000.0
BAYER = ((24, 32), (24, 32), (24, 32), (32, 48), (23, 31))
XT_SHAPE = (24, 36)
# Per-image sliders, cycled over the jobs.
EDITS = [dict(exposure=0.3, contrast=5.0, saturation=20.0),
         dict(),
         dict(exposure=-0.6, shadows=0.3, vibrance=0.4, temperature=0.1),
         dict(highlights=-0.4, whites=1.05, blacks=0.02, tint=-0.1)]
EXTRAS = dict(sharpen=60.0, denoise=40.0, curve_shadows=30.0,
              vignette=-30.0, hue_red=25.0, sat_blue=-40.0,
              grade_shadow_hue=210.0, grade_shadow_sat=40.0)
# mode, demosaic_method, with the X-Trans files
SETUPS = [("parity", "nearest", True), ("accurate", "malvar", False),
          ("accurate", "grad", True), ("accurate", "bilinear", True)]


def _files(tmp_path, xtrans=True, seed=7):
    """Paths of the Bayer DNGs (and the X-Trans RAFs), written once."""
    rng = np.random.default_rng(seed)
    d = tmp_path / "raw"
    d.mkdir(exist_ok=True)
    paths = []
    for i, (h, w) in enumerate(BAYER):
        p = d / f"b{i}.dng"
        synth.write_synthetic_raw(
            p, rng.integers(0, 4096, size=(h, w), dtype=np.uint16),
            xyz_to_cam=D3300, black_level=150, white_level=4095,
            wb_neutral=(0.5, 1.0, 0.625), cfa="GBRG",
            make="NIKON CORPORATION", model="NIKON D3300", preview_jpeg=b"")
        paths.append(str(p))
    if xtrans:
        for i in range(2):
            p = d / f"x{i}.raf"
            p.write_bytes(raf.write_raf(
                rng.integers(0, 4096, size=XT_SHAPE, dtype=np.uint16),
                model="X-T2", wb_grbg=(256, 512, 384, 256)))
            paths.append(str(p))
    return paths


def _jobs(paths, out, ext, edits=EDITS, extra=None):
    """(port jobs, JAX jobs) writing ``out/<stem><ext>``."""
    port, ref = [], []
    for i, p in enumerate(paths):
        kw = dict(edits[i % len(edits)], **(extra or {}))
        name = os.path.splitext(os.path.basename(p))[0] + ext
        port.append(pex.ExportJob(p, str(out / "port" / name),
                                  EditParams(**kw)))
        ref.append(jex.ExportJob(p, str(out / "jax" / name), JaxParams(**kw)))
    return port, ref


def _recorders(monkeypatch):
    """Replace both packages' encoders by recorders: {package: {name:
    (arrays, arguments)}}."""
    seen = {"port": {}, "jax": {}}
    for pkg, mod in (("port", pex), ("jax", jex)):
        store = seen[pkg]

        def planes(out_path, y, cb, cr, quality, exif=b"", optimize=False,
                   chroma="420", restart_rows=0, icc=None, store=store):
            store[os.path.basename(out_path)] = (
                ("planes", y.copy(), cb.copy(), cr.copy()),
                (quality, exif, optimize, chroma, restart_rows, icc))

        def words(out_path, rgba_words, quality, exif=b"", optimize=False,
                  chroma="420", restart_rows=0, icc=None, store=store):
            store[os.path.basename(out_path)] = (
                ("words", np.ascontiguousarray(rgba_words).view(np.uint8)),
                (quality, exif, optimize, chroma, restart_rows, icc))

        monkeypatch.setattr(mod, "_encode_one_jpeg420", planes)
        monkeypatch.setattr(mod, "_encode_one", words)
    return seen


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(int)
                      - np.asarray(b).astype(int)).max())


def _run(port_jobs, ref_jobs, use_kernel=False, **kw):
    rep = pex.run_batch_export(port_jobs, device="cpu", use_kernel=use_kernel,
                               **kw)
    ref = jex.run_batch_export(ref_jobs, **kw)
    return rep, ref


def _same_report(rep, ref):
    assert (rep.total, rep.succeeded, rep.skipped) == (
        ref.total, ref.succeeded, ref.skipped)
    assert [(p, m.split(":")[0]) for p, m in rep.failed] == [
        (p, m.split(":")[0]) for p, m in ref.failed]
    assert set(rep.as_dict()) == set(ref.as_dict())
    assert rep.upload_bytes == ref.upload_bytes
    assert rep.fetch_bytes == ref.fetch_bytes


def _compare_recorded(seen, limit):
    """Largest LSB difference over every recorded encode; the encoders'
    arguments must be equal."""
    assert seen["port"].keys() == seen["jax"].keys() and seen["port"]
    worst = 0
    for name, (arrays, args) in seen["port"].items():
        ref_arrays, ref_args = seen["jax"][name]
        assert args == ref_args, name
        assert arrays[0] == ref_arrays[0], name
        for a, b in zip(arrays[1:], ref_arrays[1:]):
            assert a.shape == b.shape, name
            worst = max(worst, _lsb(a, b))
    assert worst <= limit
    return worst


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("setup", SETUPS, ids=lambda s: f"{s[0]}-{s[1]}")
def test_jpeg_encoder_gets_the_jax_planes(setup, use_kernel, tmp_path,
                                          monkeypatch):
    """An all-JPEG run: 4:2:0 planes for the even frames, RGBA words
    through PIL for the odd one; both exporters hand their encoders the
    same planes within 1 LSB (measured 0 on every setup and route) and
    the same quality, EXIF, optimize, chroma and restart arguments."""
    mode, method, xtrans = setup
    paths = _files(tmp_path, xtrans)
    port_jobs, ref_jobs = _jobs(paths, tmp_path, ".jpg")
    seen = _recorders(monkeypatch)
    rep, ref = _run(port_jobs, ref_jobs, use_kernel, batch_size=2, mode=mode,
                    demosaic_method=method, quality=91)
    _same_report(rep, ref)
    assert rep.succeeded == len(paths) and not rep.failed
    worst = _compare_recorded(seen, 1)
    kinds = {n: a[0][0] for n, a in seen["port"].items()}
    assert kinds["b4.jpg"] == "words" and kinds["b0.jpg"] == "planes"
    print(f"{setup} kernel={use_kernel}: encoder inputs max {worst} LSB")


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("setup", SETUPS[:3], ids=lambda s: f"{s[0]}-{s[1]}")
def test_png_pixels_equal_jax(setup, use_kernel, tmp_path):
    """A PNG run writes RGBA files: equal to the JAX run's pixels on the
    plain lane, within 1 LSB with ``use_kernel`` (measured 0)."""
    from PIL import Image

    mode, method, xtrans = setup
    paths = _files(tmp_path, xtrans)
    port_jobs, ref_jobs = _jobs(paths, tmp_path, ".png")
    rep, ref = _run(port_jobs, ref_jobs, use_kernel, batch_size=2, mode=mode,
                    demosaic_method=method)
    _same_report(rep, ref)
    assert rep.succeeded == len(paths)
    worst = 0
    for a, b in zip(port_jobs, ref_jobs):
        got, want = Image.open(a.out_path), Image.open(b.out_path)
        assert got.mode == want.mode == "RGBA" and got.size == want.size
        assert got.getexif().get(271) == want.getexif().get(271)
        worst = max(worst, _lsb(np.asarray(got), np.asarray(want)))
    assert worst <= (1 if use_kernel else 0)
    print(f"{setup} kernel={use_kernel}: PNG max {worst} LSB")


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("ext", [".jpg", ".png"])
def test_extras_bucket_matches_jax_post_pass(ext, use_kernel, tmp_path,
                                             monkeypatch):
    """Jobs with finish extras (one of them at zero amounts, one with the
    mixer off) form their own buckets and take the extras post-pass on
    either route; against the JAX exporter's post-pass within 2 LSB
    (measured 0)."""
    paths = _files(tmp_path, xtrans=True)
    edits = [dict(EDITS[0], **EXTRAS),
             dict(EDITS[1], sharpen=100.0, vignette=50.0),
             dict(EDITS[2], **EXTRAS)]
    port_jobs, ref_jobs = _jobs(paths, tmp_path, ext, edits)
    seen = _recorders(monkeypatch)
    before = dict(fx.LAUNCHES)
    rep, ref = _run(port_jobs, ref_jobs, use_kernel, batch_size=2,
                    mode="accurate", demosaic_method="grad")
    assert fx.LAUNCHES == before  # CPU tensors: the plain version ran
    _same_report(rep, ref)
    assert rep.succeeded == len(paths)
    worst = _compare_recorded(seen, 2)
    print(f"extras {ext} kernel={use_kernel}: max {worst} LSB")


def test_extras_route_calls_the_extras_wrapper_on_both_routes(tmp_path,
                                                              monkeypatch):
    """Extras always run the post-pass wrapper (B8 on a card), with or
    without ``use_kernel``, planes for an all-JPEG run of even frames."""
    paths = _files(tmp_path, xtrans=False)[:3]
    calls = []
    real = fx.fused_finish_extras_rgba

    def spy(words, table, **kw):
        calls.append((tuple(words.shape), kw["output"]))
        return real(words, table, **kw)

    monkeypatch.setattr(fx, "fused_finish_extras_rgba", spy)
    for use_kernel in (False, True):
        jobs, _ = _jobs(paths, tmp_path / str(use_kernel), ".jpg",
                        [dict(sharpen=30.0)])
        rep = pex.run_batch_export(jobs, batch_size=2, device="cpu",
                                   use_kernel=use_kernel)
        assert rep.succeeded == 3
    assert calls == [((2, 24, 32), "ycbcr420")] * 4


@pytest.mark.parametrize("case", ["missing", "truncated", "bad_cfa",
                                  "encode", "linear"])
def test_failures_quarantine_their_job(case, tmp_path):
    """One bad job fails alone with the JAX exporter's prefix; the others
    succeed. (A LinearRaw file is quarantined at decode by the port,
    which does not develop LinearRaw yet; the JAX exporter develops it.)"""
    paths = _files(tmp_path, xtrans=False)[:3]
    bad = str(tmp_path / "raw" / "bad.dng")
    rng = np.random.default_rng(3)
    if case == "truncated":
        data = open(paths[0], "rb").read()
        open(bad, "wb").write(data[: len(data) // 2])
    elif case == "bad_cfa":
        synth.write_synthetic_raw(
            bad, rng.integers(0, 4096, size=(24, 32), dtype=np.uint16),
            cfa="GRGB", preview_jpeg=b"")
    elif case == "linear":
        synth.write_synthetic_linear_dng(
            bad, rng.integers(0, 4096, size=(24, 32, 3), dtype=np.uint16))
    port_jobs, ref_jobs = _jobs(paths + [bad], tmp_path, ".jpg")
    if case == "encode":
        (tmp_path / "afile").write_bytes(b"x")
        for jobs in (port_jobs, ref_jobs):
            jobs[-1].raw_path = paths[0]
            jobs[-1].out_path = str(tmp_path / "afile" / "sub" / "x.jpg")
    rep, ref = _run(port_jobs, ref_jobs, batch_size=2, mode="accurate")
    want = {"missing": "decode", "truncated": "decode", "bad_cfa": "decode",
            "encode": "encode", "linear": "decode"}[case]
    assert rep.succeeded == 3 and len(rep.failed) == 1
    assert rep.failed[0][1].startswith(want + ": "), rep.failed
    if case == "linear":
        assert "LinearRaw" in rep.failed[0][1] and ref.succeeded == 4
    else:
        _same_report(rep, ref)


@pytest.mark.parametrize("wrapper", ["develop", "extras"])
def test_failing_kernel_quarantines_its_batch(wrapper, tmp_path,
                                              monkeypatch):
    """A kernel wrapper that raises (a build or launch failure on the
    card) quarantines its batch as "develop: ..."; no flush routes
    around it to the plain lane, and the staging budget is returned."""
    paths = _files(tmp_path, xtrans=False)[:3]
    edit = [dict(sharpen=40.0)] if wrapper == "extras" else EDITS
    jobs, _ = _jobs(paths, tmp_path, ".jpg", edit)

    def broken(*a, **k):
        raise RuntimeError(f"injected {wrapper} kernel failure")

    def never(*a, **k):
        raise AssertionError("the plain lane ran after a kernel failure")

    target = fd if wrapper == "develop" else fx
    name = ("fused_batch_develop_rgba" if wrapper == "develop"
            else "fused_finish_extras_rgba")
    monkeypatch.setattr(target, name, broken)
    monkeypatch.setattr(pex, "batch_develop_rgba", never)
    monkeypatch.setattr(pex, "batch_develop_xtrans_rgba", never)
    rep = pex.run_batch_export(jobs, batch_size=2, device="cpu",
                               use_kernel=True)
    assert rep.succeeded == 0 and len(rep.failed) == 3
    assert all(m.startswith("develop: injected") for _, m in rep.failed)
    assert pex._stage_used == 0
    assert not any(os.path.exists(j.out_path) for j in jobs)


@pytest.mark.parametrize("case", ["no_native", "missing"])
def test_jpeg_run_never_moves_the_planes_to_pil(case, tmp_path,
                                                monkeypatch):
    """``RAWEDITOR_TPU_NO_NATIVE`` switches the decoders' codec only: an
    all-JPEG run still hands the native encoder its planes for the even
    frames. With no encoder at all, such a run raises naming the file
    before it reads one (the job's file does not exist); a PNG run does
    not need the encoder."""
    from raweditor_tpu_torch import native

    if case == "no_native":
        monkeypatch.setenv("RAWEDITOR_TPU_NO_NATIVE", "1")
        monkeypatch.setattr(native, "_tried", False)
        monkeypatch.setattr(native, "_cached", None)
        paths = _files(tmp_path, xtrans=False)
        jobs, _ = _jobs(paths, tmp_path, ".jpg")
        seen = _recorders(monkeypatch)["port"]
        rep = pex.run_batch_export(jobs, batch_size=2, device="cpu",
                                   use_kernel=True)
        assert native.get_rawkit() is None and rep.succeeded == len(paths)
        assert {n: a[0][0] for n, a in seen.items()} == {
            "b0.jpg": "planes", "b1.jpg": "planes", "b2.jpg": "planes",
            "b3.jpg": "planes", "b4.jpg": "words"}
        assert rep.fetch_bytes == sum(
            h * w * (1.5 if h % 2 == 0 else 4) for h, w in BAYER)
        return

    def missing():
        raise FileNotFoundError("no _rawkit extension for this "
                                "interpreter: _rawkit.so is missing")

    monkeypatch.setattr(native, "require_rawkit", missing)
    gone = str(tmp_path / "gone.dng")
    with pytest.raises(FileNotFoundError, match="_rawkit"):
        pex.run_batch_export([pex.ExportJob(gone, str(tmp_path / "a.jpg"))],
                             device="cpu")
    rep = pex.run_batch_export([pex.ExportJob(gone, str(tmp_path / "a.png"))],
                               device="cpu")
    assert rep.failed[0][1].startswith("decode: ")


def test_skip_existing_and_progress(tmp_path):
    """A rerun with ``skip_existing`` skips what the first run wrote, as
    the JAX exporter does; the progress callback sees every image and a
    raising callback does not fail the run."""
    paths = _files(tmp_path, xtrans=False)
    port_jobs, ref_jobs = _jobs(paths, tmp_path, ".jpg")
    calls = []
    first = pex.run_batch_export(
        port_jobs[:3], batch_size=2, device="cpu",
        on_progress=lambda *a: calls.append(a))
    assert first.succeeded == 3 and calls[-1][:3] == (3, 0, 3)
    jex.run_batch_export(ref_jobs[:3], batch_size=2)

    def boom(*a):
        raise RuntimeError("callback")

    rep, ref = _run(port_jobs, ref_jobs, batch_size=2, skip_existing=True,
                    on_progress=boom)
    assert (rep.skipped, rep.succeeded, rep.total) == (3, 2, 5)
    _same_report(rep, ref)
    again = pex.run_batch_export(port_jobs, device="cpu", skip_existing=True)
    assert (again.skipped, again.succeeded, again.fetch_bytes) == (5, 0, 0)


def test_jobs_from_catalog_matches_jax(tmp_path):
    """The same jobs as the JAX function on one catalog: stored edits,
    the stem collision of two folders disambiguated by id, a deleted
    row left out, ``image_ids`` and ``ext``."""
    from raweditor_tpu.catalog import Library as JaxLibrary
    from raweditor_tpu_torch import Library

    rng = np.random.default_rng(5)
    for folder in ("a", "b"):
        d = tmp_path / "photos" / folder
        d.mkdir(parents=True)
        for stem in ("IMG_0001", "IMG_0002"):
            synth.write_synthetic_raw(
                d / f"{stem}.dng",
                rng.integers(0, 4096, size=(8, 8), dtype=np.uint16),
                preview_jpeg=b"")
    db = tmp_path / "cat.db"
    with Library(db) as lib:
        assert lib.import_folder(tmp_path / "photos")["imported"] == 4
        ids = [i.id for i in lib.get_all_images()]
        lib.save_edit_params(ids[0], EditParams(exposure=1.5, sharpen=20.0))
        # A file gone from disk becomes a tombstone, which exports skip.
        os.unlink(tmp_path / "photos" / "b" / "IMG_0002.dng")
        assert lib.verify_files() == 1
    with Library(db) as lib, JaxLibrary(db) as jlib:
        for kw in (dict(), dict(image_ids=ids[:2], ext="png")):
            got = pex.jobs_from_catalog(lib, tmp_path / "out", **kw)
            want = jex.jobs_from_catalog(jlib, tmp_path / "out", **kw)
            assert [(j.raw_path, j.out_path, j.image_id, j.params.to_json())
                    for j in got] == [
                (j.raw_path, j.out_path, j.image_id, j.params.to_json())
                for j in want]
    names = [os.path.basename(j.out_path) for j in got]
    assert len(set(names)) == len(names)


def _sof(data: bytes):
    """(component, h, v) sampling of a baseline or progressive SOF."""
    for marker in (b"\xff\xc0", b"\xff\xc1", b"\xff\xc2"):
        i = data.find(marker)
        if i >= 0:
            n = data[i + 9]
            return [(data[i + 10 + 3 * k], data[i + 11 + 3 * k] >> 4,
                     data[i + 11 + 3 * k] & 15) for k in range(n)]
    raise AssertionError("no SOF marker")


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("flags", [
    dict(chroma="444"), dict(jpeg_optimize=True),
    dict(jpeg_restart_rows=1), dict(chroma="444", jpeg_restart_rows=1)],
    ids=["444", "optimize", "restart", "444-restart"])
def test_jpeg_flags_reach_the_bytes(flags, use_kernel, tmp_path):
    """The JPEG flags change the written bytes as in the JAX exporter:
    4:4:4 is sampled 1x1 and takes the planes path even for the odd
    frame (3 B/px fetched), restart rows write DRI/RSTn (``\\xff\\xdd``),
    optimised tables make a smaller file of the same picture. On the
    plain lane the files are byte-equal to the JAX exporter's."""
    from PIL import Image

    paths = _files(tmp_path, xtrans=False)
    port_jobs, ref_jobs = _jobs(paths, tmp_path, ".jpg")
    rep, ref = _run(port_jobs, ref_jobs, use_kernel, batch_size=2,
                    quality=90, **flags)
    _same_report(rep, ref)
    assert rep.succeeded == len(paths)
    base_jobs = _jobs(paths, tmp_path / "base", ".jpg")[0]
    base = pex.run_batch_export(base_jobs, batch_size=2, device="cpu",
                                use_kernel=use_kernel, quality=90)
    assert base.succeeded == len(paths)
    if flags.get("chroma") == "444":
        assert rep.fetch_bytes == sum(3 * h * w for h, w in BAYER)
    for a, b, c in zip(port_jobs, ref_jobs, base_jobs):
        data = open(a.out_path, "rb").read()
        plain = open(c.out_path, "rb").read()
        if not use_kernel:
            assert data == open(b.out_path, "rb").read(), a.out_path
        sampling = _sof(data)
        assert sampling[0][1:] == (
            (1, 1) if flags.get("chroma") == "444" else (2, 2))
        assert (b"\xff\xdd" in data) == bool(flags.get("jpeg_restart_rows"))
        if flags.get("jpeg_optimize"):
            assert len(data) < len(plain)
            np.testing.assert_array_equal(
                np.asarray(Image.open(a.out_path)),
                np.asarray(Image.open(c.out_path)))


@pytest.mark.parametrize("arg", [
    "mesh", "bits", "color_space", "long_edge", "rotate", "crop", "lens",
    "perspective", "clarity", "dehaze", "grain", "locals",
    "highlight_recovery"])
def test_unported_arguments_raise_before_any_file_is_read(arg, tmp_path):
    """Each argument and edit the port cannot export yet raises
    ``NotImplementedError`` naming itself, before a file is read (the
    job's file does not exist)."""
    kw, edit = {}, {}
    value = {"mesh": object(), "bits": 16, "color_space": "display-p3",
             "long_edge": 16, "rotate": 1.5, "crop": (0, 0, 8, 8),
             "lens": (0.01, 0.0, 0.0, 0.0), "perspective": (0.1, 0.0),
             "clarity": 20.0, "dehaze": 10.0, "grain": 15.0,
             "locals": (types.SimpleNamespace(kind="radial"),),
             "highlight_recovery": 0.5}[arg]
    if arg in EditParams.field_names() or arg == "locals":
        edit[arg] = value
    else:
        kw[arg] = value
    job = pex.ExportJob(str(tmp_path / "missing.dng"),
                        str(tmp_path / "out.jpg"), EditParams(**edit))
    name = {"locals": "local adjustments",
            "highlight_recovery": "highlight recovery"}.get(arg, arg)
    with pytest.raises(NotImplementedError, match=name):
        pex.run_batch_export([job], device="cpu", **kw)
    assert not (tmp_path / "out.jpg").exists()


def test_invalid_arguments_and_device(tmp_path, monkeypatch):
    """Invalid values raise ``ValueError`` as in the JAX exporter; the
    default device is the card and never falls back to the CPU."""
    job = pex.ExportJob(str(tmp_path / "missing.dng"),
                        str(tmp_path / "out.jpg"))
    for kw in (dict(chroma="422"), dict(bits=12), dict(color_space="xyz"),
               dict(transfer="bogus"), dict(mode="fast"),
               dict(demosaic_method="ahd")):
        with pytest.raises(ValueError):
            pex.run_batch_export([job], device="cpu", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        pex.run_batch_export([job])
    import inspect

    sig = inspect.signature(pex.run_batch_export).parameters
    ref = inspect.signature(jex.run_batch_export).parameters
    assert list(sig) == [("use_kernel" if n == "use_pallas" else n)
                         for n in ref] + ["device"]
    assert sig["device"].default == "cuda"
    assert list(pex.ExportReport().as_dict()) == list(
        jex.ExportReport().as_dict())


@pytest.mark.parametrize("setup", SETUPS[:3], ids=lambda s: f"{s[0]}-{s[1]}")
def test_batch_develop_u8_equals_jax(setup, rng):
    """``parallel/batch.batch_develop``, the u8 lane, equals the JAX
    function on a batch with per-image edits, WB, matrices and levels
    (measured 0 LSB), and equals the RGBA lane's words unpacked."""
    from raweditor_tpu.parallel.batch import batch_develop as jax_batch
    from raweditor_tpu.parallel.batch import pack_params as jax_pack
    from raweditor_tpu_torch.ops.develop import rgba_view
    from raweditor_tpu_torch.parallel.batch import (batch_develop,
                                                    batch_develop_rgba)

    mode, method, _ = setup
    mosaics = rng.integers(0, 4096, size=(3, 24, 32), dtype=np.uint16)
    edits = [dict(EDITS[i], sharpen=30.0 * i) for i in range(3)]
    wbs = rng.uniform(1.0, 2.2, (3, 3)).astype(np.float32)
    cms = np.stack([np.eye(3, dtype=np.float32), D3300 * 2.0,
                    np.eye(3, dtype=np.float32)])
    levels = dict(white_levels=np.array([4095.0, 4000.0, 4095.0], np.float32),
                  black_levels=np.array([150.0, 0.0, 64.0], np.float32))
    kw = dict(matrix_transpose=mode == "parity", cfa_phase=(1, 0),
              demosaic_method=method, extras="base")
    got = batch_develop(torch.from_numpy(mosaics),
                        [EditParams(**e) for e in edits], wbs, cms,
                        **levels, **kw)
    want = np.asarray(jax_batch(mosaics, jax_pack([JaxParams(**e)
                                                   for e in edits]),
                                wbs, cms, **levels, **kw))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert _lsb(got.numpy(), want) == 0
    words = batch_develop_rgba(torch.from_numpy(mosaics),
                               [EditParams(**e) for e in edits], wbs, cms,
                               **levels, **kw)
    np.testing.assert_array_equal(rgba_view(words)[..., :3], got.numpy())
