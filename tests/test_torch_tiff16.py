"""16-bit output in the port (``finish_to_u16``, ``develop_u16``,
``develop_xtrans(bits=16)``, ``DevelopEngine.export_tiff16`` and
``run_batch_export(bits=16)``) against the JAX package on the CPU.

Tolerance: 1 LSB of u16 (the transfers' ``pow`` rounds an ulp apart
between XLA and PyTorch on the CPU; measured maxima printed, 1 LSB on
under 0.1% of the samples). A TIFF's bytes outside its pixel strip
(tags, the ICC profile, the layout) are equal to the JAX file's.
"""

import os

import numpy as np
import pytest
import torch

from raweditor_tpu.ops import develop as jd
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.pipeline import export as jex
from raweditor_tpu.pipeline.engine import DevelopEngine as JaxEngine
from raweditor_tpu.raw.types import RawImage as JaxRaw
from raweditor_tpu_torch import DevelopEngine, EditParams, RawImage
from raweditor_tpu_torch.ops import develop as td
from raweditor_tpu_torch.pipeline import export as pex
from raweditor_tpu_torch.raw import raf, synth
from raweditor_tpu_torch.raw import tiff as T

SLIDERS = dict(exposure=0.4, contrast=6.0, highlights=-0.3, shadows=0.2,
               whites=1.05, blacks=0.03, saturation=30.0, vibrance=0.4,
               temperature=0.15, tint=-0.1)
EXTRAS = dict(sharpen=40.0, vignette=-20.0, hue_red=20.0,
              grade_shadow_hue=200.0, grade_shadow_sat=30.0)
D3300 = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                  [-1485, 2204, 7318]], np.float32)
WB = np.array([2.07, 1.0, 1.32], np.float32)
REAL = np.array([[1.6, -0.3, -0.3], [-0.2, 1.5, -0.3], [0.0, -0.4, 1.4]],
                np.float32)
TRANSFERS = ("gamma22", "gamma22_poly", "srgb", "srgb_poly", "gamma_adobe")


def _lsb(got, want, what):
    d = np.abs(np.asarray(got).astype(np.int64)
               - np.asarray(want).astype(np.int64))
    print(f"{what}: max {d.max()} LSB of u16, differing {(d > 0).mean():.2e}")
    return int(d.max())


@pytest.mark.parametrize("transfer", TRANSFERS)
def test_finish_to_u16(transfer, rng):
    """Every transfer against the JAX function; the polynomial ones are
    demoted to their exact curves."""
    planes = [rng.uniform(-0.1, 1.2, (16, 24)).astype(np.float32)
              for _ in range(3)]
    got = td.finish_to_u16(*(torch.from_numpy(p) for p in planes),
                           transfer=transfer)
    want = jd.finish_to_u16(*planes, transfer=transfer)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint16
        assert _lsb(g.numpy(), w, f"finish_to_u16 {transfer}") <= 1
    if transfer.endswith("_poly"):
        exact = td.finish_to_u16(*(torch.from_numpy(p) for p in planes),
                                 transfer=transfer[:-5])
        for g, e in zip(got, exact):
            assert torch.equal(g, e)


@pytest.mark.parametrize("method", ["nearest", "bilinear", "malvar", "grad"])
def test_develop_u16(method, rng):
    m = rng.integers(0, 4096, size=(24, 36), dtype=np.uint16)
    for edit in (SLIDERS, dict(SLIDERS, **EXTRAS)):
        p, jp = EditParams(**edit), JaxParams(**edit)
        mode = p.finish_extras_mode()
        got = td.develop_u16(torch.from_numpy(m), p, WB, REAL,
                             white_level=4000.0, black_level=128.0,
                             demosaic_method=method, matrix_transpose=False,
                             transfer="srgb", cfa_phase=(1, 0), extras=mode)
        want = jd.develop_u16(m, jp, WB, REAL, white_level=4000.0,
                              black_level=128.0, demosaic_method=method,
                              matrix_transpose=False, transfer="srgb",
                              cfa_phase=(1, 0), extras=mode)
        assert got.shape == (24, 36, 3) and got.dtype == torch.uint16
        assert _lsb(got.numpy(), want,
                    f"develop_u16 {method} extras={mode}") <= 1


@pytest.mark.parametrize("method", ["nearest", "smooth", "grad"])
def test_develop_xtrans_bits16(method, rng):
    m = rng.integers(0, 4096, size=(24, 36), dtype=np.uint16)
    p, jp = EditParams(**SLIDERS), JaxParams(**SLIDERS)
    got = td.develop_xtrans(torch.from_numpy(m), p, WB, REAL, 4000.0, 128.0,
                            transfer="srgb", demosaic_method=method, bits=16)
    want = jd.develop_xtrans(m, jp, WB, REAL, 4000.0, 128.0, transfer="srgb",
                             demosaic_method=method, bits=16)
    assert got.dtype == torch.uint16
    assert _lsb(got.numpy(), want, f"develop_xtrans bits=16 {method}") <= 1


def _split(data):
    """(pixels (H, W, 3) u16, the file's other bytes) of a 16-bit TIFF."""
    ifd = T.TiffFile(data).ifds[0]
    off = ifd.get_scalar(T.STRIP_OFFSETS)
    h, w = ifd.get_scalar(T.IMAGE_LENGTH), ifd.get_scalar(T.IMAGE_WIDTH)
    n = h * w * 6
    return (np.frombuffer(data[off:off + n], "<u2").reshape(h, w, 3),
            data[:off] + data[off + n:])


def _same_tiff(got_path, want_path, what):
    got, want = (_split(open(p, "rb").read()) for p in (got_path, want_path))
    assert got[1] == want[1]  # tags, profile, layout
    assert got[0].shape == want[0].shape
    return _lsb(got[0], want[0], what)


@pytest.mark.parametrize("case", [
    ("parity", "nearest", "RGGB", 1, "srgb", {}),
    ("accurate", "grad", "GBRG", 6, "srgb", dict(auto_orient=True)),
    ("accurate", "malvar", "BGGR", 8, "display-p3", dict(fast_gamma=True)),
    ("accurate", "bilinear", "GRBG", 3, "adobe-rgb", dict(auto_orient=True)),
    ("accurate", "grad", "xtrans", 1, "display-p3", {})],
    ids=["parity", "grad-orient6", "p3-fast", "adobe-orient3", "xtrans-p3"])
def test_export_tiff16_equals_the_jax_engine(case, rng, tmp_path):
    """``export(".tif")`` (and ``export_tiff16``): pixels within 1 LSB,
    every other byte equal: make, model, orientation, software and the
    ICC profile; auto-orient rotates the pixels."""
    mode, method, pattern, orientation, space, kw = case
    if pattern == "xtrans":
        pattern = ("GGRGGB" "GGBGGR" "BRGRBG" "GGBGGR" "GGRGGB" "RBGBRG")
    fields = dict(mosaic=rng.integers(0, 4096, size=(24, 36),
                                      dtype=np.uint16),
                  wb_multipliers=np.array([2.1, 1.0, 1.4, 1.0], np.float32),
                  xyz_to_cam=D3300, black_level=128.0, white_level=4000.0,
                  cfa_pattern=pattern, orientation=orientation,
                  camera_make="NIKON CORPORATION", camera_model="NIKON D3300")
    kw = dict(kw, mode=mode, demosaic_method=method, color_space=space)
    port = DevelopEngine(RawImage(**fields), device="cpu", use_kernel=True,
                         **kw)
    ref = JaxEngine(JaxRaw(**fields), **kw)
    edit = dict(SLIDERS, highlight_recovery=40.0, **EXTRAS)
    assert port.export(tmp_path / "p.tif", EditParams(**edit)) == str(
        tmp_path / "p.tif")
    ref.export(tmp_path / "j.tif", JaxParams(**edit))
    assert _same_tiff(tmp_path / "p.tif", tmp_path / "j.tif",
                      f"export .tif {case[:5]}") <= 1
    port.export_tiff16(tmp_path / "q.tiff", EditParams(**edit))
    assert (tmp_path / "q.tiff").read_bytes() == (
        tmp_path / "p.tif").read_bytes()
    pix = _split((tmp_path / "p.tif").read_bytes())[0]
    rotated = kw.get("auto_orient") and orientation in (6, 8)
    assert pix.shape[:2] == ((36, 24) if rotated else (24, 36))
    # The long edge is ported: the JAX engine's resized TIFF.
    port.export_tiff16(tmp_path / "r.tif", EditParams(), long_edge=16)
    ref.export_tiff16(tmp_path / "rj.tif", JaxParams(), long_edge=16)
    assert _same_tiff(tmp_path / "r.tif", tmp_path / "rj.tif",
                      f"long_edge 16 {case[:5]}") <= 1
    pix = _split((tmp_path / "r.tif").read_bytes())[0]
    assert max(pix.shape[:2]) == 16


def test_batch_export_bits16_equals_the_jax_exporter(rng, tmp_path):
    """``run_batch_export(bits=16)`` over Bayer and X-Trans files, with a
    colour space, highlight recovery and extras: each TIFF within 1 LSB
    of the JAX exporter's, every other byte equal; the engine's export of
    the same job is the exporter's file, byte for byte."""
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
    p = d / "x0.raf"
    p.write_bytes(raf.write_raf(
        rng.integers(0, 4096, size=(24, 36), dtype=np.uint16), model="X-T2",
        wb_grbg=(256, 512, 384, 256)))
    paths.append(str(p))
    edits = [dict(SLIDERS), dict(SLIDERS, highlight_recovery=60.0),
             dict(SLIDERS, **EXTRAS), {}]
    for space, use_kernel in (("srgb", True), ("adobe-rgb", False)):
        port_jobs, ref_jobs = [], []
        for path, edit in zip(paths, edits):
            name = os.path.splitext(os.path.basename(path))[0] + ".tif"
            port_jobs.append(pex.ExportJob(path, str(tmp_path / space / "p"
                                                     / name),
                                           EditParams(**edit)))
            ref_jobs.append(jex.ExportJob(path, str(tmp_path / space / "j"
                                                    / name),
                                          JaxParams(**edit)))
        kw = dict(batch_size=2, mode="accurate", demosaic_method="grad",
                  bits=16, color_space=space, fast_gamma=True)
        rep = pex.run_batch_export(port_jobs, device="cpu",
                                   use_kernel=use_kernel, **kw)
        ref = jex.run_batch_export(ref_jobs, **kw)
        assert rep.succeeded == ref.succeeded == 4, rep.failed
        assert rep.fetch_bytes == ref.fetch_bytes
        for a, b in zip(port_jobs, ref_jobs):
            assert _same_tiff(a.out_path, b.out_path,
                              f"bits=16 {space} {a.out_path[-6:]}") <= 1
        eng = DevelopEngine.open(paths[1], mode="accurate", device="cpu",
                                 demosaic_method="grad", color_space=space,
                                 fast_gamma=True, use_kernel=use_kernel)
        eng.export(tmp_path / space / "e.tif", port_jobs[1].params)
        assert (tmp_path / space / "e.tif").read_bytes() == open(
            port_jobs[1].out_path, "rb").read()
    with pytest.raises(ValueError, match="16-bit"):
        pex._encode_one_tiff16(str(tmp_path / "x.jpg"),
                               np.zeros((2, 2, 3), np.uint16))
