"""Clipped-highlight recovery in the port (``ops/highlights.py``, the
engine's ``_render_mosaic`` and the exporter's flush) against the JAX
package on the CPU.

Tolerances: the reconstruction is bit-equal to the JAX function run op
by op (the same f32 operation order, ``round`` half to even in both;
measured: equal on every case). The JAX engine and exporter run it
jitted, and XLA's CPU backend contracts ``a + b * c`` into fused
multiply-adds and turns ``/ 100`` into ``* 0.01``, so the jitted program
is held within 1 LSB of u16 (measured: 1 LSB at 0-3 sites of a frame);
PyTorch, here and on the card, runs every operation on its own.
the engine's renders of a recovered mosaic within 1 LSB of 8-bit output,
the lanes' own tolerance (measured maxima printed); the exporter's
encoder inputs within 1 LSB (measured: 0).
"""

import os

import numpy as np
import pytest
import torch

from raweditor_tpu.ops import highlights as jhl
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.pipeline import export as jex
from raweditor_tpu.pipeline.engine import DevelopEngine as JaxEngine
from raweditor_tpu.raw.types import RawImage as JaxRaw
from raweditor_tpu_torch import DevelopEngine, EditParams, RawImage
from raweditor_tpu_torch.ops import highlights as hl
from raweditor_tpu_torch.pipeline import export as pex
from raweditor_tpu_torch.raw import raf, synth

XTRANS = ("GGRGGB" "GGBGGR" "BRGRBG" "GGBGGR" "GGRGGB" "RBGBRG")
LAYOUTS = {"RGGB": (0, 0), "GRBG": (0, 1), "GBRG": (1, 0), "BGGR": (1, 1),
           "xtrans": None}
WB = np.array([2.0, 1.0, 1.4], np.float32)
WHITE, BLACK = 4095.0, 128.0
D3300 = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                  [-1485, 2204, 7318]], np.float32)
SLIDERS = dict(exposure=-0.4, contrast=6.0, saturation=20.0, vibrance=0.2)


def _frame(rng, kind, h=24, w=36):
    """A u16 mosaic: ``clipped`` has a bright disc over noise (a share of
    every channel at the white level), ``none`` stays below the clip,
    ``all`` is at the white level everywhere."""
    if kind == "all":
        return np.full((h, w), int(WHITE), np.uint16)
    m = rng.integers(int(BLACK), 3000, size=(h, w)).astype(np.uint16)
    if kind == "clipped":
        yy, xx = np.mgrid[0:h, 0:w]
        disc = (yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 3) ** 2
        m[disc] = rng.integers(3850, 4096, size=int(disc.sum()))
    return m


def _magenta(h=16, w=16):
    """The magenta-highlight setup of the JAX package's tests: a bright
    neutral under WB (2, 1, 1.4) clips green first."""
    m = np.zeros((h, w), np.uint16)
    yy, xx = np.mgrid[0:h, 0:w]
    is_r = (yy % 2 == 0) & (xx % 2 == 0)
    is_b = (yy % 2 == 1) & (xx % 2 == 1)
    m[is_r] = int(0.55 * WHITE)
    m[~(is_r | is_b)] = int(WHITE)
    m[is_b] = int(0.77 * WHITE)
    return m


def _layout(name):
    if name == "xtrans":
        return dict(cfa_phase=(0, 0), xtrans_pattern=XTRANS)
    return dict(cfa_phase=LAYOUTS[name], xtrans_pattern=None)


@pytest.mark.parametrize("kind", ["clipped", "none", "all", "magenta"])
@pytest.mark.parametrize("amount", [0.0, 50.0, 100.0])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mosaic_reconstruction_is_bit_equal(layout, amount, kind, rng):
    """Bit-equal to the JAX function op by op, within 1 LSB of u16 of its
    jitted form (the engine's and exporter's), for the four Bayer phases
    and X-Trans."""
    m = _magenta(24, 36) if kind == "magenta" else _frame(rng, kind)
    lay = _layout(layout)
    got = hl.reconstruct_mosaic_highlights(
        torch.from_numpy(m), WB, amount, WHITE, BLACK, **lay)
    assert got.dtype == torch.uint16
    got = got.numpy()
    want = np.asarray(jhl.reconstruct_mosaic_highlights(
        m, WB, amount, WHITE, BLACK, **lay))
    np.testing.assert_array_equal(got, want)
    assert _lsb16(got, jhl._HL_JIT_MOSAIC(m, WB, amount, WHITE, BLACK,
                                          **lay)) <= 1
    if amount == 0.0 or kind == "none":
        np.testing.assert_array_equal(got, m)  # passes through
    elif kind == "clipped" or (kind, layout) == ("magenta", "RGGB"):
        assert (got != m).any()


def _lsb16(got, want):
    """Largest difference in u16 LSB, printed with the differing share."""
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    print(f"against the jitted JAX form: max {d.max()} LSB of u16 at "
          f"{int((d > 0).sum())} sites")
    return int(d.max())


def test_site_channel_masks_match(rng):
    for name in LAYOUTS:
        lay = _layout(name)
        got = hl._site_channel_masks(12, 18, lay["cfa_phase"],
                                     lay["xtrans_pattern"])
        want = jhl._site_channel_masks(12, 18, lay["cfa_phase"],
                                       lay["xtrans_pattern"])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert hl.CLIP_FRACTION == jhl.CLIP_FRACTION


def _linear_frame(rng):
    f = rng.integers(int(BLACK), 3000, size=(20, 28, 3)).astype(np.uint16)
    f[4:12, 6:18, 1] = int(WHITE)                  # green clipped
    f[8:14, 10:20, :] = rng.integers(3930, 4096, size=(6, 10, 3))
    return f


@pytest.mark.parametrize("amount", [0.0, 50.0, 100.0])
def test_linear_reconstruction_is_bit_equal(amount, rng):
    f = _linear_frame(rng)
    got = hl.reconstruct_linear_highlights(torch.from_numpy(f), WB, amount,
                                           WHITE, BLACK).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jhl.reconstruct_linear_highlights(f, WB, amount, WHITE, BLACK)))
    assert _lsb16(got, jhl._HL_JIT_LINEAR(f, WB, amount, WHITE, BLACK)) <= 1


@pytest.mark.parametrize("layout", ["GBRG", "xtrans"])
def test_batch_forms_with_mixed_amounts_are_bit_equal(layout, rng):
    """Per-image amounts, WB and levels; zero-amount images pass through
    bit-exactly."""
    n = 4
    ms = np.stack([_frame(rng, "clipped") for _ in range(n)])
    wbs = np.stack([WB, WB * 1.1, WB[::-1], WB]).astype(np.float32)
    amounts = np.array([0.0, 60.0, 100.0, 0.0], np.float32)
    whites = np.array([4095, 4000, 4095, 3900], np.float32)
    blacks = np.array([128, 0, 64, 128], np.float32)
    lay = _layout(layout)
    got = hl.batch_reconstruct_mosaic(torch.from_numpy(ms), wbs, amounts,
                                      whites, blacks, **lay).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jhl.batch_reconstruct_mosaic(ms, wbs, amounts, whites, blacks,
                                     **lay)))
    assert _lsb16(got, jhl._HL_JIT_BATCH_MOSAIC(ms, wbs, amounts, whites,
                                                blacks, **lay)) <= 1
    np.testing.assert_array_equal(got[[0, 3]], ms[[0, 3]])
    assert (got[[1, 2]] != ms[[1, 2]]).any()
    fs = np.stack([_linear_frame(rng) for _ in range(n)])
    got = hl.batch_reconstruct_linear(torch.from_numpy(fs), wbs, amounts,
                                      whites, blacks).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jhl.batch_reconstruct_linear(fs, wbs, amounts, whites, blacks)))
    assert _lsb16(got, jhl._HL_JIT_BATCH_LINEAR(fs, wbs, amounts, whites,
                                                blacks)) <= 1
    np.testing.assert_array_equal(got[[0, 3]], fs[[0, 3]])


def _raws(rng, pattern, h=48, w=72):
    m = _frame(rng, "clipped", h, w)
    fields = dict(mosaic=m, wb_multipliers=np.array([2.0, 1.0, 1.4, 1.0],
                                                    np.float32),
                  xyz_to_cam=D3300, black_level=BLACK, white_level=WHITE,
                  cfa_pattern=pattern)
    return RawImage(**fields), JaxRaw(**fields)


def _max_diff(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("mode,pattern,method", [
    ("parity", "RGGB", "nearest"), ("accurate", "GRBG", "malvar"),
    ("accurate", "BGGR", "grad"), ("accurate", XTRANS, "grad")],
    ids=["parity", "malvar", "grad", "xtrans"])
def test_engine_renders_the_recovered_mosaic(mode, pattern, method, rng):
    """Preview, histogram and full develop with recovery against the JAX
    engine, within 1 LSB; the white-balance eyedropper reads the
    original mosaic."""
    raw, jraw = _raws(rng, pattern)
    kw = dict(mode=mode, demosaic_method=method, max_preview_width=64,
              histogram_width=32)
    port = DevelopEngine(raw, device="cpu", **kw)
    ref = JaxEngine(jraw, **kw)
    p = EditParams(highlight_recovery=70.0, **SLIDERS)
    jp = JaxParams(highlight_recovery=70.0, **SLIDERS)
    recovered = port._render_mosaic(p).numpy()
    np.testing.assert_array_equal(recovered, np.asarray(
        jhl.reconstruct_mosaic_highlights(
            ref.mosaic, ref.wb, 70.0, ref.white_level, ref.black_level,
            cfa_phase=ref.cfa_phase, xtrans_pattern=ref.xtrans_pattern)))
    assert _lsb16(recovered, ref._render_mosaic(jp)) <= 1
    worst = {}
    for name, got, want in (
            ("tick", port.preview_tick(p).numpy(), ref.preview(jp)),
            ("full", port.full(p), ref.full(jp)),
            ("words", port.full_rgba_device(p).numpy().view(np.uint8),
             np.asarray(ref.full_rgba_device(jp)).view(np.uint8))):
        worst[name] = _max_diff(got, want)
        assert worst[name][0] <= 1, name
    gh, wh = port.histogram(p), ref.histogram(jp)
    assert gh.sum() == wh.sum()
    if worst["tick"][0] == 0:
        np.testing.assert_array_equal(gh, wh)
    print(f"{mode} {method}: {worst}")
    # The recovered full develop differs from the unrecovered one.
    assert not np.array_equal(port.full(p), port.full(
        p.replace(highlight_recovery=0.0)))
    # pick_wb reads the original mosaic, as the JAX engine's does.
    assert port.pick_wb(0.2, 0.8) == pytest.approx(ref.pick_wb(0.2, 0.8))


def test_render_mosaic_cache(rng, monkeypatch):
    """One reconstruction per amount: the same amount is a cache hit, a
    new amount redoes it, amount 0 is the device mosaic itself."""
    raw, _ = _raws(rng, "GBRG")
    port = DevelopEngine(raw, mode="accurate", device="cpu")
    calls = []
    real = hl.reconstruct_mosaic_highlights

    def counted(*a, **k):
        calls.append(a[2])
        return real(*a, **k)

    monkeypatch.setattr(hl, "reconstruct_mosaic_highlights", counted)
    p = EditParams(highlight_recovery=40.0)
    first = port._render_mosaic(p)
    port.preview_tick(p)
    port.full_rgba_device(p)
    assert calls == [40.0] and port._render_mosaic(p) is first
    port.histogram(p.replace(highlight_recovery=80.0))
    assert calls == [40.0, 80.0]
    assert port._render_mosaic(EditParams()) is port.mosaic
    assert port._render_mosaic(p) is not first  # the cache holds one amount
    assert calls == [40.0, 80.0, 40.0]


def test_exporter_mixed_amounts_match_the_jax_exporter(rng, tmp_path,
                                                       monkeypatch):
    """Amounts 0, 60 and 100 mixed in one batch, Bayer and X-Trans
    buckets, with and without the kernels' route: what each exporter
    hands its encoder within 1 LSB, and the engine's export of the same
    job equal to the exporter's file."""
    d = tmp_path / "raw"
    d.mkdir()
    paths = []
    for i in range(3):
        p = d / f"b{i}.dng"
        synth.write_synthetic_raw(
            p, _frame(rng, "clipped", 24, 32), xyz_to_cam=D3300,
            black_level=128, white_level=4095, wb_neutral=(0.5, 1.0, 0.7),
            cfa="GBRG", preview_jpeg=b"")
        paths.append(str(p))
    p = d / "x0.raf"
    p.write_bytes(raf.write_raf(_frame(rng, "clipped", 24, 36), model="X-T2",
                                wb_grbg=(256, 512, 384, 256)))
    paths.append(str(p))
    amounts = [0.0, 60.0, 100.0, 60.0]
    seen = {"port": {}, "jax": {}}
    for pkg, mod in (("port", pex), ("jax", jex)):
        def words(out_path, rgba_words, *a, store=seen[pkg], **k):
            store[os.path.basename(out_path)] = np.ascontiguousarray(
                rgba_words).view(np.uint8)

        monkeypatch.setattr(mod, "_encode_one", words)
    for use_kernel in (False, True):
        port_jobs, ref_jobs = [], []
        for path, amt in zip(paths, amounts):
            name = os.path.splitext(os.path.basename(path))[0] + ".png"
            port_jobs.append(pex.ExportJob(
                path, str(tmp_path / "p" / name),
                EditParams(highlight_recovery=amt, **SLIDERS)))
            ref_jobs.append(jex.ExportJob(
                path, str(tmp_path / "j" / name),
                JaxParams(highlight_recovery=amt, **SLIDERS)))
        rep = pex.run_batch_export(port_jobs, device="cpu", batch_size=3,
                                   mode="accurate", demosaic_method="grad",
                                   use_kernel=use_kernel)
        ref = jex.run_batch_export(ref_jobs, batch_size=3, mode="accurate",
                                   demosaic_method="grad")
        assert rep.succeeded == ref.succeeded == 4, rep.failed
        worst = max(_max_diff(seen["port"][k], seen["jax"][k])[0]
                    for k in seen["jax"])
        print(f"exporter, use_kernel={use_kernel}: max {worst} LSB")
        assert seen["port"].keys() == seen["jax"].keys()
        assert worst <= 1
        # The engine renders the same job to the same pixels.
        eng = DevelopEngine.open(paths[1], mode="accurate", device="cpu",
                                 demosaic_method="grad", use_kernel=use_kernel)
        np.testing.assert_array_equal(
            eng.full_rgba_device(port_jobs[1].params).numpy().view(np.uint8),
            seen["port"]["b1.png"])
