"""The port's CUDA kernels on the card, against their plain PyTorch
versions and the CPU lane. Marked ``cuda``; skipped where torch sees no
CUDA device. This file imports no jax, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from raweditor_tpu_torch import DevelopEngine, EditParams, RawImage
from raweditor_tpu_torch.ops import _build
from raweditor_tpu_torch.ops import fused_develop as fd
from raweditor_tpu_torch.ops import fused_extras as fx
from raweditor_tpu_torch.ops import fused_linear as fl
from raweditor_tpu_torch.ops.develop import _SLIDERS, unpack_rgba
from raweditor_tpu_torch.ops.jpeg import rgba_words_to_ycbcr420
from raweditor_tpu_torch.parallel.batch import (batch_develop_linear_rgba,
                                                pack_params)

pytestmark = pytest.mark.cuda

FULL = EditParams(exposure=0.6, contrast=8.0, highlights=-0.4, shadows=0.3,
                  whites=1.05, blacks=0.04, saturation=25.0, vibrance=0.5,
                  temperature=0.2, tint=-0.1)
REAL = np.array([[1.6, -0.3, -0.3], [-0.2, 1.5, -0.3], [0.0, -0.4, 1.4]],
                np.float32)


@pytest.fixture
def rng():
    # tests/conftest.py has the same fixture, but imports jax: this file
    # runs without it on the card's machine.
    return np.random.default_rng(1234)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _words_diff(a, b):
    return max(int((x - y).abs().max())
               for x, y in zip(unpack_rgba(a.cpu()), unpack_rgba(b.cpu())))


def _inputs(rng, n, h, w, dev):
    mos = torch.from_numpy(rng.integers(0, 4096, (n, h, w), dtype=np.uint16))
    wbs = rng.uniform(1.0, 2.2, (n, 3)).astype(np.float32)
    cms = np.stack([REAL if i % 2 else np.eye(3, dtype=np.float32)
                    for i in range(n)])
    params = [FULL, EditParams(), FULL.replace(exposure=-1.0)]
    scal = pack_params([params[i % 3] for i in range(n)], wbs, cms,
                       rng.uniform(3800, 4096, n), rng.uniform(0, 200, n))
    return mos.to(dev), scal.to(dev)


@pytest.mark.parametrize("gamma", sorted(fd.GAMMAS))
@pytest.mark.parametrize("shape", [(3, 64, 96), (2, 31, 45), (1, 1, 1),
                                   (1, 2, 3)])
def test_rgba_kernel_matches_plain(cuda, gamma, shape, rng):
    mos, scal = _inputs(rng, *shape, cuda)
    for phase in ((0, 0), (0, 1), (1, 0), (1, 1)):
        before = fd.LAUNCHES["develop_rgba"]
        got = fd.fused_batch_develop_rgba(mos, scal, phase, gamma)
        assert fd.LAUNCHES["develop_rgba"] == before + 1
        want = fd.develop_rgba_folded_plain(mos, scal, phase, gamma)
        torch.cuda.synchronize()
        assert got.dtype == torch.uint32 and got.shape == mos.shape
        assert _words_diff(got, want) == 0
        # and against the plain version on the CPU (an ulp apart: 1 LSB)
        cpu = fd.fused_batch_develop_rgba(mos.cpu(), scal.cpu(), phase, gamma)
        assert _words_diff(got, cpu) <= 1


@pytest.mark.parametrize("gamma", sorted(fd.GAMMAS))
def test_ycbcr420_kernel_matches_plain(cuda, gamma, rng):
    mos, scal = _inputs(rng, 3, 48, 70, cuda)
    before = fd.LAUNCHES["develop_ycbcr420"]
    y, cbcr = fd.fused_batch_develop_rgba(mos, scal, (1, 0), gamma,
                                          output="ycbcr420")
    assert fd.LAUNCHES["develop_ycbcr420"] == before + 1
    wy, wc = fd.develop_rgba_folded_plain(mos, scal, (1, 0), gamma,
                                          output="ycbcr420")
    torch.cuda.synchronize()
    assert y.shape == (3, 48, 70) and cbcr.shape == (3, 24, 70)
    assert torch.equal(y, wy) and torch.equal(cbcr, wc)


def test_kernel_rejects_bad_inputs(cuda, rng):
    mos, scal = _inputs(rng, 2, 8, 10, cuda)
    for args, kw in (((mos.to(torch.int32), scal), {}),
                     ((mos, scal.cpu()), {}),
                     ((mos[:, :, ::2], scal), {}),
                     ((mos[:, :7].contiguous(), scal), {"output": "ycbcr420"})):
        with pytest.raises((TypeError, ValueError)):
            fd.fused_batch_develop_rgba(*args, **kw)


@pytest.mark.parametrize("mode", ["parity", "accurate"])
def test_engine_on_card_matches_cpu(cuda, mode, rng):
    raw = RawImage(rng.integers(0, 4096, (96, 144), dtype=np.uint16),
                   np.array([2.0, 1.0, 1.5, 1.0], np.float32), REAL * 10000,
                   black_level=100.0, white_level=4000.0, cfa_pattern="GBRG")
    kw = dict(mode=mode, use_kernel=True, max_preview_width=64,
              histogram_width=32)
    gpu, cpu = DevelopEngine(raw, device=cuda, **kw), DevelopEngine(
        raw, device="cpu", **kw)
    for zoom, pan in ((1.0, (0.0, 0.0)), (2.5, (0.1, -0.05))):
        a = gpu.preview_tick(FULL, zoom, pan).cpu().numpy().astype(int)
        b = cpu.preview_tick(FULL, zoom, pan).numpy().astype(int)
        assert np.abs(a - b).max() <= 1
        assert gpu.histogram(FULL, zoom, pan).sum() == 3 * 32 * gpu.histogram_h
    before = fd.LAUNCHES["develop_rgba"]
    words = gpu.full_rgba_device(FULL)
    assert fd.LAUNCHES["develop_rgba"] == before + 1
    assert _words_diff(words, cpu.full_rgba_device(FULL)) <= 1
    gpu.use_kernel = False
    assert _words_diff(words, gpu.full_rgba_device(FULL)) <= 1


ACCURATE = ("bilinear", "malvar", "grad")
PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))


@pytest.mark.parametrize("demosaic", ACCURATE)
@pytest.mark.parametrize("gamma", sorted(fd.GAMMAS))
@pytest.mark.parametrize("shape", [(3, 64, 96), (2, 31, 45), (1, 1, 1),
                                   (1, 2, 3), (1, 3, 5), (1, 32, 48),
                                   (1, 250, 32), (1, 32, 128),
                                   (2, 100, 166)])
def test_accurate_rgba_kernel_matches_plain(cuda, demosaic, gamma, shape,
                                            rng):
    mos, scal = _inputs(rng, *shape, cuda)
    key = fd.launch_key("rgba", demosaic)
    for phase in PHASES:
        before = fd.LAUNCHES[key]
        got = fd.fused_batch_develop_rgba(mos, scal, phase, gamma,
                                          demosaic=demosaic)
        assert fd.LAUNCHES[key] == before + 1
        want = fd.develop_rgba_folded_plain(mos, scal, phase, gamma,
                                            demosaic=demosaic)
        torch.cuda.synchronize()
        assert got.dtype == torch.uint32 and got.shape == mos.shape
        assert _words_diff(got, want) == 0
        cpu = fd.fused_batch_develop_rgba(mos.cpu(), scal.cpu(), phase, gamma,
                                          demosaic=demosaic)
        assert _words_diff(got, cpu) <= 1


@pytest.mark.parametrize("demosaic", ACCURATE)
@pytest.mark.parametrize("gamma", sorted(fd.GAMMAS))
def test_accurate_ycbcr420_kernel_matches_plain(cuda, demosaic, gamma, rng):
    mos, scal = _inputs(rng, 3, 48, 70, cuda)
    key = fd.launch_key("ycbcr420", demosaic)
    for phase in PHASES:
        before = fd.LAUNCHES[key]
        y, cbcr = fd.fused_batch_develop_rgba(mos, scal, phase, gamma,
                                              output="ycbcr420",
                                              demosaic=demosaic)
        assert fd.LAUNCHES[key] == before + 1
        wy, wc = fd.develop_rgba_folded_plain(mos, scal, phase, gamma,
                                              output="ycbcr420",
                                              demosaic=demosaic)
        torch.cuda.synchronize()
        assert y.shape == (3, 48, 70) and cbcr.shape == (3, 24, 70)
        assert torch.equal(y, wy) and torch.equal(cbcr, wc), phase


def test_malvar_floor_on_card(cuda, rng):
    """Hard edges around the R sites push the Malvar correction below
    the black level; the kernel floors at the folded black sc[19]."""
    m = rng.integers(200, 4096, (1, 32, 48), dtype=np.uint16)
    m[:, ::2, ::2] = 200
    scal = pack_params([EditParams()], np.ones((1, 3), np.float32),
                       REAL[None], [4000.0], [200.0])
    mos = torch.from_numpy(m).to(cuda)
    got = fd.fused_batch_develop_rgba(mos, scal.to(cuda), gamma="srgb",
                                      demosaic="malvar")
    want = fd.develop_rgba_folded_plain(mos.cpu(), scal, gamma="srgb",
                                        demosaic="malvar")
    assert _words_diff(got, want) <= 1


@pytest.mark.parametrize("demosaic", ACCURATE)
def test_accurate_engine_on_card_matches_cpu(cuda, demosaic, rng):
    raw = RawImage(rng.integers(0, 4096, (96, 144), dtype=np.uint16),
                   np.array([2.0, 1.0, 1.5, 1.0], np.float32), REAL * 10000,
                   black_level=100.0, white_level=4000.0, cfa_pattern="GRBG",
                   black_per_site=np.array([[98.0, 102.0], [101.0, 99.0]],
                                           np.float32))
    kw = dict(mode="accurate", use_kernel=True, transfer="srgb",
              demosaic_method=demosaic, max_preview_width=64,
              histogram_width=32)
    gpu, cpu = DevelopEngine(raw, device=cuda, **kw), DevelopEngine(
        raw, device="cpu", **kw)
    key = fd.launch_key("rgba", demosaic)
    before = fd.LAUNCHES[key]
    words = gpu.full_rgba_device(FULL)
    assert fd.LAUNCHES[key] == before + 1
    assert _words_diff(words, cpu.full_rgba_device(FULL)) <= 1
    for g, c in zip(gpu.jpeg_planes(FULL), cpu.jpeg_planes(FULL)):
        assert int((g.cpu().int() - c.int()).abs().max()) <= 1
    gpu.use_kernel = False
    assert _words_diff(words, gpu.full_rgba_device(FULL)) <= 1


# -- the finish-extras kernel (B8) ---------------------------------------------

EXTRA = EditParams(sharpen=60.0, denoise=40.0, curve_shadows=30.0,
                   curve_darks=-20.0, curve_lights=15.0,
                   curve_highlights=-40.0, vignette=-30.0, hue_red=25.0,
                   hue_blue=-40.0, sat_orange=30.0, sat_green=-50.0,
                   lum_yellow=40.0, lum_purple=-35.0, grade_shadow_hue=210.0,
                   grade_shadow_sat=40.0, grade_high_hue=45.0,
                   grade_high_sat=30.0, grade_balance=-20.0)
# Per-image amounts: one image with every amount at zero, one with
# other sliders (the mixer off there).
EXTRA_BATCH = [EXTRA, EditParams(),
               EditParams(sharpen=100.0, vignette=70.0, curve_lights=-60.0,
                          grade_mid_hue=120.0, grade_mid_sat=-50.0)]
FLAGS = [(m, g, s) for m in (False, True) for g in (False, True)
         for s in (False, True)]


def _extras_inputs(rng, n, h, w, dev):
    words = (rng.integers(0, 2**24, (n, h, w)).astype(np.uint32)
             | np.uint32(0xFF000000))
    tw = torch.from_numpy(words.view(np.int32)).view(torch.uint32)
    table, *_ = fx.pack_extras([EXTRA_BATCH[i % 3] for i in range(n)])
    return tw.to(dev), table.to(dev)


def _share(a, b):
    d = torch.stack([(x - y).abs() for x, y in zip(unpack_rgba(a.cpu()),
                                                   unpack_rgba(b.cpu()))])
    return int(d.max()), float((d.amax(0) > 0).float().mean())


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "mgs" + "".join(
    str(int(x)) for x in f))
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 33, 17), (2, 100, 166),
                                   (1, 256, 384), (3, 5, 7)])
def test_extras_rgba_kernel_matches_plain(cuda, flags, shape, rng):
    """Strips and bands at the edge and inside, every flag set, per-image
    amounts: 0 LSB from the plain version on the card (same f32 operations,
    -fmad=false); 1 LSB from the plain version on the CPU, whose exp2
    differs by an ulp."""
    words, table = _extras_inputs(rng, *shape, cuda)
    kw = dict(zip(("mixer_on", "grading_on", "stencils"), flags))
    before = fx.LAUNCHES["extras_rgba"]
    got = fx.fused_finish_extras_rgba(words, table, **kw)
    assert fx.LAUNCHES["extras_rgba"] == before + 1
    want = fx.finish_extras_plain(words, table, *flags)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint32 and got.shape == words.shape
    mx, share = _share(got, want)
    assert mx == 0, f"max {mx} LSB, differing {share:.2e}"
    cpu = fx.fused_finish_extras_rgba(words.cpu(), table.cpu(), **kw)
    assert _share(got, cpu)[0] <= 1


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "mgs" + "".join(
    str(int(x)) for x in f))
@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 34, 18), (2, 100, 166),
                                   (1, 256, 384)])
def test_extras_ycbcr420_kernel_matches_plain(cuda, flags, shape, rng):
    words, table = _extras_inputs(rng, *shape, cuda)
    kw = dict(zip(("mixer_on", "grading_on", "stencils"), flags))
    before = fx.LAUNCHES["extras_ycbcr420"]
    y, cbcr = fx.fused_finish_extras_rgba(words, table, output="ycbcr420",
                                          **kw)
    assert fx.LAUNCHES["extras_ycbcr420"] == before + 1
    wy, wc = fx.finish_extras_plain(words, table, *flags, output="ycbcr420")
    torch.cuda.synchronize()
    n, h, w = shape
    assert y.shape == (n, h, w) and cbcr.shape == (n, h // 2, w)
    assert torch.equal(y, wy) and torch.equal(cbcr, wc)


def test_extras_kernel_rejects_and_raises(cuda, rng, monkeypatch):
    """Bad inputs raise before a launch; a launch error raises (no
    fallback to the plain version) and is not counted."""
    words, table = _extras_inputs(rng, 2, 8, 10, cuda)
    kw = dict(mixer_on=True, grading_on=True, stencils=True)
    for args, extra in (((words.to(torch.int32), table), {}),
                        ((words, table.cpu()), {}),
                        ((words, table[:1].contiguous()), {}),
                        ((words[:, :7].contiguous(), table),
                         {"output": "ycbcr420"})):
        with pytest.raises((TypeError, ValueError)):
            fx.fused_finish_extras_rgba(*args, **kw, **extra)

    class Failing:
        def rtt_extras_launch(self, *a):
            return 700

        def rtt_error_string(self, code):
            return b"an illegal memory access was encountered"

    monkeypatch.setattr(_build, "load", lambda: Failing())
    before = dict(fx.LAUNCHES)
    with pytest.raises(RuntimeError, match="extras kernel"):
        fx.fused_finish_extras_rgba(words, table, **kw)
    assert fx.LAUNCHES == before


def test_extras_engine_on_card(cuda, rng):
    """The engine's extras route on the card: develop kernel then B8;
    a point curve keeps the develop on the plain lane and B8 after it;
    every result within 1 LSB of the same engine on the CPU."""
    raw = RawImage(rng.integers(0, 4096, (96, 144), dtype=np.uint16),
                   np.array([2.0, 1.0, 1.5, 1.0], np.float32), REAL * 10000,
                   black_level=100.0, white_level=4000.0, cfa_pattern="RGGB")
    kw = dict(mode="accurate", use_kernel=True, transfer="srgb",
              demosaic_method="malvar", max_preview_width=64,
              histogram_width=32)
    gpu, cpu = DevelopEngine(raw, device=cuda, **kw), DevelopEngine(
        raw, device="cpu", **kw)
    p = FULL.replace(**{k: getattr(EXTRA, k) for k in fx.EXTRAS_COLUMNS})
    a = gpu.preview_tick(p, 1.5, (0.05, 0.0)).cpu().numpy().astype(int)
    b = cpu.preview_tick(p, 1.5, (0.05, 0.0)).numpy().astype(int)
    assert np.abs(a - b).max() <= 1
    assert gpu.histogram(p).sum() == 3 * 32 * gpu.histogram_h
    dev_key = fd.launch_key("rgba", "malvar")
    before = dict(fd.LAUNCHES), dict(fx.LAUNCHES)
    words = gpu.full_rgba_device(p)
    assert fd.LAUNCHES[dev_key] == before[0][dev_key] + 1
    assert fx.LAUNCHES["extras_rgba"] == before[1]["extras_rgba"] + 1
    assert _words_diff(words, cpu.full_rgba_device(p)) <= 1
    for g, c in zip(gpu.jpeg_planes(p), cpu.jpeg_planes(p)):
        assert int((g.cpu().int() - c.int()).abs().max()) <= 1
    assert fx.LAUNCHES["extras_ycbcr420"] == before[1]["extras_ycbcr420"] + 1
    pc = p.replace(point_curve=((0.0, 0.0), (0.4, 0.5), (1.0, 1.0)))
    before = dict(fd.LAUNCHES), dict(fx.LAUNCHES)
    words = gpu.full_rgba_device(pc)
    assert fd.LAUNCHES == before[0]
    assert fx.LAUNCHES["extras_rgba"] == before[1]["extras_rgba"] + 1
    assert _words_diff(words, cpu.full_rgba_device(pc)) <= 1
    gpu.use_kernel = False
    assert _words_diff(words, gpu.full_rgba_device(pc)) <= 1


# -- the generic-CFA (X-Trans) kernels B5, B6, B7 ------------------------------

XTRANS = fd.cfa_generic.XTRANS_PATTERN
CFA = tuple(fd.CFA_DEMOSAICS)
# Around the 32x16 tile, the 2x2 quad and the 6x6 period; odd and tiny.
CFA_SHAPES = [(3, 64, 96), (2, 31, 45), (1, 1, 1), (1, 2, 3), (1, 3, 5),
              (1, 6, 6), (1, 7, 13), (1, 36, 48), (1, 250, 32), (1, 32, 128),
              (2, 100, 166), (1, 17, 33)]


@pytest.mark.parametrize("demosaic", CFA)
@pytest.mark.parametrize("gamma", sorted(fd.GAMMAS))
@pytest.mark.parametrize("shape", CFA_SHAPES)
def test_cfa_rgba_kernel_matches_plain(cuda, demosaic, gamma, shape, rng):
    """0 LSB expected (the same f32 operations in the same order), 1
    allowed; per-image scalars in the batches."""
    mos, scal = _inputs(rng, *shape, cuda)
    key = fd.launch_key("rgba", demosaic, XTRANS)
    before = fd.LAUNCHES[key]
    got = fd.fused_batch_develop_rgba(mos, scal, gamma=gamma,
                                      demosaic=demosaic, pattern=XTRANS)
    assert fd.LAUNCHES[key] == before + 1
    want = fd.develop_rgba_folded_plain(mos, scal, gamma=gamma,
                                        demosaic=demosaic, pattern=XTRANS)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint32 and got.shape == mos.shape
    mx, share = _share(got, want)
    print(f"cfa {demosaic} {gamma} {shape}: max {mx} LSB, differing "
          f"{share:.2e}")
    assert mx <= 1
    cpu = fd.fused_batch_develop_rgba(mos.cpu(), scal.cpu(), gamma=gamma,
                                      demosaic=demosaic, pattern=XTRANS)
    assert _words_diff(got, cpu) <= 1


@pytest.mark.parametrize("demosaic", CFA)
@pytest.mark.parametrize("gamma", sorted(fd.GAMMAS))
@pytest.mark.parametrize("shape", [(3, 48, 70), (1, 2, 2), (2, 34, 18)])
def test_cfa_ycbcr420_kernel_matches_plain(cuda, demosaic, gamma, shape, rng):
    mos, scal = _inputs(rng, *shape, cuda)
    key = fd.launch_key("ycbcr420", demosaic, XTRANS)
    before = fd.LAUNCHES[key]
    y, cbcr = fd.fused_batch_develop_rgba(mos, scal, gamma=gamma,
                                          output="ycbcr420",
                                          demosaic=demosaic, pattern=XTRANS)
    assert fd.LAUNCHES[key] == before + 1
    wy, wc = fd.develop_rgba_folded_plain(mos, scal, gamma=gamma,
                                          output="ycbcr420",
                                          demosaic=demosaic, pattern=XTRANS)
    torch.cuda.synchronize()
    n, h, w = shape
    assert y.shape == (n, h, w) and cbcr.shape == (n, h // 2, w)
    for g, wnt in ((y, wy), (cbcr, wc)):
        assert int((g.int() - wnt.int()).abs().max()) <= 1


@pytest.mark.parametrize("pattern", ["RGGB", "GBRG", "RGBGBRBRG"])
def test_cfa_kernels_take_other_periods(cuda, pattern, rng):
    """Periods 2 and 3 through the same kernels and tables, the grad
    kernel on its generic march; on a 2x2 pattern the smooth tier is the
    Bayer bilinear kernel's result."""
    assert fd.cfa_tables("RGBGBRBRG").taps is not None
    assert not fd.period6_march(pattern)
    six = dict(fd.PERIOD6_LAUNCHES)
    mos, scal = _inputs(rng, 2, 37, 53, cuda)
    for demosaic in CFA:
        if demosaic == "nearest" and fd.cfa_tables(pattern).taps is None:
            # A Bayer grid's nearest B of an R site lies on the diagonal,
            # which is not one of the kernel's five taps.
            with pytest.raises(ValueError, match="offset"):
                fd.fused_batch_develop_rgba(mos, scal, demosaic=demosaic,
                                            pattern=pattern)
            continue
        got = fd.fused_batch_develop_rgba(mos, scal, gamma="srgb",
                                          demosaic=demosaic, pattern=pattern)
        want = fd.develop_rgba_folded_plain(mos, scal, gamma="srgb",
                                            demosaic=demosaic,
                                            pattern=pattern)
        assert _words_diff(got, want) <= 1
    assert fd.PERIOD6_LAUNCHES == six
    if len(pattern) == 4:
        from raweditor_tpu_torch.ops.demosaic import phase_of

        bayer = fd.fused_batch_develop_rgba(mos, scal, phase_of(pattern),
                                            "srgb", demosaic="bilinear")
        smooth = fd.fused_batch_develop_rgba(mos, scal, gamma="srgb",
                                             demosaic="smooth",
                                             pattern=pattern)
        assert _words_diff(bayer, smooth) <= 1


def test_cfa_kernel_rejects_and_raises(cuda, rng, monkeypatch):
    """Bad arguments raise before a launch; a launch error raises (no
    fallback to the plain version) and is not counted."""
    mos, scal = _inputs(rng, 2, 12, 18, cuda)
    for kw in ({"demosaic": "malvar"}, {"demosaic": "smooth", "pattern": None},
               {"demosaic": "smooth", "pattern": "RGGG" "GGGG" "GGGB" "GGGG"},
               {"pattern": "RGBRGB"}, {"pattern": "RGBGRBG" * 7}):
        with pytest.raises(ValueError):
            fd.fused_batch_develop_rgba(mos, scal, **{"pattern": XTRANS, **kw})

    class Failing:
        def rtt_develop_cfa_launch(self, *a):
            return 700

        rtt_develop_grad_cfa_launch = rtt_develop_cfa_launch

        def rtt_error_string(self, code):
            return b"an illegal memory access was encountered"

    monkeypatch.setattr(_build, "load", lambda: Failing())
    before = dict(fd.LAUNCHES)
    for demosaic in CFA:
        with pytest.raises(RuntimeError, match="generic-CFA develop kernel"):
            fd.fused_batch_develop_rgba(mos, scal, demosaic=demosaic,
                                        pattern=XTRANS)
    assert fd.LAUNCHES == before


@pytest.mark.parametrize("method", ["nearest", "malvar", "grad"])
def test_xtrans_engine_on_card_matches_cpu(cuda, method, rng):
    """An accurate-mode X-Trans frame: every entry point launches the
    tier's kernel and stays within 1 LSB of the CPU engine and of the
    plain lane on the card."""
    raw = RawImage(rng.integers(0, 4096, (96, 150), dtype=np.uint16),
                   np.array([2.0, 1.0, 1.5, 1.0], np.float32), REAL * 10000,
                   black_level=100.0, white_level=4000.0, cfa_pattern=XTRANS)
    kw = dict(mode="accurate", use_kernel=True, transfer="srgb",
              demosaic_method=method, max_preview_width=64,
              histogram_width=32)
    gpu, cpu = DevelopEngine(raw, device=cuda, **kw), DevelopEngine(
        raw, device="cpu", **kw)
    tier = fd.cfa_generic.generic_cfa_method(method)
    for zoom, pan in ((1.0, (0.0, 0.0)), (2.5, (0.1, -0.05))):
        a = gpu.preview_tick(FULL, zoom, pan).cpu().numpy().astype(int)
        b = cpu.preview_tick(FULL, zoom, pan).numpy().astype(int)
        assert np.abs(a - b).max() <= 1
        assert gpu.histogram(FULL, zoom, pan).sum() == 3 * 32 * gpu.histogram_h
    before = dict(fd.LAUNCHES)
    words = gpu.full_rgba_device(FULL)
    planes = gpu.jpeg_planes(FULL)
    for out in ("rgba", "ycbcr420"):
        key = fd.launch_key(out, tier, XTRANS)
        assert fd.LAUNCHES[key] == before[key] + 1
    assert _words_diff(words, cpu.full_rgba_device(FULL)) <= 1
    for g, c in zip(planes, cpu.jpeg_planes(FULL)):
        assert int((g.cpu().int() - c.int()).abs().max()) <= 1
    p = FULL.replace(**{k: getattr(EXTRA, k) for k in fx.EXTRAS_COLUMNS})
    before = dict(fd.LAUNCHES), dict(fx.LAUNCHES)
    gpu.full_rgba_device(p)
    key = fd.launch_key("rgba", tier, XTRANS)
    assert fd.LAUNCHES[key] == before[0][key] + 1
    assert fx.LAUNCHES["extras_rgba"] == before[1]["extras_rgba"] + 1
    gpu.use_kernel = False
    assert _words_diff(words, gpu.full_rgba_device(FULL)) <= 1


# -- the grad kernels' strips and bands (B4, B7) -------------------------------

# A warp of the grad kernels marches down a strip of 56 output columns (64
# with its halo) in bands of 64 rows. Sizes one below, at and one above
# each edge and their doubles, and frames narrower or shorter than one
# strip or band; always a batch of three with per-image scalars. The
# 400x172 frame has interior bands (neither image edge) starting at rows
# 64, 128, 192, 256 and 320, at cell rows 4, 2, 0, 4, 2 of a 6x6 period,
# and interior strips; the X-Trans grid shifted by a row and a column
# puts those starts at the odd cell rows.
GRAD_EDGE_RGBA = [(63, 55), (64, 56), (65, 57), (127, 111), (128, 112),
                  (129, 113), (9, 7), (64, 113), (129, 56), (65, 7), (1, 57),
                  (128, 1), (400, 172)]
GRAD_EDGE_PLANES = [(2, 2), (62, 54), (64, 56), (66, 58), (128, 112),
                    (130, 114), (400, 172)]


def _shifted(pattern, dy, dx):
    side = int(len(pattern) ** 0.5)
    return "".join(pattern[((y + dy) % side) * side + (x + dx) % side]
                   for y in range(side) for x in range(side))


# 6x6 patterns beside the X-Trans grid: one the period-6 march takes (a
# stage-2 denominator of 5), one it leaves to the generic march (6 and 7).
P6_MARCH = "GBGGRBRGRBGGGBGGRGGRGGBGBGBRGRGRGGBG"
P6_GENERIC = "GBGGRGRGBGGBGRGGRBGRGGBGBGBRGRGRGGBG"
# Bayer at the four phases; the generic-CFA kernel at period 6 on both
# marches (the X-Trans grid at two phases) and at periods 2 and 3.
GRAD_KERNELS = {
    "bayer": [dict(cfa_phase=ph) for ph in ((0, 0), (0, 1), (1, 0), (1, 1))],
    "cfa": [dict(pattern=p) for p in (XTRANS, _shifted(XTRANS, 1, 1),
                                      P6_MARCH, P6_GENERIC, "GRBG",
                                      "RGBGBRBRG")],
}


def _period6_after(before, key, pattern):
    """``fd.PERIOD6_LAUNCHES`` after one launch of ``key`` on ``pattern``."""
    six = pattern is not None and fd.period6_march(pattern)
    return {k: n + (k == key and six) for k, n in before.items()}


@pytest.mark.parametrize("kernel", sorted(GRAD_KERNELS))
@pytest.mark.parametrize("gamma", sorted(fd.GAMMAS))
@pytest.mark.parametrize("shape", GRAD_EDGE_RGBA,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_grad_rgba_equals_plain_at_strip_and_band_edges(cuda, kernel, gamma,
                                                        shape, rng):
    """0 LSB: the kernels keep the plain versions' f32 operations and
    their order, whatever strip or band a pixel falls in."""
    mos, scal = _inputs(rng, 3, *shape, cuda)
    for kw in GRAD_KERNELS[kernel]:
        key = fd.launch_key("rgba", "grad", kw.get("pattern"))
        before, six = fd.LAUNCHES[key], dict(fd.PERIOD6_LAUNCHES)
        got = fd.fused_batch_develop_rgba(mos, scal, gamma=gamma,
                                          demosaic="grad", **kw)
        assert fd.LAUNCHES[key] == before + 1
        assert fd.PERIOD6_LAUNCHES == _period6_after(six, key,
                                                     kw.get("pattern"))
        want = fd.develop_rgba_folded_plain(mos, scal, gamma=gamma,
                                            demosaic="grad", **kw)
        torch.cuda.synchronize()
        assert got.shape == mos.shape
        mx, share = _share(got, want)
        assert mx == 0, f"{kw}: max {mx} LSB, differing {share:.2e}"


@pytest.mark.parametrize("kernel", sorted(GRAD_KERNELS))
@pytest.mark.parametrize("gamma", sorted(fd.GAMMAS))
@pytest.mark.parametrize("shape", GRAD_EDGE_PLANES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_grad_planes_equal_plain_at_strip_and_band_edges(cuda, kernel, gamma,
                                                         shape, rng):
    mos, scal = _inputs(rng, 3, *shape, cuda)
    for kw in GRAD_KERNELS[kernel]:
        key = fd.launch_key("ycbcr420", "grad", kw.get("pattern"))
        before, six = fd.LAUNCHES[key], dict(fd.PERIOD6_LAUNCHES)
        y, cbcr = fd.fused_batch_develop_rgba(
            mos, scal, gamma=gamma, output="ycbcr420", demosaic="grad", **kw)
        assert fd.LAUNCHES[key] == before + 1
        assert fd.PERIOD6_LAUNCHES == _period6_after(six, key,
                                                     kw.get("pattern"))
        wy, wc = fd.develop_rgba_folded_plain(
            mos, scal, gamma=gamma, output="ycbcr420", demosaic="grad", **kw)
        torch.cuda.synchronize()
        h, w = shape
        assert y.shape == (3, h, w) and cbcr.shape == (3, h // 2, w)
        assert torch.equal(y, wy) and torch.equal(cbcr, wc), kw


@pytest.mark.parametrize("pattern", [
    XTRANS, _shifted(XTRANS, 1, 1), _shifted(XTRANS, 3, 2), P6_MARCH,
    P6_GENERIC, "GRBG", "RGBGBRBRG"])
def test_grad_cfa_launcher_takes_the_period6_march_where_the_wrapper_says(
        cuda, pattern):
    """The launcher's choice (``rtt_develop_grad_cfa_period6``, from the
    packed tables) is ``fd.period6_march``: every phase of the X-Trans
    grid and the other 6x6 pattern with exact denominators take the
    period-6 march, the 6x6 pattern with a 6 or a 7 and periods 2 and 3
    the generic one."""
    lib = _build.load()
    six = bool(lib.rtt_develop_grad_cfa_period6(fd.cfa_tables(pattern).packed))
    assert six == fd.period6_march(pattern)
    assert six == (pattern not in (P6_GENERIC, "GRBG", "RGBGBRBRG"))


def test_exact_quotient_on_every_f32_on_the_card(cuda, tmp_path):
    """The period-6 march's stage-2 division (``csrc/exact_quotient.cuh``)
    against the card's IEEE division on all 2^32 f32 numerators: no
    difference for the denominators the kernel takes (the listed ones and
    the powers of two), some for the even ones it leaves out (6 and 10:
    subnormal ties, as the CPU test finds)."""
    import ctypes
    import subprocess
    from pathlib import Path

    src = Path(__file__).resolve().parent / "exact_quotient_check.cu"
    so = tmp_path / "libexact_quotient_check.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-shared", str(src), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.rtt_exact_quotient_check.argtypes = [ctypes.c_float] + [
        ctypes.c_void_p] * 3
    lib.rtt_exact_quotient_check.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    taken = list(fd.EXACT_QUOTIENT_DENS) + [1.0, 2.0, 4.0, 8.0, 16.0]
    for d in taken + [6.0, 10.0]:
        counts = torch.zeros(2, dtype=torch.int64, device=cuda)
        first = torch.zeros(1, dtype=torch.int32, device=cuda)
        assert lib.rtt_exact_quotient_check(d, counts.data_ptr(),
                                            first.data_ptr(), stream) == 0
        bad, nan_bits = counts.tolist()
        x = np.array([first.item()], np.int32).view(np.float32)[0]
        print(f"d={d}: {bad} of 2^32 differ (e.g. x={x!r}), "
              f"{nan_bits} NaN pairs differ in payload")
        if d in taken:
            assert bad == 0, f"d={d}: {bad} differ, e.g. x={x!r}"
        else:
            assert bad > 0


# -- the extras kernel's strips and bands (B8) ---------------------------------

# A warp of the extras kernel marches down a strip of 60 output columns (64
# with its halo of 2) in bands of 64 rows. Sizes one below, at and one above
# each edge and their doubles, and frames narrower or shorter than one strip
# or band; always a batch of three with per-image amounts.
EXTRAS_EDGE_RGBA = [(63, 59), (64, 60), (65, 61), (127, 119), (128, 120),
                    (129, 121), (5, 3), (64, 121), (129, 60), (65, 1),
                    (1, 61), (128, 2)]
EXTRAS_EDGE_PLANES = [(2, 2), (62, 58), (64, 60), (66, 62), (128, 120),
                      (130, 122)]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "mgs" + "".join(
    str(int(x)) for x in f))
@pytest.mark.parametrize("shape", EXTRAS_EDGE_RGBA,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_extras_rgba_equal_plain_at_strip_and_band_edges(cuda, flags, shape,
                                                         rng):
    """0 LSB: the kernel keeps the plain version's f32 operations and
    their order, whatever strip or band a pixel falls in."""
    words, table = _extras_inputs(rng, 3, *shape, cuda)
    kw = dict(zip(("mixer_on", "grading_on", "stencils"), flags))
    before = fx.LAUNCHES["extras_rgba"]
    got = fx.fused_finish_extras_rgba(words, table, **kw)
    assert fx.LAUNCHES["extras_rgba"] == before + 1
    want = fx.finish_extras_plain(words, table, *flags)
    torch.cuda.synchronize()
    assert got.shape == words.shape
    mx, share = _share(got, want)
    assert mx == 0, f"max {mx} LSB, differing {share:.2e}"


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "mgs" + "".join(
    str(int(x)) for x in f))
@pytest.mark.parametrize("shape", EXTRAS_EDGE_PLANES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_extras_planes_equal_plain_at_strip_and_band_edges(cuda, flags, shape,
                                                           rng):
    words, table = _extras_inputs(rng, 3, *shape, cuda)
    kw = dict(zip(("mixer_on", "grading_on", "stencils"), flags))
    before = fx.LAUNCHES["extras_ycbcr420"]
    y, cbcr = fx.fused_finish_extras_rgba(words, table, output="ycbcr420",
                                          **kw)
    assert fx.LAUNCHES["extras_ycbcr420"] == before + 1
    wy, wc = fx.finish_extras_plain(words, table, *flags, output="ycbcr420")
    torch.cuda.synchronize()
    h, w = shape
    assert y.shape == (3, h, w) and cbcr.shape == (3, h // 2, w)
    assert torch.equal(y, wy) and torch.equal(cbcr, wc)


# -- the generic-CFA quad stencils' strips and bands (B5, B6) ------------------

# A warp of the generic-CFA smooth kernel marches down a strip of 62 output
# columns (64 with its halo of 1) in bands of 24 rows; the nearest kernel
# keeps a thread per 2x2 quad and takes the same frames.
CFA_EDGE_RGBA = [(23, 61), (24, 62), (25, 63), (47, 123), (48, 124),
                 (49, 125), (5, 3), (24, 125), (49, 62), (25, 1), (1, 63),
                 (48, 2)]
CFA_EDGE_PLANES = [(2, 2), (22, 60), (24, 62), (26, 64), (48, 124),
                   (50, 126)]
# Periods 6, 2 and 3. A Bayer grid's nearest B of an R site lies on a
# diagonal, which is not one of the nearest kernel's five taps.
CFA_EDGE_PATTERNS = {"nearest": (XTRANS, "RGBGBRBRG"),
                     "smooth": (XTRANS, "GRBG", "RGBGBRBRG")}


@pytest.mark.parametrize("demosaic", sorted(CFA_EDGE_PATTERNS))
@pytest.mark.parametrize("gamma", sorted(fd.GAMMAS))
@pytest.mark.parametrize("shape", CFA_EDGE_RGBA,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cfa_quads_rgba_equal_plain_at_strip_and_band_edges(cuda, demosaic,
                                                            gamma, shape,
                                                            rng):
    """0 LSB: value read clamped, site mask periodic, in every strip and
    band."""
    mos, scal = _inputs(rng, 3, *shape, cuda)
    for pattern in CFA_EDGE_PATTERNS[demosaic]:
        key = fd.launch_key("rgba", demosaic, pattern)
        before = fd.LAUNCHES[key]
        kw = dict(gamma=gamma, demosaic=demosaic, pattern=pattern)
        got = fd.fused_batch_develop_rgba(mos, scal, **kw)
        assert fd.LAUNCHES[key] == before + 1
        want = fd.develop_rgba_folded_plain(mos, scal, **kw)
        torch.cuda.synchronize()
        assert got.shape == mos.shape
        mx, share = _share(got, want)
        assert mx == 0, f"{pattern}: max {mx} LSB, differing {share:.2e}"


@pytest.mark.parametrize("demosaic", sorted(CFA_EDGE_PATTERNS))
@pytest.mark.parametrize("gamma", sorted(fd.GAMMAS))
@pytest.mark.parametrize("shape", CFA_EDGE_PLANES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cfa_quads_planes_equal_plain_at_strip_and_band_edges(cuda, demosaic,
                                                              gamma, shape,
                                                              rng):
    mos, scal = _inputs(rng, 3, *shape, cuda)
    for pattern in CFA_EDGE_PATTERNS[demosaic]:
        key = fd.launch_key("ycbcr420", demosaic, pattern)
        before = fd.LAUNCHES[key]
        kw = dict(gamma=gamma, output="ycbcr420", demosaic=demosaic,
                  pattern=pattern)
        y, cbcr = fd.fused_batch_develop_rgba(mos, scal, **kw)
        assert fd.LAUNCHES[key] == before + 1
        wy, wc = fd.develop_rgba_folded_plain(mos, scal, **kw)
        torch.cuda.synchronize()
        h, w = shape
        assert y.shape == (3, h, w) and cbcr.shape == (3, h // 2, w)
        assert torch.equal(y, wy) and torch.equal(cbcr, wc), pattern


# -- the Bayer quad kernel's tile (B1-B3) ----------------------------------------

# A block of the Bayer quad kernel covers tiles of 128 columns and 16 rows,
# four tiles down (64 rows); a thread four columns (two quads) of two
# rows. Sizes one below, at and one above each edge and their doubles,
# widths that are 2 modulo four (a thread whose second quad lies past the
# edge), frames narrower or shorter than one tile; always a batch of three
# with per-image scalars.
BAYER_EDGE_RGBA = [(15, 127), (16, 128), (17, 129), (31, 255), (32, 256),
                   (33, 257), (5, 3), (16, 257), (33, 128), (17, 1), (1, 129),
                   (32, 126), (15, 130), (3, 6), (63, 128), (64, 129),
                   (65, 127), (127, 130), (128, 6), (129, 257)]
BAYER_EDGE_PLANES = [(2, 2), (14, 126), (16, 128), (18, 130), (32, 256),
                     (34, 258), (62, 126), (64, 128), (66, 130), (128, 256)]
BAYER_QUADS = ("nearest", "bilinear", "malvar")


@pytest.mark.parametrize("demosaic", BAYER_QUADS)
@pytest.mark.parametrize("gamma", sorted(fd.GAMMAS))
@pytest.mark.parametrize("shape", BAYER_EDGE_RGBA,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_bayer_quads_rgba_equal_plain_at_tile_edges(cuda, demosaic, gamma,
                                                    shape, rng):
    """0 LSB at the four phases: the fast and the clamped window loads,
    the word stores and the masked ones, the ragged quads."""
    mos, scal = _inputs(rng, 3, *shape, cuda)
    key = fd.launch_key("rgba", demosaic)
    for phase in PHASES:
        kw = dict(cfa_phase=phase, gamma=gamma, demosaic=demosaic)
        before = fd.LAUNCHES[key]
        got = fd.fused_batch_develop_rgba(mos, scal, **kw)
        assert fd.LAUNCHES[key] == before + 1
        want = fd.develop_rgba_folded_plain(mos, scal, **kw)
        torch.cuda.synchronize()
        assert got.shape == mos.shape
        mx, share = _share(got, want)
        assert mx == 0, f"{phase}: max {mx} LSB, differing {share:.2e}"


@pytest.mark.parametrize("demosaic", BAYER_QUADS)
@pytest.mark.parametrize("gamma", sorted(fd.GAMMAS))
@pytest.mark.parametrize("shape", BAYER_EDGE_PLANES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_bayer_quads_planes_equal_plain_at_tile_edges(cuda, demosaic, gamma,
                                                      shape, rng):
    mos, scal = _inputs(rng, 3, *shape, cuda)
    key = fd.launch_key("ycbcr420", demosaic)
    for phase in PHASES:
        kw = dict(cfa_phase=phase, gamma=gamma, output="ycbcr420",
                  demosaic=demosaic)
        before = fd.LAUNCHES[key]
        y, cbcr = fd.fused_batch_develop_rgba(mos, scal, **kw)
        assert fd.LAUNCHES[key] == before + 1
        wy, wc = fd.develop_rgba_folded_plain(mos, scal, **kw)
        torch.cuda.synchronize()
        h, w = shape
        assert y.shape == (3, h, w) and cbcr.shape == (3, h // 2, w)
        assert torch.equal(y, wy) and torch.equal(cbcr, wc), phase


# -- the develop kernels' table quantiser ------------------------------------------

ONE_BITS = 0x3F800000  # f32 1.0


@pytest.mark.parametrize("gamma", sorted(fd.GAMMAS))
def test_quant_table_equals_plain_on_the_card(cuda, gamma):
    """The table derived on the card against the plain quantiser there:
    its thresholds are where the plain version steps; the lookup equals it
    on a seeded tenth of the f32 values in [0, 1], within 4 ulp of every
    threshold, and at -0.0, negatives, denormals, values above 1 and
    +-inf (chip_smoke.py sweeps every value of [0, 1])."""
    _table_equals_plain(cuda, gamma, fd.quant_table(gamma, cuda)[0],
                        fd._quantize, fd.fused_quantize, 20261016)


def _table_equals_plain(cuda, gamma, table, plain, lookup, seed):
    t = torch.from_numpy(table.next[:255, 0].astype(np.int32)).to(cuda)
    finite = t[t < 2**31 - 1]
    k = torch.arange(1, finite.numel() + 1, device=cuda)
    q = plain(finite.view(torch.float32), gamma)
    q_below = plain((finite - 1).view(torch.float32), gamma)
    assert bool((q >= k).all()) and bool((q_below < k).all())
    gen = torch.Generator(device=cuda).manual_seed(seed)
    tenth = torch.randint(0, ONE_BITS + 1, (ONE_BITS // 10,), generator=gen,
                          device=cuda, dtype=torch.int32)
    near = (finite[:, None] + torch.arange(-4, 5, device=cuda,
                                           dtype=torch.int32)).reshape(-1)
    special = torch.tensor(
        [-0.0, -1.0, -1e-30, -1e-42, -float("inf"), 1e-45, 1e-40,
         1.1754942e-38, 1.0, 1.0000001, 1.5, 255.0, 3.4e38, float("inf")],
        device=cuda).view(torch.int32)
    for bits in (tenth, near, special):
        c = bits.view(torch.float32)
        got = lookup(c, gamma)
        want = plain(c, gamma).to(torch.uint8)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        assert bad == 0, f"{bad} of {c.numel()} values differ"


@pytest.mark.parametrize("chroma", ["420", "444"])
def test_batch_export_equals_engine_export(cuda, chroma, rng, tmp_path):
    """Two 12-bit DNGs through ``run_batch_export`` with ``use_kernel``:
    one grad develop launch for the bucket (planes for 4:2:0, words
    converted on the card for 4:4:4) and JPEGs byte-equal to the
    engine's ``export`` of the same file with the same flags."""
    from raweditor_tpu_torch.pipeline.export import (ExportJob,
                                                     run_batch_export)
    from raweditor_tpu_torch.raw import synth

    edits = [FULL, FULL.replace(exposure=-0.8, saturation=-20.0)]
    jobs = []
    for i, p in enumerate(edits):
        path = tmp_path / f"f{i}.dng"
        synth.write_synthetic_raw(
            path, rng.integers(0, 4096, size=(64, 96), dtype=np.uint16),
            xyz_to_cam=REAL, black_level=150, white_level=4095,
            preview_jpeg=b"")
        jobs.append(ExportJob(str(path), str(tmp_path / f"f{i}.jpg"), p))
    flags = dict(quality=90, chroma=chroma, jpeg_restart_rows=1)
    for k in fd.LAUNCHES:
        fd.LAUNCHES[k] = 0
    rep = run_batch_export(jobs, batch_size=2, mode="accurate",
                           demosaic_method="grad", use_kernel=True, **flags)
    assert rep.succeeded == 2 and not rep.failed
    key = fd.launch_key("ycbcr420" if chroma == "420" else "rgba", "grad")
    assert {k: v for k, v in fd.LAUNCHES.items() if v} == {key: 1}
    for job in jobs:
        eng = DevelopEngine.open(job.raw_path, "accurate", use_kernel=True,
                                 demosaic_method="grad")
        path = eng.export(tmp_path / "engine.jpg", job.params,
                          jpeg_optimize=False, **flags)
        with open(path, "rb") as f, open(job.out_path, "rb") as g:
            assert f.read() == g.read()


# -- wide gamut, highlight recovery and 16-bit output --------------------

XT_GRID = ("GGRGGB" "GGBGGR" "BRGRBG" "GGBGGR" "GGRGGB" "RBGBRG")
D3300 = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                  [-1485, 2204, 7318]], np.float32) / 10000.0


def _raw(rng, pattern, h=64, w=96, clipped=False):
    m = rng.integers(150, 4096, (h, w), dtype=np.uint16)
    if clipped:
        m[h // 4: 3 * h // 4, w // 4: w // 2] = 4095
    return RawImage(m, np.array([2.0, 1.0, 1.5, 1.0], np.float32), D3300,
                    black_level=150.0, white_level=4095.0,
                    cfa_pattern=pattern)


@pytest.mark.parametrize("demosaic,pattern", [
    ("nearest", "RGGB"), ("bilinear", "GBRG"), ("malvar", "BGGR"),
    ("grad", "GRBG"), ("nearest", XT_GRID), ("smooth", XT_GRID),
    ("grad", XT_GRID)], ids=["B1", "B3-bilinear", "B3-malvar", "B4", "B5",
                             "B6", "B7"])
def test_display_p3_develop_equals_plain(cuda, demosaic, pattern, rng):
    """A Display P3 develop through each develop kernel: 0 LSB from the
    kernel's plain version on the engine's own (P3) scalars."""
    e = DevelopEngine(_raw(rng, pattern), mode="accurate", use_kernel=True,
                      demosaic_method=demosaic, color_space="display-p3",
                      device=cuda)
    assert e.transfer == "srgb"
    got = e.full_rgba_device(FULL)
    kw = dict(e._kernel_demosaic())
    want = fd.develop_rgba_folded_plain(e.mosaic[None], e.scalars(FULL)[None],
                                        e.cfa_phase, "srgb", **kw)[0]
    assert _words_diff(got, want) == 0


def test_reconstruction_on_the_card_equals_the_cpu(cuda, rng):
    from raweditor_tpu_torch.ops import highlights as hl

    for pattern, phase, grid in (("GBRG", (1, 0), None),
                                 (XT_GRID, (0, 0), XT_GRID)):
        m = _raw(rng, pattern, clipped=True).mosaic
        m[5:9, 60:70] = rng.integers(3900, 4096, (4, 10))
        t = torch.from_numpy(m)
        for amount in (0.0, 35.0, 60.0, 100.0):
            got = hl.reconstruct_mosaic_highlights(
                t.to(cuda), [2.0, 1.0, 1.5], amount, 4095.0, 150.0,
                cfa_phase=phase, xtrans_pattern=grid)
            want = hl.reconstruct_mosaic_highlights(
                t, [2.0, 1.0, 1.5], amount, 4095.0, 150.0, cfa_phase=phase,
                xtrans_pattern=grid)
            assert torch.equal(got.cpu(), want)
            assert (amount == 0.0) == torch.equal(want, t)


@pytest.mark.parametrize("demosaic", ["nearest", "malvar", "grad"])
def test_develop_u16_on_the_card_within_1_lsb_of_the_cpu(cuda, demosaic,
                                                         rng):
    from raweditor_tpu_torch.ops.develop import develop_u16

    m = torch.from_numpy(_raw(rng, "RGGB").mosaic)
    kw = dict(white_level=4095.0, black_level=150.0,
              demosaic_method=demosaic, matrix_transpose=False,
              transfer="srgb")
    got = develop_u16(m.to(cuda), FULL, [2.0, 1.0, 1.5], REAL, **kw)
    want = develop_u16(m, FULL, [2.0, 1.0, 1.5], REAL, **kw)
    assert got.dtype == torch.uint16
    d = (got.cpu().to(torch.int32) - want.to(torch.int32)).abs()
    assert int(d.max()) <= 1


def test_adobe_rgb_with_use_kernel_launches_no_develop_kernel(cuda, rng):
    e = DevelopEngine(_raw(rng, "RGGB"), mode="accurate", use_kernel=True,
                      demosaic_method="grad", color_space="adobe-rgb",
                      device=cuda)
    before = dict(fd.LAUNCHES)
    words = e.full_rgba_device(FULL)
    planes = e.jpeg_planes(FULL)
    torch.cuda.synchronize()
    assert fd.LAUNCHES == before
    e.use_kernel = False
    assert torch.equal(words, e.full_rgba_device(FULL))
    assert all(torch.equal(a, b) for a, b in zip(planes, e.jpeg_planes(FULL)))


# -- LinearRaw frames, the resize and the output geometry ---------------------

def _linear_raw(rng, h=72, w=110):
    rgb = rng.integers(0, 4096, (h, w, 3), dtype=np.uint16)
    return RawImage(rgb, np.array([1.8, 1.0, 1.4, 1.0], np.float32),
                    REAL * 10000, black_level=64.0, white_level=4095.0)


def test_linear_extras_is_b8_at_0_lsb_from_plain(cuda, rng):
    """A LinearRaw engine with ``use_kernel``: ``full_rgba_device`` of an
    extras edit launches exactly B8 (no develop kernel) and its words
    equal ``finish_extras_plain`` over the plain develop's words; the
    planes route equals the plain planes too. Within 1 LSB of the CPU."""
    e = DevelopEngine(_linear_raw(rng), mode="accurate", use_kernel=True,
                      transfer="srgb", device=cuda)
    cpu = DevelopEngine(_linear_raw(np.random.default_rng(1234)),
                        mode="accurate", use_kernel=True, transfer="srgb",
                        device="cpu")
    p = FULL.replace(**{k: getattr(EXTRA, k) for k in fx.EXTRAS_COLUMNS})
    before = dict(fd.LAUNCHES), dict(fx.LAUNCHES)
    words = e.full_rgba_device(p)
    torch.cuda.synchronize()
    assert fd.LAUNCHES == before[0]
    moved = {k: v - before[1][k] for k, v in fx.LAUNCHES.items()
             if v != before[1][k]}
    assert moved == {"extras_rgba": 1}
    table, *flags = fx.pack_extras([p])
    plain = e._plain_develop(p, rgba=True)
    want = fx.finish_extras_plain(plain[None], table.to(cuda), *flags)[0]
    assert _words_diff(words, want) == 0
    planes = e.jpeg_planes(p)
    want_planes = fx.finish_extras_plain(plain[None], table.to(cuda), *flags,
                                         output="ycbcr420")
    got = (planes[0], torch.stack([planes[1], planes[2]], -1).flatten(-2))
    for g, w in zip(got, want_planes):
        assert torch.equal(g.cpu(), w[0].cpu())
    assert _words_diff(words, cpu.full_rgba_device(p)) <= 1


def test_resize_and_geometry_on_the_card_within_1_lsb_of_the_cpu(cuda, rng):
    from raweditor_tpu_torch.ops import geometry, resize

    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    rgb = rng.integers(0, 256, (200, 300, 3), dtype=np.uint32)
    words = torch.from_numpy((rgb[..., 0] | rgb[..., 1] << 8
                              | rgb[..., 2] << 16 | 0xFF000000).astype(
        np.uint32).view(np.int32)).view(torch.uint32)
    cases = [lambda w: resize.resize_rgba_words(w, 96, 64),
             lambda w: resize.resize_rgba_words(w, 611, 397),
             lambda w: geometry.rotate_crop_rgba_words(w, 3.0),
             lambda w: geometry.rotate_crop_rgba_words(
                 w, 0.0, lens=(0.02, 0.0, 1.0, -1.0)),
             lambda w: geometry.rotate_crop_rgba_words(
                 w, -2.0, perspective=(0.1, 0.05)),
             lambda w: geometry.shape_output(w, "words", 128, 2.0)]
    for fn in cases:
        got, want = fn(words.to(cuda)), fn(words)
        assert got.shape == want.shape
        assert _words_diff(got, want) <= 1
    u16 = torch.from_numpy(rng.integers(0, 65536, (120, 180, 3),
                                        dtype=np.uint16))
    for fn in (lambda x: resize.resize_rgb16(x, 90, 60),
               lambda x: geometry.rotate_crop_u16(x, 4.0)):
        got, want = fn(u16.to(cuda)), fn(u16)
        d = (got.cpu().view(torch.int16).to(torch.int32) & 0xFFFF) - (
            want.view(torch.int16).to(torch.int32) & 0xFFFF)
        assert int(d.abs().max()) <= 1


# -- the banded resize kernel ----------------------------------------------------

def _any_words(rng, *shape):
    """Seeded packed RGBA words, every bit random (alpha too)."""
    bits = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(bits.view(np.int32)).view(torch.uint32)


def _resize_equals_plain(words, out_h, out_w):
    """The kernel's words, and for an even output its planes, bit for bit
    the plain banded version's on the same card, one launch a call."""
    from raweditor_tpu_torch.ops import fused_resize as fr

    want = fr.resize_words_banded_plain(words, out_w, out_h)
    outputs = ["rgba"] + (["ycbcr420"] if out_h % 2 == out_w % 2 == 0
                          else [])
    for output in outputs:
        before = dict(fr.LAUNCHES)
        got = fr.resize_words(words, out_w, out_h, output=output)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in fr.LAUNCHES.items()
                 if v != before[k]}
        assert moved == {fr._LAUNCH_KEY[output]: 1}
        if output == "rgba":
            assert got.shape == want.shape
            assert torch.equal(got.view(torch.int32).cpu(),
                               want.view(torch.int32).cpu())
        else:
            for g, p in zip(got, rgba_words_to_ycbcr420(want)):
                assert g.shape == p.shape and torch.equal(g.cpu(), p.cpu())


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("size", [
    (64, 96, 16, 24), (397, 611, 131, 201), (397, 611, 150, 226),
    (611, 397, 226, 150), (200, 300, 397, 611), (397, 611, 397, 300),
    (300, 611, 120, 611)], ids=str)
def test_resize_kernel_equals_plain(cuda, rng, size, n):
    """The cell's rehearsal (64x96 to 16x24), odd sizes, a portrait frame
    (the march along the columns), an upscale (the ring of 16) and each
    axis kept, in flushes of 1, 3 and 8: words and planes bit for bit the
    plain version's, one launch a flush."""
    h, w, oh, ow = size
    _resize_equals_plain(_any_words(rng, n, h, w).to(cuda), oh, ow)


@pytest.mark.parametrize("size", [(5464, 8192, 1366, 2048),
                                  (8192, 5464, 2048, 1366)], ids=str)
def test_resize_kernel_equals_plain_at_45_mp(cuda, rng, size):
    """One 45 MP image to a 2048 long edge, landscape (the cell's) and
    portrait."""
    h, w, oh, ow = size
    _resize_equals_plain(_any_words(rng, 1, h, w).to(cuda), oh, ow)
    torch.cuda.empty_cache()


def test_resize_kernel_refuses_what_it_does_not_take(cuda, rng):
    from raweditor_tpu_torch.ops import fused_resize as fr

    words = _any_words(rng, 2, 64, 96)
    before = dict(fr.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        fr.launch_resize(words, 24, 16)
    with pytest.raises(TypeError, match="uint32"):
        fr.resize_words(words.view(torch.int32).to(cuda), 24, 16)
    with pytest.raises(ValueError, match="contiguous"):
        fr.resize_words(words.to(cuda).transpose(1, 2), 16, 24)
    with pytest.raises(ValueError, match="even"):
        fr.resize_words(words.to(cuda), 24, 15, output="ycbcr420")
    assert fr.LAUNCHES == before


@pytest.mark.parametrize("size, n", [
    ((1200, 1600, 12, 16), 3), ((1100, 1600, 11, 16), 2),
    ((1600, 1200, 16, 12), 3), ((64, 96, 320, 480), 3),
    ((5464, 8192, 44, 64), 1), ((8192, 5464, 43, 64), 1)], ids=str)
def test_resize_taps_equals_plain(cuda, rng, size, n):
    """What the march does not take runs ``resize_taps``: 100:1, odd
    outputs, a portrait frame, a 5x upscale and a 45 MP frame to a 64
    long edge (about 128:1), words and planes bit for bit the plain
    version's, one launch a flush."""
    from raweditor_tpu_torch.ops import fused_resize as fr

    h, w, oh, ow = size
    assert fr.kernel_plan(h, w, oh, ow, device=cuda).ring == 0
    _resize_equals_plain(_any_words(rng, n, h, w).to(cuda), oh, ow)
    torch.cuda.empty_cache()


def test_shape_output_of_a_pure_crop_on_the_card(cuda, rng):
    """A crop without rotation is a strided view of the frame; the
    engine's output stage resizes it on the card as the plain version
    resizes its copy, and within 1 LSB of the CPU."""
    from raweditor_tpu_torch.ops import fused_resize as fr
    from raweditor_tpu_torch.ops import geometry

    words = _any_words(rng, 400, 600)
    crop = (37, 21, 501, 333)
    for long_edge in (128, 6):
        got = geometry.shape_output(words.to(cuda), "words", long_edge, 0.0,
                                    crop)
        view = words.to(cuda)[21:354, 37:538]
        want = fr.resize_words_banded_plain(view, *got.shape[::-1])
        assert torch.equal(got.view(torch.int32).cpu(),
                           want.view(torch.int32).cpu())
        cpu = geometry.shape_output(words, "words", long_edge, 0.0, crop)
        assert _words_diff(got, cpu) <= 1


def test_shaped_export_resizes_once_a_flush_on_the_card(cuda, rng, tmp_path):
    """A web export on the card: one resize launch a shaped flush, to
    planes for an all-JPEG even output, ``resize.kernel_images`` equal to
    ``shape.images``, and each JPEG byte-equal to the engine's export."""
    from raweditor_tpu_torch.ops import fused_resize as fr
    from raweditor_tpu_torch.pipeline import export as pex
    from raweditor_tpu_torch.raw import synth

    jobs = []
    for i in range(5):
        path = tmp_path / f"w{i}.dng"
        synth.write_synthetic_raw(
            path, rng.integers(0, 4096, size=(64, 96), dtype=np.uint16),
            xyz_to_cam=REAL, black_level=150, white_level=4095,
            preview_jpeg=b"")
        jobs.append(pex.ExportJob(str(path), str(tmp_path / f"w{i}.jpg"),
                                  FULL.replace(exposure=0.2 * i)))
    before = dict(fr.LAUNCHES)
    rep = pex.run_batch_export(jobs, batch_size=2, mode="accurate",
                               demosaic_method="grad", use_kernel=True,
                               long_edge=24, device=cuda)
    assert rep.succeeded == 5 and not rep.failed
    counters = rep.stages["counters"]
    assert counters["resize.kernel_images"] == counters["shape.images"] == 5
    flushes = rep.timer.counts["export.flush"]
    assert {k: v - before[k] for k, v in fr.LAUNCHES.items()
            if v != before[k]} == {"resize_ycbcr420": flushes}
    for job in jobs:
        eng = DevelopEngine.open(job.raw_path, "accurate", use_kernel=True,
                                 demosaic_method="grad")
        path = eng.export(tmp_path / "engine.jpg", job.params, long_edge=24)
        with open(path, "rb") as f, open(job.out_path, "rb") as g:
            assert f.read() == g.read()


def test_linear_frame_stages_unpacked_and_bit_exact(cuda, rng, tmp_path):
    from concurrent.futures import ThreadPoolExecutor

    from raweditor_tpu_torch.pipeline import export as pex

    frame = rng.integers(0, 65536, (40, 60, 3), dtype=np.uint16)
    with ThreadPoolExecutor(1) as pool:
        t, done, _ = pex._Uploader(pool, cuda).submit(frame).result()
    done.synchronize()
    assert t.dtype == torch.uint16 and tuple(t.shape) == frame.shape
    got = t.view(torch.int16).cpu().numpy().view(np.uint16)
    np.testing.assert_array_equal(got, frame)


# -- the staging kernel (csrc/staging.cu) ----------------------------------------

# (format, frame): the main path's 12-bit Bayer and 14-bit X-Trans frames,
# and frames whose packed rows (1503 and 1757 bytes) are no multiple of 16
# and whose slots start off a 16-byte boundary.
STAGING_FRAMES = [("u12", (4016, 6016)), ("u14", (4000, 6000)),
                  ("u12", (37, 1002)), ("u14", (7, 1004)), ("u12", (3, 6))]


def _packed_rows(gen, fmt, h, w, dev):
    from raweditor_tpu_torch.ops import staging as st

    per, size = st._GROUPS[fmt]
    return torch.randint(0, 256, (h, w // per * size), generator=gen,
                         dtype=torch.uint8, device=dev)


def _fill_both(out, sources, fmts):
    """The kernel's fill of ``out`` (one launch) and the plain version's."""
    from raweditor_tpu_torch.ops import staging as st

    want = st.unpack_into_batch_plain(out.clone(), sources, fmts)
    before = st.LAUNCHES["unpack_slots"]
    st.unpack_into_batch(out, sources, fmts)
    assert st.LAUNCHES["unpack_slots"] == before + 1
    torch.cuda.synchronize()
    return out, want


@pytest.mark.parametrize("slots", [1, 3, 8])
@pytest.mark.parametrize("fmt,frame", STAGING_FRAMES,
                         ids=lambda v: v if isinstance(v, str)
                         else "x".join(map(str, v)))
def test_staging_kernel_equals_plain(cuda, fmt, frame, slots):
    """Every byte of the batch equals the plain version, the last three
    slots of a batch of eight repeating the first of its five sources."""
    gen = torch.Generator(device="cuda").manual_seed(slots)
    bufs = [_packed_rows(gen, fmt, *frame, cuda) for _ in range(min(slots, 5))]
    sources = bufs + [bufs[0]] * (slots - len(bufs))
    out = torch.zeros((slots,) + frame, dtype=torch.uint16, device=cuda)
    got, want = _fill_both(out, sources, [fmt] * slots)
    assert torch.equal(got, want)


def test_staging_kernel_takes_sources_from_the_upload_stream(cuda):
    """Sources copied on a stream of their own, waited for by an event as
    the flush does: the batch equals the plain version's and the CPU's."""
    from raweditor_tpu_torch.ops import staging as st

    gen = torch.Generator(device="cuda").manual_seed(7)
    host = [torch.randint(0, 256, (64, 96 * 3 // 2), generator=gen,
                          dtype=torch.uint8, device=cuda).cpu().pin_memory()
            for _ in range(3)]
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        bufs = [h.to(cuda, non_blocking=True) for h in host]
        done = torch.cuda.Event()
        done.record(side)
    stream = torch.cuda.current_stream()
    stream.wait_event(done)
    for b in bufs:
        b.record_stream(stream)
    out = torch.empty((4, 64, 96), dtype=torch.uint16, device=cuda)
    got, want = _fill_both(out, bufs + [bufs[0]], ["u12"] * 4)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), torch.stack(
        [st.unpack12_rows(h) for h in host + [host[0]]]))


def test_staging_kernel_mixed_slots_and_alignments(cuda):
    """u12, u14 and u16 sources in one launch, a slot the caller filled
    (left as it is) and a u16 replay that reads it, a packed source that
    starts one byte off any vector boundary, and a 3-D frame copied."""
    from raweditor_tpu_torch.ops import staging as st

    gen = torch.Generator(device="cuda").manual_seed(11)
    h, w = 6, 40
    big = torch.randint(0, 256, (h * w * 3 // 2 + 1,), generator=gen,
                        dtype=torch.uint8, device=cuda)
    odd = big[1:].view(h, w * 3 // 2)  # contiguous, 1 byte off
    out = torch.zeros((6, h, w), dtype=torch.uint16, device=cuda)
    out[0] = torch.randint(0, 4096, (h, w), generator=gen, dtype=torch.int32,
                           device=cuda).to(torch.uint16)
    sources = [None, _packed_rows(gen, "u12", h, w, cuda),
               _packed_rows(gen, "u14", h, w, cuda), out[0], odd,
               torch.randint(0, 65536, (h, w), generator=gen,
                             dtype=torch.int32, device=cuda).to(torch.uint16)]
    fmts = [None, "u12", "u14", "u16", "u12", "u16"]
    got, want = _fill_both(out, sources, fmts)
    assert torch.equal(got, want)
    assert torch.equal(got[3], got[0])
    frames = torch.randint(0, 65536, (2, 9, 14, 3), generator=gen,
                           dtype=torch.int32, device=cuda).to(torch.uint16)
    out3 = torch.zeros((3, 9, 14, 3), dtype=torch.uint16, device=cuda)
    got, want = _fill_both(out3, [frames[0], frames[1], frames[0]],
                           ["u16"] * 3)
    assert torch.equal(got, want) and torch.equal(got[2], frames[0])
    with pytest.raises(ValueError):  # a source on another device
        st.unpack_into_batch(out, [odd.cpu()] + [None] * 5,
                             ["u12"] + [None] * 5)


def test_staging_kernel_launches_once_a_flush(cuda, tmp_path, rng):
    """A small ``run_batch_export`` on the card: the staging kernel
    launches once a flush and unpacks one slot an image (the drained
    bucket of one at its own length); the develop reads the same batch as
    the CPU's."""
    from raweditor_tpu_torch.ops import staging as st
    from raweditor_tpu_torch.pipeline import export as pex
    from raweditor_tpu_torch.raw import synth

    jobs = []
    for i in range(5):
        p = tmp_path / f"f{i}.dng"
        synth.write_synthetic_raw(
            p, rng.integers(0, 4096, size=(16, 24), dtype=np.uint16),
            black_level=150, white_level=4095, preview_jpeg=b"")
        jobs.append(pex.ExportJob(str(p), str(tmp_path / f"f{i}.jpg"),
                                  EditParams(exposure=0.1 * i)))
    before = st.LAUNCHES["unpack_slots"]
    rep = pex.run_batch_export(jobs, batch_size=2, use_kernel=True,
                               mode="accurate", demosaic_method="grad",
                               device=cuda)
    assert rep.succeeded == 5 and not rep.failed
    flushes = rep.timer.counts["export.flush"]
    assert flushes == 3
    assert st.LAUNCHES["unpack_slots"] - before == flushes
    counters = rep.stages["counters"]
    assert counters["staging.slots_unpacked"] == 5
    assert counters["staging.slots_copied"] == 0
    assert counters["staging.slots_uploaded"] == 0


def test_staging_kernel_splits_a_batch_over_its_slot_limit(cuda):
    """More slots than one launch takes (``MAX_SLOTS``): u12, u14 and u16
    sources, slots that repeat the first, a slot the caller filled and a
    u16 replay that reads it, in two launches; every byte equal to the
    plain version."""
    from raweditor_tpu_torch.ops import staging as st

    gen = torch.Generator(device="cuda").manual_seed(65)
    h, w = 5, 24
    n = st.MAX_SLOTS + 6
    out = torch.zeros((n, h, w), dtype=torch.uint16, device=cuda)
    out[n - 1] = torch.randint(0, 65536, (h, w), generator=gen,
                               dtype=torch.int32, device=cuda).to(torch.uint16)
    kinds = ("u12", "u14", "u16")
    sources, fmts = [], []
    for i in range(40):
        fmt = kinds[i % 3]
        fmts.append(fmt)
        sources.append(torch.randint(0, 65536, (h, w), generator=gen,
                                     dtype=torch.int32, device=cuda)
                       .to(torch.uint16) if fmt == "u16"
                       else _packed_rows(gen, fmt, h, w, cuda))
    sources += [sources[0]] * (n - 42) + [out[n - 1], None]
    fmts += [fmts[0]] * (n - 42) + ["u16", None]
    want = st.unpack_into_batch_plain(out.clone(), sources, fmts)
    before = st.LAUNCHES["unpack_slots"]
    st.unpack_into_batch(out, sources, fmts)
    assert st.LAUNCHES["unpack_slots"] - before == 2
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(out[n - 2], out[n - 1])


def test_staging_late_uploads_go_straight_into_their_slots(cuda, tmp_path,
                                                           rng, monkeypatch):
    """A flush whose first item missed the staging budget beside a staged
    u12 one, two slots long under a batch size of three, on the card: the
    first uploads into its slot, the second unpacks, in one launch, and no
    slot replays either; the files equal an unstaged run's."""
    from raweditor_tpu_torch.ops import staging as st
    from raweditor_tpu_torch.pipeline import export as pex
    from raweditor_tpu_torch.raw import synth

    mosaics = [rng.integers(16384, 65536, size=(16, 24), dtype=np.uint16),
               rng.integers(0, 4096, size=(16, 24), dtype=np.uint16)]
    outs = {}
    for budget in (0, 16 * 24 * 2 * 3 // 4):  # room for the u12 one only
        monkeypatch.setattr(pex, "_STAGE_BUDGET", budget)
        jobs = []
        for i, m in enumerate(mosaics):
            p = tmp_path / f"l{i}.dng"
            synth.write_synthetic_raw(p, m, bpp=12 if i else 16,
                                      preview_jpeg=b"")
            jobs.append(pex.ExportJob(str(p), str(tmp_path / f"l{budget}_{i}"
                                                  ".jpg")))
        before = st.LAUNCHES["unpack_slots"]
        rep = pex.run_batch_export(jobs, batch_size=3, decode_threads=1,
                                   device=cuda)
        assert rep.succeeded == 2 and not rep.failed
        counters = rep.stages["counters"]
        got = (counters["staging.slots_unpacked"],
               counters["staging.slots_copied"],
               counters["staging.slots_uploaded"])
        if budget:
            assert got == (1, 0, 1)
            assert st.LAUNCHES["unpack_slots"] - before == 1
        else:  # nothing staged: one upload of the stacked batch
            assert got == (0, 0, 0)
            assert st.LAUNCHES["unpack_slots"] == before
        outs[budget] = [open(j.out_path, "rb").read() for j in jobs]
    assert outs[0] == outs[16 * 24 * 2 * 3 // 4]


# -- a flush launched at its own length ---------------------------------------

SHORT_KERNELS = {"B4": None, "B7": XTRANS}


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("output", ["rgba", "ycbcr420"])
@pytest.mark.parametrize("kernel", sorted(SHORT_KERNELS))
def test_grad_kernels_over_a_short_batch_equal_a_full_ones_slots(
        cuda, kernel, output, n, rng):
    """B4 and B7 over the first n of eight frames (several strips and
    bands each) give the bytes of the first n slots of the same launch over
    all eight: a flush launched at its own length develops each image as
    a batch of eight does."""
    mos, scal = _inputs(rng, 8, 198, 300, cuda)
    kw = dict(gamma="srgb", output=output, demosaic="grad",
              pattern=SHORT_KERNELS[kernel])
    full = fd.fused_batch_develop_rgba(mos, scal, (0, 1), **kw)
    short = fd.fused_batch_develop_rgba(mos[:n].contiguous(),
                                        scal[:n].contiguous(), (0, 1), **kw)
    torch.cuda.synchronize()
    if output == "rgba":
        full, short = (full,), (short,)
    for a, b in zip(full, short):
        assert b.shape[0] == n and torch.equal(a[:n], b)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("output", ["rgba", "ycbcr420"])
def test_extras_kernel_over_a_short_batch_equals_a_full_ones_slots(
        cuda, output, n, rng):
    """B8 with every stage on over the first n of eight frames gives the
    bytes of the first n slots of the same launch over all eight."""
    words, table = _extras_inputs(rng, 8, 198, 300, cuda)
    kw = dict(mixer_on=True, grading_on=True, stencils=True, output=output)
    full = fx.fused_finish_extras_rgba(words, table, **kw)
    short = fx.fused_finish_extras_rgba(words[:n].contiguous(),
                                        table[:n].contiguous(), **kw)
    torch.cuda.synchronize()
    if output == "rgba":
        full, short = (full,), (short,)
    for a, b in zip(full, short):
        assert b.shape[0] == n and torch.equal(a[:n], b)


@pytest.mark.parametrize("budget", ["default", "nothing staged"])
def test_batch_export_short_flushes_equal_full_ones_on_the_card(
        cuda, budget, rng, tmp_path, monkeypatch):
    """The kernel route on the card over Bayer DNGs and X-Trans RAFs whose
    buckets drain one and three images short of a batch of four (B4 and
    B7 to planes and words, B8 to planes): every file byte-equal to the
    same jobs exported a bucket an image (``batch_size=1``), every flush
    at its own length; with nothing staged, the pageable bytes are each
    flush's own mosaics, its scalars and tables, and the fetch."""
    from raweditor_tpu_torch.ops import staging as st
    from raweditor_tpu_torch.pipeline import export as pex
    from raweditor_tpu_torch.raw import raf, synth

    if budget != "default":
        monkeypatch.setattr(pex, "_STAGE_BUDGET", 0)
    h, w = 120, 180
    extras = dict(sharpen=40.0, vignette=-20.0, hue_red=20.0,
                  grade_shadow_hue=200.0, grade_shadow_sat=30.0)
    paths, edits = [], []
    for i in range(13):
        m = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
        if i < 8:
            p = tmp_path / f"b{i}.dng"
            synth.write_synthetic_raw(p, m, xyz_to_cam=REAL, black_level=150,
                                      white_level=4095, preview_jpeg=b"")
        else:
            p = tmp_path / f"x{i}.raf"
            p.write_bytes(raf.write_raf(m, model="X-T2"))
        paths.append(str(p))
        edits.append(FULL.replace(**extras) if i in (1, 4, 6, 10)
                     else FULL.replace(exposure=0.1 * i))
    written = {}
    for batch in (4, 1):
        jobs = [pex.ExportJob(p, str(tmp_path / f"b{batch}_{i}.jpg"), e)
                for i, (p, e) in enumerate(zip(paths, edits))]
        for k in fd.LAUNCHES:
            fd.LAUNCHES[k] = 0
        for k in fx.LAUNCHES:
            fx.LAUNCHES[k] = 0
        before = st.LAUNCHES["unpack_slots"]
        rep = pex.run_batch_export(jobs, batch_size=batch, mode="accurate",
                                   demosaic_method="grad", use_kernel=True,
                                   device=cuda)
        assert rep.succeeded == 13 and not rep.failed, rep.failed
        written[batch] = [open(j.out_path, "rb").read() for j in jobs]
        if batch == 1:
            continue
        # Buckets: Bayer plain 5 (4 + 1), Bayer extras 3, X-Trans plain 4,
        # X-Trans extras 1: five flushes, 7 slots short of 20.
        c = rep.stages["counters"]
        assert rep.timer.counts["export.flush"] == 5
        assert (c["slots.developed"], c["slots.unfilled"]) == (13, 7)
        assert (c["extras.slots"], c["extras.asked"]) == (4, 4)
        assert {k: v for k, v in fd.LAUNCHES.items() if v} == {
            fd.launch_key("ycbcr420", "grad"): 2,
            fd.launch_key("rgba", "grad"): 1,
            fd.launch_key("ycbcr420", "grad", XTRANS): 1,
            fd.launch_key("rgba", "grad", XTRANS): 1}
        assert {k: v for k, v in fx.LAUNCHES.items() if v} == {
            "extras_ycbcr420": 2}
        if budget == "default":
            assert st.LAUNCHES["unpack_slots"] - before == 5
            assert c["staging.slots_unpacked"] == 13
        else:
            assert st.LAUNCHES["unpack_slots"] == before
            assert c["staging.slots_unpacked"] == 0
            assert c["transfer.pinned_bytes"] == 0
            assert c["transfer.pageable_bytes"] == (
                rep.fetch_bytes + 13 * h * w * 2 + 13 * fd.N_SCALARS * 4
                + 4 * fx.N_EXTRAS * 4)
    assert written[4] == written[1]


# -- the LinearRaw kernel (csrc/linear.cu) --------------------------------------

LINEAR_TRANSFERS = {g: t for g, t in fl.TRANSFER_BY_GAMMA.items()}
LINEAR_EDITS = [EditParams(), FULL, FULL.replace(exposure=-1.3, contrast=-50.0,
                                                 saturation=60.0),
                EditParams(exposure=2.1, highlights=0.8, shadows=-0.6,
                           whites=0.9, blacks=-0.05, temperature=-0.4,
                           tint=0.3, vibrance=-0.3)]


def _linear_flush(rng, n, h, w, dev, params=None):
    """A flush of n seeded (h, w, 3) u16 frames with every seventh sample
    0, every eleventh 65535 and every thirteenth 100 (below a black of
    512.5), per-slot white balance, matrices, levels and edits: (frames,
    the lane's inputs)."""
    f = rng.integers(0, 65536, (n, h, w, 3), dtype=np.uint16)
    flat = f.reshape(-1)
    flat[::7], flat[3::11], flat[5::13] = 0, 65535, 100
    params = params or [LINEAR_EDITS[i % len(LINEAR_EDITS)] for i in range(n)]
    i = np.arange(n) % 4
    inputs = (params, rng.uniform(0.5, 2.5, (n, 3)),
              rng.uniform(-0.5, 1.5, (n, 3, 3)),
              np.array([65535.0, 60000.0, 4095.0, 16383.0])[i],
              np.array([0.0, 512.5, 150.0, 64.0])[i])
    return torch.from_numpy(f).to(dev), inputs


def _linear_against_lane(frames, inputs, gamma, output, transpose=False):
    """Launch the kernel once over the flush and hold it to the plain lane
    on the card: words, or Y and each of Cb and Cr, equal."""
    key = "linear_" + output
    before = fl.LAUNCHES[key]
    got = fl.fused_batch_develop_linear(frames, *inputs,
                                        matrix_transpose=transpose,
                                        gamma=gamma, output=output)
    assert fl.LAUNCHES[key] == before + 1
    want = batch_develop_linear_rgba(frames, *inputs,
                                     matrix_transpose=transpose,
                                     transfer=LINEAR_TRANSFERS[gamma])
    torch.cuda.synchronize()
    n, h, w = want.shape
    if output == "rgba":
        assert got.dtype == torch.uint32 and got.shape == (n, h, w)
        assert torch.equal(got, want)
        return
    y, cb, cr = rgba_words_to_ycbcr420(want)
    assert got[0].shape == (n, h, w) and got[1].shape == (n, h // 2, w)
    assert torch.equal(got[0], y)
    assert torch.equal(got[1][..., 0::2], cb)
    assert torch.equal(got[1][..., 1::2], cr)


@pytest.mark.parametrize("output", ["rgba", "ycbcr420"])
@pytest.mark.parametrize("gamma", ["pow", "srgb"])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_linear_kernel_equals_the_lane_at_24_mp(cuda, rng, n, gamma, output):
    """Flushes of 24 MP LinearRaw frames: words, Y, Cb and Cr equal the
    plain lane's (the kernel sums the chroma box rows first, in the order
    torch's sum takes on the card)."""
    frames, inputs = _linear_flush(rng, n, 4016, 6016, cuda)
    _linear_against_lane(frames, inputs, gamma, output)


# Frames around the kernel's eight-column thread, 256-column tile and
# 64-row block (csrc/linear.cu kLinTileW, kLinBlockH), odd and ragged.
LINEAR_SHAPES = [(1, 1, 1), (3, 1, 9), (3, 3, 7), (1, 17, 8), (3, 37, 53),
                 (2, 63, 255), (2, 65, 257), (1, 64, 256), (1, 129, 520)]
LINEAR_SHAPES_EVEN = [(3, 2, 2), (3, 2, 10), (8, 24, 32), (3, 38, 54),
                      (2, 62, 254), (2, 66, 262), (1, 128, 512)]


@pytest.mark.parametrize("gamma", sorted(LINEAR_TRANSFERS))
@pytest.mark.parametrize("shape", LINEAR_SHAPES + LINEAR_SHAPES_EVEN,
                         ids=str)
def test_linear_kernel_equals_the_lane_on_odd_and_ragged_frames(
        cuda, rng, gamma, shape):
    frames, inputs = _linear_flush(rng, *shape, cuda)
    outputs = ["rgba"] + (["ycbcr420"] if shape in LINEAR_SHAPES_EVEN
                          else [])
    for output in outputs:
        _linear_against_lane(frames, inputs, gamma, output,
                             transpose=gamma == "srgb")


@pytest.mark.parametrize("slider", _SLIDERS)
def test_linear_kernel_over_a_slider_sweep(cuda, rng, slider):
    """Eight slots, each with the slider at another value, over the
    range an editor sends and past it."""
    percent = (-100.0, -60.0, -7.5, 0.0, 12.0, 45.0, 80.0, 100.0)
    vals = {"exposure": (-5.0, -2.3, -0.7, 0.0, 0.31, 1.7, 3.9, 5.0),
            "contrast": percent, "saturation": percent}.get(
        slider, (-1.0, -0.55, -0.2, 0.0, 0.05, 0.3, 0.75, 1.0))
    params = [EditParams(**{slider: v}) for v in vals]
    frames, inputs = _linear_flush(rng, 8, 38, 54, cuda, params)
    for output in ("rgba", "ycbcr420"):
        for gamma in ("pow", "srgb"):
            _linear_against_lane(frames, inputs, gamma, output)


@pytest.mark.parametrize("gamma", sorted(LINEAR_TRANSFERS))
def test_linear_quant_table_equals_the_lanes_finish_on_the_card(cuda, gamma):
    """The LinearRaw table, derived on the card from the lane's finish,
    held to it as the develop kernels' table is to ``_quantize``."""
    _table_equals_plain(cuda, gamma, fl.lane_quant_table(gamma, cuda)[0],
                        fl._lane_quantize, fl.linear_quantize, 20261023)


def test_linear_scalars_are_the_lanes_on_the_card(cuda):
    """Each slot of the scalar table is the f32 value the lane computes on
    the card, where ``x / 100.0`` multiplies by the reciprocal: against
    the same operations on 0-d tensors, image by image."""
    from raweditor_tpu_torch.ops.develop import _scalars, f32

    params = LINEAR_EDITS + [EditParams(contrast=c, saturation=-c,
                                        exposure=c / 37.0)
                             for c in (1.0, 3.0, 7.0, 33.0, 99.0)]
    n = len(params)
    sc = fl.pack_linear_params(params, np.ones((n, 3)),
                               np.tile(np.eye(3), (n, 1, 1)),
                               np.full(n, 60000.0), np.full(n, 512.5),
                               device=cuda)
    slot = {name: i for i, name in enumerate(fl.SCALAR_SLOTS)}
    for i, p in enumerate(params):
        s = _scalars(p, cuda)
        want = {"exposure": torch.exp2(s["exposure"]),
                "contrast": 1.0 + s["contrast"] / 100.0,
                "saturation": 1.0 + s["saturation"] / 100.0,
                "inv_range": 1.0 / (s["whites"] - s["blacks"] + f32(0.0001)),
                "temp_r": 1.0 + s["temperature"] * f32(0.3)}
        for name, v in want.items():
            assert torch.equal(sc[i, slot[name]], v), (i, name)


def test_linear_export_launches_once_a_flush_and_equals_the_lane(
        cuda, rng, tmp_path, monkeypatch):
    """LinearRaw files through ``run_batch_export`` with ``use_kernel``:
    one LinearRaw kernel launch a flush (planes, and words before B8 for
    the flush with extras), every slot counted under
    ``linear.kernel_slots``, and every JPEG byte-equal to the same run
    without ``use_kernel`` (the plain lane)."""
    from raweditor_tpu_torch.pipeline import export as pex
    from raweditor_tpu_torch.raw import synth

    monkeypatch.setattr(synth, "preview_from_mosaic", lambda *a, **k: b"")
    paths = []
    for i in range(5):
        p = tmp_path / f"l{i}.dng"
        synth.write_synthetic_linear_dng(
            p, rng.integers(0, 65536, (40, 64, 3), dtype=np.uint16),
            wb_neutral=(0.5, 1.0, 0.625))
        paths.append(str(p))
    extra = FULL.replace(**{k: getattr(EXTRA, k) for k in fx.EXTRAS_COLUMNS})
    edits = [FULL, EditParams(), extra, FULL.replace(exposure=-0.5), FULL]

    def run(tag, use_kernel):
        jobs = [pex.ExportJob(p, str(tmp_path / f"{tag}{i}.jpg"), e)
                for i, (p, e) in enumerate(zip(paths, edits))]
        before = dict(fl.LAUNCHES)
        rep = pex.run_batch_export(jobs, batch_size=2, mode="accurate",
                                   use_kernel=use_kernel, device=cuda)
        assert rep.succeeded == 5 and not rep.failed
        moved = {k: v - before[k] for k, v in fl.LAUNCHES.items()}
        return rep, moved, [open(j.out_path, "rb").read() for j in jobs]

    rep, moved, kernel_files = run("k", True)
    counters = rep.stages["counters"]
    assert counters["linear.kernel_slots"] == counters[
        "develop.slots.linear"] == counters["slots.developed"] == 5
    # Bucketed by extras: two flushes of the four other images to planes,
    # the extras image's to words for B8.
    assert rep.timer.counts["export.flush"] == 3
    assert moved == {"linear_ycbcr420": 2, "linear_rgba": 1}
    rep, moved, plain_files = run("p", False)
    assert "linear.kernel_slots" not in rep.stages["counters"]
    assert not any(moved.values())
    assert kernel_files == plain_files
