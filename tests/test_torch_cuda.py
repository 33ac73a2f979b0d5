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
from raweditor_tpu_torch.ops.develop import unpack_rgba
from raweditor_tpu_torch.parallel.batch import pack_params

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
    """Periods 2 and 3 through the same kernels and tables; on a 2x2
    pattern the smooth tier is the Bayer bilinear kernel's result."""
    assert fd.cfa_tables("RGBGBRBRG").taps is not None
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
# strip or band; always a batch of three with per-image scalars.
GRAD_EDGE_RGBA = [(63, 55), (64, 56), (65, 57), (127, 111), (128, 112),
                  (129, 113), (9, 7), (64, 113), (129, 56), (65, 7), (1, 57),
                  (128, 1)]
GRAD_EDGE_PLANES = [(2, 2), (62, 54), (64, 56), (66, 58), (128, 112),
                    (130, 114)]
# Bayer at the four phases; the generic-CFA kernel at periods 6, 2 and 3.
GRAD_KERNELS = {
    "bayer": [dict(cfa_phase=ph) for ph in ((0, 0), (0, 1), (1, 0), (1, 1))],
    "cfa": [dict(pattern=p) for p in (XTRANS, "GRBG", "RGBGBRBRG")],
}


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
        before = fd.LAUNCHES[key]
        got = fd.fused_batch_develop_rgba(mos, scal, gamma=gamma,
                                          demosaic="grad", **kw)
        assert fd.LAUNCHES[key] == before + 1
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
        before = fd.LAUNCHES[key]
        y, cbcr = fd.fused_batch_develop_rgba(
            mos, scal, gamma=gamma, output="ycbcr420", demosaic="grad", **kw)
        assert fd.LAUNCHES[key] == before + 1
        wy, wc = fd.develop_rgba_folded_plain(
            mos, scal, gamma=gamma, output="ycbcr420", demosaic="grad", **kw)
        torch.cuda.synchronize()
        h, w = shape
        assert y.shape == (3, h, w) and cbcr.shape == (3, h // 2, w)
        assert torch.equal(y, wy) and torch.equal(cbcr, wc), kw


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
    table, _ = fd.quant_table(gamma, cuda)
    t = torch.from_numpy(table.next[:255, 0].astype(np.int32)).to(cuda)
    finite = t[t < 2**31 - 1]
    k = torch.arange(1, finite.numel() + 1, device=cuda)
    q = fd._quantize(finite.view(torch.float32), gamma)
    q_below = fd._quantize((finite - 1).view(torch.float32), gamma)
    assert bool((q >= k).all()) and bool((q_below < k).all())
    gen = torch.Generator(device=cuda).manual_seed(20261016)
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
        got = fd.fused_quantize(c, gamma)
        want = fd._quantize(c, gamma).to(torch.uint8)
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
