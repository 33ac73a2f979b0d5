"""The port's finish extras (``ops/mixer.py``, ``ops/grading.py``,
``ops/extras.py``, ``ops/curve.py``) against the JAX package's functions
on the same numpy-made inputs.

Contract: bit-equal. The one exception is the mixer's luminance
``exp2``, which XLA's and PyTorch's CPU libraries round apart by an ulp
on about 15% of inputs; where the mixer's luminance sliders are on, the
planes are held within 4 ulp of 1.0 and the requantised words within
1 LSB. Each test prints its measured difference.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raweditor_tpu.ops import curve as jc
from raweditor_tpu.ops import extras as je
from raweditor_tpu.ops import grading as jg
from raweditor_tpu.ops import mixer as jm
from raweditor_tpu_torch.ops import curve as tc
from raweditor_tpu_torch.ops import extras as te
from raweditor_tpu_torch.ops import grading as tg
from raweditor_tpu_torch.ops import mixer as tm
from raweditor_tpu_torch.ops.fused_develop import _dn, _lf, _rt, _up

SHAPES = [(1, 1), (2, 3), (3, 5), (37, 53), (96, 128)]
ULP4 = 4 * float(np.finfo(np.float32).eps)
EXTRAS = (60.0, 40.0, (30.0, -20.0, 15.0, -40.0), -30.0)
GRADING = (210.0, 40.0, 100.0, -25.0, 45.0, 30.0, -20.0)


def _planes(rng, shape):
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(3)]


def _both(planes):
    return ([jnp.asarray(p) for p in planes],
            [torch.from_numpy(p.copy()) for p in planes])


def _diff(want, got):
    w = np.asarray(want, np.float64)
    g = got.numpy().astype(np.float64) if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    return float(np.abs(w - g).max()), float((w != g).mean())


def _mixer(rng, lum=True):
    v = rng.uniform(-100, 100, 24)
    if not lum:
        v[16:] = 0.0
    return [float(x) for x in v]


def _words(rng, shape):
    return (rng.integers(0, 2**24, shape).astype(np.uint32)
            | np.uint32(0xFF000000))


def _torch_words(words):
    return torch.from_numpy(words.view(np.int32).copy()).view(torch.uint32)


def _word_lsb(want, got):
    a = np.asarray(want).view(np.uint8).astype(int)
    b = got.view(torch.int32).numpy().view(np.uint8).astype(int)
    d = np.abs(a - b)
    return int(d.max()), float((d > 0).mean())


def test_constants_match():
    assert tm.BAND_NAMES == jm.BAND_NAMES
    assert tm.BAND_CENTERS == jm.BAND_CENTERS
    assert (tm.HUE_DEG_PER_UNIT, tm.SAT_PER_UNIT, tm.LUM_EXP2_PER_UNIT) == (
        jm.HUE_DEG_PER_UNIT, jm.SAT_PER_UNIT, jm.LUM_EXP2_PER_UNIT)
    assert tg.GRADE_ORDER == jg.GRADE_ORDER
    assert (tg.STRENGTH, tg.BALANCE_PER_UNIT) == (jg.STRENGTH,
                                                   jg.BALANCE_PER_UNIT)
    assert (tc.MAX_POINTS, tc.MIN_GAP) == (jc.MAX_POINTS, jc.MIN_GAP)


@pytest.mark.parametrize("shape", SHAPES)
def test_hsl_mixer_matches(shape, rng):
    jp, tp = _both(_planes(rng, shape))
    for lum in (False, True):
        mix = _mixer(rng, lum)
        want = jm.apply_hsl_mixer(*jp, mix)
        got = tm.apply_hsl_mixer(*tp, mix)
        for w, g in zip(want, got):
            mx, share = _diff(w, g)
            print(f"mixer {shape} lum={lum}: max {mx:.3g}, differing "
                  f"{share:.2e}")
            assert mx <= (ULP4 if lum else 0.0)
        if not lum:
            jh = jm._hat_weights(jp[0] * 360.0)
            th = tm._hat_weights(tp[0] * 360.0)
            assert len(th) == 9
            for w, g in zip(jh, th):
                assert _diff(w, g)[0] == 0.0


@pytest.mark.parametrize("shape", SHAPES)
def test_color_grading_matches(shape, rng):
    jp, tp = _both(_planes(rng, shape))
    for grading in (GRADING, tuple(rng.uniform(-400, 400, 7))):
        want = jg.apply_color_grading(*jp, grading)
        got = tg.apply_color_grading(*tp, grading)
        for w, g in zip(want, got):
            mx, share = _diff(w, g)
            print(f"grading {shape}: max {mx:.3g}, differing {share:.2e}")
            assert mx == 0.0
    for hue in (-725.0, -30.0, 0.0, 59.9, 359.99, 1000.0):
        for w, g in zip(jg._hue_dir(hue), tg._hue_dir(hue)):
            assert _diff(w, g)[0] == 0.0


@pytest.mark.parametrize("curve", [(30.0, -20.0, 15.0, -40.0),
                                   (600.0, 600.0, 600.0, 600.0),
                                   (-600.0, 600.0, -600.0, 600.0),
                                   (0.0, 0.0, 0.0, 0.0),
                                   (-100.0, -100.0, 100.0, 100.0)])
def test_tone_curve_matches(curve, rng):
    y = np.concatenate([rng.uniform(-0.2, 1.2, 4000),
                        np.linspace(0, 1, 101)]).astype(np.float32)
    mx, share = _diff(je.tone_curve(jnp.asarray(y), curve),
                      te.tone_curve(torch.from_numpy(y), curve))
    print(f"tone curve {curve}: max {mx:.3g}")
    assert mx == 0.0


@pytest.mark.parametrize("shape", SHAPES + [(4016, 6016), (4015, 6013)])
def test_radial_sq_matches(shape):
    h, w = shape
    rows = np.array([0, h // 2, h - 1], np.float32)[:, None]
    cols = np.array([0, w // 3, w - 1], np.float32)[None, :]
    assert _diff(je.radial_sq(h, w, jnp.asarray(rows), jnp.asarray(cols)),
                 te.radial_sq(h, w, torch.from_numpy(rows),
                              torch.from_numpy(cols)))[0] == 0.0
    if h * w < 10**5:
        assert _diff(je.radial_sq(h, w), te.radial_sq(h, w))[0] == 0.0
    want = [np.float32(v) for v in (
        (h - 1) / 2.0, (w - 1) / 2.0)]
    assert te.radial_consts(h, w)[:2] == tuple(want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("heads", ["none", "mixer", "grading", "both"])
def test_extras_core_matches(shape, heads, rng):
    """extras_core over the clamped shifts, with scalar amounts."""
    jp, tp = _both(_planes(rng, shape))
    mix = _mixer(rng) if heads in ("mixer", "both") else None
    grd = GRADING if heads in ("grading", "both") else None
    up, dn, lf, rt = je._pad_shift_fns()
    h, w = shape
    for stencils in (True, False):
        want = je.extras_core(*jp, *EXTRAS, je.radial_sq(h, w), up, dn, lf,
                              rt, mixer=mix, grading=grd, stencils=stencils)
        got = te.extras_core(*tp, *EXTRAS, te.radial_sq(h, w), _up, _dn,
                             _lf, _rt, mixer=mix, grading=grd,
                             stencils=stencils)
        for wp, gp in zip(want, got):
            mx, share = _diff(wp, gp)
            print(f"extras_core {shape} {heads} stencils={stencils}: max "
                  f"{mx:.3g}, differing {share:.2e}")
            assert mx <= (8 * ULP4 if mix else 0.0)


@pytest.mark.parametrize("shape", [(2, 3), (37, 53), (96, 128)])
def test_apply_finish_extras_per_image(shape, rng):
    """(N, 1, 1) per-image amounts, one image at all zeros."""
    planes = [rng.uniform(0, 1, (3,) + shape).astype(np.float32)
              for _ in range(3)]
    jp, tp = _both(planes)
    amounts = np.array([[80.0, 20.0, 10.0, -30.0, 0.0, 45.0, 50.0],
                        [0.0] * 7,
                        [10.0, 100.0, -600.0, 600.0, 30.0, 0.0, -90.0]],
                       np.float32)
    grd = np.array([GRADING, [0.0] * 7, [300, -20, 10, 60, 200, 80, 40]],
                   np.float32)

    def split(a, mod):
        return [mod(np.ascontiguousarray(a[:, k, None, None]))
                for k in range(a.shape[1])]

    ja, ta = split(amounts, jnp.asarray), split(amounts, torch.from_numpy)
    jgr, tgr = split(grd, jnp.asarray), split(grd, torch.from_numpy)
    for stencils in (True, False):
        want = je.apply_finish_extras(*jp, ja[0], ja[1], tuple(ja[2:6]),
                                      ja[6], grading=tuple(jgr),
                                      stencils=stencils)
        got = te.apply_finish_extras(*tp, ta[0], ta[1], tuple(ta[2:6]),
                                     ta[6], grading=tuple(tgr),
                                     stencils=stencils)
        for wp, gp in zip(want, got):
            mx, share = _diff(wp, gp)
            print(f"per-image {shape} stencils={stencils}: max {mx:.3g}")
            assert mx == 0.0


@pytest.mark.parametrize("shape", SHAPES + [(2, 37, 53)])
def test_finish_extras_rgba_words_matches(shape, rng):
    """The behavioural reference of B8: <= 1 LSB (bit-equal expected;
    the mixer's exp2 is the one source of a difference)."""
    words = _words(rng, shape)
    mix = _mixer(rng)
    for kw in (dict(), dict(mixer=mix, grading=GRADING),
               dict(mixer=mix, stencils=False)):
        want = je.finish_extras_rgba_words(jnp.asarray(words), *EXTRAS, **kw)
        got = te.finish_extras_rgba_words(_torch_words(words), *EXTRAS, **kw)
        mx, share = _word_lsb(want, got)
        print(f"words {shape} {sorted(kw)}: max {mx} LSB, differing "
              f"{share:.2e}")
        assert mx <= 1 and share <= 1e-3


def test_unported_extras_raise(rng):
    tp = _both(_planes(rng, (4, 5)))[1]
    for kw, name in ((dict(clarity=10.0), "clarity"),
                     (dict(dehaze=-5.0), "dehaze"),
                     (dict(grain=(20.0, 0.0)), "grain"),
                     (dict(clarity=torch.tensor([[[0.0]], [[3.0]]])),
                      "clarity")):
        with pytest.raises(NotImplementedError, match=name):
            te.apply_finish_extras(*tp, *EXTRAS, **kw)
    # Zero amounts are skipped, as the JAX function skips a host zero.
    base = te.apply_finish_extras(*tp, *EXTRAS)
    for g, b in zip(te.apply_finish_extras(*tp, *EXTRAS, clarity=0.0,
                                           dehaze=0.0, grain=(0.0, 50.0)),
                    base):
        assert torch.equal(g, b)


def test_words_round_trip(rng):
    words = _words(rng, (5, 7))
    planes = te.words_to_planes(_torch_words(words))
    for w, g in zip(je.words_to_planes(jnp.asarray(words)), planes):
        assert _diff(w, g)[0] == 0.0
    back = te.planes_to_words(*planes)
    assert _word_lsb(words, back)[0] == 0


POINTS = [((0.0, 0.0), (1.0, 1.0)),
          ((0.0, 0.05), (0.3, 0.2), (0.6, 0.8), (1.0, 0.95)),
          ((0.1, 0.9), (0.5, 0.1), (0.501, 0.5), (0.9, 0.9)),
          ((0.2, 0.3), (0.4, 0.3), (0.7, 0.6)),
          tuple((i / 15.0, (i % 3) / 2.0) for i in range(16))]


@pytest.mark.parametrize("points", POINTS, ids=lambda p: f"{len(p)}pts")
def test_point_curve_matches(points, rng):
    c = np.concatenate([rng.uniform(0, 1, 5000), [x for x, _ in points],
                        [0.0, 1.0]]).astype(np.float32)
    assert tc.validate_points(points) == jc.validate_points(points)
    mx, share = _diff(jc.apply_point_curve(jnp.asarray(c), points),
                      tc.apply_point_curve(torch.from_numpy(c), points))
    print(f"point curve {len(points)} points: max {mx:.3g}")
    assert mx == 0.0
    assert tc.apply_point_curve(torch.from_numpy(c), ()) is not None


@pytest.mark.parametrize("bad", [
    [(0.0, 0.0)],
    [(0.0, 0.0), (0.0005, 1.0)],
    [(0.5, 0.0), (0.2, 1.0)],
    [(0.0, 1.5), (1.0, 1.0)],
    [(0.0, float("nan")), (1.0, 1.0)],
    ["00", (1.0, 1.0)],
    [(0.0, 0.0, 0.0), (1.0, 1.0)],
    [(0.0, "x"), (1.0, 1.0)],
    [(i / 20.0, 0.5) for i in range(17)],
])
def test_validate_points_errors(bad):
    with pytest.raises(ValueError) as want:
        jc.validate_points(bad)
    with pytest.raises(ValueError) as got:
        tc.validate_points(bad)
    assert str(got.value) == str(want.value)
    assert tc.validate_points([]) == () == jc.validate_points([])
    assert tc.validate_points([[0, 0], [1, 1]]) == ((0.0, 0.0), (1.0, 1.0))
