"""The port's output geometry (``raweditor_tpu_torch/ops/geometry.py``)
against the JAX package's ``ops/geometry.py`` on the CPU.

Inputs are made with numpy from a seed. The rectangle helpers and the
resolvers are pure Python and must agree exactly, errors included. The
resample is f32 in both, with each coordinate constant rounded once to
f32 and the same operation order; the JAX ``_rotate_sample`` is jitted,
and XLA's CPU backend contracts ``a * b + c`` into fused multiply-adds,
so a sample coordinate may sit an ulp or two apart (about 4e-6 at these
sizes); times the steepest step of a noise image (255 a pixel) the f32
samples are held within ``SAMPLE_TOL`` = 4e-3, and the rounded outputs
within 1 LSB of u8 and of u16, with the differing share printed
(measured maxima in the prints). The fast paths (identity, pure crop)
are exact.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raweditor_tpu.ops import geometry as jgeo
from raweditor_tpu_torch.ops import geometry as geo

SAMPLE_TOL = 4e-3
# (angle, crop, lens, perspective)
CASES = [
    (3.0, None, None, None),
    (-7.5, None, None, None),
    (0.0, (3, 2, 20, 14), None, None),
    (2.0, (1, 1, 30, 20), None, None),
    (0.0, None, (0.02, 0.0, 0.0, 0.0), None),
    (0.0, None, (0.05, -0.01, 1.0, -1.0), None),
    (0.0, None, None, (0.1, 0.0)),
    (0.0, None, None, (-0.2, 0.15)),
    (4.0, None, (-0.03, 0.01, 0.0, 0.0), (0.0, 0.1)),
    (95.0, None, None, None),
    (0.0, None, None, None),
    (0.0, (0, 0, 41, 27), None, None),
]


def _ids(case):
    return "-".join(str(v).replace(" ", "") for v in case)


def _diff(a, b):
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    return int(d.max()), float((d > 0).mean())


def _words(rng, h, w):
    rgb = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint32)
    return (rgb[..., 0] | rgb[..., 1] << 8 | rgb[..., 2] << 16
            | np.uint32(0xFF000000))


def _t_words(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).view(
        torch.uint32)


def _np_words(t):
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


def test_rectangles_and_resolvers():
    for w, h, a in ((41, 27, 0.0), (41, 27, 3.0), (6016, 4016, -2.5),
                    (64, 64, 90.0), (30, 100, 45.0), (5, 3, 180.0),
                    (40, 30, 1e-12), (6000, 4000, 271.0)):
        assert geo.largest_upright_rect(w, h, a) == \
            jgeo.largest_upright_rect(w, h, a)
        assert geo._resolve_geometry(h, w, a, None) == \
            jgeo._resolve_geometry(h, w, a, None)
    assert geo._resolve_geometry(27, 41, 3.0, (2, 3, 10, 9)) == \
        jgeo._resolve_geometry(27, 41, 3.0, (2, 3, 10, 9))
    for lens in (None, (0, 0, 0, 0), (0.02, 0, 1, -1), ("0.5", 0, 0, 0)):
        assert geo._resolve_lens(lens) == jgeo._resolve_lens(lens)
    for p in (None, (0, 0), (0.1, -0.3), (0.95, 0)):
        assert geo._resolve_perspective(p) == jgeo._resolve_perspective(p)
    bad = [(geo._resolve_lens, jgeo._resolve_lens, (float("nan"), 0, 0, 0)),
           (geo._resolve_lens, jgeo._resolve_lens, (0, 0, float("inf"), 0)),
           (geo._resolve_perspective, jgeo._resolve_perspective, (1.0, 0)),
           (geo._resolve_perspective, jgeo._resolve_perspective,
            (0, float("nan")))]
    for ours, theirs, arg in bad:
        with pytest.raises(ValueError) as a:
            ours(arg)
        with pytest.raises(ValueError) as b:
            theirs(arg)
        assert str(a.value) == str(b.value)
    for crop in ((0, 0, 0, 5), (-1, 0, 5, 5), (30, 0, 20, 5), (0, 20, 5, 9)):
        with pytest.raises(ValueError) as a:
            geo._resolve_geometry(27, 41, 0.0, crop)
        with pytest.raises(ValueError) as b:
            jgeo._resolve_geometry(27, 41, 0.0, crop)
        assert str(a.value) == str(b.value)


def test_bilerp_equals_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, size=(9, 13, 3)).astype(np.float32)
    sx = rng.uniform(-2.0, 15.0, size=(5, 7)).astype(np.float32)
    sy = rng.uniform(-2.0, 11.0, size=(5, 7)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (img, sx, sy)]
    j = [jnp.asarray(a) for a in (img, sx, sy)]
    for channel in (None, 0, 2):
        got = geo._bilerp(*t, channel=channel).numpy()
        want = np.asarray(jgeo._bilerp(*j, channel=channel))
        assert got.shape == want.shape
        err = float(np.abs(got - want).max())
        print(f"_bilerp channel {channel}: max |diff| {err:.3g}")
        assert err <= SAMPLE_TOL


@pytest.mark.parametrize("case", CASES[:10], ids=_ids)
def test_rotate_sample_equals_jax(case):
    angle, crop, lens, persp = case
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, size=(27, 41, 3)).astype(np.float32)
    lens, persp = geo._resolve_lens(lens), geo._resolve_perspective(persp)
    rect = geo.output_rect(27, 41, angle, crop, persp)
    got = geo._rotate_sample(torch.from_numpy(img), angle, *rect, lens=lens,
                             perspective=persp).numpy()
    want = np.asarray(jgeo._rotate_sample(jnp.asarray(img), angle, *rect,
                                          lens=lens, perspective=persp))
    assert got.shape == want.shape == (rect[1], rect[0], 3)
    err = float(np.abs(got - want).max())
    print(f"{case}: _rotate_sample max |diff| {err:.3g}")
    assert err <= SAMPLE_TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_rotate_crop_forms_equal_jax(case):
    """u8, u16, RGBA words and the words batch, with the identity and
    pure-crop fast paths exact."""
    angle, crop, lens, persp = case
    kw = dict(lens=lens, perspective=persp)
    rng = np.random.default_rng(3)
    h, w = 27, 41
    fast = (geo._resolve_lens(lens) is None
            and geo._resolve_perspective(persp) is None and angle == 0.0)
    u8 = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    got = geo.rotate_crop_u8(torch.from_numpy(u8), angle, crop, **kw)
    want = np.asarray(jgeo.rotate_crop_u8(jnp.asarray(u8), angle, crop, **kw))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    mx, share = _diff(got.numpy(), want)
    print(f"{case}: u8 {want.shape} max {mx} LSB, differing {share:.2e}")
    assert mx <= (0 if fast else 1)
    u16 = rng.integers(0, 65536, size=(h, w, 3), dtype=np.uint16)
    got = geo.rotate_crop_u16(torch.from_numpy(u16), angle, crop, **kw)
    want = np.asarray(jgeo.rotate_crop_u16(jnp.asarray(u16), angle, crop,
                                           **kw))
    assert got.dtype == torch.uint16 and tuple(got.shape) == want.shape
    mx, share = _diff(got.view(torch.int16).numpy().view(np.uint16), want)
    print(f"{case}: u16 max {mx} LSB of u16, differing {share:.2e}")
    assert mx <= (0 if fast else 1)
    words = np.stack([_words(rng, h, w), _words(rng, h, w)])
    got = _np_words(geo.rotate_crop_rgba_words(_t_words(words[0]), angle,
                                               crop, **kw))
    want = np.asarray(jgeo.rotate_crop_rgba_words(jnp.asarray(words[0]),
                                                  angle, crop, **kw))
    assert got.shape == want.shape and ((got >> 24) == 0xFF).all()
    mx, share = _diff(got.view(np.uint8), want.view(np.uint8))
    print(f"{case}: words max {mx} LSB, differing {share:.2e}")
    assert mx <= (0 if fast else 1)
    got_b = geo.rotate_crop_rgba_words_batch(_t_words(words), angle, crop,
                                             **kw)
    want_b = np.asarray(jgeo.rotate_crop_rgba_words_batch(
        jnp.asarray(words), angle, crop, **kw))
    assert tuple(got_b.shape) == want_b.shape
    mx, _ = _diff(_np_words(got_b).view(np.uint8), want_b.view(np.uint8))
    assert mx <= (0 if fast else 1)
    # Image by image: the batch equals the single form of each image.
    assert np.array_equal(_np_words(got_b)[0], got)


def test_fast_paths_return_the_image_or_a_slice():
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.integers(0, 256, size=(10, 12, 3),
                                        dtype=np.uint8))
    assert geo.rotate_crop_u8(img) is img
    assert geo.rotate_crop_u8(img, 0.0, None, lens=(0, 0, 0, 0),
                              perspective=(0, 0)) is img
    out = geo.rotate_crop_u8(img, 0.0, (2, 3, 5, 4))
    assert out.data_ptr() == img[3:, 2:].data_ptr()
    assert torch.equal(out, img[3:7, 2:7])
    words = torch.zeros((4, 6, 8), dtype=torch.int32).view(torch.uint32)
    assert geo.rotate_crop_rgba_words_batch(words) is words
    assert math.isclose(geo.output_rect(30, 40, 0.0, None, (0.1, 0.0))[0],
                        jgeo._resolve_geometry(30, 40, 0.0, None)[0] - 4)


def test_shape_output_orders_geometry_then_resize():
    """``shape_output`` (the exporters' output stage) is the geometry,
    then the long-edge resize, as the JAX engine and exporter order them;
    ``reshapes`` says when it changes a frame."""
    from raweditor_tpu.ops import resize as jrs

    rng = np.random.default_rng(5)
    words = _words(rng, 27, 41)
    got = _np_words(geo.shape_output(_t_words(words), "words", 20, 3.0))
    want = jgeo.rotate_crop_rgba_words(jnp.asarray(words), 3.0)
    h, w = want.shape
    oh, ow = jrs.long_edge_shape(h, w, 20)
    want = np.asarray(jrs.resize_rgba_words(want, ow, oh))
    assert got.shape == want.shape == (oh, ow)
    mx, share = _diff(got.view(np.uint8), want.view(np.uint8))
    print(f"shape_output words: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1
    u16 = torch.from_numpy(rng.integers(0, 65536, size=(27, 41, 3),
                                        dtype=np.uint16))
    assert geo.shape_output(u16, "u16") is u16
    assert tuple(geo.shape_output(u16, "u16", 30, crop=(0, 0, 20, 10))
                 .shape) == (10, 20, 3)
    assert not geo.reshapes((27, 41))
    assert not geo.reshapes((27, 41), long_edge=41)
    assert geo.reshapes((27, 41), long_edge=40)
    assert geo.reshapes((27, 41), lens=(0, 0, 0, 0))
    assert geo.reshapes((27, 41), perspective=(0.1, 0.0))
