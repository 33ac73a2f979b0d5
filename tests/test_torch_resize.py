"""The port's resize (``raweditor_tpu_torch/ops/resize.py``) against the
JAX package's ``ops/resize.py`` and ``jax.image.resize`` on the CPU.

Inputs are made with numpy from a seed. Tolerances: the f32 resize
(``resize_hw``) within 1e-4 of the values' range (XLA's CPU backend sums
the contraction and the weights in another order and contracts
``a * b + c`` into fused multiply-adds; torch's and XLA's ``sin`` may
differ by an ulp); the rounded outputs within 1 LSB of u8 and of u16,
with the differing share printed (measured maxima in the prints). The
shapes and the helpers' sizes are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raweditor_tpu.ops import resize as jrs
from raweditor_tpu_torch.ops import resize as rs

# (in_h, in_w, out_h, out_w): downsampling, upsampling, odd sizes, one
# axis kept, a 1-pixel axis either way, both orders of contraction.
SHAPES = [(24, 36, 8, 12), (17, 23, 5, 9), (9, 13, 20, 31), (16, 16, 16, 7),
          (20, 30, 7, 30), (1, 15, 1, 6), (12, 1, 30, 1), (6, 9, 1, 1),
          (31, 12, 11, 40), (40, 24, 15, 9)]


def _diff(a, b):
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("method", ["linear", "lanczos3"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_resize_hw_equals_jax_image_resize(shape, method):
    h, w, oh, ow = shape
    rng = np.random.default_rng(h * 1000 + w)
    x = rng.uniform(0.0, 255.0, size=(3, h, w)).astype(np.float32)
    got = rs.resize_hw(torch.from_numpy(x), oh, ow, method).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, oh, ow),
                                       method=method))
    assert got.shape == want.shape == (3, oh, ow)
    err = float(np.abs(got - want).max())
    print(f"{shape} {method}: max |diff| {err:.3g}")
    assert err <= 255.0 * 1e-4


@pytest.mark.parametrize("method", ["linear", "lanczos3"])
def test_weight_matrix_equals_jax(method):
    """The per-axis matrix of JAX's ``compute_weight_mat`` (antialiased,
    scale out/in, translation 0) within a few ulp."""
    from jax._src.image import scale as jscale

    kernels = {"linear": jscale._fill_triangle_kernel,
               "lanczos3": lambda x: jscale._fill_lanczos_kernel(3.0, x)}
    for n_in, n_out in ((36, 12), (13, 31), (6016, 2048), (7, 1), (1, 5)):
        got = rs.weight_matrix(n_in, n_out, method).numpy()
        want = np.asarray(jscale.compute_weight_mat(
            n_in, n_out, n_out / n_in, 0.0, kernels[method], True))
        assert got.shape == want.shape == (n_in, n_out)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    with pytest.raises(ValueError):
        rs.weight_matrix(4, 2, "cubic")


@pytest.mark.parametrize("shape", SHAPES[:6], ids=lambda s: "x".join(map(str, s)))
def test_resize_rgb_words_and_rgb16(shape):
    h, w, oh, ow = shape
    rng = np.random.default_rng(7 + h + w)
    rgb = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    got = rs.resize_rgb(torch.from_numpy(rgb), ow, oh).numpy()
    want = np.asarray(jrs.resize_rgb(jnp.asarray(rgb), ow, oh))
    assert got.shape == want.shape and got.dtype == np.uint8
    mx, share = _diff(got, want)
    print(f"{shape} resize_rgb: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1
    # Packed words, batched over a leading axis.
    words = (rgb[..., 0].astype(np.uint32) | rgb[..., 1].astype(np.uint32) << 8
             | rgb[..., 2].astype(np.uint32) << 16 | np.uint32(0xFF000000))
    batch = np.stack([words, np.roll(words, 3, axis=1)])
    got = rs.resize_rgba_words(torch.from_numpy(batch.view(np.int32)).view(
        torch.uint32), ow, oh)
    want = np.asarray(jrs.resize_rgba_words(jnp.asarray(batch), ow, oh))
    got = got.view(torch.int32).numpy().view(np.uint32)
    assert got.shape == want.shape == (2, oh, ow)
    assert ((got >> 24) == 0xFF).all()
    mx, share = _diff(got.view(np.uint8), want.view(np.uint8))
    print(f"{shape} resize_rgba_words: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1
    # 16-bit.
    rgb16 = rng.integers(0, 65536, size=(2, h, w, 3), dtype=np.uint16)
    got = rs.resize_rgb16(torch.from_numpy(rgb16), ow, oh)
    want = np.asarray(jrs.resize_rgb16(jnp.asarray(rgb16), ow, oh))
    assert got.dtype == torch.uint16 and tuple(got.shape) == want.shape
    mx, share = _diff(got.view(torch.int16).numpy().view(np.uint16), want)
    print(f"{shape} resize_rgb16: max {mx} LSB of u16, differing {share:.2e}")
    assert mx <= 1


def test_shapes_and_tiers():
    for args in ((6016, 4016, 256), (4000, 6000, 384), (33, 17, 1280),
                 (100, 1, 7)):
        assert rs.tier_shape(*args) == jrs.tier_shape(*args)
    for args in ((4016, 6016, 2048), (6016, 4016, 2048), (20, 30, 30),
                 (20, 30, 0), (3, 1001, 10), (1001, 3, 10), (24, 32, 16)):
        assert rs.long_edge_shape(*args) == jrs.long_edge_shape(*args)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(30, 44, 3), dtype=np.uint8)
    widths = (8, 13, 44, 60)
    got = rs.develop_tiers(torch.from_numpy(img), widths)
    want = jrs.develop_tiers(jnp.asarray(img), widths)
    for g, wnt in zip(got, want):
        assert tuple(g.shape) == wnt.shape
        mx, share = _diff(g.numpy(), np.asarray(wnt))
        print(f"tier {wnt.shape}: max {mx} LSB, differing {share:.2e}")
        assert mx <= 1
