"""The port's sampling and nearest demosaic against the JAX package's:
exact, including the image edges and the integer texel boundaries."""

import numpy as np
import pytest
import torch

from raweditor_tpu.ops import demosaic as jdm
from raweditor_tpu.ops import sampling as jsa
from raweditor_tpu_torch.ops import demosaic as tdm
from raweditor_tpu_torch.ops import sampling as tsa


@pytest.mark.parametrize("zoom", [0.5, 1.0, 2.0, 3.7])
@pytest.mark.parametrize("pan", [0.0, 0.13, -0.31])
def test_sample_axis_exact(zoom, pan):
    for out_size, full_size in ((1280, 6016), (85, 4016), (32, 97)):
        ji, jv = jsa.sample_axis(out_size, full_size, np.float32(zoom),
                                 np.float32(pan))
        ti, tv = tsa.sample_axis(out_size, full_size, zoom, pan)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_target_shapes_match():
    for w, h in ((6016, 4016), (4016, 6016), (97, 64), (1000, 1000)):
        assert tsa.preview_shape(w, h) == jsa.preview_shape(w, h)
        assert tsa.histogram_shape(w, h) == jsa.histogram_shape(w, h)


@pytest.mark.parametrize("pattern", sorted(jdm.CFA_PHASES))
def test_demosaic_nearest_exact(pattern, rng):
    phase = tdm.phase_of(pattern)
    assert phase == jdm.phase_of(pattern)
    m = rng.random((17, 23), dtype=np.float32)  # odd: ragged edges
    want = jdm.demosaic_nearest(m, phase)
    got = tdm.demosaic_nearest(torch.from_numpy(m), phase)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pattern", sorted(jdm.CFA_PHASES))
def test_demosaic_nearest_sampled_exact(pattern, rng):
    phase = tdm.phase_of(pattern)
    m = rng.random((20, 31), dtype=np.float32)
    # Every edge row/column plus interior picks, with repeats.
    yi = np.array([0, 0, 1, 7, 18, 19, 19], np.int32)
    xi = np.array([0, 1, 2, 15, 29, 30, 30, 0], np.int32)
    want = jdm.demosaic_nearest_sampled(m, yi, xi, phase)
    got = tdm.demosaic_nearest_sampled(
        torch.from_numpy(m), torch.from_numpy(yi).long(),
        torch.from_numpy(xi).long(), phase)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unported_and_unknown_methods(rng):
    m = torch.from_numpy(rng.random((4, 4), dtype=np.float32))
    with pytest.raises(NotImplementedError):
        tdm.demosaic(m, "malvar")
    with pytest.raises(ValueError):
        tdm.demosaic(m, "bogus")
    with pytest.raises(ValueError):
        tdm.phase_of("XTRANS")
