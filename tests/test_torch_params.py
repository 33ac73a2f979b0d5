"""The port's EditParams and colour tables against the JAX package's."""

import json

import numpy as np
import pytest

from raweditor_tpu import color as jcolor
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu_torch import color as tcolor
from raweditor_tpu_torch.params import EditParams


def _random_sliders(rng, extras: bool):
    names = JaxParams.field_names()
    d = {n: float(rng.uniform(-1, 1)) for n in names[:10]}
    if extras:
        for n in rng.choice(names[10:], size=6, replace=False):
            d[str(n)] = float(rng.uniform(0, 50))
    return d


def test_fields_and_defaults_match():
    assert EditParams.field_names() == JaxParams.field_names()
    t, j = EditParams(), JaxParams()
    for n in JaxParams.field_names():
        assert getattr(t, n) == getattr(j, n), n
    assert t.locals == j.locals and t.point_curve == j.point_curve


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("extras", [False, True])
def test_json_round_trip_both_ways(seed, extras):
    d = _random_sliders(np.random.default_rng(seed), extras)
    jax_json = JaxParams(**d).to_json()
    port_json = EditParams.from_dict(d).to_json()
    assert port_json == jax_json  # byte-compatible catalog rows
    assert EditParams.from_json(jax_json) == EditParams.from_dict(d)
    back = JaxParams.from_json(port_json)
    for n in JaxParams.field_names():
        assert getattr(back, n) == d.get(n, getattr(JaxParams(), n)), n


def test_mode_helpers_match():
    cases = [{}, {"sharpen": 20.0}, {"clarity": 10.0, "hue_red": 5.0},
             {"grade_mid_sat": 30.0, "grain": 12.0}, {"grade_mid_hue": 90.0},
             {"highlight_recovery": 50.0}]
    for d in cases:
        t, j = EditParams.from_dict(d), JaxParams(**d)
        assert t.has_finish_extras() == j.has_finish_extras(), d
        assert t.finish_extras_mode() == j.finish_extras_mode(), d
    p = EditParams().replace(exposure=1.5)
    assert p.exposure == 1.5 and p.replace(exposure=0.0) == EditParams()


def test_unknown_and_unported_json():
    with pytest.raises(ValueError):
        EditParams.from_json(json.dumps({"bogus": 1.0}))
    with pytest.raises(NotImplementedError):
        EditParams.from_json(json.dumps({"point_curve": [[0, 0], [1, 1]]}))
    assert EditParams.from_json(json.dumps({"locals": []})) == EditParams()


def test_colour_tables_equal_jax():
    assert tcolor.GAMMA22_POLY == jcolor.GAMMA22_POLY
    assert tcolor.SRGB_POLY == jcolor.SRGB_POLY
    assert tcolor.KERNEL_GAMMA_BY_TRANSFER == jcolor.PALLAS_GAMMA_BY_TRANSFER
    np.testing.assert_array_equal(tcolor.XYZ_TO_SRGB, jcolor.XYZ_TO_SRGB)
    np.testing.assert_array_equal(tcolor.SRGB_TO_XYZ, jcolor.SRGB_TO_XYZ)


@pytest.mark.parametrize("mode", ["parity", "accurate"])
@pytest.mark.parametrize("matrix", [
    np.eye(3),
    np.array([[6988, -1384, -714], [-5631, 13410, 2447],
              [-1485, 2204, 7318]]),                       # x10000 scaled
    np.array([[0.6988, -0.1384, -0.0714], [-0.5631, 1.341, 0.2447],
              [-0.1485, 0.2204, 0.7318]]),
    np.zeros((3, 3)),                                      # degenerate
])
def test_cam_to_srgb_matrix_matches(mode, matrix):
    np.testing.assert_array_equal(tcolor.cam_to_srgb_matrix(matrix, mode),
                                  jcolor.cam_to_srgb_matrix(matrix, mode))


@pytest.mark.parametrize("transfer", ["gamma22", "gamma22_poly", "srgb",
                                      "srgb_poly"])
def test_transfer_curves_match(transfer):
    """Encoders on f32 inputs spanning the clamps, against the jitted
    JAX encoders: within 4 ulp of 1.0 (XLA's and PyTorch's CPU pow and
    polynomial evaluations round differently in the last bits)."""
    import jax
    import torch

    x = np.linspace(-0.1, 1.2, 20001, dtype=np.float32)
    want = np.asarray(jax.jit(jcolor.encoder_for(transfer))(x))
    got = tcolor.encoder_for(transfer)(torch.from_numpy(x)).numpy()
    err = float(np.abs(got - want).max())
    print(f"{transfer}: max abs diff {err:.3g}, "
          f"differing {(got != want).mean():.2e}")
    assert err <= 4 * np.finfo(np.float32).eps
    with pytest.raises(ValueError):
        tcolor.encoder_for("bogus")
