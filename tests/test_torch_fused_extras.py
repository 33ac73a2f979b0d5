"""The finish-extras kernel's wrapper and plain version on the CPU,
against the TPU kernel ``pallas_finish_extras_rgba`` in Pallas interpret
mode (the JAX package's own test style, tests/test_extras.py).

Contract: <= 1 LSB per channel for RGBA and <= 1 per plane for the
YCbCr 4:2:0 output, JAX's own contract for its kernel against its XLA
form; each test prints its measured difference. The kernel itself runs
only on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raweditor_tpu.ops.pallas_develop import pallas_finish_extras_rgba
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu_torch.ops import fused_extras as fx
from raweditor_tpu_torch.params import EditParams

EDIT = dict(sharpen=60.0, denoise=40.0, curve_shadows=30.0,
            curve_darks=-20.0, curve_lights=15.0, curve_highlights=-40.0,
            vignette=-30.0, hue_red=25.0, hue_blue=-40.0, sat_orange=30.0,
            sat_green=-50.0, lum_yellow=40.0, lum_purple=-35.0,
            grade_shadow_hue=210.0, grade_shadow_sat=40.0,
            grade_high_hue=45.0, grade_high_sat=30.0, grade_balance=-20.0)
# One image with every amount at zero; only the first uses the mixer.
BATCH = [EDIT, {}, dict(sharpen=100.0, vignette=70.0, curve_lights=-60.0,
                        grade_mid_hue=120.0, grade_mid_sat=-50.0)]


def _words(rng, shape):
    return (rng.integers(0, 2**24, shape).astype(np.uint32)
            | np.uint32(0xFF000000))


def _torch_words(words):
    return torch.from_numpy(words.view(np.int32).copy()).view(torch.uint32)


def _lsb(want, got):
    a = np.asarray(want).view(np.uint8).astype(int)
    b = got.view(torch.int32).numpy().view(np.uint8).astype(int)
    d = np.abs(a - b)
    return int(d.max()), float((d > 0).mean())


def _pallas(words, table, mixer_on, grading_on, stencils, **kw):
    """The TPU kernel in interpret mode with the table's amounts."""
    t = table.numpy()
    return pallas_finish_extras_rgba(
        jnp.asarray(words), t[:, 0], t[:, 1],
        tuple(t[:, 2 + k] for k in range(4)), t[:, 6],
        mixer=t[:, fx.MIXER_COL:fx.GRADING_COL] if mixer_on else None,
        grading=t[:, fx.GRADING_COL:] if grading_on else None,
        stencils=stencils, interpret=True, **kw)


@pytest.mark.parametrize("case", [
    ((96, 128), [EDIT], (True, True, True)),
    ((2, 96, 128), BATCH[:2], (True, True, True)),
    ((3, 96, 128), BATCH, (False, True, True)),
    ((96, 128), [EDIT], (True, False, False)),
    ((50, 70), [EDIT], (False, False, True)),
], ids=["single", "batch2", "batch3-grading", "mixer-pointwise",
        "pad-50x70"])
def test_plain_matches_pallas(case, rng):
    shape, edits, flags = case
    words = _words(rng, shape)
    n = shape[0] if len(shape) == 3 else 1
    table = fx.pack_extras([EditParams(**edits[i % len(edits)])
                            for i in range(n)])[0]
    want = _pallas(words, table, *flags)
    got = fx.fused_finish_extras_rgba(
        _torch_words(words), table if len(shape) == 3 else table[0],
        mixer_on=flags[0], grading_on=flags[1], stencils=flags[2])
    assert got.dtype == torch.uint32 and tuple(got.shape) == shape
    mx, share = _lsb(want, got)
    print(f"plain vs pallas {shape} {flags}: max {mx} LSB, differing "
          f"{share:.2e}")
    assert mx <= 1


@pytest.mark.parametrize("shape", [(96, 128), (2, 100, 130)])
def test_plain_ycbcr420_matches_pallas(shape, rng):
    words = _words(rng, shape)
    n = shape[0] if len(shape) == 3 else 1
    table = fx.pack_extras([EditParams(**BATCH[i % 2]) for i in range(n)])[0]
    wy, wc = _pallas(words, table, True, True, True, output="ycbcr420")
    y, cbcr = fx.fused_finish_extras_rgba(
        _torch_words(words), table if len(shape) == 3 else table[0],
        mixer_on=True, grading_on=True, stencils=True, output="ycbcr420")
    h, w = shape[-2:]
    assert tuple(y.shape) == shape and cbcr.shape[-2:] == (h // 2, w)
    for name, g, wnt in (("Y", y, wy), ("CbCr", cbcr, wc)):
        d = np.abs(g.numpy().astype(int) - np.asarray(wnt).astype(int))
        print(f"planes {name} {shape}: max {d.max()}, differing "
              f"{(d > 0).mean():.2e}")
        assert d.max() <= 1


def test_ycbcr420_matches_rgba_words(rng):
    """The planes equal converting the kernel's own RGBA output with the
    kernels' emission (one definition, fused_develop.emit_ycbcr420)."""
    from raweditor_tpu_torch.ops.develop import unpack_rgba
    from raweditor_tpu_torch.ops.fused_develop import emit_ycbcr420

    words = _torch_words(_words(rng, (2, 36, 50)))
    table = fx.pack_extras([EditParams(**EDIT), EditParams()])[0]
    kw = dict(mixer_on=True, grading_on=True, stencils=True)
    rgba = fx.fused_finish_extras_rgba(words, table, **kw)
    y, cbcr = fx.fused_finish_extras_rgba(words, table, output="ycbcr420",
                                          **kw)
    wy, wc = emit_ycbcr420(*(c.to(torch.float32) for c in unpack_rgba(rgba)))
    assert torch.equal(y, wy) and torch.equal(cbcr, wc)


@pytest.mark.parametrize("phase", [0, 3])
def test_input_steps_stay_within_radius(phase, rng):
    """1-LSB steps at isolated pixels (6 apart, so no output pixel is in
    reach of two) move the output only within the stencils' radius 2,
    the reach to which the card holds the engine's kernel route against
    its plain lane, by at most the edit's gain: 4 LSB for EDIT."""
    h, w = 96, 128
    words = _words(rng, (1, h, w))
    stepped = words.copy()
    v = stepped.view(np.uint8).reshape(h, w, 4)[phase::6, phase::6, :3]
    v[...] = np.where(v < 255, v + 1, v - 1)
    table = fx.pack_extras([EditParams(**EDIT)])[0]
    kw = dict(mixer_on=True, grading_on=True, stencils=True)
    a, b = (fx.fused_finish_extras_rgba(_torch_words(x), table, **kw)
            for x in (words, stepped))
    d = np.abs(a.view(torch.int32).numpy().view(np.uint8).astype(int)
               - b.view(torch.int32).numpy().view(np.uint8).astype(int))
    d = d.reshape(h, w, 4).max(-1)
    ys, xs = np.nonzero(d)
    print(f"1-LSB steps, phase {phase}: {len(ys)} pixels moved, max "
          f"{d.max()} LSB")
    assert len(ys) and d.max() <= 4
    # Distance to the nearest stepped row and column (steps at
    # phase + 6k, the last one inside the frame).
    for pos, n in ((ys, h), (xs, w)):
        k = np.clip(np.round((pos - phase) / 6.0), 0, (n - 1 - phase) // 6)
        assert (np.abs(pos - (phase + 6 * k)) <= 2).all()


def test_odd_ycbcr420_and_bad_inputs_raise(rng):
    table = fx.pack_extras([EditParams(**EDIT)])[0]
    kw = dict(mixer_on=True, grading_on=False, stencils=True)
    for shape in ((1, 7, 8), (1, 8, 7)):
        with pytest.raises(ValueError, match="even"):
            fx.fused_finish_extras_rgba(_torch_words(_words(rng, shape)),
                                        table, output="ycbcr420", **kw)
    words = _torch_words(_words(rng, (1, 8, 8)))
    for args, extra in (((words.view(torch.int32), table), {}),
                        ((words, table.double()), {}),
                        ((words, table[:, :7].contiguous()), {}),
                        ((words[:, :, ::2], table), {}),
                        ((words, table), {"output": "ycbcr444"})):
        with pytest.raises((TypeError, ValueError)):
            fx.fused_finish_extras_rgba(*args, **kw, **extra)


def test_cpu_runs_plain_and_other_devices_raise(rng):
    """A CPU tensor runs the plain version (no launch counted); a tensor
    on any other non-CUDA device raises."""
    words = _torch_words(_words(rng, (1, 8, 8)))
    table = fx.pack_extras([EditParams(**EDIT)])[0]
    kw = dict(mixer_on=True, grading_on=True, stencils=True)
    before = dict(fx.LAUNCHES)
    got = fx.fused_finish_extras_rgba(words, table, **kw)
    assert torch.equal(got, fx.finish_extras_plain(words, table, True, True,
                                                   True))
    with pytest.raises(ValueError, match="unsupported device"):
        fx.fused_finish_extras_rgba(words.to("meta"), table.to("meta"), **kw)
    assert fx.LAUNCHES == before == {"extras_rgba": before["extras_rgba"],
                                     "extras_ycbcr420":
                                         before["extras_ycbcr420"]}


def test_pack_extras_flags_and_columns():
    """The flags follow the JAX engine's _extras_post and the exporter's
    _extras_post_batch: mixer/grading on when any image uses them,
    stencils when any base amount is non-zero."""
    table, mixer_on, grading_on, stencils = fx.pack_extras(
        [EditParams(**e) for e in BATCH])
    assert table.shape == (3, fx.N_EXTRAS) and table.dtype == torch.float32
    assert (mixer_on, grading_on, stencils) == (True, True, True)
    jp = JaxParams(**EDIT)
    np.testing.assert_array_equal(
        table[0, fx.MIXER_COL:fx.GRADING_COL].numpy(),
        np.float32(jp.mixer_values()))
    np.testing.assert_array_equal(table[0, fx.GRADING_COL:].numpy(),
                                  np.float32(jp.grading_values()))
    assert fx.EXTRAS_COLUMNS[:7] == ("sharpen", "denoise", "curve_shadows",
                                     "curve_darks", "curve_lights",
                                     "curve_highlights", "vignette")
    assert fx.pack_extras([EditParams(hue_red=5.0)])[1:] == (True, False,
                                                             False)
    assert fx.pack_extras([EditParams(grade_mid_hue=5.0)])[1:] == (
        False, False, False)
    for name in ("clarity", "dehaze", "grain"):
        with pytest.raises(NotImplementedError, match=name):
            fx.pack_extras([EditParams(), EditParams(**{name: 10.0})])
