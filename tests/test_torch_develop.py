"""The port's parity develop lane against ``raweditor_tpu.ops.develop``.

Target bit-exact, floor 1 LSB per channel. The only differences come
from the transcendental functions (``pow``, ``exp2``), which XLA's and
PyTorch's CPU libraries round differently in the last ulp; each test
prints its measured maximum difference and share of differing values.
"""

import numpy as np
import pytest
import torch

from raweditor_tpu.ops import develop as jd
from raweditor_tpu.ops import jpeg as jj
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu_torch.ops import develop as td
from raweditor_tpu_torch.ops import jpeg as tj
from raweditor_tpu_torch.params import EditParams

import oracle

WB = np.array([2.07, 1.0, 1.32], np.float32)
IDENTITY = np.eye(3, dtype=np.float32)
REAL = np.array([[1.6, -0.3, -0.3], [-0.2, 1.5, -0.3], [0.0, -0.4, 1.4]],
                np.float32)
TRANSFERS = ("gamma22", "gamma22_poly", "srgb", "srgb_poly")
FULL = dict(exposure=0.8, contrast=-4.0, highlights=0.3, shadows=-0.2,
            whites=1.1, blacks=0.05, vibrance=-0.4, saturation=20.0,
            temperature=-0.25, tint=0.15)
# Parity lane, and an accurate-style case: real matrix straight, levels.
CASES = {
    "parity": dict(cam=IDENTITY, transpose=True, white=4096.0, black=0.0,
                   phase=(0, 0)),
    "accurate": dict(cam=REAL, transpose=False, white=4000.0, black=128.0,
                     phase=(1, 0)),
}


def _diff(got, want):
    d = np.abs(np.asarray(got).astype(np.int64)
               - np.asarray(want).astype(np.int64))
    return int(d.max()), float((d > 0).mean())


def _kw(case):
    c = CASES[case]
    return dict(white_level=c["white"], black_level=c["black"],
                matrix_transpose=c["transpose"], cfa_phase=c["phase"])


def _sweep(rng, n):
    """Random points over the ten sliders (tests/test_develop_parity.py
    ranges)."""
    return [dict(exposure=float(rng.uniform(-5, 5)),
                 contrast=float(rng.uniform(-10, 10)),
                 highlights=float(rng.uniform(-1, 1)),
                 shadows=float(rng.uniform(-1, 1)),
                 whites=float(rng.uniform(0.8, 1.2)),
                 blacks=float(rng.uniform(0, 0.2)),
                 vibrance=float(rng.uniform(-1, 1)),
                 saturation=float(rng.uniform(-100, 100)),
                 temperature=float(rng.uniform(-1, 1)),
                 tint=float(rng.uniform(-1, 1))) for _ in range(n)]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("transfer", TRANSFERS)
def test_develop_rgba_and_develop(case, transfer, rng):
    mosaic = rng.integers(0, 4096, size=(64, 96), dtype=np.uint16)
    cam = CASES[case]["cam"]
    kw = dict(_kw(case), transfer=transfer)
    want = jd.develop_rgba(mosaic, JaxParams(**FULL), WB, cam, **kw)
    got = td.develop_rgba(torch.from_numpy(mosaic), EditParams(**FULL), WB,
                          cam, **kw)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (64, 96)
    mx, share = _diff(td.rgba_view(got), jd.rgba_view(want))
    print(f"develop_rgba {case}/{transfer}: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1 and share <= 1e-3
    rgb = td.develop(torch.from_numpy(mosaic), EditParams(**FULL), WB, cam,
                     **kw)
    np.testing.assert_array_equal(rgb.numpy(), td.rgba_view(got)[..., :3])


def test_random_slider_sweep(rng):
    mosaic = rng.integers(0, 4096, size=(32, 40), dtype=np.uint16)
    tm = torch.from_numpy(mosaic)
    worst, diffs = 0, []
    for d in _sweep(rng, 25):
        for transfer in TRANSFERS:
            want = jd.develop(mosaic, JaxParams(**d), WB, IDENTITY,
                              transfer=transfer)
            got = td.develop(tm, EditParams(**d), WB, IDENTITY,
                             transfer=transfer)
            mx, share = _diff(got.numpy(), want)
            worst = max(worst, mx)
            diffs.append(share)
    print(f"sweep: max {worst} LSB, mean differing {np.mean(diffs):.2e}")
    assert worst <= 1 and np.mean(diffs) <= 1e-3


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("view", [(1.0, 0.0, 0.0), (2.0, 0.1, -0.2),
                                  (0.5, 0.0, 0.3), (3.7, -0.05, 0.0)])
def test_preview_and_histogram(case, view, rng):
    mosaic = rng.integers(0, 4096, size=(96, 144), dtype=np.uint16)
    zoom, px, py = view
    cam = CASES[case]["cam"]
    kw = dict(_kw(case), zoom=zoom, pan_x=px, pan_y=py)
    want = np.asarray(jd.develop_preview(mosaic, JaxParams(**FULL), WB, cam,
                                         out_w=64, out_h=42, **kw))
    got = td.develop_preview(torch.from_numpy(mosaic), EditParams(**FULL),
                             WB, cam, 64, 42, **kw).numpy()
    mx, share = _diff(got, want)
    print(f"preview {case} {view}: max {mx} LSB, differing {share:.2e}")
    assert got.shape == (42, 64, 3) and mx <= 1
    jh = np.asarray(jd.develop_histogram(mosaic, JaxParams(**FULL), WB, cam,
                                         out_w=64, out_h=42, **kw))
    th = td.develop_histogram(torch.from_numpy(mosaic), EditParams(**FULL),
                              WB, cam, 64, 42, **kw).numpy()
    assert th.dtype == np.int32 and th.sum() == 3 * 64 * 42
    np.testing.assert_array_equal(th, td.histogram_256(torch.from_numpy(got))
                                  .numpy())
    if mx == 0:  # histograms are exact whenever the preview is
        np.testing.assert_array_equal(th, jh)


def test_against_numpy_oracle(rng):
    mosaic = rng.integers(0, 4096, size=(24, 32), dtype=np.uint16)
    p = EditParams(**FULL)
    want = oracle.develop_image(mosaic, p, WB, IDENTITY)
    got = td.develop_u8(torch.from_numpy(mosaic), p, WB, IDENTITY)
    mx, share = _diff(got, want)
    print(f"oracle full: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1 and share <= 0.01
    want = oracle.develop_preview(mosaic, p, WB, IDENTITY, 20, 14, zoom=2.0,
                                  pan_x=0.1)
    got = td.develop_preview(torch.from_numpy(mosaic), p, WB, IDENTITY, 20,
                             14, zoom=2.0, pan_x=0.1).numpy()
    assert _diff(got, want)[0] <= 1


def test_jpeg_planes_match(rng):
    words = rng.integers(0, 2**24, size=(2, 16, 24), dtype=np.uint32)
    words |= np.uint32(0xFF000000)
    tw = torch.from_numpy(words.view(np.int32)).view(torch.uint32)
    for tf, jf in ((tj.rgba_words_to_ycbcr420, jj.rgba_words_to_ycbcr420),
                   (tj.rgba_words_to_ycbcr444, jj.rgba_words_to_ycbcr444)):
        for g, w in zip(tf(tw), jf(words)):
            assert _diff(g.numpy(), w)[0] == 0
    img = rng.integers(0, 256, size=(16, 24, 3), dtype=np.uint8)
    for g, w in zip(tj.rgb_u8_to_ycbcr420(torch.from_numpy(img)),
                    jj.rgb_u8_to_ycbcr420(img)):
        assert _diff(g.numpy(), w)[0] == 0
    with pytest.raises(ValueError):
        tj.rgba_words_to_ycbcr420(tw[:, :15])


@pytest.mark.parametrize("output", ["rgba_words", "ycbcr420", "ycbcr444"])
def test_batch_develop_matches(output, rng):
    from raweditor_tpu.parallel.batch import batch_develop_rgba as jax_batch
    from raweditor_tpu.parallel.batch import pack_params as jax_pack
    from raweditor_tpu_torch.parallel.batch import batch_develop_rgba

    mosaics = rng.integers(0, 4096, size=(2, 16, 24), dtype=np.uint16)
    plist = [FULL, {}]
    wbs = np.stack([WB, np.ones(3, np.float32)])
    cms = np.stack([IDENTITY, REAL])
    want = jax_batch(mosaics, jax_pack([JaxParams(**d) for d in plist]), wbs,
                     cms, output=output)
    got = batch_develop_rgba(torch.from_numpy(mosaics),
                             [EditParams(**d) for d in plist], wbs, cms,
                             output=output)
    if output == "rgba_words":
        got, want = (td.rgba_view(got),), (jd.rgba_view(want),)
    for g, w in zip(got, want):
        mx, share = _diff(g.numpy() if isinstance(g, torch.Tensor) else g, w)
        print(f"batch {output}: max {mx}, differing {share:.2e}")
        assert mx <= 1


def test_pack_unpack_round_trip(rng):
    planes = [torch.from_numpy(rng.integers(0, 256, (5, 7), dtype=np.uint8))
              for _ in range(3)]
    words = td.pack_rgba(*planes)
    assert words.dtype == torch.uint32
    view = td.rgba_view(words)
    for c in range(3):
        np.testing.assert_array_equal(view[..., c], planes[c].numpy())
        np.testing.assert_array_equal(td.unpack_rgba(words)[c].numpy(),
                                      planes[c].numpy())
    assert (view[..., 3] == 255).all()


def test_unported_inputs_raise(rng):
    m = torch.from_numpy(rng.integers(0, 4096, (8, 8), dtype=np.uint16))
    for p in (EditParams(clarity=10.0), EditParams(grain=10.0)):
        with pytest.raises(NotImplementedError):
            td.develop_rgba(m, p, WB, IDENTITY)
    # Highlight recovery is ported, and as in the JAX package it is no
    # stage of the develop functions (the engine and the exporter
    # reconstruct the mosaic first): the develop ignores the field.
    assert torch.equal(td.develop_rgba(m, EditParams(highlight_recovery=5.0),
                                       WB, IDENTITY),
                       td.develop_rgba(m, EditParams(), WB, IDENTITY))
    with pytest.raises(NotImplementedError):
        td.develop_rgba(m, EditParams(), WB, IDENTITY,
                        demosaic_method="bilinear", extras=True)
    with pytest.raises(ValueError):
        td.develop_rgba(m, EditParams(), WB, IDENTITY,
                        demosaic_method="smooth")
