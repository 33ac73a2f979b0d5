"""The generic-CFA (X-Trans) develop kernels' plain versions and wrappers
on the CPU, against the TPU kernels run in Pallas interpret mode on the
shapes the JAX package's own tests use (tests/test_pallas_develop.py).

Contract: <= 1 LSB per channel with at least 97% of values exact for the
RGBA words, planes within one step for YCbCr 4:2:0; each test prints its
measured difference. The kernels themselves (``csrc/develop.cu``'s
generic stencils and ``csrc/develop_grad_generic.cu``) run only on the
card: tests/test_torch_cuda.py.
"""

import re

import numpy as np
import pytest
import torch

from raweditor_tpu.ops import develop as jd
from raweditor_tpu.ops.cfa_generic import XTRANS_PATTERN as XTRANS
from raweditor_tpu.ops.jpeg import rgba_words_to_ycbcr420
from raweditor_tpu.ops.pallas_develop import (pallas_batch_develop_rgba,
                                              pallas_develop_rgba)
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.parallel.batch import pack_params as jax_pack_params
from raweditor_tpu_torch.ops import _build
from raweditor_tpu_torch.ops import develop as td
from raweditor_tpu_torch.ops import fused_develop as fd
from raweditor_tpu_torch.params import EditParams
from raweditor_tpu_torch.parallel.batch import pack_params

TIERS = ("nearest", "smooth", "grad")
SPARSE = "RGGG" "GGGG" "GGGB" "GGGG"  # R/B smooth radius 2 on this 4x4
WB = np.array([2.07, 1.0, 1.32], np.float32)
REAL_MATRIX = np.array([[0.9, 0.2, -0.1], [-0.15, 1.1, 0.05],
                        [0.02, -0.3, 1.28]], np.float32)
FULL = dict(exposure=0.6, contrast=8.0, highlights=-0.4, shadows=0.3,
            whites=1.05, blacks=0.04, saturation=25.0, vibrance=0.5,
            temperature=0.2, tint=-0.1)
# (tier, shape, block_h of the TPU kernel): the JAX tests' shapes. 48x384
# reaches the TPU kernel's roll-mask path, 72x48 runs at two block
# heights, 250x48 and 64x130 take its height- and width-pad rescues.
CASES = [("nearest", (24, 36), None), ("nearest", (48, 132), None),
         ("smooth", (40, 48), None), ("smooth", (48, 132), None),
         ("smooth", (48, 384), None),
         ("grad", (40, 48), 8), ("grad", (72, 48), 8), ("grad", (72, 48), 24),
         ("grad", (250, 48), None), ("grad", (64, 130), None)]


def _lsb(got, want):
    d = np.abs(td.rgba_view(got).astype(int)
               - jd.rgba_view(np.asarray(want)).astype(int))[..., :3]
    return int(d.max()), float((d > 0).mean())


def _plane_diff(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("tier,shape,block_h", CASES,
                         ids=[f"{t}-{s[0]}x{s[1]}-bh{b}" for t, s, b in CASES])
def test_plain_matches_pallas_single(tier, shape, block_h, rng):
    mosaic = rng.integers(0, 4000, size=shape, dtype=np.uint16)
    want = pallas_develop_rgba(
        mosaic, JaxParams(**FULL), WB, REAL_MATRIX, white_level=4000.0,
        black_level=128.0, matrix_transpose=False, gamma="srgb",
        pattern=XTRANS, demosaic=tier, block_h=block_h, interpret=True)
    scal = fd.fold_scalars(EditParams(**FULL), WB, REAL_MATRIX, 4000.0,
                           128.0, False)
    got = fd.fused_develop_rgba(torch.from_numpy(mosaic), scal, gamma="srgb",
                                demosaic=tier, pattern=XTRANS)
    assert got.dtype == torch.uint32 and tuple(got.shape) == shape
    mx, share = _lsb(got, want)
    print(f"plain vs Pallas {tier} {shape} bh={block_h}: max {mx} LSB, "
          f"differing {share:.2e}")
    assert mx <= 1 and share <= 0.03


@pytest.mark.parametrize("gamma", ["pow", "poly", "srgb_poly"])
def test_plain_matches_pallas_other_transfers(gamma, rng):
    """The parity-style call of the JAX test (identity matrix, /4096)
    through the other three transfers, nearest tier."""
    mosaic = rng.integers(0, 4096, size=(24, 36), dtype=np.uint16)
    eye = np.eye(3, dtype=np.float32)
    want = pallas_develop_rgba(mosaic, JaxParams(**FULL), WB, eye,
                               matrix_transpose=False, gamma=gamma,
                               pattern=XTRANS, interpret=True)
    scal = fd.fold_scalars(EditParams(**FULL), WB, eye,
                           matrix_transpose=False)
    got = fd.fused_develop_rgba(torch.from_numpy(mosaic), scal, gamma=gamma,
                                pattern=XTRANS)
    mx, share = _lsb(got, want)
    print(f"plain vs Pallas nearest {gamma}: max {mx} LSB, differing "
          f"{share:.2e}")
    assert mx <= 1 and share <= 0.03


@pytest.mark.parametrize("tier", TIERS)
def test_plain_matches_pallas_batch_and_ycbcr420(tier, rng):
    """A batch of two with per-image sliders, WB and levels: the words
    against the TPU batch launcher, the 4:2:0 planes against its planes
    and against converting the words."""
    n, h, w = 2, 40, 48
    mosaics = rng.integers(0, 3900, size=(n, h, w), dtype=np.uint16)
    plist = [FULL, dict(exposure=-0.9, saturation=-40.0, vibrance=-0.3)]
    wbs = np.stack([WB, np.array([1.8, 1.0, 1.5], np.float32)])
    cms = np.stack([REAL_MATRIX, np.eye(3, dtype=np.float32)])
    whites = np.array([4000.0, 3900.0], np.float32)
    blacks = np.array([128.0, 60.0], np.float32)
    kw = dict(matrix_transpose=False, gamma="srgb", pattern=XTRANS,
              demosaic=tier, block_h=8, interpret=True)
    jp = jax_pack_params([JaxParams(**d) for d in plist])
    scal = pack_params([EditParams(**d) for d in plist], wbs, cms, whites,
                       blacks, matrix_transpose=False)
    t = torch.from_numpy(mosaics)
    want = pallas_batch_develop_rgba(mosaics, jp, wbs, cms, whites, blacks,
                                     **kw)
    got = fd.fused_batch_develop_rgba(t, scal, gamma="srgb", demosaic=tier,
                                      pattern=XTRANS)
    mx, share = _lsb(got, want)
    print(f"batch {tier}: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1 and share <= 0.03
    for i in range(n):
        assert torch.equal(got[i], fd.fused_develop_rgba(
            t[i], scal[i], gamma="srgb", demosaic=tier, pattern=XTRANS))
    wy, wc = pallas_batch_develop_rgba(mosaics, jp, wbs, cms, whites, blacks,
                                       output="ycbcr420", **kw)
    gy, gc = fd.fused_batch_develop_rgba(t, scal, gamma="srgb",
                                         output="ycbcr420", demosaic=tier,
                                         pattern=XTRANS)
    assert tuple(gy.shape) == (n, h, w) and tuple(gc.shape) == (n, h // 2, w)
    assert gy.dtype == gc.dtype == torch.uint8
    for name, g, tpl in (("Y", gy, wy), ("CbCr", gc, wc)):
        mxp, sharep = _plane_diff(g.numpy(), tpl)
        print(f"ycbcr420 {tier} {name}: max {mxp}, differing {sharep:.2e}")
        assert mxp <= 1
    conv = rgba_words_to_ycbcr420(np.asarray(want))
    for g, c in zip((gy, gc[:, :, 0::2], gc[:, :, 1::2]), conv):
        assert _plane_diff(g.numpy(), c)[0] <= 1


@pytest.mark.parametrize("tier", TIERS)
def test_plain_kernel_form_vs_xla_lane(tier, rng):
    """The two plain forms (the kernels' arithmetic on raw * scale, the
    XLA lane on the normalised mosaic) round apart by at most 1 LSB, also
    on tiny and odd frames (not multiples of 2 or of 6) that the TPU
    kernel refuses."""
    worst, shares = 0, []
    for shape in ((36, 48), (25, 31), (7, 5), (1, 1), (13, 18), (3, 40)):
        mosaic = rng.integers(0, 15871, size=shape, dtype=np.uint16)
        scal = fd.fold_scalars(EditParams(**FULL), WB, REAL_MATRIX, 15871.0,
                               1008.0, False)
        got = fd.fused_develop_rgba(torch.from_numpy(mosaic), scal,
                                    gamma="srgb", demosaic=tier,
                                    pattern=XTRANS)
        want = jd.develop_xtrans(mosaic, JaxParams(**FULL), WB, REAL_MATRIX,
                                 15871.0, 1008.0, pattern=XTRANS,
                                 transfer="srgb", rgba=True,
                                 demosaic_method=tier)
        mx, share = _lsb(got, want)
        worst = max(worst, mx)
        shares.append(share)
    print(f"kernel form vs JAX XLA lane, {tier}: max {worst} LSB, differing "
          f"at most {max(shares):.2e}")
    assert worst <= 1


@pytest.mark.parametrize("tier", TIERS)
def test_constant_mosaic_is_uniform(tier):
    """A constant mosaic develops to one colour: clamp-to-edge values,
    periodic masks and the denominators agree at every edge."""
    scal = fd.fold_scalars(EditParams(), WB, REAL_MATRIX, 4000.0, 100.0,
                           False)
    for shape in ((40, 48), (25, 31)):
        mosaic = torch.from_numpy(np.full(shape, 2000, np.uint16))
        words = fd.fused_develop_rgba(mosaic, scal, gamma="srgb",
                                      demosaic=tier, pattern=XTRANS)
        assert torch.unique(words).numel() == 1
        lane = td.develop_xtrans(mosaic, EditParams(), WB, REAL_MATRIX,
                                 4000.0, 100.0, pattern=XTRANS,
                                 transfer="srgb", rgba=True,
                                 demosaic_method=tier)
        assert torch.equal(words, lane)


def test_masks_are_periodic_values_clamped(rng):
    """The rule of the generic-CFA taps: a frame developed alone equals
    the same frame cut from one edge-padded by a whole period (values
    repeat the edge, masks continue periodically), for the single-stage
    tiers; and differs from a zero-padded one."""
    mosaic = rng.integers(0, 4096, size=(1, 17, 23), dtype=np.uint16)
    scal = fd.fold_scalars(EditParams(**FULL), WB, REAL_MATRIX, 4096.0, 0.0,
                           False)[None]
    for tier in ("nearest", "smooth"):
        alone = fd.fused_batch_develop_rgba(
            torch.from_numpy(mosaic), scal, demosaic=tier, pattern=XTRANS)
        padded = np.pad(mosaic, ((0, 0), (6, 6), (6, 6)), mode="edge")
        big = fd.fused_batch_develop_rgba(
            torch.from_numpy(padded), scal, demosaic=tier, pattern=XTRANS)
        assert torch.equal(alone, big[:, 6:-6, 6:-6])
    zero = np.pad(mosaic, ((0, 0), (6, 6), (6, 6)))
    big = fd.fused_batch_develop_rgba(torch.from_numpy(zero), scal,
                                      demosaic="smooth", pattern=XTRANS)
    assert not torch.equal(alone, big[:, 6:-6, 6:-6])


def test_argument_checks(rng):
    """The TPU launchers' checks, as ``ValueError``s, for the wrappers and
    the plain version alike."""
    m = torch.from_numpy(rng.integers(0, 4096, (2, 12, 18), dtype=np.uint16))
    scal = torch.zeros(2, fd.N_SCALARS)
    bad = [
        (dict(pattern=XTRANS, demosaic="bilinear"), "nearest/smooth/grad"),
        (dict(pattern=XTRANS, demosaic="malvar"), "nearest/smooth/grad"),
        (dict(demosaic="smooth"), "generic-CFA tier"),
        (dict(pattern=SPARSE, demosaic="smooth"), "smooth radius 1"),
        (dict(pattern=SPARSE, demosaic="grad"), "smooth radius 1"),
        (dict(pattern="RBGG", demosaic="grad"), "directional-G radius 1"),
        (dict(pattern=SPARSE, demosaic="nearest"), "offset"),
        (dict(pattern="RGGB", demosaic="nearest"), "offset"),
        (dict(pattern="RGBRGB"), "not square"),
        (dict(pattern="RGBGRBG" * 7), "exceeds"),
        (dict(pattern="RGGG"), "absent"),
        (dict(pattern=XTRANS, demosaic="vng"), "nearest/smooth/grad"),
        (dict(demosaic="vng"), "unknown demosaic"),
    ]
    for kw, match in bad:
        with pytest.raises(ValueError, match=match):
            fd.fused_batch_develop_rgba(m, scal, **kw)
        with pytest.raises(ValueError, match=match):
            fd.check_demosaic(kw.get("demosaic", "nearest"),
                              kw.get("pattern"))
    with pytest.raises(ValueError, match="even H and W"):
        fd.fused_batch_develop_rgba(m[:, :11].contiguous(), scal,
                                    pattern=XTRANS, output="ycbcr420",
                                    demosaic="grad")
    with pytest.raises(ValueError, match="nearest/smooth/grad"):
        fd.develop_rgba_folded_plain(m, scal, demosaic="malvar",
                                     pattern=XTRANS)
    # What is valid: every tier on X-Trans, smooth and grad on a Bayer
    # grid, lower-case letters.
    for tier in TIERS:
        fd.check_demosaic(tier, XTRANS)
        fd.check_demosaic(tier, XTRANS.lower())
    for tier in ("smooth", "grad"):
        fd.check_demosaic(tier, "GRBG")
    assert fd.cfa_tables(XTRANS.lower()) is fd.cfa_tables(XTRANS)


def test_smooth_on_bayer_is_the_bilinear_kernel_form(rng):
    """On a 2x2 pattern the smooth tier equals the Bayer bilinear plain
    version (within 1 LSB: the sums associate differently)."""
    m = torch.from_numpy(rng.integers(0, 4096, (1, 20, 26), dtype=np.uint16))
    scal = fd.fold_scalars(EditParams(**FULL), WB, REAL_MATRIX, 4000.0,
                           100.0, False)[None]
    for pattern, phase in (("RGGB", (0, 0)), ("GBRG", (1, 0))):
        a = fd.fused_batch_develop_rgba(m, scal, gamma="srgb",
                                        demosaic="smooth", pattern=pattern)
        b = fd.fused_batch_develop_rgba(m, scal, phase, "srgb",
                                        demosaic="bilinear")
        d = np.abs(td.rgba_view(a).astype(int) - td.rgba_view(b).astype(int))
        print(f"smooth on {pattern} vs bilinear: max {d.max()} LSB, "
              f"differing {(d > 0).mean():.2e}")
        assert d.max() <= 1


def test_launch_keys_and_counts(rng, monkeypatch):
    """One ``LAUNCHES`` key per output and tier; CPU tensors run the
    plain version and never reach the kernel build or a count."""
    keys = {fd.launch_key(o, t, XTRANS) for o in fd.OUTPUTS for t in TIERS}
    assert keys == {"develop_rgba_cfa_nearest", "develop_rgba_cfa_smooth",
                    "develop_rgba_cfa_grad", "develop_ycbcr420_cfa_nearest",
                    "develop_ycbcr420_cfa_smooth",
                    "develop_ycbcr420_cfa_grad"}
    assert keys <= set(fd.LAUNCHES)
    assert [fd.variant(t, XTRANS) for t in TIERS] == [
        "cfa_nearest", "cfa_smooth", "cfa_grad"]
    assert fd.variant("grad") == "grad"
    assert not keys & {fd.launch_key(o, d) for o in fd.OUTPUTS
                       for d in fd.DEMOSAICS}

    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "load", no_build)
    m = torch.from_numpy(rng.integers(0, 4096, (1, 8, 12), dtype=np.uint16))
    before = dict(fd.LAUNCHES)
    for tier in TIERS:
        for output in fd.OUTPUTS:
            fd.fused_batch_develop_rgba(m, torch.zeros(1, fd.N_SCALARS),
                                        output=output, demosaic=tier,
                                        pattern=XTRANS)
        with pytest.raises(ValueError, match="unsupported device"):
            fd.fused_batch_develop_rgba(
                m.to("meta"), torch.zeros(1, fd.N_SCALARS, device="meta"),
                demosaic=tier, pattern=XTRANS)
    assert fd.LAUNCHES == before


def test_packed_tables_match_the_kernel_struct():
    """``CfaTables.packed`` is the byte layout of ``struct CfaTables`` in
    csrc/cfa_tables.cuh: its size and period limit are the header's, and
    the fields decode back to the tables."""
    src = (_build.CSRC / "cfa_tables.cuh").read_text()
    size = int(re.search(r"sizeof\(CfaTables\) == (\d+)", src).group(1))
    side_max = int(re.search(r"kCfaMaxSide = (\d+);", src).group(1))
    assert side_max == fd.MAX_CFA_SIDE
    order = re.findall(r"^\s+(?:int|unsigned char|float) (\w+)", src, re.M)
    assert order[:6] == ["side", "chan", "tap", "den_h", "den_v", "den2"]
    assert list(fd._TABLES_DTYPE.names) == order[:6]
    for pattern in (XTRANS, "RGBGBRBRG", "GRBG"):
        t = fd.cfa_tables(pattern)
        assert len(t.packed) == size == fd._TABLES_DTYPE.itemsize
        rec = np.frombuffer(t.packed, fd._TABLES_DTYPE)[0]
        n = t.side * t.side
        assert rec["side"] == t.side
        np.testing.assert_array_equal(rec["chan"][:n], t.grid.reshape(-1))
        np.testing.assert_array_equal(rec["den_h"][:n], t.den_h.reshape(-1))
        np.testing.assert_array_equal(rec["den_v"][:n], t.den_v.reshape(-1))
        np.testing.assert_array_equal(rec["den2"][:, :n],
                                      t.den2.reshape(3, -1))
        if t.taps is not None:
            np.testing.assert_array_equal(rec["tap"][:, :n],
                                          t.taps.reshape(3, -1))
    codes = re.search(r"// (0 centre, 1 left, 2 right, 3 up, 4 down)", src)
    assert codes and fd.NEAREST_TAP_CODES == {
        (0, 0): 0, (0, -1): 1, (0, 1): 2, (-1, 0): 3, (1, 0): 4}


@pytest.mark.parametrize("pattern", [XTRANS, "RGGB", "GBRG", "RGBGBRBRG"],
                         ids=["xtrans", "rggb", "gbrg", "3x3"])
def test_grad_kernel_reads_match_jax_site_masks(pattern):
    """What csrc/develop_grad_generic.cu reads of the pattern, held against
    the TPU kernel's trace-time constructions on a window whose global
    origin is not a multiple of the period (a strip's first column minus
    its halo, a band's first row minus its halo):

    - a tap's channel is ``tables.grid`` at the unclamped position modulo
      the period: the lane's own two columns, the column either side, the
      rows above and below (``_site_mask_fn`` at every offset of the 3x3);
    - the denominators are the tables at the pixel's own cell
      (``_tile_consts_fn`` at the TPU kernel's offsets);
    - at every R/B cell the 1-D denominators are 1 or 2, so the kernel's
      exact-reciprocal path serves stage 1 and its division stays unused.

    The tables themselves (``struct CfaTables``) are unchanged; the packed
    bytes are held by test_packed_tables_match_the_kernel_struct."""
    import jax.numpy as jnp

    from raweditor_tpu.ops import cfa_generic as jcg
    from raweditor_tpu.ops import pallas_develop as jp

    tables = fd.cfa_tables(pattern)
    side = tables.side
    grid = jcg.channel_grid(pattern, side, side)
    np.testing.assert_array_equal(tables.grid, grid)
    y0, x0, h, w = 60, 52, 14, 17  # 64 - 4 and 56 - 4: not multiples of 6
    rows = jnp.arange(y0, y0 + h)[:, None] + jnp.zeros((1, w), jnp.int32)
    cols = jnp.arange(x0, x0 + w)[None, :] + jnp.zeros((h, 1), jnp.int32)
    rind, cind = jp._parity_indicators(rows, cols, side)
    mask = jp._site_mask_fn(grid, rind, cind)
    tile = jp._tile_consts_fn(rind, cind)
    yy, xx = np.mgrid[y0:y0 + h, x0:x0 + w]
    for chan in range(3):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                want = np.asarray(mask(chan, dy, dx))
                got = tables.grid[(yy + dy) % side, (xx + dx) % side] == chan
                np.testing.assert_array_equal(got, want)
    g = jcg._CHAN["G"]
    cell = (yy % side, xx % side)
    np.testing.assert_array_equal(
        tables.den_h[cell],
        np.asarray(tile(jcg._periodic_den_1d(grid, g, 1, 1), 0, -1)))
    np.testing.assert_array_equal(
        tables.den_v[cell],
        np.asarray(tile(jcg._periodic_den_1d(grid, g, 1, 0), -1, 0)))
    for chan in (0, 2):
        np.testing.assert_array_equal(
            tables.den2[chan][cell],
            np.asarray(tile(jcg._periodic_den_2d(grid, chan, 1), -1, -1)))
    at_rb = tables.grid != g
    assert set(np.unique(tables.den_h[at_rb])) <= {1.0, 2.0}
    assert set(np.unique(tables.den_v[at_rb])) <= {1.0, 2.0}
    # Rows in which an even-aligned column pair holds two R/B sites (the
    # kernel interpolates a second G there): two of the X-Trans grid's six.
    if side % 2 == 0:
        twice = [bool((at_rb[y, 0::2] & at_rb[y, 1::2]).any())
                 for y in range(side)]
        assert sum(twice) == (2 if pattern == XTRANS else 0)
