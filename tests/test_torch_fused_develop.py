"""The fused develop kernel's plain version and wrappers, on the CPU,
against the TPU kernel run in Pallas interpret mode (the JAX package's
own test style, tests/test_pallas_develop.py).

Contract: <= 1 LSB per channel for RGBA and <= 1 per plane for the
YCbCr 4:2:0 output; each test prints its measured difference. The
kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from raweditor_tpu.ops.develop import rgba_view as jax_rgba_view
from raweditor_tpu.ops.pallas_develop import (
    _fold_scalars,
    pallas_batch_develop_rgba,
    pallas_develop_rgba,
)
from raweditor_tpu.params import EditParams as JaxParams
from raweditor_tpu.parallel.batch import pack_params as jax_pack_params
from raweditor_tpu_torch.color import INV_22, INV_24
from raweditor_tpu_torch.ops import _build
from raweditor_tpu_torch.ops import fused_develop as fd
from raweditor_tpu_torch.ops.develop import rgba_view
from raweditor_tpu_torch.params import EditParams
from raweditor_tpu_torch.parallel.batch import pack_params

WB = np.array([2.07, 1.0, 1.32], np.float32)
IDENTITY = np.eye(3, dtype=np.float32)
REAL = np.array([[1.6, -0.3, -0.3], [-0.2, 1.5, -0.3], [0.0, -0.4, 1.4]],
                np.float32)
FULL = dict(exposure=0.6, contrast=8.0, highlights=-0.4, shadows=0.3,
            whites=1.05, blacks=0.04, saturation=25.0, vibrance=0.5,
            temperature=0.2, tint=-0.1)
BATCH_PARAMS = [FULL, {}, dict(exposure=-1.3, saturation=-60.0,
                               vibrance=-0.7, temperature=-0.4)]
GAMMAS = ("pow", "poly", "srgb", "srgb_poly")
PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))


def _lsb(got, want):
    d = np.abs(rgba_view(got).astype(int) - jax_rgba_view(want).astype(int))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("transpose", [True, False])
def test_fold_scalars_match(seed, transpose):
    rng = np.random.default_rng(seed)
    d = {k: float(v * rng.uniform(0.2, 1.5)) for k, v in FULL.items()}
    cam = REAL * np.float32(rng.uniform(0.8, 1.2))
    white, black = float(rng.uniform(3000, 16000)), float(rng.uniform(0, 600))
    want = np.asarray(_fold_scalars(JaxParams(**d), WB, cam, white, black,
                                    transpose))
    got = fd.fold_scalars(EditParams(**d), WB, cam, white, black,
                          transpose).numpy()
    assert got.shape == (fd.N_SCALARS,) and got.dtype == np.float32
    print(f"fold_scalars: max rel diff "
          f"{np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)):.2e}")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("gamma", GAMMAS)
def test_plain_matches_pallas_single(gamma, rng):
    """All four Bayer phases, accurate-style levels and matrix."""
    mosaic = rng.integers(100, 16000, size=(32, 48), dtype=np.uint16)
    scal = _fold_scalars(JaxParams(**FULL), WB, REAL, 16000.0, 100.0, False)
    t_scal = fd.scalars_from_numpy(np.asarray(scal)[None])[0]
    for phase in PHASES:
        want = pallas_develop_rgba(mosaic, JaxParams(**FULL), WB, REAL,
                                   white_level=16000.0, black_level=100.0,
                                   matrix_transpose=False, interpret=True,
                                   cfa_phase=phase, gamma=gamma)
        got = fd.fused_develop_rgba(torch.from_numpy(mosaic), t_scal, phase,
                                    gamma)
        mx, share = _lsb(got, want)
        print(f"single {gamma} {phase}: max {mx} LSB, differing {share:.2e}")
        assert mx <= 1 and share <= 0.01


def _batch_inputs(rng, n=3, h=32, w=64):
    mosaics = rng.integers(0, 4096, size=(n, h, w), dtype=np.uint16)
    wbs = np.stack([WB, np.array([1.8, 1.0, 1.5], np.float32),
                    np.ones(3, np.float32)])[:n]
    cms = np.stack([IDENTITY, REAL, IDENTITY])[:n]
    whites = np.array([4096.0, 4000.0, 3800.0], np.float32)[:n]
    blacks = np.array([0.0, 128.0, 60.0], np.float32)[:n]
    return mosaics, wbs, cms, whites, blacks


@pytest.mark.parametrize("gamma", GAMMAS)
@pytest.mark.parametrize("phase", [(0, 0), (1, 1)])
def test_plain_matches_pallas_batch(gamma, phase, rng):
    mosaics, wbs, cms, whites, blacks = _batch_inputs(rng)
    jp = jax_pack_params([JaxParams(**d) for d in BATCH_PARAMS])
    want = pallas_batch_develop_rgba(mosaics, jp, wbs, cms, whites, blacks,
                                     interpret=True, cfa_phase=phase,
                                     gamma=gamma)
    scal = pack_params([EditParams(**d) for d in BATCH_PARAMS], wbs, cms,
                       whites, blacks)
    got = fd.fused_batch_develop_rgba(torch.from_numpy(mosaics), scal, phase,
                                      gamma)
    assert got.dtype == torch.uint32 and tuple(got.shape) == mosaics.shape
    mx, share = _lsb(got, want)
    print(f"batch {gamma} {phase}: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1 and share <= 0.01


@pytest.mark.parametrize("gamma", ["pow", "srgb_poly"])
def test_ycbcr420_matches_pallas(gamma, rng):
    mosaics, wbs, cms, whites, blacks = _batch_inputs(rng)
    jp = jax_pack_params([JaxParams(**d) for d in BATCH_PARAMS])
    wy, wc = pallas_batch_develop_rgba(mosaics, jp, wbs, cms, whites, blacks,
                                       interpret=True, gamma=gamma,
                                       output="ycbcr420")
    scal = pack_params([EditParams(**d) for d in BATCH_PARAMS], wbs, cms,
                       whites, blacks)
    gy, gc = fd.fused_batch_develop_rgba(torch.from_numpy(mosaics), scal,
                                         gamma=gamma, output="ycbcr420")
    n, h, w = mosaics.shape
    assert tuple(gy.shape) == (n, h, w) and tuple(gc.shape) == (n, h // 2, w)
    for name, g, t in (("Y", gy, wy), ("CbCr", gc, wc)):
        d = np.abs(g.numpy().astype(int) - np.asarray(t).astype(int))
        print(f"ycbcr420 {gamma} {name}: max {d.max()}, "
              f"differing {(d > 0).mean():.2e}")
        assert d.max() <= 1


def test_pack_params_matches_jax_vmap(rng):
    _, wbs, cms, whites, blacks = _batch_inputs(rng)
    import functools

    import jax

    want = jax.vmap(functools.partial(_fold_scalars, matrix_transpose=True))(
        jax_pack_params([JaxParams(**d) for d in BATCH_PARAMS]), wbs, cms,
        whites, blacks)
    got = pack_params([EditParams(**d) for d in BATCH_PARAMS], wbs, cms,
                      whites, blacks)
    assert tuple(got.shape) == (3, fd.N_SCALARS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_odd_frame_rgba(rng):
    """Odd H and W (ragged quads on the card): clamp-to-edge at the true
    edge, equal to developing the edge-padded frame, and within 1 LSB of
    the TPU kernel."""
    mosaic = rng.integers(0, 4096, size=(1, 15, 21), dtype=np.uint16)
    scal = pack_params([EditParams(**FULL)], WB[None], IDENTITY[None])
    got = fd.fused_batch_develop_rgba(torch.from_numpy(mosaic), scal)
    big = fd.fused_batch_develop_rgba(
        torch.from_numpy(np.pad(mosaic, ((0, 0), (0, 1), (0, 1)),
                                mode="edge")), scal)
    np.testing.assert_array_equal(got.numpy(), big.numpy()[:, :-1, :-1])
    want = pallas_develop_rgba(mosaic[0], JaxParams(**FULL), WB, IDENTITY,
                               interpret=True)
    mx, share = _lsb(got[0], want)
    print(f"odd frame: max {mx} LSB, differing {share:.2e}")
    assert mx <= 1


def test_wrapper_rejects_bad_inputs(rng):
    """No fallback: wrong dtype, shape, layout or mode raises."""
    m = torch.from_numpy(rng.integers(0, 4096, (2, 8, 10), dtype=np.uint16))
    scal = torch.zeros(2, fd.N_SCALARS)
    fd.fused_batch_develop_rgba(m, scal)  # the valid baseline
    bad = [
        (m.to(torch.int32), scal, {}),
        (m, scal.double(), {}),
        (m, scal[:1], {}),
        (m.transpose(1, 2), scal, {}),
        (m[:, :, ::2], scal, {}),
        (m[:, :7].contiguous(), scal, {"output": "ycbcr420"}),
        (m[:, :, :9].contiguous(), scal, {"output": "ycbcr420"}),
        (m, scal, {"gamma": "cube"}),
        (m, scal, {"output": "nv21"}),
        (m, scal, {"cfa_phase": (2, 0)}),
        (m[0], scal, {}),
    ]
    for mos, sc, kw in bad:
        with pytest.raises((TypeError, ValueError)):
            fd.fused_batch_develop_rgba(mos, sc, **kw)
    with pytest.raises(ValueError):
        fd.fused_develop_rgba(m, scal[0])


def test_cpu_tensors_never_launch(rng):
    m = torch.from_numpy(rng.integers(0, 4096, (1, 8, 8), dtype=np.uint16))
    before = dict(fd.LAUNCHES)
    fd.fused_batch_develop_rgba(m, torch.zeros(1, fd.N_SCALARS))
    assert fd.LAUNCHES == before


def test_kernel_constants_match_python():
    """The hex-float literals in csrc/develop.cu are the f32 polynomial
    and exponent constants of the plain version."""
    src = (Path(_build.CSRC) / "develop.cu").read_text()

    def table(name):
        body = re.search(name + r"\[7\] = \{([^}]*)\}", src).group(1)
        return [float.fromhex(t.strip().rstrip("f")) for t in body.split(",")]

    assert table("GAMMA_POLY255") == [float(k) for k in fd.GAMMA_POLY255]
    assert table("SRGB_POLY255") == [float(k) for k in fd.SRGB_POLY255]
    for name, value in (("INV_22", INV_22), ("INV_24", INV_24),
                        ("SRGB_LIN255", fd.SRGB_LIN255)):
        lit = re.search(rf"{name} = ([^;]*);", src).group(1)
        assert float.fromhex(lit.rstrip("f")) == value, name


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
