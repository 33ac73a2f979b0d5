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
from raweditor_tpu_torch.ops import fused_develop as fd
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
        assert _words_diff(got, want) <= 1
        # and against the plain version on the CPU
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
    for g, w in ((y, wy), (cbcr, wc)):
        assert int((g.int() - w.int()).abs().max()) <= 1


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
