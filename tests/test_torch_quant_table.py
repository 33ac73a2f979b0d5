"""The develop kernels' exact quantiser table, on the CPU: the plain
derivation of the thresholds (``fused_develop.quant_thresholds``), the
table built from them (``QuantTable``) and a plain model of the kernels'
bucketed lookup (``QuantTable.lookup``), against the plain quantiser
``_quantize`` and against the JAX package's (the ``q`` of
``raweditor_tpu/ops/pallas_develop.py`` ``_finish_block``).

Contracts: the lookup equals ``_quantize`` exactly (0 LSB) on every value
tried; ``_quantize`` and the JAX quantiser within 1 LSB, the develop
parity tests' tolerance (each test prints its measured difference). The
card sweeps every f32 value in [0, 1] (chip_smoke.py) and the card tests
hold the kernel's lookup against the plain version there
(tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raweditor_tpu.ops.pallas_develop import _finish_block
from raweditor_tpu_torch.ops import _build
from raweditor_tpu_torch.ops import fused_develop as fd

GAMMAS = tuple(fd.GAMMAS)
INT_MAX = 2**31 - 1


@pytest.fixture(scope="module", params=GAMMAS)
def table(request):
    gamma = request.param
    thresholds = fd.quant_thresholds(gamma)
    return gamma, thresholds, fd.QuantTable(thresholds)


def _values(table, rng):
    """A seeded 10**6 f32 in [0, 1], every threshold and +-1..+-4 ulp
    around it, and the special values."""
    gamma, t, _ = table
    sample = torch.from_numpy(rng.uniform(0.0, 1.0, 10**6).astype(np.float32))
    offsets = torch.arange(-4, 5, dtype=torch.int32)
    near = (t[:, None] + offsets[None]).reshape(-1).view(torch.float32)
    return torch.cat([sample, near, _special()])


def _special():
    return torch.tensor(
        [-0.0, 0.0, -1.0, -1e-30, -1e-42, -float("inf"), 1e-45, 1e-40,
         1.1754942e-38, 5e-39, 1.0, 1.0000001, 1.5, 255.0, 3.4e38,
         float("inf")], dtype=torch.float32)


def test_thresholds_strictly_increase(table):
    gamma, t, qt = table
    assert t.dtype == torch.int32 and t.shape == (255,)
    assert bool((t[1:] > t[:-1]).all()), "a code is skipped"
    assert int(t[-1]) < INT_MAX  # _quantize(1.0) reaches 255
    # t_k is where the plain quantiser steps to k
    k = torch.arange(1, 256, dtype=torch.float32)
    assert torch.equal(fd._quantize(t.view(torch.float32), gamma), k)
    assert torch.equal(fd._quantize((t - 1).view(torch.float32), gamma),
                       k - 1)
    print(f"{gamma}: t_1 {float(t[:1].view(torch.float32)):.6g}, "
          f"t_255 {float(t[-1:].view(torch.float32)):.9g}, buckets {qt.n}")


def test_lookup_equals_plain_quantizer(table, rng):
    gamma, _, qt = table
    c = _values(table, rng)
    got = qt.lookup(c)
    want = fd._quantize(c, gamma).to(torch.int64)
    bad = int((got != want).sum())
    print(f"{gamma}: {c.numel()} values, {bad} differ")
    assert bad == 0


def test_no_bucket_holds_more_than_the_compares(table):
    gamma, t, qt = table
    bits = t.to(torch.int64).numpy()
    per = np.bincount((bits >> fd.QUANT_SHIFT) - qt.lo, minlength=qt.n)
    assert per.max() <= fd.QUANT_COMPARES
    assert qt.n <= fd.QUANT_BUCKETS and per.size == qt.n
    # the last bucket holds 1.0, whose code is the top one
    assert (qt.lo + qt.n - 1) << fd.QUANT_SHIFT == 0x3F800000
    assert int(qt.base[-1]) == 255 and int(qt.base[0]) == 0
    print(f"{gamma}: {int((per > 0).sum())} of {qt.n} buckets hold a "
          f"threshold, at most {per.max()}")


def test_packed_table_is_the_kernels_layout(table):
    gamma, t, qt = table
    rec = np.frombuffer(qt.packed, fd._QUANT_DTYPE)[0]
    assert len(qt.packed) == 5456  # static_assert in develop_common.cuh
    assert (rec["lo"], rec["n"]) == (qt.lo, qt.n)
    # no exception: _quantize never decreases on the CPU
    assert len(fd.quant_exceptions(gamma, t)[0]) == 0
    assert rec["next"][0].tolist() == [int(t[0]), int(t[1]), INT_MAX,
                                       INT_MAX]
    assert rec["next"][254].tolist() == [int(t[254])] + [INT_MAX] * 3
    assert rec["next"][255].tolist() == [INT_MAX] * 4
    assert not rec["base"][qt.n:].any()


@pytest.mark.parametrize("where, code", [(1, 100), (2, 100), (-2, 101)])
def test_a_value_off_the_staircase_is_an_exception(monkeypatch, rng, where,
                                                   code):
    """A quantiser that steps down and up again at one value beside a
    threshold (as the card's pow does once in [0, 1] for two transfers),
    or up and down again: the derivation finds the value and the lookup
    takes its code there, whichever crossing the bisection found."""
    plain = fd._quantize
    t = fd.quant_thresholds("srgb")
    dip = int(t[100]) + where  # t_101: the value's code leaves 100 -> 101

    def dipped(c, gamma):
        q = plain(c, gamma)
        bits = c.contiguous().view(torch.int32)
        return torch.where(bits == dip, torch.full_like(q, code), q)

    monkeypatch.setattr(fd, "_quantize", dipped)
    thresholds = fd.quant_thresholds("srgb")
    ex_bits, ex_codes = fd.quant_exceptions("srgb", thresholds)
    assert len(ex_bits) == 1
    qt = fd.QuantTable(thresholds, (ex_bits, ex_codes))
    c = torch.cat([_values(("srgb", thresholds, qt), rng),
                   (torch.arange(-6, 7) + dip).to(torch.int32).view(
                       torch.float32)])
    assert torch.equal(qt.lookup(c), dipped(c, "srgb").to(torch.int64))
    with pytest.raises(ValueError, match="share the code"):
        fd.QuantTable(thresholds, (np.r_[ex_bits, ex_bits + 1],
                                   np.r_[ex_codes, ex_codes]))


def _jax_quantize(c, gamma):
    """The JAX package's quantiser: ``_finish_block`` with an identity
    edit (unit matrix, gain and saturation, no offsets), on r = g = b = c,
    where every stage before the transfer returns c itself (c - luma is
    exact for luma within a factor 2 of c), read from the red byte."""
    sc_vals = np.zeros(24, np.float32)
    sc_vals[[0, 4, 8, 13, 17, 20]] = 1.0

    def sc(i):
        return jnp.float32(sc_vals[i])

    plane = jnp.asarray(c.numpy().reshape(1, -1))
    words = _finish_block(sc, plane, plane, plane, 1, plane.shape[1], gamma,
                          "rgba")
    return torch.from_numpy(np.asarray(words).reshape(-1) & 0xFF).to(
        torch.int64)


def test_lookup_against_the_jax_quantizer(table, rng):
    gamma, _, qt = table
    c = _values(table, rng)
    c = c[torch.isfinite(c)]  # inf - inf in the identity edit's luma
    d = (qt.lookup(c) - _jax_quantize(c, gamma)).abs()
    print(f"{gamma}: lookup vs JAX max {int(d.max())} LSB on "
          f"{float((d > 0).float().mean()):.2e} of {c.numel()} values")
    assert int(d.max()) <= 1


def test_table_refuses_what_it_cannot_hold():
    t = fd.quant_thresholds("srgb")
    with pytest.raises(ValueError, match="non-decreasing"):
        fd.QuantTable(t.flip(0))
    crowded = t.clone()
    crowded[10:13] = crowded[10] + torch.arange(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="bucket holds 3"):
        fd.QuantTable(crowded)
    low = t.clone()
    low[0] = 1  # a threshold among the denormals: too many buckets
    with pytest.raises(ValueError, match="buckets"):
        fd.QuantTable(low)


def test_fused_quantize_on_the_cpu_is_the_plain_version(monkeypatch, rng):
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "load", no_build)
    c = torch.cat([torch.from_numpy(rng.uniform(-0.1, 1.1, 4096).astype(
        np.float32)), _special()])
    for gamma in GAMMAS:
        got = fd.fused_quantize(c, gamma)
        assert got.dtype == torch.uint8 and got.shape == c.shape
        assert torch.equal(got, fd._quantize(c, gamma).to(torch.uint8))
    for bad, exc in ((c.double(), TypeError), (c[::2], ValueError)):
        with pytest.raises(exc):
            fd.fused_quantize(bad)
    with pytest.raises(ValueError, match="gamma"):
        fd.fused_quantize(c, "cube")
