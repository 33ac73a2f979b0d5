"""The exact reciprocal division of the X-Trans grad kernel's period-6
march (``exact_quotient`` in ``raweditor_tpu_torch/csrc/exact_quotient.cuh``)
against the IEEE quotient ``x / d``, emulated exactly on the CPU.

For each denominator ``d`` that is not a power of two in ``den2`` of the
patterns the tests use (the X-Trans grid, the 3x3 ``RGBGBRBRG``, the
Bayer ``GRBG``), the four steps run as the card runs them:

    q = RN(x * rcp)                      rcp = RN(1 / d)  (__frcp_rn)
    r = max(RN(q * d - x), -FLT_MAX)     one FMA
    q' = RN(q - r * rcp)                 one FMA

numpy float32 arithmetic gives the correctly rounded products and
quotients; an FMA is its exact value in float64 rounded once to float32
(``q * d - x`` is exact in float64; ``q - r * rcp`` is not always, so
where its float64 value falls on a float32 half-way point the exact sum
is rounded with ``fractions``). Both sides are compared bit for bit.

Covered: every mantissa of one binade (the result scales exactly by
powers of two between underflow and overflow), every subnormal (and a
sixteenth of their negatives), an eighth of the four binades above them,
+-0, +-inf, NaN and the largest finite values. The card test
(``tests/test_torch_cuda.py``, ``tests/exact_quotient_check.cu``) runs
all 2^32 inputs. A denominator
in the kernel's list must pass; one that is left out must fail here,
which says why it is left out (an even one: a subnormal tie).
"""

import re
from fractions import Fraction

import numpy as np
import pytest

from raweditor_tpu_torch.ops import _build
from raweditor_tpu_torch.ops import fused_develop as fd

F32_MAX = np.float32(np.finfo(np.float32).max)
CHUNK = 1 << 21


def _kernel_dens():
    """``kExactQuotientDens`` as the kernel source lists it."""
    text = (_build.CSRC / "exact_quotient.cuh").read_text()
    body = re.search(r"kExactQuotientDens\[\] = \{([^}]*)\}", text).group(1)
    return tuple(float(v.strip().rstrip("f")) for v in body.split(","))


def _pattern_dens():
    """The non-power-of-two values of ``den2`` of the tested patterns."""
    dens = set()
    for pattern in (fd.cfa_generic.XTRANS_PATTERN, "RGBGBRBRG", "GRBG"):
        for d in fd.cfa_tables(pattern).den2.ravel().tolist():
            if not fd._normal_pow2(d):
                dens.add(d)
    return sorted(dens)


def _round_exact(value: Fraction, near: np.float32) -> np.float32:
    """``value`` rounded to the nearest float32, ties to even; ``near`` is
    within an ulp of it."""
    cands = {near, np.nextafter(near, np.float32(np.inf)),
             np.nextafter(near, np.float32(-np.inf))}
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - value),
                                     int(np.float32(c).view(np.uint32)) & 1))
    return np.float32(best)


def _fma32_sum(prod: np.ndarray, addend: np.ndarray, a, b) -> np.ndarray:
    """RN32(a * b + addend) from ``prod`` = a * b (exact in float64)."""
    s64 = prod + addend.astype(np.float64)
    s32 = s64.astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        toward = np.where(s64 > s32, np.float32(np.inf), np.float32(-np.inf))
        nb = np.nextafter(s32, toward.astype(np.float32))
        mid = (s32.astype(np.float64) + nb.astype(np.float64)) / 2
        tie = np.isfinite(s64) & (s64 != s32) & (s64 == mid)
    for i in np.flatnonzero(tie):
        exact = (Fraction(float(a[i])) * Fraction(float(b[i]))
                 + Fraction(float(addend[i])))
        s32[i] = _round_exact(exact, s32[i])
    return s32


def exact_quotient(x: np.ndarray, d: float) -> np.ndarray:
    """The kernel's four steps on float32 ``x``, emulated exactly."""
    d32 = np.float32(d)
    rcp = np.float32(1.0) / d32
    with np.errstate(over="ignore", invalid="ignore", under="ignore"):
        q = x * rcp
        r = (q.astype(np.float64) * np.float64(d32)
             - x.astype(np.float64)).astype(np.float32)
        r = np.fmax(r, -F32_MAX)
        neg_r = -r
        prod = neg_r.astype(np.float64) * np.float64(rcp)
        return _fma32_sum(prod, q, neg_r, np.full_like(q, rcp))


def _inputs():
    """The bit patterns covered on the CPU, in chunks."""
    one = np.arange(0x3F800000, 0x40000000, dtype=np.uint32)  # [1, 2)
    sub = np.arange(0, 0x00800000, dtype=np.uint32)  # +0 and subnormals
    neg = sub[::16] | np.uint32(0x80000000)  # their negatives, sampled
    low = np.arange(0x00800000, 0x02800000, 8, dtype=np.uint32)  # to 2^-122
    special = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0x7F7FFFFF,
                        0xFF7FFFFF, 0x80000000, 0x80000001, 0x00000001],
                       np.uint32)
    for block in (one, sub, neg, low, special):
        for i in range(0, block.size, CHUNK):
            yield block[i:i + CHUNK].view(np.float32)


def _mismatches(d: float):
    """(count, first few inputs) where the sequence differs from x / d."""
    bad, first = 0, []
    for x in _inputs():
        with np.errstate(over="ignore", invalid="ignore", under="ignore"):
            want = x / np.float32(d)
        got = exact_quotient(x, d)
        differ = got.view(np.uint32) != want.view(np.uint32)
        differ &= ~(np.isnan(got) & np.isnan(want))
        bad += int(differ.sum())
        first += x[differ][:3].tolist()
    return bad, first[:3]


def test_the_kernel_lists_only_tested_denominators():
    """The kernel's list names values of the tested patterns' den2, and
    the wrapper's copy of it is the same."""
    assert set(_kernel_dens()) <= set(_pattern_dens())
    assert _kernel_dens() == fd.EXACT_QUOTIENT_DENS
    assert 3.0 in _kernel_dens()  # the X-Trans grid's R and B


@pytest.mark.parametrize("d", _pattern_dens())
def test_exact_quotient_equals_ieee_division(d):
    """Every listed denominator gives the IEEE quotient bit for bit on
    every covered input; every one left out fails somewhere (the even
    ones on a subnormal quotient that is a tie)."""
    bad, first = _mismatches(d)
    if d in _kernel_dens():
        assert bad == 0, f"d={d}: {bad} mismatches, first {first}"
    else:
        assert bad > 0, f"d={d} passes: it could join kExactQuotientDens"
        assert d % 2 == 0


@pytest.mark.parametrize("x, d, want", [
    (-0.0, 3.0, -0.0), (0.0, 3.0, 0.0), (np.inf, 3.0, np.inf),
    (-np.inf, 5.0, -np.inf), (9 * 2.0 ** -149, 3.0, 3 * 2.0 ** -149),
    (1.0, 3.0, float(np.float32(1.0) / np.float32(3.0)))])
def test_exact_quotient_edge_values(x, d, want):
    """The signed zeros and the infinities, which the remainder's sign and
    cap keep, and a quotient exact in the subnormals."""
    got = exact_quotient(np.array([x], np.float32), d)[0]
    assert got.view(np.uint32) == np.float32(want).view(np.uint32)
