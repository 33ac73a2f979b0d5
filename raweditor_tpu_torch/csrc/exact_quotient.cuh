// Division by a small integer denominator through its reciprocal, bit for
// bit the IEEE quotient: the period-6 site of the X-Trans grad kernel
// (develop_grad_generic.cu) divides stage 2's numerators by the 2-D tent
// denominators this way.
//
// IEEE division on the card is a reciprocal, a refinement and a range
// check with a slow path: about ten instructions and a branch. With the
// correctly rounded reciprocal rcp = RN(1/d) in hand, q = RN(x * rcp) is
// within an ulp of x / d, the remainder x - q*d is exact in one FMA, and
// a second FMA rounds the corrected quotient once (Markstein's theorem):
// four instructions. The theorem leaves out what an exhaustive check
// finds, so the sequence is used only for the denominators listed in
// kExactQuotientDens (and powers of two, whose reciprocal is exact), each
// proved over every f32 numerator: tests/test_torch_exact_quotient.py on
// the CPU (one binade, the subnormal and near-underflow range, the zeros
// and infinities) and tests/exact_quotient_check.cu on the card (all
// 2^32 inputs). What the check found:
// - the remainder is formed as -(q*d - x), not as x - q*d: for x = -0
//   that gives -0 + -0 = -0 for the quotient, where the other sign gives
//   +0 against the IEEE -0;
// - the remainder is capped from below at -FLT_MAX: for an infinite x it
//   is NaN (inf - inf), and the cap gives back the infinite q;
// - an even denominator that is not a power of two (6 and 10, on the 3x3
//   pattern and as G's on the X-Trans grid) fails where the quotient is a
//   subnormal exactly half-way between two (x = 9 * 2^-149, d = 6: the
//   IEEE quotient rounds the tie to even, the sequence does not), so
//   those keep the IEEE division. An odd one has no such tie.
//
// Numerics: every step is an explicit round-to-nearest intrinsic, so
// -fmad=false changes nothing here.

#pragma once

#include <cuda_runtime.h>

namespace {

// The denominators other than powers of two that exact_quotient() divides
// by exactly: the odd values of den2 on the X-Trans grid (3) and on the
// 3x3 pattern (5).
constexpr float kExactQuotientDens[] = {3.0f, 5.0f};

// x / d, bit for bit, for d a normal power of two or in
// kExactQuotientDens, given rcp = RN(1/d) (__frcp_rn).
__device__ __forceinline__ float exact_quotient(float x, float d, float rcp) {
  const float q = __fmul_rn(x, rcp);
  const float r = fmaxf(__fmaf_rn(q, d, -x), -0x1.fffffep127f);
  return __fmaf_rn(-r, rcp, q);
}

}  // namespace
