// The warp march shared by the band kernels (the two gradient develop
// kernels through grad_tile.cuh, the generic-CFA quad stencils of
// develop.cu, the finish-extras kernel extras.cu): what a lane holds, how
// it reaches its neighbours, and how a stage clamps at the image edge.
//
// One WARP owns a strip of 64 adjacent columns, a lane two of them (a
// Pair: a at the lane's first column x0, b at x0 + 1), and walks down a
// band of rows, one input row per step. Every stencil stage keeps its last
// three rows in registers (Win3), so vertical taps touch no memory;
// horizontal neighbours come by __shfl_sync, which moves bits and rounds
// nothing. The outermost columns of a strip are halo, as many as the
// kernel's stages are deep: they are computed and not stored. Warps share
// no stage, so there is no shared stage buffer and no block barrier
// between stages (only tables are copied to shared memory at the start),
// and lane = column pair, loop = row leaves no division or modulo per item.
//
// Clamp-to-edge: every stage reads the stage below at coordinates
// clamped to the image. Rows: a stage's row -1 is its row 0 and its row
// h is its row h-1, so the first in-image row fills the whole window and
// past the last one the newest row is pushed again (Win3::push<ROWS>,
// warp-uniform branches, and only in bands that reach the top or bottom
// edge). Columns: a lane whose column lies outside the image holds, at
// EVERY stage, the value of the nearest in-image column of that stage
// (clamp_columns, four shuffles per value); only strips that touch the
// left or right image edge pay for it (EDGE), the others take the same
// code without it. A value loaded at clamped coordinates, and anything
// computed from it pixel by pixel, needs neither.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpCols = 64;  // two per lane
constexpr unsigned kAllLanes = 0xffffffffu;

// One value for each of the lane's two columns: a at the lane's first
// column x0, b at x0 + 1.
struct Pair {
  float a, b;
};

__device__ __forceinline__ Pair operator-(const Pair& x, const Pair& y) {
  return {x.a - y.a, x.b - y.b};
}

// The value left of column a (the lane below's b) and right of column b
// (the lane above's a).
__device__ __forceinline__ float left_of_a(const Pair& v) {
  return __shfl_up_sync(kAllLanes, v.b, 1);
}
__device__ __forceinline__ float right_of_b(const Pair& v) {
  return __shfl_down_sync(kAllLanes, v.a, 1);
}

// Where a lane's columns sit, and for a strip at the left or right image
// edge the lane and half (0 = a, 1 = b) that hold the nearest in-image
// column of each.
template <bool EDGE>
struct Lane {
  int x0;
  int src_a, src_b;
  bool half_a, half_b;
};

// The first column x0 of the calling lane in the strip whose first column
// (halo included) is `first`.
__device__ __forceinline__ int lane_column(int first) {
  return first + 2 * static_cast<int>(threadIdx.x & 31);
}

template <bool EDGE>
__device__ __forceinline__ Lane<EDGE> make_lane(int first, int w) {
  Lane<EDGE> ln{};
  ln.x0 = lane_column(first);
  if constexpr (EDGE) {
    const int ca = min(max(ln.x0, 0), w - 1) - first;
    const int cb = min(max(ln.x0 + 1, 0), w - 1) - first;
    ln.src_a = ca >> 1;
    ln.half_a = ca & 1;
    ln.src_b = cb >> 1;
    ln.half_b = cb & 1;
  }
  return ln;
}

// Columns outside the image take the stage's value at the nearest
// in-image column; in-image columns read themselves.
template <bool EDGE>
__device__ __forceinline__ void clamp_columns(const Lane<EDGE>& ln, Pair& v) {
  if constexpr (EDGE) {
    const float aa = __shfl_sync(kAllLanes, v.a, ln.src_a);
    const float ab = __shfl_sync(kAllLanes, v.b, ln.src_a);
    const float ba = __shfl_sync(kAllLanes, v.a, ln.src_b);
    const float bb = __shfl_sync(kAllLanes, v.b, ln.src_b);
    v.a = ln.half_a ? ab : aa;
    v.b = ln.half_b ? bb : ba;
  }
}

// The last three rows of one stage: rows r-1, r, r+1 of the row r that
// the stage above computes next.
struct Win3 {
  Pair up, mid, dn;
  // Pushes row `row` of an image of h rows. In a band that touches the
  // top or bottom image edge (ROWS) row 0 also stands for row -1 (`v` of
  // an earlier row is never read) and rows past h-1 repeat row h-1.
  template <bool ROWS>
  __device__ __forceinline__ void push(Pair v, int row, int h) {
    if constexpr (ROWS) {
      if (row >= h) v = dn;
      if (row <= 0) up = mid = dn = v;
    }
    up = mid;
    mid = dn;
    dn = v;
  }
};

// The 3x3 tent (1 2 1)x(1 2 1)/16 over a window: the column pass on the
// lane's own columns, then the row pass over the neighbours' sums.
__device__ __forceinline__ Pair tent3(const Win3& x) {
  const Pair s{(x.up.a + x.mid.a * 2.0f) + x.dn.a,
               (x.up.b + x.mid.b * 2.0f) + x.dn.b};
  const float l = left_of_a(s);
  const float r = right_of_b(s);
  return {((l + s.a * 2.0f) + s.b) * 0.0625f,
          ((s.a + s.b * 2.0f) + r) * 0.0625f};
}

// x / d for two quotients at once. A tent's denominator is a small
// integer, often a power of two, and x * (1/d) with an exact 1/d is the
// same correctly rounded value as x / d; so where every lane's
// denominators are normal powers of two (a vote, so the warp stays
// together) two multiplies replace two IEEE divisions.
__device__ __forceinline__ bool pow2(float d) {
  const unsigned bits = __float_as_uint(d);
  const unsigned e = bits >> 23;  // the sign bit must be clear too
  return (bits & 0x007fffffu) == 0 && e >= 1 && e <= 253;
}
__device__ __forceinline__ void divide2(float x0, float d0, float x1,
                                        float d1, float& q0, float& q1) {
  if (__all_sync(kAllLanes, pow2(d0) && pow2(d1))) {
    q0 = x0 * __uint_as_float(0x7f000000u - __float_as_uint(d0));
    q1 = x1 * __uint_as_float(0x7f000000u - __float_as_uint(d1));
  } else {
    q0 = x0 / d0;
    q1 = x1 / d1;
  }
}

// One mosaic row of the lane's two columns as u16 pairs (low half: a),
// from the row clamped to the image; the columns clamped too for EDGE.
template <bool EDGE>
__device__ __forceinline__ uint32_t load_pair(const uint16_t* __restrict__ m,
                                              const Lane<EDGE>& ln, int row,
                                              int h, int w, bool aligned) {
  const uint16_t* p =
      m + static_cast<size_t>(min(max(row, 0), h - 1)) * w;
  if constexpr (EDGE) {
    const uint32_t lo = __ldg(p + min(max(ln.x0, 0), w - 1));
    const uint32_t hi = __ldg(p + min(max(ln.x0 + 1, 0), w - 1));
    return lo | (hi << 16);
  } else {
    if (aligned) return __ldg(reinterpret_cast<const uint32_t*>(p + ln.x0));
    const uint32_t lo = __ldg(p + ln.x0);
    const uint32_t hi = __ldg(p + ln.x0 + 1);
    return lo | (hi << 16);
  }
}

}  // namespace
