// The per-cell tables of a square repeating colour-filter pattern (the
// 6x6 X-Trans grid, any period up to 6x6) that the generic-CFA develop
// kernels read (develop.cu, develop_grad_generic.cu).
//
// They replace what the TPU kernel raweditor_tpu/ops/pallas_develop.py
// builds at trace time from the pattern string: the nearest-site select
// masks of _develop_block, and _parity_indicators / _site_mask_fn /
// _tile_consts_fn for the smooth and grad tiers. The host fills them
// from the port's own cfa_generic helpers (ops/fused_develop.CfaTables,
// which packs exactly this layout) and the launchers pass the struct to
// the kernel by value, so no global symbol is shared between launches or
// streams; each block copies it to shared memory, where lanes that read
// different cells do not serialise.
//
// Every table is indexed by the pixel's own cell,
// (y mod side) * side + (x mod side), in global image coordinates.

#pragma once

#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kCfaMaxSide = 6;
constexpr int kCfaCells = kCfaMaxSide * kCfaMaxSide;

struct CfaTables {
  int side;                            // period, 1..6
  unsigned char chan[kCfaCells];       // 0 = R, 1 = G, 2 = B
  // Per channel the tap of the nearest site of that channel:
  // 0 centre, 1 left, 2 right, 3 up, 4 down.
  unsigned char tap[3][kCfaCells];
  float den_h[kCfaCells];              // G, 1-D tent (1 2 1) along the row
  float den_v[kCfaCells];              // G, 1-D tent along the column
  float den2[3][kCfaCells];            // per channel, 3x3 tent
};
static_assert(sizeof(CfaTables) == 868, "CfaTables layout");

// a mod side, in 0..side-1 for a negative a too.
__device__ __forceinline__ int cell_mod(int a, int side) {
  const int r = a % side;
  return r < 0 ? r + side : r;
}

// The channels of the cell columns c0 and c1 over the period's rows, two
// bits each at bit 4 * (cell row) + 2 * half (half 0: c0, half 1: c1):
// what a lane of the band kernels keeps of its two columns for a band.
__device__ __forceinline__ unsigned pack_channels(const CfaTables& t, int c0,
                                                  int c1) {
  unsigned bits = 0;
  for (int y = 0; y < t.side; ++y) {
    const unsigned char* row = t.chan + y * t.side;
    bits |= (static_cast<unsigned>(row[c0]) |
             (static_cast<unsigned>(row[c1]) << 2))
            << (4 * y);
  }
  return bits;
}
__device__ __forceinline__ int channel_at(unsigned bits, int row, int half) {
  return (bits >> (4 * row + 2 * half)) & 3u;
}

// Block-cooperative copy of the by-value kernel parameter into shared
// memory; the caller synchronises.
__device__ __forceinline__ void copy_tables(const CfaTables& from,
                                            CfaTables* to, int tid,
                                            int threads) {
  const int* src = reinterpret_cast<const int*>(&from);
  int* dst = reinterpret_cast<int*>(to);
  for (int i = tid; i < static_cast<int>(sizeof(CfaTables) / sizeof(int));
       i += threads)
    dst[i] = src[i];
}

// Reads the packed host bytes; false when the period is out of range.
inline bool unpack_tables(const void* packed, CfaTables* out) {
  if (packed == nullptr) return false;
  std::memcpy(out, packed, sizeof(CfaTables));
  return out->side >= 1 && out->side <= kCfaMaxSide;
}

}  // namespace
