// Fused gradient-weighted develop of a repeating-CFA mosaic (the 6x6
// X-Trans grid) for Hopper (sm_90a): u16 mosaic in, packed RGBA u32
// words or JPEG YCbCr 4:2:0 planes out, in one pass.
//
// Replaces the TPU kernel raweditor_tpu/ops/pallas_develop.py
// (_kernel_flat -> _develop_block -> _demosaic_grad_generic_window with
// _parity_indicators, _site_mask_fn, _tile_consts_fn, _clamp_shift_fns
// and _chroma_refine; then _finish_block, and _emit_ycbcr420 for
// output="ycbcr420"), reached from pallas_develop_rgba and
// pallas_batch_develop_rgba with pattern= and demosaic="grad". Its TPU
// tiling mechanics (_band_realign, _clampw_fn, the roll-mask fast path,
// the lcm(128, side) width pad, the height-pad rescue, the block-height
// cap) have no counterpart here: a block clamps at the true image edge
// itself and takes any (H, W).
//
// The stages (the plain lane is ops/cfa_generic.demosaic_grad_generic):
//   1. G at R/B sites: the 1-D normalised tents (1 2 1) over the G sites
//      of the row and of the column, num / den with den from the
//      pattern's tables, blended by inverse raw gradients
//      1/(|r-l| + 1e-4) and 1/(|d-u| + 1e-4);
//   2. R and B: the masked 3x3 tent of the colour differences (value - G)
//      over the pattern's 2-D denominators, with G added back;
//   3. two chroma refinements (grad_tile.cuh).
// Each stage is a +-1 stencil over the one before, so an output pixel
// sees 4 pixels around it.
//
// The one rule that differs from the Bayer kernel: a tap's VALUE is read
// at coordinates clamped to the image, its site MASK at the unclamped
// coordinates modulo the period, so the mask continues periodically past
// the edge while the value repeats the edge pixel (the plain lane's
// edge-padded values times a periodic mask). The block therefore keeps
// the channel of every local position, in or out of the image, in shared
// memory (CH), next to the cell index of the denominators (CELL).
//
// What bounds it: operations. It moves the bytes of the other develop
// kernels (2 B/px in; 4 B/px RGBA or 1.5 B/px planes out) and needs about
// 140 f32 operations per pixel with the sRGB transfer (50 in the demosaic
// stages, averaged over the 36 X-Trans cells and counting only the taps
// the pattern fills, since a masked tap adds an exact zero: G 5.8, R/B
// 6.8 with their divisions, the refinements 36). The kernel itself sums
// every masked tap, with a select per tap on top, so it does more than
// that. The design is the Bayer grad kernel's: one block of 128
// threads per 32x16 tile, the mosaic over the tile plus a 4-pixel halo
// loaded once, every stage in shared memory over a region that shrinks
// by one pixel, a clamp-free path for tiles whose halo lies inside the
// image. Shared memory: six 24x40-float stage buffers, two byte maps and
// the tables, 26 KB per block. Later work: as for the Bayer kernel, and
// skipping the R/B tents' taps that the pattern never fills.
//
// Numerics: _demosaic_grad_generic_window's operation order on
// raw * scale (tents as (a + b*2) + c, the R/B numerator as column sums
// added left to right), IEEE division, -fmad=false, as the plain PyTorch
// version rounds. The finish tail is develop_common.cuh.

#include "develop_common.cuh"
#include "cfa_tables.cuh"
#include "grad_tile.cuh"

namespace {

template <int GAMMA, bool YCBCR, bool INTERIOR>
__device__ __forceinline__ void grad_cfa_tile(
    const Stages& st, const unsigned char* CH, const unsigned char* CELL,
    const CfaTables& t, const uint16_t* __restrict__ m, const float* sc,
    size_t img, int h, int w, int ty0, int tx0, uint32_t* __restrict__ rgba,
    uint8_t* __restrict__ yplane, uint8_t* __restrict__ cbcr) {
  float* const V = st.V;
  float* const G = st.G;
  float* const R = st.R;
  float* const B = st.B;
  const Frame<INTERIOR> f{ty0 - kHalo, tx0 - kHalo, h, w};

  load_tile(st, f, m, sc[12]);
  __syncthreads();

  // 1. G: directional normalised tents blended by inverse gradients. At
  //    an R/B site the centre adds nothing to the numerators.
  over_region(f.oy, f.ox, 3, 3, [&](int gy, int gx, int i) {
    const float c = V[f.at(i, gy, gx, 0, 0)];
    if (CH[i] == 1) {
      G[i] = c;
      return;
    }
    const float l = V[f.at(i, gy, gx, 0, -1)];
    const float r = V[f.at(i, gy, gx, 0, 1)];
    const float u = V[f.at(i, gy, gx, -1, 0)];
    const float d = V[f.at(i, gy, gx, 1, 0)];
    const float vg2 = 0.0f;  // (the centre, masked) * 2
    const float gh_num =
        ((CH[i - 1] == 1 ? l : 0.0f) + vg2) + (CH[i + 1] == 1 ? r : 0.0f);
    const float gv_num = ((CH[i - kPitch] == 1 ? u : 0.0f) + vg2) +
                         (CH[i + kPitch] == 1 ? d : 0.0f);
    const int cell = CELL[i];
    const float gh = gh_num / t.den_h[cell];
    const float gv = gv_num / t.den_v[cell];
    const float wh = 1.0f / (fabsf(r - l) + kEps);
    const float wv = 1.0f / (fabsf(d - u) + kEps);
    G[i] = (wh * gh + wv * gv) / (wh + wv);
  });
  __syncthreads();

  // 2. R/B: the masked 3x3 tent of value - G, column sums left to right.
  over_region(f.oy, f.ox, 2, 2, [&](int gy, int gx, int i) {
    float num_r = 0.0f;
    float num_b = 0.0f;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      float dr[3], db[3];
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        const int k = f.at(i, gy, gx, dy, dx);
        const float diff = V[k] - G[k];
        const int ch = CH[i + dy * kPitch + dx];
        dr[dy + 1] = ch == 0 ? diff : 0.0f;
        db[dy + 1] = ch == 2 ? diff : 0.0f;
      }
      const float col_r = (dr[0] + dr[1] * 2.0f) + dr[2];
      const float col_b = (db[0] + db[1] * 2.0f) + db[2];
      if (dx == -1) {
        num_r = col_r;
        num_b = col_b;
      } else if (dx == 0) {
        num_r = num_r + col_r * 2.0f;
        num_b = num_b + col_b * 2.0f;
      } else {
        num_r = num_r + col_r;
        num_b = num_b + col_b;
      }
    }
    const int k = f.at(i, gy, gx, 0, 0);
    const float c = V[k];
    const float g = G[k];
    const int ch = CH[i];
    const int cell = CELL[i];
    R[i] = ch == 0 ? c : g + num_r / t.den2[0][cell];
    B[i] = ch == 2 ? c : g + num_b / t.den2[2][cell];
  });
  __syncthreads();

  // 3. The refinements and the finish tail.
  refine_and_finish<GAMMA, YCBCR>(
      st, f, sc, img, ty0, tx0, [&](int, int, int i) { return int(CH[i]); },
      rgba, yplane, cbcr);
}

template <int GAMMA, bool YCBCR>
__global__ void __launch_bounds__(kThreads)
    develop_grad_cfa_tiles(const uint16_t* __restrict__ mosaics,
                           const float* __restrict__ scal, int h, int w,
                           const __grid_constant__ CfaTables tables,
                           uint32_t* __restrict__ rgba,
                           uint8_t* __restrict__ yplane,
                           uint8_t* __restrict__ cbcr) {
  __shared__ float V[kCells], G[kCells], R[kCells], B[kCells], XB[kCells],
      XR[kCells];
  __shared__ unsigned char CH[kCells], CELL[kCells];
  __shared__ CfaTables t;
  const Stages st{V, G, R, B, XB, XR};
  const size_t img = blockIdx.z;
  const float* sc = scal + img * kScalars;
  const uint16_t* m = mosaics + img * static_cast<size_t>(h) * w;
  const int ty0 = blockIdx.y * kTileH;
  const int tx0 = blockIdx.x * kTileW;

  // The tables, then the pattern cell and channel of every local
  // position, periodic in the unclamped global coordinates.
  copy_tables(tables, &t, threadIdx.x, kThreads);
  __syncthreads();
  {
    const int side = t.side;
    const int cy0 = cell_mod(ty0 - kHalo, side);
    const int cx0 = cell_mod(tx0 - kHalo, side);
    for (int k = threadIdx.x; k < kCells; k += kThreads) {
      const int cell =
          ((cy0 + k / kPitch) % side) * side + (cx0 + k % kPitch) % side;
      CELL[k] = static_cast<unsigned char>(cell);
      CH[k] = t.chan[cell];
    }
  }
  // (load_tile's barrier also orders CH and CELL before their readers.)

  // Block-uniform: most tiles of a large frame read no pixel outside it.
  if (tile_is_interior(ty0, tx0, h, w))
    grad_cfa_tile<GAMMA, YCBCR, true>(st, CH, CELL, t, m, sc, img, h, w, ty0,
                                      tx0, rgba, yplane, cbcr);
  else
    grad_cfa_tile<GAMMA, YCBCR, false>(st, CH, CELL, t, m, sc, img, h, w,
                                       ty0, tx0, rgba, yplane, cbcr);
}

template <int GAMMA>
void launch(bool ycbcr, dim3 grid, cudaStream_t st, const uint16_t* mos,
            const float* scal, int h, int w, const CfaTables& tables,
            void* out0, void* out1) {
  if (ycbcr)
    develop_grad_cfa_tiles<GAMMA, true><<<grid, kThreads, 0, st>>>(
        mos, scal, h, w, tables, nullptr, static_cast<uint8_t*>(out0),
        static_cast<uint8_t*>(out1));
  else
    develop_grad_cfa_tiles<GAMMA, false><<<grid, kThreads, 0, st>>>(
        mos, scal, h, w, tables, static_cast<uint32_t*>(out0), nullptr,
        nullptr);
}

}  // namespace

// mosaics (n, h, w) u16, scal (n, 24) f32, contiguous on the device;
// tables: the packed CfaTables bytes on the host. output 0: out0 =
// (n, h, w) u32 RGBA words. output 1: out0 = (n, h, w) u8 Y, out1 =
// (n, h/2, w) u8 interleaved CbCr; h and w must be even. gamma: 0 pow,
// 1 poly, 2 srgb, 3 srgb_poly. Launches on ``stream``, does not
// synchronise, and returns the cudaGetLastError() code.
extern "C" int rtt_develop_grad_cfa_launch(const void* mosaics,
                                           const void* scal, void* out0,
                                           void* out1, int n, int h, int w,
                                           int gamma, int output,
                                           const void* tables, void* stream) {
  if (const int bad = check_args(n, h, w, 0, 0, output)) return bad;
  CfaTables t;
  if (!unpack_tables(tables, &t)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* mos = static_cast<const uint16_t*>(mosaics);
  const auto* sc = static_cast<const float*>(scal);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool ycbcr = output == 1;
  switch (gamma) {
    case kPow: launch<kPow>(ycbcr, grid, st, mos, sc, h, w, t, out0, out1); break;
    case kPoly: launch<kPoly>(ycbcr, grid, st, mos, sc, h, w, t, out0, out1); break;
    case kSrgb: launch<kSrgb>(ycbcr, grid, st, mos, sc, h, w, t, out0, out1); break;
    case kSrgbPoly: launch<kSrgbPoly>(ycbcr, grid, st, mos, sc, h, w, t, out0, out1); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
