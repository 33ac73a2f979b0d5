// Fused gradient-weighted Bayer develop for Hopper (sm_90a): u16 mosaic
// in, packed RGBA u32 words or JPEG YCbCr 4:2:0 planes out, in one pass.
//
// Replaces the TPU kernel raweditor_tpu/ops/pallas_develop.py
// (_kernel_flat -> _develop_block -> _demosaic_grad_window with
// _clamp_shift_fns and _chroma_refine; then _finish_block, and
// _emit_ycbcr420 for output="ycbcr420"), reached from pallas_develop_rgba
// and pallas_batch_develop_rgba with demosaic="grad". Its TPU tiling
// mechanics (_band_realign, _clampw_fn, the width and height pad rescues,
// _grad_block_height) have no counterpart here: a block clamps at the
// true image edge itself and takes any (H, W).
//
// The stages (the XLA lane is ops/cfa_generic.demosaic_grad_generic):
//   1. G at R/B sites: the horizontal and vertical neighbour means
//      blended by inverse raw gradients, 1/(|r-l| + 1e-4);
//   2. R and B by colour differences (value - G) from the row pair, the
//      column pair or the diagonal quad, with G added back;
//   3. two chroma refinements: a 3x3 tent over R-G and B-G (column pass,
//      then row pass, then /16), each channel rebuilt from its own sites.
// Each stage is a +-1 stencil over the one before, so an output pixel
// sees 4 pixels around it.
//
// What bounds it: operations, narrowly. It moves the same bytes as the
// quad kernel (2 B/px in; 4 B/px RGBA or 1.5 B/px planes out: 145 MB or
// 79 MB per 24 MP frame, 0.043 ms or 0.024 ms at 3.35 TB/s) but does at
// least 140 f32 operations per pixel with the sRGB transfer (52 of them
// in the demosaic stages, two divisions among them), about 0.05 ms per
// frame at the card's 67 TFLOP/s f32 rate. The design keeps every
// intermediate stage out of device memory: one block of 128 threads owns
// a 32x16-pixel output tile (even origin), loads the mosaic over the tile
// plus a 4-pixel halo once, and computes each stage in shared memory over
// a region that shrinks by one pixel per stage (G over the tile+3, R/B
// over tile+2, refinement 1 over tile+1, refinement 2 over the tile),
// recomputing the halo ring of each stage instead of exchanging it
// between blocks (about 1.4x the interior work at this tile size). The
// finish tail then runs one 2x2 quad per thread, so the YCbCr output
// works as in develop.cu. Shared memory: six 24x40-float stage buffers,
// 23 KB per block. Later work: larger tiles or a sliding row window to
// cut the halo recompute, vector loads.
//
// Clamp-to-edge: every stage reads its neighbours at coordinates clamped
// to the image before it looks up the stage below (Frame::at). Padding
// the mosaic once would be wrong for composed stages: the clamp must
// hold at every stage, as in the TPU kernel's per-shift edge fixups. A
// tile at the image edge therefore holds each earlier stage at every
// clamped in-image position it reads; stage values at positions outside
// the image are computed but never read. A tile whose halo lies inside
// the image (all but about 2% of a 24 MP frame's tiles) takes the same
// code without the clamps, which cost more integer work than the f32
// stages themselves; both read the same values.
//
// Numerics: _demosaic_grad_window's operation order on raw * scale, the
// black level folded into the finish offset (the gradient weights see
// raw differences, where the offset cancels). IEEE division (nvcc's
// default -prec-div=true) and -fmad=false, as the plain PyTorch version
// rounds. The finish tail is develop_common.cuh.

#include "develop_common.cuh"
#include "grad_tile.cuh"

namespace {

template <int GAMMA, bool YCBCR, bool INTERIOR>
__device__ __forceinline__ void grad_tile(
    const Stages& st, const uint16_t* __restrict__ m, const float* sc,
    size_t img, int h, int w, int py, int px, int ty0, int tx0,
    uint32_t* __restrict__ rgba, uint8_t* __restrict__ yplane,
    uint8_t* __restrict__ cbcr) {
  float* const V = st.V;
  float* const G = st.G;
  float* const R = st.R;
  float* const B = st.B;
  const Frame<INTERIOR> f{ty0 - kHalo, tx0 - kHalo, h, w};

  // Site classes in global coordinates (the phase applied).
  auto ye = [&](int gy) { return ((gy + py) & 1) == 0; };
  auto xe = [&](int gx) { return ((gx + px) & 1) == 0; };

  load_tile(st, f, m, sc[12]);
  __syncthreads();

  // 1. G: directional means blended by inverse gradients.
  over_region(f.oy, f.ox, 3, 3, [&](int gy, int gx, int i) {
    const float c = V[f.at(i, gy, gx, 0, 0)];
    if (ye(gy) != xe(gx)) {
      G[i] = c;
      return;
    }
    const float l = V[f.at(i, gy, gx, 0, -1)];
    const float r = V[f.at(i, gy, gx, 0, 1)];
    const float u = V[f.at(i, gy, gx, -1, 0)];
    const float d = V[f.at(i, gy, gx, 1, 0)];
    const float wh = 1.0f / (fabsf(r - l) + kEps);
    const float wv = 1.0f / (fabsf(d - u) + kEps);
    G[i] = (wh * ((l + r) * 0.5f) + wv * ((u + d) * 0.5f)) / (wh + wv);
  });
  __syncthreads();

  // 2. R/B by colour differences; diff is exactly 0 at G sites.
  over_region(f.oy, f.ox, 2, 2, [&](int gy, int gx, int i) {
    auto diff = [&](int dy, int dx) {
      const int k = f.at(i, gy, gx, dy, dx);
      return V[k] - G[k];
    };
    const int k = f.at(i, gy, gx, 0, 0);
    const float c = V[k];
    const float g = G[k];
    const float hpair = (diff(0, -1) + diff(0, 1)) * 0.5f;
    const float vpair = (diff(-1, 0) + diff(1, 0)) * 0.5f;
    const float diag = ((diff(-1, -1) + diff(1, -1)) +
                        (diff(-1, 1) + diff(1, 1))) *
                       0.25f;
    const bool y_even = ye(gy);
    const bool x_even = xe(gx);
    R[i] = y_even ? (x_even ? c : g + hpair) : (x_even ? g + vpair : g + diag);
    B[i] = y_even ? (x_even ? g + diag : g + vpair) : (x_even ? g + hpair : c);
  });
  __syncthreads();

  // 3. The refinements and the finish tail; G sites are where the row
  //    and column parities differ, R where both are even.
  refine_and_finish<GAMMA, YCBCR>(
      st, f, sc, img, ty0, tx0,
      [&](int gy, int gx, int) { return ye(gy) != xe(gx) ? 1 : (ye(gy) ? 0 : 2); },
      rgba, yplane, cbcr);
}

template <int GAMMA, bool YCBCR>
__global__ void __launch_bounds__(kThreads)
    develop_grad_tiles(const uint16_t* __restrict__ mosaics,
                       const float* __restrict__ scal, int h, int w, int py,
                       int px, uint32_t* __restrict__ rgba,
                       uint8_t* __restrict__ yplane,
                       uint8_t* __restrict__ cbcr) {
  __shared__ float V[kCells], G[kCells], R[kCells], B[kCells], XB[kCells],
      XR[kCells];
  const Stages st{V, G, R, B, XB, XR};
  const size_t img = blockIdx.z;
  const float* sc = scal + img * kScalars;
  const uint16_t* m = mosaics + img * static_cast<size_t>(h) * w;
  const int ty0 = blockIdx.y * kTileH;
  const int tx0 = blockIdx.x * kTileW;
  // Block-uniform: most tiles of a large frame read no pixel outside it.
  if (tile_is_interior(ty0, tx0, h, w))
    grad_tile<GAMMA, YCBCR, true>(st, m, sc, img, h, w, py, px, ty0, tx0,
                                  rgba, yplane, cbcr);
  else
    grad_tile<GAMMA, YCBCR, false>(st, m, sc, img, h, w, py, px, ty0, tx0,
                                   rgba, yplane, cbcr);
}

template <int GAMMA>
void launch(bool ycbcr, dim3 grid, cudaStream_t st, const uint16_t* mos,
            const float* scal, int h, int w, int py, int px, void* out0,
            void* out1) {
  if (ycbcr)
    develop_grad_tiles<GAMMA, true><<<grid, kThreads, 0, st>>>(
        mos, scal, h, w, py, px, nullptr, static_cast<uint8_t*>(out0),
        static_cast<uint8_t*>(out1));
  else
    develop_grad_tiles<GAMMA, false><<<grid, kThreads, 0, st>>>(
        mos, scal, h, w, py, px, static_cast<uint32_t*>(out0), nullptr,
        nullptr);
}

}  // namespace

// mosaics (n, h, w) u16, scal (n, 24) f32, contiguous on the device.
// output 0: out0 = (n, h, w) u32 RGBA words. output 1: out0 = (n, h, w)
// u8 Y, out1 = (n, h/2, w) u8 interleaved CbCr; h and w must be even.
// gamma: 0 pow, 1 poly, 2 srgb, 3 srgb_poly. Launches on ``stream``,
// does not synchronise, and returns the cudaGetLastError() code.
extern "C" int rtt_develop_grad_launch(const void* mosaics, const void* scal,
                                       void* out0, void* out1, int n, int h,
                                       int w, int py, int px, int gamma,
                                       int output, void* stream) {
  if (const int bad = check_args(n, h, w, py, px, output)) return bad;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* mos = static_cast<const uint16_t*>(mosaics);
  const auto* sc = static_cast<const float*>(scal);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool ycbcr = output == 1;
  switch (gamma) {
    case kPow: launch<kPow>(ycbcr, grid, st, mos, sc, h, w, py, px, out0, out1); break;
    case kPoly: launch<kPoly>(ycbcr, grid, st, mos, sc, h, w, py, px, out0, out1); break;
    case kSrgb: launch<kSrgb>(ycbcr, grid, st, mos, sc, h, w, py, px, out0, out1); break;
    case kSrgbPoly: launch<kSrgbPoly>(ycbcr, grid, st, mos, sc, h, w, py, px, out0, out1); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
