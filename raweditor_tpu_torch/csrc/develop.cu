// Fused develop for Hopper (sm_90a) with the quad-local stencils: on a
// Bayer phase nearest (the parity stencil), bilinear and
// Malvar-He-Cutler (develop_quads); on a repeating-CFA pattern such as
// the 6x6 X-Trans grid nearest-site and the radius-1 normalised
// convolution "smooth" (develop_quads_cfa). u16 mosaic in, packed RGBA
// u32 words or JPEG YCbCr 4:2:0 planes out, in one pass. The
// gradient-weighted stencils, whose stages compose, are develop_grad.cu
// and develop_grad_generic.cu.
//
// Replaces the TPU kernel raweditor_tpu/ops/pallas_develop.py
// (_kernel_flat -> _develop_block: the nearest-Bayer branch,
// _demosaic_smooth_taps for demosaic="bilinear"/"malvar", the
// nearest-site table branch for pattern= and _demosaic_smooth_generic
// for pattern= with demosaic="smooth"; then _finish_block, and
// _emit_ycbcr420 for output="ycbcr420"), reached from
// pallas_develop_rgba and pallas_batch_develop_rgba.
//
// What bounds it: memory. At 24 MP the kernel reads 2 B/px of mosaic and
// writes 4 B/px (RGBA) or 1.5 B/px (planes), about 145 MB or 79 MB per
// image against 3.35 TB/s, with under a hundred flops per pixel. The
// design reads each mosaic sample from device memory about once
// (neighbouring threads share their windows through L1/L2), keeps the
// demosaic, the edit stack and the 2x2 chroma box in registers, and
// writes each output byte once. The Malvar window grows from 16 to 36
// loads per thread; they overlap between threads and are served by L1,
// not device memory. Later work: a shared-memory row tile (which would
// also serve Malvar's 6x6 window), 16-byte vector loads, TMA.
//
// Design: one thread per 2x2 pixel quad, grid (W/2, H/2, N) with the
// batch as the z dimension. A quad is the unit of both the Bayer parity
// pattern and the 4:2:0 chroma sample, so one thread owns a whole chroma
// sample and no cross-thread reduction is needed. Each thread loads the
// clamped window around its quad: 4x4 (rows y0-1..y0+2, columns
// x0-1..x0+2) for nearest and bilinear, 6x6 (rows y0-2..y0+3) for
// Malvar's +-2 taps. Clamping each coordinate at the true image edge
// gives clamp-to-edge for every pixel inside the image (it reproduces the
// TPU kernel's up2/down2 row fixups and the edge columns of _shift_x),
// and the ragged quad of an odd H or W masks its stores. Any (H, W) works.
//
// The generic-CFA stencils (develop_quads_cfa) keep the thread per quad:
// the quad does not align with a 6x6 period, but it is still the 4:2:0
// chroma sample, so each of its four pixels looks up its own pattern
// cell in the tables (cfa_tables.cuh). Nearest picks, per pixel and
// channel, one of the five taps centre/left/right/up/down of the same
// clamped 4x4 window by the cell's tap code. Smooth sums the nine
// clamped taps of each channel, each zeroed unless the site at its
// UNCLAMPED coordinates is of that channel (the mask continues
// periodically past the image edge while the value repeats the edge
// pixel), as column sums (a + b*2) + c, then the row sum in the same
// form, over the cell's denominator; a sensor site passes through.
// Nearest is bound by memory like the Bayer stencil. Smooth needs about
// 100 f32 operations per pixel with the sRGB transfer: on the X-Trans grid
// only 2-3 of a missing R/B's nine taps and 5 of a missing G's are ever
// filled, so the taps that change a bit come to 8.6 operations per pixel
// (averaged over the 36 cells, divisions included), then the tail. That
// keeps its RGBA form bound by memory and puts its planes form (123
// operations with the chroma box) on the operations side. The kernel
// itself sums all nine masked taps: the never-filled ones are later work.
//
// Numerics: the stencils keep _demosaic_smooth_taps' factored sums in its
// written order (hsum, vsum, diag4, then each filter's terms), on
// raw * scale before the folded black offset; Malvar is floored at the
// folded black level sc[19], not at 0. The finish tail is
// develop_common.cuh.

#include "develop_common.cuh"
#include "cfa_tables.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

enum Demosaic { kNearest = 0, kBilinear = 1, kMalvar = 2 };
enum CfaDemosaic { kCfaNearest = 0, kCfaSmooth = 1 };

// raw * s over the clamped (2 + 2R)-square window around the quad at
// (y0, x0): rows y0-R..y0+1+R, columns x0-R..x0+1+R.
template <int R>
__device__ __forceinline__ void load_window(
    const uint16_t* __restrict__ m, int h, int w, int y0, int x0, float s,
    float (&v)[2 + 2 * R][2 + 2 * R]) {
  constexpr int N = 2 + 2 * R;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint16_t* row = m + static_cast<size_t>(min(max(y0 - R + i, 0), h - 1)) * w;
#pragma unroll
    for (int j = 0; j < N; ++j)
      v[i][j] = static_cast<float>(__ldg(row + min(max(x0 - R + j, 0), w - 1))) * s;
  }
}

template <int GAMMA, bool YCBCR, int DEMOSAIC>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    develop_quads(const uint16_t* __restrict__ mosaics,
                  const float* __restrict__ scal, int h, int w, int py,
                  int px, uint32_t* __restrict__ rgba,
                  uint8_t* __restrict__ yplane,
                  uint8_t* __restrict__ cbcr) {
  constexpr int R = DEMOSAIC == kMalvar ? 2 : 1;  // window radius
  constexpr int N = 2 + 2 * R;
  const int qx = blockIdx.x * kBlockX + threadIdx.x;
  const int qy = blockIdx.y * kBlockY + threadIdx.y;
  if (qx >= (w + 1) / 2 || qy >= (h + 1) / 2) return;
  const size_t img = blockIdx.z;
  const float* sc = scal + img * kScalars;
  const uint16_t* m = mosaics + img * static_cast<size_t>(h) * w;
  const int x0 = 2 * qx;
  const int y0 = 2 * qy;

  float v[N][N];
  load_window<R>(m, h, w, y0, x0, sc[12], v);

  // CFA parity in global coordinates; y0 and x0 are even.
  int q[2][2][3];
#pragma unroll
  for (int iy = 0; iy < 2; ++iy) {
#pragma unroll
    for (int ix = 0; ix < 2; ++ix) {
      const int cy = iy + R;
      const int cx = ix + R;
      const float c = v[cy][cx];
      const float left = v[cy][cx - 1];
      const float right = v[cy][cx + 1];
      const float up = v[cy - 1][cx];
      const float down = v[cy + 1][cx];
      const bool ye = ((iy + py) & 1) == 0;
      const bool xe = ((ix + px) & 1) == 0;
      float r, g, b;
      if constexpr (DEMOSAIC == kNearest) {
        const float downleft = v[cy + 1][cx - 1];
        r = ye ? (xe ? c : left) : (xe ? down : downleft);
        g = ye ? (xe ? right : c) : (xe ? c : left);
        b = ye ? up : (xe ? right : c);
      } else {
        const float hsum = left + right;
        const float vsum = up + down;
        const float diag4 = (v[cy - 1][cx - 1] + v[cy - 1][cx + 1]) +
                            (v[cy + 1][cx - 1] + v[cy + 1][cx + 1]);
        if constexpr (DEMOSAIC == kBilinear) {
          const float hm = hsum * 0.5f;
          const float vm = vsum * 0.5f;
          const float pm = (hsum + vsum) * 0.25f;
          const float dm = diag4 * 0.25f;
          r = ye ? (xe ? c : hm) : (xe ? vm : dm);
          g = ye == xe ? pm : c;
          b = ye ? (xe ? dm : vm) : (xe ? hm : c);
        } else {
          const float h2 = v[cy][cx - 2] + v[cy][cx + 2];
          const float v2 = v[cy - 2][cx] + v[cy + 2][cx];
          const float s2 = h2 + v2;
          const float gc = c * 0.5f + (hsum + vsum) * 0.25f - s2 * 0.125f;
          const float kr = c * 0.625f + hsum * 0.5f - (h2 + diag4) * 0.125f +
                           v2 * 0.0625f;
          const float kc = c * 0.625f + vsum * 0.5f - (v2 + diag4) * 0.125f +
                           h2 * 0.0625f;
          const float kd = c * 0.75f + diag4 * 0.25f - s2 * 0.1875f;
          const float floor_ = sc[19];
          r = fmaxf(ye ? (xe ? c : kr) : (xe ? kc : kd), floor_);
          g = fmaxf(ye == xe ? gc : c, floor_);
          b = fmaxf(ye ? (xe ? kd : kc) : (xe ? kr : c), floor_);
        }
      }
      finish<GAMMA>(sc, r, g, b, q[iy][ix]);
    }
  }
  store_quad<YCBCR>(q, img, h, w, y0, x0, rgba, yplane, cbcr);
}

// The generic-CFA stencils: the quad's window as above, each pixel's
// pattern cell from the tables.
template <int GAMMA, bool YCBCR, int DEMOSAIC>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    develop_quads_cfa(const uint16_t* __restrict__ mosaics,
                      const float* __restrict__ scal, int h, int w,
                      const __grid_constant__ CfaTables tables,
                      uint32_t* __restrict__ rgba,
                      uint8_t* __restrict__ yplane,
                      uint8_t* __restrict__ cbcr) {
  __shared__ CfaTables t;
  copy_tables(tables, &t, threadIdx.y * kBlockX + threadIdx.x,
              kBlockX * kBlockY);
  __syncthreads();
  const int qx = blockIdx.x * kBlockX + threadIdx.x;
  const int qy = blockIdx.y * kBlockY + threadIdx.y;
  if (qx >= (w + 1) / 2 || qy >= (h + 1) / 2) return;
  const size_t img = blockIdx.z;
  const float* sc = scal + img * kScalars;
  const uint16_t* m = mosaics + img * static_cast<size_t>(h) * w;
  const int x0 = 2 * qx;
  const int y0 = 2 * qy;

  float v[4][4];
  load_window<1>(m, h, w, y0, x0, sc[12], v);

  // The pattern row and column of each window position, by the unclamped
  // coordinates y0-1+i and x0-1+j.
  const int side = t.side;
  int cy[4], cx[4];
  cy[0] = cell_mod(y0 - 1, side);
  cx[0] = cell_mod(x0 - 1, side);
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    cy[i] = cy[i - 1] + 1 == side ? 0 : cy[i - 1] + 1;
    cx[i] = cx[i - 1] + 1 == side ? 0 : cx[i - 1] + 1;
  }
  // Smooth: the channel of every window position.
  int ch[4][4];
  if constexpr (DEMOSAIC == kCfaSmooth) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ch[i][j] = t.chan[cy[i] * side + cx[j]];
  }

  int q[2][2][3];
#pragma unroll
  for (int iy = 0; iy < 2; ++iy) {
#pragma unroll
    for (int ix = 0; ix < 2; ++ix) {
      const int wy = iy + 1;
      const int wx = ix + 1;
      const int cell = cy[wy] * side + cx[wx];
      const float c = v[wy][wx];
      float rgb[3];
      if constexpr (DEMOSAIC == kCfaNearest) {
        const float left = v[wy][wx - 1];
        const float right = v[wy][wx + 1];
        const float up = v[wy - 1][wx];
        const float down = v[wy + 1][wx];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int code = t.tap[k][cell];
          rgb[k] = code == 0 ? c
                 : code == 1 ? left
                 : code == 2 ? right
                 : code == 3 ? up
                             : down;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float col[3];
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx) {
            const float a = ch[wy - 1][wx + dx] == k ? v[wy - 1][wx + dx] : 0.0f;
            const float b = ch[wy][wx + dx] == k ? v[wy][wx + dx] : 0.0f;
            const float d = ch[wy + 1][wx + dx] == k ? v[wy + 1][wx + dx] : 0.0f;
            col[dx + 1] = (a + b * 2.0f) + d;
          }
          const float num = (col[0] + col[1] * 2.0f) + col[2];
          rgb[k] = ch[wy][wx] == k ? c : num / t.den2[k][cell];
        }
      }
      finish<GAMMA>(sc, rgb[0], rgb[1], rgb[2], q[iy][ix]);
    }
  }
  store_quad<YCBCR>(q, img, h, w, y0, x0, rgba, yplane, cbcr);
}

template <int GAMMA, int DEMOSAIC>
void launch_cfa(bool ycbcr, dim3 grid, cudaStream_t st, const uint16_t* mos,
                const float* scal, int h, int w, const CfaTables& tables,
                void* out0, void* out1) {
  const dim3 block(kBlockX, kBlockY);
  if (ycbcr)
    develop_quads_cfa<GAMMA, true, DEMOSAIC><<<grid, block, 0, st>>>(
        mos, scal, h, w, tables, nullptr, static_cast<uint8_t*>(out0),
        static_cast<uint8_t*>(out1));
  else
    develop_quads_cfa<GAMMA, false, DEMOSAIC><<<grid, block, 0, st>>>(
        mos, scal, h, w, tables, static_cast<uint32_t*>(out0), nullptr,
        nullptr);
}

template <int GAMMA>
bool launch_cfa_demosaic(int demosaic, bool ycbcr, dim3 grid, cudaStream_t st,
                         const uint16_t* mos, const float* sc, int h, int w,
                         const CfaTables& tables, void* out0, void* out1) {
  switch (demosaic) {
    case kCfaNearest: launch_cfa<GAMMA, kCfaNearest>(ycbcr, grid, st, mos, sc, h, w, tables, out0, out1); return true;
    case kCfaSmooth: launch_cfa<GAMMA, kCfaSmooth>(ycbcr, grid, st, mos, sc, h, w, tables, out0, out1); return true;
    default: return false;
  }
}

// One thread per quad: blocks of kBlockX x kBlockY quads, the batch as z.
inline bool quad_grid(int n, int h, int w, dim3* grid) {
  const int qh = (h + 1) / 2;
  const int qw = (w + 1) / 2;
  *grid = dim3((qw + kBlockX - 1) / kBlockX, (qh + kBlockY - 1) / kBlockY, n);
  return grid->y <= 65535;
}

template <int GAMMA, int DEMOSAIC>
void launch(bool ycbcr, dim3 grid, cudaStream_t st, const uint16_t* mos,
            const float* scal, int h, int w, int py, int px, void* out0,
            void* out1) {
  const dim3 block(kBlockX, kBlockY);
  if (ycbcr)
    develop_quads<GAMMA, true, DEMOSAIC><<<grid, block, 0, st>>>(
        mos, scal, h, w, py, px, nullptr, static_cast<uint8_t*>(out0),
        static_cast<uint8_t*>(out1));
  else
    develop_quads<GAMMA, false, DEMOSAIC><<<grid, block, 0, st>>>(
        mos, scal, h, w, py, px, static_cast<uint32_t*>(out0), nullptr,
        nullptr);
}

template <int GAMMA>
bool launch_demosaic(int demosaic, bool ycbcr, dim3 grid, cudaStream_t st,
                     const uint16_t* mos, const float* sc, int h, int w,
                     int py, int px, void* out0, void* out1) {
  switch (demosaic) {
    case kNearest: launch<GAMMA, kNearest>(ycbcr, grid, st, mos, sc, h, w, py, px, out0, out1); return true;
    case kBilinear: launch<GAMMA, kBilinear>(ycbcr, grid, st, mos, sc, h, w, py, px, out0, out1); return true;
    case kMalvar: launch<GAMMA, kMalvar>(ycbcr, grid, st, mos, sc, h, w, py, px, out0, out1); return true;
    default: return false;
  }
}

}  // namespace

// mosaics (n, h, w) u16, scal (n, 24) f32, contiguous on the device.
// output 0: out0 = (n, h, w) u32 RGBA words. output 1: out0 = (n, h, w)
// u8 Y, out1 = (n, h/2, w) u8 interleaved CbCr; h and w must be even.
// gamma: 0 pow, 1 poly, 2 srgb, 3 srgb_poly. demosaic: 0 nearest,
// 1 bilinear, 2 malvar. Launches on ``stream``, does not synchronise,
// and returns the cudaGetLastError() code.
extern "C" int rtt_develop_launch(const void* mosaics, const void* scal,
                                  void* out0, void* out1, int n, int h,
                                  int w, int py, int px, int gamma,
                                  int output, int demosaic, void* stream) {
  if (const int bad = check_args(n, h, w, py, px, output)) return bad;
  dim3 grid;
  if (!quad_grid(n, h, w, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* mos = static_cast<const uint16_t*>(mosaics);
  const auto* sc = static_cast<const float*>(scal);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool ycbcr = output == 1;
  bool ok = false;
  switch (gamma) {
    case kPow: ok = launch_demosaic<kPow>(demosaic, ycbcr, grid, st, mos, sc, h, w, py, px, out0, out1); break;
    case kPoly: ok = launch_demosaic<kPoly>(demosaic, ycbcr, grid, st, mos, sc, h, w, py, px, out0, out1); break;
    case kSrgb: ok = launch_demosaic<kSrgb>(demosaic, ycbcr, grid, st, mos, sc, h, w, py, px, out0, out1); break;
    case kSrgbPoly: ok = launch_demosaic<kSrgbPoly>(demosaic, ycbcr, grid, st, mos, sc, h, w, py, px, out0, out1); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// As rtt_develop_launch for a repeating-CFA mosaic: ``tables`` is the
// packed CfaTables bytes on the host (cfa_tables.cuh), and demosaic is
// 0 nearest-site or 1 smooth (radius-1 normalised convolution).
extern "C" int rtt_develop_cfa_launch(const void* mosaics, const void* scal,
                                      void* out0, void* out1, int n, int h,
                                      int w, int gamma, int output,
                                      int demosaic, const void* tables,
                                      void* stream) {
  if (const int bad = check_args(n, h, w, 0, 0, output)) return bad;
  CfaTables t;
  if (!unpack_tables(tables, &t)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  if (!quad_grid(n, h, w, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* mos = static_cast<const uint16_t*>(mosaics);
  const auto* sc = static_cast<const float*>(scal);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool ycbcr = output == 1;
  bool ok = false;
  switch (gamma) {
    case kPow: ok = launch_cfa_demosaic<kPow>(demosaic, ycbcr, grid, st, mos, sc, h, w, t, out0, out1); break;
    case kPoly: ok = launch_cfa_demosaic<kPoly>(demosaic, ycbcr, grid, st, mos, sc, h, w, t, out0, out1); break;
    case kSrgb: ok = launch_cfa_demosaic<kSrgb>(demosaic, ycbcr, grid, st, mos, sc, h, w, t, out0, out1); break;
    case kSrgbPoly: ok = launch_cfa_demosaic<kSrgbPoly>(demosaic, ycbcr, grid, st, mos, sc, h, w, t, out0, out1); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
