// Fused Bayer develop for Hopper (sm_90a) with the quad-local stencils:
// nearest (the parity stencil), bilinear and Malvar-He-Cutler. u16 mosaic
// in, packed RGBA u32 words or JPEG YCbCr 4:2:0 planes out, in one pass.
// The gradient-weighted stencil, whose stages compose, is develop_grad.cu.
//
// Replaces the TPU kernel raweditor_tpu/ops/pallas_develop.py
// (_kernel_flat -> _develop_block: the nearest-Bayer branch, and
// _demosaic_smooth_taps for demosaic="bilinear"/"malvar"; then
// _finish_block, and _emit_ycbcr420 for output="ycbcr420"), reached from
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
// Numerics: the stencils keep _demosaic_smooth_taps' factored sums in its
// written order (hsum, vsum, diag4, then each filter's terms), on
// raw * scale before the folded black offset; Malvar is floored at the
// folded black level sc[19], not at 0. The finish tail is
// develop_common.cuh.

#include "develop_common.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

enum Demosaic { kNearest = 0, kBilinear = 1, kMalvar = 2 };

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
  const float s = sc[12];

  float v[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint16_t* row = m + static_cast<size_t>(min(max(y0 - R + i, 0), h - 1)) * w;
#pragma unroll
    for (int j = 0; j < N; ++j)
      v[i][j] = static_cast<float>(__ldg(row + min(max(x0 - R + j, 0), w - 1))) * s;
  }

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
  const int qh = (h + 1) / 2;
  const int qw = (w + 1) / 2;
  const dim3 grid((qw + kBlockX - 1) / kBlockX, (qh + kBlockY - 1) / kBlockY,
                  n);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
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

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
