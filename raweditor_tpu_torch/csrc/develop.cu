// Fused nearest-Bayer develop for Hopper (sm_90a): u16 mosaic in, packed
// RGBA u32 words or JPEG YCbCr 4:2:0 planes out, in one pass.
//
// Replaces the TPU kernel raweditor_tpu/ops/pallas_develop.py
// (_kernel_flat -> _develop_block nearest-Bayer branch -> _finish_block,
// and _emit_ycbcr420 for output="ycbcr420"), reached from
// pallas_develop_rgba and pallas_batch_develop_rgba.
//
// What bounds it: memory. At 24 MP the kernel reads 2 B/px of mosaic and
// writes 4 B/px (RGBA) or 1.5 B/px (planes), about 145 MB or 79 MB per
// image against 3.35 TB/s, with a few dozen flops per pixel. The design
// reads each mosaic sample from device memory about once (neighbouring
// threads share their 4x4 windows through L1/L2), keeps the demosaic, the
// edit stack and the 2x2 chroma box in registers, and writes each output
// byte once. Later work: 16-byte vector loads, shared-memory row tiles,
// TMA.
//
// Design: one thread per 2x2 pixel quad, grid (W/2, H/2, N) with the
// batch as the z dimension. A quad is the unit of both the Bayer parity
// pattern and the 4:2:0 chroma sample, so one thread owns a whole chroma
// sample and no cross-thread reduction is needed. Each thread loads the
// clamped 4x4 window around its quad (rows y0-1..y0+2, columns
// x0-1..x0+2); clamping at the true image edge gives clamp-to-edge for
// every pixel inside the image, and the ragged quad of an odd H or W
// masks its stores. Any (H, W) works.
//
// Numerics: the folded-scalar tail of _finish_block in the same operation
// order, built with -fmad=false so no multiply-add is contracted and the
// kernel rounds like the plain PyTorch version (develop_rgba_folded_plain).
// powf and sqrtf are the IEEE ones (no --use_fast_math). The YCbCr
// rounding is rintf (half to even), as jnp.round.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScalars = 24;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

enum Gamma { kPow = 0, kPoly = 1, kSrgb = 2, kSrgbPoly = 3 };

// The polynomial transfers pre-scaled by 255, with the quantiser's +0.5
// folded into the constant term (pallas_develop._GAMMA_POLY255 and
// _SRGB_POLY255 as f32; a test checks these literals against them).
__constant__ float GAMMA_POLY255[7] = {
    0x1.c80638p+5f, -0x1.96c4dap+7f, 0x1.2c4ed6p+8f, -0x1.01b7f0p+8f,
    0x1.60aa06p+8f, 0x1.8c29cap+2f, 0x1.d34ac2p-2f};
__constant__ float SRGB_POLY255[7] = {
    0x1.01c066p+4f, -0x1.304522p+6f, 0x1.3eb668p+7f, -0x1.a580fcp+7f,
    0x1.595536p+8f, 0x1.221dd0p+5f, -0x1.d7c77cp+3f};
constexpr float INV_22 = 0x1.d1745ep-2f;       // f32(1/2.2)
constexpr float INV_24 = 0x1.aaaaaap-2f;       // f32(1/2.4)
constexpr float SRGB_LIN255 = 0x1.9bd334p+11f; // f32(12.92*255)

template <int GAMMA>
__device__ __forceinline__ int quantize(float c) {
  c = fmaxf(c, 0.0f);
  float v;
  if (GAMMA == kPoly) {
    const float sq = sqrtf(sqrtf(fminf(c, 1.0f)));
    float acc = GAMMA_POLY255[0];
#pragma unroll
    for (int i = 1; i < 7; ++i) acc = acc * sq + GAMMA_POLY255[i];
    v = acc;
  } else if (GAMMA == kSrgb) {
    c = fminf(c, 1.0f);
    const float lo = c * 12.92f;
    const float hi = 1.055f * powf(c, INV_24) - 0.055f;
    v = (c <= 0.0031308f ? lo : hi) * 255.0f + 0.5f;
  } else if (GAMMA == kSrgbPoly) {
    c = fminf(c, 1.0f);
    const float sq = sqrtf(sqrtf(c));
    float acc = SRGB_POLY255[0];
#pragma unroll
    for (int i = 1; i < 7; ++i) acc = acc * sq + SRGB_POLY255[i];
    v = c <= 0.0031308f ? c * SRGB_LIN255 + 0.5f : acc;
  } else {
    v = powf(c, INV_22) * 255.0f + 0.5f;
  }
  return static_cast<int>(floorf(fminf(v, 255.5f)));
}

// Folded edit stack + transfer on one pixel's camera-RGB values
// (_finish_block): matrix and offset (sc 0-11), highlights/shadows tone
// times the contrast+levels gain (sc 13, 15, 16, 20) plus its offset
// (sc 14), the fused saturation/vibrance lerp (sc 17, 18).
template <int GAMMA>
__device__ __forceinline__ void finish(const float* sc, float r, float g,
                                       float b, int* q) {
  const float r2 = sc[0] * r + sc[1] * g + sc[2] * b + sc[9];
  const float g2 = sc[3] * r + sc[4] * g + sc[5] * b + sc[10];
  const float b2 = sc[6] * r + sc[7] * g + sc[8] * b + sc[11];
  r = r2;
  g = g2;
  b = b2;
  const float lum = 0.2126f * r + 0.7152f * g + 0.0722f * b;
  const float tone =
      (1.0f + lum * sc[15]) * (sc[20] - lum * sc[16]) * sc[13];
  r = r * tone + sc[14];
  g = g * tone + sc[14];
  b = b * tone + sc[14];
  const float luma = 0.2126f * r + 0.7152f * g + 0.0722f * b;
  const float mx = fmaxf(r, fmaxf(g, b));
  const float mn = fminf(r, fminf(g, b));
  const float sf = sc[17];
  const float f = sf * (1.0f + sc[18] * (1.0f - (mx - mn) * fabsf(sf)));
  q[0] = quantize<GAMMA>(luma + (r - luma) * f);
  q[1] = quantize<GAMMA>(luma + (g - luma) * f);
  q[2] = quantize<GAMMA>(luma + (b - luma) * f);
}

__device__ __forceinline__ uint8_t round_u8(float v) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

template <int GAMMA, bool YCBCR>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    develop_quads(const uint16_t* __restrict__ mosaics,
                  const float* __restrict__ scal, int h, int w, int py,
                  int px, uint32_t* __restrict__ rgba,
                  uint8_t* __restrict__ yplane,
                  uint8_t* __restrict__ cbcr) {
  const int qx = blockIdx.x * kBlockX + threadIdx.x;
  const int qy = blockIdx.y * kBlockY + threadIdx.y;
  if (qx >= (w + 1) / 2 || qy >= (h + 1) / 2) return;
  const size_t img = blockIdx.z;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* sc = scal + img * kScalars;
  const uint16_t* m = mosaics + img * plane;
  const int x0 = 2 * qx;
  const int y0 = 2 * qy;
  const float s = sc[12];

  float v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint16_t* row = m + static_cast<size_t>(min(max(y0 - 1 + i, 0), h - 1)) * w;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[i][j] = static_cast<float>(__ldg(row + min(max(x0 - 1 + j, 0), w - 1))) * s;
  }

  // CFA parity in global coordinates; y0 and x0 are even.
  int q[2][2][3];
#pragma unroll
  for (int iy = 0; iy < 2; ++iy) {
#pragma unroll
    for (int ix = 0; ix < 2; ++ix) {
      const float c = v[iy + 1][ix + 1];
      const float left = v[iy + 1][ix];
      const float right = v[iy + 1][ix + 2];
      const float up = v[iy][ix + 1];
      const float down = v[iy + 2][ix + 1];
      const float downleft = v[iy + 2][ix];
      const bool ye = ((iy + py) & 1) == 0;
      const bool xe = ((ix + px) & 1) == 0;
      const float r = ye ? (xe ? c : left) : (xe ? down : downleft);
      const float g = ye ? (xe ? right : c) : (xe ? c : left);
      const float b = ye ? up : (xe ? right : c);
      finish<GAMMA>(sc, r, g, b, q[iy][ix]);
    }
  }

  if constexpr (!YCBCR) {
    uint32_t* out = rgba + img * plane;
#pragma unroll
    for (int iy = 0; iy < 2; ++iy) {
      const int y = y0 + iy;
      if (y >= h) break;
      uint32_t word[2];
#pragma unroll
      for (int ix = 0; ix < 2; ++ix)
        word[ix] = static_cast<uint32_t>(q[iy][ix][0]) |
                   (static_cast<uint32_t>(q[iy][ix][1]) << 8) |
                   (static_cast<uint32_t>(q[iy][ix][2]) << 16) | 0xFF000000u;
      uint32_t* dst = out + static_cast<size_t>(y) * w + x0;
      if ((w & 1) == 0) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(word[0], word[1]);
      } else {
        dst[0] = word[0];
        if (x0 + 1 < w) dst[1] = word[1];
      }
    }
  } else {
    // JPEG planes (H and W are even here): Y per pixel; Cb/Cr as the 2x2
    // box mean, summed (row pair, then column pair) as _emit_ycbcr420 does,
    // stored NV12-interleaved at cbcr[y/2, 2*(x/2)] and [y/2, 2*(x/2)+1].
    float cb[2][2], cr[2][2];
#pragma unroll
    for (int iy = 0; iy < 2; ++iy) {
      uint8_t yq[2];
#pragma unroll
      for (int ix = 0; ix < 2; ++ix) {
        const float rf = static_cast<float>(q[iy][ix][0]);
        const float gf = static_cast<float>(q[iy][ix][1]);
        const float bf = static_cast<float>(q[iy][ix][2]);
        yq[ix] = round_u8(0.299f * rf + 0.587f * gf + 0.114f * bf);
        cb[iy][ix] = 128.0f - 0.168735892f * rf - 0.331264108f * gf + 0.5f * bf;
        cr[iy][ix] = 128.0f + 0.5f * rf - 0.418687589f * gf - 0.081312411f * bf;
      }
      *reinterpret_cast<uchar2*>(yplane + img * plane +
                                 static_cast<size_t>(y0 + iy) * w + x0) =
          make_uchar2(yq[0], yq[1]);
    }
    const float cbs = ((cb[0][0] + cb[1][0]) + (cb[0][1] + cb[1][1])) * 0.25f;
    const float crs = ((cr[0][0] + cr[1][0]) + (cr[0][1] + cr[1][1])) * 0.25f;
    *reinterpret_cast<uchar2*>(cbcr + img * (plane / 2) +
                               static_cast<size_t>(qy) * w + x0) =
        make_uchar2(round_u8(cbs), round_u8(crs));
  }
}

template <int GAMMA>
void launch(bool ycbcr, dim3 grid, cudaStream_t st, const uint16_t* mos,
            const float* scal, int h, int w, int py, int px, void* out0,
            void* out1) {
  const dim3 block(kBlockX, kBlockY);
  if (ycbcr)
    develop_quads<GAMMA, true><<<grid, block, 0, st>>>(
        mos, scal, h, w, py, px, nullptr, static_cast<uint8_t*>(out0),
        static_cast<uint8_t*>(out1));
  else
    develop_quads<GAMMA, false><<<grid, block, 0, st>>>(
        mos, scal, h, w, py, px, static_cast<uint32_t*>(out0), nullptr,
        nullptr);
}

}  // namespace

// mosaics (n, h, w) u16, scal (n, 24) f32, contiguous on the device.
// output 0: out0 = (n, h, w) u32 RGBA words. output 1: out0 = (n, h, w)
// u8 Y, out1 = (n, h/2, w) u8 interleaved CbCr; h and w must be even.
// gamma: 0 pow, 1 poly, 2 srgb, 3 srgb_poly. Launches on ``stream``,
// does not synchronise, and returns the cudaGetLastError() code.
extern "C" int rtt_develop_launch(const void* mosaics, const void* scal,
                                  void* out0, void* out1, int n, int h,
                                  int w, int py, int px, int gamma,
                                  int output, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535 || (py & ~1) || (px & ~1) ||
      output < 0 || output > 1 || (output == 1 && ((h | w) & 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int qh = (h + 1) / 2;
  const int qw = (w + 1) / 2;
  const dim3 grid((qw + kBlockX - 1) / kBlockX, (qh + kBlockY - 1) / kBlockY,
                  n);
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

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
