// The finish tail shared by the fused develop kernels (develop.cu,
// develop_grad.cu): the folded edit stack, the transfer and quantiser of
// one pixel, and the store of one 2x2 quad as packed RGBA words or JPEG
// YCbCr 4:2:0 planes.
//
// Replaces the tail of the TPU kernel raweditor_tpu/ops/pallas_develop.py
// (_finish_block, and _emit_ycbcr420 for output="ycbcr420").
//
// Numerics: _finish_block's operation order, built with -fmad=false so no
// multiply-add is contracted and the kernels round like the plain PyTorch
// version (develop_rgba_folded_plain). powf and sqrtf are the IEEE ones
// (no --use_fast_math). The YCbCr rounding is rintf (half to even), as
// jnp.round.
//
// Everything here has internal linkage: each kernel source includes its
// own copy.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScalars = 24;

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

// Stores the quantised quad q[iy][ix][channel] whose top-left pixel is
// (y0, x0), both even, of image `img` in an (h, w) batch plane.
// RGBA: one u32 word per pixel; the ragged quad of an odd h or w masks
// its stores. YCbCr (h and w even): Y per pixel; Cb/Cr as the 2x2 box
// mean, summed (row pair, then column pair) as _emit_ycbcr420 does,
// stored NV12-interleaved at cbcr[y0/2, x0] and [y0/2, x0+1].
template <bool YCBCR>
__device__ __forceinline__ void store_quad(int (&q)[2][2][3],
                                           size_t img, int h, int w, int y0,
                                           int x0, uint32_t* rgba,
                                           uint8_t* yplane, uint8_t* cbcr) {
  const size_t plane = static_cast<size_t>(h) * w;
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
                               static_cast<size_t>(y0 / 2) * w + x0) =
        make_uchar2(round_u8(cbs), round_u8(crs));
  }
}

// The launch arguments both launchers accept: n images of (h, w), a
// Bayer phase (py, px) in {0, 1}, output 0 (RGBA) or 1 (YCbCr 4:2:0,
// even h and w). Returns a CUDA error code, 0 when valid.
inline int check_args(int n, int h, int w, int py, int px, int output) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535 || (py & ~1) || (px & ~1) ||
      output < 0 || output > 1 || (output == 1 && ((h | w) & 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace
