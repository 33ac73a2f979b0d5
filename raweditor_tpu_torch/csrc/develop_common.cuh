// The finish tail shared by the fused develop kernels (develop.cu,
// develop_grad.cu, develop_grad_generic.cu): the folded edit stack, the
// transfer and quantiser of one pixel, and the store of one 2x2 quad as
// packed RGBA words or JPEG YCbCr 4:2:0 planes.
//
// Replaces the tail of the TPU kernel raweditor_tpu/ops/pallas_develop.py
// (_finish_block, and _emit_ycbcr420 for output="ycbcr420").
//
// What bounded it: the transfer. Three IEEE powf a pixel (or two sqrtf
// and a 7-term Horner each for the polynomial forms) were 0.18-0.19 ms
// of every 24 MP develop on an NVIDIA H100 80GB HBM3 at 700.00 W, 60% of
// the nearest kernel. The design: the output is 8-bit, and each
// transfer-and-quantise map q(c) (fused_develop._quantize) is a staircase
// over the f32 values, so 255 thresholds define it: q(c) = #{k : c >= t_k},
// t_k the f32 where q steps to k. The thresholds are derived on the card
// from the plain version itself (fused_develop.quant_table: a bisection
// over the f32 bit patterns, cached per transfer and device), so the
// kernel equals its plain version by construction. The card's powf is
// not monotone everywhere: q of the 1/2.2 power and of sRGB steps down
// and up again at one f32 value of [0, 1] each, beside a threshold. So
// the derivation scans 64 ulps around every threshold and the table
// keeps each value off the staircase as an exception (its bits and its
// code), compared for equality; chip_smoke.py and a card test hold the
// lookup against the plain version on every f32 in [0, 1] and beyond.
// The lookup keys a bucket by the f32 bits >> 17 (64 buckets a binade,
// from just below t_1 to the bucket of 1.0), reads the bucket's code at its
// first value, adds the compares against the next two thresholds (no
// bucket holds more; the derivation checks it) and takes the exception's
// code on its value: two shared-memory loads and about ten integer
// instructions where powf took tens. Both tables and the image's scalars
// sit in shared memory (struct Tail), copied once per block with 16-byte
// loads from a pointer: a by-value kernel parameter would be read with
// divergent addresses through the constant cache. Compares are on the
// signed bits, so -0.0, negatives and values below t_1 land on code 0,
// and everything at or above 1.0 (+inf too) in the bucket of 1.0, whose
// code is 255. NaN cannot arise from a u16 mosaic and finite scalars. The
// table is for u8 output only: 16-bit output (not in the port yet) always
// takes the exact transfer.
//
// Numerics: _finish_block's operation order for the matrix, tone and
// saturation, built with -fmad=false so no multiply-add is contracted and
// the kernels round like the plain PyTorch version
// (develop_rgba_folded_plain). The YCbCr rounding is rintf (half to
// even), as jnp.round.
//
// Everything here has internal linkage: each kernel source includes its
// own copy.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScalars = 24;
constexpr int kQuantShift = 17;      // bucket = f32 bits >> kQuantShift
constexpr int kQuantBuckets = 1344;  // 21 binades of 64 buckets below 1.0

// One transfer's exact quantiser (fused_develop.QuantTable packs the same
// bytes). next[k]: x, y the f32 bits of t_{k+1} and t_{k+2} (INT_MAX past
// t_255); z, w an exception of the buckets whose code is k, its bits and
// its code (z = INT_MAX, a NaN, for none). base[j]: the code of bucket
// lo + j at its first value.
struct alignas(16) QuantTable {
  int lo;                             // the bucket of the f32 below t_1
  int n;                              // buckets held; the last holds 1.0
  int pad[2];
  int4 next[256];
  unsigned char base[kQuantBuckets];
};
static_assert(sizeof(QuantTable) == 5456, "QuantTable layout");

// What the threads of a block share for the tail: the quantiser and the
// folded scalars of the block's image.
struct alignas(16) Tail {
  QuantTable quant;
  float sc[kScalars];
};

// Block-cooperative copies into shared memory; the caller synchronises.
__device__ __forceinline__ void load_quant(QuantTable* to,
                                           const QuantTable* __restrict__ from,
                                           int tid, int threads) {
  const uint4* src = reinterpret_cast<const uint4*>(from);
  uint4* dst = reinterpret_cast<uint4*>(to);
  for (int i = tid; i < static_cast<int>(sizeof(QuantTable) / 16);
       i += threads)
    dst[i] = __ldg(src + i);
}
__device__ __forceinline__ void load_tail(Tail* to,
                                          const QuantTable* __restrict__ quant,
                                          const float* __restrict__ sc,
                                          int tid, int threads) {
  load_quant(&to->quant, quant, tid, threads);
  if (tid < kScalars) to->sc[tid] = __ldg(sc + tid);
}

// The transfer, clamp and floor of one value: _quantize, exactly.
__device__ __forceinline__ int quantize(const QuantTable& t, float c) {
  const int bits = __float_as_int(c);
  const int j = min(max((bits >> kQuantShift) - t.lo, 0), t.n - 1);
  const int k = t.base[j];
  const int4 nx = t.next[k];
  const int code = k + (bits >= nx.x) + (bits >= nx.y);
  return bits == nx.z ? nx.w : code;
}

// Folded edit stack + transfer on one pixel's camera-RGB values
// (_finish_block): matrix and offset (sc 0-11), highlights/shadows tone
// times the contrast+levels gain (sc 13, 15, 16, 20) plus its offset
// (sc 14), the fused saturation/vibrance lerp (sc 17, 18).
__device__ __forceinline__ void finish(const Tail& t, float r, float g,
                                       float b, int* q) {
  const float* sc = t.sc;
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
  q[0] = quantize(t.quant, luma + (r - luma) * f);
  q[1] = quantize(t.quant, luma + (g - luma) * f);
  q[2] = quantize(t.quant, luma + (b - luma) * f);
}

__device__ __forceinline__ uint8_t round_u8(float v) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

// The JPEG 4:2:0 samples of one quantised quad q[iy][ix][channel]: Y per
// pixel; Cb/Cr as the 2x2 box mean, summed (row pair, then column pair)
// as _emit_ycbcr420 does.
__device__ __forceinline__ void ycbcr_quad(const int (&q)[2][2][3],
                                           uint8_t (&yq)[2][2], uint8_t& cbq,
                                           uint8_t& crq) {
  float cb[2][2], cr[2][2];
#pragma unroll
  for (int iy = 0; iy < 2; ++iy) {
#pragma unroll
    for (int ix = 0; ix < 2; ++ix) {
      const float rf = static_cast<float>(q[iy][ix][0]);
      const float gf = static_cast<float>(q[iy][ix][1]);
      const float bf = static_cast<float>(q[iy][ix][2]);
      yq[iy][ix] = round_u8(0.299f * rf + 0.587f * gf + 0.114f * bf);
      cb[iy][ix] = 128.0f - 0.168735892f * rf - 0.331264108f * gf + 0.5f * bf;
      cr[iy][ix] = 128.0f + 0.5f * rf - 0.418687589f * gf - 0.081312411f * bf;
    }
  }
  cbq = round_u8(((cb[0][0] + cb[1][0]) + (cb[0][1] + cb[1][1])) * 0.25f);
  crq = round_u8(((cr[0][0] + cr[1][0]) + (cr[0][1] + cr[1][1])) * 0.25f);
}

__device__ __forceinline__ uint32_t rgba_word(const int (&p)[3]) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | 0xFF000000u;
}

// Stores the quantised quad q[iy][ix][channel] whose top-left pixel is
// (y0, x0), both even, of image `img` in an (h, w) batch plane.
// RGBA: one u32 word per pixel; the ragged quad of an odd h or w masks
// its stores. YCbCr (h and w even): Y per pixel, Cb/Cr (ycbcr_quad)
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
      const uint32_t word[2] = {rgba_word(q[iy][0]), rgba_word(q[iy][1])};
      uint32_t* dst = out + static_cast<size_t>(y) * w + x0;
      if ((w & 1) == 0) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(word[0], word[1]);
      } else {
        dst[0] = word[0];
        if (x0 + 1 < w) dst[1] = word[1];
      }
    }
  } else {
    uint8_t yq[2][2], cb, cr;
    ycbcr_quad(q, yq, cb, cr);
#pragma unroll
    for (int iy = 0; iy < 2; ++iy)
      *reinterpret_cast<uchar2*>(yplane + img * plane +
                                 static_cast<size_t>(y0 + iy) * w + x0) =
          make_uchar2(yq[iy][0], yq[iy][1]);
    *reinterpret_cast<uchar2*>(cbcr + img * (plane / 2) +
                               static_cast<size_t>(y0 / 2) * w + x0) =
        make_uchar2(cb, cr);
  }
}

// The launch arguments every launcher accepts: n images of (h, w), a
// Bayer phase (py, px) in {0, 1}, output 0 (RGBA) or 1 (YCbCr 4:2:0,
// even h and w). Returns a CUDA error code, 0 when valid.
inline int check_args(int n, int h, int w, int py, int px, int output) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535 || (py & ~1) || (px & ~1) ||
      output < 0 || output > 1 || (output == 1 && ((h | w) & 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The same for a develop launcher, which also takes a quantiser table on
// the device (16-byte aligned: the blocks copy it in 16-byte words).
inline int check_develop_args(int n, int h, int w, int py, int px,
                              int output, const void* quant) {
  if (quant == nullptr || (reinterpret_cast<uintptr_t>(quant) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  return check_args(n, h, w, py, px, output);
}

}  // namespace
