// Finish-extras post-pass for Hopper (sm_90a): packed RGBA u32 words in,
// packed RGBA words or JPEG YCbCr 4:2:0 planes out, in one pass.
//
// Replaces the TPU kernel raweditor_tpu/ops/pallas_develop.py
// (pallas_finish_extras_rgba -> _extras_kernel_flat -> _extras_window,
// which runs ops/extras.extras_core; for output="ycbcr420" the
// _emit_ycbcr420 tail). Its TPU mechanics (_band_realign, the roll
// fix-ups of _clamp_shift_fns, the 128-lane width pad, the row pad and
// grid overhang, the (bh+16)-row DMA windows, the SMEM scalar table) have
// no counterpart here: a warp clamps at the true image edge itself and
// takes any (H, W).
//
// Per pixel, on the u8 values times f32(1/255) (the plain version is
// ops/fused_extras.finish_extras_plain):
//   heads (pointwise, when on): the HSL mixer (ops/mixer.py), then colour
//     grading (ops/grading.py);
//   stencils (when on): y/cr/cb; chroma denoise, two 3x3 tents over
//     cr/cb blended by denoise/100; a bilateral-lite 3x3 pass over y;
//     the 4-region tone curve and the vignette on radial_sq (global
//     coordinates); the unsharp mask y + (y - tent3(y)) * sharpen/100;
//     rebuild r, g, b and clamp to [0, 1];
//   quantise floor(c*255 + 0.5), store RGBA words or the 4:2:0 planes
//   (store_quad of develop_common.cuh, the emission of the develop
//   kernels).
// The amounts come per image from an (n, 38) table: sharpen, denoise,
// the 4 curve sliders, vignette, the 24 mixer and the 7 grading sliders.
//
// What bounds it: instruction throughput. It reads 4 B/px and writes
// 4 B/px (RGBA) or 1.5 B/px (planes): 193 MB or 133 MB per 24 MP frame,
// 0.058 ms or 0.040 ms at 3.35 TB/s, and needs some 440 f32 operations per
// pixel with every stage on (0.16 ms at 67 TFLOP/s). With -fmad=false a
// multiply and an add are two instructions, and an IEEE division or an
// exp2f is ten or more, so that rate is out of reach: on an NVIDIA H100
// 80GB HBM3 at 700.00 W one 24 MP frame takes 0.56 ms with every stage on,
// 0.33 ms with the stencils alone and 0.22 ms for mixer and grading alone.
// A design that staged every step of a 32x16 tile in shared memory behind
// four block barriers took 0.79, 0.44 and 0.28 ms: it ran the heads on the
// 36x20 pixels a tile loads (1.41x), divided eight times per bilateral
// pixel, and spent 0.13 ms on the load, the barriers and a trivial store.
//
// Design, with stencils: the warp march of band_march.cuh. A warp owns a
// strip of 64 columns (60 output columns plus the 2-column halo either
// side; a lane holds two adjacent columns, so it owns the 2x2 quad and its
// 4:2:0 chroma sample) and walks a band of kBandH output rows from top to
// bottom. At step t it
//   loads input row t (8 bytes per lane where the row is aligned; the next
//     row is requested before this one is worked on), runs the pointwise
//     heads and the opponent split y/cr/cb on it;
//   computes at row t-1 tent 1 of cr/cb and, from y, the bilateral, the
//     tone curve and the vignette (yv);
//   computes at row t-2 tent 2 and the chroma blend, the sharpen tent over
//     yv and the unsharp mask, rebuilds, quantises, and stores each quad
//     with its second row.
// Each of y, cr, cb, tent 1 (two planes) and yv keeps its last three rows
// in registers; vertical taps touch no memory and horizontal ones come by
// shuffle. Only the band's first four rows and the strip's halo are
// recomputed (1.06x and 1.07x against the tile's 1.41x on the heads).
// - The bilateral's weight kw / (1 + d^2 / sigma^2) is the same for both
//   pixels of a neighbour pair ((p - q) and (q - p) have one square), so
//   each of a pixel's four undirected pairs is divided once: the pairs
//   down from a row are kept for the next step, the pairs that cross to a
//   neighbour lane go there by shuffle. Four divisions a pixel, not eight.
// - The mixer's hue lies under at most two of its nine hats; the others
//   weigh an exact zero and add nothing, so only those two are evaluated
//   (looked up by the hue in shared memory), in the full sum's order. Its
//   three sector quotients share one division: the numerator is selected
//   first.
// - The derived amounts (the hats' tables beside them) are computed once
//   per block into shared memory, not per thread and tile.
// - Bands of 64 rows and 20 warps per SM (96 registers, no spill) measured
//   best: 32 rows gain 2% on one frame and lose 3% on four, 128 lose both;
//   16 warps (128 registers) lose 4%, unrolling the row loop loses 14%.
// Without stencils nothing looks at a neighbour: a thread per 2x2 quad
// runs the heads and stores (0.19 to 0.23 ms per frame against the tile
// kernel's 0.23 to 0.29, by the two mixer points above).
// Later work: the heads are 0.22 of the 0.56 ms with every stage on; what
// is left there is the mixer's own arithmetic (one division, one exp2f,
// some 150 instructions a pixel).
//
// Clamp-to-edge: every stage reads the stage below at coordinates
// clamped to the image, as the JAX shift closures _pad_shift_fns do, so a
// composed stage never reads a stage value that lies outside the image.
// band_march.cuh says how the march does it for rows and columns; y, cr
// and cb come pointwise from words loaded at clamped coordinates and need
// no rule of their own, and the bilateral's pair weights follow from them.
//
// Numerics: ops/extras.py's operation order (tent3 as ((up + 2x) + dn),
// then ((lf + 2xv) + rt) * 0.0625; the bilateral's num from 4y and den
// from 4 over the 8 taps in order; the knots of the tone curve by the
// forward-max / backward-min cascade), built with -fmad=false and IEEE
// division, as the plain PyTorch version rounds. The f32 constants are
// the JAX expressions: a double quotient rounded once to float.

#include "band_march.cuh"
#include "develop_common.cuh"

namespace {

// The stencil form: the warp march of band_march.cuh. The stencil chain
// is two deep on both branches (bilateral -> sharpen tent on luma, tent 1
// -> tent 2 on chroma), so two columns of a strip's 64 are halo on each
// side and a band recomputes four rows.
constexpr int kHalo = 2;
constexpr int kStripW = kWarpCols - 2 * kHalo;  // 60 output columns
constexpr int kBandH = 64;                      // output rows per warp
constexpr int kWarps = 4;                       // strips per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 5;  // 20 warps per SM: caps at 96 registers
// The pointwise form (no stencils): one thread per 2x2 quad, a block of
// kThreads threads on a 32x16-pixel tile.
constexpr int kTileW = 32;
constexpr int kTileH = 16;
static_assert((kTileW / 2) * (kTileH / 2) == kThreads, "one thread per quad");
constexpr int kExtras = 38;
constexpr int kMixerCol = 7;
constexpr int kGradingCol = 31;

constexpr float kLumaR = 0.2126f;
constexpr float kLumaG = 0.7152f;
constexpr float kLumaB = 0.0722f;
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);
constexpr float kInvLumaG = static_cast<float>(1.0 / 0.7152);

// Mixer hats: knot k of hat i is kHatKnot[i + k] (left, centre, right);
// the circle closes with magenta - 360 on the left and orange + 360 on
// the right, so hat 8 is red again. The slopes are the f32 of the double
// reciprocals. A pixel looks its two hats up by its hue, so a copy of the
// tables sits beside the amounts in shared memory, where lanes that read
// different entries do not serialise.
constexpr int kHats = 9;
__constant__ float kHatKnot[kHats + 2] = {-40.0f, 0.0f,   30.0f,  60.0f,
                                       120.0f, 180.0f, 240.0f, 280.0f,
                                       320.0f, 360.0f, 390.0f};
__constant__ float kHatRise[kHats] = {
    static_cast<float>(1.0 / 40.0),  static_cast<float>(1.0 / 30.0),
    static_cast<float>(1.0 / 30.0),  static_cast<float>(1.0 / 60.0),
    static_cast<float>(1.0 / 60.0),  static_cast<float>(1.0 / 60.0),
    static_cast<float>(1.0 / 40.0),  static_cast<float>(1.0 / 40.0),
    static_cast<float>(1.0 / 40.0)};
__constant__ float kHatFall[kHats] = {
    static_cast<float>(1.0 / 30.0),  static_cast<float>(1.0 / 30.0),
    static_cast<float>(1.0 / 60.0),  static_cast<float>(1.0 / 60.0),
    static_cast<float>(1.0 / 60.0),  static_cast<float>(1.0 / 40.0),
    static_cast<float>(1.0 / 40.0),  static_cast<float>(1.0 / 40.0),
    static_cast<float>(1.0 / 30.0)};

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// The per-image amounts and what the kernel derives from them, once per
// block, in shared memory.
struct Amounts {
  float hue[8], sat[8], lum[8];         // mixer knots
  float gdr[3], gdg[3], gdb[3], gsat[3], balance;  // grading wheels
  float s, inv_s2, a, vig, knot[4];     // denoise, sharpen, vignette, curve
  float cy, cx, icy, icx;               // radial_sq constants
  float hat_knot[kHats + 2], hat_rise[kHats], hat_fall[kHats];
};

// The zero-luma chroma direction of a grading hue (grading._hue_dir).
__device__ __forceinline__ void hue_dir(float hue, float& dr, float& dg,
                                        float& db) {
  const float h = hue - 360.0f * floorf(hue * static_cast<float>(1.0 / 360.0));
  const float hp = h * static_cast<float>(1.0 / 60.0);
  const float r = clip01(fabsf(hp - 3.0f) - 1.0f);
  const float g = clip01(2.0f - fabsf(hp - 2.0f));
  const float b = clip01(2.0f - fabsf(hp - 4.0f));
  const float y = kLumaR * r + kLumaG * g + kLumaB * b;
  dr = r - y;
  dg = g - y;
  db = b - y;
}

__device__ __forceinline__ void load_amounts(const float* __restrict__ t,
                                             Amounts& am) {
  for (int i = 0; i < 8; ++i) {
    am.hue[i] = __ldg(t + kMixerCol + i);
    am.sat[i] = __ldg(t + kMixerCol + 8 + i);
    am.lum[i] = __ldg(t + kMixerCol + 16 + i);
  }
#pragma unroll
  for (int i = 0; i < kHats + 2; ++i) am.hat_knot[i] = kHatKnot[i];
#pragma unroll
  for (int i = 0; i < kHats; ++i) {
    am.hat_rise[i] = kHatRise[i];
    am.hat_fall[i] = kHatFall[i];
  }
  for (int k = 0; k < 3; ++k) {
    hue_dir(__ldg(t + kGradingCol + 2 * k), am.gdr[k], am.gdg[k], am.gdb[k]);
    am.gsat[k] = __ldg(t + kGradingCol + 2 * k + 1) *
                 static_cast<float>(0.25 / 100.0);
  }
  am.balance = __ldg(t + kGradingCol + 6) * 0.0035f;
  am.s = clip01(__ldg(t + 1) * 0.01f);
  const float sigma = 0.02f + 0.06f * am.s;
  am.inv_s2 = 1.0f / (sigma * sigma);
  am.a = fmaxf(__ldg(t + 0), 0.0f) * 0.01f;
  am.vig = __ldg(t + 6) * 0.0075f;
  // tone_curve's knots: bounds spaced by 1e-3, then the cascades.
  constexpr float kLo[4] = {static_cast<float>(1 * 1e-3),
                            static_cast<float>(2 * 1e-3),
                            static_cast<float>(3 * 1e-3),
                            static_cast<float>(4 * 1e-3)};
  constexpr float kHi[4] = {static_cast<float>(1.0 - 4 * 1e-3),
                            static_cast<float>(1.0 - 3 * 1e-3),
                            static_cast<float>(1.0 - 2 * 1e-3),
                            static_cast<float>(1.0 - 1 * 1e-3)};
  constexpr float kBase[4] = {static_cast<float>(0.2 * 1),
                              static_cast<float>(0.2 * 2),
                              static_cast<float>(0.2 * 3),
                              static_cast<float>(0.2 * 4)};
  constexpr float kEps = static_cast<float>(1e-3);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    am.knot[i] = fminf(fmaxf(kBase[i] + __ldg(t + 2 + i) *
                                            static_cast<float>(0.15 / 100.0),
                             kLo[i]),
                       kHi[i]);
#pragma unroll
  for (int i = 1; i < 4; ++i) am.knot[i] = fmaxf(am.knot[i], am.knot[i - 1] + kEps);
#pragma unroll
  for (int i = 2; i >= 0; --i) am.knot[i] = fminf(am.knot[i], am.knot[i + 1] - kEps);
}

// ops/mixer.apply_hsl_mixer on one pixel.
__device__ __forceinline__ void mixer(const Amounts& am, float& r, float& g,
                                      float& b) {
  const float mx = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float c = mx - mn;
  const float safe = c > 0.0f ? c : 1.0f;
  // The hue of the largest channel's sector; only that sector's quotient
  // is used, so its numerator is selected first and divided once.
  const bool is_r = mx == r;
  const bool is_g = !is_r && mx == g;
  const float qh = (is_r ? g - b : (is_g ? b - r : r - g)) / safe;
  const float hr = qh - 6.0f * floorf(qh * static_cast<float>(1.0 / 6.0));
  const float h = (is_r ? hr : (is_g ? qh + 2.0f : qh + 4.0f)) * 60.0f;
  // The hue lies under at most two hats, j and j + 1 with j the last
  // centre at or below it; every other hat's weight is an exact zero,
  // which adds nothing to the three sums, so only these two are
  // evaluated, in the order the full sum takes them.
  int j = 0;
#pragma unroll
  for (int i = 2; i < kHats; ++i) j += h >= kHatKnot[i];  // centres 1..7
  const float w0 = clip01(fminf((h - am.hat_knot[j]) * am.hat_rise[j],
                                (am.hat_knot[j + 2] - h) * am.hat_fall[j]));
  const float w1 =
      clip01(fminf((h - am.hat_knot[j + 1]) * am.hat_rise[j + 1],
                   (am.hat_knot[j + 3] - h) * am.hat_fall[j + 1]));
  const int k1 = j == 7 ? 0 : j + 1;
  float dh = w0 * am.hue[j] + w1 * am.hue[k1];
  const float ds = w0 * am.sat[j] + w1 * am.sat[k1];
  const float dl = w0 * am.lum[j] + w1 * am.lum[k1];
  dh = dh * 0.3f;
  const float fs = fmaxf(1.0f + ds * 0.01f, 0.0f);
  const float fl = exp2f(dl * 0.0075f);
  float h2 = h + dh;
  h2 = h2 - 360.0f * floorf(h2 * static_cast<float>(1.0 / 360.0));
  const float v2 = clip01(mx * fl);
  const float c2 = fminf(clip01(c * fs), v2);
  const float hp = h2 * static_cast<float>(1.0 / 60.0);
  const float r1 = c2 * clip01(fabsf(hp - 3.0f) - 1.0f);
  const float g1 = c2 * clip01(2.0f - fabsf(hp - 2.0f));
  const float b1 = c2 * clip01(2.0f - fabsf(hp - 4.0f));
  const float m = v2 - c2;
  const float tcw = clip01(c * 5.0f);
  const float w = tcw * tcw * (3.0f - 2.0f * tcw);
  r = clip01(r + w * (r1 + m - r));
  g = clip01(g + w * (g1 + m - g));
  b = clip01(b + w * (b1 + m - b));
}

// ops/grading.apply_color_grading on one pixel.
__device__ __forceinline__ void grading(const Amounts& am, float& r, float& g,
                                        float& b) {
  const float y = kLumaR * r + kLumaG * g + kLumaB * b;
  const float t = clip01(y + am.balance);
  const float wt[3] = {(1.0f - t) * (1.0f - t), 2.0f * t * (1.0f - t), t * t};
  float off_r = 0.0f, off_g = 0.0f, off_b = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float amt = wt[k] * am.gsat[k];
    off_r = off_r + amt * am.gdr[k];
    off_g = off_g + amt * am.gdg[k];
    off_b = off_b + amt * am.gdb[k];
  }
  const float u = clip01(8.0f * fminf(y, 1.0f - y));
  const float p = u * u * (3.0f - 2.0f * u);
  r = clip01(r + p * off_r);
  g = clip01(g + p * off_g);
  b = clip01(b + p * off_b);
}

template <bool MIXER, bool GRADING>
__device__ __forceinline__ void unpack_heads(uint32_t v, const Amounts& am,
                                             float& r, float& g, float& b) {
  r = static_cast<float>(v & 0xFFu) * kInv255;
  g = static_cast<float>((v >> 8) & 0xFFu) * kInv255;
  b = static_cast<float>((v >> 16) & 0xFFu) * kInv255;
  if constexpr (MIXER) mixer(am, r, g, b);
  if constexpr (GRADING) grading(am, r, g, b);
}

__device__ __forceinline__ int quantize01(float c) {
  return static_cast<int>(floorf(c * 255.0f + 0.5f));
}

// The tone curve (extras.tone_curve) and the vignette on one luma value;
// ry2 and rx2 are the squares of radial_sq's row and column terms,
// (coordinate - centre) * inverse half-extent.
__device__ __forceinline__ float curve_vignette(const Amounts& am, float y,
                                                float ry2, float rx2) {
  const float t = clip01(y) * 5.0f;
  float out = 0.0f;
  float prev = 0.0f;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float kn = i < 4 ? am.knot[i] : 1.0f;
    out = out + (kn - prev) * clip01(t - static_cast<float>(i));
    prev = kn;
  }
  const float r2 = (ry2 + rx2) * 0.5f;
  return out * (1.0f + am.vig * r2);
}

// Rebuilds r, g, b of one pixel from its luma and chroma, clamps and
// quantises them.
__device__ __forceinline__ void finish_pixel(float cr, float cb, float y,
                                             int* q) {
  const float r = y + cr;
  const float b = y + cb;
  const float g = (y - kLumaR * r - kLumaB * b) * kInvLumaG;
  q[0] = quantize01(clip01(r));
  q[1] = quantize01(clip01(g));
  q[2] = quantize01(clip01(b));
}

// One input row of the lane's two columns as packed RGBA words, from the
// row clamped to the image; the columns clamped too for EDGE.
template <bool EDGE>
__device__ __forceinline__ uint2 load_words(const uint32_t* __restrict__ src,
                                            const Lane<EDGE>& ln, int row,
                                            int h, int w, bool aligned) {
  const uint32_t* p =
      src + static_cast<size_t>(min(max(row, 0), h - 1)) * w;
  if constexpr (EDGE) {
    return make_uint2(__ldg(p + min(max(ln.x0, 0), w - 1)),
                      __ldg(p + min(max(ln.x0 + 1, 0), w - 1)));
  } else {
    if (aligned) return __ldg(reinterpret_cast<const uint2*>(p + ln.x0));
    return make_uint2(__ldg(p + ln.x0), __ldg(p + ln.x0 + 1));
  }
}

// The bilateral's weight of one neighbour pair: kw (2 beside or above, 1
// on a diagonal) over 1 + (difference)^2 / sigma^2. It is the same for
// both pixels of the pair, since (p - q) and (q - p) have one square, so
// each pair is divided once and serves both.
__device__ __forceinline__ float pair_weight(float kw, float p, float q,
                                             float inv_s2) {
  const float dlt = q - p;
  return kw / (1.0f + dlt * dlt * inv_s2);
}

// The bilateral-lite pass on one pixel: num from 4y and den from 4 over
// the eight taps in the order up-left, up, up-right, left, right,
// down-left, down, down-right.
__device__ __forceinline__ float bilateral(float yc, const float (&t)[8],
                                           const float (&wk)[8], float s) {
  float num = yc * 4.0f;
  float den = 4.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    num = num + t[k] * wk[k];
    den = den + wk[k];
  }
  return yc + (num / den - yc) * s;
}

// Marches one warp down the band of output rows [y0, y0 + kBandH) of the
// strip whose first output column is sx (both even). At step t it loads
// input row t and runs the heads and the opponent split on it, computes
// tent 1 of cr/cb and the luma after bilateral, curve and vignette at row
// t-1, and tent 2, the chroma blend, the unsharp mask, the rebuild and
// the store at row t-2.
template <bool MIXER, bool GRADING, bool YCBCR, bool EDGE, bool ROWS>
__device__ __forceinline__ void march_band(
    const Amounts& am, const uint32_t* __restrict__ src, size_t img, int h,
    int w, int y0, int sx, uint32_t* __restrict__ rgba,
    uint8_t* __restrict__ yplane, uint8_t* __restrict__ cbcr) {
  const Lane<EDGE> ln = make_lane<EDGE>(sx - kHalo, w);
  const int lane = threadIdx.x & 31;
  const bool aligned =
      ((w & 1) == 0) && ((reinterpret_cast<uintptr_t>(src) & 7) == 0);
  const int rows = min(kBandH, h - y0);
  const int y_end = y0 + rows + (rows & 1);  // whole quads
  const bool stores = lane >= kHalo / 2 && lane < 32 - kHalo / 2 && ln.x0 < w;
  // The vignette's column terms (a column outside the image takes its
  // neighbour's luma by clamp_columns, whatever is computed here).
  const float rxa = (static_cast<float>(ln.x0) - am.cx) * am.icx;
  const float rxb = (static_cast<float>(ln.x0 + 1) - am.cx) * am.icx;
  const float rxa2 = rxa * rxa;
  const float rxb2 = rxb * rxb;
  const float s = am.s;
  const float inv_s2 = am.inv_s2;

  const Pair zero{0.0f, 0.0f};
  // Rows t-2..t of the opponent planes. The input is read at clamped
  // coordinates and the heads are pointwise, so these need no edge rule.
  Win3 Y{zero, zero, zero}, CR{zero, zero, zero}, CB{zero, zero, zero};
  // Y left of column a and right of column b, rows t-2..t.
  float yl_up = 0.0f, yl_mid = 0.0f, yl_dn = 0.0f;
  float yr_up = 0.0f, yr_mid = 0.0f, yr_dn = 0.0f;
  // The weights of the pairs between rows t-2 and t-1, from the step
  // before: straight down from a and b, a to the b below and b to the a
  // below, and the two that cross to the neighbour lanes as seen from
  // the lower row (up-left of a, up-right of b).
  float pv_a = 0.0f, pv_b = 0.0f, pd_ab = 0.0f, pd_ba = 0.0f;
  float p_ul_a = 0.0f, p_ur_b = 0.0f;
  Win3 TR{zero, zero, zero}, TB{zero, zero, zero};  // tent 1: rows t-3..t-1
  Win3 YV{zero, zero, zero};  // luma after curve and vignette: t-3..t-1
  int q[2][2][3];  // q[0]: the quad's first row, kept for its second

  uint2 next = load_words<EDGE>(src, ln, y0 - kHalo, h, w, aligned);
  for (int t = y0 - kHalo; t < y_end + kHalo; ++t) {
    const uint2 raw = next;
    next = load_words<EDGE>(src, ln, t + 1, h, w, aligned);

    // 0. Row t: heads, opponent split.
    {
      float r, g, b;
      Pair y, cr, cb;
      unpack_heads<MIXER, GRADING>(raw.x, am, r, g, b);
      y.a = kLumaR * r + kLumaG * g + kLumaB * b;
      cr.a = r - y.a;
      cb.a = b - y.a;
      unpack_heads<MIXER, GRADING>(raw.y, am, r, g, b);
      y.b = kLumaR * r + kLumaG * g + kLumaB * b;
      cr.b = r - y.b;
      cb.b = b - y.b;
      Y.template push<false>(y, t, h);
      CR.template push<false>(cr, t, h);
      CB.template push<false>(cb, t, h);
      yl_up = yl_mid;
      yl_mid = yl_dn;
      yl_dn = left_of_a(y);
      yr_up = yr_mid;
      yr_mid = yr_dn;
      yr_dn = right_of_b(y);
    }

    // 1. Row t-1: the bilateral, tone curve and vignette on luma; tent 1
    //    on cr/cb.
    {
      const int row = t - 1;
      // The pairs inside row t-1 and between it and row t.
      const float h_ab = pair_weight(2.0f, Y.mid.a, Y.mid.b, inv_s2);
      const float h_br = pair_weight(2.0f, Y.mid.b, yr_mid, inv_s2);
      const float h_la = __shfl_up_sync(kAllLanes, h_br, 1);
      const float v_a = pair_weight(2.0f, Y.mid.a, Y.dn.a, inv_s2);
      const float v_b = pair_weight(2.0f, Y.mid.b, Y.dn.b, inv_s2);
      const float d_ab = pair_weight(1.0f, Y.mid.a, Y.dn.b, inv_s2);
      const float d_ba = pair_weight(1.0f, Y.mid.b, Y.dn.a, inv_s2);
      const float d_al = pair_weight(1.0f, Y.mid.a, yl_dn, inv_s2);
      const float d_br = pair_weight(1.0f, Y.mid.b, yr_dn, inv_s2);
      const float ta[8] = {yl_up, Y.up.a, Y.up.b, yl_mid,
                           Y.mid.b, yl_dn, Y.dn.a, Y.dn.b};
      const float wa[8] = {p_ul_a, pv_a, pd_ba, h_la, h_ab, d_al, v_a, d_ab};
      const float tb[8] = {Y.up.a, Y.up.b, yr_up, Y.mid.a,
                           yr_mid, Y.dn.a, Y.dn.b, yr_dn};
      const float wb[8] = {pd_ab, pv_b, p_ur_b, h_ab, h_br, d_ba, v_b, d_br};
      const float ry = (static_cast<float>(row) - am.cy) * am.icy;
      const float ry2 = ry * ry;
      Pair yv{curve_vignette(am, bilateral(Y.mid.a, ta, wa, s), ry2, rxa2),
              curve_vignette(am, bilateral(Y.mid.b, tb, wb, s), ry2, rxb2)};
      // The lower row's view of the pairs that cross lanes: this lane's
      // b to the a below on the right is that a's up-left pair; this
      // lane's a to the b below on the left is that b's up-right pair.
      p_ul_a = __shfl_up_sync(kAllLanes, d_br, 1);
      p_ur_b = __shfl_down_sync(kAllLanes, d_al, 1);
      pv_a = v_a;
      pv_b = v_b;
      pd_ab = d_ab;
      pd_ba = d_ba;
      clamp_columns(ln, yv);
      YV.template push<ROWS>(yv, row, h);
      Pair tr = tent3(CR);
      Pair tb1 = tent3(CB);
      clamp_columns(ln, tr);
      clamp_columns(ln, tb1);
      TR.template push<ROWS>(tr, row, h);
      TB.template push<ROWS>(tb1, row, h);
    }

    // 2. Row t-2: tent 2 and the chroma blend, the unsharp mask, the
    //    rebuild; the quad is stored with its second row. (tent3
    //    shuffles, so every lane of the warp takes this branch together.)
    const int row = t - kHalo;
    if (row >= y0) {
      const Pair t2r = tent3(TR);
      const Pair t2b = tent3(TB);
      const Pair blur = tent3(YV);
      finish_pixel(CR.up.a + (t2r.a - CR.up.a) * s,
                   CB.up.a + (t2b.a - CB.up.a) * s,
                   YV.mid.a + (YV.mid.a - blur.a) * am.a, q[1][0]);
      finish_pixel(CR.up.b + (t2r.b - CR.up.b) * s,
                   CB.up.b + (t2b.b - CB.up.b) * s,
                   YV.mid.b + (YV.mid.b - blur.b) * am.a, q[1][1]);
      if (row & 1) {  // y0 is even: the quad's second row
        if (stores)
          store_quad<YCBCR>(q, img, h, w, row - 1, ln.x0, rgba, yplane, cbcr);
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          q[0][0][c] = q[1][0][c];
          q[0][1][c] = q[1][1][c];
        }
      }
    }
  }
}

// One warp per strip and band: EDGE when the strip reads a column outside
// the (h, w) image, ROWS when the band's stages reach row 0 or row h-1
// (both warp-uniform; most of a large frame is neither).
template <bool MIXER, bool GRADING, bool YCBCR>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    extras_bands(const uint32_t* __restrict__ words,
                 const float* __restrict__ table, int h, int w, float cy,
                 float cx, float icy, float icx,
                 uint32_t* __restrict__ rgba, uint8_t* __restrict__ yplane,
                 uint8_t* __restrict__ cbcr) {
  __shared__ Amounts am;
  const size_t img = blockIdx.z;
  if (threadIdx.x == 0) {
    load_amounts(table + img * kExtras, am);
    am.cy = cy;
    am.cx = cx;
    am.icy = icy;
    am.icx = icx;
  }
  __syncthreads();  // the only one: from here on warps share nothing

  const int sx = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kStripW;
  if (sx >= w) return;  // the whole warp
  const int y0 = blockIdx.y * kBandH;
  const uint32_t* src = words + img * static_cast<size_t>(h) * w;
  const bool edge = sx - kHalo < 0 || sx + kStripW + kHalo > w;
  const bool ends = y0 == 0 || y0 + kBandH + kHalo >= h;
  if (edge || ends) {
    // One checked form for both kinds of border: they are few.
    if (edge)
      march_band<MIXER, GRADING, YCBCR, true, true>(am, src, img, h, w, y0,
                                                    sx, rgba, yplane, cbcr);
    else
      march_band<MIXER, GRADING, YCBCR, false, true>(am, src, img, h, w, y0,
                                                     sx, rgba, yplane, cbcr);
  } else {
    march_band<MIXER, GRADING, YCBCR, false, false>(am, src, img, h, w, y0,
                                                    sx, rgba, yplane, cbcr);
  }
}

// The pointwise form (no stencils): the heads per pixel, one thread per
// quad, no clamp after them (the mixer and grading clamp, as extras_core
// returns their planes).
template <bool MIXER, bool GRADING, bool YCBCR>
__global__ void __launch_bounds__(kThreads)
    extras_quads(const uint32_t* __restrict__ words,
                 const float* __restrict__ table, int h, int w,
                 uint32_t* __restrict__ rgba, uint8_t* __restrict__ yplane,
                 uint8_t* __restrict__ cbcr) {
  __shared__ Amounts am;
  const size_t img = blockIdx.z;
  if (threadIdx.x == 0) load_amounts(table + img * kExtras, am);
  __syncthreads();
  const uint32_t* src = words + img * static_cast<size_t>(h) * w;
  const int y0 = blockIdx.y * kTileH + 2 * (threadIdx.x / (kTileW / 2));
  const int x0 = blockIdx.x * kTileW + 2 * (threadIdx.x % (kTileW / 2));
  if (y0 >= h || x0 >= w) return;
  int q[2][2][3];
#pragma unroll
  for (int iy = 0; iy < 2; ++iy) {
#pragma unroll
    for (int ix = 0; ix < 2; ++ix) {
      const int y = min(y0 + iy, h - 1);
      const int x = min(x0 + ix, w - 1);
      float r, g, b;
      unpack_heads<MIXER, GRADING>(
          __ldg(src + static_cast<size_t>(y) * w + x), am, r, g, b);
      q[iy][ix][0] = quantize01(r);
      q[iy][ix][1] = quantize01(g);
      q[iy][ix][2] = quantize01(b);
    }
  }
  store_quad<YCBCR>(q, img, h, w, y0, x0, rgba, yplane, cbcr);
}

template <bool MIXER, bool GRADING, bool STENCILS, bool YCBCR>
void launch_output(int n, cudaStream_t st, const uint32_t* words,
                   const float* table, int h, int w, float cy, float cx,
                   float icy, float icx, uint32_t* rgba, uint8_t* yplane,
                   uint8_t* cbcr) {
  if constexpr (STENCILS) {
    const int strips = (w + kStripW - 1) / kStripW;
    const dim3 grid((strips + kWarps - 1) / kWarps, (h + kBandH - 1) / kBandH,
                    n);
    extras_bands<MIXER, GRADING, YCBCR><<<grid, kThreads, 0, st>>>(
        words, table, h, w, cy, cx, icy, icx, rgba, yplane, cbcr);
  } else {
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
    extras_quads<MIXER, GRADING, YCBCR><<<grid, kThreads, 0, st>>>(
        words, table, h, w, rgba, yplane, cbcr);
  }
}

template <bool MIXER, bool GRADING, bool STENCILS>
void launch(bool ycbcr, int n, cudaStream_t st, const uint32_t* words,
            const float* table, int h, int w, float cy, float cx, float icy,
            float icx, void* out0, void* out1) {
  if (ycbcr)
    launch_output<MIXER, GRADING, STENCILS, true>(
        n, st, words, table, h, w, cy, cx, icy, icx, nullptr,
        static_cast<uint8_t*>(out0), static_cast<uint8_t*>(out1));
  else
    launch_output<MIXER, GRADING, STENCILS, false>(
        n, st, words, table, h, w, cy, cx, icy, icx,
        static_cast<uint32_t*>(out0), nullptr, nullptr);
}

}  // namespace

// words (n, h, w) u32 packed RGBA, table (n, 38) f32 per-image amounts,
// contiguous on the device. output 0: out0 = (n, h, w) u32 RGBA words.
// output 1: out0 = (n, h, w) u8 Y, out1 = (n, h/2, w) u8 interleaved
// CbCr; h and w must be even. mixer_on, grading_on, stencils: 0 or 1.
// (cy, cx, icy, icx): radial_sq's centre and inverse half-extents for
// (h, w). Launches on ``stream``, does not synchronise, and returns the
// cudaGetLastError() code.
extern "C" int rtt_extras_launch(const void* words, const void* table,
                                 void* out0, void* out1, int n, int h, int w,
                                 int mixer_on, int grading_on, int stencils,
                                 int output, float cy, float cx, float icy,
                                 float icx, void* stream) {
  if (const int bad = check_args(n, h, w, 0, 0, output)) return bad;
  if ((mixer_on | grading_on | stencils) & ~1)
    return static_cast<int>(cudaErrorInvalidValue);
  // Grid rows: bands for the stencil form, tiles for the pointwise one.
  const int grid_rows = stencils ? (h + kBandH - 1) / kBandH
                                 : (h + kTileH - 1) / kTileH;
  if (grid_rows > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* wd = static_cast<const uint32_t*>(words);
  const auto* tb = static_cast<const float*>(table);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool ycbcr = output == 1;
  switch (mixer_on * 4 + grading_on * 2 + stencils) {
    case 0: launch<false, false, false>(ycbcr, n, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
    case 1: launch<false, false, true>(ycbcr, n, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
    case 2: launch<false, true, false>(ycbcr, n, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
    case 3: launch<false, true, true>(ycbcr, n, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
    case 4: launch<true, false, false>(ycbcr, n, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
    case 5: launch<true, false, true>(ycbcr, n, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
    case 6: launch<true, true, false>(ycbcr, n, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
    default: launch<true, true, true>(ycbcr, n, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
  }
  return static_cast<int>(cudaGetLastError());
}
