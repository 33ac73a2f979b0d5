// Finish-extras post-pass for Hopper (sm_90a): packed RGBA u32 words in,
// packed RGBA words or JPEG YCbCr 4:2:0 planes out, in one pass.
//
// Replaces the TPU kernel raweditor_tpu/ops/pallas_develop.py
// (pallas_finish_extras_rgba -> _extras_kernel_flat -> _extras_window,
// which runs ops/extras.extras_core; for output="ycbcr420" the
// _emit_ycbcr420 tail). Its TPU mechanics (_band_realign, the roll
// fix-ups of _clamp_shift_fns, the 128-lane width pad, the row pad and
// grid overhang, the (bh+16)-row DMA windows, the SMEM scalar table) have
// no counterpart here: a block clamps at the true image edge itself and
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
// What bounds it: operations. It reads 4 B/px and writes 4 B/px (RGBA)
// or 1.5 B/px (planes): 193 MB or 133 MB per 24 MP frame, 0.058 ms or
// 0.040 ms at 3.35 TB/s. The stencil stages alone are some 150 f32
// operations per output pixel with the halo recompute, the mixer about
// 200 and grading about 45 more on every loaded pixel, two divisions
// per bilateral tap among them: 0.06-0.13 ms per frame at 67 TFLOP/s.
// The design keeps every stage out of device memory: one block of 128
// threads owns a 32x16-pixel output tile (even origin, batch index as
// grid z), loads the words of the tile plus a 2-pixel halo once, runs
// the pointwise heads and the opponent split on every loaded pixel, and
// computes each stencil stage in shared memory over a region one pixel
// wider than the stage that reads it:
//   load, heads, y/cr/cb         tile+2
//   column pass of tent 1 (cr/cb) rows tile+1, columns tile+2
//   bilateral, curve, vignette    tile+1
//   tent 1 row pass (cr/cb)       tile+1
//   column pass of the sharpen tent (y) and of tent 2 (cr/cb)
//                                 rows tile, columns tile+1
//   per quad: the row passes, the chroma blend, the unsharp mask, the
//   rebuild, quantisation and the store (one thread per 2x2 quad).
// Shared memory: eight 20x36-float stage buffers, 23 KB per block.
// Later work: larger tiles or a sliding row window to cut the halo
// recompute (1.4x on the heads), vector loads.
//
// Clamp-to-edge: every stage reads the stage below at coordinates
// clamped to the image (Frame::at), as the JAX shift closures
// _pad_shift_fns do, so a composed stage never reads a stage value that
// lies outside the image. A tile whose halo lies inside the image takes
// the same code without the clamps.
//
// Numerics: ops/extras.py's operation order (tent3 as ((up + 2x) + dn),
// then ((lf + 2xv) + rt) * 0.0625; the bilateral's num from 4y and den
// from 4 over the 8 taps in order; the knots of the tone curve by the
// forward-max / backward-min cascade), built with -fmad=false and IEEE
// division, as the plain PyTorch version rounds. The f32 constants are
// the JAX expressions: a double quotient rounded once to float.

#include "develop_common.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kHalo = 2;
constexpr int kPitch = kTileW + 2 * kHalo;  // 36
constexpr int kRows = kTileH + 2 * kHalo;   // 20
constexpr int kCells = kPitch * kRows;
constexpr int kThreads = (kTileW / 2) * (kTileH / 2);  // one per quad
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
// the right. The slopes are the f32 of the double reciprocals.
__constant__ float kHatKnot[11] = {-40.0f, 0.0f,   30.0f,  60.0f,
                                   120.0f, 180.0f, 240.0f, 280.0f,
                                   320.0f, 360.0f, 390.0f};
__constant__ float kHatRise[9] = {
    static_cast<float>(1.0 / 40.0),  static_cast<float>(1.0 / 30.0),
    static_cast<float>(1.0 / 30.0),  static_cast<float>(1.0 / 60.0),
    static_cast<float>(1.0 / 60.0),  static_cast<float>(1.0 / 60.0),
    static_cast<float>(1.0 / 40.0),  static_cast<float>(1.0 / 40.0),
    static_cast<float>(1.0 / 40.0)};
__constant__ float kHatFall[9] = {
    static_cast<float>(1.0 / 30.0),  static_cast<float>(1.0 / 30.0),
    static_cast<float>(1.0 / 60.0),  static_cast<float>(1.0 / 60.0),
    static_cast<float>(1.0 / 60.0),  static_cast<float>(1.0 / 40.0),
    static_cast<float>(1.0 / 40.0),  static_cast<float>(1.0 / 40.0),
    static_cast<float>(1.0 / 30.0)};

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// The per-image amounts and what the kernel derives from them once.
struct Amounts {
  float hue[8], sat[8], lum[8];         // mixer knots
  float gdr[3], gdg[3], gdb[3], gsat[3], balance;  // grading wheels
  float s, inv_s2, a, vig, knot[4];     // denoise, sharpen, vignette, curve
  float cy, cx, icy, icx;               // radial_sq constants
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
  float hr = (g - b) / safe;
  hr = hr - 6.0f * floorf(hr * static_cast<float>(1.0 / 6.0));
  const float hg = (b - r) / safe + 2.0f;
  const float hb = (r - g) / safe + 4.0f;
  const bool is_r = mx == r;
  const bool is_g = !is_r && mx == g;
  const float h = (is_r ? hr : (is_g ? hg : hb)) * 60.0f;
  float dh = 0.0f, ds = 0.0f, dl = 0.0f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float rise = (h - kHatKnot[i]) * kHatRise[i];
    const float fall = (kHatKnot[i + 2] - h) * kHatFall[i];
    const float w = clip01(fminf(rise, fall));
    const int k = i % 8;
    // The first term starts each sum (0 + x is x, also for -0).
    dh = i == 0 ? w * am.hue[k] : dh + w * am.hue[k];
    ds = i == 0 ? w * am.sat[k] : ds + w * am.sat[k];
    dl = i == 0 ? w * am.lum[k] : dl + w * am.lum[k];
  }
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

// The tone curve (extras.tone_curve) and the vignette on one luma value
// at global (gy, gx).
__device__ __forceinline__ float curve_vignette(const Amounts& am, float y,
                                                int gy, int gx) {
  const float t = clip01(y) * 5.0f;
  float out = 0.0f;
  float prev = 0.0f;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float kn = i < 4 ? am.knot[i] : 1.0f;
    out = out + (kn - prev) * clip01(t - static_cast<float>(i));
    prev = kn;
  }
  const float ry = (static_cast<float>(gy) - am.cy) * am.icy;
  const float rx = (static_cast<float>(gx) - am.cx) * am.icx;
  const float r2 = (ry * ry + rx * rx) * 0.5f;
  return out * (1.0f + am.vig * r2);
}

// The tile's local frame: local (0, 0) is global (oy, ox) = the tile
// origin minus the halo. An INTERIOR frame lies inside the image, so no
// read needs a clamp there.
template <bool INTERIOR>
struct Frame {
  int oy, ox, h, w;
  // Local index of the image pixel nearest to (gy + dy, gx + dx), where
  // i is the local index of (gy, gx).
  __device__ __forceinline__ int at(int i, int gy, int gx, int dy,
                                    int dx) const {
    if constexpr (INTERIOR) return i + dy * kPitch + dx;
    return (min(max(gy + dy, 0), h - 1) - oy) * kPitch +
           (min(max(gx + dx, 0), w - 1) - ox);
  }
};

// Calls fn(gy, gx, local index) for every position of the tile grown by
// gy_grow rows and gx_grow columns on each side.
template <typename F>
__device__ __forceinline__ void over_region(int oy, int ox, int gy_grow,
                                            int gx_grow, F fn) {
  const int rows = kTileH + 2 * gy_grow;
  const int cols = kTileW + 2 * gx_grow;
  const int ly0 = kHalo - gy_grow;
  const int lx0 = kHalo - gx_grow;
  for (int k = threadIdx.x; k < rows * cols; k += kThreads) {
    const int ly = ly0 + k / cols;
    const int lx = lx0 + k % cols;
    fn(oy + ly, ox + lx, ly * kPitch + lx);
  }
}

// The shared-memory stage buffers of one block. Y, CR, CB: the opponent
// planes. XR, XB: column passes over cr/cb (tent 1, then tent 2). TR, TB:
// tent 1 of cr/cb. YV: luma after the bilateral, curve and vignette. The
// column pass of the sharpen tent reuses Y.
struct Stages {
  float *Y, *CR, *CB, *XR, *XB, *TR, *TB, *YV;
};

template <bool MIXER, bool GRADING, bool YCBCR, bool INTERIOR>
__device__ __forceinline__ void stencil_tile(
    const Stages& st, const Amounts& am, const uint32_t* __restrict__ src,
    size_t img, int h, int w, int ty0, int tx0, uint32_t* __restrict__ rgba,
    uint8_t* __restrict__ yplane, uint8_t* __restrict__ cbcr) {
  float* const Y = st.Y;
  float* const CR = st.CR;
  float* const CB = st.CB;
  float* const XR = st.XR;
  float* const XB = st.XB;
  float* const TR = st.TR;
  float* const TB = st.TB;
  float* const YV = st.YV;
  const Frame<INTERIOR> f{ty0 - kHalo, tx0 - kHalo, h, w};

  // Load the tile + 2 at clamped coordinates: heads, opponent split.
  over_region(f.oy, f.ox, 2, 2, [&](int gy, int gx, int i) {
    const int y = INTERIOR ? gy : min(max(gy, 0), h - 1);
    const int x = INTERIOR ? gx : min(max(gx, 0), w - 1);
    float r, g, b;
    unpack_heads<MIXER, GRADING>(__ldg(src + static_cast<size_t>(y) * w + x),
                                 am, r, g, b);
    const float yl = kLumaR * r + kLumaG * g + kLumaB * b;
    Y[i] = yl;
    CR[i] = r - yl;
    CB[i] = b - yl;
  });
  __syncthreads();

  // Tent 1's column pass over cr/cb; the bilateral, the tone curve and
  // the vignette over the tile + 1.
  over_region(f.oy, f.ox, 1, 2, [&](int gy, int gx, int i) {
    const int ku = f.at(i, gy, gx, -1, 0);
    const int kc = f.at(i, gy, gx, 0, 0);
    const int kd = f.at(i, gy, gx, 1, 0);
    XR[i] = (CR[ku] + CR[kc] * 2.0f) + CR[kd];
    XB[i] = (CB[ku] + CB[kc] * 2.0f) + CB[kd];
  });
  over_region(f.oy, f.ox, 1, 1, [&](int gy, int gx, int i) {
    const float yc = Y[f.at(i, gy, gx, 0, 0)];
    constexpr int kDy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
    constexpr int kDx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
    constexpr float kW[8] = {1.0f, 2.0f, 1.0f, 2.0f, 2.0f, 1.0f, 2.0f, 1.0f};
    float num = yc * 4.0f;
    float den = 4.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float t = Y[f.at(i, gy, gx, kDy[k], kDx[k])];
      const float dlt = t - yc;
      const float wk = kW[k] / (1.0f + dlt * dlt * am.inv_s2);
      num = num + t * wk;
      den = den + wk;
    }
    const float yb = yc + (num / den - yc) * am.s;
    YV[i] = curve_vignette(am, yb, gy, gx);
  });
  __syncthreads();

  auto row_pass = [&](const float* x, int i, int gy, int gx) {
    return ((x[f.at(i, gy, gx, 0, -1)] + x[f.at(i, gy, gx, 0, 0)] * 2.0f) +
            x[f.at(i, gy, gx, 0, 1)]) *
           0.0625f;
  };
  auto column_pass = [&](const float* x, int i, int gy, int gx) {
    return (x[f.at(i, gy, gx, -1, 0)] + x[f.at(i, gy, gx, 0, 0)] * 2.0f) +
           x[f.at(i, gy, gx, 1, 0)];
  };

  // Tent 1's row pass over the tile + 1; the sharpen tent's column pass
  // (into Y, whose last reader was the bilateral).
  over_region(f.oy, f.ox, 1, 1, [&](int gy, int gx, int i) {
    TR[i] = row_pass(XR, i, gy, gx);
    TB[i] = row_pass(XB, i, gy, gx);
  });
  over_region(f.oy, f.ox, 0, 1, [&](int gy, int gx, int i) {
    Y[i] = column_pass(YV, i, gy, gx);
  });
  __syncthreads();

  // Tent 2's column pass over tent 1.
  over_region(f.oy, f.ox, 0, 1, [&](int gy, int gx, int i) {
    XR[i] = column_pass(TR, i, gy, gx);
    XB[i] = column_pass(TB, i, gy, gx);
  });
  __syncthreads();

  const int qx = threadIdx.x % (kTileW / 2);
  const int qy = threadIdx.x / (kTileW / 2);
  const int y0 = ty0 + 2 * qy;
  const int x0 = tx0 + 2 * qx;
  if (y0 >= h || x0 >= w) return;
  int q[2][2][3];
#pragma unroll
  for (int iy = 0; iy < 2; ++iy) {
#pragma unroll
    for (int ix = 0; ix < 2; ++ix) {
      const int gy = y0 + iy;
      const int gx = x0 + ix;
      const int i = (gy - f.oy) * kPitch + (gx - f.ox);
      const int kc = f.at(i, gy, gx, 0, 0);
      float cr = CR[kc];
      float cb = CB[kc];
      cr = cr + (row_pass(XR, i, gy, gx) - cr) * am.s;
      cb = cb + (row_pass(XB, i, gy, gx) - cb) * am.s;
      const float yv = YV[kc];
      const float y = yv + (yv - row_pass(Y, i, gy, gx)) * am.a;
      const float r = y + cr;
      const float b = y + cb;
      const float g = (y - kLumaR * r - kLumaB * b) * kInvLumaG;
      q[iy][ix][0] = quantize01(clip01(r));
      q[iy][ix][1] = quantize01(clip01(g));
      q[iy][ix][2] = quantize01(clip01(b));
    }
  }
  store_quad<YCBCR>(q, img, h, w, y0, x0, rgba, yplane, cbcr);
}

template <bool MIXER, bool GRADING, bool STENCILS, bool YCBCR>
__global__ void __launch_bounds__(kThreads)
    extras_tiles(const uint32_t* __restrict__ words,
                 const float* __restrict__ table, int h, int w, float cy,
                 float cx, float icy, float icx,
                 uint32_t* __restrict__ rgba, uint8_t* __restrict__ yplane,
                 uint8_t* __restrict__ cbcr) {
  const size_t img = blockIdx.z;
  Amounts am;
  load_amounts(table + img * kExtras, am);
  am.cy = cy;
  am.cx = cx;
  am.icy = icy;
  am.icx = icx;
  const uint32_t* src = words + img * static_cast<size_t>(h) * w;
  const int ty0 = blockIdx.y * kTileH;
  const int tx0 = blockIdx.x * kTileW;
  if constexpr (STENCILS) {
    __shared__ float buf[8][kCells];
    const Stages st{buf[0], buf[1], buf[2], buf[3],
                    buf[4], buf[5], buf[6], buf[7]};
    // Block-uniform: most tiles of a large frame read no pixel outside it.
    if (ty0 >= kHalo && tx0 >= kHalo && ty0 + kTileH + kHalo <= h &&
        tx0 + kTileW + kHalo <= w)
      stencil_tile<MIXER, GRADING, YCBCR, true>(st, am, src, img, h, w, ty0,
                                                tx0, rgba, yplane, cbcr);
    else
      stencil_tile<MIXER, GRADING, YCBCR, false>(st, am, src, img, h, w, ty0,
                                                 tx0, rgba, yplane, cbcr);
  } else {
    // Pointwise only: the heads per pixel, no clamp after them (the
    // mixer and grading clamp, as extras_core returns their planes).
    const int y0 = ty0 + 2 * (threadIdx.x / (kTileW / 2));
    const int x0 = tx0 + 2 * (threadIdx.x % (kTileW / 2));
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
}

template <bool MIXER, bool GRADING, bool STENCILS>
void launch(bool ycbcr, dim3 grid, cudaStream_t st, const uint32_t* words,
            const float* table, int h, int w, float cy, float cx, float icy,
            float icx, void* out0, void* out1) {
  if (ycbcr)
    extras_tiles<MIXER, GRADING, STENCILS, true><<<grid, kThreads, 0, st>>>(
        words, table, h, w, cy, cx, icy, icx, nullptr,
        static_cast<uint8_t*>(out0), static_cast<uint8_t*>(out1));
  else
    extras_tiles<MIXER, GRADING, STENCILS, false><<<grid, kThreads, 0, st>>>(
        words, table, h, w, cy, cx, icy, icx, static_cast<uint32_t*>(out0),
        nullptr, nullptr);
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
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* wd = static_cast<const uint32_t*>(words);
  const auto* tb = static_cast<const float*>(table);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool ycbcr = output == 1;
  switch (mixer_on * 4 + grading_on * 2 + stencils) {
    case 0: launch<false, false, false>(ycbcr, grid, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
    case 1: launch<false, false, true>(ycbcr, grid, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
    case 2: launch<false, true, false>(ycbcr, grid, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
    case 3: launch<false, true, true>(ycbcr, grid, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
    case 4: launch<true, false, false>(ycbcr, grid, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
    case 5: launch<true, false, true>(ycbcr, grid, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
    case 6: launch<true, true, false>(ycbcr, grid, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
    default: launch<true, true, true>(ycbcr, grid, st, wd, tb, h, w, cy, cx, icy, icx, out0, out1); break;
  }
  return static_cast<int>(cudaGetLastError());
}
