// Fused develop for Hopper (sm_90a) with the one-stage stencils: on a
// Bayer phase nearest (the parity stencil), bilinear and
// Malvar-He-Cutler (develop_quads); on a repeating-CFA pattern such as
// the 6x6 X-Trans grid nearest-site (develop_quads_cfa) and the radius-1
// normalised convolution "smooth" (develop_bands_cfa). u16 mosaic in,
// packed RGBA u32 words or JPEG YCbCr 4:2:0 planes out, in one pass. The
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
// What bounds it: instructions and their latency, not bytes. At 24 MP a
// kernel reads 2 B/px of mosaic and writes 4 B/px (RGBA) or 1.5 B/px
// (planes), about 145 MB or 79 MB per image, 0.043 or 0.024 ms at
// 3.35 TB/s. On an NVIDIA H100 80GB HBM3 at 700.00 W the Bayer nearest
// kernel of one thread per quad took 0.30 ms for one frame: 0.18 ms of
// it the three powf a pixel of the transfer, 0.05 ms the rest of the
// tail, 0.08 ms the window load (16 clamped 2-byte loads a quad, 36 for
// Malvar) and the store. The transfer is now an exact table lookup
// (develop_common.cuh); what is left is the matrix, tone and saturation
// of the tail (-fmad=false: a multiply and an add are two instructions),
// the lookups' dependent shared-memory loads, and the load and store.
//
// Design, Bayer (develop_quads): one thread per TWO 2x2 quads side by
// side, a block of kBlockX x kBlockY threads per tile of kBayerTileW x
// kBayerTileH pixels, kTileRows tiles down the image per block (the
// quantiser table is copied to shared memory once per block), the batch
// as the grid's z dimension. A quad is the unit of both the Bayer parity
// pattern and the 4:2:0 chroma sample, so a thread owns whole chroma
// samples and no cross-thread reduction is needed. Each thread loads the
// clamped window around its two quads, rows y0-R..y0+1+R and columns
// x0-R..x0+3+R (R = 1 for nearest and bilinear, 2 for Malvar's +-2
// taps). Where the row is 8-byte aligned and the window lies inside the
// image, a row is three loads (4, 8 and 4 bytes: columns x0-2..x0+5), not
// 6 or 8 scalar 2-byte loads; the store is one 16-byte word per row
// (RGBA) or 4 bytes of Y per row and 4 of CbCr. Rows are clamped to the
// image per window row; threads whose window reaches past the left or
// right edge, and frames whose rows are not aligned (W not a multiple of
// 4), load each column clamped. Clamping each coordinate at the true
// image edge gives clamp-to-edge for every pixel inside the image (it
// reproduces the TPU kernel's up2/down2 row fixups and the edge columns
// of _shift_x), and the ragged quads of an odd H or W mask their stores.
// Any (H, W) works. The two quads are worked one after the other in a
// loop that is not unrolled, each packed to its output bytes at once,
// and the kernel is held to 64 registers (four blocks an SM, a few spills
// to L1). The first form of this design unrolled both quads into 88-104
// registers, two blocks an SM; against it in turns (same card): nearest
// 0.20 -> 0.17 ms for one frame, Malvar 0.25 -> 0.20 ms, planes of four
// frames 0.64 -> 0.61 and 0.87 -> 0.77 ms.
//
// Design, generic-CFA nearest (develop_quads_cfa): one thread per quad,
// grid (W/2, H/2, N). On a repeating-CFA pattern the quad does not align
// with the period, but it is still the chroma sample, so each of its four
// pixels looks up its own pattern cell in the tables (cfa_tables.cuh):
// nearest picks, per pixel and channel, one of the five taps
// centre/left/right/up/down by the cell's tap code.
//
// Design, smooth (develop_bands_cfa): the warp march of band_march.cuh
// with a halo of one. A warp owns 64 columns, 62 of them output, a lane
// two; it walks a band of kCfaBandH rows, loads each mosaic row once (the
// next row requested before this one is worked on) and keeps three rows
// of raw * scale in registers. Smooth sums the nine taps of each channel,
// each zeroed unless the site at its UNCLAMPED coordinates is of that
// channel (the mask continues periodically past the image edge while the
// value repeats the edge pixel): a lane's two columns fix its cell
// columns for the band, so their channels over the period's rows sit
// packed in one register and the cell row advances with a wrap, no
// modulo per pixel. The column sums (a + b*2) + c are computed once per
// lane, row and channel and handed to the neighbours by shuffle (the
// thread per quad summed three columns per pixel), then the row sum in
// the same form, over the cell's denominator. Only the two channels a
// site lacks are divided, and where a warp vote finds every lane's
// denominators a power of two (two of the X-Trans grid's six rows) by a
// multiply with the exact reciprocal, which is the same rounded quotient.
// A strip starts one column left of an even column, so a lane's first
// column is odd: it stores the quad of its second column and the right
// neighbour's first, whose quantised pixel comes by one shuffle. Against
// the thread per quad in turns (same card): smooth 0.46 -> 0.43 ms for
// one frame, 1.86 -> 1.71 ms for four to planes; bands of 24 rows beat 64
// by 6% on one frame (1.4 waves of long bands leave SMs idle at the end).
// Generic-CFA nearest through the same march lost 1 to 4% on one frame and
// tied on four: it was all tail (three powf a pixel then), and the march
// runs the tail on its two halo columns too. So it keeps the thread per
// quad.
//
// Numerics: the stencils keep _demosaic_smooth_taps' factored sums in its
// written order (hsum, vsum, diag4, then each filter's terms), on
// raw * scale before the folded black offset; Malvar is floored at the
// folded black level sc[19], not at 0. The finish tail is
// develop_common.cuh.

#include "band_march.cuh"
#include "cfa_tables.cuh"
#include "develop_common.cuh"

namespace {

// The generic-CFA quad kernel: a thread per quad, blocks of kBlockX x
// kBlockY quads. The Bayer kernel: a thread per two quads, blocks of
// kBlockX x kBlockY threads, kBayerTileW x kBayerTileH pixels.
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreadCols = 4;  // columns per Bayer thread: two quads
constexpr int kBayerTileW = kBlockX * kThreadCols;  // 128 columns
constexpr int kBayerTileH = kBlockY * 2;            // 16 rows
constexpr int kTileRows = 4;        // tiles down the image per block
constexpr int kBayerBlockH = kBayerTileH * kTileRows;  // 64 rows a block
constexpr int kBayerMinBlocks = 4;  // blocks per SM: at most 64 registers

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

// raw * s over the clamped window of a Bayer thread's two quads at
// (y0, x0), x0 a multiple of 4: rows y0-R..y0+1+R, columns x0-R..x0+3+R.
// `fast`: the rows are 8-byte aligned and columns x0-2..x0+5 lie inside
// the image, so each row is read as three words.
template <int R>
__device__ __forceinline__ void load_window2(
    const uint16_t* __restrict__ m, int h, int w, int y0, int x0, float s,
    bool fast, float (&v)[2 + 2 * R][4 + 2 * R]) {
  constexpr int N = 2 + 2 * R;
  constexpr int M = 4 + 2 * R;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint16_t* row = m + static_cast<size_t>(min(max(y0 - R + i, 0), h - 1)) * w;
    if (fast) {
      const uint32_t lo = __ldg(reinterpret_cast<const uint32_t*>(row + x0 - 2));
      const uint2 mid = __ldg(reinterpret_cast<const uint2*>(row + x0));
      const uint32_t hi = __ldg(reinterpret_cast<const uint32_t*>(row + x0 + 4));
      const uint32_t c[8] = {lo & 0xffffu, lo >> 16, mid.x & 0xffffu,
                             mid.x >> 16, mid.y & 0xffffu, mid.y >> 16,
                             hi & 0xffffu, hi >> 16};  // columns x0-2..x0+5
#pragma unroll
      for (int j = 0; j < M; ++j)
        v[i][j] = static_cast<float>(c[j + 2 - R]) * s;
    } else {
#pragma unroll
      for (int j = 0; j < M; ++j)
        v[i][j] = static_cast<float>(__ldg(row + min(max(x0 - R + j, 0), w - 1))) * s;
    }
  }
}

// One Bayer site's camera RGB from the window v, whose (cy, cx) is the
// pixel; ye, xe: the pixel's row and column are of the phase's even class.
template <int DEMOSAIC, int N, int M>
__device__ __forceinline__ void bayer_site(const float (&v)[N][M], int cy,
                                           int cx, bool ye, bool xe,
                                           float floor_, float& r, float& g,
                                           float& b) {
  const float c = v[cy][cx];
  const float left = v[cy][cx - 1];
  const float right = v[cy][cx + 1];
  const float up = v[cy - 1][cx];
  const float down = v[cy + 1][cx];
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
      r = fmaxf(ye ? (xe ? c : kr) : (xe ? kc : kd), floor_);
      g = fmaxf(ye == xe ? gc : c, floor_);
      b = fmaxf(ye ? (xe ? kd : kc) : (xe ? kr : c), floor_);
    }
  }
}

// Develops one Bayer thread's two quads at (y0, x0) and stores them:
// each quad is quantised and packed (RGBA words, or Y bytes and the CbCr
// pair) before the next is worked on.
template <bool YCBCR, int DEMOSAIC>
__device__ __forceinline__ void develop_pair(
    const Tail& tail, const uint16_t* __restrict__ m, size_t img, int h,
    int w, int y0, int x0, int py, int px, bool load_fast, bool store_fast,
    uint32_t* __restrict__ rgba, uint8_t* __restrict__ yplane,
    uint8_t* __restrict__ cbcr) {
  constexpr int R = DEMOSAIC == kMalvar ? 2 : 1;  // window radius
  float v[2 + 2 * R][4 + 2 * R];
  load_window2<R>(m, h, w, y0, x0, tail.sc[12], load_fast, v);

  // CFA parity in global coordinates; y0 and x0 are even. One quad at a
  // time (not unrolled: fewer live registers), the window shifted two
  // columns left for the second.
  const float floor_ = tail.sc[19];
  uint32_t prev[2][2], cur[2][2] = {};        // RGBA: [row][column]
  uint32_t yrow[2] = {0u, 0u}, chroma = 0u;  // YCbCr: bytes by column
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {
    int q[2][2][3];
#pragma unroll
    for (int iy = 0; iy < 2; ++iy) {
#pragma unroll
      for (int ix = 0; ix < 2; ++ix) {
        const bool ye = ((iy + py) & 1) == 0;
        const bool xe = ((ix + px) & 1) == 0;
        float r, g, b;
        bayer_site<DEMOSAIC>(v, iy + R, ix + R, ye, xe, floor_, r, g, b);
        finish(tail, r, g, b, q[iy][ix]);
      }
    }
    if constexpr (!YCBCR) {
#pragma unroll
      for (int iy = 0; iy < 2; ++iy) {
        prev[iy][0] = cur[iy][0];
        prev[iy][1] = cur[iy][1];
        cur[iy][0] = rgba_word(q[iy][0]);
        cur[iy][1] = rgba_word(q[iy][1]);
      }
    } else {
      uint8_t yq[2][2], cb, cr;
      ycbcr_quad(q, yq, cb, cr);
#pragma unroll
      for (int iy = 0; iy < 2; ++iy)
        yrow[iy] |= (static_cast<uint32_t>(yq[iy][0]) |
                     (static_cast<uint32_t>(yq[iy][1]) << 8)) << (16 * k);
      chroma |= (static_cast<uint32_t>(cb) | (static_cast<uint32_t>(cr) << 8))
                << (16 * k);
    }
#pragma unroll
    for (int i = 0; i < 2 + 2 * R; ++i)
#pragma unroll
      for (int j = 0; j < 2 + 2 * R; ++j) v[i][j] = v[i][j + 2];
  }

  const size_t plane = static_cast<size_t>(h) * w;
  if constexpr (!YCBCR) {
    uint32_t* out = rgba + img * plane;
#pragma unroll
    for (int iy = 0; iy < 2; ++iy) {
      const int y = y0 + iy;
      if (y >= h) break;
      uint32_t* dst = out + static_cast<size_t>(y) * w + x0;
      const uint32_t word[4] = {prev[iy][0], prev[iy][1], cur[iy][0],
                                cur[iy][1]};
      if (store_fast) {  // both quads whole: one 16-byte word
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(word[0], word[1], word[2], word[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (x0 + c < w) dst[c] = word[c];
      }
    }
  } else {  // h and w even
    uint8_t* yout = yplane + img * plane + static_cast<size_t>(y0) * w + x0;
    uint8_t* cout = cbcr + img * (plane / 2) + static_cast<size_t>(y0 / 2) * w +
                    x0;
    if (store_fast) {
      *reinterpret_cast<uint32_t*>(yout) = yrow[0];
      *reinterpret_cast<uint32_t*>(yout + w) = yrow[1];
      *reinterpret_cast<uint32_t*>(cout) = chroma;
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (x0 + 2 * k >= w) break;
        *reinterpret_cast<uint16_t*>(yout + 2 * k) = yrow[0] >> (16 * k);
        *reinterpret_cast<uint16_t*>(yout + w + 2 * k) = yrow[1] >> (16 * k);
        *reinterpret_cast<uint16_t*>(cout + 2 * k) = chroma >> (16 * k);
      }
    }
  }
}

// A block of kBlockX x kBlockY threads loads the tail once and develops
// kTileRows tiles of kBayerTileW x kBayerTileH pixels down the image.
template <bool YCBCR, int DEMOSAIC>
__global__ void __launch_bounds__(kBlockX* kBlockY, kBayerMinBlocks)
    develop_quads(const uint16_t* __restrict__ mosaics,
                  const float* __restrict__ scal,
                  const QuantTable* __restrict__ quant, int h, int w, int py,
                  int px, uint32_t* __restrict__ rgba,
                  uint8_t* __restrict__ yplane,
                  uint8_t* __restrict__ cbcr) {
  const size_t img = blockIdx.z;
  __shared__ Tail tail;
  load_tail(&tail, quant, scal + img * kScalars,
            threadIdx.y * kBlockX + threadIdx.x, kBlockX * kBlockY);
  __syncthreads();
  const int x0 = (blockIdx.x * kBlockX + threadIdx.x) * kThreadCols;
  if (x0 >= w) return;
  const uint16_t* m = mosaics + img * static_cast<size_t>(h) * w;
  // With W a multiple of 4 every row starts 8-byte aligned (16 for words).
  const bool wide = (w & 3) == 0;
  const bool load_fast = wide && x0 >= 2 && x0 + 6 <= w &&
                         (reinterpret_cast<uintptr_t>(mosaics) & 7) == 0;
  const bool store_fast =
      wide && x0 + 4 <= w &&
      (YCBCR ? ((reinterpret_cast<uintptr_t>(yplane) |
                 reinterpret_cast<uintptr_t>(cbcr)) & 3) == 0
             : (reinterpret_cast<uintptr_t>(rgba) & 15) == 0);
  for (int tile = 0; tile < kTileRows; ++tile) {
    const int y0 =
        ((blockIdx.y * kTileRows + tile) * kBlockY + threadIdx.y) * 2;
    if (y0 >= h) break;
    develop_pair<YCBCR, DEMOSAIC>(tail, m, img, h, w, y0, x0, py, px,
                                  load_fast, store_fast, rgba, yplane, cbcr);
  }
}

// Nearest-site: per channel one of the five taps by the cell's tap code.
__device__ __forceinline__ void nearest_site(const CfaTables& t, int cell,
                                             float c, float left, float right,
                                             float up, float down,
                                             float (&rgb)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int code = t.tap[k][cell];
    rgb[k] = code == 0 ? c
           : code == 1 ? left
           : code == 2 ? right
           : code == 3 ? up
                       : down;
  }
}

// The generic-CFA nearest-site stencil: the quad's window as above, each
// pixel's pattern cell from the tables.
template <bool YCBCR>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    develop_quads_cfa(const uint16_t* __restrict__ mosaics,
                      const float* __restrict__ scal,
                      const QuantTable* __restrict__ quant, int h, int w,
                      const __grid_constant__ CfaTables tables,
                      uint32_t* __restrict__ rgba,
                      uint8_t* __restrict__ yplane,
                      uint8_t* __restrict__ cbcr) {
  const size_t img = blockIdx.z;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  __shared__ CfaTables t;
  __shared__ Tail tail;
  copy_tables(tables, &t, tid, kBlockX * kBlockY);
  load_tail(&tail, quant, scal + img * kScalars, tid, kBlockX * kBlockY);
  __syncthreads();
  const int qx = blockIdx.x * kBlockX + threadIdx.x;
  const int qy = blockIdx.y * kBlockY + threadIdx.y;
  if (qx >= (w + 1) / 2 || qy >= (h + 1) / 2) return;
  const uint16_t* m = mosaics + img * static_cast<size_t>(h) * w;
  const int x0 = 2 * qx;
  const int y0 = 2 * qy;

  float v[4][4];
  load_window<1>(m, h, w, y0, x0, tail.sc[12], v);

  // The pattern row and column of the quad's pixels, by their unclamped
  // coordinates.
  const int side = t.side;
  int cy[2], cx[2];
  cy[0] = cell_mod(y0, side);
  cx[0] = cell_mod(x0, side);
  cy[1] = cy[0] + 1 == side ? 0 : cy[0] + 1;
  cx[1] = cx[0] + 1 == side ? 0 : cx[0] + 1;

  int q[2][2][3];
#pragma unroll
  for (int iy = 0; iy < 2; ++iy) {
#pragma unroll
    for (int ix = 0; ix < 2; ++ix) {
      const int wy = iy + 1;
      const int wx = ix + 1;
      float rgb[3];
      nearest_site(t, cy[iy] * side + cx[ix], v[wy][wx], v[wy][wx - 1],
                   v[wy][wx + 1], v[wy - 1][wx], v[wy + 1][wx], rgb);
      finish(tail, rgb[0], rgb[1], rgb[2], q[iy][ix]);
    }
  }
  store_quad<YCBCR>(q, img, h, w, y0, x0, rgba, yplane, cbcr);
}

// The generic-CFA smooth stencil as a warp march (band_march.cuh). The
// stencil is one deep, so one column of a strip's 64 is halo on each side and a
// band recomputes two rows; the mosaic is read at clamped coordinates, so
// no stage needs an edge rule.
constexpr int kCfaHalo = 1;
constexpr int kCfaStripW = kWarpCols - 2 * kCfaHalo;  // 62 output columns
constexpr int kCfaBandH = 24;                         // output rows per warp
constexpr int kCfaWarps = 4;                          // strips per block
constexpr int kCfaThreads = 32 * kCfaWarps;
constexpr int kCfaMinBlocks = 6;  // 24 warps per SM: caps at 80 registers

// Smooth on one pixel of channel ch: its own value, and for the two
// channels it lacks the 3x3 masked tent num[k] over the cell's
// denominator. Only those two are divided.
__device__ __forceinline__ void smooth_site(const CfaTables& t, int cell,
                                            int ch, float c,
                                            const float (&num)[3],
                                            float (&rgb)[3]) {
  const int k1 = ch == 0 ? 1 : 0;  // the lacking channels, in order
  const int k2 = ch == 2 ? 1 : 2;
  float q1, q2;
  divide2(ch == 0 ? num[1] : num[0], t.den2[k1][cell],
          ch == 2 ? num[1] : num[2], t.den2[k2][cell], q1, q2);
  rgb[0] = ch == 0 ? c : q1;
  rgb[1] = ch == 1 ? c : (ch == 0 ? q1 : q2);
  rgb[2] = ch == 2 ? c : q2;
}

// One warp per strip of kCfaStripW output columns and band of kCfaBandH
// output rows. A lane's first column x0 is ODD: the strip starts one
// halo column left of an even output column, so the lane holds the
// second column of one 2x2 quad and the first of the next. Each lane
// stores the quad of its column b and the right neighbour's column a,
// whose quantised pixel comes by one shuffle.
template <bool YCBCR>
__global__ void __launch_bounds__(kCfaThreads, kCfaMinBlocks)
    develop_bands_cfa(const uint16_t* __restrict__ mosaics,
                      const float* __restrict__ scal,
                      const QuantTable* __restrict__ quant, int h, int w,
                      const __grid_constant__ CfaTables tables,
                      uint32_t* __restrict__ rgba,
                      uint8_t* __restrict__ yplane,
                      uint8_t* __restrict__ cbcr) {
  const size_t img = blockIdx.z;
  __shared__ CfaTables t;
  __shared__ Tail tail;
  copy_tables(tables, &t, threadIdx.x, kCfaThreads);
  load_tail(&tail, quant, scal + img * kScalars, threadIdx.x, kCfaThreads);
  __syncthreads();  // the only one: from here on warps share nothing

  const int sx = (blockIdx.x * kCfaWarps + (threadIdx.x >> 5)) * kCfaStripW;
  if (sx >= w) return;  // the whole warp
  const int y0 = blockIdx.y * kCfaBandH;
  const uint16_t* m = mosaics + img * static_cast<size_t>(h) * w;
  const int lane = threadIdx.x & 31;
  const int x0 = lane_column(sx - kCfaHalo);
  // The value is read at clamped coordinates, the pattern cell at the
  // unclamped ones modulo the period.
  const int xa = min(max(x0, 0), w - 1);
  const int xb = min(max(x0 + 1, 0), w - 1);
  const int side = t.side;
  const int cell_a = cell_mod(x0, side);
  const int cell_b = cell_mod(x0 + 1, side);
  const unsigned own = pack_channels(t, cell_a, cell_b);
  const float s = tail.sc[12];
  const int rows = min(kCfaBandH, h - y0);
  const int y_end = y0 + rows + (rows & 1);  // whole quads
  const bool stores = lane < 31 && x0 + 1 < w;

  const Pair zero{0.0f, 0.0f};
  Win3 V{zero, zero, zero};  // raw * scale, rows t-2..t
  int cy = cell_mod(y0 - kCfaHalo - 2, side);  // cell row of row t-1
  int q[2][2][3];  // q[0]: the quad's first row, kept for its second

  auto load = [&](int row, uint32_t& a, uint32_t& b) {
    const uint16_t* p = m + static_cast<size_t>(min(max(row, 0), h - 1)) * w;
    a = __ldg(p + xa);
    b = __ldg(p + xb);
  };
  uint32_t next_a, next_b;
  load(y0 - kCfaHalo, next_a, next_b);
  for (int t_row = y0 - kCfaHalo; t_row < y_end + kCfaHalo; ++t_row) {
    const Pair v{static_cast<float>(next_a) * s,
                 static_cast<float>(next_b) * s};
    load(t_row + 1, next_a, next_b);
    V.template push<false>(v, t_row, h);
    cy = cy + 1 == side ? 0 : cy + 1;
    const int row = t_row - kCfaHalo;
    if (row < y0) continue;  // the whole warp

    // The masked tents: per channel the column sums (a + b*2) + d of the
    // lane's own two columns, once, the neighbours' by shuffle, then the
    // row sum in the same form.
    const int ru = cy == 0 ? side - 1 : cy - 1;
    const int rd = cy + 1 == side ? 0 : cy + 1;
    float num_a[3], num_b[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const Pair col{((channel_at(own, ru, 0) == k ? V.up.a : 0.0f) +
                      (channel_at(own, cy, 0) == k ? V.mid.a : 0.0f) * 2.0f) +
                         (channel_at(own, rd, 0) == k ? V.dn.a : 0.0f),
                     ((channel_at(own, ru, 1) == k ? V.up.b : 0.0f) +
                      (channel_at(own, cy, 1) == k ? V.mid.b : 0.0f) * 2.0f) +
                         (channel_at(own, rd, 1) == k ? V.dn.b : 0.0f)};
      const float l = left_of_a(col);
      const float r = right_of_b(col);
      num_a[k] = (l + col.a * 2.0f) + col.b;
      num_b[k] = (col.a + col.b * 2.0f) + r;
    }
    const int cell_row = cy * side;
    float rgb_a[3], rgb_b[3];
    smooth_site(t, cell_row + cell_a, channel_at(own, cy, 0), V.mid.a, num_a,
                rgb_a);
    smooth_site(t, cell_row + cell_b, channel_at(own, cy, 1), V.mid.b, num_b,
                rgb_b);
    int qa[3];
    finish(tail, rgb_a[0], rgb_a[1], rgb_a[2], qa);
    finish(tail, rgb_b[0], rgb_b[1], rgb_b[2], q[1][0]);
    // The quad's second column is the right neighbour's column a.
    const uint32_t word_a = static_cast<uint32_t>(qa[0]) |
                            (static_cast<uint32_t>(qa[1]) << 8) |
                            (static_cast<uint32_t>(qa[2]) << 16);
    const uint32_t right = __shfl_down_sync(kAllLanes, word_a, 1);
    q[1][1][0] = right & 0xffu;
    q[1][1][1] = (right >> 8) & 0xffu;
    q[1][1][2] = right >> 16;
    if (row & 1) {  // y0 is even: the quad's second row
      if (stores)
        store_quad<YCBCR>(q, img, h, w, row - 1, x0 + 1, rgba, yplane, cbcr);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q[0][0][c] = q[1][0][c];
        q[0][1][c] = q[1][1][c];
      }
    }
  }
}

// The generic-CFA quad kernel's grid: blocks of kBlockX x kBlockY quads,
// the batch as z.
inline bool quad_grid(int n, int h, int w, dim3* grid) {
  const int qh = (h + 1) / 2;
  const int qw = (w + 1) / 2;
  *grid = dim3((qw + kBlockX - 1) / kBlockX, (qh + kBlockY - 1) / kBlockY, n);
  return grid->y <= 65535;
}

// The Bayer kernel's grid: blocks of kTileRows tiles of kBayerTileW x
// kBayerTileH pixels.
inline bool bayer_grid(int n, int h, int w, dim3* grid) {
  *grid = dim3((w + kBayerTileW - 1) / kBayerTileW,
               (h + kBayerBlockH - 1) / kBayerBlockH, n);
  return grid->y <= 65535;
}

template <bool YCBCR>
bool launch_cfa(int demosaic, int n, cudaStream_t st, const uint16_t* mos,
                const float* sc, const QuantTable* qt, int h, int w,
                const CfaTables& tables, uint32_t* rgba, uint8_t* yplane,
                uint8_t* cbcr) {
  if (demosaic == kCfaSmooth) {
    const int strips = (w + kCfaStripW - 1) / kCfaStripW;
    const dim3 grid((strips + kCfaWarps - 1) / kCfaWarps,
                    (h + kCfaBandH - 1) / kCfaBandH, n);
    if (grid.y > 65535) return false;
    develop_bands_cfa<YCBCR><<<grid, kCfaThreads, 0, st>>>(
        mos, sc, qt, h, w, tables, rgba, yplane, cbcr);
    return true;
  }
  dim3 grid;
  if (!quad_grid(n, h, w, &grid)) return false;
  develop_quads_cfa<YCBCR><<<grid, dim3(kBlockX, kBlockY), 0, st>>>(
      mos, sc, qt, h, w, tables, rgba, yplane, cbcr);
  return true;
}

template <bool YCBCR>
bool launch_bayer(int demosaic, dim3 grid, cudaStream_t st,
                  const uint16_t* mos, const float* sc, const QuantTable* qt,
                  int h, int w, int py, int px, uint32_t* rgba,
                  uint8_t* yplane, uint8_t* cbcr) {
  const dim3 block(kBlockX, kBlockY);
  switch (demosaic) {
    case kNearest: develop_quads<YCBCR, kNearest><<<grid, block, 0, st>>>(mos, sc, qt, h, w, py, px, rgba, yplane, cbcr); return true;
    case kBilinear: develop_quads<YCBCR, kBilinear><<<grid, block, 0, st>>>(mos, sc, qt, h, w, py, px, rgba, yplane, cbcr); return true;
    case kMalvar: develop_quads<YCBCR, kMalvar><<<grid, block, 0, st>>>(mos, sc, qt, h, w, py, px, rgba, yplane, cbcr); return true;
    default: return false;
  }
}

}  // namespace

// mosaics (n, h, w) u16, scal (n, 24) f32, contiguous on the device.
// output 0: out0 = (n, h, w) u32 RGBA words. output 1: out0 = (n, h, w)
// u8 Y, out1 = (n, h/2, w) u8 interleaved CbCr; h and w must be even.
// demosaic: 0 nearest, 1 bilinear, 2 malvar. quant: the transfer's
// QuantTable on the device (develop_common.cuh). Launches on ``stream``,
// does not synchronise, and returns the cudaGetLastError() code.
extern "C" int rtt_develop_launch(const void* mosaics, const void* scal,
                                  void* out0, void* out1, int n, int h,
                                  int w, int py, int px, int output,
                                  int demosaic, const void* quant,
                                  void* stream) {
  if (const int bad = check_develop_args(n, h, w, py, px, output, quant))
    return bad;
  dim3 grid;
  if (!bayer_grid(n, h, w, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* mos = static_cast<const uint16_t*>(mosaics);
  const auto* sc = static_cast<const float*>(scal);
  const auto* qt = static_cast<const QuantTable*>(quant);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool ok =
      output == 1
          ? launch_bayer<true>(demosaic, grid, st, mos, sc, qt, h, w, py, px,
                               nullptr, static_cast<uint8_t*>(out0),
                               static_cast<uint8_t*>(out1))
          : launch_bayer<false>(demosaic, grid, st, mos, sc, qt, h, w, py, px,
                                static_cast<uint32_t*>(out0), nullptr,
                                nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// As rtt_develop_launch for a repeating-CFA mosaic: ``tables`` is the
// packed CfaTables bytes on the host (cfa_tables.cuh), and demosaic is
// 0 nearest-site or 1 smooth (radius-1 normalised convolution).
extern "C" int rtt_develop_cfa_launch(const void* mosaics, const void* scal,
                                      void* out0, void* out1, int n, int h,
                                      int w, int output, int demosaic,
                                      const void* tables, const void* quant,
                                      void* stream) {
  if (const int bad = check_develop_args(n, h, w, 0, 0, output, quant))
    return bad;
  CfaTables t;
  if (!unpack_tables(tables, &t) ||
      (demosaic != kCfaNearest && demosaic != kCfaSmooth))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* mos = static_cast<const uint16_t*>(mosaics);
  const auto* sc = static_cast<const float*>(scal);
  const auto* qt = static_cast<const QuantTable*>(quant);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool fits =
      output == 1
          ? launch_cfa<true>(demosaic, n, st, mos, sc, qt, h, w, t, nullptr,
                             static_cast<uint8_t*>(out0),
                             static_cast<uint8_t*>(out1))
          : launch_cfa<false>(demosaic, n, st, mos, sc, qt, h, w, t,
                              static_cast<uint32_t*>(out0), nullptr, nullptr);
  if (!fits) return static_cast<int>(cudaErrorInvalidConfiguration);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// The table quantiser over n values: the check that it equals the plain
// version (fused_develop.fused_quantize), not a kernel of the develop path.
constexpr int kSweepThreads = 256;

__global__ void __launch_bounds__(kSweepThreads)
    quant_sweep(const QuantTable* __restrict__ quant,
                const float* __restrict__ c, uint8_t* __restrict__ out,
                int n) {
  __shared__ QuantTable t;
  load_quant(&t, quant, threadIdx.x, kSweepThreads);
  __syncthreads();
  for (int i = blockIdx.x * kSweepThreads + threadIdx.x; i < n;
       i += gridDim.x * kSweepThreads)
    out[i] = static_cast<uint8_t>(quantize(t, __ldg(c + i)));
}

}  // namespace

// out[i] = the u8 code of c[i] (f32) under the QuantTable quant, for
// i < n, all on the device. Launches on ``stream``, does not synchronise,
// and returns the cudaGetLastError() code.
extern "C" int rtt_quant_sweep_launch(const void* quant, const void* c,
                                      void* out, int n, void* stream) {
  if (n < 0 || quant == nullptr ||
      (reinterpret_cast<uintptr_t>(quant) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int blocks = min((n + kSweepThreads - 1) / kSweepThreads, 132 * 16);
  quant_sweep<<<blocks, kSweepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QuantTable*>(quant), static_cast<const float*>(c),
      static_cast<uint8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
