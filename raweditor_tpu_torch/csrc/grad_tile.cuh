// The band machinery and the chroma-refinement tail shared by the two
// gradient-weighted develop kernels (develop_grad.cu on a Bayer phase,
// develop_grad_generic.cu on a repeating-CFA pattern).
//
// What bounds these kernels on an H100 is instruction throughput, not bytes
// (0.043 ms per 24 MP frame) and not the f32 rate (0.05 ms): -fmad=false
// arithmetic, IEEE divisions and the finish tail (develop_common.cuh).
// A design that stages every step of a 32x16 tile in shared memory
// behind block barriers spent another 0.45 ms (Bayer) to 0.7 ms
// (X-Trans) around the arithmetic: 80 to 120 shared
// accesses, a division and a modulo of index arithmetic and the
// recompute of a 4-pixel halo ring per output pixel; loading the tile
// and storing a trivial result already took 0.15 to 0.24 ms. So the
// design here keeps the stages in registers and marches down the image:
//
// - One WARP owns a strip of 64 columns (56 output columns plus the
//   4-column halo either side; a lane holds two adjacent columns, so it
//   owns the 2x2 quad and its 4:2:0 chroma sample) and walks a band of
//   kBandH output rows from top to bottom, one mosaic row per step.
// - Every stage keeps its last three rows in registers (Win3). A 3x3
//   stencil takes one new row per step; the vertical taps (the tents'
//   column pass, the u/d taps of G) touch no memory at all.
// - Horizontal neighbours come by __shfl_sync: 12 to 14 shuffles per
//   lane and row where the tile design made 170 to 230 shared accesses
//   for the same two pixels. A shuffle moves bits, so nothing rounds
//   differently. Warps share only the tail's tables, read after the one
//   block barrier at the start.
// - lane = column pair, loop = row: no division, no modulo per item.
// - Stage 2 and refinement 1 hand on the colour differences R-G and B-G
//   (the one subtraction the tents' column pass would do on each of its
//   three reads) instead of R and B.
// - Only the band's first 8 rows are recomputed (1.125x at 64 rows) and
//   the strip's halo (1.14x); the finish tail is skipped on them.
// - The next mosaic row is loaded (4 bytes per lane where the row is
//   aligned) before the current one is worked on.
// - Bands of 64 rows and 20 warps per SM (kMinBlocks) measured best: 32
//   rows recompute too much, 128 leave too few warps for one frame.
//
// The two kernels differ in stages 1 and 2 (G, then R/B by colour
// differences) and in how a position's channel is found: a Site type
// gives green(), red_blue() and chan(). The refinements and the finish
// tail are the same and live here (the TPU kernel's _chroma_refine,
// then _finish_block).
//
// Clamp-to-edge: every stage reads the stage below at coordinates
// clamped to the image; band_march.cuh, which holds the march's lanes,
// windows and shuffles, says how for rows and for columns. A site's
// channel is always that of the unclamped position, which is what the
// generic-CFA rule needs (value clamped, mask periodic).

#pragma once

#include "band_march.cuh"
#include "develop_common.cuh"

namespace {

constexpr int kHalo = 4;
constexpr int kStripW = kWarpCols - 2 * kHalo;    // 56 output columns
constexpr int kBandH = 64;                        // output rows per warp
constexpr int kWarps = 4;                         // strips per block
constexpr int kThreads = 32 * kWarps;
// Five blocks (20 warps) per SM: caps the kernels at 96 registers. The
// march is bound by instruction throughput and its chains are long, so warps
// in flight buy more than the few registers cost.
constexpr int kMinBlocks = 5;
constexpr float kEps = 1e-4f;

// One pixel of a chroma refinement: the channels rebuilt from the sensor
// value c of channel ch (0 R, 1 G, 2 B) and the smoothed differences.
__device__ __forceinline__ void rebuild(int ch, float c, float cb, float cr,
                                        float& r, float& g, float& b) {
  g = ch == 1 ? c : (ch == 0 ? c - cb : c - cr);
  r = ch == 0 ? c : g + cb;
  b = ch == 2 ? c : g + cr;
}

// Marches one warp down the band of output rows [y0, y0 + kBandH) of the
// strip whose first output column is sx (both even). At step t it loads
// mosaic row t and computes G at row t-1, R/B at t-2, refinement 1 at
// t-3 and refinement 2 with the finish tail at t-4.
//
// Site gives the pattern: step() once per row before the stages (the row
// t of that step is y0 - kHalo at the first call); green(u, c, d): G of
// row t-1 from raw*scale rows t-2, t-1, t; red_blue(c, g, diff, r, b):
// R and B of row t-2 from that row's raw*scale and G and the window of
// raw*scale - G; chan(lag, half): the channel of the lane's column at
// row t-lag.
template <bool YCBCR, bool EDGE, bool ROWS, typename Site>
__device__ __forceinline__ void march_band(
    Site site, const uint16_t* __restrict__ m, const Tail& tail, size_t img,
    int h, int w, int y0, int sx, uint32_t* __restrict__ rgba,
    uint8_t* __restrict__ yplane, uint8_t* __restrict__ cbcr) {
  const Lane<EDGE> ln = make_lane<EDGE>(sx - kHalo, w);
  const int lane = threadIdx.x & 31;
  const bool aligned =
      ((w & 1) == 0) && ((reinterpret_cast<uintptr_t>(m) & 3) == 0);
  const float s = tail.sc[12];
  const int rows = min(kBandH, h - y0);
  const int y_end = y0 + rows + (rows & 1);  // whole quads
  const bool stores = lane >= kHalo / 2 && lane < 32 - kHalo / 2 && ln.x0 < w;

  const Pair zero{0.0f, 0.0f};
  Pair v0 = zero, v1 = zero, v2 = zero, v3 = zero, v4 = zero;  // rows t-4..t
  Pair g1 = zero, g2 = zero;                                   // rows t-1, t-2
  Win3 diff{zero, zero, zero};   // raw*scale - G, rows t-3..t-1
  Win3 rg{zero, zero, zero}, bg{zero, zero, zero};      // R-G, B-G: t-4..t-2
  Win3 rg2{zero, zero, zero}, bg2{zero, zero, zero};    // refined: t-5..t-3
  int q[2][2][3];  // q[0]: the quad's first row, kept for its second

  uint32_t next = load_pair<EDGE>(m, ln, y0 - kHalo, h, w, aligned);
  for (int t = y0 - kHalo; t < y_end + kHalo; ++t) {
    const uint32_t raw = next;
    next = load_pair<EDGE>(m, ln, t + 1, h, w, aligned);
    site.step();

    // 0. raw * scale.
    v0 = v1;
    v1 = v2;
    v2 = v3;
    v3 = v4;
    v4 = {static_cast<float>(raw & 0xffffu) * s,
          static_cast<float>(raw >> 16) * s};

    // 1. G at row t-1, and raw*scale - G.
    {
      const int row = t - 1;
      Pair g = site.green(v2, v3, v4);
      clamp_columns(ln, g);
      g2 = g1;
      if constexpr (ROWS) {
        if (row >= h) g = g1;
        if (row <= 0) g2 = g;
      }
      g1 = g;
      diff.template push<ROWS>(v3 - g, row, h);
    }

    // 2. R and B at row t-2, kept as R-G and B-G.
    {
      Pair r, b;
      site.red_blue(v2, g2, diff, r, b);
      Pair dr = r - g2;
      Pair db = b - g2;
      clamp_columns(ln, dr);
      clamp_columns(ln, db);
      rg.template push<ROWS>(dr, t - 2, h);
      bg.template push<ROWS>(db, t - 2, h);
    }

    // 3a. Refinement 1 at row t-3.
    {
      const Pair cb = tent3(rg);
      const Pair cr = tent3(bg);
      float r, g, b;
      Pair dr, db;
      rebuild(site.chan(3, 0), v1.a, cb.a, cr.a, r, g, b);
      dr.a = r - g;
      db.a = b - g;
      rebuild(site.chan(3, 1), v1.b, cb.b, cr.b, r, g, b);
      dr.b = r - g;
      db.b = b - g;
      clamp_columns(ln, dr);
      clamp_columns(ln, db);
      rg2.template push<ROWS>(dr, t - 3, h);
      bg2.template push<ROWS>(db, t - 3, h);
    }

    // 3b. Refinement 2 and the finish tail at row t-4; the quad is
    //     stored with its second row. (tent3 shuffles, so every lane
    //     of the warp takes this branch together.)
    const int row = t - kHalo;
    if (row >= y0) {
      const Pair cb = tent3(rg2);
      const Pair cr = tent3(bg2);
      float r, g, b;
      rebuild(site.chan(4, 0), v0.a, cb.a, cr.a, r, g, b);
      finish(tail, r, g, b, q[1][0]);
      rebuild(site.chan(4, 1), v0.b, cb.b, cr.b, r, g, b);
      finish(tail, r, g, b, q[1][1]);
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

// Picks the march for a warp's strip and band: EDGE when the strip reads
// a column outside the (h, w) image, ROWS when the band's stages reach
// row 0 or row h-1 (both warp-uniform; most of a large frame is neither).
template <bool YCBCR, typename Site>
__device__ __forceinline__ void march(
    const Site& site, const uint16_t* __restrict__ m, const Tail& tail,
    size_t img, int h, int w, int y0, int sx,
    uint32_t* __restrict__ rgba, uint8_t* __restrict__ yplane,
    uint8_t* __restrict__ cbcr) {
  const bool edge = sx - kHalo < 0 || sx + kStripW + kHalo > w;
  const bool ends = y0 == 0 || y0 + kBandH + kHalo >= h;
  if (edge || ends) {
    // One checked form for both kinds of border: they are few.
    if (edge)
      march_band<YCBCR, true, true>(site, m, tail, img, h, w, y0, sx, rgba,
                                    yplane, cbcr);
    else
      march_band<YCBCR, false, true>(site, m, tail, img, h, w, y0, sx, rgba,
                                     yplane, cbcr);
  } else {
    march_band<YCBCR, false, false>(site, m, tail, img, h, w, y0, sx, rgba,
                                    yplane, cbcr);
  }
}

// The launch grid of the band kernels for n images of (h, w).
inline dim3 band_grid(int n, int h, int w) {
  const int strips = (w + kStripW - 1) / kStripW;
  return dim3((strips + kWarps - 1) / kWarps, (h + kBandH - 1) / kBandH, n);
}

}  // namespace
