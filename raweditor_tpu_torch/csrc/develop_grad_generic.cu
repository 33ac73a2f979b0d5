// Fused gradient-weighted develop of a repeating-CFA mosaic (the 6x6
// X-Trans grid) for Hopper (sm_90a): u16 mosaic in, packed RGBA u32
// words or JPEG YCbCr 4:2:0 planes out, in one pass.
//
// Replaces the TPU kernel raweditor_tpu/ops/pallas_develop.py
// (_kernel_flat -> _develop_block -> _demosaic_grad_generic_window with
// _parity_indicators, _site_mask_fn, _tile_consts_fn, _clamp_shift_fns
// and _chroma_refine; then _finish_block, and _emit_ycbcr420 for
// output="ycbcr420"), reached from pallas_develop_rgba and
// pallas_batch_develop_rgba with pattern= and demosaic="grad". Its TPU
// tiling mechanics (_band_realign, _clampw_fn, the roll-mask fast path,
// the lcm(128, side) width pad, the height-pad rescue, the block-height
// cap) have no counterpart here: a warp clamps at the true image edge
// itself and takes any (H, W).
//
// The stages (the plain lane is ops/cfa_generic.demosaic_grad_generic):
//   1. G at R/B sites: the 1-D normalised tents (1 2 1) over the G sites
//      of the row and of the column, num / den with den from the
//      pattern's tables, blended by inverse raw gradients
//      1/(|r-l| + 1e-4) and 1/(|d-u| + 1e-4);
//   2. R and B: the masked 3x3 tent of the colour differences (value - G)
//      over the pattern's 2-D denominators, with G added back;
//   3. two chroma refinements (grad_tile.cuh).
// Each stage is a +-1 stencil over the one before, so an output pixel
// sees 4 pixels around it.
//
// The one rule that differs from the Bayer kernel: a tap's VALUE is read
// at coordinates clamped to the image, its site MASK at the unclamped
// coordinates modulo the period, so the mask continues periodically past
// the edge while the value repeats the edge pixel (the plain lane's
// edge-padded values times a periodic mask). The march of grad_tile.cuh
// gives exactly that: a lane outside the image carries the clamped
// column's value at every stage and its own, unclamped, channel.
//
// What bounds it: instruction throughput (develop_grad.cu says why the f32
// operation bound, about 140 per pixel here, 50 of them in the demosaic
// stages counting only the taps the pattern fills, is out of reach of
// any -fmad=false kernel). The design is the Bayer grad kernel's march in
// registers (grad_tile.cuh), and for the pattern:
// - the masked 3x3 tent of stage 2 is separable as the plain version
//   writes it: each lane sums its own two columns over the three rows in
//   registers, per channel, and the row pass takes the neighbours' column
//   sums by shuffle, so a column sum is computed once and not three
//   times. Every masked tap is still a select that adds an exact zero;
// - stage 1 interpolates G once per lane and row, at whichever of the
//   lane's two columns is the R/B site, and a second time only in rows
//   where some column pair holds two (two of the X-Trans grid's six);
// - a lane's two columns fix its cell columns for the whole band, and
//   the cell row of each stage advances by one per step: no modulo per
//   pixel.
//
// Two sites give the pattern to the march. The generic one (CfaSite,
// any period from 1 to 6) derives it per lane and row: the channels of
// the four columns a lane looks at, packed two bits each over the
// period's rows once per band, read with shifts by the row (about 26 a
// lane and row), the denominators looked up per cell in the tables in
// shared memory, a warp vote per division for the power-of-two fast
// path, and IEEE divisions in stage 2 where the X-Trans grid has a
// denominator of 3. On an NVIDIA H100 (700 W) that made B7 0.464 ms a
// 24 MP frame to planes against the Bayer grad kernel's 0.313 on the same
// march: of the 0.151 ms, stage 2's divisions and votes took 0.055,
// stage 1's votes and power-of-two tests 0.029, the second G
// interpolation 0.023 and the per-lane derivations most of the rest.
//
// Everything that site derives depends only on the lane's cell column
// pair and the row's place in the period, both fixed or cycling for a
// whole band. So a 6x6 pattern whose denominators allow it (the X-Trans
// grid does; build_period6) takes the period-6 site (CfaSite6): the host
// tabulates, for each of the 6 cell rows and 3 column pairs (a lane's
// first column is even), the site masks and channels every stage reads
// as one word of bits, the reciprocals of stage 1's power-of-two
// denominators and stage 2's denominators; each block adds their
// correctly rounded reciprocals (__frcp_rn) and keeps the 1440 bytes in
// shared memory, where the warp's three entries a row lie in different
// banks. A lane reads one entry a step, rotated with the rows: a bit test
// with an immediate mask where the generic site shifted by the row, no
// vote (the row's second interpolation is a bit that is the same in every
// lane), and stage 2 divides by an exact reciprocal and one correction
// (exact_quotient), bit for bit the IEEE quotient for each denominator it
// takes, proved over every f32 numerator. The march still takes one
// mosaic row per step, so the band, its edges and its registers are the
// Bayer kernel's. Periods 1 to 5 keep the generic site: their rows and
// column pairs cycle differently (a period-3 lane's first column takes
// every cell column), and no camera the port reads has one (a Bayer
// frame takes the Bayer kernel).
//
// Numerics: _demosaic_grad_generic_window's operation order on
// raw * scale (tents as (a + b*2) + c, the R/B numerator as column sums
// added left to right), IEEE division, -fmad=false, as the plain PyTorch
// version rounds. The finish tail is develop_common.cuh.

#include <cmath>
#include <cstddef>

#include "develop_common.cuh"
#include "cfa_tables.cuh"
#include "exact_quotient.cuh"
#include "grad_tile.cuh"

namespace {

// The pattern seen from a lane. Channels are packed two bits each at
// bit 4 * (cell row) + 2 * half: `own` for the lane's columns a and b,
// `out` for the column left of a and the column right of b.
struct CfaSite {
  const CfaTables* t;  // in shared memory
  int side;
  int cy0, cy1, cy2, cy3, cy4;  // cell rows of rows t (this step's
                                // mosaic row), t-1, ..., t-4
  int cell_a, cell_b;  // cell columns of a and b
  unsigned own, out;

  __device__ __forceinline__ CfaSite(const CfaTables* tables, int x0,
                                     int t_first)
      : t(tables), side(tables->side) {
    cy0 = cell_mod(t_first - 1, side);
    cy1 = cell_mod(t_first - 2, side);
    cy2 = cell_mod(t_first - 3, side);
    cy3 = cell_mod(t_first - 4, side);
    cy4 = cell_mod(t_first - 5, side);
    cell_a = cell_mod(x0, side);
    cell_b = cell_mod(x0 + 1, side);
    const int cell_l = cell_mod(x0 - 1, side);
    const int cell_r = cell_mod(x0 + 2, side);
    own = pack_channels(*t, cell_a, cell_b);
    out = pack_channels(*t, cell_l, cell_r);
  }
  __device__ __forceinline__ void step() {
    cy4 = cy3;
    cy3 = cy2;
    cy2 = cy1;
    cy1 = cy0;
    cy0 = next_row(cy0);
  }
  // Cell row of row t - lag, lag in 1..4.
  __device__ __forceinline__ int row_of(int lag) const {
    return lag == 1 ? cy1 : lag == 2 ? cy2 : lag == 3 ? cy3 : cy4;
  }
  __device__ __forceinline__ int next_row(int r) const {
    return r + 1 == side ? 0 : r + 1;
  }
  __device__ __forceinline__ int prev_row(int r) const {
    return r == 0 ? side - 1 : r - 1;
  }
  static __device__ __forceinline__ int at(unsigned bits, int r, int half) {
    return channel_at(bits, r, half);
  }
  __device__ __forceinline__ int chan(int lag, int half) const {
    return at(own, row_of(lag), half);
  }

  // G of one R/B site: the 1-D normalised tents over the G sites of the
  // row and of the column (the centre, masked, adds nothing), blended by
  // inverse gradients. `live` is false in a lane that has no such site
  // (its result is dropped; it must not hold the others' vote back).
  __device__ __forceinline__ float green_at(float l, float r, float u,
                                            float d, bool ml, bool mr,
                                            bool mu, bool md, int cell,
                                            bool live) const {
    const float vg2 = 0.0f;  // (the centre, masked) * 2
    const float gh_num = ((ml ? l : 0.0f) + vg2) + (mr ? r : 0.0f);
    const float gv_num = ((mu ? u : 0.0f) + vg2) + (md ? d : 0.0f);
    float gh, gv;
    divide2(gh_num, live ? t->den_h[cell] : 1.0f, gv_num,
            live ? t->den_v[cell] : 1.0f, gh, gv);
    const float wh = 1.0f / (fabsf(r - l) + kEps);
    const float wv = 1.0f / (fabsf(d - u) + kEps);
    return (wh * gh + wv * gv) / (wh + wv);
  }

  // 1. G at row t-1. In most rows of most patterns (four of the X-Trans
  //    grid's six, every row of a 2x2 one) no column pair holds two R/B
  //    sites, so one interpolation per lane serves the row: at column a
  //    where that is the R/B site, else at b. A second one, for b, runs
  //    only in rows where some lane has both (a vote).
  __device__ __forceinline__ Pair green(const Pair& u, const Pair& c,
                                        const Pair& d) const {
    const int r = row_of(1);
    const int ru = prev_row(r);
    const int rd = next_row(r);
    const bool site_a = at(own, r, 0) != 1;
    const bool site_b = at(own, r, 1) != 1;
    const float l = left_of_a(c);
    const float rt = right_of_b(c);
    const int half = site_a ? 0 : 1;
    const float g1 = green_at(
        site_a ? l : c.a, site_a ? c.b : rt, site_a ? u.a : u.b,
        site_a ? d.a : d.b, site_a ? at(out, r, 0) == 1 : true,
        site_a ? !site_b : at(out, r, 1) == 1, at(own, ru, half) == 1,
        at(own, rd, half) == 1, r * side + (site_a ? cell_a : cell_b),
        site_a || site_b);
    Pair g{site_a ? g1 : c.a, site_a || !site_b ? c.b : g1};
    const bool both = site_a && site_b;
    if (__any_sync(kAllLanes, both)) {
      const float g2 =
          green_at(c.a, rt, u.b, d.b, false, at(out, r, 1) == 1,
                   at(own, ru, 1) == 1, at(own, rd, 1) == 1,
                   r * side + cell_b, both);
      if (both) g.b = g2;
    }
    return g;
  }

  // 2. R and B at row t-2: the masked 3x3 tent of value - G, column sums
  //    left to right, over the pattern's 2-D denominators, G added back.
  __device__ __forceinline__ void red_blue(const Pair& c, const Pair& g,
                                           const Win3& diff, Pair& r,
                                           Pair& b) const {
    const int rc = row_of(2);
    const int ru = prev_row(rc);
    const int rd = next_row(rc);
    auto col = [&](int chan, int half, float du, float dc, float dd) {
      return ((at(own, ru, half) == chan ? du : 0.0f) +
              (at(own, rc, half) == chan ? dc : 0.0f) * 2.0f) +
             (at(own, rd, half) == chan ? dd : 0.0f);
    };
    const Pair col_r{col(0, 0, diff.up.a, diff.mid.a, diff.dn.a),
                     col(0, 1, diff.up.b, diff.mid.b, diff.dn.b)};
    const Pair col_b{col(2, 0, diff.up.a, diff.mid.a, diff.dn.a),
                     col(2, 1, diff.up.b, diff.mid.b, diff.dn.b)};
    const float rl = left_of_a(col_r);
    const float rr = right_of_b(col_r);
    const float bl = left_of_a(col_b);
    const float br = right_of_b(col_b);
    const int ia = rc * side + cell_a;
    const int ib = rc * side + cell_b;
    const int ch_a = at(own, rc, 0);
    const int ch_b = at(own, rc, 1);
    const float nra = (rl + col_r.a * 2.0f) + col_r.b;
    const float nrb = (col_r.a + col_r.b * 2.0f) + rr;
    const float nba = (bl + col_b.a * 2.0f) + col_b.b;
    const float nbb = (col_b.a + col_b.b * 2.0f) + br;
    float qra, qrb, qba, qbb;
    divide2(nra, t->den2[0][ia], nrb, t->den2[0][ib], qra, qrb);
    divide2(nba, t->den2[2][ia], nbb, t->den2[2][ib], qba, qbb);
    r = {ch_a == 0 ? c.a : g.a + qra, ch_b == 0 ? c.b : g.b + qrb};
    b = {ch_a == 2 ? c.a : g.a + qba, ch_b == 2 ? c.b : g.b + qbb};
  }
};

// ---- The period-6 site ------------------------------------------------------

constexpr int kSide6 = 6;
constexpr int kChanR = 0, kChanG = 1, kChanB = 2;  // CfaTables::chan codes
// What the period-6 march needs of one cell row p and one column pair of
// the pattern (a at cell column 2k, b at 2k + 1: a lane's first column is
// even), at the step whose mosaic row t lies in cell row p: stage 1 works
// on row t-1, stage 2 on t-2, the refinements on t-3 and t-4.
struct alignas(16) Cfa6Entry {
  unsigned bits;        // site masks and channels (kSiteA ... below)
  float yh1, yv1, yh2;  // stage 1: 1/den_h, 1/den_v of the first
  float yv2;            //   interpolation's cell, then of the second's
  float pad0[3];
  float den[4];         // stage 2: den2 of R at a, R at b, B at a, B at b
  float rcp[4];         // RN(1/den), computed by each block (__frcp_rn)
  float pad1[4];        // 80 bytes: a row's three entries, read by one
                        // warp, lie in different shared-memory banks
};
static_assert(sizeof(Cfa6Entry) == 80, "Cfa6Entry layout");

// Entry [p][k]: cell row p of row t, cell columns 2k and 2k + 1.
struct Cfa6Table {
  Cfa6Entry e[kSide6][kSide6 / 2];
};

// Cfa6Entry::bits. Stage 1, row t-1: which of a and b is an R/B site;
// the G masks of the first interpolation's taps (left, right, up, down,
// resolved for whichever column it runs at) and of the second's (at b,
// where a and b both are R/B sites; its left tap, a, never is G); and
// whether any column pair of the row holds two R/B sites (the same bit in
// every lane of the row, so warp-uniform).
constexpr unsigned kSiteA = 1u << 0, kSiteB = 1u << 1;
constexpr unsigned kMaskL1 = 1u << 2, kMaskR1 = 1u << 3, kMaskU1 = 1u << 4,
                   kMaskD1 = 1u << 5;
constexpr unsigned kMaskR2 = 1u << 6, kMaskU2 = 1u << 7, kMaskD2 = 1u << 8;
constexpr unsigned kTwo = 1u << 9;
// Stage 2, row t-2: bit kTaps2 + 6 * c + 3 * half + dy (c 0 for R, 1 for
// B; dy 0, 1, 2 for rows t-3, t-2, t-1): that tap's site is of channel c.
constexpr int kTaps2 = 10;
// The refinements: the channel of column `half` at row t-3 in the two
// bits at kChan3 + 2 * half, at row t-4 at kChan4 + 2 * half.
constexpr int kChan3 = 22, kChan4 = 26;

// The pattern seen from a lane on a 6x6 period: everything the generic
// site derives per lane and row from the channel bits and the tables is a
// function of the lane's cell column pair and of the row's place in the
// period, so it is read from the block's Cfa6Table (built on the host,
// rcp filled by the block): one entry a step, rotated with the rows.
struct CfaSite6 {
  const Cfa6Entry* col;  // in shared memory: entry [0][k] of the lane's k
  int row;               // offset of entry [p][k] from col (3 * p)
  const Cfa6Entry* e;    // this step's entry
  unsigned bits;
  float yh1, yv1, yh2;

  __device__ __forceinline__ CfaSite6(const Cfa6Table& table, int x0,
                                      int t_first)
      : col(&table.e[0][cell_mod(x0, kSide6) >> 1]),
        row(cell_mod(t_first - 1, kSide6) * (kSide6 / 2)),
        e(nullptr), bits(0), yh1(0.0f), yv1(0.0f), yh2(0.0f) {}
  __device__ __forceinline__ void step() {
    row = row == (kSide6 - 1) * (kSide6 / 2) ? 0 : row + kSide6 / 2;
    e = col + row;
    const uint4 head = *reinterpret_cast<const uint4*>(e);
    bits = head.x;
    yh1 = __uint_as_float(head.y);
    yv1 = __uint_as_float(head.z);
    yh2 = __uint_as_float(head.w);
  }
  __device__ __forceinline__ bool has(unsigned m) const {
    return (bits & m) != 0;
  }
  __device__ __forceinline__ int chan(int lag, int half) const {
    return (bits >> ((lag == 3 ? kChan3 : kChan4) + 2 * half)) & 3u;
  }

  // G of one R/B site, as CfaSite::green_at; the denominators are powers
  // of two (the host checks), so a multiply by the exact reciprocal gives
  // the IEEE quotient.
  static __device__ __forceinline__ float green_at(float l, float r, float u,
                                                   float d, bool ml, bool mr,
                                                   bool mu, bool md, float yh,
                                                   float yv) {
    const float vg2 = 0.0f;  // (the centre, masked) * 2
    const float gh_num = ((ml ? l : 0.0f) + vg2) + (mr ? r : 0.0f);
    const float gv_num = ((mu ? u : 0.0f) + vg2) + (md ? d : 0.0f);
    const float gh = gh_num * yh;
    const float gv = gv_num * yv;
    const float wh = 1.0f / (fabsf(r - l) + kEps);
    const float wv = 1.0f / (fabsf(d - u) + kEps);
    return (wh * gh + wv * gv) / (wh + wv);
  }

  // 1. G at row t-1, as CfaSite::green.
  __device__ __forceinline__ Pair green(const Pair& u, const Pair& c,
                                        const Pair& d) const {
    const bool site_a = has(kSiteA);
    const bool site_b = has(kSiteB);
    const float l = left_of_a(c);
    const float rt = right_of_b(c);
    const float g1 = green_at(site_a ? l : c.a, site_a ? c.b : rt,
                              site_a ? u.a : u.b, site_a ? d.a : d.b,
                              has(kMaskL1), has(kMaskR1), has(kMaskU1),
                              has(kMaskD1), yh1, yv1);
    Pair g{site_a ? g1 : c.a, site_a || !site_b ? c.b : g1};
    if (has(kTwo)) {
      const float g2 = green_at(c.a, rt, u.b, d.b, false, has(kMaskR2),
                                has(kMaskU2), has(kMaskD2), yh2, e->yv2);
      if (site_a && site_b) g.b = g2;
    }
    return g;
  }

  // 2. R and B at row t-2, as CfaSite::red_blue.
  __device__ __forceinline__ void red_blue(const Pair& c, const Pair& g,
                                           const Win3& diff, Pair& r,
                                           Pair& b) const {
    auto tap = [&](int ch, int half, int dy) {
      return has(1u << (kTaps2 + 6 * ch + 3 * half + dy));
    };
    auto col = [&](int ch, int half, float du, float dc, float dd) {
      return ((tap(ch, half, 0) ? du : 0.0f) +
              (tap(ch, half, 1) ? dc : 0.0f) * 2.0f) +
             (tap(ch, half, 2) ? dd : 0.0f);
    };
    const Pair col_r{col(0, 0, diff.up.a, diff.mid.a, diff.dn.a),
                     col(0, 1, diff.up.b, diff.mid.b, diff.dn.b)};
    const Pair col_b{col(1, 0, diff.up.a, diff.mid.a, diff.dn.a),
                     col(1, 1, diff.up.b, diff.mid.b, diff.dn.b)};
    const float rl = left_of_a(col_r);
    const float rr = right_of_b(col_r);
    const float bl = left_of_a(col_b);
    const float br = right_of_b(col_b);
    const float nra = (rl + col_r.a * 2.0f) + col_r.b;
    const float nrb = (col_r.a + col_r.b * 2.0f) + rr;
    const float nba = (bl + col_b.a * 2.0f) + col_b.b;
    const float nbb = (col_b.a + col_b.b * 2.0f) + br;
    const float4 den = *reinterpret_cast<const float4*>(e->den);
    const float4 rcp = *reinterpret_cast<const float4*>(e->rcp);
    r = {tap(0, 0, 1) ? c.a : g.a + exact_quotient(nra, den.x, rcp.x),
         tap(0, 1, 1) ? c.b : g.b + exact_quotient(nrb, den.y, rcp.y)};
    b = {tap(1, 0, 1) ? c.a : g.a + exact_quotient(nba, den.z, rcp.z),
         tap(1, 1, 1) ? c.b : g.b + exact_quotient(nbb, den.w, rcp.w)};
  }
};

// Block-cooperative copy of the period-6 table into shared memory, each
// entry's rcp computed from its den; the caller synchronises.
__device__ __forceinline__ void copy_tables(const Cfa6Table& from,
                                            Cfa6Table* to, int tid,
                                            int threads) {
  constexpr int kWords = sizeof(Cfa6Entry) / 4;
  constexpr int kDen = offsetof(Cfa6Entry, den) / 4;
  constexpr int kRcp = offsetof(Cfa6Entry, rcp) / 4;
  const unsigned* src = reinterpret_cast<const unsigned*>(&from);
  unsigned* dst = reinterpret_cast<unsigned*>(to);
  for (int i = tid; i < static_cast<int>(sizeof(Cfa6Table) / 4);
       i += threads) {
    const int j = i % kWords;
    dst[i] = j >= kRcp && j < kRcp + 4
                 ? __float_as_uint(
                       __frcp_rn(__uint_as_float(src[i - kRcp + kDen])))
                 : src[i];
  }
}

__device__ __forceinline__ CfaSite site_for(const CfaTables& t, int x0,
                                            int t_first) {
  return CfaSite(&t, x0, t_first);
}
__device__ __forceinline__ CfaSite6 site_for(const Cfa6Table& t, int x0,
                                             int t_first) {
  return CfaSite6(t, x0, t_first);
}

// Tables: CfaTables (the generic site) or Cfa6Table (the period-6 site).
template <bool YCBCR, typename Tables>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    develop_grad_cfa_bands(const uint16_t* __restrict__ mosaics,
                           const float* __restrict__ scal,
                           const QuantTable* __restrict__ quant, int h, int w,
                           const __grid_constant__ Tables tables,
                           uint32_t* __restrict__ rgba,
                           uint8_t* __restrict__ yplane,
                           uint8_t* __restrict__ cbcr) {
  const size_t img = blockIdx.z;
  __shared__ Tables t;
  __shared__ Tail tail;
  copy_tables(tables, &t, threadIdx.x, kThreads);
  load_tail(&tail, quant, scal + img * kScalars, threadIdx.x, kThreads);
  __syncthreads();  // the only one: from here on warps share nothing

  const int sx = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kStripW;
  if (sx >= w) return;  // the whole warp
  const int y0 = blockIdx.y * kBandH;
  const uint16_t* m = mosaics + img * static_cast<size_t>(h) * w;
  const auto site = site_for(t, lane_column(sx - kHalo), y0 - kHalo);
  march<YCBCR>(site, m, tail, img, h, w, y0, sx, rgba, yplane, cbcr);
}

// A lane's first column must be even for the period-6 site's column pairs.
static_assert(kStripW % 2 == 0 && kHalo % 2 == 0, "even lane columns");

inline bool is_pow2(float d) {
  int e;
  return d > 0.0f && std::frexp(d, &e) == 0.5f && d >= 0x1p-126f &&
         d <= 0x1p126f;
}
inline bool exact_den(float d) {
  if (is_pow2(d)) return true;
  for (const float x : kExactQuotientDens)
    if (d == x) return true;
  return false;
}

// The period-6 site's table of a pattern, from its CfaTables; false (the
// generic site then runs) unless the period is 6, the G denominators of
// every R/B site are powers of two (as on any pattern the grad tier
// takes: one or two G neighbours on each axis) and every R and B den2 is
// a power of two or in kExactQuotientDens.
inline bool build_period6(const CfaTables& t, Cfa6Table* out) {
  if (t.side != kSide6) return false;
  auto cell = [](int y, int x) {
    return ((y + kSide6) % kSide6) * kSide6 + (x + kSide6) % kSide6;
  };
  auto ch = [&](int y, int x) { return static_cast<int>(t.chan[cell(y, x)]); };
  bool two[kSide6];
  for (int y = 0; y < kSide6; ++y) {
    two[y] = false;
    for (int a = 0; a < kSide6; a += 2)
      two[y] = two[y] || (ch(y, a) != kChanG && ch(y, a + 1) != kChanG);
  }
  *out = Cfa6Table{};
  for (int p = 0; p < kSide6; ++p) {
    for (int k = 0; k < kSide6 / 2; ++k) {
      Cfa6Entry& e = out->e[p][k];
      const int a = 2 * k, b = a + 1;
      // Stage 1 at cell row r = p - 1.
      const int r = p - 1;
      const bool site_a = ch(r, a) != kChanG, site_b = ch(r, b) != kChanG;
      const int half = site_a ? a : b;
      unsigned bits = (site_a ? kSiteA : 0u) | (site_b ? kSiteB : 0u);
      if (!site_a || ch(r, a - 1) == kChanG) bits |= kMaskL1;
      if (site_a ? !site_b : ch(r, b + 1) == kChanG) bits |= kMaskR1;
      if (ch(r - 1, half) == kChanG) bits |= kMaskU1;
      if (ch(r + 1, half) == kChanG) bits |= kMaskD1;
      if (ch(r, b + 1) == kChanG) bits |= kMaskR2;
      if (ch(r - 1, b) == kChanG) bits |= kMaskU2;
      if (ch(r + 1, b) == kChanG) bits |= kMaskD2;
      if (two[(r + kSide6) % kSide6]) bits |= kTwo;
      const bool live = site_a || site_b, both = site_a && site_b;
      const float dens1[4] = {live ? t.den_h[cell(r, half)] : 1.0f,
                              live ? t.den_v[cell(r, half)] : 1.0f,
                              both ? t.den_h[cell(r, b)] : 1.0f,
                              both ? t.den_v[cell(r, b)] : 1.0f};
      for (const float d : dens1)
        if (!is_pow2(d)) return false;
      e.yh1 = 1.0f / dens1[0];
      e.yv1 = 1.0f / dens1[1];
      e.yh2 = 1.0f / dens1[2];
      e.yv2 = 1.0f / dens1[3];
      // Stage 2 at cell row rc = p - 2.
      const int rc = p - 2;
      for (int c = 0; c < 2; ++c)
        for (int hf = 0; hf < 2; ++hf)
          for (int dy = 0; dy < 3; ++dy)
            if (ch(rc - 1 + dy, a + hf) == (c ? kChanB : kChanR))
              bits |= 1u << (kTaps2 + 6 * c + 3 * hf + dy);
      const float dens2[4] = {t.den2[kChanR][cell(rc, a)],
                              t.den2[kChanR][cell(rc, b)],
                              t.den2[kChanB][cell(rc, a)],
                              t.den2[kChanB][cell(rc, b)]};
      for (int i = 0; i < 4; ++i) {
        if (!exact_den(dens2[i])) return false;
        e.den[i] = dens2[i];
      }
      // The refinements at cell rows p - 3 and p - 4.
      bits |= static_cast<unsigned>(ch(p - 3, a)) << kChan3 |
              static_cast<unsigned>(ch(p - 3, b)) << (kChan3 + 2) |
              static_cast<unsigned>(ch(p - 4, a)) << kChan4 |
              static_cast<unsigned>(ch(p - 4, b)) << (kChan4 + 2);
      e.bits = bits;
    }
  }
  return true;
}

}  // namespace

// mosaics (n, h, w) u16, scal (n, 24) f32, contiguous on the device;
// tables: the packed CfaTables bytes on the host. output 0: out0 =
// (n, h, w) u32 RGBA words. output 1: out0 = (n, h, w) u8 Y, out1 =
// (n, h/2, w) u8 interleaved CbCr; h and w must be even. quant: the
// transfer's QuantTable on the device (develop_common.cuh). A pattern for
// which rtt_develop_grad_cfa_period6 says 1 takes the period-6 march, any
// other the generic one. Launches on ``stream``, does not synchronise, and
// returns the cudaGetLastError() code.
extern "C" int rtt_develop_grad_cfa_launch(const void* mosaics,
                                           const void* scal, void* out0,
                                           void* out1, int n, int h, int w,
                                           int output, const void* tables,
                                           const void* quant, void* stream) {
  if (const int bad = check_develop_args(n, h, w, 0, 0, output, quant))
    return bad;
  CfaTables t;
  if (!unpack_tables(tables, &t)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = band_grid(n, h, w);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* mos = static_cast<const uint16_t*>(mosaics);
  const auto* sc = static_cast<const float*>(scal);
  const auto* qt = static_cast<const QuantTable*>(quant);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* words = output == 1 ? nullptr : static_cast<uint32_t*>(out0);
  auto* y = output == 1 ? static_cast<uint8_t*>(out0) : nullptr;
  auto* cbcr = output == 1 ? static_cast<uint8_t*>(out1) : nullptr;
  Cfa6Table six;
  if (build_period6(t, &six)) {
    if (output == 1)
      develop_grad_cfa_bands<true, Cfa6Table><<<grid, kThreads, 0, st>>>(
          mos, sc, qt, h, w, six, words, y, cbcr);
    else
      develop_grad_cfa_bands<false, Cfa6Table><<<grid, kThreads, 0, st>>>(
          mos, sc, qt, h, w, six, words, y, cbcr);
  } else if (output == 1) {
    develop_grad_cfa_bands<true, CfaTables><<<grid, kThreads, 0, st>>>(
        mos, sc, qt, h, w, t, words, y, cbcr);
  } else {
    develop_grad_cfa_bands<false, CfaTables><<<grid, kThreads, 0, st>>>(
        mos, sc, qt, h, w, t, words, y, cbcr);
  }
  return static_cast<int>(cudaGetLastError());
}

// 1 if rtt_develop_grad_cfa_launch takes the period-6 march for the packed
// CfaTables bytes ``tables``, else 0.
extern "C" int rtt_develop_grad_cfa_period6(const void* tables) {
  CfaTables t;
  Cfa6Table six;
  return unpack_tables(tables, &t) && build_period6(t, &six) ? 1 : 0;
}
