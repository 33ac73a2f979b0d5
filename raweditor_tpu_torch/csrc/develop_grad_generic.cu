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
// any -fmad=false kernel). Stage 1 has five IEEE divisions per R/B site
// and stage 2 two per pixel; these, not the masked taps, are what the
// stages cost (dropping eight of stage 2's nine taps from the earlier
// tile design did not change its time). The design is the Bayer grad
// kernel's march in registers, and for the pattern:
// - a lane's two columns fix its cell columns for the whole band, and
//   the cell row of each stage advances by one per step (no modulo per
//   pixel). The channels of the four columns a lane looks at (its own
//   two and the one on either side) over the period's rows are packed
//   into two registers, two bits each, once per band; the tile design
//   kept two byte maps in shared memory and built them with a division
//   and two modulos per position (0.09 ms per frame);
// - the masked 3x3 tent of stage 2 is separable as the plain version
//   writes it: each lane sums its own two columns over the three rows in
//   registers, per channel, and the row pass takes the neighbours' column
//   sums by shuffle, so a column sum is computed once and not three
//   times. Every masked tap is still a select that adds an exact zero;
// - stage 1 interpolates G once per lane and row, at whichever of the
//   lane's two columns is the R/B site, and a second time only in rows
//   where some column pair holds two (a warp vote: two of the X-Trans
//   grid's six rows);
// - a division by a tent's denominator becomes a multiply by its exact
//   reciprocal where every lane's denominator is a power of two (a warp
//   vote again: all of stage 1 on any radius-1 pattern, two rows in six
//   of stage 2 on X-Trans): both are the correctly rounded quotient, so
//   no bit changes;
// - the denominators are looked up per cell from the tables in shared
//   memory (868 bytes per block), where lanes in different cells do not
//   serialise: four loads per pixel.
//
// Numerics: _demosaic_grad_generic_window's operation order on
// raw * scale (tents as (a + b*2) + c, the R/B numerator as column sums
// added left to right), IEEE division, -fmad=false, as the plain PyTorch
// version rounds. The finish tail is develop_common.cuh.

#include "develop_common.cuh"
#include "cfa_tables.cuh"
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

template <bool YCBCR>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    develop_grad_cfa_bands(const uint16_t* __restrict__ mosaics,
                           const float* __restrict__ scal,
                           const QuantTable* __restrict__ quant, int h, int w,
                           const __grid_constant__ CfaTables tables,
                           uint32_t* __restrict__ rgba,
                           uint8_t* __restrict__ yplane,
                           uint8_t* __restrict__ cbcr) {
  const size_t img = blockIdx.z;
  __shared__ CfaTables t;
  __shared__ Tail tail;
  copy_tables(tables, &t, threadIdx.x, kThreads);
  load_tail(&tail, quant, scal + img * kScalars, threadIdx.x, kThreads);
  __syncthreads();  // the only one: from here on warps share nothing

  const int sx = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kStripW;
  if (sx >= w) return;  // the whole warp
  const int y0 = blockIdx.y * kBandH;
  const uint16_t* m = mosaics + img * static_cast<size_t>(h) * w;
  const CfaSite site(&t, lane_column(sx - kHalo), y0 - kHalo);
  march<YCBCR>(site, m, tail, img, h, w, y0, sx, rgba, yplane, cbcr);
}

}  // namespace

// mosaics (n, h, w) u16, scal (n, 24) f32, contiguous on the device;
// tables: the packed CfaTables bytes on the host. output 0: out0 =
// (n, h, w) u32 RGBA words. output 1: out0 = (n, h, w) u8 Y, out1 =
// (n, h/2, w) u8 interleaved CbCr; h and w must be even. quant: the
// transfer's QuantTable on the device (develop_common.cuh). Launches on
// ``stream``, does not synchronise, and returns the cudaGetLastError()
// code.
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
  if (output == 1)
    develop_grad_cfa_bands<true><<<grid, kThreads, 0, st>>>(
        mos, sc, qt, h, w, t, nullptr, static_cast<uint8_t*>(out0),
        static_cast<uint8_t*>(out1));
  else
    develop_grad_cfa_bands<false><<<grid, kThreads, 0, st>>>(
        mos, sc, qt, h, w, t, static_cast<uint32_t*>(out0), nullptr,
        nullptr);
  return static_cast<int>(cudaGetLastError());
}
