// Fused gradient-weighted Bayer develop for Hopper (sm_90a): u16 mosaic
// in, packed RGBA u32 words or JPEG YCbCr 4:2:0 planes out, in one pass.
//
// Replaces the TPU kernel raweditor_tpu/ops/pallas_develop.py
// (_kernel_flat -> _develop_block -> _demosaic_grad_window with
// _clamp_shift_fns and _chroma_refine; then _finish_block, and
// _emit_ycbcr420 for output="ycbcr420"), reached from pallas_develop_rgba
// and pallas_batch_develop_rgba with demosaic="grad". Its TPU tiling
// mechanics (_band_realign, _clampw_fn, the width and height pad rescues,
// _grad_block_height) have no counterpart here: a warp clamps at the
// true image edge itself and takes any (H, W).
//
// The stages (the XLA lane is ops/cfa_generic.demosaic_grad_generic):
//   1. G at R/B sites: the horizontal and vertical neighbour means
//      blended by inverse raw gradients, 1/(|r-l| + 1e-4);
//   2. R and B by colour differences (value - G) from the row pair, the
//      column pair or the diagonal quad, with G added back;
//   3. two chroma refinements: a 3x3 tent over R-G and B-G (column pass,
//      then row pass, then /16), each channel rebuilt from its own sites.
// Each stage is a +-1 stencil over the one before, so an output pixel
// sees 4 pixels around it.
//
// What bounds it: instruction throughput. It moves the same bytes as the quad
// kernel (2 B/px in; 4 B/px RGBA or 1.5 B/px planes out: 0.043 ms or
// 0.024 ms per 24 MP frame at 3.35 TB/s) and needs at least 140 f32
// operations per pixel with the sRGB transfer (52 of them in the demosaic
// stages, two divisions among them): 0.05 ms at the card's 67 TFLOP/s.
// No -fmad=false kernel can reach that rate (a multiply and an add are
// two instructions), an IEEE division costs tens of instructions, and the
// transfer's table lookup (develop_common.cuh) two dependent shared loads
// per channel. What a design can move is everything around the
// arithmetic, so this one keeps every stage in registers: a warp marches
// down a 64-column strip, each stage holds its last three rows per lane,
// horizontal neighbours come by warp shuffles, and there is no shared
// memory beyond the tail's tables, one block barrier at the start and no
// per-item index arithmetic (grad_tile.cuh). The
// Bayer site classes are warp-uniform per row (a lane's even column is
// the R/B site of a row or its G site), so stage 1 interpolates one G
// per lane and row with one shuffle, and stage 2 needs two shuffles: the
// vertical pair sums and the centre differences of the neighbour
// columns.
//
// Clamp-to-edge: every stage reads its neighbours at coordinates clamped
// to the image before it looks up the stage below. Padding the mosaic
// once would be wrong for composed stages: the clamp must hold at every
// stage, as in the TPU kernel's per-shift edge fixups (grad_tile.cuh
// says how the march does it for rows and for columns).
//
// Numerics: _demosaic_grad_window's operation order on raw * scale, the
// black level folded into the finish offset (the gradient weights see
// raw differences, where the offset cancels). IEEE division (nvcc's
// default -prec-div=true) and -fmad=false, as the plain PyTorch version
// rounds. The finish tail is develop_common.cuh.

#include "develop_common.cuh"
#include "grad_tile.cuh"

namespace {

// The Bayer pattern seen from a lane: column a is even, so it is in the
// x-even class iff the phase px is 0; rows alternate.
struct BayerSite {
  bool a_even;  // column a is of the x-even class
  bool t_even;  // row t (the mosaic row of this step) is of the y-even class

  __device__ __forceinline__ BayerSite(int py, int px, int t_first)
      : a_even(px == 0), t_even(((t_first - 1 + py) & 1) == 0) {}
  __device__ __forceinline__ void step() { t_even = !t_even; }
  __device__ __forceinline__ bool row_even(int lag) const {
    return (lag & 1) ? !t_even : t_even;
  }
  // G sites are where the row and column classes differ, R where both
  // are even.
  __device__ __forceinline__ int chan(int lag, int half) const {
    const bool ye = row_even(lag);
    const bool xe = half == 0 ? a_even : !a_even;
    return ye != xe ? 1 : (ye ? 0 : 2);
  }

  // 1. G at row t-1: directional means blended by inverse gradients at
  //    the row's R/B column, the sensor value at its G column.
  __device__ __forceinline__ Pair green(const Pair& u, const Pair& c,
                                        const Pair& d) const {
    const bool site_a = row_even(1) == a_even;  // warp-uniform
    float l, r, up, dn;
    if (site_a) {
      l = left_of_a(c);
      r = c.b;
      up = u.a;
      dn = d.a;
    } else {
      l = c.a;
      r = right_of_b(c);
      up = u.b;
      dn = d.b;
    }
    const float wh = 1.0f / (fabsf(r - l) + kEps);
    const float wv = 1.0f / (fabsf(dn - up) + kEps);
    const float g =
        (wh * ((l + r) * 0.5f) + wv * ((up + dn) * 0.5f)) / (wh + wv);
    return site_a ? Pair{g, c.b} : Pair{c.a, g};
  }

  // 2. R and B at row t-2 by colour differences (diff is exactly 0 at G
  //    sites): at the row's R/B column the other colour from the diagonal
  //    quad, at its G column one colour from the row pair and one from
  //    the column pair.
  __device__ __forceinline__ void red_blue(const Pair& c, const Pair& g,
                                           const Win3& diff, Pair& r,
                                           Pair& b) const {
    const bool ye = row_even(2);
    const bool site_a = ye == a_even;  // warp-uniform
    const Pair vs{diff.up.a + diff.dn.a, diff.up.b + diff.dn.b};
    float diag, hpair, vpair;
    if (site_a) {
      diag = (left_of_a(vs) + vs.b) * 0.25f;
      hpair = (diff.mid.a + right_of_b(diff.mid)) * 0.5f;
      vpair = vs.b * 0.5f;
    } else {
      hpair = (left_of_a(diff.mid) + diff.mid.b) * 0.5f;
      vpair = vs.a * 0.5f;
      diag = (vs.a + right_of_b(vs)) * 0.25f;
    }
    const float cs = site_a ? c.a : c.b;  // the R/B site and its G
    const float gs = site_a ? g.a : g.b;
    const float go = site_a ? g.b : g.a;  // the G site's G
    const float rs = ye ? cs : gs + diag;
    const float bs = ye ? gs + diag : cs;
    const float ro = ye ? go + hpair : go + vpair;
    const float bo = ye ? go + vpair : go + hpair;
    r = site_a ? Pair{rs, ro} : Pair{ro, rs};
    b = site_a ? Pair{bs, bo} : Pair{bo, bs};
  }
};

template <bool YCBCR>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    develop_grad_bands(const uint16_t* __restrict__ mosaics,
                       const float* __restrict__ scal,
                       const QuantTable* __restrict__ quant, int h, int w,
                       int py, int px, uint32_t* __restrict__ rgba,
                       uint8_t* __restrict__ yplane,
                       uint8_t* __restrict__ cbcr) {
  const size_t img = blockIdx.z;
  __shared__ Tail tail;
  load_tail(&tail, quant, scal + img * kScalars, threadIdx.x, kThreads);
  __syncthreads();  // the only one: from here on warps share nothing
  const int sx = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kStripW;
  if (sx >= w) return;  // the whole warp
  const int y0 = blockIdx.y * kBandH;
  const uint16_t* m = mosaics + img * static_cast<size_t>(h) * w;
  const BayerSite site(py, px, y0 - kHalo);
  march<YCBCR>(site, m, tail, img, h, w, y0, sx, rgba, yplane, cbcr);
}

}  // namespace

// mosaics (n, h, w) u16, scal (n, 24) f32, contiguous on the device.
// output 0: out0 = (n, h, w) u32 RGBA words. output 1: out0 = (n, h, w)
// u8 Y, out1 = (n, h/2, w) u8 interleaved CbCr; h and w must be even.
// quant: the transfer's QuantTable on the device (develop_common.cuh).
// Launches on ``stream``, does not synchronise, and returns the
// cudaGetLastError() code.
extern "C" int rtt_develop_grad_launch(const void* mosaics, const void* scal,
                                       void* out0, void* out1, int n, int h,
                                       int w, int py, int px, int output,
                                       const void* quant, void* stream) {
  if (const int bad = check_develop_args(n, h, w, py, px, output, quant))
    return bad;
  const dim3 grid = band_grid(n, h, w);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* mos = static_cast<const uint16_t*>(mosaics);
  const auto* sc = static_cast<const float*>(scal);
  const auto* qt = static_cast<const QuantTable*>(quant);
  const auto st = static_cast<cudaStream_t>(stream);
  if (output == 1)
    develop_grad_bands<true><<<grid, kThreads, 0, st>>>(
        mos, sc, qt, h, w, py, px, nullptr, static_cast<uint8_t*>(out0),
        static_cast<uint8_t*>(out1));
  else
    develop_grad_bands<false><<<grid, kThreads, 0, st>>>(
        mos, sc, qt, h, w, py, px, static_cast<uint32_t*>(out0), nullptr,
        nullptr);
  return static_cast<int>(cudaGetLastError());
}
