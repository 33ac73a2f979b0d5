// The banded Lanczos-3 resize of packed RGBA words for Hopper (sm_90a): a
// batch of (n, H, W) u32 words to (n, out_h, out_w) words, or to JPEG
// YCbCr 4:2:0 planes (Y (n, out_h, out_w), Cb and Cr (n, out_h/2,
// out_w/2) u8), in one launch.
//
// Replaces no TPU kernel: the JAX package resizes with jax.image.resize
// (raweditor_tpu/ops/resize.py), which XLA contracts as dense per-axis
// weight matrices; the port did the same with torch.matmul
// (ops/resize.resize_hw). At a 45 MP frame cut to a 2048 long edge that
// was 12.9 ms of device time an image, 94% of the web export's, though
// 99.6% of its multiply-adds were by zero weights.
//
// Numerics: the plain version ops/fused_resize.resize_words_banded_plain,
// bit for bit. Each axis's band (fused_resize.band_table: the first input
// with a nonzero weight and the weights from there, the program's own f32
// matrix) is summed tap by tap in ascending input index, acc = acc + x *
// w from 0, built with -fmad=false so every product and sum rounds on its
// own; the passes run in the order resize.resize_hw picks; an axis that
// keeps its size takes a pass of weight 1.0, which is exact. Then rintf
// (half to even), clamped to 0..255, packed with opaque alpha; for planes
// ops/jpeg.rgba_words_to_ycbcr420 of those codes: Y and the chroma of each
// pixel, the chroma box summed in the order torch's CUDA sum takes it (the
// row pair first), as csrc/linear.cu does.
//
// What bounds it: at 45 MP to 2048 x 1366 an image is 179 MB of words
// read and 4.2 MB of planes written, 0.0547 ms at 3.35 TB/s; the band's
// separately rounded multiplies and adds (24 taps a pass, three channels)
// take about as long at the card's f32 issue rate. So each word is read
// once and the intermediate never goes to device memory. Design: a block
// of 256 threads owns a window of input columns (two a thread, or one
// where the ring below is 16) and the outputs whose column bands lie
// inside it (a strip, at most 256), and a band of 64 output rows. It
// marches down the input rows the band needs, as the band kernels do
// (band_march.cuh): each thread adds every row's three channels to the
// live output rows it feeds, held in registers as a ring of 8 (16 for an
// upscale) whose slots are compile-time indices, in ascending row order.
// When an output row's band ends its column values go to shared memory;
// after each turn of the ring the block runs the column pass on those
// rows from there (lanes over 8 columns and 4 rows, a row pitch of one
// more than the window, so the 32 lanes read 32 banks at 4:1), and the
// 2x2 epilogue gathers each 4:2:0 quad by warp shuffles. Words are read
// as one u32 a lane, 128 bytes a warp; a byte becomes f32 exactly as
// (2^23 + b) - 2^23 (a byte permute and an add, no conversion
// instruction). A block takes 68,800 bytes of shared memory at 4:1, so
// three fit an SM where the registers allow: held to 80 registers (no
// spills) against 116-123 with two blocks an SM, a 45 MP image of a
// flush of eight took 0.272 ms to words and 0.278 to planes against
// 0.359 and 0.363 (NVIDIA H100 80GB HBM3 at 700.00 W, queued). Where resize_hw runs the column pass first (a portrait
// frame), the same march runs along the columns (`transposed`): the
// arithmetic is the same, only the addressing turns, and the loads are no
// longer coalesced.
//
// The march takes a size change whose live outputs fit its ring and whose
// cross bands fit a strip of at least two outputs in the window; beyond
// about 73:1 (a thumbnail of a 45 MP frame: a 4:1 band is 24 columns, a
// 100:1 band 600) or an upscale beyond about 2.5x, fused_resize.kernel_plan
// gives ring 0 and the launch takes resize_taps instead: a block a 2x2
// quad of outputs, the same sums in the same order (each cross input's
// march band by one thread, then the output's cross band by one thread a
// channel, in ascending index), so the same words. It recomputes each
// march sum for every output that reads it, which costs little where the
// outputs are this few.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBandRows = 64;  // fused_resize.BAND_ROWS
constexpr int kMinBlocks = 3;  // three blocks an SM: at most 85 registers
constexpr unsigned kAllLanes = 0xffffffffu;

// f(std::integral_constant<int, I>()) for I = B .. E - 1: each I a
// compile-time constant, so the ring's register slots need no indexing.
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(const F& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>());
    static_for<B + 1, E>(f);
  }
}

// Byte `sel` of a word (0x7440: R, 0x7441: G, 0x7442: B) as f32: the
// byte under the exponent of 2^23, minus 2^23.
__device__ __forceinline__ float byte_f32(uint32_t w, uint32_t sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, sel)) - 8388608.0f;
}

__device__ __forceinline__ int round_code(float v) {
  return static_cast<int>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

__device__ __forceinline__ uint8_t round_u8(float v) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

// ops/jpeg.rgb_to_ycbcr of one pixel's codes.
__device__ __forceinline__ void ycbcr_px(const int (&p)[3], float& y,
                                         float& cb, float& cr) {
  const float rf = static_cast<float>(p[0]);
  const float gf = static_cast<float>(p[1]);
  const float bf = static_cast<float>(p[2]);
  y = 0.299f * rf + 0.587f * gf + 0.114f * bf;
  cb = 128.0f - 0.168735892f * rf - 0.331264108f * gf + 0.5f * bf;
  cr = 128.0f + 0.5f * rf - 0.418687589f * gf - 0.081312411f * bf;
}

// The 2x2 box mean of c[row][column] of the image, the row pair first.
__device__ __forceinline__ uint8_t box_u8(const float (&c)[2][2]) {
  return round_u8(((c[0][0] + c[1][0]) + (c[0][1] + c[1][1])) * 0.25f);
}

// Where the outputs go, and the image's sizes.
struct Outputs {
  uint32_t* rgba;
  uint8_t* y;
  uint8_t* cb;
  uint8_t* cr;
  int out_h, out_w;
  bool transposed;
};

// The column pass over rows [0, nr) of the ring's shared rows (march
// indices m0 + r) and the block's strip of pw outputs (cross indices
// p0 + p), then the store. Lanes: 8 outputs by 4 rows.
template <int R, int kPitch, bool YCBCR>
__device__ __forceinline__ void cross_pass(
    const float* __restrict__ ibuf, const float* __restrict__ s_wc,
    const int* __restrict__ s_fc, const int* __restrict__ s_nc, int tc,
    int pw, int nr, int m0, int p0, size_t img, const Outputs& out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p_lo = lane & 7, r_lo = lane >> 3;
  const int groups = (pw + 7) >> 3;
  const size_t plane = static_cast<size_t>(out.out_h) * out.out_w;
  for (int task = warp; task < groups * (R / 4); task += kWarps) {
    const int p = (task % groups) * 8 + p_lo;
    const int r = (task / groups) * 4 + r_lo;
    const bool valid = p < pw && r < nr;
    int q[3] = {0, 0, 0};
    if (valid) {
      const float* x = ibuf + r * kPitch + s_fc[p];
      const float* wt = s_wc + p * tc;
      const int taps = s_nc[p];
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
      for (int t = 0; t < taps; ++t) {
        const float wv = wt[t];
        a0 = a0 + x[t] * wv;
        a1 = a1 + x[R * kPitch + t] * wv;
        a2 = a2 + x[2 * R * kPitch + t] * wv;
      }
      q[0] = round_code(a0);
      q[1] = round_code(a1);
      q[2] = round_code(a2);
    }
    const int m = m0 + r, c = p0 + p;
    const size_t pix = out.transposed
                           ? static_cast<size_t>(c) * out.out_w + m
                           : static_cast<size_t>(m) * out.out_w + c;
    if constexpr (!YCBCR) {
      if (valid)
        out.rgba[img * plane + pix] =
            static_cast<uint32_t>(q[0]) | (static_cast<uint32_t>(q[1]) << 8) |
            (static_cast<uint32_t>(q[2]) << 16) | 0xFF000000u;
    } else {
      float y, cb, cr;
      ycbcr_px(q, y, cb, cr);
      if (valid) out.y[img * plane + pix] = round_u8(y);
      // The quad of a lane at an even output and an even row: the next
      // output is lane + 1, the next row lane + 8.
      const float cb_c = __shfl_down_sync(kAllLanes, cb, 1);
      const float cb_r = __shfl_down_sync(kAllLanes, cb, 8);
      const float cb_rc = __shfl_down_sync(kAllLanes, cb, 9);
      const float cr_c = __shfl_down_sync(kAllLanes, cr, 1);
      const float cr_r = __shfl_down_sync(kAllLanes, cr, 8);
      const float cr_rc = __shfl_down_sync(kAllLanes, cr, 9);
      if (valid && !(p_lo & 1) && !(r_lo & 1)) {
        // [image row][image column]: the march runs down the image's
        // rows, or along its columns where transposed.
        const float bcb[2][2] = {
            {cb, out.transposed ? cb_r : cb_c},
            {out.transposed ? cb_c : cb_r, cb_rc}};
        const float bcr[2][2] = {
            {cr, out.transposed ? cr_r : cr_c},
            {out.transposed ? cr_c : cr_r, cr_rc}};
        const int cw = out.out_w / 2;
        const size_t cpix = out.transposed
                                ? static_cast<size_t>(c / 2) * cw + m / 2
                                : static_cast<size_t>(m / 2) * cw + c / 2;
        out.cb[img * (plane / 4) + cpix] = box_u8(bcb);
        out.cr[img * (plane / 4) + cpix] = box_u8(bcr);
      }
    }
  }
}

// One block: strip blockIdx.x of the cross axis, band blockIdx.y of
// kBandRows outputs along the march, image blockIdx.z. The tables (see
// fused_resize.kernel_plan): itab = first input and last input of each
// march output, first input and tap count of each cross output, and
// (first input, first output, end output) of each strip; ftab = the march
// weights (out_march x tm), then the cross weights (out_cross x tc).
template <int R, int CPT, bool YCBCR>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    resize_bands(const uint32_t* __restrict__ words,
                 const int* __restrict__ itab, const float* __restrict__ ftab,
                 Outputs out, int h, int w, int tm, int tc, int strip_max) {
  constexpr int kWindow = kThreads * CPT;
  constexpr int kPitch = kWindow + 1;  // a row of the ring in shared memory
  extern __shared__ __align__(16) float smem[];
  float* ibuf = smem;  // [3][R][kPitch]
  float* s_wm = ibuf + 3 * R * kPitch;
  int* s_fm = reinterpret_cast<int*>(s_wm + kBandRows * tm);
  int* s_lm = s_fm + kBandRows;
  float* s_wc = reinterpret_cast<float*>(s_lm + kBandRows);
  int* s_fc = reinterpret_cast<int*>(s_wc + strip_max * tc);
  int* s_nc = s_fc + strip_max;

  const bool tr = out.transposed;
  const int march_len = tr ? w : h, cross_len = tr ? h : w;
  const int out_march = tr ? out.out_w : out.out_h;
  const int out_cross = tr ? out.out_h : out.out_w;
  const int* fm = itab;
  const int* lm = fm + out_march;
  const int* fc = lm + out_march;
  const int* nc = fc + out_cross;
  const int* strip = nc + out_cross + 3 * blockIdx.x;
  const float* wm = ftab;
  const float* wc = ftab + static_cast<size_t>(out_march) * tm;

  const int tid = threadIdx.x;
  const int c0 = __ldg(strip), p0 = __ldg(strip + 1);
  const int pw = __ldg(strip + 2) - p0;
  const int q0 = blockIdx.y * kBandRows;
  const int nq = min(kBandRows, out_march - q0);
  const size_t img = blockIdx.z;

  for (int i = tid; i < nq * tm; i += kThreads)
    s_wm[i] = __ldg(wm + static_cast<size_t>(q0) * tm + i);
  for (int i = tid; i < nq; i += kThreads) {
    s_fm[i] = __ldg(fm + q0 + i);
    s_lm[i] = __ldg(lm + q0 + i);
  }
  for (int i = tid; i < pw * tc; i += kThreads)
    s_wc[i] = __ldg(wc + static_cast<size_t>(p0) * tc + i);
  for (int i = tid; i < pw; i += kThreads) {
    s_fc[i] = __ldg(fc + p0 + i) - c0;
    s_nc[i] = __ldg(nc + p0 + i);
  }
  __syncthreads();

  // The thread's columns (clamped to the image: a column past it is
  // computed and never read).
  const size_t ld_march = tr ? 1 : static_cast<size_t>(w);
  const size_t ld_cross = tr ? static_cast<size_t>(w) : 1;
  const uint32_t* src = words + img * static_cast<size_t>(h) * w;
  size_t col[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    col[k] = static_cast<size_t>(min(c0 + tid + k * kThreads, cross_len - 1)) *
             ld_cross;

  float acc[R][3][CPT];
#pragma unroll
  for (int s = 0; s < R; ++s)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
#pragma unroll
      for (int k = 0; k < CPT; ++k) acc[s][ch][k] = 0.0f;

  int y = s_fm[0];
  uint32_t next[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    next[k] = __ldg(src + static_cast<size_t>(y) * ld_march + col[k]);

  for (int ob = 0; ob < nq; ob += R) {
    // Step j finishes output ob + j; slot (j + kk) % R holds output
    // ob + j + kk, so every slot index is a constant.
    static_for<0, R>([&](auto step) {
      constexpr int j = decltype(step)::value;
      const int o = ob + j;
      if (o >= nq) return;
      const int yend = s_lm[o];
      for (; y <= yend; ++y) {
        uint32_t cur[CPT];
#pragma unroll
        for (int k = 0; k < CPT; ++k) cur[k] = next[k];
        const size_t yn = static_cast<size_t>(min(y + 1, march_len - 1));
#pragma unroll
        for (int k = 0; k < CPT; ++k)
          next[k] = __ldg(src + yn * ld_march + col[k]);
        float v[3][CPT];
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          v[0][k] = byte_f32(cur[k], 0x7440u);
          v[1][k] = byte_f32(cur[k], 0x7441u);
          v[2][k] = byte_f32(cur[k], 0x7442u);
        }
        // The live outputs o, o + 1, ...: their first inputs are in
        // order, so the first that starts below this row ends the list.
#pragma unroll
        for (int kk = 0; kk < R; ++kk) {
          const int ok = o + kk;
          if (ok >= nq) break;
          const int f = s_fm[ok];
          if (f > y) break;
          const float wt = s_wm[ok * tm + (y - f)];
          const int s = (j + kk) % R;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
#pragma unroll
            for (int k = 0; k < CPT; ++k)
              acc[s][ch][k] = acc[s][ch][k] + v[ch][k] * wt;
        }
      }
      // Output o is complete: its row goes to the ring's shared rows.
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          ibuf[(ch * R + j) * kPitch + tid + k * kThreads] = acc[j][ch][k];
          acc[j][ch][k] = 0.0f;
        }
    });
    __syncthreads();
    cross_pass<R, kPitch, YCBCR>(ibuf, s_wc, s_fc, s_nc, tc, pw,
                                 min(R, nq - ob), q0 + ob, p0, img, out);
    __syncthreads();
  }
}

// The fallback (ring 0): output quad blockIdx.x (quads of the image's
// rows, out_w / 2 rounded up of them a row) of image blockIdx.y. For each
// output of the quad the threads take its cross band kThreads inputs at a
// time, each summing its input's march band (the tables as resize_bands
// reads them, without the strips); then thread ch adds the chunk to
// channel ch's sum, in ascending input index.
template <bool YCBCR>
__global__ void __launch_bounds__(kThreads)
    resize_taps(const uint32_t* __restrict__ words,
                const int* __restrict__ itab, const float* __restrict__ ftab,
                Outputs out, int h, int w, int tm, int tc) {
  __shared__ float part[3][kThreads + 1];
  __shared__ int codes[4][3];
  const bool tr = out.transposed;
  const int out_march = tr ? out.out_w : out.out_h;
  const int out_cross = tr ? out.out_h : out.out_w;
  const int* fm = itab;
  const int* lm = fm + out_march;
  const int* fc = lm + out_march;
  const int* nc = fc + out_cross;
  const float* wc = ftab + static_cast<size_t>(out_march) * tm;
  const int qw = (out.out_w + 1) >> 1;
  const int qr = blockIdx.x / qw, qc = blockIdx.x % qw;
  const size_t img = blockIdx.y;
  const size_t ld_march = tr ? 1 : static_cast<size_t>(w);
  const size_t ld_cross = tr ? static_cast<size_t>(w) : 1;
  const uint32_t* src = words + img * static_cast<size_t>(h) * w;
  const int tid = threadIdx.x;

  for (int k = 0; k < 4; ++k) {
    const int r = 2 * qr + (k >> 1), c = 2 * qc + (k & 1);
    if (r >= out.out_h || c >= out.out_w) continue;  // the same for all
    const int m = tr ? c : r, p = tr ? r : c;
    const int f = __ldg(fm + m), taps = __ldg(lm + m) - f + 1;
    const int fcp = __ldg(fc + p), ncp = __ldg(nc + p);
    const float* wm = ftab + static_cast<size_t>(m) * tm;
    const float* wcp = wc + static_cast<size_t>(p) * tc;
    float acc = 0.0f;  // thread ch < 3: channel ch
    for (int s0 = 0; s0 < ncp; s0 += kThreads) {
      if (s0 + tid < ncp) {
        const uint32_t* x = src + static_cast<size_t>(fcp + s0 + tid) *
                                      ld_cross + static_cast<size_t>(f) *
                                      ld_march;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll 4
        for (int t = 0; t < taps; ++t) {
          const uint32_t v = __ldg(x + static_cast<size_t>(t) * ld_march);
          const float wt = __ldg(wm + t);
          a0 = a0 + byte_f32(v, 0x7440u) * wt;
          a1 = a1 + byte_f32(v, 0x7441u) * wt;
          a2 = a2 + byte_f32(v, 0x7442u) * wt;
        }
        part[0][tid] = a0;
        part[1][tid] = a1;
        part[2][tid] = a2;
      }
      __syncthreads();
      if (tid < 3) {
        const int e = min(kThreads, ncp - s0);
        for (int i = 0; i < e; ++i)
          acc = acc + part[tid][i] * __ldg(wcp + s0 + i);
      }
      __syncthreads();
    }
    if (tid < 3) codes[k][tid] = round_code(acc);
  }
  __syncthreads();
  if (tid != 0) return;
  const size_t plane = static_cast<size_t>(out.out_h) * out.out_w;
  if constexpr (!YCBCR) {
    for (int k = 0; k < 4; ++k) {
      const int r = 2 * qr + (k >> 1), c = 2 * qc + (k & 1);
      if (r < out.out_h && c < out.out_w)
        out.rgba[img * plane + static_cast<size_t>(r) * out.out_w + c] =
            static_cast<uint32_t>(codes[k][0]) |
            (static_cast<uint32_t>(codes[k][1]) << 8) |
            (static_cast<uint32_t>(codes[k][2]) << 16) | 0xFF000000u;
    }
  } else {
    // Even out_h and out_w: every output of the quad is in the image.
    float cb[2][2], cr[2][2];
    for (int k = 0; k < 4; ++k) {
      const int q[3] = {codes[k][0], codes[k][1], codes[k][2]};
      float y;
      ycbcr_px(q, y, cb[k >> 1][k & 1], cr[k >> 1][k & 1]);
      out.y[img * plane +
            static_cast<size_t>(2 * qr + (k >> 1)) * out.out_w + 2 * qc +
            (k & 1)] = round_u8(y);
    }
    const size_t cpix = static_cast<size_t>(qr) * (out.out_w / 2) + qc;
    out.cb[img * (plane / 4) + cpix] = box_u8(cb);
    out.cr[img * (plane / 4) + cpix] = box_u8(cr);
  }
}

template <int R, int CPT, bool YCBCR>
int launch(dim3 grid, int smem, cudaStream_t st, const uint32_t* words,
           const int* itab, const float* ftab, const Outputs& out, int h,
           int w, int tm, int tc, int strip_max) {
  const auto kernel = resize_bands<R, CPT, YCBCR>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, st>>>(words, itab, ftab, out, h, w, tm, tc,
                                       strip_max);
  return static_cast<int>(cudaGetLastError());
}

template <int R, int CPT>
int launch_output(int output, dim3 grid, int smem, cudaStream_t st,
                  const uint32_t* words, const int* itab, const float* ftab,
                  const Outputs& out, int h, int w, int tm, int tc,
                  int strip_max) {
  return output == 1
             ? launch<R, CPT, true>(grid, smem, st, words, itab, ftab, out, h,
                                    w, tm, tc, strip_max)
             : launch<R, CPT, false>(grid, smem, st, words, itab, ftab, out,
                                     h, w, tm, tc, strip_max);
}

template <bool YCBCR>
int launch_taps(dim3 grid, cudaStream_t st, const uint32_t* words,
                const int* itab, const float* ftab, const Outputs& out, int h,
                int w, int tm, int tc) {
  resize_taps<YCBCR><<<grid, kThreads, 0, st>>>(words, itab, ftab, out, h, w,
                                                tm, tc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the resize on `stream`: words (n, h, w) u32, contiguous on the
// device, to (n, out_h, out_w) u32 words in out0 (output 0), or (output
// 1, even out_h and out_w) Y (n, out_h, out_w) u8 in out0, Cb and Cr
// (n, out_h/2, out_w/2) u8 in out1 and out2. itab, ftab, transposed, tm,
// tc, nstrips, strip_max, ring (8 or 16; 0 for resize_taps, which takes
// no strips and no dynamic shared memory) and smem_bytes are
// fused_resize.kernel_plan's. Returns a CUDA error code, 0 on success.
extern "C" int rtt_resize_launch(const void* words, const void* itab,
                                 const void* ftab, void* out0, void* out1,
                                 void* out2, int n, int h, int w, int out_h,
                                 int out_w, int transposed, int tm, int tc,
                                 int nstrips, int strip_max, int ring,
                                 int output, int smem_bytes, void* stream) {
  if (words == nullptr || itab == nullptr || ftab == nullptr ||
      out0 == nullptr || n < 1 || h < 1 || w < 1 || out_h < 1 || out_w < 1 ||
      tm < 1 || tc < 1 || (output != 0 && output != 1) ||
      (ring != 0 && ring != 8 && ring != 16) ||
      (ring != 0 && (nstrips < 1 || strip_max < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (output == 1 && (out1 == nullptr || out2 == nullptr || (out_h & 1) ||
                      (out_w & 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int out_march = transposed ? out_w : out_h;
  const long long quads =
      static_cast<long long>((out_h + 1) / 2) * ((out_w + 1) / 2);
  const dim3 grid = ring == 0 ? dim3(static_cast<unsigned>(quads), n)
                              : dim3(nstrips,
                                     (out_march + kBandRows - 1) / kBandRows,
                                     n);
  if (quads > 0x7fffffffLL || grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  Outputs out{};
  out.out_h = out_h;
  out.out_w = out_w;
  out.transposed = transposed != 0;
  if (output == 1) {
    out.y = static_cast<uint8_t*>(out0);
    out.cb = static_cast<uint8_t*>(out1);
    out.cr = static_cast<uint8_t*>(out2);
  } else {
    out.rgba = static_cast<uint32_t*>(out0);
  }
  const auto* wd = static_cast<const uint32_t*>(words);
  const auto* it = static_cast<const int*>(itab);
  const auto* ft = static_cast<const float*>(ftab);
  const auto st = static_cast<cudaStream_t>(stream);
  if (ring == 0)
    return output == 1 ? launch_taps<true>(grid, st, wd, it, ft, out, h, w,
                                           tm, tc)
                       : launch_taps<false>(grid, st, wd, it, ft, out, h, w,
                                            tm, tc);
  return ring == 8
             ? launch_output<8, 2>(output, grid, smem_bytes, st, wd, it, ft,
                                   out, h, w, tm, tc, strip_max)
             : launch_output<16, 1>(output, grid, smem_bytes, st, wd, it, ft,
                                    out, h, w, tm, tc, strip_max);
}
