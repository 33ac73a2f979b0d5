// The LinearRaw develop for Hopper (sm_90a): a batch of already
// demosaiced (n, H, W, 3) u16 frames (DNG LinearRaw, photometric 34892)
// to packed RGBA u32 words or JPEG YCbCr 4:2:0 planes, in one launch.
//
// Replaces no TPU kernel: the JAX package develops LinearRaw frames on
// XLA (raweditor_tpu/ops/develop.py develop_linear, then the 4:2:0
// conversion of raweditor_tpu/ops/jpeg.py). The port's plain lane
// (parallel/batch.batch_develop_linear_rgba) ran that as some 157 torch
// launches a 24 MP image, each a pass over device memory; this kernel is
// that lane in one pass, with no f32 intermediate in device memory.
//
// Numerics: the plain lane's own operation order, not the folded one of
// the CFA kernels (develop_common.cuh finish(), which reassociates white
// balance and exposure into the matrix and is up to 1 LSB from the lane).
// Per pixel and channel: (x - black) / (white - black), an IEEE division;
// then ops/develop.apply_edit_stack step for step (white balance,
// temperature and tint, the 3x3 matrix, exp2(exposure), tone, contrast,
// levels, saturation, vibrance), built with -fmad=false so that every
// multiply and add rounds on its own as torch's elementwise kernels do.
// The per-image scalars (struct LinearTail) are the lane's f32 values,
// computed by the same torch operations on the same device
// (ops/fused_linear.pack_linear_params). The transfer and quantiser of
// finish_to_u8 is the exact table of develop_common.cuh (QuantTable),
// derived from the lane's own finish (fused_linear.lane_quant_table). The
// 4:2:0 conversion is ops/jpeg.rgba_words_to_ycbcr420's: Y and the
// chroma of every pixel from its codes, the chroma box summed in the
// order torch's sum over the 2x2 box takes on the card. So the output is
// the lane's, bit for bit.
//
// What bounds it: at 24 MP a frame is 145 MB of samples read and 36 MB
// of planes (or 97 MB of words) written, 0.054 ms (0.072 ms) at
// 3.35 TB/s; but the lane's unfolded stack under -fmad=false (a multiply
// and an add are two instructions), three IEEE divisions and three table
// lookups are some 250 instructions a pixel, and issuing them takes
// longer than the bytes. So the loads and stores are wide and few, and
// nothing is spent on moving values about. Design: a thread owns two
// rows of eight pixels, four 2x2 quads side by side, so it owns whole
// chroma samples and each row is three 16-byte loads (8 x 3 x 2 bytes)
// where the frame's width is a multiple of 8; it keeps the rows packed,
// works its quads unrolled (100-112 registers, two blocks an SM, no
// spills), and stores one 16-byte word per four RGBA pixels, or eight
// bytes of Y per row and eight of NV12 CbCr. On an NVIDIA H100 80GB HBM3
// at 700.00 W, against a loop over the quads held to 80 registers (it
// spilled 184-284 bytes): 0.266 -> 0.176 ms a 24 MP slot to words,
// 0.192 -> 0.192 ms to planes, in flushes of eight. Blocks of 32 x 8
// threads cover tiles of 256 x 16 pixels, four tiles down the image, the
// batch as the grid's z dimension, so a flush of any n is one launch;
// each block copies the quantiser table and its image's scalars to
// shared memory once. Frames whose width is not a multiple of 8, and the
// last columns of a ragged width, load and store each pixel masked; odd
// frames mask the ragged quad's stores (RGBA; the planes need even
// frames). A sample at the black level is a zero dividend, which sends
// the IEEE division to its slow path: with every seventh sample at black
// 0 a slot took 0.348 ms to planes (same card). Dividing 1 in its place
// (behind an opaque move, or the compiler folds it back) brought that to
// 0.200 ms but cost 4% on frames without such samples, the common case
// (a decoder's samples sit at black only where the shadows clip), so
// the division stays plain.

#include "develop_common.cuh"

namespace {

constexpr int kLinearScalars = 25;  // the slots below
constexpr int kLinBlockX = 32;
constexpr int kLinBlockY = 8;
constexpr int kLinCols = 8;                           // four quads a thread
constexpr int kLinTileW = kLinBlockX * kLinCols;      // 256 columns
constexpr int kLinTileH = kLinBlockY * 2;             // 16 rows
constexpr int kLinTileRows = 4;                       // tiles down a block
constexpr int kLinBlockH = kLinTileH * kLinTileRows;  // 64 rows a block
constexpr int kLinMinBlocks = 2;  // at most 128 registers: no spills

// The slots of one image's scalars (fused_linear.SCALAR_SLOTS).
enum Slot {
  kBlack = 0,      // black level
  kRange = 1,      // white - black
  kWb = 2,         // 2..4 white balance r, g, b
  kTempR = 5,      // 1 + temperature * 0.3
  kTint = 6,       // 1 + tint * 0.3
  kTempB = 7,      // 1 - temperature * 0.3
  kMatrix = 8,     // 8..16 the 3x3 matrix as the lane applies it
  kExposure = 17,  // exp2(exposure)
  kHighlights = 18,
  kShadows = 19,
  kContrast = 20,  // 1 + contrast / 100
  kBlacks = 21,    // the levels' blacks slider
  kInvRange = 22,  // 1 / (whites - blacks + 1e-4)
  kSaturation = 23,  // 1 + saturation / 100
  kVibrance = 24,
};

// What the threads of a block share: the quantiser and the scalars of
// the block's image.
struct alignas(16) LinearTail {
  QuantTable quant;
  float sc[kLinearScalars];
};

__device__ __forceinline__ float luma_of(float r, float g, float b) {
  return 0.2126f * r + 0.7152f * g + 0.0722f * b;
}

// One pixel's u16 samples to its three codes: ops/develop.develop_linear
// (_normalize, apply_edit_stack, finish_to_u8) in its order.
__device__ __forceinline__ void edit_pixel(const LinearTail& t, uint32_t xr,
                                           uint32_t xg, uint32_t xb,
                                           int (&q)[3]) {
  const float* sc = t.sc;
  const float black = sc[kBlack];
  const float range = sc[kRange];
  float r = (static_cast<float>(xr) - black) / range;
  float g = (static_cast<float>(xg) - black) / range;
  float b = (static_cast<float>(xb) - black) / range;

  r = r * sc[kWb];
  g = g * sc[kWb + 1];
  b = b * sc[kWb + 2];
  r = r * sc[kTempR];
  b = b * sc[kTempB];
  g = g * sc[kTint];

  const float* m = sc + kMatrix;
  const float r2 = m[0] * r + m[1] * g + m[2] * b;
  const float g2 = m[3] * r + m[4] * g + m[5] * b;
  const float b2 = m[6] * r + m[7] * g + m[8] * b;

  const float ex = sc[kExposure];
  r = r2 * ex;
  g = g2 * ex;
  b = b2 * ex;

  const float lum = luma_of(r, g, b);
  const float tone = (1.0f + lum * sc[kHighlights]) *
                     (1.0f + (1.0f - lum) * sc[kShadows]);
  r = r * tone;
  g = g * tone;
  b = b * tone;

  const float cf = sc[kContrast];
  r = (r - 0.5f) * cf + 0.5f;
  g = (g - 0.5f) * cf + 0.5f;
  b = (b - 0.5f) * cf + 0.5f;

  const float blacks = sc[kBlacks];
  const float inv = sc[kInvRange];
  r = (r - blacks) * inv;
  g = (g - blacks) * inv;
  b = (b - blacks) * inv;

  float luma = luma_of(r, g, b);
  const float sf = sc[kSaturation];
  r = luma + (r - luma) * sf;
  g = luma + (g - luma) * sf;
  b = luma + (b - luma) * sf;

  const float mx = fmaxf(r, fmaxf(g, b));
  const float mn = fminf(r, fminf(g, b));
  const float vf = 1.0f + sc[kVibrance] * (1.0f - (mx - mn));
  luma = luma_of(r, g, b);
  q[0] = quantize(t.quant, luma + (r - luma) * vf);
  q[1] = quantize(t.quant, luma + (g - luma) * vf);
  q[2] = quantize(t.quant, luma + (b - luma) * vf);
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

// The 2x2 box mean of one quad's chroma c[row][column], summed in the
// order torch's sum over the box (ops/jpeg._box2) takes on the card: the
// row pair, then the column pair (the CPU's sum takes the column pair
// first; the two sums differ in the last bit in one box in five).
__device__ __forceinline__ uint8_t box_u8(const float (&c)[2][2]) {
  return round_u8(((c[0][0] + c[1][0]) + (c[0][1] + c[1][1])) * 0.25f);
}

// Row iy's eight pixels, packed: 24 u16 samples (r, g, b a pixel) in 12
// words; a quad's two pixels are the first three words.
__device__ __forceinline__ void load_row(const uint16_t* __restrict__ row,
                                         int x0, int w, bool fast,
                                         uint32_t (&px)[12]) {
  if (fast) {
    const uint4* src = reinterpret_cast<const uint4*>(row + 3 * x0);
    const uint4 a = __ldg(src), b = __ldg(src + 1), c = __ldg(src + 2);
    px[0] = a.x; px[1] = a.y; px[2] = a.z; px[3] = a.w;
    px[4] = b.x; px[5] = b.y; px[6] = b.z; px[7] = b.w;
    px[8] = c.x; px[9] = c.y; px[10] = c.z; px[11] = c.w;
  } else {
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      uint32_t word = 0u;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = 2 * k + half;  // sample s of the eight pixels
        if (x0 + s / 3 < w)
          word |= static_cast<uint32_t>(__ldg(row + 3 * x0 + s)) << (16 * half);
      }
      px[k] = word;
    }
  }
}

// Develops a thread's two rows of eight pixels at (y0, x0), y0 and x0
// even, and stores them: each quad is quantised and packed before the
// next is worked on.
template <bool YCBCR>
__device__ __forceinline__ void linear_block(
    const LinearTail& tail, const uint16_t* __restrict__ f, size_t img,
    int h, int w, int y0, int x0, bool load_fast, bool store_fast,
    uint32_t* __restrict__ rgba, uint8_t* __restrict__ yplane,
    uint8_t* __restrict__ cbcr) {
  uint32_t px[2][12];
#pragma unroll
  for (int iy = 0; iy < 2; ++iy) {
    if (y0 + iy < h) {
      load_row(f + static_cast<size_t>(y0 + iy) * w * 3, x0, w, load_fast,
               px[iy]);
    } else {
#pragma unroll
      for (int k = 0; k < 12; ++k) px[iy][k] = 0u;
    }
  }

  uint32_t words[2][8];                                       // RGBA
  unsigned long long yrow[2] = {0ull, 0ull}, chroma = 0ull;  // bytes
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // quad k: columns x0 + 2k, x0 + 2k + 1
    int q[2][2][3];
#pragma unroll
    for (int iy = 0; iy < 2; ++iy) {
      const uint32_t a = px[iy][3 * k], b = px[iy][3 * k + 1],
                     c = px[iy][3 * k + 2];
      edit_pixel(tail, a & 0xffffu, a >> 16, b & 0xffffu, q[iy][0]);
      edit_pixel(tail, b >> 16, c & 0xffffu, c >> 16, q[iy][1]);
    }
    if constexpr (!YCBCR) {
#pragma unroll
      for (int iy = 0; iy < 2; ++iy) {
        words[iy][2 * k] = rgba_word(q[iy][0]);
        words[iy][2 * k + 1] = rgba_word(q[iy][1]);
      }
    } else {
      float cb[2][2], cr[2][2];
#pragma unroll
      for (int iy = 0; iy < 2; ++iy) {
        uint32_t pair = 0u;
#pragma unroll
        for (int ix = 0; ix < 2; ++ix) {
          float y;
          ycbcr_px(q[iy][ix], y, cb[iy][ix], cr[iy][ix]);
          pair |= static_cast<uint32_t>(round_u8(y)) << (8 * ix);
        }
        yrow[iy] |= static_cast<unsigned long long>(pair) << (16 * k);
      }
      const uint32_t cbcr_pair = static_cast<uint32_t>(box_u8(cb)) |
                                 (static_cast<uint32_t>(box_u8(cr)) << 8);
      chroma |= static_cast<unsigned long long>(cbcr_pair) << (16 * k);
    }
  }

  const size_t plane = static_cast<size_t>(h) * w;
  if constexpr (!YCBCR) {
    uint32_t* out = rgba + img * plane;
#pragma unroll
    for (int iy = 0; iy < 2; ++iy) {
      const int y = y0 + iy;
      if (y >= h) break;
      uint32_t* dst = out + static_cast<size_t>(y) * w + x0;
      if (store_fast) {
        reinterpret_cast<uint4*>(dst)[0] =
            make_uint4(words[iy][0], words[iy][1], words[iy][2], words[iy][3]);
        reinterpret_cast<uint4*>(dst)[1] =
            make_uint4(words[iy][4], words[iy][5], words[iy][6], words[iy][7]);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (x0 + c < w) dst[c] = words[iy][c];
      }
    }
  } else {  // h and w even
    uint8_t* yout = yplane + img * plane + static_cast<size_t>(y0) * w + x0;
    uint8_t* cout =
        cbcr + img * (plane / 2) + static_cast<size_t>(y0 / 2) * w + x0;
    if (store_fast) {
      *reinterpret_cast<unsigned long long*>(yout) = yrow[0];
      *reinterpret_cast<unsigned long long*>(yout + w) = yrow[1];
      *reinterpret_cast<unsigned long long*>(cout) = chroma;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (x0 + 2 * k >= w) break;
        *reinterpret_cast<uint16_t*>(yout + 2 * k) =
            static_cast<uint16_t>(yrow[0] >> (16 * k));
        *reinterpret_cast<uint16_t*>(yout + w + 2 * k) =
            static_cast<uint16_t>(yrow[1] >> (16 * k));
        *reinterpret_cast<uint16_t*>(cout + 2 * k) =
            static_cast<uint16_t>(chroma >> (16 * k));
      }
    }
  }
}

// A block of kLinBlockX x kLinBlockY threads copies the tail once and
// develops kLinTileRows tiles of kLinTileW x kLinTileH pixels down the
// image blockIdx.z.
template <bool YCBCR>
__global__ void __launch_bounds__(kLinBlockX* kLinBlockY, kLinMinBlocks)
    linear_quads(const uint16_t* __restrict__ frames,
                 const float* __restrict__ scal,
                 const QuantTable* __restrict__ quant, int h, int w,
                 uint32_t* __restrict__ rgba, uint8_t* __restrict__ yplane,
                 uint8_t* __restrict__ cbcr) {
  const size_t img = blockIdx.z;
  const int tid = threadIdx.y * kLinBlockX + threadIdx.x;
  __shared__ LinearTail tail;
  load_quant(&tail.quant, quant, tid, kLinBlockX * kLinBlockY);
  if (tid < kLinearScalars)
    tail.sc[tid] = __ldg(scal + img * kLinearScalars + tid);
  __syncthreads();
  const int x0 = (blockIdx.x * kLinBlockX + threadIdx.x) * kLinCols;
  if (x0 >= w) return;
  const uint16_t* f = frames + img * static_cast<size_t>(h) * w * 3;
  // With W a multiple of 8 every row of samples starts 16-byte aligned,
  // and so does every eighth pixel's word.
  const bool whole = (w & 7) == 0 && x0 + kLinCols <= w;
  const bool load_fast =
      whole && (reinterpret_cast<uintptr_t>(frames) & 15) == 0;
  const bool store_fast =
      whole && (YCBCR ? ((reinterpret_cast<uintptr_t>(yplane) |
                          reinterpret_cast<uintptr_t>(cbcr)) & 7) == 0
                      : (reinterpret_cast<uintptr_t>(rgba) & 15) == 0);
  for (int tile = 0; tile < kLinTileRows; ++tile) {
    const int y0 =
        ((blockIdx.y * kLinTileRows + tile) * kLinBlockY + threadIdx.y) * 2;
    if (y0 >= h) break;
    linear_block<YCBCR>(tail, f, img, h, w, y0, x0, load_fast, store_fast,
                        rgba, yplane, cbcr);
  }
}

}  // namespace

// Launches the LinearRaw develop on `stream`: frames (n, h, w, 3) u16 and
// scal (n, kLinearScalars) f32, contiguous on the device; output 0 writes
// (n, h, w) u32 RGBA words to out0, 1 (even h and w) Y (n, h, w) u8 to
// out0 and NV12 CbCr (n, h/2, w) u8 to out1; quant: the transfer's
// QuantTable on the device. Returns a CUDA error code, 0 on success.
extern "C" int rtt_linear_launch(const void* frames, const void* scal,
                                 void* out0, void* out1, int n, int h, int w,
                                 int output, const void* quant,
                                 void* stream) {
  if (const int bad = check_develop_args(n, h, w, 0, 0, output, quant))
    return bad;
  const dim3 grid((w + kLinTileW - 1) / kLinTileW,
                  (h + kLinBlockH - 1) / kLinBlockH, n);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 block(kLinBlockX, kLinBlockY);
  const auto* fr = static_cast<const uint16_t*>(frames);
  const auto* sc = static_cast<const float*>(scal);
  const auto* qt = static_cast<const QuantTable*>(quant);
  const auto st = static_cast<cudaStream_t>(stream);
  if (output == 1)
    linear_quads<true><<<grid, block, 0, st>>>(
        fr, sc, qt, h, w, nullptr, static_cast<uint8_t*>(out0),
        static_cast<uint8_t*>(out1));
  else
    linear_quads<false><<<grid, block, 0, st>>>(
        fr, sc, qt, h, w, static_cast<uint32_t*>(out0), nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}
