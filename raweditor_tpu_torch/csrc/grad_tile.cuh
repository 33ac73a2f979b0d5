// The tile machinery and the chroma-refinement tail shared by the two
// gradient-weighted develop kernels (develop_grad.cu on a Bayer phase,
// develop_grad_generic.cu on a repeating-CFA pattern).
//
// One block of 128 threads owns a 32x16-pixel output tile (even origin)
// and holds every stage in shared memory over the tile plus a 4-pixel
// halo, each stage over a region that shrinks by one pixel. The two
// kernels differ in stages 1 and 2 (G, then R/B by colour differences)
// and in how a position's channel is found; the refinements and the
// finish tail are the same and live here (the TPU kernel's
// _chroma_refine, then _finish_block).
//
// Clamp-to-edge: every stage reads its neighbours at coordinates clamped
// to the image before it looks up the stage below (Frame::at). A tile
// whose halo lies inside the image takes the same code without the
// clamps; both read the same values.

#pragma once

#include "develop_common.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kHalo = 4;
constexpr int kPitch = kTileW + 2 * kHalo;  // 40
constexpr int kRows = kTileH + 2 * kHalo;   // 24
constexpr int kCells = kPitch * kRows;
constexpr int kThreads = (kTileW / 2) * (kTileH / 2);  // one per quad
constexpr float kEps = 1e-4f;

// The tile's local frame: local (0, 0) is global (oy, ox) = the tile
// origin minus the halo; every stage buffer uses it. An INTERIOR frame
// lies inside the image, so no read needs a clamp there.
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

// The shared-memory stage buffers of one block. V: raw * scale. G, R, B:
// stages 1-2, then refinement 1 in place. XB, XR: the column passes of
// the tents over R-G and B-G.
struct Stages {
  float *V, *G, *R, *B, *XB, *XR;
};

// Loads raw * scale over the tile plus its halo, clamped to the image.
template <bool INTERIOR>
__device__ __forceinline__ void load_tile(const Stages& st,
                                          const Frame<INTERIOR>& f,
                                          const uint16_t* __restrict__ m,
                                          float s) {
  over_region(f.oy, f.ox, kHalo, kHalo, [&](int gy, int gx, int i) {
    const int y = INTERIOR ? gy : min(max(gy, 0), f.h - 1);
    const int x = INTERIOR ? gx : min(max(gx, 0), f.w - 1);
    st.V[i] =
        static_cast<float>(__ldg(m + static_cast<size_t>(y) * f.w + x)) * s;
  });
}

// Stage 3 and the finish tail, after G, R and B hold stages 1-2 over the
// tile+2 and the block has synchronised: two chroma refinements (a 3x3
// tent over R-G and B-G: column pass, then row pass, then /16; each
// channel rebuilt from its own sites), then per quad the folded edit
// stack and the store. chan_at(gy, gx, i) is the channel (0 R, 1 G, 2 B)
// of the sensor site at global (gy, gx), local index i.
template <int GAMMA, bool YCBCR, bool INTERIOR, typename ChanAt>
__device__ __forceinline__ void refine_and_finish(
    const Stages& st, const Frame<INTERIOR>& f, const float* sc, size_t img,
    int ty0, int tx0, ChanAt chan_at, uint32_t* __restrict__ rgba,
    uint8_t* __restrict__ yplane, uint8_t* __restrict__ cbcr) {
  float* const V = st.V;
  float* const G = st.G;
  float* const R = st.R;
  float* const B = st.B;
  float* const XB = st.XB;
  float* const XR = st.XR;

  // Column pass of the tent over (R-G, B-G), rows grown by `grow` and
  // columns by grow+1 (the row pass reads one column either side).
  auto column_pass = [&](int grow) {
    over_region(f.oy, f.ox, grow, grow + 1, [&](int gy, int gx, int i) {
      const int ku = f.at(i, gy, gx, -1, 0);
      const int kc = f.at(i, gy, gx, 0, 0);
      const int kd = f.at(i, gy, gx, 1, 0);
      XB[i] = ((R[ku] - G[ku]) + (R[kc] - G[kc]) * 2.0f) + (R[kd] - G[kd]);
      XR[i] = ((B[ku] - G[ku]) + (B[kc] - G[kc]) * 2.0f) + (B[kd] - G[kd]);
    });
  };
  auto row_pass = [&](const float* x, int i, int gy, int gx) {
    return ((x[f.at(i, gy, gx, 0, -1)] + x[f.at(i, gy, gx, 0, 0)] * 2.0f) +
            x[f.at(i, gy, gx, 0, 1)]) *
           0.0625f;
  };

  // 3a. Refinement 1 over the tile+1, rebuilt in place into G, R, B
  //     (this step reads only V, XB and XR).
  column_pass(1);
  __syncthreads();
  over_region(f.oy, f.ox, 1, 1, [&](int gy, int gx, int i) {
    const float cb = row_pass(XB, i, gy, gx);
    const float cr = row_pass(XR, i, gy, gx);
    const float c = V[f.at(i, gy, gx, 0, 0)];
    const int ch = chan_at(gy, gx, i);
    const float g = ch == 1 ? c : (ch == 0 ? c - cb : c - cr);
    G[i] = g;
    R[i] = ch == 0 ? c : g + cb;
    B[i] = ch == 2 ? c : g + cr;
  });
  __syncthreads();

  // 3b. Refinement 2: the column pass over the tile, then per quad the
  //     row pass, the rebuild and the finish tail.
  column_pass(0);
  __syncthreads();
  const int qx = threadIdx.x % (kTileW / 2);
  const int qy = threadIdx.x / (kTileW / 2);
  const int y0 = ty0 + 2 * qy;
  const int x0 = tx0 + 2 * qx;
  if (y0 >= f.h || x0 >= f.w) return;
  int q[2][2][3];
#pragma unroll
  for (int iy = 0; iy < 2; ++iy) {
#pragma unroll
    for (int ix = 0; ix < 2; ++ix) {
      const int gy = y0 + iy;
      const int gx = x0 + ix;
      const int i = (gy - f.oy) * kPitch + (gx - f.ox);
      const float cb = row_pass(XB, i, gy, gx);
      const float cr = row_pass(XR, i, gy, gx);
      const float c = V[f.at(i, gy, gx, 0, 0)];
      const int ch = chan_at(gy, gx, i);
      const float g = ch == 1 ? c : (ch == 0 ? c - cb : c - cr);
      finish<GAMMA>(sc, ch == 0 ? c : g + cb, g, ch == 2 ? c : g + cr,
                    q[iy][ix]);
    }
  }
  store_quad<YCBCR>(q, img, f.h, f.w, y0, x0, rgba, yplane, cbcr);
}

// True when the tile at (ty0, tx0) reads no pixel outside the (h, w)
// image (block-uniform).
__device__ __forceinline__ bool tile_is_interior(int ty0, int tx0, int h,
                                                 int w) {
  return ty0 >= kHalo && tx0 >= kHalo && ty0 + kTileH + kHalo <= h &&
         tx0 + kTileW + kHalo <= w;
}

}  // namespace
