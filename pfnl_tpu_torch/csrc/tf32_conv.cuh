// The 3xTF32 implicit-GEMM tile of the float32 PFRB kernels: kernels 2-3
// (pfrb.cu) and the data gradients of kernels 5-6 (pfrb_bwd.cu).  Their
// heads give the design; in short, a block of 8 warps owns an 8 x 16 pixel
// tile of one sample, a warp two tile rows (two m-tiles of 16 pixels) x 32
// output channels (four n-tiles), and a 3x3 conv is K = 9 taps x 64
// channels read from the staged (8+2) x (16+2) window, each tap another row
// address into it.  Windows and weights are float32 in shared memory,
// pixels and weight rows PS = 68 floats apart, so the eight rows (g) x four
// columns (t) of a fragment load fall on banks 4g + t, all distinct.
#pragma once

#include <cstddef>

#include "mma.cuh"

namespace pfnl {
namespace tf32 {

constexpr int C = 64, TH = 8, TW = 16;   // channels; the block's pixel tile
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int IH = TH + 2, IW = TW + 2;  // the tile's window, with the 1-pixel halo
constexpr int PS = C + 4;                // window pixel and weight-row stride (floats)
constexpr int CPP = C / 4;               // 16-byte chunks a pixel or weight row
constexpr int WIN = IH * IW * PS;        // floats of a window
constexpr int WCONV = 9 * C * PS;        // floats of a conv's weights, [tap][out][in]
constexpr int WIN_CHUNKS = IH * IW * CPP;
static_assert(WCONV % 4 == 0 && PS % 4 == 0, "16-byte aligned rows");

using DAcc = float[2][4][4];  // [m-tile: tile row][n-tile][fragment]

template <int M, int N>
__device__ __forceinline__ void zero(float (&acc)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// The tile of a block: y0, x0 of an h x w image, from blockIdx.x.
__device__ __forceinline__ void tile_origin(int w, int& y0, int& x0) {
  const int tiles_x = (w + TW - 1) / TW;
  y0 = (blockIdx.x / tiles_x) * TH;
  x0 = (blockIdx.x % tiles_x) * TW;
}

// The IH x IW window whose top-left pixel is (y0-1, x0-1) of img [h, w, 64]
// into s (pixels PS apart); pixels outside the image are zero.
template <bool ASYNC>
__device__ __forceinline__ void stage_window(float* s, const float* __restrict__ img, int h, int w,
                                             int y0, int x0, const float* any) {
  for (int i = threadIdx.x; i < WIN_CHUNKS; i += THREADS) {
    const int p = i / CPP, c = (i % CPP) * 4;
    const int gy = y0 - 1 + p / IW, gx = x0 - 1 + p % IW;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    pfnl::stage_f32x4<ASYNC>(s + p * PS + c, img + ((ptrdiff_t)gy * w + gx) * C + c, inside, any);
  }
}

// acc += sum over TAPS taps of src's pixels times s_w [TAPS][64 out][PS]
// at the warp's pixels: tile rows 2 (warp / 2) + mt, columns 0..15 of src,
// whose pixel rows are ROW pixels apart (PS floats a pixel), shifted by
// (tap / 3, tap % 3) at a 3x3 conv's tap; output channels 32 (warp % 2) +
// 8 j + 2 (lane % 4) + (e & 1) at pixel column lane / 4 + 8 (e / 2) of
// acc[mt][j][e].  The mma accumulate with truncation, so each tap sums into
// a fresh `part` (24 mma a chain), added into acc in float32 after the tap.
template <int TAPS, int ROW>
__device__ __forceinline__ void mma_taps(const float* src, const float* s_w, int warp, int lane,
                                         DAcc& acc) {
  static_assert(TAPS == 1 || TAPS == 9, "a product or a 3x3 conv");
  const int g = lane / 4, t = lane % 4;
  const float* a_row = src + (2 * (warp / 2) * ROW + g) * PS + t;
  const float* b_row = s_w + (32 * (warp % 2) + g) * PS + t;
#pragma unroll 1
  for (int tap = 0; tap < TAPS; ++tap) {
    const float* a_tap = a_row + ((tap / 3) * ROW + tap % 3) * PS;
    const float* b_tap = b_row + tap * C * PS;
    DAcc part;
    zero(part);
#pragma unroll
    for (int kk = 0; kk < C; kk += 8) {
      uint32_t b[4][2][2], a[2][2][4];  // [tile][hi, lo][register]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* bp = b_tap + 8 * j * PS + kk;  // (k t, n g), (k t+4, n g)
        pfnl::split_tf32(bp[0], b[j][0][0], b[j][1][0]);
        pfnl::split_tf32(bp[4], b[j][0][1], b[j][1][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ap = a_tap + mt * ROW * PS + kk;  // (pixel g, channel t)
        pfnl::split_tf32(ap[0], a[mt][0][0], a[mt][1][0]);
        pfnl::split_tf32(ap[8 * PS], a[mt][0][1], a[mt][1][1]);
        pfnl::split_tf32(ap[4], a[mt][0][2], a[mt][1][2]);
        pfnl::split_tf32(ap[8 * PS + 4], a[mt][0][3], a[mt][1][3]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) pfnl::mma_3xtf32(part[mt][j], a[mt], b[j]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
  }
}

// acc += the 3x3 conv of the window `win` with s_w [9][64 out][PS].
__device__ __forceinline__ void conv3x3(const float* win, const float* s_w, int warp, int lane,
                                        DAcc& acc) {
  mma_taps<9, IW>(win, s_w, warp, lane, acc);
}

}  // namespace tf32
}  // namespace pfnl
