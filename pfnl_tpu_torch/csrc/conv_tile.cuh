// Direct 3x3 SAME convolution of one TH x TW pixel tile, channels-last, on
// CUDA cores with float accumulation: the building block of the float32
// entries of kernels 2-4 (pfrb.cu, pfnl_tail.cu).
//
// The block stages the tile's input with its 1-pixel halo in shared memory
// (zero outside the image, which is the SAME padding) and one 3x3 tap of
// weights at a time; each thread owns PPT horizontally adjacent pixels x
// CPT adjacent output channels, so a loaded input value feeds CPT FMAs and
// a loaded weight PPT.  The shared-memory channel stride is CIN+1 (odd):
// the pixel groups of one warp then read distinct banks.
#pragma once

#include "common.cuh"

namespace pfnl {

template <int CIN, int COUT, int TH, int TW, int PPT, int CPT>
struct ConvTile {
  static_assert(COUT % CPT == 0 && TW % PPT == 0, "tile must split evenly");
  static constexpr int NCG = COUT / CPT;  // output-channel groups
  static constexpr int TPR = TW / PPT;    // pixel groups per tile row
  static constexpr int NPG = TH * TPR;    // pixel groups
  static constexpr int THREADS = NCG * NPG;
  static constexpr int IH = TH + 2, IW = TW + 2;
  static constexpr int CS = CIN + 1;
  static constexpr int IN_FLOATS = IH * IW * CS;
  static constexpr int W_FLOATS = CIN * COUT;
  static constexpr size_t SMEM_BYTES = (IN_FLOATS + W_FLOATS) * sizeof(float);

  // This thread's output channels start at cg()*CPT; its pixels are row
  // py(), columns px()..px()+PPT-1 of the tile.
  __device__ static int cg() { return threadIdx.x % NCG; }
  __device__ static int py() { return (threadIdx.x / NCG) / TPR; }
  __device__ static int px() { return ((threadIdx.x / NCG) % TPR) * PPT; }

  // Stage the (TH+2)x(TW+2) input window whose top-left pixel is
  // (y0-1, x0-1) of an [h, w, ld] image (ld = channels between pixels;
  // the first CIN are read).
  template <typename T>
  __device__ static void load_input(float* s_in, const T* __restrict__ img, int h, int w,
                                    int ld, int y0, int x0) {
    for (int i = threadIdx.x; i < IH * IW * CIN; i += THREADS) {
      const int c = i % CIN, p = i / CIN;
      const int gy = y0 - 1 + p / IW, gx = x0 - 1 + p % IW;
      float v = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = to_f32(img[((size_t)gy * w + gx) * ld + c]);
      s_in[p * CS + c] = v;
    }
  }

  // Stage a [CIN, COUT] weight slice whose rows are ldw floats apart.
  __device__ static void load_weights(float* s_w, const float* __restrict__ wt, int ldw) {
    for (int i = threadIdx.x; i < CIN * COUT; i += THREADS)
      s_w[i] = wt[(size_t)(i / COUT) * ldw + i % COUT];
  }

  // acc[p][j] += sum_ci in[py+dy, px+p+dx, ci] * w[ci, cg*CPT+j], reading an
  // input staged with `row` pixels per row.
  __device__ static void accumulate(const float* s_in, int row, int dy, int dx,
                                    const float* s_w, float (&acc)[PPT][CPT]) {
    const float* in0 = s_in + ((py() + dy) * row + px() + dx) * CS;
    const float* w0 = s_w + cg() * CPT;
#pragma unroll 4
    for (int ci = 0; ci < CIN; ++ci) {
      float wv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) wv[j] = w0[ci * COUT + j];
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        const float xv = in0[p * CS + ci];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[p][j] = fmaf(xv, wv[j], acc[p][j]);
      }
    }
  }

  // The 3x3 conv of the staged input: kernel taps are tap_stride floats
  // apart, each a [CIN, COUT] slice with rows ldw floats apart.  Begins
  // with a barrier, so the caller's load_input needs none of its own.
  __device__ static void conv3x3(const float* s_in, float* s_w, const float* __restrict__ wt,
                                 size_t tap_stride, int ldw, float (&acc)[PPT][CPT]) {
    for (int tap = 0; tap < 9; ++tap) {
      __syncthreads();
      load_weights(s_w, wt + tap * tap_stride, ldw);
      __syncthreads();
      accumulate(s_in, IW, tap / 3, tap % 3, s_w, acc);
    }
  }
};

}  // namespace pfnl
