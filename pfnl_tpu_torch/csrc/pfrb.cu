// Kernels 2 and 3: one progressive-fusion residual block (PFRB) of PFNL.
//
// Replaces the TPU kernels pfnl_tpu/ops/pallas/pfrb_pack.py:_kernel_a and
// :_kernel_b (driven by _pfrb_pack_pallas).  Those work on a column-pair
// packed, 128-lane layout and carry `base` across a sequential frame-group
// grid axis; here activations are plain contiguous channels-last
// [N,T,H,W,64] tensors and the frame loop runs inside the block.
//
//   A: i1_t = lrelu(conv3x3(feat_t, W1) + b1)             for every frame t
//      base = lrelu(sum_t i1_t @ Wfuse_t + bfuse)          once per sample
//   B: out_t = feat_t + lrelu(conv3x3(i1_t, W2f) + conv3x3(base, W2b) + b2)
//
// One block per (sample, 8x16 pixel tile), 256 threads.  Kernel A keeps the
// fusion sum of its tile in registers across the frame loop, so `base`
// needs no reduction across blocks; the rounded i1_t tile goes through
// shared memory to feed the fusion product.  Kernel B computes the base
// conv once into registers and adds it to each frame's conv.  `out` is a
// separate buffer: blocks read feat's halo rows that neighbouring blocks
// would otherwise overwrite.  i1, base and out are rounded to the
// activation type exactly where the plain version rounds them.
//
// Bound on the H100: at the main path's geometry (180x320, 7 frames) one
// PFRB is 15 3x3 convs of 64->64 channels per sample plus the fusion, about
// 67 GFLOP, 1.34 TFLOP for the 20 blocks of a window, against about
// 0.2 GB of activations per block: compute-bound.  This simple design runs
// float FMAs on CUDA cores (67 TFLOP/s peak), not the tensor cores
// (989 TFLOP/s bf16).  Left for later: an implicit-GEMM form on
// wgmma/mma.sync with TMA-fed tiles, and fusing B of block k with A of
// block k+1.
#include "conv_tile.cuh"

namespace {

using pfnl::from_f32;
using pfnl::lrelu;
using pfnl::round_to;
using pfnl::to_f32;

constexpr int C = 64, TH = 8, TW = 16, PPT = 4, CPT = 8;
using Tile = pfnl::ConvTile<C, C, TH, TW, PPT, CPT>;

template <typename T>
__global__ void __launch_bounds__(Tile::THREADS)
pfrb_a_kernel(const T* __restrict__ feat, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ wfuse,
              const float* __restrict__ bfuse, T* __restrict__ i1, T* __restrict__ base,
              int nt, int h, int w) {
  extern __shared__ float smem[];
  float* s_in = smem;
  float* s_w = smem + Tile::IN_FLOATS;
  const int tiles_x = (w + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int b = blockIdx.y;
  const int co0 = Tile::cg() * CPT, py = Tile::py(), px = Tile::px();
  const int gy = y0 + py;
  const size_t plane = (size_t)h * w * C;

  float bacc[PPT][CPT] = {};
  for (int t = 0; t < nt; ++t) {
    const size_t img = ((size_t)b * nt + t) * plane;
    __syncthreads();  // the previous frame's fusion reads of s_in are done
    Tile::load_input(s_in, feat + img, h, w, C, y0, x0);
    float acc[PPT][CPT] = {};
    Tile::conv3x3(s_in, s_w, w1, (size_t)C * C, C, acc);

    float v[PPT][CPT];
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int gx = x0 + px + p;
#pragma unroll
      for (int j = 0; j < CPT; ++j) v[p][j] = round_to<T>(lrelu(acc[p][j] + b1[co0 + j]));
      if (gy < h && gx < w) {
        T* dst = i1 + img + ((size_t)gy * w + gx) * C + co0;
#pragma unroll
        for (int j = 0; j < CPT; ++j) dst[j] = from_f32<T>(v[p][j]);
      }
    }
    __syncthreads();  // every thread is done with this frame's conv
    // the i1 tile, [TH*TW pixels][C], over the input window's storage
#pragma unroll
    for (int p = 0; p < PPT; ++p)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s_in[(py * TW + px + p) * Tile::CS + co0 + j] = v[p][j];
    Tile::load_weights(s_w, wfuse + (size_t)t * C * C, C);
    __syncthreads();
    Tile::accumulate(s_in, TW, 0, 0, s_w, bacc);
  }

#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int gx = x0 + px + p;
    if (gy < h && gx < w) {
      T* dst = base + (size_t)b * plane + ((size_t)gy * w + gx) * C + co0;
#pragma unroll
      for (int j = 0; j < CPT; ++j) dst[j] = from_f32<T>(lrelu(bacc[p][j] + bfuse[co0 + j]));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Tile::THREADS)
pfrb_b_kernel(const T* __restrict__ feat, const T* __restrict__ i1, const T* __restrict__ base,
              const float* __restrict__ w2f, const float* __restrict__ w2b,
              const float* __restrict__ b2, T* __restrict__ out, int nt, int h, int w) {
  extern __shared__ float smem[];
  float* s_in = smem;
  float* s_w = smem + Tile::IN_FLOATS;
  const int tiles_x = (w + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int b = blockIdx.y;
  const int co0 = Tile::cg() * CPT, py = Tile::py(), px = Tile::px();
  const int gy = y0 + py;
  const size_t plane = (size_t)h * w * C;

  float bacc[PPT][CPT] = {};
  Tile::load_input(s_in, base + (size_t)b * plane, h, w, C, y0, x0);
  Tile::conv3x3(s_in, s_w, w2b, (size_t)C * C, C, bacc);

  for (int t = 0; t < nt; ++t) {
    const size_t img = ((size_t)b * nt + t) * plane;
    __syncthreads();  // the previous conv's reads of s_in are done
    Tile::load_input(s_in, i1 + img, h, w, C, y0, x0);
    float acc[PPT][CPT] = {};
    Tile::conv3x3(s_in, s_w, w2f, (size_t)C * C, C, acc);
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int gx = x0 + px + p;
      if (gy < h && gx < w) {
        const size_t at = img + ((size_t)gy * w + gx) * C + co0;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float i2 = lrelu(acc[p][j] + bacc[p][j] + b2[co0 + j]);
          out[at + j] = from_f32<T>(to_f32(feat[at + j]) + i2);
        }
      }
    }
  }
}

template <typename T>
int launch_a(const void* feat, const float* w1, const float* b1, const float* wfuse,
             const float* bfuse, void* i1, void* base, int n, int t, int h, int w,
             cudaStream_t stream) {
  auto k = pfrb_a_kernel<T>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::SMEM_BYTES);
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), n);
  k<<<grid, Tile::THREADS, Tile::SMEM_BYTES, stream>>>(
      static_cast<const T*>(feat), w1, b1, wfuse, bfuse, static_cast<T*>(i1),
      static_cast<T*>(base), t, h, w);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_b(const void* feat, const void* i1, const void* base, const float* w2f,
             const float* w2b, const float* b2, void* out, int n, int t, int h, int w,
             cudaStream_t stream) {
  auto k = pfrb_b_kernel<T>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::SMEM_BYTES);
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), n);
  k<<<grid, Tile::THREADS, Tile::SMEM_BYTES, stream>>>(
      static_cast<const T*>(feat), static_cast<const T*>(i1), static_cast<const T*>(base), w2f,
      w2b, b2, static_cast<T*>(out), t, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Activations [n,t,h,w,64] (base
// [n,h,w,64]) of float or bf16; weights and biases float32, already rounded
// to the activation type by the caller: W1/W2f/W2b [3,3,64,64] (HWIO),
// Wfuse [t,64,64].  Returns cudaGetLastError() after the launch.
extern "C" {

int pfnl_pfrb_a_f32(const void* feat, const float* w1, const float* b1, const float* wfuse,
                    const float* bfuse, void* i1, void* base, int n, int t, int h, int w,
                    void* stream) {
  return launch_a<float>(feat, w1, b1, wfuse, bfuse, i1, base, n, t, h, w,
                         static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_a_bf16(const void* feat, const float* w1, const float* b1, const float* wfuse,
                     const float* bfuse, void* i1, void* base, int n, int t, int h, int w,
                     void* stream) {
  return launch_a<__nv_bfloat16>(feat, w1, b1, wfuse, bfuse, i1, base, n, t, h, w,
                                 static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_b_f32(const void* feat, const void* i1, const void* base, const float* w2f,
                    const float* w2b, const float* b2, void* out, int n, int t, int h, int w,
                    void* stream) {
  return launch_b<float>(feat, i1, base, w2f, w2b, b2, out, n, t, h, w,
                         static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_b_bf16(const void* feat, const void* i1, const void* base, const float* w2f,
                     const float* w2b, const float* b2, void* out, int n, int t, int h, int w,
                     void* stream) {
  return launch_b<__nv_bfloat16>(feat, i1, base, w2f, w2b, b2, out, n, t, h, w,
                                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
