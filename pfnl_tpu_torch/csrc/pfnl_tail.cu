// Kernel 4: the PFNL merge tail on the LR grid.
//
// Replaces the TPU kernel pfnl_tpu/ops/pallas/pfnl_tail.py:pfnl_tail_pack
// (_kernel), which reads the chain's column-pair packed buffer and
// recomputes a halo row of the merge activation per row tile.  Here the
// input is the plain [N,T,H,W,64] chain output and the tail runs as two
// launches from one entry point, with the 48-channel merge map `m` in
// device memory between them:
//
//   1. m   = lrelu(conv3x3(concat_t feat_t, Wm1) + bm1)         448 -> 48
//   2. out = conv3x3(m, Wf) + bf                                 48 -> 48
//
// Wf is convmerge2 folded onto the LR grid (fold_d2s_conv in
// ops/pfrb_ref.py), so the 2x intermediate of the reference never exists;
// the output is the folded [N,H,W,48] map (channel (pr*2+pc)*12 + c12)
// that pfnl_tail_pack writes.  m is rounded to the activation type, as
// both the TPU kernel and the plain version round it.
//
// Bound on the H100: at 180x320 the tail is about 25 GFLOP per window
// (the 448->48 conv is 90% of it) against about 0.06 GB read in bf16:
// compute-bound.
// The simple design runs float FMAs on CUDA cores, 8x16 pixel tiles, 192
// threads, the concat never materialised (the frame loop walks Wm1's
// 64-row slices).  Left for later: tensor-core products, and keeping m in
// shared memory with a recomputed halo so the tail is one launch.
#include "conv_tile.cuh"

namespace {

using pfnl::from_f32;
using pfnl::lrelu;

constexpr int C = 64, CM = 48, TH = 8, TW = 16, PPT = 4, CPT = 8;
using MergeTile = pfnl::ConvTile<C, CM, TH, TW, PPT, CPT>;
using FoldTile = pfnl::ConvTile<CM, CM, TH, TW, PPT, CPT>;
static_assert(MergeTile::THREADS == FoldTile::THREADS, "one launch shape for both");

template <typename T>
__global__ void __launch_bounds__(MergeTile::THREADS)
tail_merge_kernel(const T* __restrict__ feat, const float* __restrict__ wm1,
                  const float* __restrict__ bm1, T* __restrict__ m, int nt, int h, int w) {
  extern __shared__ float smem[];
  float* s_in = smem;
  float* s_w = smem + MergeTile::IN_FLOATS;
  const int tiles_x = (w + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int b = blockIdx.y;
  const int co0 = MergeTile::cg() * CPT, gy = y0 + MergeTile::py(), px = MergeTile::px();
  const size_t plane = (size_t)h * w * C;

  float acc[PPT][CPT] = {};
  for (int t = 0; t < nt; ++t) {
    __syncthreads();  // the previous frame's conv reads of s_in are done
    MergeTile::load_input(s_in, feat + ((size_t)b * nt + t) * plane, h, w, C, y0, x0);
    // frame t meets rows [t*64, t*64+64) of Wm1 [3,3,nt*64,48]
    MergeTile::conv3x3(s_in, s_w, wm1 + (size_t)t * C * CM, (size_t)nt * C * CM, CM, acc);
  }
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int gx = x0 + px + p;
    if (gy < h && gx < w) {
      T* dst = m + ((size_t)b * h * w + (size_t)gy * w + gx) * CM + co0;
#pragma unroll
      for (int j = 0; j < CPT; ++j) dst[j] = from_f32<T>(lrelu(acc[p][j] + bm1[co0 + j]));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(FoldTile::THREADS)
tail_fold_kernel(const T* __restrict__ m, const float* __restrict__ wf,
                 const float* __restrict__ bf, T* __restrict__ out, int h, int w) {
  extern __shared__ float smem[];
  float* s_in = smem;
  float* s_w = smem + FoldTile::IN_FLOATS;
  const int tiles_x = (w + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const size_t img = (size_t)blockIdx.y * h * w * CM;
  const int co0 = FoldTile::cg() * CPT, gy = y0 + FoldTile::py(), px = FoldTile::px();

  FoldTile::load_input(s_in, m + img, h, w, CM, y0, x0);
  float acc[PPT][CPT] = {};
  FoldTile::conv3x3(s_in, s_w, wf, (size_t)CM * CM, CM, acc);
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int gx = x0 + px + p;
    if (gy < h && gx < w) {
      T* dst = out + img + ((size_t)gy * w + gx) * CM + co0;
#pragma unroll
      for (int j = 0; j < CPT; ++j) dst[j] = from_f32<T>(acc[p][j] + bf[co0 + j]);
    }
  }
}

template <typename T>
int launch_tail(const void* feat, const float* wm1, const float* bm1, const float* wf,
                const float* bf, void* m, void* out, int n, int t, int h, int w,
                cudaStream_t stream) {
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), n);
  auto k1 = tail_merge_kernel<T>;
  cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)MergeTile::SMEM_BYTES);
  k1<<<grid, MergeTile::THREADS, MergeTile::SMEM_BYTES, stream>>>(
      static_cast<const T*>(feat), wm1, bm1, static_cast<T*>(m), t, h, w);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto k2 = tail_fold_kernel<T>;
  cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)FoldTile::SMEM_BYTES);
  k2<<<grid, FoldTile::THREADS, FoldTile::SMEM_BYTES, stream>>>(
      static_cast<const T*>(m), wf, bf, static_cast<T*>(out), h, w);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  feat [n,t,h,w,64] float or bf16; m
// (scratch) and out [n,h,w,48] of the same type; weights float32, already
// rounded to the activation type: Wm1 [3,3,t*64,48], bm1 [48], Wf
// [3,3,48,48] (folded), bf [48] (bm2 tiled over the 4 phases).
extern "C" {

int pfnl_tail_f32(const void* feat, const float* wm1, const float* bm1, const float* wf,
                  const float* bf, void* m, void* out, int n, int t, int h, int w,
                  void* stream) {
  return launch_tail<float>(feat, wm1, bm1, wf, bf, m, out, n, t, h, w,
                            static_cast<cudaStream_t>(stream));
}

int pfnl_tail_bf16(const void* feat, const float* wm1, const float* bm1, const float* wf,
                   const float* bf, void* m, void* out, int n, int t, int h, int w,
                   void* stream) {
  return launch_tail<__nv_bfloat16>(feat, wm1, bm1, wf, bf, m, out, n, t, h, w,
                                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
