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
// bf16 (the serving path): both convs are implicit GEMMs on the tensor
// cores, on the tile of duf_conv_mma.cuh that kernels 9 and 10 run (its head
// gives the operand roles, the shared-memory layout and the tap shift by
// ldmatrix row addresses), so this file holds no GEMM code of its own:
//   - the merge conv is that tile's kt x 3 x 3 conv with kt = T planes, the
//     T frames of a sample, VALID in T (one output plane) and G = 48 (six
//     n-tiles): M = pixels, N = 48, K = T x 9 x 64, walked as (frame, 32-
//     channel chunk, k-step, tap) with the float32 accumulators in registers
//     across the frame loop.  Frame t meets rows [64t, 64t+64) of Wm1 [3,3,
//     64T, 48] (weight row (t, tap, c) at 64 t + 64 T tap + c), so the concat
//     is never materialised.  A stage holds one frame's 32-channel window and
//     its 9 x 32 x 48 weight slice (rows padded to 56 elements, 112 bytes);
//     two full stages of a frame's 64 channels and weights would not fit
//     the SM's 227 KB.  The epilogue adds bm1, applies the leaky ReLU and
//     rounds to bf16.
//   - the fold conv (48 -> 48, 10% of the operations) is a second launch of
//     the same tile with kt = 1 on m (22 MB at a batch of 4), chunks 32 + 16
//     (the second half zero-filled), plus bf.  Fusing it with a recomputed
//     halo row of m is left for later.
//   - a block is 8 warps and a 16 x 32 pixel tile (the tile's WY = 4), 162
//     KB of shared memory, one block an SM: a weight chunk staged once feeds
//     twice the pixels that DUF's 8 x 32 tile gives it.  An input that is not
//     16-byte aligned (a view at an odd offset) takes the element-wise
//     staging instantiation.  Weights come as bf16 (Wm1 [3,3,64T,48], Wf
//     [3,3,48,48]), rounded once by the wrapper.  No atomics: bitwise
//     reproducible.
//
// float32 (training and the float32 model): the first design, float FMAs
// on CUDA cores through conv_tile.cuh, 8x16 pixel tiles, 192 threads, the
// frame loop walking Wm1's 64-row slices.  Tensor cores would mean TF32,
// which cannot hold the 1e-4 float32 check.
//
// Bound on the H100: at 180x320 the tail is 24.7 GFLOP per window (the
// 448->48 conv is 90% of it) against about 0.06 GB read in bf16:
// compute-bound (0.050 ms for [2,7,180,320,64] at 989 TFLOP/s).  Left for
// later: the fold fused into the merge launch, and wgmma with TMA-fed tiles.
#include "conv_tile.cuh"
#include "duf_conv_mma.cuh"

namespace {

using pfnl::lrelu;

constexpr int C = 64, CM = 48, TH = 8, TW = 16, PPT = 4, CPT = 8;
using MergeTile = pfnl::ConvTile<C, CM, TH, TW, PPT, CPT>;
using FoldTile = pfnl::ConvTile<CM, CM, TH, TW, PPT, CPT>;
static_assert(MergeTile::THREADS == FoldTile::THREADS, "one launch shape for both");

__global__ void __launch_bounds__(MergeTile::THREADS)
tail_merge_kernel(const float* __restrict__ feat, const float* __restrict__ wm1,
                  const float* __restrict__ bm1, float* __restrict__ m, int nt, int h, int w) {
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
      float* dst = m + ((size_t)b * h * w + (size_t)gy * w + gx) * CM + co0;
#pragma unroll
      for (int j = 0; j < CPT; ++j) dst[j] = lrelu(acc[p][j] + bm1[co0 + j]);
    }
  }
}

__global__ void __launch_bounds__(FoldTile::THREADS)
tail_fold_kernel(const float* __restrict__ m, const float* __restrict__ wf,
                 const float* __restrict__ bf, float* __restrict__ out, int h, int w) {
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
      float* dst = out + img + ((size_t)gy * w + gx) * CM + co0;
#pragma unroll
      for (int j = 0; j < CPT; ++j) dst[j] = acc[p][j] + bf[co0 + j];
    }
  }
}

int launch_f32(const float* feat, const float* wm1, const float* bm1, const float* wf,
               const float* bf, float* m, float* out, int n, int t, int h, int w,
               cudaStream_t stream) {
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), n);
  cudaFuncSetAttribute(tail_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)MergeTile::SMEM_BYTES);
  tail_merge_kernel<<<grid, MergeTile::THREADS, MergeTile::SMEM_BYTES, stream>>>(feat, wm1, bm1,
                                                                                m, t, h, w);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaFuncSetAttribute(tail_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)FoldTile::SMEM_BYTES);
  tail_fold_kernel<<<grid, FoldTile::THREADS, FoldTile::SMEM_BYTES, stream>>>(m, wf, bf, out, h,
                                                                              w);
  return (int)cudaGetLastError();
}

// The bf16 tensor-core kernels (see the head of this file).
namespace tc {

using bf16 = __nv_bfloat16;
using Tile = pfnl::ConvMma<CM, 4>;

// Block (pixel tile, sample): one output plane.  LRELU: the merge conv.
template <bool ASYNC, bool LRELU>
__global__ void __launch_bounds__(Tile::THREADS, 1)
pfnl_tail_bf16_mma_kernel(const pfnl::ConvMmaArgs p) {
  extern __shared__ __align__(16) bf16 smem_bf16[];
  pfnl::conv_mma_tile<CM, 4, ASYNC, LRELU>(p, 0, blockIdx.x, blockIdx.y, smem_bf16);
}

template <bool LRELU>
int launch_conv(const pfnl::ConvMmaArgs& p, int n, cudaStream_t stream) {
  const bool async = p.f % 8 == 0 && p.ldi % 8 == 0 &&
                     ((reinterpret_cast<uintptr_t>(p.in) | reinterpret_cast<uintptr_t>(p.wt)) & 15) == 0;
  auto k = async ? &pfnl_tail_bf16_mma_kernel<true, LRELU>
                 : &pfnl_tail_bf16_mma_kernel<false, LRELU>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::SMEM_BYTES);
  k<<<dim3(Tile::tiles(p.h, p.w), n), Tile::THREADS, Tile::SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch(const bf16* feat, const bf16* wm1, const float* bm1, const bf16* wf, const float* bf,
           bf16* m, bf16* out, int n, int t, int h, int w, cudaStream_t stream) {
  // the T frames are the planes of a VALID kt = T conv; weight row (t, tap, c) of Wm1
  // [3,3,64T,48] is 64 t + 64 T tap + c
  const pfnl::ConvMmaArgs merge{feat, t, h, w, C, C, 0, t, wm1, C, t * C, bm1, m, 1, 0, CM, 0};
  const int err = launch_conv<true>(merge, n, stream);
  if (err != 0) return err;
  // one plane, Wf [3,3,48,48]: weight row (tap, c) is 48 tap + c
  const pfnl::ConvMmaArgs fold{m, 1, h, w, CM, CM, 0, 1, wf, 0, CM, bf, out, 1, 0, CM, 0};
  return launch_conv<false>(fold, n, stream);
}

}  // namespace tc

}  // namespace

// C interface, loaded with ctypes.  feat [n,t,h,w,64] float or bf16; m
// (scratch) and out [n,h,w,48] of the same type; Wm1 [3,3,t*64,48] and Wf
// [3,3,48,48] (folded) of the activation type (float32 entry: float32),
// bm1 [48] and bf [48] (bm2 tiled over the 4 phases) float32, all rounded
// to the activation type by the caller.
extern "C" {

int pfnl_tail_f32(const void* feat, const float* wm1, const float* bm1, const float* wf,
                  const float* bf, void* m, void* out, int n, int t, int h, int w,
                  void* stream) {
  return launch_f32(static_cast<const float*>(feat), wm1, bm1, wf, bf, static_cast<float*>(m),
                    static_cast<float*>(out), n, t, h, w, static_cast<cudaStream_t>(stream));
}

int pfnl_tail_bf16(const void* feat, const void* wm1, const float* bm1, const void* wf,
                   const float* bf, void* m, void* out, int n, int t, int h, int w,
                   void* stream) {
  using tc::bf16;
  return tc::launch(static_cast<const bf16*>(feat), static_cast<const bf16*>(wm1), bm1,
                    static_cast<const bf16*>(wf), bf, static_cast<bf16*>(m),
                    static_cast<bf16*>(out), n, t, h, w, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
