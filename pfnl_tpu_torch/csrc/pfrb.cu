// Kernels 2 and 3: one progressive-fusion residual block (PFRB) of PFNL.
//
// Replaces the TPU kernels pfnl_tpu/ops/pallas/pfrb_pack.py:_kernel_a and
// :_kernel_b (driven by _pfrb_pack_pallas, the pallas_calls at :313 and
// :330).  Those work on a column-pair packed, 128-lane layout and carry
// `base` across a sequential frame-group grid axis; here activations are
// plain contiguous channels-last [N,T,H,W,64] tensors and the frame loop
// runs inside the block, so `base` needs no reduction across blocks.
//
//   A: i1_t = lrelu(conv3x3(feat_t, W1) + b1)             for every frame t
//      base = lrelu(sum_t i1_t @ Wfuse_t + bfuse)          once per sample
//   B: out_t = feat_t + lrelu(conv3x3(i1_t, W2f) + conv3x3(base, W2b) + b2)
//
// `out` is a separate buffer: blocks read feat's halo rows that neighbouring
// blocks would otherwise overwrite.  i1, base and out are rounded once to
// the activation type; the sums run in float32.
//
// Bound on the H100 at the serving geometry (batch 4 of 7-frame windows at
// LR 180x320, [4,7,180,320,64]; benchmark/counts/ops.py): kernel A does 9 + 1
// products of 64x64 per pixel and frame, 132 GFLOP (0.134 ms at 989 TFLOP/s
// bf16), against 442 MB of bf16 activations moved (0.132 ms at 3.35 TB/s):
// operations, barely.  Kernel B does 9 products over T + 1 images, 136 GFLOP
// (0.137 ms) against 649 MB (0.194 ms): bytes.  At 4K (LR 540x960) nine times
// each.  float32 at the training shape ([16,7,32,32,64]): A 9.40 and B 9.66
// GFLOP, three TF32 products a float32 one at 495 TFLOP/s, 0.057 and 0.059 ms,
// against 63 and 92 MB (0.019 and 0.028 ms): operations.
//
// bf16 (the serving path; the `wg` namespace): a warp-specialised implicit
// GEMM on Hopper's warpgroup tensor cores (wgmma, float32 accumulation;
// wgmma.cuh), fed by tensor-map copies (TMA).
//   - M = the 64 pixels of one output row, N = the 64 output channels, K = 9
//     taps x 64 channels: a conv is 36 wgmma m64n64k16.  A block is two
//     consumer warpgroups, one output row each (a 2 x 64 pixel tile), and a
//     producer warpgroup of which one thread issues the copies.  Blocks are
//     persistent, one an SM, and take the tiles in turn.
//   - A 64-channel bf16 pixel is one 128-byte swizzle row, so a tile's window
//     (4 x 66 pixels, one copy of a 5-D tensor map with the 128-byte swizzle)
//     is the A operand of every tap as it lies: tap (dh, dw) is the same
//     descriptor started dh rows and dw pixels (128 bytes each) further.  The
//     swizzle is taken on the address bits, so no base offset is needed.  The
//     map's zero fill outside the tensor gives the halo and the ragged edge.
//   - The HWIO weights are the B operand as they lie: MN-major (rows of 64
//     output channels), swizzled by their own tensor-map copy, a k-step 16
//     rows further.  A conv's 72 KB stay in shared memory for the whole block.
//   - Kernel A: a ring of 3 stages, frame t's window and Wfuse_t in each.  A
//     warpgroup's conv, then its epilogue (+b1, lrelu, round once) packs
//     i1_t as bf16 pairs that are at once the A fragments of base_acc +=
//     i1_t @ Wfuse_t (wgmma with A from registers, left in flight behind the
//     next frame's conv) and, staged by stmatrix, the row that a tensor-map
//     store writes to i1.  base_acc stays in float32 across the frame loop;
//     base is rounded once and stored the same way.
//   - Kernel B: W2b and W2f both resident, which leaves room for a ring of 2
//     windows (base's, then each frame's i1), each given back as soon as both
//     convs have read it.  conv3x3(base, W2b) once a tile into float32
//     registers; per frame conv3x3(i1_t, W2f), while feat_t's row comes by a
//     tensor-map copy into the warpgroup's staging; out_t = feat_t + lrelu(conv
//     + base conv + b2), feat_t read there by ldmatrix and added in float32, is
//     written over it, rounded once, and stored.  The block takes all 232,448
//     bytes, its barriers in the alignment slack.
//   - Turns: a warpgroup issues its conv only after the other has issued its
//     own (named barriers), so one's epilogue runs while the other's products
//     do.  No atomics, every sum in a fixed order: bitwise reproducible.
//   - Reached on an H100 at its 700 W limit (PERF.md, section 6): K2 0.211-0.213
//     ms (63% of its bound), K3 0.272-0.278 ms (70-71%) at [4,7,180,320], 2.0x
//     and 1.8-1.9x the mma.sync body; run back to back at 4K they hold the
//     card at that power limit, the SM clock near 1.56 GHz, and the kernel
//     after them takes as many cycles as alone but more time (an in-kernel
//     clock probe; PERF.md, section 7).
//     What holds them: wgmma m64n64k16 issued by two warpgroups tops out at
//     72% of the tensor peak on this card (three reach 95%: a
//     microbenchmark), but a third warpgroup's window stages do not fit beside
//     the weights (tiles of 3 and 4 rows on 2 stages measured slower); kernel B
//     has one window copy in flight while it computes the other.
//   - Views a tensor map cannot describe (not 16-byte aligned) keep the
//     mma.sync body of the `tc` namespace: 8 warps, an 8 x 32 tile, windows
//     double-buffered by cp.async (element-wise for an unaligned view), the
//     conv's weights resident with rows padded to 144 bytes, i1's fusion from
//     the accumulator's registers as here.  The op chooses by alignment
//     (ops/cuda/pfrb.py, `entry`), and no benchmark cell runs that body.
// Left for later: a third consumer warpgroup (window stages smaller, or kernel
// B's weights out of shared memory), fusing B of block k with A of block k+1
// (i1 and base never leave the chip), and a CUDA graph over the chain.
//
// float32 (training and the float32 model; the `tf32` namespace): 3xTF32
// on the tensor cores, on the implicit-GEMM tile of kernels 5-6's data
// gradients (tf32_conv.cuh).
//   - Arithmetic: mma.sync m16n8k8 TF32 with float32 accumulation.  Each
//     operand is split in registers after its fragment load into hi + lo,
//     both TF32 by cvt.rna's rule (mma.cuh), and a k-step runs lo*hi,
//     hi*lo, then hi*hi.  Each tap of a conv, and each frame's fusion
//     product, sums into a fresh accumulator that is then added to the
//     running total in float32 (the mma truncate, a bias that grows with a
//     chain).  One TF32 product instead lands about 3e-4 of max|plain|
//     off, over the 1e-4 check, and 2e-6 to 4e-5 off on pfnl.train's first
//     loss (limit 5e-7): a lower precision, not a faster kernel.
//   - The tile: M = the 8 x 16 pixels of the block's tile, N = 64 output
//     channels, K = 9 taps x 64 channels; 8 warps, a warp two tile rows x
//     32 channels.  The conv's HWIO weights are transposed while staged (a
//     4-byte cp.async an element) to [tap][out][in], rows padded to 68
//     floats, and stay resident for the whole frame loop; the (8+2) x
//     (16+2) window is staged by cp.async (src-size 0 outside the image),
//     single-buffered, pixels 68 floats apart: fragment loads are free of
//     bank conflicts.  At the training shape ([16,7,32,32,64]) the grid is
//     128 blocks on 132 SMs, one wave; at 720p about 14 waves.
//   - Kernel A, per frame: i1_t = lrelu(conv(feat_t, W1) + b1) is stored,
//     then written over the window as a [128 pixel][68] tile, from which
//     base_acc += i1_t @ Wfuse_t runs as a one-tap GEMM (Wfuse_t staged
//     transposed with the frame's window).  base_acc stays in float32
//     across the frames; lrelu(+ bfuse) once at the end.  Shared memory:
//     156,672 B of W1 + 48,960 B of window + 17,408 B of Wfuse_t = 223,040
//     B of the 232,448 an SM gives a block.
//   - Kernel B: conv(base, W2b) once into float32 registers; then W2f takes
//     W2b's shared memory, and per frame conv(i1_t, W2f) + that + b2,
//     lrelu, + feat_t, one store.  205,632 B of shared memory.
//   - 174-202 registers a thread, no spills (kernel B 174 / 187, kernel A
//     187 / 202, element-wise / cp.async staging; ptxas on the card).
//   - What still holds them back (no ncu on the card, so inferred): they
//     reach about 30% of the 3xTF32 rate (K5/K6's tile does about as
//     well); a k-step of a warp needs 16 ld.shared and 16 splits beside its
//     24 mma, with two warps a sub-partition to hide their latency; every
//     frame waits on its window (a second one does not fit beside the
//     weights); kernel A's i1 tile costs two more barriers a frame, and
//     kernel B stages W2f only after the base conv.  wgmma with operands
//     split once into shared memory is the next design.
//   - No atomics, every sum in a fixed order: bitwise reproducible.
#include <atomic>

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"
#include "mma.cuh"
#include "tf32_conv.cuh"
#include "wgmma.cuh"

namespace {

using pfnl::lrelu;

constexpr int C = 64;

// The float32 kernels on the tensor cores, 3xTF32 (see the head of this file).
namespace tf32 {

using namespace pfnl::tf32;  // the conv tile (tf32_conv.cuh)

constexpr int WFUSE = C * PS;  // floats of one frame's fusion weights, [out][in]
constexpr size_t SMEM_A = (size_t)(WCONV + WIN + WFUSE) * sizeof(float);
constexpr size_t SMEM_B = (size_t)(WCONV + WIN) * sizeof(float);
static_assert(SMEM_A <= 232448 && TH * TW * PS <= WIN, "an SM's shared memory; the i1 tile");

// `taps` HWIO slices [64 in][64 out] of wt into s as [taps][64 out][PS],
// transposed while staged, by 4-byte cp.async.  A warp's 32 lanes copy 4
// input x 8 output channels: four 32-byte runs of device memory, and
// shared-memory banks 4 (out) + in, all distinct.
__device__ __forceinline__ void stage_weights_t(float* s, const float* __restrict__ wt, int taps) {
  for (int i = threadIdx.x; i < taps * C * C; i += THREADS) {
    const int tap = i / (C * C), q = (i % (C * C)) / 32, l = i % 32;
    const int ci = (q % (C / 4)) * 4 + l % 4, co = (q / (C / 4)) * 8 + l / 4;
    pfnl::cp_async_f32(s + (tap * C + co) * PS + ci, wt + ((size_t)tap * C + ci) * C + co);
  }
}

// f(at, v0, v1) for each pair of channels of acc at the warp's pixels
// inside the h x w image of the tile at (y0, x0): at = the offset of the
// pair's first channel in an [h, w, 64] image.
template <typename F>
__device__ __forceinline__ void each_pair(const DAcc& acc, int y0, int x0, int h, int w, int warp,
                                          int lane, F f) {
  const int c0 = 32 * (warp % 2) + 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int gy = y0 + 2 * (warp / 2) + mt;
    if (gy >= h) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + lane / 4 + 8 * half;
      if (gx >= w) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f(((size_t)gy * w + gx) * C + c0 + 8 * j, acc[mt][j][2 * half], acc[mt][j][2 * half + 1]);
    }
  }
}

// acc = lrelu(acc + bias), channel by channel.
__device__ __forceinline__ void bias_lrelu(DAcc& acc, const float* __restrict__ bias, int warp,
                                           int lane) {
  const int c0 = 32 * (warp % 2) + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float bc[2] = {bias[c0 + 8 * j], bias[c0 + 8 * j + 1]};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = lrelu(acc[mt][j][e] + bc[e & 1]);
  }
}

template <bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1)
pfrb_a_tf32_mma_kernel(const float* __restrict__ feat, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ wfuse,
                       const float* __restrict__ bfuse, float* __restrict__ i1,
                       float* __restrict__ base, int nt, int h, int w) {
  extern __shared__ __align__(16) float smem16[];
  float* s_w = smem16;          // W1 [9][64 out][PS]
  float* s_win = s_w + WCONV;   // frame t's window, then its i1 tile [TH * TW][PS]
  float* s_wf = s_win + WIN;    // Wfuse_t [64 out][PS]
  int y0, x0;
  tile_origin(w, y0, x0);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t plane = (size_t)h * w * C;

  stage_weights_t(s_w, w1, 9);
  DAcc bacc;
  zero(bacc);
  for (int t = 0; t < nt; ++t) {
    const size_t img = ((size_t)b * nt + t) * plane;
    stage_window<ASYNC>(s_win, feat + img, h, w, y0, x0, feat);
    stage_weights_t(s_wf, wfuse + (size_t)t * C * C, 1);
    pfnl::cp_async_commit();
    pfnl::cp_async_wait<0>();
    __syncthreads();
    DAcc acc;
    zero(acc);
    conv3x3(s_win, s_w, warp, lane, acc);
    bias_lrelu(acc, b1, warp, lane);
    float* i1_t = i1 + img;
    each_pair(acc, y0, x0, h, w, warp, lane, [&](size_t at, float v0, float v1) {
      *reinterpret_cast<float2*>(i1_t + at) = make_float2(v0, v1);
    });
    __syncthreads();  // every warp is done with the window
    // the i1 tile over the window, pixel (row, column) at (row * TW + column) * PS: all of
    // its pixels, those outside the image too (a GEMM row feeds only its own output row)
    const int c0 = 32 * (warp % 2) + 2 * (lane % 4);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(s_win + ((2 * (warp / 2) + mt) * TW + lane / 4 + 8 * half) * PS +
                                     c0 + 8 * j) =
              make_float2(acc[mt][j][2 * half], acc[mt][j][2 * half + 1]);
    __syncthreads();
    mma_taps<1, TW>(s_win, s_wf, warp, lane, bacc);  // base_acc += i1_t @ Wfuse_t
    __syncthreads();  // every warp is done with the tile and Wfuse_t before they are refilled
  }

  bias_lrelu(bacc, bfuse, warp, lane);
  float* base_b = base + (size_t)b * plane;
  each_pair(bacc, y0, x0, h, w, warp, lane, [&](size_t at, float v0, float v1) {
    *reinterpret_cast<float2*>(base_b + at) = make_float2(v0, v1);
  });
}

template <bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1)
pfrb_b_tf32_mma_kernel(const float* __restrict__ feat, const float* __restrict__ i1,
                       const float* __restrict__ base, const float* __restrict__ w2f,
                       const float* __restrict__ w2b, const float* __restrict__ b2,
                       float* __restrict__ out, int nt, int h, int w) {
  extern __shared__ __align__(16) float smem16[];
  float* s_w = smem16;          // W2b, then W2f [9][64 out][PS]
  float* s_win = s_w + WCONV;
  int y0, x0;
  tile_origin(w, y0, x0);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t plane = (size_t)h * w * C;

  stage_weights_t(s_w, w2b, 9);
  stage_window<ASYNC>(s_win, base + (size_t)b * plane, h, w, y0, x0, base);
  pfnl::cp_async_commit();
  pfnl::cp_async_wait<0>();
  __syncthreads();
  DAcc bacc;
  zero(bacc);
  conv3x3(s_win, s_w, warp, lane, bacc);
  __syncthreads();  // W2b and base's window are read
  stage_weights_t(s_w, w2f, 9);  // lands with frame 0's window

  for (int t = 0; t < nt; ++t) {
    const size_t img = ((size_t)b * nt + t) * plane;
    stage_window<ASYNC>(s_win, i1 + img, h, w, y0, x0, i1);
    pfnl::cp_async_commit();
    pfnl::cp_async_wait<0>();
    __syncthreads();
    DAcc acc;
    zero(acc);
    conv3x3(s_win, s_w, warp, lane, acc);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += bacc[mt][j][e];
    bias_lrelu(acc, b2, warp, lane);
    const float* feat_t = feat + img;
    float* out_t = out + img;
    each_pair(acc, y0, x0, h, w, warp, lane, [&](size_t at, float v0, float v1) {
      float f0, f1;
      if constexpr (ASYNC) {  // 16-byte aligned: one 8-byte load
        const float2 f = *reinterpret_cast<const float2*>(feat_t + at);
        f0 = f.x;
        f1 = f.y;
      } else {
        f0 = feat_t[at];
        f1 = feat_t[at + 1];
      }
      *reinterpret_cast<float2*>(out_t + at) = make_float2(f0 + v0, f1 + v1);
    });
    __syncthreads();  // every warp is done with the window before it is refilled
  }
}

int launch_a(const float* feat, const float* w1, const float* b1, const float* wfuse,
             const float* bfuse, float* i1, float* base, int n, int t, int h, int w,
             cudaStream_t stream) {
  auto k = pfnl::aligned16({feat}) ? &pfrb_a_tf32_mma_kernel<true> : &pfrb_a_tf32_mma_kernel<false>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_A);
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), n);
  k<<<grid, THREADS, SMEM_A, stream>>>(feat, w1, b1, wfuse, bfuse, i1, base, t, h, w);
  return (int)cudaGetLastError();
}

int launch_b(const float* feat, const float* i1, const float* base, const float* w2f,
             const float* w2b, const float* b2, float* out, int n, int t, int h, int w,
             cudaStream_t stream) {
  auto k = pfnl::aligned16({feat, i1, base}) ? &pfrb_b_tf32_mma_kernel<true>
                                             : &pfrb_b_tf32_mma_kernel<false>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_B);
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), n);
  k<<<grid, THREADS, SMEM_B, stream>>>(feat, i1, base, w2f, w2b, b2, out, t, h, w);
  return (int)cudaGetLastError();
}

}  // namespace tf32

// The bf16 tensor-core kernels (see the head of this file).
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int TH = WARPS, TW = 32;       // block tile: one output row of 32 pixels a warp
constexpr int IH = TH + 2, IW = TW + 2;  // its input window, with the 1-pixel halo
constexpr int PS = C + 8;                // pixel stride in a window (144 bytes)
constexpr int WS = C + 8;                // weight-row stride (144 bytes)
constexpr int MT = TW / 16;              // m-tiles of a warp: 16 pixels of its row each
constexpr int NT = C / 8;                // n-tiles: 8 output channels each
constexpr int KS = C / 16;               // k-steps of 16 input channels a tap
constexpr int CPP = C / 8;               // 16-byte chunks a pixel or weight row
constexpr int WIN = IH * IW * PS;        // elements of a window
constexpr int WCONV = 9 * C * WS;        // elements of a conv's weights
constexpr int WFUSE = C * WS;            // elements of one frame's fusion weights
static_assert(WIN % 8 == 0 && WCONV % 8 == 0 && WFUSE % 8 == 0, "16-byte aligned regions");
constexpr size_t SMEM_A = (size_t)(WCONV + 2 * (WIN + WFUSE)) * sizeof(bf16);
constexpr size_t SMEM_B = (size_t)(WCONV + 2 * WIN) * sizeof(bf16);

using Acc = float[MT][NT][4];

// The IH x IW window whose top-left pixel is (y0-1, x0-1) of img [h, w, 64]
// into s (pixels PS apart); pixels outside the image are zero, never read.
template <bool ASYNC>
__device__ __forceinline__ void stage_window(bf16* s, const bf16* __restrict__ img, int h, int w,
                                             int y0, int x0, const bf16* any) {
  for (int i = threadIdx.x; i < IH * IW * CPP; i += THREADS) {
    const int p = i / CPP, c = (i % CPP) * 8;
    const int gy = y0 - 1 + p / IW, gx = x0 - 1 + p % IW;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    pfnl::stage_chunk<8, ASYNC>(s + p * PS + c, img + ((ptrdiff_t)gy * w + gx) * C + c,
                                inside ? 8 : 0, any);
  }
}

// `rows` contiguous weight rows of 64 bf16 into s (rows WS apart).
template <bool ASYNC>
__device__ __forceinline__ void stage_weights(bf16* s, const bf16* __restrict__ wt, int rows) {
  for (int i = threadIdx.x; i < rows * CPP; i += THREADS) {
    const int r = i / CPP, c = (i % CPP) * 8;
    pfnl::stage_chunk<8, ASYNC>(s + r * WS + c, wt + (size_t)r * C + c, 8, wt);
  }
}

// B fragments of the 16 x 64 weight slice at rows k0.. of s_w (rows WS
// apart): b[j] is n-tile j (channels 8j..8j+7), two from one ldmatrix.x4.trans.
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2], const bf16* s_w, int k0, int lane) {
#pragma unroll
  for (int q = 0; q < NT / 2; ++q) {
    uint32_t r[4];
    pfnl::ldmatrix_x4_trans(r, s_w + (k0 + ((lane / 8) % 2) * 8 + lane % 8) * WS +
                                   8 * (2 * q + lane / 16));
    b[2 * q][0] = r[0];
    b[2 * q][1] = r[1];
    b[2 * q + 1][0] = r[2];
    b[2 * q + 1][1] = r[3];
  }
}

// acc += the 3x3 conv of the window `win` with the weights s_w [9][64][WS]
// (HWIO, tap-major) at the warp's pixels: output row wy of the tile,
// columns 16 mt + 0..15 (window row wy + dh, column 16 mt + dw + 0..15 at
// tap (dh, dw)).  acc[mt][j]: pixels 16 mt + lane/4 (e 0, 1) and + 8 (e 2,
// 3), channels 8 j + 2 (lane % 4) + (e & 1).
__device__ __forceinline__ void conv3x3(const bf16* win, const bf16* s_w, int wy, int lane,
                                        Acc& acc) {
  const bf16* a_row = win + (wy * IW + lane % 16) * PS + (lane / 16) * 8;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3, dw = tap % 3;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t b[NT][2];
      load_b(b, s_w, tap * C + ks * 16, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        pfnl::ldmatrix_x4(a, a_row + (dh * IW + 16 * mt + dw) * PS + ks * 16);
#pragma unroll
        for (int j = 0; j < NT; ++j) pfnl::mma_bf16(acc[mt][j], a, b[j][0], b[j][1]);
      }
    }
  }
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
}

// The tile of a block: y0, x0 of an h x w image, from blockIdx.x.
__device__ __forceinline__ void tile_origin(int w, int& y0, int& x0) {
  const int tiles_x = (w + TW - 1) / TW;
  y0 = (blockIdx.x / tiles_x) * TH;
  x0 = (blockIdx.x % tiles_x) * TW;
}

template <bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1)
pfrb_a_bf16_mma_kernel(const bf16* __restrict__ feat, const bf16* __restrict__ w1,
                       const float* __restrict__ b1, const bf16* __restrict__ wfuse,
                       const float* __restrict__ bfuse, bf16* __restrict__ i1,
                       bf16* __restrict__ base, int nt, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_w = reinterpret_cast<bf16*>(smem_raw);  // W1 [9][64][WS]
  bf16* s_buf = s_w + WCONV;                      // [2][window, then Wfuse_t [64][WS]]
  int y0, x0;
  tile_origin(w, y0, x0);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gy = y0 + warp;
  const bool live = gy < h;  // a warp past the image's last row only stages and waits
  const size_t plane = (size_t)h * w * C;

  stage_weights<ASYNC>(s_w, w1, 9 * C);
  stage_window<ASYNC>(s_buf, feat + (size_t)b * nt * plane, h, w, y0, x0, feat);
  stage_weights<ASYNC>(s_buf + WIN, wfuse, C);
  pfnl::cp_async_commit();

  Acc bacc;
  zero(bacc);
  for (int t = 0; t < nt; ++t) {
    const bf16* cur = s_buf + (t & 1) * (WIN + WFUSE);
    if (t + 1 < nt) {  // frame t+1 into the other buffer, read two frames ago
      bf16* nxt = s_buf + ((t + 1) & 1) * (WIN + WFUSE);
      stage_window<ASYNC>(nxt, feat + ((size_t)b * nt + t + 1) * plane, h, w, y0, x0, feat);
      stage_weights<ASYNC>(nxt + WIN, wfuse + (size_t)(t + 1) * C * C, C);
      pfnl::cp_async_commit();
      pfnl::cp_async_wait<1>();
    } else {
      pfnl::cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      Acc acc;
      zero(acc);
      conv3x3(cur, s_w, warp, lane, acc);
      // i1 = bf16(lrelu(acc + b1)), packed two channels a register: pk[mt][j][half]
      // holds pixel 16 mt + lane/4 + 8 half, channels 8 j + 2 (lane % 4) + {0, 1}
      uint32_t pk[MT][NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const float c0 = b1[c], c1 = b1[c + 1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pk[mt][j][0] = pfnl::pack_bf16(lrelu(acc[mt][j][0] + c0), lrelu(acc[mt][j][1] + c1));
          pk[mt][j][1] = pfnl::pack_bf16(lrelu(acc[mt][j][2] + c0), lrelu(acc[mt][j][3] + c1));
        }
      }
      bf16* dst = i1 + ((size_t)b * nt + t) * plane + ((size_t)gy * w) * C + 2 * (lane % 4);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gx = x0 + 16 * mt + lane / 4 + 8 * half;
          if (gx >= w) continue;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            *reinterpret_cast<uint32_t*>(dst + (size_t)gx * C + 8 * j) = pk[mt][j][half];
        }
      // base_acc += i1_t @ Wfuse_t: the k-step of channels 16 kk.. is n-tiles 2kk, 2kk+1
      const bf16* s_wf = cur + WIN;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bf[NT][2];
        load_b(bf, s_wf, kk * 16, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t a[4] = {pk[mt][2 * kk][0], pk[mt][2 * kk][1], pk[mt][2 * kk + 1][0],
                                 pk[mt][2 * kk + 1][1]};
#pragma unroll
          for (int j = 0; j < NT; ++j) pfnl::mma_bf16(bacc[mt][j], a, bf[j][0], bf[j][1]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer t & 1 before it is refilled
  }

  if (!live) return;
  bf16* dst = base + (size_t)b * plane + ((size_t)gy * w) * C + 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + 16 * mt + lane / 4 + 8 * half;
      if (gx >= w) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(dst + (size_t)gx * C + 8 * j) =
            pfnl::pack_bf16(lrelu(bacc[mt][j][2 * half] + bfuse[c]),
                            lrelu(bacc[mt][j][2 * half + 1] + bfuse[c + 1]));
      }
    }
}

template <bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1)
pfrb_b_bf16_mma_kernel(const bf16* __restrict__ feat, const bf16* __restrict__ i1,
                       const bf16* __restrict__ base, const bf16* __restrict__ w2f,
                       const bf16* __restrict__ w2b, const float* __restrict__ b2,
                       bf16* __restrict__ out, int nt, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_w = reinterpret_cast<bf16*>(smem_raw);  // W2b, then W2f [9][64][WS]
  bf16* s_win = s_w + WCONV;                      // [2][window]
  int y0, x0;
  tile_origin(w, y0, x0);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gy = y0 + warp;
  const bool live = gy < h;
  const size_t plane = (size_t)h * w * C;

  // the base conv from buffer 0, with frame 0's i1 window behind it in buffer 1
  stage_weights<ASYNC>(s_w, w2b, 9 * C);
  stage_window<ASYNC>(s_win, base + (size_t)b * plane, h, w, y0, x0, base);
  pfnl::cp_async_commit();
  stage_window<ASYNC>(s_win + WIN, i1 + (size_t)b * nt * plane, h, w, y0, x0, i1);
  pfnl::cp_async_commit();
  pfnl::cp_async_wait<1>();
  __syncthreads();
  Acc bacc;
  zero(bacc);
  if (live) conv3x3(s_win, s_w, warp, lane, bacc);
  __syncthreads();  // W2b and base's window are read
  stage_weights<ASYNC>(s_w, w2f, 9 * C);
  pfnl::cp_async_commit();

  for (int t = 0; t < nt; ++t) {
    const bf16* cur = s_win + ((t + 1) & 1) * WIN;  // frame t is in buffer (t + 1) & 1
    if (t + 1 < nt) {
      stage_window<ASYNC>(s_win + (t & 1) * WIN, i1 + ((size_t)b * nt + t + 1) * plane, h, w, y0,
                          x0, i1);
      pfnl::cp_async_commit();
      pfnl::cp_async_wait<1>();  // W2f and frame t have landed
    } else {
      pfnl::cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      Acc acc;
      zero(acc);
      conv3x3(cur, s_w, warp, lane, acc);
      const size_t row = ((size_t)b * nt + t) * plane + ((size_t)gy * w) * C + 2 * (lane % 4);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gx = x0 + 16 * mt + lane / 4 + 8 * half;
          if (gx >= w) continue;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const size_t at = row + (size_t)gx * C + 8 * j;
            const int c = 8 * j + 2 * (lane % 4);
            float f0, f1;
            if constexpr (ASYNC) {  // 4-byte aligned: one bf16x2 load
              const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(feat + at));
              f0 = f.x;
              f1 = f.y;
            } else {
              f0 = __bfloat162float(feat[at]);
              f1 = __bfloat162float(feat[at + 1]);
            }
            const float o0 = f0 + lrelu(acc[mt][j][2 * half] + bacc[mt][j][2 * half] + b2[c]);
            const float o1 =
                f1 + lrelu(acc[mt][j][2 * half + 1] + bacc[mt][j][2 * half + 1] + b2[c + 1]);
            *reinterpret_cast<uint32_t*>(out + at) = pfnl::pack_bf16(o0, o1);
          }
        }
    }
    __syncthreads();  // every warp is done with buffer (t + 1) & 1 before it is refilled
  }
}

int launch_a(const void* feat, const void* w1, const float* b1, const void* wfuse,
             const float* bfuse, void* i1, void* base, int n, int t, int h, int w,
             cudaStream_t stream) {
  auto k = pfnl::aligned16({feat, w1, wfuse}) ? &pfrb_a_bf16_mma_kernel<true>
                                              : &pfrb_a_bf16_mma_kernel<false>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_A);
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), n);
  k<<<grid, THREADS, SMEM_A, stream>>>(
      static_cast<const bf16*>(feat), static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(wfuse), bfuse, static_cast<bf16*>(i1), static_cast<bf16*>(base),
      t, h, w);
  return (int)cudaGetLastError();
}

int launch_b(const void* feat, const void* i1, const void* base, const void* w2f,
             const void* w2b, const float* b2, void* out, int n, int t, int h, int w,
             cudaStream_t stream) {
  auto k = pfnl::aligned16({feat, i1, base, w2f, w2b}) ? &pfrb_b_bf16_mma_kernel<true>
                                                       : &pfrb_b_bf16_mma_kernel<false>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_B);
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), n);
  k<<<grid, THREADS, SMEM_B, stream>>>(
      static_cast<const bf16*>(feat), static_cast<const bf16*>(i1),
      static_cast<const bf16*>(base), static_cast<const bf16*>(w2f),
      static_cast<const bf16*>(w2b), b2, static_cast<bf16*>(out), t, h, w);
  return (int)cudaGetLastError();
}

}  // namespace tc

// The bf16 kernels on the warpgroup tensor cores, fed by tensor-map copies
// (see the head of this file).
namespace wg {

using bf16 = __nv_bfloat16;
using namespace pfnl;

constexpr int ROWS = 2;               // a tile's output rows: one a consumer warpgroup
constexpr int TW = 64, WW = TW + 2;   // a row's 64 output pixels, 66 with the halo
constexpr int PIX = C * 2;            // bytes of a pixel: one 128-byte swizzle row
constexpr int WIN = (ROWS + 2) * WW * PIX;  // a tile's window with its halo (33 x 1024 bytes)
constexpr int WTAP = C * PIX;         // one tap's [64 in][64 out] weights, 8 KB
constexpr int WCONV = 9 * WTAP;       // a conv's weights
constexpr int W_BOX = 192;            // weight rows a copy brings (of a conv's 576)
constexpr int OUT_ROW = TW * PIX;     // a warpgroup's output row, staged for its store
constexpr int NT = 128 * (ROWS + 1);  // the consumer warpgroups, then the producer's
// Kernel A: a stage holds frame t's window and Wfuse_t.  Kernel B: base's or a
// frame's i1 window; both convs' weights stay resident, which leaves room for
// two, and its barriers go in the alignment slack before the 1024-byte regions.
constexpr int STAGES_A = 3, STAGE_A = WIN + WTAP, STAGES_B = 2;
constexpr size_t SMEM_A =
    1024 + WCONV + STAGES_A * STAGE_A + ROWS * OUT_ROW + (2 * STAGES_A + 1) * 8;
constexpr size_t REGIONS_B = 2 * WCONV + STAGES_B * WIN + ROWS * OUT_ROW;
constexpr size_t SMEM_B = 1024 + REGIONS_B;
static_assert(WIN % 1024 == 0 && STAGE_A % 1024 == 0, "1024-byte swizzle atoms");
static_assert(SMEM_A <= 232448 && SMEM_B <= 232448, "an SM's shared memory");
// named barriers: TURN + w, warpgroup w's turn to issue its conv; WG_SYNC + w, its 128 threads
enum : int { TURN = 1, WG_SYNC = 3 };

struct Tile {
  int b, y0, x0;
};

// Tile `i` of the n x tiles_y x tiles_x tiles, x fastest.
__device__ __forceinline__ Tile tile_at(int i, int tiles_x, int tiles_y) {
  const int per = tiles_x * tiles_y;
  return {i / per, (i % per) / tiles_x * ROWS, i % tiles_x * TW};
}

// acc = the 3x3 conv at the warpgroup's 64 pixels.  A is the window from
// `win`, the first window row of the warpgroup's output row: tap (dh, dw)
// starts dh rows and dw pixels further, a k-step 32 bytes into each pixel.
// B is the conv's HWIO weights at `wts`, MN-major (rows of 64 output
// channels), a k-step 16 rows further.  9 taps x 4 k-steps.
__device__ __forceinline__ void conv_issue(float (&acc)[32], uint32_t win, uint32_t wts) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks)
      wgmma_m64n64k16_ss_tb(
          acc, wgmma_desc(win + ((tap / 3) * WW + tap % 3) * PIX + ks * 32, 1024, SWIZZLE_128B),
          wgmma_desc(wts + tap * WTAP + ks * 16 * PIX, 1024, SWIZZLE_128B, 1024),
          tap > 0 || ks > 0);
}

// The 16 bias values of the thread's channels 8i + 2(lane % 4) + {0, 1}.
__device__ __forceinline__ void load_bias(float (&bias)[16], const float* __restrict__ b) {
  const int c0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bias[2 * i] = b[8 * i + c0];
    bias[2 * i + 1] = b[8 * i + c0 + 1];
  }
}

// v = the bf16 pairs of lrelu(d + bias) as k-step fragments: v[k][e] holds
// n-tile 2k + e / 2 at pixel g (e even) or g + 8 (e odd), so v[k] is also
// the A fragment of k-step k of a product.
__device__ __forceinline__ void pack_lrelu(uint32_t (&v)[C / 16][4], const float (&d)[32],
                                           const float (&bias)[16]) {
#pragma unroll
  for (int k = 0; k < C / 16; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 2 * k + e / 2, r = 4 * i + 2 * (e % 2);
      v[k][e] = pack_bf16(lrelu(d[r] + bias[2 * i]), lrelu(d[r + 1] + bias[2 * i + 1]));
    }
}

// Where this lane's row address of k-step k's stmatrix / ldmatrix x4 lies in
// a staged output row (64 pixels of 128 bytes, 128-byte swizzled, the row
// 1024-byte aligned): chunk 2k + lane / 16 of pixel p.
__device__ __forceinline__ uint32_t row_offset(int k) {
  const int lane = threadIdx.x % 32;
  const int p = 16 * ((threadIdx.x % 128) / 32) + (lane / 8 % 2) * 8 + lane % 8;
  return p * PIX + (((2 * k + lane / 16) ^ (p % 8)) * 16);
}

// Stage v (k-step fragments) as the row, then store it at the coordinates of
// its first pixel: after the barrier that shows every warp's part written,
// the elected thread issues the store.  Before the staging is written again,
// that thread waits for the store to have read it (bulk_wait_read).
__device__ __forceinline__ void store_row(uint8_t* staging, const uint32_t (&v)[C / 16][4],
                                          const void* map, int wg, bool elected, int x0, int y,
                                          int t, int b) {
#pragma unroll
  for (int k = 0; k < C / 16; ++k) stmatrix_x4(staging + row_offset(k), v[k]);
  fence_proxy_async();
  named_bar_sync(WG_SYNC + wg, 128);
  if (elected) {
    tma_store_5d(map, staging, 0, x0, y, t, b);
    bulk_commit();
  }
}

__global__ void __launch_bounds__(NT, 1)
pfrb_a_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap feat_map,
                         const __grid_constant__ CUtensorMap i1_map,
                         const __grid_constant__ CUtensorMap base_map,
                         const __grid_constant__ CUtensorMap w1_map,
                         const __grid_constant__ CUtensorMap wf_map, const float* __restrict__ b1,
                         const float* __restrict__ bfuse, int n, int nt, int h, int w) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* s_w = smem;                        // W1 [9][64 in][64 out]
  uint8_t* s_ring = s_w + WCONV;              // [STAGES_A][window, Wfuse_t]
  uint8_t* s_out = s_ring + STAGES_A * STAGE_A;  // [ROWS][an output row]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_out + ROWS * OUT_ROW);
  uint64_t* empty = full + STAGES_A;
  uint64_t* wbar = empty + STAGES_A;
  const int wg = threadIdx.x / 128;
  const int tiles_x = (w + TW - 1) / TW, tiles_y = (h + ROWS - 1) / ROWS;
  const int tiles = n * tiles_x * tiles_y;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES_A; ++s) {
      mbar_init(&full[s], 1);      // the producer's arrival and the stage's bytes
      mbar_init(&empty[s], ROWS);  // each consumer warpgroup, once done with the stage
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == ROWS) {  // the producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * ROWS) {
      mbar_arrive_expect_tx(wbar, WCONV);
      for (int r = 0; r < 9 * C / W_BOX; ++r)
        tma_load_2d(s_w + r * W_BOX * PIX, &w1_map, 0, r * W_BOX, wbar);
      int j = 0;  // the block's frames in order: frame t of its tile i
      for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
        const Tile tl = tile_at(i, tiles_x, tiles_y);
        for (int t = 0; t < nt; ++t, ++j) {
          const int s = j % STAGES_A;
          if (j >= STAGES_A) mbar_wait(&empty[s], ((j / STAGES_A) & 1) ^ 1);
          uint8_t* st = s_ring + s * STAGE_A;
          mbar_arrive_expect_tx(&full[s], STAGE_A);
          tma_load_5d(st, &feat_map, 0, tl.x0 - 1, tl.y0 - 1, t, tl.b, &full[s]);
          tma_load_2d(st + WIN, &wf_map, 0, t * C, &full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const uint32_t w_addr = smem_addr(s_w), ring = smem_addr(s_ring);
    uint8_t* staging = s_out + wg * OUT_ROW;
    const bool elected = threadIdx.x % 128 == 0;
    float bias[16];
    load_bias(bias, b1);
    mbar_wait(wbar, 0);
    // Turns: a warpgroup issues its conv only after the other has issued its
    // own, so one's epilogue runs while the other's products do.  Warpgroup 0
    // goes first.
    if (wg == 1) named_bar_arrive(TURN, 256);
    float acc[32], bacc[32];
    uint32_t af[C / 16][4];  // i1_t rounded, as the A fragments of the fusion product
    int j = 0;
    for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
      const Tile tl = tile_at(i, tiles_x, tiles_y);
      const int y = tl.y0 + wg;
      const bool last_tile = i + gridDim.x >= tiles;
      for (int t = 0; t < nt; ++t, ++j) {
        const int s = j % STAGES_A;
        const uint32_t st = ring + s * STAGE_A;
        mbar_wait(&full[s], (j / STAGES_A) & 1);
        named_bar_sync(TURN + wg, 256);
        reg_fence(acc);
        wgmma_fence();
        conv_issue(acc, st + wg * WW * PIX, w_addr);
        wgmma_commit();
        if (wg == 0 || !(last_tile && t == nt - 1)) named_bar_arrive(TURN + (wg ^ 1), 256);
        wgmma_wait<0>();  // this conv, and the previous frame's fusion product
        reg_fence(acc);
        reg_fence(bacc);
        reg_fence(af);
        pack_lrelu(af, acc, bias);  // i1_t = bf16(lrelu(acc + b1))
        if (elected) bulk_wait_read<0>();   // the previous row has left the staging
        named_bar_sync(WG_SYNC + wg, 128);  // and every warp is past its wait:
        if (elected && t > 0) mbar_arrive(&empty[(j - 1) % STAGES_A]);  // frame t-1's stage is read
        store_row(staging, af, &i1_map, wg, elected, tl.x0, y, t, tl.b);
        // base_acc += i1_t @ Wfuse_t, left in flight behind the next frame's conv
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk)
          wgmma_m64n64k16_rs_tb(bacc, af[kk],
                                wgmma_desc(st + WIN + kk * 16 * PIX, 1024, SWIZZLE_128B, 1024),
                                t > 0 || kk > 0);
        wgmma_commit();
      }
      wgmma_wait<0>();
      reg_fence(bacc);
      reg_fence(af);
      if (elected) bulk_wait_read<0>();
      named_bar_sync(WG_SYNC + wg, 128);
      if (elected) mbar_arrive(&empty[(j - 1) % STAGES_A]);
      float fb[16];  // base = bf16(lrelu(base_acc + bfuse))
      load_bias(fb, bfuse);
      pack_lrelu(af, bacc, fb);
      store_row(staging, af, &base_map, wg, elected, tl.x0, y, 0, tl.b);
    }
    if (elected) bulk_wait_read<0>();
  }
}

__global__ void __launch_bounds__(NT, 1)
pfrb_b_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap i1_map,
                         const __grid_constant__ CUtensorMap base_map,
                         const __grid_constant__ CUtensorMap feat_map,
                         const __grid_constant__ CUtensorMap out_map,
                         const __grid_constant__ CUtensorMap w2f_map,
                         const __grid_constant__ CUtensorMap w2b_map, const float* __restrict__ b2,
                         int n, int nt, int h, int w) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + STAGES_B;
  uint64_t* wbar = empty + STAGES_B;
  uint64_t* fbar = wbar + 1;  // [ROWS]: feat_t's row in a warpgroup's staging
  const uint32_t raw = smem_addr(smem_raw), barriers_end = smem_addr(fbar + ROWS);
  uint8_t* smem = smem_raw + (((barriers_end + 1023) & ~1023u) - raw);
  if (smem_addr(smem) - raw + REGIONS_B > SMEM_B) __trap();  // room only on a 1024-aligned base
  uint8_t* s_w2b = smem;                       // W2b [9][64 in][64 out]
  uint8_t* s_w2f = s_w2b + WCONV;              // W2f
  uint8_t* s_ring = s_w2f + WCONV;             // [STAGES_B][window of base or of i1_t]
  uint8_t* s_out = s_ring + STAGES_B * WIN;    // [ROWS][feat_t's row, then out_t's]
  const int wg = threadIdx.x / 128;
  const int tiles_x = (w + TW - 1) / TW, tiles_y = (h + ROWS - 1) / ROWS;
  const int tiles = n * tiles_x * tiles_y;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES_B; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], ROWS);
    }
    mbar_init(wbar, 1);
    for (int r = 0; r < ROWS; ++r) mbar_init(&fbar[r], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == ROWS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * ROWS) {
      mbar_arrive_expect_tx(wbar, 2 * WCONV);
      for (int r = 0; r < 9 * C / W_BOX; ++r) {
        tma_load_2d(s_w2b + r * W_BOX * PIX, &w2b_map, 0, r * W_BOX, wbar);
        tma_load_2d(s_w2f + r * W_BOX * PIX, &w2f_map, 0, r * W_BOX, wbar);
      }
      int j = 0;  // the block's windows in order: base's (f = -1), then each frame's i1
      for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
        const Tile tl = tile_at(i, tiles_x, tiles_y);
        for (int f = -1; f < nt; ++f, ++j) {
          const int s = j % STAGES_B;
          if (j >= STAGES_B) mbar_wait(&empty[s], ((j / STAGES_B) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], WIN);
          tma_load_5d(s_ring + s * WIN, f < 0 ? (const void*)&base_map : (const void*)&i1_map, 0,
                      tl.x0 - 1, tl.y0 - 1, f < 0 ? 0 : f, tl.b, &full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const uint32_t w2b = smem_addr(s_w2b), w2f = smem_addr(s_w2f), ring = smem_addr(s_ring);
    uint8_t* staging = s_out + wg * OUT_ROW;
    const bool elected = threadIdx.x % 128 == 0;
    float bias[16];
    load_bias(bias, b2);
    mbar_wait(wbar, 0);
    if (wg == 1) named_bar_arrive(TURN, 256);
    float acc[32], bacc[32];
    uint32_t ov[C / 16][4];
    int j = 0, nf = 0;
    // A window's stage goes back to the producer as soon as both warpgroups'
    // convs have read it, before their epilogues.
    auto release = [&](int s) {
      named_bar_sync(WG_SYNC + wg, 128);  // every warp is past its wait
      if (elected) mbar_arrive(&empty[s]);
    };
    for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
      const Tile tl = tile_at(i, tiles_x, tiles_y);
      const int y = tl.y0 + wg;
      const bool last_tile = i + gridDim.x >= tiles;
      // conv3x3(base, W2b), kept in float32 across the frames
      {
        const int s = j % STAGES_B;
        mbar_wait(&full[s], (j / STAGES_B) & 1);
        named_bar_sync(TURN + wg, 256);
        reg_fence(bacc);
        wgmma_fence();
        conv_issue(bacc, ring + s * WIN + wg * WW * PIX, w2b);
        wgmma_commit();
        named_bar_arrive(TURN + (wg ^ 1), 256);
        wgmma_wait<0>();
        reg_fence(bacc);
        release(s);
        ++j;
      }
      for (int t = 0; t < nt; ++t, ++j, ++nf) {
        const int s = j % STAGES_B;
        mbar_wait(&full[s], (j / STAGES_B) & 1);
        named_bar_sync(TURN + wg, 256);
        reg_fence(acc);
        wgmma_fence();
        conv_issue(acc, ring + s * WIN + wg * WW * PIX, w2f);
        wgmma_commit();
        if (wg == 0 || !(last_tile && t == nt - 1)) named_bar_arrive(TURN + (wg ^ 1), 256);
        // feat_t's row into the staging once the previous out row has left it,
        // while the products run
        if (elected) {
          bulk_wait_read<0>();
          mbar_arrive_expect_tx(&fbar[wg], OUT_ROW);
          tma_load_5d(staging, &feat_map, 0, tl.x0, y, t, tl.b, &fbar[wg]);
        }
        wgmma_wait<0>();
        reg_fence(acc);
        release(s);
        // out_t = feat_t + lrelu(acc + bacc + b2), rounded once, over feat_t in the staging
        mbar_wait(&fbar[wg], nf & 1);
#pragma unroll
        for (int k = 0; k < C / 16; ++k) ldmatrix_x4(ov[k], staging + row_offset(k));
#pragma unroll
        for (int k = 0; k < C / 16; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i8 = 2 * k + e / 2, d = 4 * i8 + 2 * (e % 2);
            const float2 fe =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov[k][e]));
            ov[k][e] = pack_bf16(fe.x + lrelu(acc[d] + bacc[d] + bias[2 * i8]),
                                 fe.y + lrelu(acc[d + 1] + bacc[d + 1] + bias[2 * i8 + 1]));
          }
        store_row(staging, ov, &out_map, wg, elected, tl.x0, y, t, tl.b);
      }
    }
    if (elected) bulk_wait_read<0>();
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no libcuda); null where the driver lacks it.
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// [n, t, h, w, 64] bf16 activations, a box of bw x bh pixels of one frame,
// rows 128-byte swizzled; reads outside the tensor give zeros.
bool act_map(CUtensorMap* m, const void* p, int n, int t, int h, int w, int bw, int bh) {
  const cuuint64_t dims[5] = {C, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)t, (cuuint64_t)n};
  const cuuint64_t strides[4] = {PIX, (cuuint64_t)w * PIX, (cuuint64_t)h * w * PIX,
                                 (cuuint64_t)t * h * w * PIX};
  const cuuint32_t box[5] = {C, (cuuint32_t)bw, (cuuint32_t)bh, 1, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(p), dims, strides,
                        box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `rows` weight rows of 64 bf16, box_rows a copy, rows 128-byte swizzled.
bool weight_map(CUtensorMap* m, const void* p, int rows, int box_rows) {
  const cuuint64_t dims[2] = {C, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {PIX};
  const cuuint32_t box[2] = {C, (cuuint32_t)box_rows}, ones[2] = {1, 1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides,
                        box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device's SM count, with both kernels' shared memory allowed
// there: queried and set once a device (every launch pays for it otherwise).
int device_sms() {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<int> sms[MAX_DEVICES];  // zero: not yet queried
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < MAX_DEVICES && sms[dev].load() > 0) return sms[dev].load();
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(pfrb_a_bf16_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_A);
  cudaFuncSetAttribute(pfrb_b_bf16_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_B);
  if (dev < MAX_DEVICES) sms[dev].store(n);
  return n;
}

// One persistent block an SM (or a block a tile, where there are fewer).
int blocks(int n, int h, int w) {
  const int sms = device_sms();
  const int tiles = n * ((h + ROWS - 1) / ROWS) * ((w + TW - 1) / TW);
  return tiles < sms ? tiles : sms;
}

int launch_a(const void* feat, const void* w1, const float* b1, const void* wfuse,
             const float* bfuse, void* i1, void* base, int n, int t, int h, int w,
             cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap fm, im, bm, wm, ffm;
  if (!act_map(&fm, feat, n, t, h, w, WW, ROWS + 2) || !act_map(&im, i1, n, t, h, w, TW, 1) ||
      !act_map(&bm, base, n, 1, h, w, TW, 1) || !weight_map(&wm, w1, 9 * C, W_BOX) ||
      !weight_map(&ffm, wfuse, t * C, C))
    return (int)cudaErrorInvalidValue;
  pfrb_a_bf16_wgmma_kernel<<<blocks(n, h, w), NT, SMEM_A, stream>>>(fm, im, bm, wm, ffm, b1, bfuse,
                                                                    n, t, h, w);
  return (int)cudaGetLastError();
}

int launch_b(const void* feat, const void* i1, const void* base, const void* w2f,
             const void* w2b, const float* b2, void* out, int n, int t, int h, int w,
             cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap im, bm, fm, om, wfm, wbm;
  if (!act_map(&im, i1, n, t, h, w, WW, ROWS + 2) ||
      !act_map(&bm, base, n, 1, h, w, WW, ROWS + 2) || !act_map(&fm, feat, n, t, h, w, TW, 1) ||
      !act_map(&om, out, n, t, h, w, TW, 1) || !weight_map(&wfm, w2f, 9 * C, W_BOX) ||
      !weight_map(&wbm, w2b, 9 * C, W_BOX))
    return (int)cudaErrorInvalidValue;
  pfrb_b_bf16_wgmma_kernel<<<blocks(n, h, w), NT, SMEM_B, stream>>>(im, bm, fm, om, wfm, wbm, b2, n,
                                                                    t, h, w);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// C interface, loaded with ctypes.  Activations [n,t,h,w,64] (base
// [n,h,w,64]) of float or bf16, contiguous; W1/W2f/W2b [3,3,64,64] (HWIO)
// and Wfuse [t,64,64], contiguous, of the activation type (float32 entries:
// float32 rounded to the activation type, which is float32 itself); biases
// [64] float32, rounded to the activation type by the caller.  Returns
// cudaGetLastError() after the launch.
extern "C" {

int pfnl_pfrb_a_f32(const void* feat, const float* w1, const float* b1, const float* wfuse,
                    const float* bfuse, void* i1, void* base, int n, int t, int h, int w,
                    void* stream) {
  return tf32::launch_a(static_cast<const float*>(feat), w1, b1, wfuse, bfuse,
                        static_cast<float*>(i1), static_cast<float*>(base), n, t, h, w,
                        static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_a_bf16(const void* feat, const void* w1, const float* b1, const void* wfuse,
                     const float* bfuse, void* i1, void* base, int n, int t, int h, int w,
                     void* stream) {
  return tc::launch_a(feat, w1, b1, wfuse, bfuse, i1, base, n, t, h, w,
                      static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_a_bf16_wgmma(const void* feat, const void* w1, const float* b1, const void* wfuse,
                           const float* bfuse, void* i1, void* base, int n, int t, int h, int w,
                           void* stream) {
  return wg::launch_a(feat, w1, b1, wfuse, bfuse, i1, base, n, t, h, w,
                      static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_b_bf16_wgmma(const void* feat, const void* i1, const void* base, const void* w2f,
                           const void* w2b, const float* b2, void* out, int n, int t, int h, int w,
                           void* stream) {
  return wg::launch_b(feat, i1, base, w2f, w2b, b2, out, n, t, h, w,
                      static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_b_f32(const void* feat, const void* i1, const void* base, const float* w2f,
                    const float* w2b, const float* b2, void* out, int n, int t, int h, int w,
                    void* stream) {
  return tf32::launch_b(static_cast<const float*>(feat), static_cast<const float*>(i1),
                        static_cast<const float*>(base), w2f, w2b, b2, static_cast<float*>(out), n,
                        t, h, w, static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_b_bf16(const void* feat, const void* i1, const void* base, const void* w2f,
                     const void* w2b, const float* b2, void* out, int n, int t, int h, int w,
                     void* stream) {
  return tc::launch_b(feat, i1, base, w2f, w2b, b2, out, n, t, h, w,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
