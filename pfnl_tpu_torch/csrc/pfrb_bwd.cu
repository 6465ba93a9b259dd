// Kernels 5 and 6: the backward of one PFRB (kernels 2 and 3), from the
// forward's saved feat, i1 and base, with no forward recompute.
//
// Replaces the TPU kernels pfnl_tpu/ops/pallas/pfrb_bwd.py:_kernel_bwd_b
// (driven by _run_bwd_b) and :_kernel_bwd_a (driven by _run_bwd_a).  Those
// work on the column-pair packed 128-lane layout, shift grids with
// pltpu.roll, and accumulate the weight gradients in an output block
// revisited across a sequential grid.  Here activations are plain
// contiguous channels-last [N,T,H,W,64] tensors.
//
//   K5 (bwd_b), from dz2 = d_out * lrelu'(i2):
//        d_i1_t = convT(dz2_t, W2f)
//        dzsum  = sum_t dz2_t (float), rounded to the activation type
//        d_base = convT(dzsum, W2b)
//        dW2f = sum patches(i1) x dz2,  dW2b = sum patches(base) x dzsum,
//        db2 = sum dz2
//   K6 (bwd_a), from dz1 = d_i1 * lrelu'(i1) and the block's output
//   cotangent g:
//        d_feat_t = g_t + convT(dz1_t, W1)
//        dW1 = sum patches(feat) x dz1,  db1 = sum dz1
//
// A transposed SAME conv is a SAME conv with the mirrored,
// channel-transposed kernel (mirror_t), so both kernels are three
// implicit-GEMM convs and three weight-gradient GEMMs.  The weight and bias
// gradients are reductions over all N*T*H*W pixels: a GEMM patches^T * dZ
// with K = pixels.  Blocks run in no order on the GPU, so instead of the
// TPU's revisited accumulator they are made deterministic in two launches:
// the (frame, 8x16 tile) items are split into WGRAD_CHUNKS fixed contiguous
// ranges, one block per (range, kernel row dy) sums its 3 x 64 x 64 part of
// dW (and, at dy = 0, db) and writes it out, and wgrad_reduce_kernel sums
// the ranges in a fixed order.  No float atomics: two runs on the same
// inputs agree bit for bit.
//
// Bound on the H100: at the paper's training shape (batch 16, 7 frames,
// LR 32x32) K5 does 19.33 GFLOP (d_i1, d_base, dW2f, dW2b as 3x3x64x64
// MACs) and K6 16.91, against about 101 and 117 MB moved: 0.030 and 0.035
// ms at 3.35 TB/s.  On the tensor cores three TF32 products stand for one
// float32 product, so the bound is 3 x ops over 495 TFLOP/s: 0.117 and
// 0.103 ms, operations.
//
// float32 (training; the `tf32` namespace): 3xTF32 on the tensor cores.
//   - Arithmetic: mma.sync m16n8k8 TF32 with float32 accumulation (mma.cuh).
//     Each operand x is split in registers after its fragment load into
//     hi = tf32(x) and lo = tf32(x - hi), both rounded by cvt.rna's rule
//     (two integer operations, mma.cuh); a k-step runs lo*hi, hi*lo, then
//     hi*hi into one accumulator (lo*lo, about 2^-22 of the product, is
//     dropped).  One TF32 product lands about 3e-4 of max|plain| off, above
//     the 1e-4 check; the split holds it, with float32 accumulation, to
//     about 1e-6 (tests/test_torch_pfrb_bwd.py emulates both).  The mma
//     accumulate with truncation, a bias toward zero that grows with the
//     chain (one accumulator over a range's thousands of pixels left dW
//     well behind the plain float32 version at [2,7,180,320]), so each tap
//     (data) or item (weights) sums into a fresh accumulator that is then
//     added to the total in float32; every output then lies within 2e-6 of
//     max|plain| (chip_smoke.py phase 5a).  Shared memory holds one float32
//     copy of everything; ldmatrix is 16-bit only, so the fragments come
//     from 32-bit ld.shared, one element a lane.
//   - Data gradients, an implicit GEMM per conv (the tile of
//     tf32_conv.cuh, which kernels 2-3's float32 entries share): M = the
//     8 x 16 pixels of the block's tile, N = 64 output channels, K = 9
//     taps x 64 channels.
//     8 warps; a warp owns two tile rows (two m-tiles of 16 pixels) x 32
//     channels (four n-tiles), so a split A fragment feeds 12 mma and a
//     split B fragment 6.  A tap shift is another row address into the
//     staged (8+2) x (16+2) window: no im2col.  The conv's weights stay
//     resident for the whole frame loop as [tap][out][in], 576 rows padded
//     from 64 to 68 floats (156,672 B); the window's pixels are padded to
//     68 floats too (48,960 B), so the eight rows (g) x four columns (t) of
//     a fragment load fall on banks 4g + t, all distinct.  205,632 B of
//     shared memory: one block an SM, and the frame window is filled
//     single-buffered by cp.async (double-buffered it would need 255 KB);
//     halo pixels outside the image are zero-filled with src-size 0.  An
//     8x16 tile gives 128 blocks at the training shape, one wave on 132
//     SMs (8x32 would leave half the card idle).  137-223 registers a
//     thread, no spills.
//   - K5 keeps the running sum of dz2 over frames in registers: each
//     thread adds the 16-byte chunks of the window it owns (12 a thread),
//     so d_base needs no reduction across blocks and no second window
//     (which would not fit).  After the frame loop W2b replaces W2f, the
//     sum goes into the window buffer, its tile pixels out as dzsum, and a
//     last conv gives d_base.  K6 adds g in the epilogue (one rounding).
//   - Weight gradients, wgrad_tf32_mma_kernel: M = 192 (dx, input channel)
//     of the block's kernel row dy, N = 64, K = 128 pixels an item.  A
//     warp owns three m-tiles x four n-tiles (48 accumulators a thread);
//     the A operand is patches^T, its m an input channel and its k a
//     pixel, read transposed from the staged [pixel][channel] window, whose
//     pixels are padded to 72 floats (banks 8t + g, distinct).  Items are
//     double-buffered by cp.async, 2 x 78,336 B.  128 ranges x 3 rows =
//     384 blocks, 2.9 waves of one block an SM.  db sums the raw dz
//     fragments of warps 0-1 of the dy = 0 blocks, then across each quad
//     in a fixed order.
//   - Inputs not 16-byte aligned (a view at an odd offset) are staged
//     element by element by another instantiation of each kernel.
//   - What still holds them back (no ncu on the card, so inferred): at the
//     training shape each kernel issues about one mma per 12 cycles of a
//     sub-partition, and a k-step of a warp needs about 100 other
//     instructions (16 ld.shared, 16 splits) beside its 24 mma, with two
//     warps a sub-partition to hide their latency; the block waits on each
//     frame's window (single-buffered); the partials' round trip through
//     device memory (about 19 MB a weight gradient at the training shape);
//     and K5 and K6 stage the dz windows that their weight gradients read
//     again.  wgmma with operands split once into shared memory is the next
//     step, if the shared memory can be found.
//
// bf16: the first design, float FMAs on CUDA cores.  The data gradients
// reuse conv_tile.cuh with the mirror_t kernel: one block per (sample,
// 8x16 tile), the frame loop inside the block; K5 adds every frame's
// staged dz2 window into a second shared buffer for d_base.
// wgrad_partial_kernel keeps 3 x 64 x 64 partial sums in registers
// (thread: 4 input x 4 output channels for each dx).
#include "conv_tile.cuh"
#include "tf32_conv.cuh"

namespace {

using pfnl::from_f32;
using pfnl::round_to;
using pfnl::to_f32;

constexpr int C = 64, TH = 8, TW = 16, PPT = 4, CPT = 8;
using Tile = pfnl::ConvTile<C, C, TH, TW, PPT, CPT>;

// weight-gradient tiling
constexpr int WTH = 8, WTW = 16, WX = WTW + 2;   // pixel tile; staged input columns
constexpr int WG_THREADS = 256;                  // 16 input x 16 output channel groups
constexpr int WGRAD_CHUNKS = 128;                // fixed ranges of (frame, tile) items
constexpr int WGRAD_ENTRIES = 9 * C * C + C;     // dW (HWIO) then db
constexpr size_t WG_SMEM_BYTES = (size_t)(WTH * WX * C + WTH * WTW * C) * sizeof(float);
constexpr size_t B_SMEM_BYTES = (size_t)(2 * Tile::IN_FLOATS + Tile::W_FLOATS) * sizeof(float);

// Stage the input window of the tile at (y0, x0) like Tile::load_input and
// add it into s_sum; each thread touches the same elements in both buffers.
template <typename T>
__device__ void load_and_sum(float* s_in, float* s_sum, const T* __restrict__ img, int h, int w,
                             int y0, int x0) {
  for (int i = threadIdx.x; i < Tile::IH * Tile::IW * C; i += Tile::THREADS) {
    const int c = i % C, p = i / C;
    const int gy = y0 - 1 + p / Tile::IW, gx = x0 - 1 + p % Tile::IW;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = to_f32(img[((size_t)gy * w + gx) * C + c]);
    s_in[p * Tile::CS + c] = v;
    s_sum[p * Tile::CS + c] += v;
  }
}

template <typename T>
__global__ void __launch_bounds__(Tile::THREADS)
bwd_b_data_kernel(const T* __restrict__ dz2, const float* __restrict__ w2ft,
                  const float* __restrict__ w2bt, T* __restrict__ d_i1, T* __restrict__ dzsum,
                  T* __restrict__ d_base, int nt, int h, int w) {
  extern __shared__ float smem[];
  float* s_in = smem;
  float* s_w = smem + Tile::IN_FLOATS;
  float* s_sum = s_w + Tile::W_FLOATS;
  const int tiles_x = (w + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int b = blockIdx.y;
  const int co0 = Tile::cg() * CPT, py = Tile::py(), px = Tile::px();
  const int gy = y0 + py;
  const size_t plane = (size_t)h * w * C;

  for (int i = threadIdx.x; i < Tile::IH * Tile::IW * C; i += Tile::THREADS)
    s_sum[(i / C) * Tile::CS + i % C] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const size_t img = ((size_t)b * nt + t) * plane;
    __syncthreads();  // the previous frame's conv reads of s_in are done
    load_and_sum(s_in, s_sum, dz2 + img, h, w, y0, x0);
    float acc[PPT][CPT] = {};
    Tile::conv3x3(s_in, s_w, w2ft, (size_t)C * C, C, acc);
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int gx = x0 + px + p;
      if (gy < h && gx < w) {
        T* dst = d_i1 + img + ((size_t)gy * w + gx) * C + co0;
#pragma unroll
        for (int j = 0; j < CPT; ++j) dst[j] = from_f32<T>(acc[p][j]);
      }
    }
  }

  // round the frame sum to the activation type, as the plain version
  // does, and write the tile's own pixels of it for dW2b
  for (int i = threadIdx.x; i < Tile::IH * Tile::IW * C; i += Tile::THREADS) {
    const int c = i % C, p = i / C;
    const int wy = p / Tile::IW, wx = p % Tile::IW;
    const float v = round_to<T>(s_sum[p * Tile::CS + c]);
    s_sum[p * Tile::CS + c] = v;
    const int sy = y0 - 1 + wy, sx = x0 - 1 + wx;
    if (wy >= 1 && wy <= TH && wx >= 1 && wx <= TW && sy < h && sx < w)
      dzsum[(size_t)b * plane + ((size_t)sy * w + sx) * C + c] = from_f32<T>(v);
  }
  float acc[PPT][CPT] = {};
  Tile::conv3x3(s_sum, s_w, w2bt, (size_t)C * C, C, acc);  // begins with a barrier
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int gx = x0 + px + p;
    if (gy < h && gx < w) {
      T* dst = d_base + (size_t)b * plane + ((size_t)gy * w + gx) * C + co0;
#pragma unroll
      for (int j = 0; j < CPT; ++j) dst[j] = from_f32<T>(acc[p][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Tile::THREADS)
bwd_a_data_kernel(const T* __restrict__ dz1, const T* __restrict__ g,
                  const float* __restrict__ w1t, T* __restrict__ d_feat, int nt, int h, int w) {
  extern __shared__ float smem[];
  float* s_in = smem;
  float* s_w = smem + Tile::IN_FLOATS;
  const int tiles_x = (w + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int b = blockIdx.y;
  const int co0 = Tile::cg() * CPT, py = Tile::py(), px = Tile::px();
  const int gy = y0 + py;
  const size_t plane = (size_t)h * w * C;

  for (int t = 0; t < nt; ++t) {
    const size_t img = ((size_t)b * nt + t) * plane;
    __syncthreads();  // the previous frame's conv reads of s_in are done
    Tile::load_input(s_in, dz1 + img, h, w, C, y0, x0);
    float acc[PPT][CPT] = {};
    Tile::conv3x3(s_in, s_w, w1t, (size_t)C * C, C, acc);
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int gx = x0 + px + p;
      if (gy < h && gx < w) {
        const size_t at = img + ((size_t)gy * w + gx) * C + co0;
#pragma unroll
        for (int j = 0; j < CPT; ++j) d_feat[at + j] = from_f32<T>(to_f32(g[at + j]) + acc[p][j]);
      }
    }
  }
}

// Partial sums of dW[dy][dx][ci][co] = sum_pixels x[y+dy-1, x+dx-1, ci] *
// dz[y, x, co] (zero outside the image) and, for dy = 0, of db[co] =
// sum_pixels dz[y, x, co], over range blockIdx.x of the (frame, tile)
// items, into part[range][WGRAD_ENTRIES].  x and dz are [frames, h, w, 64].
template <typename T>
__global__ void __launch_bounds__(WG_THREADS)
wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dz, float* __restrict__ part,
                     int frames, int h, int w) {
  extern __shared__ float smem[];
  float* s_x = smem;                // [WTH][WX][C]: input rows y0-1+dy.., columns x0-1..
  float* s_d = smem + WTH * WX * C;  // [WTH][WTW][C]
  const int dy = blockIdx.y;
  const int tiles_x = (w + WTW - 1) / WTW;
  const int tiles = tiles_x * ((h + WTH - 1) / WTH);
  const long long items = (long long)frames * tiles;
  const long long i0 = items * blockIdx.x / WGRAD_CHUNKS;
  const long long i1 = items * (blockIdx.x + 1) / WGRAD_CHUNKS;
  const int ci0 = (threadIdx.x / 16) * 4, co0 = (threadIdx.x % 16) * 4;
  const bool bias = dy == 0 && ci0 == 0;

  float acc[3][4][4] = {};
  float bacc[4] = {};
  for (long long it = i0; it < i1; ++it) {
    const int f = (int)(it / tiles), tile = (int)(it % tiles);
    const int y0 = (tile / tiles_x) * WTH, x0 = (tile % tiles_x) * WTW;
    const size_t img = (size_t)f * h * w * C;
    __syncthreads();  // the previous item's reads are done
    for (int i = threadIdx.x; i < WTH * WX * C; i += WG_THREADS) {
      const int c = i % C, p = i / C;
      const int gy = y0 - 1 + dy + p / WX, gx = x0 - 1 + p % WX;
      float v = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = to_f32(x[img + ((size_t)gy * w + gx) * C + c]);
      s_x[i] = v;
    }
    for (int i = threadIdx.x; i < WTH * WTW * C; i += WG_THREADS) {
      const int c = i % C, p = i / C;
      const int gy = y0 + p / WTW, gx = x0 + p % WTW;
      float v = 0.f;
      if (gy < h && gx < w) v = to_f32(dz[img + ((size_t)gy * w + gx) * C + c]);
      s_d[i] = v;
    }
    __syncthreads();
    for (int r = 0; r < WTH; ++r) {
#pragma unroll 2
      for (int cc = 0; cc < WTW; ++cc) {
        const float4 d = *reinterpret_cast<const float4*>(s_d + (r * WTW + cc) * C + co0);
        const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 xq = *reinterpret_cast<const float4*>(s_x + (r * WX + cc + dx) * C + ci0);
          const float xv[4] = {xq.x, xq.y, xq.z, xq.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[dx][i][j] = fmaf(xv[i], dv[j], acc[dx][i][j]);
        }
        if (bias) {
#pragma unroll
          for (int j = 0; j < 4; ++j) bacc[j] += dv[j];
        }
      }
    }
  }

  float* out = part + (size_t)blockIdx.x * WGRAD_ENTRIES;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = out + ((size_t)(dy * 3 + dx) * C + ci0 + i) * C + co0;
#pragma unroll
      for (int j = 0; j < 4; ++j) row[j] = acc[dx][i][j];
    }
  if (bias) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[9 * C * C + co0 + j] = bacc[j];
  }
}

// out[e] = sum over the ranges, in order, of part[range][e].
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= WGRAD_ENTRIES) return;
  float s = 0.f;
  for (int r = 0; r < WGRAD_CHUNKS; ++r) s += part[(size_t)r * WGRAD_ENTRIES + e];
  out[e] = s;
}

template <typename T>
int launch_wgrad(const void* x, const void* dz, float* part, float* out, int frames, int h, int w,
                 cudaStream_t stream) {
  auto k = wgrad_partial_kernel<T>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WG_SMEM_BYTES);
  k<<<dim3(WGRAD_CHUNKS, 3), WG_THREADS, WG_SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dz), part, frames, h, w);
  int err = (int)cudaGetLastError();
  if (err) return err;
  wgrad_reduce_kernel<<<(WGRAD_ENTRIES + 255) / 256, 256, 0, stream>>>(part, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_b(const void* dz2, const void* i1, const void* base, const float* w2ft,
                 const float* w2bt, void* d_i1, void* dzsum, void* d_base, float* part,
                 float* gw2f, float* gw2b, int n, int t, int h, int w, cudaStream_t stream) {
  auto k = bwd_b_data_kernel<T>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B_SMEM_BYTES);
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), n);
  k<<<grid, Tile::THREADS, B_SMEM_BYTES, stream>>>(
      static_cast<const T*>(dz2), w2ft, w2bt, static_cast<T*>(d_i1), static_cast<T*>(dzsum),
      static_cast<T*>(d_base), t, h, w);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = launch_wgrad<T>(i1, dz2, part, gw2f, n * t, h, w, stream);
  if (err) return err;
  return launch_wgrad<T>(base, dzsum, part, gw2b, n, h, w, stream);
}

template <typename T>
int launch_bwd_a(const void* dz1, const void* feat, const void* g, const float* w1t, void* d_feat,
                 float* part, float* gw1, int n, int t, int h, int w, cudaStream_t stream) {
  auto k = bwd_a_data_kernel<T>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::SMEM_BYTES);
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), n);
  k<<<grid, Tile::THREADS, Tile::SMEM_BYTES, stream>>>(
      static_cast<const T*>(dz1), static_cast<const T*>(g), w1t, static_cast<T*>(d_feat), t, h,
      w);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_wgrad<T>(feat, dz1, part, gw1, n * t, h, w, stream);
}

// The float32 kernels on the tensor cores, 3xTF32 (see the head of this file).
namespace tf32 {

using namespace pfnl::tf32;  // the data tile (tf32_conv.cuh)

constexpr int OWN = (WIN_CHUNKS + THREADS - 1) / THREADS;  // window chunks a thread owns
constexpr size_t SMEM_DATA = (size_t)(WCONV + WIN) * sizeof(float);

// weight gradients: an item's input rows y0-1+dy.. (TH x WX) and dz tile (TH x TW)
constexpr int WX = TW + 2;
constexpr int WPS = C + 8;                         // their pixel stride (floats)
constexpr int XWIN = TH * WX * WPS, DWIN = TH * TW * WPS;
constexpr int STAGE = XWIN + DWIN;
constexpr size_t SMEM_WGRAD = 2 * (size_t)STAGE * sizeof(float);
static_assert(STAGE % 4 == 0 && WPS % 4 == 0, "16-byte aligned rows");

using WAcc = float[3][4][4];

// A conv's 9 x 64 weight rows of 64 floats into s (rows PS apart).
template <bool ASYNC>
__device__ __forceinline__ void stage_weights(float* s, const float* __restrict__ wt) {
  for (int i = threadIdx.x; i < 9 * C * CPP; i += THREADS) {
    const int r = i / CPP, c = (i % CPP) * 4;
    pfnl::stage_f32x4<ASYNC>(s + r * PS + c, wt + (size_t)r * C + c, true, wt);
  }
}

// out = acc (+ add, where ADD) at the warp's pixels of the tile at (y0, x0)
// of an h x w image [h, w, 64]; out 8-byte aligned, add only where ASYNC.
template <bool ASYNC, bool ADD>
__device__ __forceinline__ void store_tile(float* __restrict__ out, const float* __restrict__ add,
                                           const DAcc& acc, int y0, int x0, int h, int w,
                                           int warp, int lane) {
  const int g = lane / 4, c0 = 32 * (warp % 2) + 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int gy = y0 + 2 * (warp / 2) + mt;
    if (gy >= h) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + g + 8 * half;
      if (gx >= w) continue;
      const size_t at = ((size_t)gy * w + gx) * C + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 v = make_float2(acc[mt][j][2 * half], acc[mt][j][2 * half + 1]);
        if constexpr (ADD) {
          if constexpr (ASYNC) {
            const float2 a = *reinterpret_cast<const float2*>(add + at + 8 * j);
            v.x += a.x;
            v.y += a.y;
          } else {
            v.x += add[at + 8 * j];
            v.y += add[at + 8 * j + 1];
          }
        }
        *reinterpret_cast<float2*>(out + at + 8 * j) = v;
      }
    }
  }
}

// K5's data gradients: d_i1_t = conv(dz2_t, W2f'), dzsum = sum_t dz2_t,
// d_base = conv(dzsum, W2b'), W' = [tap][out][in] of the transposed conv.
template <bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1)
pfrb_bwd_b_tf32_mma_kernel(const float* __restrict__ dz2, const float* __restrict__ w2f,
                           const float* __restrict__ w2b, float* __restrict__ d_i1,
                           float* __restrict__ dzsum, float* __restrict__ d_base, int nt, int h,
                           int w) {
  extern __shared__ __align__(16) float smem16[];
  float* s_w = smem16;          // W2f, then W2b
  float* s_win = smem16 + WCONV;
  int y0, x0;
  tile_origin(w, y0, x0);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t plane = (size_t)h * w * C;

  stage_weights<ASYNC>(s_w, w2f);
  float4 sum[OWN];  // chunk threadIdx.x + THREADS i of the window, summed over frames
#pragma unroll
  for (int i = 0; i < OWN; ++i) sum[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < nt; ++t) {
    const size_t img = ((size_t)b * nt + t) * plane;
    stage_window<ASYNC>(s_win, dz2 + img, h, w, y0, x0, dz2);
    pfnl::cp_async_commit();
    pfnl::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const int ch = threadIdx.x + THREADS * i;
      if (ch < WIN_CHUNKS) {
        const float4 v = *reinterpret_cast<const float4*>(s_win + (ch / CPP) * PS + (ch % CPP) * 4);
        sum[i].x += v.x;
        sum[i].y += v.y;
        sum[i].z += v.z;
        sum[i].w += v.w;
      }
    }
    DAcc acc;
    zero(acc);
    conv3x3(s_win, s_w, warp, lane, acc);
    store_tile<ASYNC, false>(d_i1 + img, nullptr, acc, y0, x0, h, w, warp, lane);
    __syncthreads();  // every warp is done with the window and the weights
  }

  stage_weights<ASYNC>(s_w, w2b);
  pfnl::cp_async_commit();
  float* sum_out = dzsum + (size_t)b * plane;
#pragma unroll
  for (int i = 0; i < OWN; ++i) {
    const int ch = threadIdx.x + THREADS * i;
    if (ch < WIN_CHUNKS) {
      const int p = ch / CPP, c = (ch % CPP) * 4;
      *reinterpret_cast<float4*>(s_win + p * PS + c) = sum[i];
      const int wy = p / IW, wx = p % IW, sy = y0 - 1 + wy, sx = x0 - 1 + wx;
      if (wy >= 1 && wy <= TH && wx >= 1 && wx <= TW && sy < h && sx < w)
        *reinterpret_cast<float4*>(sum_out + ((size_t)sy * w + sx) * C + c) = sum[i];
    }
  }
  pfnl::cp_async_wait<0>();
  __syncthreads();
  DAcc acc;
  zero(acc);
  conv3x3(s_win, s_w, warp, lane, acc);
  store_tile<ASYNC, false>(d_base + (size_t)b * plane, nullptr, acc, y0, x0, h, w, warp, lane);
}

// K6's data gradient: d_feat_t = g_t + conv(dz1_t, W1'), W1' = [tap][out][in].
template <bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1)
pfrb_bwd_a_tf32_mma_kernel(const float* __restrict__ dz1, const float* __restrict__ g,
                           const float* __restrict__ w1, float* __restrict__ d_feat, int nt,
                           int h, int w) {
  extern __shared__ __align__(16) float smem16[];
  float* s_w = smem16;
  float* s_win = smem16 + WCONV;
  int y0, x0;
  tile_origin(w, y0, x0);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t plane = (size_t)h * w * C;

  stage_weights<ASYNC>(s_w, w1);
  for (int t = 0; t < nt; ++t) {
    const size_t img = ((size_t)b * nt + t) * plane;
    stage_window<ASYNC>(s_win, dz1 + img, h, w, y0, x0, dz1);
    pfnl::cp_async_commit();
    pfnl::cp_async_wait<0>();
    __syncthreads();
    DAcc acc;
    zero(acc);
    conv3x3(s_win, s_w, warp, lane, acc);
    store_tile<ASYNC, true>(d_feat + img, g + img, acc, y0, x0, h, w, warp, lane);
    __syncthreads();  // every warp is done with the window
  }
}

// Item `it` (frame, 8x16 tile) for kernel row dy into s: the input rows
// y0-1+dy.. (TH x WX pixels from column x0-1) and the dz tile (TH x TW),
// pixels WPS apart, zero outside the image.
template <bool ASYNC>
__device__ __forceinline__ void stage_item(float* s, const float* __restrict__ x,
                                           const float* __restrict__ dz, long long it, int tiles,
                                           int tiles_x, int dy, int h, int w) {
  const int f = (int)(it / tiles), tile = (int)(it % tiles);
  const int y0 = (tile / tiles_x) * TH, x0 = (tile % tiles_x) * TW;
  const size_t img = (size_t)f * h * w * C;
  for (int i = threadIdx.x; i < TH * WX * CPP; i += THREADS) {
    const int p = i / CPP, c = (i % CPP) * 4;
    const int gy = y0 - 1 + dy + p / WX, gx = x0 - 1 + p % WX;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    pfnl::stage_f32x4<ASYNC>(s + p * WPS + c, x + img + ((ptrdiff_t)gy * w + gx) * C + c, inside,
                             x);
  }
  float* sd = s + XWIN;
  for (int i = threadIdx.x; i < TH * TW * CPP; i += THREADS) {
    const int p = i / CPP, c = (i % CPP) * 4;
    const int gy = y0 + p / TW, gx = x0 + p % TW;
    pfnl::stage_f32x4<ASYNC>(sd + p * WPS + c, dz + img + ((ptrdiff_t)gy * w + gx) * C + c,
                             gy < h && gx < w, dz);
  }
}

// Partial sums of dW[dy][dx][ci][co] = sum_pixels x[y+dy-1, x+dx-1, ci] *
// dz[y, x, co] (zero outside the image) and, for dy = 0, of db[co] =
// sum_pixels dz[y, x, co], over range blockIdx.x of the (frame, tile)
// items, into part[range][WGRAD_ENTRIES].  x and dz are [frames, h, w, 64].
// GEMM M = (dx, ci), 12 m-tiles; warp w owns m-tiles 3 (w / 2) + i and
// output channels 32 (w % 2)..+31.
template <bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_tf32_mma_kernel(const float* __restrict__ x, const float* __restrict__ dz,
                      float* __restrict__ part, int frames, int h, int w) {
  extern __shared__ __align__(16) float smem16[];
  const int dy = blockIdx.y;
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles = tiles_x * ((h + TH - 1) / TH);
  const long long items = (long long)frames * tiles;
  const long long i0 = items * blockIdx.x / WGRAD_CHUNKS;
  const long long i1 = items * (blockIdx.x + 1) / WGRAD_CHUNKS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mg = warp / 2, n0 = 32 * (warp % 2);
  const bool bias = dy == 0 && mg == 0;  // warps 0 and 1 of the dy = 0 blocks sum db
  // the warp's A rows: m-tile 3 mg + i is dx = (3 mg + i) / 4, channels 16 ((3 mg + i) % 4)..
  int a_off[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int mi = 3 * mg + i;
    a_off[i] = (t + mi / 4) * WPS + 16 * (mi % 4) + g;
  }
  const int b_off = t * WPS + n0 + g;

  WAcc acc;
  zero(acc);
  float bacc[4] = {0.f, 0.f, 0.f, 0.f};
  if (i0 < i1) stage_item<ASYNC>(smem16, x, dz, i0, tiles, tiles_x, dy, h, w);
  pfnl::cp_async_commit();
  for (long long it = i0; it < i1; ++it) {
    const float* cur = smem16 + ((it - i0) & 1) * STAGE;
    if (it + 1 < i1) {  // the next item into the other buffer, read two items ago
      stage_item<ASYNC>(smem16 + ((it + 1 - i0) & 1) * STAGE, x, dz, it + 1, tiles, tiles_x, dy, h,
                        w);
      pfnl::cp_async_commit();
      pfnl::cp_async_wait<1>();
    } else {
      pfnl::cp_async_wait<0>();
    }
    __syncthreads();
    const float* sd = cur + XWIN;
    WAcc part;  // this item's sums: 48 mma a chain, then added into acc in float32
    zero(part);
#pragma unroll 2
    for (int ks = 0; ks < TH * TW / 8; ++ks) {  // k-step: 8 pixels of tile row ks / 2
      const int r = ks / 2, c0 = (ks % 2) * 8;
      uint32_t b[4][2][2], a[3][2][4];  // [tile][hi, lo][register]
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // (k t: pixel c0 + t, n g: channel n0 + 8 j + g)
        const float* bp = sd + (r * TW + c0) * WPS + b_off + 8 * j;
        const float v0 = bp[0], v1 = bp[4 * WPS];
        pfnl::split_tf32(v0, b[j][0][0], b[j][1][0]);
        pfnl::split_tf32(v1, b[j][0][1], b[j][1][1]);
        if (bias) bacc[j] += v0 + v1;
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {  // (m g: channel, k t: pixel c0 + t, shifted by dx)
        const float* ap = cur + (r * WX + c0) * WPS + a_off[i];
        pfnl::split_tf32(ap[0], a[i][0][0], a[i][1][0]);
        pfnl::split_tf32(ap[8], a[i][0][1], a[i][1][1]);
        pfnl::split_tf32(ap[4 * WPS], a[i][0][2], a[i][1][2]);
        pfnl::split_tf32(ap[4 * WPS + 8], a[i][0][3], a[i][1][3]);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pfnl::mma_3xtf32(part[i][j], a[i], b[j]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  float* out = part + (size_t)blockIdx.x * WGRAD_ENTRIES;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int mi = 3 * mg + i, dx = mi / 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = 16 * (mi % 4) + g + 8 * half;
      float* row = out + ((size_t)(dy * 3 + dx) * C + ci) * C + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
    }
  }
  if (bias) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // the quad's four pixel columns, in a fixed order
      float v = bacc[j];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) out[9 * C * C + n0 + 8 * j + g] = v;
    }
  }
}

int launch_wgrad(const float* x, const float* dz, float* part, float* out, int frames, int h,
                 int w, cudaStream_t stream) {
  auto k = pfnl::aligned16({x, dz}) ? &wgrad_tf32_mma_kernel<true>
                                     : &wgrad_tf32_mma_kernel<false>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_WGRAD);
  k<<<dim3(WGRAD_CHUNKS, 3), THREADS, SMEM_WGRAD, stream>>>(x, dz, part, frames, h, w);
  int err = (int)cudaGetLastError();
  if (err) return err;
  wgrad_reduce_kernel<<<(WGRAD_ENTRIES + 255) / 256, 256, 0, stream>>>(part, out);
  return (int)cudaGetLastError();
}

int launch_bwd_b(const float* dz2, const float* i1, const float* base, const float* w2f,
                 const float* w2b, float* d_i1, float* dzsum, float* d_base, float* part,
                 float* gw2f, float* gw2b, int n, int t, int h, int w, cudaStream_t stream) {
  auto k = pfnl::aligned16({dz2, w2f, w2b}) ? &pfrb_bwd_b_tf32_mma_kernel<true>
                                            : &pfrb_bwd_b_tf32_mma_kernel<false>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_DATA);
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), n);
  k<<<grid, THREADS, SMEM_DATA, stream>>>(dz2, w2f, w2b, d_i1, dzsum, d_base, t, h, w);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = launch_wgrad(i1, dz2, part, gw2f, n * t, h, w, stream);
  if (err) return err;
  return launch_wgrad(base, dzsum, part, gw2b, n, h, w, stream);
}

int launch_bwd_a(const float* dz1, const float* feat, const float* g, const float* w1,
                 float* d_feat, float* part, float* gw1, int n, int t, int h, int w,
                 cudaStream_t stream) {
  auto k = pfnl::aligned16({dz1, g, w1}) ? &pfrb_bwd_a_tf32_mma_kernel<true>
                                         : &pfrb_bwd_a_tf32_mma_kernel<false>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_DATA);
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), n);
  k<<<grid, THREADS, SMEM_DATA, stream>>>(dz1, g, w1, d_feat, t, h, w);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_wgrad(feat, dz1, part, gw1, n * t, h, w, stream);
}

}  // namespace tf32

}  // namespace

// C interface, loaded with ctypes.  Activations [n,t,h,w,64] (base,
// dzsum, d_base [n,h,w,64]) of float or bf16; the transposed convs'
// kernels W2f^T, W2b^T, W1^T as float32, rounded to the activation type by
// the caller: for the float32 entries [3,3,64 out,64 in] (the forward
// kernel flipped in space, [3,3,Ci,Co] of the forward), for the bf16
// entries HWIO mirror_t; part is float32 scratch of
// pfnl_wgrad_scratch_floats() floats; each gradient output gw* holds
// pfnl_wgrad_entries() floats: dW [3,3,64,64] (HWIO) then db [64].
// Launches run in order on `stream`; each returns the first non-zero
// cudaGetLastError().
extern "C" {

int pfnl_wgrad_entries() { return WGRAD_ENTRIES; }
int pfnl_wgrad_scratch_floats() { return WGRAD_CHUNKS * WGRAD_ENTRIES; }

int pfnl_pfrb_bwd_b_f32(const void* dz2, const void* i1, const void* base, const float* w2ft,
                        const float* w2bt, void* d_i1, void* dzsum, void* d_base, float* part,
                        float* gw2f, float* gw2b, int n, int t, int h, int w, void* stream) {
  return tf32::launch_bwd_b(static_cast<const float*>(dz2), static_cast<const float*>(i1),
                            static_cast<const float*>(base), w2ft, w2bt, static_cast<float*>(d_i1),
                            static_cast<float*>(dzsum), static_cast<float*>(d_base), part, gw2f,
                            gw2b, n, t, h, w, static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_bwd_b_bf16(const void* dz2, const void* i1, const void* base, const float* w2ft,
                         const float* w2bt, void* d_i1, void* dzsum, void* d_base, float* part,
                         float* gw2f, float* gw2b, int n, int t, int h, int w, void* stream) {
  return launch_bwd_b<__nv_bfloat16>(dz2, i1, base, w2ft, w2bt, d_i1, dzsum, d_base, part, gw2f,
                                     gw2b, n, t, h, w, static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_bwd_a_f32(const void* dz1, const void* feat, const void* g, const float* w1t,
                        void* d_feat, float* part, float* gw1, int n, int t, int h, int w,
                        void* stream) {
  return tf32::launch_bwd_a(static_cast<const float*>(dz1), static_cast<const float*>(feat),
                            static_cast<const float*>(g), w1t, static_cast<float*>(d_feat), part,
                            gw1, n, t, h, w, static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_bwd_a_bf16(const void* dz1, const void* feat, const void* g, const float* w1t,
                         void* d_feat, float* part, float* gw1, int n, int t, int h, int w,
                         void* stream) {
  return launch_bwd_a<__nv_bfloat16>(dz1, feat, g, w1t, d_feat, part, gw1, n, t, h, w,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
