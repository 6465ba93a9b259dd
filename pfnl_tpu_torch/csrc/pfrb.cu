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
// Bound on the H100: at the main path's geometry ([2,7,180,320,64]) kernel
// A does 9 + 1 products of 64x64 per pixel and frame, 66.1 GFLOP (0.067 ms
// at 989 TFLOP/s bf16), against 221 MB of bf16 activations moved (0.066 ms
// at 3.35 TB/s): operations, barely.  Kernel B does 8 taps x 9 products
// over T + 1 images, 67.9 GFLOP (0.069 ms) against 325 MB (0.097 ms):
// bytes and operations nearly even.
//
// bf16 (the serving path): an implicit GEMM per conv on the tensor cores,
// mma.sync m16n8k16 with float32 accumulation (mma.cuh).
//   - M = the pixels of the block's tile, N = the 64 output channels, K =
//     9 x 64 walked as (tap, 16-channel k-step).  A block is 8 warps and an
//     8 x 32 pixel tile; a warp owns one output row of 32 pixels (two
//     m-tiles) x all 64 channels (eight n-tiles), so each A fragment feeds
//     8 mma and each B fragment 2.  A tap shift is another set of ldmatrix
//     row addresses into the staged (8+2) x (32+2) window: no im2col.
//   - The conv's weights, 9 x 64 x 64 bf16 (rounded once by the caller),
//     are loaded once per block by cp.async and stay in shared memory for
//     the whole frame loop, rows padded to 72 elements (144 bytes) so the
//     eight rows of an ldmatrix(.trans) fall on distinct banks; so are the
//     window's pixels (64 channels padded to 72).
//   - Frame windows are double-buffered: cp.async fills frame t+1's while
//     frame t computes.  Halo pixels outside the image are zero-filled with
//     src-size 0 and never read.  Inputs not 16-byte aligned (a view at an
//     odd offset) are staged element by element by another instantiation
//     of the same kernel.
//   - Kernel A's fusion stays in registers: frame t's epilogue (+b1,
//     lrelu, round to bf16) writes i1_t and repacks the same rounded values
//     from the accumulator layout into A fragments (C -> A, as kernel 1
//     reuses P), which feed base_acc += i1_t @ Wfuse_t directly; the 8 KB
//     Wfuse_t slice is staged with the frame's window.  base_acc stays in
//     float32 across the frame loop and is rounded once at the end.  The
//     Pallas kernel rounds the partial sum at each 4-frame group instead
//     (about one bf16 ulp of max|base| apart; tests/test_torch_pfrb.py).
//   - Kernel B computes conv3x3(base, W2b) once into float32 registers
//     (W2b then gives its shared memory to W2f), then per frame
//     conv3x3(i1_t, W2f) + that + b2, lrelu, + feat_t (read as bf16, added
//     in float32), one rounding, as the Pallas kernel keeps frame_part +
//     bpart in float32.
//   - Two float32 accumulators of 32 pixels x 64 channels (128 registers a
//     thread) live across the frame loop, so a warp owns 32 pixels, not 64,
//     and a block runs alone on its SM (199 KB / 181 KB of shared memory).
//     Per k-step a warp reads 3 KB of fragments from shared memory for 16
//     mma: shared-memory bandwidth caps this tile near two thirds of the
//     mma.sync rate.
//   - No atomics, every sum in a fixed order: bitwise reproducible.
// Left for later: wgmma with TMA-fed windows and warp specialisation,
// fusing B of block k with A of block k+1 (i1 and base never leave the
// chip), and a CUDA graph over the chain.
//
// float32 (training and the float32 model): the first design, float FMAs
// on CUDA cores through conv_tile.cuh.  One block per (sample, 8x16 pixel
// tile), 256 threads; kernel A pushes the rounded i1 tile through shared
// memory to feed the fusion product; kernel B computes the base conv once
// into registers.  One TF32 product a float32 product cannot hold the 1e-4
// float32 check against the plain version (about 3e-4); the 3xTF32 split of
// kernels 5-6 (pfrb_bwd.cu) holds it at about 1e-6 and is the candidate.
#include "conv_tile.cuh"
#include "mma.cuh"

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
  return launch_a<float>(feat, w1, b1, wfuse, bfuse, i1, base, n, t, h, w,
                         static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_a_bf16(const void* feat, const void* w1, const float* b1, const void* wfuse,
                     const float* bfuse, void* i1, void* base, int n, int t, int h, int w,
                     void* stream) {
  return tc::launch_a(feat, w1, b1, wfuse, bfuse, i1, base, n, t, h, w,
                      static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_b_f32(const void* feat, const void* i1, const void* base, const float* w2f,
                    const float* w2b, const float* b2, void* out, int n, int t, int h, int w,
                    void* stream) {
  return launch_b<float>(feat, i1, base, w2f, w2b, b2, out, n, t, h, w,
                         static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_b_bf16(const void* feat, const void* i1, const void* base, const void* w2f,
                     const void* w2b, const float* b2, void* out, int n, int t, int h, int w,
                     void* stream) {
  return tc::launch_b(feat, i1, base, w2f, w2b, b2, out, n, t, h, w,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
