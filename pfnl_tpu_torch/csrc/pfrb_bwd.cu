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
// channel-transposed kernel (mirror_t, built by the wrapper), so the data
// gradients reuse conv_tile.cuh: one block per (sample, 8x16 tile), the
// frame loop inside the block as in kernel 3.  K5 adds every frame's
// staged dz2 window (tile plus its 1-pixel halo) into a second shared
// buffer, so sum_t dz2 over the halo is at hand for d_base and no
// reduction crosses blocks.
//
// The weight and bias gradients are reductions over all N*T*H*W pixels: a
// GEMM patches^T * dZ with K = pixels.  Blocks run in no order on the GPU,
// so instead of the TPU's revisited accumulator they are made
// deterministic in two launches: wgrad_partial_kernel splits the
// (frame, 8x16 tile) items into WGRAD_CHUNKS fixed contiguous ranges, one
// block per (range, kernel row dy) keeps its 3 x 64 x 64 partial sums in
// registers (thread: 4 input x 4 output channels for each dx) and writes
// them out; wgrad_reduce_kernel then sums the ranges in a fixed order.  No
// float atomics: two runs on the same inputs agree bit for bit.
//
// Bound on the H100: at the paper's training shape (batch 16, 7 frames,
// LR 32x32) each PFRB backward is about 2x its forward: three 3x3 data
// convs, two 3x3 weight gradients on the frames and one of each on the
// base, about 36 GFLOP, so 0.72 TFLOP in K5+K6 over the 20 blocks of a
// step, against about 0.2 GB of activations read: compute-bound.  This
// simple design runs float FMAs on CUDA cores (67 TFLOP/s peak), not the
// tensor cores.  Left for later: implicit-GEMM data and weight gradients
// on mma.sync/wgmma, the weight gradients fused into the data-gradient
// blocks (they stage the same windows), and one kernel for B and A.
#include "conv_tile.cuh"

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

}  // namespace

// C interface, loaded with ctypes.  Activations [n,t,h,w,64] (base,
// dzsum, d_base [n,h,w,64]) of float or bf16; the mirrored kernels
// W2f^T, W2b^T, W1^T [3,3,64,64] float32, already rounded to the
// activation type by the caller; part is float32 scratch of
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
  return launch_bwd_b<float>(dz2, i1, base, w2ft, w2bt, d_i1, dzsum, d_base, part, gw2f, gw2b, n,
                             t, h, w, static_cast<cudaStream_t>(stream));
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
  return launch_bwd_a<float>(dz1, feat, g, w1t, d_feat, part, gw1, n, t, h, w,
                             static_cast<cudaStream_t>(stream));
}

int pfnl_pfrb_bwd_a_bf16(const void* dz1, const void* feat, const void* g, const float* w1t,
                         void* d_feat, float* part, float* gw1, int n, int t, int h, int w,
                         void* stream) {
  return launch_bwd_a<__nv_bfloat16>(dz1, feat, g, w1t, d_feat, part, gw1, n, t, h, w,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
