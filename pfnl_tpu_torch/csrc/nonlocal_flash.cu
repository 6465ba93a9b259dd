// Kernel 1: streaming-softmax ("flash") non-local attention,
//
//     out = softmax(theta @ phi^T) @ g        per batch element, NO 1/sqrt(d)
//
// Replaces the TPU kernel pfnl_tpu/ops/pallas/nonlocal_flash.py:nonlocal_flash
// (_kernel), which carries the running max, denominator and accumulator in
// VMEM scratch across a sequential key-block grid axis and pads D to 128
// lanes.  On the GPU a block owns its queries and walks all key tiles itself.
// Keys past M are masked to -inf, queries past N are computed and dropped.
//
// bf16 (the serving path): a FlashAttention-2-style kernel on the tensor
// cores, mma.sync m16n8k16 with float32 accumulation (mma.cuh).
//   - A block is 4 warps and 64 queries; each warp owns 16 query rows, and
//     their Q fragments stay in registers for the whole key loop.  D and Dv
//     are zero-padded to DP = 96 in shared memory (6 k-steps for QK^T, 12
//     n-tiles for PV); 84 -> 96 costs 14% of the products.  The Q tile is
//     staged once, in V's second buffer before its first use, so a block
//     takes 52 KB of shared memory and, bounded to 128 registers a thread,
//     four blocks (16 warps) fit an SM: the softmax between the two
//     products is a serial chain in each warp, and other warps hide it.
//   - K and V tiles of 64 keys are double-buffered in shared memory and
//     filled by cp.async while the previous tile computes.  A row of 84
//     bf16 is 168 bytes, only 8-byte aligned, so rows are copied as 8-byte
//     cp.async chunks (the pad columns and rows past M zero-filled with
//     src-size 0) into rows padded to 104 elements (208 bytes): the eight
//     row addresses of an ldmatrix then fall on distinct banks.  Inputs
//     whose D or base is not 8-byte aligned are staged element by element.
//   - S = Q K^T (K fragments by ldmatrix from the key-major tile) lands in
//     float32 registers; the online softmax stays there: row max and sum
//     over the quad that shares a row (two xor shuffles), exp2f with
//     log2(e) folded into one fma per score.
//   - PV: P is rounded to bf16 where the TPU kernel rounds it
//     (p.astype(v.dtype)), and reused from the S accumulators as the A
//     operand with no trip through shared memory; V fragments come by
//     ldmatrix.trans.  The denominator is summed from the float32 p, as
//     there.  The output is acc / l, rounded once to bf16.
//   - Every key tile holds a valid key, so the first tile's max is finite
//     and the rescale exp2f(m_old - m_new) is exp2f(-inf) = 0 only then.
//   - Sums run in a fixed order without atomics: bitwise reproducible.
// Bound on the H100: PFNL attends over N = M = 90*160 = 14400 positions of
// 84 channels, 2*N*M*(D+Dv) = 70 GFLOP per window against 7 MB of inputs:
// compute-bound on the tensor cores.  Each warp reads the whole K and V
// tile from shared memory for its 16 rows (96 KB a tile a block for 1.6
// MFLOP), so shared-memory bandwidth, not mma issue, caps this design near
// half the 989 TFLOP/s peak; PERF.md has what it reaches.  Left for later:
// wgmma on 64-row warpgroup tiles with K/V fed by TMA and a producer warp
// (warp specialisation), which reads each K/V tile once per warpgroup and
// overlaps one tile's softmax with the next tile's products.
//
// float32 (tests and the float32 model; no float32 main path runs it): the
// first design, float FMAs on CUDA cores.  One block of 128 threads owns 64
// queries; D and Dv are taken as they are (<= 96).
//
//   per key tile:  S = Q K^T      (each thread 4 queries x 8 keys, float FMA)
//                  running max / rescale / exp, two threads per query row
//                  acc = acc*alpha + P V   (each thread one query x Dv/2)
//
// Tensor cores would mean TF32 in float32, which cannot hold the 1e-4
// float32 check against the plain version.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using pfnl::from_f32;
using pfnl::to_f32;

constexpr int BQ = 64, BK = 64, NT = 128;
constexpr int DMAX = 96;      // largest D and Dv taken
constexpr int DVH = DMAX / 2;  // accumulator columns per thread
constexpr int PS = BK + 1;     // score-row stride in shared memory

static_assert(NT == 2 * BQ, "two threads per query row in the softmax and PV phases");

template <typename T>
__device__ void load_rows(float* dst, int ld_dst, const T* __restrict__ src, int row0, int rows,
                          int nrows, int d) {
  for (int i = threadIdx.x; i < rows * d; i += NT) {
    const int r = i / d, c = i % d;
    dst[r * ld_dst + c] = (row0 + r < nrows) ? to_f32(src[(size_t)(row0 + r) * d + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
nonlocal_flash_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                      const T* __restrict__ g, T* __restrict__ out, int n, int m, int d,
                      int dv) {
  extern __shared__ float smem[];
  const int ds = d | 1;  // odd row stride: the 8 key rows a warp reads hit distinct banks
  float* s_q = smem;                // [BQ][ds]
  float* s_k = s_q + BQ * ds;       // [BK][ds]
  float* s_v = s_k + BK * ds;       // [BK][dv]
  float* s_p = s_v + BK * dv;       // [BQ][PS] scores, then probabilities

  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  theta += (size_t)b * n * d;
  phi += (size_t)b * m * d;
  g += (size_t)b * m * dv;
  out += (size_t)b * n * dv;

  // score phase: queries qg + 16*i, keys kg + 8*j
  const int kg = threadIdx.x % 8, qg = threadIdx.x / 8;
  // softmax / PV phase: query row qr, value columns [half*DVH, half*DVH+DVH)
  const int qr = threadIdx.x / 2, half = threadIdx.x % 2;
  const int v0 = half * DVH;

  load_rows(s_q, ds, theta, q0, BQ, n, d);

  float acc[DVH];
#pragma unroll
  for (int j = 0; j < DVH; ++j) acc[j] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < m; k0 += BK) {
    __syncthreads();  // the previous tile's reads of s_k, s_v, s_p are done
    load_rows(s_k, ds, phi, k0, BK, m, d);
    load_rows(s_v, dv, g, k0, BK, m, dv);
    __syncthreads();

    float s[4][8] = {};
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(qg + 16 * i) * ds + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = s_k[(kg + 8 * j) * ds + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = kg + 8 * j;
        s_p[(qg + 16 * i) * PS + key] = (k0 + key < m) ? s[i][j] : -INFINITY;
      }
    __syncthreads();

    // online softmax of row qr; the two threads of a row are lanes 2r, 2r+1
    float* row = s_p + qr * PS;
    float mx = -INFINITY;
    for (int kk = half; kk < BK; kk += 2) mx = fmaxf(mx, row[kk]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);  // finite: every tile holds a valid key
    const float alpha = expf(m_run - m_new);
    float lsum = 0.f;
    for (int kk = half; kk < BK; kk += 2) {
      const float p = expf(row[kk] - m_new);
      row[kk] = p;
      lsum += p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    l_run = l_run * alpha + lsum;
    m_run = m_new;
    __syncwarp();  // the partner lane's probabilities are visible

#pragma unroll
    for (int j = 0; j < DVH; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = row[kk];
      const float* vr = s_v + kk * dv + v0;
#pragma unroll
      for (int j = 0; j < DVH; ++j)
        if (v0 + j < dv) acc[j] = fmaf(p, vr[j], acc[j]);
    }
  }

  if (q0 + qr < n) {
    const float inv = 1.f / l_run;
    T* dst = out + (size_t)(q0 + qr) * dv;
#pragma unroll
    for (int j = 0; j < DVH; ++j)
      if (v0 + j < dv) dst[v0 + j] = from_f32<T>(acc[j] * inv);
  }
}

template <typename T>
int launch(const void* theta, const void* phi, const void* g, void* out, int b, int n, int m,
           int d, int dv, cudaStream_t stream) {
  if (d < 1 || d > DMAX || dv < 1 || dv > DMAX || n < 1 || m < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  const int ds = d | 1;
  const size_t smem = (size_t)(BQ * ds + BK * ds + BK * dv + BQ * PS) * sizeof(float);
  auto k = nonlocal_flash_kernel<T>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((n + BQ - 1) / BQ, b);
  k<<<grid, NT, smem, stream>>>(static_cast<const T*>(theta), static_cast<const T*>(phi),
                                static_cast<const T*>(g), static_cast<T*>(out), n, m, d, dv);
  return (int)cudaGetLastError();
}


// The bf16 tensor-core kernel (see the head of this file).
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4, NT = WARPS * 32;
constexpr int BQ = 16 * WARPS, BK = 64;
constexpr int DP = 96;       // D and Dv zero-padded to this in shared memory
constexpr int LDS = DP + 8;  // row stride (208 bytes): ldmatrix rows on distinct banks
constexpr int KC = DP / 16;  // k-steps of QK^T
constexpr int NV = DP / 8;   // n-tiles of the output
constexpr int NS = BK / 8;   // n-tiles of a score tile
constexpr int VEC = 4;       // elements per staged chunk (8 bytes)
constexpr size_t SMEM_BYTES = (size_t)4 * BK * LDS * sizeof(bf16);  // K, V: two buffers each
constexpr float LOG2E = 1.4426950408889634f;

// Rows [row0, row0 + 64) of src [nrows, d] into dst [64][LDS], all DP
// columns: columns past d and rows past nrows are zero.
template <bool ASYNC>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int row0,
                                           int nrows, int d) {
  constexpr int CH = DP / VEC;
  for (int i = threadIdx.x; i < 64 * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * VEC, row = row0 + r;
    const int n = row < nrows ? min(max(d - c, 0), VEC) : 0;
    pfnl::stage_chunk<VEC, ASYNC>(dst + r * LDS + c, src + (size_t)row * d + c, n, src);
  }
}

template <bool ASYNC>
__global__ void __launch_bounds__(NT, 4)
nonlocal_flash_bf16_mma_kernel(const bf16* __restrict__ theta, const bf16* __restrict__ phi,
                               const bf16* __restrict__ g, bf16* __restrict__ out, int n, int m,
                               int d, int dv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);  // [2][BK][LDS]
  bf16* s_v = s_k + 2 * BK * LDS;                 // [2][BK][LDS]
  bf16* s_q = s_v + BK * LDS;  // [BQ][LDS] in V's second buffer until the Q fragments are read

  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  theta += (size_t)b * n * d;
  phi += (size_t)b * m * d;
  g += (size_t)b * m * dv;
  out += (size_t)b * n * dv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nt = (m + BK - 1) / BK;

  stage_rows<ASYNC>(s_q, theta, q0, n, d);
  stage_rows<ASYNC>(s_k, phi, 0, m, d);
  stage_rows<ASYNC>(s_v, g, 0, m, dv);
  pfnl::cp_async_commit();
  pfnl::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    pfnl::ldmatrix_x4(qf[kc], s_q + (warp * 16 + lane % 16) * LDS + kc * 16 + (lane / 16) * 8);
  __syncthreads();  // the Q tile is read before tile 1 refills its buffer

  float o[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // rows lane/4 and lane/4 + 8 of the warp's 16: running max (raw scores)
  // and denominator
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < nt; ++t) {
    const int cur = t & 1;
    if (t + 1 < nt) {  // the next tile into the other buffer, read two iterations ago
      stage_rows<ASYNC>(s_k + (cur ^ 1) * BK * LDS, phi, (t + 1) * BK, m, d);
      stage_rows<ASYNC>(s_v + (cur ^ 1) * BK * LDS, g, (t + 1) * BK, m, dv);
      pfnl::cp_async_commit();
      pfnl::cp_async_wait<1>();
    } else {
      pfnl::cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T: n-tiles j, j+1 from one ldmatrix.x4 of keys 8j..8j+15
    const bf16* kb = s_k + cur * BK * LDS;
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bk[4];
        pfnl::ldmatrix_x4(bk, kb + (8 * (j + lane / 16) + lane % 8) * LDS + kc * 16 +
                                  ((lane / 8) % 2) * 8);
        pfnl::mma_bf16(s[j], qf[kc], bk[0], bk[1]);
        pfnl::mma_bf16(s[j + 1], qf[kc], bk[2], bk[3]);
      }
    }
    if ((t + 1) * BK > m) {  // the last tile: keys past M are -inf
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t * BK + 8 * j + 2 * (lane % 4) + (e & 1) >= m) s[j][e] = -INFINITY;
    }

    // online softmax of the two rows, over the quad that holds them
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], ml[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m_run[r] - mx[r]) * LOG2E);  // 0 on the first tile
      ml[r] = mx[r] * LOG2E;
      m_run[r] = mx[r];
    }
    // p = exp(s - max) as exp2(s*log2e - max*log2e); P rounded to bf16 as
    // the A fragments of PV: keys 16kk..16kk+15 are n-tiles 2kk and 2kk+1
    uint32_t pf[NS / 2][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = exp2f(fmaf(s[j][0], LOG2E, -ml[0]));
      const float p1 = exp2f(fmaf(s[j][1], LOG2E, -ml[0]));
      const float p2 = exp2f(fmaf(s[j][2], LOG2E, -ml[1]));
      const float p3 = exp2f(fmaf(s[j][3], LOG2E, -ml[1]));
      lsum[0] += p0 + p1;
      lsum[1] += p2 + p3;
      pf[j / 2][(j % 2) * 2] = pfnl::pack_bf16(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pfnl::pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + lsum[r];
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: n-tiles j, j+1 of Dv from one ldmatrix.x4.trans of 16 keys
    const bf16* vb = s_v + cur * BK * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NV; j += 2) {
        uint32_t bv[4];
        pfnl::ldmatrix_x4_trans(bv, vb + (16 * kk + ((lane / 8) % 2) * 8 + lane % 8) * LDS +
                                        8 * (j + lane / 16));
        pfnl::mma_bf16(o[j], pf[kk], bv[0], bv[1]);
        pfnl::mma_bf16(o[j + 1], pf[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer `cur` before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + lane / 4 + 8 * r;
    if (row >= n) continue;
    bf16* dst = out + (size_t)row * dv;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      if (c < dv) dst[c] = __float2bfloat16_rn(o[j][2 * r] / l_run[r]);
      if (c + 1 < dv) dst[c + 1] = __float2bfloat16_rn(o[j][2 * r + 1] / l_run[r]);
    }
  }
}

int launch(const void* theta, const void* phi, const void* g, void* out, int b, int n, int m,
           int d, int dv, cudaStream_t stream) {
  if (d < 1 || d > DP || dv < 1 || dv > DP || n < 1 || m < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  // 8-byte cp.async needs every row and every base 8-byte aligned
  const bool async = d % VEC == 0 && dv % VEC == 0 &&
                     ((reinterpret_cast<uintptr_t>(theta) | reinterpret_cast<uintptr_t>(phi) |
                       reinterpret_cast<uintptr_t>(g)) & 7) == 0;
  auto k = async ? &nonlocal_flash_bf16_mma_kernel<true> : &nonlocal_flash_bf16_mma_kernel<false>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  const dim3 grid((n + BQ - 1) / BQ, b);
  k<<<grid, NT, SMEM_BYTES, stream>>>(static_cast<const bf16*>(theta),
                                      static_cast<const bf16*>(phi), static_cast<const bf16*>(g),
                                      static_cast<bf16*>(out), n, m, d, dv);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// C interface, loaded with ctypes.  theta [b,n,d], phi [b,m,d], g [b,m,dv],
// out [b,n,dv], all contiguous, of float or bf16; d, dv <= 96.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes it
// does not take).
extern "C" {

int pfnl_nonlocal_flash_f32(const void* theta, const void* phi, const void* g, void* out, int b,
                            int n, int m, int d, int dv, void* stream) {
  return launch<float>(theta, phi, g, out, b, n, m, d, dv, static_cast<cudaStream_t>(stream));
}

int pfnl_nonlocal_flash_bf16(const void* theta, const void* phi, const void* g, void* out, int b,
                             int n, int m, int d, int dv, void* stream) {
  return tc::launch(theta, phi, g, out, b, n, m, d, dv, static_cast<cudaStream_t>(stream));
}

const char* pfnl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
