// Kernel 1: streaming-softmax ("flash") non-local attention,
//
//     out = softmax(theta @ phi^T) @ g        per batch element, NO 1/sqrt(d)
//
// Replaces the TPU kernel pfnl_tpu/ops/pallas/nonlocal_flash.py:nonlocal_flash
// (_kernel), which carries the running max, denominator and accumulator in
// VMEM scratch across a sequential key-block grid axis and pads D to 128
// lanes.  Here one block of 128 threads owns 64 queries and walks all key
// tiles of 64 itself; D and Dv are taken as they are (<= 96, bounds-checked),
// keys past M are masked to -inf, queries past N are computed and dropped.
//
//   per key tile:  S = Q K^T      (each thread 4 queries x 8 keys, float FMA)
//                  running max / rescale / exp, two threads per query row
//                  acc = acc*alpha + P V   (each thread one query x Dv/2)
//
// Scores, the softmax and the accumulator are float; inputs may be bf16
// (products of two bf16 values are exact in float); the output is written
// in g's type.
//
// Bound on the H100: PFNL attends over N = M = 90*160 = 14400 positions of
// 84 channels, 2*N*M*(D+Dv) = 70 GFLOP per window against 7 MB of inputs:
// compute-bound.  This simple design runs on CUDA cores at float rate.
// Left for later: QK^T and PV on tensor cores (mma.sync/wgmma with D padded
// to 96), K/V tiles double-buffered with cp.async or TMA, exp2 with a
// folded log2(e).
#include <math.h>

#include "common.cuh"

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
  return launch<__nv_bfloat16>(theta, phi, g, out, b, n, m, d, dv,
                               static_cast<cudaStream_t>(stream));
}

const char* pfnl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
