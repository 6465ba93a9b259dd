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
// bf16 (the serving path): a warp-specialised kernel on Hopper's warpgroup
// tensor cores (wgmma, float32 accumulation; wgmma.cuh), in two launches
// that both carry the name nonlocal_flash:
//   - nonlocal_flash_pack_kernel copies phi and g, tile of BK = 128 keys by
//     tile, into a buffer that the op allocates: K as [128][96] in three
//     64-byte swizzled panels (D zero-padded to 96: 6 k-steps of 16), then
//     V transposed as [DVP][128] in two 128-byte swizzled panels (Dv
//     zero-padded to DVP = 88 for Dv <= 88, as PFNL's 84, else 96), zero
//     past M.  A row of 84 bf16 is 168 bytes, not the 16-byte multiple a
//     bulk copy or tensor map needs; a packed tile is one contiguous 46-48
//     KB block in the layout wgmma reads.  It takes 0.3% of the op's
//     device time at 4K and 2.6% at 720p (PERF.md).
//   - nonlocal_flash_bf16_wgmma_kernel: a block of 384 threads owns 128
//     queries of one window.  Warpgroup 2 is the producer: it gives up
//     registers (setmaxnreg 40) and one thread keeps a ring of 4 packed
//     tiles in shared memory full, one bulk copy a tile, on full/empty
//     mbarrier pairs.  Warpgroups 0 and 1 (232 registers a thread) each
//     own 64 query rows: their Q tile is staged once (zero-padded, rows
//     past N zero) and held in registers as wgmma A fragments (24 regs).
//     Per key tile: S = Q K^T by 6 m64n128k16 (A from registers, K from the
//     ring), the online softmax on S's float32 fragments (64 a thread),
//     then O += P V by 8 m64nDVPk16 with P from registers (O 44 regs).
//     Tile t's S product is issued with tile t-1's PV.  The two warpgroups
//     take turns on the tensor cores (named barriers): one issues its
//     products only after the other has issued its own, so that one's
//     softmax runs while the other's products do.  Shared memory: 24 KB of
//     Q and 4 x 46 KB of ring, one block an SM.
//   - Numerics as the mma.sync design before it had them: scores and
//     the online softmax in float32, no 1/sqrt(d), p = exp2(s*log2(e) -
//     max*log2(e)) with one fma a score (ex2.approx.ftz: a p below 2^-126
//     of the row's max flushes to zero); P rounded to bf16 where the TPU
//     kernel rounds it (p.astype(v.dtype)); the denominator summed from the
//     float32 p; the output acc / l, rounded once to bf16.  Keys past M are
//     masked to -inf in the last tile only; every tile holds a valid key, so
//     the first tile's max is finite and its rescale ex2(-inf) = 0.  Sums
//     run in a fixed order without atomics: bitwise reproducible.
//   - Any alignment: the pack and the Q staging read elements (16-byte
//     loads where a tile's rows start 16-byte aligned), the output is
//     written in bf16 pairs where dv and out allow.
// Bound on the H100: PFNL attends over N = M = 270*480 = 129,600 positions
// at 4K (14,400 at 720p) of D = Dv = 84 channels, 2*N*M*(D+Dv) = 5.64
// TFLOP a window against 65 MB of inputs: compute-bound, 5.7 ms a window at
// 989 TFLOP/s.  The padding runs 184/168 of the counted products (6 k-steps
// of 96, N = 88), so the counted roofline tops out near 91%.  The exps,
// N*M = 1.68e10 a window on the SFU's 16 a clock an SM (about 4.0 ms at
// 1.98 GHz), cost two thirds of the padded tensor-core time, so they must
// overlap the products rather than follow them.  Reached (PERF.md, section 6): 52-55% of the
// counted peak at 4K, 44-46% at 720p (3.4 waves of 128-query blocks over
// 132 SMs).  What holds it back: without the softmax the same pipeline
// reaches 78% at 4K, so the serial softmax of a warpgroup (about 500
// instructions a warp a tile, 66 of them on the SFU) outlasts the other
// warpgroup's products; ptxas places the wait for a warpgroup's own PV
// ahead of its softmax, so the two do not overlap within a warpgroup; and
// at 4K the card runs at its 700 W limit, its SM clock down to 1.70-1.88
// GHz.
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
#include "wgmma.cuh"

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


// The bf16 kernel on the warpgroup tensor cores (see the head of this file).
namespace tc {

using bf16 = __nv_bfloat16;
using namespace pfnl;

constexpr int BQ = 128;     // queries a block: two consumer warpgroups of 64
constexpr int BK = 128;     // keys a tile (the N of S = Q K^T, m64n128k16)
constexpr int STAGES = 4;   // K/V tiles in the ring
constexpr int NT = 384;     // consumer warpgroups 0 and 1, then the producer's
constexpr int DP = 96;      // D zero-padded to this: 6 k-steps of 16 for QK^T
constexpr int KC = DP / 16;
constexpr int PANEL = 32;                      // D columns a 64-byte swizzled row of Q or K holds
constexpr int Q_PANEL = 64 * 64;               // bytes: a warpgroup's 64 query rows
constexpr int Q_BYTES = DP / PANEL * Q_PANEL;  // 12 KB a warpgroup
constexpr int K_PANEL = BK * 64;
constexpr int K_BYTES = DP / PANEL * K_PANEL;  // 24 KB a tile
constexpr int V_PANELS = BK / 64;              // V^T: 64 keys a 128-byte swizzled row
constexpr float LOG2E = 1.4426950408889634f;
enum : int { TURN = 1, Q_READY = 3 };  // named barriers TURN + w and Q_READY + w of warpgroup w

// A packed key tile, as the ring holds it: K [BK][DP] as DP/32 64-byte
// swizzled panels, then V^T [DVP][BK] as BK/64 128-byte swizzled panels.
// DVP, Dv zero-padded to a width wgmma's N takes: 88 (Dv <= 88; PFNL's 84)
// or 96.
template <int DVP>
struct Tile {
  static constexpr int V_PANEL = DVP * 128;
  static constexpr int BYTES = K_BYTES + V_PANELS * V_PANEL;
  // Q of both warpgroups, the ring, the full and empty barriers, and room
  // to align the start to the 1024-byte swizzle atom
  static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + STAGES * BYTES + 2 * STAGES * 8;
};

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The first `count` elements of src into dst, zero up to `total`: by
// 16-byte loads where src is 16-byte aligned (dst always is).
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int count,
                                           int total) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < count / 8; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    i0 = count / 8 * 8;
  }
  for (int i = i0 + threadIdx.x; i < total; i += blockDim.x)
    dst[i] = i < count ? src[i] : __float2bfloat16_rn(0.f);
}

// Key tile t of window b into packed[b][t] (Tile's layout), zero past m, d
// and dv: the producer then fills a stage with one bulk copy.
template <int DVP>
__global__ void __launch_bounds__(256)
nonlocal_flash_pack_kernel(const bf16* __restrict__ phi, const bf16* __restrict__ g,
                           uint8_t* __restrict__ packed, int m, int d, int dv, int nt) {
  extern __shared__ __align__(16) bf16 rows[];  // the tile's K rows [BK][d], then V's [BK][dv]
  bf16* sk = rows;
  bf16* sv = rows + BK * d;  // 16-byte aligned: BK * d * 2 is a multiple of 16
  const int t = blockIdx.x, b = blockIdx.y;
  const int valid = min(BK, m - t * BK);
  stage_rows(sk, phi + ((size_t)b * m + (size_t)t * BK) * d, valid * d, BK * d);
  stage_rows(sv, g + ((size_t)b * m + (size_t)t * BK) * dv, valid * dv, BK * dv);
  __syncthreads();
  const bf16 zero = __float2bfloat16_rn(0.f);

  uint4* dst = reinterpret_cast<uint4*>(packed + ((size_t)b * nt + t) * Tile<DVP>::BYTES);
  // 16-byte chunk i of K: panel i / (4 BK), key r, stored chunk i % 4
  for (int i = threadIdx.x; i < K_BYTES / 16; i += blockDim.x) {
    const int r = (i / 4) % BK;
    const int c0 = i / (4 * BK) * PANEL + ((i % 4) ^ (r / 2 % 4)) * 8;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 2 * e;
      w[e] = pack2(c < d ? sk[r * d + c] : zero, c + 1 < d ? sk[r * d + c + 1] : zero);
    }
    dst[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  // chunk i of V^T: panel i / (8 DVP), value column c, stored chunk i % 8
  for (int i = threadIdx.x; i < V_PANELS * Tile<DVP>::V_PANEL / 16; i += blockDim.x) {
    const int c = (i / 8) % DVP;
    const int k0 = i / (8 * DVP) * 64 + ((i % 8) ^ (c % 8)) * 8;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = c < dv ? pack2(sv[(k0 + 2 * e) * dv + c], sv[(k0 + 2 * e + 1) * dv + c]) : 0u;
    dst[K_BYTES / 16 + i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int DVP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DVP / 2], const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (DVP == 88)
    wgmma_m64n88k16_rs(o, a, desc, 1);
  else
    wgmma_m64n96k16_rs(o, a, desc, 1);
}

// The scores of key tile t in s, rows g and g+8 of the warp's 16: keys
// past m masked, the running max advanced (alpha its rescale), and s
// replaced by p = exp(s - max) in float32, their row sums in lsum.
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], int t, int m, float (&m_run)[2],
                                               float (&alpha)[2], float (&lsum)[2]) {
  const int key = t * BK + 2 * (threadIdx.x % 4);
  if (t * BK + BK > m) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key + 8 * i + (e & 1) >= m) s[4 * i + e] = -INFINITY;
  }
  float mx[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mx[0][j] = fmaxf(s[4 * j], s[4 * j + 1]);
    mx[1][j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
  }
#pragma unroll
  for (int i = 4; i < BK / 8; ++i) {
    mx[0][i % 4] = fmaxf(mx[0][i % 4], fmaxf(s[4 * i], s[4 * i + 1]));
    mx[1][i % 4] = fmaxf(mx[1][i % 4], fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  float ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    x = fmaxf(x, m_run[r]);  // finite: every tile holds a valid key
    alpha[r] = ex2((m_run[r] - x) * LOG2E);  // 0 on the first tile
    ml[r] = x * LOG2E;
    m_run[r] = x;
  }
  // p = exp2(s*log2e - max*log2e), summed in four partial sums a row
  float ls[2][4] = {};
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    s[4 * i] = ex2(fmaf(s[4 * i], LOG2E, -ml[0]));
    s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], LOG2E, -ml[0]));
    s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], LOG2E, -ml[1]));
    s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], LOG2E, -ml[1]));
    ls[0][i % 4] += s[4 * i] + s[4 * i + 1];
    ls[1][i % 4] += s[4 * i + 2] + s[4 * i + 3];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) lsum[r] = (ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]);
}

// Once the previous PV is done: O and the row sums rescaled, and P rounded
// to bf16 as the A fragments of the next PV (keys 16kk..16kk+15 are the
// n-tiles 2kk and 2kk+1 of s).
template <int DVP>
__device__ __forceinline__ void rescale_and_pack(float (&o)[DVP / 2], uint32_t (&pf)[BK / 16][4],
                                                 const float (&s)[BK / 2],
                                                 const float (&alpha)[2], const float (&lsum)[2],
                                                 float (&l_run)[2]) {
#pragma unroll
  for (int i = 0; i < DVP / 8; ++i) {
    o[4 * i] *= alpha[0];
    o[4 * i + 1] *= alpha[0];
    o[4 * i + 2] *= alpha[1];
    o[4 * i + 3] *= alpha[1];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + lsum[r];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) pf[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// A consumer warpgroup: queries q0..q0+63 of window b against every key
// tile of the ring, in turns with the other warpgroup on the tensor cores.
template <int DVP>
__device__ __forceinline__ void consume(const bf16* __restrict__ theta, bf16* __restrict__ out,
                                        uint8_t* s_q, const uint8_t* s_ring, uint64_t* full,
                                        uint64_t* empty, int wg, int b, int q0, int n, int m,
                                        int d, int dv, int nt) {
  using T = Tile<DVP>;
  const int tid = threadIdx.x % 128, lane = threadIdx.x % 32;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // the warpgroup's Q rows into 64-byte swizzled panels, zero past n and d
  const bf16* qsrc = theta + (size_t)b * n * d;
  for (int i = tid; i < Q_BYTES / 16; i += 128) {
    const int r = (i / 4) % 64, row = q0 + r;
    const int c0 = i / 256 * PANEL + ((i % 4) ^ (r / 2 % 4)) * 8;
    const bf16* src = qsrc + (size_t)row * d;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 2 * e;
      w[e] = pack2(row < n && c < d ? src[c] : zero, row < n && c + 1 < d ? src[c + 1] : zero);
    }
    reinterpret_cast<uint4*>(s_q)[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  named_bar_sync(Q_READY + wg, 128);
  // the warp's 16 rows as the A fragments of QK^T's 6 k-steps, for the
  // whole key loop: wgmma then reads only K from shared memory
  uint32_t qf[KC][4];
  {
    const int r = tid / 32 * 16 + lane % 16;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int chunk = (kc % 2 * 2 + lane / 16) ^ (r / 2 % 4);
      ldmatrix_x4(qf[kc], s_q + kc / 2 * Q_PANEL + r * 64 + chunk * 16);
    }
  }

  const uint32_t ring = smem_addr(s_ring);
  float s[BK / 2], o[DVP / 2];
  uint32_t pf[BK / 16][4];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) o[i] = 0.f;
  // rows g and g+8: running max (raw scores), this thread's part of the
  // denominator; the rescale and row sums of the tile in flight
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, alpha[2], lsum[2];

  auto issue_s = [&](int stage) {
    const uint32_t k_addr = ring + stage * T::BYTES;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      wgmma_m64n128k16_rs(s, qf[kc],
                          wgmma_desc(k_addr + kc / 2 * K_PANEL + kc % 2 * 32, 512, SWIZZLE_64B),
                          kc > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int stage) {
    const uint32_t v_addr = ring + stage * T::BYTES + K_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<DVP>(o, pf[kk],
                    wgmma_desc(v_addr + kk / 4 * T::V_PANEL + kk % 4 * 32, 1024, SWIZZLE_128B));
    wgmma_commit();
  };

  // Turns: a warpgroup issues its products only after the other has issued
  // its own, so one's softmax runs while the other's products do.
  // Warpgroup 0 goes first.
  if (wg == 1) named_bar_arrive(TURN, 256);

  // tile 0: S alone
  mbar_wait(&full[0], 0);
  named_bar_sync(TURN + wg, 256);
  wgmma_fence();
  issue_s(0);
  named_bar_arrive(TURN + (wg ^ 1), 256);
  wgmma_wait<0>();
  reg_fence(s);
  online_softmax(s, 0, m, m_run, alpha, lsum);
  rescale_and_pack<DVP>(o, pf, s, alpha, lsum, l_run);

  // tile t: S_t and PV_{t-1}; the softmax of S_t runs while PV_{t-1} does
#pragma unroll 1
  for (int t = 1; t < nt; ++t) {
    const int cur = t % STAGES, prev = (t - 1) % STAGES;
    mbar_wait(&full[cur], (t / STAGES) & 1);
    named_bar_sync(TURN + wg, 256);
    reg_fence(s);
    reg_fence(o);
    reg_fence(pf);
    wgmma_fence();
    issue_s(cur);
    issue_pv(prev);
    named_bar_arrive(TURN + (wg ^ 1), 256);
    wgmma_wait<1>();
    reg_fence(s);
    online_softmax(s, t, m, m_run, alpha, lsum);
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(pf);
    mbar_arrive(&empty[prev]);
    rescale_and_pack<DVP>(o, pf, s, alpha, lsum, l_run);
  }

  // the last PV
  named_bar_sync(TURN + wg, 256);
  reg_fence(o);
  reg_fence(pf);
  wgmma_fence();
  issue_pv((nt - 1) % STAGES);
  if (wg == 0) named_bar_arrive(TURN + 1, 256);
  wgmma_wait<0>();
  reg_fence(o);

  // out = O / l, rounded once to bf16
  const bool pairs = dv % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + tid / 32 * 16 + lane / 4 + 8 * r;
    if (row >= n) continue;
    bf16* dst = out + ((size_t)b * n + row) * dv;
#pragma unroll
    for (int i = 0; i < DVP / 8; ++i) {
      const int c = 8 * i + 2 * (lane % 4);
      const float v0 = o[4 * i + 2 * r] / l, v1 = o[4 * i + 2 * r + 1] / l;
      if (pairs && c < dv) {
        *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < dv) dst[c] = __float2bfloat16_rn(v0);
        if (c + 1 < dv) dst[c + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int DVP>
__global__ void __launch_bounds__(NT, 1)
nonlocal_flash_bf16_wgmma_kernel(const bf16* __restrict__ theta,
                                 const uint8_t* __restrict__ packed, bf16* __restrict__ out,
                                 int n, int m, int d, int dv, int nt) {
  using T = Tile<DVP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* s_q = smem;                // [2][Q_BYTES]
  uint8_t* s_ring = s_q + 2 * Q_BYTES;  // [STAGES][T::BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_ring + STAGES * T::BYTES);
  uint64_t* empty = full + STAGES;
  const int b = blockIdx.y, wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);       // the producer's arrival and the tile's bytes
      mbar_init(&empty[s], 256);    // every consumer thread, once its products have read it
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const uint8_t* src = packed + (size_t)b * nt * T::BYTES;
      for (int t = 0; t < nt; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], T::BYTES);
        bulk_copy_g2s(s_ring + s * T::BYTES, src + (size_t)t * T::BYTES, T::BYTES, &full[s]);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    consume<DVP>(theta, out, s_q + wg * Q_BYTES, s_ring, full, empty, wg, b,
                 blockIdx.x * BQ + wg * 64, n, m, d, dv, nt);
  }
}

int tile_bytes(int dv) { return dv <= 88 ? Tile<88>::BYTES : Tile<96>::BYTES; }

template <int DVP>
int run(const bf16* theta, const bf16* phi, const bf16* g, bf16* out, uint8_t* packed, int b,
        int n, int m, int d, int dv, cudaStream_t stream) {
  const int nt = (m + BK - 1) / BK;
  nonlocal_flash_pack_kernel<DVP>
      <<<dim3(nt, b), 256, (size_t)BK * (d + dv) * sizeof(bf16), stream>>>(phi, g, packed, m, d,
                                                                           dv, nt);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto k = nonlocal_flash_bf16_wgmma_kernel<DVP>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<DVP>::SMEM);
  k<<<dim3((n + BQ - 1) / BQ, b), NT, Tile<DVP>::SMEM, stream>>>(theta, packed, out, n, m, d, dv,
                                                                 nt);
  return (int)cudaGetLastError();
}

int launch(const void* theta, const void* phi, const void* g, void* out, void* packed, int b,
           int n, int m, int d, int dv, cudaStream_t stream) {
  if (d < 1 || d > DP || dv < 1 || dv > 96 || n < 1 || m < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  auto run_dvp = dv <= 88 ? &run<88> : &run<96>;
  return run_dvp(static_cast<const bf16*>(theta), static_cast<const bf16*>(phi),
                 static_cast<const bf16*>(g), static_cast<bf16*>(out),
                 static_cast<uint8_t*>(packed), b, n, m, d, dv, stream);
}

}  // namespace tc

}  // namespace

// C interface, loaded with ctypes.  theta [b,n,d], phi [b,m,d], g [b,m,dv],
// out [b,n,dv], all contiguous, of float or bf16, at any alignment; d, dv
// <= 96.  The bf16 entry also takes `packed`, a device buffer of
// pfnl_nonlocal_flash_bf16_packed_bytes(b, m, dv) bytes, 16-byte aligned,
// that it fills with the padded key tiles before the attention reads them.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for
// shapes it does not take).
extern "C" {

int pfnl_nonlocal_flash_f32(const void* theta, const void* phi, const void* g, void* out, int b,
                            int n, int m, int d, int dv, void* stream) {
  return launch<float>(theta, phi, g, out, b, n, m, d, dv, static_cast<cudaStream_t>(stream));
}

long long pfnl_nonlocal_flash_bf16_packed_bytes(int b, int m, int dv) {
  return (long long)b * ((m + tc::BK - 1) / tc::BK) * tc::tile_bytes(dv);
}

int pfnl_nonlocal_flash_bf16(const void* theta, const void* phi, const void* g, void* out,
                             void* packed, int b, int n, int m, int d, int dv, void* stream) {
  return tc::launch(theta, phi, g, out, packed, b, n, m, d, dv,
                    static_cast<cudaStream_t>(stream));
}

const char* pfnl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
