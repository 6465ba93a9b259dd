// Kernel 9: one DUF dense block on the persistent feature buffer.
//
// Replaces the TPU kernel pfnl_tpu/ops/pallas/duf_block.py:_run_block (body
// _kernel), driven by dense_backbone_fused.  That kernel keeps a
// lane-group-major buffer with built-in pad planes and columns, DMAs each
// input plane through 3-slot rings, keeps the activation `a` in VMEM and
// appends the G new channels by a 128-lane read-modify-write; all of that
// answers the TPU's lane and VMEM rules.  Here the buffer is a plain
// channels-last [B, T, H, W, C_fin] tensor with no pad stored, and a block
// is two launches from one entry point (BatchNorms folded, inference):
//
//   1. pointwise, for the input planes [in_lo, in_hi):
//        a = relu(sb * (relu(sa * buf[..., :F] + oa) @ Wa) + ob)
//      into a scratch [B, in_hi - in_lo, H, W, F] in device memory;
//   2. the 3x3x3 growth conv of `a`, plus the bias, written in place into
//      channels [F, F+G) of the output planes.
//
// `a` is zero outside the image and on temporal pad planes (the reference
// pads after the activation), which the conv gets by never reading there.
// A VALID-T block ("hw") convolves all its input planes and writes
// [in_lo+1, in_hi-1).  Every accumulator starts at zero; the pointwise
// launch writes every element of the scratch that the conv reads, and
// neither launch reads a channel of the buffer at or past F.  Rounding is
// the TPU kernel's: relu(sa*x+oa) and `a` rounded to the activation type,
// products summed in float, the new channels rounded once.
//
// bf16 (the serving path), on the tensor cores, mma.sync m16n8k16 with
// float32 accumulation (mma.cuh):
//   - the pointwise product is a GEMM, M = the pixels of the input planes,
//     N = K = F.  A block keeps its 128-column slice of Wa (bf16 [F, F],
//     rounded once by the wrapper; F <= 512) in shared memory and is
//     persistent: one block an SM, the N tiles side by side in the grid, each
//     walking the M tiles of its group (every gridDim.y-th 256-pixel tile),
//     so only A streams, and the blocks of a group read each A tile at about
//     the same time and share it through L2.  8 warps, each 32 pixels x all
//     128 channels of the tile (2 m-tiles x 16 n-tiles), so each element of
//     A is transformed once a block; A walks K in chunks of 64, double-
//     buffered by cp.async across the block's tiles (64 with two buffers ran
//     faster on the H100 than 32 with four or 64 with three).  A k-step
//     loads the A fragments of x (ldmatrix), applies relu(sa*x+oa) to those
//     registers, where each register's k is known, and rounds them to bf16:
//     no pass over shared memory and no barrier between the transform and
//     the mma; each B fragment (ldmatrix.trans) then feeds 4 mma.  Rows are
//     padded to 72 (A) and 136 (Wa) elements, 144 and 272 bytes, so the eight
//     row addresses of an ldmatrix fall on distinct banks.  DUF-52L's F runs
//     from 64 to 432 in steps of 16, ragged against the 128-wide N tile: Wa
//     is zero-filled past F, A past F (never read: the buffer holds other
//     blocks' channels there), and the stores are masked.
//     The epilogue applies relu(sb*acc+ob) and rounds to bf16.  In the
//     accumulator layout a warp's store covers 16 bytes of each of 8 rows
//     (`a`'s rows are F channels apart), half a 32-byte sector, and storing
//     so took longer on the H100 than the product itself; a 4 x 4 transpose
//     of 32-bit words across the lanes of a quad (two shfl.xor steps) gives
//     each lane 8 consecutive channels, so a warp's store covers 64 bytes of
//     each of 8 rows, whole sectors, with a quarter of the instructions.
//   - the growth conv is kernel 10's tile (duf_conv_mma.cuh) on the scratch
//     (ldi = F), writing buf's channels [F, F+G) of the output planes with
//     the bias; the grid puts the output plane fastest, as kernel 10's does.
//   - either launch stages element by element (another instantiation) when
//     its input is not 16-byte aligned or its channel stride or F not a
//     multiple of 8; the product stores `a` element by element when F is
//     not a multiple of 8 or the scratch not 16-byte aligned.  No atomics,
//     every sum in a fixed order: bitwise reproducible.
//
// float32 (tests and the float32 model): the first design on CUDA cores, a
// register-tiled [pixels x F] x [F x F] product (128 x 64 tiles, BK 16, 8 x
// 4 outputs a thread, the BN-relus as the A tile is staged and in the
// epilogue) and the float-FMA conv of duf_conv.cuh.  Tensor cores would mean
// TF32, which cannot hold the 1e-4 float32 check.
//
// Bound on the H100: DUF-52L at LR 180x320, 7 frames, is 3.1 TFLOP a window
// (1.3 in the F x F products, 1.8 in the growth convs) against about 19 GB
// read and written for a batch of 4 windows in bf16: compute-bound (12.6 ms
// at 989 TFLOP/s for the batch against 5.7 ms at 3.35 TB/s).  The F 384
// block at batch 2 is 237.8 + 267.5 GFLOP (0.51 ms at 989 TFLOP/s).  The
// `a` scratch adds B*T*H*W*F elements of traffic each way per block (0.62 GB
// each way at F 384, batch 2: 0.37 ms at 3.35 TB/s, against the block's 0.51
// ms of operations at the peak).  Left for later: keeping `a` on chip, with
// the pointwise product recomputed over a halo of three planes (as the TPU
// kernel keeps it in VMEM), and wgmma with TMA-fed tiles.
#include <algorithm>

#include "duf_conv.cuh"
#include "duf_conv_mma.cuh"

namespace {

constexpr int BM = 128, BN = 64, BK = 16, PW_THREADS = 256;

// One BM x BN tile of `a` for sample blockIdx.z.  Pixel m of the sample's
// input planes is buf row m (planes are contiguous); thread (tm, tn) owns
// rows tm*8..tm*8+7 and columns tn*4..tn*4+3 of the tile.
__global__ void __launch_bounds__(PW_THREADS)
duf_block_pointwise_kernel(const float* __restrict__ buf, int t_all, int in_lo, int n_in, int hw,
                           int ldb, int f, const float* __restrict__ sa,
                           const float* __restrict__ oa, const float* __restrict__ wa,
                           const float* __restrict__ sb, const float* __restrict__ ob,
                           float* __restrict__ a_out) {
  __shared__ __align__(16) float As[BK][BM + 4];  // the A tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];
  const int b = blockIdx.z, m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int m_all = n_in * hw;
  const float* src = buf + ((size_t)b * t_all + in_lo) * hw * ldb;
  const int tid = threadIdx.x, tn = tid % 16, tm = tid / 16;
  const int la_m = tid >> 1, la_c = (tid & 1) * 8;   // A staging: a pixel, 8 channels
  const int lb_k = tid >> 4, lb_n = (tid & 15) * 4;  // B staging: a row, 4 columns

  float acc[8][4] = {};
  for (int k0 = 0; k0 < f; k0 += BK) {
    __syncthreads();  // the previous tile's reads of shared memory are done
    const int m = m0 + la_m;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = k0 + la_c + j;
      float v = 0.f;
      if (m < m_all && c < f) v = fmaxf(src[(size_t)m * ldb + c] * sa[c] + oa[c], 0.f);
      As[la_c + j][la_m] = v;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + lb_k, n = n0 + lb_n + j;
      Bs[lb_k][lb_n + j] = (c < f && n < f) ? wa[(size_t)c * f + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][tm * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][tm * 8 + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tn * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tm * 8 + i;
    if (m >= m_all) continue;
    float* dst = a_out + ((size_t)b * m_all + m) * f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n < f) dst[n] = fmaxf(acc[i][j] * sb[n] + ob[n], 0.f);
    }
  }
}

template <int G>
__global__ void __launch_bounds__(pfnl::Conv333<G>::THREADS)
duf_block_conv_kernel(const float* __restrict__ a, int n_in, int h, int w, int f, int off,
                      const float* __restrict__ wb, const float* __restrict__ bb,
                      float* __restrict__ buf, int t_all, int out_lo, int ldb) {
  extern __shared__ __align__(16) float smem[];
  pfnl::conv3x3x3_tile<G>(a, n_in, h, w, f, f, off, wb, bb, buf, t_all, out_lo, ldb, f, smem);
}

template <int G>
int launch_block(float* buf, float* scratch, const float* sa, const float* oa, const float* wa,
                 const float* sb, const float* ob, const float* wb, const float* bb, int nb,
                 int t_all, int h, int w, int ldb, int f, int in_lo, int in_hi, int same_t,
                 cudaStream_t stream) {
  const int n_in = in_hi - in_lo, hw = h * w;
  const dim3 pgrid((n_in * hw + BM - 1) / BM, (f + BN - 1) / BN, nb);
  duf_block_pointwise_kernel<<<pgrid, PW_THREADS, 0, stream>>>(buf, t_all, in_lo, n_in, hw, ldb,
                                                               f, sa, oa, wa, sb, ob, scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  using C = pfnl::Conv333<G>;
  const int n_out = same_t ? n_in : n_in - 2;
  auto k = duf_block_conv_kernel<G>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM_BYTES);
  const dim3 cgrid(C::tiles(h, w), n_out, nb);
  k<<<cgrid, C::THREADS, C::SMEM_BYTES, stream>>>(scratch, n_in, h, w, f, same_t ? -1 : 0, wb, bb,
                                                  buf, t_all, same_t ? in_lo : in_lo + 1, ldb);
  return (int)cudaGetLastError();
}

// The bf16 tensor-core kernels (see the head of this file).
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BM = 256, BN = 128, BK = 64, STAGES = 2;
constexpr int MAX_F = 512;  // Wa's N-tile slice, F x 128, stays in shared memory
constexpr int WARPS_M = 8, THREADS = 32 * WARPS_M;
constexpr int WM = BM / WARPS_M;          // a warp's 32 x 128 outputs: all of the N tile
constexpr int MT = WM / 16, NT = BN / 8;  // its m-tiles and n-tiles
constexpr int AS = BK + 8;                // A row stride (144 bytes)
constexpr int BS = BN + 8;                // B row stride (272 bytes)
constexpr int A_STAGE = BM * AS;
static_assert(A_STAGE % 8 == 0 && BS % 8 == 0, "16-byte aligned regions");
constexpr int A_CHUNKS = BM * BK / 8;  // 16-byte chunks of an A stage
static_assert(A_CHUNKS % THREADS == 0, "whole chunks a thread");

// relu(s * x + o) of the two bf16 of v, rounded to bf16 and packed.
__device__ __forceinline__ uint32_t bn_relu2(uint32_t v, float2 s, float2 o) {
  const float x0 = __uint_as_float(v << 16), x1 = __uint_as_float(v & 0xffff0000u);
  return pfnl::pack_bf16(fmaxf(x0 * s.x + o.x, 0.f), fmaxf(x1 * s.y + o.y, 0.f));
}

// Shared memory of the pointwise kernel at F (K padded to whole chunks):
// Wa's slice [kp][BS], the A ring [STAGES][BM][AS], then sa and oa [kp].
inline size_t pointwise_smem(int f) {
  const size_t kp = (size_t)(f + BK - 1) / BK * BK;
  return (kp * BS + STAGES * A_STAGE) * sizeof(bf16) + 2 * kp * sizeof(float);
}

// Block (n tile, group): a[m0.., n0..] for the M tiles group, group +
// gridDim.y, ... of all samples (tile i: sample i / tps, rows (i % tps) * BM..
// of its input planes, whose pixel m is buf row m: the planes are contiguous).
template <bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1)
duf_block_pointwise_bf16_mma_kernel(const bf16* __restrict__ buf, int nb, int t_all, int in_lo,
                                    int n_in, int hw, int ldb, int f,
                                    const float* __restrict__ sa, const float* __restrict__ oa,
                                    const bf16* __restrict__ wa, const float* __restrict__ sb,
                                    const float* __restrict__ ob, bf16* __restrict__ a_out,
                                    bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nk = (f + BK - 1) / BK, kp = nk * BK;
  bf16* s_b = reinterpret_cast<bf16*>(smem_raw);  // Wa[:, n0..n0+BN), rows kp
  bf16* s_a = s_b + kp * BS;                      // the A ring
  float* s_sa = reinterpret_cast<float*>(s_a + STAGES * A_STAGE);
  float* s_oa = s_sa + kp;
  const int n0 = blockIdx.x * BN;
  const int m_all = n_in * hw, tps = (m_all + BM - 1) / BM, tiles = nb * tps;
  const int my_tiles = blockIdx.y < tiles ? (tiles - blockIdx.y + gridDim.y - 1) / gridDim.y : 0;
  const int n_stages = my_tiles * nk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = warp * WM;

  // sa and oa zero past F, so the zeros staged there stay relu(0 * 0 + 0) = 0
  // (the loop's first barrier orders these stores before their reads)
  for (int k = threadIdx.x; k < kp; k += THREADS) {
    s_sa[k] = k < f ? sa[k] : 0.f;
    s_oa[k] = k < f ? oa[k] : 0.f;
  }
  // Wa's slice, zero past F in both directions, in the first cp.async group
  for (int i = threadIdx.x; i < kp * (BN / 8); i += THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int n = r < f ? min(max(f - n0 - c, 0), 8) : 0;
    pfnl::stage_chunk<8, ASYNC>(s_b + r * BS + c, wa + (size_t)r * f + n0 + c, n, wa);
  }

  // stage s is chunk s % nk of this block's tile s / nk: the sample and first row
  auto tile_of = [&](int s, int& b, int& m0) {
    const int i = blockIdx.y + (s / nk) * gridDim.y;
    b = i / tps;
    m0 = (i % tps) * BM;
  };
  // A rows m0.. x channels [k0, k0+BK) of stage s into its ring slot
  auto issue = [&](int s) {
    int b, m0;
    tile_of(s, b, m0);
    const int k0 = (s % nk) * BK;
    const bf16* src = buf + ((size_t)b * t_all + in_lo) * hw * ldb;
    bf16* st = s_a + (s % STAGES) * A_STAGE;
#pragma unroll
    for (int j = 0; j < A_CHUNKS / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS, r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int n = m0 + r < m_all ? min(max(f - k0 - c, 0), 8) : 0;
      pfnl::stage_chunk<8, ASYNC>(st + r * AS + c, src + (size_t)(m0 + r) * ldb + k0 + c, n, buf);
    }
  };

  float acc[MT][NT][4];

  // a ring of STAGES slots running on across this block's tiles: stage s +
  // STAGES - 1 is issued once every warp is past stage s - 1, whose slot it
  // takes; empty groups keep the count
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) issue(s);
    pfnl::cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    pfnl::cp_async_wait<STAGES - 2>();  // this thread's chunks of stage s (and Wa) have landed
    __syncthreads();  // stage s is whole; every warp is done with stage s - 1
    if (s + STAGES - 1 < n_stages) issue(s + STAGES - 1);
    pfnl::cp_async_commit();
    const int k0 = (s % nk) * BK;
    if (k0 == 0) {  // a tile's first chunk
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
    }
    const bf16* st = s_a + (s % STAGES) * A_STAGE;
    const bf16* st_b = s_b + k0 * BS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // A fragments of x, then relu(sa*x+oa) rounded to bf16 in place: registers 0
      // and 1 hold k = 2t, 2t+1 of the k-step, 2 and 3 k = 2t+8, 2t+9 (mma.cuh)
      const int kk = k0 + ks * 16 + 2 * (lane % 4);
      const float2 s_lo = *reinterpret_cast<const float2*>(s_sa + kk);
      const float2 s_hi = *reinterpret_cast<const float2*>(s_sa + kk + 8);
      const float2 o_lo = *reinterpret_cast<const float2*>(s_oa + kk);
      const float2 o_hi = *reinterpret_cast<const float2*>(s_oa + kk + 8);
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pfnl::ldmatrix_x4(a[mt], st + (wm0 + 16 * mt + lane % 16) * AS + ks * 16 + (lane / 16) * 8);
        a[mt][0] = bn_relu2(a[mt][0], s_lo, o_lo);
        a[mt][1] = bn_relu2(a[mt][1], s_lo, o_lo);
        a[mt][2] = bn_relu2(a[mt][2], s_hi, o_hi);
        a[mt][3] = bn_relu2(a[mt][3], s_hi, o_hi);
      }
#pragma unroll
      for (int q = 0; q < NT / 2; ++q) {
        uint32_t r[4];
        pfnl::ldmatrix_x4_trans(r, st_b + (ks * 16 + ((lane / 8) % 2) * 8 + lane % 8) * BS +
                                       8 * (2 * q + lane / 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pfnl::mma_bf16(acc[mt][2 * q], a[mt], r[0], r[1]);
          pfnl::mma_bf16(acc[mt][2 * q + 1], a[mt], r[2], r[3]);
        }
      }
    }
    if (k0 + BK < kp) continue;

    // the tile's last chunk: acc[mt][j] holds pixels wm0 + 16 mt + lane/4 (e 0,
    // 1) and + 8 (e 2, 3), channels n0 + 8 j + 2 (lane % 4) + (e & 1)
    int b, m0;
    tile_of(s, b, m0);
    bf16* dst = a_out + (size_t)b * m_all * f;
    if (vec) {
      // relu(sb*acc+ob) rounded to bf16, a word of two channels per (row, n-tile);
      // a 4 x 4 transpose of words across the lanes of a quad (two xor steps)
      // gives lane t the 8 channels of n-tile 4 jj + t, one 16-byte store
      const int t = lane % 4;
#pragma unroll
      for (int jj = 0; jj < NT / 4; ++jj) {
        float2 sbv[4], obv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = n0 + 8 * (4 * jj + u) + 2 * t;  // f % 8 == 0: n and n + 1 < f or neither
          sbv[u] = n < f ? make_float2(sb[n], sb[n + 1]) : make_float2(0.f, 0.f);
          obv[u] = n < f ? make_float2(ob[n], ob[n + 1]) : make_float2(0.f, 0.f);
        }
        const int n = n0 + 8 * (4 * jj + t);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t x[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              x[u] = pfnl::pack_bf16(
                  fmaxf(acc[mt][4 * jj + u][2 * half] * sbv[u].x + obv[u].x, 0.f),
                  fmaxf(acc[mt][4 * jj + u][2 * half + 1] * sbv[u].y + obv[u].y, 0.f));
            const bool b1 = t & 2, b0 = t & 1;
            uint32_t r0 = __shfl_xor_sync(0xffffffffu, b1 ? x[0] : x[2], 2);
            uint32_t r1 = __shfl_xor_sync(0xffffffffu, b1 ? x[1] : x[3], 2);
            if (b1) x[0] = r0, x[1] = r1; else x[2] = r0, x[3] = r1;
            r0 = __shfl_xor_sync(0xffffffffu, b0 ? x[0] : x[1], 1);
            r1 = __shfl_xor_sync(0xffffffffu, b0 ? x[2] : x[3], 1);
            if (b0) x[0] = r0, x[2] = r1; else x[1] = r0, x[3] = r1;
            const int m = m0 + wm0 + 16 * mt + lane / 4 + 8 * half;
            if (m < m_all && n < f)
              *reinterpret_cast<uint4*>(dst + (size_t)m * f + n) = make_uint4(x[0], x[1], x[2], x[3]);
          }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n >= f) continue;
      const bool two = n + 1 < f;
      const float sb0 = sb[n], ob0 = ob[n], sb1 = two ? sb[n + 1] : 0.f, ob1 = two ? ob[n + 1] : 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + wm0 + 16 * mt + lane / 4 + 8 * half;
          if (m >= m_all) continue;
          dst[(size_t)m * f + n] = __float2bfloat16_rn(fmaxf(acc[mt][j][2 * half] * sb0 + ob0, 0.f));
          if (two)
            dst[(size_t)m * f + n + 1] =
                __float2bfloat16_rn(fmaxf(acc[mt][j][2 * half + 1] * sb1 + ob1, 0.f));
        }
    }
  }
  pfnl::cp_async_wait<0>();  // only empty groups can remain; leave none in flight
}

// Block (output plane, pixel tile, sample) of the growth conv.
template <int G, bool ASYNC>
__global__ void __launch_bounds__(pfnl::ConvMma<G>::THREADS)
duf_block_conv_bf16_mma_kernel(const pfnl::ConvMmaArgs p) {
  extern __shared__ __align__(16) bf16 smem_bf16[];
  pfnl::conv_mma_tile<G, 2, ASYNC, false>(p, blockIdx.x, blockIdx.y, blockIdx.z, smem_bf16);
}

inline bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

template <int G>
int launch_block(bf16* buf, bf16* scratch, const float* sa, const float* oa, const bf16* wa,
                 const float* sb, const float* ob, const bf16* wb, const float* bb, int nb,
                 int t_all, int h, int w, int ldb, int f, int in_lo, int in_hi, int same_t,
                 cudaStream_t stream) {
  const int n_in = in_hi - in_lo, hw = h * w;
  if (f > MAX_F) return (int)cudaErrorInvalidValue;
  auto pk = f % 8 == 0 && ldb % 8 == 0 && aligned16(buf, wa)
                ? &duf_block_pointwise_bf16_mma_kernel<true>
                : &duf_block_pointwise_bf16_mma_kernel<false>;
  const size_t smem = pointwise_smem(f);
  cudaFuncSetAttribute(pk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // 16-byte stores of `a` when its rows are whole 16-byte chunks
  const bool vec = f % 8 == 0 && (reinterpret_cast<uintptr_t>(scratch) & 15) == 0;
  // one block an SM: the N tiles side by side, so the blocks of a group read
  // each A tile at about the same time and share it through L2
  int dev, sms;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_tiles = (f + BN - 1) / BN, m_tiles = nb * ((n_in * hw + BM - 1) / BM);
  const dim3 pgrid(n_tiles, std::max(1, std::min(m_tiles, sms / n_tiles)));
  pk<<<pgrid, THREADS, smem, stream>>>(buf, nb, t_all, in_lo, n_in, hw, ldb, f, sa, oa, wa, sb, ob,
                                       scratch, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  using C = pfnl::ConvMma<G>;
  auto ck = f % 8 == 0 && aligned16(scratch, wb) ? &duf_block_conv_bf16_mma_kernel<G, true>
                                                 : &duf_block_conv_bf16_mma_kernel<G, false>;
  cudaFuncSetAttribute(ck, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM_BYTES);
  const int n_out = same_t ? n_in : n_in - 2;
  // `a` [nb, n_in, h, w, f] in, DHWIO [3,3,3,f,G] weights (row dt * 9f + tap * f + c),
  // out = channels [f, f+G) of buf's planes from out_lo
  const pfnl::ConvMmaArgs p{scratch, n_in, h, w, f, f, same_t ? -1 : 0, 3, wb, 9 * f, f, bb,
                            buf, t_all, same_t ? in_lo : in_lo + 1, ldb, f};
  const dim3 cgrid(n_out, C::tiles(h, w), nb);
  ck<<<cgrid, C::THREADS, C::SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// C interface, loaded with ctypes.  buf [nb, t_all, h, w, ldb] and scratch
// (at least nb*(in_hi-in_lo)*h*w*f elements) of float or bf16; sa, oa, sb,
// ob [f] and bb [g] float32; wa [f, f] and wb [3,3,3,f,g] of the activation
// type (float32 entry: float32), rounded to it by the caller.  g is 16 or
// 32; same_t is 1 for a SAME-T block, 0 for VALID-T.  Returns
// cudaGetLastError() after the launches.
extern "C" {

int pfnl_duf_block_f32(void* buf, void* scratch, const float* sa, const float* oa,
                       const float* wa, const float* sb, const float* ob, const float* wb,
                       const float* bb, int nb, int t_all, int h, int w, int ldb, int f, int g,
                       int in_lo, int in_hi, int same_t, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<float*>(buf);
  auto a = static_cast<float*>(scratch);
  if (g == 16)
    return launch_block<16>(x, a, sa, oa, wa, sb, ob, wb, bb, nb, t_all, h, w, ldb, f, in_lo,
                            in_hi, same_t, s);
  if (g == 32)
    return launch_block<32>(x, a, sa, oa, wa, sb, ob, wb, bb, nb, t_all, h, w, ldb, f, in_lo,
                            in_hi, same_t, s);
  return (int)cudaErrorInvalidValue;
}

int pfnl_duf_block_bf16(void* buf, void* scratch, const float* sa, const float* oa,
                        const void* wa, const float* sb, const float* ob, const void* wb,
                        const float* bb, int nb, int t_all, int h, int w, int ldb, int f, int g,
                        int in_lo, int in_hi, int same_t, void* stream) {
  using tc::bf16;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<bf16*>(buf);
  auto a = static_cast<bf16*>(scratch);
  auto wa16 = static_cast<const bf16*>(wa);
  auto wb16 = static_cast<const bf16*>(wb);
  if (g == 16)
    return tc::launch_block<16>(x, a, sa, oa, wa16, sb, ob, wb16, bb, nb, t_all, h, w, ldb, f,
                                in_lo, in_hi, same_t, s);
  if (g == 32)
    return tc::launch_block<32>(x, a, sa, oa, wa16, sb, ob, wb16, bb, nb, t_all, h, w, ldb, f,
                                in_lo, in_hi, same_t, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
