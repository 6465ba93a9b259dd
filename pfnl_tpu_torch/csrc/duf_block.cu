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
//      a register-tiled [pixels x F] x [F x F] product (128 x 64 tiles,
//      BK 16, 8 x 4 outputs a thread) with the first BN-relu applied as
//      the A tile is staged and the second in the epilogue; `a` goes to a
//      scratch [B, in_hi - in_lo, H, W, F] in device memory;
//   2. the 3x3x3 growth conv of `a` (duf_conv.cuh), plus the bias, written
//      in place into channels [F, F+G) of the output planes.
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
// Bound on the H100: DUF-52L at LR 180x320, 7 frames, is 3.1 TFLOP a window
// (1.3 in the F x F products, 1.8 in the growth convs) against about 19 GB
// read and written for a batch of 4 windows in bf16: compute-bound (12.6 ms
// at 989 TFLOP/s for the batch against 5.7 ms at 3.35 TB/s).  This simple
// design runs float FMAs on CUDA cores (67 TFLOP/s peak), and the `a`
// scratch adds B*T*H*W*F elements of traffic each way per block.  Left for
// later: tensor-core products (mma.sync, then wgmma with TMA-fed tiles) and
// keeping `a` on chip, as the TPU kernel does.
#include "duf_conv.cuh"

namespace {

using pfnl::from_f32;
using pfnl::round_to;
using pfnl::to_f32;

constexpr int BM = 128, BN = 64, BK = 16, PW_THREADS = 256;

// One BM x BN tile of `a` for sample blockIdx.z.  Pixel m of the sample's
// input planes is buf row m (planes are contiguous); thread (tm, tn) owns
// rows tm*8..tm*8+7 and columns tn*4..tn*4+3 of the tile.
template <typename T>
__global__ void __launch_bounds__(PW_THREADS)
duf_block_pointwise_kernel(const T* __restrict__ buf, int t_all, int in_lo, int n_in, int hw,
                           int ldb, int f, const float* __restrict__ sa,
                           const float* __restrict__ oa, const float* __restrict__ wa,
                           const float* __restrict__ sb, const float* __restrict__ ob,
                           T* __restrict__ a_out) {
  __shared__ __align__(16) float As[BK][BM + 4];  // the A tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];
  const int b = blockIdx.z, m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int m_all = n_in * hw;
  const T* src = buf + ((size_t)b * t_all + in_lo) * hw * ldb;
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
      if (m < m_all && c < f)
        v = round_to<T>(fmaxf(to_f32(src[(size_t)m * ldb + c]) * sa[c] + oa[c], 0.f));
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
    T* dst = a_out + ((size_t)b * m_all + m) * f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n < f) dst[n] = from_f32<T>(fmaxf(acc[i][j] * sb[n] + ob[n], 0.f));
    }
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(pfnl::Conv333<G>::THREADS)
duf_block_conv_kernel(const T* __restrict__ a, int n_in, int h, int w, int f, int off,
                      const float* __restrict__ wb, const float* __restrict__ bb,
                      T* __restrict__ buf, int t_all, int out_lo, int ldb) {
  extern __shared__ __align__(16) float smem[];
  pfnl::conv3x3x3_tile<T, G>(a, n_in, h, w, f, f, off, wb, bb, buf, t_all, out_lo, ldb, f, smem);
}

template <typename T, int G>
int launch_block(void* buf, void* scratch, const float* sa, const float* oa, const float* wa,
                 const float* sb, const float* ob, const float* wb, const float* bb, int nb,
                 int t_all, int h, int w, int ldb, int f, int in_lo, int in_hi, int same_t,
                 cudaStream_t stream) {
  const int n_in = in_hi - in_lo, hw = h * w;
  const dim3 pgrid((n_in * hw + BM - 1) / BM, (f + BN - 1) / BN, nb);
  duf_block_pointwise_kernel<T><<<pgrid, PW_THREADS, 0, stream>>>(
      static_cast<const T*>(buf), t_all, in_lo, n_in, hw, ldb, f, sa, oa, wa, sb, ob,
      static_cast<T*>(scratch));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  using C = pfnl::Conv333<G>;
  const int n_out = same_t ? n_in : n_in - 2;
  auto k = duf_block_conv_kernel<T, G>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM_BYTES);
  const dim3 cgrid(C::tiles(h, w), n_out, nb);
  k<<<cgrid, C::THREADS, C::SMEM_BYTES, stream>>>(
      static_cast<const T*>(scratch), n_in, h, w, f, same_t ? -1 : 0, wb, bb, static_cast<T*>(buf),
      t_all, same_t ? in_lo : in_lo + 1, ldb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void* buf, void* scratch, const float* sa, const float* oa, const float* wa,
           const float* sb, const float* ob, const float* wb, const float* bb, int nb, int t_all,
           int h, int w, int ldb, int f, int g, int in_lo, int in_hi, int same_t, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (g == 16)
    return launch_block<T, 16>(buf, scratch, sa, oa, wa, sb, ob, wb, bb, nb, t_all, h, w, ldb, f,
                               in_lo, in_hi, same_t, s);
  if (g == 32)
    return launch_block<T, 32>(buf, scratch, sa, oa, wa, sb, ob, wb, bb, nb, t_all, h, w, ldb, f,
                               in_lo, in_hi, same_t, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes.  buf [nb, t_all, h, w, ldb] and scratch
// (at least nb*(in_hi-in_lo)*h*w*f elements) of float or bf16; sa, oa, sb,
// ob [f] and bb [g] float32; wa [f, f] and wb [3,3,3,f,g] float32, already
// rounded to the activation type by the caller.  g is 16 or 32; same_t is 1
// for a SAME-T block, 0 for VALID-T.  Returns cudaGetLastError() after the
// launches.
extern "C" {

int pfnl_duf_block_f32(void* buf, void* scratch, const float* sa, const float* oa,
                       const float* wa, const float* sb, const float* ob, const float* wb,
                       const float* bb, int nb, int t_all, int h, int w, int ldb, int f, int g,
                       int in_lo, int in_hi, int same_t, void* stream) {
  return launch<float>(buf, scratch, sa, oa, wa, sb, ob, wb, bb, nb, t_all, h, w, ldb, f, g,
                       in_lo, in_hi, same_t, stream);
}

int pfnl_duf_block_bf16(void* buf, void* scratch, const float* sa, const float* oa,
                        const float* wa, const float* sb, const float* ob, const float* wb,
                        const float* bb, int nb, int t_all, int h, int w, int ldb, int f, int g,
                        int in_lo, int in_hi, int same_t, void* stream) {
  return launch<__nv_bfloat16>(buf, scratch, sa, oa, wa, sb, ob, wb, bb, nb, t_all, h, w, ldb, f,
                               g, in_lo, in_hi, same_t, stream);
}

}  // extern "C"
