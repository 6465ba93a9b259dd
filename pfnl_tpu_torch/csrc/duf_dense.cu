// Kernel 10: DUF's 3x3x3 dense-block conv alone, G outputs, SAME in H/W,
// SAME or VALID in T, no bias.
//
// Replaces the TPU kernel pfnl_tpu/ops/pallas/duf_dense.py:
// _conv3x3x3_tap_fwd_impl (body _kernel), public conv3x3x3_tap.  That kernel
// packs the nine spatial taps into the output columns of one dot ((dw, dh,
// g) order, N = 9G lanes) so that G = 16 outputs fill the 128-lane MXU, DMAs
// input planes through a 4-slot ring, and leaves the dh reduction to XLA.
// None of that carries over: it answers the MXU's 128 lanes.
//
// bf16 (the serving dtype): an implicit GEMM on the tensor cores, the tile
// of duf_conv_mma.cuh (mma.sync m16n8k16, M = output pixels, N = G, K = 27 F;
// its head gives the operand roles, tiles and shared-memory layout).  It
// reads x [B, T, H, W, F] directly and writes [B, T_out, H, W, G]; the
// weights come as bf16 [27, F, G] (DHWIO as it is, rounded once by the
// caller).  Products are summed in float32 and rounded once to bf16; the
// TPU kernel rounds each dh group of products to the activation type before
// XLA sums the three, so the two differ by a few bf16 ulps.  One block per
// 8 x 32 pixel tile of an output plane; the grid puts the output plane
// fastest, so the blocks that read an input plane (three output planes)
// run together and share it through L2.  Sums run in a fixed order without
// atomics: bitwise reproducible.
//
// float32 (tests and the float32 model; no float32 main path runs it): the
// first design, the float-FMA tile of duf_conv.cuh that kernel 9's float32
// entry also runs, one block per 8 x 16 pixel tile, weights as float
// [3,3,3,F,G].  Tensor cores would mean TF32, which cannot hold the 1e-4
// float32 check.
//
// Bound on the H100: 27 F G multiply-adds per output pixel (F = 64..432, G =
// 16) against F + G elements moved: compute-bound at every DUF width
// (267.5 GFLOP at F = 384, batch 2, 7 frames, LR 180x320: 0.27 ms at 989
// TFLOP/s).  The bf16 tile is bound by shared-memory bandwidth (see its
// head).  Left for later: wgmma with TMA-fed windows and warp
// specialisation.
#include "duf_conv.cuh"
#include "duf_conv_mma.cuh"

namespace {

// float32: block (pixel tile, output plane, sample)
template <int G>
__global__ void __launch_bounds__(pfnl::Conv333<G>::THREADS)
duf_dense_conv_kernel(const float* __restrict__ x, int t_in, int h, int w, int f, int off,
                      const float* __restrict__ wk, float* __restrict__ out, int t_out) {
  extern __shared__ __align__(16) float smem[];
  pfnl::conv3x3x3_tile<G>(x, t_in, h, w, f, f, off, wk, nullptr, out, t_out, 0, G, 0, smem);
}

template <int G>
int launch_conv(const float* x, const float* wk, float* out, int nb, int t_in, int h, int w,
                int f, int pad_t, cudaStream_t stream) {
  using C = pfnl::Conv333<G>;
  const int t_out = pad_t ? t_in : t_in - 2;
  auto k = duf_dense_conv_kernel<G>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM_BYTES);
  const dim3 grid(C::tiles(h, w), t_out, nb);
  k<<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(x, t_in, h, w, f, pad_t ? -1 : 0, wk, out,
                                                 t_out);
  return (int)cudaGetLastError();
}

using bf16 = __nv_bfloat16;

// bf16: block (output plane, pixel tile, sample)
template <int G, bool ASYNC>
__global__ void __launch_bounds__(pfnl::ConvMma<G>::THREADS)
duf_dense_bf16_mma_kernel(const pfnl::ConvMmaArgs p) {
  extern __shared__ __align__(16) bf16 smem_bf16[];
  pfnl::conv_mma_tile<G, 2, ASYNC, false>(p, blockIdx.x, blockIdx.y, blockIdx.z, smem_bf16);
}

template <int G>
int launch_mma(const void* x, const void* wk, void* out, int nb, int t_in, int h, int w, int f,
               int pad_t, cudaStream_t stream) {
  using C = pfnl::ConvMma<G>;
  const int t_out = pad_t ? t_in : t_in - 2;
  const bool async = f % 8 == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                     reinterpret_cast<uintptr_t>(wk)) & 15) == 0;
  auto k = async ? &duf_dense_bf16_mma_kernel<G, true> : &duf_dense_bf16_mma_kernel<G, false>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM_BYTES);
  // DHWIO [3,3,3,f,G]: weight row (dt, tap, c) is dt * 9f + tap * f + c
  const pfnl::ConvMmaArgs p{static_cast<const bf16*>(x), t_in, h, w, f, f, pad_t ? -1 : 0, 3,
                            static_cast<const bf16*>(wk), 9 * f, f, nullptr,
                            static_cast<bf16*>(out), t_out, 0, G, 0};
  const dim3 grid(t_out, C::tiles(h, w), nb);
  k<<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  x [nb, t_in, h, w, f] and out [nb,
// t_out, h, w, g] (t_out = t_in, or t_in - 2 without pad_t); g is 16 or 32.
// float32: wk [3,3,3,f,g] float32; bf16: wk [3,3,3,f,g] bf16; either
// already rounded to the activation type by the caller.  Returns
// cudaGetLastError() after the launch.
extern "C" {

int pfnl_duf_dense_f32(const void* x, const float* wk, void* out, int nb, int t_in, int h, int w,
                       int f, int g, int pad_t, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto of = static_cast<float*>(out);
  if (g == 16) return launch_conv<16>(xf, wk, of, nb, t_in, h, w, f, pad_t, s);
  if (g == 32) return launch_conv<32>(xf, wk, of, nb, t_in, h, w, f, pad_t, s);
  return (int)cudaErrorInvalidValue;
}

int pfnl_duf_dense_bf16(const void* x, const void* wk, void* out, int nb, int t_in, int h, int w,
                        int f, int g, int pad_t, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (g == 16) return launch_mma<16>(x, wk, out, nb, t_in, h, w, f, pad_t, s);
  if (g == 32) return launch_mma<32>(x, wk, out, nb, t_in, h, w, f, pad_t, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
