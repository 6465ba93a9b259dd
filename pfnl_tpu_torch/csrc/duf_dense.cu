// Kernel 10: DUF's 3x3x3 dense-block conv alone, G outputs, SAME in H/W,
// SAME or VALID in T, no bias.
//
// Replaces the TPU kernel pfnl_tpu/ops/pallas/duf_dense.py:
// _conv3x3x3_tap_fwd_impl (body _kernel), public conv3x3x3_tap.  That kernel
// packs the nine spatial taps into the output columns of one dot ((dw, dh,
// g) order, N = 9G lanes) so that G = 16 outputs fill the 128-lane MXU, DMAs
// input planes through a 4-slot ring, and leaves the dh reduction to XLA.
// Here it is the growth conv of kernel 9 without the pointwise chain: the
// shared tile routine of duf_conv.cuh reads x [B, T, H, W, F] directly and
// writes [B, T_out, H, W, G], one block per 8 x 16 pixel tile of an output
// plane, float FMAs on CUDA cores.
//
// Bound on the H100: 27 F G multiply-adds per output pixel (F = 64..432, G =
// 16) against F + G elements moved: compute-bound at every DUF width
// (about 0.14 TFLOP at F = 384, batch 2, 7 frames, LR 180x320).  Left for
// later: tensor-core products; the growth conv has N = G = 16, so an
// implicit GEMM with the 27 taps in K fits m16n8k16 tiles directly.
#include "duf_conv.cuh"

namespace {

template <typename T, int G>
__global__ void __launch_bounds__(pfnl::Conv333<G>::THREADS)
duf_dense_conv_kernel(const T* __restrict__ x, int t_in, int h, int w, int f, int off,
                      const float* __restrict__ wk, T* __restrict__ out, int t_out) {
  extern __shared__ __align__(16) float smem[];
  pfnl::conv3x3x3_tile<T, G>(x, t_in, h, w, f, f, off, wk, nullptr, out, t_out, 0, G, 0, smem);
}

template <typename T, int G>
int launch_conv(const void* x, const float* wk, void* out, int nb, int t_in, int h, int w, int f,
                int pad_t, cudaStream_t stream) {
  using C = pfnl::Conv333<G>;
  const int t_out = pad_t ? t_in : t_in - 2;
  auto k = duf_dense_conv_kernel<T, G>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM_BYTES);
  const dim3 grid(C::tiles(h, w), t_out, nb);
  k<<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(static_cast<const T*>(x), t_in, h, w, f,
                                                 pad_t ? -1 : 0, wk, static_cast<T*>(out), t_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const float* wk, void* out, int nb, int t_in, int h, int w, int f,
           int g, int pad_t, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (g == 16) return launch_conv<T, 16>(x, wk, out, nb, t_in, h, w, f, pad_t, s);
  if (g == 32) return launch_conv<T, 32>(x, wk, out, nb, t_in, h, w, f, pad_t, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes.  x [nb, t_in, h, w, f] and out [nb,
// t_out, h, w, g] of float or bf16 (t_out = t_in, or t_in - 2 without
// pad_t); wk [3,3,3,f,g] float32, already rounded to the activation type by
// the caller; g is 16 or 32.  Returns cudaGetLastError() after the launch.
extern "C" {

int pfnl_duf_dense_f32(const void* x, const float* wk, void* out, int nb, int t_in, int h, int w,
                       int f, int g, int pad_t, void* stream) {
  return launch<float>(x, wk, out, nb, t_in, h, w, f, g, pad_t, stream);
}

int pfnl_duf_dense_bf16(const void* x, const float* wk, void* out, int nb, int t_in, int h, int w,
                        int f, int g, int pad_t, void* stream) {
  return launch<__nv_bfloat16>(x, wk, out, nb, t_in, h, w, f, g, pad_t, stream);
}

}  // extern "C"
