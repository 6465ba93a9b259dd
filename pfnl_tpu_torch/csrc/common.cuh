// Shared helpers of the port's CUDA kernels: element-type conversions and
// the leaky ReLU.  Activations are float or __nv_bfloat16 in device memory
// and float in registers and shared memory; every sum accumulates in float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pfnl {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the value a T activation written and re-read holds.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// tf.nn.leaky_relu with alpha 0.2, as max(x, 0.2x) like the JAX package.
__device__ __forceinline__ float lrelu(float x) { return fmaxf(x, 0.2f * x); }

}  // namespace pfnl
