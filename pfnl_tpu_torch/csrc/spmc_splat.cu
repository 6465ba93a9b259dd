// Kernel 8: the SPMC upscale-while-warp splat (DRVSR), x4.
//
// Replaces the TPU kernel pfnl_tpu/ops/pallas/spmc_splat.py: spmc_phases
// (_kernel), together with the phase interleave and border fold that
// pfnl_tpu/ops/warp.py (_spmc_fwd) applies to its s^2 phase canvases.
// Every LR source pixel moved by a flow |uv| <= R lands at (x, y) =
// ((j + u) * s, (i + v) * s) on the HR grid (the reference's coordinate
// scaling, videosr_ops.py:407-408) and splats its four bilinear taps; a
// tap lands only when its HR offset from s*(source cell) lies in
// [-sR, sR+s-1] (the TPU kernel's s^2 (2R+1)^2 = 400 masked terms at
// s=4, R=2), and a tap outside the image is folded onto the border (the
// reference's index clip).
//
// Design: a gather over LR cells.  The s x s HR pixels of LR cell (i, j)
// are reached by the same (2R+1)^2 sources, cells [i-R, i+R] x [j-R, j+R],
// so one thread per LR cell reads those sources once, recomputes their
// taps in float32, and sums into s*s = 16 register accumulators in a
// fixed order: no atomics, no phase canvases, the interleave and fold
// inside the kernel, two launches bitwise equal.  Each term is
// im * (wx * wy), rounded as the plain version rounds it.  The TPU's
// split u/v planes and its precomputed mask scratch are not carried over.
//
// Bound on the H100: the HR write.  At DRVSR's [12,180,320] it reads 4 MB
// (float32 Y and flow) and writes 44 MB; each thread writes 4 rows of 4
// consecutive values, so a warp's stores are full 128-byte lines.  The
// arithmetic is 25 sources x 64 masked products per LR cell.
#include "common.cuh"

namespace {

using pfnl::from_f32;
using pfnl::to_f32;

constexpr int S = 4, BX = 32, BY = 8;

template <typename T>
__global__ void __launch_bounds__(BX * BY)
spmc_splat_kernel(const T* __restrict__ im, const T* __restrict__ uv, T* __restrict__ out,
                  int h, int w, int r) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (j >= w || i >= h) return;
  const int oh = h * S, ow = w * S;
  const size_t img = (size_t)blockIdx.z * h * w;
  const int dmin = -S * r, dmax = S * r + S - 1;  // window of a tap's HR offset
  float acc[S][S] = {};
  for (int ii = max(i - r, 0); ii <= min(i + r, h - 1); ++ii) {
    for (int jj = max(j - r, 0); jj <= min(j + r, w - 1); ++jj) {
      const size_t src = img + (size_t)ii * w + jj;
      const float val = to_f32(im[src]);
      const float xs = ((float)jj + to_f32(uv[2 * src])) * (float)S;
      const float ys = ((float)ii + to_f32(uv[2 * src + 1])) * (float)S;
      const float x0f = floorf(xs), y0f = floorf(ys);
      const float wx[2] = {x0f + 1.0f - xs, xs - x0f};
      const float wy[2] = {y0f + 1.0f - ys, ys - y0f};
      const int dx0 = (int)x0f - S * jj, dy0 = (int)y0f - S * ii;
      // phase row / column of this cell that tap k lands on, or -1
      int prow[2], pcol[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int dy = dy0 + k, dx = dx0 + k;
        prow[k] = (dy >= dmin && dy <= dmax) ? min(max(S * ii + dy, 0), oh - 1) - S * i : -1;
        pcol[k] = (dx >= dmin && dx <= dmax) ? min(max(S * jj + dx, 0), ow - 1) - S * j : -1;
      }
      // taps in the plain version's order: (y0,x0) (y1,x0) (y0,x1) (y1,x1)
#pragma unroll
      for (int kx = 0; kx < 2; ++kx) {
#pragma unroll
        for (int ky = 0; ky < 2; ++ky) {
          const float term = __fmul_rn(val, __fmul_rn(wx[kx], wy[ky]));
#pragma unroll
          for (int py = 0; py < S; ++py) {
#pragma unroll
            for (int px = 0; px < S; ++px)
              if (prow[ky] == py && pcol[kx] == px) acc[py][px] = __fadd_rn(acc[py][px], term);
          }
        }
      }
    }
  }
  T* dst = out + ((size_t)blockIdx.z * oh + (size_t)S * i) * ow + (size_t)S * j;
#pragma unroll
  for (int py = 0; py < S; ++py) {
#pragma unroll
    for (int px = 0; px < S; ++px) dst[(size_t)py * ow + px] = from_f32<T>(acc[py][px]);
  }
}

template <typename T>
int launch_spmc_splat(const void* im, const void* uv, void* out, int b, int h, int w, int r,
                      cudaStream_t stream) {
  if (r < 0 || b < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY, b);
  spmc_splat_kernel<T><<<grid, dim3(BX, BY), 0, stream>>>(
      static_cast<const T*>(im), static_cast<const T*>(uv), static_cast<T*>(out), h, w, r);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  im [b,h,w] (one channel), uv
// [b,h,w,2] and out [b,4h,4w], all of one type (float or bf16),
// contiguous; r = the flow bound R.
extern "C" {

int pfnl_spmc_splat_f32(const void* im, const void* uv, void* out, int b, int h, int w, int r,
                        void* stream) {
  return launch_spmc_splat<float>(im, uv, out, b, h, w, r, static_cast<cudaStream_t>(stream));
}

int pfnl_spmc_splat_bf16(const void* im, const void* uv, void* out, int b, int h, int w, int r,
                         void* stream) {
  return launch_spmc_splat<__nv_bfloat16>(im, uv, out, b, h, w, r,
                                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
