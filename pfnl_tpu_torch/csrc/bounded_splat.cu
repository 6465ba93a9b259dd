// Kernel 7: the bounded same-size bilinear forward splat.
//
// Replaces the TPU kernel pfnl_tpu/ops/pallas/bounded_splat.py:
// bounded_splat_canvas (_kernel), together with the border fold that
// pfnl_tpu/ops/warp.py (_bsplat_fwd) applies to its padded canvas.  Every
// source pixel moved by a flow |uv| <= R splats its four bilinear taps;
// a tap lands only when its offset from the source lies in [-R, R+1]
// (the TPU kernel's (2R+2)^2 masked terms), and a tap outside the image
// is folded onto the border row or column (the reference's index clip,
// videosr_ops.py:455-466), which is what the fold of the padded canvas
// computes.
//
// Design: a gather.  One thread per output pixel reads the (2R+2)^2
// sources that can reach it, recomputes their taps from the flow in
// float32, and sums the taps that land on it in a fixed order: no
// atomics, no canvas, the fold inside the kernel, so two launches are
// bitwise equal.  Each term is im * (wx * wy), rounded as the plain
// version rounds it.  The TPU's channel-major planes and split u/v planes
// (answers to its 128 lanes) are not carried over: im is NHWC, uv
// [B,H,W,2].
//
// Bound on the H100: memory.  Per output pixel it reads and writes C
// values and reads two flow values; the (2R+2)^2 re-reads of neighbours
// hit L1/L2.  At VESPCN's [12,1,180,320] it moves under 10 MB, so the
// launch dominates; at FRVSR's HR shape [4,3,720,1280] it moves about
// 130 MB in float32.
#include "common.cuh"

namespace {

using pfnl::from_f32;
using pfnl::to_f32;

constexpr int MAX_C = 4, BX = 32, BY = 8;

template <typename T>
__global__ void __launch_bounds__(BX * BY)
bounded_splat_kernel(const T* __restrict__ im, const T* __restrict__ uv, T* __restrict__ out,
                     int h, int w, int c, int r) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t img = (size_t)blockIdx.z * h * w;
  float acc[MAX_C] = {};
  // sources whose window-valid taps, clamped into the image, can reach (y, x)
  for (int i = max(y - r - 1, 0); i <= min(y + r, h - 1); ++i) {
    for (int j = max(x - r - 1, 0); j <= min(x + r, w - 1); ++j) {
      const size_t src = img + (size_t)i * w + j;
      const float xs = (float)j + to_f32(uv[2 * src]);
      const float ys = (float)i + to_f32(uv[2 * src + 1]);
      const float x0f = floorf(xs), y0f = floorf(ys);
      const float wx[2] = {x0f + 1.0f - xs, xs - x0f};
      const float wy[2] = {y0f + 1.0f - ys, ys - y0f};
      const int dx0 = (int)x0f - j, dy0 = (int)y0f - i;
      bool on_row[2], on_col[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int dy = dy0 + k, dx = dx0 + k;
        on_row[k] = dy >= -r && dy <= r + 1 && min(max(i + dy, 0), h - 1) == y;
        on_col[k] = dx >= -r && dx <= r + 1 && min(max(j + dx, 0), w - 1) == x;
      }
      // taps in the plain version's order: (y0,x0) (y1,x0) (y0,x1) (y1,x1)
#pragma unroll
      for (int kx = 0; kx < 2; ++kx) {
#pragma unroll
        for (int ky = 0; ky < 2; ++ky) {
          if (!(on_row[ky] && on_col[kx])) continue;
          const float wgt = __fmul_rn(wx[kx], wy[ky]);
#pragma unroll
          for (int ch = 0; ch < MAX_C; ++ch)
            if (ch < c) acc[ch] = __fadd_rn(acc[ch], __fmul_rn(to_f32(im[src * c + ch]), wgt));
        }
      }
    }
  }
  T* dst = out + (img + (size_t)y * w + x) * c;
#pragma unroll
  for (int ch = 0; ch < MAX_C; ++ch)
    if (ch < c) dst[ch] = from_f32<T>(acc[ch]);
}

template <typename T>
int launch_bounded_splat(const void* im, const void* uv, void* out, int b, int h, int w, int c,
                         int r, cudaStream_t stream) {
  if (c < 1 || c > MAX_C || r < 0 || b < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY, b);
  bounded_splat_kernel<T><<<grid, dim3(BX, BY), 0, stream>>>(
      static_cast<const T*>(im), static_cast<const T*>(uv), static_cast<T*>(out), h, w, c, r);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  im [b,h,w,c] and out [b,h,w,c], uv
// [b,h,w,2], all of one type (float or bf16), contiguous; 1 <= c <= 4;
// r = the flow bound R.
extern "C" {

int pfnl_bounded_splat_f32(const void* im, const void* uv, void* out, int b, int h, int w,
                           int c, int r, void* stream) {
  return launch_bounded_splat<float>(im, uv, out, b, h, w, c, r,
                                     static_cast<cudaStream_t>(stream));
}

int pfnl_bounded_splat_bf16(const void* im, const void* uv, void* out, int b, int h, int w,
                            int c, int r, void* stream) {
  return launch_bounded_splat<__nv_bfloat16>(im, uv, out, b, h, w, c, r,
                                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
