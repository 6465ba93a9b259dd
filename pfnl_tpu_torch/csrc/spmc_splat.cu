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
// Design: a scatter into a shared-memory tile (splat_tile.cuh).  A block
// owns TH x TW LR cells, the 4TH x 4TW HR pixels they hold, and stages
// with cp.async the image and flow of every source that can reach them:
// the cells plus R on each side (a tap's HR offset reaches R LR cells
// either way; a fold reaches the border only from sources that close).
// Each source's taps (floor, the two HR target rows and columns, clamped
// for the fold or dropped outside [-sR, sR+s-1], the term im * (wx*wy))
// are computed once per block, by the one thread that adds them into a
// float32 HR tile, in the plain version's tap order: four adds a source.
// The sources go class by class, (i mod 2R+1, j mod 2R+1), a barrier
// between classes: a source's taps span 2R+1 LR cells, so two sources of
// one class never reach one HR pixel and no atomics are needed; every
// output sums in one fixed order (class, then tap), so two launches are
// bitwise equal.  The HR tile is rounded once to T and written with
// 16-byte stores (8 bf16 HR pixels a store).  A gather is not taken: it
// would spend about 100 compare-selects per HR pixel to place 0.25 terms
// on average.  The TPU's split u/v planes and its precomputed mask
// scratch are not carried over.
//
// Bound on the H100: the HR write.  At DRVSR's [12,180,320] bf16 it reads
// 4.1 MB (Y and flow) and writes 22.1 MB, 84% of the bytes it moves.  What
// sets its pace instead is the class schedule: each class is a chain of
// dependent steps per source between two barriers and holds about 1/25 of
// the block's sources at R=2, while the HR tile (64 bytes an LR cell)
// bounds the cells in flight on an SM; a second tile would halve the
// barriers but also the cells in flight, so the block keeps one (the
// variants of `python -m pfnl_tpu_torch.ops.cuda.profile_splats
// --variants` time that choice and the tile's shape beside these sources).
#include "splat_tile.cuh"

namespace {

using pfnl::from_f32;
using pfnl::to_f32;
using namespace pfnl::splat;

constexpr int S = 4, TH = 16, TW = 32, NT = 128;
constexpr int HTH = S * TH, HTW = S * TW;  // the HR tile
static_assert((TH + 2 * MAX_R) * (TW + 2 * MAX_R) < MAX_SOURCES, "for_each_class");

template <typename T>
struct Geometry {  // shared-memory layout of a block, from r alone
  int sh, sw, pim, puv;
  __host__ __device__ explicit Geometry(int r)
      : sh(TH + 2 * r), sw(TW + 2 * r), pim(staged_pitch<T>(sw)), puv(staged_pitch<T>(sw * 2)) {}
  __host__ __device__ size_t bytes() const {
    return (size_t)HTH * HTW * sizeof(float) + (size_t)sh * (pim + puv) * sizeof(T);
  }
};

template <typename T, bool ASYNC>
__global__ void __launch_bounds__(NT)
spmc_splat_kernel(const T* __restrict__ im, const T* __restrict__ uv, T* __restrict__ out,
                  int h, int w, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry<T> g(r);
  float* acc = reinterpret_cast<float*>(smem);  // [HTH][HTW]
  T* sim = reinterpret_cast<T*>(acc + HTH * HTW);
  T* suv = sim + g.sh * g.pim;
  const int oh = h * S, ow = w * S;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;  // the tile's first LR cell
  const int oy = y0 - r, ox = x0 - r;  // image coordinates of the region's first source
  const int cx0 = max(ox, 0), ncol = min(ox + g.sw, w) - cx0;  // its in-image columns
  const long long pix = (long long)gridDim.z * h * w;
  const long long img = (long long)blockIdx.z * h;
  auto src_run = [&](int li, int cc) {
    const int gy = oy + li;
    const bool in = gy >= 0 && gy < h;
    return Run{in ? ((img + gy) * w + cx0) * cc : 0, in ? ncol * cc : 0};
  };
  stage_rows<T, ASYNC, NT>(sim, im, pix, g.sh, g.pim, [&](int li) { return src_run(li, 1); });
  stage_rows<T, ASYNC, NT>(suv, uv, pix * 2, g.sh, g.puv, [&](int li) { return src_run(li, 2); });
  pfnl::cp_async_commit();
  zero_tile<NT>(acc, HTH * HTW);
  pfnl::cp_async_wait<0>();
  __syncthreads();

  const int dmin = -S * r, dmax = S * r + S - 1;  // window of a tap's HR offset
  for_each_class<NT, 1>(g.sh, g.sw, oy, ox, 2 * r + 1, [&](int li, int lj, int) {
    const int gy = oy + li, gx = ox + lj;
    if (gy < 0 || gy >= h || gx < 0 || gx >= w) return;
    const unsigned lo = ((unsigned)blockIdx.z * h + gy) * (unsigned)w + cx0;  // the run's low bits
    const T* s_uv = suv + li * g.puv + staged_shift<T>(lo * 2) + (gx - cx0) * 2;
    const float v[1] = {to_f32(sim[li * g.pim + staged_shift<T>(lo) + gx - cx0])};
    const float xs = ((float)gx + to_f32(s_uv[0])) * (float)S;
    const float ys = ((float)gy + to_f32(s_uv[1])) * (float)S;
    const float x0f = floorf(xs), y0f = floorf(ys);
    const float wx[2] = {x0f + 1.0f - xs, xs - x0f};
    const float wy[2] = {y0f + 1.0f - ys, ys - y0f};
    const int dx0 = (int)x0f - S * gx, dy0 = (int)y0f - S * gy;
    int row[2], col[2];  // HR tile row / column of each tap, or out of the tile
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int dy = dy0 + k, dx = dx0 + k;
      row[k] = dy >= dmin && dy <= dmax ? clampi(S * gy + dy, 0, oh - 1) - S * y0 : -1;
      col[k] = dx >= dmin && dx <= dmax ? clampi(S * gx + dx, 0, ow - 1) - S * x0 : -1;
    }
    add_taps<1>(acc, HTW, HTH, HTW, row, col, wx, wy, v);
  });

  const int nout = S * min(TW, w - x0);
  store_rows<T, ASYNC, NT, 1>(out, acc, 0, HTW, min(HTH, oh - S * y0),
                              staged_pitch<T>(HTW) / Chunk<T>::N, [&](int ty) {
                                return Run{((long long)blockIdx.z * oh + S * y0 + ty) * ow +
                                               S * x0,
                                           nout};
                              });
}

template <typename T>
int launch_spmc_splat(const void* im, const void* uv, void* out, int b, int h, int w, int r,
                      cudaStream_t stream) {
  if (r < 0 || r > MAX_R || b < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = pfnl::aligned16({im, uv, out}) ? &spmc_splat_kernel<T, true>
                                               : &spmc_splat_kernel<T, false>;
  const size_t bytes = Geometry<T>(r).bytes();
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  kernel<<<grid, NT, bytes, stream>>>(static_cast<const T*>(im), static_cast<const T*>(uv),
                                      static_cast<T*>(out), h, w, r);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  im [b,h,w] (one channel), uv
// [b,h,w,2] and out [b,4h,4w], all of one type (float or bf16),
// contiguous; r = the flow bound R, 0 <= r <= pfnl_splat_max_r().
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
