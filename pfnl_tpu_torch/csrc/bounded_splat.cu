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
// Design: a scatter into shared-memory tiles (splat_tile.cuh).  A block
// owns TH x TW output pixels x C channels and stages, with cp.async, the
// image and flow of every source that can reach them: the tile plus R+1
// rows / columns above and left and R below and right (a fold reaches the
// border only from sources within that span).  Each source's taps (floor,
// the two target rows and columns, clamped for the fold or dropped outside
// [-R, R+1], the products wx*wy) are computed once per block, by the one
// thread that adds its terms im * (wx*wy) into a float32 tile, in the
// plain version's tap order.  The sources go class by class, (i mod 2R+2,
// j mod 2R+2): a source's taps span 2R+2 rows and columns, so two sources
// of one class never reach one pixel and no atomics are needed.  A block
// keeps tiles(C) float tiles and runs that many classes between two
// barriers, each into its own tile; the write-out adds the tiles in order
// and rounds once to T, with 16-byte stores.  Every output sums in one
// fixed order (tile, class, tap), so two launches are bitwise equal.  A
// gather (a thread per run of 4 outputs reading every source that can
// reach it) would read (2R+2)(2R+5) sources a run at R=2, about 14 an
// output where the scatter handles about one; it was not taken.  The
// TPU's channel-major planes and split u/v planes (answers to its 128
// lanes) are not carried over: im is NHWC, uv [B,H,W,2].
//
// Bound on the H100: memory.  Per output pixel it reads and writes C values
// and reads two flow values once from device memory (halo re-reads hit L2):
// 5.5 MB at VESPCN's [12,1,180,320] bf16, 59 MB at FRVSR's HR grid
// [4,3,720,1280].  What sets its pace instead is the class schedule: each
// class is a chain of dependent steps per source (staged flow, floor,
// clamp, read-add-write of the tile) between two barriers, and a class
// holds about 1 / (2R+2)^2 of the block's sources, so few warps have work
// at a time.  For one channel, where the staged image and flow outweigh
// a tile, four tiles run four classes a barrier; at three channels a
// second tile measured slower (it halves the blocks an SM holds).  Each
// such choice (tiles, TH x TW, threads, the float4 write-out) is undone
// by a variant of `python -m pfnl_tpu_torch.ops.cuda.profile_splats
// --variants`, which times it beside these sources.
#include "splat_tile.cuh"

namespace {

using pfnl::from_f32;
using pfnl::to_f32;
using namespace pfnl::splat;

constexpr int MAX_C = 4, TH = 16, TW = 64, NT = 128;
// float tiles a block keeps (classes a barrier), by channels
__host__ __device__ constexpr int tiles(int c) { return c == 1 ? 4 : 1; }
static_assert((TH + 2 * MAX_R + 1) * (TW + 2 * MAX_R + 1) < MAX_SOURCES, "for_each_class");

template <typename T>
struct Geometry {  // shared-memory layout of a block, from c and r alone
  int sh, sw, pim, puv;
  __host__ __device__ Geometry(int c, int r)
      : sh(TH + 2 * r + 1), sw(TW + 2 * r + 1), pim(staged_pitch<T>(sw * c)),
        puv(staged_pitch<T>(sw * 2)) {}
  __host__ __device__ size_t bytes(int c) const {
    return (size_t)tiles(c) * TH * TW * c * sizeof(float) + (size_t)sh * (pim + puv) * sizeof(T);
  }
};

template <typename T, int C, bool ASYNC>
__global__ void __launch_bounds__(NT)
bounded_splat_kernel(const T* __restrict__ im, const T* __restrict__ uv, T* __restrict__ out,
                     int h, int w, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RP = TW * C, NBUF = tiles(C);  // RP: floats a tile row
  const Geometry<T> g(C, r);
  float* acc = reinterpret_cast<float*>(smem);  // NBUF tiles [TH][TW][C]
  T* sim = reinterpret_cast<T*>(acc + NBUF * TH * RP);
  T* suv = sim + g.sh * g.pim;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int oy = y0 - r - 1, ox = x0 - r - 1;  // image coordinates of the region's first source
  const int cx0 = max(ox, 0), ncol = min(ox + g.sw, w) - cx0;  // its in-image columns
  const long long pix = (long long)gridDim.z * h * w;
  const long long img = (long long)blockIdx.z * h;
  auto src_run = [&](int li, int cc) {
    const int gy = oy + li;
    const bool in = gy >= 0 && gy < h;
    return Run{in ? ((img + gy) * w + cx0) * cc : 0, in ? ncol * cc : 0};
  };
  stage_rows<T, ASYNC, NT>(sim, im, pix * C, g.sh, g.pim, [&](int li) { return src_run(li, C); });
  stage_rows<T, ASYNC, NT>(suv, uv, pix * 2, g.sh, g.puv, [&](int li) { return src_run(li, 2); });
  pfnl::cp_async_commit();
  zero_tile<NT>(acc, NBUF * TH * RP);
  pfnl::cp_async_wait<0>();
  __syncthreads();

  for_each_class<NT, NBUF>(g.sh, g.sw, oy, ox, 2 * r + 2, [&](int li, int lj, int b) {
    const int gy = oy + li, gx = ox + lj;
    if (gy < 0 || gy >= h || gx < 0 || gx >= w) return;
    const unsigned lo = ((unsigned)blockIdx.z * h + gy) * (unsigned)w + cx0;  // the run's low bits
    const T* s_uv = suv + li * g.puv + staged_shift<T>(lo * 2) + (gx - cx0) * 2;
    const T* s_im = sim + li * g.pim + staged_shift<T>(lo * C) + (gx - cx0) * C;
    const float xs = (float)gx + to_f32(s_uv[0]);
    const float ys = (float)gy + to_f32(s_uv[1]);
    const float x0f = floorf(xs), y0f = floorf(ys);
    const float wx[2] = {x0f + 1.0f - xs, xs - x0f};
    const float wy[2] = {y0f + 1.0f - ys, ys - y0f};
    const int dx0 = (int)x0f - gx, dy0 = (int)y0f - gy;
    int row[2], col[2];  // tile row / column of each tap, or out of the tile
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int dy = dy0 + k, dx = dx0 + k;
      row[k] = dy >= -r && dy <= r + 1 ? clampi(gy + dy, 0, h - 1) - y0 : -1;
      col[k] = dx >= -r && dx <= r + 1 ? clampi(gx + dx, 0, w - 1) - x0 : -1;
    }
    float v[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = to_f32(s_im[ch]);
    add_taps<C>(acc + b * TH * RP, RP, TH, TW, row, col, wx, wy, v);
  });

  const int nout = min(TW, w - x0) * C;
  store_rows<T, ASYNC, NT, NBUF>(out, acc, TH * RP, RP, min(TH, h - y0),
                                 staged_pitch<T>(RP) / Chunk<T>::N, [&](int ty) {
                                   return Run{((img + y0 + ty) * w + x0) * C, nout};
                                 });
}

template <typename T, int C>
int launch_c(const void* im, const void* uv, void* out, int b, int h, int w, int r,
             cudaStream_t stream) {
  auto kernel = pfnl::aligned16({im, uv, out}) ? &bounded_splat_kernel<T, C, true>
                                               : &bounded_splat_kernel<T, C, false>;
  const size_t bytes = Geometry<T>(C, r).bytes(C);
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  kernel<<<grid, NT, bytes, stream>>>(static_cast<const T*>(im), static_cast<const T*>(uv),
                                       static_cast<T*>(out), h, w, r);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bounded_splat(const void* im, const void* uv, void* out, int b, int h, int w, int c,
                         int r, cudaStream_t stream) {
  if (c < 1 || c > MAX_C || r < 0 || r > MAX_R || b < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  switch (c) {
    case 1: return launch_c<T, 1>(im, uv, out, b, h, w, r, stream);
    case 2: return launch_c<T, 2>(im, uv, out, b, h, w, r, stream);
    case 3: return launch_c<T, 3>(im, uv, out, b, h, w, r, stream);
    default: return launch_c<T, 4>(im, uv, out, b, h, w, r, stream);
  }
}

}  // namespace

// C interface, loaded with ctypes.  im [b,h,w,c] and out [b,h,w,c], uv
// [b,h,w,2], all of one type (float or bf16), contiguous; 1 <= c <= 4;
// r = the flow bound R, 0 <= r <= pfnl_splat_max_r() (kernel 8's too).
extern "C" {

int pfnl_splat_max_r() { return MAX_R; }

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
