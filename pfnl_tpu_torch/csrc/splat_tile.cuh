// The tile shared by kernels 7 (bounded_splat.cu) and 8 (spmc_splat.cu):
// a block owns an output tile, stages the image and flow of every source
// that can reach it into shared memory, adds each source's bilinear taps
// into a float32 copy of the tile there, and writes the tile out once.
//
// Staging: every region row is a contiguous run of elements of the flat
// NHWC array (the in-image columns of one image row), staged whole 16-byte
// chunks at a time from the chunk that holds its first element.  ASYNC:
// the array is 16-byte aligned, so each chunk goes by cp.async, with
// src-size 0 for a chunk of a row outside the image (never read) and
// src-size cut at the array's end; otherwise element by element.  A chunk
// may hold elements of neighbouring pixels of the array: they are never
// used.
//
// Order and races: the sources are split into colour classes by their image
// coordinates, (i mod P, j mod P), with P at least the number of cells one
// source's taps span in each direction (kernel 7: 2R+2 pixels; kernel 8:
// 2R+1 LR cells).  Two sources of one class lie P or more apart in a row or
// a column, so the unclamped targets of their taps are disjoint there; the
// border clamp is monotone, and only sources within the span of a border
// fold onto it, so two sources of one class never fold onto one pixel
// either (tests/test_torch_warp.py checks both on random flows).  A block
// keeps NBUF float tiles; the classes, numbered n = (i mod P) * P + (j mod
// P), run NBUF at a time, class n into tile n % NBUF, with a barrier
// between, so no two threads ever add to one element at once.  Within a
// class each source belongs to one thread, which computes its taps (once
// per block) and adds them in the plain version's tap order, two folded
// onto one pixel in turn; the write-out adds the NBUF tiles in order.
// Every output thus sums its terms in one fixed order: no atomics, two
// launches bitwise equal.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace pfnl::splat {

constexpr int MAX_R = 4;  // the flow bound the halo of a tile is sized for
// Sources a block's region may hold: for_each_class's float quotients stay
// exact below it (see there); each kernel asserts its region at MAX_R.
constexpr int MAX_SOURCES = 1 << 22;

template <typename T> struct Chunk;  // elements of T in 16 bytes
template <> struct Chunk<float> { static constexpr int N = 4; };
template <> struct Chunk<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// a mod p in [0, p) for any sign of a
__device__ __forceinline__ int pmod(int a, int p) {
  const int m = a % p;
  return m < 0 ? m + p : m;
}

// A region row: elements [lo, lo + len) of a flat array; len == 0 for a row
// outside the image.
struct Run {
  long long lo;
  int len;
};

// Elements of shared memory a staged row of n elements takes: whole chunks
// from the chunk that holds its first element.
template <typename T>
__host__ __device__ constexpr int staged_pitch(int n) {
  return (n + 2 * Chunk<T>::N - 2) / Chunk<T>::N * Chunk<T>::N;
}

// Where a run's first element lies in its staged row: lo mod the chunk,
// from lo's low bits, which 32-bit arithmetic that wraps keeps exact.
template <typename T>
__device__ __forceinline__ int staged_shift(unsigned lo_low_bits) {
  return (int)(lo_low_bits & (Chunk<T>::N - 1));
}

// Stage `rows` runs of the flat array src (n elements), run(r) giving row
// r, into dst + r * pitch.  Commits nothing: the caller commits and waits.
template <typename T, bool ASYNC, int NT, typename RunFn>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, long long n,
                                           int rows, int pitch, RunFn run) {
  constexpr int V = Chunk<T>::N;
  const int chunks = pitch / V;
  for (int q = threadIdx.x; q < rows * chunks; q += NT) {
    const int r = q / chunks, k = q % chunks;
    const Run rr = run(r);
    const long long e = (rr.lo & ~(long long)(V - 1)) + (long long)k * V;
    const bool inside = rr.len > 0 && e < rr.lo + rr.len;
    T* d = dst + r * pitch + k * V;
    if constexpr (ASYNC) {
      const int take = inside ? (int)min((long long)V, n - e) : 0;
      cp_async<16>(d, inside ? src + e : src, take * (int)sizeof(T));
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        d[v] = (inside && e + v >= rr.lo && e + v < rr.lo + rr.len) ? src[e + v]
                                                                   : from_f32<T>(0.f);
    }
  }
}

__device__ __forceinline__ void store16(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// Zero n floats of shared memory (n a multiple of 4, p 16-byte aligned).
template <int NT>
__device__ __forceinline__ void zero_tile(float* p, int n) {
  for (int q = threadIdx.x * 4; q < n; q += NT * 4)
    *reinterpret_cast<float4*>(p + q) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Write `rows` rows of the float tile to the runs of dst: row r of the sum
// of the NBUF tiles at tile + b * tstride (added in that order), at tile +
// r * tpitch, its values in run(r)'s order, rounded once to T.  VEC (dst
// 16-byte aligned): a whole chunk inside a run whose tile column is a
// multiple of 4 by float4 reads of the tiles and one 16-byte store; the
// ragged ends, and every chunk of a run that starts off a 4-element
// boundary (W * C not a multiple of 4), element by element.  `chunks`
// bounds the chunks a run touches.
template <typename T, bool VEC, int NT, int NBUF, typename RunFn>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float* tile, int tstride,
                                           int tpitch, int rows, int chunks, RunFn run) {
  constexpr int V = Chunk<T>::N;
  for (int q = threadIdx.x; q < rows * chunks; q += NT) {
    const int r = q / chunks, k = q % chunks;
    const Run rr = run(r);
    const long long e = (rr.lo & ~(long long)(V - 1)) + (long long)k * V;
    if (rr.len <= 0 || e >= rr.lo + rr.len) continue;
    const float* t = tile + r * tpitch;  // 16-byte aligned: tpitch, tstride multiples of 4
    const int at = (int)(e - rr.lo);  // tile column of the chunk's first element (may be < 0)
    if (VEC && at >= 0 && at + V <= rr.len && (at & 3) == 0) {
      float v[V];
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        float4 x = *reinterpret_cast<const float4*>(t + at + i);
#pragma unroll
        for (int b = 1; b < NBUF; ++b) {
          const float4 y = *reinterpret_cast<const float4*>(t + b * tstride + at + i);
          x = make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y), __fadd_rn(x.z, y.z),
                          __fadd_rn(x.w, y.w));
        }
        *reinterpret_cast<float4*>(v + i) = x;
      }
      store16(dst + e, v);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (at + i < 0 || at + i >= rr.len) continue;
        float x = t[at + i];
#pragma unroll
        for (int b = 1; b < NBUF; ++b) x = __fadd_rn(x, t[b * tstride + at + i]);
        dst[e + i] = from_f32<T>(x);
      }
    }
  }
}

// Run fn(li, lj, b) for every source of a region of sh x sw sources whose
// first one lies at image row oy, column ox, class by class: the classes
// (i mod p, j mod p) of the image coordinates, numbered n = ci * p + cj,
// go NBUF at a time, class n into float tile b = n % NBUF by NT / NBUF
// threads, one source a thread, a barrier after each NBUF.  Class (ci, cj)
// starts at region row (ci - oy) mod p and holds sh / p rows, one more
// where that start lies below sh mod p (columns alike).  Quotients by p and
// by a class's columns nc come from float reciprocals: (x + 0.5) / d lies
// at least 0.5 / d from an integer, and the reciprocal and the product
// round it by at most 2^-23 of itself, (x + 0.5) / d * 2^-23, which is
// less than 0.5 / d while x + 0.5 < 2^22.  Here x is a class number n <
// p^2 or a source k < sh * sw, both below MAX_SOURCES.
template <int NT, int NBUF, typename Fn>
__device__ __forceinline__ void for_each_class(int sh, int sw, int oy, int ox, int p, Fn fn) {
  static_assert(NT % NBUF == 0, "equal thread groups");
  constexpr int G = NT / NBUF;
  const int b = threadIdx.x / G, t = threadIdx.x % G;
  const int qr = sh / p, rr = sh % p, qc = sw / p, rc = sw % p;
  const int r0 = pmod(-oy, p), c0 = pmod(-ox, p);
  const float inv_p = 1.0f / (float)p;
  const float inv_q = 1.0f / (float)max(qc, 1), inv_q1 = 1.0f / (float)(qc + 1);
  for (int n0 = 0; n0 < p * p; n0 += NBUF) {
    const int n = n0 + b;
    if (n < p * p) {
      const int ci = (int)(((float)n + 0.5f) * inv_p), cj = n - ci * p;
      const int li0 = r0 + ci < p ? r0 + ci : r0 + ci - p;
      const int lj0 = c0 + cj < p ? c0 + cj : c0 + cj - p;
      const int nr = qr + (li0 < rr), nc = qc + (lj0 < rc);
      const float inv = lj0 < rc ? inv_q1 : inv_q;
      for (int k = t; k < nr * nc; k += G) {
        const int a = (int)(((float)k + 0.5f) * inv);
        fn(li0 + a * p, lj0 + (k - a * nc) * p, b);
      }
    }
    __syncthreads();
  }
}

// Add one source's four taps, im * (wx*wy) per channel, to the float tile
// (pixel (row, col) at acc + row * pitch + col * C), in the plain version's
// order (y0,x0) (y1,x0) (y0,x1) (y1,x1); a tap outside [0, rows) x
// [0, cols) belongs to another tile (or is dropped: -1).  Two taps folded
// onto one pixel add in turn.
template <int C>
__device__ __forceinline__ void add_taps(float* acc, int pitch, int rows, int cols,
                                         const int (&row)[2], const int (&col)[2],
                                         const float (&wx)[2], const float (&wy)[2],
                                         const float (&v)[C]) {
#pragma unroll
  for (int kx = 0; kx < 2; ++kx) {
#pragma unroll
    for (int ky = 0; ky < 2; ++ky) {
      if ((unsigned)row[ky] >= (unsigned)rows || (unsigned)col[kx] >= (unsigned)cols) continue;
      const float wt = __fmul_rn(wx[kx], wy[ky]);
      float* at = acc + row[ky] * pitch + col[kx] * C;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) at[ch] = __fadd_rn(at[ch], __fmul_rn(v[ch], wt));
    }
  }
}

// Launch-time check of a kernel's dynamic shared memory: above the default
// 48 KB the kernel has to opt in.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace pfnl::splat
