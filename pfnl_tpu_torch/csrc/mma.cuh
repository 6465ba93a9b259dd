// Tensor-core and async-copy primitives of sm_80+ used by the bf16 kernels
// (kernels 2-3 in pfrb.cu, kernel 9's product in duf_block.cu, and the
// conv tile of kernels 4, 9 and 10 in duf_conv_mma.cuh; kernel 1 in
// nonlocal_flash.cu takes ldmatrix and pack_bf16 for its wgmma operands):
// mma.sync m16n8k16 bf16 with float32 accumulation, ldmatrix, cp.async;
// and by the float32 entries of kernels 2-3 and 5-6 (tf32_conv.cuh):
// mma.sync m16n8k8 TF32 run three times a k-step on a hi + lo split
// (3xTF32).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 regs of two bf16:  a0 (g, 2t..2t+1), a1 (g+8, 2t..),
//                                                 a2 (g, 2t+8..),  a3 (g+8, 2t+8..)
//   B (16 x 8, "col": stored [n][k]), 2 regs:     b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C/D (16 x 8, float):                          c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..)
// ldmatrix.x4 hands lane l the fragment pieces of four 8x8 matrices whose
// rows are addressed by lanes 8i..8i+7 (matrix i); `.trans` transposes each.
#pragma once

#include <cstdint>
#include <initializer_list>

#include <cuda_bf16.h>

namespace pfnl {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The inverse of ldmatrix_x4 (sm_90): register i of each lane (row lane / 4,
// columns 2(lane % 4).. of matrix i) to shared memory, lane l giving the
// address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void stmatrix_x4(void* row, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :
               : "r"(smem_addr(row)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// d += a * b, bf16 inputs, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// cp.async of BYTES (8 or 16) from global to shared; only src_bytes (0 or
// BYTES) are read, the rest of the destination is zero-filled.  Both
// addresses are BYTES-aligned.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  static_assert(BYTES == 8 || BYTES == 16, "cp.async copies 8 or 16 bytes here");
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the VEC-element chunk at src (n of its elements valid, the rest
// zero) into shared memory at dst.  ASYNC: the chunk is VEC-aligned and n
// is 0 or VEC, so it goes by cp.async (zero-filled with src-size 0 from the
// aligned address `any`, never read); otherwise element by element.
template <int VEC, bool ASYNC>
__device__ __forceinline__ void stage_chunk(__nv_bfloat16* dst, const __nv_bfloat16* src, int n,
                                            const __nv_bfloat16* any) {
  if constexpr (ASYNC) {
    cp_async<VEC * 2>(dst, n > 0 ? src : any, n > 0 ? VEC * 2 : 0);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) dst[k] = k < n ? src[k] : __float2bfloat16_rn(0.f);
  }
}

// Fragment layouts of mma.m16n8k8 TF32 (g = lane / 4, t = lane % 4), one
// 32-bit element a register:
//   A (16 x 8, row-major), 4 regs:  a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, "col"), 2 regs:       b0 (k t, n g), b1 (k t+4, n g)
//   C/D (16 x 8, float):            as for m16n8k16
// ldmatrix moves 16-bit elements only; these fragments come from 32-bit
// ld.shared, one element a lane.

// x rounded to TF32 by cvt.rna's rule (to nearest, ties away from zero): a
// float whose low 13 mantissa bits are zero.  Written as two integer
// operations: ptxas expands cvt.rna.tf32.f32 itself to four (with a guard
// for Inf and NaN), which made kernels 5-6 slower.  The two differ only on
// NaN inputs.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi and lo TF32: lo holds the 11 significant bits after
// hi's, so hi*hi + hi*lo + lo*hi keeps a float32
// product to about 2^-21.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a * b, TF32 inputs, float32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b to float32 accuracy (3xTF32) from split fragments (a[0],
// b[0]: hi; a[1], b[1]: lo): lo*hi and hi*lo first, then hi*hi, as
// CUTLASS's 3xTF32 orders them.  The mma accumulate with truncation, so a
// caller keeps the chains of one accumulator short (kernels 5-6 sum 24-48
// mma into a fresh one, then add it to the total in float32).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a)[2][4],
                                           const uint32_t (&b)[2][2]) {
  mma_tf32(d, a[1], b[0][0], b[0][1]);
  mma_tf32(d, a[0], b[1][0], b[1][1]);
  mma_tf32(d, a[0], b[0][0], b[0][1]);
}

// Stage the 4 floats at src (zero if !inside) into shared memory at dst.
// ASYNC: both 16-byte aligned, by cp.async (src-size 0 from the aligned
// address `any` when outside, never read); otherwise element by element.
template <bool ASYNC>
__device__ __forceinline__ void stage_f32x4(float* dst, const float* src, bool inside,
                                            const float* any) {
  if constexpr (ASYNC) {
    cp_async<16>(dst, inside ? src : any, inside ? 16 : 0);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[k] = inside ? src[k] : 0.f;
  }
}

// cp.async of one float from global to shared (both 4-byte aligned, as
// every float is): a copy that transposes while it stages.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// Every pointer 16-byte aligned: a kernel may stage them all by cp.async.
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return (bits & 15) == 0;
}

}  // namespace pfnl
