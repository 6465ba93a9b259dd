// The implicit-GEMM convolution tile of the bf16 tensor cores, shared by
// kernel 10 (duf_dense.cu: DUF's 3x3x3 conv alone), kernel 9's growth conv
// (duf_block.cu) and both convs of kernel 4 (pfnl_tail.cu): a kt x 3 x 3
// conv over the planes of one sample, SAME in H/W,
//
//   out[o, y, x, c_off + g] = act(bias[g] + sum_{dt,dh,dw,c} in[o+off+dt, y-1+dh, x-1+dw, c]
//                                                             * W[dt, dh, dw, c, g])
//
// with `in` zero outside the image and outside its planes [0, n_in).  DUF's
// growth conv is kt = 3 with off = -1 (SAME in T) or 0 (VALID in T); PFNL's
// merge conv is kt = T, off = 0 and one output plane (frame t meets the
// 64-row slice t of Wm1, the concat of the frames never exists); its fold
// conv is kt = 1.  Weight row (dt, tap = 3 dh + dw, c) sits at
// wt + (dt * w_plane + tap * w_tap + c) * G, which covers DHWIO [3,3,3,F,G]
// (w_plane = 9 F, w_tap = F) and HWIO [3,3,T*64,48] (w_plane = 64, w_tap =
// 64 T) alike.  The zeros are never read: a halo pixel outside the image is
// zero-filled by cp.async with src-size 0, and a plane outside [0, n_in) is
// skipped.
//
// The GEMM: M = output pixels, N = G (16, 32 or 48), K = kt 9 F walked as
// (dt, channel chunk of CK = 32, two k-steps of 16, the 9 spatial taps), by
// mma.sync m16n8k16 bf16 with float32 accumulation (mma.cuh) and one
// rounding to bf16 in the epilogue (after the bias and, for kernel 4's merge
// conv, the leaky ReLU).
//
// Operand roles.  Pixels are A (16 consecutive pixels of one output row, the
// mma's M) and the weights are B (G on N).  N = G = 16 gives only G/8 = 2
// mma per A fragment and tap, so the A fragments are what must be reused:
// an input row serves three output rows (dh = 0, 1, 2), and a warp owns 4
// output rows x 16 columns, so each A fragment read from shared memory
// (input row iy, shifted by dw) feeds up to 3 x G/8 mma, the six input rows
// of a warp 12 x G/8 in all per dw.  The B fragments of the three dh taps of
// one dw (G/8 x 2 registers each) are loaded once a k-step and held while
// the six input rows stream.  With G on M instead, a 16 x 16 weight tile
// per tap would stay in registers and pixel fragments would feed only G/16
// mma each; the pixel operand is the large one, so it is the one reused.
//
// Tiles.  A block is WY x 2 warps and a 4 WY x 32 pixel tile of one output
// plane (WY = 2 for DUF: 8 x 32; 4 for kernel 4, whose 48-wide weight
// chunks are then shared by twice the pixels); its input window is
// (4 WY + 2) x 34 pixels.  Per (dt, chunk) stage it holds the window's CK
// channels (pixel stride 40 elements, 80 bytes, so the eight row addresses
// of an ldmatrix fall on distinct banks) and the weights W[dt, :, :, chunk,
// :] (row stride G + 8 elements: 48, 80 or 112 bytes, for the same reason,
// read by ldmatrix.trans).  Two stages are double-buffered: cp.async fills
// the next while the current computes.  The tap shift needs no im2col:
// ldmatrix takes one address per row, so a (dh, dw) shift of the window is
// another set of row addresses.  A chunk past F is zero-filled on both
// operands, so a ragged F (40, or 48 = 32 + 16) stays exact.
//
// Bound on the H100: kt 9 F G multiply-adds per output pixel against F + G
// elements: compute-bound for every caller (267.5 GFLOP at F 384, batch 2,
// 7 planes, LR 180x320).  Each mma of this tile needs about 190 bytes from
// shared memory at G = 16 (a 512-byte A fragment per 4 mma, a B fragment
// per 8), so shared-memory bandwidth, not tensor-core issue, caps it near
// half the 989 TFLOP/s peak (PERF.md has what it reaches); at G = 48 an A
// fragment feeds 3 x 6 mma.  Each input plane is staged once per dt that
// reads it, through L2.  Left for later: wgmma with the window fed by TMA and
// a producer warp.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace pfnl {

template <int G, int WY = 2>
struct ConvMma {
  static_assert(G == 16 || G == 32 || G == 48, "G is 16, 32 or 48");
  static constexpr int WR = 4, WC = 16;        // a warp's output rows x columns
  static constexpr int WARPS_Y = WY, WARPS_X = 2;
  static constexpr int THREADS = 32 * WARPS_Y * WARPS_X;
  static constexpr int TH = WR * WARPS_Y, TW = WC * WARPS_X;
  static constexpr int IH = TH + 2, IW = TW + 2;
  static constexpr int CK = 32;                 // channels a stage
  static constexpr int PS = CK + 8;             // pixel stride in the window (80 bytes)
  static constexpr int WS = G + 8;              // weight-row stride (48, 80 or 112 bytes)
  static constexpr int NT = G / 8;              // n-tiles
  static constexpr int IN_ELEMS = IH * IW * PS;
  static constexpr int W_ELEMS = 9 * CK * WS;
  static constexpr int STAGE = IN_ELEMS + W_ELEMS;
  static_assert(IN_ELEMS % 8 == 0 && STAGE % 8 == 0, "stages start 16-byte aligned");
  static constexpr size_t SMEM_BYTES = 2 * (size_t)STAGE * sizeof(__nv_bfloat16);

  // Pixel tiles of an h x w plane.
  static int tiles(int h, int w) { return ((h + TH - 1) / TH) * ((w + TW - 1) / TW); }
};

// What a conv_mma_tile launch convolves (a kernel parameter, by value).
//   in:   [nb, n_in, h, w, ldi] bf16; channels [0, f) are read
//   off, kt: output plane o reads input planes o + off + dt, dt in [0, kt)
//   wt:   bf16 weight rows of G, row (dt, tap, c) at wt + (dt*w_plane + tap*w_tap + c) * G
//   bias: [G] float, or nullptr for none
//   out:  element (b, o, y, x, g) at
//         out[(((b * out_planes + out_base + o) * h + y) * w + x) * ldo + c_off + g]
struct ConvMmaArgs {
  const __nv_bfloat16* in;
  int n_in, h, w, ldi, f, off, kt;
  const __nv_bfloat16* wt;
  int w_plane, w_tap;
  const float* bias;
  __nv_bfloat16* out;
  int out_planes, out_base, ldo, c_off;
};

// Output plane o, pixel tile `tile`, sample b, computed by the block.
// ASYNC: in and wt are 16-byte aligned and f and ldi multiples of 8, so
// every 8-channel chunk is staged by cp.async; otherwise element by element.
// LRELU: the leaky ReLU after the bias.  Every output of the tile inside the
// image is written, rounded once; nothing else of `out` is touched.
template <int G, int WY, bool ASYNC, bool LRELU>
__device__ void conv_mma_tile(const ConvMmaArgs p, int o, int tile, int b, __nv_bfloat16* smem) {
  using C = ConvMma<G, WY>;
  using bf16 = __nv_bfloat16;
  const int h = p.h, w = p.w, f = p.f, ldi = p.ldi;
  const int tiles_x = (w + C::TW - 1) / C::TW;
  const int y0 = (tile / tiles_x) * C::TH, x0 = (tile % tiles_x) * C::TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wy0 = (warp / C::WARPS_X) * C::WR, wx0 = (warp % C::WARPS_X) * C::WC;
  const size_t plane = (size_t)h * w;

  // the stages: (dt, chunk) over the planes that exist, chunk fastest
  const int q0 = o + p.off;  // the input plane of dt = 0
  const int dt_lo = max(0, -q0), dt_hi = min(p.kt, p.n_in - q0);
  const int nchunks = (f + C::CK - 1) / C::CK;
  const int n_stages = (dt_hi - dt_lo) * nchunks;

  auto issue = [&](int s, bf16* st) {
    const int dt = dt_lo + s / nchunks, c0 = (s % nchunks) * C::CK;
    const bf16* src = p.in + ((size_t)b * p.n_in + q0 + dt) * plane * ldi;
    constexpr int CPP = C::CK / 8;  // 16-byte chunks per pixel
    for (int i = threadIdx.x; i < C::IH * C::IW * CPP; i += C::THREADS) {
      const int px = i / CPP, c = (i % CPP) * 8;
      const int gy = y0 - 1 + px / C::IW, gx = x0 - 1 + px % C::IW;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
      const int n = inside ? min(max(f - c0 - c, 0), 8) : 0;
      stage_chunk<8, ASYNC>(st + px * C::PS + c, src + ((ptrdiff_t)gy * w + gx) * ldi + c0 + c,
                            n, p.in);
    }
    // st_w[(tap * CK + c) * WS + g] = W[dt, tap / 3, tap % 3, c0 + c, g]
    bf16* st_w = st + C::IN_ELEMS;
    const bf16* wsrc = p.wt + ((size_t)dt * p.w_plane + c0) * G;
    for (int i = threadIdx.x; i < 9 * C::CK * C::NT; i += C::THREADS) {
      const int gc = (i % C::NT) * 8, row = i / C::NT, c = row % C::CK, tap = row / C::CK;
      const int n = c0 + c < f ? 8 : 0;
      stage_chunk<8, ASYNC>(st_w + row * C::WS + gc,
                            wsrc + ((size_t)tap * p.w_tap + c) * G + gc, n, p.wt);
    }
  };

  float acc[C::WR][C::NT][4];
#pragma unroll
  for (int r = 0; r < C::WR; ++r)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;

  if (n_stages > 0) {
    issue(0, smem);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    const bf16* st = smem + (s & 1) * C::STAGE;
    if (s + 1 < n_stages) {  // the other buffer, read two stages ago
      issue(s + 1, smem + ((s + 1) & 1) * C::STAGE);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* st_w = st + C::IN_ELEMS;
#pragma unroll
    for (int ks = 0; ks < C::CK / 16; ++ks) {
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        // B fragments of taps (dh, dw), dh = 0..2: n-tiles 2q, 2q+1 from one x4.trans
        uint32_t wf[3][C::NT][2];
#pragma unroll
        for (int dh = 0; dh < 3; ++dh)
#pragma unroll
          for (int q = 0; q < C::NT / 2; ++q) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, st_w + ((dh * 3 + dw) * C::CK + ks * 16 + ((lane / 8) % 2) * 8 +
                                         lane % 8) * C::WS + 8 * (2 * q + lane / 16));
            wf[dh][2 * q][0] = r[0];
            wf[dh][2 * q][1] = r[1];
            wf[dh][2 * q + 1][0] = r[2];
            wf[dh][2 * q + 1][1] = r[3];
          }
        // window row wy0 + iy, columns wx0 + dw .. +15: output row iy - dh at tap (dh, dw)
#pragma unroll
        for (int iy = 0; iy < C::WR + 2; ++iy) {
          uint32_t a[4];
          ldmatrix_x4(a, st + ((wy0 + iy) * C::IW + wx0 + dw + lane % 16) * C::PS + ks * 16 +
                             (lane / 16) * 8);
#pragma unroll
          for (int dh = 0; dh < 3; ++dh) {
            const int ry = iy - dh;
            if (ry < 0 || ry >= C::WR) continue;
#pragma unroll
            for (int j = 0; j < C::NT; ++j) mma_bf16(acc[ry][j], a, wf[dh][j][0], wf[dh][j][1]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // acc[ry][j]: pixels (row wy0 + ry, columns wx0 + lane/4 and +8), g = 8j + 2(lane%4) + {0,1}
  bf16* dst = p.out + ((size_t)b * p.out_planes + p.out_base + o) * plane * p.ldo + p.c_off;
#pragma unroll
  for (int ry = 0; ry < C::WR; ++ry) {
    const int gy = y0 + wy0 + ry;
    if (gy >= h) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + wx0 + lane / 4 + 8 * half;
      if (gx >= w) continue;
      bf16* d = dst + ((size_t)gy * w + gx) * p.ldo;
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gg = 8 * j + 2 * (lane % 4) + e;
          float v = acc[ry][j][2 * half + e] + (p.bias != nullptr ? p.bias[gg] : 0.f);
          if constexpr (LRELU) v = lrelu(v);
          d[gg] = __float2bfloat16_rn(v);
        }
    }
  }
}

}  // namespace pfnl
