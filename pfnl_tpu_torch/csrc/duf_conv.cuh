// The 3x3x3 growth convolution of DUF's dense blocks on CUDA cores: the
// routine shared by the float32 entries of kernel 9 (duf_block.cu, after its
// pointwise chain) and kernel 10 (duf_dense.cu).
//
//   out[o, y, x, g] = bias[g] + sum_{dt,dh,dw,c} in[o+off+dt, y-1+dh, x-1+dw, c]
//                                                * W[dt, dh, dw, c, g]
//
// with `in` zero outside the image and outside its planes [0, n_in): SAME in
// H/W, SAME (off = -1) or VALID (off = 0) in T.  The zeros are never stored:
// a tap outside the image reads 0 while staging, and a tap on a temporal pad
// plane is skipped.
//
// One block computes one TH x TW pixel tile of one output plane of one
// sample, all G output channels, on CUDA cores with float accumulation.  For
// each of its (up to) three input planes it walks the F input channels in
// chunks of CK: the chunk's input window with its 1-pixel halo and the nine
// [CK, G] weight slices of that dt are staged in shared memory as float.
// Each thread owns PPT horizontally adjacent pixels x CPT adjacent output
// channels; a row of PPT+2 staged inputs feeds the three dw taps, so one
// shared-memory load feeds up to 3*CPT FMAs.  The shared-memory channel
// stride of the input is CK+1 (odd), so the pixel groups of a warp read
// distinct banks.
#pragma once

#include "common.cuh"

namespace pfnl {

template <int G>
struct Conv333 {
  static constexpr int TH = 8, TW = 16, PPT = 4, CPT = 8, CK = 16;
  static_assert(G % CPT == 0, "G must be a multiple of 8");
  static_assert(CPT == 8, "a thread reads its weights as two float4");
  static constexpr int NCG = G / CPT;     // output-channel groups
  static constexpr int TPR = TW / PPT;    // pixel groups per tile row
  static constexpr int NPG = TH * TPR;    // pixel groups
  static constexpr int THREADS = NCG * NPG;
  static constexpr int IH = TH + 2, IW = TW + 2, CS = CK + 1;
  static constexpr int IN_FLOATS = IH * IW * CS;
  static constexpr int W_FLOATS = 9 * CK * G;
  static_assert(IN_FLOATS % 4 == 0, "the weights start 16-byte aligned");
  static constexpr size_t SMEM_BYTES = (IN_FLOATS + W_FLOATS) * sizeof(float);

  // Pixel tiles of an h x w plane: gridDim.x of a launch.
  static int tiles(int h, int w) { return ((h + TH - 1) / TH) * ((w + TW - 1) / TW); }
};

// The tile of block (blockIdx.x = pixel tile, blockIdx.y = output plane o,
// blockIdx.z = sample b).
//   in:   [nb, n_in, h, w, ldi] float; channels [0, f) are read
//   wt:   [3, 3, 3, f, G] float (DHWIO)
//   bias: [G] float, or nullptr for none
//   out:  element (b, o, y, x, g) at
//         out[(((b * out_planes + out_base + o) * h + y) * w + x) * ldo + c_off + g]
// Every output of the tile inside the image is written.
template <int G>
__device__ void conv3x3x3_tile(const float* __restrict__ in, int n_in, int h, int w, int ldi, int f,
                               int off, const float* __restrict__ wt,
                               const float* __restrict__ bias, float* __restrict__ out,
                               int out_planes, int out_base, int ldo, int c_off, float* smem) {
  using C = Conv333<G>;
  float* s_in = smem;
  float* s_w = smem + C::IN_FLOATS;
  const int tiles_x = (w + C::TW - 1) / C::TW;
  const int y0 = (blockIdx.x / tiles_x) * C::TH, x0 = (blockIdx.x % tiles_x) * C::TW;
  const int o = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int cg = tid % C::NCG, pg = tid / C::NCG;
  const int py = pg / C::TPR, px = (pg % C::TPR) * C::PPT;
  const size_t plane = (size_t)h * w;

  float acc[C::PPT][C::CPT] = {};
  for (int dt = 0; dt < 3; ++dt) {
    const int q = o + off + dt;
    if (q < 0 || q >= n_in) continue;  // a temporal pad plane: its taps are zero
    const float* src = in + ((size_t)b * n_in + q) * plane * ldi;
    for (int c0 = 0; c0 < f; c0 += C::CK) {
      __syncthreads();  // the previous chunk's reads of shared memory are done
      for (int i = tid; i < C::IH * C::IW * C::CK; i += C::THREADS) {
        const int c = i % C::CK, p = i / C::CK;
        const int gy = y0 - 1 + p / C::IW, gx = x0 - 1 + p % C::IW;
        float v = 0.f;
        if (gy >= 0 && gy < h && gx >= 0 && gx < w && c0 + c < f)
          v = src[((size_t)gy * w + gx) * ldi + c0 + c];
        s_in[p * C::CS + c] = v;
      }
      // s_w[(tap * CK + c) * G + g] = W[dt, tap / 3, tap % 3, c0 + c, g]
      for (int i = tid; i < C::W_FLOATS; i += C::THREADS) {
        const int g = i % G, c = (i / G) % C::CK, tap = i / (G * C::CK);
        s_w[i] = c0 + c < f ? wt[((size_t)(dt * 9 + tap) * f + c0 + c) * G + g] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int c = 0; c < C::CK; ++c) {
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          const float* row = s_in + ((py + dh) * C::IW + px) * C::CS + c;
          float xv[C::PPT + 2];
#pragma unroll
          for (int i = 0; i < C::PPT + 2; ++i) xv[i] = row[i * C::CS];
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            const float4* wp = reinterpret_cast<const float4*>(
                s_w + ((dh * 3 + dw) * C::CK + c) * G + cg * C::CPT);
            const float4 w0 = wp[0], w1 = wp[1];
            const float wv[C::CPT] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int p = 0; p < C::PPT; ++p)
#pragma unroll
              for (int j = 0; j < C::CPT; ++j) acc[p][j] = fmaf(xv[p + dw], wv[j], acc[p][j]);
          }
        }
      }
    }
  }

  const int gy = y0 + py;
  if (gy >= h) return;
  float* dst = out + ((size_t)b * out_planes + out_base + o) * plane * ldo + c_off + cg * C::CPT;
#pragma unroll
  for (int p = 0; p < C::PPT; ++p) {
    const int gx = x0 + px + p;
    if (gx >= w) continue;
    float* d = dst + ((size_t)gy * w + gx) * ldo;
#pragma unroll
    for (int j = 0; j < C::CPT; ++j)
      d[j] = acc[p][j] + (bias != nullptr ? bias[cg * C::CPT + j] : 0.f);
  }
}

}  // namespace pfnl
