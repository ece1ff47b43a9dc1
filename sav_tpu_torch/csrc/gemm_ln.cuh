// LayerNorm and bf16 GEMM launches shared by the K1 port
// (fused_attention.cu) and the K5a port (th_attention.cu).
//
//  * layernorm_kernel: one warp per row, y = LN(x) in bf16 with f32
//    statistics (fast variance E[x^2] - mu^2).
//  * gemm_kernel<kQkv>: y @ [Wq | Wk | Wv] side by side along the grid's x
//    axis, q scaled in the epilogue.
//  * gemm_kernel<kOut>: attn @ Wo, + resid in the epilogue when resid is
//    not null (the sublayer without its residual: CaiT's body).
// Both GEMMs stream 128 x 32 / 32 x 128 tiles through a 3-stage cp.async
// ring into mma.sync m16n8k16, f32 accumulation.
#pragma once

#include "mma.cuh"

namespace sav {

constexpr int GM = 128;             // rows of A / out per block
constexpr int GN = 128;             // columns of out per block
constexpr int GK = 32;              // depth per pipeline stage
constexpr int STAGES = 3;
constexpr int GA_LD = GK + 8;       // padded rows: conflict-free ldmatrix
constexpr int GB_LD = GN + 8;
constexpr int GEMM_SMEM = STAGES * (GM * GA_LD + GK * GB_LD) * 2;

__global__ void __launch_bounds__(256)
layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, bf16* __restrict__ y, int M,
                 int D, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      s += f;
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float mu = s / D;
  const float rs = rsqrtf(fmaxf(ss / D - mu * mu, 0.f) + eps);
  bf16* yr = y + (size_t)row * D;
  for (int c = lane * 8; c < D; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16((__bfloat162float(e[j]) - mu) * rs * scale[c + j]
                              + bias[c + j]);
    *reinterpret_cast<uint4*>(yr + c) = u;
  }
}

enum Epilogue { kQkv, kOut };

// C[M, n_each] = A[M, K] @ W[K, n_each] for up to three (W, C) pairs laid
// side by side along the grid's x axis (the q/k/v projections).
// kQkv: pair 0 is scaled by q_scale. kOut: C = A @ W (pair 0), plus resid
// when resid is not null.
// Needs K % 32 == 0 and n_each % 128 == 0; rows past M are zero-filled on
// load and never stored.
template <Epilogue kEpi>
__global__ void __launch_bounds__(256)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ w0,
            const bf16* __restrict__ w1, const bf16* __restrict__ w2,
            bf16* __restrict__ c0, bf16* __restrict__ c1,
            bf16* __restrict__ c2, const bf16* __restrict__ resid, int M,
            int K, int n_each, float q_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sB = sA + STAGES * GM * GA_LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * GM;
  const int which = blockIdx.x * GN / n_each;
  const int n0 = blockIdx.x * GN - which * n_each;
  const bf16* W = which == 0 ? w0 : (which == 1 ? w1 : w2);
  bf16* C = which == 0 ? c0 : (which == 1 ? c1 : c2);
  const float out_scale = (kEpi == kQkv && which == 0) ? q_scale : 1.f;
  const int k_tiles = K / GK;

  // each thread moves 2 x 16 B of the A tile and 2 x 16 B of the B tile
  auto load_stage = [&](int kt, int stage) {
    const int k0 = kt * GK;
    bf16* a = sA + stage * GM * GA_LD;
    bf16* b = sB + stage * GK * GB_LD;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * 256;
      const int r = i >> 2, c = (i & 3) * 8;
      const bool in = m0 + r < M;
      cp_async_16(&a[r * GA_LD + c],
                  A + (size_t)(in ? m0 + r : 0) * K + k0 + c, in ? 16 : 0);
      const int kr = i >> 4, nc = (i & 15) * 8;
      cp_async_16(&b[kr * GB_LD + nc],
                  W + (size_t)(k0 + kr) * n_each + n0 + nc, 16);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();        // tile kt has landed
    __syncthreads();                    // ... for all; tile kt-1 is consumed
    if (kt + STAGES - 1 < k_tiles)
      load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const bf16* a = sA + (kt % STAGES) * GM * GA_LD;
    const bf16* b = sB + (kt % STAGES) * GK * GB_LD;
#pragma unroll
    for (int ks = 0; ks < GK / 16; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], &a[(wm * 64 + mi * 16 + (lane & 15)) * GA_LD
                               + ks * 16 + (lane >> 4) * 8]);
      uint32_t bfr[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        const int kr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(r, &b[kr * GB_LD + wn * 32 + p * 16 + (lane >> 4) * 8]);
        bfr[2 * p][0] = r[0];
        bfr[2 * p][1] = r[1];
        bfr[2 * p + 1][0] = r[2];
        bfr[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_16816(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (row >= M) continue;
        float v0 = acc[mi][ni][2 * half] * out_scale;
        float v1 = acc[mi][ni][2 * half + 1] * out_scale;
        const size_t off = (size_t)row * n_each + col;
        if (kEpi == kOut && resid != nullptr) {
          const __nv_bfloat162 x2 =
              *reinterpret_cast<const __nv_bfloat162*>(resid + off);
          v0 += __low2float(x2);
          v1 += __high2float(x2);
        }
        *reinterpret_cast<uint32_t*>(C + off) = pack_bf16(v0, v1);
      }
    }
  }
}

}  // namespace sav
