// K10's attention core (fused_attention_q8.cu) on the head-band layout.
//
// q, k, v, out are [B, rows, stride] bf16 with head h in columns
// [h*64, h*64+64); q is pre-scaled by 1/sqrt(d). One block of 4 warps per
// (64-query tile, head, image); each warp owns 16 query rows. A first
// sweep over the key tiles of 64 finds each row's final max, so every
// p = exp(s - max) is rounded to bf16 against the max the TPU kernel
// subtracts (one block over all keys), which K10's int8 codes of the
// output depend on; the second sweep never rescales, and the output is
// divided by the row sum, as that kernel does. Query rows past q_len are
// loaded as zeros and never stored; key rows past kv_len are loaded as
// zeros and their logits set to -inf, so no tail row is dropped or leaks.
// (The bf16 attention of K1 and K4 runs the Hopper kernel of
// flash_fwd_sm90.cuh instead.)
#pragma once

#include <math.h>

#include "mma.cuh"

namespace sav {

constexpr int ATT_D = 64;
constexpr int ATT_BQ = 64;
constexpr int ATT_BK = 64;
constexpr int ATT_LD = ATT_D + 8;   // padded row: conflict-free fragments

// out row stride equals q's.
__global__ void __launch_bounds__(128)
attention_fwd_exact_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           int q_len, int kv_rows, int kv_len, int q_stride,
                           int kv_stride) {
  __shared__ __align__(16) bf16 sQ[ATT_BQ * ATT_LD];
  __shared__ __align__(16) bf16 sK[2][ATT_BK * ATT_LD];
  __shared__ __align__(16) bf16 sV[2][ATT_BK * ATT_LD];

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * ATT_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + (size_t)b * q_len * q_stride + h * ATT_D;
  const bf16* kb = k + (size_t)b * kv_rows * kv_stride + h * ATT_D;
  const bf16* vb = v + (size_t)b * kv_rows * kv_stride + h * ATT_D;

  // rows past the true length are zero-filled (src-size 0, clamped address)
  auto load_kv = [&](int k0, int buf) {
    for (int i = tid; i < ATT_BK * 8; i += 128) {
      const int r = i >> 3, c = (i & 7) * 8;
      const bool in = k0 + r < kv_len;
      const size_t off = (size_t)(in ? k0 + r : 0) * kv_stride + c;
      cp_async_16(&sK[buf][r * ATT_LD + c], kb + off, in ? 16 : 0);
      cp_async_16(&sV[buf][r * ATT_LD + c], vb + off, in ? 16 : 0);
    }
  };
  for (int i = tid; i < ATT_BQ * 8; i += 128) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool in = q0 + r < q_len;
    cp_async_16(&sQ[r * ATT_LD + c],
                qb + (size_t)(in ? q0 + r : 0) * q_stride + c, in ? 16 : 0);
  }
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(qf[kk], &sQ[(wr + (lane & 15)) * ATT_LD + kk * 16 + (lane >> 4) * 8]);

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // logits of this warp's 16 rows against key tile k0 (in sKb), keys past
  // kv_len at -inf
  auto logits = [&](const bf16* sKb, int k0, float (&s)[8][4]) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // keys 16j..16j+15 (rows), d 16kk..16kk+15: b0/b1 of two n8 tiles
        uint32_t kf[4];
        ldmatrix_x4(kf, &sKb[(j * 16 + (lane & 7) + ((lane >> 4) << 3)) * ATT_LD
                             + kk * 16 + ((lane >> 3) & 1) * 8]);
        mma_16816(s[2 * j], qf[kk], kf[0], kf[1]);
        mma_16816(s[2 * j + 1], qf[kk], kf[2], kf[3]);
      }
    }
    if (k0 + ATT_BK > kv_len) {         // key tail of the last tile
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (k0 + nt * 8 + 2 * t + j >= kv_len) {
            s[nt][j] = -INFINITY;
            s[nt][2 + j] = -INFINITY;
          }
        }
      }
    }
  };

  // sweep 1: the rows' final max, K tiles through buffer 1 (buffer 0
  // holds tile 0 for sweep 2)
  for (int k0 = 0; k0 < kv_len; k0 += ATT_BK) {
    const bf16* sKb = sK[0];
    if (k0 > 0) {
      for (int i = tid; i < ATT_BK * 8; i += 128) {
        const int r = i >> 3, c = (i & 7) * 8;
        const bool in = k0 + r < kv_len;
        cp_async_16(&sK[1][r * ATT_LD + c],
                    kb + (size_t)(in ? k0 + r : 0) * kv_stride + c,
                    in ? 16 : 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      sKb = sK[1];
    }
    float s[8][4];
    logits(sKb, k0, s);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
    __syncthreads();                  // buffer 1 is free again
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }

  // sweep 2, K/V tiles double-buffered: tile it+1 streams in while tile
  // it is used; one barrier per tile both publishes tile it+1 and retires
  // buffer it&1. m0/m1 are final, so nothing is rescaled.
  for (int it = 0, k0 = 0; k0 < kv_len; ++it, k0 += ATT_BK) {
    const int buf = it & 1;
    if (k0 + ATT_BK < kv_len) load_kv(k0 + ATT_BK, buf ^ 1);
    cp_async_commit();
    const bf16* sKb = sK[buf];
    const bf16* sVb = sV[buf];

    float s[8][4];
    logits(sKb, k0, s);

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {    // exp(s - max), as the TPU kernel
      s[nt][0] = expf(s[nt][0] - m0);
      s[nt][1] = expf(s[nt][1] - m0);
      s[nt][2] = expf(s[nt][2] - m1);
      s[nt][3] = expf(s[nt][3] - m1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 += rs0;                          // per-lane partial; reduced at the end
    l1 += rs1;

    // P (rounded to bf16, as the TPU kernel feeds its PV matmul) · V
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const int key = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &sVb[key * ATT_LD + p * 16 + (lane >> 4) * 8]);
        mma_16816(o[2 * p], pa, vf[0], vf[1]);
        mma_16816(o[2 * p + 1], pa, vf[2], vf[3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  bf16* ob = out + (size_t)b * q_len * q_stride + h * ATT_D + 2 * t;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {      // divided by the sum
    o[dt][0] = __fdiv_rn(o[dt][0], l0);
    o[dt][1] = __fdiv_rn(o[dt][1], l0);
    o[dt][2] = __fdiv_rn(o[dt][2], l1);
    o[dt][3] = __fdiv_rn(o[dt][3], l1);
    if (row0 < q_len)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * q_stride + dt * 8) =
          pack_bf16(o[dt][0], o[dt][1]);
    if (row1 < q_len)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * q_stride + dt * 8) =
          pack_bf16(o[dt][2], o[dt][3]);
  }
}

}  // namespace sav
