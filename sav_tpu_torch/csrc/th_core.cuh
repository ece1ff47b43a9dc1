// The talking-heads forward core shared by the TH ports (th_attention.cu:
// K5a, K6a) and the int8 TH span (th_attention_q8.cu: K11): the tile
// helpers, th_fwd_kernel<H, RES> (RES: K5a's resident logit rows, else
// K6a's two sweeps over the keys) and its launcher. What it computes and
// why it is shaped so: th_attention.cu's header.
#pragma once

#include <math.h>

#include "mma.cuh"

namespace sav {

constexpr int TD = 48;          // head width
constexpr int TK = 32;          // keys per tile
constexpr int TROWS = 128;      // (query row, head) pairs per block
constexpr int TTHREADS = 256;   // 8 warps
constexpr int TSMEM_LIMIT = 232448;
constexpr int SLD = TK + 4;     // f32 tile pitch
constexpr int PLD = TK + 8;     // bf16 tile pitch: conflict-free ldmatrix

__host__ __device__ inline int round_up_to(int n, int m) {
  return (n + m - 1) / m * m;
}

// rows [r0, r0 + rows) of a [*, L, hd] band tensor -> smem (pitch ld);
// rows at or past `valid` are zero-filled (src-size 0, clamped address)
__device__ __forceinline__ void th_load_rows(bf16* dst, int ld,
                                             const bf16* src, int hd, int r0,
                                             int rows, int valid, int tid) {
  const int chunks = hd / 8;
  for (int i = tid; i < rows * chunks; i += TTHREADS) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const bool in = r0 + r < valid;
    cp_async_16(&dst[r * ld + c], src + (size_t)(in ? r0 + r : 0) * hd + c,
                in ? 16 : 0);
  }
}

// A fragments (3 k-steps) of the 16 x 48 band at smem row r0, column c0
__device__ __forceinline__ void th_load_a48(uint32_t (&f)[3][4], const bf16* s,
                                            int ld, int r0, int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 3; ++kk)
    ldmatrix_x4(f[kk], &s[(r0 + (lane & 15)) * ld + c0 + kk * 16 + (lane >> 4) * 8]);
}

// acc[4][4] = A (16 x 48, fragments) . B^T where B is 32 rows (n) x 48 (k)
// at smem column c0: a 16 x 32 f32 tile
__device__ __forceinline__ void th_mma_nt32(float (&acc)[4][4],
                                            const uint32_t (&a)[3][4],
                                            const bf16* s, int ld, int c0,
                                            int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t f[4];
      ldmatrix_x4(f, &s[(p * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0
                        + kk * 16 + ((lane >> 3) & 1) * 8]);
      mma_16816(acc[2 * p], a[kk], f[0], f[1]);
      mma_16816(acc[2 * p + 1], a[kk], f[2], f[3]);
    }
  }
}

// acc[6][4] += A (16 x 32 bf16 at smem a_s, pitch a_ld) . B (32 rows (k) x
// 48 (n) at smem column c0 of b_s)
__device__ __forceinline__ void th_mma_nn48(float (&acc)[6][4],
                                            const bf16* a_s, int a_ld,
                                            const bf16* b_s, int b_ld, int c0,
                                            int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, &a_s[(lane & 15) * a_ld + ks * 16 + (lane >> 4) * 8]);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      uint32_t f[4];
      ldmatrix_x4_trans(f, &b_s[(ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * b_ld
                                + c0 + p * 16 + (lane >> 4) * 8]);
      mma_16816(acc[2 * p], a, f[0], f[1]);
      mma_16816(acc[2 * p + 1], a, f[2], f[3]);
    }
  }
}

// a 16 x 32 f32 accumulator tile -> smem (pitch ld)
__device__ __forceinline__ void th_store_tile(float* s, int ld,
                                              const float (&acc)[4][4],
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    *reinterpret_cast<float2*>(&s[g * ld + nt * 8 + 2 * t]) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(&s[(g + 8) * ld + nt * 8 + 2 * t]) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// rows [r0, r0 + 16) of a 16 x 48 accumulator -> out band (rows < L only)
__device__ __forceinline__ void th_store_band(bf16* out, int hd, int L,
                                              int r0, int c0,
                                              const float (&acc)[6][4],
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) {
    const int col = c0 + nt * 8 + 2 * t;
    if (r0 + g < L)
      *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + g) * hd + col) =
          pack_bf16(acc[nt][0], acc[nt][1]);
    if (r0 + g + 8 < L)
      *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + g + 8) * hd + col) =
          pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

// reduce over the `tpr` consecutive lanes that share one row
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
template <int TPR>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// out[i] = sum_j m[j * H + i] * in[j]
template <int H>
__device__ __forceinline__ void th_mix(float (&out)[H], const float* m,
                                       const float (&in)[H]) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < H; ++j) acc = fmaf(m[j * H + i], in[j], acc);
    out[i] = acc;
  }
}
// out[j] = sum_i m[j * H + i] * in[i]   (the transposed mix)
template <int H>
__device__ __forceinline__ void th_mix_t(float (&out)[H], const float* m,
                                         const float (&in)[H]) {
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < H; ++i) acc = fmaf(m[j * H + i], in[i], acc);
    out[j] = acc;
  }
}

// ------------------------------------------------------------- forward

template <int H, bool RES>
struct ThFwd {
  static constexpr int HD = H * TD;
  static constexpr int LDB = HD + 8;
  static constexpr int BQ = (RES ? TROWS : 2 * TROWS) / H;
  static constexpr int TASKS = H * BQ / 16 / 8;
  static constexpr int TPR = TTHREADS / BQ;
  static constexpr int RINGS = RES ? 1 : 2;     // K/V share one ring if RES
  // logits / probabilities tiles span LK columns
  __host__ __device__ static int lk(int L) { return RES ? round_up_to(L, TK) : TK; }
  __host__ __device__ static size_t smem(int L) {
    const int w = lk(L);
    return (size_t)H * BQ * (w + 4) * 4 + (size_t)H * BQ * (w + 8) * 2
        + (size_t)RINGS * 2 * TK * LDB * 2 + 2 * H * H * 4;
  }
};

// grid (ceil(L / BQ), B), 256 threads. lse [B, H, L] f32 or null.
template <int H, bool RES>
__global__ void __launch_bounds__(TTHREADS, 1)
th_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ mpre_g,
              const float* __restrict__ mpost_g, bf16* __restrict__ attn,
              float* __restrict__ lse, int L) {
  using G = ThFwd<H, RES>;
  constexpr int HD = G::HD, LDB = G::LDB, BQ = G::BQ, TASKS = G::TASKS,
                TPR = G::TPR;
  const int LK = G::lk(L), sld = LK + 4, pld = LK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sS = reinterpret_cast<float*>(smem_raw);             // [H][BQ][sld]
  float* sM = sS + H * BQ * sld;                              // [2][H][H]
  bf16* sP = reinterpret_cast<bf16*>(sM + 2 * H * H);         // [H][BQ][pld]
  bf16* sK = sP + H * BQ * pld;                               // 2 x [TK][LDB]
  bf16* sV = RES ? sK : sK + 2 * TK * LDB;

  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kb = k + (size_t)b * L * HD;
  const bf16* vb = v + (size_t)b * L * HD;
  for (int i = tid; i < 2 * H * H; i += TTHREADS)
    sM[i] = i < H * H ? mpre_g[i] : mpost_g[i - H * H];
  const float* mpre = sM;
  const float* mpost = sM + H * H;

  // q of this block's rows, staged through the K ring into fragments
  th_load_rows(sK, LDB, q + (size_t)b * L * HD, HD, q0, BQ, L, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[TASKS][3][4];
#pragma unroll
  for (int j = 0; j < TASKS; ++j) {
    const int tk = warp + 8 * j, h = tk % H, mt = tk / H;
    th_load_a48(qf[j], sK, LDB, mt * 16, h * TD, lane);
  }
  __syncthreads();

  // per-head logits of one key tile -> sS columns [col0, col0 + TK)
  auto qk_tile = [&](const bf16* kt, int col0) {
#pragma unroll
    for (int j = 0; j < TASKS; ++j) {
      const int tk = warp + 8 * j, h = tk % H, mt = tk / H;
      float acc[4][4];
      th_mma_nt32(acc, qf[j], kt, LDB, h * TD, lane);
      th_store_tile(sS + (h * BQ + mt * 16) * sld + col0, sld, acc, lane);
    }
  };
  float o[TASKS][6][4];
#pragma unroll
  for (int j = 0; j < TASKS; ++j)
#pragma unroll
    for (int n = 0; n < 6; ++n) o[j][n][0] = o[j][n][1] = o[j][n][2] = o[j][n][3] = 0.f;
  auto pv_tile = [&](const bf16* vt, int col0) {
#pragma unroll
    for (int j = 0; j < TASKS; ++j) {
      const int tk = warp + 8 * j, h = tk % H, mt = tk / H;
      th_mma_nn48(o[j], sP + (h * BQ + mt * 16) * pld + col0, pld, vt, LDB,
                  h * TD, lane);
    }
  };

  const int r = tid / TPR, u = tid % TPR;        // this thread's row
  const int ntiles = (L + TK - 1) / TK;
  float mx[H], sm[H];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    mx[i] = -INFINITY;
    sm[i] = 0.f;
  }

  if (RES) {
    // keys once: every logit of the block's rows, whole kv rows resident
    th_load_rows(sK, LDB, kb, HD, 0, TK, L, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int it = 0; it < ntiles; ++it) {
      if (it + 1 < ntiles)
        th_load_rows(sK + ((it + 1) & 1) * TK * LDB, LDB, kb, HD, (it + 1) * TK,
                     TK, L, tid);
      cp_async_commit();
      qk_tile(sK + (it & 1) * TK * LDB, it * TK);
      cp_async_wait<0>();
      __syncthreads();
    }
    // pre-mix in place (each thread reads all heads of a position, then
    // writes them), masked after the mix; exact softmax of each mixed row
    for (int c = u; c < LK; c += TPR) {
      float s[H], st[H];
#pragma unroll
      for (int j = 0; j < H; ++j) s[j] = sS[(j * BQ + r) * sld + c];
      th_mix<H>(st, mpre, s);
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float x = c < L ? st[i] : -INFINITY;
        sS[(i * BQ + r) * sld + c] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
#pragma unroll
    for (int i = 0; i < H; ++i) mx[i] = row_max<TPR>(mx[i]);
    for (int c = u; c < LK; c += TPR) {
#pragma unroll
      for (int i = 0; i < H; ++i) {
        float* p = &sS[(i * BQ + r) * sld + c];
        const float e = expf(*p - mx[i]);
        *p = e;
        sm[i] += e;
      }
    }
#pragma unroll
    for (int i = 0; i < H; ++i) sm[i] = row_sum<TPR>(sm[i]);
    for (int c = u; c < LK; c += TPR) {
      float pn[H], pt[H];
#pragma unroll
      for (int j = 0; j < H; ++j) pn[j] = sS[(j * BQ + r) * sld + c] / sm[j];
      th_mix<H>(pt, mpost, pn);
#pragma unroll
      for (int i = 0; i < H; ++i) sP[(i * BQ + r) * pld + c] = __float2bfloat16(pt[i]);
    }
    __syncthreads();
    // values once: P V
    th_load_rows(sV, LDB, vb, HD, 0, TK, L, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int it = 0; it < ntiles; ++it) {
      if (it + 1 < ntiles)
        th_load_rows(sV + ((it + 1) & 1) * TK * LDB, LDB, vb, HD, (it + 1) * TK,
                     TK, L, tid);
      cp_async_commit();
      pv_tile(sV + (it & 1) * TK * LDB, it * TK);
      cp_async_wait<0>();
      __syncthreads();
    }
  } else {
    // sweep 1: online max and sum of each mixed head
    th_load_rows(sK, LDB, kb, HD, 0, TK, L, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int it = 0; it < ntiles; ++it) {
      if (it + 1 < ntiles)
        th_load_rows(sK + ((it + 1) & 1) * TK * LDB, LDB, kb, HD, (it + 1) * TK,
                     TK, L, tid);
      cp_async_commit();
      qk_tile(sK + (it & 1) * TK * LDB, 0);
      __syncthreads();
      for (int c = u; c < TK; c += TPR) {
        if (it * TK + c >= L) continue;
        float s[H], st[H];
#pragma unroll
        for (int j = 0; j < H; ++j) s[j] = sS[(j * BQ + r) * sld + c];
        th_mix<H>(st, mpre, s);
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float m_new = fmaxf(mx[i], st[i]);
          sm[i] = sm[i] * expf(mx[i] - m_new) + expf(st[i] - m_new);
          mx[i] = m_new;
        }
      }
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float m_all = row_max<TPR>(mx[i]);
      // a lane that saw no valid key has mx = -inf and sm = 0
      const float part = mx[i] == -INFINITY ? 0.f : sm[i] * expf(mx[i] - m_all);
      sm[i] = row_sum<TPR>(part);
      mx[i] = m_all;
    }
    float lse_r[H];
#pragma unroll
    for (int i = 0; i < H; ++i) lse_r[i] = mx[i] + logf(sm[i]);

    // sweep 2: probabilities, post-mix, P V
    th_load_rows(sK, LDB, kb, HD, 0, TK, L, tid);
    th_load_rows(sV, LDB, vb, HD, 0, TK, L, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int it = 0; it < ntiles; ++it) {
      if (it + 1 < ntiles) {
        const int nb = ((it + 1) & 1) * TK * LDB;
        th_load_rows(sK + nb, LDB, kb, HD, (it + 1) * TK, TK, L, tid);
        th_load_rows(sV + nb, LDB, vb, HD, (it + 1) * TK, TK, L, tid);
      }
      cp_async_commit();
      qk_tile(sK + (it & 1) * TK * LDB, 0);
      __syncthreads();
      for (int c = u; c < TK; c += TPR) {
        const bool valid = it * TK + c < L;
        float s[H], st[H], pn[H], pt[H];
#pragma unroll
        for (int j = 0; j < H; ++j) s[j] = sS[(j * BQ + r) * sld + c];
        th_mix<H>(st, mpre, s);
#pragma unroll
        for (int i = 0; i < H; ++i) pn[i] = valid ? expf(st[i] - lse_r[i]) : 0.f;
        th_mix<H>(pt, mpost, pn);
#pragma unroll
        for (int i = 0; i < H; ++i) sP[(i * BQ + r) * pld + c] = __float2bfloat16(pt[i]);
      }
      __syncthreads();
      pv_tile(sV + (it & 1) * TK * LDB, 0);
      cp_async_wait<0>();
      __syncthreads();
    }
  }

  if (lse != nullptr && u == 0 && q0 + r < L) {
#pragma unroll
    for (int i = 0; i < H; ++i)
      lse[((size_t)b * H + i) * L + q0 + r] = mx[i] + logf(sm[i]);
  }
#pragma unroll
  for (int j = 0; j < TASKS; ++j) {
    const int tk = warp + 8 * j, h = tk % H, mt = tk / H;
    th_store_band(attn + (size_t)b * L * HD, HD, L, q0 + mt * 16, h * TD, o[j],
                  lane);
  }
}

template <typename K>
cudaError_t th_smem_attr(K kernel, size_t bytes) {
  if (bytes > (size_t)TSMEM_LIMIT) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int H, bool RES>
cudaError_t th_core_launch(const bf16* q, const bf16* k, const bf16* v,
                           const float* mpre, const float* mpost, bf16* attn,
                           float* lse, int batch, int L, cudaStream_t st) {
  using G = ThFwd<H, RES>;
  const size_t bytes = G::smem(L);
  cudaError_t err = th_smem_attr(th_fwd_kernel<H, RES>, bytes);
  if (err != cudaSuccess) return err;
  th_fwd_kernel<H, RES><<<dim3((L + G::BQ - 1) / G::BQ, batch), TTHREADS, bytes,
                          st>>>(q, k, v, mpre, mpost, attn, lse, L);
  return cudaGetLastError();
}

}  // namespace sav
