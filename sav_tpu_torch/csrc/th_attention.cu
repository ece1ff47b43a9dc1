// K5 and K6 ports: CaiT's talking-heads attention, forward and backward.
//
// Replaces sav_tpu/ops/th_attention.py::_th_fwd_kernel (K5a),
// ::_th_bwd_kernel (K5b), ::_th_blk_fwd_kernel (K6a) and
// ::_th_blk_bwd_kernel (K6b). Same function, on [B, L, H*48] bf16 head
// bands (q pre-scaled by 1/sqrt(48)) and f32 [H, H] mixes M_pre, M_post:
//   s_j  = q_j k_j^T                       (f32)
//   st_i = sum_j M_pre[j, i] s_j           (pre-softmax head mix)
//   pn_i = softmax(st_i)                   (exact, over the true length)
//   pt_i = sum_j M_post[j, i] pn_j         (post-softmax head mix)
//   o_i  = bf16(pt_i) v_i,  lse_i = logsumexp(st_i)
// and its gradients (dq, dk, dv, dM_pre, dM_post), rounded to bf16 where
// the TPU kernels round, with f32 accumulation. head_ch 48 is taken as it
// is: q k^T is three 16-deep k-steps of mma.sync m16n8k16 and P V six
// 8-wide n-tiles, so nothing is padded to 64.
//
// What is new against flash attention (csrc/attention_core.cuh):
//  * The mixes couple all heads: one mixed logit takes the logits of all H
//    heads at the same (query, key). So one block owns EVERY head of its
//    query rows: 8 warps compute the per-head tiles with mma.sync into
//    f32 shared memory, then all 256 threads mix them position by
//    position (H^2 scalar FMAs per mix, the [H, H] matrices in shared
//    memory), and the warps take the mixed tiles back to the tensor cores.
//    A block holds 128 (query row, head) pairs: 16 query rows at H = 8.
//  * No single-pass online softmax: the post-mix sums NORMALIZED
//    probabilities of different heads. Two answers, one per route:
//      K5a core (th_fwd_kernel<H, true>): the logits of whole kv rows of
//        all heads stay resident in shared memory (f32, 128 rows x L), so
//        the softmax is exact in one pass over the keys, like the TPU's
//        unrolled lists. It fits while L <= 224 at H = 8 (221.5 KB of the
//        227 KB a block may have at CaiT-S/24 @224, L = 196).
//      K6a (th_fwd_kernel<H, false>): 32 query rows x 32-key tiles; a
//        first sweep over the keys computes the lse of each mixed head
//        (online max and sum per mixed head), a second recomputes the
//        logits and forms pn = exp(st - lse), the post-mix and P V. Any L;
//        it pays one more q k^T sweep (~1.5x the forward's tensor work).
//  * The backward has no flash delta: dst_i = pn_i (dpn_i - rowsum(dpn_i
//    pn_i)) with dpn_j = sum_i M_post[j, i] do_i v_i^T, and that rowsum is
//    not rowsum(o * do). K5b and K6b share two kernels: th_bwd_dq_kernel,
//    one block per (16 query rows, image), sweeps the keys once for the
//    rowsum (delta, written for the next kernel) and dM_post, and once
//    more for ds, dq and dM_pre; th_bwd_dkv_kernel, one block per (16 key
//    rows, image), sweeps the queries and accumulates dk and dv in
//    registers. The TPU's sequential grid axis becomes these in-block
//    loops; nothing is summed across blocks with atomics. dM_pre and
//    dM_post leave each dq block as an [H, H] partial (warp shuffles, then
//    shared memory), summed afterwards in a fixed order by the wrapper.
//  * K5a is four launches, the first two and the last shared with K1
//    (gemm_ln.cuh): LN, the QKV GEMM with q scaled in its epilogue, the
//    resident core, and the out GEMM without the residual (CaiT adds
//    LayerScale and stochastic depth before the skip connection).
//
// Bound on the card: per (image, head, query, key) the forward does 192
// tensor-core operations (q k^T and P V at d = 48) and 4H scalar
// operations for the two mixes; the backward 480 and 12H (four mixes, the
// two dM sums). At H = 8 the mixes are 32 and 96 CUDA-core FMAs per
// position, against 989 TFLOP/s of bf16 tensor cores and 67 TFLOP/s of f32
// FMA: the mixes, not the products, bound these kernels, which is why the
// TPU kernel ran them as VMEM adds and why a later version would run them
// as [H, H] x [H, positions] tensor-core products.
//
// No silent row drops: query rows past L load as zeros (with lse = +inf in
// the backward, so p = 0) and are never stored; keys past L load as zeros
// and their mixed logits are set to -inf AFTER the pre-mix (a mix of -inf
// logits with signed weights would be NaN), so their probabilities, dk and
// dv are exact zeros. Nothing is padded.
#include <math.h>

#include "gemm_ln.cuh"

namespace sav {

constexpr int TD = 48;          // head width
constexpr int TK = 32;          // keys (forward, dq) or queries (dkv) per tile
constexpr int TROWS = 128;      // (query or key row, head) pairs per block
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

// ------------------------------------------------------------ backward

template <int H>
struct ThBwd {
  static constexpr int HD = H * TD;
  static constexpr int LDB = HD + 8;
  static constexpr int BR = TROWS / H;          // query (dq) or key (dkv) rows
  static constexpr int TPR = TTHREADS / BR;
  static constexpr size_t dq_smem =
      2 * (size_t)TROWS * SLD * 4 + 2 * H * H * 4 + 8 * H * H * 4
      + (size_t)TROWS * PLD * 2 + 4 * (size_t)TK * LDB * 2;
  static constexpr size_t dkv_smem =
      2 * (size_t)TROWS * SLD * 4 + 2 * H * H * 4 + 4 * (size_t)H * TK * 4
      + 2 * (size_t)TROWS * PLD * 2 + 4 * (size_t)TK * LDB * 2;
};

// sum of acc[e] over the block -> out[e] (e < H*H); red is [8][H*H] smem
template <int H>
__device__ __forceinline__ void th_block_sum(float (&acc)[H * H], float* red,
                                             float* out, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int e = 0; e < H * H; ++e) {
    float x = acc[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp * H * H + e] = x;
  }
  __syncthreads();
  for (int e = tid; e < H * H; e += TTHREADS) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) x += red[w * H * H + e];
    out[e] = x;
  }
  __syncthreads();
}

// grid (ceil(L / BR), B). Writes dq, delta [B, H, L] and this block's dM
// partials dm[b][blockIdx.x] = {dM_pre, dM_post} ([2][H][H] f32).
template <int H>
__global__ void __launch_bounds__(TTHREADS, 1)
th_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ mpre_g,
                 const float* __restrict__ mpost_g, float* __restrict__ delta,
                 float* __restrict__ dm, bf16* __restrict__ dq, int L) {
  using G = ThBwd<H>;
  constexpr int HD = G::HD, LDB = G::LDB, BQ = G::BR, TPR = G::TPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sS = reinterpret_cast<float*>(smem_raw);             // [H][BQ][SLD]
  float* sA = sS + TROWS * SLD;                               // da tiles
  float* sM = sA + TROWS * SLD;                               // [2][H][H]
  float* sRed = sM + 2 * H * H;                               // [8][H*H]
  bf16* sDS = reinterpret_cast<bf16*>(sRed + 8 * H * H);      // [H][BQ][PLD]
  bf16* sK = sDS + TROWS * PLD;                               // 2 x [TK][LDB]
  bf16* sV = sK + 2 * TK * LDB;

  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = warp % H, mt = warp / H;          // this warp's (head, rows)
  const bf16* kb = k + (size_t)b * L * HD;
  const bf16* vb = v + (size_t)b * L * HD;
  for (int i = tid; i < 2 * H * H; i += TTHREADS)
    sM[i] = i < H * H ? mpre_g[i] : mpost_g[i - H * H];
  const float* mpre = sM;
  const float* mpost = sM + H * H;

  th_load_rows(sK, LDB, q + (size_t)b * L * HD, HD, q0, BQ, L, tid);
  th_load_rows(sV, LDB, dout + (size_t)b * L * HD, HD, q0, BQ, L, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[3][4], df[3][4];
  th_load_a48(qf, sK, LDB, mt * 16, h * TD, lane);
  th_load_a48(df, sV, LDB, mt * 16, h * TD, lane);
  __syncthreads();

  const int r = tid / TPR, u = tid % TPR;
  const bool row_ok = q0 + r < L;
  float lse_r[H], dl[H];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    lse_r[i] = row_ok ? lse[((size_t)b * H + i) * L + q0 + r] : INFINITY;
    dl[i] = 0.f;
  }
  float dmacc[H * H];
#pragma unroll
  for (int e = 0; e < H * H; ++e) dmacc[e] = 0.f;

  // s_h and da_h = do_h v_h^T of one key tile -> sS, sA
  auto tiles = [&](int buf) {
    float acc[4][4];
    th_mma_nt32(acc, qf, sK + buf * TK * LDB, LDB, h * TD, lane);
    th_store_tile(sS + (h * BQ + mt * 16) * SLD, SLD, acc, lane);
    th_mma_nt32(acc, df, sV + buf * TK * LDB, LDB, h * TD, lane);
    th_store_tile(sA + (h * BQ + mt * 16) * SLD, SLD, acc, lane);
  };
  auto load_kv = [&](int k0, int buf) {
    th_load_rows(sK + buf * TK * LDB, LDB, kb, HD, k0, TK, L, tid);
    th_load_rows(sV + buf * TK * LDB, LDB, vb, HD, k0, TK, L, tid);
  };
  const int ntiles = (L + TK - 1) / TK;
  float* dm_blk = dm + ((size_t)b * gridDim.x + blockIdx.x) * 2 * H * H;

  // sweep 1: delta_i = rowsum(dpn_i * pn_i) and dM_post[j, i] = sum da_i pn_j
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv((it + 1) * TK, (it + 1) & 1);
    cp_async_commit();
    tiles(it & 1);
    __syncthreads();
    for (int c = u; c < TK; c += TPR) {
      if (it * TK + c >= L) continue;
      float s[H], pn[H], da[H], dpn[H];
#pragma unroll
      for (int j = 0; j < H; ++j) {
        s[j] = sS[(j * BQ + r) * SLD + c];
        da[j] = sA[(j * BQ + r) * SLD + c];
      }
      th_mix<H>(pn, mpre, s);
#pragma unroll
      for (int i = 0; i < H; ++i) pn[i] = expf(pn[i] - lse_r[i]);
      th_mix_t<H>(dpn, mpost, da);
#pragma unroll
      for (int j = 0; j < H; ++j) {
        dl[j] = fmaf(dpn[j], pn[j], dl[j]);
#pragma unroll
        for (int i = 0; i < H; ++i)
          dmacc[j * H + i] = fmaf(da[i], pn[j], dmacc[j * H + i]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < H; ++i) dl[i] = row_sum<TPR>(dl[i]);
  if (u == 0 && row_ok) {
#pragma unroll
    for (int i = 0; i < H; ++i) delta[((size_t)b * H + i) * L + q0 + r] = dl[i];
  }
  th_block_sum<H>(dmacc, sRed, dm_blk + H * H, tid);
#pragma unroll
  for (int e = 0; e < H * H; ++e) dmacc[e] = 0.f;

  // sweep 2: ds, dq = ds k, dM_pre[j, i] = sum dst_i s_j
  float dqa[6][4];
#pragma unroll
  for (int n = 0; n < 6; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv((it + 1) * TK, (it + 1) & 1);
    cp_async_commit();
    tiles(it & 1);
    __syncthreads();
    for (int c = u; c < TK; c += TPR) {
      const bool valid = it * TK + c < L;
      float s[H], pn[H], da[H], dpn[H], ds[H];
#pragma unroll
      for (int j = 0; j < H; ++j) {
        s[j] = sS[(j * BQ + r) * SLD + c];
        da[j] = sA[(j * BQ + r) * SLD + c];
      }
      th_mix<H>(pn, mpre, s);
#pragma unroll
      for (int i = 0; i < H; ++i) pn[i] = valid ? expf(pn[i] - lse_r[i]) : 0.f;
      th_mix_t<H>(dpn, mpost, da);
#pragma unroll
      for (int i = 0; i < H; ++i) pn[i] = pn[i] * (dpn[i] - dl[i]);    // dst
      th_mix_t<H>(ds, mpre, pn);
#pragma unroll
      for (int j = 0; j < H; ++j) {
        sDS[(j * BQ + r) * PLD + c] = __float2bfloat16(ds[j]);
#pragma unroll
        for (int i = 0; i < H; ++i)
          dmacc[j * H + i] = fmaf(pn[i], s[j], dmacc[j * H + i]);
      }
    }
    __syncthreads();
    th_mma_nn48(dqa, sDS + (h * BQ + mt * 16) * PLD, PLD, sK + (it & 1) * TK * LDB,
                LDB, h * TD, lane);
    cp_async_wait<0>();
    __syncthreads();
  }
  th_block_sum<H>(dmacc, sRed, dm_blk, tid);
  th_store_band(dq + (size_t)b * L * HD, HD, L, q0 + mt * 16, h * TD, dqa, lane);
}

// grid (ceil(L / BR), B): one block per BR key rows sweeps all queries and
// accumulates dk_h, dv_h of its rows in registers.
template <int H>
__global__ void __launch_bounds__(TTHREADS, 1)
th_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const float* __restrict__ mpre_g,
                  const float* __restrict__ mpost_g, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int L) {
  using G = ThBwd<H>;
  constexpr int HD = G::HD, LDB = G::LDB, BK = G::BR, TPR = G::TPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sS = reinterpret_cast<float*>(smem_raw);       // s^T [H][BK][SLD]
  float* sA = sS + TROWS * SLD;                         // da^T
  float* sM = sA + TROWS * SLD;                         // [2][H][H]
  float* sL = sM + 2 * H * H;                           // 2 x [H][TK] lse
  float* sD = sL + 2 * H * TK;                          // 2 x [H][TK] delta
  bf16* sP = reinterpret_cast<bf16*>(sD + 2 * H * TK);  // pt^T [H][BK][PLD]
  bf16* sDS = sP + TROWS * PLD;                         // ds^T
  bf16* sQ = sDS + TROWS * PLD;                         // 2 x [TK][LDB]
  bf16* sO = sQ + 2 * TK * LDB;                         // do, 2 x [TK][LDB]

  const int b = blockIdx.y, k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = warp % H, mt = warp / H;
  const bf16* qb = q + (size_t)b * L * HD;
  const bf16* ob = dout + (size_t)b * L * HD;
  for (int i = tid; i < 2 * H * H; i += TTHREADS)
    sM[i] = i < H * H ? mpre_g[i] : mpost_g[i - H * H];
  const float* mpre = sM;
  const float* mpost = sM + H * H;

  th_load_rows(sQ, LDB, k + (size_t)b * L * HD, HD, k0, BK, L, tid);
  th_load_rows(sO, LDB, v + (size_t)b * L * HD, HD, k0, BK, L, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[3][4], vf[3][4];
  th_load_a48(kf, sQ, LDB, mt * 16, h * TD, lane);
  th_load_a48(vf, sO, LDB, mt * 16, h * TD, lane);
  __syncthreads();

  auto load_q = [&](int q0, int buf) {
    th_load_rows(sQ + buf * TK * LDB, LDB, qb, HD, q0, TK, L, tid);
    th_load_rows(sO + buf * TK * LDB, LDB, ob, HD, q0, TK, L, tid);
    for (int i = tid; i < H * TK; i += TTHREADS) {
      const int hh = i / TK, qg = q0 + i - hh * TK;
      const bool in = qg < L;
      sL[buf * H * TK + i] = in ? lse[((size_t)b * H + hh) * L + qg] : INFINITY;
      sD[buf * H * TK + i] = in ? delta[((size_t)b * H + hh) * L + qg] : 0.f;
    }
  };

  const int r = tid / TPR, u = tid % TPR;       // key row r, query columns
  const bool row_ok = k0 + r < L;
  float dka[6][4], dva[6][4];
#pragma unroll
  for (int n = 0; n < 6; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const int ntiles = (L + TK - 1) / TK;
  load_q(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) load_q((it + 1) * TK, buf ^ 1);
    cp_async_commit();
    {
      float acc[4][4];
      th_mma_nt32(acc, kf, sQ + buf * TK * LDB, LDB, h * TD, lane);
      th_store_tile(sS + (h * BK + mt * 16) * SLD, SLD, acc, lane);
      th_mma_nt32(acc, vf, sO + buf * TK * LDB, LDB, h * TD, lane);
      th_store_tile(sA + (h * BK + mt * 16) * SLD, SLD, acc, lane);
    }
    __syncthreads();
    const float* lt = sL + buf * H * TK;
    const float* dt = sD + buf * H * TK;
    for (int c = u; c < TK; c += TPR) {
      float s[H], pn[H], da[H], dpn[H], mix[H];
#pragma unroll
      for (int j = 0; j < H; ++j) {
        s[j] = sS[(j * BK + r) * SLD + c];
        da[j] = sA[(j * BK + r) * SLD + c];
      }
      th_mix<H>(pn, mpre, s);
#pragma unroll
      for (int i = 0; i < H; ++i)
        pn[i] = row_ok ? expf(pn[i] - lt[i * TK + c]) : 0.f;
      th_mix<H>(mix, mpost, pn);                          // pt
#pragma unroll
      for (int i = 0; i < H; ++i) sP[(i * BK + r) * PLD + c] = __float2bfloat16(mix[i]);
      th_mix_t<H>(dpn, mpost, da);
#pragma unroll
      for (int i = 0; i < H; ++i) pn[i] = pn[i] * (dpn[i] - dt[i * TK + c]);
      th_mix_t<H>(mix, mpre, pn);                         // ds
#pragma unroll
      for (int j = 0; j < H; ++j) sDS[(j * BK + r) * PLD + c] = __float2bfloat16(mix[j]);
    }
    __syncthreads();
    th_mma_nn48(dva, sP + (h * BK + mt * 16) * PLD, PLD, sO + buf * TK * LDB, LDB,
                h * TD, lane);
    th_mma_nn48(dka, sDS + (h * BK + mt * 16) * PLD, PLD, sQ + buf * TK * LDB,
                LDB, h * TD, lane);
    cp_async_wait<0>();
    __syncthreads();
  }
  th_store_band(dk + (size_t)b * L * HD, HD, L, k0 + mt * 16, h * TD, dka, lane);
  th_store_band(dv + (size_t)b * L * HD, HD, L, k0 + mt * 16, h * TD, dva, lane);
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

template <int H>
cudaError_t th_bwd_launch(const bf16* q, const bf16* k, const bf16* v,
                          const bf16* dout, const float* lse,
                          const float* mpre, const float* mpost, float* delta,
                          float* dm, bf16* dq, bf16* dk, bf16* dv, int batch,
                          int L, cudaStream_t st) {
  using G = ThBwd<H>;
  const dim3 grid((L + G::BR - 1) / G::BR, batch);
  cudaError_t err = th_smem_attr(th_bwd_dq_kernel<H>, G::dq_smem);
  if (err == cudaSuccess) err = th_smem_attr(th_bwd_dkv_kernel<H>, G::dkv_smem);
  if (err != cudaSuccess) return err;
  th_bwd_dq_kernel<H><<<grid, TTHREADS, G::dq_smem, st>>>(
      q, k, v, dout, lse, mpre, mpost, delta, dm, dq, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  th_bwd_dkv_kernel<H><<<grid, TTHREADS, G::dkv_smem, st>>>(
      q, k, v, dout, lse, delta, mpre, mpost, dk, dv, L);
  return cudaGetLastError();
}

}  // namespace sav

// Shared memory of the K5a core at length seq (0 for an unbuilt H); the
// wrapper's router reads it (fused_smem).
extern "C" int sav_th_fwd_smem(int seq, int heads) {
  using namespace sav;
  if (heads == 4) return (int)ThFwd<4, true>::smem(seq);
  if (heads == 8) return (int)ThFwd<8, true>::smem(seq);
  return 0;
}

// K6a. q, k, v, attn [B, L, H*48] bf16; mixes [H, H] f32; lse [B, H, L].
extern "C" int sav_th_core_fwd(const void* q, const void* k, const void* v,
                               const float* mpre, const float* mpost,
                               void* attn, float* lse, int batch, int seq,
                               int heads, void* stream) {
  using namespace sav;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16 *qq = (const bf16*)q, *kk = (const bf16*)k, *vv = (const bf16*)v;
  if (heads == 4)
    return (int)th_core_launch<4, false>(qq, kk, vv, mpre, mpost, (bf16*)attn,
                                         lse, batch, seq, st);
  if (heads == 8)
    return (int)th_core_launch<8, false>(qq, kk, vv, mpre, mpost, (bf16*)attn,
                                         lse, batch, seq, st);
  return (int)cudaErrorInvalidValue;
}

// K5a. x [B, L, D]; ln_scale/ln_bias [D] f32; wq/wk/wv [D, H*48], wo
// [H*48, D]; y [B*L, D] and q/k/v/attn [B, L, H*48] scratch; out [B, L, D];
// lse [B, H, L] f32 or null (inference). Needs D % 128 == 0, H*48 % 128
// == 0 and the resident core's shared memory (sav_th_fwd_smem).
extern "C" int sav_th_attention_fwd(
    const void* x, const float* ln_scale, const float* ln_bias,
    const void* wq, const void* wk, const void* wv, const void* wo,
    const float* mpre, const float* mpost, void* y, void* qs, void* ks,
    void* vs, void* attn, void* out, float* lse, int batch, int seq, int dim,
    int heads, int residual, float eps, float q_scale, void* stream) {
  using namespace sav;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = batch * seq, hd = heads * TD;
  const int m_tiles = (M + GM - 1) / GM;
  if (dim % GN || hd % GN || (heads != 4 && heads != 8))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<kQkv>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_kernel<kOut>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GEMM_SMEM);
  if (err != cudaSuccess) return (int)err;

  layernorm_kernel<<<(M + 7) / 8, 256, 0, st>>>(
      (const bf16*)x, ln_scale, ln_bias, (bf16*)y, M, dim, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gemm_kernel<kQkv><<<dim3(3 * hd / GN, m_tiles), 256, GEMM_SMEM, st>>>(
      (const bf16*)y, (const bf16*)wq, (const bf16*)wk, (const bf16*)wv,
      (bf16*)qs, (bf16*)ks, (bf16*)vs, nullptr, M, dim, hd, q_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = heads == 4
      ? th_core_launch<4, true>((const bf16*)qs, (const bf16*)ks,
                                (const bf16*)vs, mpre, mpost, (bf16*)attn, lse,
                                batch, seq, st)
      : th_core_launch<8, true>((const bf16*)qs, (const bf16*)ks,
                                (const bf16*)vs, mpre, mpost, (bf16*)attn, lse,
                                batch, seq, st);
  if (err != cudaSuccess) return (int)err;
  gemm_kernel<kOut><<<dim3(dim / GN, m_tiles), 256, GEMM_SMEM, st>>>(
      (const bf16*)attn, (const bf16*)wo, (const bf16*)wo, (const bf16*)wo,
      (bf16*)out, (bf16*)out, (bf16*)out,
      residual ? (const bf16*)x : nullptr, M, hd, dim, 1.f);
  return (int)cudaGetLastError();
}

// K5b and K6b. q, k, v, do, dq, dk, dv [B, L, H*48] bf16; lse [B, H, L]
// from the forward; delta [B, H, L] f32 scratch; dm [B, ceil(L / (128/H)),
// 2, H, H] f32 partials (dM_pre, dM_post) for the wrapper to sum.
extern "C" int sav_th_core_bwd(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* mpre, const float* mpost,
                               float* delta, float* dm, void* dq, void* dk,
                               void* dv, int batch, int seq, int heads,
                               void* stream) {
  using namespace sav;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16 *qq = (const bf16*)q, *kk = (const bf16*)k, *vv = (const bf16*)v,
             *oo = (const bf16*)dout;
  if (heads == 4)
    return (int)th_bwd_launch<4>(qq, kk, vv, oo, lse, mpre, mpost, delta, dm,
                                 (bf16*)dq, (bf16*)dk, (bf16*)dv, batch, seq, st);
  if (heads == 8)
    return (int)th_bwd_launch<8>(qq, kk, vv, oo, lse, mpre, mpost, delta, dm,
                                 (bf16*)dq, (bf16*)dk, (bf16*)dv, batch, seq, st);
  return (int)cudaErrorInvalidValue;
}
