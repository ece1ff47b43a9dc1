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
// The forward core (th_fwd_kernel and its tile helpers) lives in
// th_core.cuh, which K11's int8 span (th_attention_q8.cu) shares.
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
#include "gemm_ln.cuh"
#include "th_core.cuh"

namespace sav {

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
