// K5a and K6a ports: CaiT's talking-heads attention forward; the backward
// (K5b, K6b) is th_bwd.cu.
//
// Replaces sav_tpu/ops/th_attention.py::_th_fwd_kernel (K5a) and
// ::_th_blk_fwd_kernel (K6a). Same function, on [B, L, H*48] bf16 head
// bands (q pre-scaled by 1/sqrt(48)) and f32 [H, H] mixes M_pre, M_post:
//   s_j  = q_j k_j^T                       (f32)
//   st_i = sum_j M_pre[j, i] s_j           (pre-softmax head mix)
//   pn_i = softmax(st_i)                   (exact, over the true length)
//   pt_i = sum_j M_post[j, i] pn_j         (post-softmax head mix)
//   o_i  = bf16(pt_i) v_i,  lse_i = logsumexp(st_i)
// rounded to bf16 where the TPU kernels round, with f32 accumulation.
// head_ch 48 is taken as it is: q k^T is three 16-deep k-steps of mma.sync
// m16n8k16 and P V six 8-wide n-tiles, so nothing is padded to 64.
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
//      K6a (th_fwd_sm90.cuh, wgmma + TMA): 64 query rows x 16-key tiles;
//        a first sweep over the keys computes the lse of each mixed head
//        (online max and sum per mixed head), a second recomputes the
//        logits and forms pn = exp(st - lse), the post-mix and P V. Any L;
//        it pays one more q k^T sweep (~1.5x the forward's tensor work).
//        Its mixes run in registers (th_fwd_sm90.cuh's header); K11 keeps
//        the mma.sync two-sweep core of th_core.cuh (th_fwd_kernel<H,
//        false>) where K5a's rows do not fit.
//  * K5a is four launches, the first two and the last shared with K1
//    (gemm_ln.cuh): LN, the QKV GEMM with q scaled in its epilogue, the
//    resident core, and the out GEMM without the residual (CaiT adds
//    LayerScale and stochastic depth before the skip connection).
//
// Bound on the card: per (image, head, query, key) the forward does 192
// tensor-core operations (q k^T and P V at d = 48) and 4H scalar
// operations for the two mixes. At H = 8 the mixes are 32 CUDA-core FMAs
// per position, against 989 TFLOP/s of bf16 tensor cores and 67 TFLOP/s of
// f32 FMA: the mixes, not the products, bound these kernels, which is why
// the TPU kernel ran them as VMEM adds.
//
// No silent row drops: query rows past L load as zeros and are never
// stored; keys past L load as zeros and their mixed logits are set to -inf
// AFTER the pre-mix (a mix of -inf logits with signed weights would be
// NaN), so their probabilities are exact zeros. Nothing is padded.
#include "gemm_ln.cuh"
#include "th_core.cuh"
#include "th_fwd_sm90.cuh"

// Shared memory of the K5a core at length seq (0 for an unbuilt H); the
// wrapper's router reads it (fused_smem).
extern "C" int sav_th_fwd_smem(int seq, int heads) {
  using namespace sav;
  if (heads == 4) return (int)ThFwd<4, true>::smem(seq);
  if (heads == 8) return (int)ThFwd<8, true>::smem(seq);
  return 0;
}

// Dynamic shared memory of the K6a kernel at H heads (0 for an unbuilt
// H); mirrored by th_fwd_plan in ops/th_attention.py.
extern "C" int sav_th_core_fwd_smem(int heads) {
  using namespace sav::thf;
  if (heads == 4) return Plan<4>::SMEM;
  if (heads == 8) return Plan<8>::SMEM;
  return 0;
}

// K6a. q, k, v, attn [B, L, H*48] bf16; mix [3, H, H] f32 (M_pre, M_pre *
// log2 e, M_post); lse [B, H, L] f32.
extern "C" int sav_th_core_fwd(const void* q, const void* k, const void* v,
                               const float* mix, void* attn, float* lse,
                               int batch, int seq, int heads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (heads == 4)
    return sav::thf::run<4>(q, k, v, mix, attn, lse, batch, seq, st);
  if (heads == 8)
    return sav::thf::run<8>(q, k, v, mix, attn, lse, batch, seq, st);
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
