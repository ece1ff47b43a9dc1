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
// head_ch 48 is taken as it is: q k^T is three 16-deep steps of wgmma
// m64n16k16 a head and P V one m64n48k16, so nothing is padded to 64.
//
// The two-sweep core (th_fwd_sm90.cuh) is K6a's kernel, K5a's core launch
// and, in its Q8 form, K11's core (th_attention_q8.cu).
//
// What is new against flash attention (csrc/flash_fwd_sm90.cuh):
//  * The mixes couple all heads: one mixed logit takes the logits of all H
//    heads at the same (query, key). So one work tile owns EVERY head of
//    its 64 query rows: a mix warpgroup holds all H heads of its positions
//    in registers (H^2 FMAs per mix, the [H, H] weights in the constant
//    bank) and hands the mixed, bf16-rounded tiles to an accumulate
//    warpgroup's tensor cores.
//  * No single-pass online softmax: the post-mix sums NORMALIZED
//    probabilities of different heads, so each mixed head's lse must be
//    known before any of them is mixed again. The core (th_fwd_sm90.cuh,
//    wgmma + TMA): 64 query rows x 16-key tiles; a first sweep over the
//    keys computes the lse of each mixed head (online max and sum per mixed
//    head), a second recomputes the logits and forms pn = exp(st - lse),
//    the post-mix and P V. Any L; it pays one more q k^T sweep (~1.5x the
//    forward's tensor work, small beside the mixes). Its mixes run in
//    registers with the weights in the constant bank. It is also K5a's
//    core: one pass over whole logit rows resident in shared memory
//    measured 2.2x slower at L = 196, from
//    per-block K/V re-reads, shared-memory mixes and one 8-warp block an
//    SM.
//  * K5a is four launches: the LN and the projection GEMMs of
//    proj_sm90.cuh (the QKV GEMM with q scaled in its epilogue, the out
//    GEMM without the residual: CaiT adds LayerScale and stochastic depth
//    before the skip connection; K1's launches too) around the core.
//
// At H = 16 (cait_m) the core accumulates its heads in two groups of 8
// (th_fwd_sm90.cuh's header says why and what it costs); at H = 6 (cait_xs)
// its band is 4.5 boxes of 64 columns, read as 5 (the same header).
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
#include "proj_sm90.cuh"
#include "th_fwd_sm90.cuh"

// Dynamic shared memory of the K6a kernel, also K5a's core, at H heads (0
// for an unbuilt H); mirrored by th_fwd_plan in ops/th_attention.py, which
// the K5a router decides on.
extern "C" int sav_th_core_fwd_smem(int heads) {
  using namespace sav::thf;
  if (heads == 4) return Plan<4>::SMEM;
  if (heads == 6) return Plan<6>::SMEM;
  if (heads == 8) return Plan<8>::SMEM;
  if (heads == 16) return Plan<16>::SMEM;
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
  if (heads == 6)
    return sav::thf::run<6>(q, k, v, mix, attn, lse, batch, seq, st);
  if (heads == 8)
    return sav::thf::run<8>(q, k, v, mix, attn, lse, batch, seq, st);
  if (heads == 16)
    return sav::thf::run<16>(q, k, v, mix, attn, lse, batch, seq, st);
  return (int)cudaErrorInvalidValue;
}

// K5a. x [B, L, D]; ln_scale/ln_bias [D] f32; wq/wk/wv [D, H*48], wo
// [H*48, D]; mix [3, H, H] f32 as for K6a; y [B*L, D] and q/k/v/attn [B,
// L, H*48] scratch; out [B, L, D]; lse [B, H, L] f32 or null (inference).
// Needs D and H*48 to be multiples of 32 (proj::takes_ragged: cait_xxs's
// 192 is one whole 192-wide tile, cait_xs's 288 ends in a ragged tile and
// a ragged 64-deep step) and H = 4, 6, 8 or 16.
extern "C" int sav_th_attention_fwd(
    const void* x, const float* ln_scale, const float* ln_bias,
    const void* wq, const void* wk, const void* wv, const void* wo,
    const float* mix, void* y, void* qs, void* ks, void* vs, void* attn,
    void* out, float* lse, int batch, int seq, int dim, int heads,
    int residual, float eps, float q_scale, void* stream) {
  using namespace sav;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = batch * seq, hd = heads * thb::TD;
  if (!proj::takes_ragged(hd, dim) || !proj::takes_ragged(dim, hd)
      || (heads != 4 && heads != 6 && heads != 8 && heads != 16))
    return (int)cudaErrorInvalidValue;
  int err = (int)layernorm(x, ln_scale, ln_bias, y, M, dim, eps, st);
  if (err != 0) return err;
  const void* wqkv[3] = {wq, wk, wv};
  void* qkv[3] = {qs, ks, vs};
  err = proj::run<proj::QKV>(y, wqkv, qkv, nullptr, M, dim, hd, 3, q_scale,
                             st);
  if (err != 0) return err;
  err = heads == 4 ? thf::run<4>(qs, ks, vs, mix, attn, lse, batch, seq, st)
        : heads == 6 ? thf::run<6>(qs, ks, vs, mix, attn, lse, batch, seq, st)
        : heads == 8 ? thf::run<8>(qs, ks, vs, mix, attn, lse, batch, seq, st)
        : thf::run<16>(qs, ks, vs, mix, attn, lse, batch, seq, st);
  if (err != 0) return err;
  const void* wout[3] = {wo, nullptr, nullptr};
  void* outs[3] = {out, nullptr, nullptr};
  return proj::run<proj::OUT>(attn, wout, outs, residual ? x : nullptr, M, hd,
                              dim, 1, 1.f, st);
}
