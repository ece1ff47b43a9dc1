// K11 port: CaiT's talking-heads attention span for serving, with int8
// q/k/v/out projections.
//
// Replaces sav_tpu/ops/th_attention.py::_th_q8_kernel (launcher
// th_attention_sublayer_q8):
//   y = LN(x) in f32 (fast variance), never rounded to bf16, quantised per
//     row over D (one set of codes feeds q, k and v);
//   q = bf16((f32(yq Wq) * (ys * sq)) * (1 / sqrt(48))), k, v = bf16(f32(yq
//     W) * (ys * s)), int32 sums, per-column f32 weight scales;
//   the talking-heads core of K5a: per-head f32 logits, the pre-mix, a
//     softmax of whole rows (p / sum p), the post-mix, bf16(pt) v -> bf16
//     bands of 48;
//   out = bf16(f32(aq Wo) * (as * so)) (+ x with residual), the bands'
//     codes taken per row over H*48.
// Serving only, as in the JAX package: there is no backward, and the
// wrapper raises under autograd.
//
// The TPU kernel pads each head to 64 lanes and quantises the padded
// weights; the padded columns and rows are zero, so they change no absmax,
// no code and no int32 sum. Here the heads stay 48 wide.
//
// Bound on the card: at CaiT-S/24 @224, B = 32, L = 196, D = 384, H = 8 the
// four projections are 7.4 G int8 operations (0.004 ms at 1979 TOPS), the
// core 1.9 G bf16 FLOP (0.002 ms) and 0.3 G f32 operations of the mixes
// (0.005 ms at 67 TFLOP/s), against ~10 MB of x, out and weight codes
// (0.003 ms): bound by operations, ~0.010 ms.
//
// Decomposition: five launches, all hand-written, K10's plan with K5a's
// core (fused_attention_q8.cu; th_core.cuh):
//  1. quantize_rows_kernel<LN>: y codes and scales, one warp per row.
//  2. gemm_s8_kernel<kQkv>: yq @ [Wq | Wk | Wv], q scaled in the epilogue;
//     each output has its own 128-column tiles, so H*48 = 192 (cait_xxs)
//     is taken as it is.
//  3. th_fwd_kernel<H, true>: K5a's core, the logits of whole kv rows
//     resident in shared memory, so every row is normalised against its
//     final max and sum as in the TPU kernel. Where those rows do not fit
//     (L > 224 at H = 8, L > 256 at H = 4, still inside the JAX package's
//     th_supported) K6a's two-sweep core th_fwd_kernel<H, false> runs
//     instead: p = exp(st - lse), the same function rounded once more.
//  4. quantize_rows_kernel: the bands' codes per row over H*48.
//  5. gemm_s8_kernel<kOut>: aq @ Wo with the dequant epilogue (+ x).
// The weight codes are [N][K] (transposed) for the s8 mma's B operand.
#include "int8_gemm.cuh"
#include "th_core.cuh"

namespace sav {

template <int H>
cudaError_t th_q8_core(const bf16* q, const bf16* k, const bf16* v,
                       const float* mpre, const float* mpost, bf16* attn,
                       int batch, int L, cudaStream_t st) {
  if (ThFwd<H, true>::smem(L) <= (size_t)TSMEM_LIMIT)
    return th_core_launch<H, true>(q, k, v, mpre, mpost, attn, nullptr, batch,
                                   L, st);
  return th_core_launch<H, false>(q, k, v, mpre, mpost, attn, nullptr, batch,
                                  L, st);
}

}  // namespace sav

// x [B, L, D] bf16; ln_scale/ln_bias [D] f32; wqt/wkt/wvt [H*48, D] and wot
// [D, H*48] int8 codes with column scales sq/sk/sv [H*48] and so [D] f32;
// mixes [H, H] f32; scratch yq [B*L, D] int8, ys [B*L] f32, qs/ks/vs/attn
// [B*L, H*48] bf16, aq [B*L, H*48] int8, as [B*L] f32; out [B, L, D] bf16;
// residual 1 adds x. Needs H in {4, 8} and D % 64 == 0.
extern "C" int sav_th_attention_q8(
    const void* x, const float* ln_scale, const float* ln_bias,
    const void* wqt, const void* wkt, const void* wvt, const void* wot,
    const float* sq, const float* sk, const float* sv, const float* so,
    const float* mpre, const float* mpost, void* yq, float* ys, void* qs,
    void* ks, void* vs, void* attn, void* aq, float* as, void* out, int batch,
    int seq, int dim, int heads, int residual, float eps, float q_scale,
    void* stream) {
  using sav::bf16;
  namespace q8 = sav::q8;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = batch * seq, hd = heads * sav::TD;
  const int m_tiles = (M + q8::TM - 1) / q8::TM;
  if (dim % q8::TK || (heads != 4 && heads != 8))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      q8::gemm_s8_kernel<q8::kQkv>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, q8::GEMM_S8_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(q8::gemm_s8_kernel<q8::kOut>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               q8::GEMM_S8_SMEM);
  if (err != cudaSuccess) return (int)err;

  q8::quantize_rows_kernel<true><<<(M + 7) / 8, 256, 0, st>>>(
      (const bf16*)x, ln_scale, ln_bias, eps, (int8_t*)yq, ys, M, dim);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  q8::GemmS8Args p = {};
  p.a = (const int8_t*)yq;
  p.bt[0] = (const int8_t*)wqt;
  p.bt[1] = (const int8_t*)wkt;
  p.bt[2] = (const int8_t*)wvt;
  p.row_scale = ys;
  p.col_scale[0] = sq;
  p.col_scale[1] = sk;
  p.col_scale[2] = sv;
  p.out[0] = (bf16*)qs;
  p.out[1] = (bf16*)ks;
  p.out[2] = (bf16*)vs;
  p.resid = nullptr;
  p.M = M;
  p.n_each = hd;
  p.K = dim;
  p.q_scale = q_scale;
  q8::gemm_s8_kernel<q8::kQkv>
      <<<dim3(q8::gemm_s8_tiles<q8::kQkv>(hd), m_tiles), 256,
         q8::GEMM_S8_SMEM, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = heads == 4
      ? sav::th_q8_core<4>((const bf16*)qs, (const bf16*)ks, (const bf16*)vs,
                           mpre, mpost, (bf16*)attn, batch, seq, st)
      : sav::th_q8_core<8>((const bf16*)qs, (const bf16*)ks, (const bf16*)vs,
                           mpre, mpost, (bf16*)attn, batch, seq, st);
  if (err != cudaSuccess) return (int)err;

  q8::quantize_rows_kernel<false><<<(M + 7) / 8, 256, 0, st>>>(
      (const bf16*)attn, nullptr, nullptr, 0.f, (int8_t*)aq, as, M, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  q8::GemmS8Args o = {};
  o.a = (const int8_t*)aq;
  o.bt[0] = o.bt[1] = o.bt[2] = (const int8_t*)wot;
  o.row_scale = as;
  o.col_scale[0] = o.col_scale[1] = o.col_scale[2] = so;
  o.out[0] = o.out[1] = o.out[2] = (bf16*)out;
  o.resid = residual ? (const bf16*)x : nullptr;
  o.M = M;
  o.n_each = dim;
  o.K = hd;
  o.q_scale = 1.f;
  q8::gemm_s8_kernel<q8::kOut>
      <<<dim3(q8::gemm_s8_tiles<q8::kOut>(dim), m_tiles), 256,
         q8::GEMM_S8_SMEM, st>>>(o);
  return (int)cudaGetLastError();
}
