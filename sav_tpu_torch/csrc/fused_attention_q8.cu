// K10 port: the pre-LN attention sublayer's serving forward with int8
// q/k/v/out projections.
//
// Replaces sav_tpu/ops/fused_layer.py::_fused_infer_q8_kernel (launcher
// attention_sublayer_q8):
//   y = LN(x) in f32 (fast variance), quantised per row over D (one set of
//     codes feeds q, k and v);
//   q = bf16((f32(yq Wq) * (ys * sq)) / sqrt(d)), k, v = bf16(f32(yq W) *
//     (ys * s)), int32 sums, per-column f32 weight scales;
//   attn_h = bf16(softmax(q_h k_h^T) v_h): f32 logits, max, exp and sum, p
//     rounded to bf16 for the PV product, divided by the sum at the end;
//   out = bf16(x + f32(aq Wo) * (as * so)), with the heads' bf16 bands
//     quantised per row over H*d.
// Serving only: there is no backward (the JAX package differentiates
// nothing through it either), and the wrapper raises under autograd.
//
// Bound on the card: at ViT-B, B = 32, L = 197 the four projections are
// 29.7 G int8 operations (0.015 ms at 1979 TOPS) and the attention core
// 3.8 G bf16 FLOP (0.004 ms at 989 TFLOP/s), against ~20 MB of x, out and
// the weight codes: bound by operations, ~0.019 ms.
//
// Decomposition: five launches, all hand-written, on K1's plan
// (fused_attention.cu: one image's x and the weights do not fit a block's
// shared memory, and the out projection sums over heads):
//  1. quantize_rows_kernel<LN>: y codes and scales, one warp per row.
//  2. gemm_s8_kernel<kQkv>: yq @ [Wq | Wk | Wv] with the dequant epilogue.
//  3. attention_fwd_exact_kernel (attention_core.cuh), per (64-query
//     tile, head, image), with a first sweep over the keys for each row's
//     final max:
//     p = exp(s - max) is rounded to bf16 against the same max as in the
//     TPU kernel (an online softmax would round it against a running max,
//     and requantising the bands would turn those roundings into other
//     codes), and the sum divides at the end.
//  4. quantize_rows_kernel: the bands' codes per row over H*d.
//  5. gemm_s8_kernel<kOut>: aq @ Wo with the dequant epilogue and + x.
// The weight codes are [N][K] (transposed) for the s8 mma's B operand.
#include "attention_core.cuh"
#include "int8_gemm.cuh"

// x [B, L, D] bf16; ln_scale/ln_bias [D] f32; wqt/wkt/wvt [H*64, D] and
// wot [D, H*64] int8 with column scales sq/sk/sv [H*64], so [D] f32;
// scratch yq [B*L, D] int8, ys [B*L] f32, qs/ks/vs/attn [B*L, H*64] bf16,
// aq [B*L, H*64] int8, as [B*L] f32; out [B, L, D] bf16; residual 0 leaves
// +x out. Needs D % 128 == 0 and H*64 % 128 == 0.
extern "C" int sav_fused_attention_q8(
    const void* x, const float* ln_scale, const float* ln_bias,
    const void* wqt, const void* wkt, const void* wvt, const void* wot,
    const float* sq, const float* sk, const float* sv, const float* so,
    void* yq, float* ys, void* qs, void* ks, void* vs, void* attn, void* aq,
    float* as, void* out, int batch, int seq, int dim, int heads,
    int residual, float eps, float q_scale, void* stream) {
  using namespace sav;
  using namespace sav::q8;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = batch * seq, hd = heads * ATT_D;
  const int m_tiles = (M + TM - 1) / TM;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_s8_kernel<kQkv>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GEMM_S8_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_s8_kernel<kOut>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GEMM_S8_SMEM);
  if (err != cudaSuccess) return (int)err;

  quantize_rows_kernel<true><<<(M + 7) / 8, 256, 0, st>>>(
      (const bf16*)x, ln_scale, ln_bias, eps, (int8_t*)yq, ys, M, dim);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  GemmS8Args p = {};
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
  gemm_s8_kernel<kQkv><<<dim3(gemm_s8_tiles<kQkv>(hd), m_tiles), 256,
                         GEMM_S8_SMEM, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  attention_fwd_exact_kernel
      <<<dim3((seq + ATT_BQ - 1) / ATT_BQ, heads, batch), 128, 0, st>>>(
          (const bf16*)qs, (const bf16*)ks, (const bf16*)vs, (bf16*)attn,
          seq, seq, seq, hd, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  quantize_rows_kernel<false><<<(M + 7) / 8, 256, 0, st>>>(
      (const bf16*)attn, nullptr, nullptr, 0.f, (int8_t*)aq, as, M, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  GemmS8Args o = {};
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
  gemm_s8_kernel<kOut><<<dim3(gemm_s8_tiles<kOut>(dim), m_tiles), 256,
                         GEMM_S8_SMEM, st>>>(o);
  return (int)cudaGetLastError();
}
