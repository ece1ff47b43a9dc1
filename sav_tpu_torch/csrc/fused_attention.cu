// K1 port: the whole attention sublayer forward, pre-LN or post-LN.
//
// Replaces sav_tpu/ops/fused_layer.py::_fused_fwd_kernel (launcher
// _fused_fwd), all its variants: inference (save_residuals=False; lse
// null) and training (save_residuals=True: the q, k, v and attn scratch
// below are kept by the caller as the backward's residuals, and the
// attention launch also writes the lse of each row and head); each with or
// without the residual (TNT's outer sublayer adds the pre-bridge stream
// itself) and with or without the LayerNorm (pre_ln=False: CeiT's post-LN
// blocks, whose attention reads the raw block input):
//   out = [x +] (softmax_h(q_h k_h^T) v_h)_h @ Wo,
//   q = y Wq / sqrt(d), k = y Wk, v = y Wv,  y = LN(x) or x,
// LN with f32 statistics (fast variance E[x^2] - mu^2), bf16 operands,
// f32 accumulation, rounded to bf16 where the TPU kernel rounds.
//
// Bound on the card: at ViT-B (D = 768, H = 12, d = 64) the four products
// are ~2*L*D*(4*D) + 4*L*L*D operations per image against ~4*L*D bytes of
// activations, so the sublayer is bound by tensor-core operations (about
// 34 us at B = 32, L = 197 at the bf16 peak). The two projection GEMMs
// carry 88% of them.
//
// Decomposition: four launches per call (three without the LN), all
// hand-written, all but the LN on wgmma + TMA.
//  1. layernorm_kernel (proj_sm90.cuh): one warp per row, y = LN(x) in
//     bf16. Skipped when pre_ln is 0: the QKV GEMM reads x as its A.
//  2. proj_gemm_kernel<QKV> (proj_sm90.cuh): y @ [Wq | Wk | Wv], q scaled
//     by 1/sqrt(d) in the epilogue. Writes q, k, v [B*L, H*d] bf16.
//  3. k4::flash_fwd_kernel (flash_fwd_sm90.cuh, K4's kernel: wgmma, TMA,
//     persistent), writing lse when the caller keeps residuals.
//  4. proj_gemm_kernel<OUT>: attn @ Wo, with +x in the epilogue when
//     residual is not 0.
// The TPU kernel runs one program per image with x and all four weights
// resident in its VMEM. That does not carry over: one image's x at L = 197
// is 303 KB and each weight 1.18 MB, beyond a block's 227 KB of shared
// memory, and the out projection sums over heads, so a grid over heads
// would need a cross-block sum. Splitting at the GEMM boundaries gives each
// launch its natural grid and keeps every sum inside one block; the price
// is writing y, q, k, v and attn (5 x B*L*D bf16) through L2/HBM, ~48 MB
// at B = 32, L = 197, about 15 us at 3.35 TB/s, under the operation bound
// of the products. LN gets its own pass so that both GEMMs are plain bf16
// GEMMs whose tiles TMA streams in unchanged.
#include "flash_fwd_sm90.cuh"
#include "proj_sm90.cuh"

// x [B, L, D]; ln_scale/ln_bias [D] f32; wq/wk/wv [D, H*64], wo [H*64, D];
// y [B*L, D] and qs/ks/vs/attn [B*L, H*64] scratch; out [B, L, D]; lse
// [B, H, L] f32 or null (inference); residual 0 leaves +x out; pre_ln 0
// leaves the LN out (ln_scale, ln_bias and y are not read and may be
// null). All bf16 unless noted. Needs D and H*64 to be widths the GEMM
// tiles (proj::takes: multiples of 128, or of 192 such as D = 192).
extern "C" int sav_fused_attention_fwd(
    const void* x, const float* ln_scale, const float* ln_bias,
    const void* wq, const void* wk, const void* wv, const void* wo, void* y,
    void* qs, void* ks, void* vs, void* attn, void* out, float* lse,
    int batch, int seq, int dim, int heads, int residual, int pre_ln,
    float eps, float q_scale, void* stream) {
  using namespace sav;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = batch * seq, hd = heads * k4::BD;
  if (!proj::takes(dim, hd) || !proj::takes(hd, dim))
    return (int)cudaErrorInvalidValue;
  if (pre_ln) {
    const cudaError_t err = layernorm(x, ln_scale, ln_bias, y, M, dim, eps,
                                      st);
    if (err != cudaSuccess) return (int)err;
  }
  const void* wqkv[3] = {wq, wk, wv};
  void* qkv[3] = {qs, ks, vs};
  int e = proj::run<proj::QKV>(pre_ln ? y : x, wqkv, qkv, nullptr, M, dim,
                               hd, 3, q_scale, st);
  if (e != 0) return e;
  const int att = k4::flash_fwd(qs, ks, vs, attn, lse, batch, seq, seq, seq,
                                heads, st);
  if (att != 0) return att;
  const void* wout[3] = {wo, nullptr, nullptr};
  void* outs[3] = {out, nullptr, nullptr};
  return proj::run<proj::OUT>(attn, wout, outs, residual ? x : nullptr, M, hd,
                              dim, 1, 1.f, st);
}

// The projection GEMM's plan for an M x (parts x n_each) product on this
// card: out[0] the tile width, out[1] its dynamic shared memory,
// out[2] its units; mirrored by proj_plan in ops/fused_layer.py.
extern "C" void sav_proj_plan(int m, int n_each, int parts, int sms,
                              int* out) {
  using namespace sav::proj;
  const int bn = plan_bn(m, n_each, parts, sms);
  out[0] = bn;
  out[1] = smem_of(bn);
  out[2] = bn ? units_of(m, n_each, parts, bn) : 0;
}
