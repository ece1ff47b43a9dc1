// K1 port: the whole pre-LN attention sublayer forward.
//
// Replaces sav_tpu/ops/fused_layer.py::_fused_fwd_kernel (launcher
// _fused_fwd), both variants: inference (save_residuals=False; lse null)
// and training (save_residuals=True: the q, k, v and attn scratch below
// are kept by the caller as the backward's residuals, and the attention
// launch also writes the lse of each row and head); each with or without
// the residual (TNT's outer sublayer adds the pre-bridge stream itself):
//   out = [x +] (softmax_h(q_h k_h^T) v_h)_h @ Wo,
//   q = LN(x) Wq / sqrt(d), k = LN(x) Wk, v = LN(x) Wv,
// LN with f32 statistics (fast variance E[x^2] - mu^2), bf16 operands,
// f32 accumulation, rounded to bf16 where the TPU kernel rounds.
//
// Bound on the card: at ViT-B (D = 768, H = 12, d = 64) the four products
// are ~2*L*D*(4*D) + 4*L*L*D operations per image against ~4*L*D bytes of
// activations, so the sublayer is bound by tensor-core operations (about
// 34 us at B = 32, L = 197 at the bf16 peak). The two projection GEMMs
// carry 88% of them.
//
// Decomposition: four launches per call, all hand-written (LN and the GEMMs
// on mma.sync, the attention on wgmma).
//  1. layernorm_kernel: one warp per row, y = LN(x) in bf16.
//  2. gemm_kernel<kQkv>: y @ [Wq | Wk | Wv], q scaled by 1/sqrt(d) in the
//     epilogue. Writes q, k, v [B*L, H*d] bf16.
//  3. k4::flash_fwd_kernel (flash_fwd_sm90.cuh, K4's kernel: wgmma, TMA,
//     persistent), writing lse when the caller keeps residuals.
//  4. gemm_kernel<kOut>: attn @ Wo, with +x in the epilogue when residual
//     is not 0.
// The TPU kernel runs one program per image with x and all four weights
// resident in its VMEM. That does not carry over: one image's x at L = 197
// is 303 KB and each weight 1.18 MB, beyond a block's 227 KB of shared
// memory, and the out projection sums over heads, so a grid over heads
// would need a cross-block sum. Splitting at the GEMM boundaries gives each
// launch its natural grid and keeps every sum inside one block; the price
// is writing y, q, k, v and attn (5 x B*L*D bf16) through L2/HBM, ~48 MB
// at B = 32, L = 197, about 15 us at 3.35 TB/s, under the operation bound
// of the products. LN gets its own pass so that both GEMMs are plain bf16
// GEMMs whose tiles stream in with cp.async through a 3-stage ring: the
// operation bound is met only if the tensor cores never wait on loads.
#include "flash_fwd_sm90.cuh"
#include "gemm_ln.cuh"

// x [B, L, D]; ln_scale/ln_bias [D] f32; wq/wk/wv [D, H*64], wo [H*64, D];
// y [B*L, D] and qs/ks/vs/attn [B*L, H*64] scratch; out [B, L, D]; lse
// [B, H, L] f32 or null (inference); residual 0 leaves +x out. All bf16
// unless noted. Needs D % 128 == 0 and H*64 % 128 == 0 (whole GEMM
// tiles along N and K).
extern "C" int sav_fused_attention_fwd(
    const void* x, const float* ln_scale, const float* ln_bias,
    const void* wq, const void* wk, const void* wv, const void* wo, void* y,
    void* qs, void* ks, void* vs, void* attn, void* out, float* lse,
    int batch, int seq, int dim, int heads, int residual, float eps,
    float q_scale, void* stream) {
  using namespace sav;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = batch * seq, hd = heads * k4::BD;
  const int m_tiles = (M + GM - 1) / GM;
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
  const int att = k4::flash_fwd(qs, ks, vs, attn, lse, batch, seq, seq, seq,
                                heads, st);
  if (att != 0) return att;
  gemm_kernel<kOut><<<dim3(dim / GN, m_tiles), 256, GEMM_SMEM, st>>>(
      (const bf16*)attn, (const bf16*)wo, (const bf16*)wo, (const bf16*)wo,
      (bf16*)out, (bf16*)out, (bf16*)out, residual ? (const bf16*)x : nullptr,
      M, hd, dim, 1.f);
  return (int)cudaGetLastError();
}
