// K4 port: blockwise online-softmax attention forward.
//
// Replaces sav_tpu/ops/flash_attention.py::_fwd_kernel (launcher _fwd).
// Same function: q, k, v as [B, L, H*64] bf16 head bands with q
// pre-scaled, out in the input layout and dtype, lse [B, H, Lq] f32, keys
// past kv_len masked to -inf.
//
// Bound on the card: at ViT shapes (L = 197..577, d = 64) the work is
// 4*L*L*d operations against 8*L*d bytes per (image, head), about 25-72
// operations per byte, under the H100's ~295 bf16 operations per byte, so
// a kernel that streams q, k, v once is bound by bytes; in practice the
// softmax (exp, max, sum on the CUDA cores) and the warp-level mma.sync
// instruction rate bound it first. The design keeps the logits and the
// probabilities in registers (never in shared or device memory), reads
// each q tile once and each k/v tile once per q tile, streams the next
// k/v tile in with cp.async while the current one is used, and needs no
// cross-block reduction: one block owns one (q tile, head, image). The
// TPU version's single-kv-block fast path is not needed: the online carry
// of one tile costs one rescale of the accumulator.
#include "attention_core.cuh"

extern "C" int sav_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, float* lse, int batch, int q_len,
                             int kv_rows, int kv_len, int heads,
                             void* stream) {
  using namespace sav;
  const int stride = heads * ATT_D;
  dim3 grid((q_len + ATT_BQ - 1) / ATT_BQ, heads, batch);
  attention_fwd_kernel<false><<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, lse,
      q_len, kv_rows, kv_len, heads, stride, stride);
  return (int)cudaGetLastError();
}
