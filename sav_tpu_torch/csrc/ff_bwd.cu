// K16 port: the backward of the FF sublayer's MLP, LN -> Dense -> gelu ->
// Dense, on flattened rows.
//
// Replaces sav_tpu/ops/fused_layer.py::_ff_bwd_kernel (launch
// _ff_bwd_pallas). Given g [M, D] (the cotangent of the MLP output), hpre
// [M, F] (the saved pre-activation), y [M, D] (the recomputed LN output)
// and W1 [D, F], W2 [F, D], all bf16:
//   dgact = g W2^T (f32); dh = dgact * gelu'(hpre) in f32, rounded to bf16
//   dW2 = gelu(hpre)^T g,  dW1 = y^T dh   (f32, summed over all M rows)
//   dy  = dh W1^T (bf16),  db1 = column sums of the f32 dh
// with the TPU kernel's roundings (h = gelu(hpre) and dh in bf16 before
// their products, f32 accumulation).
//
// Bound on the card: four products of 2 M D F operations each (714 GFLOP
// at ViT-B/16 @224 bs192, M = 37,824, D = 768, F = 3072) against ~435 MB
// of operands: 0.72 ms at the bf16 tensor-core peak, bound by operations.
//
// Design. The TPU kernel walks row blocks in order and adds dW1 and dW2 up
// in VMEM (2 x 9.4 MB of f32). No block of this card holds that, and its
// blocks run in no order, so the work is split at the products instead
// (the shared tiled GEMM of ff_common.cuh, mma.sync):
//  (a) dgact over row tiles with the gelu' epilogue: writes dh and h =
//      gelu(hpre) in bf16, and each row tile's f32 column sums of dh (the
//      db1 partials, summed from the f32 dh before it is rounded);
//  (b) dy = dh W1^T over row tiles;
//  (c) dW1 = y^T dh and dW2 = h^T g, one block per 128 x 128 output tile
//      looping over all M rows (144 tiles each), so no sum crosses blocks;
//  (d) db1: the row tiles' partials summed in a fixed order.
// No float atomics anywhere: the gradients are the same on every run. dh
// and h go through device memory (2 x 232 MB at bs192), which a version
// that keeps dh on chip would save; rows past M are zero on load and never
// stored (no padded copy of the inputs, unlike the TPU launcher).
#include "ff_common.cuh"

// g, y, dy [M, D]; hpre, dh, h [M, F] (dh, h scratch); w1 [D, F]; w2
// [F, D]; dw1 [D, F], dw2 [F, D], db1 [F] f32; colsum [ceil(M / 128), F] f32
// scratch. Needs D % 128 == 0 and F % 128 == 0.
extern "C" int sav_ff_bwd(const void* g, const void* hpre, const void* y,
                          const void* w1, const void* w2, void* dh, void* h,
                          void* dy, float* dw1, float* dw2, float* db1,
                          float* colsum, int m, int dim, int hidden,
                          void* stream) {
  using namespace sav;
  using namespace sav::ff;
  cudaStream_t st = (cudaStream_t)stream;
  if (dim % TN || hidden % TN || m < 1) return (int)cudaErrorInvalidValue;
  const bf16 *G = (const bf16*)g, *HP = (const bf16*)hpre,
             *Y = (const bf16*)y, *W1 = (const bf16*)w1,
             *W2 = (const bf16*)w2;
  bf16 *DH = (bf16*)dh, *H = (bf16*)h;

  GemmArgs a = {};
  a.nbatch = a.per_chunk = 1;
  // (a) dgact[m, f] = sum_d g[m, d] W2[f, d]
  a.A = G; a.B = W2; a.M = m; a.N = hidden; a.Kc = dim;
  a.lda = dim; a.ldb = dim;
  a.cb = DH; a.ldc = hidden; a.hpre = HP; a.h = H; a.colsum = colsum;
  cudaError_t err = gemm_launch<false, true, kGeluBwd>(a, 1, st);
  if (err != cudaSuccess) return (int)err;

  // (b) dy[m, d] = sum_f dh[m, f] W1[d, f]
  GemmArgs b = {};
  b.nbatch = b.per_chunk = 1;
  b.A = DH; b.B = W1; b.M = m; b.N = dim; b.Kc = hidden;
  b.lda = hidden; b.ldb = hidden; b.cb = (bf16*)dy; b.ldc = dim;
  if ((err = gemm_launch<false, true, kBf16>(b, 1, st)) != cudaSuccess)
    return (int)err;

  // (c) dW1[d, f] = sum_m y[m, d] dh[m, f]; dW2[f, d] = sum_m h[m, f] g[m, d]
  GemmArgs c = {};
  c.nbatch = c.per_chunk = 1;
  c.A = Y; c.B = DH; c.M = dim; c.N = hidden; c.Kc = m;
  c.lda = dim; c.ldb = hidden; c.cf = dw1; c.ldc = hidden;
  if ((err = gemm_launch<true, false, kF32>(c, 1, st)) != cudaSuccess)
    return (int)err;
  c.A = H; c.B = G; c.M = hidden; c.N = dim;
  c.lda = hidden; c.ldb = dim; c.cf = dw2; c.ldc = dim;
  if ((err = gemm_launch<true, false, kF32>(c, 1, st)) != cudaSuccess)
    return (int)err;

  // (d) db1 over the row tiles, in order
  return (int)sum_launch(colsum, (m + TM - 1) / TM, hidden, hidden, db1, st);
}
