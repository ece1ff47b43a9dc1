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
// So the design is about the products' rate: all of them run on wgmma
// from TMA-fed shared memory (ff_bwd_sm90.cuh, a persistent warp-
// specialised GEMM), in three launches and two fixed-order sums:
//  (a) GELU: dgact over 128 x 256 tiles of [M, F] with the gelu' epilogue
//      writing dh and h = gelu(hpre) in bf16 and each row tile's f32
//      column sums of dh (the db1 partials, from the f32 dh);
//  (b) DY: dy = dh W1^T;
//  (c) WGRAD: dW1 = y^T dh and dW2 = h^T g in one launch, split over M
//      into chunks (split-K, split_k's rule) so that their 144 tiles at
//      ViT-B fill the card's 132 SMs in rounds; each chunk writes an f32
//      partial;
//  (d) the dW partials, then the db1 partials, summed in a fixed order.
// The TPU kernel walks row blocks in order and adds dW1 and dW2 up in VMEM
// (2 x 9.4 MB of f32); no block of this card holds that, and its blocks
// run in no order, hence the partials. No float atomics anywhere: the
// gradients are the same on every run. dh and h go through device memory
// (2 x 232 MB at bs192); rows past M are zero on load and never stored.
#include "ff_bwd_sm90.cuh"

using namespace sav;
using namespace sav::ffb;

// [rows, width] bf16 as the map of boxes of box_rows x 64 columns.
static int map2d(CUtensorMap* map, const void* base, int rows, int width,
                 int box_rows) {
  return sm90::band_map(map, base, 1, rows, rows, width, box_rows);
}

// The launch plan at M rows on `sms` SMs: out[0] row tiles (128 rows: of
// the GELU and DY tiles, and the db1 partials), [1] 64-deep steps over M, [2] WGRAD
// chunks, [3] steps a chunk, [4..6] units of GELU, DY and WGRAD, [7] dynamic
// shared memory. Returns 0, or cudaErrorInvalidValue for a geometry the
// kernel does not take. Mirrored by ff_bwd_plan in ops/fused_layer.py.
extern "C" int sav_ff_bwd_plan(int m, int dim, int hidden, int sms,
                               int* out) {
  if (m < 1 || dim < BM || hidden < BM || dim % BM || hidden % BM)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.m = m;
  a.dim = dim;
  a.hidden = hidden;
  split_k(m, dim, hidden, sms, &a.chunks, &a.kt_per);
  out[0] = (m + BM - 1) / BM;
  out[1] = (m + BK - 1) / BK;
  out[2] = a.chunks;
  out[3] = a.kt_per;
  out[4] = units_of<GELU>(a);
  out[5] = units_of<DY>(a);
  out[6] = units_of<WGRAD>(a);
  out[7] = Plan::SMEM;
  return 0;
}

// g, y, dy [M, D]; hpre, dh, h [M, F] (dh, h scratch); w1 [D, F]; w2 [F, D]
// bf16. part [chunks, D F + F D] and colsum [ceil(M / 128), F] f32 scratch;
// dw [D F + F D] f32 out (dW1 [D, F], then dW2 [F, D]), db1 [F] f32 out.
// `chunks` is the plan's (sav_ff_bwd_plan on this card). Needs D % 128 ==
// 0 and F % 128 == 0.
extern "C" int sav_ff_bwd(const void* g, const void* hpre, const void* y,
                          const void* w1, const void* w2, void* dh, void* h,
                          void* dy, float* part, float* colsum, float* dw,
                          float* db1, int m, int dim, int hidden, int chunks,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m < 1 || dim < BM || hidden < BM || dim % BM || hidden % BM)
    return (int)cudaErrorInvalidValue;
  const int kt = (m + BK - 1) / BK;
  Args a = {};
  a.m = m;
  a.dim = dim;
  a.hidden = hidden;
  a.chunks = chunks;
  a.kt_per = chunks >= 1 ? (kt + chunks - 1) / chunks : 0;
  if (chunks < 1 || chunks > MAX_CHUNKS
      || (kt + a.kt_per - 1) / a.kt_per != chunks)
    return (int)cudaErrorInvalidValue;     // an empty chunk
  a.hpre = (const bf16*)hpre;
  a.dh = (bf16*)dh;
  a.h = (bf16*)h;
  a.colsum = colsum;
  a.dy = (bf16*)dy;
  a.part = part;

  // K-major maps (A 128-row, B 256-row boxes) for (a), (b); MN-major
  // (64-row boxes) for (c)
  CUtensorMap mg, mw2, mdh, mw1, yn, dhn, hn, gn;
  int err = map2d(&mg, g, m, dim, BM);
  if (!err) err = map2d(&mw2, w2, hidden, dim, BN);
  if (!err) err = map2d(&mdh, dh, m, hidden, BM);
  if (!err) err = map2d(&mw1, w1, dim, hidden, BN);
  if (!err) err = map2d(&yn, y, m, dim, BK);
  if (!err) err = map2d(&dhn, dh, m, hidden, BK);
  if (!err) err = map2d(&hn, h, m, hidden, BK);
  if (!err) err = map2d(&gn, g, m, dim, BK);
  if (err) return err;

  cudaError_t e = launch<GELU>(mg, mw2, mg, mw2, a, st);
  if (e == cudaSuccess) e = launch<DY>(mdh, mw1, mdh, mw1, a, st);
  if (e == cudaSuccess) e = launch<WGRAD>(yn, dhn, hn, gn, a, st);
  const long long planes = 2LL * dim * hidden;
  if (e == cudaSuccess)
    e = ff::sum_launch(part, chunks, planes, (int)planes, dw, st);
  if (e == cudaSuccess)
    e = ff::sum_launch(colsum, (m + BM - 1) / BM, hidden, hidden, db1, st);
  return (int)e;
}
