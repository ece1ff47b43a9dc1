// K12 and K13 ports: the whole int8 FF forward (int8_ff_sm90.cuh); K14:
// both int8 dx products of its SwitchBack backward (int8_dx_sm90.cuh).
//
// Replaces sav_tpu/ops/int8_ff.py::_ff_kernel (K12, launcher int8_ff_raw)
// and ::_ff_ln_kernel (K13, launcher int8_ff_ln_raw), both with and
// without save_hpre, and ::_ff_dx_kernel (K14, launcher int8_ff_dx_raw):
//   K12: out = bf16(f32(hq W2q) * (hs * s2) + b2),
//   K13: out = bf16(x + the same), the FF fed LN(x) instead of x,
// where hpre = f32(xq W1q) * (xs * s1) + b1 (xq, xs: x's or LN(x)'s codes
// per row over D), hq, hs: the codes per row over all F columns of the f32
// gelu(hpre) (tanh form), and save_hpre also writes hpre in bf16 [M, F] for
// the backward. LN is f32 with the fast variance, eps as given.
//
// Bound on the card: ViT-B's FF at B = 32 (M = 6304, D = 768, F = 3072)
// is 59.5 G int8 operations, 0.030 ms at 1979 TOPS, against 24 MB of x,
// out and weight codes (0.007 ms): bound by operations. save_hpre adds
// M * F bf16 (39 MB at M = 6304) to the bytes; at ViT-B bs192 (M =
// 37,824) it is 357 G operations (0.180 ms) against 353 MB (0.105 ms).
// The design does 1.5 times the operations (the first product twice).
//
// Design. The hidden row has to be quantised over all F columns, from its
// f32 values, before the second product can use any of it, and the TPU
// kernel keeps it in VMEM. The f32 hidden of even 128 rows (1.5 MB at
// ViT-B) does not fit a block, so the first product runs twice over the
// same codes, as in K14 (int8_sm90.cuh). Six launches:
//  1. W1's and W2's codes transposed to the K-major B operands
//     (transpose_codes_kernel);
//  2. x's codes and row scales (LN first for K13), one warp a row
//     (q8::quantize_rows_kernel, the kernels' shared quantiser);
//  3. ABSMAX (HPRE under save_hpre): xq W1q over 128 x 128 tiles with the
//     hpre epilogue and gelu, each (row, tile)'s absmax partial (and bf16
//     hpre through the staging tile by TMA);
//  4. the rows' scales hs from the partials (q8w::row_scale_kernel);
//  5. CODES: the same products and epilogue, the codes of the f32 gelu
//     through the staging tile by TMA;
//  6. OUT: hq W2q over 128 x 128 tiles, dequant + b2 (+ x for K13).
// Every product is s8 wgmma m64n128k32 on TMA-fed rings, in persistent
// blocks of two teams (int8_ff_sm90.cuh). Rows past M read as zeros and are
// never stored. Any M >= 1, D and F multiples of 32 (at least 64): a
// ragged last tile of D or F (cait_xs's D = 288: the 128-wide OUT tiles
// take 2.25, so 3, the last 32 columns wide; the 64-deep slots over D
// 4.5, so 5) reads zeros past its edge from the tensor maps' extent and
// stores nothing past it (TMA stores clip; the pointer epilogues stop at
// N and load no scale or bias past it).
#include "int8_dx_sm90.cuh"
#include "int8_ff_sm90.cuh"

// ------------------------------------------------------------------ K14
//
// K14 computes, per row of the output cotangent g [M, D] and the stored
// bf16 pre-activation hpre [M, F]:
//   dgact = f32(gq W2q^T) * (gs * s2), gq, gs: g's codes per row over D,
//     W2q [F, D] W2's codes per IN row (per F) with scales s2 [F];
//   dh    = gelu'(hpre) * dgact in f32 (jax.vjp(jax.nn.gelu)'s order),
//     written in bf16 [M, F];
//   dy    = bf16(f32(dhq W1q^T) * (dhs * s1)), dhq, dhs: the codes of the
//     f32 dh per row over all F, W1q [D, F] W1's codes per IN row (per D).
// Codes per IN row are already the [N][K] layout s8 wgmma reads, so no
// transpose is made. dh's row absmax needs all F columns of an f32 value
// too large to keep, so the first product runs twice over the same codes
// (int32 sums are exact): once for dh and the absmax partials, once for
// dh's codes. Five launches (int8_dx_sm90.cuh): g's codes (one warp a row,
// the shared quantiser), ABSMAX, dh's row scales, CODES, DY. Rows past M
// read no hpre and store nothing.
//
// Bound on the card: ViT-B/16 @224 bs192 (M = 37,824, D = 768, F = 3072):
// 357 G int8 operations (0.180 ms at 1979 TOPS) against 586 MB of g,
// hpre, dh, dy and codes (0.175 ms): bound by operations. CaiT-S/24 bs128
// (M = 25,088, D = 384, F = 1536): 59 G (0.030 ms) against 194 MB (0.058
// ms), bound by bytes. The design does 536 G (the first product twice)
// and moves ~1.1 GB at ViT-B.

namespace {

// D and F multiples of 32 (cait_xs: 288 and 1152): the codes' rows stay
// 16-byte aligned for TMA, whole words of four codes for the transpose,
// and whole 8-column groups in the epilogues.
bool bad_geometry(int m, int dim, int hidden) {
  return m < 1 || dim < 64 || hidden < 64 || dim % 32 || hidden % 32;
}

}  // namespace

// K12's and K13's launch plan at (M, D, F): out[0] row tiles (128 rows),
// [1] column tiles of F (ABSMAX, CODES) and [2] of D (OUT, 128 columns
// each), [3] units of ABSMAX and of CODES, [4] units of OUT, [5] 64-deep
// stages of the first product and [6] 128-deep stages of the second, [7]
// absmax partials a row, [8] dynamic shared memory, [9] workspace bytes,
// [10] 1 where OUT runs in pair units (ceil(D / 128) even), else 0, [11]
// the 64 x 64 tiles of each weight's codes transpose (W1's [D, F] and
// W2's [F, D] take as many). Returns 0, or cudaErrorInvalidValue for a
// geometry the kernels do not take. Mirrored by int8_ff_plan in
// ops/int8_ff.py.
extern "C" int sav_int8_ff_plan(int m, int dim, int hidden, long long* out) {
  using namespace sav::q8ff;
  if (bad_geometry(m, dim, hidden)) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.m = m;
  a.dim = dim;
  a.hidden = hidden;
  out[0] = (m + BM - 1) / BM;
  out[1] = col_tiles(hidden);
  out[2] = col_tiles(dim);
  out[3] = units_of<ABSMAX>(a);
  out[4] = units_of<OUT>(a);
  out[5] = stages_of<ABSMAX>(a);
  out[6] = stages_of<OUT>(a);
  out[7] = parts(hidden);
  out[8] = Plan::SMEM;
  out[9] = (long long)FFWorkspace(m, dim, hidden).total;
  out[10] = col_tiles(dim) % 2 == 0;
  out[11] = transpose_tiles(dim, hidden);
  return 0;
}

// K12 and K13. x [M, D] bf16; ln_scale/ln_bias [D] f32 (ln = 1: K13,
// out = x + FF(LN(x)); ln = 0: K12, out = FF(x)); w1 [D, F] int8 (W1's
// codes per column), s1/b1 [F] f32; w2 [F, D] int8, s2/b2 [D] f32; out
// [M, D] bf16; hpre [M, F] bf16 or null; ws the workspace of
// sav_int8_ff_plan's out[9] bytes. Needs D % 32 == 0, F % 32 == 0.
extern "C" int sav_int8_ff(const void* x, const float* ln_scale,
                           const float* ln_bias, const void* w1,
                           const float* s1, const float* b1, const void* w2,
                           const float* s2, const float* b2, void* out,
                           void* hpre, void* ws, int M, int dim, int hidden,
                           int ln, float eps, void* stream) {
  using namespace sav::q8ff;
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_geometry(M, dim, hidden)) return (int)cudaErrorInvalidValue;
  const FFWorkspace lay(M, dim, hidden);
  unsigned char* w = (unsigned char*)ws;
  int8_t* w1t = (int8_t*)(w + lay.w1t);
  int8_t* w2t = (int8_t*)(w + lay.w2t);
  int8_t* xq = (int8_t*)(w + lay.aq);
  int8_t* hq = (int8_t*)(w + lay.hq);
  float* xs = (float*)(w + lay.ascale);
  float* hs = (float*)(w + lay.hs);
  Args a = {};
  a.m = M;
  a.dim = dim;
  a.hidden = hidden;
  a.xs = xs;
  a.s1 = s1;
  a.b1 = b1;
  a.amax = (float*)(w + lay.amax);
  a.hs = hs;
  a.s2 = s2;
  a.b2 = b2;
  a.x = (const sav::bf16*)x;
  a.out = (sav::bf16*)out;

  // the first product's operands: boxes of 128 rows x 64 codes; OUT's and
  // the hidden codes out of the staging tile: 128 x 128; hpre: 128 x 64
  // bf16
  CUtensorMap mx, mw1, mhq, mw2, mh;
  int err = codes_map(&mx, xq, M, dim, 64);
  if (!err) err = codes_map(&mw1, w1t, hidden, dim, 64);
  if (!err) err = codes_map(&mhq, hq, M, hidden, 128);
  if (!err) err = codes_map(&mw2, w2t, dim, hidden, 128);
  if (!err && hpre != nullptr)
    err = sav::sm90::band_map(&mh, hpre, 1, M, M, hidden, BM);
  if (err) return err;

  transpose_codes_kernel<<<dim3(transpose_tiles(dim, hidden), 2), 256, 0,
                           st>>>(
      (const int8_t*)w1, (const int8_t*)w2, dim, hidden, w1t, w2t);
  if (ln)
    sav::q8::quantize_rows_kernel<true><<<(M + 7) / 8, 256, 0, st>>>(
        (const sav::bf16*)x, ln_scale, ln_bias, eps, xq, xs, M, dim);
  else
    sav::q8::quantize_rows_kernel<false><<<(M + 7) / 8, 256, 0, st>>>(
        (const sav::bf16*)x, nullptr, nullptr, 0.f, xq, xs, M, dim);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess)
    e = hpre != nullptr ? launch<HPRE>(mx, mw1, mh, a, st)
                        : launch<ABSMAX>(mx, mw1, mx, a, st);
  if (e == cudaSuccess) {
    row_scale_kernel<<<(M + 255) / 256, 256, 0, st>>>(a.amax, parts(hidden),
                                                      hs, M);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) e = launch<CODES>(mx, mw1, mhq, a, st);
  if (e == cudaSuccess)
    e = ln ? launch_out<OUT_RES>(mhq, mw2, a, st)
           : launch_out<OUT>(mhq, mw2, a, st);
  return (int)e;
}

// K14's launch plan at (M, D, F): out[0] row tiles (128 rows), [1] column
// tiles of F (ABSMAX, CODES) and [2] of D (DY, 128 columns each), [3]
// units of ABSMAX and of CODES, [4] units of DY, [5] 64-deep stages of the
// first product and [6] 128-deep stages of the second, [7] absmax partials a row, [8]
// dynamic shared memory, [9] workspace bytes. Returns 0, or
// cudaErrorInvalidValue for a geometry the kernels do not take. Mirrored
// by int8_dx_plan in ops/int8_ff.py.
extern "C" int sav_int8_ff_dx_plan(int m, int dim, int hidden,
                                   long long* out) {
  using namespace sav::q8dx;
  if (bad_geometry(m, dim, hidden)) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.m = m;
  a.dim = dim;
  a.hidden = hidden;
  out[0] = (m + BM - 1) / BM;
  out[1] = col_tiles(hidden);
  out[2] = col_tiles(dim);
  out[3] = units_of<ABSMAX>(a);
  out[4] = units_of<DY>(a);
  out[5] = stages_of<ABSMAX>(a);
  out[6] = stages_of<DY>(a);
  out[7] = parts(hidden);
  out[8] = Plan::SMEM;
  out[9] = (long long)Workspace(m, dim, hidden).total;
  return 0;
}

// K14. g [M, D] bf16; hpre [M, F] bf16; w2c [F, D] int8 with s2 [F] f32
// (W2's codes per F row); w1c [D, F] int8 with s1 [D] f32 (W1's codes per
// D row); dy [M, D] bf16; dh [M, F] bf16; ws the workspace of
// sav_int8_ff_dx_plan's out[9] bytes. Needs D % 32 == 0, F % 32 == 0.
extern "C" int sav_int8_ff_dx(const void* g, const void* hpre, const void* w2c,
                              const float* s2, const void* w1c,
                              const float* s1, void* dy, void* dh, void* ws,
                              int M, int dim, int hidden, void* stream) {
  using namespace sav::q8dx;
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_geometry(M, dim, hidden)) return (int)cudaErrorInvalidValue;
  const Workspace lay(M, dim, hidden);
  unsigned char* w = (unsigned char*)ws;
  int8_t* gq = (int8_t*)(w + lay.aq);
  int8_t* dhq = (int8_t*)(w + lay.hq);
  float* dhs = (float*)(w + lay.hs);
  Args a = {};
  a.m = M;
  a.dim = dim;
  a.hidden = hidden;
  a.gs = (float*)(w + lay.ascale);
  a.s2 = s2;
  a.s1 = s1;
  a.amax = (float*)(w + lay.amax);
  a.dhs = dhs;
  a.dy = (sav::bf16*)dy;

  // the first product's operands: boxes of 128 rows x 64 codes; DY's and
  // dh's codes out of the staging tile: 128 x 128; hpre and dh: 128 x 64
  // bf16
  CUtensorMap mg, mw2, mdhq, mw1, mh, mdh;
  int err = codes_map(&mg, gq, M, dim, 64);
  if (!err) err = codes_map(&mw2, w2c, hidden, dim, 64);
  if (!err) err = codes_map(&mdhq, dhq, M, hidden, 128);
  if (!err) err = codes_map(&mw1, w1c, dim, hidden, 128);
  if (!err) err = sav::sm90::band_map(&mh, hpre, 1, M, M, hidden, BM);
  if (!err) err = sav::sm90::band_map(&mdh, dh, 1, M, M, hidden, BM);
  if (err) return err;

  sav::q8::quantize_rows_kernel<false><<<(M + 7) / 8, 256, 0, st>>>(
      (const sav::bf16*)g, nullptr, nullptr, 0.f, gq, (float*)a.gs, M, dim);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = launch<ABSMAX>(mg, mw2, mh, mdh, a, st);
  if (e == cudaSuccess) {
    row_scale_kernel<<<(M + 255) / 256, 256, 0, st>>>(a.amax, parts(hidden),
                                                      dhs, M);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) e = launch<CODES>(mg, mw2, mh, mdhq, a, st);
  if (e == cudaSuccess) e = launch<DY>(mdhq, mw1, mdhq, mdhq, a, st);
  return (int)e;
}
