// K12 and K13 ports: the whole int8 FF forward in one kernel; K14: both
// int8 dx products of its SwitchBack backward (int8_dx_sm90.cuh).
//
// Replaces sav_tpu/ops/int8_ff.py::_ff_kernel (K12, launcher int8_ff_raw)
// and ::_ff_ln_kernel (K13, launcher int8_ff_ln_raw), both with and
// without save_hpre, and ::_ff_dx_kernel (K14, launcher int8_ff_dx_raw,
// below ff_q8_kernel):
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
// M * F bf16 (39 MB at M = 6304) to the bytes.
//
// Design. The hidden row has to be quantised over all F columns, from its
// f32 values, before the second product can use any of it, and the TPU
// kernel keeps it in VMEM. A block here owns a band of BM rows (48, or 16
// where 48 does not fit) and all of D and F, and keeps the band's x codes
// and hidden codes in shared memory (48 x (768 + 64) + 48 x (3072 + 64)
// bytes, 190 KB at ViT-B); the f32 hidden itself (48 x 3072 x 4 = 590 KB)
// does not fit, so the first product runs twice over the same codes in the
// same order:
//  1. the band's x codes (LN first for K13), one warp per row;
//  2. sweep 1: xq W1q with the hpre epilogue and gelu, keeping only each
//     row's running absmax (registers, then across lanes and warps);
//  3. sweep 2: the same products (int32 sums are exact, and the epilogue
//     is the same instructions), now writing bf16 hpre (save_hpre) and the
//     f32 gelu's codes into shared memory;
//  4. hq W2q with the out epilogue (+ x for K13).
// Every product is mma.sync m16n8k32 s8 with the weight codes read
// straight from global memory (L2) into registers, one 64-byte stage
// ahead. 16 warps split the columns. At ViT-B's M = 6304 the 48-row bands
// make 132 blocks: one wave over the H100's 132 SMs. The price of the
// band is that every block reads W1q twice and W2q once (7 MB) through L2.
#include "int8_dx_sm90.cuh"
#include "int8_gemm.cuh"

namespace sav {
namespace q8ff {

using namespace sav::q8;

constexpr int FF_THREADS = 512;
constexpr int FF_WARPS = FF_THREADS / 32;
constexpr int SMEM_LIMIT = 232448;

// jax.nn.gelu(approximate=True) in its own order:
// x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))))
__device__ __forceinline__ float gelu(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f,
                                __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
}

// shared-memory row stride of a band of K codes: K + 64 when K % 128 == 0,
// so rows g and g + 1 of a fragment load fall in other banks
__host__ __device__ __forceinline__ int band_ld(int k) {
  return k % 128 == 0 ? k + 64 : k;
}

__host__ __device__ __forceinline__ int band_smem(int bm, int d, int f) {
  return bm * (band_ld(d) + band_ld(f)) + (2 + FF_WARPS) * bm * 4;
}

// C[BM, N] = A[BM, K] (shared, row stride lda) x B, with B^T [N, K] in
// global memory. Warp w takes the column groups of NT n8 tiles w, w + 16,
// ...; epi(mi, half, r, col, v0, v1) receives each int32 pair (band row r
// = mi * 16 + g + 8 * half, columns col and col + 1).
template <int MT, int NT, typename Epi>
__device__ __forceinline__ void band_gemm(const int8_t* sA, int lda,
                                          const int8_t* __restrict__ bt, int N,
                                          int K, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int n0 = warp * NT * 8; n0 < N; n0 += FF_WARPS * NT * 8) {
    int acc[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0;
    const int8_t* brow[NT];
    uint4 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      brow[j] = bt + (size_t)(n0 + j * 8 + g) * K + 16 * t;
      b[j] = __ldg(reinterpret_cast<const uint4*>(brow[j]));
    }
    for (int k0 = 0; k0 < K; k0 += 64) {
      uint4 nb[NT];
      const bool more = k0 + 64 < K;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        nb[j] = more ? __ldg(reinterpret_cast<const uint4*>(brow[j] + k0 + 64))
                     : b[j];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        uint32_t a[2][4];
        load_a64(a, sA + mi * 16 * lda + k0, lda, lane);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_k64(acc[mi][j], a, b[j]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) b[j] = nb[j];
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + j * 8 + 2 * t;
        epi(mi, 0, mi * 16 + g, col, acc[mi][j][0], acc[mi][j][1]);
        epi(mi, 1, mi * 16 + g + 8, col, acc[mi][j][2], acc[mi][j][3]);
      }
  }
}

struct FFArgs {
  const bf16* x;                  // [M, D]
  const float* ln_scale;          // [D] (K13)
  const float* ln_bias;           // [D] (K13)
  const int8_t* w1t;              // [F, D] codes of W1, transposed
  const float* s1;                // [F]
  const float* b1;                // [F]
  const int8_t* w2t;              // [D, F] codes of W2, transposed
  const float* s2;                // [D]
  const float* b2;                // [D]
  bf16* out;                      // [M, D]
  bf16* hpre;                     // [M, F] or null
  int M, D, F;
  float eps;
};

template <int BM, bool kLN>
__global__ void __launch_bounds__(FF_THREADS, 1)
ff_q8_kernel(const FFArgs p) {
  constexpr int MT = BM / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, F = p.F;
  const int ldx = band_ld(D), ldh = band_ld(F);
  int8_t* xq = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* hq = xq + BM * ldx;
  float* xs = reinterpret_cast<float*>(hq + BM * ldh);
  float* hs = xs + BM;
  float* red = hs + BM;                     // [FF_WARPS][BM]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM;

  // 1. the band's input codes (LN first for K13); rows past M are zeros
  for (int r = warp; r < BM; r += FF_WARPS) {
    const int row = m0 + r;
    int8_t* qr = xq + r * ldx;
    if (row >= p.M) {
      for (int c = 2 * lane; c < D; c += 64)
        *reinterpret_cast<char2*>(qr + c) = make_char2(0, 0);
      if (lane == 0) xs[r] = 0.f;
      continue;
    }
    const bf16* xr = p.x + (size_t)row * D;
    float mu = 0.f, rs = 1.f;
    if (kLN) row_stats(xr, D, p.eps, lane, mu, rs);
    auto value = [&](int c) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xr + c));
      if (!kLN) return v;
      return make_float2(
          ln_value(v.x, mu, rs, p.ln_scale[c], p.ln_bias[c]),
          ln_value(v.y, mu, rs, p.ln_scale[c + 1], p.ln_bias[c + 1]));
    };
    float amax = 0.f;
    for (int c = 2 * lane; c < D; c += 64) {
      const float2 v = value(c);
      amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = row_scale(amax);
    for (int c = 2 * lane; c < D; c += 64) {
      const float2 v = value(c);
      *reinterpret_cast<char2*>(qr + c) = make_char2(
          (signed char)quantize(v.x, s), (signed char)quantize(v.y, s));
    }
    if (lane == 0) xs[r] = s;
  }
  __syncthreads();

  auto hpre_of = [&](int r, int col, int v) {
    return __fadd_rn(dequant(v, xs[r], p.s1[col]), p.b1[col]);
  };

  // 2. sweep 1: each band row's absmax of gelu(hpre) over all F columns
  float amax[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) amax[mi][0] = amax[mi][1] = 0.f;
  band_gemm<MT, 4>(xq, ldx, p.w1t, F, D,
                   [&](int mi, int half, int r, int col, int v0, int v1) {
    amax[mi][half] = fmaxf(amax[mi][half],
                           fmaxf(fabsf(gelu(hpre_of(r, col, v0))),
                                 fabsf(gelu(hpre_of(r, col + 1, v1)))));
  });
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v = amax[mi][half];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t == 0) red[warp * BM + mi * 16 + g + 8 * half] = v;
    }
  __syncthreads();
  for (int r = threadIdx.x; r < BM; r += FF_THREADS) {
    float m = 0.f;
    for (int w = 0; w < FF_WARPS; ++w) m = fmaxf(m, red[w * BM + r]);
    hs[r] = row_scale(m);
  }
  __syncthreads();

  // 3. sweep 2: the same products; bf16 hpre out, f32 gelu's codes kept
  band_gemm<MT, 4>(xq, ldx, p.w1t, F, D,
                   [&](int mi, int half, int r, int col, int v0, int v1) {
    const float h0 = hpre_of(r, col, v0), h1 = hpre_of(r, col + 1, v1);
    const int row = m0 + r;
    if (p.hpre != nullptr && row < p.M)
      *reinterpret_cast<uint32_t*>(p.hpre + (size_t)row * F + col) =
          pack_bf16(h0, h1);
    *reinterpret_cast<char2*>(hq + r * ldh + col) =
        make_char2((signed char)quantize(gelu(h0), hs[r]),
                   (signed char)quantize(gelu(h1), hs[r]));
  });
  __syncthreads();

  // 4. the second product and the output
  band_gemm<MT, 2>(hq, ldh, p.w2t, D, F,
                   [&](int mi, int half, int r, int col, int v0, int v1) {
    const int row = m0 + r;
    if (row >= p.M) return;
    float f0 = __fadd_rn(dequant(v0, hs[r], p.s2[col]), p.b2[col]);
    float f1 = __fadd_rn(dequant(v1, hs[r], p.s2[col + 1]), p.b2[col + 1]);
    const size_t off = (size_t)row * D + col;
    if (kLN) {
      const float2 x2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p.x + off));
      f0 = __fadd_rn(x2.x, f0);
      f1 = __fadd_rn(x2.y, f1);
    }
    *reinterpret_cast<uint32_t*>(p.out + off) = pack_bf16(f0, f1);
  });
}

template <int BM, bool kLN>
int launch(const FFArgs& p, cudaStream_t st) {
  const int smem = band_smem(BM, p.D, p.F);
  cudaError_t err = cudaFuncSetAttribute(
      ff_q8_kernel<BM, kLN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ff_q8_kernel<BM, kLN><<<(p.M + BM - 1) / BM, FF_THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}


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
// and moves ~1.1 GB at ViT-B; K12's 48-row band plan would stream 5.6 GB
// of weight codes from L2 into registers.

}  // namespace q8ff
}  // namespace sav

// Rows per block K12 and K13 take at (D, F): 48, 16, or 0 where even a
// 16-row band does not fit a block's shared memory.
extern "C" int sav_int8_ff_band(int dim, int hidden) {
  using namespace sav::q8ff;
  if (band_smem(48, dim, hidden) <= SMEM_LIMIT) return 48;
  if (band_smem(16, dim, hidden) <= SMEM_LIMIT) return 16;
  return 0;
}

// x [M, D] bf16; ln_scale/ln_bias [D] f32 (ln = 1: K13, out = x + FF(LN(x));
// ln = 0: K12, out = FF(x)); w1t [F, D] int8, s1/b1 [F] f32; w2t [D, F]
// int8, s2/b2 [D] f32; out [M, D] bf16; hpre [M, F] bf16 or null. Needs
// D % 64 == 0, F % 64 == 0 and sav_int8_ff_band(D, F) != 0.
extern "C" int sav_int8_ff(const void* x, const float* ln_scale,
                           const float* ln_bias, const void* w1t,
                           const float* s1, const float* b1, const void* w2t,
                           const float* s2, const float* b2, void* out,
                           void* hpre, int M, int dim, int hidden, int ln,
                           float eps, void* stream) {
  using namespace sav::q8ff;
  FFArgs p = {(const sav::bf16*)x, ln_scale, ln_bias, (const int8_t*)w1t, s1,
              b1, (const int8_t*)w2t, s2, b2, (sav::bf16*)out,
              (sav::bf16*)hpre, M, dim, hidden, eps};
  cudaStream_t st = (cudaStream_t)stream;
  const int bm = sav_int8_ff_band(dim, hidden);
  if (bm == 48) return ln ? launch<48, true>(p, st) : launch<48, false>(p, st);
  if (bm == 16) return ln ? launch<16, true>(p, st) : launch<16, false>(p, st);
  return (int)cudaErrorInvalidValue;
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
  if (m < 1 || dim < 64 || hidden < 64 || dim % 64 || hidden % 64)
    return (int)cudaErrorInvalidValue;
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
// sav_int8_ff_dx_plan's out[9] bytes. Needs D % 64 == 0, F % 64 == 0.
extern "C" int sav_int8_ff_dx(const void* g, const void* hpre, const void* w2c,
                              const float* s2, const void* w1c,
                              const float* s1, void* dy, void* dh, void* ws,
                              int M, int dim, int hidden, void* stream) {
  using namespace sav::q8dx;
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || dim < 64 || hidden < 64 || dim % 64 || hidden % 64)
    return (int)cudaErrorInvalidValue;
  const Workspace lay(M, dim, hidden);
  unsigned char* w = (unsigned char*)ws;
  int8_t* gq = (int8_t*)(w + lay.gq);
  int8_t* dhq = (int8_t*)(w + lay.dhq);
  float* dhs = (float*)(w + lay.dhs);
  Args a = {};
  a.m = M;
  a.dim = dim;
  a.hidden = hidden;
  a.gs = (float*)(w + lay.gs);
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
    dx_scale_kernel<<<(M + 255) / 256, 256, 0, st>>>(a.amax, parts(hidden),
                                                      dhs, M);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) e = launch<CODES>(mg, mw2, mh, mdhq, a, st);
  if (e == cudaSuccess) e = launch<DY>(mdhq, mw1, mdhq, mdhq, a, st);
  return (int)e;
}
