// Int8 building blocks shared by the int8 ports: K10 (fused_attention_q8.cu),
// K11 (th_attention_q8.cu), K12, K13 and K14 (int8_ff.cu), K15
// (int8_matmul.cu); their GEMMs are the s8 wgmma + TMA kernels of
// q8_gemm_sm90.cuh (K10, K11, K15), int8_ff_sm90.cuh (K12, K13) and
// int8_dx_sm90.cuh (K14).
//
//  * The symmetric quantiser of sav_tpu/ops/int8_matmul_kernel.py::
//    _quantize_tile, in f32: scale = max(absmax, 1e-8) / 127 (an IEEE
//    division), code = clip(round-half-even(v / scale), -127, 127). The
//    division is __fdiv_rn and the rounding rintf, never roundf or a
//    multiply by the reciprocal: either would move codes that sit at .5.
//  * The dequant epilogue acc_f32 * (row_scale * col_scale), the two
//    scales multiplied first, as the TPU kernels bracket it; the int32 sum
//    converts round-to-nearest (__int2float_rn). Every product and sum that
//    the twins round on their own goes through __fmul_rn / __fadd_rn, so
//    nvcc cannot contract it into an FMA that rounds once. quantize_by is
//    the same quantiser by the IEEE reciprocal where that cannot move a
//    code, quantize_exact the same by the reciprocal and an FMA
//    correction.
//  * quantize_rows_kernel (quantize_row): one warp per row, optionally
//    LayerNorm first (f32 statistics, fast variance), per-row codes and
//    scale.
//  * quantize_block: K15's per-(row, 256-wide k-block) codes.
#pragma once

#include "mma.cuh"

namespace sav {
namespace q8 {

__device__ __forceinline__ float row_scale(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-8f), 127.f);
}

__device__ __forceinline__ int quantize(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return (int)fminf(fmaxf(r, -127.f), 127.f);
}

// quantize(v, scale), with inv = __frcp_rn(scale): v * inv rounds to
// within 3 * 2^-24 |v / scale| (< 2.3e-5 for |v / scale| <= 128, as every
// code of a row is) of the IEEE quotient, so unless it lies within 1e-4 of
// a half-integer its rint is the quotient's; there the division decides.
// The same codes, fewer instructions.
__device__ __forceinline__ int quantize_by(float v, float scale, float inv) {
  const float q = __fmul_rn(v, inv);
  const float r = rintf(q);
  if (fabsf(fabsf(__fsub_rn(q, r)) - 0.5f) < 1e-4f) return quantize(v, scale);
  return (int)fminf(fmaxf(r, -127.f), 127.f);
}

// quantize(v, scale) without a division: q0 = v * inv with inv =
// __frcp_rn(scale) (the correctly rounded reciprocal), the residual v - q0
// scale by one FMA (exact: q0 is within an ulp of the quotient), then q0 +
// residual * inv rounded once, which is the correctly rounded quotient
// (Markstein's correction); so the codes are quantize's at .5 ties too.
// Branch-free, where quantize_by's test for ties sends bf16 values, whose
// quotients sit on ties often, to the division. sav_q8_quantizer_check
// (int8_matmul.cu) holds it against quantize for every bf16 value against
// every bf16 row absmax (tests/test_torch_cuda.py, chip_smoke.py).
__device__ __forceinline__ int quantize_exact(float v, float scale,
                                              float inv) {
  const float q0 = __fmul_rn(v, inv);
  const float r = __fmaf_rn(-q0, scale, v);
  const float q = __fmaf_rn(r, inv, q0);
  return (int)fminf(fmaxf(rintf(q), -127.f), 127.f);
}

__device__ __forceinline__ float dequant(int acc, float rs, float cs) {
  return __fmul_rn(__int2float_rn(acc), __fmul_rn(rs, cs));
}

// ---------------------------------------------------------- LayerNorm rows

// mu and 1/sqrt(var + eps) of a row of K bf16 values, by one warp (f32
// sums, fast variance E[x^2] - mu^2 clamped at 0, as flax's LayerNorm).
// Needs K % 2 == 0 and a 4-byte aligned row.
__device__ __forceinline__ void row_stats(const bf16* xr, int K, float eps,
                                          int lane, float& mu, float& rs) {
  float s = 0.f, ss = 0.f;
  for (int c = 2 * lane; c < K; c += 64) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(xr + c));
    s = __fadd_rn(__fadd_rn(s, v.x), v.y);
    ss = __fadd_rn(__fadd_rn(ss, __fmul_rn(v.x, v.x)), __fmul_rn(v.y, v.y));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  mu = __fdiv_rn(s, (float)K);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(ss, (float)K), __fmul_rn(mu, mu)),
                          0.f);
  rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// ((a - mu) * rs) * scale + bias, rounded where the TPU kernels round
__device__ __forceinline__ float ln_value(float a, float mu, float rs,
                                          float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(a, mu), rs), scale), bias);
}

// Per-row codes of y = LN(x) (kLN) or y = x over K values: q [M, K] int8,
// scale [M] f32. One warp per row, 8 rows per 256-thread block. Needs
// K % 2 == 0.
// The row held in registers where K <= 64 * ROW_PAIRS (every ViT width up
// to 1024): each lane loads its pairs once, all loads in flight together,
// and the statistics, absmax and codes come from the registers in the
// order of the loop below (the same sums); the codes by quantize_by (the
// same codes: an f32 LN value's quotient seldom lies near a tie, where
// the division still decides), whose IEEE division a value bounded the
// launch by instructions.
constexpr int ROW_PAIRS = 16;

template <bool kLN>
__device__ __forceinline__ void quantize_row_cached(
    const bf16* __restrict__ xr, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, float eps, int8_t* __restrict__ qr,
    float* __restrict__ scale, int row, int K, int lane) {
  float2 v[ROW_PAIRS];
#pragma unroll
  for (int i = 0; i < ROW_PAIRS; ++i) {
    const int c = 2 * lane + 64 * i;
    v[i] = c < K ? __bfloat1622float2(
                       *reinterpret_cast<const __nv_bfloat162*>(xr + c))
                 : make_float2(0.f, 0.f);
  }
  if (kLN) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < ROW_PAIRS; ++i)
      if (2 * lane + 64 * i < K) {
        s = __fadd_rn(__fadd_rn(s, v[i].x), v[i].y);
        ss = __fadd_rn(__fadd_rn(ss, __fmul_rn(v[i].x, v[i].x)),
                       __fmul_rn(v[i].y, v[i].y));
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    const float mu = __fdiv_rn(s, (float)K);
    const float var = fmaxf(
        __fsub_rn(__fdiv_rn(ss, (float)K), __fmul_rn(mu, mu)), 0.f);
    const float rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
    for (int i = 0; i < ROW_PAIRS; ++i) {
      const int c = 2 * lane + 64 * i;
      if (c < K)
        v[i] = make_float2(ln_value(v[i].x, mu, rs, ln_scale[c], ln_bias[c]),
                           ln_value(v[i].y, mu, rs, ln_scale[c + 1],
                                    ln_bias[c + 1]));
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < ROW_PAIRS; ++i)
    if (2 * lane + 64 * i < K)
      amax = fmaxf(amax, fmaxf(fabsf(v[i].x), fabsf(v[i].y)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = row_scale(amax), inv = __frcp_rn(s);
#pragma unroll
  for (int i = 0; i < ROW_PAIRS; ++i) {
    const int c = 2 * lane + 64 * i;
    if (c < K) {
      char2 out;
      out.x = (signed char)quantize_by(v[i].x, s, inv);
      out.y = (signed char)quantize_by(v[i].y, s, inv);
      *reinterpret_cast<char2*>(qr + c) = out;
    }
  }
  if (lane == 0) scale[row] = s;
}

template <bool kLN>
__device__ __forceinline__ void quantize_row(const bf16* __restrict__ x,
                                             const float* __restrict__ ln_scale,
                                             const float* __restrict__ ln_bias,
                                             float eps, int8_t* __restrict__ q,
                                             float* __restrict__ scale,
                                             int row, int K, int lane) {
  const bf16* xr = x + (size_t)row * K;
  if (K <= 64 * ROW_PAIRS) {
    quantize_row_cached<kLN>(xr, ln_scale, ln_bias, eps, q + (size_t)row * K,
                             scale, row, K, lane);
    return;
  }
  float mu = 0.f, rs = 1.f;
  if (kLN) row_stats(xr, K, eps, lane, mu, rs);
  auto value = [&](int c) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(xr + c));
    if (!kLN) return v;
    return make_float2(ln_value(v.x, mu, rs, ln_scale[c], ln_bias[c]),
                       ln_value(v.y, mu, rs, ln_scale[c + 1], ln_bias[c + 1]));
  };
  float amax = 0.f;
  for (int c = 2 * lane; c < K; c += 64) {
    const float2 v = value(c);
    amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = row_scale(amax);
  int8_t* qr = q + (size_t)row * K;
  for (int c = 2 * lane; c < K; c += 64) {
    const float2 v = value(c);
    char2 out;
    out.x = (signed char)quantize(v.x, s);
    out.y = (signed char)quantize(v.y, s);
    *reinterpret_cast<char2*>(qr + c) = out;
  }
  if (lane == 0) scale[row] = s;
}

template <bool kLN>
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const bf16* __restrict__ x,
                     const float* __restrict__ ln_scale,
                     const float* __restrict__ ln_bias, float eps,
                     int8_t* __restrict__ q, float* __restrict__ scale, int M,
                     int K) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  quantize_row<kLN>(x, ln_scale, ln_bias, eps, q, scale, row, K,
                    threadIdx.x & 31);
}

// K15's activation codes, one warp's share: item w = (row, pair of 256-wide
// k-blocks) of a [M, K] bf16 -> q [M, ld] int8 (rows ld bytes apart, ld >=
// K a multiple of 16; zeros past K) and scale [M, KB] f32, one scale per
// (row, k-block), the block's values taken to f32 first; a half-warp a
// k-block, two 16-byte loads and one 16-byte store a lane where K % 8 ==
// 0, the codes by quantize_exact. Any K. Launched from q8g::codes_kernel
// (q8_gemm_sm90.cuh), one warp an item, k-blocks fastest, with no loop,
// so every warp's loads are in flight at once.
constexpr int QBLOCK = 256;

__device__ __forceinline__ void quantize_block(const bf16* __restrict__ a,
                                               int8_t* __restrict__ q,
                                               float* __restrict__ scale,
                                               int K, int KB, int ld, int w,
                                               int lane) {
  const int pairs = (KB + 1) / 2;
  const int row = w / pairs, kb = 2 * (w % pairs) + (lane >> 4);
  const bf16* ar = a + (size_t)row * K;
  const int c0 = kb * QBLOCK + (lane & 15) * 16;
  float v[16];
  if (K % 8 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 raw = make_uint4(0, 0, 0, 0);  // zeros past K (and past KB)
      if (c0 + 8 * h < K)
        raw = *reinterpret_cast<const uint4*>(ar + c0 + 8 * h);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        v[8 * h + 2 * j] = f.x;
        v[8 * h + 2 * j + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = c0 + j < K ? __bfloat162float(ar[c0 + j]) : 0.f;
  }
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) amax = fmaxf(amax, fabsf(v[j]));
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)    // the half-warp of the k-block
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = row_scale(amax), inv = __frcp_rn(s);
  uint4 packed;
  signed char* b = reinterpret_cast<signed char*>(&packed);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    b[j] = (signed char)quantize_exact(v[j], s, inv);
  if (kb < KB && c0 < ld)
    *reinterpret_cast<uint4*>(q + (size_t)row * ld + c0) = packed;
  if (kb < KB && (lane & 15) == 0) scale[(size_t)row * KB + kb] = s;
}

}  // namespace q8
}  // namespace sav
