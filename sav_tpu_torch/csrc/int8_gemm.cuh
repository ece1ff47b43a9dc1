// Int8 building blocks shared by the int8 ports: K10 (fused_attention_q8.cu),
// K11 (th_attention_q8.cu), K12, K13 and K14 (int8_ff.cu), K15
// (int8_matmul.cu).
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
//  * mma.sync m16n8k32 s8 x s8 -> s32 on fragments loaded under a fixed
//    permutation of each 64-byte slice of the contraction axis: thread
//    (g, t) = (lane / 4, lane % 4) reads bytes [16t, 16t + 16) of A rows g
//    and g + 8 and of B^T row g (two 16-byte loads per 16 x 64 A tile, one
//    per 8 x 64 B tile) and feeds bytes 16t..16t+7 to the first k32 step
//    and 16t+8..16t+15 to the second. A and B see the same permutation,
//    and int32 sums are exact in any order, so the product is the plain
//    one. B is stored transposed ([N][K], k contiguous), as s8 mma reads it.
//  * quantize_rows_kernel (quantize_row): one warp per row, optionally
//    LayerNorm first (f32 statistics, fast variance), per-row codes and
//    scale.
//  * quantize_block: K15's per-(row, 256-wide k-block) codes.
//  * gemm_s8_kernel: a 128 x 128 output tile per block over 64-byte
//    contraction stages in a 4-deep cp.async ring, 8 warps of 64 x 32,
//    with the epilogues of K10's projections.
// Rows past M and columns past N load as zeros and are never stored.
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

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The two A fragments (k32 steps) of a 16 x 64 int8 tile at s (row stride
// ld bytes), under the permutation above.
__device__ __forceinline__ void load_a64(uint32_t (&a)[2][4], const int8_t* s,
                                         int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint4 lo = *reinterpret_cast<const uint4*>(s + g * ld + 16 * t);
  const uint4 hi = *reinterpret_cast<const uint4*>(s + (g + 8) * ld + 16 * t);
  a[0][0] = lo.x; a[0][1] = hi.x; a[0][2] = lo.y; a[0][3] = hi.y;
  a[1][0] = lo.z; a[1][1] = hi.z; a[1][2] = lo.w; a[1][3] = hi.w;
}

// acc += A(16 x 64) B(64 x 8), b = this thread's 16 bytes of B^T row g.
__device__ __forceinline__ void mma_k64(int* acc, const uint32_t (&a)[2][4],
                                        const uint4& b) {
  mma_s8(acc, a[0], b.x, b.y);
  mma_s8(acc, a[1], b.z, b.w);
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
template <bool kLN>
__device__ __forceinline__ void quantize_row(const bf16* __restrict__ x,
                                             const float* __restrict__ ln_scale,
                                             const float* __restrict__ ln_bias,
                                             float eps, int8_t* __restrict__ q,
                                             float* __restrict__ scale,
                                             int row, int K, int lane) {
  const bf16* xr = x + (size_t)row * K;
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

// ------------------------------------------------------------- tiled GEMM

constexpr int TM = 128, TN = 128, TK = 64, TSTAGES = 4;
constexpr int GEMM_S8_SMEM = TSTAGES * (TM + TN) * TK;   // 65,536 bytes

enum Epilogue {
  kQkv,     // three outputs side by side: q (x q_scale), k, v
  kOut,     // one output, + resid (f32 add) when resid is not null
};

struct GemmS8Args {
  const int8_t* a;            // [M, K] codes
  const int8_t* bt[3];        // [n_each, K] codes (B transposed)
  const float* row_scale;     // [M]
  const float* col_scale[3];  // [n_each]
  bf16* out[3];               // [M, n_each]
  const bf16* resid;          // kOut: [M, n_each] or null
  int M, n_each, K;           // K % 64 == 0
  float q_scale;
};

// grid (gemm_s8_tiles<kEpi>(n_each), ceil(M / 128)): for kQkv each of the
// three outputs has its own ceil(n_each / 128) column tiles, so n_each need
// only be even.
template <Epilogue kEpi>
__host__ __device__ __forceinline__ int gemm_s8_tiles(int n_each) {
  return (kEpi == kQkv ? 3 : 1) * ((n_each + TN - 1) / TN);
}

template <Epilogue kEpi>
__global__ void __launch_bounds__(256)
gemm_s8_kernel(const GemmS8Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sA = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* sB = sA + TSTAGES * TM * TK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * TM;
  const int tiles = (p.n_each + TN - 1) / TN;
  const int which = kEpi == kQkv ? blockIdx.x / tiles : 0;
  const int n0 = (blockIdx.x - which * tiles) * TN;
  const int8_t* B = p.bt[which];
  const int K = p.K, M = p.M, N = p.n_each;
  const int k_tiles = K / TK;

  auto load_stage = [&](int kt, int stage) {
    const int k0 = kt * TK;
    int8_t* a = sA + stage * TM * TK;
    int8_t* b = sB + stage * TN * TK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * 256;
      const int r = i >> 2, c = (i & 3) * 16;
      const bool in_a = m0 + r < M, in_b = n0 + r < N;
      cp_async_16(&a[r * TK + c],
                  p.a + (size_t)(in_a ? m0 + r : 0) * K + k0 + c,
                  in_a ? 16 : 0);
      cp_async_16(&b[r * TK + c], B + (size_t)(in_b ? n0 + r : 0) * K + k0 + c,
                  in_b ? 16 : 0);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<TSTAGES - 2>();
    __syncthreads();
    if (kt + TSTAGES - 1 < k_tiles)
      load_stage(kt + TSTAGES - 1, (kt + TSTAGES - 1) % TSTAGES);
    cp_async_commit();
    const int8_t* a = sA + (kt % TSTAGES) * TM * TK;
    const int8_t* b = sB + (kt % TSTAGES) * TN * TK;
    uint4 bf[4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      bf[ni] = *reinterpret_cast<const uint4*>(
          b + (wn * 32 + ni * 8 + g) * TK + 16 * t);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      uint32_t af[2][4];
      load_a64(af, a + (wm * 64 + mi * 16) * TK, TK, lane);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_k64(acc[mi][ni], af, bf[ni]);
    }
  }
  cp_async_wait<0>();

  bf16* C = p.out[which];
  const float* cs = p.col_scale[which];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (row >= M) continue;
        const float rs = p.row_scale[row];
        float v0 = dequant(acc[mi][ni][2 * half], rs, cs[col]);
        float v1 = dequant(acc[mi][ni][2 * half + 1], rs, cs[col + 1]);
        const size_t off = (size_t)row * N + col;
        if (kEpi == kQkv && which == 0) {
          v0 = __fmul_rn(v0, p.q_scale);
          v1 = __fmul_rn(v1, p.q_scale);
        }
        if (kEpi == kOut && p.resid != nullptr) {
          const float2 x2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p.resid + off));
          v0 = __fadd_rn(x2.x, v0);
          v1 = __fadd_rn(x2.y, v1);
        }
        *reinterpret_cast<uint32_t*>(C + off) = pack_bf16(v0, v1);
      }
    }
  }
}

}  // namespace q8
}  // namespace sav
