// K7 port: one whole TNT inner layer, forward (K7a) and backward (K7b), on
// the model's own [B*P, 16, D] layout.
//
// Replaces sav_tpu/ops/tnt_inner.py::_fwd_kernel (K7a, launcher _forward)
// and ::_bwd_kernel (K7b, launcher _inner_bwd). Per patch of 16 pixel
// tokens, with x [16, D] bf16, H heads of hd = D / H, FF width F:
//   y  = bf16(LN1(x))                     (f32 statistics, fast variance)
//   q  = (y Wq) / sqrt(hd), k = y Wk, v = y Wv        all f32
//   o  = softmax(q_h k_h^T) v_h per head              f32, scalar FMAs
//   x2 = x + bf16(o) Wo                               f32, not rounded
//   hp = bf16(LN2(x2)) W1 + b1,  gact = gelu(hp)      f32 (tanh form)
//   out = bf16(x2 + bf16(gact) W2 + b2)
// rounding where the TPU kernel rounds; weights bf16, LN parameters and
// biases f32. K7b recomputes all of it from x (the only saved residual)
// and returns dx (bf16) and the 12 parameter gradients (f32).
//
// Bound on the card: at TNT-S (D = 24, F = 96, H = 4) a patch is 16 x 24
// bf16 in and out (1.5 KB) against 0.22 MFLOP of products and 25 kFLOP of
// f32 attention; at B*P = 32 x 196 that is 2.9 us of device-memory bytes
// and 3.7 us of operations (1.4 us of bf16 products at the tensor-core
// peak, 2.3 us of f32 attention at the CUDA-core peak), so the layer is
// bound by operations, at a few microseconds. The products' operand
// widths (24-160) are far below a wgmma tile and the attention below any
// tensor-core shape, so issue and latency, not either roofline, set the
// kernels' times.
//
// Design:
//  * One warp owns one patch: its 16 rows are exactly one m16 tile of
//    mma.sync m16n8k16, so every product of the layer (QKV, Wo, W1, W2 and
//    their transposes in the backward) is a warp-local row of tiles whose
//    A operand sits in the warp's shared memory. The weights sit once per
//    block in shared memory, zero-padded from D to Dp = 16-multiple (24 ->
//    32, 40 -> 48) along every axis that is a contraction or a 16-wide
//    fragment, so padded channels contribute exact zeros and are never
//    stored. Blocks are persistent: a warp walks patches w, w + warps in
//    the grid, ..., so the weights are loaded once per block and the last
//    patch needs no padding (patches past B*P are never touched).
//  * The kernels are instantiated for TNT-S's and TNT-B's inner widths
//    (constant loop bounds and index arithmetic) and once with the widths
//    read at run time, for any other shape supported() takes.
//  * The attention is 16 x 16 x hd per (patch, head) with hd = 6 or 10:
//    below any tensor-core shape, so each lane takes (query row, head)
//    pairs with scalar f32 FMAs over registers holding one logit row.
//  * K7b: the TPU carries the weight gradients in one f32 scratch across
//    its sequential grid. Blocks here run in no order, and an f32 partial
//    of every weight gradient per warp does not fit shared memory at D =
//    40 (78 KB). So the per-patch kernel writes the bf16 operands of the
//    weight-gradient products (y, dq|dk|dv, bf16(o), bf16(dx2), y2,
//    bf16(dhp), bf16(gelu)) to a workspace, and the four products dW =
//    A^T B run as the tiled GEMM of ff_common.cuh with the contraction
//    over rows split into chunks; the LN and bias gradients are per-lane
//    column sums kept by each warp. Every partial (chunk, block, warp) is
//    summed in a fixed order: no float atomics, identical bits on every
//    call on one card.
#include "ff_common.cuh"

namespace sav {
namespace tnt {

using namespace sav::ff;

constexpr int L = 16;            // pixel tokens per patch: one m16 tile
constexpr int MAX_WARPS = 8;
constexpr int SMEM_CAP = 232448;
constexpr unsigned FULL = 0xffffffffu;

struct Geo {
  int d, f, h, hd;
  int dp;      // D padded to a multiple of 16
  int ldy;     // bf16 row stride of [16][Dp] operands and of Wo, W2
  int ldq;     // bf16 row stride of Wqkv and dq|dk|dv: 3 Dp + 8
  int ldf;     // bf16 row stride of W1 and [16][F] operands: F + 8
  int nvec;    // LN parameters and biases: 5 D + F
};

__host__ __device__ inline Geo geo(int d, int f, int h) {
  Geo g;
  g.d = d; g.f = f; g.h = h; g.hd = d / h;
  g.dp = (d + 15) / 16 * 16;
  g.ldy = g.dp + 8;
  g.ldq = 3 * g.dp + 8;
  g.ldf = f + 8;
  g.nvec = 5 * d + f;
  return g;
}

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) / 16 * 16; }

// Block-shared part: Wqkv [Dp][ldq], Wo [Dp][ldy], W1 [Dp][ldf], W2 [F][ldy]
// (bf16, zero-padded), then the f32 vector parameters.
__host__ __device__ inline size_t weight_bytes(const Geo& g) {
  return up16((size_t)2 * (g.dp * g.ldq + g.dp * g.ldy + g.dp * g.ldf
                           + g.f * g.ldy))
         + up16((size_t)4 * g.nvec);
}

// Per warp, K7a: x/x2 f32 [16][D], y and o bf16 [16][ldy], the row
// statistics [16][2], and one region holding q, k, v f32 [16][Dp] until
// the attention is done, then gelu bf16 [16][ldf].
__host__ __device__ inline size_t fwd_region(const Geo& g) {
  const size_t qkv = (size_t)3 * L * g.dp * 4, gact = (size_t)L * g.ldf * 2;
  return up16(qkv > gact ? qkv : gact);
}

__host__ __device__ inline size_t fwd_warp_bytes(const Geo& g) {
  return up16((size_t)L * g.d * 4) + 2 * up16((size_t)L * g.ldy * 2) + 128
         + fwd_region(g);
}

// Per warp, K7b: x and x2/dx2 f32 [16][D]; q, k, v and a scratch T f32
// [16][Dp]; y/y2, o/dao and do bf16 [16][ldy]; one region holding hp/dhp
// f32 [16][F] and bf16(dhp) [16][ldf] until dy2 is formed, then the
// softmax rows and ds f32 [2][H][16][16] and dq|dk|dv bf16 [16][ldq]; the
// row statistics [2][16][2]; the column sums of the LN and bias gradients
// [nvec].
__host__ __device__ inline size_t bwd_region(const Geo& g) {
  const size_t ff = up16((size_t)L * g.f * 4) + up16((size_t)L * g.ldf * 2);
  const size_t at = up16((size_t)2 * g.h * L * L * 4)
                    + up16((size_t)L * g.ldq * 2);
  return ff > at ? ff : at;
}

// Offset of the column sums in a warp's part (they come last).
__host__ __device__ inline size_t bwd_vec_offset(const Geo& g) {
  return 2 * up16((size_t)L * g.d * 4) + 4 * up16((size_t)L * g.dp * 4)
         + 3 * up16((size_t)L * g.ldy * 2) + bwd_region(g) + 256;
}

__host__ __device__ inline size_t bwd_warp_bytes(const Geo& g) {
  return bwd_vec_offset(g) + up16((size_t)4 * g.nvec);
}

// Warps per block (at most 8) whose shared memory fits one block, or 0.
__host__ __device__ inline int warps_for(size_t per_warp, size_t shared) {
  if (shared + per_warp > (size_t)SMEM_CAP) return 0;
  const size_t w = ((size_t)SMEM_CAP - shared) / per_warp;
  return w > MAX_WARPS ? MAX_WARPS : (int)w;
}

// ----------------------------------------------------------- warp pieces

// out[16][N] = A[16][K] B with A stored [m][k] (row stride lda) and B
// stored [k][n] (kTB false) or [n][k] (kTB true); N, K multiples of 16.
// epi(row, col, v0, v1) gets columns col and col + 1 of row, each once.
template <bool kTB, typename Epi>
__device__ __forceinline__ void warp_mma(const bf16* a, int lda, const bf16* b,
                                         int ldb, int N, int K, int lane,
                                         Epi epi) {
  const int g = lane >> 2, t = lane & 3;
  for (int n0 = 0; n0 < N; n0 += 16) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t af[4], bfr[4];
      load_a(af, a, lda, 0, k0, lane);
      load_b_any<kTB>(bfr, b, ldb, k0, n0, lane);
      mma_16816(acc[0], af, bfr[0], bfr[1]);
      mma_16816(acc[1], af, bfr[2], bfr[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      epi(g, col, acc[j][0], acc[j][1]);
      epi(g + 8, col, acc[j][2], acc[j][3]);
    }
  }
}

// y = bf16(LN(x)) over the D columns of x f32 [16][D], zeros in columns D
// .. Dp - 1; two lanes per row. stat[2r], stat[2r + 1] = mu, 1/sigma.
__device__ __forceinline__ void
ln_rows(const float* x, const float* s, const float* b, bf16* y, float* stat,
        const Geo& g, float eps, int lane) {
  const int r = lane >> 1, half = lane & 1;
  float sum = 0.f, sq = 0.f;
  for (int c = half; c < g.d; c += 2) {
    const float v = x[r * g.d + c];
    sum += v;
    sq += v * v;
  }
  sum += __shfl_xor_sync(FULL, sum, 1);
  sq += __shfl_xor_sync(FULL, sq, 1);
  const float mu = sum / g.d;
  const float inv = rsqrtf(fmaxf(sq / g.d - mu * mu, 0.f) + eps);
  for (int c = half; c < g.dp; c += 2)
    y[r * g.ldy + c] = __float2bfloat16(
        c < g.d ? (x[r * g.d + c] - mu) * inv * s[c] + b[c] : 0.f);
  if (half == 0) {
    stat[2 * r] = mu;
    stat[2 * r + 1] = inv;
  }
}

// One logit row of query r, head hh: s[p] = q[r] . k[p] over the head's
// columns, then the softmax in place (a = e / sum e, as the TPU kernel).
__device__ __forceinline__ void softmax_row(const float* q, const float* k,
                                            const Geo& g, int r, int c0,
                                            float* s) {
  float m = -INFINITY;
#pragma unroll
  for (int p = 0; p < L; ++p) {
    float acc = 0.f;
    for (int c = 0; c < g.hd; ++c)
      acc += q[r * g.dp + c0 + c] * k[p * g.dp + c0 + c];
    s[p] = acc;
    m = fmaxf(m, acc);
  }
  float l = 0.f;
#pragma unroll
  for (int p = 0; p < L; ++p) {
    s[p] = expf(s[p] - m);
    l += s[p];
  }
#pragma unroll
  for (int p = 0; p < L; ++p) s[p] = s[p] / l;
}

// o = bf16(softmax(q k^T) v) per head into [16][ldy], zeros past D.
__device__ __forceinline__ void
attention_fwd(const float* q, const float* k, const float* v, bf16* o,
              const Geo& g, int lane) {
  for (int pr = lane; pr < L * g.h; pr += 32) {
    const int r = pr & (L - 1), c0 = (pr / L) * g.hd;
    float s[L];
    softmax_row(q, k, g, r, c0, s);
    for (int c = 0; c < g.hd; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < L; ++p) acc += s[p] * v[p * g.dp + c0 + c];
      o[r * g.ldy + c0 + c] = __float2bfloat16(acc);
    }
  }
  const int pad = g.dp - g.d;
  for (int i = lane; i < L * pad; i += 32)
    o[(i / pad) * g.ldy + g.d + i % pad] = __float2bfloat16(0.f);
}

// The block's weights into shared memory, zero-padded.
__device__ __forceinline__ void
load_weights(const bf16* __restrict__ wqkv, const bf16* __restrict__ wo,
             const bf16* __restrict__ w1, const bf16* __restrict__ w2,
             const float* __restrict__ par, const Geo& g, bf16* sWqkv,
             bf16* sWo, bf16* sW1, bf16* sW2, float* sPar) {
  const bf16 zero = __float2bfloat16(0.f);
  const int d = g.d, dp = g.dp, f = g.f;
  for (int i = threadIdx.x; i < dp * 3 * dp; i += blockDim.x) {
    const int r = i / (3 * dp), c = i % (3 * dp), sec = c / dp, cc = c % dp;
    sWqkv[r * g.ldq + c] =
        (r < d && cc < d) ? wqkv[r * 3 * d + sec * d + cc] : zero;
  }
  for (int i = threadIdx.x; i < dp * dp; i += blockDim.x) {
    const int r = i / dp, c = i % dp;
    sWo[r * g.ldy + c] = (r < d && c < d) ? wo[r * d + c] : zero;
  }
  for (int i = threadIdx.x; i < dp * f; i += blockDim.x) {
    const int r = i / f, c = i % f;
    sW1[r * g.ldf + c] = r < d ? w1[r * f + c] : zero;
  }
  for (int i = threadIdx.x; i < f * dp; i += blockDim.x) {
    const int r = i / dp, c = i % dp;
    sW2[r * g.ldy + c] = c < d ? w2[r * d + c] : zero;
  }
  for (int i = threadIdx.x; i < g.nvec; i += blockDim.x) sPar[i] = par[i];
}

struct Shared {
  bf16 *wqkv, *wo, *w1, *w2;
  float* par;     // ln1s, ln1b, ln2s, ln2b, b2 [D] each, then b1 [F]
  unsigned char* warps;
};

__device__ inline Shared carve(unsigned char* smem, const Geo& g) {
  Shared s;
  s.wqkv = reinterpret_cast<bf16*>(smem);
  s.wo = s.wqkv + g.dp * g.ldq;
  s.w1 = s.wo + g.dp * g.ldy;
  s.w2 = s.w1 + g.dp * g.ldf;
  s.par = reinterpret_cast<float*>(
      smem + up16((size_t)2 * (g.dp * g.ldq + g.dp * g.ldy + g.dp * g.ldf
                               + g.f * g.ldy)));
  s.warps = smem + weight_bytes(g);
  return s;
}

// ------------------------------------------------------------------ K7a

// Both kernels are templates over (D, F, H): an instantiation with them
// built in (TNT-S's and TNT-B's inner layer) lets the compiler unroll the
// per-head loops and turn every index division into constant arithmetic;
// <0, 0, 0> reads them from its arguments and takes any supported shape.
template <int kD, int kF, int kH>
__global__ void __launch_bounds__(MAX_WARPS * 32)
tnt_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
               const bf16* __restrict__ wo, const bf16* __restrict__ w1,
               const bf16* __restrict__ w2, const float* __restrict__ par,
               bf16* __restrict__ out, int n, int d, int f, int h, float eps,
               float q_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (kD) {
    d = kD;
    f = kF;
    h = kH;
  }
  const Geo g = geo(d, f, h);
  const Shared S = carve(smem_raw, g);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const float *ln1s = S.par, *ln1b = S.par + d, *ln2s = S.par + 2 * d,
              *ln2b = S.par + 3 * d, *b2 = S.par + 4 * d, *b1 = S.par + 5 * d;

  unsigned char* base = S.warps + (size_t)warp * fwd_warp_bytes(g);
  float* sX = reinterpret_cast<float*>(base);
  bf16* sY = reinterpret_cast<bf16*>(base + up16((size_t)L * d * 4));
  bf16* sO = sY + up16((size_t)L * g.ldy * 2) / 2;
  float* sStat = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(sO) + up16((size_t)L * g.ldy * 2));
  unsigned char* region = reinterpret_cast<unsigned char*>(sStat) + 128;
  float* sQ = reinterpret_cast<float*>(region);
  float* sK = sQ + L * g.dp;
  float* sV = sK + L * g.dp;
  bf16* sG = reinterpret_cast<bf16*>(region);

  load_weights(wqkv, wo, w1, w2, par, g, S.wqkv, S.wo, S.w1, S.w2, S.par);
  __syncthreads();

  for (int p = blockIdx.x * nwarps + warp; p < n; p += gridDim.x * nwarps) {
    const bf16* xp = x + (size_t)p * L * d;
    for (int i = lane; i < L * d; i += 32) sX[i] = __bfloat162float(xp[i]);
    __syncwarp();
    ln_rows(sX, ln1s, ln1b, sY, sStat, g, eps, lane);
    __syncwarp();
    warp_mma<false>(sY, g.ldy, S.wqkv, g.ldq, 3 * g.dp, g.dp, lane,
                    [&](int r, int c, float v0, float v1) {
      const int sec = c / g.dp, cc = c - sec * g.dp;
      float* dst = sec == 0 ? sQ : (sec == 1 ? sK : sV);
      const float m = sec == 0 ? q_scale : 1.f;
      dst[r * g.dp + cc] = v0 * m;
      dst[r * g.dp + cc + 1] = v1 * m;
    });
    __syncwarp();
    attention_fwd(sQ, sK, sV, sO, g, lane);
    __syncwarp();
    // x2 = x + bf16(o) Wo, kept in f32 (in place of x)
    warp_mma<false>(sO, g.ldy, S.wo, g.ldy, g.dp, g.dp, lane,
                    [&](int r, int c, float v0, float v1) {
      if (c < d) {
        sX[r * d + c] += v0;
        sX[r * d + c + 1] += v1;
      }
    });
    __syncwarp();
    ln_rows(sX, ln2s, ln2b, sY, sStat, g, eps, lane);
    __syncwarp();
    warp_mma<false>(sY, g.ldy, S.w1, g.ldf, f, g.dp, lane,
                    [&](int r, int c, float v0, float v1) {
      const float h0 = v0 + b1[c], h1 = v1 + b1[c + 1];
      *reinterpret_cast<uint32_t*>(sG + r * g.ldf + c) =
          pack_bf16(0.5f * h0 * (1.f + gelu_t(h0)),
                    0.5f * h1 * (1.f + gelu_t(h1)));
    });
    __syncwarp();
    bf16* op = out + (size_t)p * L * d;
    warp_mma<false>(sG, g.ldf, S.w2, g.ldy, g.dp, f, lane,
                    [&](int r, int c, float v0, float v1) {
      if (c < d)
        *reinterpret_cast<uint32_t*>(op + r * d + c) =
            pack_bf16(sX[r * d + c] + v0 + b2[c],
                      sX[r * d + c + 1] + v1 + b2[c + 1]);
    });
    __syncwarp();
  }
}

// ------------------------------------------------------------------ K7b

// The workspace the backward's per-patch kernel fills: bf16 row operands of
// the weight-gradient products, [rows][width] each.
struct Rows {
  bf16 *y, *dqkv, *ob, *dao, *y2, *dh, *gact;
};

// LayerNorm backward of one patch from dy f32 [16][Dp] (stride dp) and
// the forward's input xin f32 [16][D] with its row statistics: the column
// sums of dy * xhat and dy into dscale/dbias (one lane per column, rows in
// order), then dx_ln = inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
// handed to emit(r, c, dx_ln) (two lanes per row; each element is read
// from xin by the lane that emits it, after every other read of xin, so
// emit may overwrite xin).
template <typename Emit>
__device__ __forceinline__ void
ln_bwd(const float* dy, const float* xin, const float* stat, const float* scale,
       float* dscale, float* dbias, const Geo& g, int lane, Emit emit) {
  for (int c = lane; c < g.d; c += 32) {
    float ds = 0.f, db = 0.f;
    for (int r = 0; r < L; ++r) {
      const float xh = (xin[r * g.d + c] - stat[2 * r]) * stat[2 * r + 1];
      ds += dy[r * g.dp + c] * xh;
      db += dy[r * g.dp + c];
    }
    dscale[c] += ds;
    dbias[c] += db;
  }
  const int r = lane >> 1, half = lane & 1;
  const float mu = stat[2 * r], inv = stat[2 * r + 1];
  float m1 = 0.f, m2 = 0.f;
  for (int c = half; c < g.d; c += 2) {
    const float dxh = dy[r * g.dp + c] * scale[c];
    m1 += dxh;
    m2 += dxh * (xin[r * g.d + c] - mu) * inv;
  }
  m1 += __shfl_xor_sync(FULL, m1, 1);
  m2 += __shfl_xor_sync(FULL, m2, 1);
  m1 /= g.d;
  m2 /= g.d;
  __syncwarp();
  for (int c = half; c < g.d; c += 2) {
    const float xh = (xin[r * g.d + c] - mu) * inv;
    const float dxh = dy[r * g.dp + c] * scale[c];
    emit(r, c, inv * (dxh - m1 - xh * m2));
  }
}

__device__ __forceinline__ void
store_rows(bf16* __restrict__ dst, const bf16* src, int lds, int width,
           int lane) {
  for (int i = lane; i < L * width; i += 32)
    dst[i] = src[(i / width) * lds + i % width];
}

template <int kD, int kF, int kH>
__global__ void __launch_bounds__(MAX_WARPS * 32)
tnt_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gout,
                    const bf16* __restrict__ wqkv, const bf16* __restrict__ wo,
                    const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                    const float* __restrict__ par, bf16* __restrict__ dx,
                    Rows ws, float* __restrict__ vec_part, int n, int d, int f,
                    int h, float eps, float q_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (kD) {
    d = kD;
    f = kF;
    h = kH;
  }
  const Geo g = geo(d, f, h);
  const Shared S = carve(smem_raw, g);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int dp = g.dp;
  const float *ln1s = S.par, *ln1b = S.par + d, *ln2s = S.par + 2 * d,
              *ln2b = S.par + 3 * d, *b1 = S.par + 5 * d;

  unsigned char* cur = S.warps + (size_t)warp * bwd_warp_bytes(g);
  auto take = [&](size_t bytes) {
    unsigned char* p = cur;
    cur += up16(bytes);
    return p;
  };
  float* sX = reinterpret_cast<float*>(take((size_t)L * d * 4));
  float* sX2 = reinterpret_cast<float*>(take((size_t)L * d * 4));
  float* sQ = reinterpret_cast<float*>(take((size_t)L * dp * 4));
  float* sK = reinterpret_cast<float*>(take((size_t)L * dp * 4));
  float* sV = reinterpret_cast<float*>(take((size_t)L * dp * 4));
  float* sT = reinterpret_cast<float*>(take((size_t)L * dp * 4));
  bf16* sY = reinterpret_cast<bf16*>(take((size_t)L * g.ldy * 2));
  bf16* sO = reinterpret_cast<bf16*>(take((size_t)L * g.ldy * 2));
  bf16* sDo = reinterpret_cast<bf16*>(take((size_t)L * g.ldy * 2));
  unsigned char* region = take(bwd_region(g));
  float* sStat = reinterpret_cast<float*>(take(256));   // [2][16][2]
  float* sVec = reinterpret_cast<float*>(take((size_t)4 * g.nvec));
  // region, first half of the backward: hp -> dhp f32, bf16(dhp)
  float* sH = reinterpret_cast<float*>(region);
  bf16* sDh = reinterpret_cast<bf16*>(region + up16((size_t)L * f * 4));
  // region, attention backward: softmax rows, ds, then dq|dk|dv bf16
  float* sA = reinterpret_cast<float*>(region);
  float* sDs = sA + h * L * L;
  bf16* sDqkv = reinterpret_cast<bf16*>(region
                                        + up16((size_t)2 * h * L * L * 4));
  float *vln1s = sVec, *vln1b = sVec + d, *vln2s = sVec + 2 * d,
        *vln2b = sVec + 3 * d, *vb2 = sVec + 4 * d, *vb1 = sVec + 5 * d;

  load_weights(wqkv, wo, w1, w2, par, g, S.wqkv, S.wo, S.w1, S.w2, S.par);
  for (int i = lane; i < g.nvec; i += 32) sVec[i] = 0.f;
  __syncthreads();

  for (int p = blockIdx.x * nwarps + warp; p < n; p += gridDim.x * nwarps) {
    const size_t row0 = (size_t)p * L;
    const bf16* xp = x + row0 * d;
    const bf16* gp = gout + row0 * d;
    for (int i = lane; i < L * d; i += 32) sX[i] = __bfloat162float(xp[i]);
    for (int i = lane; i < L * dp; i += 32) {
      const int r = i / dp, c = i % dp;
      sDo[r * g.ldy + c] = c < d ? gp[r * d + c] : __float2bfloat16(0.f);
    }
    __syncwarp();

    // ---- recompute the forward
    ln_rows(sX, ln1s, ln1b, sY, sStat, g, eps, lane);
    __syncwarp();
    store_rows(ws.y + row0 * d, sY, g.ldy, d, lane);
    warp_mma<false>(sY, g.ldy, S.wqkv, g.ldq, 3 * dp, dp, lane,
                    [&](int r, int c, float v0, float v1) {
      const int sec = c / dp, cc = c - sec * dp;
      float* dst = sec == 0 ? sQ : (sec == 1 ? sK : sV);
      const float m = sec == 0 ? q_scale : 1.f;
      dst[r * dp + cc] = v0 * m;
      dst[r * dp + cc + 1] = v1 * m;
    });
    __syncwarp();
    attention_fwd(sQ, sK, sV, sO, g, lane);
    __syncwarp();
    store_rows(ws.ob + row0 * d, sO, g.ldy, d, lane);
    warp_mma<false>(sO, g.ldy, S.wo, g.ldy, dp, dp, lane,
                    [&](int r, int c, float v0, float v1) {
      if (c < d) {
        sX2[r * d + c] = sX[r * d + c] + v0;
        sX2[r * d + c + 1] = sX[r * d + c + 1] + v1;
      }
    });
    __syncwarp();
    ln_rows(sX2, ln2s, ln2b, sY, sStat + 2 * L, g, eps, lane);
    __syncwarp();
    store_rows(ws.y2 + row0 * d, sY, g.ldy, d, lane);
    bf16* gact = ws.gact + row0 * f;
    warp_mma<false>(sY, g.ldy, S.w1, g.ldf, f, dp, lane,
                    [&](int r, int c, float v0, float v1) {
      const float h0 = v0 + b1[c], h1 = v1 + b1[c + 1];
      sH[r * f + c] = h0;
      sH[r * f + c + 1] = h1;
      *reinterpret_cast<uint32_t*>(gact + r * f + c) =
          pack_bf16(0.5f * h0 * (1.f + gelu_t(h0)),
                    0.5f * h1 * (1.f + gelu_t(h1)));
    });
    __syncwarp();

    // ---- FF backward: dgact = do W2^T, dhp = dgact gelu'(hp)
    bf16* dhg = ws.dh + row0 * f;
    warp_mma<true>(sDo, g.ldy, S.w2, g.ldy, f, dp, lane,
                   [&](int r, int c, float v0, float v1) {
      const float h0 = sH[r * f + c], h1 = sH[r * f + c + 1];
      const float d0 = v0 * gelu_bwd(h0, gelu_t(h0));
      const float d1 = v1 * gelu_bwd(h1, gelu_t(h1));
      sH[r * f + c] = d0;
      sH[r * f + c + 1] = d1;
      const uint32_t pk = pack_bf16(d0, d1);
      *reinterpret_cast<uint32_t*>(sDh + r * g.ldf + c) = pk;
      *reinterpret_cast<uint32_t*>(dhg + r * f + c) = pk;
    });
    __syncwarp();
    for (int c = lane; c < f; c += 32) {
      float s = 0.f;
      for (int r = 0; r < L; ++r) s += sH[r * f + c];
      vb1[c] += s;
    }
    for (int c = lane; c < d; c += 32) {
      float s = 0.f;
      for (int r = 0; r < L; ++r) s += __bfloat162float(sDo[r * g.ldy + c]);
      vb2[c] += s;
    }
    // dy2 = bf16(dhp) W1^T
    warp_mma<true>(sDh, g.ldf, S.w1, g.ldf, dp, f, lane,
                   [&](int r, int c, float v0, float v1) {
      sT[r * dp + c] = v0;
      sT[r * dp + c + 1] = v1;
    });
    __syncwarp();
    // LN2 backward: dx2 = LN2'(dy2) + do in f32, in place of x2; dao =
    // bf16(dx2) in place of bf16(o)
    ln_bwd(sT, sX2, sStat + 2 * L, ln2s, vln2s, vln2b, g, lane,
           [&](int r, int c, float v) {
      const float dx2 = v + __bfloat162float(sDo[r * g.ldy + c]);
      sX2[r * d + c] = dx2;
      sO[r * g.ldy + c] = __float2bfloat16(dx2);
    });
    __syncwarp();
    for (int i = lane; i < L * (dp - d); i += 32)
      sO[(i / (dp - d)) * g.ldy + d + i % (dp - d)] = __float2bfloat16(0.f);
    __syncwarp();
    store_rows(ws.dao + row0 * d, sO, g.ldy, d, lane);
    // dO = bf16(dx2) Wo^T
    warp_mma<true>(sO, g.ldy, S.wo, g.ldy, dp, dp, lane,
                   [&](int r, int c, float v0, float v1) {
      sT[r * dp + c] = v0;
      sT[r * dp + c + 1] = v1;
    });
    __syncwarp();

    // ---- attention backward, pass 1 per (query row, head): a, ds, dq
    for (int pr = lane; pr < L * h; pr += 32) {
      const int r = pr & (L - 1), hh = pr / L, c0 = hh * g.hd;
      float a[L], ds[L];
      softmax_row(sQ, sK, g, r, c0, a);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        float acc = 0.f;
        for (int c = 0; c < g.hd; ++c)
          acc += sT[r * dp + c0 + c] * sV[k * dp + c0 + c];
        ds[k] = acc;               // da
        sum += acc * a[k];
      }
#pragma unroll
      for (int k = 0; k < L; ++k) {
        ds[k] = a[k] * (ds[k] - sum);
        sA[(hh * L + r) * L + k] = a[k];
        sDs[(hh * L + r) * L + k] = ds[k];
      }
      for (int c = 0; c < g.hd; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < L; ++k) acc += ds[k] * sK[k * dp + c0 + c];
        sDqkv[r * g.ldq + c0 + c] = __float2bfloat16(acc * q_scale);
      }
    }
    __syncwarp();
    // pass 2 per (key row, head): dk = ds^T qs, dv = a^T dO
    for (int pr = lane; pr < L * h; pr += 32) {
      const int kr = pr & (L - 1), hh = pr / L, c0 = hh * g.hd;
      for (int c = 0; c < g.hd; ++c) {
        float dk = 0.f, dv = 0.f;
#pragma unroll
        for (int q = 0; q < L; ++q) {
          dk += sDs[(hh * L + q) * L + kr] * sQ[q * dp + c0 + c];
          dv += sA[(hh * L + q) * L + kr] * sT[q * dp + c0 + c];
        }
        sDqkv[kr * g.ldq + dp + c0 + c] = __float2bfloat16(dk);
        sDqkv[kr * g.ldq + 2 * dp + c0 + c] = __float2bfloat16(dv);
      }
    }
    for (int i = lane; i < L * 3 * (dp - d); i += 32) {
      const int r = i / (3 * (dp - d)), j = i % (3 * (dp - d));
      sDqkv[r * g.ldq + (j / (dp - d)) * dp + d + j % (dp - d)] =
          __float2bfloat16(0.f);
    }
    __syncwarp();
    bf16* dqg = ws.dqkv + row0 * 3 * d;
    for (int i = lane; i < L * 3 * d; i += 32) {
      const int r = i / (3 * d), j = i % (3 * d);
      dqg[i] = sDqkv[r * g.ldq + (j / d) * dp + j % d];
    }
    // dy = [dq|dk|dv] Wqkv^T
    warp_mma<true>(sDqkv, g.ldq, S.wqkv, g.ldq, dp, 3 * dp, lane,
                   [&](int r, int c, float v0, float v1) {
      sT[r * dp + c] = v0;
      sT[r * dp + c + 1] = v1;
    });
    __syncwarp();
    bf16* dxp = dx + row0 * d;
    ln_bwd(sT, sX, sStat, ln1s, vln1s, vln1b, g, lane,
           [&](int r, int c, float v) {
      dxp[r * d + c] = __float2bfloat16(v + sX2[r * d + c]);
    });
    __syncwarp();
  }

  // the block's column sums: the warps' sums added in warp order
  __syncthreads();
  for (int i = threadIdx.x; i < g.nvec; i += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w)
      s += reinterpret_cast<const float*>(
               S.warps + (size_t)w * bwd_warp_bytes(g)
               + bwd_vec_offset(g))[i];
    vec_part[(size_t)blockIdx.x * g.nvec + i] = s;
  }
}

// ----------------------------------------------------------------- host

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The instantiation of a kernel for (D, F, H).
template <typename K>
inline K pick(int d, int f, int h, K tnt_s, K tnt_b, K any) {
  if (d == 24 && f == 96 && h == 4) return tnt_s;
  if (d == 40 && f == 160 && h == 4) return tnt_b;
  return any;
}

inline auto fwd_kernel(int d, int f, int h) {
  return pick(d, f, h, tnt_fwd_kernel<24, 96, 4>, tnt_fwd_kernel<40, 160, 4>,
              tnt_fwd_kernel<0, 0, 0>);
}

inline auto bwd_kernel(int d, int f, int h) {
  return pick(d, f, h, tnt_bwd_rows_kernel<24, 96, 4>,
              tnt_bwd_rows_kernel<40, 160, 4>, tnt_bwd_rows_kernel<0, 0, 0>);
}

// Persistent grid of a per-patch kernel: at most the blocks the card holds
// at once, at most one warp per patch.
template <typename K>
inline cudaError_t grid_for(K kernel, int warps, size_t smem, int n,
                            int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      warps * 32, smem);
  if (err != cudaSuccess) return err;
  const int need = (n + warps - 1) / warps;
  const int most = (per_sm > 0 ? per_sm : 1) * sm_count();
  *blocks = need < most ? need : most;
  return cudaSuccess;
}

struct BwdPlan {
  int warps, blocks;          // per-patch kernel
  int per_item, items, chunks, per_chunk;   // dW GEMMs over row items
  size_t rows_bytes, vec_bytes, part_bytes;
  long long total;            // f32 elements of all weight gradients
};

inline size_t up256(size_t n) { return (n + 255) / 256 * 256; }

inline cudaError_t plan_bwd(int n, int d, int f, int h, BwdPlan* pl) {
  const Geo g = geo(d, f, h);
  pl->warps = warps_for(bwd_warp_bytes(g), weight_bytes(g));
  if (pl->warps < 1) return cudaErrorInvalidValue;
  const size_t smem = weight_bytes(g) + pl->warps * bwd_warp_bytes(g);
  cudaError_t err = grid_for(bwd_kernel(d, f, h), pl->warps, smem, n,
                             &pl->blocks);
  if (err != cudaSuccess) return err;
  // rows of one GEMM batch item: 4 patches where they divide B*P (always
  // at 196 patches an image), so a 32-row contraction tile is whole
  pl->per_item = n % 4 == 0 ? 4 : (n % 2 == 0 ? 2 : 1);
  pl->items = n / pl->per_item;
  const int want = 2 * sm_count();
  pl->per_chunk = (pl->items + want - 1) / want;
  pl->chunks = (pl->items + pl->per_chunk - 1) / pl->per_chunk;
  const size_t rows = (size_t)n * L;
  // y, ob, dao, y2 [rows][D]; dqkv [rows][3D]; dh, gact [rows][F]
  pl->rows_bytes = 4 * up256(rows * d * 2) + up256(rows * 3 * d * 2)
                   + 2 * up256(rows * f * 2);
  pl->vec_bytes = up256((size_t)pl->blocks * g.nvec * 4);
  pl->total = 4LL * d * d + 2LL * d * f;
  pl->part_bytes = up256((size_t)pl->chunks * pl->total * 4);
  return cudaSuccess;
}

}  // namespace tnt
}  // namespace sav

using namespace sav;
using namespace sav::tnt;

// Warps per block of the forward (which = 0) or the backward's per-patch
// kernel (which = 1) at D, F, H, from the kernels' shared-memory layout;
// 0 where not even one warp fits a block.
extern "C" int sav_tnt_warps(int which, int d, int f, int h) {
  const Geo g = geo(d, f, h);
  return warps_for(which ? bwd_warp_bytes(g) : fwd_warp_bytes(g),
                   weight_bytes(g));
}

// x, out [n, 16, D] bf16; wqkv [D, 3D] = [Wq | Wk | Wv], wo [D, D], w1
// [D, F], w2 [F, D] bf16; par f32 [5D + F] = ln1 scale, ln1 bias, ln2
// scale, ln2 bias, b2 [D] each, b1 [F]. Needs D % 8 == 0, D % H == 0,
// F % 16 == 0 and sav_tnt_warps(0, ...) >= 1.
extern "C" int sav_tnt_fwd(const void* x, const void* wqkv, const void* wo,
                           const void* w1, const void* w2, const float* par,
                           void* out, int n, int d, int f, int h, float eps,
                           float q_scale, void* stream) {
  const Geo g = geo(d, f, h);
  const int warps = warps_for(fwd_warp_bytes(g), weight_bytes(g));
  if (warps < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = weight_bytes(g) + warps * fwd_warp_bytes(g);
  int blocks = 0;
  const auto kernel = fwd_kernel(d, f, h);
  cudaError_t err = grid_for(kernel, warps, smem, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)wqkv, (const bf16*)wo, (const bf16*)w1,
      (const bf16*)w2, par, (bf16*)out, n, d, f, h, eps, q_scale);
  return (int)cudaGetLastError();
}

// Bytes of the workspace sav_tnt_bwd needs at n patches on the current
// device, or -1 where the shape is not taken.
extern "C" long long sav_tnt_bwd_workspace(int n, int d, int f, int h) {
  BwdPlan pl;
  if (n < 1 || plan_bwd(n, d, f, h, &pl) != cudaSuccess) return -1;
  return (long long)(pl.rows_bytes + pl.vec_bytes + pl.part_bytes);
}

// The backward of sav_tnt_fwd from x and the cotangent g [n, 16, D] bf16:
// dx [n, 16, D] bf16; gw f32 [4 D^2 + 2 D F] = dWqkv [D][3D], dWo [D][D],
// dW1 [D][F], dW2 [F][D]; gvec f32 [5D + F] in par's order. ws: the bytes
// sav_tnt_bwd_workspace gives.
extern "C" int sav_tnt_bwd(const void* x, const void* gout, const void* wqkv,
                           const void* wo, const void* w1, const void* w2,
                           const float* par, void* dx, float* gw, float* gvec,
                           void* ws, int n, int d, int f, int h, float eps,
                           float q_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Geo g = geo(d, f, h);
  BwdPlan pl;
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = plan_bwd(n, d, f, h, &pl);
  if (err != cudaSuccess) return (int)err;
  const size_t rows = (size_t)n * L;
  unsigned char* cur = (unsigned char*)ws;
  auto take = [&](size_t bytes) {
    unsigned char* p = cur;
    cur += up256(bytes);
    return p;
  };
  Rows R;
  R.y = (bf16*)take(rows * d * 2);
  R.ob = (bf16*)take(rows * d * 2);
  R.dao = (bf16*)take(rows * d * 2);
  R.y2 = (bf16*)take(rows * d * 2);
  R.dqkv = (bf16*)take(rows * 3 * d * 2);
  R.dh = (bf16*)take(rows * f * 2);
  R.gact = (bf16*)take(rows * f * 2);
  float* vec_part = (float*)take((size_t)pl.blocks * g.nvec * 4);
  float* part = (float*)take((size_t)pl.chunks * pl.total * 4);

  const size_t smem = weight_bytes(g) + pl.warps * bwd_warp_bytes(g);
  const auto rows_kernel = bwd_kernel(d, f, h);
  rows_kernel<<<pl.blocks, pl.warps * 32, smem, st>>>(
      (const bf16*)x, (const bf16*)gout, (const bf16*)wqkv, (const bf16*)wo,
      (const bf16*)w1, (const bf16*)w2, par, (bf16*)dx, R, vec_part, n, d, f,
      h, eps, q_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = sum_launch(vec_part, pl.blocks, g.nvec, g.nvec, gvec, st))
      != cudaSuccess)
    return (int)err;

  // dW = A^T B over all rows, rows split into items of per_item patches
  const int kc = L * pl.per_item;
  struct Product { const bf16* a; int m; const bf16* b; int n; long long off; };
  const Product prods[4] = {
      {R.y, d, R.dqkv, 3 * d, 0},
      {R.ob, d, R.dao, d, 3LL * d * d},
      {R.y2, d, R.dh, f, 4LL * d * d},
      {R.gact, f, (const bf16*)gout, d, 4LL * d * d + (long long)d * f},
  };
  for (const Product& pr : prods) {
    GemmArgs p = {};
    p.A = pr.a;
    p.B = pr.b;
    p.M = pr.m;
    p.N = pr.n;
    p.Kc = kc;
    p.lda = pr.m;
    p.ldb = pr.n;
    p.sa = (long long)kc * pr.m;
    p.sb = (long long)kc * pr.n;
    p.nbatch = pl.items;
    p.per_chunk = pl.per_chunk;
    p.cf = part + pr.off;
    p.ldc = pr.n;
    p.sc = pl.total;
    if ((err = gemm_launch<true, false, kF32>(p, pl.chunks, st))
        != cudaSuccess)
      return (int)err;
  }
  return (int)sum_launch(part, pl.chunks, pl.total, (int)pl.total, gw, st);
}
