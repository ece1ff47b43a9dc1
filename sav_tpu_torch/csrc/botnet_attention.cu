// K9a and K9b ports: BoTNet's attention core with the decomposed 2-D
// relative-position bias.
//
// Replaces sav_tpu/ops/botnet_attention.py::_fwd_kernel (K9a) and
// ::_bwd_kernel (K9b). Same function: qs (pre-scaled), k, v as [B, L, h*d]
// bf16 head bands with L = g*g keys on a g x g grid in row-major order;
// rel_h, rel_w as [B, h, L, g] f32; per (image, head), for query row q and
// key column j
//   s[q, j] = qs[q] . k[j] + rel_h[q, j / g] + rel_w[q, j % g]      (f32)
//   K9a: p = exp(s - m), out = bf16(p) v / sum(p) in bf16, lse = m + log sum p
//   K9b: p = exp(s - lse);  dv = bf16(p)^T do;  dp = do v^T;
//        di = rowsum(do * o) (f32);  ds = (dp - di) p (f32);
//        dq = bf16(ds) k,  dk = bf16(ds)^T qs;
//        drel_h[q, P] = sum_{j / g = P} ds[q, j],
//        drel_w[q, Q] = sum_{j % g = Q} ds[q, j]      (from the f32 ds)
// with f32 accumulation, dq/dk/dv/out in bf16, rounded where the TPU
// kernels round. The TPU kernels expand the bias with two 0/1 matmuls in
// VMEM (`_expanders`) and pad L to a multiple of 16 in HBM; here the bias is
// an index computation per logit (j / g by a float reciprocal, exact for
// g < 2048, so no integer division runs per logit) and the ragged edge is
// masked in the kernel: query rows past L are loaded as zeros and never
// stored, key columns past L never reach the softmax, nothing is padded in
// device memory.
//
// Bound on the card (botnet_t3 @224: L = 196, g = 14, h = 4, d = 128): the
// forward is 4*L*L*d operations against 4*L*d bf16 + 2*L*g f32 bytes per
// (image, head), ~45 operations per byte, and the backward 10*L*L*d
// against 8*L*d + 4*L*g (+ the lse and di rows) bytes, ~60 per byte; both
// under the H100's ~295 bf16 operations per byte, so bound by bytes. In
// practice mma.sync's instruction rate and the per-logit bias, exp and
// masking work on the CUDA cores bound these kernels first.
//
// Design (simple first; wgmma/TMA is later work):
//  * d is a template parameter (64 or 128). At d = 128 a 64-row tile plus
//    double-buffered 64-row K/V tiles exceed the 48 KB of static shared
//    memory, so every kernel uses dynamic shared memory.
//  * K9a (bot_fwd_kernel): one block of 4 warps per (64-query tile, head,
//    image), as the K4 port: each warp owns 16 query rows and sweeps the
//    keys in 64-row tiles with an online softmax; K/V double-buffered with
//    cp.async. The block's rel_h/rel_w rows (64 x g f32 each) sit in shared
//    memory and each logit fragment gets its bias added in registers.
//  * K9b as two kernels, as the K3 port, so every sum runs in a fixed order
//    with no float atomics (two calls give identical bits):
//    - bot_bwd_dq_kernel: per (64-query tile, head, image), 4 warps of 16
//      query rows sweep every key tile, recompute p and dp, accumulate dq
//      and, per query row, drel_h and drel_w (row-local sums: each lane
//      owns its two rows' partial bins in shared memory, summed over the
//      four lanes of a row at the end in a fixed order); it also writes
//      di for the second kernel.
//    - bot_bwd_dkv_kernel: per (64-key tile, head, image), 4 warps of 16
//      key rows sweep every query tile (Q, dO, their rel rows, lse and di
//      double-buffered), accumulating dk and dv.
//    The split recomputes s and dp once more: 14*L*L*d operations for the
//    10*L*L*d of the function.
#include <math.h>

#include "mma.cuh"

namespace sav {
namespace bot {

constexpr int BT = 64;              // rows of a query or key tile: 4 warps x 16
constexpr int THREADS = 128;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory one block may use
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Geo {
  static constexpr int LD = D + 8;  // padded smem row: conflict-free ldmatrix
  static constexpr int KS = D / 16; // mma depth steps over d
  static constexpr int NT = D / 8;  // n8 tiles of a d-wide accumulator
  static constexpr int CH = D / 8;  // 16-byte chunks of a row
};

__host__ __device__ inline int odd_pitch(int g) { return g | 1; }

// 4-byte asynchronous copy global -> shared; src_bytes = 0 fills zeros.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           int src_bytes) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

// Rows [r0, r0 + BT) of one head band -> smem (pitch LD); rows at or past
// `valid` are zero-filled (src-size 0, clamped address).
template <int D>
__device__ __forceinline__ void load_band(bf16* dst, const bf16* src,
                                          int stride, int r0, int valid,
                                          int tid) {
  constexpr int CH = Geo<D>::CH, LD = Geo<D>::LD;
  for (int i = tid; i < BT * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = r0 + r < valid;
    cp_async_16(&dst[r * LD + c],
                src + (size_t)(in ? r0 + r : 0) * stride + c, in ? 16 : 0);
  }
}

// Rows [r0, r0 + BT) of one (image, head) slice [L, g] f32 -> smem [BT][g];
// rows at or past L are zero-filled.
__device__ __forceinline__ void load_rel(float* dst, const float* src, int r0,
                                         int L, int g, int tid) {
  const int valid = (L - r0 < BT ? L - r0 : BT) * g;
  const float* base = src + (size_t)r0 * g;
  for (int i = tid; i < BT * g; i += THREADS) {
    const bool in = i < valid;
    cp_async_4(&dst[i], in ? base + i : src, in ? 4 : 0);
  }
}

// Key column j -> (j / g, j % g) without an integer division.
__device__ __forceinline__ void grid_cell(int j, int g, float inv_g, int& hb,
                                          int& wb) {
  hb = (int)(((float)j + 0.5f) * inv_g);
  wb = j - hb * g;
}

// A fragment of the 16 x 16 tile at smem row r, depth step kk.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[4], const bf16* s, int r,
                                       int kk, int lane) {
  ldmatrix_x4(f, &s[(r + (lane & 15)) * Geo<D>::LD + kk * 16 + (lane >> 4) * 8]);
}

// B fragments for X . Y^T with Y's rows r..r+15 as the n axis, depth step
// kk: b[0..1] for rows r..r+7, b[2..3] for rows r+8..r+15.
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* s,
                                            int r, int kk, int lane) {
  ldmatrix_x4(b, &s[(r + (lane & 7) + ((lane >> 4) << 3)) * Geo<D>::LD
                    + kk * 16 + ((lane >> 3) & 1) * 8]);
}

// B fragments for X . Y with Y's rows r..r+15 as the depth axis and
// columns p*16..p*16+15 as n: b[0..1] for columns p*16.., b[2..3] for +8.
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* s,
                                            int r, int p, int lane) {
  ldmatrix_x4_trans(b, &s[(r + (lane & 7) + ((lane >> 3) & 1) * 8) * Geo<D>::LD
                          + p * 16 + (lane >> 4) * 8]);
}

// 16 x d accumulator -> bf16 rows r0.. of a head band (rows >= valid are
// not stored).
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, int stride, int r0,
                                           int valid,
                                           const float (&acc)[Geo<D>::NT][4],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int row0 = r0 + g, row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < Geo<D>::NT; ++dt) {
    if (row0 < valid)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row0 * stride + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][0], acc[dt][1]);
    if (row1 < valid)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row1 * stride + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// ------------------------------------------------------------------ K9a

template <int D>
__host__ __device__ inline size_t fwd_smem(int g) {
  return (size_t)5 * BT * Geo<D>::LD * 2 + (size_t)2 * BT * g * 4;
}

// grid (query tiles, heads, batch); lse is [B, h, L] f32 or null.
template <int D>
__global__ void __launch_bounds__(THREADS)
bot_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ rel_h,
               const float* __restrict__ rel_w, bf16* __restrict__ out,
               float* __restrict__ lse, int L, int heads, int g, float inv_g) {
  constexpr int LD = Geo<D>::LD, KS = Geo<D>::KS, NT = Geo<D>::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BT * LD;                  // [2][BT * LD]
  bf16* sV = sK + 2 * BT * LD;              // [2][BT * LD]
  float* sRh = reinterpret_cast<float*>(sV + 2 * BT * LD);   // [BT][g]
  float* sRw = sRh + BT * g;

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int stride = heads * D;
  const size_t off = (size_t)b * L * stride + h * D;
  const size_t roff = ((size_t)b * heads + h) * L * g;

  load_band<D>(sQ, q + off, stride, q0, L, tid);
  load_band<D>(sK, k + off, stride, 0, L, tid);
  load_band<D>(sV, v + off, stride, 0, L, tid);
  load_rel(sRh, rel_h + roff, q0, L, g, tid);
  load_rel(sRw, rel_w + roff, q0, L, g, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int wr = warp * 16;
  // a warp whose 16 rows all lie past L takes part in the loads and
  // barriers only
  const bool active = q0 + wr < L;
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a<D>(qf[kk], sQ, wr, kk, lane);
  const float* rh0 = sRh + (wr + gr) * g;
  const float* rh1 = rh0 + 8 * g;
  const float* rw0 = sRw + (wr + gr) * g;
  const float* rw1 = rw0 + 8 * g;

  float o[NT][4];
  zero(o);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0, k0 = 0; k0 < L; ++it, k0 += BT) {
    const int buf = it & 1;
    if (k0 + BT < L) {
      load_band<D>(sK + (buf ^ 1) * BT * LD, k + off, stride, k0 + BT, L, tid);
      load_band<D>(sV + (buf ^ 1) * BT * LD, v + off, stride, k0 + BT, L, tid);
    }
    cp_async_commit();
    const bf16* sKb = sK + buf * BT * LD;
    const bf16* sVb = sV + buf * BT * LD;

    if (active) {
      float s[8][4];
      zero(s);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t kf[4];
          load_b_rows<D>(kf, sKb, j * 16, kk, lane);
          mma_16816(s[2 * j], qf[kk], kf[0], kf[1]);
          mma_16816(s[2 * j + 1], qf[kk], kf[2], kf[3]);
        }
      }
      // the bias, in the TPU kernel's order (s + rel_h) + rel_w; key
      // columns past L never reach the softmax
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = k0 + nt * 8 + 2 * t + e;
          if (j < L) {
            int hb, wb;
            grid_cell(j, g, inv_g, hb, wb);
            s[nt][e] = s[nt][e] + rh0[hb] + rw0[wb];
            s[nt][2 + e] = s[nt][2 + e] + rh1[hb] + rw1[wb];
          } else {
            s[nt][e] = -INFINITY;
            s[nt][2 + e] = -INFINITY;
          }
        }
      }

      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
      }
      // the first tile always holds a key, so mx is finite here and
      // exp2(-inf) = 0 clears the empty carry
      const float a0 = exp2f((m0 - mx0) * kLog2e);
      const float a1 = exp2f((m1 - mx1) * kLog2e);
      m0 = mx0;
      m1 = mx1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = exp2f((s[nt][0] - m0) * kLog2e);
        s[nt][1] = exp2f((s[nt][1] - m0) * kLog2e);
        s[nt][2] = exp2f((s[nt][2] - m1) * kLog2e);
        s[nt][3] = exp2f((s[nt][3] - m1) * kLog2e);
        rs0 += s[nt][0] + s[nt][1];
        rs1 += s[nt][2] + s[nt][3];
      }
      l0 = l0 * a0 + rs0;               // per-lane partial; reduced at the end
      l1 = l1 * a1 + rs1;
#pragma unroll
      for (int dt = 0; dt < NT; ++dt) {
        o[dt][0] *= a0;
        o[dt][1] *= a0;
        o[dt][2] *= a1;
        o[dt][3] *= a1;
      }
      // P (rounded to bf16, as the TPU kernel feeds its PV matmul) . V
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
        for (int p = 0; p < D / 16; ++p) {
          uint32_t vf[4];
          load_b_cols<D>(vf, sVb, j * 16, p, lane);
          mma_16816(o[2 * p], pa, vf[0], vf[1]);
          mma_16816(o[2 * p + 1], pa, vf[2], vf[3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
  if (!active) return;

#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < NT; ++dt) {
    o[dt][0] *= inv0;
    o[dt][1] *= inv0;
    o[dt][2] *= inv1;
    o[dt][3] *= inv1;
  }
  store_rows<D>(out + off, stride, q0 + wr, L, o, lane);
  if (lse != nullptr && t == 0) {
    float* lb = lse + ((size_t)b * heads + h) * L;
    const int row0 = q0 + wr + gr, row1 = row0 + 8;
    if (row0 < L) lb[row0] = m0 + logf(l0);
    if (row1 < L) lb[row1] = m1 + logf(l1);
  }
}

// ------------------------------------------------------------ K9b: dq

template <int D>
__host__ __device__ inline size_t dq_smem(int g) {
  return (size_t)6 * BT * Geo<D>::LD * 2 + (size_t)2 * BT * g * 4 + BT * 4
         + (size_t)2 * BT * 4 * odd_pitch(g) * 4;
}

// di[r] = sum_c o[r][c] * do[r][c] for the tile's BT rows (row r0 + r of
// the band; do already in smem at sdO); rows at or past L get 0. Four
// lanes per row; BT * 4 is a multiple of 32, so each warp runs the loop
// whole and the shuffles see all their lanes.
template <int D>
__device__ __forceinline__ void row_delta(float* sD, const bf16* o,
                                          const bf16* sdO, int stride, int r0,
                                          int L, int tid) {
  constexpr int PART = D / 4;
  for (int i = tid; i < BT * 4; i += THREADS) {
    const int r = i >> 2, part = (i & 3) * PART;
    float acc = 0.f;
    if (r0 + r < L) {
      const bf16* orow = o + (size_t)(r0 + r) * stride + part;
      const bf16* drow = sdO + r * Geo<D>::LD + part;
#pragma unroll
      for (int c = 0; c < PART; c += 8) {
        uint4 ou = *reinterpret_cast<const uint4*>(orow + c);
        uint4 du = *reinterpret_cast<const uint4*>(drow + c);
        const bf16* oe = reinterpret_cast<const bf16*>(&ou);
        const bf16* de = reinterpret_cast<const bf16*>(&du);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc += __bfloat162float(oe[e]) * __bfloat162float(de[e]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if ((i & 3) == 0) sD[r] = acc;
  }
}

// grid (query tiles, heads, batch). Writes dq, drel_h, drel_w and di
// [B, h, L] f32 (read by the dkv kernel).
template <int D>
__global__ void __launch_bounds__(THREADS)
bot_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const bf16* __restrict__ dout,
                  const float* __restrict__ rel_h,
                  const float* __restrict__ rel_w,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  bf16* __restrict__ dq, float* __restrict__ drel_h,
                  float* __restrict__ drel_w, int L, int heads, int g,
                  float inv_g) {
  constexpr int LD = Geo<D>::LD, KS = Geo<D>::KS, NT = Geo<D>::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + BT * LD;
  bf16* sK = sdO + BT * LD;                 // [2][BT * LD]
  bf16* sV = sK + 2 * BT * LD;              // [2][BT * LD]
  float* sRh = reinterpret_cast<float*>(sV + 2 * BT * LD);   // [BT][g]
  float* sRw = sRh + BT * g;
  float* sD = sRw + BT * g;                                   // [BT]
  // per (row, lane of the row's quad) partial bins, pitch gp: each entry is
  // owned by one thread, so no two threads add into it
  const int gp = odd_pitch(g);
  float* sAh = sD + BT;                                       // [BT][4][gp]
  float* sAw = sAh + BT * 4 * gp;

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int stride = heads * D;
  const size_t off = (size_t)b * L * stride + h * D;
  const size_t roff = ((size_t)b * heads + h) * L * g;
  const size_t soff = ((size_t)b * heads + h) * L;

  load_band<D>(sQ, q + off, stride, q0, L, tid);
  load_band<D>(sdO, dout + off, stride, q0, L, tid);
  load_band<D>(sK, k + off, stride, 0, L, tid);
  load_band<D>(sV, v + off, stride, 0, L, tid);
  load_rel(sRh, rel_h + roff, q0, L, g, tid);
  load_rel(sRw, rel_w + roff, q0, L, g, tid);
  cp_async_commit();
  for (int i = tid; i < 2 * BT * 4 * gp; i += THREADS) sAh[i] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  row_delta<D>(sD, o + off, sdO, stride, q0, L, tid);
  __syncthreads();
  if (tid < BT && q0 + tid < L) delta[soff + q0 + tid] = sD[tid];

  const int wr = warp * 16;
  const bool active = q0 + wr < L;
  const int r0 = wr + gr, r1 = r0 + 8;          // the lane's rows in the tile
  const float l0 = q0 + r0 < L ? lse[soff + q0 + r0] : INFINITY;
  const float l1 = q0 + r1 < L ? lse[soff + q0 + r1] : INFINITY;
  const float d0 = sD[r0], d1 = sD[r1];
  const float* rh0 = sRh + r0 * g;
  const float* rh1 = sRh + r1 * g;
  const float* rw0 = sRw + r0 * g;
  const float* rw1 = sRw + r1 * g;
  float* ah0 = sAh + (r0 * 4 + t) * gp;
  float* ah1 = sAh + (r1 * 4 + t) * gp;
  float* aw0 = sAw + (r0 * 4 + t) * gp;
  float* aw1 = sAw + (r1 * 4 + t) * gp;
  float adq[NT][4];
  zero(adq);

  for (int it = 0, k0 = 0; k0 < L; ++it, k0 += BT) {
    const int buf = it & 1;
    if (k0 + BT < L) {
      load_band<D>(sK + (buf ^ 1) * BT * LD, k + off, stride, k0 + BT, L, tid);
      load_band<D>(sV + (buf ^ 1) * BT * LD, v + off, stride, k0 + BT, L, tid);
    }
    cp_async_commit();
    const bf16* sKb = sK + buf * BT * LD;
    const bf16* sVb = sV + buf * BT * LD;

    if (active) {
      float s[8][4], dp[8][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4], da[4];
        load_a<D>(qa, sQ, wr, kk, lane);
        load_a<D>(da, sdO, wr, kk, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bb[4];
          load_b_rows<D>(bb, sKb, j * 16, kk, lane);     // s = Q_w K^T
          mma_16816(s[2 * j], qa, bb[0], bb[1]);
          mma_16816(s[2 * j + 1], qa, bb[2], bb[3]);
          load_b_rows<D>(bb, sVb, j * 16, kk, lane);     // dp = dO_w V^T
          mma_16816(dp[2 * j], da, bb[0], bb[1]);
          mma_16816(dp[2 * j + 1], da, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = k0 + nt * 8 + 2 * t + e;
          if (j < L) {
            int hb, wb;
            grid_cell(j, g, inv_g, hb, wb);
            const float p0 = exp2f((s[nt][e] + rh0[hb] + rw0[wb] - l0) * kLog2e);
            const float p1 =
                exp2f((s[nt][2 + e] + rh1[hb] + rw1[wb] - l1) * kLog2e);
            const float ds0 = (dp[nt][e] - d0) * p0;
            const float ds1 = (dp[nt][2 + e] - d1) * p1;
            ah0[hb] += ds0;
            aw0[wb] += ds0;
            ah1[hb] += ds1;
            aw1[wb] += ds1;
            s[nt][e] = ds0;
            s[nt][2 + e] = ds1;
          } else {
            s[nt][e] = 0.f;
            s[nt][2 + e] = 0.f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {                   // dq += bf16(dS) K
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
        for (int p = 0; p < D / 16; ++p) {
          uint32_t bb[4];
          load_b_cols<D>(bb, sKb, j * 16, p, lane);
          mma_16816(adq[2 * p], a, bb[0], bb[1]);
          mma_16816(adq[2 * p + 1], a, bb[2], bb[3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
  if (!active) return;
  store_rows<D>(dq + off, stride, q0 + wr, L, adq, lane);
  // the warp's rows are complete in sAh/sAw: sum each row's four partials
  // in the order t = 0..3
  __syncwarp();
  for (int i = lane; i < 16 * g; i += 32) {
    const int r = wr + i / g, bin = i % g;
    if (q0 + r >= L) continue;
    const float* ph = sAh + r * 4 * gp + bin;
    const float* pw = sAw + r * 4 * gp + bin;
    const size_t at = roff + (size_t)(q0 + r) * g + bin;
    drel_h[at] = ((ph[0] + ph[gp]) + ph[2 * gp]) + ph[3 * gp];
    drel_w[at] = ((pw[0] + pw[gp]) + pw[2 * gp]) + pw[3 * gp];
  }
}

// ----------------------------------------------------------- K9b: dkv

template <int D>
__host__ __device__ inline size_t dkv_smem(int g) {
  return (size_t)6 * BT * Geo<D>::LD * 2 + (size_t)4 * BT * g * 4
         + (size_t)4 * BT * 4;
}

// grid (key tiles, heads, batch); reads the di the dq kernel wrote.
template <int D>
__global__ void __launch_bounds__(THREADS)
bot_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ rel_h,
                   const float* __restrict__ rel_w,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int L, int heads, int g,
                   float inv_g) {
  constexpr int LD = Geo<D>::LD, KS = Geo<D>::KS, NT = Geo<D>::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BT * LD;
  bf16* sQ = sV + BT * LD;                  // [2][BT * LD]
  bf16* sdO = sQ + 2 * BT * LD;             // [2][BT * LD]
  float* sRh = reinterpret_cast<float*>(sdO + 2 * BT * LD);  // [2][BT * g]
  float* sRw = sRh + 2 * BT * g;                              // [2][BT * g]
  float* sL = sRw + 2 * BT * g;                               // [2][BT]
  float* sD = sL + 2 * BT;                                    // [2][BT]

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int stride = heads * D;
  const size_t off = (size_t)b * L * stride + h * D;
  const size_t roff = ((size_t)b * heads + h) * L * g;
  const size_t soff = ((size_t)b * heads + h) * L;

  // query rows past L: lse = +inf makes p = 0, so they add nothing
  auto load_q_tile = [&](int r0, int buf) {
    load_band<D>(sQ + buf * BT * LD, q + off, stride, r0, L, tid);
    load_band<D>(sdO + buf * BT * LD, dout + off, stride, r0, L, tid);
    load_rel(sRh + buf * BT * g, rel_h + roff, r0, L, g, tid);
    load_rel(sRw + buf * BT * g, rel_w + roff, r0, L, g, tid);
    if (tid < BT) {
      const bool in = r0 + tid < L;
      sL[buf * BT + tid] = in ? lse[soff + r0 + tid] : INFINITY;
      sD[buf * BT + tid] = in ? delta[soff + r0 + tid] : 0.f;
    }
  };
  load_band<D>(sK, k + off, stride, k0, L, tid);
  load_band<D>(sV, v + off, stride, k0, L, tid);
  load_q_tile(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int wr = warp * 16;
  const bool active = k0 + wr < L;
  // the lane's two key rows and their grid cells
  const int j0 = k0 + wr + gr, j1 = j0 + 8;
  const bool ok0 = j0 < L, ok1 = j1 < L;
  int hb0 = 0, wb0 = 0, hb1 = 0, wb1 = 0;
  if (ok0) grid_cell(j0, g, inv_g, hb0, wb0);
  if (ok1) grid_cell(j1, g, inv_g, hb1, wb1);
  float adk[NT][4], adv[NT][4];
  zero(adk);
  zero(adv);

  for (int it = 0, r0 = 0; r0 < L; ++it, r0 += BT) {
    const int buf = it & 1;
    if (r0 + BT < L) load_q_tile(r0 + BT, buf ^ 1);
    cp_async_commit();
    const bf16* sQb = sQ + buf * BT * LD;
    const bf16* sdOb = sdO + buf * BT * LD;
    const float* sRhb = sRh + buf * BT * g;
    const float* sRwb = sRw + buf * BT * g;
    const float* sLb = sL + buf * BT;
    const float* sDb = sD + buf * BT;

    if (active) {
#pragma unroll 1
      for (int c = 0; c < BT; c += 16) {
        float st[2][4], dpt[2][4];
        zero(st);
        zero(dpt);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t a[4], bb[4];
          load_a<D>(a, sK, wr, kk, lane);
          load_b_rows<D>(bb, sQb, c, kk, lane);     // s^T = K_w Q^T
          mma_16816(st[0], a, bb[0], bb[1]);
          mma_16816(st[1], a, bb[2], bb[3]);
          load_a<D>(a, sV, wr, kk, lane);
          load_b_rows<D>(bb, sdOb, c, kk, lane);    // dp^T = V_w dO^T
          mma_16816(dpt[0], a, bb[0], bb[1]);
          mma_16816(dpt[1], a, bb[2], bb[3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = c + n * 8 + 2 * t + (e & 1);   // query in the tile
            const bool ok = e < 2 ? ok0 : ok1;
            float p = 0.f;
            if (ok) {
              const int hb = e < 2 ? hb0 : hb1, wb = e < 2 ? wb0 : wb1;
              p = exp2f((st[n][e] + sRhb[qi * g + hb] + sRwb[qi * g + wb]
                         - sLb[qi]) * kLog2e);
            }
            st[n][e] = p;
            dpt[n][e] = (dpt[n][e] - sDb[qi]) * p;
          }
        }
        uint32_t pa[4], dsa[4];
        pa[0] = pack_bf16(st[0][0], st[0][1]);
        pa[1] = pack_bf16(st[0][2], st[0][3]);
        pa[2] = pack_bf16(st[1][0], st[1][1]);
        pa[3] = pack_bf16(st[1][2], st[1][3]);
        dsa[0] = pack_bf16(dpt[0][0], dpt[0][1]);
        dsa[1] = pack_bf16(dpt[0][2], dpt[0][3]);
        dsa[2] = pack_bf16(dpt[1][0], dpt[1][1]);
        dsa[3] = pack_bf16(dpt[1][2], dpt[1][3]);
#pragma unroll
        for (int p = 0; p < D / 16; ++p) {
          uint32_t bb[4];
          load_b_cols<D>(bb, sdOb, c, p, lane);     // dv += bf16(P)^T dO
          mma_16816(adv[2 * p], pa, bb[0], bb[1]);
          mma_16816(adv[2 * p + 1], pa, bb[2], bb[3]);
          load_b_cols<D>(bb, sQb, c, p, lane);      // dk += bf16(dS)^T Q
          mma_16816(adk[2 * p], dsa, bb[0], bb[1]);
          mma_16816(adk[2 * p + 1], dsa, bb[2], bb[3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
  if (!active) return;
  store_rows<D>(dk + off, stride, k0 + wr, L, adk, lane);
  store_rows<D>(dv + off, stride, k0 + wr, L, adv, lane);
}

// ------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, const float* rel_h,
        const float* rel_w, void* out, float* lse, int batch, int L,
        int heads, int g, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>(g);
  cudaError_t err = prepare(bot_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  bot_fwd_kernel<D><<<dim3((L + BT - 1) / BT, heads, batch), THREADS, smem,
                      stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, rel_h, rel_w,
      (bf16*)out, lse, L, heads, g, 1.f / (float)g);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* rel_h, const float* rel_w,
           const float* lse, float* delta, void* dq, float* drel_h,
           float* drel_w, int batch, int L, int heads, int g,
           cudaStream_t stream) {
  const size_t smem = dq_smem<D>(g);
  cudaError_t err = prepare(bot_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  bot_bwd_dq_kernel<D><<<dim3((L + BT - 1) / BT, heads, batch), THREADS, smem,
                         stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const bf16*)dout, rel_h, rel_w, lse, delta, (bf16*)dq, drel_h, drel_w,
      L, heads, g, 1.f / (float)g);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* rel_h, const float* rel_w, const float* lse,
            const float* delta, void* dk, void* dv, int batch, int L,
            int heads, int g, cudaStream_t stream) {
  const size_t smem = dkv_smem<D>(g);
  cudaError_t err = prepare(bot_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  bot_bwd_dkv_kernel<D><<<dim3((L + BT - 1) / BT, heads, batch), THREADS,
                          smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      rel_h, rel_w, lse, delta, (bf16*)dk, (bf16*)dv, L, heads, g,
      1.f / (float)g);
  return (int)cudaGetLastError();
}

}  // namespace bot
}  // namespace sav

// Shared memory of kernel `which` (0: K9a, 1: K9b's dq kernel, 2: its dkv
// kernel) at grid side g and head width d, or 0 where it cannot run (d not
// 64 or 128, g < 1, or beyond a block's shared memory).
extern "C" int sav_bot_smem(int which, int g, int d) {
  using namespace sav::bot;
  if (g < 1 || (d != 64 && d != 128)) return 0;
  size_t bytes;
  if (d == 64)
    bytes = which == 0 ? fwd_smem<64>(g) : which == 1 ? dq_smem<64>(g)
                                                      : dkv_smem<64>(g);
  else
    bytes = which == 0 ? fwd_smem<128>(g) : which == 1 ? dq_smem<128>(g)
                                                       : dkv_smem<128>(g);
  return bytes > (size_t)SMEM_LIMIT ? 0 : (int)bytes;
}

// q (pre-scaled), k, v, out [B, L, h*d] bf16; rel_h, rel_w [B, h, L, g]
// f32; lse [B, h, L] f32 or null (serving).
extern "C" int sav_bot_fwd(const void* q, const void* k, const void* v,
                           const float* rel_h, const float* rel_w, void* out,
                           float* lse, int batch, int L, int heads, int g,
                           int d, void* stream) {
  using namespace sav::bot;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64) return fwd<64>(q, k, v, rel_h, rel_w, out, lse, batch, L, heads, g, s);
  if (d == 128) return fwd<128>(q, k, v, rel_h, rel_w, out, lse, batch, L, heads, g, s);
  return (int)cudaErrorInvalidValue;
}

// dq [B, L, h*d] bf16, drel_h/drel_w [B, h, L, g] f32 and di [B, h, L] f32
// from the forward's inputs, its out and lse, and the cotangent dout.
extern "C" int sav_bot_bwd_dq(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* rel_h, const float* rel_w,
                              const float* lse, float* delta, void* dq,
                              float* drel_h, float* drel_w, int batch, int L,
                              int heads, int g, int d, void* stream) {
  using namespace sav::bot;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return bwd_dq<64>(q, k, v, o, dout, rel_h, rel_w, lse, delta, dq, drel_h,
                      drel_w, batch, L, heads, g, s);
  if (d == 128)
    return bwd_dq<128>(q, k, v, o, dout, rel_h, rel_w, lse, delta, dq, drel_h,
                       drel_w, batch, L, heads, g, s);
  return (int)cudaErrorInvalidValue;
}

// dk, dv [B, L, h*d] bf16 from the di that sav_bot_bwd_dq wrote.
extern "C" int sav_bot_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* rel_h,
                               const float* rel_w, const float* lse,
                               const float* delta, void* dk, void* dv,
                               int batch, int L, int heads, int g, int d,
                               void* stream) {
  using namespace sav::bot;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return bwd_dkv<64>(q, k, v, dout, rel_h, rel_w, lse, delta, dk, dv, batch,
                       L, heads, g, s);
  if (d == 128)
    return bwd_dkv<128>(q, k, v, dout, rel_h, rel_w, lse, delta, dk, dv, batch,
                        L, heads, g, s);
  return (int)cudaErrorInvalidValue;
}
