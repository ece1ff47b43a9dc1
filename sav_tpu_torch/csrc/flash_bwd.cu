// K2 port: the flash attention backward in one launch.
//
// Replaces sav_tpu/ops/flash_attention.py::_fused_bwd_kernel (the
// single-block branch of _bwd). Same function as K3 (flash_bwd_split.cu,
// which takes the longer heads): q (pre-scaled), k, v, o, do as
// [B, L, H*64] bf16 head bands, lse [B, H, Lq] f32 from the forward; per
// head
//   p  = exp(q k^T - lse)          (f32; keys past kv_len masked to -inf)
//   d  = rowsum(o * do)            (f32 from o and do in bf16)
//   dv = bf16(p)^T do
//   ds = bf16(p * (do v^T - d))
//   dq = ds k,  dk = ds^T q
// with f32 accumulation, outputs in bf16, rounded where the TPU kernels
// round. Query rows past q_len are loaded as zeros (with lse = +inf, so
// p = 0) and never stored, so they add nothing to dk and dv (the TPU
// wrapper zeroes do there for the same reason). Key rows past kv_len are
// loaded as zeros and their logits are masked; their dk and dv rows come
// out as exact zeros. No tail row is dropped: every row count is rounded
// up to the 16-row mma tile and masked, never divided into blocks.
//
// Bound on the card: the function is 10*L*L*d operations against 8 band
// tensors of L*d bf16 per (image, head), ~80 operations per byte at
// L = 197 (under the H100's ~295), so a kernel that reads each operand
// once is bound by bytes. In practice mma.sync's instruction rate and the
// exp/select work on the CUDA cores bound it first.
//
// Design: one block per (head, image) holds q, k, v, do of its head
// (4 x L16 x 64 bf16) and lse/delta in shared memory, plus ds^T (L16 x L16
// bf16), so dq, dk, dv come out of ONE launch with no atomics and every
// operand read from device memory once. Phase A: each warp owns 16 key rows
// and walks the queries 16 at a time, accumulating dv and dk in registers
// and writing its ds^T rows to shared memory. Phase B: each warp owns 16
// query rows and forms dq = ds k from the stored ds. 10*L*L*d operations,
// nothing recomputed. Shared memory bounds it: at L16 = 208 it needs 211 KB
// of the 227 KB a block may have (ViT @224, L = 197), at L16 = 224 it would
// need 229 KB, so flash_bwd_fused_smem() decides K2 vs K3; one block per
// SM, one warp per 16-row tile (up to 13 warps).
#include <math.h>

#include "mma.cuh"

namespace sav {

constexpr int BD = 64;              // head width
constexpr int BLD = BD + 8;         // padded smem row: conflict-free ldmatrix
constexpr int K2_MAX_WARPS = 13;    // one warp per 16-row tile, L16 <= 208
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory one block may use
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// Rows [r0, r0 + rows) of one head band -> smem (row pitch BLD); rows at or
// past `valid` are zero-filled (src-size 0, clamped address).
__device__ __forceinline__ void load_band(bf16* dst, const bf16* src,
                                          int stride, int r0, int rows,
                                          int valid, int tid, int nthreads) {
  for (int i = tid; i < rows * 8; i += nthreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool in = r0 + r < valid;
    cp_async_16(&dst[r * BLD + c],
                src + (size_t)(in ? r0 + r : 0) * stride + c, in ? 16 : 0);
  }
}

// A fragments of the 16 x 64 tile at smem row r (4 depth steps of 16).
__device__ __forceinline__ void load_a(uint32_t (&f)[4][4], const bf16* s,
                                       int r, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(f[kk], &s[(r + (lane & 15)) * BLD + kk * 16 + (lane >> 4) * 8]);
}

// B fragments for X . Y^T with Y's rows r..r+15 in smem as the n axis and
// depth step kk: b[0..1] for rows r..r+7, b[2..3] for rows r+8..r+15.
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* s,
                                            int r, int kk, int lane) {
  ldmatrix_x4(b, &s[(r + (lane & 7) + ((lane >> 4) << 3)) * BLD + kk * 16
                    + ((lane >> 3) & 1) * 8]);
}

// B fragments for X . Y with Y's rows r..r+15 in smem as the depth axis and
// columns p*16..p*16+15 as n: b[0..1] for columns p*16.., b[2..3] for +8.
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* s,
                                            int r, int p, int lane) {
  ldmatrix_x4_trans(b, &s[(r + (lane & 7) + ((lane >> 3) & 1) * 8) * BLD
                          + p * 16 + (lane >> 4) * 8]);
}

// 16 x 64 C accumulator -> bf16 rows r0.. of a head band (rows >= valid
// are not stored).
__device__ __forceinline__ void store_rows(bf16* dst, int stride, int r0,
                                           int valid, const float (&acc)[8][4],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int row0 = r0 + g, row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    if (row0 < valid)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row0 * stride + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][0], acc[dt][1]);
    if (row1 < valid)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row1 * stride + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// One warp owning 16 key rows (A fragments kf of K, vf of V; ok0/ok1: its
// rows g and g+8 are below kv_len) against the 16 queries at smem row c of
// sQ/sdO, whose lse and delta sit at sL[c..], sD[c..]. Adds bf16(p)^T do to
// dv and ds^T q to dk; returns ds^T packed as an A fragment (dsa[0]: row g,
// columns c+2t..; [1]: row g+8; [2]/[3]: columns c+8+2t..).
__device__ __forceinline__ void key_rows_step(
    const uint32_t (&kf)[4][4], const uint32_t (&vf)[4][4], const bf16* sQ,
    const bf16* sdO, const float* sL, const float* sD, int c, bool ok0,
    bool ok1, float (&dv)[8][4], float (&dk)[8][4], uint32_t (&dsa)[4],
    int lane) {
  const int t = lane & 3;
  float st[2][4], dpt[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
    st[n][0] = st[n][1] = st[n][2] = st[n][3] =
        dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t b[4];
    load_b_rows(b, sQ, c, kk, lane);          // s^T = K_w Q^T
    mma_16816(st[0], kf[kk], b[0], b[1]);
    mma_16816(st[1], kf[kk], b[2], b[3]);
    load_b_rows(b, sdO, c, kk, lane);         // dp^T = V_w dO^T
    mma_16816(dpt[0], vf[kk], b[0], b[1]);
    mma_16816(dpt[1], vf[kk], b[2], b[3]);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = c + n * 8 + 2 * t + (e & 1);
      const bool ok = e < 2 ? ok0 : ok1;
      const float p = ok ? exp2f((st[n][e] - sL[q]) * kLog2e) : 0.f;
      st[n][e] = p;
      dpt[n][e] = p * (dpt[n][e] - sD[q]);
    }
  }
  uint32_t pa[4];
  pa[0] = pack_bf16(st[0][0], st[0][1]);
  pa[1] = pack_bf16(st[0][2], st[0][3]);
  pa[2] = pack_bf16(st[1][0], st[1][1]);
  pa[3] = pack_bf16(st[1][2], st[1][3]);
  dsa[0] = pack_bf16(dpt[0][0], dpt[0][1]);
  dsa[1] = pack_bf16(dpt[0][2], dpt[0][3]);
  dsa[2] = pack_bf16(dpt[1][0], dpt[1][1]);
  dsa[3] = pack_bf16(dpt[1][2], dpt[1][3]);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    uint32_t b[4];
    load_b_cols(b, sdO, c, p, lane);          // dv += P^T dO
    mma_16816(dv[2 * p], pa, b[0], b[1]);
    mma_16816(dv[2 * p + 1], pa, b[2], b[3]);
    load_b_cols(b, sQ, c, p, lane);           // dk += dS^T Q
    mma_16816(dk[2 * p], dsa, b[0], b[1]);
    mma_16816(dk[2 * p + 1], dsa, b[2], b[3]);
  }
}

// delta[r] = sum_c o[r][c] * do[r][c] for `rows` rows (row r0 + r of the
// band; do already in smem at sdO); rows at or past q_len get 0. Four
// lanes per row; `rows * 4` is a multiple of 32, so each warp runs the loop
// whole and the shuffles see all their lanes.
__device__ __forceinline__ void row_delta(float* sD, const bf16* o,
                                          const bf16* sdO, int stride, int r0,
                                          int rows, int q_len, int tid,
                                          int nthreads) {
  for (int i = tid; i < rows * 4; i += nthreads) {
    const int r = i >> 2, part = (i & 3) * 16;
    float acc = 0.f;
    if (r0 + r < q_len) {
      const bf16* orow = o + (size_t)(r0 + r) * stride + part;
      const bf16* drow = sdO + r * BLD + part;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint4 ou = *reinterpret_cast<const uint4*>(orow + h * 8);
        uint4 du = *reinterpret_cast<const uint4*>(drow + h * 8);
        const bf16* oe = reinterpret_cast<const bf16*>(&ou);
        const bf16* de = reinterpret_cast<const bf16*>(&du);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc += __bfloat162float(oe[j]) * __bfloat162float(de[j]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if ((i & 3) == 0) sD[r] = acc;
  }
}

__host__ __device__ inline size_t fused_smem_bytes(int lq16, int lk16) {
  return (size_t)(2 * lq16 + 2 * lk16) * BLD * 2 + (size_t)lk16 * (lq16 + 8) * 2
         + (size_t)2 * lq16 * 4;
}

// K2: grid (heads, batch), one warp per 16-row tile of the longer side.
__global__ void __launch_bounds__(K2_MAX_WARPS * 32, 1)
flash_bwd_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse, bf16* __restrict__ dq,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int q_len,
                       int kv_rows, int kv_len, int heads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lq16 = round16(q_len), lk16 = round16(kv_rows);
  const int lds = lq16 + 8;                 // ds^T row pitch
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + lq16 * BLD;
  bf16* sK = sdO + lq16 * BLD;
  bf16* sV = sK + lk16 * BLD;
  bf16* sDS = sV + lk16 * BLD;              // [lk16][lds]: ds^T
  float* sL = reinterpret_cast<float*>(sDS + lk16 * lds);
  float* sD = sL + lq16;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int stride = heads * BD;
  const size_t qoff = (size_t)b * q_len * stride + h * BD;
  const size_t koff = (size_t)b * kv_rows * stride + h * BD;

  load_band(sQ, q + qoff, stride, 0, lq16, q_len, tid, nthreads);
  load_band(sdO, dout + qoff, stride, 0, lq16, q_len, tid, nthreads);
  load_band(sK, k + koff, stride, 0, lk16, kv_len, tid, nthreads);
  load_band(sV, v + koff, stride, 0, lk16, kv_len, tid, nthreads);
  cp_async_commit();
  const float* lb = lse + ((size_t)b * heads + h) * q_len;
  for (int i = tid; i < lq16; i += nthreads) sL[i] = i < q_len ? lb[i] : INFINITY;
  cp_async_wait<0>();
  __syncthreads();
  row_delta(sD, o + qoff, sdO, stride, 0, lq16, q_len, tid, nthreads);
  __syncthreads();

  // phase A: 16 key rows per warp -> dk, dv, and ds^T into shared memory
  for (int kr = warp * 16; kr < lk16; kr += nwarps * 16) {
    uint32_t kf[4][4], vf[4][4];
    load_a(kf, sK, kr, lane);
    load_a(vf, sV, kr, lane);
    const bool ok0 = kr + g < kv_len, ok1 = kr + g + 8 < kv_len;
    float adv[8][4], adk[8][4];
    zero(adv);
    zero(adk);
    for (int c = 0; c < lq16; c += 16) {
      uint32_t dsa[4];
      key_rows_step(kf, vf, sQ, sdO, sL, sD, c, ok0, ok1, adv, adk, dsa, lane);
      bf16* r0 = sDS + (kr + g) * lds + c + 2 * t;
      bf16* r1 = r0 + 8 * lds;
      *reinterpret_cast<uint32_t*>(r0) = dsa[0];
      *reinterpret_cast<uint32_t*>(r1) = dsa[1];
      *reinterpret_cast<uint32_t*>(r0 + 8) = dsa[2];
      *reinterpret_cast<uint32_t*>(r1 + 8) = dsa[3];
    }
    store_rows(dk + koff, stride, kr, kv_rows, adk, lane);
    store_rows(dv + koff, stride, kr, kv_rows, adv, lane);
  }
  __syncthreads();

  // phase B: 16 query rows per warp, dq = ds k from the stored ds^T
  for (int qr = warp * 16; qr < lq16; qr += nwarps * 16) {
    float adq[8][4];
    zero(adq);
    for (int j = 0; j < lk16; j += 16) {
      // A = ds[qr.., j..] read transposed out of ds^T[j.., qr..]
      uint32_t a[4];
      ldmatrix_x4_trans(a, &sDS[(j + (lane & 7) + ((lane >> 4) & 1) * 8) * lds
                                + qr + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bb[4];
        load_b_cols(bb, sK, j, p, lane);
        mma_16816(adq[2 * p], a, bb[0], bb[1]);
        mma_16816(adq[2 * p + 1], a, bb[2], bb[3]);
      }
    }
    store_rows(dq + qoff, stride, qr, q_len, adq, lane);
  }
}

}  // namespace sav

// Shared memory K2 needs at these lengths, or 0 where K2 cannot run (more
// than K2_MAX_WARPS 16-row tiles, or beyond a block's shared memory).
extern "C" int sav_flash_bwd_fused_smem(int q_len, int kv_rows) {
  using namespace sav;
  const int lq16 = round16(q_len), lk16 = round16(kv_rows);
  const size_t bytes = fused_smem_bytes(lq16, lk16);
  const int tiles = (lq16 > lk16 ? lq16 : lk16) / 16;
  return (tiles > K2_MAX_WARPS || bytes > (size_t)SMEM_LIMIT) ? 0 : (int)bytes;
}

// q, o, dout, dq [B, q_len, H*64]; k, v, dk, dv [B, kv_rows, H*64]; lse
// [B, H, q_len] f32. All bf16 unless noted.
extern "C" int sav_flash_bwd_fused(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, void* dq, void* dk,
                                   void* dv, int batch, int q_len, int kv_rows,
                                   int kv_len, int heads, void* stream) {
  using namespace sav;
  const int smem = sav_flash_bwd_fused_smem(q_len, kv_rows);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int lq16 = round16(q_len), lk16 = round16(kv_rows);
  const int warps = (lq16 > lk16 ? lq16 : lk16) / 16;
  flash_bwd_fused_kernel<<<dim3(heads, batch), warps * 32, smem,
                           (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const bf16*)dout, lse, (bf16*)dq, (bf16*)dk, (bf16*)dv, q_len, kv_rows,
      kv_len, heads);
  return (int)cudaGetLastError();
}
