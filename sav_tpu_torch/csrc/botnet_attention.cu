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
// under the H100's ~295 bf16 operations per byte, so bound by bytes.
// K9a's mma.sync instruction rate and the per-logit bias, exp and masking
// work on the CUDA cores bound it first; K9b's bias, exp and drel sums on
// the CUDA cores beside its wgmma products.
//
// Design. d is a template parameter (64 or 128); the ragged edge is masked
// in the kernels (rows past L read as zeros and are never stored).
//  * K9a (bot_fwd_kernel, mma.sync): one block of 4 warps per (64-query
//    tile, head, image), as the K4 port was first written: each warp owns
//    16 query rows and sweeps the keys in 64-row tiles with an online
//    softmax; K/V double-buffered with cp.async. The block's rel_h/rel_w
//    rows (64 x g f32 each) sit in shared memory and each logit fragment
//    gets its bias added in registers.
//  * K9b as two persistent wgmma + TMA kernels on K3's split
//    (flash_bwd_split.cu), so every sum runs in a fixed order with no
//    float atomics (two calls give identical bits); 384 threads, a
//    producer warpgroup (thread 0 issues the TMA loads, all 128 copy the
//    rel rows by cp.async into the same mbarrier's phase) and two consumer
//    warpgroups of 64 rows:
//    - bot_bwd_dq_kernel: a unit is (128-query tile, head, image); Q, dO
//      and O (for delta, written for the dkv kernel) resident, K and V
//      tiles through a TMA ring. s = Q K^T and dp = dO V^T on wgmma with
//      both operands in shared memory (at d = 128 the registers hold the
//      accumulators, not the operands), the bias added to the fragments
//      from the resident rel rows (j / g by a float reciprocal), ds formed
//      in registers and fed to dq += bf16(ds) K as the register A operand;
//      while that product runs, the warpgroup's f32 ds tile (shared
//      memory) gives the drel sums: drel_h a running sum over each grid
//      row's runs of keys, drel_w bin by bin (each bin's keys of a tile
//      summed in a register, then added to the bin in shared memory).
//    - bot_bwd_dkv_kernel: a unit is (128-key tile, head, image); K and V
//      resident, each query tile's Q, dO, rel rows, lse and delta through
//      the ring; s^T and dp^T on wgmma, dv += bf16(p^T) dO and dk +=
//      bf16(ds^T) Q with p^T and ds^T as register A operands, dk and dv
//      in registers (setmaxnreg gives the consumers 232 a thread).
//    The split recomputes s and dp once more: 14*L*L*d operations for the
//    10*L*L*d of the function.
#include <math.h>

#include "flash_sm90.cuh"
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

// The rel rows' pitch in shared memory: odd, so rows fall in other banks.
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

}  // namespace bot
}  // namespace sav


// ------------------------------------------------------------------ K9b

namespace sav {
namespace botb {

using namespace flash;
using bot::grid_cell;
using bot::odd_pitch;

constexpr int BLOCK_ROWS = 128;           // rows of a work unit (2 x 64)
constexpr int MAX_STAGES = 4;             // ring slots
constexpr int BOX = TILE_BYTES;           // a 64 x 64 bf16 box
constexpr int DSP = 65;                   // f32 pitch of a ds tile row
constexpr int SMEM_LIMIT = 232448;
constexpr int DQ_PRODUCER_REGS = 56;      // 128 x 56 + 256 x 224 <= 65536
constexpr int DQ_CONSUMER_REGS = 224;
constexpr int DKV_PRODUCER_REGS = 40;     // 40 + 2 x 232 = 3 x 168
constexpr int DKV_CONSUMER_REGS = 232;

__host__ __device__ inline int round1024(int n) {
  return (n + 1023) / 1024 * 1024;
}

// The mbarrier's phase also waits for this thread's cp.async copies: one
// of its expected arrivals, made when they have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Rows [r0, r0 + rows) of one (image, head) slice [L, g] f32 -> shared
// memory (g f32 a row) by 4-byte cp.async, one of the producer
// warpgroup's 128 threads (pt) a value at a time; rows past L are
// zero-filled. For odd g, whose rows do not start on 16-byte boundaries.
__device__ __forceinline__ void copy_rel(float* dst, const float* src,
                                         int r0, int rows, int L, int g,
                                         int pt) {
  const int valid = (L - r0 < rows ? L - r0 : rows) * g;
  const float* base = src + (size_t)r0 * g;
  for (int i = pt; i < rows * g; i += 128) {
    const bool in = i < valid;
    bot::cp_async_4(dst + i, in ? base + i : src, in ? 4 : 0);
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned src -> dst by one bulk
// copy, completing that many bytes of the barrier's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Even g: an (image, head) slice's rows (g^3 f32, a multiple of 32 bytes
// apart), a 64-row tile's (64 g f32) and L - r0 (a multiple of 4) rows of
// them all lie on 16-byte boundaries, as do lse's and delta's rows (g^2
// f32): thread 0 moves them by bulk copies. Odd g: the 128 producer
// threads by cp.async.
__host__ __device__ inline bool bulk_rows(int g) { return g % 2 == 0; }

// The dq kernel's shared memory at grid side g and head width d (bytes
// from a 1024-byte aligned base): Q and dO of a unit's 128 rows (d / 64
// boxes a 64-row half), the ring of K and V tiles, one region for O (the
// unit's delta) and later the two warpgroups' f32 ds tiles, the unit's
// rel_h and rel_w rows (g f32 a row, as in device memory), the drel_w bins
// of each warpgroup's 64 rows (pitch gp = g | 1: a warp's 32 rows in 32
// banks), delta, the mbarriers (res_full, res_empty, full[S], empty[S]).
// The most ring slots (<= 4) that fit; 0 where not even one does.
// Mirrored by bot_bwd_plan in ops/botnet_attention.py.
struct DqPlan {
  int nb, gp, stages;
  int off_do, off_ring, off_ods, off_rh, off_rw, off_bins, off_delta,
      off_bar, smem;
};

__host__ __device__ inline DqPlan dq_plan(int g, int d) {
  DqPlan p;
  p.nb = d / 64;
  p.gp = odd_pitch(g);
  const int res = 2 * p.nb * BOX;
  const int ods = res > 2 * 64 * DSP * 4 ? res : 2 * 64 * DSP * 4;
  for (int s = MAX_STAGES; s >= 1; --s) {
    p.stages = s;
    p.off_do = res;
    p.off_ring = 2 * res;
    p.off_ods = p.off_ring + s * 2 * p.nb * BOX;
    p.off_rh = p.off_ods + ods;
    p.off_rw = p.off_rh + BLOCK_ROWS * g * 4;
    p.off_bins = p.off_rw + BLOCK_ROWS * g * 4;
    p.off_delta = p.off_bins + 2 * 64 * p.gp * 4;
    p.off_bar = p.off_delta + BLOCK_ROWS * 4;
    p.smem = p.off_bar + (2 + 2 * s) * 8 + 1024;
    if (p.smem <= SMEM_LIMIT) return p;
  }
  p.stages = 0;
  return p;
}

// The dkv kernel's: K and V of a unit's 128 keys, then the ring, each slot
// (1024-byte aligned) a query tile's Q and dO boxes, its rel_h and rel_w
// rows (64 x g f32 each), lse and delta (64 f32 each), then the mbarriers.
// Mirrored by bot_bwd_plan.
struct DkvPlan {
  int nb, stages, slot, s_rh, s_rw, s_lse, s_di;
  int off_v, off_ring, off_bar, smem;
};

__host__ __device__ inline DkvPlan dkv_plan(int g, int d) {
  DkvPlan p;
  p.nb = d / 64;
  const int res = 2 * p.nb * BOX;
  p.s_rh = 2 * p.nb * BOX;
  p.s_rw = p.s_rh + 64 * g * 4;
  p.s_lse = p.s_rw + 64 * g * 4;
  p.s_di = p.s_lse + 64 * 4;
  p.slot = round1024(p.s_di + 64 * 4);
  p.off_v = res;
  p.off_ring = 2 * res;
  for (int s = MAX_STAGES; s >= 1; --s) {
    p.stages = s;
    p.off_bar = p.off_ring + s * p.slot;
    p.smem = p.off_bar + (2 + 2 * s) * 8 + 1024;
    if (p.smem <= SMEM_LIMIT) return p;
  }
  p.stages = 0;
  return p;
}

// d = A B^T over d / 16 steps (A: 64 rows from box 0 at desc a, B: W rows
// from box 0 at desc b, the depth's boxes BOX apart), one commit group.
template <int W, int NB>
__device__ __forceinline__ void ss_products(float (&d)[W / 2], uint64_t a,
                                            uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    const uint64_t off = (kk >> 2) * (BOX >> 4) + (kk & 3) * K_STEP;
    if constexpr (W == 64)
      wgmma_ss_k(d, a + off, b + off, kk);
    else
      wgmma_ss_k_n16(d, a + off, b + off, kk);
  }
  wgmma_commit();
}

// acc[c] += A Y_c for each 64-column box c of Y (W rows, MN-major; A the
// W-deep register operand), not committed.
template <int W, int NB>
__device__ __forceinline__ void rs_products(float (&acc)[NB][32],
                                            const uint32_t (&a)[W / 16][4],
                                            const bf16* y) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    const uint64_t yd = desc_mn_major(y + c * TILE_ELEMS);
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      wgmma_rs_mn(acc[c], a[kk], yd + kk * MN_STEP);
  }
}

// ---- the dq kernel: dq, drel_h, drel_w and delta

// The per-thread state of a consumer across a unit's key tiles.
struct DqRows {
  float l2a, l2b, da, db;                 // rows lrow, lrow + 8
  bool ok0, ok1;                          // below L (p = 0 past it)
  const float* rh0;
  const float* rh1;
  const float* rw0;
  const float* rw1;
};

// A drel_h thread's running sum: grid row cur's keys so far.
struct Bins {
  float acc;
  int cur;                                // drel_h: the grid row in acc
};

// The drel sums of one key tile's f32 ds (its first key key0, n keys), in
// the warpgroup's tile dst: threads 0..63 take row r's drel_h, a running
// sum over each grid row's runs of keys (a run summed in key order, then
// added; the sum written as the keys move on to the next grid row),
// threads 64..127 its drel_w, bin by bin (the bin's keys of the tile
// summed in key order in a register, then added to the bin in wbins).
__device__ __forceinline__ void bin_tile(const float* dst, float* wbins,
                                         float* drh_row, Bins& bins,
                                         int key0, int n, int g, float inv_g,
                                         int wt, bool row_ok) {
  const int r = wt & 63;
  int hb, wb;
  grid_cell(key0, g, inv_g, hb, wb);
  const float* __restrict__ drow = dst + r * DSP;
  if (wt < 64) {
    for (int c = 0; c < n;) {
      const int len = g - wb < n - c ? g - wb : n - c;
      float part = drow[c];
      for (int k = 1; k < len; ++k) part += drow[c + k];
      if (hb != bins.cur) {
        if (row_ok) drh_row[bins.cur] = bins.acc;
        bins.acc = 0.f;
        bins.cur = hb;
      }
      bins.acc += part;
      c += len;
      wb += len;
      if (wb == g) {
        wb = 0;
        ++hb;
      }
    }
  } else {
    float* __restrict__ wrow = wbins + r * odd_pitch(g);
    const int m = g < n ? g : n;
    for (int k = 0; k < m; ++k) {
      float part = drow[k];
      for (int c = k + g; c < n; c += g) part += drow[c];
      wrow[wb] += part;
      if (++wb == g) wb = 0;
    }
  }
}

// Key tile j (W wide; the tile's first key key0): s and dp on the tensor
// cores and, while they run, the drel sums of the previous tile's ds
// (prev_n keys from prev_key0; none for the first); the bias and p =
// exp(s - lse) on s, ds = (dp - delta) p, ds to the warpgroup's f32 tile
// and packed as the A operand of dq += ds K. (Binning tile j under its own
// dq product left it on the path from one tile's products to the next's:
// 0.024 of the kernel's 0.092 ms at BoTNet-T3 bs64.)
template <int W, int NB>
__device__ __forceinline__ void dq_tile(
    float (&adq)[NB][32], const DqRows& rr, Bins& bins, uint64_t dq_a,
    uint64_t ddo_a, const bf16* kt, const bf16* vt, uint64_t* full,
    uint64_t* empty, int step, int stages, float* dst, float* wbins,
    float* drh_row, int key0, int prev_key0, int prev_n, int L, int g,
    float inv_g, int t, int lrow, int wg, int wt, bool leader, bool row_ok) {
  const int st = step % stages;
  float sc[W / 2], dp[W / 2];
  mbar_wait(&full[st], (step / stages) & 1);
  wgmma_fence();
  ss_products<W, NB>(sc, dq_a, desc_k_major(kt));          // s = Q K^T
  ss_products<W, NB>(dp, ddo_a, desc_k_major(vt));         // dp = dO V^T
  if (prev_n > 0)
    bin_tile(dst, wbins, drh_row, bins, prev_key0, prev_n, g, inv_g, wt,
             row_ok);
  wgmma_wait<1>();
  fence_regs(sc);
#pragma unroll
  for (int i = 0; i < W / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = key0 + 8 * i + 2 * t + e;
      int hb = 0, wb = 0;
      const bool in = key < L;
      if (in) grid_cell(key, g, inv_g, hb, wb);
      const float x0 = (sc[4 * i + e] + rr.rh0[hb]) + rr.rw0[wb];
      const float x1 = (sc[4 * i + 2 + e] + rr.rh1[hb]) + rr.rw1[wb];
      sc[4 * i + e] = exp2_approx(in && rr.ok0 ? fmaf(x0, kLog2e, -rr.l2a)
                                               : -INFINITY);
      sc[4 * i + 2 + e] = exp2_approx(
          in && rr.ok1 ? fmaf(x1, kLog2e, -rr.l2b) : -INFINITY);
    }
  wgmma_wait<0>();
  fence_regs(dp);
  warpgroup_sync(1 + wg);                   // the last tile's ds is binned
#pragma unroll
  for (int i = 0; i < W / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dp[4 * i + e] = (dp[4 * i + e] - rr.da) * sc[4 * i + e];
      dp[4 * i + 2 + e] = (dp[4 * i + 2 + e] - rr.db) * sc[4 * i + 2 + e];
      const int c = 8 * i + 2 * t + e;
      dst[lrow * DSP + c] = dp[4 * i + e];
      dst[(lrow + 8) * DSP + c] = dp[4 * i + 2 + e];
    }
  uint32_t a[W / 16][4];
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) a_frag(a[kk], dp, kk);
  wgmma_fence();
  rs_products<W, NB>(adq, a, kt);                           // dq += ds K
  wgmma_commit();
  warpgroup_sync(1 + wg);                   // the tile's ds is in dst
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NB; ++c) fence_regs(adq[c]);
  if (leader) mbar_arrive(&empty[st]);
}

// Persistent; units (128-row tile, head, image) by flash::work_of. 384
// threads: the producer warpgroup (its thread 0 issues every TMA load; all
// 128 copy the unit's rel rows by cp.async, as no TMA box fits a g-wide
// f32 row in general) and two consumer warpgroups of 64 rows each. Writes
// dq, drel_h, drel_w and delta [B, h, L] (read by the dkv kernel).
template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
bot_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap to,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ rel_h,
                  const float* __restrict__ rel_w,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  bf16* __restrict__ dq, float* __restrict__ drel_h,
                  float* __restrict__ drel_w, const DqPlan plan, int batch,
                  int L, int heads, int g, float inv_g) {
  constexpr int D = 64 * NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int S = plan.stages, gp = plan.gp;
  bf16* sq = reinterpret_cast<bf16*>(base);
  bf16* sdo = reinterpret_cast<bf16*>(base + plan.off_do);
  bf16* ring = reinterpret_cast<bf16*>(base + plan.off_ring);
  unsigned char* ods = base + plan.off_ods;
  float* srh = reinterpret_cast<float*>(base + plan.off_rh);
  float* srw = reinterpret_cast<float*>(base + plan.off_rw);
  float* sbins = reinterpret_cast<float*>(base + plan.off_bins);
  float* sdelta = reinterpret_cast<float*>(base + plan.off_delta);
  uint64_t* res_full = reinterpret_cast<uint64_t*>(base + plan.off_bar);
  uint64_t* res_empty = res_full + 1;
  uint64_t* full = res_full + 2;
  uint64_t* empty = full + S;
  const int tid = threadIdx.x;
  const int nx = (L + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int units = nx * heads * batch;
  const int n_k = (L + TILE - 1) / TILE, n_wide = wide_tiles(L);
  const int stride = heads * D;
  auto kslot = [&](int st) { return ring + st * 2 * NB * TILE_ELEMS; };

  const bool bulk = bulk_rows(g);
  if (tid == 0) {
    // the TMA thread, and the 128 copiers where they copy
    mbar_init(res_full, bulk ? 1 : 1 + 128);
    mbar_init(res_empty, 2);                 // each consumer warpgroup
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {                    // producer warpgroup
    setmaxnreg_dec<DQ_PRODUCER_REGS>();
    const int pt = tid - CONSUMERS;
    if (bulk && pt != 0) return;
    int step = 0;
    for (int u = blockIdx.x, n = 0; u < units; u += gridDim.x, ++n) {
      const Work w = work_of(u, nx, heads);
      const int q0 = w.x * BLOCK_ROWS;
      const int rows = L - q0 < BLOCK_ROWS ? L - q0 : BLOCK_ROWS;
      const size_t roff = ((size_t)w.b * heads + w.h) * L * g;
      mbar_wait(res_empty, (n & 1) ^ 1);
      if (pt == 0) {
        const uint32_t rel = bulk ? rows * g * 4 : 0;
        mbar_arrive_expect_tx(res_full, 6 * NB * BOX + 2 * rel);
        if (bulk) {
          bulk_load(srh, rel_h + roff + (size_t)q0 * g, rel, res_full);
          bulk_load(srw, rel_w + roff + (size_t)q0 * g, rel, res_full);
        }
        for (int grp = 0; grp < 2; ++grp)
          for (int c = 0; c < NB; ++c) {
            const int at = (grp * NB + c) * TILE_ELEMS;
            const int col = w.h * D + 64 * c, row = q0 + 64 * grp;
            tma_load_3d(sq + at, &tq, res_full, col, row, w.b);
            tma_load_3d(sdo + at, &tdo, res_full, col, row, w.b);
            tma_load_3d(reinterpret_cast<bf16*>(ods) + at, &to, res_full,
                        col, row, w.b);
          }
      }
      if (!bulk) {       // the unit's rel rows (zeros past L), at once
        copy_rel(srh, rel_h + roff, q0, BLOCK_ROWS, L, g, pt);
        copy_rel(srw, rel_w + roff, q0, BLOCK_ROWS, L, g, pt);
        cp_async_arrive(res_full);
      }
      if (pt != 0) continue;
      for (int j = 0; j < n_k; ++j, ++step) {
        const int st = step % S;
        mbar_wait(&empty[st], ((step / S) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * NB * BOX);
        for (int c = 0; c < NB; ++c) {
          tma_load_3d(kslot(st) + c * TILE_ELEMS, &tk, &full[st],
                      w.h * D + 64 * c, j * TILE, w.b);
          tma_load_3d(kslot(st) + (NB + c) * TILE_ELEMS, &tv, &full[st],
                      w.h * D + 64 * c, j * TILE, w.b);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<DQ_CONSUMER_REGS>();
  const int wg = tid >> 7, wt = tid & 127, wi = wt >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int lrow = 16 * wi + (lane >> 2);    // the warpgroup's rows lrow, +8
  const bool leader = wt == 0;
  float* dst = reinterpret_cast<float*>(ods) + wg * 64 * DSP;
  float* wbins = sbins + wg * 64 * gp;
  int step = 0;
  for (int u = blockIdx.x, n = 0; u < units; u += gridDim.x, ++n) {
    const Work w = work_of(u, nx, heads);
    const int q0 = w.x * BLOCK_ROWS, row0 = q0 + 64 * wg + lrow;
    const size_t srow = ((size_t)w.b * heads + w.h) * L;
    DqRows rr;
    rr.ok0 = row0 < L;
    rr.ok1 = row0 + 8 < L;
    rr.l2a = rr.ok0 ? lse[srow + row0] * kLog2e : 0.f;
    rr.l2b = rr.ok1 ? lse[srow + row0 + 8] * kLog2e : 0.f;
    mbar_wait(res_full, n & 1);

    // delta = rowsum(o * do): two threads a row, each over half of its
    // 16-byte chunks in order; o and do share the swizzle
    {
      const int r = 64 * wg + (wt >> 1), rs = r & 63, grp = r >> 6;
      float acc = 0.f;
#pragma unroll
      for (int k = (wt & 1) * 4 * NB; k < ((wt & 1) + 1) * 4 * NB; ++k) {
        const int box = k >> 3, ch = (k & 7) ^ (rs & 7);
        const int at = (grp * NB + box) * TILE_ELEMS + rs * 64 + ch * 8;
        const uint4 ov = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const bf16*>(ods) + at);
        const uint4 dv = *reinterpret_cast<const uint4*>(sdo + at);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc += __bfloat162float(oe[e]) * __bfloat162float(de[e]);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if ((wt & 1) == 0) {
        sdelta[r] = acc;
        if (q0 + r < L) delta[srow + q0 + r] = acc;
      }
    }
    named_sync(3, CONSUMERS);                // delta is in; O is read
    rr.da = sdelta[64 * wg + lrow];
    rr.db = sdelta[64 * wg + lrow + 8];
    rr.rh0 = srh + (64 * wg + lrow) * g;
    rr.rh1 = rr.rh0 + 8 * g;
    rr.rw0 = srw + (64 * wg + lrow) * g;
    rr.rw1 = rr.rw0 + 8 * g;
    // the binning thread's row and its drel state
    const int br = wt & 63, brow = q0 + 64 * wg + br;
    const bool brow_ok = brow < L;
    float* drh_row = drel_h + (srow + brow) * g;
    Bins bins{0.f, 0};
    if (wt >= 64)
      for (int c = 0; c < g; ++c) wbins[br * gp + c] = 0.f;

    const uint64_t dq_a = desc_k_major(sq + wg * NB * TILE_ELEMS);
    const uint64_t ddo_a = desc_k_major(sdo + wg * NB * TILE_ELEMS);
    float adq[NB][32];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) adq[c][i] = 0.f;
    // a tile's keys: 64, or L's rest (the last tile's)
    const auto keys = [&](int j) { return L - j * TILE < TILE ? L - j * TILE
                                                                : TILE; };
    for (int j = 0; j < n_wide; ++j, ++step) {
      const bf16* kt = kslot(step % S);
      dq_tile<64, NB>(adq, rr, bins, dq_a, ddo_a, kt, kt + NB * TILE_ELEMS,
                      full, empty, step, S, dst, wbins, drh_row, j * TILE,
                      (j - 1) * TILE, j > 0 ? keys(j - 1) : 0, L, g, inv_g, t,
                      lrow, wg, wt, leader, brow_ok);
    }
    if (n_wide < n_k) {
      const bf16* kt = kslot(step % S);
      dq_tile<16, NB>(adq, rr, bins, dq_a, ddo_a, kt, kt + NB * TILE_ELEMS,
                      full, empty, step, S, dst, wbins, drh_row,
                      n_wide * TILE, (n_wide - 1) * TILE,
                      n_wide > 0 ? keys(n_wide - 1) : 0, L, g, inv_g, t, lrow,
                      wg, wt, leader, brow_ok);
      ++step;
    }
    // the last tile's drel sums, the last drel_h sum, the drel_w bins, dq
    bin_tile(dst, wbins, drh_row, bins, (n_k - 1) * TILE, keys(n_k - 1), g,
             inv_g, wt, brow_ok);
    if (wt < 64) {
      if (brow_ok) drh_row[bins.cur] = bins.acc;
    } else if (brow_ok) {
      float* out = drel_w + (srow + brow) * g;
      for (int c = 0; c < g; ++c) out[c] = wbins[br * gp + c];
    }
    warpgroup_sync(1 + wg);                  // every read of the unit done
    if (leader) mbar_arrive(res_empty);
    bf16* dqb = dq + (size_t)w.b * L * stride + w.h * D;
#pragma unroll
    for (int c = 0; c < NB; ++c)
      store_acc(dqb + 64 * c, stride, q0 + 64 * wg + lrow, L, L, adq[c], t);
  }
}

// ---- the dkv kernel: dk and dv

// Query tile j (W wide) of a unit: s^T = K Q^T and dp^T = V dO^T on the
// tensor cores (K and V resident, this warpgroup's 64 keys), the bias and
// p^T = exp(s^T - lse) from the slot's rel rows and lse, ds^T = (dp^T -
// delta) p^T, then dv += bf16(p^T) dO and dk += bf16(ds^T) Q with p^T and
// ds^T as register A operands; the slot is freed once they are in.
template <int W, int NB>
__device__ __forceinline__ void dkv_tile(
    float (&adk)[NB][32], float (&adv)[NB][32], uint64_t k_a, uint64_t v_a,
    const unsigned char* slot, const DkvPlan plan, uint64_t* full,
    uint64_t* empty, int step, int nq, int g, int hb0, int wb0, int hb1,
    int wb1, bool ok0, bool ok1, int t, bool leader) {
  const int S = plan.stages, st = step % S;
  const bf16* qt = reinterpret_cast<const bf16*>(slot);
  const bf16* dot = qt + NB * TILE_ELEMS;
  const float* rh = reinterpret_cast<const float*>(slot + plan.s_rh);
  const float* rw = reinterpret_cast<const float*>(slot + plan.s_rw);
  const float* ls = reinterpret_cast<const float*>(slot + plan.s_lse);
  const float* di = reinterpret_cast<const float*>(slot + plan.s_di);
  float sc[W / 2], dp[W / 2];
  mbar_wait(&full[st], (step / S) & 1);
  wgmma_fence();
  ss_products<W, NB>(sc, k_a, desc_k_major(qt));           // s^T = K Q^T
  ss_products<W, NB>(dp, v_a, desc_k_major(dot));          // dp^T = V dO^T
  wgmma_wait<1>();
  fence_regs(sc);
#pragma unroll
  for (int i = 0; i < W / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 8 * i + 2 * t + e;       // the query in the tile
      // p = 0 for a query past L (its slot rows may be stale)
      const bool okq = q < nq;
      const float l2 = ls[q] * kLog2e;
      const float x0 = (sc[4 * i + e] + rh[q * g + hb0]) + rw[q * g + wb0];
      const float x1 = (sc[4 * i + 2 + e] + rh[q * g + hb1]) + rw[q * g + wb1];
      sc[4 * i + e] = exp2_approx(ok0 && okq ? fmaf(x0, kLog2e, -l2)
                                             : -INFINITY);
      sc[4 * i + 2 + e] = exp2_approx(ok1 && okq ? fmaf(x1, kLog2e, -l2)
                                                 : -INFINITY);
    }
  wgmma_wait<0>();
  fence_regs(dp);
#pragma unroll
  for (int i = 0; i < W / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 8 * i + 2 * t + e;
      const float d = q < nq ? di[q] : 0.f;
      dp[4 * i + e] = (dp[4 * i + e] - d) * sc[4 * i + e];
      dp[4 * i + 2 + e] = (dp[4 * i + 2 + e] - d) * sc[4 * i + 2 + e];
    }
  uint32_t pa[W / 16][4], da[W / 16][4];
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    a_frag(pa[kk], sc, kk);
    a_frag(da[kk], dp, kk);
  }
  wgmma_fence();
  rs_products<W, NB>(adv, pa, dot);                         // dv += p^T dO
  rs_products<W, NB>(adk, da, qt);                          // dk += ds^T Q
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    fence_regs(adv[c]);
    fence_regs(adk[c]);
  }
  if (leader) mbar_arrive(&empty[st]);
}

// Persistent; units (128-key tile, head, image). The producer warpgroup:
// thread 0 loads a unit's K and V and each query tile's Q and dO by TMA;
// all 128 copy each query tile's rel rows, lse and delta (zeros past L)
// into its slot by cp.async. Reads the delta the dq kernel wrote.
template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
bot_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ rel_h,
                   const float* __restrict__ rel_w,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, const DkvPlan plan, int batch,
                   int L, int heads, int g, float inv_g) {
  constexpr int D = 64 * NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int S = plan.stages;
  bf16* sk = reinterpret_cast<bf16*>(base);
  bf16* sv = reinterpret_cast<bf16*>(base + plan.off_v);
  unsigned char* ring = base + plan.off_ring;
  uint64_t* res_full = reinterpret_cast<uint64_t*>(base + plan.off_bar);
  uint64_t* res_empty = res_full + 1;
  uint64_t* full = res_full + 2;
  uint64_t* empty = full + S;
  const int tid = threadIdx.x;
  const int nx = (L + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int units = nx * heads * batch;
  const int n_q = (L + TILE - 1) / TILE, n_wide = wide_tiles(L);
  const int stride = heads * D;

  const bool bulk = bulk_rows(g);
  if (tid == 0) {
    mbar_init(res_full, 1);
    mbar_init(res_empty, 2);
    for (int i = 0; i < S; ++i) {
      // the TMA thread, and the 128 copiers where they copy
      mbar_init(&full[i], bulk ? 1 : 1 + 128);
      mbar_init(&empty[i], 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {                    // producer warpgroup
    setmaxnreg_dec<DKV_PRODUCER_REGS>();
    const int pt = tid - CONSUMERS;
    if (bulk && pt != 0) return;
    int step = 0;
    for (int u = blockIdx.x, n = 0; u < units; u += gridDim.x, ++n) {
      const Work w = work_of(u, nx, heads);
      const size_t srow = ((size_t)w.b * heads + w.h) * L;
      if (pt == 0) {
        const int k0 = w.x * BLOCK_ROWS;
        mbar_wait(res_empty, (n & 1) ^ 1);
        mbar_arrive_expect_tx(res_full, 4 * NB * BOX);
        for (int grp = 0; grp < 2; ++grp)
          for (int c = 0; c < NB; ++c) {
            const int at = (grp * NB + c) * TILE_ELEMS;
            tma_load_3d(sk + at, &tk, res_full, w.h * D + 64 * c,
                        k0 + 64 * grp, w.b);
            tma_load_3d(sv + at, &tv, res_full, w.h * D + 64 * c,
                        k0 + 64 * grp, w.b);
          }
      }
      for (int j = 0; j < n_q; ++j, ++step) {
        const int st = step % S, r0 = j * TILE;
        const int rows = L - r0 < TILE ? L - r0 : TILE;
        unsigned char* slot = ring + st * plan.slot;
        mbar_wait(&empty[st], ((step / S) & 1) ^ 1);
        if (pt == 0) {
          const uint32_t rel = bulk ? rows * g * 4 : 0;
          const uint32_t stat = bulk ? rows * 4 : 0;
          mbar_arrive_expect_tx(&full[st], 2 * NB * BOX + 2 * rel + 2 * stat);
          for (int c = 0; c < NB; ++c) {
            tma_load_3d(slot + c * BOX, &tq, &full[st], w.h * D + 64 * c, r0,
                        w.b);
            tma_load_3d(slot + (NB + c) * BOX, &tdo, &full[st],
                        w.h * D + 64 * c, r0, w.b);
          }
          if (bulk) {
            bulk_load(slot + plan.s_rh, rel_h + (srow + r0) * g, rel,
                      &full[st]);
            bulk_load(slot + plan.s_rw, rel_w + (srow + r0) * g, rel,
                      &full[st]);
            bulk_load(slot + plan.s_lse, lse + srow + r0, stat, &full[st]);
            bulk_load(slot + plan.s_di, delta + srow + r0, stat, &full[st]);
            continue;
          }
        }
        // the tile's rel rows, lse and delta (zeros past L), all copies
        // in flight at once
        copy_rel(reinterpret_cast<float*>(slot + plan.s_rh), rel_h + srow * g,
                 r0, TILE, L, g, pt);
        copy_rel(reinterpret_cast<float*>(slot + plan.s_rw), rel_w + srow * g,
                 r0, TILE, L, g, pt);
        if (pt < TILE) {
          const bool in = r0 + pt < L;
          bot::cp_async_4(slot + plan.s_lse + 4 * pt,
                          in ? lse + srow + r0 + pt : lse, in ? 4 : 0);
          bot::cp_async_4(slot + plan.s_di + 4 * pt,
                          in ? delta + srow + r0 + pt : delta, in ? 4 : 0);
        }
        cp_async_arrive(&full[st]);
      }
    }
    return;
  }

  setmaxnreg_inc<DKV_CONSUMER_REGS>();
  const int wg = tid >> 7, wt = tid & 127, wi = wt >> 5, lane = tid & 31;
  const int t = lane & 3;
  const bool leader = wt == 0;
  int step = 0;
  for (int u = blockIdx.x, n = 0; u < units; u += gridDim.x, ++n) {
    const Work w = work_of(u, nx, heads);
    const int key0 = w.x * BLOCK_ROWS + 64 * wg + 16 * wi + (lane >> 2);
    const bool ok0 = key0 < L, ok1 = key0 + 8 < L;
    int hb0 = 0, wb0 = 0, hb1 = 0, wb1 = 0;
    if (ok0) grid_cell(key0, g, inv_g, hb0, wb0);
    if (ok1) grid_cell(key0 + 8, g, inv_g, hb1, wb1);
    float adk[NB][32], adv[NB][32];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) adk[c][i] = adv[c][i] = 0.f;
    mbar_wait(res_full, n & 1);
    const uint64_t k_a = desc_k_major(sk + wg * NB * TILE_ELEMS);
    const uint64_t v_a = desc_k_major(sv + wg * NB * TILE_ELEMS);
    for (int j = 0; j < n_wide; ++j, ++step)
      dkv_tile<64, NB>(adk, adv, k_a, v_a, ring + (step % S) * plan.slot,
                       plan, full, empty, step, L - j * TILE, g, hb0, wb0,
                       hb1, wb1, ok0, ok1, t, leader);
    if (n_wide < n_q) {
      dkv_tile<16, NB>(adk, adv, k_a, v_a, ring + (step % S) * plan.slot,
                       plan, full, empty, step, L - n_wide * TILE, g, hb0,
                       wb0, hb1, wb1, ok0, ok1, t, leader);
      ++step;
    }
    if (leader) mbar_arrive(res_empty);      // K and V are read
    const size_t koff = (size_t)w.b * L * stride + w.h * D;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      store_acc(dk + koff + 64 * c, stride, key0, L, L, adk[c], t);
      store_acc(dv + koff + 64 * c, stride, key0, L, L, adv[c], t);
    }
  }
}

// ---- host

template <int NB>
int bwd_dq(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* rel_h, const float* rel_w,
           const float* lse, float* delta, void* dq, float* drel_h,
           float* drel_w, int batch, int L, int heads, int g,
           cudaStream_t stream) {
  const DqPlan plan = dq_plan(g, 64 * NB);
  if (plan.stages == 0) return (int)cudaErrorInvalidValue;
  const int width = heads * 64 * NB;
  CUtensorMap tq, tk, tv, to, tdo;
  int err = band_map(&tq, q, batch, L, L, width);
  if (!err) err = band_map(&tk, k, batch, L, L, width);
  if (!err) err = band_map(&tv, v, batch, L, L, width);
  if (!err) err = band_map(&to, o, batch, L, L, width);
  if (!err) err = band_map(&tdo, dout, batch, L, L, width);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      bot_bwd_dq_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      plan.smem);
  if (e != cudaSuccess) return (int)e;
  const int units = (L + BLOCK_ROWS - 1) / BLOCK_ROWS * heads * batch;
  bot_bwd_dq_kernel<NB><<<persistent_grid(units), THREADS, plan.smem,
                          stream>>>(
      tq, tk, tv, to, tdo, rel_h, rel_w, lse, delta, (bf16*)dq, drel_h,
      drel_w, plan, batch, L, heads, g, 1.f / (float)g);
  return (int)cudaGetLastError();
}

template <int NB>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* rel_h, const float* rel_w, const float* lse,
            const float* delta, void* dk, void* dv, int batch, int L,
            int heads, int g, cudaStream_t stream) {
  const DkvPlan plan = dkv_plan(g, 64 * NB);
  if (plan.stages == 0) return (int)cudaErrorInvalidValue;
  const int width = heads * 64 * NB;
  CUtensorMap tq, tk, tv, tdo;
  int err = band_map(&tq, q, batch, L, L, width);
  if (!err) err = band_map(&tk, k, batch, L, L, width);
  if (!err) err = band_map(&tv, v, batch, L, L, width);
  if (!err) err = band_map(&tdo, dout, batch, L, L, width);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      bot_bwd_dkv_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      plan.smem);
  if (e != cudaSuccess) return (int)e;
  const int units = (L + BLOCK_ROWS - 1) / BLOCK_ROWS * heads * batch;
  bot_bwd_dkv_kernel<NB><<<persistent_grid(units), THREADS, plan.smem,
                           stream>>>(
      tq, tk, tv, tdo, rel_h, rel_w, lse, delta, (bf16*)dk, (bf16*)dv, plan,
      batch, L, heads, g, 1.f / (float)g);
  return (int)cudaGetLastError();
}

}  // namespace botb
}  // namespace sav

// Shared memory of kernel `which` (0: K9a, 1: K9b's dq kernel, 2: its dkv
// kernel) at grid side g and head width d, or 0 where it cannot run (d not
// 64 or 128, g < 1, or beyond a block's shared memory).
extern "C" int sav_bot_smem(int which, int g, int d) {
  using namespace sav;
  if (g < 1 || (d != 64 && d != 128)) return 0;
  if (which == 1) {
    const botb::DqPlan p = botb::dq_plan(g, d);
    return p.stages ? p.smem : 0;
  }
  if (which == 2) {
    const botb::DkvPlan p = botb::dkv_plan(g, d);
    return p.stages ? p.smem : 0;
  }
  const size_t bytes = d == 64 ? bot::fwd_smem<64>(g) : bot::fwd_smem<128>(g);
  return bytes > (size_t)bot::SMEM_LIMIT ? 0 : (int)bytes;
}

// K9b's launch plan at grid side g and head width d: out[0] the dq
// kernel's shared memory, [1] its ring slots, [2] the dkv kernel's shared
// memory, [3] its ring slots, [4] a dkv slot's bytes, [5] the drel_w bins'
// pitch; returns 0, or cudaErrorInvalidValue where either kernel cannot
// run. Mirrored by bot_bwd_plan in ops/botnet_attention.py.
extern "C" int sav_bot_bwd_plan(int g, int d, long long* out) {
  using namespace sav::botb;
  if (g < 1 || (d != 64 && d != 128)) return (int)cudaErrorInvalidValue;
  const DqPlan a = dq_plan(g, d);
  const DkvPlan b = dkv_plan(g, d);
  out[0] = a.stages ? a.smem : 0;
  out[1] = a.stages;
  out[2] = b.stages ? b.smem : 0;
  out[3] = b.stages;
  out[4] = b.slot;
  out[5] = a.gp;
  return a.stages && b.stages ? 0 : (int)cudaErrorInvalidValue;
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
  using namespace sav::botb;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return bwd_dq<1>(q, k, v, o, dout, rel_h, rel_w, lse, delta, dq, drel_h,
                     drel_w, batch, L, heads, g, s);
  if (d == 128)
    return bwd_dq<2>(q, k, v, o, dout, rel_h, rel_w, lse, delta, dq, drel_h,
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
  using namespace sav::botb;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return bwd_dkv<1>(q, k, v, dout, rel_h, rel_w, lse, delta, dk, dv, batch,
                      L, heads, g, s);
  if (d == 128)
    return bwd_dkv<2>(q, k, v, dout, rel_h, rel_w, lse, delta, dk, dv, batch,
                      L, heads, g, s);
  return (int)cudaErrorInvalidValue;
}
