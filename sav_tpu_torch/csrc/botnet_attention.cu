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
//  * K9a (botf::bot_fwd_kernel<NB, W>): persistent wgmma + TMA on K9b's
//    frame. 384 threads: a producer warpgroup (thread 0 issues the TMA
//    loads and the rel rows' bulk copies; at odd g all 128 copy the rel
//    rows by cp.async) and two consumer warpgroups of 64 query rows. A
//    unit is (128-query tile, head, image): its Q and rel rows in one of
//    two buffers (the next unit's land under this one's work), K and V
//    tiles of W keys through a ring whose slots hold one K or one V tile.
//    The keys a tile W come from a plan per L (fwd_width: the width of
//    64 or 104 that covers L with the fewest columns; L = 196 is two
//    104-key steps, 208 columns instead of the 256 of 64-key tiles). s = Q
//    K^T on wgmma with both operands in shared memory, the bias added to
//    the fragments from the resident rel rows, keys past L at -inf, the
//    softmax online across tiles (one tile: the exact max), p = 2^(s log2
//    e - m log2 e) by ex2.approx, rounded to bf16 as the register A
//    operand of o += p V (V MN-major, K = W rounded up to 16, p 0 past the
//    tile and V rows past L zero). Registers at W = 104, d = 128: s 52 + o
//    64 a thread beside the row state and p's 28, within the 168 ptxas
//    gives a thread of 384 (one 208-key tile, s 104 + o 64, spilled). out
//    is normalised in registers, staged in the warpgroup's Q half (free
//    once the unit's products are in) and
//    stored by TMA, which clips the rows past L. The short tile of L =
//    196 (rows 192-195) shares its unit with rows 128-191: it runs in the
//    block's second warpgroup beside a full tile, on the same K/V loads,
//    not as a unit of its own (B = 32: 256 units, 1.94 waves on 132 SMs;
//    B = 64: 512 units, 3.88 waves).
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

namespace sav {
namespace bot {

// The rel rows' pitch in shared memory: odd, so rows fall in other banks.
__host__ __device__ inline int odd_pitch(int g) { return g | 1; }

// 4-byte asynchronous copy global -> shared; src_bytes = 0 fills zeros.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           int src_bytes) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

// Key column j -> (j / g, j % g) without an integer division.
__device__ __forceinline__ void grid_cell(int j, int g, float inv_g, int& hb,
                                          int& wb) {
  hb = (int)(((float)j + 0.5f) * inv_g);
  wb = j - hb * g;
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


// ------------------------------------------------------------------ K9a

namespace sav {
namespace botf {

using namespace flash;
using bot::grid_cell;
using botb::bulk_load;
using botb::bulk_rows;
using botb::copy_rel;
using botb::cp_async_arrive;
using botb::round1024;

constexpr int BLOCK_ROWS = 128;           // query rows of a unit (2 x 64)
constexpr int MAX_STAGES = 4;             // ring slots, each a K or a V tile
constexpr int MAX_QBUFS = 2;              // Q + rel-row buffers
constexpr int SMEM_LIMIT = 232448;
constexpr int PRODUCER_REGS = 40;         // 40 + 2 x 232 = 3 x 168
constexpr int CONSUMER_REGS = 232;

// The keys a tile at L keys: 104 where 104-key steps cover L in no more
// columns than 64-key tiles do (L = 196: two steps, 208 columns against
// 256), else 64 (L = 169: 192 against 208). A 104-key step's box holds 112
// rows (p V runs 16-key steps; p is 0 on the 8 past the step), and its
// logits take 52 registers a thread beside o's 64 at d = 128: within the
// 168 ptxas gives a thread of 384 (one 208-key tile, 104 + 64, spilled).
__host__ __device__ inline int fwd_width(int L) {
  return (L + 103) / 104 * 104 <= (L + 63) / 64 * 64 ? 104 : 64;
}

// The rows of a key tile's box: W rounded up to 16.
__host__ __device__ constexpr int box_rows(int w) { return (w + 15) / 16 * 16; }

// K9a's layout at L keys, grid side g, head width d (bytes from a
// 1024-byte aligned base): qbufs buffers, each Q's two 64-row halves (d /
// 64 boxes each) and the unit's rel_h and rel_w rows (g f32 a row, as in
// device memory); the ring of stages slots, each one K or one V tile
// (box_rows(W) rows, d / 64 boxes); the mbarriers (res_full, res_empty [qbufs], full,
// empty [stages]). Two buffers and the most slots (2-4) that fit, else one
// buffer; else 64-key tiles; stages 0 where nothing fits. Mirrored by
// bot_fwd_plan in ops/botnet_attention.py.
struct FwdPlan {
  int nb, w, tiles, qbufs, stages;
  int off_rel, res, slot, off_ring, off_bar, smem;
};

__host__ __device__ inline FwdPlan fwd_plan(int L, int g, int d) {
  FwdPlan p;
  p.nb = d / 64;
  p.off_rel = 2 * p.nb * (int)TILE_BYTES;
  p.res = round1024(p.off_rel + 2 * BLOCK_ROWS * g * 4);
  for (int w = fwd_width(L);; w = 64) {
    p.w = w;
    p.tiles = (L + w - 1) / w;
    p.slot = p.nb * box_rows(w) * 128;
    for (int qb = MAX_QBUFS; qb >= 1; --qb)
      for (int s = MAX_STAGES; s >= 2; --s) {
        p.qbufs = qb;
        p.stages = s;
        p.off_ring = qb * p.res;
        p.off_bar = p.off_ring + s * p.slot;
        p.smem = p.off_bar + (2 * qb + 2 * s) * 8 + 1024;
        if (p.smem <= SMEM_LIMIT) return p;
      }
    if (w == 64) break;
  }
  p.stages = 0;
  return p;
}

// A consumer thread's rows lrow and lrow + 8 of its warpgroup's 64: the
// running max (raw logits), the per-thread partial sums, the rel rows.
struct FwdRows {
  float m0, m1, l0, l1;
  const float* rh0;
  const float* rh1;
  const float* rw0;
  const float* rw1;
};

// s = Q K^T of one key tile, 64 x W, as one commit group: Q's 64 rows
// (d / 64 boxes of 64 rows at q) against the tile's W keys (d / 64 boxes
// of box_rows(W) rows at kt), both K-major.
template <int W, int NB>
__device__ __forceinline__ void s_products(float (&sc)[W / 2], const bf16* q,
                                           const bf16* kt) {
  const uint64_t qd = desc_k_major(q), kd = desc_k_major(kt);
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    const uint64_t qo = (kk >> 2) * (TILE_BYTES >> 4) + (kk & 3) * K_STEP;
    const uint64_t ko =
        (kk >> 2) * ((box_rows(W) * 128) >> 4) + (kk & 3) * K_STEP;
    if constexpr (W == 64)
      wgmma_ss_k(sc, qd + qo, kd + ko, kk);
    else
      wgmma_ss_kn<W>(sc, qd + qo, kd + ko, kk);
  }
  wgmma_commit();
}

// o[c] += p V for each 64-column box c of the V tile (WP rows at vt,
// MN-major), p the WP-deep register operand; one commit group.
template <int WP, int NB>
__device__ __forceinline__ void pv_products(float (&o)[NB][32],
                                            const uint32_t (&pa)[WP / 16][4],
                                            const bf16* vt) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    const uint64_t vd = desc_mn_major(vt + c * WP * 64);
#pragma unroll
    for (int kk = 0; kk < WP / 16; ++kk)
      wgmma_rs_mn(o[c], pa[kk], vd + kk * MN_STEP);
  }
  wgmma_commit();
}

// Key tile logits in sc's first W / 2 (this thread's first key key0) ->
// the bias in the TPU kernel's order (s + rel_h) + rel_w, keys past L at
// -inf; the running max and sums move on, p = 2^(s log2 e - m log2 e) (0
// on the box's rows past the tile) packed as the A operand of p V, and
// (a0, a1) the factor o takes first.
template <int W, int WP>
__device__ __forceinline__ void bias_softmax(FwdRows& r, float (&sc)[WP / 2],
                                             uint32_t (&pa)[WP / 16][4],
                                             int key0, int L, int g,
                                             float inv_g, float& a0,
                                             float& a1) {
#pragma unroll
  for (int i = 0; i < W / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = key0 + 8 * i + e;
      int hb = 0, wb = 0;
      const bool in = key < L;
      if (in) grid_cell(key, g, inv_g, hb, wb);
      const float x0 = (sc[4 * i + e] + r.rh0[hb]) + r.rw0[wb];
      const float x1 = (sc[4 * i + 2 + e] + r.rh1[hb]) + r.rw1[wb];
      sc[4 * i + e] = in ? x0 : -INFINITY;
      sc[4 * i + 2 + e] = in ? x1 : -INFINITY;
    }
  float mx0 = r.m0, mx1 = r.m1;
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // key 0 is in the first tile, so mx is finite from there on and the
  // empty carry (m = -inf) gets the factor 2^-inf = 0
  a0 = exp2_approx((r.m0 - mx0) * kLog2e);
  a1 = exp2_approx((r.m1 - mx1) * kLog2e);
  const float n0 = -mx0 * kLog2e, n1 = -mx1 * kLog2e;
  r.m0 = mx0;
  r.m1 = mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
    sc[4 * i] = exp2_approx(fmaf(sc[4 * i], kLog2e, n0));
    sc[4 * i + 1] = exp2_approx(fmaf(sc[4 * i + 1], kLog2e, n0));
    sc[4 * i + 2] = exp2_approx(fmaf(sc[4 * i + 2], kLog2e, n1));
    sc[4 * i + 3] = exp2_approx(fmaf(sc[4 * i + 3], kLog2e, n1));
    rs0 += sc[4 * i] + sc[4 * i + 1];
    rs1 += sc[4 * i + 2] + sc[4 * i + 3];
  }
  r.l0 = r.l0 * a0 + rs0;
  r.l1 = r.l1 * a1 + rs1;
#pragma unroll
  for (int i = W / 2; i < WP / 2; ++i) sc[i] = 0.f;
  pack_frags<WP>(pa, sc);
}

// Persistent; units (128-query tile, head, image) by flash::work_of, so a
// head's units follow each other and share its K and V in L2. lse is [B,
// h, L] f32 or null (serving).
template <int NB, int W>
__global__ void __launch_bounds__(THREADS, 1)
bot_fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to,
               const float* __restrict__ rel_h,
               const float* __restrict__ rel_w, float* __restrict__ lse,
               const FwdPlan plan, int batch, int L, int heads, int g,
               float inv_g) {
  constexpr int D = 64 * NB, WP = box_rows(W);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int QB = plan.qbufs, S = plan.stages, T = plan.tiles;
  unsigned char* ring = base + plan.off_ring;
  uint64_t* res_full = reinterpret_cast<uint64_t*>(base + plan.off_bar);
  uint64_t* res_empty = res_full + QB;
  uint64_t* full = res_empty + QB;
  uint64_t* empty = full + S;
  const int tid = threadIdx.x;
  const int nx = (L + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int units = nx * heads * batch;

  const bool bulk = bulk_rows(g);
  if (tid == 0) {
    for (int i = 0; i < QB; ++i) {
      // the TMA thread, and the 128 copiers where they copy
      mbar_init(&res_full[i], bulk ? 1 : 1 + 128);
      mbar_init(&res_empty[i], 2);           // each consumer warpgroup
    }
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {                    // producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = tid - CONSUMERS;
    if (bulk && pt != 0) return;
    int step = 0;
    for (int u = blockIdx.x, n = 0; u < units; u += gridDim.x, ++n) {
      const Work w = work_of(u, nx, heads);
      const int q0 = w.x * BLOCK_ROWS;
      const int rows = L - q0 < BLOCK_ROWS ? L - q0 : BLOCK_ROWS;
      const size_t roff = ((size_t)w.b * heads + w.h) * L * g;
      const int rb = n % QB;
      unsigned char* res = base + rb * plan.res;
      float* srh = reinterpret_cast<float*>(res + plan.off_rel);
      float* srw = srh + BLOCK_ROWS * g;
      mbar_wait(&res_empty[rb], ((n / QB) & 1) ^ 1);
      if (pt == 0) {
        const uint32_t rel = bulk ? rows * g * 4 : 0;
        mbar_arrive_expect_tx(&res_full[rb], 2 * NB * TILE_BYTES + 2 * rel);
        if (bulk) {
          bulk_load(srh, rel_h + roff + (size_t)q0 * g, rel, &res_full[rb]);
          bulk_load(srw, rel_w + roff + (size_t)q0 * g, rel, &res_full[rb]);
        }
        for (int grp = 0; grp < 2; ++grp)
          for (int c = 0; c < NB; ++c)
            tma_load_3d(res + (grp * NB + c) * TILE_BYTES, &tq,
                        &res_full[rb], w.h * D + 64 * c, q0 + 64 * grp, w.b);
      }
      if (!bulk) {       // the unit's rel rows (zeros past L), at once
        copy_rel(srh, rel_h + roff, q0, BLOCK_ROWS, L, g, pt);
        copy_rel(srw, rel_w + roff, q0, BLOCK_ROWS, L, g, pt);
        cp_async_arrive(&res_full[rb]);
      }
      if (pt != 0) continue;
      for (int j = 0; j < 2 * T; ++j, ++step) {   // K_0, V_0, K_1, V_1, ...
        const int st = step % S;
        mbar_wait(&empty[st], ((step / S) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], plan.slot);
        for (int c = 0; c < NB; ++c)
          tma_load_3d(ring + st * plan.slot + c * WP * 128,
                      (j & 1) ? &tv : &tk, &full[st], w.h * D + 64 * c,
                      (j >> 1) * W, w.b);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = tid >> 7, wt = tid & 127, wi = wt >> 5, lane = tid & 31;
  const int t = lane & 3, gq = lane >> 2;
  const int lrow = 16 * wi + gq;             // the warpgroup's rows lrow, +8
  const bool leader = wt == 0;
  int step = 0, held = -1;                   // held: a buffer still to free
  for (int u = blockIdx.x, n = 0; u < units; u += gridDim.x, ++n) {
    const Work w = work_of(u, nx, heads);
    const int q0 = w.x * BLOCK_ROWS, r0 = q0 + 64 * wg, row0 = r0 + lrow;
    const int rb = n % QB;
    unsigned char* res = base + rb * plan.res;
    bf16* sq = reinterpret_cast<bf16*>(res) + wg * NB * TILE_ELEMS;
    FwdRows r;
    r.rh0 = reinterpret_cast<const float*>(res + plan.off_rel)
            + (64 * wg + lrow) * g;
    r.rh1 = r.rh0 + 8 * g;
    r.rw0 = r.rh0 + BLOCK_ROWS * g;
    r.rw1 = r.rw0 + 8 * g;
    r.m0 = r.m1 = -INFINITY;
    r.l0 = r.l1 = 0.f;
    float o[NB][32];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    mbar_wait(&res_full[rb], (n / QB) & 1);

    for (int j = 0; j < T; ++j) {
      int st = step % S;
      float sc[WP / 2];
      mbar_wait(&full[st], (step / S) & 1);
      wgmma_fence();
      s_products<W, NB>(*reinterpret_cast<float(*)[W / 2]>(sc), sq,
                        reinterpret_cast<const bf16*>(ring + st * plan.slot));
      wgmma_wait<0>();
      fence_regs(sc);
      if (leader) {
        mbar_arrive(&empty[st]);             // the K tile is read
        if (held >= 0) {                     // the last unit's store has
          bulk_wait_read();                  // read its staging tile
          mbar_arrive(&res_empty[held]);
          held = -1;
        }
      }
      ++step;
      uint32_t pa[WP / 16][4];
      float a0, a1;
      bias_softmax<W, WP>(r, sc, pa, j * W + 2 * t, L, g, inv_g, a0, a1);
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          o[c][4 * i] *= a0;
          o[c][4 * i + 1] *= a0;
          o[c][4 * i + 2] *= a1;
          o[c][4 * i + 3] *= a1;
        }
      st = step % S;
      mbar_wait(&full[st], (step / S) & 1);
      wgmma_fence();
      pv_products<WP, NB>(o, pa,
                          reinterpret_cast<const bf16*>(ring + st * plan.slot));
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(o[c]);
      if (leader) mbar_arrive(&empty[st]);   // the V tile is read
      ++step;
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, off);
      r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, off);
    }
    const float inv0 = 1.f / r.l0, inv1 = 1.f / r.l1;
    if (lse != nullptr && t == 0) {
      float* lb = lse + ((size_t)w.b * heads + w.h) * L;
      if (row0 < L) lb[row0] = r.m0 + logf(r.l0);
      if (row0 + 8 < L) lb[row0 + 8] = r.m1 + logf(r.l1);
    }
    // out through the warpgroup's Q half, in TMA's swizzled box layout
    // (the 16-byte chunk i of row rr at i ^ (rr % 8): a store's 8 rows hit
    // 8 different chunks), then one TMA store a box, which writes only the
    // rows below L
    warpgroup_sync(1 + wg);                  // every read of Q is done
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = lrow + 8 * h;
        const float inv = h ? inv1 : inv0;
        unsigned char* dst = reinterpret_cast<unsigned char*>(sq)
                             + c * TILE_BYTES + rr * 128 + 4 * t;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<uint32_t*>(dst + ((i ^ (rr & 7)) << 4)) =
              pack_bf16x2(o[c][4 * i + 2 * h] * inv,
                          o[c][4 * i + 2 * h + 1] * inv);
      }
    fence_proxy_async();
    warpgroup_sync(1 + wg);
    if (leader) {
      if (r0 < L) {
        for (int c = 0; c < NB; ++c)
          tma_store_3d(&to, sq + c * TILE_ELEMS, w.h * D + 64 * c, r0, w.b);
        bulk_commit();
      }
      if (QB == 1) {                         // the producer waits for it
        bulk_wait_read();
        mbar_arrive(&res_empty[rb]);
      } else {
        held = rb;                           // freed under the next unit
      }
    }
  }
  if (leader) bulk_wait_all();
}

template <int NB, int W>
int fwd_launch(const void* q, const void* k, const void* v,
               const float* rel_h, const float* rel_w, void* out, float* lse,
               const FwdPlan& plan, int batch, int L, int heads, int g,
               cudaStream_t stream) {
  const int width = heads * 64 * NB;
  CUtensorMap tq, tk, tv, to;
  int err = band_map(&tq, q, batch, L, L, width);
  if (!err) err = band_map(&tk, k, batch, L, L, width, box_rows(W));
  if (!err) err = band_map(&tv, v, batch, L, L, width, box_rows(W));
  if (!err) err = band_map(&to, out, batch, L, L, width);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      bot_fwd_kernel<NB, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      plan.smem);
  if (e != cudaSuccess) return (int)e;
  const int units = (L + BLOCK_ROWS - 1) / BLOCK_ROWS * heads * batch;
  bot_fwd_kernel<NB, W><<<persistent_grid(units), THREADS, plan.smem,
                          stream>>>(tq, tk, tv, to, rel_h, rel_w, lse, plan,
                                    batch, L, heads, g, 1.f / (float)g);
  return (int)cudaGetLastError();
}

inline int fwd(const void* q, const void* k, const void* v,
               const float* rel_h, const float* rel_w, void* out, float* lse,
               int batch, int L, int heads, int g, int d,
               cudaStream_t stream) {
  if (g < 1 || (d != 64 && d != 128)) return (int)cudaErrorInvalidValue;
  const FwdPlan plan = fwd_plan(L, g, d);
  if (plan.stages == 0) return (int)cudaErrorInvalidValue;
  const auto run = [&](auto launch) {
    return launch(q, k, v, rel_h, rel_w, out, lse, plan, batch, L, heads, g,
                  stream);
  };
  if (d == 64)
    return plan.w == 104 ? run(fwd_launch<1, 104>) : run(fwd_launch<1, 64>);
  return plan.w == 104 ? run(fwd_launch<2, 104>) : run(fwd_launch<2, 64>);
}

}  // namespace botf
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
  const botf::FwdPlan p = botf::fwd_plan(g * g, g, d);
  return p.stages ? p.smem : 0;
}

// K9a's launch plan at grid side g and head width d (L = g g): out[0] the
// key tile width, [1] key tiles a unit, [2] Q + rel buffers, [3] ring
// slots, [4] a buffer's bytes, [5] a slot's bytes, [6] shared memory;
// returns 0, or cudaErrorInvalidValue where the kernel cannot run.
// Mirrored by bot_fwd_plan in ops/botnet_attention.py.
extern "C" int sav_bot_fwd_plan(int g, int d, long long* out) {
  using namespace sav::botf;
  if (g < 1 || (d != 64 && d != 128)) return (int)cudaErrorInvalidValue;
  const FwdPlan p = fwd_plan(g * g, g, d);
  out[0] = p.w;
  out[1] = p.tiles;
  out[2] = p.qbufs;
  out[3] = p.stages;
  out[4] = p.res;
  out[5] = p.slot;
  out[6] = p.stages ? p.smem : 0;
  return p.stages ? 0 : (int)cudaErrorInvalidValue;
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
  if (L != g * g) return (int)cudaErrorInvalidValue;
  return sav::botf::fwd(q, k, v, rel_h, rel_w, out, lse, batch, L, heads, g,
                        d, (cudaStream_t)stream);
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
