// K2 port: the flash attention backward in one launch, on Hopper (wgmma,
// TMA, mbarriers; helpers in sm90.cuh and flash_sm90.cuh).
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
// round. Query rows past q_len read as zeros with lse = +inf and d = 0 (so
// p = 0) and are never stored; key rows past kv_len read as zeros, their
// logits are masked and their dk and dv rows in [kv_len, kv_rows) are
// written as exact zeros. No row is dropped: every tile count is a
// ceiling. Five products and nothing recomputed (K3 forms s and dp twice),
// no atomics (dq, dk, dv repeat bit for bit), no [L, L] tensor in device
// memory.
//
// Bound on the card: 10*L*L*64 operations against 8 band tensors and lse
// per (image, head), ~123 operations a byte at L = 197, under the H100's
// ~295: reading and writing each band once bounds it, so a head's loads
// have to overlap the products of the head before it.
//
// Design: persistent, one block per SM walking the (head, image) pairs,
// the heads of an image in turn. 384 threads: two consumer warpgroups and
// a producer warpgroup of which one thread issues TMA; setmaxnreg moves
// registers to the consumers. A whole head (L <= 208: ViT @224, L = 197)
// sits in shared memory:
//  * Statistics: o arrives by TMA beside K (in the last ds^T tile, which
//    phase A fills only later), and the consumers form delta =
//    rowsum(o * do) from it and the resident dO, one thread a row, with
//    lse log2 e read while the tiles arrive.
//  * Phase A (keys on the rows, K3b's inner step with Q and dO resident):
//    each consumer warpgroup takes key tiles of 64 in turn and holds its K
//    and V rows as register A operands; for each 64-query chunk (a last
//    chunk of 1-16 rows runs 16 wide) s^T = K Q^T and dp^T = V dO^T run
//    on wgmma in two commit groups, p^T is formed while dp^T runs, then
//    ds^T; both feed dV += p^T dO and dK += ds^T Q as register A operands
//    with Q and dO read MN-major. ds^T goes to shared memory in the
//    swizzled tile layout; dk and dv leave from registers.
//  * Phase B: dq = ds K per 64-query chunk, with ds^T read from shared
//    memory as an MN-major A operand and K as the MN-major B operand, in
//    16-key steps up to kv_len.
//  * Overlap: Q, dO and V are dead after phase A, so the producer loads
//    the next head's into them while phase B runs; K and o after phase B.
// Shared memory, sized for 208 rows: Q, dO, K, V (26 KB each) and ds^T as
// four 64-query column tiles over 208 key rows (104 KB), 211 KB with the
// statistics; mirrored by fused_bwd_plan in ops/flash_attention.py.
#include "flash_sm90.cuh"

namespace sav {
namespace k2 {

using namespace flash;

constexpr int MAX_ROWS = 208;             // longest head: 13 x 16 rows
constexpr int CHUNKS = 4;                 // 64-query chunks of 208 rows
constexpr int BAND = MAX_ROWS * BD;       // elements of one resident band
constexpr int STAT_ROWS = CHUNKS * TILE;

struct Smem {
  bf16 q[BAND], dout[BAND], k[BAND], v[BAND];
  bf16 dst[CHUNKS][BAND];                 // ds^T: key rows x 64 queries;
                                          // o in the last before phase A
  float lse[STAT_ROWS];                   // times log2 e; +inf past q_len
  float delta[STAT_ROWS];                 // 0 past q_len
  uint64_t qdov_full, qdov_empty, k_full, k_empty;
};

// dynamic shared memory asked for: the struct and the alignment slack
constexpr int SMEM = (int)sizeof(Smem) + 1024;

// The consumers' named barrier over both warpgroups (1 and 2 are each
// warpgroup's own).
constexpr int BAR_CONSUMERS = 3;

// Rows a band loads: full 64-row boxes, then a 16-row box for a tail of
// 1-16 rows (flash::cover_rows).
__device__ __forceinline__ void load_band(bf16* dst, const CUtensorMap* m64,
                                          const CUtensorMap* m16,
                                          uint64_t* bar, int rows, int col,
                                          int b) {
  const int wide = wide_tiles(rows);
  for (int i = 0; i < wide; ++i)
    tma_load_3d(dst + i * TILE_ELEMS, m64, bar, col, i * TILE, b);
  if (wide * TILE < rows)
    tma_load_3d(dst + wide * TILE_ELEMS, m16, bar, col, wide * TILE, b);
}

// ds^T (64 key rows x W query columns, accumulator layout) -> bf16 into
// the swizzled column tile `dst` at key rows tile0 + r, rows at or past
// `rows` skipped.
template <int W>
__device__ __forceinline__ void store_dst(bf16* dst, const float (&ds)[W / 2],
                                          int tile0, int r0, int rows,
                                          int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = tile0 + r0 + 8 * half;
    if (row >= rows) continue;
    unsigned char* base = reinterpret_cast<unsigned char*>(dst) + row * 128;
#pragma unroll
    for (int i = 0; i < W / 8; ++i)
      *reinterpret_cast<uint32_t*>(base + ((i ^ (row & 7)) << 4) + 4 * t) =
          pack_bf16x2(ds[4 * i + 2 * half], ds[4 * i + 2 * half + 1]);
  }
}

// Phase A's step: key tile at tile0 (K, V rows as register A operands)
// against query chunk c (W = 64, or 16 for a last chunk of 1-16 rows).
template <int W>
__device__ __forceinline__ void key_step(float (&adk)[32], float (&adv)[32],
                                         Smem& s, int c, int tile0,
                                         const uint32_t (&k_a)[4][4],
                                         const uint32_t (&v_a)[4][4], int r0,
                                         int ds_rows, bool ok0, bool ok1,
                                         int t) {
  const bf16* qc = s.q + c * TILE_ELEMS;
  const bf16* dc = s.dout + c * TILE_ELEMS;
  float sc[W / 2], dp[W / 2];
  uint32_t pa[W / 16][4], da[W / 16][4];
  wgmma_fence();
  mma_xy<W>(sc, k_a, qc);                                  // s^T = K Q^T
  mma_xy<W>(dp, v_a, dc);                                  // dp^T = V dO^T
  wgmma_wait<1>();
  fence_regs(sc);
  keyrow_p<W>(sc, s.lse + c * TILE, ok0, ok1, t);
  wgmma_wait<0>();
  fence_regs(dp);
  keyrow_ds<W>(sc, dp, s.delta + c * TILE, t);
  pack_frags<W>(pa, sc);
  pack_frags<W>(da, dp);
  wgmma_fence();
  mma_rs<W>(adv, pa, dc);                                  // dv += p^T dO
  mma_rs<W>(adk, da, qc);                                  // dk += ds^T Q
  wgmma_commit();
  store_dst<W>(s.dst[c], dp, tile0, r0, ds_rows, t);
  wgmma_wait<0>();
  fence_regs(adv);
  fence_regs(adk);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tq16,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tdo16,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tk16,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tv16,
                       const __grid_constant__ CUtensorMap to,
                       const __grid_constant__ CUtensorMap to16,
                       const float* __restrict__ lse, bf16* __restrict__ dq,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       int batch, int q_len, int kv_rows, int kv_len,
                       int heads) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const int tid = threadIdx.x;
  const int items = heads * batch;
  const int stride = heads * BD;
  const int q_cover = cover_rows(q_len), kv_cover = cover_rows(kv_rows);

  if (tid == 0) {
    mbar_init(&s.qdov_full, 1);
    mbar_init(&s.k_full, 1);
    mbar_init(&s.qdov_empty, 2);            // one arrival per warpgroup
    mbar_init(&s.k_empty, 2);
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {                   // producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != CONSUMERS) return;           // one thread works
    for (int item = blockIdx.x, n = 0; item < items;
         item += gridDim.x, ++n) {
      const Work w = work_of(item, 1, heads);
      const int col = w.h * BD, par = (n & 1) ^ 1;
      mbar_wait(&s.qdov_empty, par);        // phase A of the last head done
      mbar_arrive_expect_tx(&s.qdov_full, (2 * q_cover + kv_cover) * 128);
      load_band(s.q, &tq, &tq16, &s.qdov_full, q_len, col, w.b);
      load_band(s.dout, &tdo, &tdo16, &s.qdov_full, q_len, col, w.b);
      load_band(s.v, &tv, &tv16, &s.qdov_full, kv_rows, col, w.b);
      mbar_wait(&s.k_empty, par);           // its phase B done
      mbar_arrive_expect_tx(&s.k_full, (kv_cover + q_cover) * 128);
      load_band(s.k, &tk, &tk16, &s.k_full, kv_rows, col, w.b);
      load_band(s.dst[CHUNKS - 1], &to, &to16, &s.k_full, q_len, col, w.b);
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = tid >> 7, wt = tid & 127, wi = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wi * 16 + g;               // rows r0, r0 + 8 of a tile
  const bool leader = wt == 0;
  const int q_wide = wide_tiles(q_len), q_chunks = (q_len + TILE - 1) / TILE;
  const int k_tiles = (kv_rows + TILE - 1) / TILE;
  const int ds_rows = (kv_len + 15) / 16 * 16;  // keys phase B sums over
  for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
    const Work w = work_of(item, 1, heads);
    const size_t qoff = (size_t)w.b * q_len * stride + w.h * BD;
    const size_t koff = (size_t)w.b * kv_rows * stride + w.h * BD;
    // statistics: thread `tid` forms row tid's (rows past q_len: lse = +inf,
    // delta = 0); o and dO share the swizzle, so a row's 128 bytes hold the
    // same columns in both tiles
    const float l2 = tid < q_len
        ? lse[((size_t)w.b * heads + w.h) * q_len + tid] * kLog2e : INFINITY;
    mbar_wait(&s.qdov_full, n & 1);
    mbar_wait(&s.k_full, n & 1);
    if (tid < q_cover) {
      float acc = 0.f;
      if (tid < q_len) {
        const uint4* ou =
            reinterpret_cast<const uint4*>(s.dst[CHUNKS - 1] + tid * BD);
        const uint4* du = reinterpret_cast<const uint4*>(s.dout + tid * BD);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint4 ov = ou[c], dv4 = du[c];
          const bf16* oe = reinterpret_cast<const bf16*>(&ov);
          const bf16* de = reinterpret_cast<const bf16*>(&dv4);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc += __bfloat162float(oe[j]) * __bfloat162float(de[j]);
        }
      }
      s.delta[tid] = acc;
      s.lse[tid] = l2;
    }
    named_sync(BAR_CONSUMERS, CONSUMERS);   // statistics in, o read

    // phase A: key tiles wg, wg + 2, ...
    for (int kt = wg; kt < k_tiles; kt += 2) {
      const int tile0 = kt * TILE, key0 = tile0 + r0;
      uint32_t k_a[4][4], v_a[4][4];
      if (tile0 + 16 * wi < kv_cover) {     // a 16-row tail tile: warp 0
        load_a_frags(k_a, s.k + kt * TILE_ELEMS, wi, lane);
        load_a_frags(v_a, s.v + kt * TILE_ELEMS, wi, lane);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) k_a[kk][e] = v_a[kk][e] = 0u;
      }
      const bool ok0 = key0 < kv_len, ok1 = key0 + 8 < kv_len;
      float adk[32], adv[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) adk[i] = adv[i] = 0.f;
      for (int c = 0; c < q_wide; ++c)
        key_step<64>(adk, adv, s, c, tile0, k_a, v_a, r0, ds_rows, ok0,
                     ok1, t);
      if (q_wide < q_chunks)
        key_step<16>(adk, adv, s, q_wide, tile0, k_a, v_a, r0, ds_rows,
                     ok0, ok1, t);
      store_acc(dk + koff, stride, key0, kv_rows, kv_len, adk, t);
      store_acc(dv + koff, stride, key0, kv_rows, kv_len, adv, t);
    }
    fence_proxy_async();                    // ds^T -> the wgmma operands
    named_sync(BAR_CONSUMERS, CONSUMERS);
    if (leader) mbar_arrive(&s.qdov_empty); // Q, dO, V free

    // phase B: dq = ds K for query chunks wg, wg + 2, ...
    for (int c = wg; c < q_chunks; c += 2) {
      float adq[32];
      const uint64_t ad = desc_mn_major(s.dst[c]), kd = desc_mn_major(s.k);
      wgmma_fence();
      for (int kk = 0; kk < ds_rows / 16; ++kk)
        wgmma_ss_mn(adq, ad + kk * MN_STEP, kd + kk * MN_STEP, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(adq);
      store_acc(dq + qoff, stride, c * TILE + r0, q_len, q_len, adq, t);
    }
    named_sync(1 + wg, 128);                // the warpgroup's reads done
    if (leader) mbar_arrive(&s.k_empty);    // K and ds^T free
  }
}

}  // namespace k2
}  // namespace sav

// Dynamic shared memory of K2 where it takes these lengths, else 0;
// mirrored by fused_bwd_fits in ops/flash_attention.py.
extern "C" int sav_flash_bwd_fused_smem(int q_len, int kv_rows) {
  using namespace sav::k2;
  return q_len <= MAX_ROWS && kv_rows <= MAX_ROWS ? SMEM : 0;
}

// q, o, dout, dq [B, q_len, H*64]; k, v, dk, dv [B, kv_rows, H*64]; lse
// [B, H, q_len] f32. All bf16 unless noted.
extern "C" int sav_flash_bwd_fused(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, void* dq, void* dk,
                                   void* dv, int batch, int q_len, int kv_rows,
                                   int kv_len, int heads, void* stream) {
  using namespace sav::k2;
  using sav::sm90::band_map;
  if (sav_flash_bwd_fused_smem(q_len, kv_rows) == 0)
    return (int)cudaErrorInvalidValue;
  const int width = heads * BD;
  CUtensorMap maps[10];
  const void* bases[5] = {q, dout, k, v, o};
  int err = 0;
  for (int i = 0; i < 5 && !err; ++i) {
    const bool keys = i == 2 || i == 3;
    const int rows = keys ? kv_len : q_len, image = keys ? kv_rows : q_len;
    err = band_map(&maps[2 * i], bases[i], batch, rows, image, width, 64);
    if (!err)
      err = band_map(&maps[2 * i + 1], bases[i], batch, rows, image, width,
                     16);
  }
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_fused_kernel<<<persistent_grid(heads * batch), THREADS, SMEM,
                           (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      maps[8], maps[9], lse,
      (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, batch,
      q_len, kv_rows, kv_len, heads);
  return (int)cudaGetLastError();
}
