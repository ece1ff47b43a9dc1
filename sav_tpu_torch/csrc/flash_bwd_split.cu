// K3 port: the flash attention backward for heads longer than one block
// holds (K2 in flash_bwd.cu takes L16 <= 208).
//
// Replaces sav_tpu/ops/flash_attention.py::_dq_kernel (K3a) and
// ::_dkv_kernel (K3b). Same function as K2: q (pre-scaled), k, v, o, do as
// [B, L, H*64] bf16 head bands, lse [B, H, Lq] f32 from the forward; per
// head
//   p  = exp(q k^T - lse)          (f32; keys past kv_len masked to -inf)
//   d  = rowsum(o * do)            (f32 from o and do in bf16)
//   dv = bf16(p)^T do
//   ds = bf16(p * (do v^T - d))
//   dq = ds k,  dk = ds^T q
// with f32 accumulation and bf16 outputs. Query rows past q_len read as
// zeros with lse = +inf and d = 0 (so p = 0) and are never stored; keys in
// [kv_len, kv_rows) read as zeros, their logits are masked and their dk and
// dv rows are written as exact zeros. No row is dropped: every tile count is
// a ceiling.
//
// Bound on the card: 10*L*L*d operations of the function against 8 band
// tensors and lse per (image, head); at ViT-B/16 @384 (L = 577) that is
// ~230 operations a byte, under the H100's ~295, so the tensor cores bound
// it. The split recomputes s and dp in both kernels (14*L*L*d), and forms
// p (an exp) for every entry twice: the special-function unit and the f32
// work on the tiles are the next limits.
//
// Design (Hopper: wgmma, TMA, mbarriers; helpers in sm90.cuh). Each block
// runs two consumer warpgroups and a producer warpgroup (384 threads) of
// which one warp works; setmaxnreg moves registers from the producer (56)
// to the consumers (224). Both kernels are persistent: one block per SM
// walks work tiles of 128 rows of one (head, image).
//  * K3b (flash_bwd_dkv_kernel): a work tile's K and V (128 rows) arrive by
//    TMA in one of two slots, and each consumer warpgroup (64 keys) holds
//    its K and V rows as register A operands. The producer streams 64-row
//    tiles of Q and dO by TMA through a ring of STAGES slots (full/empty
//    mbarriers), with each tile's lse and delta. s^T = K Q^T and dp^T =
//    V dO^T run on wgmma; p^T and ds^T are formed in registers and fed back
//    as the register A operand of dV += p^T dO and dK += ds^T Q, whose B is
//    the same Q/dO tile read MN-major (the descriptor's transpose bit,
//    nothing transposed by hand). dK and dV stay in registers until the
//    work tile's epilogue.
//  * K3a (flash_bwd_dq_kernel), the roles swapped: a work tile's Q, dO and
//    O arrive in one of two slots; the consumers form delta from O and dO
//    (and write it for K3b) and hold their Q and dO rows as register A
//    operands; the producer streams K and V tiles; s = Q K^T, dp = dO V^T,
//    then dQ += ds K with ds from registers and K read MN-major. Each work
//    tile owns its dq rows over all keys: no atomics, and dq, dk, dv are
//    bitwise repeatable.
//  * Operands are described to TMA as [B, rows, H*64] with a 64 x 64 box
//    at column h*64 and the 128-byte swizzle (sm90::band_map), rows = q_len
//    for q/o/do and kv_len for k/v, so the ragged tails arrive as zeros and
//    no box crosses into the next image. A streamed last tile of 1-16 rows
//    (L = 577 = 9 x 64 + 1) runs 16 columns wide.
//  * p = 2^(s log2 e - lse log2 e) by one FFMA and ex2.approx (the accurate
//    exp2f, with its range fix-ups and the mask as branches, cost K3a a
//    third of its time on the card).
#include "flash_sm90.cuh"

namespace sav {
namespace k3 {

using namespace flash;

constexpr int BLOCK_ROWS = 128;           // rows of a work tile
constexpr int STAGES = 3;                 // ring slots of streamed tiles

// Shared memory of each kernel; tiles first, each on a 1024-byte boundary.
// The rows a work tile keeps resident have two slots (tile n uses slot
// n % 2), so the producer loads the next tile's while this one runs.
struct DqSmem {
  bf16 q[2][2 * TILE_ELEMS];
  bf16 dout[2][2 * TILE_ELEMS];
  bf16 o[2][2 * TILE_ELEMS];
  bf16 k[STAGES][TILE_ELEMS];
  bf16 v[STAGES][TILE_ELEMS];
  float delta[BLOCK_ROWS];
  uint64_t res_full[2], res_empty[2], full[STAGES], empty[STAGES];
};

struct DkvSmem {
  bf16 k[2][2 * TILE_ELEMS];
  bf16 v[2][2 * TILE_ELEMS];
  bf16 q[STAGES][TILE_ELEMS];
  bf16 dout[STAGES][TILE_ELEMS];
  float lse[STAGES][TILE];
  float delta[STAGES][TILE];
  uint64_t res_full[2], res_empty[2], full[STAGES], empty[STAGES];
};

// dynamic shared memory asked for: the struct and the alignment slack
constexpr int DQ_SMEM = (int)sizeof(DqSmem) + 1024;
constexpr int DKV_SMEM = (int)sizeof(DkvSmem) + 1024;

// p = 2^(s log2 e - lse log2 e): one FFMA and ex2; a masked or padded entry
// gets the exponent -inf.

// K3a: p of one key tile in place of its s; the thread's two rows' lse
// (l2a, l2b, times log2 e; +inf on padded queries); columns at or past
// kv_len get p = 0 (none when the tile is full).
template <int W>
__device__ __forceinline__ void dq_p(float (&sc)[W / 2], int key0, int kv_len,
                                     float l2a, float l2b, bool full_tile) {
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool in = full_tile || key0 + 8 * i + j < kv_len;
      sc[4 * i + j] = exp2_approx(
          in ? fmaf(sc[4 * i + j], kLog2e, -l2a) : -INFINITY);
      sc[4 * i + 2 + j] = exp2_approx(
          in ? fmaf(sc[4 * i + 2 + j], kLog2e, -l2b) : -INFINITY);
    }
  }
}

// K3a: ds in place of dp (p in sc); the two rows' delta (da, db).
template <int W>
__device__ __forceinline__ void dq_ds(const float (&sc)[W / 2],
                                      float (&dp)[W / 2], float da, float db) {
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      dp[4 * i + j] = sc[4 * i + j] * (dp[4 * i + j] - da);
      dp[4 * i + 2 + j] = sc[4 * i + 2 + j] * (dp[4 * i + 2 + j] - db);
    }
  }
}

// One step of the consumers' loop over the streamed tiles: s and dp of
// tile j as two commit groups; wait<1> retires s, so p is formed on the
// CUDA cores while dp runs on the tensor cores; wait<0>, ds; p and ds
// packed as register A operands of tile j's products, which are waited for
// before the slot is released. (Starting tile j+1's s and dp before forming
// tile j's p was measured slower here: K3b then spills, and both kernels'
// wgmmas are serialized by ptxas around the loop's back edge.)
// j: the tile's index within the work tile; step: its index in the ring's
// stream over all of the block's work tiles.
template <int W>
__device__ __forceinline__ void dq_tile(float (&adq)[32], DqSmem& s, int j,
                                        int step, const uint32_t (&q_a)[4][4],
                                        const uint32_t (&do_a)[4][4],
                                        int kv_len, int t, bool leader,
                                        float l2a, float l2b, float da,
                                        float db) {
  const int st = step % STAGES;
  float sc[W / 2], dp[W / 2];
  uint32_t a[W / 16][4];
  mbar_wait(&s.full[st], (step / STAGES) & 1);
  wgmma_fence();
  mma_xy<W>(sc, q_a, s.k[st]);                             // s = Q K^T
  mma_xy<W>(dp, do_a, s.v[st]);                            // dp = dO V^T
  wgmma_wait<1>();
  fence_regs(sc);
  dq_p<W>(sc, j * TILE + 2 * t, kv_len, l2a, l2b, (j + 1) * TILE <= kv_len);
  wgmma_wait<0>();
  fence_regs(dp);
  dq_ds<W>(sc, dp, da, db);
  pack_frags<W>(a, dp);
  wgmma_fence();
  mma_rs<W>(adq, a, s.k[st]);                              // dq += ds K
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(adq);
  if (leader) mbar_arrive(&s.empty[st]);
}

template <int W>
__device__ __forceinline__ void dkv_tile(float (&adk)[32], float (&adv)[32],
                                         DkvSmem& s, int step,
                                         const uint32_t (&k_a)[4][4],
                                         const uint32_t (&v_a)[4][4], int t,
                                         bool leader,
                                         bool ok0, bool ok1) {
  const int st = step % STAGES;
  float sc[W / 2], dp[W / 2];
  uint32_t pa[W / 16][4], da[W / 16][4];
  mbar_wait(&s.full[st], (step / STAGES) & 1);
  wgmma_fence();
  mma_xy<W>(sc, k_a, s.q[st]);                             // s^T = K Q^T
  mma_xy<W>(dp, v_a, s.dout[st]);                          // dp^T = V dO^T
  wgmma_wait<1>();
  fence_regs(sc);
  keyrow_p<W>(sc, s.lse[st], ok0, ok1, t);
  wgmma_wait<0>();
  fence_regs(dp);
  keyrow_ds<W>(sc, dp, s.delta[st], t);
  pack_frags<W>(pa, sc);
  pack_frags<W>(da, dp);
  wgmma_fence();
  mma_rs<W>(adv, pa, s.dout[st]);                          // dv += p^T dO
  mma_rs<W>(adk, da, s.q[st]);                             // dk += ds^T Q
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(adv);
  fence_regs(adk);
  if (leader) mbar_arrive(&s.empty[st]);
}

// Both kernels are persistent (flash::work_of). The producer runs ahead
// across work tiles: the next tile's resident rows go into the other slot
// while this tile's loop runs, and the ring of streamed tiles continues
// from one work tile into the next (its step counts on).

// K3a: 384 threads. Work tiles of 128 query rows. Writes dq and delta
// [B, H, q_len] (read by K3b).
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int batch, int q_len, int kv_len,
                    int heads) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& s = *reinterpret_cast<DqSmem*>(align1024(smem_raw));
  const int tid = threadIdx.x;
  const int nx = (q_len + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int tiles = nx * heads * batch;
  const int n_k = (kv_len + TILE - 1) / TILE;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.res_full[i], 1);
      mbar_init(&s.res_empty[i], 2);        // one arrival per warpgroup
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {                   // producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != CONSUMERS) return;           // one thread works
    int step = 0;
    for (int tile = blockIdx.x, n = 0; tile < tiles;
         tile += gridDim.x, ++n) {
      const Work w = work_of(tile, nx, heads);
      const int slot = n & 1, q0 = w.x * BLOCK_ROWS;
      mbar_wait(&s.res_empty[slot], ((n >> 1) & 1) ^ 1);
      mbar_arrive_expect_tx(&s.res_full[slot], 6 * TILE_BYTES);
      for (int i = 0; i < 2; ++i) {
        const int r = q0 + i * TILE;
        tma_load_3d(s.q[slot] + i * TILE_ELEMS, &tq, &s.res_full[slot], w.h * BD, r, w.b);
        tma_load_3d(s.dout[slot] + i * TILE_ELEMS, &tdo, &s.res_full[slot], w.h * BD, r, w.b);
        tma_load_3d(s.o[slot] + i * TILE_ELEMS, &to, &s.res_full[slot], w.h * BD, r, w.b);
      }
      for (int it = 0; it < n_k; ++it, ++step) {
        const int st = step % STAGES;
        mbar_wait(&s.empty[st], ((step / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&s.full[st], 2 * TILE_BYTES);
        tma_load_3d(s.k[st], &tk, &s.full[st], w.h * BD, it * TILE, w.b);
        tma_load_3d(s.v[st], &tv, &s.full[st], w.h * BD, it * TILE, w.b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. of each tile
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = tid >> 7, wt = tid & 127, wi = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = wg * TILE + wi * 16 + g;          // local rows lrow, +8
  const bool leader = wt == 0;
  const int stride = heads * BD;
  const int n_wide = wide_tiles(kv_len);
  int step = 0;
  for (int tile = blockIdx.x, n = 0; tile < tiles; tile += gridDim.x, ++n) {
    const Work w = work_of(tile, nx, heads);
    const int slot = n & 1, q0 = w.x * BLOCK_ROWS, row0 = q0 + lrow;
    const size_t srow = ((size_t)w.b * heads + w.h) * q_len;
    const float l2a = row0 < q_len ? lse[srow + row0] * kLog2e : INFINITY;
    const float l2b =
        row0 + 8 < q_len ? lse[srow + row0 + 8] * kLog2e : INFINITY;
    mbar_wait(&s.res_full[slot], (n >> 1) & 1);

    // delta = rowsum(o * do): two threads per row; o and do share the
    // swizzle, so a row's 128 bytes hold the same columns in both tiles.
    {
      const int r = wg * TILE + (wt >> 1);
      const uint4* ou =
          reinterpret_cast<const uint4*>(s.o[slot] + r * BD) + (wt & 1) * 4;
      const uint4* du =
          reinterpret_cast<const uint4*>(s.dout[slot] + r * BD) + (wt & 1) * 4;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint4 ov = ou[c], dv = du[c];
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc += __bfloat162float(oe[j]) * __bfloat162float(de[j]);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if ((wt & 1) == 0) {
        s.delta[r] = acc;
        if (q0 + r < q_len) delta[srow + q0 + r] = acc;
      }
    }
    warpgroup_sync(1 + wg);
    const float da = s.delta[lrow], db = s.delta[lrow + 8];
    warpgroup_sync(1 + wg);                 // read before the next tile's

    uint32_t q_a[4][4], do_a[4][4];
    load_a_frags(q_a, s.q[slot] + wg * TILE_ELEMS, wi, lane);
    load_a_frags(do_a, s.dout[slot] + wg * TILE_ELEMS, wi, lane);
    float adq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) adq[i] = 0.f;
    for (int j = 0; j < n_wide; ++j, ++step)
      dq_tile<64>(adq, s, j, step, q_a, do_a, kv_len, t, leader, l2a, l2b,
                  da, db);
    if (n_wide < n_k)
      dq_tile<16>(adq, s, n_wide, step++, q_a, do_a, kv_len, t, leader, l2a,
                  l2b, da, db);
    if (leader) mbar_arrive(&s.res_empty[slot]);
    store_acc(dq + (size_t)w.b * q_len * stride + w.h * BD, stride, row0,
              q_len, q_len, adq, t);
  }
}

// K3b: 384 threads. Work tiles of 128 key rows; reads the delta K3a wrote.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int batch, int q_len, int kv_rows,
                     int kv_len, int heads) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem& s = *reinterpret_cast<DkvSmem*>(align1024(smem_raw));
  const int tid = threadIdx.x;
  const int nx = (kv_rows + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int tiles = nx * heads * batch;
  const int n_q = (q_len + TILE - 1) / TILE;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.res_full[i], 1);
      mbar_init(&s.res_empty[i], 2);
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 33);            // TMA lane + 32 stat writers
      mbar_init(&s.empty[i], 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {                   // producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid >= CONSUMERS + 32) return;      // one warp works
    const int lane = tid & 31;
    int step = 0;
    for (int tile = blockIdx.x, n = 0; tile < tiles;
         tile += gridDim.x, ++n) {
      const Work w = work_of(tile, nx, heads);
      const int slot = n & 1, k0 = w.x * BLOCK_ROWS;
      const size_t srow = ((size_t)w.b * heads + w.h) * q_len;
      if (lane == 0) {
        mbar_wait(&s.res_empty[slot], ((n >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&s.res_full[slot], 4 * TILE_BYTES);
        for (int i = 0; i < 2; ++i) {
          const int r = k0 + i * TILE;
          tma_load_3d(s.k[slot] + i * TILE_ELEMS, &tk, &s.res_full[slot], w.h * BD, r, w.b);
          tma_load_3d(s.v[slot] + i * TILE_ELEMS, &tv, &s.res_full[slot], w.h * BD, r, w.b);
        }
      }
      for (int it = 0; it < n_q; ++it, ++step) {
        const int st = step % STAGES;
        float l[2], d[2];                   // loaded before the slot frees
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = it * TILE + lane + 32 * i;
          l[i] = r < q_len ? lse[srow + r] * kLog2e : INFINITY;
          d[i] = r < q_len ? delta[srow + r] : 0.f;
        }
        mbar_wait(&s.empty[st], ((step / STAGES) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&s.full[st], 2 * TILE_BYTES);
          tma_load_3d(s.q[st], &tq, &s.full[st], w.h * BD, it * TILE, w.b);
          tma_load_3d(s.dout[st], &tdo, &s.full[st], w.h * BD, it * TILE, w.b);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s.lse[st][lane + 32 * i] = l[i];
          s.delta[st][lane + 32 * i] = d[i];
        }
        mbar_arrive(&s.full[st]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64 wg .. of each tile
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = tid >> 7, wt = tid & 127, wi = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool leader = wt == 0;
  const int stride = heads * BD;
  const int n_wide = wide_tiles(q_len);
  int step = 0;
  for (int tile = blockIdx.x, n = 0; tile < tiles; tile += gridDim.x, ++n) {
    const Work w = work_of(tile, nx, heads);
    const int slot = n & 1;
    const int key0 = w.x * BLOCK_ROWS + wg * TILE + wi * 16 + g;  // +8 too
    const bool ok0 = key0 < kv_len, ok1 = key0 + 8 < kv_len;
    float adk[32], adv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) adk[i] = adv[i] = 0.f;
    mbar_wait(&s.res_full[slot], (n >> 1) & 1);
    uint32_t k_a[4][4], v_a[4][4];
    load_a_frags(k_a, s.k[slot] + wg * TILE_ELEMS, wi, lane);
    load_a_frags(v_a, s.v[slot] + wg * TILE_ELEMS, wi, lane);
    for (int j = 0; j < n_wide; ++j, ++step)
      dkv_tile<64>(adk, adv, s, step, k_a, v_a, t, leader, ok0, ok1);
    if (n_wide < n_q)
      dkv_tile<16>(adk, adv, s, step++, k_a, v_a, t, leader, ok0, ok1);
    if (leader) mbar_arrive(&s.res_empty[slot]);
    const size_t koff = (size_t)w.b * kv_rows * stride + w.h * BD;
    store_acc(dk + koff, stride, key0, kv_rows, kv_len, adk, t);
    store_acc(dv + koff, stride, key0, kv_rows, kv_len, adv, t);
  }
}

}  // namespace k3
}  // namespace sav

// Dynamic shared memory of K3a (which = 0) and K3b (which = 1); mirrored by
// split_plan in ops/flash_attention.py.
extern "C" int sav_flash_bwd_split_smem(int which) {
  return which == 0 ? sav::k3::DQ_SMEM : sav::k3::DKV_SMEM;
}

// q, o, dout, dq [B, q_len, H*64]; k, v [B, kv_rows, H*64]; lse, delta
// [B, H, q_len] f32. All bf16 unless noted; writes dq and delta.
extern "C" int sav_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const float* lse, float* delta, void* dq,
                                int batch, int q_len, int kv_rows, int kv_len,
                                int heads, void* stream) {
  using namespace sav::k3;
  const int width = heads * BD;
  CUtensorMap tq, tk, tv, to, tdo;
  int err = 0;
  if (!err) err = sav::sm90::band_map(&tq, q, batch, q_len, q_len, width);
  if (!err) err = sav::sm90::band_map(&tk, k, batch, kv_len, kv_rows, width);
  if (!err) err = sav::sm90::band_map(&tv, v, batch, kv_len, kv_rows, width);
  if (!err) err = sav::sm90::band_map(&to, o, batch, q_len, q_len, width);
  if (!err) err = sav::sm90::band_map(&tdo, dout, batch, q_len, q_len, width);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (q_len + BLOCK_ROWS - 1) / BLOCK_ROWS * heads * batch;
  flash_bwd_dq_kernel<<<sav::flash::persistent_grid(tiles), THREADS, DQ_SMEM,
                        (cudaStream_t)stream>>>(
      tq, tk, tv, to, tdo, lse, delta, (__nv_bfloat16*)dq, batch, q_len, kv_len,
      heads);
  return (int)cudaGetLastError();
}

// dk, dv [B, kv_rows, H*64] from the delta sav_flash_bwd_dq wrote.
extern "C" int sav_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv,
                                 int batch, int q_len, int kv_rows, int kv_len,
                                 int heads, void* stream) {
  using namespace sav::k3;
  const int width = heads * BD;
  CUtensorMap tq, tk, tv, tdo;
  int err = 0;
  if (!err) err = sav::sm90::band_map(&tq, q, batch, q_len, q_len, width);
  if (!err) err = sav::sm90::band_map(&tk, k, batch, kv_len, kv_rows, width);
  if (!err) err = sav::sm90::band_map(&tv, v, batch, kv_len, kv_rows, width);
  if (!err) err = sav::sm90::band_map(&tdo, dout, batch, q_len, q_len, width);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DKV_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (kv_rows + BLOCK_ROWS - 1) / BLOCK_ROWS * heads * batch;
  flash_bwd_dkv_kernel<<<sav::flash::persistent_grid(tiles), THREADS, DKV_SMEM,
                         (cudaStream_t)stream>>>(
      tq, tk, tv, tdo, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, batch,
      q_len, kv_rows, kv_len, heads);
  return (int)cudaGetLastError();
}
