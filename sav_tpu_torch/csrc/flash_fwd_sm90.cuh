// The flash attention forward on Hopper (wgmma, TMA, mbarriers): K4's
// kernel (flash_fwd.cu) and the attention launch of K1
// (fused_attention.cu).
//
// Replaces sav_tpu/ops/flash_attention.py::_fwd_kernel (launcher _fwd) and
// the attention core inside sav_tpu/ops/fused_layer.py::_fused_fwd_kernel.
// Per (image, head), with q pre-scaled:
//   out = softmax(q k^T) v,   lse = m + log l   ([B, H, Lq] f32)
// keys in [kv_len, kv_rows) masked, p rounded to bf16 before p v (as the
// TPU kernel feeds its product), f32 accumulation, out in bf16. No query
// row is dropped and none past q_len is stored.
//
// Bound on the card: 4*Lq*Lkv*64 operations against q, k, v, out and lse
// per (image, head): at ViT lengths 25-72 operations a byte, under the
// H100's ~295, so reading each operand once bounds it. Before that, at
// d = 64 the exponentials (16 a clock on an SM's special-function units)
// take as long as the products, and the chain from a tile's logits
// through its softmax to its p v bounds each warpgroup: the design keeps
// the products running while p is formed.
//
// Design (helpers in sm90.cuh, flash_sm90.cuh). Persistent: one block per
// SM walks work tiles of 128 query rows of one (head, image), the heads of
// an image in turn, so their K and V bands stay in L2. 384 threads: a
// producer warpgroup (one thread issues TMA; setmaxnreg gives its
// registers to the consumers) and two consumer warpgroups, each owning 64
// of the tile's query rows.
//  * Q arrives by TMA in one of two slots (the next work tile's while this
//    one runs) and is held as the register A operand; the slot is freed at
//    once. K and V stream in 64-row tiles through a ring of STAGES slots
//    (full/empty mbarriers), continuing from one work tile into the next.
//  * s = Q K^T on wgmma with K K-major; o += p V with p packed to bf16 in
//    registers and V read MN-major (the transpose bit: nothing transposed
//    by hand).
//  * Online softmax in registers: p = 2^(s log2 e - m log2 e) as one FFMA
//    and ex2.approx; keys past kv_len get s = -inf (selects, no branches).
//  * Overlap: each step issues key tile j's s together with tile j-1's
//    p V and forms tile j's p while p V runs, then rescales o; the two
//    warpgroups interleave on top of that. Every commit group is waited
//    for inside the step that issues it (ptxas serializes wgmma when a
//    group stays in flight across a loop's back edge), so the tiles run in
//    pairs with p alternating between two register arrays. Measured on the
//    card and dropped as slower (PERF.md): FlashAttention-3's
//    ping-pong of the two warpgroups on named barriers, steps of two key
//    tiles, a quarter or half of the exponentials as a polynomial on the
//    FMA pipe, and the last p V of a work tile issued beside the next work
//    tile's first s (ptxas then serializes the wgmmas).
//  * A last key tile of 1-16 rows runs m64n16k16 (577 = 9 x 64 + 1,
//    197 = 3 x 64 + 5).
#pragma once

#include "flash_sm90.cuh"

namespace sav {
namespace k4 {

using namespace flash;

constexpr int BLOCK_ROWS = 128;           // query rows of a work tile
constexpr int STAGES = 4;                 // ring slots of K/V tiles

struct Smem {
  bf16 q[2][2 * TILE_ELEMS];
  bf16 k[STAGES][TILE_ELEMS];
  bf16 v[STAGES][TILE_ELEMS];
  uint64_t q_full[2], q_empty[2], full[STAGES], empty[STAGES];
};

// dynamic shared memory asked for: the struct and the alignment slack
constexpr int SMEM = (int)sizeof(Smem) + 1024;

// One consumer thread's share of its warpgroup's 64 query rows: rows g and
// g + 8 of its warp's 16 (the accumulator layout), their running max (raw
// logits) and per-thread partial sums.
struct Rows {
  float o[32];
  float m0, m1, l0, l1;
};

// Tile j's logits in sc -> p (in place), packed as the register A operand
// of p V; the running max and sums move on, and (a0, a1) is the factor o
// must take once the previous p V is in. key0: the key of this thread's
// first column; full: no key of the tile is masked.
template <int W>
__device__ __forceinline__ void online_softmax(Rows& r, float (&sc)[W / 2],
                                               uint32_t (&pa)[W / 16][4],
                                               int key0, int kv_len,
                                               bool full, float& a0,
                                               float& a1) {
  if (!full) {
#pragma unroll
    for (int i = 0; i < W / 8; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool in = key0 + 8 * i + j < kv_len;
        sc[4 * i + j] = in ? sc[4 * i + j] : -INFINITY;
        sc[4 * i + 2 + j] = in ? sc[4 * i + 2 + j] : -INFINITY;
      }
    }
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
  pack_frags<W>(pa, sc);
}

__device__ __forceinline__ void rescale(Rows& r, float a0, float a1) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.o[4 * i] *= a0;
    r.o[4 * i + 1] *= a0;
    r.o[4 * i + 2] *= a1;
    r.o[4 * i + 3] *= a1;
  }
}

// Where a consumer thread is in its work tile: ring step of key tile 0,
// its column offset (2t), the unmasked keys, and whether it frees slots.
struct Pos {
  int step0, t2, kv_len;
  bool leader;
};

// Tile j (W_S wide) once the previous tile's p (W_P wide, in pp) is
// formed: s of tile j and pp V of tile j - 1 on the tensor cores, p of
// tile j into pn while they run, then o rescaled and tile j - 1's slot
// freed. j = 0 has no previous tile (W_P = 0).
template <int W_S, int W_P>
__device__ __forceinline__ void tile_step(Rows& r,
                                          const uint32_t (&pp)[W_P ? W_P / 16 : 1][4],
                                          uint32_t (&pn)[W_S / 16][4],
                                          const uint32_t (&q_a)[4][4],
                                          Smem& s, const Pos& p, int j) {
  const int step = p.step0 + j, st = step % STAGES;
  const int pst = (step + STAGES - 1) % STAGES;
  float sc[W_S / 2];
  mbar_wait(&s.full[st], (step / STAGES) & 1);
  wgmma_fence();
  mma_xy<W_S>(sc, q_a, s.k[st]);                           // s = Q K^T
  if constexpr (W_P > 0) {
    mma_rs<W_P>(r.o, pp, s.v[pst]);                        // o += p V
    wgmma_commit();
  }
  wgmma_wait<W_P ? 1 : 0>();
  fence_regs(sc);
  float a0, a1;
  online_softmax<W_S>(r, sc, pn, j * TILE + p.t2, p.kv_len,
                      (j * TILE) + W_S <= p.kv_len, a0, a1);
  if constexpr (W_P > 0) {
    wgmma_wait<0>();
    fence_regs(r.o);
    if (p.leader) mbar_arrive(&s.empty[pst]);
  }
  rescale(r, a0, a1);
}

// The last tile's p V (tile j, W wide), and its slot freed.
template <int W>
__device__ __forceinline__ void last_pv(Rows& r,
                                        const uint32_t (&pp)[W / 16][4],
                                        Smem& s, const Pos& p, int j) {
  const int st = (p.step0 + j) % STAGES;
  wgmma_fence();
  mma_rs<W>(r.o, pp, s.v[st]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(r.o);
  if (p.leader) mbar_arrive(&s.empty[st]);
}

// From the last full-width tile n_wide - 1 (its p in pp): the 1-16-row
// tail tile if kv_len has one, then the last p V.
__device__ __forceinline__ void finish_tiles(Rows& r,
                                             const uint32_t (&pp)[4][4],
                                             const uint32_t (&q_a)[4][4],
                                             Smem& s, const Pos& p,
                                             int n_wide) {
  if (n_wide * TILE < p.kv_len) {
    uint32_t p16[1][4];
    tile_step<16, 64>(r, pp, p16, q_a, s, p, n_wide);
    last_pv<16>(r, p16, s, p, n_wide);
  } else {
    last_pv<64>(r, pp, s, p, n_wide - 1);
  }
}

// out, lse (may be null): [B, q_len, H*64] bf16 and [B, H, q_len] f32.
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ out, float* __restrict__ lse, int batch,
                 int q_len, int kv_len, int heads) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const int tid = threadIdx.x;
  const int nx = (q_len + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int tiles = nx * heads * batch;
  const int n_k = (kv_len + TILE - 1) / TILE;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.q_full[i], 1);
      mbar_init(&s.q_empty[i], 2);          // one arrival per warpgroup
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
      mbar_wait(&s.q_empty[slot], ((n >> 1) & 1) ^ 1);
      mbar_arrive_expect_tx(&s.q_full[slot], 2 * TILE_BYTES);
      for (int i = 0; i < 2; ++i)
        tma_load_3d(s.q[slot] + i * TILE_ELEMS, &tq, &s.q_full[slot],
                    w.h * BD, q0 + i * TILE, w.b);
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
  const bool leader = wt == 0;
  const int stride = heads * BD;
  const int n_wide = wide_tiles(kv_len);
  int step = 0;
  for (int tile = blockIdx.x, n = 0; tile < tiles; tile += gridDim.x, ++n) {
    const Work w = work_of(tile, nx, heads);
    const int slot = n & 1;
    const int row0 = w.x * BLOCK_ROWS + wg * TILE + wi * 16 + g;  // +8 too
    uint32_t q_a[4][4];
    mbar_wait(&s.q_full[slot], (n >> 1) & 1);
    load_a_frags(q_a, s.q[slot] + wg * TILE_ELEMS, wi, lane);
    warpgroup_sync(1 + wg);                 // the slot is read: free it
    if (leader) mbar_arrive(&s.q_empty[slot]);

    Rows r;
#pragma unroll
    for (int i = 0; i < 32; ++i) r.o[i] = 0.f;
    r.m0 = r.m1 = -INFINITY;
    r.l0 = r.l1 = 0.f;
    const Pos p{step, 2 * t, kv_len, leader};
    const uint32_t none[1][4] = {};         // tile 0 has no previous p
    if (n_wide > 0) {
      uint32_t pa[4][4], pb[4][4];
      tile_step<64, 0>(r, none, pa, q_a, s, p, 0);
      int j = 1;
      // pairs of full-width tiles, p alternating between pa and pb
      for (; j + 1 < n_wide; j += 2) {
        tile_step<64, 64>(r, pa, pb, q_a, s, p, j);
        tile_step<64, 64>(r, pb, pa, q_a, s, p, j + 1);
      }
      if (j < n_wide) {                     // one full-width tile left
        tile_step<64, 64>(r, pa, pb, q_a, s, p, j);
        finish_tiles(r, pb, q_a, s, p, n_wide);
      } else {
        finish_tiles(r, pa, q_a, s, p, n_wide);
      }
    } else {                                // kv_len <= 16: one narrow tile
      uint32_t p16[1][4];
      tile_step<16, 0>(r, none, p16, q_a, s, p, 0);
      last_pv<16>(r, p16, s, p, 0);
    }
    step += n_k;

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, off);
      r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, off);
    }
    const float inv0 = 1.f / r.l0, inv1 = 1.f / r.l1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      r.o[4 * i] *= inv0;
      r.o[4 * i + 1] *= inv0;
      r.o[4 * i + 2] *= inv1;
      r.o[4 * i + 3] *= inv1;
    }
    store_acc(out + (size_t)w.b * q_len * stride + w.h * BD, stride, row0,
              q_len, q_len, r.o, t);
    if (lse != nullptr && t == 0) {
      float* lb = lse + ((size_t)w.b * heads + w.h) * q_len;
      if (row0 < q_len) lb[row0] = r.m0 + logf(r.l0);
      if (row0 + 8 < q_len) lb[row0 + 8] = r.m1 + logf(r.l1);
    }
  }
}

// q, out [B, q_len, H*64]; k, v [B, kv_rows, H*64] bf16; lse [B, H, q_len]
// f32 or null. Returns 0 or a cudaError_t.
inline int flash_fwd(const void* q, const void* k, const void* v, void* out,
                     float* lse, int batch, int q_len, int kv_rows,
                     int kv_len, int heads, cudaStream_t stream) {
  const int width = heads * BD;
  CUtensorMap tq, tk, tv;
  int err = band_map(&tq, q, batch, q_len, q_len, width);
  if (!err) err = band_map(&tk, k, batch, kv_len, kv_rows, width);
  if (!err) err = band_map(&tv, v, batch, kv_len, kv_rows, width);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (q_len + BLOCK_ROWS - 1) / BLOCK_ROWS * heads * batch;
  flash_fwd_kernel<<<persistent_grid(tiles), THREADS, SMEM, stream>>>(
      tq, tk, tv, (bf16*)out, lse, batch, q_len, kv_len, heads);
  return (int)cudaGetLastError();
}

}  // namespace k4
}  // namespace sav
