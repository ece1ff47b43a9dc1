// The pieces the Hopper flash kernels share: K4 (flash_fwd_sm90.cuh, the
// forward, also K1's attention launch), K2 (flash_bwd.cu, the one-launch
// backward) and K3 (flash_bwd_split.cu, the backward past 208 rows).
//
// Layout: q, k, v, o and their gradients are [B, rows, H*64] bf16 head
// bands; every operand tile in shared memory is a TMA box of the band map
// (sm90::band_map) with the 128-byte swizzle, 64 columns (one head) wide.
// Products are wgmma with the accumulator layout of sm90.cuh: thread (warp
// w, lane g*4+t) holds rows 16w+g and 16w+g+8 of a 64-row tile, columns
// 8i+2t and 8i+2t+1.
//
// A streamed tile of `rows` rows is 64 wide, but a last tile of 1-16 rows
// runs W = 16 columns wide (m64n16k16 products, one 16-deep step): at
// L = 577 = 9 x 64 + 1 and L = 197 = 3 x 64 + 5 that saves the padding of
// a whole tile.
#pragma once

#include <math.h>

#include "sm90.cuh"

namespace sav {

typedef __nv_bfloat16 bf16;               // as mma.cuh declares it

namespace flash {

using namespace sm90;

constexpr int BD = 64;                    // head width
constexpr int TILE = 64;                  // rows of a full tile / wgmma M
constexpr int TILE_ELEMS = TILE * BD;
constexpr uint32_t TILE_BYTES = TILE_ELEMS * 2;
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int PRODUCER_REGS = 56;         // 128 x 56 + 256 x 224 <= 65536
constexpr int CONSUMER_REGS = 224;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error ~2^-22; 2^-inf = 0).
// With the scale folded into one FFMA this replaces the accurate exp2f,
// whose range fix-ups cost K3a a third of its time on the card.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Tiles of `rows` rows run W = 64 wide, a last tile of 1-16 rows W = 16:
// the count of full-width tiles.
__host__ __device__ __forceinline__ int wide_tiles(int rows) {
  const int rem = rows % TILE;
  return rem == 0 || rem > 16 ? (rows + TILE - 1) / TILE : rows / TILE;
}

// Rows those tiles cover: every row below `rows`, rounded up to its tile.
__host__ __device__ __forceinline__ int cover_rows(int rows) {
  return wide_tiles(rows) * TILE + (wide_tiles(rows) * TILE < rows ? 16 : 0);
}

// 64 x 64 f32 accumulator rows (row0 = this thread's first row, row0 + 8
// the second) -> bf16 band rows below `valid`; rows at or past `zero_from`
// are written as zeros.
__device__ __forceinline__ void store_acc(bf16* dst, int stride, int row0,
                                          int valid, int zero_from,
                                          const float (&acc)[32], int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= valid) continue;
    const bool keep = row < zero_from;
    bf16* p = dst + (size_t)row * stride + 2 * t;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint32_t*>(p + 8 * i) =
          keep ? pack_bf16x2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1])
               : 0u;
  }
}

// d = X Y^T (64 x W, 64 deep; X the warpgroup's resident rows as register
// A operands, Y's first W rows of a tile, K-major) as one commit group.
// Holding X in registers halves the products' shared-memory reads.
template <int W>
__device__ __forceinline__ void mma_xy(float (&d)[W / 2],
                                       const uint32_t (&x)[4][4],
                                       const bf16* y) {
  const uint64_t yd = desc_k_major(y);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (W == 64)
      wgmma_rs_k(d, x[kk], yd + kk * K_STEP, kk);
    else
      wgmma_rs_k_n16(d, x[kk], yd + kk * K_STEP, kk);
  }
  wgmma_commit();
}

// acc += A Y, A [64 x W] from registers, Y the first W rows of a tile read
// MN-major (not committed: the caller groups it).
template <int W>
__device__ __forceinline__ void mma_rs(float (&acc)[32],
                                       const uint32_t (&a)[W / 16][4],
                                       const bf16* y) {
  const uint64_t yd = desc_mn_major(y);
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    wgmma_rs_mn(acc, a[kk], yd + kk * MN_STEP);
}

template <int W>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[W / 16][4],
                                           const float (&d)[W / 2]) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) a_frag(a[kk], d, kk);
}

// The backward's p and ds with keys on the rows (K2 and K3b): p^T of one
// query tile in place of its s^T, from the tile's lse (times log2 e; +inf
// on padded queries, so p = 0 there) in shared memory; keys at or past
// kv_len (ok0, ok1: the thread's two rows) get p = 0. Then ds^T in place
// of dp^T from the tile's delta (0 on padded queries).
template <int W>
__device__ __forceinline__ void keyrow_p(float (&sc)[W / 2], const float* sl,
                                         bool ok0, bool ok1, int t) {
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
    const float2 l = *reinterpret_cast<const float2*>(sl + 8 * i + 2 * t);
    sc[4 * i] = exp2_approx(ok0 ? fmaf(sc[4 * i], kLog2e, -l.x) : -INFINITY);
    sc[4 * i + 1] =
        exp2_approx(ok0 ? fmaf(sc[4 * i + 1], kLog2e, -l.y) : -INFINITY);
    sc[4 * i + 2] =
        exp2_approx(ok1 ? fmaf(sc[4 * i + 2], kLog2e, -l.x) : -INFINITY);
    sc[4 * i + 3] =
        exp2_approx(ok1 ? fmaf(sc[4 * i + 3], kLog2e, -l.y) : -INFINITY);
  }
}

template <int W>
__device__ __forceinline__ void keyrow_ds(const float (&sc)[W / 2],
                                          float (&dp)[W / 2], const float* sd,
                                          int t) {
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
    const float2 d = *reinterpret_cast<const float2*>(sd + 8 * i + 2 * t);
    dp[4 * i] = sc[4 * i] * (dp[4 * i] - d.x);
    dp[4 * i + 1] = sc[4 * i + 1] * (dp[4 * i + 1] - d.y);
    dp[4 * i + 2] = sc[4 * i + 2] * (dp[4 * i + 2] - d.x);
    dp[4 * i + 3] = sc[4 * i + 3] * (dp[4 * i + 3] - d.y);
  }
}

// Persistent kernels walk work tiles blockIdx.x, + gridDim.x, ... of
// (row tile, head, image), the row tile fastest, so concurrent blocks share
// a head's streamed rows in L2, and the heads of one image follow each
// other.
struct Work {
  int x, h, b;
};

__device__ __forceinline__ Work work_of(int tile, int nx, int heads) {
  return {tile % nx, (tile / nx) % heads, tile / (nx * heads)};
}

// Persistent grid: one block per SM, or one per work tile if fewer.
inline int persistent_grid(int tiles) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return tiles < sms || sms <= 0 ? tiles : sms;
}

}  // namespace flash
}  // namespace sav
