// The pieces the talking-heads kernels on Hopper share: the backward (K5b
// and K6b, th_bwd.cu) and the two-sweep forward (K6a, th_fwd_sm90.cuh).
// Both run work tiles of 64 resident rows of one image x all H heads of 48
// columns: a mix warpgroup holds every head of its positions in registers
// (wgmma m64n16k16 per head gives all heads one accumulator layout) and
// mixes them with the [H, H] weights in the constant bank (c_mix); an
// accumulate warpgroup takes the mixed, bf16-rounded tile of every head
// from an exchange buffer (xidx) as wgmma's register A operand against
// one TMA box per head at column 48h (acc_step), its 64 x 48 x H outputs in
// registers (store_rows); a producer warp streams 16-row tiles by TMA.
// Layout of every band tile: th_bwd.cu's header. At H = 16 the forward
// accumulates its heads in two groups of 8 (th_fwd_sm90.cuh's header) and
// the backward is staged through device memory (th_bwd_staged.cuh).
#pragma once

#include "flash_sm90.cuh"

namespace sav {
namespace thb {

using namespace sm90;
using flash::exp2_approx;
using flash::kLog2e;

constexpr int TD = 48;                    // head width
constexpr int ROWS = 64;                  // resident rows of a work tile
constexpr int COLS = 16;                  // rows of a streamed tile
constexpr int CONSUMERS = 256;            // mix and accumulate warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
// A 384-thread block starts at 168 registers a thread; setmaxnreg moves
// them between warpgroups within 3 x 168 = 504 (an increase past the pool
// waits forever). The accumulation holds its 64 x 48 x H outputs (192 at H
// = 8); given less than 240, ptxas serialized every wgmma of the kernel
// (C7512). The backward's mix holds s and da (128), or halves of them
// beside a dM sum; the forward's s and its softmax statistics.
constexpr int PRODUCER_REGS = 24;
constexpr int MIX_REGS = 240;
constexpr int ACC_REGS = 240;
constexpr int BOX_RES = ROWS * 64;        // elements of a resident box
constexpr int BOX_STR = COLS * 64;        // elements of a streamed box
constexpr int XHEAD = ROWS * COLS;        // elements of one head's exchange

// [M_pre; M_pre * log2 e; M_post], each [H][H] row-major, for H <= 16
__constant__ float c_mix[3 * 256];

template <int H>
__device__ __forceinline__ float m_pre(int j, int i) {
  return c_mix[j * H + i];
}
template <int H>
__device__ __forceinline__ float m_pre2(int j, int i) {
  return c_mix[H * H + j * H + i];
}
template <int H>
__device__ __forceinline__ float m_post(int j, int i) {
  return c_mix[2 * H * H + j * H + i];
}

// ---- wgmma shapes

// d (+)= A B^T, 64 x 8 over one 16-deep step (B is one 8-row atom), both
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n8(float (&d)[4], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %6, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B^T, 64 x 16 over one 16-deep step, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %10, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, 64 x 48 over one 16-deep step: A [64 x 16] in registers, B
// [16 x 48] MN-major in shared memory (the first 48 columns of a box).
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %29, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, "
      "%28, p, 1, 1, 1;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int H, int N>
__device__ __forceinline__ void fence_all(float (&r)[H][N]) {
#pragma unroll
  for (int h = 0; h < H; ++h) fence_regs(r[h]);
}

// sm90::mbar_wait, then the warp reconverged: its lanes may leave the spin
// on different polls, and the .aligned instructions that follow (wgmma,
// bar.sync, ldmatrix, shuffles) need the whole warp.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

// Position p of a thread's tile: row half (p >> 1) & 1 (rows g and g + 8);
// column 8 (p >> 2) + 2t + (p & 1) of a 16-column tile (P = 8 positions),
// or 8 half + 2t + (p & 1) of its half (P = 4).
template <int P = 8>
__device__ __forceinline__ int pos_col(int p, int t, int half = 0) {
  return (P == 8 ? 8 * (p >> 2) : 8 * half) + 2 * t + (p & 1);
}

// Exchange element of (row, column) in one head's 64 x 16 tile: two 16-byte
// chunks a row, the chunk index flipped on rows 4..7 of every 8 (ldmatrix
// reads 8 rows of one chunk without bank conflicts).
__device__ __forceinline__ int xidx(int row, int col) {
  return row * COLS + ((((col >> 3) ^ (row >> 2)) & 1) << 3) + (col & 7);
}

// The accumulate warpgroup's step: acc_h += X_h B_h for every head, X_h the
// exchange tile (register A operand by ldmatrix), B_h the per-head box of
// the slot read MN-major. Two heads a commit group (8 A registers).
template <int H>
__device__ __forceinline__ void acc_step(float (&acc)[H][24], const bf16* x,
                                         uint64_t str1, int wi, int lane) {
  const int row = 16 * wi + (lane & 15), chunk = lane >> 4;
  asm volatile("" : "+l"(str1));            // descriptors formed per call
#pragma unroll
  for (int hg = 0; hg < H / 2; ++hg) {
    uint32_t a[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const bf16* src = x + (2 * hg + hh) * XHEAD + xidx(row, 8 * chunk);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(a[hh][0]), "=r"(a[hh][1]), "=r"(a[hh][2]), "=r"(a[hh][3])
          : "r"(smem_addr(src)));
    }
    wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      wgmma_rs_n48(acc[2 * hg + hh], a[hh],
                   str1 + (2 * hg + hh) * (BOX_STR * 2 / 16));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) fence_regs(acc[2 * hg + hh]);
  }
}

// Rows of a 64-row accumulator (24 registers a head) of G heads -> out
// rows < L, rows ld elements apart (out at the first head's column).
template <int G>
__device__ __forceinline__ void store_rows(const float (&acc)[G][24],
                                           bf16* out, int ld, int row0,
                                           int lrow, int t, int L) {
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = row0 + lrow + 8 * rh;
    if (row >= L) continue;
    bf16* dst = out + (size_t)row * ld + 2 * t;
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int i = 0; i < 6; ++i)
        *reinterpret_cast<uint32_t*>(dst + TD * h + 8 * i) =
            pack_bf16x2(acc[h][4 * i + 2 * rh], acc[h][4 * i + 2 * rh + 1]);
  }
}

}  // namespace thb
}  // namespace sav
