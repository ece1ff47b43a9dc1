// The K16 port's GEMM on Hopper (wgmma, TMA, mbarriers; sm90.cuh): one
// persistent, warp-specialised kernel for the three kinds of product of
// the FF backward (ff_bwd.cu says what they compute).
//
//  GELU   dgact = g W2^T over 128 x 256 tiles of [M, F], with the gelu'
//         epilogue: dh = bf16(dgact gelu'(hpre)), h = bf16(gelu(hpre)),
//         and the tile's f32 column sums of dh (the db1 partial of its
//         128 rows).
//  DY     dy = dh W1^T over 128 x 256 tiles of [M, D], stored as bf16.
//  WGRAD  dW1 = y^T dh and dW2 = h^T g in one launch, the M rows split into
//         `chunks` chunks of kt_per 64-row steps (split-K): each (tile,
//         chunk) unit writes its own f32 partial, which sum_partials adds
//         in a fixed order (no float atomics, the same bits on every run).
//
// Operands are read in the layouts they have, by the descriptors' two
// forms (sm90.cuh): GELU and DY take A [M][K] and B [N][K] K-major (TMA
// boxes of 128 and 256 rows x 64 columns); WGRAD takes y, h, dh and g
// [M][*] MN-major, the 64 depth rows of a step x 128 (A) or 256 (B)
// output columns as 64-column boxes (the transpose bits of wgmma).
// Nothing is copied or padded: rows past M, and columns past N in a
// tile's second half where N is an odd number of 128-wide tiles
// (ff_kernel_supported takes any multiple of 128), arrive as zeros from
// TMA's out-of-bounds fill and are never stored.
//
// Block: 384 threads, persistent over the units (blockIdx.x, + gridDim.x,
// ...), each a 128 x 256 output tile. Warpgroup 2's first lane is the
// producer: it streams each unit's 64-deep steps, A (16 KB) and B (32 KB),
// through a ring of STAGES slots (full and empty mbarriers). Warpgroups 0
// and 1 are consumers: warpgroup c holds the tile's 128 x 128 quadrant of
// columns 128 c.. (two m64n128k16 products a 16-deep step, 128 f32
// accumulators a thread), both reading the slot's A. What bounds the
// products here is the operands' traffic from L2 (a 128 x 128 tile a
// warpgroup moves 32 KB a step for 2.1 MFLOP; the shared A makes it 48 KB
// for 4.2), so the tile is as wide as the accumulators allow; while both
// consumers run an epilogue the producer fills the ring for the next unit.
#pragma once

#include "ff_common.cuh"
#include "sm90.cuh"

namespace sav {
namespace ffb {

using namespace sm90;

constexpr int BM = 128, BN = 256, BK = 64;   // a unit's tile and step
constexpr int WN = 128;                      // columns of a warpgroup
constexpr int STAGES = 4;                    // ring slots
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;
// 384 threads start at 168 registers; the producer gives back to 24 so
// that each consumer can take 240 (24 + 2 x 240 = 504 = 3 x 168).
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr uint32_t A_BYTES = BM * BK * 2;            // 16 KB
constexpr uint32_t STAGE_BYTES = A_BYTES + BN * BK * 2;  // then B, 32 KB
constexpr int MAX_CHUNKS = 16;

enum Mode { GELU = 0, DY = 1, WGRAD = 2 };

// Shared memory (bytes from a 1024-byte aligned base); the Python mirror is
// ff_bwd_plan in ops/fused_layer.py.
struct Plan {
  static constexpr int OFF_COL = STAGES * STAGE_BYTES;  // [2][4][WN] f32
  static constexpr int OFF_BAR = OFF_COL + 2 * 4 * WN * 4;
  static constexpr int BARS = 2 * STAGES;
  static constexpr int SMEM = OFF_BAR + BARS * 8 + 1024;
};

struct Args {
  int m, dim, hidden;
  int chunks, kt_per;   // WGRAD's split of the ceil(M / 64) depth steps
  const bf16* hpre;     // GELU: [M][F]
  bf16* dh;             // GELU out [M][F]
  bf16* h;              // GELU out [M][F]
  float* colsum;        // GELU out [ceil(M / 128)][F]
  bf16* dy;             // DY out [M][D]
  float* part;          // WGRAD out [chunks][D F + F D] (dW1 then dW2)
};

// One unit of work: output rows row0.., columns col0.. of product `prod`
// (WGRAD: 0 = dW1, 1 = dW2), depth steps k0 .. k0 + nk - 1 of chunk c.
struct Work {
  int prod, row0, col0, k0, nk, c;
};

__host__ __device__ __forceinline__ int col_tiles(int n) {
  return (n + BN - 1) / BN;
}

// WGRAD's tiles of one chunk: dW1 [D][F], then dW2 [F][D].
__host__ __device__ __forceinline__ int wgrad_tiles(int dim, int hidden) {
  return dim / BM * col_tiles(hidden) + hidden / BM * col_tiles(dim);
}

template <int MODE>
__host__ __device__ __forceinline__ int units_of(const Args& a) {
  const int mt = (a.m + BM - 1) / BM;
  if (MODE == GELU) return mt * col_tiles(a.hidden);
  if (MODE == DY) return mt * col_tiles(a.dim);
  return a.chunks * wgrad_tiles(a.dim, a.hidden);
}

template <int MODE>
__device__ __forceinline__ Work work_of(int u, const Args& a) {
  Work w;
  if (MODE != WGRAD) {                     // column tiles fastest: the A
    const int nt = col_tiles(MODE == GELU ? a.hidden : a.dim);  // rows in L2
    w.prod = 0;
    w.row0 = (u / nt) * BM;
    w.col0 = (u % nt) * BN;
    w.k0 = 0;
    w.nk = (MODE == GELU ? a.dim : a.hidden) / BK;
    w.c = 0;
    return w;
  }
  const int t1 = a.dim / BM * col_tiles(a.hidden);  // tiles of dW1
  const int per = wgrad_tiles(a.dim, a.hidden);
  w.c = u / per;
  int r = u % per;
  w.prod = r >= t1;
  r -= w.prod * t1;
  const int nt = col_tiles(w.prod ? a.dim : a.hidden);  // dW1 [D][F], dW2 [F][D]
  w.row0 = (r / nt) * BM;
  w.col0 = (r % nt) * BN;
  const int kt = (a.m + BK - 1) / BK;
  w.k0 = w.c * a.kt_per;
  w.nk = min(a.kt_per, kt - w.k0);
  return w;
}

// sm90::mbar_wait, then the warp reconverged (the .aligned instructions
// after it need the whole warp).
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

// a0/b0: the A and B maps (WGRAD: of dW1's product), a1/b1: dW2's.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
ff_gemm_kernel(const __grid_constant__ CUtensorMap a0,
               const __grid_constant__ CUtensorMap b0,
               const __grid_constant__ CUtensorMap a1,
               const __grid_constant__ CUtensorMap b1, Args args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  float* scol = reinterpret_cast<float*>(base + Plan::OFF_COL);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Plan::OFF_BAR);
  uint64_t* empty = full + STAGES;
  constexpr bool MN = MODE == WGRAD;
  const int units = units_of<MODE>(args);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);              // the producer's expect_tx
      mbar_init(&empty[i], 8);             // each consumer warp once
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {                  // producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != CONSUMERS) return;          // one thread issues every load
    int step = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Work w = work_of<MODE>(u, args);
      const CUtensorMap* ma = w.prod ? &a1 : &a0;
      const CUtensorMap* mb = w.prod ? &b1 : &b0;
      for (int k = 0; k < w.nk; ++k, ++step) {
        const int s = step % STAGES;
        mbar_wait(&empty[s], ((step / STAGES) & 1) ^ 1);
        unsigned char* st = base + s * STAGE_BYTES;
        const int kk = (w.k0 + k) * BK;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        if (!MN) {                         // [rows][64 deep] boxes
          tma_load_3d(st, ma, &full[s], kk, w.row0, 0);
          tma_load_3d(st + A_BYTES, mb, &full[s], kk, w.col0, 0);
        } else {                           // [64 deep][64 columns] boxes
          for (int c = 0; c < BM / 64; ++c)
            tma_load_3d(st + c * 8192, ma, &full[s], w.row0 + 64 * c, kk, 0);
          for (int c = 0; c < BN / 64; ++c)
            tma_load_3d(st + A_BYTES + c * 8192, mb, &full[s],
                        w.col0 + 64 * c, kk, 0);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = tid >> 7, wt = tid & 127, wi = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int step = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Work w = work_of<MODE>(u, args);
    const int col0 = w.col0 + WN * wg;     // this warpgroup's columns
    float acc[2][64];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[hh][i] = 0.f;
    for (int k = 0; k < w.nk; ++k, ++step) {
      const int s = step % STAGES;
      wait(&full[s], (step / STAGES) & 1);
      const unsigned char* st = base + s * STAGE_BYTES;
      // A: rows 64 hh.. of the tile (K-major: 64 rows further in the box;
      // MN-major: the second box); B: the warpgroup's 128 columns (K-major:
      // rows 128 wg.. of the 256-row box; MN-major: boxes 2 wg, 2 wg + 1)
      const unsigned char* b = st + A_BYTES + wg * (WN * BK * 2);
      const uint64_t da = MN ? desc_mn_major(st) : desc_k_major(st);
      const uint64_t db = MN ? desc_encode(b, 8192, 1024) : desc_k_major(b);
      constexpr uint64_t STEP = MN ? MN_STEP : K_STEP;
      constexpr uint64_t HALF = 8192 >> 4;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          wgmma_ss_n128<MN, MN>(acc[hh], da + hh * HALF + kk * STEP,
                                db + kk * STEP);
      wgmma_commit();
      // the previous step's products are done: its slot is free
      wgmma_wait<1>();
      if (k > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (w.nk > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % STAGES]);
    // a second half past N (N an odd number of 128-wide tiles) is zeros
    if (col0 >= (MODE == GELU ? args.hidden : MODE == DY ? args.dim
                 : w.prod ? args.dim : args.hidden))
      continue;

    // epilogue: thread (wi, g, t) holds rows 64 hh + 16 wi + g (+ 8),
    // columns 8 i + 2 t (+ 1) of the tile
    if constexpr (MODE == GELU) {
      float cs[16][2];
#pragma unroll
      for (int i = 0; i < 16; ++i) cs[i][0] = cs[i][1] = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int row = w.row0 + 64 * hh + 16 * wi + g + 8 * rh;
          if (row >= args.m) continue;
          const size_t off = (size_t)row * args.hidden + col0 + 2 * t;
          // the row's 16 hpre pairs loaded before any is used: one memory
          // latency a row, not one a pair
          __nv_bfloat162 hpr[16];
#pragma unroll
          for (int i = 0; i < 16; ++i)
            hpr[i] = *reinterpret_cast<const __nv_bfloat162*>(args.hpre + off
                                                              + 8 * i);
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const __nv_bfloat162 hp2 = hpr[i];
            float dv[2], hv[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float hp = __bfloat162float(j ? hp2.y : hp2.x);
              const float th = ff::gelu_t(hp);
              dv[j] = acc[hh][4 * i + 2 * rh + j] * ff::gelu_bwd(hp, th);
              hv[j] = 0.5f * hp * (1.f + th);
              cs[i][j] += dv[j];
            }
            *reinterpret_cast<uint32_t*>(args.dh + off + 8 * i) =
                pack_bf16x2(dv[0], dv[1]);
            *reinterpret_cast<uint32_t*>(args.h + off + 8 * i) =
                pack_bf16x2(hv[0], hv[1]);
          }
        }
      // fixed order: the thread's rows, the 8 lanes of equal t (xor over
      // g), then the warps in order
      float* sc = scol + wg * 4 * WN;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v = cs[i][j];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) sc[wi * WN + 8 * i + 2 * t + j] = v;
        }
      warpgroup_sync(1 + wg);
      args.colsum[(size_t)(w.row0 / BM) * args.hidden + col0 + wt] =
          ((sc[wt] + sc[WN + wt]) + sc[2 * WN + wt]) + sc[3 * WN + wt];
      warpgroup_sync(1 + wg);              // sc free for the next tile
    } else if constexpr (MODE == DY) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int row = w.row0 + 64 * hh + 16 * wi + g + 8 * rh;
          if (row >= args.m) continue;
          bf16* dst = args.dy + (size_t)row * args.dim + col0 + 2 * t;
#pragma unroll
          for (int i = 0; i < 16; ++i)
            *reinterpret_cast<uint32_t*>(dst + 8 * i) = pack_bf16x2(
                acc[hh][4 * i + 2 * rh], acc[hh][4 * i + 2 * rh + 1]);
        }
    } else {
      const size_t plane = (size_t)args.dim * args.hidden;
      const int cols = w.prod ? args.dim : args.hidden;
      float* out = args.part + (size_t)w.c * 2 * plane + w.prod * plane;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int row = w.row0 + 64 * hh + 16 * wi + g + 8 * rh;
          float* dst = out + (size_t)row * cols + col0 + 2 * t;
#pragma unroll
          for (int i = 0; i < 16; ++i)
            *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(
                acc[hh][4 * i + 2 * rh], acc[hh][4 * i + 2 * rh + 1]);
        }
    }
  }
}

// One block per SM, or one per unit if fewer.
inline int grid_for(int units) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return units < sms || sms <= 0 ? units : sms;
}

template <int MODE>
cudaError_t launch(const CUtensorMap& a0, const CUtensorMap& b0,
                   const CUtensorMap& a1, const CUtensorMap& b1,
                   const Args& args, cudaStream_t st) {
  static_assert(Plan::SMEM <= 232448, "over the block's shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      ff_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Plan::SMEM);
  if (e != cudaSuccess) return e;
  const int units = units_of<MODE>(args);
  ff_gemm_kernel<MODE><<<grid_for(units), THREADS, Plan::SMEM, st>>>(
      a0, b0, a1, b1, args);
  return cudaGetLastError();
}

// WGRAD's split of M: the chunk count (at most MAX_CHUNKS, none empty)
// whose estimated time is least, in units of a sixth of one 64-deep step of
// a block: ceil(units / SMs) rounds of kt_per steps, plus the partials'
// write and sum (each chunk ~ tiles / 6 of those units, 24 steps' time at
// ViT-B's 144 tiles). Ties go to fewer chunks. Mirrored by ff_bwd_plan.
inline void split_k(int m, int dim, int hidden, int sms, int* chunks,
                    int* kt_per) {
  const int kt = (m + BK - 1) / BK;
  const long long tiles = wgrad_tiles(dim, hidden);
  const long long slots = sms > 0 ? sms : 1;
  long long best = -1;
  *chunks = 1;
  *kt_per = kt;
  for (int s = 1; s <= MAX_CHUNKS && s <= kt; ++s) {
    const int per = (kt + s - 1) / s;
    if ((kt + per - 1) / per != s) continue;   // a chunk would be empty
    const long long rounds = (tiles * s + slots - 1) / slots;
    const long long cost = 6 * rounds * per + s * tiles;
    if (best < 0 || cost < best) {
      best = cost;
      *chunks = s;
      *kt_per = per;
    }
  }
}

}  // namespace ffb
}  // namespace sav
