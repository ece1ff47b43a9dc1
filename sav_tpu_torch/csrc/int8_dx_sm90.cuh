// The K14 port on Hopper (wgmma, TMA, mbarriers; sm90.cuh): the two int8 dx
// products of the SwitchBack FF backward on one persistent, warp-
// specialised s8 GEMM with three epilogues (int8_ff.cu says what is
// computed and in which order each value is rounded; the pieces it shares
// with K12 and K13 are in int8_sm90.cuh).
//
//  ABSMAX  gq W2q^T over 128 x 128 tiles of [M, F], dequant, gelu'(hpre):
//          the f32 dh; dh in bf16 (the output) and each (row, tile)'s
//          absmax of |dh| to amax [M, ceil(F / 128)].
//  CODES   the same product and epilogue again (int32 sums are exact and
//          the epilogue is the same instructions: the same f32 dh), now
//          with each row's scale dhs = row_scale(the max of its partials),
//          exact and independent of order (row_scale_kernel, between
//          the two): dh's codes dhq [M, F] int8.
//  DY      dhq W1q^T over 128 x 128 tiles of [M, D], dequant, bf16.
// dh's codes are per row over all F columns of the f32 dh, which does not
// fit on chip, so the first product runs twice. (Its f32 result through
// device memory instead, 465 MB out and back at ViT-B, measured slower:
// 1.22 ms against this design's 1.13.)
//
// Both operands of every product are codes stored K-major ([rows][depth],
// the depth contiguous), as 8-bit wgmma needs: g's and dh's codes are [M][K]
// and the weights' codes per IN row are [N][K]. A TMA box is a ring slot's
// depth of codes (64 or 128, the swizzle of that width) x 128 rows; a
// 32-deep step advances 32 bytes, as bf16's 16-deep one. Rows past M and depth past K arrive as zeros from
// TMA's out-of-bounds fill; columns past N (D and F are multiples of 32:
// cait_xs's D = 288 leaves DY a last tile of 32 columns, and ABSMAX and
// CODES a last 64-deep slot of 32 codes) are zeros too, and nothing past
// M or N is stored (DY's epilogue stops at N, loading no scale past it).
//
// Block: 20 warps, persistent, two teams. Team r (warps 8 r .. 8 r + 7,
// two warpgroups) takes the units 2 (blockIdx.x + j gridDim.x) + r, each a
// 128 x 128 output tile (column tiles fastest: a block's two teams work on
// one row tile, side by side), through a ring of its own (STAGES slots of
// A 8 KB + B 8 KB, full and empty mbarriers) fed by a producer warp of
// its own (warp 16 + r of the producer warpgroup, lane 0) (Ring: five
// slots 64 codes deep beside the staging tiles, three 128 deep in DY).
// Warpgroup q of a team holds rows 64 q.. of the tile (one m64n128k32
// product a 32-deep step, 64 s32 accumulators a thread). ABSMAX's and CODES's epilogues run on the team's staging tile:
// the unit's hpre tile arrives in it by TMA (two boxes of 64 columns)
// while the unit's products run, each thread reads its elements and writes
// dh (bf16, in place) or dh's codes (after a team barrier) back, and a
// staging warp of the team (warp 18 + r) stores the tile by TMA and, once
// the store has read it, loads the team's next hpre tile into it, while
// the team goes on. So the epilogues' device-memory traffic is whole
// tiles. The two teams take turns at the products (an mbarrier
// each), so that one team's epilogue runs under the other's products.
#pragma once

#include "int8_sm90.cuh"

namespace sav {
namespace q8dx {

using namespace q8w;
using q8::dequant;

enum Mode { ABSMAX = 0, CODES = 1, DY = 2 };

// DY's ring is the deep one (int8_sm90.cuh).
template <int MODE>
using Ring = RingOf<MODE == DY>;

struct Args {
  int m, dim, hidden;
  const float* gs;      // [M] g's row scales (quantize_rows_kernel)
  const float* s2;      // [F]
  const float* s1;      // [D]
  float* amax;          // ABSMAX out [M, parts(F)]
  const float* dhs;     // CODES, DY in [M]
  bf16* dy;             // DY out [M, D]
};

template <int MODE>
__host__ __device__ __forceinline__ int out_cols(const Args& a) {
  return MODE == DY ? a.dim : a.hidden;
}

template <int MODE>
__host__ __device__ __forceinline__ int units_of(const Args& a) {
  return (a.m + BM - 1) / BM * col_tiles(out_cols<MODE>(a));
}

// Ring stages of the contraction (D for ABSMAX and CODES, F for DY).
template <int MODE>
__host__ __device__ __forceinline__ int stages_of(const Args& a) {
  return ((MODE == DY ? a.hidden : a.dim) + Ring<MODE>::BK - 1)
         / Ring<MODE>::BK;
}

// The cotangent of jax.nn.gelu (tanh form) at x for the output cotangent
// g, in the operation order of jax.vjp's f32 graph:
// e = 3 x^2; i = tanh(c (x + a x^3)); p = (0.5 (x g)) (1 - i);
// s = c (p + p i); return (g (0.5 (1 + i)) + s) + (a s) e.
__device__ __forceinline__ float gelu_vjp(float x, float g) {
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x, x2);
  const float i = tanhf(__fmul_rn(0.7978845608028654f,
                                  __fadd_rn(x, __fmul_rn(0.044715f, x3))));
  const float p = __fmul_rn(__fmul_rn(0.5f, __fmul_rn(x, g)), __fsub_rn(1.f, i));
  const float s = __fmul_rn(0.7978845608028654f, __fadd_rn(p, __fmul_rn(p, i)));
  const float l = __fmul_rn(0.5f, __fadd_rn(1.f, i));
  return __fadd_rn(__fadd_rn(__fmul_rn(g, l), s),
                   __fmul_rn(__fmul_rn(0.044715f, s), __fmul_rn(3.f, x2)));
}

// ma/mb: the A and B maps of the mode's product; mh: hpre's (bf16, boxes of
// 128 rows x 64 columns); mo: the staging tile's destination (ABSMAX: dh,
// as mh; CODES: dhq, as ma).
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
dx_gemm_kernel(const __grid_constant__ CUtensorMap ma,
               const __grid_constant__ CUtensorMap mb,
               const __grid_constant__ CUtensorMap mh,
               const __grid_constant__ CUtensorMap mo, Args args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  using R = Ring<MODE>;
  constexpr int STAGES = R::STAGES, BK = R::BK;
  constexpr uint32_t A_BYTES = R::A_BYTES, STAGE_BYTES = R::STAGE_BYTES;
  const int units = units_of<MODE>(args);
  const int nk = stages_of<MODE>(args);
  const int nt = col_tiles(out_cols<MODE>(args));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int team = warp < 2 * TEAM_WARPS ? warp / TEAM_WARPS
                                         : (warp - 2 * TEAM_WARPS) & 1;
  unsigned char* ring = base + team * STAGES * STAGE_BYTES;
  unsigned char* stg = base + Plan::OFF_STG + team * STG_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + Plan::OFF_BAR);
  uint64_t* full = bars + team * MAX_STAGES;
  uint64_t* empty = bars + 2 * MAX_STAGES + team * MAX_STAGES;
  uint64_t* stg_full = bars + 4 * MAX_STAGES + team;
  uint64_t* turn = bars + 4 * MAX_STAGES + 2;  // [2]: a team's turn
  uint64_t* written = bars + 4 * MAX_STAGES + 4 + team;  // tile written
  constexpr bool STAGED = MODE != DY;
  const int first = 2 * blockIdx.x + team, stride = 2 * gridDim.x;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * MAX_STAGES; ++i) {
      mbar_init(&bars[i], 1);                          // expect_tx
      mbar_init(&bars[2 * MAX_STAGES + i], TEAM_WARPS);  // each team warp
    }
    mbar_init(&bars[4 * MAX_STAGES], 1);   // the staging tiles' full
    mbar_init(&bars[4 * MAX_STAGES + 1], 1);
    mbar_init(&turn[0], TEAM_WARPS);       // each warp of the other team
    mbar_init(&turn[1], TEAM_WARPS);
    mbar_init(&bars[4 * MAX_STAGES + 4], 1);  // the tiles' written
    mbar_init(&bars[4 * MAX_STAGES + 5], 1);
    fence_mbar_init();
  }
  __syncthreads();

  // the staging tile's hpre for unit uu
  const CUtensorMap* pmh = &mh;
  auto load_hpre = [=](int uu) {
    const int row0 = (uu / nt) * BM, col0 = (uu % nt) * BN;
    mbar_arrive_expect_tx(stg_full, STG_BYTES);
    tma_load_3d(stg, pmh, stg_full, col0, row0, 0);
    tma_load_3d(stg + BM * 128, pmh, stg_full, col0 + 64, row0, 0);
  };
  const bool leader = warp < 2 * TEAM_WARPS && (warp & 7) == 0 && lane == 0;

  if (warp >= 2 * TEAM_WARPS) {            // the producer warpgroup: warps
    setmaxnreg_dec<PRODUCER_REGS>();       // 16 and 17 feed teams 0 and 1,
    if (lane != 0) return;                 // 18 and 19 their staging tiles
    if (warp >= 2 * TEAM_WARPS + 2) {
      if (!STAGED) return;
      // the tile's hpre in, the team's dh or codes out once written, the
      // next unit's hpre in once the store has read the tile
      if (first < units) load_hpre(first);
      for (int u = first, j = 0; u < units; u += stride, ++j) {
        mbar_wait(written, j & 1);
        const int row0 = (u / nt) * BM, col0 = (u % nt) * BN;
        tma_store_3d(&mo, stg, col0, row0, 0);
        if (MODE == ABSMAX)
          tma_store_3d(&mo, stg + BM * 128, col0 + 64, row0, 0);
        bulk_commit();
        bulk_wait_read();
        if (u + stride < units) load_hpre(u + stride);
      }
      return;
    }
    int step = 0;
    for (int u = first; u < units; u += stride) {
      const int row0 = (u / nt) * BM, col0 = (u % nt) * BN;
      for (int k = 0; k < nk; ++k, ++step) {
        const int s = step % STAGES;
        mbar_wait(&empty[s], ((step / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        tma_load_3d(st, &ma, &full[s], k * BK, row0, 0);
        tma_load_3d(st + A_BYTES, &mb, &full[s], k * BK, col0, 0);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int q = (warp >> 2) & 1, wi = warp & 3;   // warpgroup in the team
  const int g = lane >> 2, t = lane & 3;
  const int n = out_cols<MODE>(args);
  const int nparts = parts(args.hidden);
  int step = 0;
  uint32_t sp = 0;                         // staging tile phase, this team
  for (int u = first, j = 0; u < units; u += stride, ++j) {
    const int row0 = (u / nt) * BM, col0 = (u % nt) * BN;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    // the staged modes take turns at the products, team 0 first: the
    // other team's epilogue runs under them
    if (STAGED) wait(&turn[team], team == 0 ? (j & 1) ^ 1 : j & 1);
    for (int k = 0; k < nk; ++k, ++step) {
      const int s = step % STAGES;
      wait(&full[s], (step / STAGES) & 1);
      const unsigned char* st = ring + s * STAGE_BYTES;
      // A: rows 64 q.. of the stage's 128; B: all 128 columns
      const uint64_t da = BK == 64 ? desc_k_major_sw64(st + q * (64 * BK))
                                   : desc_k_major(st + q * (64 * BK));
      const uint64_t db = BK == 64 ? desc_k_major_sw64(st + A_BYTES)
                                   : desc_k_major(st + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_ss_s8_n128(acc, da + kk * K_STEP, db + kk * K_STEP);
      wgmma_commit();
      // the previous stage's products are done: its slot is free
      wgmma_wait<1>();
      if (k > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) {
      mbar_arrive(&empty[(step - 1) % STAGES]);
      if (STAGED) mbar_arrive(&turn[team ^ 1]);
    }

    // epilogue: thread (wi, g, t) holds tile rows r = 64 q + 16 wi + g (+ 8),
    // columns c = 8 i + 2 t (+ 1)
    const int r0 = 64 * q + 16 * wi + g;
    if constexpr (MODE == DY) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = row0 + r0 + 8 * rh;
        if (row >= args.m) continue;
        const float rs = args.dhs[row];
        bf16* dst = args.dy + (size_t)row * n + col0 + 2 * t;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (col0 + 8 * i >= n) break;     // for every lane or for none
          const float2 cs = *reinterpret_cast<const float2*>(
              args.s1 + col0 + 8 * i + 2 * t);
          *reinterpret_cast<uint32_t*>(dst + 8 * i) = pack_bf16(
              dequant(acc[4 * i + 2 * rh], rs, cs.x),
              dequant(acc[4 * i + 2 * rh + 1], rs, cs.y));
        }
      }
      continue;
    } else {
      wait(stg_full, sp);
      sp ^= 1;
      float rs[2], hsc[2], hinv[2], mx[2] = {0.f, 0.f};
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = row0 + r0 + 8 * rh;
        rs[rh] = row < args.m ? args.gs[row] : 0.f;
        hsc[rh] = MODE == CODES && row < args.m ? args.dhs[row] : 1.f;
        hinv[rh] = __frcp_rn(hsc[rh]);
      }
      uint32_t codes[16];                  // CODES: char2 pairs, two a word
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = 8 * i + 2 * t;
        // columns past N hold zeros (hpre and acc): dh = 0
        const float2 cs = col0 + c < n ? *reinterpret_cast<const float2*>(
                                             args.s2 + col0 + c)
                                       : make_float2(0.f, 0.f);
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          uint32_t* sh = reinterpret_cast<uint32_t*>(stg + stg_bf16(r0 + 8 * rh, c));
          const float2 h = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sh));
          const float d0 = gelu_vjp(h.x, dequant(acc[4 * i + 2 * rh], rs[rh], cs.x));
          const float d1 = gelu_vjp(h.y,
                                    dequant(acc[4 * i + 2 * rh + 1], rs[rh], cs.y));
          if constexpr (MODE == ABSMAX) {
            mx[rh] = fmaxf(mx[rh], fmaxf(fabsf(d0), fabsf(d1)));
            *sh = pack_bf16(d0, d1);
          } else {
            const uint32_t pair =
                (uint32_t)(uint8_t)(signed char)quantize_by(d0, hsc[rh], hinv[rh])
                | ((uint32_t)(uint8_t)(signed char)quantize_by(d1, hsc[rh],
                                                               hinv[rh]) << 8);
            if (rh == 0) codes[i] = pair;
            else codes[i] |= pair << 16;
          }
        }
      }
      if constexpr (MODE == ABSMAX) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          // the 4 lanes of a row (equal g); every lane takes part
          float v = mx[rh];
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          const int row = row0 + r0 + 8 * rh;
          if (row < args.m && t == 0)
            args.amax[(size_t)row * nparts + col0 / BN] = v;
        }
      } else {
        named_sync(1 + team, TEAM_WARPS * 32);   // every hpre read is done
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
            *reinterpret_cast<uint16_t*>(stg + stg_code(r0 + 8 * rh, 8 * i + 2 * t)) =
                (uint16_t)(codes[i] >> (16 * rh));
      }
      fence_proxy_async();                 // the tile is TMA's to store
      named_sync(1 + team, TEAM_WARPS * 32);
      if (leader) mbar_arrive(written);
    }
  }
}

template <int MODE>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb,
                   const CUtensorMap& mh, const CUtensorMap& mo,
                   const Args& args, cudaStream_t st) {
  static_assert(Plan::SMEM <= 232448, "over the block's shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      dx_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Plan::SMEM);
  if (e != cudaSuccess) return e;
  dx_gemm_kernel<MODE><<<grid_for(units_of<MODE>(args)), THREADS, Plan::SMEM,
                         st>>>(ma, mb, mh, mo, args);
  return cudaGetLastError();
}

}  // namespace q8dx
}  // namespace sav
