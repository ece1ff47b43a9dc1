// The K12 and K13 ports on Hopper (wgmma, TMA, mbarriers; sm90.cuh): the
// whole int8 FF forward as three launches of one persistent, warp-
// specialised s8 GEMM with five epilogues (int8_ff.cu says what is computed
// and in which order each value is rounded; the pieces it shares with K14
// are in int8_sm90.cuh).
//
//  ABSMAX  xq W1q over 128 x 128 tiles of [M, F], dequant + b1: the f32
//          hpre; each (row, tile)'s absmax of |gelu(hpre)| to amax
//          [M, ceil(F / 128)]. HPRE is the same and also writes hpre in
//          bf16 (save_hpre) through the team's staging tile.
//  CODES   the same product and epilogue again (int32 sums are exact and
//          the epilogue is the same instructions: the same f32 gelu), now
//          with each row's scale hs = row_scale(the max of its partials)
//          (row_scale_kernel, between the two): hq [M, F] int8 through
//          the staging tile.
//  OUT     hq W2q over 128 x 128 tiles of [M, D], dequant + b2, bf16;
//          OUT_RES adds x first (K13's residual).
// x's codes come before them from q8::quantize_rows_kernel (LN first for
// K13).
//
// The weights' codes per output column come as [D][F] and [F][D];
// transpose_codes_kernel writes them transposed ([F][D] and [D][F], the
// depth contiguous: the K-major B operand 8-bit wgmma reads) into the
// workspace first. x's and the hidden codes are [M][K]. The block is K14's:
// 20 warps, persistent, two teams of two warpgroups each taking the units
// 2 (blockIdx.x + j gridDim.x) + r (128 x 128 output tiles, column tiles
// fastest) through a ring of its own fed by a producer warp; a staging warp
// a team stores the staging tile by TMA once the team has written it and
// then frees it for the team's next unit. Unlike K14's, the teams multiply
// at once: turns at the products measured slower here (a gelu a value is
// less epilogue than K14's gelu' of a loaded hpre).
#pragma once

#include "int8_sm90.cuh"

namespace sav {
namespace q8ff {

using namespace q8w;
using q8::dequant;

enum Mode { ABSMAX = 0, HPRE = 1, CODES = 2, OUT = 3, OUT_RES = 4 };

// The second product's ring is the deep one (int8_sm90.cuh).
template <int MODE>
using Ring = RingOf<(MODE >= OUT)>;

struct Args {
  int m, dim, hidden;
  const float* xs;      // [M] x's row scales (quantize_rows_kernel)
  const float* s1;      // [F]
  const float* b1;      // [F]
  float* amax;          // ABSMAX, HPRE out [M, parts(F)]
  const float* hs;      // CODES, OUT in [M]
  const float* s2;      // [D]
  const float* b2;      // [D]
  const bf16* x;        // OUT_RES in [M, D]
  bf16* out;            // OUT out [M, D]
};

template <int MODE>
__host__ __device__ __forceinline__ int out_cols(const Args& a) {
  return MODE >= OUT ? a.dim : a.hidden;
}

template <int MODE>
__host__ __device__ __forceinline__ int units_of(const Args& a) {
  return (a.m + BM - 1) / BM * col_tiles(out_cols<MODE>(a));
}

// Ring stages of the contraction (D for the first product, F for OUT).
template <int MODE>
__host__ __device__ __forceinline__ int stages_of(const Args& a) {
  return ((MODE >= OUT ? a.hidden : a.dim) + Ring<MODE>::BK - 1)
         / Ring<MODE>::BK;
}

// jax.nn.gelu(approximate=True) in its own order:
// x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))))
__device__ __forceinline__ float gelu(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f,
                                __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
}

// OUT's shared ring: a slot holds the row tile's A box and both teams' B
// boxes (48 KB), four slots.
constexpr int PAIR_STAGES = 4;

// ma/mb: the A and B maps of the mode's product; mo: the staging tile's
// destination (HPRE: hpre, bf16 boxes of 128 rows x 64 columns; CODES:
// hq, boxes of 128 x 128 codes). PAIR (OUT where D / 128 is even): the
// block's teams take the two column tiles of one pair unit (a row tile,
// column tiles 2 c and 2 c + 1) at once from one ring, whose A box they
// share: a quarter less operand traffic from L2.
template <int MODE, bool PAIR>
__global__ void __launch_bounds__(THREADS, 1)
ff_gemm_kernel(const __grid_constant__ CUtensorMap ma,
               const __grid_constant__ CUtensorMap mb,
               const __grid_constant__ CUtensorMap mo, Args args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  using R = Ring<MODE>;
  constexpr int BK = R::BK;
  constexpr int STAGES = PAIR ? PAIR_STAGES : R::STAGES;
  constexpr uint32_t A_BYTES = R::A_BYTES, B_BYTES = BN * BK;
  constexpr uint32_t STAGE_BYTES = PAIR ? A_BYTES + 2 * B_BYTES
                                        : R::STAGE_BYTES;
  constexpr bool SECOND = MODE >= OUT;
  constexpr bool STAGED = MODE == HPRE || MODE == CODES;
  static_assert(!PAIR || SECOND, "pairs in OUT only");
  static_assert(!PAIR || STAGES * STAGE_BYTES <= (uint32_t)Plan::OFF_BAR,
                "the shared ring (no staging tiles) below the mbarriers");
  const int nt = col_tiles(out_cols<MODE>(args));
  // PAIR: pair units (row tile, column tiles 2 c, 2 c + 1), the block's
  // blockIdx.x + j gridDim.x
  const int units = PAIR ? units_of<MODE>(args) / 2 : units_of<MODE>(args);
  const int nk = stages_of<MODE>(args);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int team = warp < 2 * TEAM_WARPS ? warp / TEAM_WARPS
                                         : (warp - 2 * TEAM_WARPS) & 1;
  const int rt = PAIR ? 0 : team;                // the ring's team
  unsigned char* ring = base + rt * STAGES * STAGE_BYTES;
  unsigned char* stg = base + Plan::OFF_STG + team * STG_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + Plan::OFF_BAR);
  uint64_t* full = bars + rt * MAX_STAGES;
  uint64_t* empty = bars + 2 * MAX_STAGES + rt * MAX_STAGES;
  uint64_t* stg_free = bars + 4 * MAX_STAGES + team;  // tile stored
  uint64_t* written = bars + 4 * MAX_STAGES + 4 + team;  // tile written
  const int first = PAIR ? blockIdx.x : 2 * blockIdx.x + team;
  const int stride = PAIR ? gridDim.x : 2 * gridDim.x;
  // the row tile and the team's column tile of unit u
  auto tile_of = [&](int u, int& row0, int& col0) {
    if (PAIR) {
      row0 = (u / (nt / 2)) * BM;
      col0 = (2 * (u % (nt / 2)) + team) * BN;
    } else {
      row0 = (u / nt) * BM;
      col0 = (u % nt) * BN;
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * MAX_STAGES; ++i) {
      mbar_init(&bars[i], 1);                          // expect_tx
      // each team warp (PAIR: of both teams)
      mbar_init(&bars[2 * MAX_STAGES + i], PAIR ? 2 * TEAM_WARPS : TEAM_WARPS);
    }
    mbar_init(&bars[4 * MAX_STAGES], 1);   // the staging tiles' free
    mbar_init(&bars[4 * MAX_STAGES + 1], 1);
    mbar_init(&bars[4 * MAX_STAGES + 4], 1);  // the tiles' written
    mbar_init(&bars[4 * MAX_STAGES + 5], 1);
    fence_mbar_init();
  }
  __syncthreads();
  const bool leader = warp < 2 * TEAM_WARPS && (warp & 7) == 0 && lane == 0;

  if (warp >= 2 * TEAM_WARPS) {            // the producer warpgroup: warps
    setmaxnreg_dec<PRODUCER_REGS>();       // 16 and 17 feed teams 0 and 1,
    if (lane != 0) return;                 // 18 and 19 store their staging
    if (warp >= 2 * TEAM_WARPS + 2) {      // tiles
      // the team's hpre or codes out once written; the tile is the team's
      // again once the store has read it
      if constexpr (STAGED) {
        for (int u = first, j = 0; u < units; u += stride, ++j) {
          mbar_wait(written, j & 1);
          int row0, col0;
          tile_of(u, row0, col0);
          tma_store_3d(&mo, stg, col0, row0, 0);
          if (MODE == HPRE)
            tma_store_3d(&mo, stg + BM * 128, col0 + 64, row0, 0);
          bulk_commit();
          bulk_wait_read();
          mbar_arrive(stg_free);
        }
      }
      return;
    }
    if (PAIR && team == 1) return;        // warp 16 feeds the shared ring
    int step = 0;
    for (int u = first; u < units; u += stride) {
      int row0, col0;
      tile_of(u, row0, col0);
      for (int k = 0; k < nk; ++k, ++step) {
        const int s = step % STAGES;
        mbar_wait(&empty[s], ((step / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        tma_load_3d(st, &ma, &full[s], k * BK, row0, 0);
        tma_load_3d(st + A_BYTES, &mb, &full[s], k * BK, col0, 0);
        if (PAIR)                          // team 1's column tile
          tma_load_3d(st + A_BYTES + B_BYTES, &mb, &full[s], k * BK,
                      col0 + BN, 0);
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
  for (int u = first, j = 0; u < units; u += stride, ++j) {
    int row0, col0;
    tile_of(u, row0, col0);
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int k = 0; k < nk; ++k, ++step) {
      const int s = step % STAGES;
      wait(&full[s], (step / STAGES) & 1);
      const unsigned char* st = ring + s * STAGE_BYTES;
      // A: rows 64 q.. of the stage's 128; B: all 128 columns
      const uint64_t da = BK == 64 ? desc_k_major_sw64(st + q * (64 * BK))
                                   : desc_k_major(st + q * (64 * BK));
      const unsigned char* bt = st + A_BYTES + (PAIR ? team * B_BYTES : 0);
      const uint64_t db = BK == 64 ? desc_k_major_sw64(bt) : desc_k_major(bt);
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
    if (lane == 0) mbar_arrive(&empty[(step - 1) % STAGES]);

    // epilogue: thread (wi, g, t) holds tile rows r = 64 q + 16 wi + g (+ 8),
    // columns c = 8 i + 2 t (+ 1)
    const int r0 = 64 * q + 16 * wi + g;
    if constexpr (SECOND) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = row0 + r0 + 8 * rh;
        if (row >= args.m) continue;
        const float rs = args.hs[row];
        const size_t off = (size_t)row * n + col0 + 2 * t;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (col0 + 8 * i >= n) break;     // for every lane or for none
          const int c = col0 + 8 * i + 2 * t;
          const float2 cs = *reinterpret_cast<const float2*>(args.s2 + c);
          const float2 cb = *reinterpret_cast<const float2*>(args.b2 + c);
          float f0 = __fadd_rn(dequant(acc[4 * i + 2 * rh], rs, cs.x), cb.x);
          float f1 = __fadd_rn(dequant(acc[4 * i + 2 * rh + 1], rs, cs.y),
                               cb.y);
          if constexpr (MODE == OUT_RES) {
            const float2 x2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(args.x + off + 8 * i));
            f0 = __fadd_rn(x2.x, f0);
            f1 = __fadd_rn(x2.y, f1);
          }
          *reinterpret_cast<uint32_t*>(args.out + off + 8 * i) =
              pack_bf16(f0, f1);
        }
      }
    } else {
      float xsr[2], hsc[2], hinv[2], mx[2] = {0.f, 0.f};
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = row0 + r0 + 8 * rh;
        xsr[rh] = row < args.m ? args.xs[row] : 0.f;
        hsc[rh] = MODE == CODES && row < args.m ? args.hs[row] : 1.f;
        hinv[rh] = __frcp_rn(hsc[rh]);
      }
      // the tile is free once the team's previous store has read it
      if (MODE == HPRE) wait(stg_free, (j & 1) ^ 1);
      uint32_t codes[16];                  // CODES: char2 pairs, two a word
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = 8 * i + 2 * t;
        // columns past N: hpre = 0 (acc is 0 there), gelu(0) = 0
        const bool in = col0 + c < n;
        const float2 cs = in ? *reinterpret_cast<const float2*>(
                                   args.s1 + col0 + c)
                             : make_float2(0.f, 0.f);
        const float2 cb = in ? *reinterpret_cast<const float2*>(
                                   args.b1 + col0 + c)
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const float h0 = __fadd_rn(dequant(acc[4 * i + 2 * rh], xsr[rh],
                                             cs.x), cb.x);
          const float h1 = __fadd_rn(dequant(acc[4 * i + 2 * rh + 1], xsr[rh],
                                             cs.y), cb.y);
          const float a0 = gelu(h0), a1 = gelu(h1);
          if constexpr (MODE == CODES) {
            const uint32_t pair =
                (uint32_t)(uint8_t)(signed char)quantize_by(a0, hsc[rh], hinv[rh])
                | ((uint32_t)(uint8_t)(signed char)quantize_by(a1, hsc[rh],
                                                               hinv[rh]) << 8);
            if (rh == 0) codes[i] = pair;
            else codes[i] |= pair << 16;
          } else {
            mx[rh] = fmaxf(mx[rh], fmaxf(fabsf(a0), fabsf(a1)));
            if (MODE == HPRE)
              *reinterpret_cast<uint32_t*>(stg + stg_bf16(r0 + 8 * rh, c)) =
                  pack_bf16(h0, h1);
          }
        }
      }
      if constexpr (MODE == CODES) {
        wait(stg_free, (j & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
            *reinterpret_cast<uint16_t*>(stg + stg_code(r0 + 8 * rh, 8 * i + 2 * t)) =
                (uint16_t)(codes[i] >> (16 * rh));
      } else {
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
      }
      if constexpr (STAGED) {
        fence_proxy_async();               // the tile is TMA's to store
        named_sync(1 + team, TEAM_WARPS * 32);
        if (leader) mbar_arrive(written);
      }
    }
  }
}

// out[c][r] = in[r][c] for int8 [rows, cols] matrices, rows and cols
// multiples of 4: blockIdx.y picks W1's codes [D, F] or W2's [F, D], each
// block one 64 x 64 tile, in and out in words of four codes. At a width
// that is not a multiple of 64 (cait_xs's D = 288: 4.5 tiles) the last
// tile of a side is ragged: the words past it are neither read nor
// written (the GEMMs read zeros there from their tensor maps' extent).
__global__ void __launch_bounds__(256)
transpose_codes_kernel(const int8_t* __restrict__ w1,
                       const int8_t* __restrict__ w2, int dim, int hidden,
                       int8_t* __restrict__ w1t, int8_t* __restrict__ w2t) {
  __shared__ uint32_t tile[64][17];       // 64 rows of 16 words (+ 1 pad)
  const bool second = blockIdx.y != 0;
  const int8_t* in = second ? w2 : w1;
  int8_t* out = second ? w2t : w1t;
  const int rows = second ? hidden : dim, cols = second ? dim : hidden;
  const int ct = (cols + 63) / 64;
  const int r0 = blockIdx.x / ct * 64, c0 = blockIdx.x % ct * 64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool col_in = c0 + 4 * tx < cols;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (col_in && r0 + r < rows)
      tile[r][tx] = *reinterpret_cast<const uint32_t*>(
          in + (size_t)(r0 + r) * cols + c0 + 4 * tx);
  }
  __syncthreads();
  if (r0 + 4 * tx >= rows) return;        // out's codes r0 + 4 tx ..
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 16 * i;            // the tile's column: out's row
    if (c0 + c >= cols) break;
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v |= ((tile[4 * tx + j][c >> 2] >> (8 * (c & 3))) & 0xffu) << (8 * j);
    *reinterpret_cast<uint32_t*>(out + (size_t)(c0 + c) * rows + r0 + 4 * tx) =
        v;
  }
}

// The workspace of one call: K14's regions (x's codes and scales, the
// absmax partials, the hidden codes' scales and the codes), then W1's and
// W2's transposed codes. Mirrored by int8_ff_plan.
struct FFWorkspace : Workspace {
  size_t w1t, w2t;
  FFWorkspace(int m, int dim, int hidden) : Workspace(m, dim, hidden) {
    w1t = total;
    w2t = w1t + align256((size_t)dim * hidden);
    total = w2t + align256((size_t)dim * hidden);
  }
};

template <int MODE, bool PAIR = false>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb,
                   const CUtensorMap& mo, const Args& args, cudaStream_t st) {
  static_assert(Plan::SMEM <= 232448, "over the block's shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      ff_gemm_kernel<MODE, PAIR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Plan::SMEM);
  if (e != cudaSuccess) return e;
  // PAIR: one block a pair unit, as grid_for gives for two units
  ff_gemm_kernel<MODE, PAIR><<<grid_for(units_of<MODE>(args)), THREADS,
                               Plan::SMEM, st>>>(ma, mb, mo, args);
  return cudaGetLastError();
}

// OUT, paired where D / 128 is even.
template <int MODE>
cudaError_t launch_out(const CUtensorMap& ma, const CUtensorMap& mb,
                       const Args& args, cudaStream_t st) {
  return col_tiles(args.dim) % 2 == 0
             ? launch<MODE, true>(ma, mb, ma, args, st)
             : launch<MODE, false>(ma, mb, ma, args, st);
}

}  // namespace q8ff
}  // namespace sav
