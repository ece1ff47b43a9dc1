// K6a on Hopper: the talking-heads forward core in two sweeps over the keys
// (wgmma, TMA, mbarriers; the pieces it shares with the backward are in
// th_sm90.cuh). th_attention.cu's header says what the core computes.
//
// What bounds it: per (image, query, key) three 48-deep products a head
// (q k^T twice, P V once) and three [H, H] mixes (the pre-mix in both
// sweeps, the post-mix in the second: 6 H^2 f32 operations), plus one exp
// per head in each sweep. At H = 8 the mixes are 384 f32 operations
// against 2304 bf16 tensor operations, and the card's f32 rate is 1/15 of
// its bf16 tensor rate: the CUDA-core work bounds the kernel. So every mix
// runs in registers with its weights as constant-bank operands of FFMA,
// and every exp is one ex2.approx with log2 e folded into the pre-mix
// weights (c_mix's second matrix) and into the lse.
//
// Two sweeps, because the post-mix adds NORMALIZED probabilities of
// different heads: each mixed head's lse must be known before any of them
// is mixed again. Work tile: 64 query rows of one image, all H heads;
// persistent blocks of 384 threads:
//  * the mix warpgroup computes s_h = q_h k_h^T of a 16-key tile for every
//    head (wgmma m64n16k16, q resident, k streamed, both K-major) so that
//    each thread holds 8 positions x H heads, and pre-mixes them;
//    sweep 1 keeps, per lane, the running max and sum of 2^x of each mixed
//    head over its own columns (one exp a position and head, one rescale
//    a tile of four), combined over the 4 lanes of a row at the end into
//    lse (written for the rows below L);
//    sweep 2 forms pn_i = 2^(x_i - lse_i log2 e), the post-mix pt, and
//    writes pt of every head as bf16 to an exchange buffer;
//  * the accumulate warpgroup runs o_h += pt_h v_h on wgmma m64n48k16 from
//    the exchange buffer (register A) and one TMA box of v per head at
//    column 48h (MN-major), its 64 x 48 x H outputs in registers, and
//    stores the rows below L; in sweep 1 it only frees the slots;
//  * the producer warp loads q (64-row boxes) once a tile, and streams k
//    (sweep 1), then k and v (sweep 2), through a ring of STAGES slots.
// Keys past L read zeros and their mixed logit is set to -inf after the
// pre-mix (a signed mix of -inf would be NaN): their pn is an exact zero.
// Query rows past L read zeros and are never stored. Nothing is padded.
// The mixes reach the kernel through c_mix, filled from device memory on
// the caller's stream before the launch.
//
// H = 16 (cait_m): one thread cannot hold the outputs of every head (24 H
// = 384 accumulator registers against a ceiling of 255), and the H = 8
// plan's shared memory doubles past a block's 227 KB. So the second sweep
// runs once per group of G = 8 output heads (NG = 2 passes): the mix
// warpgroup recomputes s and the pre-mix of all 16 heads in each pass and
// post-mixes only the group's 8 heads; the accumulate warpgroup holds the
// group's 8 x 24 registers (H = 8's) and stores them after each pass; the
// ring's slots carry k and the group's 8 v boxes. Against one second sweep
// this repeats the q k^T products and the pre-mix once (~1.5x the mix
// work). The mix warpgroup takes each 16-key tile as two 8-key halves
// (wgmma m64n8k16: s is 4 H = 64 registers beside 4 H of running max and
// sum), and the ring has 2 slots: q 96 KB + 2 x (k 24 KB + v 16 KB) + the
// exchange 32 KB = 214,096 bytes. (A two-CTA cluster splitting the heads
// would avoid the repeat, at the price of partial mixes swapped through
// distributed shared memory every tile.) Where the work tiles fill less
// than one wave of SMs and their two groups would fill at most one
// (cait_m_48 @224 bs16: 64 tiles on 132 SMs), each group is a work unit
// of its own (split_of): a unit sweeps the keys for the lse and then for
// its group, 2 sweeps against a tile's 3, on twice the SMs. At H <= 8,
// G = H: one pass, the kernel as before.
//
// H = 6 (cait_xs): the band is 288 columns, 4.5 boxes of 64. q and k are
// read in NB = 5 boxes (a ceiling): the fifth box's 32 columns past 288
// arrive as zeros (the tensor map's extent is the band's width, and TMA
// fills past it; the mbarriers still count whole boxes), and no product
// reads them: head h's 16-deep steps lie at columns 48 h + 16 kk < 288.
// Head 5's v box (columns 240-303) carries 16 such zero columns, which
// m64n48k16 never reads. Every store writes 48 columns a head, so nothing
// is written past the band. 156,784 bytes; the accumulation holds 6 x 24
// registers.
//
// Q8 (K11, th_attention_q8.cu): the accumulate warpgroup's store takes the
// codes of its rows instead of writing bf16 bands. It holds every head's 48
// columns of its 64 rows, and K11 quantises a band row over exactly those
// H*48 values, so no band goes to device memory: each output is rounded to
// bf16 first (the twin's bands), the row's absmax is taken in-thread over
// the heads and then over the 4 lanes of a row, scale = max(absmax, 1e-8) /
// 127 by IEEE division, and the codes come from q8::quantize_exact
// (int8_gemm.cuh: the IEEE quotient's codes without a division, where
// quantize_by's tie test would send most bf16 values, whose quotients sit
// on ties often, to the division: `scripts/torch_ablate.py k11`, tie_test)
// into a staging tile in shared memory, and out to aq [B, L, H*48] int8 in
// 16-byte stores (the accumulator's layout gives 2-byte ones); as [B, L]
// f32. At H = 16 the row's absmax spans both groups: the first group's
// bf16 values wait in the tile's own aq rows (8 heads x 48 bf16 = the
// row's 768 bytes) with their absmax in registers; after the second group
// each thread reads its own values back, and every code is taken against
// the absmax of all 16 heads. The staging tile then lies over the
// resident q, which no one reads by then (the mix warpgroup's last
// products precede the last exchange tile, and the producer reloads q
// only after the store).
#pragma once

#include <type_traits>

#include "int8_gemm.cuh"
#include "th_sm90.cuh"

namespace sav {
namespace thf {

using namespace sm90;
using thb::ACC_REGS;
using thb::BOX_RES;
using thb::BOX_STR;
using thb::COLS;
using thb::CONSUMERS;
using thb::MIX_REGS;
using thb::PRODUCER_REGS;
using thb::ROWS;
using thb::TD;
using thb::THREADS;
using thb::XHEAD;
using thb::acc_step;
using thb::c_mix;
using thb::exp2_approx;
using thb::fence_all;
using thb::kLog2e;
using thb::m_post;
using thb::m_pre2;
using thb::pos_col;
using thb::store_rows;
using thb::wait;
using thb::wgmma_ss_n16;
using thb::xidx;

// Heads a pass of the second sweep accumulates (G) and passes (NG);
// positions of one product a mix thread holds (P: a 16-key tile, or one
// 8-key half of it at H = 16) and products a tile (HALVES); ring slots.
template <int H>
struct Geo {
  static constexpr int G = H <= 8 ? H : 8;
  static constexpr int NG = H / G;
  static constexpr int P = H <= 8 ? 8 : 4;
  static constexpr int HALVES = 8 / P;
  static constexpr int STAGES = H <= 8 ? 4 : 2;
};

// Shared memory (bytes from a 1024-byte aligned base); the Python mirror
// is th_fwd_plan in ops/th_attention.py.
template <int H>
struct Plan {
  static constexpr int G = Geo<H>::G;
  static constexpr int STAGES = Geo<H>::STAGES;
  static constexpr int HD = H * TD;
  static constexpr int NB = (HD + 63) / 64;            // 64-column boxes
  static constexpr int OFF_K = NB * BOX_RES * 2;       // after resident q
  static constexpr int OFF_V = OFF_K + STAGES * NB * BOX_STR * 2;
  static constexpr int OFF_EXCH = OFF_V + STAGES * G * BOX_STR * 2;
  static constexpr int OFF_BAR = OFF_EXCH + 2 * G * XHEAD * 2;
  static constexpr int BARS = 2 + 2 * STAGES + 4;
  static constexpr int SMEM = OFF_BAR + BARS * 8 + 1024;
  static constexpr uint32_t RES_TX = NB * BOX_RES * 2;
  static constexpr uint32_t K_TX = NB * BOX_STR * 2;
  static constexpr uint32_t V_TX = G * BOX_STR * 2;
};

// s_h = q_h k_h^T of the slot's 16 keys (P = 8), or of its keys 8 half..
// (P = 4), for every head, one commit group.
template <int H, int P>
__device__ __forceinline__ void qk_products(float (&s)[H][P], uint64_t res,
                                            uint64_t str, int half) {
  asm volatile("" : "+l"(res), "+l"(str));  // descriptors formed per call
  if constexpr (P == 4) str += half * (1024 / 16);
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      const int c = TD * h + 16 * kk;      // column of the 16-deep step
      const uint64_t a = res + ((c >> 6) * BOX_RES * 2 + (c & 63) * 2) / 16;
      const uint64_t b = str + ((c >> 6) * BOX_STR * 2 + (c & 63) * 2) / 16;
      if constexpr (P == 8)
        wgmma_ss_n16(s[h], a, b, kk);
      else
        thb::wgmma_ss_n8(s[h], a, b, kk);
    }
  wgmma_commit();
}

// x_i = sum_j M_pre[j, i] log2 e s_j at position p, -inf for a key past L.
template <int H, int P>
__device__ __forceinline__ void premix(float (&x)[H], const float (&s)[H][P],
                                       int p, bool ok) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < H; ++j) a = fmaf(m_pre2<H>(j, i), s[j][p], a);
    x[i] = ok ? a : -INFINITY;
  }
}

// Sweep 1 on one product: the lane's running max mx and sum sm of 2^x of
// every mixed head, per row half, over the row half's P / 2 positions;
// key0 is the key of the lane's column 0.
template <int H, int P>
__device__ __forceinline__ void sweep1_mix(const float (&s)[H][P],
                                           float (&mx)[2][H],
                                           float (&sm)[2][H], int key0,
                                           int L, int half) {
  constexpr int NQ = P / 2;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    float x[NQ][H];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {         // the row half's positions
      const int p = 2 * rh + (q & 1) + 4 * (q >> 1);
      premix<H, P>(x[q], s, p, key0 + pos_col<P>(p, 0, half) < L);
    }
#pragma unroll
    for (int i = 0; i < H; ++i) {
      float m_new = fmaxf(x[0][i], x[1][i]);
      if constexpr (NQ == 4)
        m_new = fmaxf(m_new, fmaxf(x[2][i], x[3][i]));
      m_new = fmaxf(mx[rh][i], m_new);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float e = exp2_approx(x[0][i] - base) + exp2_approx(x[1][i] - base);
      if constexpr (NQ == 4)
        e += exp2_approx(x[2][i] - base) + exp2_approx(x[3][i] - base);
      sm[rh][i] = sm[rh][i] * exp2_approx(mx[rh][i] - base) + e;
      mx[rh][i] = m_new;
    }
  }
}

// Sweep 2 on one product: pn = 2^(x - lse2) of every head, the post-mix pt
// of group grp's G heads, as bf16 into their exchange tiles xb.
template <int H, int P, int G>
__device__ __forceinline__ void sweep2_mix(const float (&s)[H][P],
                                           const float (&l2)[2][H], bf16* xb,
                                           int lrow, int t, int key0, int L,
                                           int half, int grp) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int rh = (p >> 1) & 1, col = pos_col<P>(p, t, half);
    float x[H];
    premix<H, P>(x, s, p, key0 + pos_col<P>(p, 0, half) < L);
#pragma unroll
    for (int i = 0; i < H; ++i) x[i] = exp2_approx(x[i] - l2[rh][i]);
    const int at = xidx(lrow + 8 * rh, col);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < H; ++j) a = fmaf(m_post<H>(j, G * grp + i), x[j], a);
      xb[i * XHEAD + at] = __float2bfloat16(a);
    }
  }
}

// Q8: a work tile's codes are staged in shared memory, 64 rows of H*48
// bytes 16 bytes apart (400 at H = 8: the 8 rows of a store fall in 8 bank
// groups), then copied out in 16-byte chunks: after the mbarriers, or at H
// = 16 over the resident q (the header says why that is free).
template <int H>
struct CodesPlan {
  static constexpr bool OVER_Q = Geo<H>::NG > 1;
  static constexpr int LD = H * TD + 16;
  static constexpr int OFF =
      OVER_Q ? 0 : (Plan<H>::OFF_BAR + Plan<H>::BARS * 8 + 15) / 16 * 16;
  static constexpr int SMEM = OVER_Q ? Plan<H>::SMEM : OFF + ROWS * LD + 1024;
  static_assert(!OVER_Q || ROWS * LD <= Plan<H>::OFF_K, "over q's region");
};

// Q8's store of pass grp: the rows of a 64-row accumulator of G heads (24
// registers a head) as codes of their bf16 values over all H*48 columns ->
// aq rows < L (an image's [L, H*48]), their scales -> as (the image's
// [L]). With two passes, pass 0 leaves its bf16 values in the aq rows and
// their absmax in mx0; pass 1 takes every code. wt: the thread in the
// warpgroup.
template <int H>
__device__ __forceinline__ void store_codes(float (&acc)[Geo<H>::G][24],
                                            int8_t* stage, int8_t* aq,
                                            float* as, int row0, int lrow,
                                            int t, int wt, int L, int grp,
                                            float (&mx0)[2]) {
  constexpr int G = Geo<H>::G, HD = H * TD;
  constexpr int LD = CodesPlan<H>::LD, CH = HD / 16;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    float mx = 0.f;
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& v = acc[h][4 * i + 2 * rh + j];
          v = __bfloat162float(__float2bfloat16(v));
          mx = fmaxf(mx, fabsf(v));
        }
    const int r = lrow + 8 * rh, row = row0 + r;
    if constexpr (Geo<H>::NG > 1) {
      if (grp == 0) {                      // park the bf16 values in aq
        mx0[rh] = mx;
        if (row < L) {
          uint32_t* dst = reinterpret_cast<uint32_t*>(aq + (size_t)row * HD);
#pragma unroll
          for (int h = 0; h < G; ++h)
#pragma unroll
            for (int i = 0; i < 6; ++i)
              dst[(TD * h + 8 * i + 2 * t) / 2] = pack_bf16x2(
                  acc[h][4 * i + 2 * rh], acc[h][4 * i + 2 * rh + 1]);
        }
        continue;
      }
      mx = fmaxf(mx, mx0[rh]);
    }
    if (rh == 0) warpgroup_sync(2);        // the last tile's rows are out
    // the 4 lanes of a row (equal g); every lane takes part
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float scale = q8::row_scale(mx), inv = __frcp_rn(scale);
    int8_t* dst = stage + r * LD + 2 * t;
    if constexpr (Geo<H>::NG > 1) {        // pass 0's codes from aq
      if (row < L) {
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(aq + (size_t)row * HD);
#pragma unroll
        for (int h = 0; h < G; ++h)
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            const uint32_t w = src[(TD * h + 8 * i + 2 * t) / 2];
            const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(&w);
            char2 c;
            c.x = (signed char)q8::quantize_exact(__low2float(v2), scale, inv);
            c.y = (signed char)q8::quantize_exact(__high2float(v2), scale, inv);
            *reinterpret_cast<char2*>(dst + TD * h + 8 * i) = c;
          }
      }
      dst += G * TD;
    }
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        char2 c;
        c.x = (signed char)q8::quantize_exact(acc[h][4 * i + 2 * rh], scale,
                                              inv);
        c.y = (signed char)q8::quantize_exact(acc[h][4 * i + 2 * rh + 1],
                                              scale, inv);
        *reinterpret_cast<char2*>(dst + TD * h + 8 * i) = c;
      }
    if (t == 0 && row < L) as[row] = scale;
  }
  if (grp + 1 < Geo<H>::NG) return;
  warpgroup_sync(2);
  for (int c = wt; c < ROWS * CH; c += 128) {
    const int r = c / CH, k = c % CH;
    if (row0 + r < L)
      *reinterpret_cast<uint4*>(aq + (size_t)(row0 + r) * HD + 16 * k) =
          *reinterpret_cast<const uint4*>(stage + r * LD + 16 * k);
  }
  if constexpr (CodesPlan<H>::OVER_Q) {    // q's region goes back to TMA
    fence_proxy_async();
    warpgroup_sync(2);
  }
}

// Work units a tile: its NG head groups apart (NG) where the tiles fill
// less than a wave of `sms` and the groups at most one, else 1 (and
// always 1 for Q8, whose codes take a row over every group).
template <int H, bool Q8>
inline int split_of(int tiles, int sms) {
  constexpr int NG = Geo<H>::NG;
  return !Q8 && NG > 1 && tiles * NG <= sms ? NG : 1;
}

// qmap: q in 64-row boxes; kmap, vmap: k and v in 16-row boxes (k read in
// its 64-column boxes, v one box per head at column 48h). attn [B, L,
// H*48] bf16, lse [B, H, L] f32 or null; Q8: aq [B, L, H*48] int8 and as
// [B, L] f32 instead of attn (lse null). split: work units a tile
// (split_of); a unit takes head groups [g0, g1) of its tile and the first
// writes the lse.
template <int H, bool Q8 = false>
__global__ void __launch_bounds__(THREADS, 1)
th_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   bf16* __restrict__ attn, float* __restrict__ lse,
                   int8_t* __restrict__ aq, float* __restrict__ as,
                   int batch, int L, int split) {
  using P = Plan<H>;
  constexpr int G = Geo<H>::G, NG = Geo<H>::NG, STAGES = P::STAGES;
  constexpr int PP = Geo<H>::P, HALVES = Geo<H>::HALVES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(base);
  bf16* sk = reinterpret_cast<bf16*>(base + P::OFF_K);
  bf16* sv = reinterpret_cast<bf16*>(base + P::OFF_V);
  bf16* sx = reinterpret_cast<bf16*>(base + P::OFF_EXCH);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + P::OFF_BAR);
  uint64_t* res_full = bars;
  uint64_t* res_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = full + STAGES;
  uint64_t* xfull = empty + STAGES;
  uint64_t* xempty = xfull + 2;

  const int tid = threadIdx.x;
  // work units a tile: a compile-time 1 where no split can happen (H <= 8,
  // K11), so that there the group loops fold to their passes
  const int sp = NG > 1 && !Q8 ? split : 1;
  const int nx = (L + ROWS - 1) / ROWS, units = nx * batch * sp;
  const int nc = (L + COLS - 1) / COLS;     // key tiles of a sweep
  // tile of a unit and its head groups [g0, g1)
  auto unit_of = [=](int unit, int& b, int& r0, int& g0, int& g1) {
    const int tile = unit / sp;
    b = tile / nx;
    r0 = (tile % nx) * ROWS;
    g0 = sp == 1 ? 0 : unit % sp;
    g1 = sp == 1 ? NG : g0 + 1;
  };

  if (tid == 0) {
    mbar_init(res_full, 1);
    mbar_init(res_empty, 2);                // one arrival per consumer group
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&xfull[i], 128);            // every mixing thread
      mbar_init(&xempty[i], 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {                   // producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != CONSUMERS) return;           // one thread issues every load
    int step = 0;
    for (int unit = blockIdx.x, n = 0; unit < units;
         unit += gridDim.x, ++n) {
      int b, r0, g0, g1;
      unit_of(unit, b, r0, g0, g1);
      mbar_wait(res_empty, (n & 1) ^ 1);
      mbar_arrive_expect_tx(res_full, P::RES_TX);
      for (int c = 0; c < P::NB; ++c)
        tma_load_3d(sq + c * BOX_RES, &qmap, res_full, 64 * c, r0, b);
      for (int sw = 0; sw <= g1 - g0; ++sw)  // sweep 1, then a pass a group
        for (int j = 0; j < nc; ++j, ++step) {
          const int st = step % STAGES;
          mbar_wait(&empty[st], ((step / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], sw ? P::K_TX + P::V_TX : P::K_TX);
          for (int c = 0; c < P::NB; ++c)
            tma_load_3d(sk + (st * P::NB + c) * BOX_STR, &kmap, &full[st],
                        64 * c, j * COLS, b);
          if (sw)
            for (int h = 0; h < G; ++h)
              tma_load_3d(sv + (st * G + h) * BOX_STR, &vmap, &full[st],
                          TD * (G * (g0 + sw - 1) + h), j * COLS, b);
        }
    }
    return;
  }

  // consumers: warpgroup 0 mixes, warpgroup 1 accumulates, each in its own
  // copy of the code (so ptxas knows each one's register budget)
  const int wg = tid >> 7, wt = tid & 127, wi = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = 16 * wi + g;             // local rows lrow, lrow + 8
  const bool leader = wt == 0;
  auto consumer = [&](auto role) {
    constexpr int WG = decltype(role)::value;
    const uint64_t dq = desc_k_major(sq), dk = desc_k_major(sk);
    const uint64_t mv = desc_mn_major(sv);
    constexpr uint64_t K_SLOT = P::NB * BOX_STR * 2 / 16;
    constexpr uint64_t V_SLOT = G * BOX_STR * 2 / 16;
    int step = 0, xstep = 0;
    for (int unit = blockIdx.x, n = 0; unit < units; unit += gridDim.x, ++n) {
      int b, r0, g0, g1;
      unit_of(unit, b, r0, g0, g1);
      wait(res_full, n & 1);
      if constexpr (WG == 0) {              // the mix
        float mx[2][H], sm[2][H];
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
#pragma unroll
          for (int i = 0; i < H; ++i) {
            mx[rh][i] = -INFINITY;
            sm[rh][i] = 0.f;
          }
        for (int j = 0; j < nc; ++j, ++step) {
          const int st = step % STAGES;
          wait(&full[st], (step / STAGES) & 1);
#pragma unroll 1
          for (int half = 0; half < HALVES; ++half) {
            float s[H][PP];
            qk_products<H, PP>(s, dq, dk + st * K_SLOT, half);
            wgmma_wait<0>();
            fence_all(s);
            if (half == HALVES - 1) {       // the slot is read
              warpgroup_sync(1);
              if (leader) mbar_arrive(&empty[st]);
            }
            sweep1_mix<H, PP>(s, mx, sm, j * COLS + 2 * t, L, half);
          }
        }
        // the 4 lanes of a row: lse2 = max + log2(sum), in mx
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
#pragma unroll
          for (int i = 0; i < H; ++i) {
            float m_all = mx[rh][i];
            m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, 1));
            m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, 2));
            float part = mx[rh][i] == -INFINITY
                             ? 0.f : sm[rh][i] * exp2_approx(mx[rh][i] - m_all);
            part += __shfl_xor_sync(0xffffffffu, part, 1);
            part += __shfl_xor_sync(0xffffffffu, part, 2);
            mx[rh][i] = m_all + __log2f(part);
            const int row = r0 + lrow + 8 * rh;
            if (lse != nullptr && g0 == 0 && t == 0 && row < L)
              lse[((size_t)b * H + i) * L + row] = mx[rh][i] / kLog2e;
          }
#pragma unroll 1
        for (int grp = g0; grp < g1; ++grp)
          for (int j = 0; j < nc; ++j, ++step, ++xstep) {
            const int st = step % STAGES, xb = xstep & 1;
            wait(&full[st], (step / STAGES) & 1);
#pragma unroll 1
            for (int half = 0; half < HALVES; ++half) {
              float s[H][PP];
              qk_products<H, PP>(s, dq, dk + st * K_SLOT, half);
              wgmma_wait<0>();
              fence_all(s);
              if (half == HALVES - 1) {
                warpgroup_sync(1);
                if (leader) mbar_arrive(&empty[st]);
              }
              if (half == 0) wait(&xempty[xb], ((xstep >> 1) & 1) ^ 1);
              sweep2_mix<H, PP, G>(s, mx, sx + xb * G * XHEAD, lrow, t,
                                   j * COLS + 2 * t, L, half, grp);
            }
            mbar_arrive(&xfull[xb]);
          }
      } else {                              // the accumulation
        for (int j = 0; j < nc; ++j, ++step) {   // sweep 1: free the slots
          const int st = step % STAGES;
          wait(&full[st], (step / STAGES) & 1);
          if (leader) mbar_arrive(&empty[st]);
        }
        [[maybe_unused]] float mx0[2] = {0.f, 0.f};  // Q8: pass 0's absmax
#pragma unroll 1
        for (int grp = g0; grp < g1; ++grp) {
          float o[G][24];
#pragma unroll
          for (int h = 0; h < G; ++h)
#pragma unroll
            for (int i = 0; i < 24; ++i) o[h][i] = 0.f;
          for (int j = 0; j < nc; ++j, ++step, ++xstep) {
            const int st = step % STAGES, xb = xstep & 1;
            wait(&full[st], (step / STAGES) & 1);
            wait(&xfull[xb], (xstep >> 1) & 1);
            acc_step<G>(o, sx + xb * G * XHEAD, mv + st * V_SLOT, wi, lane);
            warpgroup_sync(2);
            if (leader) {
              mbar_arrive(&xempty[xb]);
              mbar_arrive(&empty[st]);
            }
          }
          if constexpr (Q8)
            store_codes<H>(o, reinterpret_cast<int8_t*>(
                                  base + CodesPlan<H>::OFF),
                           aq + (size_t)b * L * (H * TD), as + (size_t)b * L,
                           r0, lrow, t, wt, L, grp, mx0);
          else
            store_rows<G>(o, attn + (size_t)b * L * (H * TD) + G * TD * grp,
                          H * TD, r0, lrow, t, L);
        }
      }
      if (leader) mbar_arrive(res_empty);
    }
  };
  if (wg == 0) {
    setmaxnreg_inc<MIX_REGS>();
    consumer(std::integral_constant<int, 0>{});
  } else {
    setmaxnreg_inc<ACC_REGS>();
    consumer(std::integral_constant<int, 1>{});
  }
}

// mix [3, H, H] f32 (M_pre, M_pre * log2 e, M_post) in device memory;
// Q8: aq and as instead of attn and lse.
template <int H, bool Q8>
int launch(const void* q, const void* k, const void* v, const float* mix,
           void* attn, float* lse, void* aq, float* as, int batch, int L,
           cudaStream_t st) {
  constexpr int SMEM = Q8 ? CodesPlan<H>::SMEM : Plan<H>::SMEM;
  static_assert(SMEM <= 232448, "over the block's shared memory");
  cudaError_t e = cudaMemcpyToSymbolAsync(
      c_mix, mix, 3 * H * H * sizeof(float), 0, cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap qmap, kmap, vmap;
  int err = band_map(&qmap, q, batch, L, L, H * TD, ROWS);
  if (!err) err = band_map(&kmap, k, batch, L, L, H * TD, COLS);
  if (!err) err = band_map(&vmap, v, batch, L, L, H * TD, COLS);
  if (err) return err;
  e = cudaFuncSetAttribute(th_fwd_sm90_kernel<H, Q8>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (L + ROWS - 1) / ROWS * batch;
  int split = 1;
  if constexpr (!Q8 && Geo<H>::NG > 1) {   // H <= 8 and K11 never split
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    split = split_of<H, Q8>(tiles, sms);
  }
  th_fwd_sm90_kernel<H, Q8><<<flash::persistent_grid(tiles * split),
                              THREADS, SMEM, st>>>(
      qmap, kmap, vmap, (bf16*)attn, lse, (int8_t*)aq, as, batch, L, split);
  return (int)cudaGetLastError();
}

// K6a, and K5a's core: attn [B, L, H*48] bf16, lse [B, H, L] f32 or null.
template <int H>
int run(const void* q, const void* k, const void* v, const float* mix,
        void* attn, float* lse, int batch, int L, cudaStream_t st) {
  return launch<H, false>(q, k, v, mix, attn, lse, nullptr, nullptr, batch,
                          L, st);
}

// K11's core: the bands' codes aq [B, L, H*48] int8 and scales as [B, L].
template <int H>
int run_q8(const void* q, const void* k, const void* v, const float* mix,
           void* aq, float* as, int batch, int L, cudaStream_t st) {
  return launch<H, true>(q, k, v, mix, nullptr, nullptr, aq, as, batch, L,
                         st);
}

}  // namespace thf
}  // namespace sav
