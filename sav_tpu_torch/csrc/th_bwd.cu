// K5b and K6b port: the talking-heads attention backward on Hopper (wgmma,
// TMA, mbarriers; helpers in sm90.cuh and flash_sm90.cuh).
//
// Replaces sav_tpu/ops/th_attention.py::_th_bwd_kernel (K5b) and
// ::_th_blk_bwd_kernel (K6b), which compute the same function: q (pre-
// scaled), k, v, do as [B, L, H*48] bf16 head bands, lse [B, H, L] f32 of
// each mixed head from the forward, f32 [H, H] mixes M_pre, M_post; per
// (image, query, key), with j and i over the heads,
//   s_j    = q_j . k_j,           pn_i  = exp(sum_j M_pre[j, i] s_j - lse_i)
//   da_i   = do_i . v_i,          dpn_j = sum_i M_post[j, i] da_i
//   pt_i   = sum_j M_post[j, i] pn_j,   delta_j = rowsum(dpn_j pn_j)
//   dst_i  = pn_i (dpn_i - delta_i),    ds_j = sum_i M_pre[j, i] dst_i
//   dq_j = bf16(ds_j) k_j, dk_j = bf16(ds_j)^T q_j, dv_i = bf16(pt_i)^T do_i
//   dM_pre[j, i] = sum dst_i s_j, dM_post[j, i] = sum da_i pn_j
// with pn, the mixes and the dM sums in f32 and the products accumulated in
// f32 (th_core_bwd_plain in ops/th_attention.py is the twin).
//
// What bounds it on the card: per (image, query, key) the function needs
// five 48-deep products (480 tensor operations over H heads) and six [H, H]
// mixes or sums (12 H^2 f32 operations); at H = 8 the mixes take 768 f32
// operations against 3840 bf16 tensor operations, and the H100's f32 rate
// is 1/15 of its bf16 tensor rate. So the CUDA-core mixes bound it, and the
// design keeps them cheap: every mix runs in registers, on one thread that
// holds all H heads of its positions, with the [H, H] weights as constant-
// bank operands of FFMA (no shared-memory loads); exp is one ex2.approx
// with log2 e folded into a second copy of M_pre and into lse.
//
// How a thread comes to hold all heads: a warpgroup computes one 64 x 16
// tile (64 resident rows, 16 streamed rows) of s, and of da, for every head
// with wgmma m64n16k16; wgmma gives every head's product the same
// accumulator layout, so thread (warp w, lane 4g + t) holds rows 16w + g and
// 16w + g + 8, columns 2t, 2t + 1, 8 + 2t, 9 + 2t of all H heads: 8
// positions x H heads in registers, 8 H registers a tensor.
//
// The accumulated outputs (dq, dk, dv: 64 rows x 48 columns x H heads, 24 H
// registers a thread of a warpgroup) do not fit beside the mix's 16 H and
// its [H, H] dM sum, so every kernel runs two consumer warpgroups and a
// producer warpgroup (384 threads, setmaxnreg moving registers to the
// consumers):
//  * the mix warpgroup computes s (and da) of a tile with wgmma, mixes them
//    and writes the bf16 result (ds or pt) of every head to an exchange
//    buffer in shared memory (two of them, 64 x 16 per head);
//  * the accumulate warpgroup takes each head's exchange tile as the
//    register A operand (ldmatrix) of wgmma m64n48k16, acc_h += A_h B_h,
//    with B_h the streamed tile's 16 rows of head h read MN-major; its
//    accumulators stay in registers for the whole work tile;
//  * the producer's one warp streams 16-row tiles by TMA through a ring of
//    STAGES slots (full/empty mbarriers) and writes the per-row statistics
//    a tile needs beside it.
// Three launches, persistent (one block per SM walking work tiles of 64
// resident rows of one image):
//  DQ  rows = 64 queries (q, do resident), streamed = keys (k, v), two
//      sweeps: (1) delta (pn, dpn; delta_j += dpn_j pn_j), written for DK;
//      (2) pn, dpn, dst, ds -> dq += ds k.
//  DK  rows = 64 keys (k, v resident), streamed = queries (q, do) with
//      their lse and delta: pn, dpn, dst, ds -> dk += ds^T q; dM_pre +=
//      dst_i s_j.
//  DV  rows = 64 keys (k, v resident), streamed = queries (q, do) with
//      their lse: pn, pt -> dv += pt^T do; dM_post += da_i pn_j.
//  In DK and DV, s (or pn) stays beside da and the [H, H] dM sum, so their
//  mix takes each 16-row tile as two 8-row halves (wgmma m64n8k16: s and da
//  are 8 H registers; at 16 H ptxas spilled 1.5 KB a thread and DK took
//  three times as long).
// Mixes per (query, key) against the function's 6 H^2: DQ 2 H^2 + 3 H^2,
// DK 4 H^2, DV 3 H^2: 12 H^2 (the parent's three sweeps ran 11 H^2 out of
// f32 shared memory). The R form of delta (R_ji = sum_k pn_j da_i per row,
// 2 H^2) would need 2 H^2 accumulators a thread (its two rows) beside the
// 16 H of s and da: 256 registers at H = 8.
//
// Layout: every band tile in shared memory is a TMA box of 64 bf16 columns
// with the 128-byte swizzle (sm90::band_map). Resident tiles and the mix's
// second streamed operand are the bands' own boxes at columns 64c (head h's
// 16-deep step kk at column 48h + 16kk lies inside one box, 32-byte
// aligned); the streamed operand the accumulate warpgroup reads MN-major is
// loaded as one box per head at column 48h, so its 48 columns start the box
// (the band's next 16 columns, or zeros past the last head, are never
// read). At H = 6 (cait_xs) the band's 288 columns are 4.5 boxes: the
// bands are read as NB = 5 (a ceiling), the fifth box's 32 columns past
// the band's width arriving as zeros from TMA's fill (the mbarriers count
// whole boxes) and read by no product, as head 5's per-head box's 16
// columns past 288 are not; 178,272 bytes at most (DQ). Query rows past
// L read zeros with lse = +inf (so pn = 0); keys past L read zeros and
// their pn is set to 0 after the pre-mix (a signed mix of -inf would be
// NaN); nothing is padded and no row at or past L is written.
// No float atomics: dq, dk, dv are written once, and dM_post (DV) and
// dM_pre (DK) leave as [H, H] partials, one a warp of a work tile (warp
// butterflies, fixed order), that the wrapper sums in a fixed order.
// The mixes reach the kernels through c_mix, which the C entry fills from
// device memory on the caller's stream before its launches: calls on one
// stream are ordered, calls of one device on two streams must not overlap.
//
// At H = 16 (cait_m) these kernels do not fit a block (two resident bands
// of 96 KB each): sav_th_core_bwd_staged runs the same function staged
// through device memory (th_bwd_staged.cuh says how and why).
#include <type_traits>

#include "th_bwd_staged.cuh"
#include "th_sm90.cuh"

namespace sav {
namespace thb {

constexpr int STAGES = 3;                 // ring slots of streamed tiles
enum Mode { DQ = 0, DK = 1, DV = 2 };

// Shared memory of one mode (bytes from a 1024-byte aligned base); the
// Python mirror is th_bwd_plan in ops/th_attention.py.
template <int H, int MODE>
struct Plan {
  static constexpr int HD = H * TD;
  static constexpr int NB = (HD + 63) / 64;            // 64-column boxes
  static constexpr int SWEEPS = MODE == DQ ? 2 : 1;
  static constexpr int OFF_STR0 = 2 * NB * BOX_RES * 2;  // two resident bands
  static constexpr int OFF_STR1 = OFF_STR0 + STAGES * NB * BOX_STR * 2;
  static constexpr int OFF_EXCH = OFF_STR1 + STAGES * H * BOX_STR * 2;
  static constexpr int OFF_STAT = OFF_EXCH + 2 * H * XHEAD * 2;
  // DQ: [2][H][ROWS] (lse log2 e and delta of the rows); DK, DV:
  // [STAGES][2][H][COLS] (lse log2 e and delta of the streamed tile's rows)
  static constexpr int STAT_BYTES =
      MODE == DQ ? 2 * H * ROWS * 4 : STAGES * 2 * H * COLS * 4;
  static constexpr int OFF_BAR = OFF_STAT + STAT_BYTES;
  static constexpr int BARS = 2 + 2 * STAGES + 4;
  static constexpr int SMEM = OFF_BAR + BARS * 8 + 1024;
  static constexpr uint32_t RES_TX = 2 * NB * BOX_RES * 2;
  static constexpr uint32_t STAGE_TX = (NB + H) * BOX_STR * 2;
};

// ---- the mix warpgroup's products

// s_h and da_h of streamed tile `st` for every head, as two commit groups
// (s first: pn is formed under da's products where s is not kept). res:
// the resident boxes (res0 then res1); str0: the slot's
// natural boxes, str1: its per-head boxes. s = res0 x str1 and da = res1 x
// str0 (DQ, DK), s = res0 x str0 and da = res1 x str1 (DV, whose per-head
// band is do).
template <int H, int MODE, int P>
__device__ __forceinline__ void mix_products(float (&s)[H][P],
                                             float (&da)[H][P],
                                             uint64_t res, uint64_t str0,
                                             uint64_t str1, int half = 0) {
  using P_ = Plan<H, MODE>;
  constexpr bool S_PER_HEAD = MODE != DV;
  // the 6 H descriptors are formed here, per call: hoisted out of the
  // caller's loop they would hold 12 H registers for the whole work tile
  asm volatile("" : "+l"(res), "+l"(str0), "+l"(str1));
  if constexpr (P == 4) {                   // rows 8 half .. of the slot
    str0 += half * (1024 / 16);
    str1 += half * (1024 / 16);
  }
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 2; ++t) {             // s, then da
    const bool per_head = (t == 0) == S_PER_HEAD;
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
        const int c = TD * h + 16 * kk;    // column of the 16-deep step
        const uint64_t a = res + (t * P_::NB * BOX_RES * 2
                                  + (c >> 6) * BOX_RES * 2 + (c & 63) * 2) / 16;
        const uint64_t b =
            per_head ? str1 + (h * BOX_STR * 2 + 32 * kk) / 16
                     : str0 + ((c >> 6) * BOX_STR * 2 + (c & 63) * 2) / 16;
        if constexpr (P == 8)
          wgmma_ss_n16(t == 0 ? s[h] : da[h], a, b, kk);
        else
          wgmma_ss_n8(t == 0 ? s[h] : da[h], a, b, kk);
      }
    }
    wgmma_commit();
  }
}

// Each mix output is one chain of H FMAs with constant-bank weights; the
// positions' chains are independent, and every value is stored as soon as
// it is formed (a mix warpgroup has few registers beside s, da and dM).

// pn in place of s for a DQ tile (rows = queries): l2 [H][ROWS] is lse log2
// e of the rows (+inf past L); keys at or past `kmax` get pn = 0.
template <int H>
__device__ __forceinline__ void dq_pn(float (&s)[H][8], const float* l2,
                                      int lrow, int key0, int kmax) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int row = lrow + 8 * ((p >> 1) & 1);
    const bool ok = key0 + pos_col(p, 0) < kmax;
    float x[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      float a = -l2[i * ROWS + row];
#pragma unroll
      for (int j = 0; j < H; ++j) a = fmaf(m_pre2<H>(j, i), s[j][p], a);
      x[i] = a;
    }
#pragma unroll
    for (int i = 0; i < H; ++i) s[i][p] = exp2_approx(ok ? x[i] : -INFINITY);
  }
}

// dpn in place of da: da[j] <- sum_i M_post[j, i] da[i] at every position.
template <int H, int P>
__device__ __forceinline__ void dpn_in_place(float (&da)[H][P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float x[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < H; ++i) a = fmaf(m_post<H>(j, i), da[i][p], a);
      x[j] = a;
    }
#pragma unroll
    for (int j = 0; j < H; ++j) da[j][p] = x[j];
  }
}

// DQ sweep 1 (pn in s, dpn in da): delta partials of the thread's two rows.
template <int H>
__device__ __forceinline__ void dq_sweep1_mix(const float (&pn)[H][8],
                                              const float (&dpn)[H][8],
                                              float (&dl)[2][H]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int rh = (p >> 1) & 1;
#pragma unroll
    for (int j = 0; j < H; ++j) dl[rh][j] = fmaf(dpn[j][p], pn[j][p], dl[rh][j]);
  }
}

// ds_j = sum_i M_pre[j, i] dst_i at position p of dst -> bf16 exchange tile.
template <int H, int P>
__device__ __forceinline__ void store_ds(const float (&dst)[H][P], int p,
                                         bf16* x, int at) {
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < H; ++i) a = fmaf(m_pre<H>(j, i), dst[i][p], a);
    x[j * XHEAD + at] = __float2bfloat16(a);
  }
}

// DQ sweep 2 (pn in s, dpn in da): dst in place of dpn, ds of every head into
// the exchange tile x; dd [H][ROWS] is the rows' delta.
template <int H>
__device__ __forceinline__ void dq_sweep2_mix(const float (&pn)[H][8],
                                              float (&da)[H][8],
                                              const float* dd, bf16* x,
                                              int lrow, int t) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int row = lrow + 8 * ((p >> 1) & 1), col = pos_col(p, t);
#pragma unroll
    for (int j = 0; j < H; ++j)
      da[j][p] = pn[j][p] * (da[j][p] - dd[j * ROWS + row]);
    store_ds<H, 8>(da, p, x, xidx(row, col));
  }
}

// DK (rows = keys, columns = queries; dpn in da): pn, dst in place of dpn,
// ds of every head into x, dM_pre; cs = [2][H][COLS] lse log2 e and delta
// of the tile's queries; rows at or past `rmax` (keys past L) get pn = 0.
template <int H, int P>
__device__ __forceinline__ void dk_mix(const float (&s)[H][P],
                                       float (&da)[H][P], const float* cs,
                                       bf16* x, float (&dm)[H][H], int lrow,
                                       int t, int row0, int rmax, int half) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int row = lrow + 8 * ((p >> 1) & 1), col = pos_col<P>(p, t, half);
    const bool ok = row0 + row < rmax;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      float a = -cs[i * COLS + col];
#pragma unroll
      for (int j = 0; j < H; ++j) a = fmaf(m_pre2<H>(j, i), s[j][p], a);
      const float pn = exp2_approx(ok ? a : -INFINITY);
      da[i][p] = pn * (da[i][p] - cs[(H + i) * COLS + col]);   // dst
    }
    store_ds<H, P>(da, p, x, xidx(row, col));
#pragma unroll
    for (int j = 0; j < H; ++j)
#pragma unroll
      for (int i = 0; i < H; ++i) dm[j][i] = fmaf(da[i][p], s[j][p], dm[j][i]);
  }
}

// pn in place of s for a DK/DV tile (rows = keys, columns = queries): cs =
// [2][H][COLS] lse log2 e (+inf past L) and delta of the tile's queries;
// rows at or past `rmax` (keys past L) get pn = 0.
template <int H, int P>
__device__ __forceinline__ void kv_pn(float (&s)[H][P], const float* cs,
                                      int lrow, int t, int row0, int rmax,
                                      int half) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int row = lrow + 8 * ((p >> 1) & 1), col = pos_col<P>(p, t, half);
    const bool ok = row0 + row < rmax;
    float x[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      float a = -cs[i * COLS + col];
#pragma unroll
      for (int j = 0; j < H; ++j) a = fmaf(m_pre2<H>(j, i), s[j][p], a);
      x[i] = a;
    }
#pragma unroll
    for (int i = 0; i < H; ++i) s[i][p] = exp2_approx(ok ? x[i] : -INFINITY);
  }
}

// DV (pn in s): pt of every head into x and dM_post.
template <int H, int P>
__device__ __forceinline__ void dv_mix(const float (&pn)[H][P],
                                       const float (&da)[H][P], bf16* x,
                                       float (&dm)[H][H], int lrow, int t,
                                       int half) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int row = lrow + 8 * ((p >> 1) & 1), col = pos_col<P>(p, t, half);
#pragma unroll
    for (int i = 0; i < H; ++i) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < H; ++j) a = fmaf(m_post<H>(j, i), pn[j][p], a);
      x[i * XHEAD + xidx(row, col)] = __float2bfloat16(a);
    }
#pragma unroll
    for (int j = 0; j < H; ++j)
#pragma unroll
      for (int i = 0; i < H; ++i) dm[j][i] = fmaf(da[i][p], pn[j][p], dm[j][i]);
  }
}

// [H][H] partial of a warp (butterfly, fixed order) -> out[e * stride] by
// lane 0 (the wrapper sums each entry's partials along a row).
template <int H>
__device__ __forceinline__ void write_dm(float (&dm)[H][H], float* out,
                                         size_t stride, int lane) {
#pragma unroll
  for (int j = 0; j < H; ++j)
#pragma unroll
    for (int i = 0; i < H; ++i) {
      float v = dm[j][i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) out[(j * H + i) * stride] = v;
    }
}

// 384 threads: warpgroup 0 mixes, warpgroup 1 accumulates, warpgroup 2's
// first warp produces. Work tiles of
// 64 resident rows of one image, persistent. res0/res1: maps of the
// resident bands (64-row boxes); str0: of the streamed band read in its own
// boxes, str1: of the streamed band read one box per head (16-row boxes).
// lse, delta [B, H, L] (delta written by DQ, read by DK); dm [2][H H][4
// tiles]: DV writes dM_post partials (4 a work tile, one a warp), DK dM_pre;
// out: dq, dk or dv.
template <int H, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
th_bwd_kernel(const __grid_constant__ CUtensorMap res0,
              const __grid_constant__ CUtensorMap res1,
              const __grid_constant__ CUtensorMap str0,
              const __grid_constant__ CUtensorMap str1,
              const float* __restrict__ lse, float* __restrict__ delta,
              float* __restrict__ dm_out, bf16* __restrict__ out, int batch,
              int L) {
  using P = Plan<H, MODE>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* sres = reinterpret_cast<bf16*>(base);
  bf16* sstr0 = reinterpret_cast<bf16*>(base + P::OFF_STR0);
  bf16* sstr1 = reinterpret_cast<bf16*>(base + P::OFF_STR1);
  bf16* sx = reinterpret_cast<bf16*>(base + P::OFF_EXCH);
  float* sst = reinterpret_cast<float*>(base + P::OFF_STAT);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + P::OFF_BAR);
  uint64_t* res_full = bars;
  uint64_t* res_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = full + STAGES;
  uint64_t* xfull = empty + STAGES;
  uint64_t* xempty = xfull + 2;

  const int tid = threadIdx.x;
  const int nx = (L + ROWS - 1) / ROWS, tiles = nx * batch;
  const int nc = (L + COLS - 1) / COLS;     // streamed tiles of a sweep

  if (tid == 0) {
    mbar_init(res_full, 33);                // TMA lane + 32 statistics lanes
    mbar_init(res_empty, 2);                // one arrival per consumer group
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 33);
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
    if (tid >= CONSUMERS + 32) return;      // one warp works
    const int lane = tid & 31;
    int step = 0;
    for (int tile = blockIdx.x, n = 0; tile < tiles;
         tile += gridDim.x, ++n) {
      const int x = tile % nx, b = tile / nx, r0 = x * ROWS;
      wait(res_empty, (n & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(res_full, P::RES_TX);
        for (int c = 0; c < P::NB; ++c) {
          tma_load_3d(sres + c * BOX_RES, &res0, res_full, 64 * c, r0, b);
          tma_load_3d(sres + (P::NB + c) * BOX_RES, &res1, res_full, 64 * c,
                      r0, b);
        }
      }
      if constexpr (MODE == DQ) {           // the rows' lse log2 e
        for (int e = lane; e < H * ROWS; e += 32) {
          const int i = e / ROWS, r = r0 + e % ROWS;
          sst[e] = r < L ? lse[((size_t)b * H + i) * L + r] * kLog2e
                         : INFINITY;
        }
      }
      mbar_arrive(res_full);
      for (int sw = 0; sw < P::SWEEPS; ++sw) {
        for (int j = 0; j < nc; ++j, ++step) {
          const int st = step % STAGES;
          constexpr int PER = H * COLS / 32;  // statistics a lane moves
          float l2[PER], dl[PER];
          if constexpr (MODE != DQ) {       // loaded before the slot frees
#pragma unroll
            for (int u = 0; u < PER; ++u) {
              const int e = lane + 32 * u, i = e / COLS, q = j * COLS + e % COLS;
              const size_t at = ((size_t)b * H + i) * L + q;
              l2[u] = q < L ? lse[at] * kLog2e : INFINITY;
              dl[u] = MODE == DK && q < L ? delta[at] : 0.f;
            }
          }
          wait(&empty[st], ((step / STAGES) & 1) ^ 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(&full[st], P::STAGE_TX);
            for (int c = 0; c < P::NB; ++c)
              tma_load_3d(sstr0 + (st * P::NB + c) * BOX_STR, &str0, &full[st],
                          64 * c, j * COLS, b);
            for (int h = 0; h < H; ++h)
              tma_load_3d(sstr1 + (st * H + h) * BOX_STR, &str1, &full[st],
                          TD * h, j * COLS, b);
          }
          if constexpr (MODE != DQ) {
            float* cs = sst + st * 2 * H * COLS;
#pragma unroll
            for (int u = 0; u < PER; ++u) {
              cs[lane + 32 * u] = l2[u];
              cs[H * COLS + lane + 32 * u] = dl[u];
            }
          }
          mbar_arrive(&full[st]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup 0 mixes, warpgroup 1 accumulates; each runs its
  // own copy of the code below, so that
  // ptxas knows the register budget of every instruction (setmaxnreg)
  const int wg = tid >> 7, wt = tid & 127, wi = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = 16 * wi + g;             // local rows lrow, lrow + 8
  const bool leader = wt == 0;
  auto consumer = [&](auto role) {
    constexpr int WG = decltype(role)::value;
    const uint64_t dres = desc_k_major(sres);
    const uint64_t dstr0 = desc_k_major(sstr0), dstr1 = desc_k_major(sstr1);
    const uint64_t mstr1 = desc_mn_major(sstr1);
    constexpr uint64_t STR0_STEP = P::NB * BOX_STR * 2 / 16;   // per slot
    constexpr uint64_t STR1_STEP = H * BOX_STR * 2 / 16;
    int step = 0, xstep = 0;
    for (int tile = blockIdx.x, n = 0; tile < tiles; tile += gridDim.x, ++n) {
      const int x = tile % nx, b = tile / nx, r0 = x * ROWS;
      bf16* outb = out + (size_t)b * L * (H * TD);
      wait(res_full, n & 1);
      if constexpr (MODE == DQ) {
        // sweep 1: the mix warpgroup forms delta of its 64 rows; the
        // accumulate warpgroup only releases the slots. (Both mixing
        // alternate key tiles, their partials combined after the sweep,
        // deadlocked on a slot barrier once in several hundred calls on the
        // card, through a named barrier or an mbarrier handoff alike, and
        // was no faster.)
        if constexpr (WG == 0) {
          float dl[2][H];
#pragma unroll
          for (int j = 0; j < H; ++j) dl[0][j] = dl[1][j] = 0.f;
          for (int j = 0; j < nc; ++j, ++step) {
            const int st = step % STAGES;
            wait(&full[st], (step / STAGES) & 1);
            float s[H][8], da[H][8];
            mix_products<H, DQ, 8>(s, da, dres, dstr0 + st * STR0_STEP,
                                   dstr1 + st * STR1_STEP);
            wgmma_wait<1>();
            fence_all(s);
            dq_pn<H>(s, sst, lrow, j * COLS + 2 * t, L);
            wgmma_wait<0>();
            fence_all(da);
            warpgroup_sync(2 + WG);
            if (leader) mbar_arrive(&empty[st]);
            dpn_in_place<H, 8>(da);
            dq_sweep1_mix<H>(s, da, dl);
          }
          // delta of each row: the 4 lanes of the row
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
#pragma unroll
            for (int j = 0; j < H; ++j) {
              float v = dl[rh][j];
              v += __shfl_xor_sync(0xffffffffu, v, 1);
              v += __shfl_xor_sync(0xffffffffu, v, 2);
              const int r = lrow + 8 * rh;
              if (t == 0) {
                sst[H * ROWS + j * ROWS + r] = v;
                if (r0 + r < L) delta[((size_t)b * H + j) * L + r0 + r] = v;
              }
            }
          warpgroup_sync(2 + WG);           // delta in, for sweep 2
        } else {
          for (int j = 0; j < nc; ++j, ++step) {
            const int st = step % STAGES;
            wait(&full[st], (step / STAGES) & 1);
            if (leader) mbar_arrive(&empty[st]);
          }
        }
      }
      if constexpr (WG == 0) {              // the mix
        float dm[H][H];
#pragma unroll
        for (int j = 0; j < H; ++j)
#pragma unroll
          for (int i = 0; i < H; ++i) dm[j][i] = 0.f;
        for (int j = 0; j < nc; ++j, ++step, ++xstep) {
          const int st = step % STAGES, xb = xstep & 1;
          bf16* xbuf = sx + xb * H * XHEAD;
          wait(&full[st], (step / STAGES) & 1);
          if constexpr (MODE == DQ) {
            float s[H][8], da[H][8];
            mix_products<H, DQ, 8>(s, da, dres, dstr0 + st * STR0_STEP,
                                   dstr1 + st * STR1_STEP);
            wgmma_wait<1>();
            fence_all(s);
            dq_pn<H>(s, sst, lrow, j * COLS + 2 * t, L);   // under da
            wgmma_wait<0>();
            fence_all(da);
            wait(&xempty[xb], ((xstep >> 1) & 1) ^ 1);
            dpn_in_place<H, 8>(da);
            dq_sweep2_mix<H>(s, da, sst + H * ROWS, xbuf, lrow, t);
          } else {
            // s (DK) or pn (DV) stays beside da and the dM sum: the mix
            // takes the slot as two 8-row halves, s and da 8 H registers
            const float* cs = sst + st * 2 * H * COLS;   // its statistics
            wait(&xempty[xb], ((xstep >> 1) & 1) ^ 1);
#pragma unroll 1
            for (int half = 0; half < 2; ++half) {
              float s[H][4], da[H][4];
              mix_products<H, MODE, 4>(s, da, dres, dstr0 + st * STR0_STEP,
                                       dstr1 + st * STR1_STEP, half);
              if constexpr (MODE == DK) {
                wgmma_wait<0>();
                fence_all(s);
                fence_all(da);
                dpn_in_place<H, 4>(da);
                dk_mix<H, 4>(s, da, cs, xbuf, dm, lrow, t, r0, L, half);
              } else {
                wgmma_wait<1>();
                fence_all(s);
                kv_pn<H, 4>(s, cs, lrow, t, r0, L, half);    // under da
                wgmma_wait<0>();
                fence_all(da);
                dv_mix<H, 4>(s, da, xbuf, dm, lrow, t, half);
              }
            }
          }
          warpgroup_sync(2 + WG);           // the slot's statistics read
          if (leader) mbar_arrive(&empty[st]);
          mbar_arrive(&xfull[xb]);
        }
        // [2][H H][tiles 4] partials: dM_post (DV), then dM_pre (DK)
        if constexpr (MODE != DQ)
          write_dm<H>(dm, dm_out + (MODE == DK ? (size_t)H * H * tiles * 4 : 0)
                              + (size_t)tile * 4 + wi,
                      (size_t)tiles * 4, lane);
      } else {                              // the accumulation
        float acc[H][24];
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int i = 0; i < 24; ++i) acc[h][i] = 0.f;
        for (int j = 0; j < nc; ++j, ++step, ++xstep) {
          const int st = step % STAGES, xb = xstep & 1;
          wait(&full[st], (step / STAGES) & 1);
          wait(&xfull[xb], (xstep >> 1) & 1);
          acc_step<H>(acc, sx + xb * H * XHEAD, mstr1 + st * STR1_STEP, wi,
                      lane);
          warpgroup_sync(2 + WG);
          if (leader) {
            mbar_arrive(&xempty[xb]);
            mbar_arrive(&empty[st]);
          }
        }
        store_rows<H>(acc, outb, H * TD, r0, lrow, t, L);
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

template <int H, int MODE>
cudaError_t launch(const CUtensorMap& res0, const CUtensorMap& res1,
                   const CUtensorMap& str0, const CUtensorMap& str1,
                   const float* lse, float* delta, float* dm, bf16* out,
                   int batch, int L, cudaStream_t st) {
  using P = Plan<H, MODE>;
  static_assert(P::SMEM <= 232448, "over the block's shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      th_bwd_kernel<H, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = (L + ROWS - 1) / ROWS * batch;
  th_bwd_kernel<H, MODE><<<flash::persistent_grid(tiles), THREADS, P::SMEM,
                           st>>>(res0, res1, str0, str1, lse, delta, dm, out,
                                 batch, L);
  return cudaGetLastError();
}

template <int H>
int run(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* mix, float* delta, float* dm, void* dq,
        void* dk, void* dv, int batch, int L, cudaStream_t st) {
  const int width = H * TD;
  cudaError_t e = cudaMemcpyToSymbolAsync(c_mix, mix, 3 * H * H * sizeof(float),
                                          0, cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  // [64-row, 16-row] maps of q, k, v, do
  CUtensorMap maps[4][2];
  const void* bases[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i)
    for (int r = 0; r < 2; ++r) {
      const int err = band_map(&maps[i][r], bases[i], batch, L, L, width,
                               r == 0 ? ROWS : COLS);
      if (err) return err;
    }
  enum { Q, K, V, O };
  bf16 *gq = (bf16*)dq, *gk = (bf16*)dk, *gv = (bf16*)dv;
  e = launch<H, DQ>(maps[Q][0], maps[O][0], maps[V][1], maps[K][1], lse,
                    delta, dm, gq, batch, L, st);
  if (e == cudaSuccess)
    e = launch<H, DK>(maps[K][0], maps[V][0], maps[O][1], maps[Q][1], lse,
                      delta, dm, gk, batch, L, st);
  if (e == cudaSuccess)
    e = launch<H, DV>(maps[K][0], maps[V][0], maps[Q][1], maps[O][1], lse,
                      delta, dm, gv, batch, L, st);
  return (int)e;
}

}  // namespace thb
}  // namespace sav

// Dynamic shared memory of mode 0 (DQ), 1 (DK) or 2 (DV) at H heads, 0 for
// an unbuilt H; mirrored by th_bwd_plan in ops/th_attention.py.
extern "C" int sav_th_bwd_smem(int heads, int mode) {
  using namespace sav::thb;
  if (heads == 4)
    return mode == 0 ? Plan<4, DQ>::SMEM
                     : mode == 1 ? Plan<4, DK>::SMEM : Plan<4, DV>::SMEM;
  if (heads == 6)
    return mode == 0 ? Plan<6, DQ>::SMEM
                     : mode == 1 ? Plan<6, DK>::SMEM : Plan<6, DV>::SMEM;
  if (heads == 8)
    return mode == 0 ? Plan<8, DQ>::SMEM
                     : mode == 1 ? Plan<8, DK>::SMEM : Plan<8, DV>::SMEM;
  return 0;
}

// K5b and K6b. q, k, v, dout, dq, dk, dv [B, L, H*48] bf16; lse [B, H, L]
// from the forward; mix [3, H, H] f32 (M_pre, M_pre * log2 e, M_post);
// delta [B, H, L] f32 scratch; dm [2, H H, B ceil(L / 64) 4] f32 partials
// (dM_post, then dM_pre; 4 a work tile) for the wrapper to sum.
extern "C" int sav_th_core_bwd(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* mix, float* delta, float* dm,
                               void* dq, void* dk, void* dv, int batch,
                               int seq, int heads, void* stream) {
  using namespace sav::thb;
  cudaStream_t st = (cudaStream_t)stream;
  if (heads == 4)
    return run<4>(q, k, v, dout, lse, mix, delta, dm, dq, dk, dv, batch, seq,
                  st);
  if (heads == 6)
    return run<6>(q, k, v, dout, lse, mix, delta, dm, dq, dk, dv, batch, seq,
                  st);
  if (heads == 8)
    return run<8>(q, k, v, dout, lse, mix, delta, dm, dq, dk, dv, batch, seq,
                  st);
  return (int)cudaErrorInvalidValue;
}

// The staged backward's plan at (B, L, 16 heads) (th_bwd_staged.cuh): out[0]
// LP (the row pitch of DS and PT), [1..4] the workspace offsets of S, DA,
// DS, PT, [5] workspace bytes, [6..8] dynamic shared memory of the
// products, mix and GEMM kernels, [9..11] their blocks (the GEMM's a
// launch; the mix's are the dM partials of each kind). Returns 0, or
// cudaErrorInvalidValue for another head count. Mirrored by th_bwd_plan.
extern "C" int sav_th_bwd_staged_plan(int batch, int seq, int heads,
                                      long long* out) {
  using namespace sav::ths;
  if (heads != H || batch < 1 || seq < 1) return (int)cudaErrorInvalidValue;
  const Layout lay(batch, seq);
  const int nt = tiles_of(seq);
  const long long vals[12] = {lay.lp, (long long)lay.s, (long long)lay.da,
                              (long long)lay.ds, (long long)lay.pt,
                              (long long)lay.total, PRODUCTS_SMEM, MIX_SMEM,
                              GEMM_SMEM, (long long)batch * H * nt * nt,
                              mix_blocks(batch, seq), (long long)batch * H * nt};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
  return 0;
}

// K5b and K6b at H = 16: as sav_th_core_bwd, with ws the workspace of
// sav_th_bwd_staged_plan's out[5] bytes and dm [2, H H, out[10]] f32
// partials (dM_post, then dM_pre), and no delta scratch.
extern "C" int sav_th_core_bwd_staged(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* mix,
                                      void* ws, float* dm, void* dq, void* dk,
                                      void* dv, int batch, int seq, int heads,
                                      void* stream) {
  if (heads != sav::ths::H || batch < 1 || seq < 1)
    return (int)cudaErrorInvalidValue;
  return sav::ths::run(q, k, v, dout, lse, mix, ws, dm, dq, dk, dv, batch,
                       seq, (cudaStream_t)stream);
}
