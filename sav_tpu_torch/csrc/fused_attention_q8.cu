// K10 port: the pre-LN attention sublayer's serving forward with int8
// q/k/v/out projections.
//
// Replaces sav_tpu/ops/fused_layer.py::_fused_infer_q8_kernel (launcher
// attention_sublayer_q8):
//   y = LN(x) in f32 (fast variance), quantised per row over D (one set of
//     codes feeds q, k and v);
//   q = bf16((f32(yq Wq) * (ys * sq)) / sqrt(d)), k, v = bf16(f32(yq W) *
//     (ys * s)), int32 sums, per-column f32 weight scales;
//   attn_h = bf16(softmax(q_h k_h^T) v_h): f32 logits, max, exp and sum, p
//     rounded to bf16 for the PV product, divided by the sum at the end;
//   out = bf16(x + f32(aq Wo) * (as * so)), with the heads' bf16 bands
//     quantised per row over H*d.
// Serving only: there is no backward (the JAX package differentiates
// nothing through it either), and the wrapper raises under autograd.
//
// Bound on the card: at ViT-B, B = 32, L = 197 the four projections are
// 29.7 G int8 operations (0.015 ms at 1979 TOPS) and the attention core
// 3.8 G bf16 FLOP (0.004 ms at 989 TFLOP/s), against ~20 MB of x, out and
// the weight codes: bound by operations, ~0.019 ms.
//
// Design: four launches, none of them mma.sync, and no bf16 band in device
// memory (K11's plan, th_attention_q8.cu, with K4's softmax core):
//  1. q8g::ln_codes_kernel: the four weights' codes transposed into the
//     workspace (s8 wgmma reads K-major B only, and the checkpoint layout
//     is [D, H*64] / [H*64, D]) and, in the same launch, y's codes and row
//     scales one warp a row;
//  2. q8g QKV: yq [Wq | Wk | Wv] on the persistent s8 wgmma + TMA GEMM
//     (q8_gemm_sm90.cuh), each output its own TILE-column tiles, q scaled
//     in the epilogue;
//  3. k10_core_kernel (below): the attention of every head on wgmma + TMA,
//     and the bands' codes of each row taken in the same launch;
//  4. q8g OUT: aq Wo with the dequant epilogue and + x.
//
// The core. A row's codes are taken over all H*64 columns of its bands, so
// a work unit is 64 query rows of one image over every head; the unit's
// bands are staged as bf16 in shared memory (64 x (H*64 + 8); in a
// workspace region of the unit where they do not fit beside the rings, past
// H = 12) and quantised there. The unit gives 4 x 32 = 128 units at ViT-B
// bs32 on 132 SMs, one each: persistent blocks of 512 threads, three
// consumer warpgroups taking the heads in turn (wg, wg + 3, ...), each with
// its own producer thread, q slot and ring of K/V slots, so none waits on
// another's head (three, not two: 0.0411 against 0.0441 ms at ViT-B bs32
// with 16 bytes spilled at 160 registers a thread); per head, as K4
// (flash_fwd_sm90.cuh) with the max made exact first:
//  * q arrives by TMA and is held as the register A operand (the slot is
//    freed at once, and the next head's q loads while this one runs);
//  * sweep 1 streams K and takes each row's final max of s = q k^T
//    (wgmma, K K-major; two tiles' products at once; keys past L at -inf);
//  * sweep 2 streams K and V: s again, p = exp(s - m) against that max
//    (the max the TPU kernel subtracts, so p rounds to bf16 where its p
//    does) as one FFMA and ex2.approx (expf's range handling cost the
//    launch 0.022 ms at ViT-B bs32: scripts/torch_ablate.py k10, expf),
//    the row sums in f32, o += bf16(p) V (p packed as the register A
//    operand, V read MN-major); tile j's s is issued beside tile j-1's
//    p V, as in K4;
//  * the rows are divided by their sums (IEEE), rounded to bf16 into the
//    staging tile, and each thread keeps its rows' absmax.
// Once every warpgroup has stored its heads, the rows' absmax meet in
// shared memory and all 384 consumer threads take the codes of the staged
// rows, 16 a thread at a time: scale = max(absmax, 1e-8) / 127 by IEEE
// division, codes by q8::quantize_exact (the IEEE quotient's), out to aq
// [B, L, H*64] int8 in 16-byte stores and as [B, L] f32. Query rows past L
// read zeros and are never stored; nothing is padded in device memory.
// Measured and not kept: the four key tiles' logits at 193 <= L <= 208
// held in registers from the max to p V (one s product a tile; two
// warpgroups, a ring of single K or V boxes), 0.049 against 0.041 ms.
#include "q8_gemm_sm90.cuh"

namespace sav {
namespace k10 {

using namespace flash;

constexpr int ROWS = 64;                 // query rows of a work unit
constexpr int MAX_STAGES = 4;            // K/V ring slots a warpgroup
constexpr int SLOT = 2 * TILE_BYTES;     // a ring slot: a K and a V box
constexpr int SMEM_LIMIT = 232448;
constexpr int WGS = 3;                   // consumer warpgroups
constexpr int CONS = 128 * WGS;          // consumer threads
constexpr int NTHREADS = CONS + 128;     // and the producer warpgroup
// 512 threads start at 128 registers: 24 + 3 x 160 = 504 <= 4 x 128
constexpr int PROD_REGS = 24;
constexpr int CONS_REGS = 160;
static_assert(PROD_REGS * 128 + CONS_REGS * CONS <= 65536, "registers");

// The core's shared memory at H*64 = hd (bytes from a 1024-byte aligned
// base): a q slot a warpgroup, each warpgroup's ring, the staging tile
// (when in shared memory), the rows' absmax of each warpgroup, the
// mbarriers (a warpgroup's q_full, q_empty, full[stages], empty[stages]).
// The most ring slots (<= 4, >= 2) that fit beside the staging tile; where
// two do not, the tile goes to the workspace and the ring takes 4. Mirrored
// by fused_q8_plan in ops/fused_layer.py.
struct CorePlan {
  int hd, pitch, stages, staged;         // staged: 1 in shared memory
  int off_ring, off_stage, off_amax, off_bar, smem;
};

__host__ __device__ inline CorePlan core_plan(int hd) {
  CorePlan p;
  p.hd = hd;
  p.pitch = hd + 8;                      // bf16 a staged row (+16 bytes)
  const int stage_bytes = ROWS * p.pitch * 2;
  for (int staged = 1; staged >= 0; --staged)
    for (int s = MAX_STAGES; s >= 2; --s) {
      p.stages = s;
      p.staged = staged;
      p.off_ring = WGS * TILE_BYTES;
      p.off_stage = p.off_ring + WGS * s * SLOT;
      p.off_amax = p.off_stage + (staged ? stage_bytes : 0);
      p.off_bar = p.off_amax + WGS * ROWS * 4;
      p.smem = p.off_bar + WGS * (2 + 2 * s) * 8 + 1024;
      if (p.smem <= SMEM_LIMIT) return p;
    }
  return p;                              // not reached: 4 slots always fit
}

// Work units of the core: 64 query rows of one image.
__host__ __device__ inline int core_units(int batch, int L) {
  return (L + ROWS - 1) / ROWS * batch;
}

// Sweep 1's step on key tile j (W wide): s = q k^T, keys past L at -inf,
// the rows' running max; the slot is freed once its product is in.
template <int W>
__device__ __forceinline__ void max_tile(float& m0, float& m1,
                                         const uint32_t (&q_a)[4][4],
                                         const bf16* k, uint64_t* full,
                                         uint64_t* empty, int stages,
                                         int step, int key0, int L,
                                         bool leader) {
  const int st = step % stages;
  float sc[W / 2];
  mbar_wait(&full[st], (step / stages) & 1);
  wgmma_fence();
  mma_xy<W>(sc, q_a, k + st * (SLOT / 2));
  wgmma_wait<0>();
  fence_regs(sc);
  if (leader) mbar_arrive(&empty[st]);
#pragma unroll
  for (int i = 0; i < W / 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool in = key0 + 8 * i + j < L;
      m0 = fmaxf(m0, in ? sc[4 * i + j] : -INFINITY);
      m1 = fmaxf(m1, in ? sc[4 * i + 2 + j] : -INFINITY);
    }
}

// Sweep 1's step on tiles j and j + 1 (W0 and W1 wide, both in the ring):
// both products issued at once, each tile's max taken as its own is in.
template <int W0, int W1>
__device__ __forceinline__ void max_pair(float& m0, float& m1,
                                         const uint32_t (&q_a)[4][4],
                                         const bf16* k, uint64_t* full,
                                         uint64_t* empty, int stages,
                                         int step, int key0, int L,
                                         bool leader) {
  const int s0 = step % stages, s1 = (step + 1) % stages;
  float a[W0 / 2], c[W1 / 2];
  mbar_wait(&full[s0], (step / stages) & 1);
  mbar_wait(&full[s1], ((step + 1) / stages) & 1);
  wgmma_fence();
  mma_xy<W0>(a, q_a, k + s0 * (SLOT / 2));
  mma_xy<W1>(c, q_a, k + s1 * (SLOT / 2));
  wgmma_wait<1>();
  fence_regs(a);
  if (leader) mbar_arrive(&empty[s0]);
#pragma unroll
  for (int i = 0; i < W0 / 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool in = key0 + 8 * i + j < L;
      m0 = fmaxf(m0, in ? a[4 * i + j] : -INFINITY);
      m1 = fmaxf(m1, in ? a[4 * i + 2 + j] : -INFINITY);
    }
  wgmma_wait<0>();
  fence_regs(c);
  if (leader) mbar_arrive(&empty[s1]);
#pragma unroll
  for (int i = 0; i < W1 / 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool in = key0 + TILE + 8 * i + j < L;
      m0 = fmaxf(m0, in ? c[4 * i + j] : -INFINITY);
      m1 = fmaxf(m1, in ? c[4 * i + 2 + j] : -INFINITY);
    }
}

// One consumer thread's rows lrow and lrow + 8 of the head in progress:
// the p V accumulator, the final max and the per-thread partial sums.
struct Rows {
  float o[32];
  float m0, m1, l0, l1;
  float n0, n1;                          // m log2 e
};

// Where the warpgroup is in its stream: the ring step of key tile 0, the
// thread's column offset (2t), its ring, whether it frees slots.
struct Ring {
  const bf16* k;
  const bf16* v;
  uint64_t* full;
  uint64_t* empty;
  int stages, step0, t2, L;
  bool leader;
};

// Tile j's logits in sc -> p = exp(s - m) (keys past L: 0), packed as the
// register A operand of p V; the rows' sums move on.
template <int W>
__device__ __forceinline__ void exp_tile(Rows& r, float (&sc)[W / 2],
                                         uint32_t (&pa)[W / 16][4], int key0,
                                         int L) {
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < W / 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool in = key0 + 8 * i + j < L;
      sc[4 * i + j] = exp2_approx(in ? fmaf(sc[4 * i + j], kLog2e, -r.n0)
                                     : -INFINITY);
      sc[4 * i + 2 + j] = exp2_approx(
          in ? fmaf(sc[4 * i + 2 + j], kLog2e, -r.n1) : -INFINITY);
      rs0 += sc[4 * i + j];
      rs1 += sc[4 * i + 2 + j];
    }
  r.l0 += rs0;
  r.l1 += rs1;
  pack_frags<W>(pa, sc);
}

// Sweep 2's step on tile j (W_S wide) once the previous tile's p (W_P
// wide, in pp) is formed: s of tile j and pp V of tile j - 1 on the
// tensor cores, p of tile j into pn while they run, then tile j - 1's slot
// freed. j = 0 has no previous tile (W_P = 0).
template <int W_S, int W_P>
__device__ __forceinline__ void pv_step(Rows& r,
                                        const uint32_t (&pp)[W_P ? W_P / 16 : 1][4],
                                        uint32_t (&pn)[W_S / 16][4],
                                        const uint32_t (&q_a)[4][4],
                                        const Ring& g, int j) {
  const int step = g.step0 + j, st = step % g.stages;
  const int pst = (step + g.stages - 1) % g.stages;
  float sc[W_S / 2];
  mbar_wait(&g.full[st], (step / g.stages) & 1);
  wgmma_fence();
  mma_xy<W_S>(sc, q_a, g.k + st * (SLOT / 2));             // s = q K^T
  if constexpr (W_P > 0) {
    mma_rs<W_P>(r.o, pp, g.v + pst * (SLOT / 2));           // o += p V
    wgmma_commit();
  }
  wgmma_wait<W_P ? 1 : 0>();
  fence_regs(sc);
  exp_tile<W_S>(r, sc, pn, j * TILE + g.t2, g.L);
  if constexpr (W_P > 0) {
    wgmma_wait<0>();
    fence_regs(r.o);
    if (g.leader) mbar_arrive(&g.empty[pst]);
  }
}

// The last tile's p V (tile j, W wide), and its slot freed.
template <int W>
__device__ __forceinline__ void last_pv(Rows& r,
                                        const uint32_t (&pp)[W / 16][4],
                                        const Ring& g, int j) {
  const int st = (g.step0 + j) % g.stages;
  wgmma_fence();
  mma_rs<W>(r.o, pp, g.v + st * (SLOT / 2));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(r.o);
  if (g.leader) mbar_arrive(&g.empty[st]);
}

// From the last full-width tile n_wide - 1 (its p in pp): the 1-16-row
// tail tile if L has one, then the last p V.
__device__ __forceinline__ void finish_pv(Rows& r, const uint32_t (&pp)[4][4],
                                          const uint32_t (&q_a)[4][4],
                                          const Ring& g, int n_wide) {
  if (n_wide * TILE < g.L) {
    uint32_t p16[1][4];
    pv_step<16, 64>(r, pp, p16, q_a, g, n_wide);
    last_pv<16>(r, p16, g, n_wide);
  } else {
    last_pv<64>(r, pp, g, n_wide - 1);
  }
}

// qmap, kmap, vmap: q, k, v [B, L, hd] bf16 in 64 x 64 boxes. aq [B, L, hd]
// int8, as [B, L] f32; gstage: the workspace's staging tiles (a unit's 64 x
// pitch bf16 each) where the plan does not stage in shared memory.
__global__ void __launch_bounds__(NTHREADS, 1)
k10_core_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                int8_t* __restrict__ aq, float* __restrict__ as,
                bf16* __restrict__ gstage, const CorePlan plan, int batch,
                int L, int heads) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int S = plan.stages, hd = plan.hd, pitch = plan.pitch;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + plan.off_bar);
  float* amax_s = reinterpret_cast<float*>(base + plan.off_amax);
  const int tid = threadIdx.x;
  const int nx = (L + ROWS - 1) / ROWS, units = nx * batch;
  const int n_k = (L + TILE - 1) / TILE;
  // warpgroup w's q slot, ring (K box, V box a slot) and barriers
  auto qslot = [&](int w) {
    return reinterpret_cast<bf16*>(base + w * TILE_BYTES);
  };
  auto kring = [&](int w) {
    return reinterpret_cast<bf16*>(base + plan.off_ring + w * S * SLOT);
  };
  auto q_full = [&](int w) { return bars + w * (2 + 2 * S); };
  auto q_empty = [&](int w) { return bars + w * (2 + 2 * S) + 1; };
  auto full = [&](int w) { return bars + w * (2 + 2 * S) + 2; };
  auto empty = [&](int w) { return bars + w * (2 + 2 * S) + 2 + S; };

  if (tid == 0) {
    for (int w = 0; w < WGS; ++w) {
      mbar_init(q_full(w), 1);
      mbar_init(q_empty(w), 1);
      for (int i = 0; i < S; ++i) {
        mbar_init(&full(w)[i], 1);
        mbar_init(&empty(w)[i], 1);
      }
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONS) {                        // producer warpgroup
    setmaxnreg_dec<PROD_REGS>();
    const int w = (tid - CONS) >> 5;        // warp w serves warpgroup w
    if (w >= WGS || (tid & 31) != 0) return;
    bf16* ring = kring(w);
    int step = 0, qn = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int b = u / nx, r0 = (u % nx) * ROWS;
      for (int h = w; h < heads; h += WGS, ++qn) {
        mbar_wait(q_empty(w), (qn & 1) ^ 1);
        mbar_arrive_expect_tx(q_full(w), TILE_BYTES);
        tma_load_3d(qslot(w), &qmap, q_full(w), h * BD, r0, b);
        for (int sw = 0; sw < 2; ++sw)
          for (int j = 0; j < n_k; ++j, ++step) {
            const int st = step % S;
            mbar_wait(&empty(w)[st], ((step / S) & 1) ^ 1);
            mbar_arrive_expect_tx(&full(w)[st],
                                  sw ? 2 * TILE_BYTES : TILE_BYTES);
            bf16* slot = ring + st * (SLOT / 2);
            tma_load_3d(slot, &kmap, &full(w)[st], h * BD, j * TILE, b);
            if (sw)
              tma_load_3d(slot + TILE_ELEMS, &vmap, &full(w)[st], h * BD,
                          j * TILE, b);
          }
      }
    }
    return;
  }

  setmaxnreg_inc<CONS_REGS>();
  const int wg = tid >> 7, wt = tid & 127, wi = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = 16 * wi + g;             // rows lrow and lrow + 8
  const bool leader = wt == 0;
  const int n_wide = wide_tiles(L);
  const bf16* ring = kring(wg);
  int step = 0, qn = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int b = u / nx, r0 = (u % nx) * ROWS;
    bf16* stg = plan.staged
                    ? reinterpret_cast<bf16*>(base + plan.off_stage)
                    : gstage + (size_t)u * ROWS * pitch;
    float am0 = 0.f, am1 = 0.f;             // the rows' absmax, my columns
    for (int h = wg; h < heads; h += WGS, ++qn) {
      uint32_t q_a[4][4];
      mbar_wait(q_full(wg), qn & 1);
      load_a_frags(q_a, qslot(wg), wi, lane);
      warpgroup_sync(1 + wg);               // the slot is read: free it
      if (leader) mbar_arrive(q_empty(wg));

      Rows r;
      r.m0 = r.m1 = -INFINITY;
      {
        int j = 0;                          // tiles in pairs
        for (; j + 1 < n_wide; j += 2, step += 2)
          max_pair<64, 64>(r.m0, r.m1, q_a, ring, full(wg), empty(wg), S,
                           step, j * TILE + 2 * t, L, leader);
        if (j < n_wide && n_wide < n_k) {   // the last wide one and the tail
          max_pair<64, 16>(r.m0, r.m1, q_a, ring, full(wg), empty(wg), S,
                           step, j * TILE + 2 * t, L, leader);
          step += 2;
        } else if (j < n_wide) {
          max_tile<64>(r.m0, r.m1, q_a, ring, full(wg), empty(wg), S, step++,
                       j * TILE + 2 * t, L, leader);
        } else if (n_wide < n_k) {
          max_tile<16>(r.m0, r.m1, q_a, ring, full(wg), empty(wg), S, step++,
                       n_wide * TILE + 2 * t, L, leader);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        r.m0 = fmaxf(r.m0, __shfl_xor_sync(0xffffffffu, r.m0, off));
        r.m1 = fmaxf(r.m1, __shfl_xor_sync(0xffffffffu, r.m1, off));
      }
      r.n0 = r.m0 * kLog2e;
      r.n1 = r.m1 * kLog2e;

#pragma unroll
      for (int i = 0; i < 32; ++i) r.o[i] = 0.f;
      r.l0 = r.l1 = 0.f;
      const Ring rg{ring, ring + TILE_ELEMS, full(wg), empty(wg), S, step,
                    2 * t, L, leader};
      const uint32_t none[1][4] = {};       // tile 0 has no previous p
      if (n_wide > 0) {
        uint32_t pa[4][4], pb[4][4];
        pv_step<64, 0>(r, none, pa, q_a, rg, 0);
        int j = 1;
        for (; j + 1 < n_wide; j += 2) {    // p alternates between pa, pb
          pv_step<64, 64>(r, pa, pb, q_a, rg, j);
          pv_step<64, 64>(r, pb, pa, q_a, rg, j + 1);
        }
        if (j < n_wide) {
          pv_step<64, 64>(r, pa, pb, q_a, rg, j);
          finish_pv(r, pb, q_a, rg, n_wide);
        } else {
          finish_pv(r, pa, q_a, rg, n_wide);
        }
      } else {                              // L <= 16: one narrow tile
        uint32_t p16[1][4];
        pv_step<16, 0>(r, none, p16, q_a, rg, 0);
        last_pv<16>(r, p16, rg, 0);
      }
      step += n_k;

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, off);
        r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, off);
      }
      // the head's bf16 band rows into the staging tile, at column 64 h
      bf16* s0 = stg + (size_t)lrow * pitch + h * BD + 2 * t;
      bf16* s1 = s0 + 8 * pitch;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const __nv_bfloat162 a = __floats2bfloat162_rn(
            __fdiv_rn(r.o[4 * i], r.l0), __fdiv_rn(r.o[4 * i + 1], r.l0));
        const __nv_bfloat162 c = __floats2bfloat162_rn(
            __fdiv_rn(r.o[4 * i + 2], r.l1), __fdiv_rn(r.o[4 * i + 3], r.l1));
        *reinterpret_cast<__nv_bfloat162*>(s0 + 8 * i) = a;
        *reinterpret_cast<__nv_bfloat162*>(s1 + 8 * i) = c;
        const float2 fa = __bfloat1622float2(a), fc = __bfloat1622float2(c);
        am0 = fmaxf(am0, fmaxf(fabsf(fa.x), fabsf(fa.y)));
        am1 = fmaxf(am1, fmaxf(fabsf(fc.x), fabsf(fc.y)));
      }
    }

    // the rows' absmax over every warpgroup's heads, then the codes of the
    // staged rows by all the consumer threads
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      am0 = fmaxf(am0, __shfl_xor_sync(0xffffffffu, am0, off));
      am1 = fmaxf(am1, __shfl_xor_sync(0xffffffffu, am1, off));
    }
    if (t == 0) {
      amax_s[wg * ROWS + lrow] = am0;
      amax_s[wg * ROWS + lrow + 8] = am1;
    }
    named_sync(WGS + 1, CONS);              // every head's rows are staged
    const int ch = hd / 16;                 // 16-code chunks of a row
    for (int c = tid; c < ROWS * ch; c += CONS) {
      const int rr = c / ch, k = c % ch, row = r0 + rr;
      if (row >= L) continue;
      float am = amax_s[rr];
#pragma unroll
      for (int w = 1; w < WGS; ++w) am = fmaxf(am, amax_s[w * ROWS + rr]);
      const float scale = q8::row_scale(am);
      const float inv = __frcp_rn(scale);
      const uint4* src =
          reinterpret_cast<const uint4*>(stg + (size_t)rr * pitch + 16 * k);
      uint4 packed;
      signed char* pc = reinterpret_cast<signed char*>(&packed);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint4 raw = src[half];
        const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(v2[e]);
          pc[8 * half + 2 * e] =
              (signed char)q8::quantize_exact(f.x, scale, inv);
          pc[8 * half + 2 * e + 1] =
              (signed char)q8::quantize_exact(f.y, scale, inv);
        }
      }
      const size_t at = (size_t)b * L + row;
      *reinterpret_cast<uint4*>(aq + at * hd + 16 * k) = packed;
      if (k == 0) as[at] = scale;
    }
    named_sync(WGS + 1, CONS);              // the tile and absmax are free
  }
}

int core_launch(const void* q, const void* k, const void* v, void* aq,
                float* as, void* gstage, int batch, int L, int heads,
                cudaStream_t st) {
  const int hd = heads * BD;
  const CorePlan plan = core_plan(hd);
  CUtensorMap qmap, kmap, vmap;
  int err = band_map(&qmap, q, batch, L, L, hd);
  if (!err) err = band_map(&kmap, k, batch, L, L, hd);
  if (!err) err = band_map(&vmap, v, batch, L, L, hd);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      k10_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      plan.smem);
  if (e != cudaSuccess) return (int)e;
  k10_core_kernel<<<persistent_grid(core_units(batch, L)), NTHREADS,
                    plan.smem, st>>>(qmap, kmap, vmap, (int8_t*)aq, as,
                                     (bf16*)gstage, plan, batch, L, heads);
  return (int)cudaGetLastError();
}

}  // namespace k10
}  // namespace sav

namespace {

bool bad_geometry(int batch, int seq, int dim, int heads) {
  return batch < 1 || seq < 1 || heads < 1 || dim < 128 || dim % 128
         || (heads * sav::flash::BD) % 128;
}

// The projections' column tile: 128 divides H*64 and D wherever the kernel
// runs (scripts/torch_ablate.py k10 times 64, tiles64); their ring slots
// are 128 codes deep (K = D or H*64, multiples of 128).
constexpr int TILE = 128;
constexpr int DEPTH = 128;

// The scratch of one call, 256-byte aligned regions in this order: y's
// codes [M, D] and scales [M], the transposed codes [3 H*64, D] (Wq, Wk, Wv)
// and [D, H*64] (Wo), q, k, v [M, H*64] bf16, the bands' codes [M, H*64]
// and scales [M], and the core's staging tiles where the plan does not
// stage in shared memory (a unit's 64 x (H*64 + 8) bf16 each; else none).
// Mirrored by fused_q8_plan.
struct Workspace {
  size_t at[10], total;
  Workspace(int batch, int seq, int dim, int hd) {
    const size_t m = (size_t)batch * seq;
    const sav::k10::CorePlan p = sav::k10::core_plan(hd);
    const size_t bytes[10] = {
        m * dim, m * 4, (size_t)3 * hd * dim, (size_t)dim * hd, m * hd * 2,
        m * hd * 2, m * hd * 2, m * hd, m * 4,
        p.staged ? 0
                 : (size_t)sav::k10::core_units(batch, seq) * sav::k10::ROWS
                       * p.pitch * 2};
    size_t off = 0;
    for (int i = 0; i < 10; ++i) {
      at[i] = off;
      off += sav::q8w::align256(bytes[i]);
    }
    total = off;
  }
};

enum Region { kYq = 0, kYs, kWqkv, kWo, kQ, kK, kV, kAq, kAs, kStage };

}  // namespace

// K10's launch plan at (B, L, D, H): out[0] the QKV GEMM's column tile and
// [1] the OUT GEMM's, [2] row tiles (128 rows), [3] QKV units, [4] OUT
// units, [5] QKV ring slots a unit (64-deep, over D), [6] OUT's (over
// H*64), [7] QKV's and [8] OUT's dynamic shared memory, [9] the core's,
// [10] the core's work units (64 rows of one image), [11] its K/V ring
// slots a warpgroup, [12] 1 where it stages the bands in shared memory,
// [13] workspace bytes, [14..23] the workspace regions' offsets
// (Workspace). Returns 0, or cudaErrorInvalidValue for a geometry the
// kernels do not take. Mirrored by fused_q8_plan in ops/fused_layer.py.
extern "C" int sav_fused_q8_plan(int batch, int seq, int dim, int heads,
                                 long long* out) {
  using namespace sav::q8g;
  if (bad_geometry(batch, seq, dim, heads)) return (int)cudaErrorInvalidValue;
  const int m = batch * seq, hd = heads * sav::flash::BD;
  const sav::k10::CorePlan core = sav::k10::core_plan(hd);
  out[0] = out[1] = TILE;
  out[2] = row_tiles(m);
  out[3] = row_tiles(m) * col_tiles<TILE>(QKV, 3 * hd, hd);
  out[4] = row_tiles(m) * col_tiles<TILE>(OUT, dim, dim);
  out[5] = stages_of(QKV, dim, 0, DEPTH);
  out[6] = stages_of(OUT, hd, 0, DEPTH);
  out[7] = Plan<QKV, TILE, DEPTH>::SMEM;
  out[8] = Plan<OUT, TILE, DEPTH>::SMEM;
  out[9] = core.smem;
  out[10] = sav::k10::core_units(batch, seq);
  out[11] = core.stages;
  out[12] = core.staged;
  const Workspace ws(batch, seq, dim, hd);
  out[13] = (long long)ws.total;
  for (int i = 0; i < 10; ++i) out[14 + i] = (long long)ws.at[i];
  return 0;
}

// x [B, L, D] bf16; ln_scale/ln_bias [D] f32; wq/wk/wv [D, H*64] and wo
// [H*64, D] int8 codes (per output column) with column scales sq/sk/sv
// [H*64] and so [D] f32; ws the workspace of sav_fused_q8_plan's out[13]
// bytes; out [B, L, D] bf16; residual 1 adds x. Needs D and H*64 multiples
// of 128; any L.
extern "C" int sav_fused_attention_q8(
    const void* x, const float* ln_scale, const float* ln_bias,
    const void* wq, const void* wk, const void* wv, const void* wo,
    const float* sq, const float* sk, const float* sv, const float* so,
    void* ws, void* out, int batch, int seq, int dim, int heads,
    int residual, float eps, float q_scale, void* stream) {
  using namespace sav::q8g;
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_geometry(batch, seq, dim, heads)) return (int)cudaErrorInvalidValue;
  const int m = batch * seq, hd = heads * sav::flash::BD;
  const Workspace lay(batch, seq, dim, hd);
  unsigned char* w = (unsigned char*)ws;
  auto at = [&](Region r) { return (void*)(w + lay.at[r]); };
  int8_t* wqkv = (int8_t*)at(kWqkv);

  Transposes tr = {};
  const void* ins[4] = {wq, wk, wv, wo};
  for (int i = 0; i < 4; ++i) {
    tr.in[i] = (const int8_t*)ins[i];
    tr.rows[i] = i < 3 ? dim : hd;
    tr.cols[i] = i < 3 ? hd : dim;
    tr.ld[i] = i < 3 ? dim : hd;
    tr.out[i] = i < 3 ? wqkv + (size_t)i * hd * dim : (int8_t*)at(kWo);
  }
  const int per = transpose_blocks(
      transpose_tiles(hd, dim) > transpose_tiles(dim, hd)
          ? transpose_tiles(hd, dim) : transpose_tiles(dim, hd));
  ln_codes_kernel<<<4 * per + (m + 7) / 8, 256, 0, st>>>(
      tr, 4, per, (const sav::bf16*)x, ln_scale, ln_bias, eps,
      (int8_t*)at(kYq), (float*)at(kYs), m, dim);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  Args a = {};
  a.m = m;
  a.k = dim;
  a.n = 3 * hd;
  a.n_each = hd;
  a.rs = (const float*)at(kYs);
  a.cs[0] = sq;
  a.cs[1] = sk;
  a.cs[2] = sv;
  a.q_scale = q_scale;
  void* const qkv[3] = {at(kQ), at(kK), at(kV)};
  int err = launch<QKV, TILE, DEPTH>(at(kYq), dim, wqkv, dim, qkv, hd, a,
                                     st);
  if (err) return err;

  err = sav::k10::core_launch(at(kQ), at(kK), at(kV), at(kAq),
                              (float*)at(kAs), at(kStage), batch, seq, heads,
                              st);
  if (err) return err;

  Args o = {};
  o.m = m;
  o.k = hd;
  o.n = dim;
  o.n_each = dim;
  o.rs = (const float*)at(kAs);
  o.cs[0] = o.cs[1] = o.cs[2] = so;
  o.q_scale = 1.f;
  o.x = residual ? (const sav::bf16*)x : nullptr;
  void* const outs[3] = {out, out, out};
  return launch<OUT, TILE, DEPTH>(at(kAq), hd, at(kWo), hd, outs, dim, o,
                                  st);
}
