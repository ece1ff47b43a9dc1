// The persistent, warp-specialised s8 wgmma + TMA GEMM of the K11 and K15
// ports (th_attention_q8.cu, int8_matmul.cu), with three epilogues:
//
//  QKV    yq [Wq | Wk | Wv] into three [M, n_each] bf16 outputs:
//         bf16((f32(acc) * (ys[row] * s[col])) * q_scale) for q, without
//         the last factor for k and v (K11's projections).
//  OUT    aq Wo: bf16(f32(acc) * (as[row] * so[col])), x + that in f32
//         first where x is given (K11's out projection; K13's OUT
//         epilogue without its bias).
//  BLOCK  aq B with a's scales per (row, 256-wide k-block) (K15): each
//         warpgroup runs a k-block's products into an int32 accumulator,
//         waits on them and folds them into an f32 accumulator in k
//         order, acc = acc + f32(part) * a_scale[row, kb] (two IEEE
//         roundings, no FMA: the twin's order), then bf16(acc * b_scale).
//
// The block is the shape of int8_sm90.cuh's (a producer warp feeding a
// ring of TMA boxes, consumer warpgroups on s8 wgmma m64nNk32 with both
// operands K-major, a staging tile in TMA's swizzled layout written out by
// TMA stores), with one team: 384 threads, two consumer warpgroups taking
// the two 64-row halves of a 128 x BN unit and sharing its B box, and the
// producer warpgroup. One team because BLOCK holds an int32 and an f32
// accumulator of a 64 x 128 tile (64 + 64 registers a thread), past the
// 112 a consumer of int8_sm90.cuh's 640-thread block can take; at 384
// threads a consumer takes 240. Blocks are persistent (one an SM), units
// taken blockIdx.x + j gridDim.x with column tiles fastest; the producer
// loads the next unit's boxes while the consumers run the last one's
// epilogue, and each warpgroup's TMA store runs under the next unit's
// products (the staging tile is reused once bulk_wait_read has returned).
//
// Rings: K11's QKV and OUT contract over D or H*48: six slots of
// 64-code-deep boxes (64-byte swizzle), so cait_xxs's D = 192 takes three
// steps and no padded one, and cait_xs's 288 five, the last half zeros;
// K10's over D or H*64, multiples of 128: four slots of 128-code-deep
// boxes (128-byte swizzle; half the slots a unit, 0.0086 ms off K10 at
// ViT-B bs32: scripts/torch_ablate.py k10, deep). BLOCK: four slots of
// 128-code-deep boxes, two a k-block, always both (a box past K arrives
// as zeros), so no product is issued under a condition and no commit
// group stays in flight across a loop's back edge. BN = 64 for K11 (each
// of q, k and v its own tiles, so none straddles two outputs; at
// cait_xs's 288 the last of each is 32 columns wide, col_tile), 128 for
// K15.
//
// Rows past M read zeros (TMA's out-of-bounds fill) and are not stored
// (the TMA store clips them), nor are columns past N; a ragged last
// k-block reads zeros past K from the tensor map's extent.
#pragma once

#include "flash_sm90.cuh"
#include "int8_sm90.cuh"

namespace sav {
namespace q8g {

using namespace sm90;
using q8::dequant;
using q8w::transpose_tiles;
using q8w::wait;

enum Mode { QKV = 0, OUT = 1, BLOCK = 2 };

constexpr int BM = 128;                    // a unit's rows
constexpr int CONSUMERS = 256;             // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 128;   // and the producer warpgroup
// 384 threads start at 168 registers; 24 + 2 x 240 = 504 = 3 x 168
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int KBLOCK = q8::QBLOCK;         // K15's k-block, 256 codes
constexpr uint32_t BOX = 64 * 128;         // a 64 x 64 bf16 staging box

// Shared memory (bytes from a 1024-byte aligned base): the ring, one
// staging tile a warpgroup (64 x BN bf16), OUT's two x tiles (128 x BN
// bf16 each, a unit's loaded by TMA before its first slot, units taking
// them in turn so that the next unit's loads never wait on this one's
// epilogue), the mbarriers (full[STAGES], empty[STAGES], OUT's xfull[2]
// and xempty[2]). Mirrored by th_q8_plan (ops/th_attention.py) and
// int8_matmul_plan (ops/int8_matmul_kernel.py).
template <int MODE, int BN, int BK_ = (MODE == BLOCK ? 128 : 64)>
struct Plan {
  static constexpr int BK = BK_;
  static constexpr int STAGES = BK == 128 ? 4 : 6;
  static constexpr uint32_t A_BYTES = BM * BK;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + BN * BK;
  static constexpr uint32_t STG_BYTES = 64 * BN * 2;
  static constexpr int OFF_STG = STAGES * STAGE_BYTES;
  static constexpr uint32_t X_BYTES = MODE == OUT ? BM * BN * 2 : 0;
  static constexpr int OFF_X = OFF_STG + 2 * STG_BYTES;
  static constexpr int OFF_BAR = OFF_X + 2 * X_BYTES;
  static constexpr int BARS = 2 * STAGES + (MODE == OUT ? 4 : 0);
  static constexpr int SMEM = OFF_BAR + BARS * 8 + 1024;
  static_assert(SMEM <= 232448, "over the block's shared memory");
};

struct Args {
  int m, k;             // rows, contraction depth
  int n;                // output columns (QKV: the three side by side)
  int n_each;           // the columns of one output (QKV: H*48; else n)
  int kb;               // BLOCK: k-blocks a row (a_scale's row stride)
  const float* rs;      // QKV, OUT: [M] row scales; BLOCK: [M, kb]
  const float* cs[3];   // each output's column scales [n_each]
  float q_scale;        // QKV: q's last factor
  const bf16* x;        // OUT: + x [M, n] in f32 before the rounding, or null
};

// A: 128-row boxes of the mode's depth; B: BN-row boxes; the outputs:
// 64 x 64 bf16 boxes (QKV: q, k, v; else o[0]); OUT's x as its output.
struct Maps {
  CUtensorMap a, b, o[3], x;
};

template <int BN>
__host__ __device__ __forceinline__ int col_tiles(int mode, int n,
                                                  int n_each) {
  return mode == QKV ? 3 * ((n_each + BN - 1) / BN) : (n + BN - 1) / BN;
}

// Column tile ct of a unit: its output (which), its first column there
// (ocol0) and its first row of B (bcol). QKV: each output its own
// ceil(n_each / BN) tiles, so none straddles two; where n_each is not a
// multiple of BN (cait_xs: 288) the last tile's columns past n_each read
// the next output's B rows (or zeros past the last), and its epilogue
// neither scales nor stores them.
template <int BN>
__host__ __device__ __forceinline__ void col_tile(int mode, int n_each, int ct,
                                                  int& which, int& ocol0,
                                                  int& bcol) {
  const int per = mode == QKV ? (n_each + BN - 1) / BN : 1 << 30;
  which = ct / per;
  ocol0 = (ct - which * per) * BN;
  bcol = which * n_each + ocol0;
}

__host__ __device__ __forceinline__ int row_tiles(int m) {
  return (m + BM - 1) / BM;
}

// Ring slots a unit takes: QKV, OUT ceil(k / bk) (the slots' depth; a
// ragged last slot reads zeros past k from the tensor maps' extent);
// BLOCK two a k-block.
__host__ __device__ __forceinline__ int stages_of(int mode, int k, int kb,
                                                  int bk = 64) {
  return mode == BLOCK ? 2 * kb : (k + bk - 1) / bk;
}

// d (+)= A B^T over one 32-deep step of int8 codes, 64 x N, A [64 x 32]
// and B [N x 32] K-major in shared memory, s32 accumulators; accumulate 0
// overwrites d (a k-block's or a unit's first step).
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n\t}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n\t}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// One slot's products: BK / 32 steps of the warpgroup's 64 rows of A
// against the slot's B; `first`: the first step overwrites acc.
template <int MODE, int BN, int BK_>
__device__ __forceinline__ void slot_products(int (&acc)[BN / 2],
                                              const unsigned char* st,
                                              int wg, bool first) {
  using P = Plan<MODE, BN, BK_>;
  constexpr int BK = P::BK;
  const unsigned char* a = st + wg * (64 * BK);
  const unsigned char* b = st + P::A_BYTES;
  const uint64_t da = BK == 64 ? desc_k_major_sw64(a) : desc_k_major(a);
  const uint64_t db = BK == 64 ? desc_k_major_sw64(b) : desc_k_major(b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk)
    wgmma_s8<BN>(acc, da + kk * K_STEP, db + kk * K_STEP,
                 first && kk == 0 ? 0 : 1);
  wgmma_commit();
}

template <int MODE, int BN, int BK_>
__global__ void __launch_bounds__(THREADS, 1)
q8_gemm_kernel(const __grid_constant__ Maps maps, Args args) {
  using P = Plan<MODE, BN, BK_>;
  constexpr int BK = P::BK, STAGES = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P::OFF_BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* xfull = empty + STAGES;         // OUT with x only: [2]
  uint64_t* xempty = xfull + 2;
  unsigned char* xt0 = base + P::OFF_X;
  const bool has_x = MODE == OUT && args.x != nullptr;
  const int nt = col_tiles<BN>(MODE, args.n, args.n_each);
  const int units = row_tiles(args.m) * nt;
  const int nk = stages_of(MODE, args.k, args.kb, BK);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);              // the producer's expect_tx
      mbar_init(&empty[i], 8);             // each consumer warp once
    }
    if (MODE == OUT)
      for (int i = 0; i < 2; ++i) {
        mbar_init(&xfull[i], 1);
        mbar_init(&xempty[i], 2);          // each warpgroup's leader
      }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {                  // producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != CONSUMERS) return;          // one thread issues every load
    int step = 0;
    for (int u = blockIdx.x, n = 0; u < units; u += gridDim.x, ++n) {
      const int row0 = (u / nt) * BM;
      int which, col0, bcol;
      col_tile<BN>(MODE, args.n_each, u % nt, which, col0, bcol);
      if (has_x) {                         // the unit's x, for its epilogue
        const int xs = n & 1;
        mbar_wait(&xempty[xs], ((n >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&xfull[xs], P::X_BYTES);
        for (int h = 0; h < 2; ++h)
          for (int c = 0; c < BN / 64; ++c)
            tma_load_3d(xt0 + xs * P::X_BYTES + (h * (BN / 64) + c) * BOX,
                        &maps.x, &xfull[xs], col0 + 64 * c, row0 + 64 * h,
                        0);
      }
      for (int k = 0; k < nk; ++k, ++step) {
        const int s = step % STAGES;
        mbar_wait(&empty[s], ((step / STAGES) & 1) ^ 1);
        unsigned char* st = base + s * P::STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], P::STAGE_BYTES);
        tma_load_3d(st, &maps.a, &full[s], k * BK, row0, 0);
        tma_load_3d(st + P::A_BYTES, &maps.b, &full[s], k * BK, bcol, 0);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = tid >> 7, wi = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool leader = (tid & 127) == 0;
  unsigned char* stg = base + P::OFF_STG + wg * P::STG_BYTES;
  // the consumers are done with slot s
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  int step = 0;
  for (int u = blockIdx.x, n = 0; u < units; u += gridDim.x, ++n) {
    const int row0 = (u / nt) * BM + 64 * wg;   // this warpgroup's rows
    int which, ocol0, bcol;
    col_tile<BN>(MODE, args.n_each, u % nt, which, ocol0, bcol);
    int acc[BN / 2];
    float facc[MODE == BLOCK ? BN / 2 : 1];
    if constexpr (MODE == BLOCK) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) facc[i] = 0.f;
      for (int kb = 0; kb < args.kb; ++kb) {
        // the block's row scales, fetched under its products
        float s[2];
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int row = row0 + 16 * wi + g + 8 * rh;
          s[rh] = row < args.m ? args.rs[(size_t)row * args.kb + kb] : 0.f;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h, ++step) {
          const int sl = step % STAGES;
          wait(&full[sl], (step / STAGES) & 1);
          slot_products<MODE, BN, BK>(acc, base + sl * P::STAGE_BYTES, wg,
                                      h == 0);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        release((step - 2) % STAGES);      // both slots are free
        release((step - 1) % STAGES);
        // thread (wi, g, t): acc[4 i + 2 rh + j] is row 16 wi + g + 8 rh,
        // column 8 i + 2 t + j
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float& f = facc[4 * i + 2 * rh + j];
              f = __fadd_rn(f, __fmul_rn(__int2float_rn(acc[4 * i + 2 * rh + j]),
                                         s[rh]));
            }
      }
    } else {
      for (int k = 0; k < nk; ++k, ++step) {
        const int sl = step % STAGES;
        wait(&full[sl], (step / STAGES) & 1);
        slot_products<MODE, BN, BK>(acc, base + sl * P::STAGE_BYTES, wg,
                                    k == 0);
        // the previous slot's products are done: it is free
        wgmma_wait<1>();
        if (k > 0) release((step - 1) % STAGES);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release((step - 1) % STAGES);
    }

    // epilogue into the warpgroup's staging tile, TMA's swizzled layout
    // (box c / 64; the 16-byte chunk of row r at chunk ^ (r % 8): the 8
    // rows of a store hit 8 different chunks), then one TMA store a box
    const float* cs = which == 0 ? args.cs[0]
                                 : which == 1 ? args.cs[1] : args.cs[2];
    const float qs = MODE == QKV && which == 0 ? args.q_scale : 1.f;
    if (leader) bulk_wait_read();          // the last tile's store read it
    if (has_x) wait(&xfull[n & 1], (n >> 1) & 1);
    const unsigned char* xt =
        xt0 + (n & 1) * P::X_BYTES + wg * (BN / 64) * BOX;
    warpgroup_sync(1 + wg);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int r = 16 * wi + g + 8 * rh, row = row0 + r;
      const bool in = row < args.m;
      const float rsv = MODE != BLOCK && in ? args.rs[row] : 0.f;
      const bool add = MODE == OUT && args.x != nullptr && in;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int c = 8 * i + 2 * t, col = ocol0 + c;
        // the output's (and x's) place in a swizzled 64 x 64 box
        const int sw = (c >> 6) * BOX + r * 128
                       + ((((c & 63) >> 3) ^ (r & 7)) << 4) + 4 * t;
        const float2 cv = col < args.n_each
                              ? *reinterpret_cast<const float2*>(cs + col)
                              : make_float2(0.f, 0.f);
        float v0, v1;
        if constexpr (MODE == BLOCK) {
          v0 = __fmul_rn(facc[4 * i + 2 * rh], cv.x);
          v1 = __fmul_rn(facc[4 * i + 2 * rh + 1], cv.y);
        } else {
          v0 = dequant(acc[4 * i + 2 * rh], rsv, cv.x);
          v1 = dequant(acc[4 * i + 2 * rh + 1], rsv, cv.y);
          if (MODE == QKV) {
            v0 = __fmul_rn(v0, qs);
            v1 = __fmul_rn(v1, qs);
          }
          if (add && col < args.n_each) {
            const float2 x2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xt + sw));
            v0 = __fadd_rn(x2.x, v0);
            v1 = __fadd_rn(x2.y, v1);
          }
        }
        *reinterpret_cast<uint32_t*>(stg + sw) = pack_bf16x2(v0, v1);
      }
    }
    fence_proxy_async();                   // the tile is TMA's to store
    warpgroup_sync(1 + wg);
    if (leader && has_x) mbar_arrive(&xempty[n & 1]);   // x is read
    if (leader && row0 < args.m) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        tma_store_3d(&maps.o[which], stg + c * BOX, ocol0 + 64 * c, row0, 0);
      bulk_commit();
    }
  }
  if (leader) bulk_wait_all();
}

// ---- host

// Tensor map of a [rows, width] int8 array with rows `ld` bytes apart (a
// multiple of 16), for boxes of `box_rows` rows x `depth` codes (64: the
// 64-byte swizzle; 128: the 128-byte one); codes past `width` and rows
// past `rows` read as zeros. Returns 0 or a cudaError_t.
inline int operand_map(CUtensorMap* map, const void* base, int rows,
                       int width, int ld, int depth, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)ld, (cuuint64_t)ld * rows};
  const cuuint32_t box[3] = {(cuuint32_t)depth, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        depth == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                    : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Tensor map of a [rows, width] bf16 output with rows `ld` elements apart
// (a multiple of 8), for the staging tile's 64 x 64 boxes (128-byte
// swizzle); the store writes nothing past `rows` or `width`.
inline int output_map(CUtensorMap* map, const void* base, int rows,
                      int width, int ld) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2,
                                 (cuuint64_t)ld * 2 * rows};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The maps of one launch: A [m, k] codes (rows `lda` bytes apart), B [n,
// k] codes (`ldb`), the outputs [m, n_each] bf16 (`ldo` elements apart).
template <int MODE, int BN, int BK_>
int make_maps(Maps* maps, const void* a, int lda, const void* b, int ldb,
              void* const (&out)[3], int ldo, const Args& args) {
  constexpr int BK = Plan<MODE, BN, BK_>::BK;
  int err = operand_map(&maps->a, a, args.m, args.k, lda, BK, BM);
  if (!err) err = operand_map(&maps->b, b, args.n, args.k, ldb, BK, BN);
  for (int i = 0; i < (MODE == QKV ? 3 : 1) && !err; ++i)
    err = output_map(&maps->o[i], out[i], args.m, args.n_each, ldo);
  if (MODE != QKV) maps->o[1] = maps->o[2] = maps->o[0];
  if (!err && MODE == OUT && args.x != nullptr)
    err = output_map(&maps->x, args.x, args.m, args.n_each, args.n);
  return err;
}

// One launch on `args`, blocks persistent (one an SM, or one a unit);
// BK_: the ring slots' depth (QKV and OUT: 64, or 128 where K is a
// multiple of 128).
template <int MODE, int BN, int BK_ = (MODE == BLOCK ? 128 : 64)>
int launch(const void* a, int lda, const void* b, int ldb,
           void* const (&out)[3], int ldo, const Args& args,
           cudaStream_t st) {
  using P = Plan<MODE, BN, BK_>;
  Maps maps;
  int err = make_maps<MODE, BN, BK_>(&maps, a, lda, b, ldb, out, ldo, args);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      q8_gemm_kernel<MODE, BN, BK_>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int units = row_tiles(args.m)
                    * col_tiles<BN>(MODE, args.n, args.n_each);
  q8_gemm_kernel<MODE, BN, BK_><<<flash::persistent_grid(units), THREADS,
                                  P::SMEM, st>>>(maps, args);
  return (int)cudaGetLastError();
}

// Codes transposed into K-major B operands, zeros past the input's rows:
// out[c][r] = in[r][c] (r < rows, c < cols), out[c][r] = 0 for rows <= r
// < ld (ld a multiple of 16), in 64 x 64 tiles of out (ceil(ld / 64) tiles
// of r fastest), up to 4 matrices; the first blocks of K11's and K15's
// codes launches (ln_codes_kernel, codes_kernel) take them.
struct Transposes {
  const int8_t* in[4];
  int8_t* out[4];
  int rows[4], cols[4], ld[4];
};

// Tile `tile` of matrix z, by a whole block of 256 threads through `buf`.
__device__ __forceinline__ void transpose_tile(const Transposes& p, int z,
                                               int tile,
                                               int8_t (&buf)[64][64 + 16]) {
  const int rows = p.rows[z], cols = p.cols[z], ld = p.ld[z];
  const int rt = (ld + 63) / 64;
  const int r0 = (tile % rt) * 64, c0 = (tile / rt) * 64;
  const int8_t* in = p.in[z];
  const int tr = threadIdx.x >> 2, tc = (threadIdx.x & 3) * 16;
  {
    const int r = r0 + tr, c = c0 + tc;
    int8_t* dst = &buf[tr][tc];
    if (r < rows && c + 16 <= cols && cols % 16 == 0) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(in + (size_t)r * cols + c);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = r < rows && c + j < cols ? in[(size_t)r * cols + c + j] : 0;
    }
  }
  __syncthreads();
  const int c = c0 + tr, r = r0 + tc;      // out row c, its codes r..r+15
  if (c >= cols || r >= ld) return;
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[q] |= (uint32_t)(uint8_t)buf[tc + 4 * q + j][tr] << (8 * j);
  }
  *reinterpret_cast<uint4*>(p.out[z] + (size_t)c * ld + r) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// K15's first launch, both of its memory-bound passes at once: blocks [0,
// T) transpose the weight codes (matrix 0 of p, a 64 x 64 tile each), the
// rest make a's codes, one warp a (row, two k-blocks) (q8::quantize_block).
__global__ void __launch_bounds__(256)
codes_kernel(const __grid_constant__ Transposes p, const bf16* __restrict__ a,
             int8_t* __restrict__ q, float* __restrict__ scale, int M, int K,
             int KB, int ld) {
  __shared__ __align__(16) int8_t buf[64][64 + 16];
  const int tiles = transpose_tiles(p.cols[0], p.ld[0]);
  if ((int)blockIdx.x < tiles) {
    transpose_tile(p, 0, blockIdx.x, buf);
    return;
  }
  const int w = ((int)blockIdx.x - tiles) * 8 + (threadIdx.x >> 5);
  if (w < M * ((KB + 1) / 2))
    q8::quantize_block(a, q, scale, K, KB, ld, w, threadIdx.x & 31);
}

// Transpose tiles a block of ln_codes_kernel takes: 576 one-tile blocks
// (four 768 x 768 matrices) and ViT-B bs32's 788 row blocks made two waves
// of the card's 1056 resident blocks.
constexpr int TRANSPOSE_TILES = 4;

// Blocks a matrix of up to `tiles` tiles takes in ln_codes_kernel.
__host__ __device__ __forceinline__ int transpose_blocks(int tiles) {
  return (tiles + TRANSPOSE_TILES - 1) / TRANSPOSE_TILES;
}

// K10's and K11's first launch: blocks [0, count x per) transpose the
// weight codes (matrix b / per, its tiles TRANSPOSE_TILES (b % per) ..;
// `per` = transpose_blocks of the most tiles of a matrix), the rest take
// LN(x)'s codes a warp a row (q8::quantize_row<true>).
__global__ void __launch_bounds__(256)
ln_codes_kernel(const __grid_constant__ Transposes p, int count, int per,
                const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                const float* __restrict__ ln_bias, float eps,
                int8_t* __restrict__ q, float* __restrict__ scale, int M,
                int K) {
  __shared__ __align__(16) int8_t buf[64][64 + 16];
  if ((int)blockIdx.x < count * per) {
    const int z = blockIdx.x / per;
    const int tiles = transpose_tiles(p.cols[z], p.ld[z]);
    for (int i = 0; i < TRANSPOSE_TILES; ++i) {
      const int tile = (blockIdx.x % per) * TRANSPOSE_TILES + i;
      if (tile >= tiles) break;
      if (i > 0) __syncthreads();          // the last tile's reads are done
      transpose_tile(p, z, tile, buf);
    }
    return;
  }
  const int row = ((int)blockIdx.x - count * per) * 8 + (threadIdx.x >> 5);
  if (row < M)
    q8::quantize_row<true>(x, ln_scale, ln_bias, eps, q, scale, row, K,
                           threadIdx.x & 31);
}

}  // namespace q8g
}  // namespace sav
