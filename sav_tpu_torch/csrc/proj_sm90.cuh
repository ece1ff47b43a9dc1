// The projections of the K1 and K5a ports (fused_attention.cu,
// th_attention.cu) on Hopper: their LayerNorm launch and one persistent,
// warp-specialised wgmma + TMA GEMM (mbarriers, descriptors and setmaxnreg
// from sm90.cuh) with two epilogues:
//
//  QKV  y @ [Wq | Wk | Wv] into three [M, n_each] bf16 outputs, q scaled
//       by q_scale on the f32 accumulator before its one rounding, as the
//       TPU kernels compute (y @ wq * sc).astype(bf16).
//  OUT  attn @ Wo, + resid in f32 before the one rounding when resid is
//       not null (the sublayer without its residual: CaiT's body, TNT's
//       outer sublayer).
//
// What bounds it: at ViT-B @224 bs192 the two products are 178.5 GFLOP
// over ~0.4 GB of operands and outputs, so the tensor cores: ~0.18 ms at
// the bf16 peak. The shape that reaches them on this card: a ring of TMA
// tiles in shared memory fed by one producer thread, two consumer
// warpgroups on wgmma, persistent blocks whose producer loads the next
// unit's tiles while the consumers store the last one's.
//
// Operands in the layouts they have: A [M, K] row-major is K-major (TMA
// boxes of 128 rows x 64 columns, the 128-byte swizzle); the weights [K, N]
// row-major are MN-major, read by the descriptor's transpose bit from boxes
// of 64 depth rows x 64 columns (sm90.cuh), so nothing is transposed or
// copied. Rows past M arrive as zeros from TMA's out-of-bounds fill and
// are never stored; nothing is padded. The same holds at widths and
// depths that are not whole tiles (multiples of 32 such as cait_xs's
// 288, K5a's): the last column tile and the last 64-deep step are ragged,
// counted by ceiling; the columns and depth past the edge arrive as TMA's
// zeros (the expected bytes stay whole boxes), their products add zero,
// and the stores (TMA's, clipped at the width) and the residual's loads
// stop at the edge.
//
// Block: 384 threads. A unit is a 128 x BN output tile (BN = 256, 192 or
// 128 from plan_bn, which never lets a tile straddle two weights); the
// producer (warpgroup 2's first thread) streams its 64-deep steps, A (16
// KB) and B (BN x 128 bytes), through a ring of 3 or 4 slots; consumer
// warpgroup c takes rows 64 c.. of the tile with one m64nBNk16 product a
// 16-deep step (A shared by the two, as in ff_bwd_sm90.cuh), BN / 2 f32
// accumulators a thread, and writes its 64 rows to a staging tile in
// shared memory that TMA stores while the next unit's products run (direct
// stores from registers cost ~40% of the GEMMs' time at ViT-B's widths).
// Units run column tiles fastest, so the rows of A a block reads are in L2.
#pragma once

#include "sm90.cuh"

namespace sav {

typedef __nv_bfloat16 bf16;

// One warp per row, y = LN(x) in bf16 with f32 statistics (the fast
// variance E[x^2] - mu^2), the TPU kernels' LayerNorm. The row is read
// once: lane l holds its 8-element chunks l, l + 32, ... (C of them) in
// registers between the statistics and the normalisation. D a multiple
// of 8, at most 256 C.
template <int C>
__global__ void __launch_bounds__(256)
layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, bf16* __restrict__ y, int M,
                 int D, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * D;
  uint4 u[C];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c >= D) continue;
    u[i] = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      s += f;
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float mu = s / D;
  const float rs = rsqrtf(fmaxf(ss / D - mu * mu, 0.f) + eps);
  bf16* yr = y + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c >= D) continue;
    bf16* e = reinterpret_cast<bf16*>(&u[i]);
    float sc[8], bi[8];
    *reinterpret_cast<float4*>(sc) = *reinterpret_cast<const float4*>(scale + c);
    *reinterpret_cast<float4*>(sc + 4) =
        *reinterpret_cast<const float4*>(scale + c + 4);
    *reinterpret_cast<float4*>(bi) = *reinterpret_cast<const float4*>(bias + c);
    *reinterpret_cast<float4*>(bi + 4) =
        *reinterpret_cast<const float4*>(bias + c + 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16((__bfloat162float(e[j]) - mu) * rs * sc[j]
                              + bi[j]);
    *reinterpret_cast<uint4*>(yr + c) = u[i];
  }
}

// The LayerNorm launch for D <= 2048 (8 chunks a lane).
inline cudaError_t layernorm(const void* x, const float* scale,
                             const float* bias, void* y, int M, int D,
                             float eps, cudaStream_t st) {
  const int grid = (M + 7) / 8, chunks = (D + 255) / 256;
  auto go = [&](auto kernel) {
    kernel<<<grid, 256, 0, st>>>((const bf16*)x, scale, bias, (bf16*)y, M,
                                 D, eps);
    return cudaGetLastError();
  };
  if (D % 8 || chunks > 8) return cudaErrorInvalidValue;
  switch (chunks) {
    case 1: return go(layernorm_kernel<1>);
    case 2: return go(layernorm_kernel<2>);
    case 3: return go(layernorm_kernel<3>);
    case 4: return go(layernorm_kernel<4>);
    case 5: return go(layernorm_kernel<5>);
    case 6: return go(layernorm_kernel<6>);
    case 7: return go(layernorm_kernel<7>);
    default: return go(layernorm_kernel<8>);
  }
}

namespace proj {

using namespace sm90;

constexpr int BM = 128, BK = 64;          // a unit's rows, a step's depth
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;
// 384 threads start at 168 registers; the producer gives back to 24 so
// that each consumer can take 240 (24 + 2 x 240 = 504 = 3 x 168).
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr uint32_t A_BYTES = BM * BK * 2;           // 16 KB
constexpr uint32_t BOX = 64 * 64 * 2;               // 8 KB: 64 x 64
constexpr int OVERHEAD = 48;              // plan_bn's per-unit cost, columns
constexpr int SMEM_LIMIT = 232448;

enum Mode { QKV = 0, OUT = 1 };

// Shared memory (bytes from a 1024-byte aligned base): the ring of STAGES
// slots (A, then B's BN / 64 boxes), each consumer warpgroup's staging
// tile (64 x BN as BN / 64 boxes), the mbarriers. The Python mirror is
// proj_plan in ops/fused_layer.py.
template <int BN>
struct Plan {
  static constexpr int STAGES = BN == 256 ? 3 : 4;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + BN * BK * 2;
  static constexpr uint32_t STG_BYTES = 64 * BN * 2;
  static constexpr int OFF_STG = STAGES * STAGE_BYTES;
  static constexpr int OFF_BAR = OFF_STG + 2 * STG_BYTES;
  static constexpr int SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;
};

__host__ __device__ inline int smem_of(int bn) {
  return bn == 256 ? Plan<256>::SMEM
       : bn == 192 ? Plan<192>::SMEM
       : bn == 128 ? Plan<128>::SMEM : 0;
}

// Column tiles of one weight: a ceiling, the last one ragged where bn
// does not divide n_each.
__host__ __device__ inline int tiles_of(int n_each, int bn) {
  return (n_each + bn - 1) / bn;
}

__host__ __device__ inline int units_of(int m, int n_each, int parts,
                                        int bn) {
  return (m + BM - 1) / BM * parts * tiles_of(n_each, bn);
}

// Whether a tile of 256, 192 or 128 columns divides n_each: multiples of
// 128, and 192, 576, ... of 192.
__host__ __device__ inline bool whole(int n_each) {
  return n_each % 128 == 0 || n_each % 192 == 0;
}

// The tile width of an M x (parts x n_each) product: of BN = 256, 192 and
// 128, those dividing n_each (a tile never straddles two weights), or all
// three with a ragged last tile where none divides it, the one whose
// estimated time is least: ceil(units / SMs) rounds of a unit costing BN +
// OVERHEAD columns' worth (its stores and the ring's refill beside its
// products). Ties go to the wider tile, which reads fewer operand bytes
// from L2 a product. Mirrored by proj_plan in ops/fused_layer.py.
__host__ __device__ inline int plan_bn(int m, int n_each, int parts,
                                       int sms) {
  const int slots = sms > 0 ? sms : 1;
  int best = 0;
  long long best_cost = 0;
  for (int bn = 256; bn >= 128; bn -= 64) {
    if (n_each % bn && whole(n_each)) continue;
    const long long rounds =
        (units_of(m, n_each, parts, bn) + slots - 1) / slots;
    const long long cost = rounds * (bn + OVERHEAD);
    if (best == 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

// Whether the output width n_each and the depth k are whole tiles: a tile
// of 256, 192 or 128 columns divides n_each and k is whole 64-deep steps.
// K1's guard (fused_attention.cu), whose attention kernel takes the same
// widths. The widths of every model the port runs but D = 192 (ceit_t,
// vit_ti, cait_xxs) and 288 (cait_xs) are multiples of 128; at D = 192
// the whole width is one 192-column tile and the depth three steps.
__host__ __device__ inline bool takes(int n_each, int k) {
  return k >= BK && k % BK == 0 && n_each > 0 && whole(n_each);
}

// Whether the GEMM takes n_each and k at all: multiples of 32 (the ragged
// last tile and step; K5a's guard, th_attention.cu). 32 keeps TMA's
// 16-byte row pitch and is the int8 kernels' rule too.
__host__ __device__ inline bool takes_ragged(int n_each, int k) {
  return k >= 32 && k % 32 == 0 && n_each >= 32 && n_each % 32 == 0;
}

// d += A B over one 16-deep step, 64 x N: A [64 x 16] K-major in shared
// memory (desc_k_major), B [16 x N] MN-major (the transpose bit; 64-column
// boxes 8 KB apart: desc_encode(tile, BOX, 1024)).
template <int N>
__device__ __forceinline__ void wgmma_kmn(float (&d)[N / 2], uint64_t a,
                                          uint64_t b);

template <>
__device__ __forceinline__ void wgmma_kmn<128>(float (&d)[64], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_kmn<192>(float (&d)[96], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %98, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_kmn<256>(float (&d)[128], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121,"
      "%122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

struct Args {
  int m, k, n_each, parts;
  const bf16* resid;    // OUT: + resid, or null
  float q_scale;        // QKV: part 0's scale
};

// The tensor maps: A in 128-row boxes; the weights of parts 0..2 and the
// outputs in 64 x 64 boxes (OUT uses part 0's).
struct Maps {
  CUtensorMap a, b[3], o[3];
};

// sm90::mbar_wait, then the warp reconverged (the .aligned instructions
// after it need the whole warp).
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

template <int MODE, int BN>
__global__ void __launch_bounds__(THREADS, 1)
proj_gemm_kernel(const __grid_constant__ Maps maps, Args args) {
  using P = Plan<BN>;
  constexpr int STAGES = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P::OFF_BAR);
  uint64_t* empty = full + STAGES;
  const int per = tiles_of(args.n_each, BN);  // tiles of one weight
  const int nt = args.parts * per;          // column tiles of a row tile
  const int units = (args.m + BM - 1) / BM * nt;
  const int nk = (args.k + BK - 1) / BK;    // the last step may be ragged
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
      const int row0 = (u / nt) * BM, ct = u % nt;
      const CUtensorMap* mb = &maps.b[ct / per];
      const int col0 = (ct % per) * BN;
      for (int k = 0; k < nk; ++k, ++step) {
        const int s = step % STAGES;
        mbar_wait(&empty[s], ((step / STAGES) & 1) ^ 1);
        unsigned char* st = base + s * P::STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], P::STAGE_BYTES);
        tma_load_3d(st, &maps.a, &full[s], k * BK, row0, 0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_3d(st + A_BYTES + c * BOX, mb, &full[s], col0 + 64 * c,
                      k * BK, 0);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = tid >> 7, wi = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool leader = (tid & 127) == 0;
  unsigned char* stg = base + P::OFF_STG + wg * P::STG_BYTES;
  int step = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int row0 = (u / nt) * BM + 64 * wg, ct = u % nt;  // this warpgroup's rows
    const int which = ct / per, col0 = (ct % per) * BN;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int k = 0; k < nk; ++k, ++step) {
      const int s = step % STAGES;
      wait(&full[s], (step / STAGES) & 1);
      const unsigned char* st = base + s * P::STAGE_BYTES;
      // A: rows 64 wg.. of the box (64 rows further, 8 KB); B: all BN
      // columns, 64-column boxes BOX apart
      const uint64_t da = desc_k_major(st + wg * (64 * 128));
      const uint64_t db = desc_encode(st + A_BYTES, BOX, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_kmn<BN>(acc, da + kk * K_STEP, db + kk * MN_STEP);
      wgmma_commit();
      // the previous step's products are done: its slot is free
      wgmma_wait<1>();
      if (k > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (nk > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % STAGES]);

    // epilogue: thread (wi, g, t) holds rows r = 16 wi + g (+ 8) of the
    // warpgroup's 64, columns 8 i + 2 t (+ 1) of the tile. They go to the
    // staging tile in TMA's swizzled layout (box i / 8; the 16-byte chunk
    // i % 8 of row r at chunk (i % 8) ^ (r % 8): the 8 rows of a store
    // fall in 8 different chunks, so no bank is hit twice), and one TMA
    // store a box writes the rows below M while the next unit's products
    // run.
    if (leader) bulk_wait_read();          // the last tile's store read it
    warpgroup_sync(1 + wg);
    const float sc = (MODE == QKV && which == 0) ? args.q_scale : 1.f;
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int r = 16 * wi + g + 8 * rh;
      const bool add = MODE == OUT && args.resid != nullptr
                       && row0 + r < args.m;
      const bf16* xr = add ? args.resid + (size_t)(row0 + r) * args.n_each
                                 + col0 + 2 * t
                           : nullptr;
      // half the row's pairs of resid loaded before any is used: one
      // memory latency a half row, not one a pair (a whole row's would
      // spill beside the 128 accumulators); none past the width (a ragged
      // last tile: n_each is a multiple of 32, so a pair is wholly in or
      // out)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        constexpr int NI = BN / 16;
        __nv_bfloat162 x2[NI];
        if (add) {
#pragma unroll
          for (int i = 0; i < NI; ++i)
            x2[i] = col0 + 8 * (NI * h + i) < args.n_each
                        ? *reinterpret_cast<const __nv_bfloat162*>(
                              xr + 8 * (NI * h + i))
                        : __float2bfloat162_rn(0.f);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int i = NI * h + j;
          float v0 = acc[4 * i + 2 * rh] * sc;
          float v1 = acc[4 * i + 2 * rh + 1] * sc;
          if (add) {
            v0 += __low2float(x2[j]);
            v1 += __high2float(x2[j]);
          }
          *reinterpret_cast<uint32_t*>(
              stg + (i >> 3) * BOX + r * 128 + (((i & 7) ^ (r & 7)) << 4)
              + 4 * t) = pack_bf16x2(v0, v1);
        }
      }
    }
    fence_proxy_async();                   // the tile is TMA's to store
    warpgroup_sync(1 + wg);
    if (leader && row0 < args.m) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        if (col0 + 64 * c < args.n_each)   // a box past a ragged edge: none
          tma_store_3d(&maps.o[which], stg + c * BOX, col0 + 64 * c, row0,
                       0);
      bulk_commit();
    }
  }
  if (leader) bulk_wait_all();
}

// The card's SM count, asked once a device (the same value for every
// library that shares this cache): the launches below are host work on
// every call, and serving's small calls are host-bound.
inline int sm_count(int dev) {
  static int cached[64] = {0};
  int sms = dev >= 0 && dev < 64 ? cached[dev] : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (dev >= 0 && dev < 64) cached[dev] = sms;
  }
  return sms;
}

// The attribute is set on every call: a static "already set" flag here
// would have vague linkage, one copy for every library of the process
// that includes this header, while each library's kernel needs its own.
template <int MODE, int BN>
cudaError_t launch(const Maps& maps, const Args& args, int sms,
                   cudaStream_t st) {
  static_assert(Plan<BN>::SMEM <= SMEM_LIMIT,
                "over the block's shared memory");
  const cudaError_t e = cudaFuncSetAttribute(
      proj_gemm_kernel<MODE, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Plan<BN>::SMEM);
  if (e != cudaSuccess) return e;
  const int units = units_of(args.m, args.n_each, args.parts, BN);
  proj_gemm_kernel<MODE, BN>
      <<<units < sms || sms <= 0 ? units : sms, THREADS, Plan<BN>::SMEM, st>>>(
          maps, args);
  return cudaGetLastError();
}

// C_p[M, n_each] = A[M, K] @ W_p[K, n_each] for the `parts` weights (QKV:
// 3, c0 scaled by q_scale; OUT: 1, + resid when not null). Needs
// takes_ragged(n_each, k); any M >= 1. Returns 0 or a cudaError_t.
template <int MODE>
int run(const void* a, const void* const (&w)[3], void* const (&c)[3],
        const void* resid, int m, int k, int n_each, int parts,
        float q_scale, cudaStream_t st) {
  if (m < 1 || !takes_ragged(n_each, k) || parts < 1 || parts > 3)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int sms = sm_count(dev);
  const int bn = plan_bn(m, n_each, parts, sms);
  Maps maps{};                              // the parts' maps only
  int err = band_map(&maps.a, a, 1, m, m, k, BM);
  for (int p = 0; p < parts && !err; ++p) {
    err = band_map(&maps.b[p], w[p], 1, k, k, n_each, BK);
    if (!err) err = band_map(&maps.o[p], c[p], 1, m, m, n_each, 64);
  }
  if (err) return err;
  const Args args{m, k, n_each, parts, (const bf16*)resid, q_scale};
  e = bn == 256 ? launch<MODE, 256>(maps, args, sms, st)
    : bn == 192 ? launch<MODE, 192>(maps, args, sms, st)
                : launch<MODE, 128>(maps, args, sms, st);
  return (int)e;
}

}  // namespace proj
}  // namespace sav
