// The pieces of the persistent, warp-specialised s8 wgmma + TMA GEMMs that
// the int8 FF forward (K12 and K13, int8_ff_sm90.cuh) and the SwitchBack dx
// backward (K14, int8_dx_sm90.cuh) share: the block's shape, the rings and
// their shared-memory plan, the staging tile's layouts, the fast quantiser,
// the row scales from per-tile absmax partials, the tensor maps of codes
// and the workspace of one call.
//
// Both run a row's quantisation over all F columns of an f32 value that
// does not fit on chip, so their first product runs twice over the same
// codes (int32 sums are exact, and the epilogue is the same instructions):
// ABSMAX writes each (row, 128-column tile)'s absmax partial,
// row_scale_kernel takes each row's max of them, CODES writes the codes.
// Then a second product takes those codes as its A operand.
#pragma once

#include "int8_gemm.cuh"
#include "sm90.cuh"

namespace sav {
namespace q8w {

using namespace sm90;
using q8::quantize;
using q8::quantize_by;
using q8::row_scale;

constexpr int BM = 128, BN = 128;           // a unit's tile
constexpr int MAX_STAGES = 5;                // ring slots a team, at most
constexpr int TEAM_WARPS = 8;
constexpr int THREADS = (2 * TEAM_WARPS + 4) * 32;   // + a producer warpgroup
// 640 threads start at 96 registers a thread; the producer warpgroup gives
// back to 24 so that the consumers can take 112, from the block's own
// registers (4 x 112 + 24 = 472 <= 5 x 96; an increase past them waits
// forever): without it the epilogues spill.
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 112;
constexpr uint32_t STG_BYTES = BM * BN * 2;          // bf16 staging tile

// A product's ring: the first product's (beside the staging tiles) five
// slots of 64 codes of depth (64-byte swizzle); the second's (no staging,
// kDeep) three of 128 (128-byte swizzle), fewer waits a product.
template <bool kDeep>
struct RingOf {
  static constexpr int BK = kDeep ? 128 : 64;
  static constexpr int STAGES = kDeep ? 3 : 5;
  static constexpr uint32_t A_BYTES = BM * BK;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + BN * BK;
};

// Shared memory (bytes from a 1024-byte aligned base): two rings, two
// staging tiles, the mbarriers (full[2][STAGES], empty[2][STAGES], the
// staging tiles' full (or free)[2], the product turns[2], the staging
// tiles' written[2]). Mirrored by int8_dx_plan and int8_ff_plan in
// ops/int8_ff.py.
struct Plan {
  static constexpr int OFF_STG = 2 * RingOf<false>::STAGES
                                 * RingOf<false>::STAGE_BYTES;
  static constexpr int OFF_BAR = OFF_STG + 2 * STG_BYTES;
  static constexpr int SMEM = OFF_BAR + (4 * MAX_STAGES + 6) * 8 + 1024;
  static_assert(2 * RingOf<true>::STAGES * RingOf<true>::STAGE_BYTES
                    <= OFF_BAR,
                "the second product's rings (no staging tiles) below the "
                "mbarriers");
};

__host__ __device__ __forceinline__ int col_tiles(int n) {
  return (n + BN - 1) / BN;
}

// The absmax partials of a row: one per 128-column tile of F.
__host__ __device__ __forceinline__ int parts(int hidden) {
  return col_tiles(hidden);
}

// A row's scale: row_scale of the max of the row's absmax partials (exact,
// and independent of their order).
__global__ void __launch_bounds__(256)
row_scale_kernel(const float* __restrict__ amax, int nparts,
                 float* __restrict__ scale, int m) {
  const int row = blockIdx.x * 256 + threadIdx.x;
  if (row >= m) return;
  float v = 0.f;
  for (int p = 0; p < nparts; ++p) v = fmaxf(v, amax[(size_t)row * nparts + p]);
  scale[row] = row_scale(v);
}

// sm90::mbar_wait, then the warp reconverged (the .aligned instructions
// after it need the whole warp).
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

// Byte offset of element (r, c) of the staging tile: bf16 as two boxes of
// 64 columns (rows of 128 bytes), int8 codes as one box of 128 columns,
// both with the 128-byte swizzle (16-byte chunk j of row r at j ^ (r % 8)).
__device__ __forceinline__ int stg_bf16(int r, int c) {
  return (c >> 6) * (BM * 128) + r * 128
         + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}
__device__ __forceinline__ int stg_code(int r, int c) {
  return r * 128 + (((c >> 4) ^ (r & 7)) << 4) + (c & 15);
}

// Blocks: one per SM, or one per pair of units if fewer.
inline int grid_for(int units) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int pairs = (units + 1) / 2;
  return pairs < sms || sms <= 0 ? pairs : sms;
}

// Tensor map of a [rows, width] int8 array for boxes of 128 rows x
// `box_codes` codes with the swizzle of that width (64: the products'
// operands, SWIZZLE_64B; 128: the staging tile's codes, SWIZZLE_128B);
// rows past `rows` and codes past `width` read as zeros. Returns 0 or a
// cudaError_t.
inline int codes_map(CUtensorMap* map, const void* base, int rows, int width,
                     int box_codes) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)width,
                                 (cuuint64_t)width * rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_codes, (cuuint32_t)BM, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        box_codes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                        : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// The 64 x 64 tiles that cover a [rows, cols] matrix, a ceiling at each
// side: the blocks of a codes transpose (K10's, K11's, K12's, K13's and
// K15's weights).
__host__ __device__ __forceinline__ int transpose_tiles(int rows, int cols) {
  return (rows + 63) / 64 * ((cols + 63) / 64);
}

// The scratch of one call, carved from one workspace in this order: the
// first product's A codes [M, D] and their row scales [M], the absmax
// partials [M, parts(F)], the hidden codes' row scales [M] and the hidden
// codes [M, F] (K14: g's codes and dh's; K12/K13: x's codes and those of
// gelu(hpre)). Mirrored by int8_dx_plan and int8_ff_plan.
struct Workspace {
  size_t aq, ascale, amax, hs, hq, total;
  Workspace(int m, int dim, int hidden) {
    size_t at = 0;
    auto take = [&](size_t bytes) {
      const size_t here = at;
      at += align256(bytes);
      return here;
    };
    aq = take((size_t)m * dim);
    ascale = take((size_t)m * 4);
    amax = take((size_t)m * parts(hidden) * 4);
    hs = take((size_t)m * 4);
    hq = take((size_t)m * hidden);
    total = at;
  }
};

}  // namespace q8w
}  // namespace sav
