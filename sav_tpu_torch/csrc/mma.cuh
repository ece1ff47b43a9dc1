// Warp-level bf16 tensor-core helpers shared by the port's kernels.
//
// Every product goes through mma.sync.m16n8k16 (bf16 in, f32 accumulate).
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A 16x16 row-major: a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                      a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B 16x8  (B[k][n]): b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C 16x8  f32:       c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// A C fragment pair of two adjacent n8 tiles, rounded to bf16, is exactly
// the A fragment of the next product over those 16 columns (used for P·V).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sav {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed on the way in. Lane l gives the row
// address of matrix l / 8, row l % 8; each row is 16 contiguous bytes.
// With matrix rows = k and columns = n of a row-major B[k][n] tile, the
// registers come back as the B fragments b0/b1 of mma_16816.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row_addr) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row_addr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The same four 8x8 matrices without the transpose: with lane l giving
// row (l % 16), column block (l / 16) * 8 of a row-major 16x16 A tile, the
// registers come back as the A fragment a0..a3 of mma_16816.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row_addr) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row_addr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 fills zeros.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int src_bytes) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace sav
