// K15 port: a @ deq(b) with the activations quantised per (row, 256-wide
// k-block).
//
// Replaces sav_tpu/ops/int8_matmul_kernel.py::_kernel (launcher
// int8_matmul_fused_raw): out[M, N] = (sum over k-blocks kb, in k order, of
// f32(int32 part_kb) * a_scale[row, kb]) * b_scale[col], rounded to bf16,
// where part_kb is the int32 product of the block's activation codes with
// the weight codes. The weights come quantised per column (outside, per
// call, as the JAX package quantises them in XLA); the block size is part
// of the function, so BLOCK_K = 256 stays, and the k-blocks are summed in
// order with no split along K.
//
// Bound on the card: at ViT-B's FF shapes (M = 6304, K = 768, N = 3072)
// the product is 29.7 G int8 operations, 0.015 ms at 1979 TOPS, against
// 51 MB of a, b and out, also ~0.015 ms at 3.35 TB/s: both limits meet.
//
// Decomposition: two launches.
//  1. quantize_blocks_kernel: a's codes per (row, k-block) into a [M, Kp]
//     int8 scratch and the [M, Kp / 256] scales (one warp per row).
//  2. gemm_s8_kernel<kBlock>: 128 x 128 output tiles, int32 mma.sync over
//     64-byte stages; after every fourth stage (one k-block) each thread
//     folds its int32 sums into its f32 accumulator with the row's block
//     scale and restarts them at 0.
// The TPU kernel quantises each [bm, bk] tile again for every column block
// it meets (24 times at N = 3072), which is free on its VPU beside the
// MXU. Here the codes are made once and read back at one byte each (5 MB
// at ViT-B's shape, ~3 us), instead of 24 f32 divisions per element.
#include "int8_gemm.cuh"

// a [M, K] bf16; bt [N, Kp] int8 (the weight codes transposed, zero rows
// past K), b_scale [N] f32; aq [M, Kp] int8 and a_scale [M, Kp / 256] f32
// scratch; out [M, N] bf16. Kp = ceil(K / 256) * 256; N % 2 == 0.
extern "C" int sav_int8_matmul(const void* a, const void* bt,
                               const float* b_scale, void* aq, float* a_scale,
                               void* out, int M, int K, int N, void* stream) {
  using namespace sav;
  using namespace sav::q8;
  cudaStream_t st = (cudaStream_t)stream;
  const int kb = (K + QBLOCK - 1) / QBLOCK;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_s8_kernel<kBlock>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GEMM_S8_SMEM);
  if (err != cudaSuccess) return (int)err;
  quantize_blocks_kernel<<<(M + 7) / 8, 256, 0, st>>>(
      (const bf16*)a, (int8_t*)aq, a_scale, M, K, kb);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  GemmS8Args p = {};
  p.a = (const int8_t*)aq;
  p.bt[0] = p.bt[1] = p.bt[2] = (const int8_t*)bt;
  p.row_scale = a_scale;
  p.col_scale[0] = p.col_scale[1] = p.col_scale[2] = b_scale;
  p.out[0] = p.out[1] = p.out[2] = (bf16*)out;
  p.resid = nullptr;
  p.M = M;
  p.n_each = N;
  p.K = kb * QBLOCK;
  p.q_scale = 1.f;
  gemm_s8_kernel<kBlock><<<dim3((N + TN - 1) / TN, (M + TM - 1) / TM), 256,
                           GEMM_S8_SMEM, st>>>(p);
  return (int)cudaGetLastError();
}
