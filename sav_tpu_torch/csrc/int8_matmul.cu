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
// Bound on the card: at ViT-B's FF shapes at serving bs32 (M = 6304, K =
// 768, N = 3072, and K = 3072, N = 768) the product is 29.7 G int8
// operations, 0.015 ms at 1979 TOPS, against ~51 MB of a, b and out, also
// ~0.015 ms at 3.35 TB/s: both limits meet.
//
// Design: two launches, neither of them mma.sync.
//  1. q8g::codes_kernel, the two memory-bound passes in one launch: the
//     weight codes [K, N] transposed into the workspace [N, ldk] (ldk = K
//     rounded up to 16 for TMA's row stride; s8 wgmma reads K-major B
//     only), and a's codes per (row, k-block) into [M, ldk] with the [M,
//     K / 256] scales, one warp a (row, two k-blocks)
//     (q8::quantize_block).
//     Made once and read back at one byte each, where the TPU kernel
//     quantises each [bm, bk] tile again for every column block it meets
//     (free on its VPU beside the MXU; here it would be 24 f32 divisions
//     an element at N = 3072). As two launches the transpose took 0.004
//     ms more at both FF shapes.
//  2. q8g BLOCK (q8_gemm_sm90.cuh): persistent 128 x 128 units on s8 wgmma
//     m64n128k32 fed by TMA; each consumer warpgroup runs a k-block's
//     products (two 128-deep ring slots) into an int32 accumulator, waits
//     on them and folds them into its f32 accumulator in k order with the
//     row's block scale; bf16(acc * b_scale) through a staging tile and
//     TMA stores. A ragged last k-block (K = 700) reads zeros past K from
//     the tensor maps' extent: nothing is padded but the transposed codes'
//     row stride.
#include "q8_gemm_sm90.cuh"

namespace {

bool bad_geometry(int m, int k, int n) {
  return m < 1 || k < 1 || n < 2 || n % 2;
}

int ld_of(int k) { return (k + 15) / 16 * 16; }

// The output's row stride: N rounded up to 8 (TMA's 16-byte row stride).
int ldo_of(int n) { return (n + 7) / 8 * 8; }

int kblocks(int k) { return (k + sav::q8g::KBLOCK - 1) / sav::q8g::KBLOCK; }

// The scratch of one call, 256-byte aligned regions in this order: the
// weight codes transposed [N, ldk], a's codes [M, ldk] and scales [M, KB].
// Mirrored by int8_matmul_plan.
struct Workspace {
  size_t bt, aq, as, total;
  Workspace(int m, int k, int n) {
    using sav::q8w::align256;
    const size_t ld = ld_of(k);
    bt = 0;
    aq = bt + align256((size_t)n * ld);
    as = aq + align256((size_t)m * ld);
    total = as + align256((size_t)m * kblocks(k) * 4);
  }
};

}  // namespace

// K15's launch plan at (M, K, N): out[0] row tiles (128 rows), [1] column
// tiles (128 columns), [2] units, [3] k-blocks, [4] ring slots a unit (two
// 128-deep a k-block), [5] ldk (the codes' row stride), [6] the output's
// row stride, [7] dynamic shared memory, [8] workspace bytes, [9..11] the
// offsets of the transposed codes, a's codes and a's scales. Returns 0, or
// cudaErrorInvalidValue for a geometry the kernel does not take. Mirrored
// by int8_matmul_plan in ops/int8_matmul_kernel.py.
extern "C" int sav_int8_matmul_plan(int m, int k, int n, long long* out) {
  using namespace sav::q8g;
  if (bad_geometry(m, k, n)) return (int)cudaErrorInvalidValue;
  out[0] = row_tiles(m);
  out[1] = col_tiles<128>(BLOCK, n, n);
  out[2] = out[0] * out[1];
  out[3] = kblocks(k);
  out[4] = stages_of(BLOCK, k, kblocks(k));
  out[5] = ld_of(k);
  out[6] = ldo_of(n);
  out[7] = Plan<BLOCK, 128>::SMEM;
  const Workspace ws(m, k, n);
  out[8] = (long long)ws.total;
  out[9] = (long long)ws.bt;
  out[10] = (long long)ws.aq;
  out[11] = (long long)ws.as;
  return 0;
}

// a [M, K] bf16; b [K, N] int8 (the weight codes per column), b_scale [N]
// f32; ws the workspace of sav_int8_matmul_plan's out[8] bytes; out [M, N]
// bf16 with rows out[6] (N rounded up to 8) elements apart. Any M and K, N
// even.
extern "C" int sav_int8_matmul(const void* a, const void* b,
                               const float* b_scale, void* ws, void* out,
                               int M, int K, int N, void* stream) {
  using namespace sav::q8g;
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_geometry(M, K, N)) return (int)cudaErrorInvalidValue;
  const Workspace lay(M, K, N);
  unsigned char* w = (unsigned char*)ws;
  int8_t* bt = (int8_t*)(w + lay.bt);
  int8_t* aq = (int8_t*)(w + lay.aq);
  float* as = (float*)(w + lay.as);
  const int ld = ld_of(K), kb = kblocks(K);

  Transposes tr = {};
  tr.in[0] = (const int8_t*)b;
  tr.out[0] = bt;
  tr.rows[0] = K;
  tr.cols[0] = N;
  tr.ld[0] = ld;
  codes_kernel<<<transpose_tiles(N, ld) + (M * ((kb + 1) / 2) + 7) / 8, 256,
                 0, st>>>(
      tr, (const sav::bf16*)a, aq, as, M, K, kb, ld);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  Args p = {};
  p.m = M;
  p.k = K;
  p.n = N;
  p.n_each = N;
  p.kb = kb;
  p.rs = as;
  p.cs[0] = p.cs[1] = p.cs[2] = b_scale;
  p.q_scale = 1.f;
  void* const outs[3] = {out, out, out};
  return launch<BLOCK, 128>(aq, ld, bt, ld, outs, ldo_of(N), p, st);
}

// ---- the quantiser's check (a card test's and chip_smoke.py's)

namespace {

// Block a: the row absmax of bf16 bits a (every positive finite one, and 0:
// the 1e-8 floor); each thread a share of the bf16 values v with |v| <= a.
// Counts the codes where q8::quantize_exact differs from the IEEE
// division's q8::quantize (counts[0]), and, as the check's own control,
// where the product with the reciprocal alone does (counts[1]).
__global__ void __launch_bounds__(256)
quantizer_check_kernel(unsigned long long* counts) {
  const float a = __uint_as_float((uint32_t)blockIdx.x << 16);
  const float s = sav::q8::row_scale(a), inv = __frcp_rn(s);
  unsigned int bad = 0, naive = 0;
  for (uint32_t bits = threadIdx.x; bits < 0x10000u; bits += blockDim.x) {
    const float v = __uint_as_float(bits << 16);
    if (!(fabsf(v) <= a)) continue;          // past the row's max, or NaN
    const int want = sav::q8::quantize(v, s);
    bad += sav::q8::quantize_exact(v, s, inv) != want;
    naive += (int)fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f)
             != want;
  }
  if (bad) atomicAdd(&counts[0], (unsigned long long)bad);
  if (naive) atomicAdd(&counts[1], (unsigned long long)naive);
}

}  // namespace

// Adds to counts[0] (device memory) the number of (bf16 value, bf16 row
// absmax) pairs, |value| <= absmax, whose q8::quantize_exact code differs
// from q8::quantize's, over every finite non-negative absmax (0x0000 -
// 0x7f7f), and to counts[1] those where rint(value * reciprocal) does.
extern "C" int sav_q8_quantizer_check(unsigned long long* counts,
                                      void* stream) {
  quantizer_check_kernel<<<0x7f80, 256, 0, (cudaStream_t)stream>>>(counts);
  return (int)cudaGetLastError();
}
