// Pieces shared by the K8 port (mixer_token.cu) and the K16 port
// (ff_bwd.cu): both are the backward of LN -> Dense -> tanh-gelu -> Dense,
// K8 contracting over tokens and K16 over channels.
//
//  * gelu_t / gelu_bwd: the tanh-gelu and its derivative recomputed in f32
//    from the pre-activation (sav_tpu/ops/tnt_inner.py::_gelu_fwd_t,
//    ::_gelu_bwd_from_t; the same closed form as fused_layer.py:555-559).
//  * Fragment loads for mma.sync m16n8k16 from shared memory holding an
//    operand either as it is ([m][k] for A, [k][n] for B) or transposed
//    ([k][m] for A, [n][k] for B), so every product of the two backwards
//    reads W1, W2 and the activations in the layout they already have.
//  * gemm_kernel: a 128 x 128 x 32 tiled GEMM (3-stage cp.async ring, 8
//    warps of 64 x 32) over any of those layouts, whose contraction may run
//    over a chunk of batch items (C = sum_b A_b B_b, the weight gradients
//    summed over images): one output tile per block, the contraction in an
//    in-block loop, so no sum crosses blocks inside it. Where a launch
//    splits the contraction into chunks (blockIdx.z), each chunk writes its
//    own f32 partial and sum_partials adds them in a fixed order: no float
//    atomics, the same gradients on every run.
//  * Rows past M, columns past N and contraction rows past the end load as
//    zeros (cp.async with 0 source bytes) and are never stored.
#pragma once

#include "mma.cuh"

namespace sav {
namespace ff {

constexpr float GELU_C = 0.7978845608028654f;   // sqrt(2/pi)
constexpr float GELU_A = 0.044715f;

// t = tanh(C (h + A h^3)); gelu(h) = 0.5 h (1 + t)
__device__ __forceinline__ float gelu_t(float h) {
  return tanhf(GELU_C * (h + GELU_A * h * h * h));
}

__device__ __forceinline__ float gelu_bwd(float h, float t) {
  return 0.5f * (1.f + t)
         + 0.5f * h * (1.f - t * t) * GELU_C * (1.f + 3.f * GELU_A * h * h);
}

// A fragment (16 x 16 at m0, k0) of A stored [m][k] with row stride ld.
__device__ __forceinline__ void load_a(uint32_t* f, const bf16* s, int ld,
                                       int m0, int k0, int lane) {
  ldmatrix_x4(f, s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// A fragment of A stored transposed, as [k][m] with row stride ld.
__device__ __forceinline__ void load_a_t(uint32_t* f, const bf16* s, int ld,
                                         int m0, int k0, int lane) {
  ldmatrix_x4_trans(f, s + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0
                           + ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles (n0, n0 + 8) at depth k0, B stored [k][n]:
// b[0], b[1] for the first tile, b[2], b[3] for the second.
__device__ __forceinline__ void load_b(uint32_t* b, const bf16* s, int ld,
                                       int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld
                           + n0 + (lane >> 4) * 8);
}

// The same, B stored transposed, as [n][k].
__device__ __forceinline__ void load_b_t(uint32_t* b, const bf16* s, int ld,
                                         int k0, int n0, int lane) {
  ldmatrix_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0
                     + ((lane >> 3) & 1) * 8);
}

template <bool kTA>
__device__ __forceinline__ void load_a_any(uint32_t* f, const bf16* s, int ld,
                                           int m0, int k0, int lane) {
  if (kTA) load_a_t(f, s, ld, m0, k0, lane);
  else load_a(f, s, ld, m0, k0, lane);
}

template <bool kTB>
__device__ __forceinline__ void load_b_any(uint32_t* b, const bf16* s, int ld,
                                           int k0, int n0, int lane) {
  if (kTB) load_b_t(b, s, ld, k0, n0, lane);
  else load_b(b, s, ld, k0, n0, lane);
}

// One block's product of operands resident in shared memory: out[M, N] =
// A[M, K] B[K, N] with M, N, K multiples of 16. The 8 warps take the 16 x
// 16 output tiles in turn; epi(row, col, v0, v1) receives each accumulator
// pair (columns col and col + 1) in f32. Every thread calls epi only for its
// own elements, each element once.
template <bool kTA, bool kTB, typename Epi>
__device__ __forceinline__ void block_mma(const bf16* a, int lda, const bf16* b,
                                          int ldb, int M, int N, int K,
                                          Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nt = N / 16, tiles = (M / 16) * nt;
  for (int tile = warp; tile < tiles; tile += blockDim.x >> 5) {
    const int m0 = (tile / nt) * 16, n0 = (tile % nt) * 16;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t af[4], bfr[4];
      load_a_any<kTA>(af, a, lda, m0, k0, lane);
      load_b_any<kTB>(bfr, b, ldb, k0, n0, lane);
      mma_16816(acc[0], af, bfr[0], bfr[1]);
      mma_16816(acc[1], af, bfr[2], bfr[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      epi(m0 + g, col, acc[j][0], acc[j][1]);
      epi(m0 + g + 8, col, acc[j][2], acc[j][3]);
    }
  }
}

// ------------------------------------------------------ tiled global GEMM

constexpr int TM = 128, TN = 128, TK = 32, TSTAGES = 3;
// one stage of either operand, in either layout ([128][32+8] or [32][128+8])
constexpr int TILE_ELEMS = (TM * (TK + 8) > TK * (TM + 8)) ? TM * (TK + 8)
                                                           : TK * (TM + 8);
constexpr int TGEMM_SMEM = TSTAGES * 2 * TILE_ELEMS * 2;

enum FfEpi { kF32, kBf16, kGeluBwd };

struct GemmArgs {
  const bf16* A;      // [M][Kc] (or [Kc][M] transposed) per batch item
  const bf16* B;      // [Kc][N] (or [N][Kc] transposed) per batch item
  int M, N, Kc;       // Kc: contraction length per batch item
  int lda, ldb;       // row strides in elements
  long long sa, sb;   // batch-item strides in elements
  int nbatch;         // batch items in all
  int per_chunk;      // batch items summed by one blockIdx.z
  float* cf;          // kF32 out [z][M][ldc]
  bf16* cb;           // kBf16 out, kGeluBwd dh out [M][ldc]
  int ldc;
  long long sc;       // kF32: stride between chunk partials
  const bf16* hpre;   // kGeluBwd: pre-activation [M][ldc]
  bf16* h;            // kGeluBwd: gelu(hpre) out [M][ldc]
  float* colsum;      // kGeluBwd: f32 column sums of dh [gridDim.y][N]
};

// C = A B with kTA / kTB saying how A and B are stored. Needs Kc % 8 == 0
// (16-byte loads along a contraction row), M % 8 == 0 when A is stored
// transposed and N % 8 == 0 when B is stored as it is.
template <bool kTA, bool kTB, int kEpi>
__global__ void __launch_bounds__(256)
gemm_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sB = sA + TSTAGES * TILE_ELEMS;
  __shared__ float s_col[2][TN];

  constexpr int LDA = kTA ? TM + 8 : TK + 8;
  constexpr int LDB = kTB ? TK + 8 : TN + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps of 64 x 32
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int b_first = blockIdx.z * p.per_chunk;
  const int k_per = (p.Kc + TK - 1) / TK;
  const int k_tiles = k_per * p.per_chunk;

  auto load_stage = [&](int kt, int stage) {
    const int b = b_first + kt / k_per;
    const int k0 = (kt % k_per) * TK;
    const bool item = b < p.nbatch;
    const bf16* A = p.A + (item ? (long long)b * p.sa : 0);
    const bf16* B = p.B + (item ? (long long)b * p.sb : 0);
    bf16* a = sA + stage * TILE_ELEMS;
    bf16* bs = sB + stage * TILE_ELEMS;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * 256;
      if (kTA) {     // [TK][TM]: 32 rows of 16 chunks
        const int r = i >> 4, c = (i & 15) * 8;
        const bool in = item && k0 + r < p.Kc && m0 + c < p.M;
        cp_async_16(&a[r * LDA + c],
                    in ? A + (size_t)(k0 + r) * p.lda + m0 + c : p.A,
                    in ? 16 : 0);
      } else {       // [TM][TK]: 128 rows of 4 chunks
        const int r = i >> 2, c = (i & 3) * 8;
        const bool in = item && m0 + r < p.M && k0 + c < p.Kc;
        cp_async_16(&a[r * LDA + c],
                    in ? A + (size_t)(m0 + r) * p.lda + k0 + c : p.A,
                    in ? 16 : 0);
      }
      if (kTB) {     // [TN][TK]
        const int r = i >> 2, c = (i & 3) * 8;
        const bool in = item && n0 + r < p.N && k0 + c < p.Kc;
        cp_async_16(&bs[r * LDB + c],
                    in ? B + (size_t)(n0 + r) * p.ldb + k0 + c : p.B,
                    in ? 16 : 0);
      } else {       // [TK][TN]
        const int r = i >> 4, c = (i & 15) * 8;
        const bool in = item && k0 + r < p.Kc && n0 + c < p.N;
        cp_async_16(&bs[r * LDB + c],
                    in ? B + (size_t)(k0 + r) * p.ldb + n0 + c : p.B,
                    in ? 16 : 0);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<TSTAGES - 2>();
    __syncthreads();
    if (kt + TSTAGES - 1 < k_tiles)
      load_stage(kt + TSTAGES - 1, (kt + TSTAGES - 1) % TSTAGES);
    cp_async_commit();
    const bf16* a = sA + (kt % TSTAGES) * TILE_ELEMS;
    const bf16* bs = sB + (kt % TSTAGES) * TILE_ELEMS;
#pragma unroll
    for (int ks = 0; ks < TK / 16; ++ks) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        load_a_any<kTA>(af[mi], a, LDA, wm * 64 + mi * 16, ks * 16, lane);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        load_b_any<kTB>(bfr[q], bs, LDB, ks * 16, wn * 32 + q * 16, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_16816(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2],
                    bfr[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // each thread's column sums (kGeluBwd: db1 from the f32 dh)
  float csum[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) csum[ni][0] = csum[ni][1] = 0.f;

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (row >= p.M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= p.N) continue;
          const float v = acc[mi][ni][2 * half + e];
          const size_t off = (size_t)row * p.ldc + col + e;
          if (kEpi == kF32) {
            p.cf[(size_t)blockIdx.z * p.sc + off] = v;
          } else if (kEpi == kBf16) {
            p.cb[off] = __float2bfloat16(v);
          } else {
            const float hp = __bfloat162float(p.hpre[off]);
            const float th = gelu_t(hp);
            const float dh = v * gelu_bwd(hp, th);
            p.cb[off] = __float2bfloat16(dh);
            p.h[off] = __float2bfloat16(0.5f * hp * (1.f + th));
            csum[ni][e] += dh;
          }
        }
      }
    }
  }
  if (kEpi == kGeluBwd) {
    // fixed order: rows within the thread, then lanes of equal t (xor over
    // g), then the two warp rows of the block
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = csum[ni][e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (g == 0) s_col[wm][wn * 32 + ni * 8 + 2 * t + e] = s;
      }
    __syncthreads();
    if (tid < TN && n0 + tid < p.N)
      p.colsum[(size_t)blockIdx.y * p.N + n0 + tid] =
          s_col[0][tid] + s_col[1][tid];
  }
}

template <bool kTA, bool kTB, int kEpi>
cudaError_t gemm_launch(const GemmArgs& p, int chunks, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<kTA, kTB, kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TGEMM_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + TN - 1) / TN, (p.M + TM - 1) / TM, chunks);
  gemm_kernel<kTA, kTB, kEpi><<<grid, 256, TGEMM_SMEM, st>>>(p);
  return cudaGetLastError();
}

// out[n] = sum over p = 0 .. parts-1 of part[p * stride + n], in p order.
__global__ void __launch_bounds__(256)
sum_partials(const float* __restrict__ part, int parts, long long stride,
             int n, float* __restrict__ out) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int q = 0; q < parts; ++q) s += part[(size_t)q * stride + i];
  out[i] = s;
}

inline cudaError_t sum_launch(const float* part, int parts, long long stride,
                              int n, float* out, cudaStream_t st) {
  sum_partials<<<(n + 255) / 256, 256, 0, st>>>(part, parts, stride, n, out);
  return cudaGetLastError();
}

}  // namespace ff
}  // namespace sav
