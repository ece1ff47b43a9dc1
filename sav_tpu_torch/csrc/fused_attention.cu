// K1 port: the whole pre-LN attention sublayer forward.
//
// Replaces sav_tpu/ops/fused_layer.py::_fused_fwd_kernel (launcher
// _fused_fwd), both variants: inference (save_residuals=False; lse null)
// and training (save_residuals=True: the q, k, v and attn scratch below
// are kept by the caller as the backward's residuals, and the attention
// launch also writes the lse of each row and head):
//   out = x + (softmax_h(q_h k_h^T) v_h)_h @ Wo,
//   q = LN(x) Wq / sqrt(d), k = LN(x) Wk, v = LN(x) Wv,
// LN with f32 statistics (fast variance E[x^2] - mu^2), bf16 operands,
// f32 accumulation, rounded to bf16 where the TPU kernel rounds.
//
// Bound on the card: at ViT-B (D = 768, H = 12, d = 64) the four products
// are ~2*L*D*(4*D) + 4*L*L*D operations per image against ~4*L*D bytes of
// activations, so the sublayer is bound by tensor-core operations (about
// 34 us at B = 32, L = 197 at the bf16 peak). The two projection GEMMs
// carry 88% of them.
//
// Decomposition: four launches per call, all hand-written (mma.sync).
//  1. layernorm_kernel: one warp per row, y = LN(x) in bf16.
//  2. gemm_kernel<kQkv>: y @ [Wq | Wk | Wv], q scaled by 1/sqrt(d) in the
//     epilogue. Writes q, k, v [B*L, H*d] bf16.
//  3. attention_fwd_kernel (shared with K4): per (q tile, head, image).
//  4. gemm_kernel<kOut>: attn @ Wo with +x in the epilogue.
// The TPU kernel runs one program per image with x and all four weights
// resident in its VMEM. That does not carry over: one image's x at L = 197
// is 303 KB and each weight 1.18 MB, beyond a block's 227 KB of shared
// memory, and the out projection sums over heads, so a grid over heads
// would need a cross-block sum. Splitting at the GEMM boundaries gives each
// launch its natural grid and keeps every sum inside one block; the price
// is writing y, q, k, v and attn (5 x B*L*D bf16) through L2/HBM, ~48 MB
// at B = 32, L = 197, about 15 us at 3.35 TB/s, under the operation bound
// of the products. LN gets its own pass so that both GEMMs are plain bf16
// GEMMs whose tiles stream in with cp.async through a 3-stage ring: the
// operation bound is met only if the tensor cores never wait on loads.
#include "attention_core.cuh"

namespace sav {

constexpr int GM = 128;             // rows of A / out per block
constexpr int GN = 128;             // columns of out per block
constexpr int GK = 32;              // depth per pipeline stage
constexpr int STAGES = 3;
constexpr int GA_LD = GK + 8;       // padded rows: conflict-free ldmatrix
constexpr int GB_LD = GN + 8;
constexpr int GEMM_SMEM = STAGES * (GM * GA_LD + GK * GB_LD) * 2;

__global__ void __launch_bounds__(256)
layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, bf16* __restrict__ y, int M,
                 int D, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
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
  for (int c = lane * 8; c < D; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16((__bfloat162float(e[j]) - mu) * rs * scale[c + j]
                              + bias[c + j]);
    *reinterpret_cast<uint4*>(yr + c) = u;
  }
}

enum Epilogue { kQkv, kOut };

// C[M, n_each] = A[M, K] @ W[K, n_each] for up to three (W, C) pairs laid
// side by side along the grid's x axis (the q/k/v projections).
// kQkv: pair 0 is scaled by q_scale. kOut: C = resid + A @ W (pair 0).
// Needs K % 32 == 0 and n_each % 128 == 0; rows past M are zero-filled on
// load and never stored.
template <Epilogue kEpi>
__global__ void __launch_bounds__(256)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ w0,
            const bf16* __restrict__ w1, const bf16* __restrict__ w2,
            bf16* __restrict__ c0, bf16* __restrict__ c1,
            bf16* __restrict__ c2, const bf16* __restrict__ resid, int M,
            int K, int n_each, float q_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sB = sA + STAGES * GM * GA_LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * GM;
  const int which = blockIdx.x * GN / n_each;
  const int n0 = blockIdx.x * GN - which * n_each;
  const bf16* W = which == 0 ? w0 : (which == 1 ? w1 : w2);
  bf16* C = which == 0 ? c0 : (which == 1 ? c1 : c2);
  const float out_scale = (kEpi == kQkv && which == 0) ? q_scale : 1.f;
  const int k_tiles = K / GK;

  // each thread moves 2 x 16 B of the A tile and 2 x 16 B of the B tile
  auto load_stage = [&](int kt, int stage) {
    const int k0 = kt * GK;
    bf16* a = sA + stage * GM * GA_LD;
    bf16* b = sB + stage * GK * GB_LD;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * 256;
      const int r = i >> 2, c = (i & 3) * 8;
      const bool in = m0 + r < M;
      cp_async_16(&a[r * GA_LD + c],
                  A + (size_t)(in ? m0 + r : 0) * K + k0 + c, in ? 16 : 0);
      const int kr = i >> 4, nc = (i & 15) * 8;
      cp_async_16(&b[kr * GB_LD + nc],
                  W + (size_t)(k0 + kr) * n_each + n0 + nc, 16);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();        // tile kt has landed
    __syncthreads();                    // ... for all; tile kt-1 is consumed
    if (kt + STAGES - 1 < k_tiles)
      load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const bf16* a = sA + (kt % STAGES) * GM * GA_LD;
    const bf16* b = sB + (kt % STAGES) * GK * GB_LD;
#pragma unroll
    for (int ks = 0; ks < GK / 16; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], &a[(wm * 64 + mi * 16 + (lane & 15)) * GA_LD
                               + ks * 16 + (lane >> 4) * 8]);
      uint32_t bfr[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        const int kr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(r, &b[kr * GB_LD + wn * 32 + p * 16 + (lane >> 4) * 8]);
        bfr[2 * p][0] = r[0];
        bfr[2 * p][1] = r[1];
        bfr[2 * p + 1][0] = r[2];
        bfr[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_16816(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (row >= M) continue;
        float v0 = acc[mi][ni][2 * half] * out_scale;
        float v1 = acc[mi][ni][2 * half + 1] * out_scale;
        const size_t off = (size_t)row * n_each + col;
        if (kEpi == kOut) {
          const __nv_bfloat162 x2 =
              *reinterpret_cast<const __nv_bfloat162*>(resid + off);
          v0 += __low2float(x2);
          v1 += __high2float(x2);
        }
        *reinterpret_cast<uint32_t*>(C + off) = pack_bf16(v0, v1);
      }
    }
  }
}

}  // namespace sav

// x [B, L, D]; ln_scale/ln_bias [D] f32; wq/wk/wv [D, H*64], wo [H*64, D];
// y [B*L, D] and qs/ks/vs/attn [B*L, H*64] scratch; out [B, L, D]; lse
// [B, H, L] f32 or null (inference). All bf16 unless noted. Needs D % 128 == 0 and H*64 % 128 == 0 (whole GEMM
// tiles along N and K).
extern "C" int sav_fused_attention_fwd(
    const void* x, const float* ln_scale, const float* ln_bias,
    const void* wq, const void* wk, const void* wv, const void* wo, void* y,
    void* qs, void* ks, void* vs, void* attn, void* out, float* lse,
    int batch, int seq,
    int dim, int heads, float eps, float q_scale, void* stream) {
  using namespace sav;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = batch * seq, hd = heads * ATT_D;
  const int m_tiles = (M + GM - 1) / GM;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<kQkv>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_kernel<kOut>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GEMM_SMEM);
  if (err != cudaSuccess) return (int)err;

  layernorm_kernel<<<(M + 7) / 8, 256, 0, st>>>(
      (const bf16*)x, ln_scale, ln_bias, (bf16*)y, M, dim, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gemm_kernel<kQkv><<<dim3(3 * hd / GN, m_tiles), 256, GEMM_SMEM, st>>>(
      (const bf16*)y, (const bf16*)wq, (const bf16*)wk, (const bf16*)wv,
      (bf16*)qs, (bf16*)ks, (bf16*)vs, nullptr, M, dim, hd, q_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attention_fwd_kernel<<<dim3((seq + ATT_BQ - 1) / ATT_BQ, heads, batch), 128,
                         0, st>>>((const bf16*)qs, (const bf16*)ks,
                                  (const bf16*)vs, (bf16*)attn, lse, seq,
                                  seq, seq, heads, hd, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gemm_kernel<kOut><<<dim3(dim / GN, m_tiles), 256, GEMM_SMEM, st>>>(
      (const bf16*)attn, (const bf16*)wo, (const bf16*)wo, (const bf16*)wo,
      (bf16*)out, (bf16*)out, (bf16*)out, (const bf16*)x, M, hd, dim, 1.f);
  return (int)cudaGetLastError();
}
