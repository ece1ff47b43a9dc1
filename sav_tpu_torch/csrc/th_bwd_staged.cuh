// K5b and K6b at H = 16 (cait_m): the talking-heads backward staged
// through device memory. th_bwd.cu's header gives the function; this file
// computes the same one in three kinds of launch.
//
// Why not th_bwd.cu's kernels: each of its modes keeps two resident bands
// of 64 rows x all heads in shared memory (q and do, or k and v). At H = 16
// a band is 64 x 768 bf16 = 96 KB, so the two alone take 192 of a block's
// 227 KB and leave no room for the streamed tiles beside them (the H = 8
// plans at H = 16 come to 441-443 KB). The mix warpgroup would also hold s
// and da of 16 heads (128 registers a thread at 8-key halves) beside a [16,
// 16] dM sum (256), and the accumulate warpgroup 16 x 24 outputs (384).
// Splitting the heads over a two-CTA cluster would need the pre-mix, the
// post-mix and the ds mix swapped as partials through distributed shared
// memory three times a tile. So at H = 16 the coupling of the heads goes
// through device memory instead (L2 holds much of it at cait_m @224):
//  1. products_kernel: per (image, head, 64 queries, 64 keys) s = q k^T
//     and da = do v^T on wgmma m64n64k16 from one TMA box of each band at
//     column 48h, f32 out to S and DA [B, H, L, L];
//  2. mix_kernel: a block of 256 threads takes MIX_ROWS query rows of one
//     image, a thread a key: pn, dpn and delta (a fixed-order block sum
//     over the row's keys), then dst, ds and pt, rounded to bf16 into DS
//     and PT [B, H, L, LP]; the [16, 16] dM sums come from each position's
//     s, dst, da and pn staged in shared memory and summed by the thread
//     that owns the entry (256 threads, 256 entries), one partial of each
//     a block, summed by the wrapper in a fixed order (no float atomics);
//  3. gemm_kernel: per (image, head, 64 rows) one head's product over the
//     length, wgmma m64n48k16 with A a 64 x 64 box of DS or PT (K-major for
//     dq = ds k, MN-major for dk = ds^T q and dv = pt^T do) and B the
//     band's box at column 48h read MN-major, two ring slots.
// The mixes run in f32 with the weights in the constant bank, one chain of
// 16 FMAs an output as in th_bwd.cu; exp is ex2.approx against M_pre log2
// e and lse log2 e. Rows and keys past L read zeros by TMA and are never
// written; the mix skips keys past L. Workspace (sav_th_bwd_staged_plan):
// S and DA f32 [B, H, L, L], DS and PT bf16 [B, H, L, LP] (LP = L rounded
// up to 8, so rows are 16-byte aligned for TMA), 256-byte aligned.
#pragma once

#include "th_sm90.cuh"

namespace sav {
namespace ths {

using namespace sm90;
using thb::TD;
using thb::exp2_approx;
using thb::kLog2e;
using thb::m_post;
using thb::m_pre;
using thb::m_pre2;
using thb::wait;

constexpr int H = 16;                     // the heads this path takes
constexpr int TILE = 64;                  // rows, keys and depth of a box
constexpr int BOX = TILE * TILE * 2;      // bytes of one bf16 box
constexpr int MIX_THREADS = 256;          // keys a pass of the mix, = H * H
constexpr int MIX_ROWS = 4;               // query rows a mix block
constexpr int SLOT = 4 * H + 1;           // floats a staged position (odd)
static_assert(MIX_THREADS == H * H, "a thread per dM entry");

constexpr int PRODUCTS_SMEM = 4 * BOX + 8 + 1024;
constexpr int MIX_SMEM = (MIX_THREADS * SLOT + 8 * H + 2 * H) * 4;
constexpr int GEMM_SMEM = 2 * 2 * BOX + 2 * 8 + 1024;

inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// The workspace's regions (bytes from its start) at (B, L).
struct Layout {
  int lp;
  size_t s, da, ds, pt, total;
  Layout(int batch, int L) {
    lp = (L + 7) / 8 * 8;
    const size_t f32 = (size_t)batch * H * L * L * 4;
    const size_t b16 = (size_t)batch * H * L * lp * 2;
    s = 0;
    da = align256(f32);
    ds = da + align256(f32);
    pt = ds + align256(b16);
    total = pt + align256(b16);
  }
};

__host__ __device__ inline int tiles_of(int L) {
  return (L + TILE - 1) / TILE;
}
inline int mix_blocks(int batch, int L) {
  return batch * ((L + MIX_ROWS - 1) / MIX_ROWS);
}

// d (+)= A B over one 16-deep step, 64 x 48, both in shared memory: B
// MN-major (a band's box at column 48h), A K-major (TA = 0) or MN-major
// (TA = 1, 16 rows of the depth axis x 64 columns of M).
template <int TA>
__device__ __forceinline__ void wgmma_ss_n48(float (&d)[24], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %26, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, "
      "%27, 1;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA));
}

// 1. s and da of one (image, head, query tile, key tile): qmap, kmap, vmap,
// omap map q, k, v, do in 64-row boxes; S, DA [B, H, L, L] f32.
__global__ void __launch_bounds__(128)
products_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap omap,
                float* __restrict__ S, float* __restrict__ DA, int L) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(base);
  bf16* sk = sq + TILE * TILE;
  bf16* so = sk + TILE * TILE;
  bf16* sv = so + TILE * TILE;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + 4 * BOX);
  const int nt = tiles_of(L), unit = blockIdx.x;
  const int kt = unit % nt, qt = unit / nt % nt, bh = unit / (nt * nt);
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, 4 * BOX);
    tma_load_3d(sq, &qmap, bar, TD * h, qt * TILE, b);
    tma_load_3d(sk, &kmap, bar, TD * h, kt * TILE, b);
    tma_load_3d(so, &omap, bar, TD * h, qt * TILE, b);
    tma_load_3d(sv, &vmap, bar, TD * h, kt * TILE, b);
  }
  wait(bar, 0);
  float s[32], da[32];
  const uint64_t dq = desc_k_major(sq), dk = desc_k_major(sk);
  const uint64_t d_o = desc_k_major(so), dv = desc_k_major(sv);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {          // head width 48: 3 steps
    wgmma_ss_k(s, dq + kk * K_STEP, dk + kk * K_STEP, kk);
    wgmma_ss_k(da, d_o + kk * K_STEP, dv + kk * K_STEP, kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(da);
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = qt * TILE + 16 * w + g + 8 * rh;
    if (row >= L) continue;
    const size_t at = ((size_t)bh * L + row) * L;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = kt * TILE + 8 * i + 2 * t + j;
        if (col < L) {
          S[at + col] = s[4 * i + 2 * rh + j];
          DA[at + col] = da[4 * i + 2 * rh + j];
        }
      }
  }
}

// pn of every head at one position (s in, pn out) and dpn in place of da;
// l2 the row's lse log2 e.
__device__ __forceinline__ void pn_dpn(const float (&s)[H], float (&pn)[H],
                                       float (&da)[H], const float* l2) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    float a = -l2[i];
#pragma unroll
    for (int j = 0; j < H; ++j) a = fmaf(m_pre2<H>(j, i), s[j], a);
    pn[i] = exp2_approx(a);
  }
  float x[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < H; ++i) a = fmaf(m_post<H>(j, i), da[i], a);
    x[j] = a;
  }
#pragma unroll
  for (int j = 0; j < H; ++j) da[j] = x[j];
}

// 2. the mix of MIX_ROWS query rows of one image: lse [B, H, L]; DS, PT
// [B, H, L, lp] bf16 out; dm [2][H H][mix_blocks]: the block's partial of
// dM_post, then of dM_pre.
__global__ void __launch_bounds__(MIX_THREADS)
mix_kernel(const float* __restrict__ S, const float* __restrict__ DA,
           const float* __restrict__ lse, bf16* __restrict__ DS,
           bf16* __restrict__ PT, float* __restrict__ dm, int L, int lp) {
  extern __shared__ float mix_smem[];
  float* stage = mix_smem;                  // [MIX_THREADS][SLOT]
  float* red = stage + MIX_THREADS * SLOT;  // [8 warps][H]
  float* l2 = red + 8 * H;                  // the row's lse log2 e
  float* delta = l2 + H;                    // the row's delta
  const int nrb = (L + MIX_ROWS - 1) / MIX_ROWS;
  const int b = blockIdx.x / nrb, q0 = blockIdx.x % nrb * MIX_ROWS;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int ej = tid / H, ei = tid % H;     // the dM entry this thread sums
  const size_t plane = (size_t)L * L, dplane = (size_t)L * lp;
  float dm_post = 0.f, dm_pre = 0.f;
  for (int r = 0; r < MIX_ROWS && q0 + r < L; ++r) {
    const int q = q0 + r;
    const size_t row = ((size_t)b * H * L + q) * L;     // head 0's row
    const size_t drow = ((size_t)b * H * L + q) * lp;
    if (tid < H) l2[tid] = lse[((size_t)b * H + tid) * L + q] * kLog2e;
    __syncthreads();
    // delta_j = sum over the keys of dpn_j pn_j
    float dl[H];
#pragma unroll
    for (int j = 0; j < H; ++j) dl[j] = 0.f;
    for (int k = tid; k < L; k += MIX_THREADS) {
      float s[H], da[H], pn[H];
#pragma unroll
      for (int j = 0; j < H; ++j) {
        s[j] = S[row + j * plane + k];
        da[j] = DA[row + j * plane + k];
      }
      pn_dpn(s, pn, da, l2);
#pragma unroll
      for (int j = 0; j < H; ++j) dl[j] = fmaf(da[j], pn[j], dl[j]);
    }
#pragma unroll
    for (int j = 0; j < H; ++j) {
      float v = dl[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[w * H + j] = v;
    }
    __syncthreads();
    if (tid < H) {
      float v = 0.f;
      for (int ww = 0; ww < MIX_THREADS / 32; ++ww) v += red[ww * H + tid];
      delta[tid] = v;
    }
    __syncthreads();
    // dst, ds -> DS, pt -> PT; s, dst, da, pn staged for the dM sums
    for (int k0 = 0; k0 < L; k0 += MIX_THREADS) {
      const int k = k0 + tid;
      float* slot = stage + tid * SLOT;
      if (k < L) {
        float s[H], da[H], pn[H], d0[H];
#pragma unroll
        for (int j = 0; j < H; ++j) {
          s[j] = S[row + j * plane + k];
          da[j] = DA[row + j * plane + k];
          d0[j] = da[j];
        }
        pn_dpn(s, pn, da, l2);              // dpn in da
#pragma unroll
        for (int i = 0; i < H; ++i) da[i] = pn[i] * (da[i] - delta[i]);
#pragma unroll
        for (int j = 0; j < H; ++j) {
          float a = 0.f, c = 0.f;
#pragma unroll
          for (int i = 0; i < H; ++i) {
            a = fmaf(m_pre<H>(j, i), da[i], a);     // ds_j
            c = fmaf(m_post<H>(i, j), pn[i], c);    // pt_j
          }
          DS[drow + j * dplane + k] = __float2bfloat16(a);
          PT[drow + j * dplane + k] = __float2bfloat16(c);
        }
#pragma unroll
        for (int j = 0; j < H; ++j) {
          slot[j] = s[j];
          slot[H + j] = da[j];              // dst
          slot[2 * H + j] = d0[j];          // da
          slot[3 * H + j] = pn[j];
        }
      }
      __syncthreads();
      const int n = min(MIX_THREADS, L - k0);
      for (int p = 0; p < n; ++p) {
        const float* sl = stage + p * SLOT;
        dm_pre = fmaf(sl[H + ei], sl[ej], dm_pre);           // dst_i s_j
        dm_post = fmaf(sl[2 * H + ei], sl[3 * H + ej], dm_post);  // da_i pn_j
      }
      __syncthreads();
    }
  }
  const size_t np = gridDim.x;
  dm[(size_t)tid * np + blockIdx.x] = dm_post;
  dm[((size_t)H * H + tid) * np + blockIdx.x] = dm_pre;
}

// Ring slot ks & 1 <- depth step ks of the GEMM's A and B boxes.
template <int TA>
__device__ __forceinline__ void gemm_load(const CUtensorMap* amap,
                                          const CUtensorMap* bmap, bf16* sa,
                                          bf16* sb, uint64_t* full, int ks,
                                          int rt, int bh, int h) {
  const int st = ks & 1, k0 = ks * TILE;
  mbar_arrive_expect_tx(&full[st], 2 * BOX);
  if (TA)
    tma_load_3d(sa + st * TILE * TILE, amap, &full[st], rt * TILE, k0, bh);
  else
    tma_load_3d(sa + st * TILE * TILE, amap, &full[st], k0, rt * TILE, bh);
  tma_load_3d(sb + st * TILE * TILE, bmap, &full[st], TD * h, k0, bh / H);
}

// 3. out rows of one (image, head, 64-row tile) = A B over the length: A
// from amap (DS or PT as [B H, L, L] in 64 x 64 boxes; TA = 0: rows of the
// tile x depth, TA = 1: depth x rows), B from bmap (a band in 64-row boxes
// at column 48h); out [B, L, H*48] bf16, rows < L.
template <int TA>
__global__ void __launch_bounds__(128)
gemm_kernel(const __grid_constant__ CUtensorMap amap,
            const __grid_constant__ CUtensorMap bmap, bf16* __restrict__ out,
            int L) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* sa = reinterpret_cast<bf16*>(base);             // 2 slots
  bf16* sb = reinterpret_cast<bf16*>(base + 2 * BOX);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + 4 * BOX);
  const int nt = tiles_of(L), rt = blockIdx.x % nt, bh = blockIdx.x / nt;
  const int b = bh / H, h = bh % H, tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    gemm_load<TA>(&amap, &bmap, sa, sb, full, 0, rt, bh, h);
    if (nt > 1) gemm_load<TA>(&amap, &bmap, sa, sb, full, 1, rt, bh, h);
  }
  float acc[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) acc[i] = 0.f;
  for (int ks = 0; ks < nt; ++ks) {
    const int st = ks & 1;
    wait(&full[st], (ks >> 1) & 1);
    const uint64_t da_ = TA ? desc_mn_major(sa + st * TILE * TILE)
                            : desc_k_major(sa + st * TILE * TILE);
    const uint64_t db = desc_mn_major(sb + st * TILE * TILE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n48<TA>(acc, da_ + kk * (TA ? MN_STEP : K_STEP),
                       db + kk * MN_STEP, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    warpgroup_sync(1);                      // every thread's reads are done
    if (tid == 0 && ks + 2 < nt)
      gemm_load<TA>(&amap, &bmap, sa, sb, full, ks + 2, rt, bh, h);
  }
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = rt * TILE + 16 * w + g + 8 * rh;
    if (row >= L) continue;
    bf16* dst = out + ((size_t)b * L + row) * (H * TD) + TD * h + 2 * t;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      *reinterpret_cast<uint32_t*>(dst + 8 * i) =
          pack_bf16x2(acc[4 * i + 2 * rh], acc[4 * i + 2 * rh + 1]);
  }
}

// Tensor map of DS or PT: [B H, L, L] bf16, rows lp elements apart, 64 x
// 64 boxes with the 128-byte swizzle; keys and rows past L read zeros.
inline int staged_map(CUtensorMap* map, const void* base, int bh, int L,
                      int lp) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)L, (cuuint64_t)L, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)lp * 2,
                                 (cuuint64_t)lp * 2 * L};
  const cuuint32_t box[3] = {TILE, TILE, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The five launches. mix [3, H, H] f32 in device memory (into c_mix on the
// stream); ws the workspace of Layout(batch, L).total bytes; dm [2, H H,
// mix_blocks] f32 partials.
inline int run(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* mix, void* ws, float* dm,
               void* dq, void* dk, void* dv, int batch, int L,
               cudaStream_t st) {
  cudaError_t e = cudaMemcpyToSymbolAsync(thb::c_mix, mix,
                                          3 * H * H * sizeof(float), 0,
                                          cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  const Layout lay(batch, L);
  unsigned char* w = (unsigned char*)ws;
  float* S = (float*)(w + lay.s);
  float* DA = (float*)(w + lay.da);
  bf16* DS = (bf16*)(w + lay.ds);
  bf16* PT = (bf16*)(w + lay.pt);
  const int width = H * TD;
  CUtensorMap bands[4], ds_map, pt_map;     // q, k, v, do
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const int err = band_map(&bands[i], ptrs[i], batch, L, L, width, TILE);
    if (err) return err;
  }
  int err = staged_map(&ds_map, DS, batch * H, L, lay.lp);
  if (!err) err = staged_map(&pt_map, PT, batch * H, L, lay.lp);
  if (err) return err;
  const int nt = tiles_of(L);
  e = cudaFuncSetAttribute(products_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           PRODUCTS_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(mix_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MIX_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gemm_kernel<0>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GEMM_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gemm_kernel<1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GEMM_SMEM);
  if (e != cudaSuccess) return (int)e;
  products_kernel<<<batch * H * nt * nt, 128, PRODUCTS_SMEM, st>>>(
      bands[0], bands[1], bands[2], bands[3], S, DA, L);
  mix_kernel<<<mix_blocks(batch, L), MIX_THREADS, MIX_SMEM, st>>>(
      S, DA, lse, DS, PT, dm, L, lay.lp);
  const int grid = batch * H * nt;
  gemm_kernel<0><<<grid, 128, GEMM_SMEM, st>>>(ds_map, bands[1], (bf16*)dq,
                                                L);   // dq = ds k
  gemm_kernel<1><<<grid, 128, GEMM_SMEM, st>>>(ds_map, bands[0], (bf16*)dk,
                                                L);   // dk = ds^T q
  gemm_kernel<1><<<grid, 128, GEMM_SMEM, st>>>(pt_map, bands[3], (bf16*)dv,
                                                L);   // dv = pt^T do
  return (int)cudaGetLastError();
}

}  // namespace ths
}  // namespace sav
