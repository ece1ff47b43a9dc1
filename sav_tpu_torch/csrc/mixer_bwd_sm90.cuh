// The K8a and K8b ports on Hopper (wgmma, TMA, mbarriers; sm90.cuh). K8a,
// the token-mixing forward, is the forward band kernel below ("K8a"). K8b:
// the token-mixing backward's band work as one persistent kernel,
// channel-major, with the three products on wgmma and their results kept
// in registers, and the LayerNorm backward as one pass a row
// (mixer_token.cu says what the backward computes).
//
// Band work, for a unit (image b, channels c0..c0+63), M = the 64 channels:
//   hp^T [c, K]    = y^T W1 + b1: A the normalised x tile (y, bf16, MN-
//                    major in shared memory), B W1 K-major;
//   dgact^T [c, K] = do^T W2^T:   A the do tile (MN-major), B W2 K-major;
//   gact = bf16(gelu(hp)) and dhp = dgact gelu'(hp) elementwise in
//   registers (the two accumulators have one layout), gact and bf16(dhp)
//   stored for the dW GEMMs, db1's partial (dhp summed over a warp's 16
//   channels by shuffles);
//   dy^T [c, L]    = bf16(dhp)^T W1^T: A from registers (the accumulator
//                    packed to bf16), B the same W1 tile read MN-major;
// then dy (f32) out for the LN pass, and from the dy accumulator and xhat
// (x reloaded by TMA into the do tile, free once the products have read
// it) the image's dscale and dbias over the band's tokens; db2's partial
// from the do tile. The LN pass (mixer_ln_bwd_kernel, a warp a token row,
// which holds the whole row) forms the row sums of dxhat and dxhat xhat
// and dx: no band partial of a row sum, no exchange across warps.
//
// The weight gradients then run on mixer_dw_kernel below (wgmma, TMA).
//
// Widths: a band kernel is built for LN tokens (a multiple of 8) and KP
// hidden units (a multiple of 16): <200, 112> for L <= 200, K <= 112
// (Mixer-B/16 and -L/16 @224: L = 196, K = 98), <56, 32> for L <= 56, K <=
// 32 (the /32 Mixers: L = 49, K = 24); the LN pass holds D <= 1024 (every
// Mixer) in registers. The products over tokens run LP = LN rounded to 16
// deep. W1 and W2 are held zero-padded (rows past K, tokens past L), so
// every padded hidden unit is gelu(0) = 0, as in the mma.sync kernels; token rows
// past L arrive as zeros from TMA and are never stored.
//
// Shared memory: W1 and W2 once per block, each as KP rows (the hidden
// units) x LP tokens in 64-token chunks of KP x 128 bytes with the 128-
// byte swizzle: W2 [k][l] as it is (the K-major B of dgact); W1 transposed
// to [k][l] on its way in, which is at once the K-major B of hp (N = k,
// depth l) and the MN-major B of dy (depth k, N = l, chunks LBO apart).
// Each of the two warpgroups has its own x tile and do tile (LP rows x 64
// channels, one TMA box each), row statistics and band parameters.
//
// Block: 256 threads, two warpgroups, one block an SM, persistent: warp-
// group w of block i takes units 2 i + w, + 2 gridDim.x, ... (unit u =
// image u / bands, band u % bands), issuing its own TMA loads: the next
// unit's x as soon as the unit's first two products have read the tiles
// (it arrives under the gelu' work and the third product), the next do at
// the unit's end (under the next normalisation). The
// weights are read from device memory once per block (2 x 38 KB at
// Mixer-B), where mixer_token.cu's mma.sync band kernel reads them
// element by element in each of its 2304 blocks (0.72 of its 1.86 ms).
#pragma once

#include "ff_common.cuh"
#include "sm90.cuh"

namespace sav {
namespace mixb {

using namespace sm90;
using ff::gelu_bwd;
using ff::gelu_t;

constexpr int BAND = 64;
constexpr int THREADS = 256;
constexpr int MAX_D = 1024;       // channels the LN pass holds in registers

// Shared memory (bytes from a 1024-byte aligned base); mirrored by
// mixer_bwd_plan in ops/mixer_token.py.
template <int LN, int KP>
struct Geo {
  static_assert(LN % 8 == 0 && KP % 16 == 0, "wgmma widths");
  static constexpr int LP = (LN + 15) / 16 * 16;     // depth over tokens
  static constexpr int NCH = (LP + 63) / 64;         // 64-token chunks
  static constexpr int CB = KP * 128;                // bytes of a chunk
  static constexpr int TILE = LP * 128;              // an x or do tile
  static constexpr int OFF_W1 = 0;
  static constexpr int OFF_W2 = NCH * CB;
  static constexpr int OFF_X = 2 * NCH * CB;         // [2] tiles
  static constexpr int OFF_DO = OFF_X + 2 * TILE;    // [2] tiles
  static constexpr int OFF_STAT = OFF_DO + 2 * TILE;  // [2][2][LP] f32
  static constexpr int OFF_BANDP = OFF_STAT + 2 * 2 * LP * 4;  // [2][2][64]
  static constexpr int OFF_B1 = OFF_BANDP + 2 * 2 * BAND * 4;  // [KP] f32
  static constexpr int OFF_BAR = OFF_B1 + KP * 4;    // [2][2] mbarriers
  static constexpr int SMEM = OFF_BAR + 4 * 8 + 1024;
  // W1 and W2 staged as they are in the four tiles before their layout
  static_assert(LN * KP * 2 <= 2 * TILE, "weights staged in the tiles");
};

struct Args {
  const bf16* x;        // [B, L, D]
  const bf16* dout;     // [B, L, D]
  const float* stats;   // [B L, 2] mu, 1/sigma
  const float* ls;      // [D]
  const float* lb;      // [D]
  const bf16* w1;       // [L, K]
  const float* b1;      // [K]
  const bf16* w2;       // [K, L]
  bf16* y;              // [B, L, D]
  bf16* gact;           // [B, K, D]
  bf16* dh;             // [B, K, D] bf16(dhp)
  float* dy;            // [B, L, D]
  float* db1;           // [B, bands, 4, K]: a partial a warp
  float* db2;           // [B, bands, L]
  float* dls;           // [B, D]: each image's dscale
  float* dlb;           // [B, D]: each image's dbias
  int batch, l, k, d;
};

// sm90::mbar_wait, then the warp reconverged.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

// Byte offset of element (r, c) in a tile of 128-byte rows with the
// 128-byte swizzle (sm90.cuh): chunk c / 8 of row r at chunk
// (c / 8) ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// W1 [L, K] or W2 [K, L] from device memory into `raw` as it is: 16-byte
// loads when the base allows them.
__device__ __forceinline__ void stage(const bf16* __restrict__ src, int n,
                                      bf16* raw) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = n / 8 * 8;
#pragma unroll 4
    for (int i = threadIdx.x; i < n / 8; i += THREADS)
      reinterpret_cast<uint4*>(raw)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
  for (int i = done + threadIdx.x; i < n; i += THREADS) raw[i] = src[i];
}

// W1 and W2 into the block's shared memory once (with the barriers'
// initialisation): staged as they are in `raw` (four x tiles), then laid
// out zero-padded and swizzled, W1 transposed to [k][l].
template <int KP, int NCH, int CB>
__device__ __forceinline__ void load_weights(const bf16* w1, const bf16* w2,
                                             const float* b1, int l, int k,
                                             unsigned char* sW1,
                                             unsigned char* sW2, float* sB1,
                                             bf16* raw1, bf16* raw2,
                                             uint64_t* bars) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&bars[i], 1);
    fence_mbar_init();
  }
  stage(w1, l * k, raw1);
  stage(w2, k * l, raw2);
  for (int i = tid; i < KP; i += THREADS) sB1[i] = i < k ? b1[i] : 0.f;
  __syncthreads();
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < KP * NCH * 64; i += THREADS) {
    const int kk = i / (NCH * 64), ll = i % (NCH * 64);
    const int off = (ll >> 6) * CB + swz(kk, ll & 63);
    const bool in = kk < k && ll < l;
    *reinterpret_cast<bf16*>(sW1 + off) = in ? raw1[ll * k + kk] : zero;
    *reinterpret_cast<bf16*>(sW2 + off) = in ? raw2[kk * l + ll] : zero;
  }
  fence_proxy_async();                     // read by wgmma and by TMA's
  __syncthreads();                         // writes into the tiles
}

// ---- K8a: the forward band kernel
//
// Replaces sav_tpu/ops/mixer_token.py::_fwd_kernel on this route (what it
// computes: mixer_token.cu). A unit (image b, channels c0..c0+63) as the
// backward's, M = the 64 channels:
//   y^T [c, LP]    the x tile read transposed by ldmatrix straight into
//                  wgmma's register A operand and normalised there (the
//                  row statistics by token, the LN scale and bias by
//                  channel, two channels a thread): no y tile;
//   hp^T [c, KP]   = y^T W1 on wgmma, B W1 K-major as the backward's hp;
//   gact = bf16(gelu(hp + b1)) in registers, packed as the next A;
//   out^T [c, LN]  = gact^T W2 on wgmma, B W2 [k][l] read MN-major (as the
//                  backward reads W1 for dy);
//   out = bf16(x + (out + b2)): x read transposed again (ldmatrix), the
//   result written over it (stmatrix), and the tile stored by one TMA
//   store (rows past L are not written).
// Bound on the card: x read once and out written once (0.0345 ms at
// Mixer-B/16 bs192); the products are ~98 operations a byte. Each
// warpgroup holds two x tiles: the next unit's x is loaded into the other
// one (once that tile's store has been read) as the unit's products start,
// and the next unit's row statistics and LN parameters into registers, so
// neither waits on device memory at the unit's start. Shared memory at
// <200, 112>: W1 and W2 114,688 bytes, four tiles 106,496, the statistics
// and biases.
template <int LN, int KP>
struct FwdGeo {
  static constexpr int LP = Geo<LN, KP>::LP;
  static constexpr int NCH = Geo<LN, KP>::NCH;
  static constexpr int CB = Geo<LN, KP>::CB;
  static constexpr int TILE = Geo<LN, KP>::TILE;
  static constexpr int OFF_W1 = 0;
  static constexpr int OFF_W2 = NCH * CB;
  static constexpr int OFF_X = 2 * NCH * CB;         // [2 warpgroups][2]
  static constexpr int OFF_STAT = OFF_X + 4 * TILE;  // [2][2][LP] f32
  static constexpr int OFF_B2 = OFF_STAT + 2 * 2 * LP * 4;  // [LP] f32
  static constexpr int OFF_B1 = OFF_B2 + LP * 4;     // [KP] f32
  static constexpr int OFF_BAR = OFF_B1 + KP * 4;    // [2][2] mbarriers
  static constexpr int SMEM = OFF_BAR + 4 * 8 + 1024;
  static_assert(LN * KP * 2 <= 2 * TILE, "weights staged in the tiles");
};

struct FwdArgs {
  const float* stats;   // [B L, 2] mu, 1/sigma
  const float* ls;      // [D]
  const float* lb;      // [D]
  const bf16* w1;       // [L, K]
  const float* b1;      // [K]
  const bf16* w2;       // [K, L]
  const float* b2;      // [L]
  int batch, l, k, d;
};

// The register A operand of 16-deep step s of y^T, rows the warp's 16
// channels (16 w.. of the tile's 64), depth tokens 16 s..: four 8 x 8
// blocks of the x tile (tokens x channels) read transposed.
__device__ __forceinline__ void x_frag_t(uint32_t (&a)[4],
                                         const unsigned char* tile, int s,
                                         int w, int lane) {
  const int mi = lane >> 3;
  const int tok = 16 * s + 8 * (mi >> 1) + (lane & 7);
  const uint32_t addr = smem_addr(tile + swz(tok, 8 * (2 * w + (mi & 1))));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// The inverse of x_frag_t: four packed bf16 pairs written back to the same
// places of the tile (stmatrix, transposed).
__device__ __forceinline__ void x_store_t(const uint32_t (&a)[4],
                                          unsigned char* tile, int s, int w,
                                          int lane) {
  const int mi = lane >> 3;
  const int tok = 16 * s + 8 * (mi >> 1) + (lane & 7);
  const uint32_t addr = smem_addr(tile + swz(tok, 8 * (2 * w + (mi & 1))));
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
      :: "r"(addr), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]) : "memory");
}

// bf16(x + (o + b)) of two tokens of one channel, packed: x the pair as
// x_frag_t gives it.
__device__ __forceinline__ uint32_t out_pair(uint32_t xv, float o0, float o1,
                                             float2 b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&xv));
  return pack_bf16x2(x.x + (o0 + b.x), x.y + (o1 + b.y));
}

// bf16(LN) of two tokens' x of one channel, packed.
__device__ __forceinline__ uint32_t ln_pair(uint32_t xv, float2 mu, float2 inv,
                                            float sc, float bi) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&xv));
  return pack_bf16x2((x.x - mu.x) * inv.x * sc + bi,
                     (x.y - mu.y) * inv.y * sc + bi);
}

template <int LN, int KP>
__global__ void __launch_bounds__(THREADS, 1)
mixer_fwd_sm90_kernel(const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap mout, FwdArgs a) {
  using G = FwdGeo<LN, KP>;
  constexpr int LP = G::LP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int wi = wt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int l = a.l, k = a.k, d = a.d, bands = d / BAND;
  const int units = a.batch * bands;
  unsigned char* sW1 = base + G::OFF_W1;
  unsigned char* sW2 = base + G::OFF_W2;
  unsigned char* tiles = base + G::OFF_X + 2 * wg * G::TILE;
  float* sMu = reinterpret_cast<float*>(base + G::OFF_STAT) + wg * 2 * LP;
  float* sInv = sMu + LP;
  float* sB2 = reinterpret_cast<float*>(base + G::OFF_B2);
  float* sB1 = reinterpret_cast<float*>(base + G::OFF_B1);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + G::OFF_BAR);
  uint64_t* bar = bars + 2 * wg;

  for (int i = tid; i < LP; i += THREADS) sB2[i] = i < l ? a.b2[i] : 0.f;
  load_weights<KP, G::NCH, G::CB>(
      a.w1, a.w2, a.b1, l, k, sW1, sW2, sB1,
      reinterpret_cast<bf16*>(base + G::OFF_X),
      reinterpret_cast<bf16*>(base + G::OFF_X + 2 * G::TILE), bars);

  const int stride = 2 * gridDim.x;
  const CUtensorMap* pmx = &mx;
  auto load_x = [=](int uu, int slot) {    // unit uu's x tile
    mbar_arrive_expect_tx(&bar[slot], G::TILE);
    tma_load_3d(tiles + slot * G::TILE, pmx, &bar[slot], (uu % bands) * BAND,
                0, uu / bands);
  };
  // unit uu's row statistics (this thread's rows wt, wt + 128) and the LN
  // scale and bias of its two channels, into registers a unit ahead
  float mu_n[2], inv_n[2], par_n[4];
  auto fetch = [&](int uu) {
    const int bb = uu / bands, ch = (uu % bands) * BAND + 16 * wi + g;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = wt + 128 * j;
      mu_n[j] = r < l ? a.stats[2 * ((size_t)bb * l + r)] : 0.f;
      inv_n[j] = r < l ? a.stats[2 * ((size_t)bb * l + r) + 1] : 0.f;
    }
    par_n[0] = a.ls[ch];
    par_n[1] = a.ls[ch + 8];
    par_n[2] = a.lb[ch];
    par_n[3] = a.lb[ch + 8];
  };
  int u = 2 * blockIdx.x + wg;
  if (u < units) {
    if (wt == 0) load_x(u, 0);
    fetch(u);
  }
  for (int it = 0; u < units; u += stride, ++it) {
    const int cur = it & 1;
    unsigned char* sX = tiles + cur * G::TILE;
    const int b = u / bands, c0 = (u % bands) * BAND;
    // 1. the unit's row statistics and LN parameters, fetched a unit ahead
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = wt + 128 * j;
      if (r < LP) {
        sMu[r] = mu_n[j];
        sInv[r] = inv_n[j];
      }
    }
    const float sc0 = par_n[0], sc1 = par_n[1];
    const float bi0 = par_n[2], bi1 = par_n[3];
    warpgroup_sync(1 + wg);

    // 2. y^T in registers: the x tile read transposed, normalised
    wait(&bar[cur], (it >> 1) & 1);
    uint32_t yf[LP / 16][4];
#pragma unroll
    for (int s = 0; s < LP / 16; ++s) {
      x_frag_t(yf[s], sX, s, wi, lane);
      const int t0 = 16 * s + 2 * t;
      const float2 mu0 = *reinterpret_cast<const float2*>(sMu + t0);
      const float2 in0 = *reinterpret_cast<const float2*>(sInv + t0);
      const float2 mu1 = *reinterpret_cast<const float2*>(sMu + t0 + 8);
      const float2 in1 = *reinterpret_cast<const float2*>(sInv + t0 + 8);
      yf[s][0] = ln_pair(yf[s][0], mu0, in0, sc0, bi0);
      yf[s][1] = ln_pair(yf[s][1], mu0, in0, sc1, bi1);
      yf[s][2] = ln_pair(yf[s][2], mu1, in1, sc0, bi0);
      yf[s][3] = ln_pair(yf[s][3], mu1, in1, sc1, bi1);
    }

    // 3. the next unit's statistics and, once the other tile's store has
    // been read, its x: both arrive under this unit's products (started
    // here, not between a product and its wait, where the divergent TMA
    // code would serialize the wgmmas)
    if (u + stride < units) {
      fetch(u + stride);
      if (wt == 0) {
        bulk_wait_read();
        load_x(u + stride, cur ^ 1);
      }
    }
    __syncwarp();
    // hp^T = y^T W1, 64 x KP
    float hp[KP / 2];
#pragma unroll
    for (int i = 0; i < KP / 2; ++i) hp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < LP / 16; ++s)
      wgmma_rs_kn<KP>(hp, yf[s],
                      desc_k_major(sW1 + (s >> 2) * G::CB) + (s & 3) * K_STEP);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(hp);

    // 4. gact = bf16(gelu(hp + b1)) as the next product's A; thread (wi,
    // g, t) holds channels 16 wi + g (+ 8), hidden units 8 i + 2 t (+ 1)
#pragma unroll
    for (int i = 0; i < KP / 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float b1 = sB1[8 * i + 2 * t + j];
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const float h = hp[4 * i + 2 * rh + j] + b1;
          hp[4 * i + 2 * rh + j] = 0.5f * h * (1.f + gelu_t(h));
        }
      }
    uint32_t af[KP / 16][4];
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) a_frag(af[kk], hp, kk);

    // 5. out^T = gact^T W2, 64 x LN
    float o[LN / 2];
#pragma unroll
    for (int i = 0; i < LN / 2; ++i) o[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk)
      wgmma_rs_mn_n<LN>(o, af[kk],
                        desc_encode(sW2, G::CB, 1024) + kk * MN_STEP);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    // 6. out = bf16(x + (out + b2)) over x in the tile, 16 tokens at a
    // time: x read transposed as in step 2, the result written back
    // transposed (stmatrix); accumulator blocks i = 2 s and 2 s + 1 (tokens
    // 8 i + 2 t (+ 1)) hold the step's two halves. Tokens past LN keep x
    // (past L, nothing is stored).
#pragma unroll
    for (int s = 0; s < LP / 16; ++s) {
      uint32_t xr[4];
      x_frag_t(xr, sX, s, wi, lane);
      const int t0 = 16 * s + 2 * t;
      const int i0 = 2 * s, i1 = 2 * s + 1;
      const float2 b0 = *reinterpret_cast<const float2*>(sB2 + t0);
      xr[0] = out_pair(xr[0], o[4 * i0], o[4 * i0 + 1], b0);
      xr[1] = out_pair(xr[1], o[4 * i0 + 2], o[4 * i0 + 3], b0);
      if (i1 < LN / 8) {
        const float2 b1 = *reinterpret_cast<const float2*>(sB2 + t0 + 8);
        xr[2] = out_pair(xr[2], o[4 * i1], o[4 * i1 + 1], b1);
        xr[3] = out_pair(xr[3], o[4 * i1 + 2], o[4 * i1 + 3], b1);
      }
      x_store_t(xr, sX, s, wi, lane);
    }
    fence_proxy_async();                   // the tile is read by TMA
    warpgroup_sync(1 + wg);
    if (wt == 0) {
      tma_store_3d(&mout, sX, c0, 0, b);
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait_all();
}

template <int LN, int KP>
__global__ void __launch_bounds__(THREADS, 1)
mixer_bwd_sm90_kernel(const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap mdo, Args a) {
  using G = Geo<LN, KP>;
  constexpr int LP = G::LP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int wi = wt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int l = a.l, k = a.k, d = a.d, bands = d / BAND;
  const int units = a.batch * bands;
  unsigned char* sW1 = base + G::OFF_W1;
  unsigned char* sW2 = base + G::OFF_W2;
  unsigned char* sX = base + G::OFF_X + wg * G::TILE;
  unsigned char* sDo = base + G::OFF_DO + wg * G::TILE;
  float* sMu = reinterpret_cast<float*>(base + G::OFF_STAT) + wg * 2 * LP;
  float* sInv = sMu + LP;
  float* sLs = reinterpret_cast<float*>(base + G::OFF_BANDP) + wg * 2 * BAND;
  float* sLb = sLs + BAND;
  float* sB1 = reinterpret_cast<float*>(base + G::OFF_B1);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + G::OFF_BAR) + 2 * wg;

  // the weights, once
  load_weights<KP, G::NCH, G::CB>(
      a.w1, a.w2, a.b1, l, k, sW1, sW2, sB1,
      reinterpret_cast<bf16*>(base + G::OFF_X),
      reinterpret_cast<bf16*>(base + G::OFF_DO),
      reinterpret_cast<uint64_t*>(base + G::OFF_BAR));

  const int stride = 2 * gridDim.x;
  const CUtensorMap* pmx = &mx;
  const CUtensorMap* pmdo = &mdo;
  auto load_x = [=](int uu, unsigned char* dst, uint64_t* on) {
    mbar_arrive_expect_tx(on, G::TILE);    // unit uu's x tile
    tma_load_3d(dst, pmx, on, (uu % bands) * BAND, 0, uu / bands);
  };
  auto load_do = [=](int uu) {             // unit uu's do tile
    mbar_arrive_expect_tx(&bar[1], G::TILE);
    tma_load_3d(sDo, pmdo, &bar[1], (uu % bands) * BAND, 0, uu / bands);
  };
  int u = 2 * blockIdx.x + wg;
  if (wt == 0 && u < units) {
    load_x(u, sX, &bar[0]);
    load_do(u);
  }
  uint32_t px = 0, pd = 0;                 // the tiles' phases
  for (; u < units; u += stride) {
    const int b = u / bands, band = u % bands, c0 = band * BAND;
    const size_t img = (size_t)b * l * d;
    const size_t part = (size_t)b * bands + band;

    // 1. the band's LN parameters and the image's row statistics
    if (wt < BAND) sLs[wt] = a.ls[c0 + wt];
    else sLb[wt - BAND] = a.lb[c0 + wt - BAND];
    for (int r = wt; r < LP; r += 128) {
      sMu[r] = r < l ? a.stats[2 * ((size_t)b * l + r)] : 0.f;
      sInv[r] = r < l ? a.stats[2 * ((size_t)b * l + r) + 1] : 0.f;
    }
    warpgroup_sync(1 + wg);

    // 2. y = bf16(LN(x)) over the x tile in place (rows past L zero), and
    // to y for the dW1 GEMM
    wait(&bar[0], px);
    px ^= 1;
    for (int i = wt; i < LP * 8; i += 128) {
      const int r = i >> 3, cc = i & 7;
      uint4* p = reinterpret_cast<uint4*>(sX + swz(r, cc * 8));
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < l) {
        v = *p;
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16((__bfloat162float(e[j]) - sMu[r]) * sInv[r]
                                  * sLs[cc * 8 + j] + sLb[cc * 8 + j]);
        *reinterpret_cast<uint4*>(a.y + img + (size_t)r * d + c0 + cc * 8) = v;
      }
      *p = v;
    }

    // 3. db2's partial: each token row's sum of do over the band
    wait(&bar[1], pd);
    pd ^= 1;
    for (int r = wt; r < l; r += 128) {
      float s = 0.f;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const uint4 v = *reinterpret_cast<const uint4*>(sDo + swz(r, cc * 8));
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += __bfloat162float(e[j]);
      }
      a.db2[part * l + r] = s;
    }
    fence_proxy_async();                   // y is read by wgmma
    warpgroup_sync(1 + wg);

    // 4. hp^T = y^T W1 and dgact^T = do^T W2^T, 64 x KP each
    float hp[KP / 2], dg[KP / 2];
#pragma unroll
    for (int i = 0; i < KP / 2; ++i) hp[i] = dg[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < LP / 16; ++s)
      wgmma_ss_mk<KP>(hp, desc_mn_major(sX) + s * MN_STEP,
                      desc_k_major(sW1 + (s >> 2) * G::CB) + (s & 3) * K_STEP,
                      1);
#pragma unroll
    for (int s = 0; s < LP / 16; ++s)
      wgmma_ss_mk<KP>(dg, desc_mn_major(sDo) + s * MN_STEP,
                      desc_k_major(sW2 + (s >> 2) * G::CB) + (s & 3) * K_STEP,
                      1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(hp);
    fence_regs(dg);
    warpgroup_sync(1 + wg);                // every warp's products are done:
    if (wt == 0) {                         // x again into the do tile (for
      load_x(u, sDo, &bar[1]);             // xhat), the next unit's x
      if (u + stride < units) load_x(u + stride, sX, &bar[0]);
    }

    // 5. gact and dhp (f32, over dg); thread (wi, g, t) holds channels
    // 16 wi + g (+ 8), hidden units 8 i + 2 t (+ 1)
    const int ch = 16 * wi + g;
    float* db1 = a.db1 + (part * 4 + wi) * k;
#pragma unroll
    for (int i = 0; i < KP / 8; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = 8 * i + 2 * t + j;
        const float b1 = sB1[kc];
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int e = 4 * i + 2 * rh + j;
          const float h = hp[e] + b1;
          const float th = gelu_t(h);
          const float dhp = dg[e] * gelu_bwd(h, th);
          dg[e] = dhp;
          if (kc < k) {
            const size_t off = ((size_t)b * k + kc) * d + c0 + ch + 8 * rh;
            a.gact[off] = __float2bfloat16(0.5f * h * (1.f + th));
            a.dh[off] = __float2bfloat16(dhp);
          }
        }
        // db1: over the thread's two channels, then the warp's 16
        float v = dg[4 * i + j] + dg[4 * i + 2 + j];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0 && kc < k) db1[kc] = v;
      }
    }

    // 6. dy^T = bf16(dhp)^T W1^T, 64 x LN
    uint32_t af[KP / 16][4];
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) a_frag(af[kk], dg, kk);
    float dy[LN / 2];
#pragma unroll
    for (int i = 0; i < LN / 2; ++i) dy[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk)
      wgmma_rs_mn_n<LN>(dy, af[kk],
                        desc_encode(sW1, G::CB, 1024) + kk * MN_STEP);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dy);

    // 7. dy (f32) out, and the image's dscale and dbias over the band's
    // tokens from dy and xhat (x reloaded into the do tile)
    wait(&bar[1], pd);
    pd ^= 1;
    float dsc[2] = {0.f, 0.f}, dbi[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < LN / 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int lc = 8 * i + 2 * t + j;
        if (lc >= l) continue;
        const float mu = sMu[lc], inv = sInv[lc];
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int c = ch + 8 * rh;
          const float v = dy[4 * i + 2 * rh + j];
          const float xh = (__bfloat162float(*reinterpret_cast<const bf16*>(
                                sDo + swz(lc, c))) - mu) * inv;
          dsc[rh] += v * xh;
          dbi[rh] += v;
          a.dy[img + (size_t)lc * d + c0 + c] = v;
        }
      }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float sl = dsc[rh], sb = dbi[rh];
      sl += __shfl_xor_sync(0xffffffffu, sl, 1);
      sl += __shfl_xor_sync(0xffffffffu, sl, 2);
      sb += __shfl_xor_sync(0xffffffffu, sb, 1);
      sb += __shfl_xor_sync(0xffffffffu, sb, 2);
      if (t == 0) {
        a.dls[(size_t)b * d + c0 + ch + 8 * rh] = sl;
        a.dlb[(size_t)b * d + c0 + ch + 8 * rh] = sb;
      }
    }
    fence_proxy_async();                   // the do tile is the next do's
    warpgroup_sync(1 + wg);
    if (wt == 0 && u + stride < units) load_do(u + stride);
  }
}

// The LN backward's row pass, a warp a token row (NC chunks of 256
// channels, lane channels 256 j + 8 lane ..): with xhat = (x - mu) inv and
// dxhat = dy * scale, dx = do + inv (dxhat - mean(dxhat) - xhat
// mean(dxhat xhat)), the two means summed over the whole row in the warp.
template <int NC>
__global__ void __launch_bounds__(256)
mixer_ln_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout,
                    const float* __restrict__ stats,
                    const float* __restrict__ ls, const float* __restrict__ dy,
                    bf16* __restrict__ dx, int rows, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= rows) return;
  const float mu = stats[2 * row], inv = stats[2 * row + 1];
  const size_t base = (size_t)row * d;
  uint4 xu[NC], du[NC];
  float4 d0[NC], d1[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {           // every load of the row at once
    const int c = 256 * j + 8 * lane;
    if (c >= d) continue;
    xu[j] = *reinterpret_cast<const uint4*>(x + base + c);
    du[j] = *reinterpret_cast<const uint4*>(dout + base + c);
    d0[j] = *reinterpret_cast<const float4*>(dy + base + c);
    d1[j] = *reinterpret_cast<const float4*>(dy + base + c + 4);
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = 256 * j + 8 * lane;
    if (c >= d) continue;
    const bf16* xe = reinterpret_cast<const bf16*>(&xu[j]);
    const float dv[8] = {d0[j].x, d0[j].y, d0[j].z, d0[j].w,
                         d1[j].x, d1[j].y, d1[j].z, d1[j].w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xh = (__bfloat162float(xe[e]) - mu) * inv;
      const float dxh = dv[e] * ls[c + e];
      s1 += dxh;
      s2 += dxh * xh;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float m1 = s1 / d, m2 = s2 / d;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = 256 * j + 8 * lane;
    if (c >= d) continue;
    const bf16* xe = reinterpret_cast<const bf16*>(&xu[j]);
    const bf16* de = reinterpret_cast<const bf16*>(&du[j]);
    const float dv[8] = {d0[j].x, d0[j].y, d0[j].z, d0[j].w,
                         d1[j].x, d1[j].y, d1[j].z, d1[j].w};
    uint4 ou;
    bf16* oe = reinterpret_cast<bf16*>(&ou);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xh = (__bfloat162float(xe[e]) - mu) * inv;
      const float dxh = dv[e] * ls[c + e];
      oe[e] = __float2bfloat16(__bfloat162float(de[e])
                               + inv * (dxh - m1 - xh * m2));
    }
    *reinterpret_cast<uint4*>(dx + base + c) = ou;
  }
}

// The weight gradients, dW1 [L, K] = sum over images b and channels c of
// y[b, l, c] bf16(dhp)[b, k, c], and dW2^T [L, K] = the same over do and
// gact: both contract over the channels, contiguous in both operands, so
// both read K-major (TMA boxes of 64 channels x 256 token rows for A, x 128
// hidden rows for B; rows past L and K arrive as zeros). A unit is one
// product over one chunk of images (split-K, mixer_token.cu's chunks),
// written as its own f32 partial (dW2's transposed, [K, L]); the partials
// are summed in a fixed order. Block: 384 threads, persistent; the
// producer warpgroup's first lane streams each unit's 64-deep steps (A 32
// KB, B 16 KB) through a ring of DW_STAGES slots; warpgroup q holds rows
// 128 q.. of the 256 x 128 output (two m64n128k16 products a 16-deep
// step). The mma.sync GEMM of ff_common.cuh it replaces on this route took
// 0.14 ms at Mixer-B/16 bs192.
constexpr int DW_BM = 256, DW_BN = 128, DW_BK = 64, DW_STAGES = 4;
constexpr int DW_THREADS = 384;
constexpr uint32_t DW_A_BYTES = DW_BM * DW_BK * 2;                // 32 KB
constexpr uint32_t DW_STAGE_BYTES = DW_A_BYTES + DW_BN * DW_BK * 2;  // 48 KB
constexpr int DW_SMEM = DW_STAGES * DW_STAGE_BYTES + 2 * DW_STAGES * 8 + 1024;

struct DwArgs {
  int batch, l, k, d, chunks, per_chunk;
  float* part1;         // [chunks, L, K]
  float* part2;         // [chunks, K, L]
};

// maps a0/b0: y and bf16(dhp) (dW1); a1/b1: do and gact (dW2)
__global__ void __launch_bounds__(DW_THREADS, 1)
mixer_dw_kernel(const __grid_constant__ CUtensorMap a0,
                const __grid_constant__ CUtensorMap b0,
                const __grid_constant__ CUtensorMap a1,
                const __grid_constant__ CUtensorMap b1, DwArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + DW_STAGES * DW_STAGE_BYTES);
  uint64_t* empty = full + DW_STAGES;
  const int tid = threadIdx.x;
  const int units = 2 * a.chunks, ksteps = a.d / DW_BK;
  if (tid == 0) {
    for (int i = 0; i < DW_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);             // each consumer warp once
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 256) {                        // producer warpgroup
    if (tid != 256) return;
    int step = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int p = u / a.chunks, c = u % a.chunks;
      const int b0i = c * a.per_chunk;
      const int b1i = min(b0i + a.per_chunk, a.batch);
      const CUtensorMap* ma = p ? &a1 : &a0;
      const CUtensorMap* mb = p ? &b1 : &b0;
      for (int b = b0i; b < b1i; ++b)
        for (int kk = 0; kk < ksteps; ++kk, ++step) {
          const int s = step % DW_STAGES;
          mbar_wait(&empty[s], ((step / DW_STAGES) & 1) ^ 1);
          unsigned char* st = base + s * DW_STAGE_BYTES;
          mbar_arrive_expect_tx(&full[s], DW_STAGE_BYTES);
          tma_load_3d(st, ma, &full[s], kk * DW_BK, 0, b);
          tma_load_3d(st + DW_A_BYTES, mb, &full[s], kk * DW_BK, 0, b);
        }
    }
    return;
  }

  const int wg = tid >> 7, wi = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int step = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int p = u / a.chunks, c = u % a.chunks;
    const int b0i = c * a.per_chunk;
    const int nk = (min(b0i + a.per_chunk, a.batch) - b0i) * ksteps;
    float acc[2][64];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[hh][i] = 0.f;
    for (int k = 0; k < nk; ++k, ++step) {
      const int s = step % DW_STAGES;
      wait(&full[s], (step / DW_STAGES) & 1);
      const unsigned char* st = base + s * DW_STAGE_BYTES;
      // A: rows 128 wg + 64 hh.. of the 256-row box; B: the 128-row box
      const uint64_t da = desc_k_major(st + wg * (128 * 128));
      const uint64_t db = desc_k_major(st + DW_A_BYTES);
      constexpr uint64_t HALF = (64 * 128) >> 4;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DW_BK / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          wgmma_ss_n128<0, 0>(acc[hh], da + hh * HALF + kk * K_STEP,
                              db + kk * K_STEP);
      wgmma_commit();
      wgmma_wait<1>();
      if (k > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % DW_STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (nk > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % DW_STAGES]);
    // thread (wg, wi, g, t): token rows 128 wg + 64 hh + 16 wi + g (+ 8),
    // hidden columns 8 i + 2 t (+ 1)
    const size_t plane = (size_t)a.l * a.k;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int r = 128 * wg + 64 * hh + 16 * wi + g + 8 * rh;
        if (r >= a.l) continue;
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int cc = 8 * i + 2 * t + j;
            if (cc >= a.k) continue;
            const float v = acc[hh][4 * i + 2 * rh + j];
            if (p == 0) a.part1[c * plane + (size_t)r * a.k + cc] = v;
            else a.part2[c * plane + (size_t)cc * a.l + r] = v;
          }
      }
  }
}

inline cudaError_t dw_launch(const bf16* y, const bf16* dh, const bf16* dout,
                             const bf16* gact, const DwArgs& args,
                             cudaStream_t st) {
  static_assert(DW_SMEM <= 232448, "over the block's shared memory");
  CUtensorMap a0, b0, a1, b1;
  int err = band_map(&a0, y, args.batch, args.l, args.l, args.d, DW_BM);
  if (!err) err = band_map(&b0, dh, args.batch, args.k, args.k, args.d, DW_BN);
  if (!err) err = band_map(&a1, dout, args.batch, args.l, args.l, args.d, DW_BM);
  if (!err) err = band_map(&b1, gact, args.batch, args.k, args.k, args.d, DW_BN);
  if (err) return (cudaError_t)err;
  cudaError_t e = cudaFuncSetAttribute(
      mixer_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int units = 2 * args.chunks;
  mixer_dw_kernel<<<units < sms || sms <= 0 ? units : sms, DW_THREADS,
                    DW_SMEM, st>>>(a0, b0, a1, b1, args);
  return cudaGetLastError();
}

// out[i] = the sum over q of part[q stride + i] for i < n, one block a
// column: each thread a fixed stride of the partials, then a fixed tree
// (no float atomics: the same bits on every run). For thousands of
// partials of a few hundred columns.
__global__ void __launch_bounds__(256)
sum_columns(const float* __restrict__ part, int parts, long long stride,
            float* __restrict__ out) {
  __shared__ float red[256];
  const int i = blockIdx.x, tid = threadIdx.x;
  float s = 0.f;
  for (int q = tid; q < parts; q += 256) s += part[(size_t)q * stride + i];
  red[tid] = s;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) out[i] = red[0];
}

inline cudaError_t sum_columns_launch(const float* part, int parts,
                                      long long stride, int n, float* out,
                                      cudaStream_t st) {
  sum_columns<<<n, 256, 0, st>>>(part, parts, stride, out);
  return cudaGetLastError();
}

// The band kernel's widths for tokens l, hidden k and channels d: 2 for
// <200, 112>, 1 for <56, 32>, 0 where neither holds them or the LN pass
// does not hold d (mixer_token.cu's mma.sync band kernel and finish pass
// take the shape).
inline int route_of(int l, int k, int d) {
  if (d > MAX_D) return 0;
  if (l <= 56 && k <= 32) return 1;
  if (l <= 200 && k <= 112) return 2;
  return 0;
}

inline int grid_for(int units, int sms) {
  const int pairs = (units + 1) / 2;
  return pairs < sms || sms <= 0 ? pairs : sms;
}

template <int LN, int KP>
cudaError_t launch(const Args& args, cudaStream_t st) {
  using G = Geo<LN, KP>;
  static_assert(G::SMEM <= 232448, "over the block's shared memory");
  CUtensorMap mx, mdo;
  int err = band_map(&mx, args.x, args.batch, args.l, args.l, args.d, G::LP);
  if (!err) err = band_map(&mdo, args.dout, args.batch, args.l, args.l,
                           args.d, G::LP);
  if (err) return (cudaError_t)err;
  cudaError_t e = cudaFuncSetAttribute(
      mixer_bwd_sm90_kernel<LN, KP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int units = args.batch * (args.d / BAND);
  mixer_bwd_sm90_kernel<LN, KP><<<grid_for(units, sms), THREADS, G::SMEM,
                                  st>>>(mx, mdo, args);
  return cudaGetLastError();
}

template <int LN, int KP>
cudaError_t fwd_launch(const bf16* x, bf16* out, const FwdArgs& args,
                       cudaStream_t st) {
  using G = FwdGeo<LN, KP>;
  static_assert(G::SMEM <= 232448, "over the block's shared memory");
  CUtensorMap mx, mout;
  int err = band_map(&mx, x, args.batch, args.l, args.l, args.d, G::LP);
  if (!err) err = band_map(&mout, out, args.batch, args.l, args.l, args.d,
                           G::LP);
  if (err) return (cudaError_t)err;
  cudaError_t e = cudaFuncSetAttribute(
      mixer_fwd_sm90_kernel<LN, KP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int units = args.batch * (args.d / BAND);
  mixer_fwd_sm90_kernel<LN, KP><<<grid_for(units, sms), THREADS, G::SMEM,
                                  st>>>(mx, mout, args);
  return cudaGetLastError();
}

// The LN row pass for d <= MAX_D channels, 8 rows a block.
inline cudaError_t ln_bwd(const bf16* x, const bf16* dout, const float* stats,
                          const float* ls, const float* dy, bf16* dx,
                          int rows, int d, cudaStream_t st) {
  const int blocks = (rows + 7) / 8;
  switch ((d + 255) / 256) {
    case 1: mixer_ln_bwd_kernel<1><<<blocks, 256, 0, st>>>(x, dout, stats, ls, dy, dx, rows, d); break;
    case 2: mixer_ln_bwd_kernel<2><<<blocks, 256, 0, st>>>(x, dout, stats, ls, dy, dx, rows, d); break;
    case 3: mixer_ln_bwd_kernel<3><<<blocks, 256, 0, st>>>(x, dout, stats, ls, dy, dx, rows, d); break;
    case 4: mixer_ln_bwd_kernel<4><<<blocks, 256, 0, st>>>(x, dout, stats, ls, dy, dx, rows, d); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace mixb
}  // namespace sav
