// K8 port: MLP-Mixer's token-mixing sublayer, forward (K8a) and backward
// (K8b), on the model's own [B, L, D] layout (never transposed).
//
// Replaces sav_tpu/ops/mixer_token.py::_fwd_kernel (K8a) and ::_bwd_kernel
// (K8b). With x [B, L, D] bf16, LN over D (f32 statistics, fast variance,
// eps), W1 [L, K], W2 [K, L] bf16, b1 [K], b2 [L] and the LN's scale and
// bias [D] f32, per image:
//   y  = bf16(LN(x))                        [L, D]
//   hp = W1^T y + b1 (f32),  gact = gelu(hp) [K, D]   (tanh form)
//   out = bf16(x + W2^T bf16(gact) + b2)
// and the backward from x alone (the only residual): dW2, db2, dgact =
// W2 do, dhp = dgact * gelu'(hp) (f32 up to db1), dW1, db1, dy = W1
// bf16(dhp) (f32), the LN backward over D, dscale, dbias and dx = do +
// dx_ln, every weight gradient summed over all images.
//
// Bound on the card: at Mixer-B/16 (L = 196, K = 98, D = 768) the two
// forward products are 4 L K D = 59 MFLOP per image against 2 L D bf16
// bytes read and written (0.6 MB), ~98 operations a byte, under the card's
// ~295: both K8a and K8b are bound by device-memory bytes (0.0345 ms and
// 0.0518 ms at bs192).
//
// Design (the mma.sync kernels below, K8a and K8b past the Hopper kernels'
// widths: mma.sync m16n8k16 on operands in shared memory):
//  * L = 196 and K = 98 are not multiples of 16: W1 and W2 are padded to
//    Lp x Kp in shared memory with zeros (W1's padded columns, W2's padded
//    rows, b1's and b2's padded entries), so every padded hidden unit is
//    gelu(0) = 0 and adds nothing; padded token rows are never stored.
//  * Channels are independent except through the LN statistics of each
//    token row, so a block owns one (image, channel band): the contraction
//    over tokens is whole inside it. The statistics need the whole D-wide
//    row: a first launch (mixer_stats_kernel, one warp per row) writes mu
//    and 1/sigma of every row, which the band blocks read.
//  * K8a: for L <= 200, K <= 112 and D <= 1024 (every Mixer config at
//    224) the band work is mixer_bwd_sm90.cuh's persistent wgmma + TMA
//    forward band kernel (two warpgroups, each its own (image, 64-channel
//    band) unit; W1 and W2 resident per block; y normalised in registers
//    as the first product's A, gact from registers as the second's, the
//    result written over x in its tile and stored by TMA). Past those
//    widths (route 0, which no factory config reaches) one mma.sync block
//    per (128-channel band, image): W1, W2, the normalised band y and the
//    gelu band in shared memory (188 KB at Mixer-B/16 widths), W1 and W2
//    loaded element by element in every block.
//  * K8b: the LN backward couples all bands of a token row through
//    mean(dxhat) and mean(dxhat * xhat). For L <= 200, K <= 112 and D <=
//    1024 (every Mixer config at 224) the band work is mixer_bwd_sm90.cuh's
//    persistent wgmma + TMA kernel (channel-major, the weights resident,
//    the products' results in registers; it also forms each image's
//    dscale and dbias), which writes dy (f32), and the LN backward is one
//    pass a token row (mixer_ln_bwd_kernel: the row sums and dx). Past those
//    widths the mma.sync band kernel below (one block per (64-channel
//    band, image), mma.sync on operands in shared memory) writes dy and
//    its bands' row sums, and mixer_finish_kernel (one warp per row) adds
//    the row sums in band order and forms dx. The weight gradients sum
//    over images and channels: the band work writes y, gact and bf16(dhp)
//    (the operands the TPU kernel feeds its dW products), and dW1 and dW2
//    are a GEMM with that contraction split into image chunks: on the
//    Hopper route mixer_bwd_sm90.cuh's wgmma + TMA kernel, else the shared
//    tiled mma.sync GEMM of ff_common.cuh. Every
//    partial (chunk of dW; band or warp of db1, db2; image of dscale and
//    dbias) is written by one block and summed in a fixed order
//    (sum_partials, or sum_columns, a block a column, where there are
//    thousands): no float atomics, the same gradients on every run.
#include "ff_common.cuh"
#include "mixer_bwd_sm90.cuh"

namespace sav {
namespace mix {

using namespace sav::ff;

constexpr int FWD_BAND = 128;
constexpr int BWD_BAND = 64;
constexpr int MAX_CHUNKS = 64;   // image chunks of the dW GEMMs

__host__ __device__ inline int up16(int n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline size_t fwd_smem(int l, int k) {
  const int lp = up16(l), kp = up16(k);
  return (size_t)(lp * (kp + 8) + kp * (lp + 8) + lp * (FWD_BAND + 8)
                  + kp * (FWD_BAND + 8)) * 2
         + (size_t)(kp + 3 * lp + 2 * FWD_BAND) * 4;
}

__host__ __device__ inline size_t bwd_union(int l) {
  const int lp = up16(l);
  const size_t two = (size_t)2 * lp * (BWD_BAND + 8) * 2;
  const size_t dy = (size_t)lp * (BWD_BAND + 4) * 4;
  return two > dy ? two : dy;
}

__host__ __device__ inline size_t bwd_smem(int l, int k) {
  const int lp = up16(l), kp = up16(k);
  return (size_t)(lp * (kp + 8) + kp * (lp + 8)) * 2 + bwd_union(l)
         + (size_t)kp * (BWD_BAND + 4) * 4 + (size_t)kp * (BWD_BAND + 8) * 2
         + (size_t)(kp + 2 * lp + BWD_BAND) * 4;
}

// mu and 1/sigma of every [D] row, one warp per row.
__global__ void __launch_bounds__(256)
mixer_stats_kernel(const bf16* __restrict__ x, float* __restrict__ stats,
                   int rows, int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * d;
  float s = 0.f, ss = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
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
  if (lane == 0) {
    const float mu = s / d;
    stats[2 * row] = mu;
    stats[2 * row + 1] = rsqrtf(fmaxf(ss / d - mu * mu, 0.f) + eps);
  }
}

// W1 [L, K] -> s [Lp][Kp + 8] and W2 [K, L] -> s [Kp][Lp + 8], zero-padded.
__device__ void load_weights(const bf16* __restrict__ w1,
                             const bf16* __restrict__ w2, bf16* sW1,
                             bf16* sW2, int l, int k) {
  const int lp = up16(l), kp = up16(k);
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < lp * kp; i += blockDim.x) {
    const int r = i / kp, c = i % kp;
    sW1[r * (kp + 8) + c] = (r < l && c < k) ? w1[r * k + c] : zero;
  }
  for (int i = threadIdx.x; i < kp * lp; i += blockDim.x) {
    const int r = i / lp, c = i % lp;
    sW2[r * (lp + 8) + c] = (r < k && c < l) ? w2[r * l + c] : zero;
  }
}

// y band [Lp][band + 8] = bf16(LN(x)) of channels c0.. of image b (padded
// rows zero); also written to y_out [B, L, D] when given.
template <int kBand>
__device__ void ln_band(const bf16* __restrict__ xb, const float* sMu,
                        const float* sInv, const float* __restrict__ ls,
                        const float* __restrict__ lb, bf16* sY,
                        bf16* __restrict__ y_out, int l, int d, int c0) {
  const int lp = up16(l);
  constexpr int CH = kBand / 8;
  for (int i = threadIdx.x; i < lp * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r < l) {
      u = *reinterpret_cast<const uint4*>(xb + (size_t)r * d + c0 + c);
      bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16((__bfloat162float(e[j]) - sMu[r]) * sInv[r]
                                * ls[c0 + c + j] + lb[c0 + c + j]);
      if (y_out) *reinterpret_cast<uint4*>(y_out + (size_t)r * d + c0 + c) = u;
    }
    *reinterpret_cast<uint4*>(sY + r * (kBand + 8) + c) = u;
  }
}

__device__ void load_stats(const float* __restrict__ stats, float* sMu,
                           float* sInv, int l) {
  for (int r = threadIdx.x; r < up16(l); r += blockDim.x) {
    sMu[r] = r < l ? stats[2 * r] : 0.f;
    sInv[r] = r < l ? stats[2 * r + 1] : 0.f;
  }
}

// K8a: one block per (band, image).
__global__ void __launch_bounds__(256)
mixer_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ stats,
                 const float* __restrict__ ls, const float* __restrict__ lb,
                 const bf16* __restrict__ w1, const float* __restrict__ b1,
                 const bf16* __restrict__ w2, const float* __restrict__ b2,
                 bf16* __restrict__ out, int l, int k, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lp = up16(l), kp = up16(k);
  constexpr int NB = FWD_BAND;
  bf16* sW1 = reinterpret_cast<bf16*>(smem_raw);
  bf16* sW2 = sW1 + lp * (kp + 8);
  bf16* sY = sW2 + kp * (lp + 8);
  bf16* sG = sY + lp * (NB + 8);
  float* sB1 = reinterpret_cast<float*>(sG + kp * (NB + 8));
  float* sB2 = sB1 + kp;
  float* sMu = sB2 + lp;
  float* sInv = sMu + lp;

  const int b = blockIdx.y, c0 = blockIdx.x * NB;
  const bf16* xb = x + (size_t)b * l * d;
  load_weights(w1, w2, sW1, sW2, l, k);
  for (int i = threadIdx.x; i < kp; i += blockDim.x) sB1[i] = i < k ? b1[i] : 0.f;
  for (int i = threadIdx.x; i < lp; i += blockDim.x) sB2[i] = i < l ? b2[i] : 0.f;
  load_stats(stats + (size_t)b * l * 2, sMu, sInv, l);
  __syncthreads();
  ln_band<NB>(xb, sMu, sInv, ls, lb, sY, nullptr, l, d, c0);
  __syncthreads();

  // hp[k, c] = sum_l W1[l, k] y[l, c] + b1[k]; gact = gelu(hp) in bf16
  block_mma<true, false>(sW1, kp + 8, sY, NB + 8, kp, NB, lp,
                         [&](int r, int c, float v0, float v1) {
    const float h0 = v0 + sB1[r], h1 = v1 + sB1[r];
    *reinterpret_cast<uint32_t*>(sG + r * (NB + 8) + c) =
        pack_bf16(0.5f * h0 * (1.f + gelu_t(h0)),
                  0.5f * h1 * (1.f + gelu_t(h1)));
  });
  __syncthreads();

  // out[l, c] = x[l, c] + sum_k W2[k, l] gact[k, c] + b2[l]
  bf16* ob = out + (size_t)b * l * d;
  block_mma<true, false>(sW2, lp + 8, sG, NB + 8, lp, NB, kp,
                         [&](int r, int c, float v0, float v1) {
    if (r >= l) return;
    const size_t off = (size_t)r * d + c0 + c;
    const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(xb + off);
    *reinterpret_cast<uint32_t*>(ob + off) =
        pack_bf16(__low2float(x2) + v0 + sB2[r],
                  __high2float(x2) + v1 + sB2[r]);
  });
}

// K8b, the band part past mixer_bwd_sm90.cuh's widths (L > 200 or K >
// 112: mixb::route_of gives 0): one block per (64-channel band, image).
struct BwdOut {
  bf16* y;          // [B, L, D]
  bf16* gact;       // [B, K, D]
  bf16* dh;         // [B, K, D]  bf16(dhp)
  float* dy;        // [B, L, D]
  float* rows;      // [B, bands, L, 2]  row sums of dxhat and dxhat*xhat
  float* db1;       // [B, bands, K]
  float* db2;       // [B, bands, L]
  float* dls;       // [B, D]
  float* dlb;       // [B, D]
};

__global__ void __launch_bounds__(256)
mixer_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout,
                 const float* __restrict__ stats, const float* __restrict__ ls,
                 const float* __restrict__ lb, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 BwdOut o, int l, int k, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lp = up16(l), kp = up16(k);
  constexpr int NB = BWD_BAND;
  bf16* sW1 = reinterpret_cast<bf16*>(smem_raw);
  bf16* sW2 = sW1 + lp * (kp + 8);
  unsigned char* uni = reinterpret_cast<unsigned char*>(sW2 + kp * (lp + 8));
  bf16* sY = reinterpret_cast<bf16*>(uni);       // y band, then dy (f32)
  bf16* sDo = sY + lp * (NB + 8);
  float* sDy = reinterpret_cast<float*>(uni);
  float* sHp = reinterpret_cast<float*>(uni + bwd_union(l));  // hp, then dhp
  bf16* sDh = reinterpret_cast<bf16*>(sHp + kp * (NB + 4));
  float* sB1 = reinterpret_cast<float*>(sDh + kp * (NB + 8));
  float* sMu = sB1 + kp;
  float* sInv = sMu + lp;
  float* sLs = sInv + lp;

  const int b = blockIdx.y, band = blockIdx.x, bands = gridDim.x;
  const int c0 = band * NB;
  const size_t img = (size_t)b * l * d, himg = (size_t)b * k * d;
  const bf16* xb = x + img;
  const bf16* dob = dout + img;
  load_weights(w1, w2, sW1, sW2, l, k);
  for (int i = threadIdx.x; i < kp; i += blockDim.x) sB1[i] = i < k ? b1[i] : 0.f;
  for (int i = threadIdx.x; i < NB; i += blockDim.x) sLs[i] = ls[c0 + i];
  load_stats(stats + (size_t)b * l * 2, sMu, sInv, l);
  __syncthreads();
  ln_band<NB>(xb, sMu, sInv, ls, lb, sY, o.y + img, l, d, c0);
  for (int i = threadIdx.x; i < lp * (NB / 8); i += blockDim.x) {
    const int r = i / (NB / 8), c = (i % (NB / 8)) * 8;
    const uint4 u = r < l ? *reinterpret_cast<const uint4*>(
                                dob + (size_t)r * d + c0 + c)
                          : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(sDo + r * (NB + 8) + c) = u;
  }
  __syncthreads();

  // db2 partial: each token row's sum of do over the band
  float* db2 = o.db2 + ((size_t)b * bands + band) * l;
  for (int r = threadIdx.x; r < l; r += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < NB; ++c) s += __bfloat162float(sDo[r * (NB + 8) + c]);
    db2[r] = s;
  }
  // hp = W1^T y + b1 (f32, kept); gact = bf16(gelu(hp)) for the dW2 GEMM
  bf16* gb = o.gact + himg;
  block_mma<true, false>(sW1, kp + 8, sY, NB + 8, kp, NB, lp,
                         [&](int r, int c, float v0, float v1) {
    const float h0 = v0 + sB1[r], h1 = v1 + sB1[r];
    sHp[r * (NB + 4) + c] = h0;
    sHp[r * (NB + 4) + c + 1] = h1;
    if (r < k)
      *reinterpret_cast<uint32_t*>(gb + (size_t)r * d + c0 + c) =
          pack_bf16(0.5f * h0 * (1.f + gelu_t(h0)),
                    0.5f * h1 * (1.f + gelu_t(h1)));
  });
  __syncthreads();

  // dgact = W2 do; dhp = dgact * gelu'(hp) in f32 (over hp, in place)
  bf16* hb = o.dh + himg;
  block_mma<false, false>(sW2, lp + 8, sDo, NB + 8, kp, NB, lp,
                          [&](int r, int c, float v0, float v1) {
    float* hp = sHp + r * (NB + 4) + c;
    const float d0 = v0 * gelu_bwd(hp[0], gelu_t(hp[0]));
    const float d1 = v1 * gelu_bwd(hp[1], gelu_t(hp[1]));
    hp[0] = d0;
    hp[1] = d1;
    const uint32_t packed = pack_bf16(d0, d1);
    *reinterpret_cast<uint32_t*>(sDh + r * (NB + 8) + c) = packed;
    if (r < k) *reinterpret_cast<uint32_t*>(hb + (size_t)r * d + c0 + c) = packed;
  });
  __syncthreads();

  // db1 partial from the f32 dhp; dy = W1 bf16(dhp) (f32, over y and do)
  float* db1 = o.db1 + ((size_t)b * bands + band) * k;
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < NB; ++c) s += sHp[r * (NB + 4) + c];
    db1[r] = s;
  }
  block_mma<false, false>(sW1, kp + 8, sDh, NB + 8, lp, NB, kp,
                          [&](int r, int c, float v0, float v1) {
    sDy[r * (NB + 4) + c] = v0;
    sDy[r * (NB + 4) + c + 1] = v1;
  });
  __syncthreads();

  // dy to device memory for the finishing pass
  float* dyb = o.dy + img;
  for (int i = threadIdx.x; i < l * NB; i += blockDim.x) {
    const int r = i / NB, c = i % NB;
    dyb[(size_t)r * d + c0 + c] = sDy[r * (NB + 4) + c];
  }
  // per token row: sum of dxhat = dy * scale and of dxhat * xhat
  float* rows = o.rows + ((size_t)b * bands + band) * l * 2;
  for (int r = threadIdx.x; r < l; r += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = 0; c < NB; ++c) {
      const float xh = (__bfloat162float(xb[(size_t)r * d + c0 + c]) - sMu[r])
                       * sInv[r];
      const float dxh = sDy[r * (NB + 4) + c] * sLs[c];
      s1 += dxh;
      s2 += dxh * xh;
    }
    rows[2 * r] = s1;
    rows[2 * r + 1] = s2;
  }
  // per channel of the band: this image's dscale and dbias
  for (int c = threadIdx.x; c < NB; c += blockDim.x) {
    float sl = 0.f, sb = 0.f;
    for (int r = 0; r < l; ++r) {
      const float xh = (__bfloat162float(xb[(size_t)r * d + c0 + c]) - sMu[r])
                       * sInv[r];
      const float dyv = sDy[r * (NB + 4) + c];
      sl += dyv * xh;
      sb += dyv;
    }
    o.dls[(size_t)b * d + c0 + c] = sl;
    o.dlb[(size_t)b * d + c0 + c] = sb;
  }
}

// dx = do + inv * (dy * scale - mean(dxhat) - xhat * mean(dxhat * xhat)),
// one warp per token row, the band row sums added in band order.
__global__ void __launch_bounds__(256)
mixer_finish_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout,
                    const float* __restrict__ stats,
                    const float* __restrict__ ls, const float* __restrict__ dy,
                    const float* __restrict__ rows, bf16* __restrict__ dx,
                    int batch, int l, int d, int bands) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= batch * l) return;
  const int b = row / l, r = row % l;
  float s1 = 0.f, s2 = 0.f;
  for (int j = 0; j < bands; ++j) {
    const float* p = rows + (((size_t)b * bands + j) * l + r) * 2;
    s1 += p[0];
    s2 += p[1];
  }
  const float m1 = s1 / d, m2 = s2 / d;
  const float mu = stats[2 * row], inv = stats[2 * row + 1];
  const size_t base = (size_t)row * d;
  for (int c = lane * 8; c < d; c += 256) {
    const uint4 xu = *reinterpret_cast<const uint4*>(x + base + c);
    const uint4 du = *reinterpret_cast<const uint4*>(dout + base + c);
    const bf16* xe = reinterpret_cast<const bf16*>(&xu);
    const bf16* de = reinterpret_cast<const bf16*>(&du);
    uint4 ou;
    bf16* oe = reinterpret_cast<bf16*>(&ou);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xh = (__bfloat162float(xe[j]) - mu) * inv;
      const float dxh = dy[base + c + j] * ls[c + j];
      oe[j] = __float2bfloat16(__bfloat162float(de[j])
                               + inv * (dxh - m1 - xh * m2));
    }
    *reinterpret_cast<uint4*>(dx + base + c) = ou;
  }
}

inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// The backward's scratch, carved from one workspace in this order (rows:
// the mma.sync band kernel's partials of the LN row sums; db1 holds a partial a
// band, or a warp of a band on the Hopper route).
struct BwdLayout {
  size_t stats, y, gact, dh, dy, rows, db1, db2, dls, dlb, w1, w2, total;
  int chunks, per_chunk;
  BwdLayout(int batch, int l, int k, int d) {
    const int bands = d / BWD_BAND;
    per_chunk = (batch + MAX_CHUNKS - 1) / MAX_CHUNKS;
    chunks = (batch + per_chunk - 1) / per_chunk;
    const size_t bl = (size_t)batch * l, bk = (size_t)batch * k;
    size_t at = 0;
    auto take = [&](size_t bytes) { size_t here = at; at += align256(bytes); return here; };
    stats = take(bl * 2 * 4);
    y = take(bl * d * 2);
    gact = take(bk * d * 2);
    dh = take(bk * d * 2);
    dy = take(bl * d * 4);
    rows = take(bl * bands * 2 * 4);
    db1 = take(bk * bands * 4 * 4);
    db2 = take(bl * bands * 4);
    dls = take((size_t)batch * d * 4);
    dlb = take((size_t)batch * d * 4);
    w1 = take((size_t)chunks * l * k * 4);
    w2 = take((size_t)chunks * k * l * 4);
    total = at;
  }
};

inline bool geometry_ok(int l, int k, int d) {
  return l >= 1 && k >= 1 && d % FWD_BAND == 0
         && fwd_smem(l, k) <= 232448 && bwd_smem(l, k) <= 232448;
}

}  // namespace mix
}  // namespace sav

extern "C" int sav_mixer_fwd_smem(int l, int k) {
  return (int)sav::mix::fwd_smem(l, k);
}

extern "C" int sav_mixer_bwd_smem(int l, int k) {
  return (int)sav::mix::bwd_smem(l, k);
}

extern "C" long long sav_mixer_bwd_workspace(int batch, int l, int k, int d) {
  return (long long)sav::mix::BwdLayout(batch, l, k, d).total;
}

// K8b's launch plan on `sms` SMs: out[0] the band work's route (2: the
// Hopper kernel at <200, 112>, 1: at <56, 32>, both with the LN pass; 0:
// the mma.sync band kernel and finish pass), [1] its token width LN and [2] hidden width KP (0 on route 0),
// [3] (image, band) units, [4] blocks, [5] units of the busiest warpgroup
// (route 0: 1), [6] the band kernel's dynamic shared memory, [7] dW GEMM
// image chunks, [8] images a chunk, [9] workspace bytes. Returns 0, or
// cudaErrorInvalidValue where sav_mixer_bwd refuses the geometry.
// Mirrored by mixer_bwd_plan in ops/mixer_token.py.
extern "C" int sav_mixer_bwd_plan(int batch, int l, int k, int d, int sms,
                                  long long* out) {
  using namespace sav::mix;
  namespace mb = sav::mixb;
  if (!geometry_ok(l, k, d) || batch < 1) return (int)cudaErrorInvalidValue;
  const BwdLayout lay(batch, l, k, d);
  const int route = mb::route_of(l, k, d);
  const long long units = (long long)batch * (d / BWD_BAND);
  out[0] = route;
  out[1] = route == 2 ? 200 : route == 1 ? 56 : 0;
  out[2] = route == 2 ? 112 : route == 1 ? 32 : 0;
  out[3] = units;
  if (route == 0) {
    out[4] = units;
    out[5] = 1;
    out[6] = (long long)bwd_smem(l, k);
  } else {
    const int grid = mb::grid_for((int)units, sms);
    out[4] = grid;
    out[5] = (units + 2LL * grid - 1) / (2LL * grid);
    out[6] = route == 2 ? mb::Geo<200, 112>::SMEM : mb::Geo<56, 32>::SMEM;
  }
  out[7] = lay.chunks;
  out[8] = lay.per_chunk;
  out[9] = (long long)lay.total;
  return 0;
}

// K8a's launch plan on `sms` SMs: out[0] the band work's route (2: the
// Hopper forward band kernel at <200, 112>, 1: at <56, 32>; 0: the
// mma.sync block per (128-channel band, image)), [1] its token width LN
// and [2] hidden width KP (0 on route 0), [3] units ((image, 64-channel
// band) pairs; route 0: (image, 128-channel band)), [4] blocks, [5] units
// of the busiest warpgroup (route 0: 1), [6] the band kernel's dynamic
// shared memory. Returns 0, or cudaErrorInvalidValue where sav_mixer_fwd
// refuses the geometry. Mirrored by mixer_fwd_plan in ops/mixer_token.py.
extern "C" int sav_mixer_fwd_plan(int batch, int l, int k, int d, int sms,
                                  long long* out) {
  using namespace sav::mix;
  namespace mb = sav::mixb;
  if (!geometry_ok(l, k, d) || batch < 1) return (int)cudaErrorInvalidValue;
  const int route = mb::route_of(l, k, d);
  out[0] = route;
  out[1] = route == 2 ? 200 : route == 1 ? 56 : 0;
  out[2] = route == 2 ? 112 : route == 1 ? 32 : 0;
  if (route == 0) {
    out[3] = out[4] = (long long)batch * (d / FWD_BAND);
    out[5] = 1;
    out[6] = (long long)fwd_smem(l, k);
  } else {
    const long long units = (long long)batch * (d / mb::BAND);
    const int grid = mb::grid_for((int)units, sms);
    out[3] = units;
    out[4] = grid;
    out[5] = (units + 2LL * grid - 1) / (2LL * grid);
    out[6] = route == 2 ? mb::FwdGeo<200, 112>::SMEM : mb::FwdGeo<56, 32>::SMEM;
  }
  return 0;
}

// K8a. x, out [B, L, D] bf16; ln_scale/ln_bias [D], b1 [K], b2 [L] f32;
// w1 [L, K], w2 [K, L] bf16; stats [B*L, 2] f32 scratch. Two launches: the
// row statistics, then the band work (route as sav_mixer_fwd_plan).
extern "C" int sav_mixer_fwd(const void* x, const float* ln_scale,
                             const float* ln_bias, const void* w1,
                             const float* b1, const void* w2, const float* b2,
                             float* stats, void* out, int batch, int l, int k,
                             int d, float eps, void* stream) {
  using namespace sav;
  using namespace sav::mix;
  namespace mb = sav::mixb;
  cudaStream_t st = (cudaStream_t)stream;
  if (!geometry_ok(l, k, d) || batch < 1) return (int)cudaErrorInvalidValue;
  const int rows = batch * l;
  mixer_stats_kernel<<<(rows + 7) / 8, 256, 0, st>>>((const bf16*)x, stats,
                                                     rows, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int route = mb::route_of(l, k, d);
  if (route != 0) {
    const mb::FwdArgs a = {stats, ln_scale, ln_bias, (const bf16*)w1, b1,
                           (const bf16*)w2, b2, batch, l, k, d};
    return (int)(route == 2
                     ? mb::fwd_launch<200, 112>((const bf16*)x, (bf16*)out, a, st)
                     : mb::fwd_launch<56, 32>((const bf16*)x, (bf16*)out, a, st));
  }
  const size_t smem = fwd_smem(l, k);
  err = cudaFuncSetAttribute(mixer_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  mixer_fwd_kernel<<<dim3(d / FWD_BAND, batch), 256, smem, st>>>(
      (const bf16*)x, stats, ln_scale, ln_bias, (const bf16*)w1, b1,
      (const bf16*)w2, b2, (bf16*)out, l, k, d);
  return (int)cudaGetLastError();
}

// K8b. x, dout, dx [B, L, D] bf16; parameters as K8a; gradients dls, dlb
// [D], dw1 [L, K], db1 [K], dw2 [K, L], db2 [L] f32; ws the workspace of
// sav_mixer_bwd_workspace bytes.
extern "C" int sav_mixer_bwd(const void* x, const void* dout,
                             const float* ln_scale, const float* ln_bias,
                             const void* w1, const float* b1, const void* w2,
                             void* dx, float* dls, float* dlb, float* dw1,
                             float* db1, float* dw2, float* db2, void* ws,
                             int batch, int l, int k, int d, float eps,
                             void* stream) {
  using namespace sav;
  using namespace sav::mix;
  cudaStream_t st = (cudaStream_t)stream;
  if (!geometry_ok(l, k, d) || batch < 1) return (int)cudaErrorInvalidValue;
  const BwdLayout lay(batch, l, k, d);
  unsigned char* w = (unsigned char*)ws;
  float* stats = (float*)(w + lay.stats);
  BwdOut o;
  o.y = (bf16*)(w + lay.y);
  o.gact = (bf16*)(w + lay.gact);
  o.dh = (bf16*)(w + lay.dh);
  o.dy = (float*)(w + lay.dy);
  o.rows = (float*)(w + lay.rows);
  o.db1 = (float*)(w + lay.db1);
  o.db2 = (float*)(w + lay.db2);
  o.dls = (float*)(w + lay.dls);
  o.dlb = (float*)(w + lay.dlb);
  float* pw1 = (float*)(w + lay.w1);
  float* pw2 = (float*)(w + lay.w2);
  const int bands = d / BWD_BAND, rows = batch * l;

  cudaError_t err = cudaSuccess;
  mixer_stats_kernel<<<(rows + 7) / 8, 256, 0, st>>>((const bf16*)x, stats,
                                                     rows, d, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int route = sav::mixb::route_of(l, k, d);
  if (route != 0) {
    sav::mixb::Args a = {(const bf16*)x, (const bf16*)dout, stats, ln_scale,
                         ln_bias, (const bf16*)w1, b1, (const bf16*)w2, o.y,
                         o.gact, o.dh, o.dy, o.db1, o.db2, o.dls, o.dlb,
                         batch, l, k, d};
    err = route == 2 ? sav::mixb::launch<200, 112>(a, st)
                     : sav::mixb::launch<56, 32>(a, st);
    if (err == cudaSuccess)
      err = sav::mixb::ln_bwd((const bf16*)x, (const bf16*)dout, stats,
                              ln_scale, o.dy, (bf16*)dx, rows, d, st);
    if (err != cudaSuccess) return (int)err;
  } else {
    const size_t smem = bwd_smem(l, k);
    err = cudaFuncSetAttribute(mixer_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    mixer_bwd_kernel<<<dim3(bands, batch), 256, smem, st>>>(
        (const bf16*)x, (const bf16*)dout, stats, ln_scale, ln_bias,
        (const bf16*)w1, b1, (const bf16*)w2, o, l, k, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    mixer_finish_kernel<<<(rows + 7) / 8, 256, 0, st>>>(
        (const bf16*)x, (const bf16*)dout, stats, ln_scale, o.dy, o.rows,
        (bf16*)dx, batch, l, d, bands);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  if (route != 0) {
    // dW1 and dW2 (transposed partials) on the wgmma GEMM
    const sav::mixb::DwArgs da = {batch, l, k, d, lay.chunks, lay.per_chunk,
                                  pw1, pw2};
    if ((err = sav::mixb::dw_launch(o.y, o.dh, (const bf16*)dout, o.gact, da,
                                    st)) != cudaSuccess)
      return (int)err;
  } else {
    // dW2[k, l] = sum over images and channels of gact[k, c] do[l, c]
    ff::GemmArgs g = {};
    g.A = o.gact; g.B = (const bf16*)dout; g.M = k; g.N = l; g.Kc = d;
    g.lda = d; g.ldb = d; g.sa = (long long)k * d; g.sb = (long long)l * d;
    g.nbatch = batch; g.per_chunk = lay.per_chunk;
    g.cf = pw2; g.ldc = l; g.sc = (long long)k * l;
    if ((err = ff::gemm_launch<false, true, ff::kF32>(g, lay.chunks, st))
        != cudaSuccess)
      return (int)err;
    // dW1[l, k] = sum of y[l, c] bf16(dhp)[k, c]
    g.A = o.y; g.B = o.dh; g.M = l; g.N = k;
    g.sa = (long long)l * d; g.sb = (long long)k * d;
    g.cf = pw1; g.ldc = k; g.sc = (long long)l * k;
    if ((err = ff::gemm_launch<false, true, ff::kF32>(g, lay.chunks, st))
        != cudaSuccess)
      return (int)err;
  }

  // every partial summed in a fixed order
  namespace mb = sav::mixb;
  const long long lk = (long long)l * k;
  const int db1_parts = batch * bands * (route != 0 ? 4 : 1);
  if ((err = ff::sum_launch(pw1, lay.chunks, lk, l * k, dw1, st)) != cudaSuccess ||
      (err = ff::sum_launch(pw2, lay.chunks, lk, l * k, dw2, st)) != cudaSuccess ||
      (err = mb::sum_columns_launch(o.db1, db1_parts, k, k, db1, st))
          != cudaSuccess ||
      (err = mb::sum_columns_launch(o.db2, batch * bands, l, l, db2, st))
          != cudaSuccess ||
      (err = ff::sum_launch(o.dls, batch, d, d, dls, st)) != cudaSuccess ||
      (err = ff::sum_launch(o.dlb, batch, d, d, dlb, st)) != cudaSuccess)
    return (int)err;
  return 0;
}
