// K7 port: one whole TNT inner layer, forward (K7a) and backward (K7b), on
// the model's own [B*P, 16, D] layout.
//
// Replaces sav_tpu/ops/tnt_inner.py::_fwd_kernel (K7a, launcher _forward)
// and ::_bwd_kernel (K7b, launcher _inner_bwd). Per patch of 16 pixel
// tokens, with x [16, D] bf16, H heads of hd = D / H, FF width F:
//   y  = bf16(LN1(x))                     (f32 statistics, fast variance)
//   q  = (y Wq) / sqrt(hd), k = y Wk, v = y Wv        all f32
//   o  = softmax(q_h k_h^T) v_h per head              f32, scalar FMAs
//   x2 = x + bf16(o) Wo                               f32, not rounded
//   hp = bf16(LN2(x2)) W1 + b1,  gact = gelu(hp)      f32 (tanh form)
//   out = bf16(x2 + bf16(gact) W2 + b2)
// rounding where the TPU kernel rounds; weights bf16, LN parameters and
// biases f32. K7b recomputes all of it from x (the only saved residual)
// and returns dx (bf16) and the 12 parameter gradients (f32). Both read
// the parameters as the model holds them (f32, checkpoint layout) and
// cast the weights to bf16 as each block stages them.
//
// Bound on the card: at TNT-S (D = 24, F = 96, H = 4) a patch is 16 x 24
// bf16 in and out (1.5 KB) against 0.22 MFLOP of products and 25 kFLOP of
// f32 attention; at B*P = 32 x 196 that is 2.9 us of device-memory bytes
// and 3.7 us of operations (1.4 us of bf16 products at the tensor-core
// peak, 2.3 us of f32 attention at the CUDA-core peak), so the layer is
// bound by operations, at a few microseconds. The products' operand
// widths (24-160) are far below a wgmma tile and the attention below any
// tensor-core shape, so issue and latency, not either roofline, set the
// kernels' times.
//
// Design of K7a at TNT-S's and TNT-B's widths (hop::tnt_fwd_sm90_kernel,
// route 1 of plan_fwd):
//  * Persistent consumer warpgroups, 4 a block at TNT-S and 3 at TNT-B
//    (their registers; TNT-B's shared memory), each walking units of 4
//    patches: 64 rows, one m64 wgmma tile, warp w holding patch w. x
//    arrives by TMA into two tiles a warpgroup (the next units' loads
//    under this one's work); out is staged over the unit's q, k, v rows
//    and stored by TMA, which also masks the last unit's patches past
//    B*P (neither read nor written).
//  * Every product is one wgmma chain with A in registers and the
//    block's weights as K-major 128-byte-swizzled B tiles: QKV (n = 3
//    Dp), Wo (n = Dp), W1 (n = F), W2 (n = Dp, k = F). y and y2 come from
//    the accumulator layout (a row lies in one quad: the LN statistics
//    are quad shuffles), bf16(o) by ldmatrix from the warp's o tile, x2
//    stays in registers, gelu(hp) is packed from W1's accumulators as
//    W2's A operand (its tanh by tanh.approx, ~2^-11, under the bf16
//    rounding that follows).
//  * The attention stays f32 on the CUDA cores, warp-local: q, k, v in
//    shared memory at the row stride D + 2 (a head's 16 query rows in 16
//    banks), a lane taking query rows r and r + 8 of one head, so each k
//    and v row it reads feeds both; p by ex2.approx.
//  * The block fetches the f32 parameters by 4-byte cp.async into the
//    warpgroups' work regions, then converts them (8 channels a 16-byte
//    store), while the first units' x tiles arrive.
// Design of K7b, and of K7a at any other width supported() takes
// (tnt_fwd_kernel<0, 0, 0>, route 0):
//  * One warp owns one patch: its 16 rows are exactly one m16 tile of
//    mma.sync m16n8k16, so every product of the layer (QKV, Wo, W1, W2 and
//    their transposes in the backward) is a warp-local row of tiles whose
//    A operand sits in the warp's shared memory. The weights sit once per
//    block in shared memory, zero-padded from D to Dp = 16-multiple (24 ->
//    32, 40 -> 48) along every axis that is a contraction or a 16-wide
//    fragment, so padded channels contribute exact zeros and are never
//    stored. Blocks are persistent, so the weights are loaded once per
//    block and the last patch needs no padding (patches past B*P are never
//    touched).
//  * K7b is instantiated for TNT-S's and TNT-B's inner widths (constant
//    loop bounds and index arithmetic) and, as K7a's route 0, once with
//    the widths read at run time, for any other shape supported() takes.
//  * The attention is 16 x 16 x hd per (patch, head) with hd = 6 or 10:
//    below any tensor-core shape, so each lane takes (query row, head)
//    pairs with scalar f32 FMAs over registers holding one logit row.
//  * K7b: the weight gradients are products contracting over the patch
//    rows (dW = A^T B). The TPU carries them in one f32 scratch across its
//    sequential grid; here each block holds one f32 partial of all four
//    (4 D^2 + 2 D F floats: 27.6 KB at TNT-S, 76.8 KB at TNT-B) in shared
//    memory beside the weights. The block's warps take patches in rounds,
//    one patch a warp, in step; at product points of a round the block
//    meets at a barrier and its warps multiply the round's operands, which
//    each warp holds in its own shared memory, into the partial: mma.sync
//    over the round's patches in warp order, each 16 x 16 tile of a
//    gradient owned by one warp, so no two threads add to one element. The
//    points: each 16-column tile of F (gelu and bf16(dhp) tiles, double-
//    buffered, so one barrier a tile; dy2 accumulates in registers), then
//    after dO (dWo), then after dq|dk|dv (dWqkv), each followed by a
//    barrier that frees the operands. The LN and bias gradients are
//    per-lane column sums kept by each warp. At the end each block writes
//    its partial once and the partials are summed in a fixed order: no
//    operand rows in device memory, no float atomics, identical bits on
//    every call on one card.
//  * K7b's working set a warp is small so that more warps share an SM (10
//    at TNT-S, 4 at TNT-B): the FF operands a 16-column tile at a time,
//    and in the attention backward only each query row's max, sum and
//    delta (pass 2 forms a, da and ds again, flash-style, from q, k, v and
//    dO). Its f32 row buffers have the row stride D + 2, twice an odd
//    number, so the attention's lanes, one a query row, read 16 different
//    banks, and a head's columns load as float2.
#include "ff_common.cuh"
#include "sm90.cuh"

namespace sav {
namespace tnt {

using namespace sav::ff;

constexpr int L = 16;            // pixel tokens per patch: one m16 tile
constexpr int MAX_WARPS = 8;     // the warp-a-patch K7a's warps a block
constexpr int BWD_MAX_WARPS = 12;  // K7b's
constexpr int LDT = 24;          // bf16 row stride of K7b's [16][16] FF tiles
constexpr int MAX_HD = 128;      // the widest head the kernels take
constexpr int MAX_NT = 4;        // K7b's dy2 accumulator: Dp <= 64
constexpr int SMEM_CAP = 232448;
constexpr unsigned FULL = 0xffffffffu;

struct Geo {
  int d, f, h, hd;
  int dp;      // D padded to a multiple of 16
  int ldy;     // bf16 row stride of [16][Dp] operands and of Wo, W2
  int ldq;     // bf16 row stride of Wqkv: 3 Dp + 8
  int ldf;     // bf16 row stride of W1 and [16][F] operands: F + 8
  int lf;      // f32 row stride of the backward's [16][D] buffers: D + 2
  int nvec;    // LN parameters and biases: 5 D + F
  int total;   // weight-gradient floats: 4 D^2 + 2 D F
};

__host__ __device__ inline Geo geo(int d, int f, int h) {
  Geo g;
  g.d = d; g.f = f; g.h = h; g.hd = d / h;
  g.dp = (d + 15) / 16 * 16;
  g.ldy = g.dp + 8;
  g.ldq = 3 * g.dp + 8;
  g.ldf = f + 8;
  g.lf = d + 2;
  g.nvec = 5 * d + f;
  g.total = 4 * d * d + 2 * d * f;
  return g;
}

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) / 16 * 16; }

// Block-shared part: Wqkv [Dp][ldq], Wo [Dp][ldy], W1 [Dp][ldf], W2 [F][ldy]
// (bf16, zero-padded), then the f32 vector parameters.
__host__ __device__ inline size_t weight_bytes(const Geo& g) {
  return up16((size_t)2 * (g.dp * g.ldq + g.dp * g.ldy + g.dp * g.ldf
                           + g.f * g.ldy))
         + up16((size_t)4 * g.nvec);
}

// Per warp, K7a: x/x2 f32 [16][D], y and o bf16 [16][ldy], the row
// statistics [16][2], and one region holding q, k, v f32 [16][Dp] until
// the attention is done, then gelu bf16 [16][ldf].
__host__ __device__ inline size_t fwd_region(const Geo& g) {
  const size_t qkv = (size_t)3 * L * g.dp * 4, gact = (size_t)L * g.ldf * 2;
  return up16(qkv > gact ? qkv : gact);
}

__host__ __device__ inline size_t fwd_warp_bytes(const Geo& g) {
  return up16((size_t)L * g.d * 4) + 2 * up16((size_t)L * g.ldy * 2) + 128
         + fwd_region(g);
}

// K7b's block-shared part past the weights: the block's f32 partial of the
// four weight gradients, laid out as the output (dWqkv [D][3D], dWo
// [D][D], dW1 [D][F], dW2 [F][D]).
__host__ __device__ inline size_t part_bytes(const Geo& g) {
  return up16((size_t)4 * g.total);
}

// Per warp, K7b, in this order: x bf16 [16][D]; x2 (then dx2), q, k, v
// and a scratch T f32 [16][lf]; y, o and do bf16 [16][ldy] (in the
// attention backward: dq, dk and dv); one region; the row statistics
// [2][16][2]; the column sums of the LN and bias gradients [nvec]. The
// region holds in turn, in the resident layout, gelu and bf16(dhp) bf16
// [16][ldf] (all of F), the softmax rows and ds f32 [2][H][16][16] (key k
// of row r at k ^ r: pass 1's lanes, one a row, and pass 2's, one a key,
// hit distinct banks), and y
// again; in the F-tiled layout two pairs of 16-column FF tiles (gelu and
// bf16(dhp), bf16 [16][LDT]), the softmax statistics of each (head, query
// row) (max, sum, delta) f32 [H][16][4], and y again.
struct BwdOff {
  size_t x, x2, q, k, v, t, y, o, dob, region, stat, vec, bytes;
};

constexpr size_t TILE_BYTES = (size_t)L * LDT * 2;   // one [16][LDT] tile

__host__ __device__ inline size_t bwd_region(const Geo& g, bool tiled) {
  const size_t ff = tiled ? 4 * TILE_BYTES
                          : 2 * up16((size_t)L * g.ldf * 2);
  const size_t at = tiled ? (size_t)g.h * L * 4 * 4
                          : up16((size_t)2 * g.h * L * L * 4);
  const size_t y = up16((size_t)L * g.ldy * 2);
  const size_t m = ff > at ? ff : at;
  return m > y ? m : y;
}

__host__ __device__ inline BwdOff bwd_off(const Geo& g, bool tiled) {
  BwdOff o;
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t here = at;
    at += up16(bytes);
    return here;
  };
  const size_t f32row = (size_t)L * g.lf * 4, bfrow = (size_t)L * g.ldy * 2;
  o.x = take((size_t)L * g.d * 2);
  o.x2 = take(f32row);
  o.q = take(f32row);
  o.k = take(f32row);
  o.v = take(f32row);
  o.t = take(f32row);
  o.y = take(bfrow);
  o.o = take(bfrow);
  o.dob = take(bfrow);
  o.region = take(bwd_region(g, tiled));
  o.stat = take(4 * L * 4);
  o.vec = take((size_t)4 * g.nvec);
  o.bytes = at;
  return o;
}

__host__ __device__ inline size_t bwd_warp_bytes(const Geo& g, bool tiled) {
  return bwd_off(g, tiled).bytes;
}

// Warps per block (at most `most`) whose shared memory fits one block, or
// 0.
__host__ __device__ inline int warps_for(size_t per_warp, size_t shared,
                                         int most = MAX_WARPS) {
  if (shared + per_warp > (size_t)SMEM_CAP) return 0;
  const size_t w = ((size_t)SMEM_CAP - shared) / per_warp;
  return w > (size_t)most ? most : (int)w;
}

// K7b's layout at D, F, H: the resident one (all of F's FF operands and
// the attention's softmax rows kept a patch) wherever it leaves a block at
// least MIN_RESIDENT warps; else the F-tiled one (16 columns of F at a
// time, one barrier each, and the attention's pass 2 forming a, da and ds
// again from each row's statistics), which a warp needs less of. Measured
// on an H100 80GB HBM3 (700 W): TNT-S resident 8 warps 0.36 ms against
// tiled 10 warps 0.40; TNT-B resident 3 warps 0.70 against tiled 4 warps
// 0.60.
constexpr int MIN_RESIDENT = 4;

__host__ __device__ inline int bwd_warps(const Geo& g, bool tiled) {
  if ((tiled && g.dp > 16 * MAX_NT) || g.hd > MAX_HD) return 0;
  return warps_for(bwd_warp_bytes(g, tiled), weight_bytes(g) + part_bytes(g),
                   BWD_MAX_WARPS);
}

__host__ __device__ inline int fwd_warps(const Geo& g) {
  return g.hd > MAX_HD ? 0 : warps_for(fwd_warp_bytes(g), weight_bytes(g));
}

__host__ __device__ inline bool bwd_tiled(const Geo& g) {
  return bwd_warps(g, false) < MIN_RESIDENT && bwd_warps(g, true) > 0;
}

// ----------------------------------------------------------- warp pieces

// out[16][N] = A[16][K] B with A stored [m][k] (row stride lda) and B
// stored [k][n] (kTB false) or [n][k] (kTB true); N, K multiples of 16.
// epi(row, col, v0, v1) gets columns col and col + 1 of row, each once.
template <bool kTB, typename Epi>
__device__ __forceinline__ void warp_mma(const bf16* a, int lda, const bf16* b,
                                         int ldb, int N, int K, int lane,
                                         Epi epi) {
  const int g = lane >> 2, t = lane & 3;
  for (int n0 = 0; n0 < N; n0 += 16) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t af[4], bfr[4];
      load_a(af, a, lda, 0, k0, lane);
      load_b_any<kTB>(bfr, b, ldb, k0, n0, lane);
      mma_16816(acc[0], af, bfr[0], bfr[1]);
      mma_16816(acc[1], af, bfr[2], bfr[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      epi(g, col, acc[j][0], acc[j][1]);
      epi(g + 8, col, acc[j][2], acc[j][3]);
    }
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// y = bf16(LN(x)) over the D columns of x [16][ldx] (f32 or bf16), zeros
// in columns D .. Dp - 1; two lanes per row. stat[2r], stat[2r + 1] = mu,
// 1/sigma.
template <typename T>
__device__ __forceinline__ void
ln_rows(const T* x, int ldx, const float* s, const float* b, bf16* y,
        float* stat, const Geo& g, float eps, int lane) {
  const int r = lane >> 1, half = lane & 1;
  float sum = 0.f, sq = 0.f;
  for (int c = half; c < g.d; c += 2) {
    const float v = to_f(x[r * ldx + c]);
    sum += v;
    sq += v * v;
  }
  sum += __shfl_xor_sync(FULL, sum, 1);
  sq += __shfl_xor_sync(FULL, sq, 1);
  const float mu = sum / g.d;
  const float inv = rsqrtf(fmaxf(sq / g.d - mu * mu, 0.f) + eps);
  for (int c = half; c < g.dp; c += 2)
    y[r * g.ldy + c] = __float2bfloat16(
        c < g.d ? (to_f(x[r * ldx + c]) - mu) * inv * s[c] + b[c] : 0.f);
  if (half == 0) {
    stat[2 * r] = mu;
    stat[2 * r + 1] = inv;
  }
}

// The logit of query row r and key row p over the head's columns c0..: q
// and k f32 with row stride ld.
__device__ __forceinline__ float logit(const float* q, const float* k,
                                       const Geo& g, int ld, int r, int p,
                                       int c0) {
  float acc = 0.f;
  if (g.hd % 2 == 0) {                     // ld and c0 even: float2 loads
    const float2* q2 = reinterpret_cast<const float2*>(q + r * ld + c0);
    const float2* k2 = reinterpret_cast<const float2*>(k + p * ld + c0);
    for (int c = 0; c < g.hd / 2; ++c) {
      const float2 a = q2[c], b = k2[c];
      acc += a.x * b.x;
      acc += a.y * b.y;
    }
  } else {
    for (int c = 0; c < g.hd; ++c)
      acc += q[r * ld + c0 + c] * k[p * ld + c0 + c];
  }
  return acc;
}

// out[c] += w row[c] for c < hd (row 8-byte aligned where hd is even:
// float2 loads).
template <int HD>
__device__ __forceinline__ void axpy_row(float (&out)[HD], float w,
                                         const float* row, const Geo& g) {
  if (g.hd % 2 == 0) {
    const float2* r2 = reinterpret_cast<const float2*>(row);
    for (int c = 0; c < g.hd / 2; ++c) {
      const float2 v = r2[c];
      out[2 * c] += w * v.x;
      out[2 * c + 1] += w * v.y;
    }
  } else {
    for (int c = 0; c < g.hd; ++c) out[c] += w * row[c];
  }
}

// out[c] = sum over the 16 rows p of w[p] m[p][c0 + c] for c < hd (m f32
// with row stride ld; ld and c0 even where hd is), each column's sum in
// row order; the row loop unrolled U times.
template <int HD, int U>
__device__ __forceinline__ void weighted_rows(const float* w, const float* m,
                                             const Geo& g, int ld, int c0,
                                             float (&out)[HD]) {
  for (int c = 0; c < g.hd; ++c) out[c] = 0.f;
#pragma unroll U
  for (int p = 0; p < L; ++p) axpy_row(out, w[p], m + p * ld + c0, g);
}

// The head width a kernel instantiation holds in registers: its own, or
// MAX_HD (the widest the kernels take) where it reads the widths at run
// time.
template <int kD, int kH>
__host__ __device__ constexpr int head_regs() { return kD ? kD / kH : MAX_HD; }

// How far an instantiation unrolls its loops over a patch's 16 rows: fully
// where the widths are built in; not at all where it reads them at run
// time (that instantiation takes the shapes no config has, and unrolled it
// took most of the library's build).
template <int kD>
__host__ __device__ constexpr int row_unroll() { return kD ? L : 1; }

// One logit row of query r, head hh: s[p] = q[r] . k[p] over the head's
// columns, then the softmax in place (a = e / sum e, as the TPU kernel);
// q and k f32 with row stride ld. *mx and *sum get the row's max and the
// sum of its exponentials.
template <int U>
__device__ __forceinline__ void softmax_row(const float* q, const float* k,
                                            const Geo& g, int ld, int r,
                                            int c0, float* s,
                                            float* mx = nullptr,
                                            float* sum = nullptr) {
  float m = -INFINITY;
#pragma unroll U
  for (int p = 0; p < L; ++p) {
    s[p] = logit(q, k, g, ld, r, p, c0);
    m = fmaxf(m, s[p]);
  }
  float l = 0.f;
#pragma unroll U
  for (int p = 0; p < L; ++p) {
    s[p] = expf(s[p] - m);
    l += s[p];
  }
#pragma unroll U
  for (int p = 0; p < L; ++p) s[p] = s[p] / l;
  if (mx) {
    *mx = m;
    *sum = l;
  }
}

// o = bf16(softmax(q k^T) v) per head into [16][ldy], zeros past D; q, k,
// v f32 with row stride ld.
template <int HD, int U>
__device__ __forceinline__ void
attention_fwd(const float* q, const float* k, const float* v, bf16* o,
              const Geo& g, int ld, int lane) {
  for (int pr = lane; pr < L * g.h; pr += 32) {
    const int r = pr & (L - 1), c0 = (pr / L) * g.hd;
    float s[L], acc[HD];
    softmax_row<U>(q, k, g, ld, r, c0, s);
    weighted_rows<HD, U>(s, v, g, ld, c0, acc);
    for (int c = 0; c < g.hd; ++c)
      o[r * g.ldy + c0 + c] = __float2bfloat16(acc[c]);
  }
  const int pad = g.dp - g.d;
  for (int i = lane; i < L * pad; i += 32)
    o[(i / pad) * g.ldy + g.d + i % pad] = __float2bfloat16(0.f);
}

// The inner layer's parameters as the model holds them: f32 in checkpoint
// layout (wq, wk, wv [D, H, hd] = [D][D]; wo [H, hd, D] = [D][D]; w1 [D][F];
// w2 [F][D]; the LayerNorm scales and biases, b1 and b2 as vectors). The
// kernels cast the weights to bf16 (round to nearest even, the bits of
// torch's .to(bfloat16)) as each block stages them.
struct Params {
  const float *ln1s, *ln1b, *wq, *wk, *wv, *wo, *ln2s, *ln2b, *w1, *b1,
      *w2, *b2;
};

// The block's weights into shared memory, zero-padded: Wqkv [Dp][ldq]
// (Wq | Wk | Wv, Dp columns each), Wo [Dp][ldy], W1 [Dp][ldf], W2 [F][ldy]
// in bf16; ln1s, ln1b, ln2s, ln2b, b2 [D] and b1 [F] in f32.
__device__ __forceinline__ void load_weights(const Params& p, const Geo& g,
                                             bf16* sWqkv, bf16* sWo,
                                             bf16* sW1, bf16* sW2,
                                             float* sPar) {
  const bf16 zero = __float2bfloat16(0.f);
  const int d = g.d, dp = g.dp, f = g.f;
  for (int i = threadIdx.x; i < dp * 3 * dp; i += blockDim.x) {
    const int r = i / (3 * dp), c = i % (3 * dp), sec = c / dp, cc = c % dp;
    const float* w = sec == 0 ? p.wq : (sec == 1 ? p.wk : p.wv);
    sWqkv[r * g.ldq + c] =
        (r < d && cc < d) ? __float2bfloat16(w[r * d + cc]) : zero;
  }
  for (int i = threadIdx.x; i < dp * dp; i += blockDim.x) {
    const int r = i / dp, c = i % dp;
    sWo[r * g.ldy + c] =
        (r < d && c < d) ? __float2bfloat16(p.wo[r * d + c]) : zero;
  }
  for (int i = threadIdx.x; i < dp * f; i += blockDim.x) {
    const int r = i / f, c = i % f;
    sW1[r * g.ldf + c] = r < d ? __float2bfloat16(p.w1[r * f + c]) : zero;
  }
  for (int i = threadIdx.x; i < f * dp; i += blockDim.x) {
    const int r = i / dp, c = i % dp;
    sW2[r * g.ldy + c] = c < d ? __float2bfloat16(p.w2[r * d + c]) : zero;
  }
  const float* vecs[5] = {p.ln1s, p.ln1b, p.ln2s, p.ln2b, p.b2};
  for (int i = threadIdx.x; i < g.nvec; i += blockDim.x)
    sPar[i] = i < 5 * d ? vecs[i / d][i % d] : p.b1[i - 5 * d];
}

struct Shared {
  bf16 *wqkv, *wo, *w1, *w2;
  float* par;     // ln1s, ln1b, ln2s, ln2b, b2 [D] each, then b1 [F]
  unsigned char* warps;
};

__device__ inline Shared carve(unsigned char* smem, const Geo& g) {
  Shared s;
  s.wqkv = reinterpret_cast<bf16*>(smem);
  s.wo = s.wqkv + g.dp * g.ldq;
  s.w1 = s.wo + g.dp * g.ldy;
  s.w2 = s.w1 + g.dp * g.ldf;
  s.par = reinterpret_cast<float*>(
      smem + up16((size_t)2 * (g.dp * g.ldq + g.dp * g.ldy + g.dp * g.ldf
                               + g.f * g.ldy)));
  s.warps = smem + weight_bytes(g);
  return s;
}

// ------------------------------------------------------------------ K7a

// Both kernels are templates over (D, F, H): an instantiation with them
// built in (TNT-S's and TNT-B's inner layer) lets the compiler unroll the
// per-head loops and turn every index division into constant arithmetic;
// <0, 0, 0> reads them from its arguments and takes any supported shape.
template <int kD, int kF, int kH>
__global__ void __launch_bounds__(MAX_WARPS * 32)
tnt_fwd_kernel(const bf16* __restrict__ x, const Params prm,
               bf16* __restrict__ out, int n, int d, int f, int h, float eps,
               float q_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (kD) {
    d = kD;
    f = kF;
    h = kH;
  }
  const Geo g = geo(d, f, h);
  const Shared S = carve(smem_raw, g);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const float *ln1s = S.par, *ln1b = S.par + d, *ln2s = S.par + 2 * d,
              *ln2b = S.par + 3 * d, *b2 = S.par + 4 * d, *b1 = S.par + 5 * d;

  unsigned char* base = S.warps + (size_t)warp * fwd_warp_bytes(g);
  float* sX = reinterpret_cast<float*>(base);
  bf16* sY = reinterpret_cast<bf16*>(base + up16((size_t)L * d * 4));
  bf16* sO = sY + up16((size_t)L * g.ldy * 2) / 2;
  float* sStat = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(sO) + up16((size_t)L * g.ldy * 2));
  unsigned char* region = reinterpret_cast<unsigned char*>(sStat) + 128;
  float* sQ = reinterpret_cast<float*>(region);
  float* sK = sQ + L * g.dp;
  float* sV = sK + L * g.dp;
  bf16* sG = reinterpret_cast<bf16*>(region);

  load_weights(prm, g, S.wqkv, S.wo, S.w1, S.w2, S.par);
  __syncthreads();

  for (int p = blockIdx.x * nwarps + warp; p < n; p += gridDim.x * nwarps) {
    const bf16* xp = x + (size_t)p * L * d;
    for (int i = lane; i < L * d; i += 32) sX[i] = __bfloat162float(xp[i]);
    __syncwarp();
    ln_rows(sX, d, ln1s, ln1b, sY, sStat, g, eps, lane);
    __syncwarp();
    warp_mma<false>(sY, g.ldy, S.wqkv, g.ldq, 3 * g.dp, g.dp, lane,
                    [&](int r, int c, float v0, float v1) {
      const int sec = c / g.dp, cc = c - sec * g.dp;
      float* dst = sec == 0 ? sQ : (sec == 1 ? sK : sV);
      const float m = sec == 0 ? q_scale : 1.f;
      dst[r * g.dp + cc] = v0 * m;
      dst[r * g.dp + cc + 1] = v1 * m;
    });
    __syncwarp();
    attention_fwd<head_regs<kD, kH>(), row_unroll<kD>()>(sQ, sK, sV, sO, g,
                                                         g.dp, lane);
    __syncwarp();
    // x2 = x + bf16(o) Wo, kept in f32 (in place of x)
    warp_mma<false>(sO, g.ldy, S.wo, g.ldy, g.dp, g.dp, lane,
                    [&](int r, int c, float v0, float v1) {
      if (c < d) {
        sX[r * d + c] += v0;
        sX[r * d + c + 1] += v1;
      }
    });
    __syncwarp();
    ln_rows(sX, d, ln2s, ln2b, sY, sStat, g, eps, lane);
    __syncwarp();
    warp_mma<false>(sY, g.ldy, S.w1, g.ldf, f, g.dp, lane,
                    [&](int r, int c, float v0, float v1) {
      const float h0 = v0 + b1[c], h1 = v1 + b1[c + 1];
      *reinterpret_cast<uint32_t*>(sG + r * g.ldf + c) =
          pack_bf16(0.5f * h0 * (1.f + gelu_t(h0)),
                    0.5f * h1 * (1.f + gelu_t(h1)));
    });
    __syncwarp();
    bf16* op = out + (size_t)p * L * d;
    warp_mma<false>(sG, g.ldf, S.w2, g.ldy, g.dp, f, lane,
                    [&](int r, int c, float v0, float v1) {
      if (c < d)
        *reinterpret_cast<uint32_t*>(op + r * d + c) =
            pack_bf16(sX[r * d + c] + v0 + b2[c],
                      sX[r * d + c + 1] + v1 + b2[c + 1]);
    });
    __syncwarp();
  }
}

// ------------------------------------------------------------------ K7b

// LayerNorm backward of one patch from dy f32 [16][ldd] and the forward's
// input xin [16][ldx] (f32 or bf16) with its row statistics: the column
// sums of dy * xhat and dy into dscale/dbias (one lane per column, rows in
// order), then dx_ln = inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
// handed to emit(r, c, dx_ln) (two lanes per row; each element is read
// from xin by the lane that emits it, after every other read of xin, so
// emit may overwrite xin).
template <typename T, typename Emit>
__device__ __forceinline__ void
ln_bwd(const float* dy, int ldd, const T* xin, int ldx, const float* stat,
       const float* scale, float* dscale, float* dbias, const Geo& g,
       int lane, Emit emit) {
  for (int c = lane; c < g.d; c += 32) {
    float ds = 0.f, db = 0.f;
    for (int r = 0; r < L; ++r) {
      const float xh = (to_f(xin[r * ldx + c]) - stat[2 * r]) * stat[2 * r + 1];
      ds += dy[r * ldd + c] * xh;
      db += dy[r * ldd + c];
    }
    dscale[c] += ds;
    dbias[c] += db;
  }
  const int r = lane >> 1, half = lane & 1;
  const float mu = stat[2 * r], inv = stat[2 * r + 1];
  float m1 = 0.f, m2 = 0.f;
  for (int c = half; c < g.d; c += 2) {
    const float dxh = dy[r * ldd + c] * scale[c];
    m1 += dxh;
    m2 += dxh * (to_f(xin[r * ldx + c]) - mu) * inv;
  }
  m1 += __shfl_xor_sync(FULL, m1, 1);
  m2 += __shfl_xor_sync(FULL, m2, 1);
  m1 /= g.d;
  m2 /= g.d;
  __syncwarp();
  for (int c = half; c < g.d; c += 2) {
    const float xh = (to_f(xin[r * ldx + c]) - mu) * inv;
    const float dxh = dy[r * ldd + c] * scale[c];
    emit(r, c, inv * (dxh - m1 - xh * m2));
  }
}

// The FF products of one patch at the columns n0..n1 of F, 16 at a time:
// hp = y2 W1 + b1 and dgact = do W2^T, then gelu(hp) and dhp = dgact
// gelu'(hp) (f32) to bf16 [16][ldt] buffers at column n - c0 (the operands
// of dW2, dW1 and dy2), and dhp's column sums over the 16 rows (a fixed
// shuffle tree) into vb1.
__device__ __forceinline__ void
ff_cols(const bf16* sY, const bf16* sDo, const bf16* w1s, const bf16* w2s,
        const float* b1, int n0, int n1, int c0, bf16* tg, bf16* th, int ldt,
        float* vb1, const Geo& g, int lane) {
  const int gq = lane >> 2, t = lane & 3;
  for (int nb = n0; nb < n1; nb += 16) {
    float ah[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float ad[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < g.dp; k0 += 16) {
      uint32_t af[4], bfr[4];
      load_a(af, sY, g.ldy, 0, k0, lane);
      load_b(bfr, w1s, g.ldf, k0, nb, lane);
      mma_16816(ah[0], af, bfr[0], bfr[1]);
      mma_16816(ah[1], af, bfr[2], bfr[3]);
      load_a(af, sDo, g.ldy, 0, k0, lane);
      load_b_t(bfr, w2s, g.ldy, k0, nb, lane);
      mma_16816(ad[0], af, bfr[0], bfr[1]);
      mma_16816(ad[1], af, bfr[2], bfr[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = nb + 8 * j + 2 * t;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = gq + 8 * hf;
        const float h0 = ah[j][2 * hf] + b1[c];
        const float h1 = ah[j][2 * hf + 1] + b1[c + 1];
        const float t0 = gelu_t(h0), t1 = gelu_t(h1);
        const float d0 = ad[j][2 * hf] * gelu_bwd(h0, t0);
        const float d1 = ad[j][2 * hf + 1] * gelu_bwd(h1, t1);
        *reinterpret_cast<uint32_t*>(tg + r * ldt + c - c0) =
            pack_bf16(0.5f * h0 * (1.f + t0), 0.5f * h1 * (1.f + t1));
        *reinterpret_cast<uint32_t*>(th + r * ldt + c - c0) = pack_bf16(d0, d1);
        s0 += d0;
        s1 += d1;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(FULL, s0, off);
        s1 += __shfl_xor_sync(FULL, s1, off);
      }
      if (gq == 0) {
        vb1[c] += s0;
        vb1[c + 1] += s1;
      }
    }
  }
}

// A product point: dW[M][N] (+)= the sum over the round's nv patches of
// A_w^T B_w, with A_w [16][lda] at a0 + w stride and B_w [16][ldb] at b0 +
// w stride (warp w's operands). The block's warps take dW's 16 x 16 tiles
// in turn from warp `first` on, two at a time, each tile's products in two
// chains (even and odd patches, in warp order, then added: a fixed order)
// for the latency; every pair of sums (columns col, col + 1 of a row) goes
// once to add(row, col, v0, v1). Returns the tile count (the next point's
// `first` offset).
// p[0] += a, p[1] += b, as one float2 (p 8-byte aligned: an even element
// of a partial whose rows have an even length).
__device__ __forceinline__ void add2(float* p, float a, float b) {
  float2 v = *reinterpret_cast<float2*>(p);
  v.x += a;
  v.y += b;
  *reinterpret_cast<float2*>(p) = v;
}

template <typename Add>
__device__ __forceinline__ int
point(const unsigned char* a0, int lda, const unsigned char* b0, int ldb,
      size_t stride, int M, int N, int nv, int first, int warp, int nwarps,
      int lane, Add add) {
  const int gq = lane >> 2, t = lane & 3;
  const int nt = N / 16, tiles = (M / 16) * nt;
  for (int tile = ((warp - first) % nwarps + nwarps) % nwarps; tile < tiles;
       tile += 2 * nwarps) {
    const bool two = tile + nwarps < tiles;
    int m0[2], n0[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ti = tile + i * nwarps;
      m0[i] = (ti / nt) * 16;
      n0[i] = (ti % nt) * 16;
    }
    float acc[2][2][2][4] = {};          // [tile][chain][n8][4]
    for (int w = 0; w < nv; ++w) {
      const bf16* a = reinterpret_cast<const bf16*>(a0 + w * stride);
      const bf16* b = reinterpret_cast<const bf16*>(b0 + w * stride);
      const int ch = w & 1;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 1 && !two) break;
        uint32_t af[4], bfr[4];
        load_a_t(af, a, lda, m0[i], 0, lane);
        load_b(bfr, b, ldb, 0, n0[i], lane);
        if (ch == 0) {
          mma_16816(acc[i][0][0], af, bfr[0], bfr[1]);
          mma_16816(acc[i][0][1], af, bfr[2], bfr[3]);
        } else {
          mma_16816(acc[i][1][0], af, bfr[0], bfr[1]);
          mma_16816(acc[i][1][1], af, bfr[2], bfr[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i == 1 && !two) break;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n0[i] + 8 * j + 2 * t;
        const float* e = acc[i][0][j];
        const float* o = acc[i][1][j];
        add(m0[i] + gq, col, e[0] + o[0], e[1] + o[1]);
        add(m0[i] + gq + 8, col, e[2] + o[2], e[3] + o[3]);
      }
    }
  }
  return tiles;
}

template <int kD, int kF, int kH, bool kTiled>
__global__ void __launch_bounds__(BWD_MAX_WARPS * 32)
tnt_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gout,
               const Params prm, bf16* __restrict__ dx,
               float* __restrict__ part, int n, int d, int f, int h,
               float eps, float q_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (kD) {
    d = kD;
    f = kF;
    h = kH;
  }
  const Geo g = geo(d, f, h);
  const Shared S = carve(smem_raw, g);
  const BwdOff off = bwd_off(g, kTiled);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int dp = g.dp, lf = g.lf, ldy = g.ldy;
  const float *ln1s = S.par, *ln1b = S.par + d, *ln2s = S.par + 2 * d,
              *ln2b = S.par + 3 * d, *b1 = S.par + 5 * d;
  float* sPart = reinterpret_cast<float*>(S.warps);
  float *pqkv = sPart, *po = sPart + 3 * d * d, *p1 = sPart + 4 * d * d,
        *p2 = p1 + d * f;

  unsigned char* warps = S.warps + part_bytes(g);
  const size_t wb = off.bytes;
  unsigned char* mine = warps + (size_t)warp * wb;
  bf16* sX = reinterpret_cast<bf16*>(mine + off.x);
  float* sX2 = reinterpret_cast<float*>(mine + off.x2);
  float* sQ = reinterpret_cast<float*>(mine + off.q);
  float* sK = reinterpret_cast<float*>(mine + off.k);
  float* sV = reinterpret_cast<float*>(mine + off.v);
  float* sT = reinterpret_cast<float*>(mine + off.t);
  bf16* sY = reinterpret_cast<bf16*>(mine + off.y);
  bf16* sO = reinterpret_cast<bf16*>(mine + off.o);
  bf16* sDo = reinterpret_cast<bf16*>(mine + off.dob);
  // region (bwd_off): the FF operands; the attention backward's softmax
  // rows and ds (resident) or row statistics (F-tiled); y again for dWqkv
  bf16* sG = reinterpret_cast<bf16*>(mine + off.region);
  const size_t ff_half = kTiled ? TILE_BYTES : up16((size_t)L * g.ldf * 2);
  float* sA = reinterpret_cast<float*>(mine + off.region);
  float* sDs = sA + h * L * L;
  float4* sAt = reinterpret_cast<float4*>(mine + off.region);
  bf16* sY1 = reinterpret_cast<bf16*>(mine + off.region);
  float* sStat = reinterpret_cast<float*>(mine + off.stat);   // [2][16][2]
  float* sVec = reinterpret_cast<float*>(mine + off.vec);
  float *vln1s = sVec, *vln1b = sVec + d, *vln2s = sVec + 2 * d,
        *vln2b = sVec + 3 * d, *vb2 = sVec + 4 * d, *vb1 = sVec + 5 * d;

  load_weights(prm, g, S.wqkv, S.wo, S.w1, S.w2, S.par);
  for (int i = threadIdx.x; i < g.total; i += blockDim.x) sPart[i] = 0.f;
  for (int i = lane; i < g.nvec; i += 32) sVec[i] = 0.f;
  __syncthreads();

  const bf16 zero = __float2bfloat16(0.f);
  const int pad = dp - d;
  constexpr int HD = head_regs<kD, kH>(), U = row_unroll<kD>();
  for (int base = blockIdx.x * nwarps; base < n; base += gridDim.x * nwarps) {
    const int nv = min(nwarps, n - base);
    const bool mine_valid = warp < nv;
    const size_t row0 = (size_t)(base + warp) * L;
    if (mine_valid) {
      const bf16* xp = x + row0 * d;
      const bf16* gp = gout + row0 * d;
      for (int i = lane; i < L * d / 8; i += 32)
        reinterpret_cast<uint4*>(sX)[i] = reinterpret_cast<const uint4*>(xp)[i];
      for (int i = lane; i < L * dp; i += 32) {
        const int r = i / dp, c = i % dp;
        sDo[r * ldy + c] = c < d ? gp[r * d + c] : zero;
      }
      __syncwarp();

      // ---- recompute the forward
      ln_rows(sX, d, ln1s, ln1b, sY, sStat, g, eps, lane);
      __syncwarp();
      warp_mma<false>(sY, ldy, S.wqkv, g.ldq, 3 * dp, dp, lane,
                      [&](int r, int c, float v0, float v1) {
        const int sec = c / dp, cc = c - sec * dp;
        if (cc >= d) return;
        float* dst = sec == 0 ? sQ : (sec == 1 ? sK : sV);
        const float m = sec == 0 ? q_scale : 1.f;
        dst[r * lf + cc] = v0 * m;
        dst[r * lf + cc + 1] = v1 * m;
      });
      __syncwarp();
      attention_fwd<HD, U>(sQ, sK, sV, sO, g, lf, lane);
      __syncwarp();
      warp_mma<false>(sO, ldy, S.wo, ldy, dp, dp, lane,
                      [&](int r, int c, float v0, float v1) {
        if (c < d) {
          sX2[r * lf + c] = to_f(sX[r * d + c]) + v0;
          sX2[r * lf + c + 1] = to_f(sX[r * d + c + 1]) + v1;
        }
      });
      __syncwarp();
      ln_rows(sX2, lf, ln2s, ln2b, sY, sStat + 2 * L, g, eps, lane);
      __syncwarp();

      for (int c = lane; c < d; c += 32) {
        float s = 0.f;
        for (int r = 0; r < L; ++r) s += __bfloat162float(sDo[r * ldy + c]);
        vb2[c] += s;
      }
    }

    int first = 0;
    if constexpr (kTiled) {
      // ---- the FF backward a 16-column tile of F at a time: gelu and
      // bf16(dhp) tiles (double-buffered), dy2 = bf16(dhp) W1^T
      // accumulated in registers; point 1 on each tile: dW2's rows and
      // dW1's columns n0.. (gelu^T do, y2^T bf16(dhp)). One barrier a
      // tile: a warp writes a buffer again only after every warp has
      // passed the barrier that follows its previous point.
      float dy2[MAX_NT][2][4] = {};
      for (int j = 0, n0 = 0; n0 < f; ++j, n0 += 16) {
        const size_t buf = off.region + (size_t)(j & 1) * 2 * TILE_BYTES;
        if (mine_valid) {
          bf16* tg = sG + (j & 1) * 2 * L * LDT;
          bf16* th = tg + L * LDT;
          ff_cols(sY, sDo, S.w1, S.w2, b1, n0, n0 + 16, n0, tg, th, LDT, vb1,
                  g, lane);
          __syncwarp();
          uint32_t af[4];
          load_a(af, th, LDT, 0, 0, lane);
#pragma unroll
          for (int nt = 0; nt < MAX_NT; ++nt) {
            if (16 * nt >= dp) break;
            uint32_t bfr[4];
            load_b_t(bfr, S.w1, g.ldf, n0, 16 * nt, lane);
            mma_16816(dy2[nt][0], af, bfr[0], bfr[1]);
            mma_16816(dy2[nt][1], af, bfr[2], bfr[3]);
          }
        }
        __syncthreads();
        first += point(warps + buf, LDT, warps + off.dob, ldy, wb, 16, dp, nv,
                       first, warp, nwarps, lane,
                       [&](int r, int c, float v0, float v1) {
          if (c < d) add2(p2 + (n0 + r) * d + c, v0, v1);
        });
        first += point(warps + off.y, ldy, warps + buf + TILE_BYTES, LDT, wb,
                       dp, 16, nv, first, warp, nwarps, lane,
                       [&](int r, int c, float v0, float v1) {
          if (r < d) add2(p1 + r * f + n0 + c, v0, v1);
        });
      }
      if (mine_valid) {
        const int gq = lane >> 2, t = lane & 3;
#pragma unroll
        for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int c = 16 * nt + 8 * jj + 2 * t;
            if (c >= d) continue;
            sT[gq * lf + c] = dy2[nt][jj][0];
            sT[gq * lf + c + 1] = dy2[nt][jj][1];
            sT[(gq + 8) * lf + c] = dy2[nt][jj][2];
            sT[(gq + 8) * lf + c + 1] = dy2[nt][jj][3];
          }
      }
      __syncthreads();           // the last tile's point has read y2 and do
    } else {
      // ---- the FF backward over all of F: gelu and bf16(dhp) [16][ldf];
      // point 1: dW2 += gelu^T do, dW1 += y2^T bf16(dhp); then dy2 =
      // bf16(dhp) W1^T
      bf16* sDh = reinterpret_cast<bf16*>(mine + off.region + ff_half);
      if (mine_valid)
        ff_cols(sY, sDo, S.w1, S.w2, b1, 0, f, 0, sG, sDh, g.ldf, vb1, g,
                lane);
      __syncthreads();
      first += point(warps + off.region, g.ldf, warps + off.dob, ldy, wb, f,
                     dp, nv, first, warp, nwarps, lane,
                     [&](int r, int c, float v0, float v1) {
        if (c < d) add2(p2 + r * d + c, v0, v1);
      });
      first += point(warps + off.y, ldy, warps + off.region + ff_half, g.ldf,
                     wb, dp, f, nv, first, warp, nwarps, lane,
                     [&](int r, int c, float v0, float v1) {
        if (r < d) add2(p1 + r * f + c, v0, v1);
      });
      __syncthreads();           // point 1 has read y2, do, gelu, dhp
      if (mine_valid) {
        warp_mma<true>(sDh, g.ldf, S.w1, g.ldf, dp, f, lane,
                       [&](int r, int c, float v0, float v1) {
          if (c < d) {
            sT[r * lf + c] = v0;
            sT[r * lf + c + 1] = v1;
          }
        });
        __syncwarp();
      }
    }

    if (mine_valid) {
      // LN2 backward: dx2 = LN2'(dy2) + do in f32, in place of x2; dao =
      // bf16(dx2) in place of y2
      ln_bwd(sT, lf, sX2, lf, sStat + 2 * L, ln2s, vln2s, vln2b, g, lane,
             [&](int r, int c, float v) {
        const float dx2 = v + __bfloat162float(sDo[r * ldy + c]);
        sX2[r * lf + c] = dx2;
        sY[r * ldy + c] = __float2bfloat16(dx2);
      });
      for (int i = lane; i < L * pad; i += 32)
        sY[(i / pad) * ldy + d + i % pad] = zero;
      __syncwarp();
      // dO = bf16(dx2) Wo^T
      warp_mma<true>(sY, ldy, S.wo, ldy, dp, dp, lane,
                     [&](int r, int c, float v0, float v1) {
        if (c < d) {
          sT[r * lf + c] = v0;
          sT[r * lf + c + 1] = v1;
        }
      });
      __syncwarp();
    }
    // ---- point 2: dWo += bf16(o)^T bf16(dx2)
    __syncthreads();
    first += point(warps + off.o, ldy, warps + off.y, ldy, wb, dp, dp, nv,
                   first, warp, nwarps, lane,
                   [&](int r, int c, float v0, float v1) {
      if (r < d && c < d) add2(po + r * d + c, v0, v1);
    });
    __syncthreads();

    if (mine_valid) {
      // ---- attention backward, pass 1 per (query row, head): a, da,
      // delta = sum da a, ds = a (da - delta), dq; a and ds kept
      // (resident), or the row's max, sum and delta (F-tiled)
      for (int pr = lane; pr < L * h; pr += 32) {
        const int r = pr & (L - 1), hh = pr / L, c0 = hh * g.hd;
        float a[L], ds[L], m, l;
        softmax_row<U>(sQ, sK, g, lf, r, c0, a, &m, &l);
        float sum = 0.f;
#pragma unroll U
        for (int k = 0; k < L; ++k) {
          ds[k] = logit(sT, sV, g, lf, r, k, c0);     // da
          sum += ds[k] * a[k];
        }
#pragma unroll U
        for (int k = 0; k < L; ++k) {
          ds[k] = a[k] * (ds[k] - sum);
          if (!kTiled) {
            sA[(hh * L + r) * L + (k ^ r)] = a[k];
            sDs[(hh * L + r) * L + (k ^ r)] = ds[k];
          }
        }
        if (kTiled) sAt[hh * L + r] = make_float4(m, l, sum, 0.f);
        float dq[HD];
        weighted_rows<HD, U>(ds, sK, g, lf, c0, dq);
        for (int c = 0; c < g.hd; ++c)
          sY[r * ldy + c0 + c] = __float2bfloat16(dq[c] * q_scale);
      }
      __syncwarp();
      // pass 2 per (key row, head): dk = ds^T qs, dv = a^T dO, with each
      // query row's a and ds read back (resident) or formed again from its
      // statistics by pass 1's arithmetic (F-tiled)
      for (int pr = lane; pr < L * h; pr += 32) {
        const int kr = pr & (L - 1), hh = pr / L, c0 = hh * g.hd;
        float dk[HD], dv[HD];
        for (int c = 0; c < g.hd; ++c) dk[c] = dv[c] = 0.f;
#pragma unroll U
        for (int q = 0; q < L; ++q) {
          float a, ds;
          if constexpr (kTiled) {
            const float4 st = sAt[hh * L + q];
            a = expf(logit(sQ, sK, g, lf, q, kr, c0) - st.x) / st.y;
            ds = a * (logit(sT, sV, g, lf, q, kr, c0) - st.z);
          } else {
            a = sA[(hh * L + q) * L + (kr ^ q)];
            ds = sDs[(hh * L + q) * L + (kr ^ q)];
          }
          axpy_row(dk, ds, sQ + q * lf + c0, g);
          axpy_row(dv, a, sT + q * lf + c0, g);
        }
        for (int c = 0; c < g.hd; ++c) {
          sO[kr * ldy + c0 + c] = __float2bfloat16(dk[c]);
          sDo[kr * ldy + c0 + c] = __float2bfloat16(dv[c]);
        }
      }
      for (int i = lane; i < L * pad; i += 32) {
        const int r = i / pad, c = d + i % pad;
        sY[r * ldy + c] = zero;
        sO[r * ldy + c] = zero;
        sDo[r * ldy + c] = zero;
      }
      __syncwarp();
      // dy = dq Wq^T + dk Wk^T + dv Wv^T
      for (int sec = 0; sec < 3; ++sec)
        warp_mma<true>(sec == 0 ? sY : (sec == 1 ? sO : sDo), ldy,
                       S.wqkv + sec * dp, g.ldq, dp, dp, lane,
                       [&](int r, int c, float v0, float v1) {
          if (c < d) {
            float* t = sT + r * lf + c;
            t[0] = sec == 0 ? v0 : t[0] + v0;
            t[1] = sec == 0 ? v1 : t[1] + v1;
          }
        });
      // y again (for dWqkv) over the softmax rows, which pass 2 has read
      ln_rows(sX, d, ln1s, ln1b, sY1, sStat, g, eps, lane);
      __syncwarp();
      bf16* dxp = dx + row0 * d;
      ln_bwd(sT, lf, sX, d, sStat, ln1s, vln1s, vln1b, g, lane,
             [&](int r, int c, float v) {
        dxp[r * d + c] = __float2bfloat16(v + sX2[r * lf + c]);
      });
    }
    // ---- point 3: dWq, dWk, dWv += y^T dq, dk, dv
    __syncthreads();
    const size_t secs[3] = {off.y, off.o, off.dob};
    for (int sec = 0; sec < 3; ++sec)
      first += point(warps + off.region, ldy, warps + secs[sec], ldy, wb, dp,
                     dp, nv, first, warp, nwarps, lane,
                     [&](int r, int c, float v0, float v1) {
        if (r < d && c < d) add2(pqkv + r * 3 * d + sec * d + c, v0, v1);
      });
    __syncthreads();
  }

  // the block's partial: the weight gradients, then the column sums, the
  // warps' added in warp order
  float* out = part + (size_t)blockIdx.x * (g.total + g.nvec);
  for (int i = threadIdx.x; i < g.total; i += blockDim.x) out[i] = sPart[i];
  for (int i = threadIdx.x; i < g.nvec; i += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w)
      s += reinterpret_cast<const float*>(warps + (size_t)w * wb + off.vec)[i];
    out[g.total + i] = s;
  }
}

// ------------------------------------------------------- K7a on Hopper

// The unit of the Hopper K7a is 4 patches, 64 rows: one m64 wgmma tile,
// warp w of a consumer warpgroup holding patch w's 16 rows (rows 16w + g
// and 16w + g + 8 of the accumulator layout, sm90.cuh). Built for
// TNT-S's (24, 96, 4) and TNT-B's (40, 160, 4) widths; any other shape
// supported() takes runs tnt_fwd_kernel<0, 0, 0> (route 0).
namespace hop {

using namespace sav::sm90;

constexpr int UNIT = 64;                  // rows of a unit: 4 patches
constexpr int XSLOTS = 2;                 // x tiles a warpgroup: the next
                                          // units' loads under this one
constexpr float kLog2e = 1.4426950408889634f;
constexpr int MAX_WGS = 4;                // warpgroups a block (TNT-S)
constexpr int MAX_WGS_B = 3;              // at TNT-B's widths

// Compile-time widths of an instantiation.
template <int kD, int kF, int kH>
struct W {
  static constexpr int D = kD, F = kF, H = kH, HD = kD / kH;
  static constexpr int DP = (kD + 15) / 16 * 16;    // 32, 48
  static constexpr int KS = DP / 16;                // k-steps over Dp
  static constexpr int FS = kF / 16;                // k-steps over F
  static constexpr int LQ = kD + 2;   // f32 row stride of q, k, v: twice an
                                      // odd number, so the 16 rows a head's
                                      // lanes read fall in 16 banks
  static constexpr int LO = DP + 8;   // bf16 row stride of the o tile
  static_assert(HD % 2 == 0, "the attention reads head columns as float2");
};

__host__ __device__ inline int up1024(int n) { return (n + 1023) / 1024 * 1024; }

// The layout at D, F (bytes from a 1024-byte aligned base): the block's
// weights as K-major 128-byte-swizzled wgmma B tiles (rows the output
// axis, up to 64 input channels a 128-byte row: Wqkv^T 3 Dp rows, Wo^T Dp,
// W1^T F, W2^T ceil(F / 64) boxes of Dp rows), the f32 vectors (ln1s,
// ln1b, ln2s, ln2b, b2 zero-padded to Dp, then b1 [F]); then each
// warpgroup's two x tiles (64 rows of D bf16); then each warpgroup's work
// region: its warps' q, k, v (f32, row stride D + 2; the unit's out is
// staged there once they are read) and o tiles (bf16, row stride Dp + 8);
// then the x tiles' mbarriers. Before the first unit the work regions
// hold the f32 parameters as they arrive (f32_bytes).
struct Lay {
  int dp, wqkv, wo, w1, w2, vec, weights;
  int xtile, qkv, otile, per_wg;
};

// The f32 parameters' bytes: wq, wk, wv, wo, w1, w2, then ln1s, ln1b,
// ln2s, ln2b, b2 and b1.
__host__ __device__ inline int f32_bytes(int d, int f) {
  return (4 * d * d + 2 * d * f + 5 * d + f) * 4;
}

__host__ __device__ inline Lay lay(int d, int f) {
  Lay l;
  l.dp = (d + 15) / 16 * 16;
  l.wqkv = 0;
  l.wo = l.wqkv + 3 * l.dp * 128;
  l.w1 = l.wo + l.dp * 128;
  l.w2 = l.w1 + f * 128;
  l.vec = l.w2 + (f + 63) / 64 * l.dp * 128;
  l.weights = up1024(l.vec + (5 * l.dp + f) * 4);
  l.xtile = up1024(UNIT * d * 2);
  l.qkv = up1024(4 * 3 * 16 * (d + 2) * 4);
  l.otile = up1024(4 * 16 * (l.dp + 8) * 2);
  l.per_wg = XSLOTS * l.xtile + l.qkv + l.otile;
  return l;
}

// Shared memory at wgs warpgroups a block.
__host__ __device__ inline int smem_at(const Lay& l, int wgs) {
  return l.weights + wgs * l.per_wg + wgs * XSLOTS * 8 + 1024;
}

// 4-byte asynchronous copy global -> shared.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(smem)), "l"(gmem) : "memory");
}

// The f32 parameters into shared memory at f (f32_bytes' order), all in
// flight at once: 4-byte copies, as a caller's tensor need not be 16-byte
// aligned. The caller waits (cp_async_wait<0>) and syncs.
template <class C>
__device__ __forceinline__ void fetch_params(const Params& p, float* f) {
  constexpr int D = C::D, F = C::F;
  const float* src[12] = {p.wq, p.wk, p.wv, p.wo, p.w1, p.w2,
                          p.ln1s, p.ln1b, p.ln2s, p.ln2b, p.b2, p.b1};
  const int len[12] = {D * D, D * D, D * D, D * D, D * F, F * D,
                       D, D, D, D, D, F};
  for (int a = 0; a < 12; ++a) {
    for (int i = threadIdx.x; i < len[a]; i += blockDim.x)
      cp_async_4(f + i, src[a] + i);
    f += len[a];
  }
  cp_async_commit();
}

// Row n, channels 8 kc .. 8 kc + 7 of one 64-channel box of a K-major
// wgmma tile (boxes of `rows` rows) from column col of the f32 weight w
// [K][N] (B = w), bf16, zeros past K and where !valid: one 16-byte store
// at chunk kc ^ (n % 8).
__device__ __forceinline__ void put_chunk(unsigned char* tile, int rows,
                                          int box, int n, int kc,
                                          const float* w, int K, int N,
                                          int col, bool valid) {
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = 64 * box + 8 * kc + 2 * e;
    v[e] = pack_bf16x2(valid && k < K ? w[k * N + col] : 0.f,
                       valid && k + 1 < K ? w[(k + 1) * N + col] : 0.f);
  }
  *reinterpret_cast<uint4*>(tile + box * rows * 128 + n * 128
                            + ((kc ^ (n & 7)) << 4)) =
      make_uint4(v[0], v[1], v[2], v[3]);
}

// The block's weights (bf16, zeros in every padded row and channel) and
// vectors, from the f32 parameters fetch_params put at f. A thread writes
// 8 channels of a row at once; a warp's lanes take consecutive rows, so
// their f32 reads fall in consecutive banks.
template <class C>
__device__ __forceinline__ void stage_weights(const float* f,
                                              unsigned char* base,
                                              const Lay& l) {
  constexpr int D = C::D, F = C::F, DP = C::DP, KB = (F + 63) / 64;
  const float *wq = f, *wk = wq + D * D, *wv = wk + D * D, *wo = wv + D * D,
              *w1 = wo + D * D, *w2 = w1 + D * F, *vecs = w2 + F * D;
  for (int i = threadIdx.x; i < 3 * DP * 8; i += blockDim.x) {
    const int n = i % (3 * DP), sec = n / DP, c = n - sec * DP;
    put_chunk(base + l.wqkv, 3 * DP, 0, n, i / (3 * DP),
              sec == 0 ? wq : (sec == 1 ? wk : wv), D, D, c, c < D);
  }
  for (int i = threadIdx.x; i < DP * 8; i += blockDim.x)
    put_chunk(base + l.wo, DP, 0, i % DP, i / DP, wo, D, D, i % DP,
              i % DP < D);
  for (int i = threadIdx.x; i < F * 8; i += blockDim.x)
    put_chunk(base + l.w1, F, 0, i % F, i / F, w1, D, F, i % F, true);
  for (int i = threadIdx.x; i < KB * 8 * DP; i += blockDim.x) {
    const int n = i % DP, kc = (i / DP) & 7, box = i / (8 * DP);
    put_chunk(base + l.w2, DP, box, n, kc, w2, F, D, n, n < D);
  }
  float* vec = reinterpret_cast<float*>(base + l.vec);
  for (int i = threadIdx.x; i < 5 * DP + F; i += blockDim.x) {
    const int j = i / DP, c = i - j * DP;
    vec[i] = i < 5 * DP ? (c < D ? vecs[j * D + c] : 0.f)
                        : vecs[5 * D + i - 5 * DP];
  }
}

// 0.5 h (1 + tanh(C (h + A h^3))), the tanh on the special-function unit
// (tanh.approx, relative error ~2^-11, under the bf16 rounding gelu(h)
// takes next as W2's A operand).
__device__ __forceinline__ float gelu_approx(float h) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t)
      : "f"(ff::GELU_C * (h + ff::GELU_A * h * h * h)));
  return 0.5f * h * (1.f + t);
}

// x's rows 16 w.. of a unit tile (64 rows of D bf16) in the accumulator
// layout, f32: xf[8 kk + 0..7] from one ldmatrix of the 16 x 16 block at
// column 16 kk (a_frag's inverse); channels past D are zeros.
template <class C>
__device__ __forceinline__ void load_x(float (&xf)[C::DP / 2],
                                       const unsigned char* tile, int warp,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < C::KS; ++kk) {
    const int col = 16 * kk + (lane >> 4) * 8;
    const int row = 16 * warp + (lane & 15);
    uint32_t a[4];
    ldmatrix_x4(a, tile + row * (C::D * 2) + (col < C::D ? col : 0) * 2);
    if (16 * kk + 8 >= C::D) a[2] = a[3] = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&a[e]);
      xf[8 * kk + 2 * e] = __low2float(v);
      xf[8 * kk + 2 * e + 1] = __high2float(v);
    }
  }
}

// y = bf16(LN(x)) of this thread's two rows as the register A operands of
// a product over Dp: the row's sums over the thread's columns (in column
// order, then the quad's lanes by xor 1 and 2: a row lies in one quad),
// mu = sum / D, 1/sigma = rsqrt(max(sq / D - mu^2, 0) + eps); scale and
// bias (zero past D, which zeroes the padded channels) from vec.
template <class C>
__device__ __forceinline__ void ln_frags(const float (&xf)[C::DP / 2],
                                         const float* scale,
                                         const float* bias, float eps,
                                         uint32_t (&ya)[C::KS][4], int t) {
  float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int i = 0; i < C::DP / 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float a = xf[4 * i + j], b = xf[4 * i + 2 + j];
      s0 += a;
      q0 += a * a;
      s1 += b;
      q1 += b * b;
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    s0 += __shfl_xor_sync(FULL, s0, off);
    q0 += __shfl_xor_sync(FULL, q0, off);
    s1 += __shfl_xor_sync(FULL, s1, off);
    q1 += __shfl_xor_sync(FULL, q1, off);
  }
  const float mu0 = s0 / C::D, mu1 = s1 / C::D;
  const float in0 = rsqrtf(fmaxf(q0 / C::D - mu0 * mu0, 0.f) + eps);
  const float in1 = rsqrtf(fmaxf(q1 / C::D - mu1 * mu1, 0.f) + eps);
  float y[C::DP / 2];
#pragma unroll
  for (int i = 0; i < C::DP / 8; ++i) {
    const float2 sc = *reinterpret_cast<const float2*>(scale + 8 * i + 2 * t);
    const float2 bi = *reinterpret_cast<const float2*>(bias + 8 * i + 2 * t);
    y[4 * i] = (xf[4 * i] - mu0) * in0 * sc.x + bi.x;
    y[4 * i + 1] = (xf[4 * i + 1] - mu0) * in0 * sc.y + bi.y;
    y[4 * i + 2] = (xf[4 * i + 2] - mu1) * in1 * sc.x + bi.x;
    y[4 * i + 3] = (xf[4 * i + 3] - mu1) * in1 * sc.y + bi.y;
  }
#pragma unroll
  for (int kk = 0; kk < C::KS; ++kk) a_frag(ya[kk], y, kk);
}

// acc = A B over `steps` 16-deep steps, A from registers, B the K-major
// tile at b (boxes of `rows` rows, 64 channels each); one commit group,
// waited for.
template <int N, int STEPS>
__device__ __forceinline__ void product(float (&acc)[N / 2],
                                        const uint32_t (&a)[STEPS][4],
                                        const unsigned char* b, int rows) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint64_t bd = desc_k_major(b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
    wgmma_rs_kn<N>(acc, a[kk],
                   bd + (kk >> 2) * ((rows * 128) >> 4) + (kk & 3) * K_STEP);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// One patch's attention, f32 on the CUDA cores: a lane takes query rows
// r and r + 8 of one head, both q rows in registers, so each k and v row
// it loads (float2s) feeds both: the 16 logits of each row, the softmax
// (p = 2^(s log2 e - m log2 e) by ex2.approx) and o = (sum p v) / sum p,
// written as bf16 to the warp's o tile.
template <class C>
__device__ __forceinline__ void attention(const float* sq, bf16* so,
                                          int lane) {
  constexpr int HD = C::HD, LQ = C::LQ;
  const float* sk = sq + L * LQ;
  const float* sv = sk + L * LQ;
  for (int pr = lane; pr < 8 * C::H; pr += 32) {
    const int r = pr & 7, c0 = (pr >> 3) * HD;
    float q[2][HD], s[2][L], o[2][HD], m[2], l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        q[h][c] = sq[(r + 8 * h) * LQ + c0 + c];
        o[h][c] = 0.f;
      }
      m[h] = -INFINITY;
      l[h] = 0.f;
    }
#pragma unroll
    for (int p = 0; p < L; ++p) {             // HD, LQ, c0 even: float2
      const float2* kr = reinterpret_cast<const float2*>(sk + p * LQ + c0);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 2; ++c) {
        const float2 kv = kr[c];
        a0 = fmaf(q[0][2 * c + 1], kv.y, fmaf(q[0][2 * c], kv.x, a0));
        a1 = fmaf(q[1][2 * c + 1], kv.y, fmaf(q[1][2 * c], kv.x, a1));
      }
      s[0][p] = a0;
      s[1][p] = a1;
      m[0] = fmaxf(m[0], a0);
      m[1] = fmaxf(m[1], a1);
    }
    const float n0 = -m[0] * kLog2e, n1 = -m[1] * kLog2e;
#pragma unroll
    for (int p = 0; p < L; ++p) {
      float e0, e1;
      asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e0)
          : "f"(fmaf(s[0][p], kLog2e, n0)));
      asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e1)
          : "f"(fmaf(s[1][p], kLog2e, n1)));
      l[0] += e0;
      l[1] += e1;
      const float2* vr = reinterpret_cast<const float2*>(sv + p * LQ + c0);
#pragma unroll
      for (int c = 0; c < HD / 2; ++c) {
        const float2 vv = vr[c];
        o[0][2 * c] = fmaf(e0, vv.x, o[0][2 * c]);
        o[0][2 * c + 1] = fmaf(e0, vv.y, o[0][2 * c + 1]);
        o[1][2 * c] = fmaf(e1, vv.x, o[1][2 * c]);
        o[1][2 * c + 1] = fmaf(e1, vv.y, o[1][2 * c + 1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = 1.f / l[h];
#pragma unroll
      for (int c = 0; c < HD; c += 2)
        *reinterpret_cast<uint32_t*>(so + (r + 8 * h) * C::LO + c0 + c) =
            pack_bf16x2(o[h][c] * inv, o[h][c + 1] * inv);
    }
  }
}

template <int kD, int kF, int kH, int kWgs>
__global__ void __launch_bounds__(kWgs * 128, 1)
tnt_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tout,
                    const Params prm, int n, float eps, float q_scale) {
  using C = W<kD, kF, kH>;
  constexpr int D = C::D, F = C::F, DP = C::DP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const Lay l = lay(D, F);
  const int wgs = blockDim.x >> 7;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const bool leader = wt == 0;
  const int units = (n + 3) / 4;
  const int stride = gridDim.x * wgs;
  const int first = blockIdx.x * wgs + wg;
  unsigned char* mine = base + l.weights + wg * XSLOTS * l.xtile;
  unsigned char* work = base + l.weights + wgs * XSLOTS * l.xtile;
  unsigned char* qkv = work + wg * (l.qkv + l.otile);
  float* sq = reinterpret_cast<float*>(qkv) + warp * 3 * L * C::LQ;
  bf16* so = reinterpret_cast<bf16*>(qkv + l.qkv) + warp * L * C::LO;
  uint64_t* xfull = reinterpret_cast<uint64_t*>(base + l.weights
                                                + wgs * l.per_wg)
                    + wg * XSLOTS;
  const float* vec = reinterpret_cast<const float*>(base + l.vec);
  const float *ln1s = vec, *ln1b = vec + DP, *ln2s = vec + 2 * DP,
              *ln2b = vec + 3 * DP, *b2 = vec + 4 * DP, *b1 = vec + 5 * DP;

  float* params = reinterpret_cast<float*>(work);
  fetch_params<C>(prm, params);
  if (leader) {
    for (int i = 0; i < XSLOTS; ++i) mbar_init(&xfull[i], 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (leader)                                // the first units' x, under
    for (int i = 0; i < XSLOTS; ++i) {       // the weights' staging
      const int u = first + i * stride;
      if (u >= units) break;
      mbar_arrive_expect_tx(&xfull[i], UNIT * D * 2);
      tma_load_3d(mine + i * l.xtile, &tx, &xfull[i], 0, u * UNIT, 0);
    }
  cp_async_wait<0>();
  __syncthreads();                           // every parameter has landed
  stage_weights<C>(params, base, l);
  fence_proxy_async();                       // the weights are wgmma's
  __syncthreads();                           // the f32 copies are read
  // the o tiles' padded channels stay zero: the attention writes below D
  // (the unit loop's first warpgroup barrier orders them before use)
  for (int i = wt; i < l.otile / 4; i += 128)
    reinterpret_cast<uint32_t*>(qkv + l.qkv)[i] = 0u;

  for (int k = 0, u = first; u < units; ++k, u += stride) {
    const int slot = k % XSLOTS;
    mbar_wait(&xfull[slot], (k / XSLOTS) & 1);
    float xf[DP / 2];
    load_x<C>(xf, mine + slot * l.xtile, warp, lane);
    if (leader) bulk_wait_read();            // the last unit's out is read
    warpgroup_sync(1 + wg);                  // the slot and staging are free
    if (leader && u + XSLOTS * stride < units) {
      mbar_arrive_expect_tx(&xfull[slot], UNIT * D * 2);
      tma_load_3d(mine + slot * l.xtile, &tx, &xfull[slot], 0,
                  (u + XSLOTS * stride) * UNIT, 0);
    }

    // y = bf16(LN1(x)); q (scaled), k, v = y Wqkv to the warp's f32 rows
    uint32_t ya[C::KS][4];
    ln_frags<C>(xf, ln1s, ln1b, eps, ya, t);
    {
      float acc[3 * DP / 2];
      product<3 * DP, C::KS>(acc, ya, base + l.wqkv, 3 * DP);
#pragma unroll
      for (int i = 0; i < 3 * DP / 8; ++i) {
        const int sec = i / (DP / 8), c = 8 * (i % (DP / 8)) + 2 * t;
        if (c >= D) continue;
        const float m = sec == 0 ? q_scale : 1.f;
        float* dst = sq + sec * L * C::LQ + c;
        *reinterpret_cast<float2*>(dst + gq * C::LQ) =
            make_float2(acc[4 * i] * m, acc[4 * i + 1] * m);
        *reinterpret_cast<float2*>(dst + (gq + 8) * C::LQ) =
            make_float2(acc[4 * i + 2] * m, acc[4 * i + 3] * m);
      }
    }
    __syncwarp();
    attention<C>(sq, so, lane);
    __syncwarp();

    // x2 = x + bf16(o) Wo, in f32 in xf
    {
      uint32_t oa[C::KS][4];
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk)
        ldmatrix_x4(oa[kk], so + (lane & 15) * C::LO + 16 * kk
                                + (lane >> 4) * 8);
      float acc[DP / 2];
      product<DP, C::KS>(acc, oa, base + l.wo, DP);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) xf[i] += acc[i];
    }

    // hp = bf16(LN2(x2)) W1 + b1; gact = gelu(hp) as W2's A operand
    uint32_t ga[C::FS][4];
    {
      ln_frags<C>(xf, ln2s, ln2b, eps, ya, t);
      float hp[F / 2];
      product<F, C::KS>(hp, ya, base + l.w1, F);
#pragma unroll
      for (int i = 0; i < F / 8; ++i) {
        const float2 bb = *reinterpret_cast<const float2*>(b1 + 8 * i + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float h = hp[4 * i + e] + ((e & 1) ? bb.y : bb.x);
          hp[4 * i + e] = gelu_approx(h);
        }
      }
#pragma unroll
      for (int kk = 0; kk < C::FS; ++kk) a_frag(ga[kk], hp, kk);
    }

    // out = bf16(x2 + bf16(gact) W2 + b2), staged over the q, k, v rows
    // (every warp has read them: the products since waited for all four)
    // and stored by one TMA store, which drops the rows past B*P
    float acc[DP / 2];
    product<DP, C::FS>(acc, ga, base + l.w2, DP);
    warpgroup_sync(1 + wg);
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + 2 * t;
      if (c >= D) continue;
      const float2 bb = *reinterpret_cast<const float2*>(b2 + c);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(
            qkv + ((16 * warp + gq + 8 * h) * D + c) * 2) =
            pack_bf16x2(xf[4 * i + 2 * h] + acc[4 * i + 2 * h] + bb.x,
                        xf[4 * i + 2 * h + 1] + acc[4 * i + 2 * h + 1] + bb.y);
    }
    fence_proxy_async();
    warpgroup_sync(1 + wg);
    if (leader) {
      tma_store_3d(&tout, qkv, 0, u * UNIT, 0);
      bulk_commit();
    }
  }
  if (leader) bulk_wait_all();
}

}  // namespace hop

// ----------------------------------------------------------------- host

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// K7a's launch plan at n patches of D, F, H on `sms` SMs. Route 1, the
// Hopper kernel at TNT-S's and TNT-B's widths: `wgs` warpgroups a block
// (at most its instantiation's, which its registers set: 4 at TNT-S, 3 at
// TNT-B; fewer where shared memory holds fewer), units of 4 patches, at
// most one block an SM. Route 0, tnt_fwd_kernel<0, 0, 0> (a warp a patch,
// mma.sync) for any other shape supported() takes: `wgs` its warps a
// block, its blocks from the occupancy query at launch (0 here).
// Mirrored by tnt_fwd_plan in ops/tnt_inner.py.
struct FwdPlan {
  int route, wgs, blocks, units, smem, per_wg, weights;
};

inline int hop_wgs(int d, int f, int h) {
  if (d == 24 && f == 96 && h == 4) return hop::MAX_WGS;
  if (d == 40 && f == 160 && h == 4) return hop::MAX_WGS_B;
  return 0;
}

inline cudaError_t plan_fwd(int n, int d, int f, int h, int sms,
                            FwdPlan* pl) {
  if (n < 1 || sms < 1 || h < 1 || d < 8 || d % 8 || d % h || f < 16
      || f % 16)
    return cudaErrorInvalidValue;
  const hop::Lay l = hop::lay(d, f);
  int w = hop_wgs(d, f, h);
  while (w > 0 && hop::smem_at(l, w) > SMEM_CAP) --w;
  if (w * (l.qkv + l.otile) < hop::f32_bytes(d, f)) w = 0;
  if (w > 0) {
    pl->route = 1;
    pl->wgs = w;
    pl->units = (n + 3) / 4;
    const int need = (pl->units + w - 1) / w;
    pl->blocks = need < sms ? need : sms;
    pl->smem = hop::smem_at(l, w);
    pl->per_wg = l.per_wg;
    pl->weights = l.weights;
    return cudaSuccess;
  }
  const Geo g = geo(d, f, h);
  const int warps = fwd_warps(g);
  if (warps < 1) return cudaErrorInvalidValue;
  pl->route = 0;
  pl->wgs = warps;
  pl->blocks = 0;
  pl->units = n;
  pl->smem = (int)(weight_bytes(g) + warps * fwd_warp_bytes(g));
  pl->per_wg = (int)fwd_warp_bytes(g);
  pl->weights = (int)weight_bytes(g);
  return cudaSuccess;
}

// K7b's: TNT-S's in the resident layout, TNT-B's F-tiled (bwd_tiled),
// any other shape in the layout bwd_tiled gives it.
inline auto bwd_kernel(int d, int f, int h, bool tiled) {
  const auto any = tiled ? tnt_bwd_kernel<0, 0, 0, true>
                         : tnt_bwd_kernel<0, 0, 0, false>;
  if (d == 24 && f == 96 && h == 4 && !tiled)
    return tnt_bwd_kernel<24, 96, 4, false>;
  if (d == 40 && f == 160 && h == 4 && tiled)
    return tnt_bwd_kernel<40, 160, 4, true>;
  return any;
}

// Persistent grid of the forward: at most the blocks the card holds at
// once, at most one warp per patch.
template <typename K>
inline cudaError_t grid_for(K kernel, int warps, size_t smem, int n,
                            int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      warps * 32, smem);
  if (err != cudaSuccess) return err;
  const int need = (n + warps - 1) / warps;
  const int most = (per_sm > 0 ? per_sm : 1) * sm_count();
  *blocks = need < most ? need : most;
  return cudaSuccess;
}

// K7b's launch plan on `sms` SMs: warps a block, blocks (one an SM, at
// most one round of warps per patch), the block's dynamic shared memory,
// the f32 partial a block writes (the weight gradients, then the column
// sums) and the workspace (one partial a block: it grows with blocks, not
// with patches). Mirrored by tnt_bwd_plan in ops/tnt_inner.py.
struct BwdPlan {
  bool tiled;
  int warps, blocks;
  size_t smem;
  int part_floats;
  size_t workspace;
};

inline cudaError_t plan_bwd(int n, int d, int f, int h, int sms, BwdPlan* pl) {
  const Geo g = geo(d, f, h);
  pl->tiled = bwd_tiled(g);
  pl->warps = bwd_warps(g, pl->tiled);
  if (pl->warps < 1 || n < 1 || sms < 1) return cudaErrorInvalidValue;
  pl->smem = weight_bytes(g) + part_bytes(g)
             + pl->warps * bwd_warp_bytes(g, pl->tiled);
  const int need = (n + pl->warps - 1) / pl->warps;
  pl->blocks = need < sms ? need : sms;
  pl->part_floats = g.total + g.nvec;
  pl->workspace = (size_t)pl->blocks * pl->part_floats * 4;
  return cudaSuccess;
}

}  // namespace tnt
}  // namespace sav

using namespace sav;
using namespace sav::tnt;

// K7a's plan at n patches on `sms` SMs: out[0] the route (1: the Hopper
// kernel, 0: the warp-a-patch one), [1] warpgroups a block (route 0: its
// warps), [2] blocks (route 0: 0, set by the occupancy query at launch),
// [3] dynamic shared memory, [4] units (route 1: 4 patches each; route 0:
// the patches), [5] a warpgroup's (route 0: a warp's) shared memory, [6]
// the block's weights'. Returns 0, or cudaErrorInvalidValue where
// sav_tnt_fwd refuses the shape.
extern "C" int sav_tnt_fwd_plan(int n, int d, int f, int h, int sms,
                                long long* out) {
  FwdPlan pl;
  if (plan_fwd(n, d, f, h, sms, &pl) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  const long long v[7] = {pl.route, pl.wgs, pl.blocks, pl.smem, pl.units,
                          pl.per_wg, pl.weights};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// x, out [n, 16, D] bf16; the parameters f32 in checkpoint layout (ln1
// scale and bias [D], wq, wk, wv [D, H, hd], wo [H, hd, D], ln2 scale and
// bias [D], w1 [D, F], b1 [F], w2 [F, D], b2 [D]), contiguous. Needs D % 8
// == 0, D % H == 0, F % 16 == 0 and a plan (sav_tnt_fwd_plan).
extern "C" int sav_tnt_fwd(const void* x, const float* ln1s,
                           const float* ln1b, const float* wq,
                           const float* wk, const float* wv, const float* wo,
                           const float* ln2s, const float* ln2b,
                           const float* w1, const float* b1, const float* w2,
                           const float* b2, void* out, int n, int d, int f,
                           int h, float eps, float q_scale, void* stream) {
  const Params prm{ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2, b2};
  cudaStream_t st = (cudaStream_t)stream;
  FwdPlan pl;
  cudaError_t err = plan_fwd(n, d, f, h, sm_count(), &pl);
  if (err != cudaSuccess) return (int)err;
  if (pl.route == 1) {
    CUtensorMap tx, tout;
    int e = sm90::rows_map(&tx, x, n * L, d);
    if (!e) e = sm90::rows_map(&tout, out, n * L, d);
    if (e) return e;
    const auto kernel =
        d == 24 ? hop::tnt_fwd_sm90_kernel<24, 96, 4, hop::MAX_WGS>
                : hop::tnt_fwd_sm90_kernel<40, 160, 4, hop::MAX_WGS_B>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<pl.blocks, pl.wgs * 128, pl.smem, st>>>(tx, tout, prm, n, eps,
                                                      q_scale);
    return (int)cudaGetLastError();
  }
  int blocks = 0;
  const auto kernel = tnt_fwd_kernel<0, 0, 0>;
  err = grid_for(kernel, pl.wgs, pl.smem, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, pl.wgs * 32, pl.smem, st>>>((const bf16*)x, prm,
                                               (bf16*)out, n, d, f, h, eps,
                                               q_scale);
  return (int)cudaGetLastError();
}

// K7b's plan at n patches on `sms` SMs: out[0] warps a block, [1] blocks,
// [2] dynamic shared memory, [3] the f32 partial a block writes, [4]
// workspace bytes, [5] a warp's shared memory, [6] 1 for the F-tiled
// layout, 0 for the resident one. Returns 0, or cudaErrorInvalidValue where
// sav_tnt_bwd refuses the shape.
extern "C" int sav_tnt_bwd_plan(int n, int d, int f, int h, int sms,
                                long long* out) {
  BwdPlan pl;
  if (plan_bwd(n, d, f, h, sms, &pl) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  out[0] = pl.warps;
  out[1] = pl.blocks;
  out[2] = (long long)pl.smem;
  out[3] = pl.part_floats;
  out[4] = (long long)pl.workspace;
  out[5] = (long long)bwd_warp_bytes(geo(d, f, h), pl.tiled);
  out[6] = pl.tiled;
  return 0;
}

// Bytes of the workspace sav_tnt_bwd needs at n patches on the current
// device, or -1 where the shape is not taken.
extern "C" long long sav_tnt_bwd_workspace(int n, int d, int f, int h) {
  BwdPlan pl;
  if (plan_bwd(n, d, f, h, sm_count(), &pl) != cudaSuccess) return -1;
  return (long long)pl.workspace;
}

// The backward of sav_tnt_fwd from x and the cotangent g [n, 16, D] bf16
// and the parameters as sav_tnt_fwd takes them: dx [n, 16, D] bf16; gw f32 [4 D^2 + 2 D F] = dWqkv [D][3D], dWo [D][D],
// dW1 [D][F], dW2 [F][D]; gvec f32 [5D + F] in par's order. ws: the bytes
// sav_tnt_bwd_workspace gives (the blocks' partials). Three launches: the
// patches, then the partials' fixed-order sums.
extern "C" int sav_tnt_bwd(const void* x, const void* gout,
                           const float* ln1s, const float* ln1b,
                           const float* wq, const float* wk, const float* wv,
                           const float* wo, const float* ln2s,
                           const float* ln2b, const float* w1,
                           const float* b1, const float* w2, const float* b2,
                           void* dx, float* gw, float* gvec, void* ws, int n,
                           int d, int f, int h, float eps, float q_scale,
                           void* stream) {
  const Params prm{ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2, b2};
  cudaStream_t st = (cudaStream_t)stream;
  BwdPlan pl;
  cudaError_t err = plan_bwd(n, d, f, h, sm_count(), &pl);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = bwd_kernel(d, f, h, pl.tiled);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  float* part = (float*)ws;
  kernel<<<pl.blocks, pl.warps * 32, pl.smem, st>>>(
      (const bf16*)x, (const bf16*)gout, prm, (bf16*)dx, part, n, d, f, h,
      eps, q_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const Geo g = geo(d, f, h);
  if ((err = sum_launch(part, pl.blocks, pl.part_floats, g.total, gw, st))
      != cudaSuccess)
    return (int)err;
  return (int)sum_launch(part + g.total, pl.blocks, pl.part_floats, g.nvec,
                         gvec, st);
}
