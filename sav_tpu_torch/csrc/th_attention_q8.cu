// K11 port: CaiT's talking-heads attention span for serving, with int8
// q/k/v/out projections.
//
// Replaces sav_tpu/ops/th_attention.py::_th_q8_kernel (launcher
// th_attention_sublayer_q8):
//   y = LN(x) in f32 (fast variance), never rounded to bf16, quantised per
//     row over D (one set of codes feeds q, k and v);
//   q = bf16((f32(yq Wq) * (ys * sq)) * (1 / sqrt(48))), k, v = bf16(f32(yq
//     W) * (ys * s)), int32 sums, per-column f32 weight scales;
//   the talking-heads core: per-head f32 logits, the pre-mix, a softmax
//     over the keys, the post-mix, bf16(pt) v -> bands of 48, rounded to
//     bf16;
//   out = bf16(f32(aq Wo) * (as * so)) (+ x with residual), the bands'
//     codes taken per row over H*48.
// Serving only, as in the JAX package: there is no backward, and the
// wrapper raises under autograd.
//
// The TPU kernel pads each head to 64 lanes and quantises the padded
// weights; the padded columns and rows are zero, so they change no absmax,
// no code and no int32 sum. Here the heads stay 48 wide.
//
// Bound on the card: at CaiT-S/24 @224, B = 32, L = 196, D = 384, H = 8 the
// four projections are 7.4 G int8 operations (0.004 ms at 1979 TOPS), the
// core 1.9 G bf16 FLOP (0.002 ms) and 0.3 G f32 operations of the mixes
// (0.005 ms at 67 TFLOP/s), against ~10 MB of x, out and weight codes
// (0.003 ms): bound by operations, ~0.010 ms; the mixes on the CUDA cores
// are most of it, as in K5a and K6a.
//
// Design: four launches, none of them mma.sync, and no bf16 band in device
// memory:
//  1. q8g::ln_codes_kernel: the four weights' codes transposed into the
//     workspace (s8 wgmma reads K-major B only, and the checkpoint layout
//     is [D, H*48] / [H*48, D]) and, in the same launch, y's codes and row
//     scales one warp a row (q8::quantize_row<true>, K13's
//     quantize_rows_kernel's body);
//  2. q8g QKV: yq [Wq | Wk | Wv] on the persistent s8 wgmma + TMA GEMM
//     (q8_gemm_sm90.cuh), each output its own 64-column tiles, q scaled in
//     the epilogue;
//  3. K6a's two-sweep wgmma core (th_fwd_sm90.cuh, K5a's core too) in its
//     Q8 form: the accumulate warpgroup takes each row's codes over its H
//     heads x 48 columns in registers and writes aq and as (at H = 16 over
//     two passes of 8 heads, the absmax combined before any code);
//  4. q8g OUT: aq Wo with the dequant epilogue (+ x).
// The core forms p = 2^(x - lse log2 e) by ex2.approx where the twin takes
// p / sum p: a band may move by a bf16 ulp, and a code at .5 with it (the
// card checks hold a share of bit-identical outputs for that).
#include "q8_gemm_sm90.cuh"
#include "th_fwd_sm90.cuh"

namespace {

// D a multiple of 32: the codes' rows stay 16-byte aligned for TMA.
bool bad_geometry(int batch, int seq, int dim, int heads) {
  return batch < 1 || seq < 1 || dim < 64 || dim % 32
         || (heads != 4 && heads != 6 && heads != 8 && heads != 16);
}

// The projections' column tile: 64 divides H*48 and D at CaiT-S's,
// cait_xxs's and cait_m's widths, so one tile serves them all (128-wide
// tiles at CaiT-S: `scripts/torch_ablate.py k11`, tiles128). cait_xs's
// 288 is 4.5 tiles: q, k and v take 5 each, the last one's columns past
// 288 computed (from the next output's weight rows, or zeros) but neither
// scaled nor stored, and each contraction 5 slots, the last half zeros
// (q8_gemm_sm90.cuh).
constexpr int TILE = 64;

// The scratch of one call, 256-byte aligned regions in this order: y's
// codes [M, D] and scales [M], the transposed codes [3 H*48, D] (Wq, Wk, Wv)
// and [D, H*48] (Wo), q, k, v [M, H*48] bf16, the bands' codes [M, H*48]
// and scales [M]. Mirrored by th_q8_plan.
struct Workspace {
  size_t at[9], total;
  Workspace(int m, int dim, int hd) {
    const size_t bytes[9] = {(size_t)m * dim, (size_t)m * 4,
                             (size_t)3 * hd * dim, (size_t)dim * hd,
                             (size_t)m * hd * 2, (size_t)m * hd * 2,
                             (size_t)m * hd * 2, (size_t)m * hd,
                             (size_t)m * 4};
    size_t off = 0;
    for (int i = 0; i < 9; ++i) {
      at[i] = off;
      off += sav::q8w::align256(bytes[i]);
    }
    total = off;
  }
};

enum Region { kYq = 0, kYs, kWqkv, kWo, kQ, kK, kV, kAq, kAs };

}  // namespace

// K11's launch plan at (B, L, D, H): out[0] the QKV GEMM's column tile and
// [1] the OUT GEMM's (64), [2] row tiles (128 rows), [3] QKV units,
// [4] OUT units, [5] QKV ring slots a unit (64-deep, over D), [6] OUT's
// (over H*48), [7] QKV's and [8] OUT's dynamic shared memory, [9] the
// core's (with its codes' staging tile), [10] the core's work tiles (64 rows of one image), [11] workspace
// bytes, [12..20] the workspace regions' offsets (Workspace). Returns 0, or
// cudaErrorInvalidValue for a geometry the kernels do not take. Mirrored
// by th_q8_plan in ops/th_attention.py.
extern "C" int sav_th_q8_plan(int batch, int seq, int dim, int heads,
                              long long* out) {
  using namespace sav::q8g;
  if (bad_geometry(batch, seq, dim, heads)) return (int)cudaErrorInvalidValue;
  const int m = batch * seq, hd = heads * sav::thb::TD;
  out[0] = out[1] = TILE;
  out[2] = row_tiles(m);
  out[3] = row_tiles(m) * col_tiles<TILE>(QKV, 3 * hd, hd);
  out[4] = row_tiles(m) * col_tiles<TILE>(OUT, dim, dim);
  out[5] = stages_of(QKV, dim, 0);
  out[6] = stages_of(OUT, hd, 0);
  out[7] = Plan<QKV, TILE>::SMEM;
  out[8] = Plan<OUT, TILE>::SMEM;
  out[9] = heads == 4   ? sav::thf::CodesPlan<4>::SMEM
            : heads == 6 ? sav::thf::CodesPlan<6>::SMEM
            : heads == 8 ? sav::thf::CodesPlan<8>::SMEM
                         : sav::thf::CodesPlan<16>::SMEM;
  out[10] = (long long)(seq + sav::thb::ROWS - 1) / sav::thb::ROWS * batch;
  const Workspace ws(m, dim, hd);
  out[11] = (long long)ws.total;
  for (int i = 0; i < 9; ++i) out[12 + i] = (long long)ws.at[i];
  return 0;
}

// x [B, L, D] bf16; ln_scale/ln_bias [D] f32; wq/wk/wv [D, H*48] and wo
// [H*48, D] int8 codes (per output column) with column scales sq/sk/sv
// [H*48] and so [D] f32; mix [3, H, H] f32 (M_pre, M_pre * log2 e,
// M_post); ws the workspace of sav_th_q8_plan's out[11] bytes; out [B, L,
// D] bf16; residual 1 adds x. Needs H in {4, 6, 8, 16} and D % 32 == 0.
extern "C" int sav_th_attention_q8(
    const void* x, const float* ln_scale, const float* ln_bias,
    const void* wq, const void* wk, const void* wv, const void* wo,
    const float* sq, const float* sk, const float* sv, const float* so,
    const float* mix, void* ws, void* out, int batch, int seq, int dim,
    int heads, int residual, float eps, float q_scale, void* stream) {
  using namespace sav::q8g;
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_geometry(batch, seq, dim, heads)) return (int)cudaErrorInvalidValue;
  const int m = batch * seq, hd = heads * sav::thb::TD;
  const Workspace lay(m, dim, hd);
  unsigned char* w = (unsigned char*)ws;
  auto at = [&](Region r) { return (void*)(w + lay.at[r]); };
  int8_t* wqkv = (int8_t*)at(kWqkv);

  Transposes tr = {};
  const void* ins[4] = {wq, wk, wv, wo};
  for (int i = 0; i < 4; ++i) {
    tr.in[i] = (const int8_t*)ins[i];
    tr.rows[i] = i < 3 ? dim : hd;
    tr.cols[i] = i < 3 ? hd : dim;
    tr.ld[i] = i < 3 ? dim : hd;
    tr.out[i] = i < 3 ? wqkv + (size_t)i * hd * dim : (int8_t*)at(kWo);
  }
  const int per = transpose_blocks(
      transpose_tiles(hd, dim) > transpose_tiles(dim, hd)
          ? transpose_tiles(hd, dim) : transpose_tiles(dim, hd));
  ln_codes_kernel<<<4 * per + (m + 7) / 8, 256, 0, st>>>(
      tr, 4, per, (const sav::bf16*)x, ln_scale, ln_bias, eps,
      (int8_t*)at(kYq), (float*)at(kYs), m, dim);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  Args a = {};
  a.m = m;
  a.k = dim;
  a.n = 3 * hd;
  a.n_each = hd;
  a.rs = (const float*)at(kYs);
  a.cs[0] = sq;
  a.cs[1] = sk;
  a.cs[2] = sv;
  a.q_scale = q_scale;
  void* const qkv[3] = {at(kQ), at(kK), at(kV)};
  int err = launch<QKV, TILE>(at(kYq), dim, wqkv, dim, qkv, hd, a, st);
  if (err) return err;

  auto core = heads == 4   ? sav::thf::run_q8<4>
              : heads == 6 ? sav::thf::run_q8<6>
              : heads == 8 ? sav::thf::run_q8<8>
                           : sav::thf::run_q8<16>;
  err = core(at(kQ), at(kK), at(kV), mix, at(kAq), (float*)at(kAs), batch,
             seq, st);
  if (err) return err;

  Args o = {};
  o.m = m;
  o.k = hd;
  o.n = dim;
  o.n_each = dim;
  o.rs = (const float*)at(kAs);
  o.cs[0] = o.cs[1] = o.cs[2] = so;
  o.q_scale = 1.f;
  o.x = residual ? (const sav::bf16*)x : nullptr;
  void* const outs[3] = {out, out, out};
  return launch<OUT, TILE>(at(kAq), hd, at(kWo), hd, outs, dim, o, st);
}
