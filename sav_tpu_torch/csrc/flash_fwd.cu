// K4 port: the flash attention forward, on the Hopper kernel of
// flash_fwd_sm90.cuh (which K1's attention launch shares).
//
// Replaces sav_tpu/ops/flash_attention.py::_fwd_kernel (launcher _fwd).
// Same function: q, k, v as [B, L, H*64] bf16 head bands with q
// pre-scaled, out in the input layout and dtype, lse [B, H, Lq] f32, keys
// past kv_len masked to -inf. The TPU version's single-kv-block fast path
// has no counterpart: the online carry of one tile costs one rescale.
#include "flash_fwd_sm90.cuh"

// Dynamic shared memory of the kernel; mirrored by fwd_plan in
// ops/flash_attention.py.
extern "C" int sav_flash_fwd_smem() { return sav::k4::SMEM; }

extern "C" int sav_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, float* lse, int batch, int q_len,
                             int kv_rows, int kv_len, int heads,
                             void* stream) {
  return sav::k4::flash_fwd(q, k, v, out, lse, batch, q_len, kv_rows, kv_len,
                            heads, (cudaStream_t)stream);
}
