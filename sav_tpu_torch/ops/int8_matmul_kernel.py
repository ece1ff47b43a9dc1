"""Block-wise int8 matmul (counterpart of
``sav_tpu/ops/int8_matmul_kernel.py``).

``int8_matmul_fused`` is the port of K15 ``_kernel``: ``a [M, K] @
deq(b_q [K, N] int8, b_scale [1, N] f32)``, the activations quantised per
(row, 256-wide k-block) from their f32 values, int32 sums per block, each
block's sums folded into an f32 accumulator with its row scale in k order,
the column scales applied at the end. On a CUDA tensor it launches
``csrc/int8_matmul.cu`` (its launch plan mirrored by ``int8_matmul_plan``);
on a CPU tensor it runs the plain twin ``blockwise_int8_matmul_reference``,
which follows the TPU kernel's arithmetic step by step. ``int8_dense_fused`` wraps it with the
straight-through backward of ``_core_bwd`` (``QuantizedDense(fused=True)``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sav_tpu_torch import _build
from sav_tpu_torch.ops import flash_attention as fa
from sav_tpu_torch.ops.quantized import int_matmul, quantize_symmetric

BLOCK_K = 256       # the activations' scale granularity: part of the function


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _quantize_tile(a: torch.Tensor):
    """Per-row symmetric int8 quantization of a tile, in f32 whatever a's
    dtype: (int8 codes, f32 scale [rows, 1])."""
    a = a.float()
    absmax = torch.clamp(a.abs().amax(dim=1, keepdim=True), min=1e-8)
    scale = absmax / torch.full_like(absmax, 127.0)     # IEEE, on the card too
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return q, scale


def blockwise_int8_matmul_reference(a, b_q, b_scale):
    """Plain twin of the kernel (same block granularity and dtypes): a
    padded with zero columns to whole 256-wide blocks, each block quantised
    per row, ``acc = acc + f32(int32 part) * scale`` block by block, then
    ``acc * b_scale`` in a's dtype."""
    m, k = a.shape
    kp = _round_up(k, BLOCK_K)
    a_p = F.pad(a, (0, kp - k))
    bq_p = F.pad(b_q, (0, 0, 0, kp - k))
    acc = torch.zeros(m, b_q.shape[1], dtype=torch.float32, device=a.device)
    for kk in range(kp // BLOCK_K):
        tile = a_p[:, kk * BLOCK_K:(kk + 1) * BLOCK_K]
        aq, scale = _quantize_tile(tile)
        part = int_matmul(aq, bq_p[kk * BLOCK_K:(kk + 1) * BLOCK_K])
        acc = acc + part.float() * scale
    return (acc * b_scale).to(a.dtype)


def _k15_lib():
    fn = _build.library('int8_matmul').sav_int8_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


# The GEMM's unit (128 x 128 output tiles), its ring slots' depth (two a
# k-block) and its slots
TILE, SLOT_K, SLOTS = 128, 128, 4


def int8_matmul_plan(m: int, k: int, n: int) -> dict:
    """Launch plan of K15, mirrored from ``sav_int8_matmul_plan`` in
    ``csrc/int8_matmul.cu`` (``csrc/q8_gemm_sm90.cuh``): ``row_tiles`` and
    ``col_tiles`` (128 each), ``units`` (the persistent blocks take unit i
    + j grid, column tiles fastest), ``k_blocks`` (256 codes each, the last
    ragged), ``slots`` (ring slots a unit: two 128-deep a k-block), ``ldk``
    (the codes' row stride: K rounded up to 16, TMA's row-stride unit),
    ``ldo`` (the output's row stride: N rounded up to 8), ``smem`` (dynamic
    shared memory: four slots of a 128 x 128 A and B box, a 64 x 128 bf16
    staging tile for each of the two consumer warpgroups, the mbarriers,
    alignment slack) and the workspace the C entry carves: ``scratch``
    (name -> (offset, bytes): the weight codes transposed [N, ldk], a's
    codes [M, ldk] and scales [M, k_blocks] f32, each at a 256-byte
    offset) and ``workspace`` (their total bytes). Raises ValueError where
    the kernel does not take the geometry (M, K >= 1, N even)."""
    if m < 1 or k < 1 or n < 2 or n % 2:
        raise ValueError(f'int8_matmul_fused needs M, K >= 1 and an even N, '
                         f'got M={m}, K={k}, N={n}')
    cdiv = lambda x, y: -(-x // y)
    ldk = _round_up(k, 16)
    kb = cdiv(k, BLOCK_K)
    regions, at = {}, 0
    for name, nbytes in (('bt', n * ldk), ('aq', m * ldk), ('as', 4 * m * kb)):
        regions[name] = (at, nbytes)
        at += _round_up(nbytes, 256)
    rows, cols = cdiv(m, TILE), cdiv(n, TILE)
    smem = (SLOTS * 2 * TILE * SLOT_K       # the ring: A and B boxes
            + 2 * 64 * TILE * 2             # two staging tiles
            + 2 * SLOTS * 8 + 1024)         # mbarriers, alignment
    return dict(row_tiles=rows, col_tiles=cols, units=rows * cols,
                k_blocks=kb, slots=2 * kb, ldk=ldk, ldo=_round_up(n, 8),
                smem=smem, scratch=regions, workspace=at)


def _check(a, b_q, b_scale):
    m, k = a.shape
    n = b_q.shape[1]
    if b_q.dtype != torch.int8 or tuple(b_q.shape) != (k, n):
        raise ValueError(f'b_q must be int8 [{k}, N], got {b_q.dtype} '
                         f'{tuple(b_q.shape)}')
    if tuple(b_scale.shape) != (1, n):
        raise ValueError(f'b_scale must be [1, {n}], got {tuple(b_scale.shape)}')
    return int8_matmul_plan(m, k, n)


def _int8_matmul_into(a, b_q, b_scale, out):
    """K15's three launches on checked operands, writing ``out``: [M, N]
    bf16 with rows ``ldo`` elements apart (a view of the first M rows of a
    longer buffer, or of the first N columns of [M, ldo])."""
    m, k = a.shape
    n = b_q.shape[1]
    plan = int8_matmul_plan(m, k, n)
    if out.stride() != (plan['ldo'], 1) or out.dtype != torch.bfloat16:
        raise ValueError(f'out must be bf16 with rows {plan["ldo"]} apart, '
                         f'got {out.dtype} strides {out.stride()}')
    ws = torch.empty(plan['workspace'], dtype=torch.uint8, device=a.device)
    # every buffer is held by a name until the launches are queued; the
    # kernels transpose the weight codes into the workspace
    bufs = [a, b_q.contiguous(),
            b_scale.reshape(n).to(torch.float32).contiguous(), ws, out]
    with torch.cuda.device(a.device):
        err = _k15_lib()(*[t.data_ptr() for t in bufs], m, k, n,
                         fa.stream_of(a.device))
    _build.check(err, 'int8_matmul_fused')


def int8_matmul_fused(a, b_q, b_scale):
    """Port of K15: ``a [M, K] @ deq(b_q [K, N] int8, b_scale [1, N] f32)``
    in a's dtype. On a CUDA tensor: three launches (``csrc/int8_matmul.cu``:
    the weight codes transposed, a's per-block codes, the s8 ``wgmma`` +
    TMA GEMM with the in-order fold), bf16 a, any M and K, N even (where
    N % 8 != 0 the result is a view of rows N rounded up to 8 apart). On
    a CPU tensor: the twin."""
    if a.device.type == 'cpu':
        return blockwise_int8_matmul_reference(a, b_q, b_scale)
    if a.device.type != 'cuda':
        raise ValueError(f'int8_matmul_fused runs on cuda or cpu, not {a.device}')
    fa.check_no_grad(a)
    fa.check_cuda_bf16('a', a, a.device)
    plan = _check(a, b_q, b_scale)
    m, n = a.shape[0], b_q.shape[1]
    out = torch.empty(m, plan['ldo'], dtype=a.dtype, device=a.device)[:, :n]
    _int8_matmul_into(a, b_q, b_scale, out)
    _build.count('int8_matmul')
    return out


def _int8_dense_core_fwd(a, kernel, core):
    b_q, b_scale = quantize_symmetric(kernel, axis=0)
    if core == 'plain':
        return blockwise_int8_matmul_reference(a, b_q, b_scale)
    return int8_matmul_fused(a, b_q, b_scale)


class _Int8DenseCore(torch.autograd.Function):
    """``_int8_dense_core``: the K15 forward, the straight-through
    backward of ``_core_bwd`` (gradients as if the product were
    unquantized, f32 products)."""

    @staticmethod
    def forward(ctx, a, kernel, core):
        ctx.save_for_backward(a, kernel)
        return _int8_dense_core_fwd(a, kernel, core)

    @staticmethod
    def backward(ctx, g):
        a, kernel = ctx.saved_tensors
        ga = g.float() @ kernel.float().t()
        gk = a.float().t() @ g.float()
        return ga.to(a.dtype), gk.to(kernel.dtype), None


def int8_dense_fused(x, kernel, bias=None, core='kernel'):
    """Dense forward through K15; x [..., K], kernel [K, N]. The kernel is
    cast to x's dtype first and quantised per column in that dtype's
    arithmetic (``quantize_symmetric``), as in the JAX package.
    ``core='plain'`` runs K15's twin on any device."""
    if core not in ('kernel', 'plain'):
        raise ValueError(f"core must be 'kernel' or 'plain', got {core!r}")
    flat = x.reshape(-1, x.shape[-1])
    kern = kernel.to(x.dtype)
    if torch.is_grad_enabled() and (flat.requires_grad or kern.requires_grad):
        out = _Int8DenseCore.apply(flat, kern, core)
    else:
        out = _int8_dense_core_fwd(flat, kern, core)
    out = out.reshape(*x.shape[:-1], kernel.shape[-1])
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)
