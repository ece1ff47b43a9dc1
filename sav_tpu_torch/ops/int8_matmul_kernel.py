"""Block-wise int8 matmul (counterpart of
``sav_tpu/ops/int8_matmul_kernel.py``).

``int8_matmul_fused`` is the port of K15 ``_kernel``: ``a [M, K] @
deq(b_q [K, N] int8, b_scale [1, N] f32)``, the activations quantised per
(row, 256-wide k-block) from their f32 values, int32 sums per block, each
block's sums folded into an f32 accumulator with its row scale in k order,
the column scales applied at the end. On a CUDA tensor it launches
``csrc/int8_matmul.cu``; on a CPU tensor it runs the plain twin
``blockwise_int8_matmul_reference``, which follows the TPU kernel's
arithmetic step by step. ``int8_dense_fused`` wraps it with the
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
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def int8_matmul_fused(a, b_q, b_scale):
    """Port of K15: ``a [M, K] @ deq(b_q [K, N] int8, b_scale [1, N] f32)``
    in a's dtype. On a CUDA tensor: two launches (``csrc/int8_matmul.cu``:
    the per-block codes of a, then the int8 GEMM with the fold), bf16 a,
    N even; the weight codes go in transposed and zero-padded to whole
    k-blocks (a copy of N * K bytes per call). On a CPU tensor: the twin."""
    if a.device.type == 'cpu':
        return blockwise_int8_matmul_reference(a, b_q, b_scale)
    if a.device.type != 'cuda':
        raise ValueError(f'int8_matmul_fused runs on cuda or cpu, not {a.device}')
    fa.check_no_grad(a)
    fa.check_cuda_bf16('a', a, a.device)
    m, k = a.shape
    n = b_q.shape[1]
    if b_q.dtype != torch.int8 or tuple(b_q.shape) != (k, n):
        raise ValueError(f'b_q must be int8 [{k}, N], got {b_q.dtype} '
                         f'{tuple(b_q.shape)}')
    if tuple(b_scale.shape) != (1, n):
        raise ValueError(f'b_scale must be [1, {n}], got {tuple(b_scale.shape)}')
    if m < 1 or n % 2:
        raise ValueError(f'int8_matmul_fused needs M >= 1 and an even N, got '
                         f'M={m}, N={n}')
    kp = _round_up(k, BLOCK_K)
    bt = F.pad(b_q.t(), (0, kp - k)).contiguous()
    bs = b_scale.reshape(n).to(torch.float32).contiguous()
    aq = torch.empty(m, kp, dtype=torch.int8, device=a.device)
    a_scale = torch.empty(m, kp // BLOCK_K, dtype=torch.float32, device=a.device)
    out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = _k15_lib()(a.data_ptr(), bt.data_ptr(), bs.data_ptr(),
                         aq.data_ptr(), a_scale.data_ptr(), out.data_ptr(),
                         m, k, n, fa.stream_of(a.device))
    _build.check(err, 'int8_matmul_fused')
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
