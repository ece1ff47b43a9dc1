"""Dynamic symmetric int8 matmul (counterpart of ``sav_tpu/ops/quantized.py``).

  * ``quantize_symmetric``: per-slice int8 codes and f32 scales, the
    arithmetic in the input's dtype;
  * ``int8_matmul``: int8 x int8 -> int32, rescaled to f32, with a
    straight-through backward (gradients as if the product were f32);
  * ``quantized_dense``: a dense forward through ``int8_matmul``.

This is the ``--quantized int8`` route (``QuantizedDense(fused=False)``).
The JAX package has no Pallas kernel on it: its int32 product is XLA's.
Here it is the library's ``torch._int_mm`` (exact on the CPU and the card),
or a float64 product of the codes where ``_int_mm`` does not take the shape
(also exact: every partial sum stays far below 2^53).
"""

from __future__ import annotations

import torch


def quantize_symmetric(x: torch.Tensor, axis: int):
    """Per-slice symmetric int8 quantization along ``axis``'s complement:
    (int8 codes, f32 scale broadcastable against x). The arithmetic stays in
    x's dtype, as in the JAX package; ``round`` is half-to-even. The 127 is
    a tensor: PyTorch divides a CUDA tensor by a Python number as a multiply
    by its reciprocal, which is not the IEEE division the kernels use."""
    absmax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.maximum(absmax, torch.tensor(1e-8, dtype=x.dtype,
                                               device=x.device))
    scale = scale / torch.full_like(scale, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def int_matmul(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 ``qa [M, K]`` and ``qb [K, N]``."""
    m, k = qa.shape
    n = qb.shape[1]
    if qa.device.type == 'cpu' or (m > 16 and k % 8 == 0 and n % 8 == 0):
        return torch._int_mm(qa.contiguous(), qb.contiguous())
    return (qa.double() @ qb.double()).to(torch.int32)


def int8_matmul_raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` via dynamic int8: per-row scales of a,
    per-column scales of b, int32 sums, f32 result."""
    qa, sa = quantize_symmetric(a, axis=1)
    qb, sb = quantize_symmetric(b, axis=0)
    return int_matmul(qa, qb).float() * sa * sb


class _Int8Matmul(torch.autograd.Function):
    """int8 forward, straight-through f32 backward (``_int8_matmul_bwd``)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return int8_matmul_raw(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = g.float() @ b.float().t()
        gb = a.float().t() @ g.float()
        return ga.to(a.dtype), gb.to(b.dtype)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 forward, straight-through backward; a [M, K], b [K, N]."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Int8Matmul.apply(a, b)
    return int8_matmul_raw(a, b)


def quantized_dense(x: torch.Tensor, kernel: torch.Tensor,
                    bias=None) -> torch.Tensor:
    """Dense layer forward through the int8 path; x [..., K], kernel [K, N].
    The f32 product plus bias is cast back to x's dtype."""
    flat = x.reshape(-1, x.shape[-1])
    out = int8_matmul(flat, kernel).reshape(*x.shape[:-1], kernel.shape[-1])
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)
