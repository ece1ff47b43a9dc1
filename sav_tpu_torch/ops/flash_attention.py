"""Flash attention forward on the head-band layout (counterpart of
``sav_tpu/ops/flash_attention.py``).

``flash_fwd`` is the port of the K4 kernel ``_fwd_kernel``: q, k, v as
``[B, L, H*d]`` (a free view of the projection output, q pre-scaled), out in
the same layout, lse ``[B, H, Lq]`` f32. On a CUDA tensor it launches the
hand-written kernel (``csrc/flash_fwd.cu``); on a CPU tensor it runs
``flash_fwd_plain``. No padding is needed: the kernel masks the ragged
query and key tails itself.
"""

from __future__ import annotations

import ctypes

import torch

from sav_tpu_torch import _build

BAND = 64               # the kernel's head width


def flash_fwd_plain(q, k, v, heads: int, kv_len: int):
    """Plain twin of ``flash_fwd``: exact softmax over the first ``kv_len``
    keys, probabilities rounded to v's dtype before the PV product (as the
    TPU kernel feeds its matmul), f32 accumulation."""
    b, q_len, hd = q.shape
    d = hd // heads
    q4 = q.reshape(b, q_len, heads, d).float()
    k4 = k[:, :kv_len].reshape(b, kv_len, heads, d).float()
    v4 = v[:, :kv_len].reshape(b, kv_len, heads, d)
    s = torch.einsum('bqhd,bkhd->bhqk', q4, k4)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum('bhqk,bkhd->bhqd', p.to(v.dtype).float(), v4.float()) / l
    out = out.permute(0, 2, 1, 3).reshape(b, q_len, hd).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def check_no_grad(*tensors) -> None:
    """The serving kernels have no backward yet: refuse to be differentiated."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            'this CUDA kernel is forward-only (serving); call it under '
            'torch.no_grad()/torch.inference_mode()')


def check_cuda_bf16(name: str, t: torch.Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != torch.bfloat16:
        raise ValueError(f'{name} must be bfloat16 for the kernel, got {t.dtype}')
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f'{name} must be contiguous and 16-byte aligned')


def stream_of(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _lib():
    lib = _build.library('flash_fwd')
    fn = lib.sav_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_fwd(q, k, v, heads: int, kv_len: int):
    """Attention over ``[B, L, H*d]`` head bands (q pre-scaled).

    Keys at or past ``kv_len`` are masked. Returns ``(out, lse)``: out like
    q, lse ``[B, H, Lq]`` float32.
    """
    if q.device.type == 'cpu':
        return flash_fwd_plain(q, k, v, heads, kv_len)
    if q.device.type != 'cuda':
        raise ValueError(f'flash_fwd runs on cuda or cpu, not {q.device}')
    check_no_grad(q, k, v)
    for name, t in (('q', q), ('k', k), ('v', v)):
        check_cuda_bf16(name, t, q.device)
    b, q_len, hd = q.shape
    if hd != heads * BAND:
        raise ValueError(f'flash_fwd needs head_dim {BAND}, got {hd}/{heads}')
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != hd:
        raise ValueError(f'k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do '
                         f'not match q {tuple(q.shape)}')
    if not 1 <= kv_len <= k.shape[1]:
        raise ValueError(f'kv_len {kv_len} outside [1, {k.shape[1]}]')
    out = torch.empty_like(q)
    lse = torch.empty(b, heads, q_len, dtype=torch.float32, device=q.device)
    fn = _lib()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, q_len, k.shape[1], kv_len, heads,
                 stream_of(q.device))
    _build.check(err, 'flash_fwd')
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def shape_supported(query, key, *, bias=None, pre_softmax_transform=None,
                    post_softmax_transform=None) -> bool:
    """Whether ``mha`` takes these ``[B, L, H, d]`` inputs on the card:
    plain attention (no bias or head mixing), d = 64, and at least one full
    64-row query tile (below that most of each block is padding)."""
    if (bias is not None or pre_softmax_transform is not None
            or post_softmax_transform is not None):
        return False
    return (query.ndim == 4 and key.ndim == 4 and query.shape[-1] == BAND
            and query.shape[-3] >= 64)


def mha(query, key, value):
    """Flash attention on ``[B, L, heads, d]`` (query pre-scaled), returning
    ``[B, Lq, heads, d]`` like ``sav_tpu_torch.ops.attention``'s plain path."""
    b, q_len, heads, d = query.shape
    kv_len = key.shape[1]
    out, _ = flash_fwd(query.reshape(b, q_len, heads * d).contiguous(),
                       key.reshape(b, kv_len, heads * d).contiguous(),
                       value.reshape(b, kv_len, heads * d).contiguous(),
                       heads, kv_len)
    return out.reshape(b, q_len, heads, d)
