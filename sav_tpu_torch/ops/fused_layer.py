"""The pre-LN attention sublayer ``x + W_o @ MHA(LN(x))`` as one call
(counterpart of ``sav_tpu/ops/fused_layer.py``, inference forward).

Three cores, as in the JAX package:
  * ``'xla'``   - plain torch everywhere (the name is the JAX package's).
  * ``'flash'`` - LN and projections as library GEMMs, the attention core
                  on the K4 port (``flash_attention.flash_fwd``).
  * ``'fused'`` - the whole span on the K1 port
                  (``fused_attention_fwd``, ``csrc/fused_attention.cu``).
This slice serves only: there is no backward, and the CUDA wrappers refuse
tensors that require grad while grad is enabled.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sav_tpu_torch import _build
from sav_tpu_torch.nn.posembed import apply_rotary_heads, sincos_frequencies
from sav_tpu_torch.ops import flash_attention as fa

CORES = ('xla', 'flash', 'fused')
LN_EPS = 1e-6
GEMM_TILE = 128         # the K1 port's GEMM tile along N and K


def _layernorm(x, scale, bias, eps):
    """Flax-compatible LayerNorm (fast variance, f32 stats) -> x.dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    xhat = (xf - mu) * torch.rsqrt(var + eps)
    return (xhat * scale.float() + bias.float()).to(x.dtype)


def _project_qkv(y, wq, wk, wv, num_heads, head_d):
    """q (pre-scaled), k, v as [B, L, H, d] from [D, H, d] kernels."""
    b, l, dim = y.shape
    hd = num_heads * head_d
    cdt = y.dtype
    sc = torch.full((), 1.0 / math.sqrt(head_d), dtype=cdt, device=y.device)
    qs = (y @ wq.reshape(dim, hd).to(cdt)) * sc
    k = y @ wk.reshape(dim, hd).to(cdt)
    v = y @ wv.reshape(dim, hd).to(cdt)
    return (qs.reshape(b, l, num_heads, head_d),
            k.reshape(b, l, num_heads, head_d),
            v.reshape(b, l, num_heads, head_d))


def _xla_core(qs, k, v):
    """Plain attention core on [B, L, H, d] (q pre-scaled) -> (attn, lse)."""
    logits = torch.einsum('bqhd,bkhd->bhqk', qs.float(), k.float())
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None]).to(v.dtype)
    return torch.einsum('bhqk,bkhd->bqhd', p, v), lse


def fused_attention_fwd_plain(x, scale, bias, wq, wk, wv, wo, heads, eps):
    """Plain twin of ``fused_attention_fwd``, rounding where the TPU kernel
    ``_fused_fwd_kernel`` rounds: y, q, k, v, each head's output band and
    the result in x.dtype; products accumulated in f32."""
    b, l, dim = x.shape
    hd = wq.shape[1]
    d = hd // heads
    dt = x.dtype
    y = _layernorm(x, scale, bias, eps).float()
    q = ((y @ wq.float()) * (1.0 / d ** 0.5)).to(dt)
    k = (y @ wk.float()).to(dt)
    v = (y @ wv.float()).to(dt)
    split = lambda a: a.reshape(b, l, heads, d).float()
    s = torch.einsum('bqhd,bkhd->bhqk', split(q), split(k))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    lsum = p.sum(dim=-1, keepdim=True)
    band = torch.einsum('bhqk,bkhd->bhqd', p.to(dt).float(), split(v)) / lsum
    attn = band.to(dt).permute(0, 2, 1, 3).reshape(b, l, hd)
    return (x.float() + attn.float() @ wo.float()).to(dt)


def _k1_lib():
    fn = _build.library('fused_attention').sav_fused_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fused_attention_fwd(x, scale, bias, wq, wk, wv, wo, heads: int,
                        eps: float = LN_EPS):
    """Port of K1: ``x + W_o @ MHA(LN(x))`` in one call.

    x ``[B, L, D]``; scale, bias ``[D]``; wq, wk, wv ``[D, H*d]`` and wo
    ``[H*d, D]`` in x's dtype. On a CUDA tensor: the hand-written kernels
    (four launches, see ``csrc/fused_attention.cu``), bf16 only, d = 64,
    D and H*d multiples of 128. On a CPU tensor: the plain twin.
    """
    if x.device.type == 'cpu':
        return fused_attention_fwd_plain(x, scale, bias, wq, wk, wv, wo,
                                         heads, eps)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_attention_fwd runs on cuda or cpu, not {x.device}')
    fa.check_no_grad(x, scale, bias, wq, wk, wv, wo)
    b, l, dim = x.shape
    hd = heads * fa.BAND
    for name, t in (('x', x), ('wq', wq), ('wk', wk), ('wv', wv), ('wo', wo)):
        fa.check_cuda_bf16(name, t, x.device)
    if dim % GEMM_TILE or hd % GEMM_TILE:
        raise ValueError(f'fused_attention_fwd needs D and H*{fa.BAND} to be '
                         f'multiples of {GEMM_TILE}, got D={dim}, H={heads}')
    for name, t, shape in (('wq', wq, (dim, hd)), ('wk', wk, (dim, hd)),
                           ('wv', wv, (dim, hd)), ('wo', wo, (hd, dim))):
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {shape}')
    scale = scale.to(x.device, torch.float32).contiguous()
    bias = bias.to(x.device, torch.float32).contiguous()
    scratch = [torch.empty(b * l, n, dtype=x.dtype, device=x.device)
               for n in (dim, hd, hd, hd, hd)]    # y, q, k, v, attn
    out = torch.empty_like(x)
    fn = _k1_lib()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), wo.data_ptr(),
                 *[t.data_ptr() for t in scratch], out.data_ptr(),
                 b, l, dim, heads, eps, 1.0 / math.sqrt(fa.BAND),
                 fa.stream_of(x.device))
    _build.check(err, 'fused_attention_fwd')
    fused_attention_fwd.launches += 1
    return out


fused_attention_fwd.launches = 0


def fused_supported(l: int, num_heads: int, head_d: int) -> bool:
    """Whether the K1 port takes the shape. Its GEMM tiles are 128 wide
    along N and K, so H*d (= D in ViT) must be a multiple of 128, and its
    attention core is written for d = 64. Any L works: every launch masks
    its ragged row tail, so (unlike the TPU kernel) no single-block limit."""
    return l >= 1 and head_d == fa.BAND and (num_heads * head_d) % GEMM_TILE == 0


def auto_core(l: int, num_heads: int, head_ch: int, device):
    """The core ``use_kernel='auto'`` picks on this device and shape, or
    None for the per-op path.

    On the card: ``'fused'`` wherever the K1 port takes the shape;
    otherwise ``'flash'`` where the K4 port does (d = 64 and at least one
    full 64-row query tile); else None. Off the card None, as the JAX
    package does off the TPU. At ViT-B, B = 32 on an H100 the K1 port beat
    the ``'flash'`` core (torch LayerNorm, library projections, K4) at both
    serving lengths, 0.206 vs 0.479 ms at L = 197 and 0.590 vs 0.794 ms at
    L = 577 (``chip_smoke.py``), so no length threshold sits between them.
    """
    if torch.device(device).type != 'cuda':
        return None
    if fused_supported(l, num_heads, head_ch):
        return 'fused'
    if head_ch == fa.BAND and l >= 64:
        return 'flash'
    return None


def attention_sublayer(x, scale, bias, wq, wk, wv, wo, num_heads,
                       core='flash', eps=LN_EPS, residual=True, rotary=False):
    """``x + W_o @ MHA(LN(x))`` (inference forward).

    Args:
      x: ``[B, L, D]`` activations.
      scale, bias: LayerNorm parameters ``[D]``.
      wq, wk, wv: projection kernels ``[D, H, d]`` (checkpoint layout).
      wo: merged output kernel ``[H, d, D]``.
      num_heads, core, eps, residual, rotary: as in the JAX package;
        ``core`` in ``CORES``.
    """
    b, l, dim = x.shape
    head_d = wq.shape[2]
    hd = num_heads * head_d
    cdt = x.dtype

    if rotary and core == 'fused':
        core = 'flash'          # rotation is not in the fused kernel (yet)
    if core == 'fused':
        if not residual:
            raise NotImplementedError(
                "core='fused' adds the residual in-kernel; residual=False "
                'waits for the TNT slice (ROADMAP.md)')
        return fused_attention_fwd(
            x, scale, bias, wq.reshape(dim, hd).to(cdt),
            wk.reshape(dim, hd).to(cdt), wv.reshape(dim, hd).to(cdt),
            wo.reshape(hd, dim).to(cdt), num_heads, eps)

    y = _layernorm(x, scale, bias, eps)
    qs, k, v = _project_qkv(y, wq, wk, wv, num_heads, head_d)
    if rotary:
        freqs = sincos_frequencies(l, head_d, device=x.device)
        qs = apply_rotary_heads(qs, freqs)
        k = apply_rotary_heads(k, freqs)

    if core == 'xla':
        attn, _ = _xla_core(qs, k, v)
    elif core == 'flash':
        outp, _ = fa.flash_fwd(qs.reshape(b, l, hd).contiguous(),
                               k.reshape(b, l, hd).contiguous(),
                               v.reshape(b, l, hd).contiguous(),
                               num_heads, l)
        attn = outp.reshape(b, l, num_heads, head_d)
    else:
        raise ValueError(f'core must be one of {CORES}, got {core!r}')

    out = attn.reshape(b, l, hd) @ wo.reshape(hd, dim).to(cdt)
    if residual:
        out = x + out
    return out
