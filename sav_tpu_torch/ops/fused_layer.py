"""The pre-LN attention sublayer ``x + W_o @ MHA(LN(x))`` and the post-LN
one ``x + W_o @ MHA(x)`` (CeiT's) as one differentiable call each
(counterpart of ``sav_tpu/ops/fused_layer.py``).

Three cores, as in the JAX package:
  * ``'xla'``   - plain torch everywhere (the name is the JAX package's).
  * ``'flash'`` - LN and projections as library GEMMs, the attention core
                  on the K4 port (``flash_attention.flash_fwd``).
  * ``'fused'`` - the whole forward span on the K1 port
                  (``fused_attention_fwd``, ``csrc/fused_attention.cu``).
Under autograd the sublayer is one ``torch.autograd.Function`` whose
residuals are flash-style for every core, ``(x, q, k, v, attn, lse)``: no
``[B, H, L, L]`` tensor is saved. Its backward follows ``_sublayer_bwd``:
the out-projection, weight-gradient and LayerNorm backward as library ops,
the attention core on the K2/K3 port (``flash_attention.flash_bwd``; the
plain twin on the ``'xla'`` core); without the LN (``pre_ln=False``) the
weight gradients read x where the pre-LN span reads LN(x), and dx is dy
(+ g). A call with grad off (inference, eval) runs the forward that writes
no residuals.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sav_tpu_torch import _build
from sav_tpu_torch.nn.posembed import apply_rotary_heads, sincos_frequencies
from sav_tpu_torch.ops import flash_attention as fa
from sav_tpu_torch.ops.int8_matmul_kernel import _quantize_tile
from sav_tpu_torch.ops.quantized import int_matmul, quantize_symmetric

CORES = ('xla', 'flash', 'fused')
LN_EPS = 1e-6
# the tile of the port's 128-wide GEMM contracts (K5a's route, K10, K16)
GEMM_TILE = 128
# the column tiles of the projection GEMM (csrc/proj_sm90.cuh, plan_bn),
# widest first, and the depth of one of its steps
PROJ_TILES, PROJ_STEP = (256, 192, 128), 64


def _layernorm(x, scale, bias, eps):
    """Flax-compatible LayerNorm (fast variance, f32 stats).

    Returns (y in x.dtype, xhat f32, inv f32); xhat/inv feed the backward.
    """
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mu) * inv
    return (xhat * scale.float() + bias.float()).to(x.dtype), xhat, inv


def _ln_f32(x2, scale, bias, eps):
    """The int8 kernels' in-kernel LayerNorm on flat ``[M, D]`` rows:
    ((a - mu) * rsqrt(var + eps)) * scale + bias in f32 with the fast
    variance, never rounded to x's dtype. Returns (a, y), a = f32(x)."""
    a = x2.float()
    mu = a.mean(dim=1, keepdim=True)
    var = torch.clamp((a * a).mean(dim=1, keepdim=True) - mu * mu, min=0.0)
    y = ((a - mu) * torch.rsqrt(var + eps)) * scale.float().reshape(1, -1) \
        + bias.float().reshape(1, -1)
    return a, y


def _layernorm_bwd(dy, xhat, inv, scale):
    """(dx, dscale, dbias) of LayerNorm from the saved normalized stats,
    all f32."""
    dyf = dy.float()
    dscale = (dyf * xhat).sum(dim=(0, 1))
    dbias = dyf.sum(dim=(0, 1))
    dxhat = dyf * scale.float()
    dx = inv * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx, dscale, dbias


def _wgrad(a, b):
    """``a^T b`` over the flattened leading axes with an f32 result, as the
    JAX package's ``preferred_element_type=f32`` weight gradients. bf16
    operands on the card go through cuBLAS with ``out_dtype=float32`` (bf16
    products, f32 sums and output): rounding dW to bf16 first, as a plain
    bf16 matmul would, loses about three digits of every weight gradient
    before the f32 optimizer sees it; an f32 GEMM costs ~15x the time."""
    a2 = a.reshape(-1, a.shape[-1])
    b2 = b.reshape(-1, b.shape[-1])
    if a2.is_cuda and a2.dtype == torch.bfloat16:
        return torch.mm(a2.t(), b2, out_dtype=torch.float32)
    return a2.t().float() @ b2.float()


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


def proj_takes(n_each: int, k: int) -> bool:
    """Whether the projection GEMM takes an output width ``n_each`` and a
    depth ``k`` (``proj::takes``): a tile of ``PROJ_TILES`` divides
    ``n_each`` (multiples of 128, and 192, 576, ... of 192) and ``k`` is
    whole 64-deep steps. D = 192 (ceit_t, vit_ti) is one 192-column tile
    and three steps."""
    return (k >= PROJ_STEP and k % PROJ_STEP == 0 and n_each > 0
            and (n_each % 128 == 0 or n_each % 192 == 0))


def proj_takes_ragged(n_each: int, k: int) -> bool:
    """Whether the projection GEMM takes ``n_each`` and ``k`` at all
    (``proj::takes_ragged``, K5a's guard): multiples of 32, the last column
    tile and 64-deep step ragged where they are not whole (cait_xs's D =
    H*48 = 288). ``proj_takes`` is the whole-tile subset K1 takes."""
    return k >= 32 and k % 32 == 0 and n_each >= 32 and n_each % 32 == 0


def proj_plan(m: int, n_each: int, parts: int, k: int, sms: int) -> dict:
    """Launch geometry of the projection GEMM of K1 and K5a (the QKV and
    out products, ``csrc/proj_sm90.cuh``), mirrored from its ``plan_bn``
    and ``Plan``: persistent units of 128 rows x ``bn`` columns of the M x
    (``parts`` x ``n_each``) output (``parts`` = 3 for q, k, v; 1 for the
    out product), ``bn`` the one of 256, 192 and 128 dividing ``n_each`` (a
    tile never straddles two weights; where none divides it, as at 288,
    any of the three with ``ceil(n_each / bn)`` tiles a weight, the last
    ragged) whose estimated time is least: ``rounds`` = ceil(units / sms)
    rounds of a unit costing ``bn`` + 48 columns' worth, ties to the wider
    tile. ``smem``: the kernel's dynamic shared memory (a ring of
    ``stages`` slots, 3 at bn = 256 and else 4, each a 128 x 64 box of A
    and bn / 64 boxes of 64 x 64 of the weight; two 64 x bn bf16 staging
    tiles for the TMA stores; the mbarriers; 1024 bytes of alignment
    slack); ``steps``: 64-deep steps a unit, a ceiling. Raises ValueError
    where ``proj_takes_ragged`` fails."""
    if not proj_takes_ragged(n_each, k):
        raise ValueError(f'the projection GEMM needs N and K to be multiples '
                         f'of 32, got N={n_each}, K={k}')
    if m < 1 or parts not in (1, 3):
        raise ValueError(f'the projection GEMM takes M >= 1 rows and 1 or 3 '
                         f'weights, got M={m}, parts={parts}')
    slots = max(sms, 1)
    whole = n_each % 128 == 0 or n_each % 192 == 0
    best = None
    for bn in PROJ_TILES:
        if n_each % bn and whole:
            continue
        units = -(-m // 128) * parts * -(-n_each // bn)
        cost = -(-units // slots) * (bn + 48)
        if best is None or cost < best[0]:
            best = (cost, bn, units)
    _, bn, units = best
    stages = 3 if bn == 256 else 4
    smem = (stages * (128 * 64 * 2 + 64 * bn * 2) + 2 * 64 * bn * 2
            + 2 * stages * 8 + 1024)
    return dict(bn=bn, units=units, rounds=-(-units // slots),
                steps=-(-k // PROJ_STEP), stages=stages, smem=smem)


def fused_attention_fwd_plain(x, scale, bias, wq, wk, wv, wo, heads, eps,
                              save_residuals=False, residual=True,
                              pre_ln=True):
    """Plain twin of ``fused_attention_fwd``, rounding where the TPU kernel
    ``_fused_fwd_kernel`` rounds: y (LN(x), or x itself without
    ``pre_ln``), q, k, v, each head's output band and the result in
    x.dtype; products accumulated in f32; x added in f32 when
    ``residual``."""
    b, l, dim = x.shape
    hd = wq.shape[1]
    d = hd // heads
    dt = x.dtype
    y = (_layernorm(x, scale, bias, eps)[0] if pre_ln else x).float()
    q = ((y @ wq.float()) * (1.0 / d ** 0.5)).to(dt)
    k = (y @ wk.float()).to(dt)
    v = (y @ wv.float()).to(dt)
    split = lambda a: a.reshape(b, l, heads, d).float()
    s = torch.einsum('bqhd,bkhd->bhqk', split(q), split(k))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    band = torch.einsum('bhqk,bkhd->bhqd', p.to(dt).float(), split(v)) / lsum
    attn = band.to(dt).permute(0, 2, 1, 3).reshape(b, l, hd)
    out = attn.float() @ wo.float()
    out = (x.float() + out if residual else out).to(dt)
    if not save_residuals:
        return out
    return out, (q, k, v, attn, (m + torch.log(lsum))[..., 0])


def _k1_lib():
    fn = _build.library('fused_attention').sav_fused_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fused_attention_fwd(x, scale, bias, wq, wk, wv, wo, heads: int,
                        eps: float = LN_EPS, save_residuals: bool = False,
                        residual: bool = True, pre_ln: bool = True):
    """Port of K1: ``x + W_o @ MHA(LN(x))`` in one call; with
    ``residual=False`` the sublayer alone, ``W_o @ MHA(LN(x))`` (the out
    GEMM's epilogue skips the add, as the TPU kernel does; TNT's outer
    sublayer adds the pre-bridge stream itself); with ``pre_ln=False`` the
    post-LN span ``x + W_o @ MHA(x)`` (CeiT's; scale and bias are not read
    and may be None).

    x ``[B, L, D]``; scale, bias ``[D]``; wq, wk, wv ``[D, H*d]`` and wo
    ``[H*d, D]`` in x's dtype. On a CUDA tensor: the hand-written kernels
    (four launches, see ``csrc/fused_attention.cu``: LN, the ``wgmma``
    QKV GEMM of ``proj_plan``, K4's attention kernel, the out GEMM; three
    without the LN, the QKV GEMM reading x), bf16 only, d = 64, D and H*d
    widths ``proj_takes`` (multiples of 128, and 192). On a CPU tensor: the
    plain twin.

    Returns ``out``; with ``save_residuals`` (the training variant)
    ``(out, (q, k, v, attn, lse))``: q (pre-scaled), k, v and attn as
    ``[B, L, H*d]``, lse ``[B, H, L]`` f32, the backward's residuals. The
    LN output y is not kept (``B*L*D`` bf16 a layer, 58 MB at ViT-B @224
    bs192): the backward recomputes it with the LN statistics it needs
    anyway, as the JAX package does.
    """
    if x.device.type == 'cpu':
        return fused_attention_fwd_plain(x, scale, bias, wq, wk, wv, wo,
                                         heads, eps, save_residuals, residual,
                                         pre_ln)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_attention_fwd runs on cuda or cpu, not {x.device}')
    fa.check_no_grad(*[t for t in (x, scale, bias, wq, wk, wv, wo)
                       if t is not None])
    b, l, dim = x.shape
    hd = heads * fa.BAND
    for name, t in (('x', x), ('wq', wq), ('wk', wk), ('wv', wv), ('wo', wo)):
        fa.check_cuda_bf16(name, t, x.device)
    if not (proj_takes(dim, hd) and proj_takes(hd, dim)):
        raise ValueError(f'fused_attention_fwd needs D and H*{fa.BAND} to be '
                         f'multiples of 128, or of 192 (proj_takes), got '
                         f'D={dim}, H={heads}')
    for name, t, shape in (('wq', wq, (dim, hd)), ('wk', wk, (dim, hd)),
                           ('wv', wv, (dim, hd)), ('wo', wo, (hd, dim))):
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {shape}')
    y = None
    if pre_ln:
        scale = scale.to(x.device, torch.float32).contiguous()
        bias = bias.to(x.device, torch.float32).contiguous()
        y = torch.empty(b * l, dim, dtype=x.dtype, device=x.device)
    qkva = [torch.empty(b, l, hd, dtype=x.dtype, device=x.device)
            for _ in range(4)]                    # q, k, v, attn
    lse = (torch.empty(b, heads, l, dtype=torch.float32, device=x.device)
           if save_residuals else None)
    out = torch.empty_like(x)
    fn = _k1_lib()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), ptr(scale if pre_ln else None),
                 ptr(bias if pre_ln else None),
                 wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), wo.data_ptr(),
                 ptr(y), *[t.data_ptr() for t in qkva], out.data_ptr(),
                 ptr(lse), b, l, dim, heads, int(residual), int(pre_ln), eps,
                 1.0 / math.sqrt(fa.BAND),
                 fa.stream_of(x.device))
    _build.check(err, 'fused_attention_fwd')
    # the post-LN route counts under names of its own
    name = 'fused_attention_fwd' + ('' if pre_ln else '_noln')
    if not save_residuals:
        _build.count(name)
        return out
    _build.count(name + '_train')
    return out, (*qkva, lse)


def fused_supported(l: int, num_heads: int, head_d: int) -> bool:
    """Whether the K1 port takes the shape. Its GEMM (``proj_plan``) takes
    N and K where ``proj_takes`` holds (multiples of 128, and 192), so H*d
    (= D in the models that call it) must be such a width, and its
    attention core is written for d = 64. Any L works: every launch masks
    its ragged row tail, so (unlike the TPU kernel) no single-block limit."""
    hd = num_heads * head_d
    return l >= 1 and head_d == fa.BAND and proj_takes(hd, hd)


def auto_core(l: int, num_heads: int, head_ch: int, device):
    """The core ``use_kernel='auto'`` picks on this device and shape, or
    None for the per-op path.

    On the card: ``'fused'`` wherever the K1 port takes the shape;
    otherwise ``'flash'`` where the K4 port does (d = 64 and at least one
    full 64-row query tile); else None. Off the card None, as the JAX
    package does off the TPU. ViT-B/16 on an H100 (80GB HBM3, 700 W),
    ``'fused'`` (``use_kernel='auto'``) against ``'flash'`` (torch
    LayerNorm, library projections, K4; ``use_kernel='fused_layer'``) in one
    call of ``scripts/torch_train_ab.py``: serving @224 bs32 2216-3431
    against 1893-2480 img/s (host-bound, both spread), training @224 bs192
    1694-1718 against 1582-1583 and @384 bs48 540-542 against 501; the
    sublayer alone at B = 32, 0.1027 against 0.2864 ms at L = 197 and
    0.3033 against 0.7151 at L = 577 (``chip_smoke.py``). No shape of these
    sits on the flash side.
    """
    if torch.device(device).type != 'cuda':
        return None
    if fused_supported(l, num_heads, head_ch):
        return 'fused'
    if head_ch == fa.BAND and l >= 64:
        return 'flash'
    return None


def _forward(x, scale, bias, wq, wk, wv, wo, num_heads, core, eps,
             residual, rotary, save_residuals, pre_ln=True):
    """(out, residuals): residuals ``(q, k, v, attn, lse)`` on the
    ``[B, L, H*d]`` layout (q pre-scaled and, with ``rotary``, rotated) when
    ``save_residuals``, else None. Without ``pre_ln`` the projections read
    x itself (scale and bias unused)."""
    b, l, dim = x.shape
    head_d = wq.shape[2]
    hd = num_heads * head_d
    cdt = x.dtype

    if core == 'fused':
        ws = [w.reshape(dim, hd).to(cdt) for w in (wq, wk, wv)]
        ws.append(wo.reshape(hd, dim).to(cdt))
        if save_residuals:
            return fused_attention_fwd(x, scale, bias, *ws, num_heads, eps,
                                       save_residuals=True, residual=residual,
                                       pre_ln=pre_ln)
        return fused_attention_fwd(x, scale, bias, *ws, num_heads, eps,
                                   residual=residual, pre_ln=pre_ln), None

    y = _layernorm(x, scale, bias, eps)[0] if pre_ln else x
    qs, k, v = _project_qkv(y, wq, wk, wv, num_heads, head_d)
    if rotary:
        freqs = sincos_frequencies(l, head_d, device=x.device)
        qs = apply_rotary_heads(qs, freqs)
        k = apply_rotary_heads(k, freqs)
    qs, k, v = (t.reshape(b, l, hd).contiguous() for t in (qs, k, v))

    if core == 'xla':
        attn, lse = fa.attention_plain(*(t.reshape(b, l, num_heads, head_d)
                                         for t in (qs, k, v)))
        attn = attn.reshape(b, l, hd)
    else:
        attn, lse = fa.flash_fwd(qs, k, v, num_heads, l)

    out = attn @ wo.reshape(hd, dim).to(cdt)
    if residual:
        out = x + out
    return out, ((qs, k, v, attn, lse) if save_residuals else None)


class _AttentionSublayer(torch.autograd.Function):
    """``_sublayer_fwd``/``_sublayer_bwd`` of the JAX package; with
    ``pre_ln=False`` (scale and bias None) ``_sublayer_noln_fwd``/
    ``_sublayer_noln_bwd``."""

    @staticmethod
    def forward(ctx, x, scale, bias, wq, wk, wv, wo, num_heads, core, eps,
                residual, rotary, pre_ln):
        out, res = _forward(x, scale, bias, wq, wk, wv, wo, num_heads, core,
                            eps, residual, rotary, save_residuals=True,
                            pre_ln=pre_ln)
        ctx.save_for_backward(x, scale, bias, wq, wk, wv, wo, *res)
        ctx.config = (num_heads, core, eps, residual, rotary, pre_ln)
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, wq, wk, wv, wo, qs, k, v, attn, lse = ctx.saved_tensors
        num_heads, core, eps, residual, rotary, pre_ln = ctx.config
        b, l, dim = x.shape
        head_d = wq.shape[2]
        hd = num_heads * head_d
        cdt = x.dtype
        sc = torch.full((), 1.0 / math.sqrt(head_d), dtype=cdt, device=x.device)
        w2 = [w.reshape(dim, hd).to(cdt) for w in (wq, wk, wv)]
        g_c = g.to(cdt)

        # output projection backward (library GEMMs)
        d_attn = g_c @ wo.reshape(hd, dim).to(cdt).t()
        dwo = _wgrad(attn, g_c)
        bwd = fa.flash_bwd_plain if core == 'xla' else fa.flash_bwd
        dqs, dk, dv = bwd(qs, k, v, attn, lse, d_attn.contiguous(), num_heads,
                          l)
        dq = dqs * sc                           # undo the q pre-scaling
        if rotary:
            # q/k were rotated after projection; the rotation is orthogonal,
            # so the cotangent goes back through the negated table
            freqs = sincos_frequencies(l, head_d, device=x.device)
            unrot = lambda a: apply_rotary_heads(
                a.reshape(b, l, num_heads, head_d), -freqs).reshape(b, l, hd)
            dq, dk = unrot(dq), unrot(dk)

        # projection weight gradients and dy; y recomputed from x (or x
        # itself without the LN)
        if pre_ln:
            y, xhat, inv = _layernorm(x, scale, bias, eps)
        else:
            y = x
        dwq, dwk, dwv = (_wgrad(y, t) for t in (dq, dk, dv))
        dy = dq @ w2[0].t() + dk @ w2[1].t() + dv @ w2[2].t()
        dscale = dbias = None
        if pre_ln:
            dx_ln, dscale, dbias = _layernorm_bwd(dy, xhat, inv, scale)
            dscale, dbias = dscale.to(scale.dtype), dbias.to(bias.dtype)
        else:
            dx_ln = dy.float()
        dx = (dx_ln + g.float()).to(cdt) if residual else dx_ln.to(cdt)
        shape_w = (dim, num_heads, head_d)
        return (dx, dscale, dbias,
                dwq.reshape(shape_w).to(wq.dtype),
                dwk.reshape(shape_w).to(wk.dtype),
                dwv.reshape(shape_w).to(wv.dtype),
                dwo.reshape(num_heads, head_d, dim).to(wo.dtype),
                None, None, None, None, None, None)


def attention_sublayer(x, scale, bias, wq, wk, wv, wo, num_heads,
                       core='flash', eps=LN_EPS, residual=True, rotary=False):
    """``x + W_o @ MHA(LN(x))``, differentiable in all seven tensors.

    Args:
      x: ``[B, L, D]`` activations.
      scale, bias: LayerNorm parameters ``[D]``.
      wq, wk, wv: projection kernels ``[D, H, d]`` (checkpoint layout).
      wo: merged output kernel ``[H, d, D]``.
      num_heads, core, eps, residual, rotary: as in the JAX package;
        ``core`` in ``CORES``.
    """
    if core not in CORES:
        raise ValueError(f'core must be one of {CORES}, got {core!r}')
    if rotary and core == 'fused':
        core = 'flash'          # rotation is not in the fused kernel (yet)
    args = (x, scale, bias, wq, wk, wv, wo)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _AttentionSublayer.apply(*args, num_heads, core, eps, residual,
                                        rotary, True)
    return _forward(*args, num_heads, core, eps, residual, rotary,
                    save_residuals=False)[0]


def attention_sublayer_noln(x, wq, wk, wv, wo, num_heads, core='flash',
                            residual=True):
    """``x + W_o @ MHA(x)``: the post-LN attention sublayer (CeiT's encoder
    blocks normalise after the residual, outside this span), differentiable
    in its five tensors. Same cores, residuals and residual policy as
    ``attention_sublayer``; on the ``'fused'`` core the K1 port's post-LN
    route (three launches: QKV GEMM on x, K4's attention, out GEMM + x).

    Args:
      x: ``[B, L, D]`` activations.
      wq, wk, wv: projection kernels ``[D, H, d]``; wo: ``[H, d, D]``.
      num_heads, core, residual: as in ``attention_sublayer``.
    """
    if core not in CORES:
        raise ValueError(f'core must be one of {CORES}, got {core!r}')
    args = (x, None, None, wq, wk, wv, wo)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wq, wk, wv, wo)):
        return _AttentionSublayer.apply(*args, num_heads, core, LN_EPS,
                                        residual, False, False)
    return _forward(*args, num_heads, core, LN_EPS, residual, False,
                    save_residuals=False, pre_ln=False)[0]


# ------------------------- int8 serving forward (K10): projections in int8

SERVING_ONLY = (
    "quantized='all' runs the attention sublayer on K10, a serving-only "
    'forward with no backward (as in the JAX package); call it under '
    'torch.no_grad() or torch.inference_mode(), and train with '
    "quantized='ff' or True")


def fused_attention_q8_plain(x, scale, bias, wq_q, sq, wk_q, sk, wv_q, sv,
                             wo_q, so, heads, eps=LN_EPS, residual=True):
    """Plain twin of ``fused_attention_q8``, following
    ``_fused_infer_q8_kernel``: LN in f32, one per-row quantisation of it
    for q, k and v; q = (f32(acc) * (ys * sq)) / sqrt(d) and k, v rounded to
    x's dtype; f32 logits, max, exp and sum, p rounded to x's dtype for the
    PV product, then divided by the sum; the heads' bands in x's dtype
    quantised per row over H*d; x + the out projection in f32."""
    b, l, dim = x.shape
    hd = wq_q.shape[1]
    d = hd // heads
    dt = x.dtype
    xf, y = _ln_f32(x.reshape(b * l, dim), scale, bias, eps)
    yq, ys = _quantize_tile(y)

    def proj(w_q, s):
        return int_matmul(yq, w_q).float() * (ys * s)

    split = lambda t: t.reshape(b, l, heads, d).float()
    q = split((proj(wq_q, sq) * (1.0 / d ** 0.5)).to(dt))
    k = split(proj(wk_q, sk).to(dt))
    v = split(proj(wv_q, sv).to(dt))
    s = torch.einsum('bqhd,bkhd->bhqk', q, k)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    lsum = p.sum(dim=-1, keepdim=True)
    band = torch.einsum('bhqk,bkhd->bhqd', p.to(dt).float(), v) / lsum
    attn = band.to(dt).permute(0, 2, 1, 3).reshape(b * l, hd)
    aq, a_s = _quantize_tile(attn)
    out = int_matmul(aq, wo_q).float() * (a_s * so)
    if residual:
        out = xf + out
    return out.to(dt).reshape(b, l, dim)


# K10's launch plan (csrc/fused_attention_q8.cu): the projections' GEMMs
# (q8_gemm_sm90.cuh) take 128-row units, 128-deep ring slots (four) and
# QKV's and OUT's column tile Q8_TILE; the core, 64-row units of one image
# over every head, three consumer warpgroups each with a ring of K/V slots
Q8_ROWS, Q8_TILE, Q8_SLOT_K, Q8_SLOTS = 128, 128, 128, 4
Q8_REGIONS = ('yq', 'ys', 'wqkv', 'wo', 'q', 'k', 'v', 'aq', 'as', 'stage')
CORE_ROWS, CORE_MAX_STAGES, CORE_WGS = 64, 4, 3


def _core_smem(hd: int) -> tuple:
    """K10's core at H*64 = hd: (shared memory, ring slots a warpgroup,
    whether the bands are staged in shared memory), as ``core_plan`` in
    the C source: a q slot (a 64 x 64 box) for each of the three consumer
    warpgroups, each one's ring of K and V boxes, the staging tile (64 rows
    of hd + 8 bf16) where it fits beside at least two slots, the rows'
    absmax of each warpgroup, the mbarriers, 1024 bytes of alignment
    slack; where the tile does not fit it lies in the workspace and the
    rings take four slots."""
    box, w = 64 * 64 * 2, CORE_WGS
    for staged in (True, False):
        for stages in range(CORE_MAX_STAGES, 1, -1):
            smem = (w * box + w * stages * 2 * box
                    + (CORE_ROWS * (hd + 8) * 2 if staged else 0)
                    + w * CORE_ROWS * 4 + w * (2 + 2 * stages) * 8 + 1024)
            if smem <= fa.SMEM_LIMIT:
                return smem, stages, staged
    raise AssertionError('four ring slots always fit')


def fused_q8_plan(b: int, l: int, dim: int, heads: int) -> dict:
    """Launch plan of K10, mirrored from ``sav_fused_q8_plan`` in
    ``csrc/fused_attention_q8.cu``: ``tile`` (the column tile of the QKV
    and the OUT GEMMs), ``row_tiles`` (128 rows of B*L), ``units`` of the
    two GEMMs (QKV: each of q, k and v its own column tiles) and of the
    ``core`` (64 query rows of one image over every head), ``slots`` (the
    GEMMs' 128-deep ring slots a unit: over D, over H*64; the core's K/V
    slots a warpgroup), ``smem`` of the three kernels, ``staged`` (the core
    stages a unit's bf16 bands in shared memory, or in the workspace past
    what fits there) and the workspace the C entry carves: ``scratch``
    (name -> (offset, bytes): y's codes and scales, the transposed codes of
    Wq|Wk|Wv [3 H*64, D] and of Wo [D, H*64], q, k, v [B*L, H*64] bf16, the
    bands' codes and scales, the core's staging tiles (none where they are
    staged in shared memory), each at a 256-byte offset) and
    ``workspace`` (their total). Raises ValueError where the kernels do not
    take the geometry (D and H*64 multiples of 128)."""
    hd = heads * fa.BAND
    if b < 1 or l < 1 or heads < 1 or dim < GEMM_TILE or dim % GEMM_TILE \
            or hd % GEMM_TILE:
        raise ValueError(f'fused_attention_q8 needs D and H*{fa.BAND} to be '
                         f'multiples of {GEMM_TILE}, got B={b}, L={l}, '
                         f'D={dim}, H={heads}')
    m = b * l
    cdiv = lambda x, y: -(-x // y)
    rows = cdiv(m, Q8_ROWS)
    core_units = b * cdiv(l, CORE_ROWS)
    core_smem, stages, staged = _core_smem(hd)

    def smem(t, out):
        # four slots of a 128-row A box and a t-row B box, a 64 x t bf16
        # staging tile a consumer warpgroup, OUT's two 128 x t bf16 x tiles,
        # the mbarriers, alignment slack
        return (Q8_SLOTS * (Q8_ROWS + t) * Q8_SLOT_K + 2 * 64 * t * 2
                + (2 * Q8_ROWS * t * 2 + 4 * 8 if out else 0)
                + 2 * Q8_SLOTS * 8 + 1024)

    regions, at = {}, 0
    for name, nbytes in zip(Q8_REGIONS, (
            m * dim, 4 * m, 3 * hd * dim, dim * hd, 2 * m * hd, 2 * m * hd,
            2 * m * hd, m * hd, 4 * m,
            0 if staged else core_units * CORE_ROWS * (hd + 8) * 2)):
        regions[name] = (at, nbytes)
        at += cdiv(nbytes, 256) * 256
    return dict(tile={'qkv': Q8_TILE, 'out': Q8_TILE}, row_tiles=rows,
                units={'qkv': rows * 3 * (hd // Q8_TILE),
                       'out': rows * cdiv(dim, Q8_TILE), 'core': core_units},
                slots={'qkv': dim // Q8_SLOT_K, 'out': hd // Q8_SLOT_K,
                       'core': stages},
                smem={'qkv': smem(Q8_TILE, False),
                      'out': smem(Q8_TILE, True),
                      'core': core_smem},
                staged=staged, scratch=regions, workspace=at)


def _k10_lib():
    fn = _build.library('fused_attention_q8').sav_fused_attention_q8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _fused_q8_into(x, scale, bias, codes, scales, heads, eps, residual, out):
    """K10's four launches on checked operands, writing ``out`` (``[B, L,
    D]``, or the first B*L rows of a longer ``[*, D]`` buffer)."""
    b, l, dim = x.shape
    dev = x.device
    vec = lambda t, n: t.reshape(n).to(dev, torch.float32).contiguous()
    hd = heads * fa.BAND
    ws = torch.empty(fused_q8_plan(b, l, dim, heads)['workspace'],
                     dtype=torch.uint8, device=dev)
    # every buffer is held by a name until the launches are queued; the
    # kernels transpose the weight codes into the workspace
    bufs = [x, vec(scale, dim), vec(bias, dim),
            *[w.contiguous() for w in codes],
            *[vec(s, n) for s, n in zip(scales, (hd, hd, hd, dim))], ws, out]
    with torch.cuda.device(dev):
        err = _k10_lib()(*[t.data_ptr() for t in bufs], b, l, dim, heads,
                         int(residual), eps, 1.0 / math.sqrt(fa.BAND),
                         fa.stream_of(dev))
    _build.check(err, 'fused_attention_q8')


def fused_attention_q8(x, scale, bias, wq_q, sq, wk_q, sk, wv_q, sv, wo_q, so,
                       heads: int, eps: float = LN_EPS, residual: bool = True):
    """Port of K10: ``x + W_o @ MHA(LN(x))`` with int8 projections, serving
    only (raises under autograd).

    x ``[B, L, D]``; wq_q, wk_q, wv_q ``[D, H*d]`` and wo_q ``[H*d, D]``
    int8 codes with per-column f32 scales ``[1, H*d]`` / ``[1, D]``. On a
    CUDA tensor: four launches (``csrc/fused_attention_q8.cu``: the codes
    transposed in the workspace beside LN(x)'s codes, the QKV and OUT GEMMs
    on s8 ``wgmma`` + TMA around a ``wgmma`` + TMA attention core that takes
    the bands' codes), bf16 x, d = 64, D and H*d multiples of 128, any L.
    On a CPU tensor: the plain twin.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        raise RuntimeError(SERVING_ONLY)
    if x.device.type == 'cpu':
        return fused_attention_q8_plain(x, scale, bias, wq_q, sq, wk_q, sk,
                                        wv_q, sv, wo_q, so, heads, eps,
                                        residual)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_attention_q8 runs on cuda or cpu, not {x.device}')
    fa.check_cuda_bf16('x', x, x.device)
    b, l, dim = x.shape
    hd = heads * fa.BAND
    if dim % GEMM_TILE or hd % GEMM_TILE:
        raise ValueError(f'fused_attention_q8 needs D and H*{fa.BAND} to be '
                         f'multiples of {GEMM_TILE}, got D={dim}, H={heads}')
    for name, t, shape in (('wq_q', wq_q, (dim, hd)), ('wk_q', wk_q, (dim, hd)),
                           ('wv_q', wv_q, (dim, hd)), ('wo_q', wo_q, (hd, dim))):
        if t.dtype != torch.int8 or tuple(t.shape) != shape:
            raise ValueError(f'{name} must be int8 {shape}, got {t.dtype} '
                             f'{tuple(t.shape)}')
    out = torch.empty_like(x)
    _fused_q8_into(x, scale, bias, (wq_q, wk_q, wv_q, wo_q), (sq, sk, sv, so),
                   heads, eps, residual, out)
    _build.count('fused_attention_q8')
    return out


def q8_supported(l: int, dim: int, num_heads: int, head_d: int) -> bool:
    """Whether the K10 port takes the shape: d = 64, and D and H*d
    multiples of 128, as ``fused_q8_plan`` requires. Any L."""
    hd = num_heads * head_d
    return (l >= 1 and head_d == fa.BAND and dim >= GEMM_TILE
            and dim % GEMM_TILE == 0 and hd % GEMM_TILE == 0)


def _q8_weights(wq, wk, wv, wo, dim, hd):
    """Per-column codes and scales of the four projection kernels, from
    their f32 values: [(wq_q, sq), (wk_q, sk), (wv_q, sv), (wo_q, so)]."""
    qs = [quantize_symmetric(w.reshape(dim, hd).float(), axis=0)
          for w in (wq, wk, wv)]
    return qs + [quantize_symmetric(wo.reshape(hd, dim).float(), axis=0)]


def attention_sublayer_q8(x, scale, bias, wq, wk, wv, wo, num_heads,
                          eps=LN_EPS, residual=True, core='kernel'):
    """Serving-only ``x + W_o @ MHA(LN(x))`` with int8 projections (K10).

    Same parameters as ``attention_sublayer`` (minus its core). Where
    ``q8_supported`` refuses the shape (K10 takes narrower widths than K1:
    ViT-Ti's D = 192 is K1's but not K10's) it runs the bf16 sublayer on
    the ``'flash'`` core, as the JAX package falls back off its kernel's
    geometry. Raises under autograd on either route. ``core='plain'`` runs
    K10's twin on any device (the card's reference for the kernel).
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias, wq, wk, wv, wo)):
        raise RuntimeError(SERVING_ONLY)
    b, l, dim = x.shape
    head_d = wq.shape[2]
    if not q8_supported(l, dim, num_heads, head_d):
        return attention_sublayer(x, scale, bias, wq, wk, wv, wo, num_heads,
                                  core='flash', eps=eps, residual=residual)
    (wq_q, sq), (wk_q, sk), (wv_q, sv), (wo_q, so) = _q8_weights(
        wq, wk, wv, wo, dim, num_heads * head_d)
    fwd = fused_attention_q8 if core == 'kernel' else fused_attention_q8_plain
    return fwd(x, scale, bias, wq_q, sq, wk_q, sk, wv_q, sv, wo_q, so,
               num_heads, eps, residual)


# ----------------------------------------- FF sublayer, kernel backward

# tanh-approximation constants of jax.nn.gelu(approximate=True), and the
# gelu helpers of sav_tpu/ops/tnt_inner.py:103-116 (K8's and K16's twins)
_GELU_C = 0.7978845608028654        # sqrt(2/pi)
_GELU_A = 0.044715


def _gelu_fwd_t(hp):
    t = torch.tanh(_GELU_C * (hp + _GELU_A * hp * hp * hp))
    return 0.5 * hp * (1.0 + t), t


def _gelu_bwd_from_t(hp, t):
    return (0.5 * (1.0 + t)
            + 0.5 * hp * (1.0 - t * t) * _GELU_C
            * (1.0 + 3.0 * _GELU_A * hp * hp))


def ff_kernel_supported(dim: int, hidden: int) -> bool:
    """Whether the K16 port takes the FF geometry: its products run in
    whole 128-wide tiles along D and F (ViT-B 768/3072, ViT-L 1024/4096).
    Rows are any count: the tail row tile is masked in-kernel. This is the
    card's tiling, not the TPU's VMEM ceiling (``_ff_geometry``)."""
    return dim >= 1 and hidden >= 1 and dim % GEMM_TILE == 0 \
        and hidden % GEMM_TILE == 0


def ff_refusal(dim: int, hidden: int, device) -> str | None:
    """Why ``use_kernel='fused_ff'`` does not take D = ``dim`` and FF width
    ``hidden`` on ``device``, or None where it does. Off the card the
    Function runs its plain twins at any width, as the JAX package runs
    192/768; on the card K16 needs whole 128-wide tiles
    (``ff_kernel_supported``), and a width it does not tile is refused
    rather than run per-op unasked."""
    if dim < 1 or hidden < 1:
        return 'D and the FF hidden width must be at least 1'
    if torch.device(device).type == 'cuda' and \
            not ff_kernel_supported(dim, hidden):
        return (f'K16 on the card takes D and the FF hidden width in whole '
                f'{GEMM_TILE}-wide tiles, got {dim} and {hidden} (ROADMAP.md '
                f'Queue 2 item 12); use_kernel=False runs the per-op path')
    return None


def ff_bwd_plain(g2, hpre2, y2, w1, w2):
    """Plain twin of ``ff_bwd``, following ``_ff_bwd_kernel`` line by line:
    dgact = g W2^T (f32); dh = dgact * gelu'(hpre) in f32, rounded to g's
    dtype; h = gelu(hpre) in g's dtype; dW2 = h^T g, dW1 = y^T dh (f32);
    dy = dh W1^T in g's dtype; db1 = column sums of the f32 dh."""
    hp = hpre2.float()
    dgact = g2.float() @ w2.float().t()
    h, t = _gelu_fwd_t(hp)
    dh32 = dgact * _gelu_bwd_from_t(hp, t)
    dh = dh32.to(g2.dtype)
    h = h.to(g2.dtype)
    dw2 = h.float().t() @ g2.float()
    dw1 = y2.float().t() @ dh.float()
    dy2 = (dh.float() @ w1.float().t()).to(g2.dtype)
    return dy2, dw1, dw2, dh32.sum(dim=0)


# K16's launch plan (csrc/ff_bwd_sm90.cuh): 128 x 256 output tiles (a 128 x
# 128 quadrant to each of two consumer warpgroups), 64-deep steps, a ring
# of 4 slots of A and B (48 KB a slot), split-K of the weight gradients
# into at most 16 chunks
FF_TILE, FF_TILE_N, FF_STEP, FF_STAGES, FF_MAX_CHUNKS = 128, 256, 64, 4, 16


def ff_bwd_plan(m: int, dim: int, hidden: int, sms: int = 132) -> dict:
    """Launch plan of the K16 kernels on ``sms`` SMs, mirrored from
    ``sav_ff_bwd_plan`` in ``csrc/ff_bwd.cu``: ``row_tiles`` (128-row tiles
    of the dgact and dy products, and db1 partials), ``steps`` (64-row
    depth steps of the weight gradients over M), ``chunks`` and
    ``steps_per_chunk`` (their split-K: the chunk count, none empty, that
    least takes ceil(units / SMs) rounds of a chunk's steps plus the
    partials' write and sum), ``units`` of the three GEMM launches
    (``dgact``, ``dy``, ``dw``; 128 x 256 tiles), ``smem`` (dynamic shared
    memory) and the f32 scratch the wrapper allocates (``part_floats``,
    ``colsum_floats``). Raises ValueError where the kernel does not take
    the geometry."""
    if m < 1 or not ff_kernel_supported(dim, hidden):
        raise ValueError(f'ff_bwd needs M >= 1 and D, F multiples of '
                         f'{FF_TILE}, got M={m}, D={dim}, F={hidden}')
    row_tiles, steps = -(-m // FF_TILE), -(-m // FF_STEP)
    cols = lambda n: -(-n // FF_TILE_N)
    tiles = dim // FF_TILE * cols(hidden) + hidden // FF_TILE * cols(dim)
    best = None
    for s in range(1, min(FF_MAX_CHUNKS, steps) + 1):
        per = -(-steps // s)
        if -(-steps // per) != s:               # a chunk would be empty
            continue
        cost = 6 * -(-(tiles * s) // max(sms, 1)) * per + s * tiles
        if best is None or cost < best[0]:
            best = (cost, s, per)
    _, chunks, per = best
    smem = (FF_STAGES * (FF_TILE + FF_TILE_N) * FF_STEP * 2  # the ring
            + 2 * 4 * FF_TILE * 4                            # column sums
            + 2 * FF_STAGES * 8 + 1024)              # mbarriers, alignment
    return dict(row_tiles=row_tiles, steps=steps, chunks=chunks,
                steps_per_chunk=per,
                units={'dgact': row_tiles * cols(hidden),
                       'dy': row_tiles * cols(dim), 'dw': tiles * chunks},
                smem=smem, part_floats=chunks * 2 * dim * hidden,
                colsum_floats=row_tiles * hidden)


def _k16_fn(name):
    fn = getattr(_build.library('ff_bwd'), name)
    if fn.argtypes is None:
        if name == 'sav_ff_bwd':
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
        else:                                   # sav_ff_bwd_plan
            fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ff_bwd_into(g2, hpre2, y2, w1, w2, dy2):
    """K16's launches with dy written into ``dy2`` (``[M, D]``, or the first
    M rows of a longer buffer); returns (dw1, dw2, db1)."""
    m, dim = g2.shape
    hidden = hpre2.shape[-1]
    dev = g2.device
    plan = ff_bwd_plan(m, dim, hidden,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    dh, h = (torch.empty(m, hidden, dtype=g2.dtype, device=dev)
             for _ in range(2))
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty(plan['part_floats'], **f32)
    colsum = torch.empty(plan['colsum_floats'], **f32)
    dw = torch.empty(2 * dim * hidden, **f32)
    db1 = torch.empty(hidden, **f32)
    with torch.cuda.device(dev):
        err = _k16_fn('sav_ff_bwd')(
            g2.data_ptr(), hpre2.data_ptr(), y2.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), dh.data_ptr(), h.data_ptr(), dy2.data_ptr(),
            part.data_ptr(), colsum.data_ptr(), dw.data_ptr(), db1.data_ptr(),
            m, dim, hidden, plan['chunks'], fa.stream_of(dev))
    _build.check(err, 'ff_bwd')
    _build.count('ff_bwd')
    return (dw[:dim * hidden].view(dim, hidden),
            dw[dim * hidden:].view(hidden, dim), db1)


def ff_bwd(g2, hpre2, y2, w1, w2):
    """Port of K16 ``_ff_bwd_kernel``: g2, y2 ``[M, D]``, hpre2 ``[M, F]``,
    w1 ``[D, F]``, w2 ``[F, D]`` -> (dy2 ``[M, D]``, dw1 ``[D, F]`` f32, dw2
    ``[F, D]`` f32, db1 ``[F]`` f32). On the card (``csrc/ff_bwd.cu``, one
    call): the dgact GEMM with the gelu' epilogue writing dh, gelu(hpre)
    and per-row-tile db1 partials; dy = dh W1^T; dW1 and dW2 in one launch
    split over M (``ff_bwd_plan``), each chunk's partial and the db1
    partials summed in a fixed order. The GEMMs are ``wgmma`` + TMA
    (``csrc/ff_bwd_sm90.cuh``). bf16 only; no float atomics."""
    if g2.device.type == 'cpu':
        return ff_bwd_plain(g2, hpre2, y2, w1, w2)
    if g2.device.type != 'cuda':
        raise ValueError(f'ff_bwd runs on cuda or cpu, not {g2.device}')
    m, dim = g2.shape
    hidden = hpre2.shape[-1]
    for name, t in (('g2', g2), ('hpre2', hpre2), ('y2', y2), ('w1', w1),
                    ('w2', w2)):
        fa.check_cuda_bf16(name, t, g2.device)
    for name, t, shape in (('hpre2', hpre2, (m, hidden)), ('y2', y2, (m, dim)),
                           ('w1', w1, (dim, hidden)),
                           ('w2', w2, (hidden, dim))):
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {shape}')
    ff_bwd_plan(m, dim, hidden)                 # raises on the geometry
    dy2 = torch.empty_like(g2)
    return (dy2, *_ff_bwd_into(g2, hpre2, y2, w1, w2, dy2))


def _ff_fwd_res(x, scale2, bias2, w1, b1, w2, b2, eps, residual):
    """The library forward: (out, hpre), hpre = LN(x) W1 + b1 in x.dtype."""
    cdt = x.dtype
    y2 = _layernorm(x, scale2, bias2, eps)[0]
    hpre = y2 @ w1.to(cdt) + b1.to(cdt)
    out = torch.nn.functional.gelu(hpre, approximate='tanh') @ w2.to(cdt) \
        + b2.to(cdt)
    return (x + out if residual else out), hpre


class _FFSublayer(torch.autograd.Function):
    """``_ff_sublayer_fwd``/``_ff_sublayer_bwd`` of the JAX package."""

    @staticmethod
    def forward(ctx, x, scale2, bias2, w1, b1, w2, b2, eps, residual):
        out, hpre = _ff_fwd_res(x, scale2, bias2, w1, b1, w2, b2, eps,
                                residual)
        ctx.save_for_backward(x, scale2, bias2, w1, b1, w2, b2, hpre)
        ctx.config = (eps, residual)
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale2, bias2, w1, b1, w2, b2, hpre = ctx.saved_tensors
        eps, residual = ctx.config
        b, l, dim = x.shape
        hidden = w1.shape[1]
        cdt = x.dtype
        g_c = g.to(cdt)
        y2, xhat2, inv2 = _layernorm(x, scale2, bias2, eps)
        dy2, dw1, dw2, db1 = ff_bwd(
            g_c.reshape(b * l, dim).contiguous(),
            hpre.reshape(b * l, hidden).contiguous(),
            y2.reshape(b * l, dim).contiguous(), w1.to(cdt).contiguous(),
            w2.to(cdt).contiguous())
        db2 = g.float().sum(dim=(0, 1))
        dx_ln, dscale2, dbias2 = _layernorm_bwd(dy2.reshape(b, l, dim), xhat2,
                                                inv2, scale2)
        dx = (dx_ln + g.float()).to(cdt) if residual else dx_ln.to(cdt)
        return (dx, dscale2.to(scale2.dtype), dbias2.to(bias2.dtype),
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype), None, None)


def ff_sublayer(x, scale2, bias2, w1, b1, w2, b2, eps=LN_EPS, residual=True):
    """``x + W2 @ gelu(W1 @ LN(x) + b1) + b2`` with the library forward and
    the K16 backward (``ff_bwd``); ``residual=False`` leaves x out, as in
    the JAX package. Differentiable in all seven tensors."""
    args = (x, scale2, bias2, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FFSublayer.apply(*args, eps, residual)
    return _ff_fwd_res(*args, eps, residual)[0]
