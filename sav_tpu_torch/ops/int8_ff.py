"""The whole int8 FF forward on the card's kernels (counterpart of
``sav_tpu/ops/int8_ff.py``).

``int8_ff_raw`` is the port of K12 ``_ff_kernel``: gelu(q(x) W1q (xs s1) +
b1) quantised per row over all F columns from its f32 values, times W2q
(hs s2), + b2. ``int8_ff_ln_raw`` is the port of K13 ``_ff_ln_kernel``: x +
the same FF fed LN(x). With ``save_hpre`` both also return the
pre-activation in bf16 ``[M, F]`` from the same pass (the training
variant). On a CUDA tensor each makes six launches of ``csrc/int8_ff.cu``
(``csrc/int8_ff_sm90.cuh``): the weights' codes transposed to the K-major
operands 8-bit ``wgmma`` reads; x's codes (LN first for K13); a persistent s8
``wgmma`` + TMA GEMM with the hpre and gelu epilogue writing each row's
absmax partials (and bf16 hpre); the rows' scales; the same product and
epilogue again for the hidden codes; the second product with the b2 (+ x)
epilogue. On a CPU tensor each runs its plain twin (``int8_ff_reference``,
``int8_ff_ln_reference``), which follows the TPU kernel's arithmetic step
by step. The weights are quantised per column by ``_quantized_weights``
outside the kernel, per call, as the JAX package quantises them in XLA.

Autograd, as in the JAX package: ``int8_ff`` (the bare core, LN outside:
the Mixer's and CaiT's ``FFBlock(quantized='ff')``) has the f32
straight-through backward ``_ff_bwd``; ``int8_ff_sublayer`` (LN + FF +
residual, one boundary: ViT's ``'ff'``/``'all'``) has ``_sublayer_bwd``,
bf16 [M, 4D] elementwise work, f32-accumulated weight gradients, and the
LayerNorm backward from statistics recomputed from x. Both backwards are
library work on the stored bf16 hpre.

The SwitchBack backward (``int8_ff(switchback=True)``: ``_ff_sb_bwd``;
``int8_ff_sublayer_sb``: ``_sublayer_sb_bwd``) runs both dx products in
int8 on K14 (``int8_ff_dx_raw``, the port of ``_ff_dx_kernel``): g's codes
times W2's codes per IN row, gelu' of the stored hpre, dh's codes times
W1's codes per IN row, returning dy and the bf16 dh. The weight gradients
stay bf16 products with f32 sums, as in the JAX package. Its plain twin is
``int8_ff_dx_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from sav_tpu_torch import _build
from sav_tpu_torch.ops import flash_attention as fa
from sav_tpu_torch.ops.fused_layer import (LN_EPS, _gelu_bwd_from_t,
                                           _gelu_fwd_t, _layernorm, _ln_f32,
                                           _wgrad)
from sav_tpu_torch.ops.int8_matmul_kernel import _quantize_tile
from sav_tpu_torch.ops.quantized import int_matmul, quantize_symmetric

_GELU_C = 0.7978845608028654        # sqrt(2/pi) as f32 rounds it
_GELU_A = 0.044715
CORES = ('kernel', 'plain')


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` in its own order of operations:
    x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))), in x's
    dtype."""
    cdf = 0.5 * (1.0 + torch.tanh(_GELU_C * (x + _GELU_A * (x * x * x))))
    return x * cdf


def gelu_vjp(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The cotangent of ``gelu`` at x for the output cotangent g, in x's
    dtype (K16's closed form of gelu')."""
    return g * _gelu_bwd_from_t(x, _gelu_fwd_t(x)[1])


def gelu_vjp_f32(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The cotangent of ``gelu`` at f32 x for the f32 output cotangent g,
    in the operation order of ``jax.vjp(jax.nn.gelu)``'s f32 graph (K14's
    and its twin's): e = 3 x^2; i = tanh(c (x + a x^3)); p = (0.5 (x g))
    (1 - i); s = c (p + p i); (g (0.5 (1 + i)) + s) + (a s) e."""
    x2 = x * x
    i = torch.tanh(_GELU_C * (x + _GELU_A * (x * x2)))
    p = (0.5 * (x * g)) * (1.0 - i)
    s = _GELU_C * (p + p * i)
    return (g * (0.5 * (1.0 + i)) + s) + (_GELU_A * s) * (3.0 * x2)


def _ff_body(xq, xs, w1_q, s1, b1, w2_q, s2, b2):
    """The shared part of both twins: (f32 out before any residual, f32
    hpre) from the input codes."""
    hpre = int_matmul(xq, w1_q).float() * (xs * s1) + b1.reshape(1, -1).float()
    hq, hs = _quantize_tile(gelu(hpre))
    y = int_matmul(hq, w2_q).float() * (hs * s2) + b2.reshape(1, -1).float()
    return y, hpre


def int8_ff_reference(x, w1_q, s1, b1, w2_q, s2, b2, save_hpre=False):
    """Plain twin of ``int8_ff_raw``. Quantisation is per row, so the TPU
    kernel's 256-row blocks need no counterpart here."""
    xq, xs = _quantize_tile(x)
    y, hpre = _ff_body(xq, xs, w1_q, s1, b1, w2_q, s2, b2)
    out = y.to(x.dtype)
    return (out, hpre.to(torch.bfloat16)) if save_hpre else out


def int8_ff_ln_reference(x, scale, bias, w1_q, s1, b1, w2_q, s2, b2,
                         eps=LN_EPS, save_hpre=False):
    """Plain twin of ``int8_ff_ln_raw``: x + FF(LN(x)), LN in f32 and its
    f32 output quantised (never rounded to x's dtype first)."""
    a, y2 = _ln_f32(x, scale, bias, eps)
    xq, xs = _quantize_tile(y2)
    f, hpre = _ff_body(xq, xs, w1_q, s1, b1, w2_q, s2, b2)
    out = (a + f).to(x.dtype)
    return (out, hpre.to(torch.bfloat16)) if save_hpre else out


def _ff_lib(name):
    fn = getattr(_build.library('int8_ff'), name)
    if fn.argtypes is None:
        if name == 'sav_int8_ff_dx':
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
        elif name in ('sav_int8_ff_plan', 'sav_int8_ff_dx_plan'):
            fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        else:
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


# The int8 GEMMs' tile (K12, K13 and K14: int8_sm90.cuh), the first
# product's ring slots' depth, the second's, and the slots a team
DX_TILE, DX_STAGE, DX_STAGE_DY, DX_RING = 128, 64, 128, 5


def _q8_plan(m, dim, hidden, what, first, second, scratch):
    """The launch plan the int8 GEMMs of K12/K13 and K14 share: ``first``
    names the first product's [M, F] tiles, ``second`` the second's [M, D];
    ``scratch`` names the workspace's regions in order (the five both
    have, then K12/K13's two transposed weight codes, [D, F] each)."""
    if m < 1 or dim < 64 or hidden < 64 or dim % 32 or hidden % 32:
        raise ValueError(f'{what} needs M >= 1 and D, F multiples of 32 (at '
                         f'least 64: int8 rows 16-byte aligned for TMA), got '
                         f'M={m}, D={dim}, F={hidden}')
    cdiv = lambda a, b: -(-a // b)
    row_tiles = cdiv(m, DX_TILE)
    col = {first: cdiv(hidden, DX_TILE), second: cdiv(dim, DX_TILE)}
    regions, at = {}, 0
    for name, nbytes in zip(scratch, (m * dim, 4 * m, 4 * m * col[first],
                                      4 * m, m * hidden, dim * hidden,
                                      dim * hidden)):
        regions[name] = (at, nbytes)
        at += cdiv(nbytes, 256) * 256
    smem = (2 * DX_RING * 2 * DX_TILE * DX_STAGE   # two teams' rings
            + 2 * DX_TILE * DX_TILE * 2            # their staging tiles
            + (4 * DX_RING + 6) * 8 + 1024)        # mbarriers, alignment
    return dict(row_tiles=row_tiles, col_tiles=col,
                units={'absmax': row_tiles * col[first],
                       'codes': row_tiles * col[first],
                       second: row_tiles * col[second]},
                stages={first: cdiv(dim, DX_STAGE),
                        second: cdiv(hidden, DX_STAGE_DY)},
                parts=col[first], smem=smem, scratch=regions, workspace=at)


def int8_ff_plan(m: int, dim: int, hidden: int) -> dict:
    """Launch plan of K12's and K13's kernels, mirrored from
    ``sav_int8_ff_plan`` in ``csrc/int8_ff.cu`` (``csrc/int8_ff_sm90.cuh``):
    ``row_tiles`` (128 rows), ``col_tiles`` of the first product's [M, F]
    (``'hidden'``) and the second's [M, D] (``'out'``, 128 columns each),
    ``units`` of the three GEMM launches (``absmax`` and ``codes`` over
    [M, F], ``out``; 128 x 128 tiles), ``out_pairs`` (OUT's blocks take
    pair units, a row tile's column tiles 2c and 2c + 1 on their two teams,
    where ceil(D / 128) is even), ``stages`` (the ring slots of a
    contraction: 64-deep over D, 128-deep over F), ``parts`` (the absmax
    partials of a row, one per 128 columns of F), ``transposes`` (the 64 x
    64 tiles of each weight's codes transpose), ``smem`` (dynamic shared
    memory: two teams' rings of five slots of two 8 KB boxes, their 32 KB
    staging tiles, the mbarriers, alignment slack) and the workspace the
    C entry carves: ``scratch`` (name -> (offset, bytes): x's codes and
    scales, the absmax partials, the hidden codes' scales and the codes,
    W1's and W2's codes transposed, each at a 256-byte offset) and
    ``workspace`` (their total bytes). Every count is a ceiling: at
    cait_xs's D = 288, F = 1152 OUT takes 3 column tiles (the last 32
    columns wide, so no pairs), each first product 5 slots (the last half
    zeros) and each transpose 5 x 18 tiles. Raises ValueError where the
    kernels do not take the geometry."""
    plan = _q8_plan(m, dim, hidden, 'int8_ff_raw', 'hidden', 'out',
                    ('xq', 'xs', 'amax', 'hs', 'hq', 'w1t', 'w2t'))
    plan['out_pairs'] = plan['col_tiles']['out'] % 2 == 0
    plan['transposes'] = -(-dim // 64) * -(-hidden // 64)
    return plan


def _int8_ff_into(x, ln, w1_q, s1, b1, w2_q, s2, b2, eps, out, hpre):
    """K12's (``ln`` None) or K13's (``ln`` = (scale, bias)) six launches
    on checked operands, writing ``out [M, D]`` and, unless it is None,
    ``hpre [M, F]`` (or the first M rows of longer buffers)."""
    m, d = x.shape
    f = w1_q.shape[1]
    dev = x.device
    vec = lambda t, n: t.reshape(n).to(dev, torch.float32).contiguous()
    ln_s, ln_b = (None, None) if ln is None else (vec(ln[0], d), vec(ln[1], d))
    ws = torch.empty(int8_ff_plan(m, d, f)['workspace'], dtype=torch.uint8,
                     device=dev)
    # every buffer is held by a name until the launches are queued; the
    # kernels transpose the weights' codes into the workspace
    args = [x, ln_s, ln_b, w1_q.contiguous(), vec(s1, f), vec(b1, f),
            w2_q.contiguous(), vec(s2, d), vec(b2, d), out, hpre, ws]
    with torch.cuda.device(dev):
        err = _ff_lib('sav_int8_ff')(
            *[None if t is None else t.data_ptr() for t in args], m, d, f,
            int(ln is not None), eps, fa.stream_of(dev))
    _build.check(err, 'int8_ff_ln_raw' if ln is not None else 'int8_ff_raw')


def _launch(x, ln, w1_q, s1, b1, w2_q, s2, b2, eps, save_hpre, what):
    """Checks and launches the K12/K13 kernels; ``ln`` is (scale, bias) for
    K13 or None for K12."""
    fa.check_no_grad(x)
    fa.check_cuda_bf16('x', x, x.device)
    m, d = x.shape
    f = w1_q.shape[1]
    for name, t, shape in (('w1_q', w1_q, (d, f)), ('w2_q', w2_q, (f, d))):
        if t.dtype != torch.int8 or tuple(t.shape) != shape:
            raise ValueError(f'{name} must be int8 {shape}, got {t.dtype} '
                             f'{tuple(t.shape)}')
    _q8_plan(m, d, f, what, 'hidden', 'out', ())    # raises on the geometry
    out = torch.empty_like(x)
    hpre = (torch.empty(m, f, dtype=torch.bfloat16, device=x.device)
            if save_hpre else None)
    _int8_ff_into(x, ln, w1_q, s1, b1, w2_q, s2, b2, eps, out, hpre)
    return (out, hpre) if save_hpre else out


def int8_ff_raw(x, w1_q, s1, b1, w2_q, s2, b2, *, save_hpre: bool = False):
    """Port of K12: gelu(x @ deq(w1) + b1) @ deq(w2) + b2.

    x [M, D]; w1_q [D, F] int8 with per-column scales s1 [1, F]; w2_q
    [F, D] int8 with s2 [1, D]; biases f32. Returns [M, D] in x.dtype, or
    (out, hpre bf16 [M, F]) with ``save_hpre``. On a CUDA tensor: the
    kernels' six launches (bf16 x, D and F multiples of 32 of at least 64,
    any M >= 1); on a CPU tensor: the twin."""
    if x.device.type == 'cpu':
        return int8_ff_reference(x, w1_q, s1, b1, w2_q, s2, b2, save_hpre)
    if x.device.type != 'cuda':
        raise ValueError(f'int8_ff_raw runs on cuda or cpu, not {x.device}')
    out = _launch(x, None, w1_q, s1, b1, w2_q, s2, b2, 0.0, save_hpre,
                  'int8_ff_raw')
    _build.count('int8_ff_train' if save_hpre else 'int8_ff')
    return out


def int8_ff_ln_raw(x, scale, bias, w1_q, s1, b1, w2_q, s2, b2, *,
                   eps: float = LN_EPS, save_hpre: bool = False):
    """Port of K13: x + gelu(LN(x) @ deq(w1) + b1) @ deq(w2) + b2 on the
    kernels on a CUDA tensor; the twin on a CPU tensor. As ``int8_ff_raw``,
    plus the LayerNorm's scale and bias [D]."""
    if x.device.type == 'cpu':
        return int8_ff_ln_reference(x, scale, bias, w1_q, s1, b1, w2_q, s2, b2,
                                    eps, save_hpre)
    if x.device.type != 'cuda':
        raise ValueError(f'int8_ff_ln_raw runs on cuda or cpu, not {x.device}')
    out = _launch(x, (scale, bias), w1_q, s1, b1, w2_q, s2, b2, eps,
                  save_hpre, 'int8_ff_ln_raw')
    _build.count('int8_ff_ln_train' if save_hpre else 'int8_ff_ln')
    return out


def _raw(core, ln):
    """The forward ``core`` picks: the kernel's wrapper (the card's kernel
    on a CUDA tensor, the twin on a CPU one) or the twin on any device."""
    if core not in CORES:
        raise ValueError(f'core must be one of {CORES}, got {core!r}')
    if ln:
        return int8_ff_ln_raw if core == 'kernel' else int8_ff_ln_reference
    return int8_ff_raw if core == 'kernel' else int8_ff_reference


def _quantized_weights(w1, w2):
    """Per-column codes and scales of W1 and W2, in f32 arithmetic."""
    w1_q, s1 = quantize_symmetric(w1.float(), axis=0)
    w2_q, s2 = quantize_symmetric(w2.float(), axis=0)
    return w1_q, s1, w2_q, s2


class _Int8FFCore(torch.autograd.Function):
    """``_int8_ff_core``: K12's training variant forward (hpre stored in
    bf16), the f32 straight-through backward ``_ff_bwd``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, core):
        w1_q, s1, w2_q, s2 = _quantized_weights(w1, w2)
        y, hpre = _raw(core, False)(x, w1_q, s1, b1, w2_q, s2, b2,
                                    save_hpre=True)
        ctx.save_for_backward(x, w1, b1, w2, b2, hpre)
        ctx.core = core
        return y

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, hpre = ctx.saved_tensors
        hpre = hpre.float()
        g32 = g.float()
        dh = g32 @ w2.float().t()
        dhpre = gelu_vjp(hpre, dh)
        dx = dhpre @ w1.float().t()
        dw1 = x.float().t() @ dhpre
        db1 = dhpre.sum(dim=0)
        dw2 = gelu(hpre).t() @ g32
        db2 = g32.sum(dim=0)
        return (dx.to(x.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype), None)


def int8_ff(x, w1, b1, w2, b2, switchback: bool = False, core='kernel'):
    """Quantized FF sublayer body (K12); x [..., D] -> [..., D].
    ``switchback`` swaps the straight-through backward for the SwitchBack
    one (dx products int8 on K14, weight gradients bf16); the forward is
    the same. ``core='plain'`` runs the same function on the twins of K12
    and K14 on any device (the card's reference for the kernels)."""
    flat = x.reshape(-1, x.shape[-1])
    args = (flat, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        fn = _Int8FFCoreSB if switchback else _Int8FFCore
        out = fn.apply(*args, core)
    else:
        w1_q, s1, w2_q, s2 = _quantized_weights(w1, w2)
        out = _raw(core, False)(flat, w1_q, s1, b1, w2_q, s2, b2)
    return out.reshape(*x.shape[:-1], w2.shape[-1])


def _layernorm_bwd_flat(dy, xhat, inv, scale):
    """(dx, dscale, dbias) of LayerNorm on flat [M, D] tensors, f32."""
    dyf = dy.float()
    dscale = (dyf * xhat).sum(dim=0)
    dbias = dyf.sum(dim=0)
    dxhat = dyf * scale.float()
    dx = inv * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx, dscale, dbias


class _Int8FFSublayer(torch.autograd.Function):
    """``int8_ff_sublayer``'s ``_sublayer_fwd``/``_sublayer_bwd``: K13's
    training variant forward, then library work in x's dtype on the [M, 4D]
    tensors and f32-accumulated weight gradients."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, eps, core):
        w1_q, s1, w2_q, s2 = _quantized_weights(w1, w2)
        flat = x.reshape(-1, x.shape[-1])
        out, hpre = _raw(core, True)(flat, scale, bias, w1_q, s1, b1, w2_q,
                                     s2, b2, eps=eps, save_hpre=True)
        ctx.save_for_backward(x, scale, bias, w1, b1, w2, b2, hpre)
        ctx.eps, ctx.core = eps, core
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, w1, b1, w2, b2, hpre = ctx.saved_tensors
        cdt = x.dtype
        shape3 = x.shape
        xf = x.reshape(-1, shape3[-1])
        gf = g.reshape(-1, shape3[-1]).to(cdt)
        y2, xhat, inv = _layernorm(xf, scale, bias, ctx.eps)
        hpre = hpre.to(cdt)
        gact = gelu(hpre)
        w1c, w2c = w1.to(cdt), w2.to(cdt)
        dgact = gf @ w2c.t()
        dw2 = _wgrad(gact, gf)
        db2 = gf.float().sum(dim=0)
        dh = gelu_vjp(hpre, dgact)
        dw1 = _wgrad(y2, dh)
        db1 = dh.float().sum(dim=0)
        dy2 = dh @ w1c.t()
        dx_ln, dscale, dbias = _layernorm_bwd_flat(dy2, xhat, inv, scale)
        dx = (dx_ln + gf.float()).to(cdt)
        return (dx.reshape(shape3), dscale.to(scale.dtype),
                dbias.to(bias.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype), None, None)


def int8_ff_sublayer(x, scale, bias, w1, b1, w2, b2, eps=LN_EPS,
                     core='kernel'):
    """``x + FF_int8(LN(x))`` on K13, with one autograd boundary for the
    whole span. x is [B, L, D]; the parameters are LayerNorm_1's and
    FFBlock_0's, so the tree is the unquantized model's. ``core='plain'``
    runs the same Function on K13's twin on any device."""
    args = (x, scale, bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Int8FFSublayer.apply(*args, eps, core)
    w1_q, s1, w2_q, s2 = _quantized_weights(w1, w2)
    flat = x.reshape(-1, x.shape[-1])
    out = _raw(core, True)(flat, scale, bias, w1_q, s1, b1, w2_q, s2, b2,
                           eps=eps)
    return out.reshape(x.shape)


# ------------------------- SwitchBack backward (K14: both dx products int8)

def _dx_quantized(w):
    """Codes of ``w [in, out]`` for its dx product ``g @ w^T``: the
    contraction runs over the OUT axis, so the scales are per IN row.
    Returns (codes ``[out, in]``, a transposed view of the ``[in, out]``
    codes, which are the k-contiguous B operand K14 reads as they are;
    scales ``[1, in]`` f32)."""
    wq, s = quantize_symmetric(w.float(), axis=1)
    return wq.t(), s.reshape(1, -1)


def int8_ff_dx_reference(g, hpre, w1t_q, s1t, w2t_q, s2t):
    """Plain twin of ``int8_ff_dx_raw``, step for step as the JAX twin:
    g's codes per row, dgact = f32(gq W2t) * (gs * s2t), dh = gelu'(hpre)
    * dgact in f32, dh's codes per row over all F, dy2 = f32(dhq W1t) *
    (dhs * s1t) in g's dtype. Returns (dy2, dh in bf16)."""
    gq, gs = _quantize_tile(g)
    dgact = int_matmul(gq, w2t_q).float() * (gs * s2t)
    dh = gelu_vjp_f32(hpre.float(), dgact)
    dhq, dhs = _quantize_tile(dh)
    dy2 = int_matmul(dhq, w1t_q).float() * (dhs * s1t)
    return dy2.to(g.dtype), dh.to(torch.bfloat16)


def int8_dx_plan(m: int, dim: int, hidden: int) -> dict:
    """Launch plan of K14's kernels, mirrored from ``sav_int8_ff_dx_plan``
    in ``csrc/int8_ff.cu`` (``csrc/int8_dx_sm90.cuh``): ``row_tiles`` (128
    rows), ``col_tiles`` of the first product's [M, F] (``'dh'``) and the
    second's [M, D] (``'dy'``, 128 columns each), ``units`` of the three
    GEMM launches (``absmax`` and ``codes`` over [M, F], ``dy``; 128 x 128
    tiles), ``stages`` (the ring slots of a contraction: 64-deep over D,
    128-deep over F), ``parts`` (the absmax
    partials of a row, one per 128 columns of F), ``smem`` (dynamic shared
    memory: two teams' rings of five slots of two 8 KB boxes, their 32 KB
    staging tiles, the mbarriers, alignment slack) and the workspace the
    wrapper allocates: ``scratch`` (name -> (offset, bytes): g's codes and
    scales, the absmax partials, dh's scales and codes, each at a 256-byte
    offset) and ``workspace`` (their total bytes). Raises ValueError where
    the kernels do not take the geometry."""
    return _q8_plan(m, dim, hidden, 'int8_ff_dx_raw', 'dh', 'dy',
                    ('gq', 'gs', 'amax', 'dhs', 'dhq'))


def _int8_dx_into(g, hpre, w1t_q, s1t, w2t_q, s2t, dy2, dh):
    """K14's five launches on checked operands, writing ``dy2 [M, D]`` and
    ``dh [M, F]`` (or the first M rows of longer buffers)."""
    m, d = g.shape
    f = hpre.shape[1]
    dev = g.device
    vec = lambda t, n: t.reshape(n).to(dev, torch.float32).contiguous()
    # the per-IN-row codes [F, D] and [D, F], k-contiguous: no copy when
    # they come from _dx_quantized
    w2c, w1c = w2t_q.t().contiguous(), w1t_q.t().contiguous()
    ws = torch.empty(int8_dx_plan(m, d, f)['workspace'], dtype=torch.uint8,
                     device=dev)
    # every buffer is held by a name until the launches are queued
    args = [g, hpre, w2c, vec(s2t, f), w1c, vec(s1t, d), dy2, dh, ws]
    with torch.cuda.device(dev):
        err = _ff_lib('sav_int8_ff_dx')(*[t.data_ptr() for t in args], m, d,
                                        f, fa.stream_of(dev))
    _build.check(err, 'int8_ff_dx_raw')


def int8_ff_dx_raw(g, hpre, w1t_q, s1t, w2t_q, s2t):
    """Port of K14: the dx path of the FF backward, both products int8.

    g ``[M, D]`` output cotangent; hpre ``[M, F]`` the forward's stored
    pre-activation; w2t_q ``[D, F]`` / w1t_q ``[F, D]`` and their scales
    ``[1, F]`` / ``[1, D]`` from ``_dx_quantized``. Returns (dy2 ``[M, D]``
    in g's dtype, dh ``[M, F]`` bf16). On a CUDA tensor five launches
    (``csrc/int8_ff.cu``, ``csrc/int8_dx_sm90.cuh``): g's codes; a
    persistent s8 ``wgmma`` + TMA GEMM with the gelu' epilogue writing dh
    and each row's absmax partials; dh's row scales; the same product and
    epilogue again for dh's codes; the same GEMM for dy. bf16 g and hpre, D
    and F multiples of 32 of at least 64, any M (rows past M are neither
    read nor stored; nothing is padded or copied). On a CPU tensor: the
    twin."""
    if g.device.type == 'cpu':
        return int8_ff_dx_reference(g, hpre, w1t_q, s1t, w2t_q, s2t)
    if g.device.type != 'cuda':
        raise ValueError(f'int8_ff_dx_raw runs on cuda or cpu, not {g.device}')
    fa.check_no_grad(g, hpre)
    fa.check_cuda_bf16('g', g, g.device)
    fa.check_cuda_bf16('hpre', hpre, g.device)
    m, d = g.shape
    f = hpre.shape[1]
    if hpre.shape[0] != m:
        raise ValueError(f'hpre has {hpre.shape[0]} rows, g has {m}')
    for name, t, shape in (('w2t_q', w2t_q, (d, f)), ('w1t_q', w1t_q, (f, d))):
        if t.dtype != torch.int8 or tuple(t.shape) != shape:
            raise ValueError(f'{name} must be int8 {shape}, got {t.dtype} '
                             f'{tuple(t.shape)}')
    int8_dx_plan(m, d, f)                       # raises on the geometry
    dy2 = torch.empty_like(g)
    dh = torch.empty(m, f, dtype=torch.bfloat16, device=g.device)
    _int8_dx_into(g, hpre, w1t_q, s1t, w2t_q, s2t, dy2, dh)
    _build.count('int8_ff_dx')
    return dy2, dh


def _dx(core):
    if core not in CORES:
        raise ValueError(f'core must be one of {CORES}, got {core!r}')
    return int8_ff_dx_raw if core == 'kernel' else int8_ff_dx_reference


def _switchback_dx(g2, hpre, w1, w2, core):
    """(dy2, dh in g2's dtype) of the SwitchBack backward from the f32 or
    bf16 weights."""
    w1t_q, s1t = _dx_quantized(w1)
    w2t_q, s2t = _dx_quantized(w2)
    dy2, dh = _dx(core)(g2.contiguous(), hpre, w1t_q, s1t, w2t_q, s2t)
    return dy2, dh.to(g2.dtype)


def _switchback_wgrads(a, g2, hpre, dh):
    """(dw1, db1, dw2, db2) in f32: bf16 products with f32 sums, as
    ``_ff_sb_bwd``/``_sublayer_sb_bwd``; gelu(hpre) in the compute dtype."""
    cdt = g2.dtype
    dw1 = _wgrad(a, dh)
    db1 = dh.float().sum(dim=0)
    dw2 = _wgrad(gelu(hpre.to(cdt)), g2)
    db2 = g2.float().sum(dim=0)
    return dw1, db1, dw2, db2


class _Int8FFCoreSB(_Int8FFCore):
    """``_int8_ff_core_sb``: the same forward (``_ff_fwd``), the
    SwitchBack backward ``_ff_sb_bwd`` (K14)."""

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, hpre = ctx.saved_tensors
        gf = g.to(x.dtype)
        dx, dh = _switchback_dx(gf, hpre, w1, w2, ctx.core)
        dw1, db1, dw2, db2 = _switchback_wgrads(x, gf, hpre, dh)
        return (dx.to(x.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype), None)


class _Int8FFSublayerSB(_Int8FFSublayer):
    """``int8_ff_sublayer_sb``'s ``_sublayer_sb_fwd``/``_sublayer_sb_bwd``:
    the same forward (K13's training variant), then the LayerNorm
    statistics recomputed from x, both dx products on K14, bf16 weight
    gradients with f32 sums, the LayerNorm backward and the skip."""

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, w1, b1, w2, b2, hpre = ctx.saved_tensors
        cdt = x.dtype
        shape3 = x.shape
        xf = x.reshape(-1, shape3[-1])
        gf = g.reshape(-1, shape3[-1]).to(cdt)
        y2, xhat, inv = _layernorm(xf, scale, bias, ctx.eps)
        dy2, dh = _switchback_dx(gf, hpre, w1, w2, ctx.core)
        dw1, db1, dw2, db2 = _switchback_wgrads(y2, gf, hpre, dh)
        dx_ln, dscale, dbias = _layernorm_bwd_flat(dy2, xhat, inv, scale)
        dx = (dx_ln + gf.float()).to(cdt)
        return (dx.reshape(shape3), dscale.to(scale.dtype),
                dbias.to(bias.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype), None, None)


def int8_ff_sublayer_sb(x, scale, bias, w1, b1, w2, b2, eps=LN_EPS,
                        core='kernel'):
    """``int8_ff_sublayer`` with the SwitchBack backward: the same K13
    forward, the dx products int8 on K14, the weight gradients bf16 with
    f32 sums. ``core='plain'`` runs the same Function on the twins of K13
    and K14 on any device."""
    args = (x, scale, bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Int8FFSublayerSB.apply(*args, eps, core)
    return int8_ff_sublayer(x, scale, bias, w1, b1, w2, b2, eps, core)
