"""One TNT inner layer as one differentiable call (counterpart of
``sav_tpu/ops/tnt_inner.py``).

``LN -> MHSA over the pixel tokens -> +x -> LN -> FF (tanh-gelu) -> +x`` on
``[B*P, L, D]`` pixel tokens, read as stored (the TPU kernel's
patches-in-lanes transpose and packed weight tile exist for the TPU's
lanes and are not ported). The parameters come in checkpoint layout and in
the JAX package's argument order: LayerNorm scale/bias ``[D]``, q/k/v
kernels ``[D, H, hd]``, the out kernel ``[H, hd, D]``, the FFBlock's
``Dense_0``/``Dense_1`` kernels ``[D, F]``/``[F, D]`` and biases.

``inner_layer_fwd`` is the port of K7a ``_fwd_kernel`` and
``inner_layer_bwd`` of K7b ``_bwd_kernel`` (``csrc/tnt_inner.cu``); on a
CPU tensor each runs its plain twin, on a CUDA tensor its kernel, or it
raises. ``inner_layer`` is the ``torch.autograd.Function`` around them:
like the JAX ``custom_vjp`` it saves x and the parameters only, and the
backward recomputes the forward from x. ``inner_layer_reference`` mirrors
the JAX package's jnp twin, differentiable by autograd.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from sav_tpu_torch import _build
from sav_tpu_torch.ops import flash_attention as fa
from sav_tpu_torch.ops.fused_layer import (LN_EPS, _gelu_bwd_from_t,
                                           _gelu_fwd_t, _layernorm,
                                           _layernorm_bwd)

TOKENS = 16             # pixel tokens per patch the kernels take (one m16 tile)


# ------------------------------------------------------------ geometry

def _warps(which: str, d: int, hidden: int, num_heads: int) -> int:
    """Warps per block of K7a (``which='fwd'``) or of K7b's per-patch
    kernel (``'bwd'``) whose shared memory fits one block, 0 where none
    does: ``sav_tnt_warps`` of ``csrc/tnt_inner.cu``, the one copy of the
    layout's formulas."""
    fn = _build.library('tnt_inner').sav_tnt_warps
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    return fn(1 if which == 'bwd' else 0, d, hidden, num_heads)


BWD_MAX_WARPS = 12      # K7b's warps a block (csrc BWD_MAX_WARPS)
MAX_NT = 4              # K7b's dy2 accumulator: Dp <= 64 (csrc MAX_NT)
LDT = 24                # bf16 row stride of K7b's 16-column FF tiles
MAX_HD = 128            # the widest head the kernels take (csrc MAX_HD)
SMEM_CAP = 232448       # a block's dynamic shared memory on the card


def _up16(n: int) -> int:
    return -(-n // 16) * 16


MIN_RESIDENT = 4        # the resident layout's least warps (csrc)


def tnt_bwd_plan(n: int, d: int, hidden: int, num_heads: int,
                 sms: int = 132) -> dict:
    """Launch plan of K7b at ``n`` patches on ``sms`` SMs, mirrored from
    ``plan_bwd``/``sav_tnt_bwd_plan`` in ``csrc/tnt_inner.cu``: ``tiled``
    (the layout: the resident one, all of F's FF operands and the softmax
    rows kept a patch, wherever it leaves a block at least
    ``MIN_RESIDENT`` warps, else the F-tiled one, 16 columns of F at a
    time), ``warps`` a block (at most 12; the weights, the block's f32
    partial of the four weight gradients and the warps' working sets
    within one block's shared memory), ``blocks`` (one an SM, no more than
    one round of warps per patch needs), ``smem``, ``warp_bytes`` (one
    warp's working set), ``layout`` (name -> (offset, floats) of each
    gradient in a block's partial: dWqkv [D, 3D], dWo [D, D], dW1 [D, F],
    dW2 [F, D], then the LN and bias column sums [5D + F] in ``par``'s
    order), ``part_floats`` and ``workspace`` (one partial a block: it
    grows with the blocks, not with the patches). Raises ValueError where
    the kernel refuses the shape."""
    if n < 1 or sms < 1 or d < 8 or d % 8 or num_heads < 1 or \
            d % num_heads or hidden < 16 or hidden % 16:
        raise ValueError(f'inner_layer_bwd does not take B*P={n}, D={d}, '
                         f'F={hidden}, H={num_heads} on {sms} SMs')
    f, h = hidden, num_heads
    dp = _up16(d)
    ldy, ldq, ldf, lf = dp + 8, 3 * dp + 8, f + 8, d + 2
    nvec, total = 5 * d + f, 4 * d * d + 2 * d * f
    weights = _up16(2 * (dp * ldq + dp * ldy + dp * ldf + f * ldy)) \
        + _up16(4 * nvec)
    shared = weights + _up16(4 * total)

    def warp_bytes(tiled):
        region = max(4 * 16 * LDT * 2 if tiled else 2 * _up16(16 * ldf * 2),
                     h * 16 * 16 if tiled else _up16(2 * h * 16 * 16 * 4),
                     _up16(16 * ldy * 2))
        return (_up16(16 * d * 2) + 5 * _up16(16 * lf * 4)
                + 3 * _up16(16 * ldy * 2) + region + _up16(4 * 16 * 4)
                + _up16(4 * nvec))

    def warps(tiled):
        if (tiled and dp > 16 * MAX_NT) or d // h > MAX_HD or \
                shared + warp_bytes(tiled) > SMEM_CAP:
            return 0
        return min(BWD_MAX_WARPS, (SMEM_CAP - shared) // warp_bytes(tiled))

    tiled = warps(False) < MIN_RESIDENT and warps(True) > 0
    w = warps(tiled)
    if w < 1:
        raise ValueError(f'inner_layer_bwd: the weights, the partial and one '
                         f'warp need more than {SMEM_CAP} bytes of shared '
                         f'memory at D = {d}, F = {f}')
    blocks = min(-(-n // w), sms)
    layout = dict(dwqkv=(0, 3 * d * d), dwo=(3 * d * d, d * d),
                  dw1=(4 * d * d, d * f), dw2=(4 * d * d + d * f, d * f),
                  vec=(total, nvec))
    return dict(tiled=tiled, warps=w, blocks=blocks,
                smem=shared + w * warp_bytes(tiled),
                warp_bytes=warp_bytes(tiled), layout=layout,
                part_floats=total + nvec,
                workspace=blocks * (total + nvec) * 4)


def _refusal(l: int, d: int, num_heads: int, hidden: int,
             device) -> str | None:
    """Why the K7 port does not take ``l`` tokens of ``d`` channels in
    ``num_heads`` heads with FF width ``hidden`` on ``device``, or None."""
    if l != TOKENS:
        return f'the kernels take {TOKENS} pixel tokens a patch (one m16 tile)'
    if d < 8 or d % 8 or num_heads < 1 or d % num_heads:
        return 'D must be a multiple of 8 and of the head count'
    if hidden < 16 or hidden % 16:
        return 'the FF width must be a multiple of 16'
    if torch.device(device).type == 'cuda':
        if min(_warps('fwd', d, hidden, num_heads),
               _warps('bwd', d, hidden, num_heads)) < 1:
            return ('the weights and one patch\'s working set exceed a '
                    f'block\'s {fa.SMEM_LIMIT} bytes of shared memory')
    return None


def supported(l: int, d: int, num_heads: int, hidden: int | None = None,
              device='cuda') -> bool:
    """Whether the K7 port takes the shape: 16 tokens a patch, D a multiple
    of 8 and of H, F (default 4 D, TNT's) a multiple of 16, and on the card
    the weights plus one warp's working set of both kernels within one
    block's 227 KB (the kernel's own formula, ``_warps``): TNT-S (D = 24)
    and TNT-B (D = 40) fit. The TPU bound ``4 <= l <= 32 and d <= 64`` and
    its VMEM patch budget ``_nb_for`` have no counterpart here. Off the
    card the plain twins have no shared-memory budget."""
    hidden = 4 * d if hidden is None else hidden
    return _refusal(l, d, num_heads, hidden, device) is None


def auto_route(l: int, d: int, num_heads: int, hidden: int, device) -> bool:
    """Whether ``use_kernel='auto'`` takes the K7 port: never off the card,
    where the JAX package takes its per-op path off the TPU; on the card
    always, and a shape the kernels do not take raises rather than run the
    per-op path unasked (``use_kernel=False`` asks for it)."""
    if torch.device(device).type != 'cuda':
        return False
    why = _refusal(l, d, num_heads, hidden, device)
    if why is not None:
        raise NotImplementedError(
            f'the TNT inner-layer kernels do not take L={l}, D={d}, '
            f'H={num_heads}, F={hidden}: {why} (ROADMAP.md Queue 2, K7); '
            'use_kernel=False runs the per-op path')
    return True


# ------------------------------------------------------------ plain twins

def _forward_state(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2,
                   b2, num_heads, eps):
    """K7's forward in f32, rounding where ``_fwd_kernel`` rounds: y, bf16
    of o before Wo, y2 and gelu(hp) in x.dtype; q (pre-scaled), k, v, the
    softmax, o, x2 and hp in f32. Returns the state the backward reuses."""
    n, l, d = x.shape
    cdt = x.dtype
    hd = d // num_heads
    wq2, wk2, wv2, wo2, w1c, w2c = (
        w.to(cdt).float() for w in (wq.reshape(d, d), wk.reshape(d, d),
                                     wv.reshape(d, d), wo.reshape(d, d), w1,
                                     w2))
    xf = x.float()
    y, xhat1, inv1 = _layernorm(x, ln1s, ln1b, eps)
    yf = y.float()
    heads = lambda t: t.reshape(n, l, num_heads, hd)
    q = heads((yf @ wq2) * (1.0 / math.sqrt(hd)))
    k, v = heads(yf @ wk2), heads(yf @ wv2)
    a = torch.softmax(torch.einsum('nqhc,nphc->nhqp', q, k), dim=-1)
    o = torch.einsum('nhqp,nphc->nqhc', a, v).reshape(n, l, d)
    ob = o.to(cdt).float()
    x2 = xf + ob @ wo2
    y2, xhat2, inv2 = _layernorm(x2, ln2s, ln2b, eps)
    y2 = y2.to(cdt).float()
    hp = y2 @ w1c + b1.float()
    gact, t = _gelu_fwd_t(hp)
    gb = gact.to(cdt).float()
    out = x2 + gb @ w2c + b2.float()
    return dict(ws=(wq2, wk2, wv2, wo2, w1c, w2c), yf=yf, xhat1=xhat1,
                inv1=inv1, q=q, k=k, v=v, a=a, ob=ob, x2=x2, xhat2=xhat2,
                inv2=inv2, y2=y2, hp=hp, t=t, gb=gb, out=out)


def inner_layer_fwd_plain(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1,
                          w2, b2, num_heads, eps=LN_EPS):
    """Plain twin of ``inner_layer_fwd`` (see ``_forward_state``)."""
    return _forward_state(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1,
                          w2, b2, num_heads, eps)['out'].to(x.dtype)


def inner_layer_bwd_plain(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1,
                          w2, b2, g, num_heads, eps=LN_EPS, wsum=None):
    """Plain twin of ``inner_layer_bwd``, following ``_bwd_kernel``'s
    closed form line by line: recompute from x; dgact = do W2^T, dhp =
    dgact gelu'(hp) (f32 up to db1), dy2 from bf16(dhp), the LN2 backward,
    dx2 = dx2_ln + do; dO from bf16(dx2); the softmax backward in f32; dq,
    dk, dv rounded before their products; the LN1 backward, dx = dx_ln +
    dx2. Returns (dx, dln1s, dln1b, dwq, dwk, dwv, dwo, dln2s, dln2b, dw1,
    db1, dw2, db2): dx in x.dtype, the rest f32 in checkpoint layout.
    ``wsum(a, b)`` sums the weight-gradient products a^T b over the patches
    (``a``, ``b`` [n, 16, .]); by default in one einsum."""
    n, l, d = x.shape
    cdt = x.dtype
    hd = d // num_heads
    st = _forward_state(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2,
                        b2, num_heads, eps)
    wq2, wk2, wv2, wo2, w1c, w2c = st['ws']
    rnd = lambda t: t.to(cdt).float()
    if wsum is None:
        wsum = lambda a, b: torch.einsum('nli,nlj->ij', a, b)

    do = rnd(g)
    dw2 = wsum(st['gb'], do)
    db2 = do.sum(dim=(0, 1))
    dhp = (do @ w2c.t()) * _gelu_bwd_from_t(st['hp'], st['t'])
    dhpb = rnd(dhp)
    dw1 = wsum(st['y2'], dhpb)
    db1 = dhp.sum(dim=(0, 1))
    dx2_ln, dln2s, dln2b = _layernorm_bwd(dhpb @ w1c.t(), st['xhat2'],
                                          st['inv2'], ln2s)
    dx2 = dx2_ln + do
    dao = rnd(dx2)
    d_o = (dao @ wo2.t()).reshape(n, l, num_heads, hd)
    dwo = wsum(st['ob'], dao)

    q, k, v, a = st['q'], st['k'], st['v'], st['a']
    da = torch.einsum('nqhc,nphc->nhqp', d_o, v)
    ds = a * (da - (da * a).sum(dim=-1, keepdim=True))
    dq = torch.einsum('nhqp,nphc->nqhc', ds, k) * (1.0 / math.sqrt(hd))
    dk = torch.einsum('nhqp,nqhc->nphc', ds, q)
    dv = torch.einsum('nhqp,nqhc->nphc', a, d_o)
    dqb, dkb, dvb = (rnd(t.reshape(n, l, d)) for t in (dq, dk, dv))
    yf = st['yf']
    dwq, dwk, dwv = wsum(yf, dqb), wsum(yf, dkb), wsum(yf, dvb)
    dy = dqb @ wq2.t() + dkb @ wk2.t() + dvb @ wv2.t()
    dx_ln, dln1s, dln1b = _layernorm_bwd(dy, st['xhat1'], st['inv1'], ln1s)
    shape_w = (d, num_heads, hd)
    return ((dx_ln + dx2).to(cdt), dln1s, dln1b, dwq.reshape(shape_w),
            dwk.reshape(shape_w), dwv.reshape(shape_w),
            dwo.reshape(num_heads, hd, d), dln2s, dln2b, dw1, db1, dw2, db2)


def blocked_wsum(blocks: int, warps: int):
    """K7b's order of the weight-gradient sums (``csrc/tnt_inner.cu``):
    block i's warps take patches in rounds, patch (r blocks + i) warps + w
    in round r; each block adds its rounds' products into its own partial,
    round by round; the partials are then added in block order. Returns
    the ``wsum`` of ``inner_layer_bwd_plain`` that sums in that order."""
    def wsum(a, b):
        n = a.shape[0]
        per_patch = torch.einsum('nli,nlj->nij', a, b)
        owner = (torch.arange(n) // warps) % blocks
        total = None
        for blk in range(blocks):
            part = torch.zeros_like(per_patch[0])
            for p in torch.nonzero(owner == blk).flatten().tolist():
                part = part + per_patch[p]
            total = part if total is None else total + part
        return total
    return wsum


def inner_layer_bwd_blocked(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1,
                            b1, w2, b2, g, num_heads, sms=132, eps=LN_EPS):
    """``inner_layer_bwd_plain`` with the weight gradients summed in K7b's
    order on ``sms`` SMs (``tnt_bwd_plan``'s blocks and warps,
    ``blocked_wsum``): per-block partials over rounds of patches, then the
    partials in block order."""
    plan = tnt_bwd_plan(x.shape[0], x.shape[-1], w1.shape[-1], num_heads, sms)
    return inner_layer_bwd_plain(
        x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2, b2, g,
        num_heads, eps, wsum=blocked_wsum(plan['blocks'], plan['warps']))


def inner_layer_reference(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1,
                          w2, b2, num_heads):
    """Per-op twin of the JAX package's ``inner_layer_reference``
    (``tnt_inner.py:490-520``): its rounding points (x2 and the
    probabilities in x.dtype), differentiable by autograd."""
    n, l, d = x.shape
    hd = d // num_heads
    cdt = x.dtype
    y = _layernorm(x, ln1s, ln1b, LN_EPS)[0]
    wq2, wk2, wv2, wo2 = (w.reshape(d, d).to(cdt) for w in (wq, wk, wv, wo))
    sqrt_hd = torch.tensor(float(hd)).to(cdt).sqrt()
    heads = lambda t: t.reshape(n, l, num_heads, hd)
    q = heads(y @ wq2) / sqrt_hd
    k, v = heads(y @ wk2), heads(y @ wv2)
    s = torch.einsum('nqhc,nphc->nhqp', q.float(), k.float())
    a = torch.softmax(s, dim=-1).to(cdt)
    o = torch.einsum('nhqp,nphc->nqhc', a, v).reshape(n, l, d)
    x2 = x + o @ wo2
    y2 = _layernorm(x2, ln2s, ln2b, LN_EPS)[0]
    hpre = y2 @ w1.to(cdt) + b1.to(cdt)
    return x2 + (F.gelu(hpre, approximate='tanh') @ w2.to(cdt) + b2.to(cdt))


# ------------------------------------------------------ kernel wrappers

def _fn(name, pointers, ints, floats=0, restype=ctypes.c_int):
    fn = getattr(_build.library('tnt_inner'), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                       + [ctypes.c_float] * floats
                       + ([ctypes.c_void_p] if restype is ctypes.c_int else []))
        fn.restype = restype
    return fn


def _check(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2, b2,
           num_heads):
    """Device, dtype and geometry the K7 kernels take; returns (wqkv [D,
    3D], wo [D, D], w1, w2 in x's dtype; par f32 [5D + F] = ln1 scale,
    ln1 bias, ln2 scale, ln2 bias, b2, b1), contiguous on x's device."""
    fa.check_cuda_bf16('x', x, x.device)
    if x.dim() != 3:
        raise ValueError(f'x must be [B*P, L, D], got {tuple(x.shape)}')
    n, l, d = x.shape
    hidden = w1.shape[-1]
    hd = d // num_heads if num_heads > 0 else 0
    shapes = (('ln1s', ln1s, (d,)), ('ln1b', ln1b, (d,)),
              ('wq', wq, (d, num_heads, hd)), ('wk', wk, (d, num_heads, hd)),
              ('wv', wv, (d, num_heads, hd)), ('wo', wo, (num_heads, hd, d)),
              ('ln2s', ln2s, (d,)), ('ln2b', ln2b, (d,)),
              ('w1', w1, (d, hidden)), ('b1', b1, (hidden,)),
              ('w2', w2, (hidden, d)), ('b2', b2, (d,)))
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {shape}')
    why = ('B*P must be at least 1' if n < 1
           else _refusal(l, d, num_heads, hidden, x.device))
    if why is not None:
        raise ValueError(
            f'the TNT inner-layer kernels do not take B*P={n}, L={l}, D={d}, '
            f'H={num_heads}, F={hidden}: {why}')
    cast = lambda t: t.to(x.device, x.dtype).contiguous()
    wqkv = torch.cat([w.reshape(d, d) for w in (wq, wk, wv)], dim=1)
    par = torch.cat([ln1s, ln1b, ln2s, ln2b, b2, b1]).to(
        x.device, torch.float32).contiguous()
    return cast(wqkv), cast(wo.reshape(d, d)), cast(w1), cast(w2), par


def inner_layer_fwd(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2,
                    b2, num_heads, eps=LN_EPS):
    """Port of K7a: the whole inner layer on ``[B*P, 16, D]``. On the card
    one launch (``csrc/tnt_inner.cu``): a warp per patch, the weights once
    per block in shared memory. bf16 only."""
    if x.device.type == 'cpu':
        return inner_layer_fwd_plain(x, ln1s, ln1b, wq, wk, wv, wo, ln2s,
                                     ln2b, w1, b1, w2, b2, num_heads, eps)
    if x.device.type != 'cuda':
        raise ValueError(f'inner_layer_fwd runs on cuda or cpu, not {x.device}')
    params = (ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2, b2)
    fa.check_no_grad(x, *params)
    wqkv, wo2, w1c, w2c, par = _check(x, *params, num_heads)
    n, _, d = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _fn('sav_tnt_fwd', 7, 4, 2)(
            x.data_ptr(), wqkv.data_ptr(), wo2.data_ptr(), w1c.data_ptr(),
            w2c.data_ptr(), par.data_ptr(), out.data_ptr(), n, d,
            w1c.shape[1], num_heads, eps, 1.0 / math.sqrt(d // num_heads),
            fa.stream_of(x.device))
    _build.check(err, 'inner_layer_fwd')
    _build.count('tnt_inner_fwd')
    return out


def inner_layer_bwd(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2,
                    b2, g, num_heads, eps=LN_EPS):
    """Port of K7b: the 13 gradients of ``inner_layer_fwd`` from x and the
    cotangent g, recomputing the forward (order as
    ``inner_layer_bwd_plain``). On the card (``csrc/tnt_inner.cu``, three
    launches): a warp per patch recomputes and writes dx and keeps its LN
    and bias column sums; the block's warps, a round of patches at a time,
    add the four weight-gradient products of the round into the block's
    f32 partial in shared memory (``tnt_bwd_plan``); then the partials are
    summed in a fixed order (``inner_layer_bwd_blocked`` mirrors the
    order). No operand rows in device memory, no float atomics: the same
    gradients on every call. bf16 only; gradients f32."""
    if x.device.type == 'cpu':
        return inner_layer_bwd_plain(x, ln1s, ln1b, wq, wk, wv, wo, ln2s,
                                     ln2b, w1, b1, w2, b2, g, num_heads, eps)
    if x.device.type != 'cuda':
        raise ValueError(f'inner_layer_bwd runs on cuda or cpu, not {x.device}')
    params = (ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2, b2)
    fa.check_no_grad(x, *params, g)
    wqkv, wo2, w1c, w2c, par = _check(x, *params, num_heads)
    g = g.to(x.dtype).contiguous()
    fa.check_cuda_bf16('g', g, x.device)
    if g.shape != x.shape:
        raise ValueError(f'g has shape {tuple(g.shape)}, expected {tuple(x.shape)}')
    n, _, d = x.shape
    hidden = w1c.shape[1]
    h, hd = num_heads, d // num_heads
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    gw = torch.empty(4 * d * d + 2 * d * hidden, **f32)
    gvec = torch.empty(5 * d + hidden, **f32)
    with torch.cuda.device(x.device):
        ws_bytes = _fn('sav_tnt_bwd_workspace', 0, 4,
                       restype=ctypes.c_longlong)(n, d, hidden, h)
        if ws_bytes < 0:
            raise RuntimeError('sav_tnt_bwd_workspace refused the shape')
        ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
        err = _fn('sav_tnt_bwd', 11, 4, 2)(
            x.data_ptr(), g.data_ptr(), wqkv.data_ptr(), wo2.data_ptr(),
            w1c.data_ptr(), w2c.data_ptr(), par.data_ptr(), dx.data_ptr(),
            gw.data_ptr(), gvec.data_ptr(), ws.data_ptr(), n, d, hidden, h,
            eps, 1.0 / math.sqrt(hd), fa.stream_of(x.device))
    _build.check(err, 'inner_layer_bwd')
    _build.count('tnt_inner_bwd')
    dwqkv = gw[:3 * d * d].view(d, 3 * d)
    dwq, dwk, dwv = (dwqkv[:, i * d:(i + 1) * d].reshape(d, h, hd)
                     for i in range(3))
    off = 4 * d * d
    dwo = gw[3 * d * d:off].view(h, hd, d)
    dw1 = gw[off:off + d * hidden].view(d, hidden)
    dw2 = gw[off + d * hidden:].view(hidden, d)
    dln1s, dln1b, dln2s, dln2b, db2 = gvec[:5 * d].view(5, d)
    return (dx, dln1s, dln1b, dwq, dwk, dwv, dwo, dln2s, dln2b, dw1,
            gvec[5 * d:], dw2, db2)


# --------------------------------------------------------- autograd span

class _InnerLayer(torch.autograd.Function):
    """``inner_layer``'s ``custom_vjp``: saves x and the parameters,
    recomputes in the backward."""

    @staticmethod
    def forward(ctx, x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2,
                b2, num_heads):
        ctx.save_for_backward(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1,
                              b1, w2, b2)
        ctx.num_heads = num_heads
        return inner_layer_fwd(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1,
                               b1, w2, b2, num_heads)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = inner_layer_bwd(*saved, g, ctx.num_heads)
        return (*(gr.to(p.dtype) for gr, p in zip(grads, saved)), None)


def inner_layer(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2, b2,
                num_heads):
    """One TNT inner layer on ``[B*P, L, D]`` (``LN -> SA -> +x -> LN -> FF
    -> +x``), differentiable in all 13 tensors; the JAX package's argument
    order and layouts. With grad off it is ``inner_layer_fwd``."""
    args = (x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _InnerLayer.apply(*args, num_heads)
    return inner_layer_fwd(*args, num_heads)
