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
raises. Both kernels read the parameters as the model holds them (f32,
checkpoint layout) and cast the weights to bf16 as they stage them, so a
call launches its kernel and allocates its outputs, nothing else. ``inner_layer`` is the ``torch.autograd.Function`` around them:
like the JAX ``custom_vjp`` it saves x and the parameters only, and the
backward recomputes the forward from x. ``inner_layer_reference`` mirrors
the JAX package's jnp twin, differentiable by autograd.
"""

from __future__ import annotations

import ctypes
import functools
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
    _check_shape(n, d, hidden, num_heads, sms, 'inner_layer_bwd')
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


MAX_WARPS = 8           # the warp-a-patch K7a's warps a block (csrc)
# the Hopper K7a's instantiations (D, F, H) and their warpgroups a block,
# which their registers set (csrc hop_wgs)
HOP_WGS = {(24, 96, 4): 4, (40, 160, 4): 3}
UNIT = 64               # rows of a Hopper K7a unit: 4 patches
XSLOTS = 2              # x tiles a warpgroup


def _up1024(n: int) -> int:
    return -(-n // 1024) * 1024


def _check_shape(n, d, hidden, num_heads, sms, what):
    if n < 1 or sms < 1 or d < 8 or d % 8 or num_heads < 1 or \
            d % num_heads or hidden < 16 or hidden % 16:
        raise ValueError(f'{what} does not take B*P={n}, D={d}, '
                         f'F={hidden}, H={num_heads} on {sms} SMs')


def hop_layout(d: int, hidden: int) -> dict:
    """The Hopper K7a's shared memory at D, F (``hop::lay`` in
    ``csrc/tnt_inner.cu``), bytes: the block's weights as K-major
    128-byte-swizzled ``wgmma`` B tiles (Wqkv^T 3 Dp rows, Wo^T Dp, W1^T F,
    W2^T ceil(F / 64) boxes of Dp rows; a row is 128 bytes of up to 64
    input channels) and the f32 vectors (five of Dp, b1 of F), 1024-byte
    aligned; then per warpgroup two x tiles (64 rows of D bf16), the four
    warps' q, k, v (f32 rows of D + 2) and o tiles (bf16 rows of Dp + 8),
    each region 1024-byte aligned."""
    dp = _up16(d)
    wo = 3 * dp * 128
    w1 = wo + dp * 128
    w2 = w1 + hidden * 128
    vec = w2 + -(-hidden // 64) * dp * 128
    weights = _up1024(vec + (5 * dp + hidden) * 4)
    xtile = _up1024(UNIT * d * 2)
    qkv = _up1024(4 * 3 * 16 * (d + 2) * 4)
    otile = _up1024(4 * 16 * (dp + 8) * 2)
    return dict(dp=dp, wqkv=0, wo=wo, w1=w1, w2=w2, vec=vec, weights=weights,
                xtile=xtile, qkv=qkv, otile=otile,
                per_wg=XSLOTS * xtile + qkv + otile)


def tnt_fwd_plan(n: int, d: int, hidden: int, num_heads: int,
                 sms: int = 132) -> dict:
    """Launch plan of K7a at ``n`` patches on ``sms`` SMs, mirrored from
    ``plan_fwd``/``sav_tnt_fwd_plan`` in ``csrc/tnt_inner.cu``. ``route``
    1, the Hopper kernel (``wgmma`` + TMA) at the widths it is built for
    (``HOP_WGS``: TNT-S's and TNT-B's): ``wgs`` warpgroups a block (the
    instantiation's, fewer where shared memory holds fewer), ``units`` of
    4 patches (64 rows, one ``wgmma`` tile), ``blocks`` (one an SM at most,
    no more than the units need), ``smem`` (``hop_layout``'s weights,
    ``wgs`` warpgroups' regions and their x tiles' mbarriers, 1024 bytes
    of alignment slack), ``per_wg``, ``weights``. ``route`` 0, the
    warp-a-patch ``tnt_fwd_kernel<0, 0, 0>`` (``mma.sync``) for any other
    shape the kernels take: ``wgs`` its warps a block, ``blocks`` 0 (the
    occupancy query at launch sets them), ``units`` the patches,
    ``per_wg`` a warp's shared memory. Raises ValueError where the kernel
    refuses the shape."""
    _check_shape(n, d, hidden, num_heads, sms, 'inner_layer_fwd')
    lay = hop_layout(d, hidden)
    smem = lambda w: lay['weights'] + w * lay['per_wg'] + w * XSLOTS * 8 + 1024
    wgs = HOP_WGS.get((d, hidden, num_heads), 0)
    while wgs and smem(wgs) > SMEM_CAP:
        wgs -= 1
    if wgs:
        units = -(-n // 4)
        return dict(route=1, wgs=wgs, blocks=min(-(-units // wgs), sms),
                    units=units, smem=smem(wgs), per_wg=lay['per_wg'],
                    weights=lay['weights'])
    f, dp = hidden, _up16(d)
    ldy, ldq, ldf = dp + 8, 3 * dp + 8, f + 8
    weights = (_up16(2 * (dp * ldq + dp * ldy + dp * ldf + f * ldy))
               + _up16(4 * (5 * d + f)))
    per_warp = (_up16(16 * d * 4) + 2 * _up16(16 * ldy * 2) + 128
                + _up16(max(3 * 16 * dp * 4, 16 * ldf * 2)))
    if d // num_heads > MAX_HD or weights + per_warp > SMEM_CAP:
        raise ValueError(f'inner_layer_fwd: the weights and one patch\'s '
                         f'working set need more than {SMEM_CAP} bytes of '
                         f'shared memory at D = {d}, F = {f}')
    warps = min(MAX_WARPS, (SMEM_CAP - weights) // per_warp)
    return dict(route=0, wgs=warps, blocks=0, units=n,
                smem=weights + warps * per_warp, per_wg=per_warp,
                weights=weights)


def _refusal(l: int, d: int, num_heads: int, hidden: int,
             device_type: str) -> str | None:
    """Why the K7 port does not take ``l`` tokens of ``d`` channels in
    ``num_heads`` heads with FF width ``hidden`` on a ``device_type``
    device, or None."""
    if l != TOKENS:
        return f'the kernels take {TOKENS} pixel tokens a patch (one m16 tile)'
    if d < 8 or d % 8 or num_heads < 1 or d % num_heads:
        return 'D must be a multiple of 8 and of the head count'
    if hidden < 16 or hidden % 16:
        return 'the FF width must be a multiple of 16'
    if device_type == 'cuda':
        try:
            tnt_fwd_plan(1, d, hidden, num_heads)
            tnt_bwd_plan(1, d, hidden, num_heads)
        except ValueError:
            return ('the weights and one patch\'s working set exceed a '
                    f'block\'s {fa.SMEM_LIMIT} bytes of shared memory')
    return None


def supported(l: int, d: int, num_heads: int, hidden: int | None = None,
              device='cuda') -> bool:
    """Whether the K7 port takes the shape: 16 tokens a patch, D a multiple
    of 8 and of H, F (default 4 D, TNT's) a multiple of 16, and on the card
    the weights plus one warp's working set of both kernels within one
    block's 227 KB (``tnt_fwd_plan`` and ``tnt_bwd_plan``, the kernels'
    formulas): TNT-S (D = 24)
    and TNT-B (D = 40) fit. The TPU bound ``4 <= l <= 32 and d <= 64`` and
    its VMEM patch budget ``_nb_for`` have no counterpart here. Off the
    card the plain twins have no shared-memory budget."""
    hidden = 4 * d if hidden is None else hidden
    return _refusal(l, d, num_heads, hidden,
                    torch.device(device).type) is None


def auto_route(l: int, d: int, num_heads: int, hidden: int, device) -> bool:
    """Whether ``use_kernel='auto'`` takes the K7 port: never off the card,
    where the JAX package takes its per-op path off the TPU; on the card
    always, and a shape the kernels do not take raises rather than run the
    per-op path unasked (``use_kernel=False`` asks for it)."""
    if torch.device(device).type != 'cuda':
        return False
    why = _refusal(l, d, num_heads, hidden, 'cuda')
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


def _check(x, params, num_heads):
    """Device, dtype and geometry the K7 kernels take for x and the twelve
    parameters (``inner_layer_fwd``'s order after x); returns the
    parameters f32 and contiguous on x's device, as the kernels read them
    (a tensor already so is passed as it is: no copy, no launch)."""
    fa.check_cuda_bf16('x', x, x.device)
    if x.dim() != 3:
        raise ValueError(f'x must be [B*P, L, D], got {tuple(x.shape)}')
    n, l, d = x.shape
    hidden = params[8].shape[-1]
    hd = d // num_heads if num_heads > 0 else 0
    shapes = ((d,), (d,), (d, num_heads, hd), (d, num_heads, hd),
              (d, num_heads, hd), (num_heads, hd, d), (d,), (d,),
              (d, hidden), (hidden,), (hidden, d), (d,))
    for name, t, shape in zip(PARAMS, params, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {shape}')
    why = ('B*P must be at least 1' if n < 1
           else _refusal_of(l, d, num_heads, hidden, x.device.type))
    if why is not None:
        raise ValueError(
            f'the TNT inner-layer kernels do not take B*P={n}, L={l}, D={d}, '
            f'H={num_heads}, F={hidden}: {why}')
    return [t if (t.dtype == torch.float32 and t.device == x.device
                  and t.is_contiguous())
            else t.to(x.device, torch.float32).contiguous() for t in params]


# the wrappers' own copy of _refusal's answers, by shape and device type:
# a call checks its shape once, not on every launch
_refusal_of = functools.lru_cache(maxsize=None)(
    lambda *key: _refusal(*key))


PARAMS = ('ln1s', 'ln1b', 'wq', 'wk', 'wv', 'wo', 'ln2s', 'ln2b', 'w1', 'b1',
          'w2', 'b2')


def inner_layer_fwd(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2,
                    b2, num_heads, eps=LN_EPS):
    """Port of K7a: the whole inner layer on ``[B*P, 16, D]``. On the card
    one launch (``csrc/tnt_inner.cu``, ``tnt_fwd_plan``): at TNT-S's and
    TNT-B's widths persistent warpgroups on units of 4 patches, every
    product on ``wgmma``, x in and out by TMA; elsewhere a warp per patch.
    The weights are staged once per block from the f32 parameters. bf16
    only."""
    if x.device.type == 'cpu':
        return inner_layer_fwd_plain(x, ln1s, ln1b, wq, wk, wv, wo, ln2s,
                                     ln2b, w1, b1, w2, b2, num_heads, eps)
    if x.device.type != 'cuda':
        raise ValueError(f'inner_layer_fwd runs on cuda or cpu, not {x.device}')
    params = (ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2, b2)
    fa.check_no_grad(x, *params)
    raw = _check(x, params, num_heads)
    n, _, d = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _fn('sav_tnt_fwd', 14, 4, 2)(
            x.data_ptr(), *(t.data_ptr() for t in raw), out.data_ptr(), n, d,
            raw[8].shape[1], num_heads, eps, 1.0 / math.sqrt(d // num_heads),
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
    gradients on every call. The weights are staged from the f32
    parameters as the forward's are. bf16 only; gradients f32."""
    if x.device.type == 'cpu':
        return inner_layer_bwd_plain(x, ln1s, ln1b, wq, wk, wv, wo, ln2s,
                                     ln2b, w1, b1, w2, b2, g, num_heads, eps)
    if x.device.type != 'cuda':
        raise ValueError(f'inner_layer_bwd runs on cuda or cpu, not {x.device}')
    params = (ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2, b2)
    fa.check_no_grad(x, *params, g)
    raw = _check(x, params, num_heads)
    g = g.to(x.dtype).contiguous()
    fa.check_cuda_bf16('g', g, x.device)
    if g.shape != x.shape:
        raise ValueError(f'g has shape {tuple(g.shape)}, expected {tuple(x.shape)}')
    n, _, d = x.shape
    hidden = raw[8].shape[1]
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
        err = _fn('sav_tnt_bwd', 18, 4, 2)(
            x.data_ptr(), g.data_ptr(), *(t.data_ptr() for t in raw),
            dx.data_ptr(), gw.data_ptr(), gvec.data_ptr(), ws.data_ptr(), n,
            d, hidden, h, eps, 1.0 / math.sqrt(hd), fa.stream_of(x.device))
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
