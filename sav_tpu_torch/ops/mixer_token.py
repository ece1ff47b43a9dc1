"""MLP-Mixer token-mixing sublayer as one differentiable call (counterpart
of ``sav_tpu/ops/mixer_token.py``).

``x + untranspose(FF(transpose(LN(x))))`` on ``[B, L, D]`` without the
transposes: LN over channels (f32 statistics, fast variance), a Dense over
tokens ``W1 [L, K]``, tanh-gelu, a Dense back ``W2 [K, L]``, +x. The
parameters are read in checkpoint layout (LayerNorm scale/bias ``[D]``,
FFBlock ``Dense_0``/``Dense_1`` kernels and biases), so the kernel and
per-op paths of ``models.mlp_mixer.MixerBlock`` share one tree.

``token_mix_fwd`` is the port of K8a ``_fwd_kernel`` and ``token_mix_bwd``
of K8b ``_bwd_kernel`` (``csrc/mixer_token.cu``); on a CPU tensor each
runs its plain twin, on a CUDA tensor its kernel, or it raises.
``token_mix_sublayer`` is the ``torch.autograd.Function`` around them:
like the JAX ``custom_vjp`` it saves x (and the parameters) only, and the
backward recomputes the forward from x.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sav_tpu_torch import _build
from sav_tpu_torch.ops import flash_attention as fa
from sav_tpu_torch.ops.fused_layer import (LN_EPS, _gelu_bwd_from_t,
                                           _gelu_fwd_t, _layernorm)

FWD_BAND = 128          # channels of a K8a block (csrc FWD_BAND)


# ------------------------------------------------------------ geometry

@functools.lru_cache(maxsize=None)
def _smem(which: str, l: int, k: int) -> int:
    """Shared memory of a K8a block (``which='fwd'``: W1 and W2 zero-padded
    to 16-multiples, the normalised and the gelu band, biases, row
    statistics) or of a K8b band block (``'bwd'``): ``sav_mixer_fwd_smem``
    / ``sav_mixer_bwd_smem`` of ``csrc/mixer_token.cu``, the one copy of
    the formulas."""
    fn = getattr(_build.library('mixer_token'), f'sav_mixer_{which}_smem')
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(l, k)


BWD_BAND = 64           # channels of a K8b work unit (csrc BWD_BAND, BAND)
MAX_CHUNKS = 64         # image chunks of K8b's dW GEMMs (csrc MAX_CHUNKS)
# the Hopper band kernel's widths (csrc/mixer_bwd_sm90.cuh): route ->
# (tokens LN, hidden KP); route 0 is the mma.sync band kernel. Its
# LN pass holds up to SM90_MAX_D channels of a row.
SM90_WIDTHS = {2: (200, 112), 1: (56, 32)}
SM90_MAX_D = 1024


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _band_bwd_smem(l: int, k: int) -> int:
    """``bwd_smem`` of ``csrc/mixer_token.cu``: the mma.sync band block
    (W1, W2 padded, the y/do union or f32 dy, f32 hp, bf16 dhp, b1, row
    statistics, the band's LN scale)."""
    lp, kp = _up(l, 16), _up(k, 16)
    union = max(2 * lp * (BWD_BAND + 8) * 2, lp * (BWD_BAND + 4) * 4)
    return ((lp * (kp + 8) + kp * (lp + 8)) * 2 + union
            + kp * (BWD_BAND + 4) * 4 + kp * (BWD_BAND + 8) * 2
            + (kp + 2 * lp + BWD_BAND) * 4)


def _sm90_smem(ln: int, kp: int) -> int:
    """``Geo<LN, KP>::SMEM`` of ``csrc/mixer_bwd_sm90.cuh``: W1 and W2 as
    KP rows x LP tokens in 64-token chunks, two warpgroups' x and do tiles
    (LP x 128 bytes), their row statistics and band parameters, b1, four
    mbarriers, 1024 bytes of alignment slack."""
    lp = _up(ln, 16)
    nch = -(-lp // 64)
    return (2 * nch * kp * 128 + 4 * lp * 128 + 2 * 2 * lp * 4
            + 2 * 2 * BWD_BAND * 4 + kp * 4 + 4 * 8 + 1024)


def _sm90_fwd_smem(ln: int, kp: int) -> int:
    """``FwdGeo<LN, KP>::SMEM`` of ``csrc/mixer_bwd_sm90.cuh``: W1 and W2
    as the backward holds them, two x tiles a warpgroup (LP x 128 bytes),
    each warpgroup's row statistics, b2 over LP tokens, b1, four mbarriers,
    1024 bytes of alignment slack."""
    lp = _up(ln, 16)
    nch = -(-lp // 64)
    return (2 * nch * kp * 128 + 4 * lp * 128 + 2 * 2 * lp * 4 + lp * 4
            + kp * 4 + 4 * 8 + 1024)


def _fwd_band_smem(l: int, k: int) -> int:
    """``fwd_smem`` of ``csrc/mixer_token.cu``: the mma.sync forward block
    (W1, W2 padded, the y and gelu bands, b1, b2, row statistics, the band's
    LN scale and bias)."""
    lp, kp = _up(l, 16), _up(k, 16)
    return ((lp * (kp + 8) + kp * (lp + 8) + lp * (FWD_BAND + 8)
             + kp * (FWD_BAND + 8)) * 2 + (kp + 3 * lp + 2 * FWD_BAND) * 4)


def _route(l: int, k: int, d: int) -> int:
    """The band kernels' route (``mixb::route_of``): 1 and 2 the Hopper
    kernels at (56, 32) and (200, 112), 0 past them or past 1024
    channels."""
    return (0 if d > SM90_MAX_D else 1 if l <= 56 and k <= 32
            else 2 if l <= 200 and k <= 112 else 0)


def _check_geometry(what: str, batch: int, l: int, k: int, d: int) -> None:
    if batch < 1 or l < 1 or k < 1 or d % FWD_BAND:
        raise ValueError(f'{what} needs B, L, K >= 1 and D a multiple of '
                         f'{FWD_BAND}, got B={batch}, L={l}, K={k}, D={d}')


def mixer_fwd_plan(batch: int, l: int, k: int, d: int, sms: int = 132) -> dict:
    """Launch plan of K8a on ``sms`` SMs, mirrored from
    ``sav_mixer_fwd_plan`` in ``csrc/mixer_token.cu``: ``route`` (2 and 1:
    the Hopper forward band kernel at ``widths`` (LN, KP) = (200, 112) and
    (56, 32); 0: an ``mma.sync`` block per (128-channel band, image), past
    those widths or past 1024 channels), ``units`` ((image, 64-channel
    band) pairs; route 0 (image, 128-channel band)), ``ctas`` (blocks of
    the band work), ``units_per_wg`` (units of the busiest warpgroup; route
    0: 1) and ``smem`` (the band kernel's dynamic shared memory). Both
    routes follow a launch of the row statistics. Raises ValueError where
    ``sav_mixer_fwd`` refuses the geometry."""
    _check_geometry('token_mix_fwd', batch, l, k, d)
    route = _route(l, k, d)
    if route:
        units = batch * (d // BWD_BAND)
        ctas = min(-(-units // 2), max(sms, 1)) if sms > 0 else -(-units // 2)
        per_wg = -(-units // (2 * ctas))
        smem = _sm90_fwd_smem(*SM90_WIDTHS[route])
    else:
        units = ctas = batch * (d // FWD_BAND)
        per_wg, smem = 1, _fwd_band_smem(l, k)
    return dict(route=route, widths=SM90_WIDTHS.get(route, (0, 0)),
                units=units, ctas=ctas, units_per_wg=per_wg, smem=smem)


def mixer_bwd_plan(batch: int, l: int, k: int, d: int, sms: int = 132) -> dict:
    """Launch plan of K8b on ``sms`` SMs, mirrored from ``sav_mixer_bwd_plan``
    in ``csrc/mixer_token.cu``: ``route`` (2 and 1: the Hopper band kernel
    at ``widths`` (LN, KP) = (200, 112) and (56, 32), with the LN row
    pass; 0: the ``mma.sync`` band kernel and finish pass, past those
    widths or past 1024 channels), ``units`` ((image,
    64-channel band) pairs), ``ctas`` (blocks of the band work; route 0 one
    a unit), ``units_per_wg`` (units of the busiest warpgroup), ``smem``
    (the band kernel's dynamic shared memory), ``chunks`` and
    ``per_chunk`` (the dW GEMMs' image chunks), ``scratch`` (name ->
    (offset, bytes) in the workspace, each at a 256-byte offset) and
    ``workspace`` (its bytes). Raises ValueError where ``sav_mixer_bwd``
    refuses the geometry (the shared memory of the K8a block and of the
    ``mma.sync`` K8b block is held by ``supported`` on the card)."""
    _check_geometry('token_mix_bwd', batch, l, k, d)
    bands = d // BWD_BAND
    route = _route(l, k, d)
    units = batch * bands
    if route:
        ctas = min(-(-units // 2), max(sms, 1)) if sms > 0 else -(-units // 2)
        per_wg = -(-units // (2 * ctas))
        smem = _sm90_smem(*SM90_WIDTHS[route])
    else:
        ctas, per_wg, smem = units, 1, _band_bwd_smem(l, k)
    per_chunk = -(-batch // MAX_CHUNKS)
    chunks = -(-batch // per_chunk)
    bl, bk = batch * l, batch * k
    scratch, at = {}, 0
    for name, nbytes in (('stats', bl * 2 * 4), ('y', bl * d * 2),
                         ('gact', bk * d * 2), ('dh', bk * d * 2),
                         ('dy', bl * d * 4), ('rows', bl * bands * 2 * 4),
                         ('db1', bk * bands * 4 * 4), ('db2', bl * bands * 4),
                         ('dls', batch * d * 4), ('dlb', batch * d * 4),
                         ('w1', chunks * l * k * 4), ('w2', chunks * k * l * 4)):
        scratch[name] = (at, nbytes)
        at += _up(nbytes, 256)
    return dict(route=route, widths=SM90_WIDTHS.get(route, (0, 0)),
                units=units, ctas=ctas, units_per_wg=per_wg, smem=smem,
                chunks=chunks, per_chunk=per_chunk, scratch=scratch,
                workspace=at)


def _refusal(l: int, k: int, d: int, device) -> str | None:
    """Why the K8 port does not take tokens ``l``, token hidden ``k`` and
    channels ``d`` on ``device``, or None where it does."""
    if l < 1 or k < 1:
        return 'L and K must be at least 1'
    if d % FWD_BAND:
        return f'D must be a multiple of the kernels\' {FWD_BAND}-channel bands'
    if torch.device(device).type == 'cuda':
        need = max(_smem('fwd', l, k), _smem('bwd', l, k))
        if need > fa.SMEM_LIMIT:
            return (f'W1, W2 and a channel band need {need} bytes of shared '
                    f'memory per block, more than the {fa.SMEM_LIMIT} of one '
                    f'block')
    return None


def supported(l: int, k: int, d: int, device='cuda') -> bool:
    """Whether the K8 port takes tokens ``l``, token hidden ``k`` and
    channels ``d``: whole 128-channel bands, and on the card W1, W2 and a
    band of both kernels within one block's 227 KB of shared memory
    (``_smem``). Every ``mixer_*`` config at 224 fits (L in {49, 196}, K in
    {24, 98}, D in {512, 768, 1024}); @384 (L = 576, K = 288) does not. The
    TPU bound ``8 <= l <= 256`` has no counterpart: L < 8 is taken. Off the
    card the plain twins have no such budget."""
    return _refusal(l, k, d, device) is None


def auto_route(l: int, k: int, d: int, device) -> bool:
    """Whether ``use_kernel='auto'`` takes the K8 port: never off the card,
    where the JAX package takes its jnp path off the TPU; on the card
    always, and a shape the kernels do not take raises rather than run the
    per-op path unasked (``use_kernel=False`` asks for it)."""
    if torch.device(device).type != 'cuda':
        return False
    why = _refusal(l, k, d, device)
    if why is not None:
        raise NotImplementedError(
            f'the token-mix kernels do not take L={l}, K={k}, D={d}: {why} '
            f'(ROADMAP.md Queue 2, K8); use_kernel=False runs the per-op '
            f'path')
    return True


# ------------------------------------------------------------ plain twins

def token_mix_fwd_plain(x, ls, lb, w1, b1, w2, b2, eps=LN_EPS):
    """Plain twin of ``token_mix_fwd``, rounding where ``_fwd_kernel``
    rounds: y and gelu(hp) in x.dtype, W1/W2 cast to it; hp, biases, gelu
    and the residual add in f32."""
    cdt = x.dtype
    y = _layernorm(x, ls, lb, eps)[0].float()
    hp = torch.einsum('lk,bld->bkd', w1.to(cdt).float(), y) \
        + b1.float()[:, None]
    gact = _gelu_fwd_t(hp)[0].to(cdt).float()
    t = torch.einsum('kl,bkd->bld', w2.to(cdt).float(), gact) \
        + b2.float()[:, None]
    return (x.float() + t).to(cdt)


def token_mix_bwd_plain(x, ls, lb, w1, b1, w2, b2, g, eps=LN_EPS):
    """Plain twin of ``token_mix_bwd``, following ``_bwd_kernel``'s closed
    form (``mixer_token.py:99-162``): recompute from x, then dW2, db2,
    dgact, dhp = dgact * gelu'(hp) (f32 up to db1), dW1, db1, dy, the LN
    backward over D and dx = do + dx_ln; each weight gradient summed over
    the images. Returns (dx, dls, dlb, dw1, db1, dw2, db2), gradients f32."""
    cdt = x.dtype
    w1c, w2c = w1.to(cdt).float(), w2.to(cdt).float()
    y, xhat, inv = _layernorm(x, ls, lb, eps)
    yb = y.float()
    hp = torch.einsum('lk,bld->bkd', w1c, yb) + b1.float()[:, None]
    gact, t = _gelu_fwd_t(hp)
    gb = gact.to(cdt).float()
    do = g.to(cdt).float()
    dw2 = torch.einsum('bkd,bld->kl', gb, do)
    db2 = do.sum(dim=(0, 2))
    dgact = torch.einsum('kl,bld->bkd', w2c, do)
    dhp = dgact * _gelu_bwd_from_t(hp, t)
    dhpb = dhp.to(cdt).float()
    dw1 = torch.einsum('bld,bkd->lk', yb, dhpb)
    db1 = dhp.sum(dim=(0, 2))
    dy = torch.einsum('lk,bkd->bld', w1c, dhpb)
    dxhat = dy * ls.float()
    dls = (dy * xhat).sum(dim=(0, 1))
    dlb = dy.sum(dim=(0, 1))
    dx_ln = inv * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                   - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return (do + dx_ln).to(cdt), dls, dlb, dw1, db1, dw2, db2


def token_mix_reference(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """Per-op twin in the model's transposed layout (``MixerBlock``'s
    per-op path), for equality tests; differentiable by autograd."""
    cdt = x.dtype
    y = _layernorm(x, ln_scale, ln_bias, LN_EPS)[0]
    z = y.transpose(-1, -2)                                   # [B, D, L]
    h = torch.nn.functional.gelu(z @ w1.to(cdt) + b1.to(cdt),
                                 approximate='tanh')
    t = h @ w2.to(cdt) + b2.to(cdt)
    return x + t.transpose(-1, -2)


# ------------------------------------------------------ kernel wrappers

def _fn(name, pointers, ints, floats=0, restype=ctypes.c_int):
    """The C entry ``name`` of ``csrc/mixer_token.cu`` with its argument
    types: ``pointers`` pointers, ``ints`` ints, ``floats`` floats, then a
    stream for a launching entry (``restype`` int)."""
    fn = getattr(_build.library('mixer_token'), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                       + [ctypes.c_float] * floats
                       + ([ctypes.c_void_p] if restype is ctypes.c_int else []))
        fn.restype = restype
    return fn


def _check(x, ls, lb, w1, b1, w2, b2):
    """Device, dtype and geometry the K8 kernels take; returns the
    parameters as the kernels read them (W1/W2 in x's dtype, the rest f32,
    all contiguous on x's device)."""
    fa.check_cuda_bf16('x', x, x.device)
    if x.dim() != 3:
        raise ValueError(f'x must be [B, L, D], got {tuple(x.shape)}')
    b, l, d = x.shape
    k = w1.shape[-1]
    shapes = (('ln_scale', ls, (d,)), ('ln_bias', lb, (d,)),
              ('w1', w1, (l, k)), ('b1', b1, (k,)), ('w2', w2, (k, l)),
              ('b2', b2, (l,)))
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {shape}')
    why = 'B must be at least 1' if b < 1 else _refusal(l, k, d, x.device)
    if why is not None:
        raise ValueError(
            f'the token-mix kernels do not take B={b}, L={l}, K={k}, D={d}: '
            f'{why}')
    cast = lambda t, dt: t.to(x.device, dt).contiguous()
    return (cast(ls, torch.float32), cast(lb, torch.float32),
            cast(w1, x.dtype), cast(b1, torch.float32), cast(w2, x.dtype),
            cast(b2, torch.float32))


def token_mix_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=LN_EPS):
    """Port of K8a: ``x + W2^T gelu(W1^T LN(x) + b1) + b2`` contracting
    over tokens, on ``[B, L, D]``. On the card two launches
    (``csrc/mixer_token.cu``): the LN statistics of every row, then the
    band work: up to 200 tokens and 112 hidden units the persistent
    ``wgmma`` + TMA kernel of ``csrc/mixer_bwd_sm90.cuh`` over (image,
    64-channel band) units, W1 and W2 resident per block
    (``mixer_fwd_plan``'s route; past them an ``mma.sync`` block per
    (128-channel band, image)). bf16 only."""
    if x.device.type == 'cpu':
        return token_mix_fwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    if x.device.type != 'cuda':
        raise ValueError(f'token_mix_fwd runs on cuda or cpu, not {x.device}')
    fa.check_no_grad(x, ln_scale, ln_bias, w1, b1, w2, b2)
    ls, lb, w1c, b1c, w2c, b2c = _check(x, ln_scale, ln_bias, w1, b1, w2, b2)
    b, l, d = x.shape
    stats = torch.empty(b * l, 2, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _fn('sav_mixer_fwd', 9, 4, 1)(
            x.data_ptr(), ls.data_ptr(), lb.data_ptr(), w1c.data_ptr(),
            b1c.data_ptr(), w2c.data_ptr(), b2c.data_ptr(), stats.data_ptr(),
            out.data_ptr(), b, l, w1c.shape[1], d, eps, fa.stream_of(x.device))
    _build.check(err, 'token_mix_fwd')
    _build.count('token_mix_fwd')
    return out


def token_mix_bwd(x, ln_scale, ln_bias, w1, b1, w2, b2, g, eps=LN_EPS):
    """Port of K8b: (dx, dls, dlb, dw1, db1, dw2, db2) of ``token_mix_fwd``
    from x and the cotangent g, recomputing the forward. On the card
    (``csrc/mixer_token.cu``): row statistics; the band-local work (hp,
    dgact, dhp, dy, the band's LN row sums and per-image dscale/dbias) for
    every (image, 64-channel band) unit, on the persistent ``wgmma`` + TMA
    kernel of ``csrc/mixer_bwd_sm90.cuh`` up to 200 tokens and 112 hidden
    units (``mixer_bwd_plan``'s route; past them an ``mma.sync`` block per
    unit); a warp per row for dx; the dW1/dW2 GEMMs over image chunks;
    every partial summed in a fixed order. No float atomics: the gradients
    are the same on every run. bf16 only; gradients f32."""
    if x.device.type == 'cpu':
        return token_mix_bwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, g, eps)
    if x.device.type != 'cuda':
        raise ValueError(f'token_mix_bwd runs on cuda or cpu, not {x.device}')
    ls, lb, w1c, b1c, w2c, b2c = _check(x, ln_scale, ln_bias, w1, b1, w2, b2)
    g = g.to(x.dtype).contiguous()
    fa.check_cuda_bf16('g', g, x.device)
    if g.shape != x.shape:
        raise ValueError(f'g has shape {tuple(g.shape)}, expected {tuple(x.shape)}')
    b, l, d = x.shape
    k = w1c.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dls, dlb = torch.empty(d, **f32), torch.empty(d, **f32)
    dw1, db1 = torch.empty(l, k, **f32), torch.empty(k, **f32)
    dw2, db2 = torch.empty(k, l, **f32), torch.empty(l, **f32)
    ws = torch.empty(mixer_bwd_plan(b, l, k, d)['workspace'],
                     dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = _fn('sav_mixer_bwd', 15, 4, 1)(
            x.data_ptr(), g.data_ptr(), ls.data_ptr(), lb.data_ptr(),
            w1c.data_ptr(), b1c.data_ptr(), w2c.data_ptr(), dx.data_ptr(),
            dls.data_ptr(), dlb.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), ws.data_ptr(), b, l, k, d, eps,
            fa.stream_of(x.device))
    _build.check(err, 'token_mix_bwd')
    _build.count('token_mix_bwd')
    return dx, dls, dlb, dw1, db1, dw2, db2


# --------------------------------------------------------- autograd span

class _TokenMix(torch.autograd.Function):
    """``token_mix_sublayer``'s ``custom_vjp``: saves x, recomputes."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        return token_mix_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        params = ctx.saved_tensors
        grads = token_mix_bwd(*params, g)
        return tuple(gr.to(p.dtype) for gr, p in zip(grads, params))


def token_mix_sublayer(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """``x + untranspose(FF(transpose(LN(x))))`` on ``[B, L, D]``,
    differentiable in all seven tensors; w1 ``[L, K]``, w2 ``[K, L]`` in
    checkpoint layout. With grad off it is ``token_mix_fwd``."""
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _TokenMix.apply(*args)
    return token_mix_fwd(*args)
