"""BoTNet's relative-position attention core as one differentiable call
(counterpart of ``sav_tpu/ops/botnet_attention.py``).

The decomposed 2-D relative logits stay library ops with torch autograd
(``decomposed_rel_logits``: two einsums against the learned per-axis
embeddings and the skew ``relative_shift``), as they stay XLA with
autodiff in the JAX package; the attention core takes them as two
``[B, h, L, g]`` f32 tensors and expands the bias per logit::

    s[q, j] = qs[q] . k[j] + rel_h[q, j // g] + rel_w[q, j % g]

on ``[B, L, h*d]`` head bands (qs pre-scaled, L = g*g keys in row-major
grid order). ``bot_fwd`` is the port of K9a ``_fwd_kernel`` and
``bot_bwd`` of K9b ``_bwd_kernel`` (``csrc/botnet_attention.cu``); on a
CPU tensor each runs its plain twin, on a CUDA tensor its kernels, or it
raises. ``bot_core`` is the ``torch.autograd.Function`` around them: like
the JAX ``custom_vjp`` it saves the inputs, the output and the lse (no
``[B, h, L, L]`` tensor) and its backward returns dq, dk, dv, drel_h and
drel_w. ``bot_mhsa_reference`` mirrors the JAX package's jnp twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from sav_tpu_torch import _build
from sav_tpu_torch.ops import flash_attention as fa

HEAD_DIMS = (64, 128)   # head widths the kernels are instantiated for


# ------------------------------------------------------ relative logits

def relative_shift(rel_logits: torch.Tensor) -> torch.Tensor:
    """Skews ``[B, h, L, 2L-1]`` relative logits into absolute
    ``[B, h, L, L]``: row q, column k ends up holding the logit for the
    relative offset ``k - q`` (the pad-reshape-slice trick)."""
    b, h, length, _ = rel_logits.shape
    x = F.pad(rel_logits, (0, 1)).reshape(b, h, 2 * length * length)
    x = F.pad(x, (0, length - 1)).reshape(b, h, length + 1, 2 * length - 1)
    return x[:, :, :length, length - 1:]


def decomposed_rel_logits(qs, emb_h, emb_w, num_heads: int, g: int):
    """Per-axis relative logits of a scaled query in band layout.

    qs ``[B, L, h*d]`` (L = g*g, row-major over the (H, W) grid);
    emb_h/emb_w ``[2g-1, d]``. Returns ``(rel_h, rel_w)``, each
    ``[B, h, L, g]`` f32 and contiguous: ``rel_h[..., (H, W), P]`` is the
    height-offset term of key row P, ``rel_w[..., (H, W), Q]`` the
    width-offset term of key column Q. The einsums run in f32, as JAX
    promotes the bf16 query against the f32 embedding."""
    b, length, hd = qs.shape
    d = hd // num_heads
    q5 = qs.float().reshape(b, g, g, num_heads, d).permute(0, 3, 1, 2, 4)

    def one_axis(q5_axis, emb):
        x = torch.einsum('bhHWd,md->bhHWm', q5_axis, emb.float())
        x = relative_shift(x.reshape(b, num_heads * g, g, 2 * g - 1))
        return x.reshape(b, num_heads, g, g, g)

    rel_w = one_axis(q5, emb_w)                               # [B,h,H,W,Q]
    rel_h = one_axis(q5.transpose(2, 3), emb_h).transpose(2, 3)   # [B,h,H,W,P]
    flat = lambda r: r.reshape(b, num_heads, length, g).contiguous()
    return flat(rel_h), flat(rel_w)


def expand_bias(rel_h, rel_w, g: int):
    """The two ``[B, h, L, L]`` bias terms: column j of the first takes
    ``rel_h[..., j // g]``, of the second ``rel_w[..., j % g]`` (what the
    kernels compute per logit)."""
    return rel_h.repeat_interleave(g, dim=-1), rel_w.repeat(1, 1, 1, g)


# ------------------------------------------------------------ geometry

def _smem(which: int, g: int, head_d: int) -> int:
    """Shared memory of K9a (``which`` 0) or of K9b's dq (1) or dkv (2)
    kernel at grid side g and head width d, 0 where a block cannot hold
    it: ``sav_bot_smem`` of ``csrc/botnet_attention.cu`` (the card's own
    count, which ``bot_plan`` mirrors)."""
    fn = _build.library('botnet_attention').sav_bot_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return fn(which, g, head_d)


_BOX = 64 * 64 * 2          # a 64 x 64 bf16 TMA box
_DS_PITCH = 65              # f32 pitch of the dq kernel's ds tile rows


def bot_bwd_plan(g: int, head_d: int) -> dict:
    """K9b's shared memory at grid side g and head width d, mirrored from
    ``dq_plan``/``dkv_plan`` (``sav_bot_bwd_plan``) in
    ``csrc/botnet_attention.cu``. ``pitch``: the drel_w bins' f32 pitch
    (g | 1). ``dq``: Q and dO of a unit's 128 rows, a ring of K and V
    tiles, one region for O and then the two warpgroups' f32 ds tiles, the
    unit's rel rows (g f32 each), each warpgroup's drel_w bins, delta, the
    mbarriers, 1024 bytes of alignment slack. ``dkv``: K and V of 128 keys, a ring of slots (each a
    query tile's Q and dO, its rel rows, lse and delta, 1024-byte aligned)
    and the mbarriers. Each takes the most ring ``stages`` (<= 4) that fit
    a block; ``smem`` and ``stages`` are 0 where not even one does."""
    nb, gp = head_d // 64, g | 1
    res = 2 * nb * _BOX
    ods = max(res, 2 * 64 * _DS_PITCH * 4)
    dq_fixed = 2 * res + ods + 2 * 128 * g * 4 + 2 * 64 * gp * 4 + 128 * 4
    slot = -(-(2 * nb * _BOX + 2 * 64 * g * 4 + 2 * 64 * 4) // 1024) * 1024

    def fit(fixed, per_stage):
        for stages in range(4, 0, -1):
            smem = fixed + stages * per_stage + (2 + 2 * stages) * 8 + 1024
            if smem <= fa.SMEM_LIMIT:
                return dict(smem=smem, stages=stages)
        return dict(smem=0, stages=0)

    return dict(pitch=gp, dq=fit(dq_fixed, 2 * nb * _BOX),
                dkv=dict(fit(2 * res, slot), slot=slot))


_UNIT_ROWS = 128            # query rows of a K9a unit (two 64-row halves)


def fwd_width(length: int) -> int:
    """K9a's keys a tile at ``length`` keys (``fwd_width`` in the C
    source): 104 where 104-key steps cover the keys in no more columns
    than 64-key tiles do (L = 196: two steps, 208 columns against 256),
    else 64 (L = 169: 192 against 208). A 104-key step's box holds 112
    rows (``box_rows``: p V runs 16-key steps)."""
    return 104 if -(-length // 104) * 104 <= -(-length // 64) * 64 else 64


def box_rows(width: int) -> int:
    """Rows of a K9a key tile's box: the width rounded up to 16."""
    return -(-width // 16) * 16


def bot_fwd_plan(g: int, head_d: int) -> dict:
    """K9a's launch plan at grid side g and head width d, mirrored from
    ``fwd_plan``/``sav_bot_fwd_plan`` in ``csrc/botnet_attention.cu``:
    ``width`` (the key tile, ``fwd_width`` of L = g*g), ``tiles`` (key
    tiles a unit of 128 query rows), ``qbufs`` (buffers of a unit's Q and
    rel rows: 2 lets the next unit's land under this one's work),
    ``stages`` (ring slots, each one K or one V tile), ``res`` (a buffer's
    bytes: Q's two 64-row halves, then the rel_h and rel_w rows, g f32
    each, 1024-byte aligned), ``slot`` (``box_rows(width)`` rows of d
    bf16) and ``smem`` (buffers, slots, the mbarriers, 1024 bytes of
    alignment slack). Two buffers and the most slots (2-4) that fit, else
    one buffer, else 64-key tiles; ``stages`` and ``smem`` 0 where nothing
    fits."""
    nb, length = head_d // 64, g * g
    res = -(-(2 * nb * _BOX + 2 * _UNIT_ROWS * g * 4) // 1024) * 1024
    for w in dict.fromkeys((fwd_width(length), 64)):
        slot = nb * box_rows(w) * 128
        for qbufs in (2, 1):
            for stages in (4, 3, 2):
                smem = (qbufs * res + stages * slot
                        + (2 * qbufs + 2 * stages) * 8 + 1024)
                if smem <= fa.SMEM_LIMIT:
                    return dict(width=w, tiles=-(-length // w), qbufs=qbufs,
                                stages=stages, res=res, slot=slot, smem=smem)
    return dict(width=64, tiles=-(-length // 64), qbufs=1, stages=0,
                res=res, slot=nb * 64 * 128, smem=0)


def fwd_smem(g: int, head_d: int) -> int:
    """K9a's shared memory (``bot_fwd_plan``), 0 past a block's."""
    return bot_fwd_plan(g, head_d)['smem']


def _refusal(g: int, num_heads: int, head_d: int, device) -> str | None:
    """Why the K9 port does not take a g x g grid of ``num_heads`` heads of
    width ``head_d`` on a ``device`` of that type, or None where it does."""
    if g < 1 or num_heads < 1:
        return 'the grid side and the head count must be at least 1'
    if head_d not in HEAD_DIMS:
        return f'the kernels are built for head widths {HEAD_DIMS}'
    if torch.device(device).type == 'cuda':
        plan = bot_bwd_plan(g, head_d)
        if min(fwd_smem(g, head_d), plan['dq']['smem'],
               plan['dkv']['smem']) == 0:
            return ('a tile\'s operands and the grid\'s rel-logit rows '
                    f'exceed a block\'s {fa.SMEM_LIMIT} bytes of shared '
                    'memory')
    return None


# the wrappers' own copy of _refusal's answers, by shape and device type:
# a call checks its shape once, not on every launch
_refusal_of = functools.lru_cache(maxsize=None)(
    lambda *key: _refusal(*key))


def supported(g: int, num_heads: int, head_d: int, device='cuda') -> bool:
    """Whether the K9 port takes a g x g grid (L = g*g) of ``num_heads``
    heads of width ``head_d``: d in ``HEAD_DIMS`` and, on the card, each
    kernel's tiles plus the rel-logit rows of a tile within one block's
    227 KB of shared memory (``fwd_smem`` and ``bot_bwd_plan``, the
    kernels' formulas). Every BoTNet config at 224 (g = 14, d = 128)
    fits; every grid the parent's kernels took (g <= 49 at d = 128, g <=
    69 at d = 64) and more. The TPU caps (g <= 28,
    at most 16 heads, d a multiple of 64) were VMEM and lane limits and
    have no counterpart here. Off the card the plain twins have no such
    budget."""
    return _refusal(g, num_heads, head_d, device) is None


# ------------------------------------------------------------ plain twins

def _heads(a, num_heads):
    b, length, hd = a.shape
    return a.reshape(b, length, num_heads, hd // num_heads)


def _logits(qs, k, rel_h, rel_w, num_heads, g):
    """f32 ``[B, h, L, L]`` logits with the bias, in the kernels' order
    ``(qs k^T + rel_h) + rel_w``."""
    s = torch.einsum('bqhd,bkhd->bhqk', _heads(qs, num_heads).float(),
                     _heads(k, num_heads).float())
    bias_h, bias_w = expand_bias(rel_h.float(), rel_w.float(), g)
    return s + bias_h + bias_w


def bot_fwd_plain(qs, k, v, rel_h, rel_w, num_heads: int, g: int):
    """Plain twin of ``bot_fwd``: f32 logits with the bias, p = exp(s - m)
    rounded to v's dtype before the value product, f32 accumulation, the
    output divided by sum(p) and rounded to qs's dtype, as ``_fwd_kernel``
    does. Returns ``(out [B, L, h*d], lse [B, h, L] f32)``."""
    b, length, hd = qs.shape
    s = _logits(qs, k, rel_h, rel_w, num_heads, g)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum('bhqk,bkhd->bhqd', p.to(v.dtype).float(),
                     _heads(v, num_heads).float()) / lsum
    out = o.permute(0, 2, 1, 3).reshape(b, length, hd).to(qs.dtype)
    return out, (m + torch.log(lsum))[..., 0]


def bot_bwd_plain(qs, k, v, rel_h, rel_w, out, lse, grad, num_heads: int,
                  g: int):
    """Plain twin of ``bot_bwd``, following ``_bwd_kernel``: p = exp(s -
    lse) in f32; dv = p (rounded to grad's dtype)^T grad; dp = grad v^T;
    di = rowsum(grad * out) in f32; ds = (dp - di) p in f32; dq = ds k and
    dk = ds^T qs from ds rounded to qs's dtype; drel_h and drel_w sums of
    the f32 ds over each key row P and key column Q of the grid. Returns
    ``(dq, dk, dv, drel_h, drel_w)``: the first three in qs's dtype, the
    rel gradients f32 ``[B, h, L, g]``."""
    b, length, hd = qs.shape
    cdt = qs.dtype
    p = torch.exp(_logits(qs, k, rel_h, rel_w, num_heads, g) - lse[..., None])
    gh = _heads(grad, num_heads).float()
    dv = torch.einsum('bhqk,bqhd->bkhd', p.to(cdt).float(), gh)
    dp = torch.einsum('bqhd,bkhd->bhqk', gh, _heads(v, num_heads).float())
    di = (grad.float() * out.float()).reshape(b, length, num_heads, -1).sum(-1)
    ds = (dp - di.transpose(1, 2)[..., None]) * p
    ds_c = ds.to(cdt).float()
    dq = torch.einsum('bhqk,bkhd->bqhd', ds_c, _heads(k, num_heads).float())
    dk = torch.einsum('bhqk,bqhd->bkhd', ds_c, _heads(qs, num_heads).float())
    cells = ds.reshape(b, num_heads, length, g, g)
    band = lambda a: a.reshape(b, length, hd).to(cdt)
    return (band(dq), band(dk), band(dv), cells.sum(dim=-1),
            cells.sum(dim=-2))


# ------------------------------------------------------ kernel wrappers

def _fn(name, pointers, ints):
    fn = getattr(_build.library('botnet_attention'), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(qs, k, v, rel_h, rel_w, num_heads, g, **bands):
    """Device, dtypes, layouts and geometry the K9 kernels take; returns
    (B, L, d)."""
    device = qs.device
    for name, t in (('qs', qs), ('k', k), ('v', v), *bands.items()):
        fa.check_cuda_bf16(name, t, device)
    if qs.dim() != 3:
        raise ValueError(f'qs must be [B, L, h*d], got {tuple(qs.shape)}')
    b, length, hd = qs.shape
    for name, t in (('k', k), ('v', v), *bands.items()):
        if t.shape != qs.shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                             f'{tuple(qs.shape)}')
    if length != g * g:
        raise ValueError(f'L = {length} is not the g x g grid of g = {g}')
    if num_heads < 1 or hd % num_heads:
        raise ValueError(f'h*d = {hd} is not divisible by {num_heads} heads')
    d = hd // num_heads
    for name, t in (('rel_h', rel_h), ('rel_w', rel_w)):
        if (t.device != device or t.dtype != torch.float32
                or not t.is_contiguous()
                or tuple(t.shape) != (b, num_heads, length, g)):
            raise ValueError(
                f'{name} must be contiguous float32 {(b, num_heads, length, g)} '
                f'on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}')
    why = ('B must be at least 1' if b < 1
           else _refusal_of(g, num_heads, d, device.type))
    if why is not None:
        raise ValueError(f'the BoTNet attention kernels do not take B={b}, '
                         f'g={g}, h={num_heads}, d={d}: {why}')
    return b, length, d


def bot_fwd(qs, k, v, rel_h, rel_w, num_heads: int, g: int,
            save_lse: bool = False):
    """Port of K9a: ``(out, lse)`` of attention with the decomposed bias on
    ``[B, L, h*d]`` head bands (qs pre-scaled); lse ``[B, h, L]`` f32 when
    ``save_lse`` (the training forward), else None. On the card one
    persistent ``wgmma`` + TMA launch (``csrc/botnet_attention.cu``; key
    tiles by ``bot_fwd_plan``), bf16 only."""
    if qs.device.type == 'cpu':
        out, lse = bot_fwd_plain(qs, k, v, rel_h, rel_w, num_heads, g)
        return out, (lse if save_lse else None)
    if qs.device.type != 'cuda':
        raise ValueError(f'bot_fwd runs on cuda or cpu, not {qs.device}')
    fa.check_no_grad(qs, k, v, rel_h, rel_w)
    b, length, d = _check(qs, k, v, rel_h, rel_w, num_heads, g)
    out = torch.empty_like(qs)
    lse = (torch.empty(b, num_heads, length, dtype=torch.float32,
                       device=qs.device) if save_lse else None)
    with torch.cuda.device(qs.device):
        err = _fn('sav_bot_fwd', 7, 5)(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(),
            rel_w.data_ptr(), out.data_ptr(),
            lse.data_ptr() if save_lse else None, b, length, num_heads, g, d,
            fa.stream_of(qs.device))
    _build.check(err, 'bot_fwd')
    _build.count('bot_fwd_train' if save_lse else 'bot_fwd')
    return out, lse


def bot_bwd(qs, k, v, rel_h, rel_w, out, lse, grad, num_heads: int, g: int):
    """Port of K9b: ``(dq, dk, dv, drel_h, drel_w)`` of ``bot_fwd`` from its
    inputs, its out and lse and the cotangent ``grad`` of out (order and
    dtypes as ``bot_bwd_plain``). On the card two persistent ``wgmma`` +
    TMA launches: the dq kernel (dq, drel_h, drel_w and di) then the dkv
    kernel; every sum in a fixed order, no float atomics, so two calls
    give the same bits."""
    if qs.device.type == 'cpu':
        return bot_bwd_plain(qs, k, v, rel_h, rel_w, out, lse, grad,
                             num_heads, g)
    if qs.device.type != 'cuda':
        raise ValueError(f'bot_bwd runs on cuda or cpu, not {qs.device}')
    fa.check_no_grad(qs, k, v, rel_h, rel_w, out, lse, grad)
    b, length, d = _check(qs, k, v, rel_h, rel_w, num_heads, g, out=out,
                          grad=grad)
    if (lse.device != qs.device or lse.dtype != torch.float32
            or not lse.is_contiguous()
            or tuple(lse.shape) != (b, num_heads, length)):
        raise ValueError(f'lse must be contiguous float32 '
                         f'{(b, num_heads, length)} on {qs.device}, got '
                         f'{lse.dtype} {tuple(lse.shape)}')
    dq, dk, dv = (torch.empty_like(qs) for _ in range(3))
    drel_h, drel_w = torch.empty_like(rel_h), torch.empty_like(rel_w)
    delta = torch.empty_like(lse)
    dims = (b, length, num_heads, g, d, fa.stream_of(qs.device))
    with torch.cuda.device(qs.device):
        err = _fn('sav_bot_bwd_dq', 12, 5)(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            grad.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            drel_h.data_ptr(), drel_w.data_ptr(), *dims)
        _build.check(err, 'bot_bwd (dq)')
        _build.count('bot_bwd_dq')
        err = _fn('sav_bot_bwd_dkv', 10, 5)(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), grad.data_ptr(),
            rel_h.data_ptr(), rel_w.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims)
    _build.check(err, 'bot_bwd (dkv)')
    _build.count('bot_bwd_dkv')
    return dq, dk, dv, drel_h, drel_w


# --------------------------------------------------------- autograd core

CORES = ('kernel', 'plain')


class _BotCore(torch.autograd.Function):
    """``bot_core``'s ``custom_vjp``: saves qs, k, v, rel_h, rel_w, out and
    lse; the backward is K9b (``core='kernel'``) or its twin."""

    @staticmethod
    def forward(ctx, qs, k, v, rel_h, rel_w, num_heads, g, core):
        fwd = bot_fwd if core == 'kernel' else bot_fwd_plain
        out, lse = fwd(qs, k, v, rel_h, rel_w, num_heads, g,
                       **({'save_lse': True} if core == 'kernel' else {}))
        ctx.save_for_backward(qs, k, v, rel_h, rel_w, out, lse)
        ctx.num_heads, ctx.g, ctx.core = num_heads, g, core
        return out

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        bwd = bot_bwd if ctx.core == 'kernel' else bot_bwd_plain
        grads = bwd(*saved, grad.to(saved[0].dtype).contiguous(),
                    ctx.num_heads, ctx.g)
        return (*grads, None, None, None)


def bot_core(qs, k, v, rel_h, rel_w, num_heads: int, g: int,
             core: str = 'kernel'):
    """Attention with the decomposed rel-pos bias as one differentiable
    call: qs ``[B, L, h*d]`` pre-scaled, k and v alike, rel_h/rel_w
    ``[B, h, L, g]`` f32 (contiguous). Returns ``[B, L, h*d]`` in qs's
    dtype. ``core='kernel'`` runs ``bot_fwd``/``bot_bwd`` (the kernels on a
    CUDA tensor, the twins on a CPU one); ``core='plain'`` runs the same
    Function on the twins, on any device: the card's gradient check holds
    the kernels against it at the same boundary. With grad off it is the
    forward alone."""
    if core not in CORES:
        raise ValueError(f'core must be one of {CORES}, got {core!r}')
    args = (qs, k, v, rel_h, rel_w)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _BotCore.apply(*args, num_heads, g, core)
    if core == 'plain':
        return bot_fwd_plain(*args, num_heads, g)[0]
    return bot_fwd(*args, num_heads, g)[0]


def botnet_mhsa(qs, k, v, emb_h, emb_w, num_heads: int, g: int,
                core: str = 'kernel'):
    """The whole BoTMHSA core: the decomposed rel logits (library ops,
    autograd) and ``bot_core``. qs is the pre-scaled query in band layout
    ``[B, L, h*d]``; emb_h/emb_w the ``[2g-1, d]`` learned per-axis
    embeddings. Returns ``[B, L, h*d]``."""
    rel_h, rel_w = decomposed_rel_logits(qs, emb_h, emb_w, num_heads, g)
    return bot_core(qs, k, v, rel_h, rel_w, num_heads, g, core)


def bot_mhsa_reference(qs, k, v, emb_h, emb_w, num_heads: int, g: int):
    """Per-op twin of the JAX package's ``bot_mhsa_reference``: f32 logits
    plus the broadcast bias, softmax, probabilities in v's dtype,
    differentiable by autograd."""
    b, length, hd = qs.shape
    rel_h, rel_w = decomposed_rel_logits(qs, emb_h, emb_w, num_heads, g)
    s = torch.einsum('bqhd,bkhd->bhqk', _heads(qs, num_heads).float(),
                     _heads(k, num_heads).float())
    bias = (rel_h.reshape(b, num_heads, length, g, 1)
            + rel_w.reshape(b, num_heads, length, 1, g))
    s = s + bias.reshape(b, num_heads, length, length)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum('bhqk,bkhd->bqhd', p, _heads(v, num_heads))
    return o.reshape(b, length, hd)
