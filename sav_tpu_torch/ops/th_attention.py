"""Talking-heads attention sublayer under one autograd boundary
(counterpart of ``sav_tpu/ops/th_attention.py``).

CaiT's body blocks mix the attention logits across heads before AND after
the softmax with learned ``[H, H]`` transforms. The span ``W_o @
TalkingHeadsMHA(LN(x))`` (``+x`` optional) is one
``torch.autograd.Function`` whose forward saves flash-style residuals
``(q, k, v, attn, lse)``, the lse being that of each MIXED head: no ``[B,
H, L, L]`` tensor is kept. Routes:

  * ``'fused'``   - the whole forward on the K5a port
                    (``th_attention_fwd``: LN, the ``wgmma`` QKV GEMM with q
                    scaled, K6a's two-sweep talking-heads core, the out
                    GEMM), backward core on the K5b port
                    (``th_attention_bwd``, ``csrc/th_bwd.cu``).
  * ``'blocked'`` - LN and projections as library ops, the core on the K6a
                    port (``th_core_fwd``: two sweeps over the keys, any
                    length; also K5a's core), backward core on the K6b port
                    (``th_core_bwd``): where K5a's GEMMs do not take D
                    (no factory CaiT).
  * ``'xla'``     - the same boundary with the plain torch core (the JAX
                    package's name for its jnp path).
The out-projection, weight gradients and LayerNorm backward are library
ops in every route, as they are XLA in the JAX package. On a CUDA tensor
each kernel wrapper launches its hand-written kernel (the forwards in
``csrc/th_attention.cu``, the backward in ``csrc/th_bwd.cu``) or raises; on
a CPU tensor it runs its plain twin. head_ch 48 is taken as it is: the
kernels run d = 48 as three 16-deep k-steps, so nothing is padded to 64
(the JAX package's ``_pad_weights`` has no counterpart).

CaiT's ``quantized='all'`` serving span is ``th_attention_sublayer_q8``:
where the JAX package's ``th_supported`` holds, the port of K11
``_th_q8_kernel`` (``th_attention_q8``, ``csrc/th_attention_q8.cu``; twin
``th_q8_reference``; launch plan ``th_q8_plan``): LN in f32, one set of
per-row codes for the int8 q/k/v projections, K6a's two-sweep core taking
the bands' codes in its epilogue, int8 out-projection; elsewhere the bf16
span above, as the JAX package falls back. Serving only: no backward.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sav_tpu_torch import _build
from sav_tpu_torch.ops import flash_attention as fa
from sav_tpu_torch.ops.fused_layer import (LN_EPS, _layernorm,
                                           _layernorm_bwd, _ln_f32,
                                           _project_qkv, _q8_weights, _wgrad,
                                           proj_takes_ragged)
from sav_tpu_torch.ops.int8_matmul_kernel import _quantize_tile
from sav_tpu_torch.ops.quantized import int_matmul

ROUTES = ('fused', 'blocked', 'xla')
HEAD_CH = 48                # the kernels' head width (every CaiT config)
KERNEL_HEADS = (4, 6, 8, 16)   # head counts the kernels are instantiated for
UNBUILT = ('every CaiT in the factory has 4, 6, 8 or 16 heads of 48; another '
           'head count needs an instantiation of the TH kernels of its own')
LOG2E = 1.4426950408889634


def th_bwd_plan(l: int, heads: int) -> dict:
    """Launch geometry of the backward (``csrc/th_bwd.cu``), mirrored from
    its ``Plan``. At H = 4, 6 and 8 (``design`` ``'fused'``): three
    persistent kernels (``'dq'``, ``'dk'``, ``'dv'``) whose work tiles are
    ``rows`` = 64 resident rows of one image, each streaming ``cols`` =
    16-row tiles through ``stages`` ring slots (DQ sweeps the keys twice),
    the bands read in ``boxes`` of 64 columns (a ceiling, as
    ``th_fwd_plan``'s). At H = 16 (``design`` ``'staged'``,
    ``csrc/th_bwd_staged.cuh``): the products kernel on 64 x 64 (query,
    key) tiles of one head, the mix kernel on ``mix_rows`` query rows of
    one image, and three GEMM launches (``'dq'``, ``'dk'``, ``'dv'``) on
    64-row tiles of one head stepping ``cols`` = 64 rows of depth at a
    time, read from the one mirror of that plan, ``th_bwd_staged_plan``.
    ``smem``: the dynamic shared memory of each kernel; ``dm_partials``: the ``[H, H]`` partials a call leaves per
    image (``dm_post`` of dM_post and ``dm_pre`` of dM_pre: 4 of each a
    work tile, or 1 of each a mix block), which the wrapper sums."""
    if heads not in KERNEL_HEADS:
        raise ValueError(f'the TH backward is built for H in {KERNEL_HEADS}, '
                         f'got {heads} ({UNBUILT})')
    rows = 64
    tiles = -(-l // rows)
    if heads == 16:
        staged = th_bwd_staged_plan(1, l)
        per = staged['blocks']['mix']          # dM partials an image
        return dict(design='staged', rows=rows, cols=64, stages=2,
                    tiles=tiles, mix_rows=STAGED_MIX_ROWS,
                    steps={'dq': tiles, 'dk': tiles, 'dv': tiles},
                    smem=staged['smem'], dm_post=per, dm_pre=per,
                    dm_partials=2 * per)
    cols, stages = 16, 3
    nb = -(-heads * HEAD_CH // 64)                  # 64-column boxes
    smem = {}
    for mode in ('dq', 'dk', 'dv'):
        nbytes = (2 * nb * rows * 64 * 2                # resident boxes
                  + stages * nb * cols * 64 * 2         # streamed, own boxes
                  + stages * heads * cols * 64 * 2      # streamed, per head
                  + 2 * heads * rows * cols * 2         # exchange buffers
                  + (2 * heads * rows * 4 if mode == 'dq'
                     else stages * 2 * heads * cols * 4)  # statistics
                  + (2 + 2 * stages + 4) * 8            # mbarriers
                  + 1024)                               # alignment slack
        smem[mode] = nbytes
    return dict(design='fused', rows=rows, cols=cols, stages=stages,
                tiles=tiles, boxes=nb,
                steps={'dq': 2 * -(-l // cols), 'dk': -(-l // cols),
                       'dv': -(-l // cols)},
                smem=smem, dm_post=4 * tiles, dm_pre=4 * tiles,
                dm_partials=8 * tiles)


STAGED_MIX_ROWS = 4         # query rows a block of the staged mix kernel


def th_bwd_staged_plan(b: int, l: int) -> dict:
    """The staged backward's workspace at H = 16, mirrored from
    ``sav_th_bwd_staged_plan``: ``lp`` (the row pitch of DS and PT, L
    rounded up to 8), ``regions`` (name -> (offset, bytes) of S and DA, f32
    ``[B, H, L, L]``, and DS and PT, bf16 ``[B, H, L, lp]``, each at a
    256-byte offset), ``workspace`` (their total), and the ``smem`` and
    ``blocks`` of the products, mix and GEMM launches (``th_bwd_plan``'s
    H = 16 geometry reads them at B = 1)."""
    heads, rows = 16, 64
    lp = -(-l // 8) * 8
    up = lambda n: -(-n // 256) * 256
    regions, at = {}, 0
    for name, nbytes in (('s', 4 * b * heads * l * l),
                         ('da', 4 * b * heads * l * l),
                         ('ds', 2 * b * heads * l * lp),
                         ('pt', 2 * b * heads * l * lp)):
        regions[name] = (at, nbytes)
        at += up(nbytes)
    nt = -(-l // rows)
    gemm = 2 * 2 * rows * 64 * 2 + 2 * 8 + 1024   # 2 slots of A and B
    return dict(lp=lp, regions=regions, workspace=at,
                smem={'products': 4 * rows * 64 * 2 + 8 + 1024,
                      'mix': (256 * (4 * heads + 1) + 10 * heads) * 4,
                      'dq': gemm, 'dk': gemm, 'dv': gemm},
                blocks={'products': b * heads * nt * nt,
                        'mix': b * -(-l // STAGED_MIX_ROWS),
                        'gemm': b * heads * nt})


def th_fwd_plan(l: int, heads: int) -> dict:
    """Launch geometry of K6a, also K5a's core (``csrc/th_fwd_sm90.cuh``),
    mirrored from its ``Geo`` and ``Plan``: persistent work tiles of
    ``rows`` = 64 query rows of one image, each sweeping the keys once for
    the lse and then once per ``groups`` of ``group`` output heads (one
    group at H <= 8, two of 8 at H = 16) in ``cols`` = 16-key tiles through
    ``stages`` ring slots (k in the first sweep, k and the group's v boxes
    after it); the mix warpgroup takes a tile as ``halves`` products;
    ``smem``: the kernel's dynamic shared memory (resident q, the ring, two
    bf16 exchange tiles of a group's heads, mbarriers). q and k are read in
    ``boxes`` of 64 columns, a ceiling: at H = 6 the 288 columns are 4.5
    boxes, and the fifth box's last 32 columns arrive as zeros (TMA's
    fill past the band's width) that no product reads. Raises ValueError
    for a head count the kernel is not built for."""
    if heads not in KERNEL_HEADS:
        raise ValueError(f'the TH forward is built for H in {KERNEL_HEADS}, '
                         f'got {heads} ({UNBUILT})')
    rows, cols = 64, 16
    group = min(heads, 8)
    stages = 4 if heads <= 8 else 2
    nb = -(-heads * HEAD_CH // 64)                  # 64-column boxes
    smem = (nb * rows * 64 * 2                      # resident q
            + stages * (nb + group) * cols * 64 * 2  # k boxes, group's v
            + 2 * group * rows * cols * 2           # exchange buffers
            + (2 + 2 * stages + 4) * 8              # mbarriers
            + 1024)                                 # alignment slack
    groups = heads // group
    return dict(rows=rows, cols=cols, stages=stages, tiles=-(-l // rows),
                group=group, groups=groups, halves=1 if heads <= 8 else 2,
                steps=(1 + groups) * -(-l // cols), boxes=nb, smem=smem)


def th_fwd_split(b: int, l: int, heads: int, sms: int = 132) -> int:
    """Work units a 64-row tile of K6a's kernel takes on a card of ``sms``
    SMs, mirrored from its ``split_of``: at H = 16 the two head groups go
    to blocks of their own (each sweeping the keys for the lse and then for
    its group) where the tiles fill less than a wave and the groups at most
    one, e.g. cait_m_48 @224 at B = 16 (64 tiles); else 1. K11's core never
    splits (a row's codes span both groups)."""
    tiles = b * -(-l // 64)
    groups = th_fwd_plan(l, heads)['groups']
    return groups if groups > 1 and tiles * groups <= sms else 1


def kernel_supported(heads: int, head_ch: int) -> bool:
    """Whether the TH kernels are built for this head geometry."""
    return head_ch == HEAD_CH and heads in KERNEL_HEADS


def fused_fits(l: int, heads: int, dim: int, device='cuda') -> bool:
    """Whether the K5a port takes the shape: its projection GEMMs (K1's,
    ``proj_takes_ragged``) need D and H*48 to be multiples of 32 (cait_xs's
    288 ends in a ragged tile), and on the card its core's shared memory
    (``th_fwd_plan``, the mirror of the kernel's ``sav_th_core_fwd_smem``
    that the card tests hold equal; the same at every L) must fit one
    block's 227 KB. Off the card the plain twin has no such budget. Read
    only by the TH routes (``th_route``, CaiT's ``'fused_th'``, the K5a
    wrapper): K1's own guard is ``fused_layer.fused_supported``."""
    hd = heads * HEAD_CH
    if (not proj_takes_ragged(hd, dim) or not proj_takes_ragged(dim, hd)
            or not kernel_supported(heads, HEAD_CH)):
        return False
    return (torch.device(device).type != 'cuda'
            or th_fwd_plan(l, heads)['smem'] <= fa.SMEM_LIMIT)


def th_route(l: int, heads: int, head_ch: int, dim: int, device):
    """The route ``use_kernel='auto'`` takes on this device and shape: None
    (the per-op path) off the card, as the JAX package takes its jnp path
    off the TPU.

    On the card: ``'fused'`` (K5) where ``fused_fits`` holds: the
    projection GEMMs take D and H*48 (multiples of 32) and the core's
    shared memory fits, at every length; else ``'blocked'`` (K6, any D).
    Both run the same two-sweep core; the blocked route's LN and
    projections are library ops, 0.33 ms slower a layer than K5a's at
    CaiT-S/24 @384 bs48 (``PERF.md``). These are the card's limits, not
    the TPU's VMEM caps (``_MAX_LIST_BYTES``, the ``l >= 320`` floor).
    Every factory CaiT takes K5 at every length: cait_xxs (D = 192, one
    192-wide GEMM tile), cait_xs (H = 6, D = 288, a ragged last GEMM tile
    and step), cait_s and cait_m (H = 16). A head geometry the
    kernels are not built for raises rather than run the per-op path
    unasked: ``use_kernel=False`` asks for it.
    """
    if torch.device(device).type != 'cuda':
        return None
    if not kernel_supported(heads, head_ch):
        raise NotImplementedError(
            f'{heads} heads of {head_ch}: the talking-heads kernels are built '
            f'for H in {KERNEL_HEADS} heads of {HEAD_CH} ({UNBUILT}); '
            f'use_kernel=False runs the per-op path')
    return 'fused' if fused_fits(l, heads, dim, device) else 'blocked'


# ------------------------------------------------------------ plain twins

def th_core_fwd_plain(q, k, v, m_pre, m_post, heads: int):
    """Plain twin of ``th_core_fwd`` (K6a) on ``[B, L, H*d]`` bands (q
    pre-scaled), rounding where the TPU kernels round: f32 logits, mixes
    and softmax, the post-mixed probabilities rounded to v's dtype before
    the PV product, f32 accumulation. Returns (attn like q, lse ``[B, H,
    L]`` f32 of each mixed head)."""
    b, l, hd = q.shape
    d = hd // heads
    split = lambda a: a.reshape(b, l, heads, d).float()
    s = torch.einsum('bqhd,bkhd->bhqk', split(q), split(k))
    st = torch.einsum('hi,bhqk->biqk', m_pre.float(), s)
    del s
    m = st.amax(dim=-1, keepdim=True)
    p = torch.exp(st - m)
    del st
    lsum = p.sum(dim=-1, keepdim=True)
    pt = torch.einsum('hi,bhqk->biqk', m_post.float(), p / lsum)
    del p
    attn = torch.einsum('bhqk,bkhd->bqhd', pt.to(v.dtype).float(), split(v))
    return (attn.reshape(b, l, hd).to(q.dtype),
            (m + torch.log(lsum))[..., 0])


def th_attention_fwd_plain(x, scale, bias, wq, wk, wv, wo, m_pre, m_post,
                           heads: int, eps: float = LN_EPS,
                           residual: bool = False,
                           save_residuals: bool = False):
    """Plain twin of ``th_attention_fwd`` (K5a): y, q (scaled by
    1/sqrt(d)), k, v, attn and out rounded to x's dtype, as the TPU kernel
    ``_th_fwd_kernel`` rounds; products in f32."""
    hd = wq.shape[1]
    dt = x.dtype
    y = _layernorm(x, scale, bias, eps)[0].float()
    q = ((y @ wq.float()) * (1.0 / math.sqrt(hd // heads))).to(dt)
    k = (y @ wk.float()).to(dt)
    v = (y @ wv.float()).to(dt)
    attn, lse = th_core_fwd_plain(q, k, v, m_pre, m_post, heads)
    out = attn.float() @ wo.float()
    if residual:
        out = x.float() + out
    out = out.to(dt)
    if not save_residuals:
        return out
    return out, (q, k, v, attn, lse)


def th_core_bwd_plain(q, k, v, do, lse, m_pre, m_post, heads: int):
    """Plain twin of the TH core backward (K5b and K6b compute the same
    function), following ``_th_bwd_kernel``: p_i = exp(st_i - lse_i);
    da_i = do_i v_i^T; dpn_j = sum_i M_post[j, i] da_i; dv_i = bf16(pt_i)^T
    do_i; dst_i = pn_i (dpn_i - rowsum(dpn_i pn_i)); ds_j = sum_i
    M_pre[j, i] dst_i rounded to q's dtype; dq_j = ds_j k_j, dk_j = ds_j^T
    q_j; dM_post[j, i] = sum da_i pn_j, dM_pre[j, i] = sum dst_i s_j.
    Returns (dq, dk, dv like q; dm_pre, dm_post ``[H, H]`` f32)."""
    b, l, hd = q.shape
    d = hd // heads
    split = lambda a: a.reshape(b, l, heads, d).float()
    q4, k4, v4, do4 = split(q), split(k), split(v), split(do)
    mpre, mpost = m_pre.float(), m_post.float()
    s = torch.einsum('bqhd,bkhd->bhqk', q4, k4)
    pn = torch.exp(torch.einsum('hi,bhqk->biqk', mpre, s) - lse[..., None])
    da = torch.einsum('bqhd,bkhd->bhqk', do4, v4)
    dpn = torch.einsum('ji,biqk->bjqk', mpost, da)
    dm_post = torch.einsum('biqk,bjqk->ji', da, pn)
    del da
    pt = torch.einsum('hi,bhqk->biqk', mpost, pn).to(do.dtype).float()
    dv = torch.einsum('bhqk,bqhd->bkhd', pt, do4)
    del pt
    dst = pn * (dpn - (dpn * pn).sum(dim=-1, keepdim=True))
    del dpn, pn
    dm_pre = torch.einsum('biqk,bjqk->ji', dst, s)
    del s
    ds = torch.einsum('ji,biqk->bjqk', mpre, dst).to(q.dtype).float()
    del dst
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, k4)
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, q4)
    flat = lambda a, like: a.reshape(b, l, hd).to(like.dtype)
    return flat(dq, q), flat(dk, k), flat(dv, v), dm_pre, dm_post


# K5b and K6b run the same function (and the same CUDA kernels): the
# backward has no shared-memory regime of its own (section in PERF.md)
th_attention_bwd_plain = th_core_bwd_plain


def th_sublayer_reference(x, scale, bias, wq, wk, wv, wo, m_pre, m_post,
                          eps=LN_EPS, residual=False):
    """Plain torch twin of the whole span with the reference semantics
    (``th_sublayer_reference`` of the JAX package); differentiable by
    autograd. Weights in the checkpoint layout ``[D, H, d]`` / ``[H, d,
    D]``."""
    d = wq.shape[2]
    cdt = x.dtype
    y = _layernorm(x, scale, bias, eps)[0]
    sqrt_d = torch.tensor(float(d)).sqrt().to(cdt)
    q = torch.einsum('bld,dhc->blhc', y, wq.to(cdt)) / sqrt_d
    k = torch.einsum('bld,dhc->blhc', y, wk.to(cdt))
    v = torch.einsum('bld,dhc->blhc', y, wv.to(cdt))
    s = torch.einsum('bqhc,bphc->bhqp', q.float(), k.float())
    s = torch.einsum('hi,bhqp->biqp', m_pre.float(), s)
    a = torch.softmax(s, dim=-1)
    a = torch.einsum('hi,bhqp->biqp', m_post.float(), a)
    o = torch.einsum('bhqp,bphc->bqhc', a.to(cdt), v)
    out = torch.einsum('bqhc,hcd->bqd', o, wo.to(cdt))
    return x + out if residual else out


# ------------------------------------------------------- kernel wrappers

def _fn(name, pointers, ints, floats=0, lib='th_attention'):
    fn = getattr(_build.library(lib), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                       + [ctypes.c_float] * floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_core(q, k, v, heads):
    """Device, dtype, layout and head geometry the TH core kernels take."""
    for name, t in (('q', q), ('k', k), ('v', v)):
        fa.check_cuda_bf16(name, t, q.device)
    b, l, hd = q.shape
    if not kernel_supported(heads, hd // heads) or hd != heads * HEAD_CH:
        raise ValueError(f'the TH kernels take H in {KERNEL_HEADS} heads of '
                         f'{HEAD_CH}, got H*d={hd} over {heads} heads')
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'q/k/v shapes {tuple(q.shape)}/{tuple(k.shape)}/'
                         f'{tuple(v.shape)} differ')
    if l < 1:
        raise ValueError('the TH kernels need at least one token')


def _mixes(m_pre, m_post, heads, device):
    out = []
    for name, m in (('m_pre', m_pre), ('m_post', m_post)):
        if tuple(m.shape) != (heads, heads):
            raise ValueError(f'{name} has shape {tuple(m.shape)}, expected '
                             f'{(heads, heads)}')
        out.append(m.to(device, torch.float32).contiguous())
    return out


def _mix_bank(m_pre, m_post, heads, device):
    """M_pre, M_pre log2 e (the exponent's pre-mix) and M_post as one
    ``[3, H, H]`` f32 tensor: the TH kernels' constant bank."""
    mpre, mpost = _mixes(m_pre, m_post, heads, device)
    return torch.stack((mpre, mpre * LOG2E, mpost)).contiguous()


def th_core_fwd(q, k, v, m_pre, m_post, heads: int):
    """Port of K6a ``_th_blk_fwd_kernel``: the talking-heads core on ``[B,
    L, H*48]`` bands (q pre-scaled) -> (attn like q, lse ``[B, H, L]`` f32
    of each mixed head). On the card one persistent ``wgmma`` + TMA kernel
    (``th_fwd_plan``) sweeps the keys of 64 query rows twice (the lse of
    each mixed head, then the probabilities, post-mix and PV), so any L is
    taken. bf16 only."""
    if q.device.type == 'cpu':
        return th_core_fwd_plain(q, k, v, m_pre, m_post, heads)
    if q.device.type != 'cuda':
        raise ValueError(f'th_core_fwd runs on cuda or cpu, not {q.device}')
    fa.check_no_grad(q, k, v, m_pre, m_post)
    _check_core(q, k, v, heads)
    b, l, _ = q.shape
    mix = _mix_bank(m_pre, m_post, heads, q.device)
    attn = torch.empty_like(q)
    lse = torch.empty(b, heads, l, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _fn('sav_th_core_fwd', 6, 3)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mix.data_ptr(),
            attn.data_ptr(), lse.data_ptr(), b, l, heads,
            fa.stream_of(q.device))
    _build.check(err, 'th_core_fwd')
    _build.count('th_core_fwd')
    return attn, lse


def th_attention_fwd(x, scale, bias, wq, wk, wv, wo, m_pre, m_post,
                     heads: int, eps: float = LN_EPS, residual: bool = False,
                     save_residuals: bool = False):
    """Port of K5a ``_th_fwd_kernel``: ``W_o @ TalkingHeadsMHA(LN(x))``
    (+x with ``residual``) in one call.

    x ``[B, L, D]``; scale, bias ``[D]``; wq, wk, wv ``[D, H*48]``, wo
    ``[H*48, D]`` in x's dtype; m_pre, m_post ``[H, H]``. On the card four
    launches (``csrc/th_attention.cu``): K1's LN and ``wgmma`` QKV GEMM (q
    scaled by 1/sqrt(48) in its epilogue; ``proj_plan``), K6a's two-sweep
    talking-heads core, K1's out GEMM without or with the residual
    (``fused_fits`` must hold). bf16 only. Returns ``out``; with
    ``save_residuals`` ``(out, (q, k, v, attn, lse))``, the backward's
    residuals (lse ``[B, H, L]`` f32 of each mixed head).
    """
    if x.device.type == 'cpu':
        return th_attention_fwd_plain(x, scale, bias, wq, wk, wv, wo, m_pre,
                                      m_post, heads, eps, residual,
                                      save_residuals)
    if x.device.type != 'cuda':
        raise ValueError(f'th_attention_fwd runs on cuda or cpu, not {x.device}')
    fa.check_no_grad(x, scale, bias, wq, wk, wv, wo, m_pre, m_post)
    b, l, dim = x.shape
    hd = heads * HEAD_CH
    for name, t in (('x', x), ('wq', wq), ('wk', wk), ('wv', wv), ('wo', wo)):
        fa.check_cuda_bf16(name, t, x.device)
    if not kernel_supported(heads, HEAD_CH) or not fused_fits(l, heads, dim):
        raise ValueError(f'th_attention_fwd does not take L={l}, H={heads}, '
                         f'D={dim} (fused_fits; the blocked route does)')
    for name, t, shape in (('wq', wq, (dim, hd)), ('wk', wk, (dim, hd)),
                           ('wv', wv, (dim, hd)), ('wo', wo, (hd, dim))):
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {shape}')
    mix = _mix_bank(m_pre, m_post, heads, x.device)
    scale = scale.to(x.device, torch.float32).contiguous()
    bias = bias.to(x.device, torch.float32).contiguous()
    y = torch.empty(b * l, dim, dtype=x.dtype, device=x.device)
    qkva = [torch.empty(b, l, hd, dtype=x.dtype, device=x.device)
            for _ in range(4)]                    # q, k, v, attn
    lse = (torch.empty(b, heads, l, dtype=torch.float32, device=x.device)
           if save_residuals else None)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _fn('sav_th_attention_fwd', 15, 5, 2)(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), wq.data_ptr(),
            wk.data_ptr(), wv.data_ptr(), wo.data_ptr(), mix.data_ptr(),
            y.data_ptr(), *[t.data_ptr() for t in qkva],
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, l, dim, heads, int(residual), eps, 1.0 / math.sqrt(HEAD_CH),
            fa.stream_of(x.device))
    _build.check(err, 'th_attention_fwd')
    if not save_residuals:
        _build.count('th_attention_fwd')
        return out
    _build.count('th_attention_fwd_train')
    return out, (*qkva, lse)


def _check_bwd(q, k, v, do, lse, heads):
    """What the backward kernels take: q, k, v, do bf16 ``[B, L, H*48]`` on
    one device, H in ``KERNEL_HEADS``, lse contiguous f32 ``[B, H, L]``
    there. Raises ValueError otherwise."""
    _check_core(q, k, v, heads)
    fa.check_cuda_bf16('do', do, q.device)
    b, l, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f'do has shape {tuple(do.shape)}, expected {tuple(q.shape)}')
    if (lse.device != q.device or lse.dtype != torch.float32
            or not lse.is_contiguous() or tuple(lse.shape) != (b, heads, l)):
        raise ValueError(f'lse must be contiguous float32 {(b, heads, l)} on '
                         f'{q.device}, got {lse.dtype} {tuple(lse.shape)} on '
                         f'{lse.device}')


def _core_bwd(q, k, v, do, lse, m_pre, m_post, heads, what):
    """The backward's three launches (``csrc/th_bwd.cu``: DQ with delta, DK
    with the dM_pre partials, DV with the dM_post partials) on CUDA inputs;
    ``what`` names the entry point."""
    fa.check_no_grad(q, k, v, do, lse, m_pre, m_post)
    _check_bwd(q, k, v, do, lse, heads)
    b, l, hd = q.shape
    mix = _mix_bank(m_pre, m_post, heads, q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dm = _dm_partials(b, l, heads, q.device)
    if heads == 16:                     # staged: workspace, no delta
        scratch = torch.empty(th_bwd_staged_plan(b, l)['workspace'],
                              dtype=torch.uint8, device=q.device)
        entry = 'sav_th_core_bwd_staged'
    else:
        scratch = torch.empty_like(lse)   # delta
        entry = 'sav_th_core_bwd'
    with torch.cuda.device(q.device):
        err = _fn(entry, 11, 3, lib='th_bwd')(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), mix.data_ptr(), scratch.data_ptr(),
            dm.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, l,
            heads, fa.stream_of(q.device))
    _build.check(err, what)
    _build.count(what)
    return (dq, dk, dv, *_sum_dm(dm, b, l, heads))


def _dm_partials(b, l, heads, device):
    """The [H, H] partials the backward writes, one a warp of a work tile's
    mixing warpgroup, as ``[2, H*H, B tiles 4]``: DV's dM_post, then DK's
    dM_pre, partial ``tile * 4 + warp`` of entry e at ``[:, e, tile * 4 +
    warp]``, so each entry sums along a contiguous row. At H = 16 one
    partial of each kind a mix block: ``[2, H*H, B ceil(L / 4)]``."""
    n = b * th_bwd_plan(l, heads)['dm_post']
    return torch.empty(2, heads * heads, n, dtype=torch.float32,
                       device=device)


def _sum_dm(dm, b, l, heads):
    """(dM_pre, dM_post) from the partials, each entry's summed in a fixed
    order: deterministic, as the JAX package sums its per-image partials in
    XLA."""
    sums = dm.sum(dim=2).view(2, heads, heads)
    return sums[1], sums[0]


def th_attention_bwd(q, k, v, do, lse, m_pre, m_post, heads: int):
    """Port of K5b ``_th_bwd_kernel``: (dq, dk, dv, dm_pre, dm_post) of the
    TH core from the K5a forward's residuals, ``do`` the cotangent of
    attn (dq is the gradient of the pre-scaled q). On the card three
    launches of ``csrc/th_bwd.cu``, shared with K6b (``th_bwd_plan``): the
    rowsum of dpn * pn under the post-mix is not rowsum(o * do), so DQ
    sweeps the keys of 64 query rows once for it and once for dq; DK and DV
    sweep the queries of 64 key rows for dk (and dM_pre) and dv (and
    dM_post). No float atomics: dM partials are summed afterwards in a fixed
    order. At H = 16 five launches staged through a device workspace
    (``th_bwd_staged_plan``): s and da per head, the mix, dq, dk and dv per
    head. bf16 only; H in ``KERNEL_HEADS`` heads of 48."""
    if q.device.type == 'cpu':
        return th_attention_bwd_plain(q, k, v, do, lse, m_pre, m_post, heads)
    if q.device.type != 'cuda':
        raise ValueError(f'th_attention_bwd runs on cuda or cpu, not {q.device}')
    return _core_bwd(q, k, v, do, lse, m_pre, m_post, heads,
                     'th_attention_bwd')


def th_core_bwd(q, k, v, do, lse, m_pre, m_post, heads: int):
    """Port of K6b ``_th_blk_bwd_kernel`` (K5b's contract on the blocked
    route's residuals): the same three launches as ``th_attention_bwd``."""
    if q.device.type == 'cpu':
        return th_core_bwd_plain(q, k, v, do, lse, m_pre, m_post, heads)
    if q.device.type != 'cuda':
        raise ValueError(f'th_core_bwd runs on cuda or cpu, not {q.device}')
    return _core_bwd(q, k, v, do, lse, m_pre, m_post, heads, 'th_core_bwd')


# ------------------------------------------------------- autograd span

def _forward(x, scale, bias, wq, wk, wv, wo, m_pre, m_post, num_heads,
             route, eps, residual, save_residuals):
    """(out, residuals ``(q, k, v, attn, lse)`` on ``[B, L, H*d]`` or
    None)."""
    b, l, dim = x.shape
    head_d = wq.shape[2]
    hd = num_heads * head_d
    cdt = x.dtype
    if route == 'fused':
        ws = [w.reshape(dim, hd).to(cdt) for w in (wq, wk, wv)]
        ws.append(wo.reshape(hd, dim).to(cdt))
        if save_residuals:
            return th_attention_fwd(x, scale, bias, *ws, m_pre, m_post,
                                    num_heads, eps, residual, True)
        return th_attention_fwd(x, scale, bias, *ws, m_pre, m_post,
                                num_heads, eps, residual), None

    y = _layernorm(x, scale, bias, eps)[0]
    qs, k, v = (t.reshape(b, l, hd).contiguous()
                for t in _project_qkv(y, wq, wk, wv, num_heads, head_d))
    core = th_core_fwd if route == 'blocked' else th_core_fwd_plain
    attn, lse = core(qs, k, v, m_pre, m_post, num_heads)
    out = attn @ wo.reshape(hd, dim).to(cdt)
    if residual:
        out = x + out
    return out, ((qs, k, v, attn, lse) if save_residuals else None)


_BWD = {'fused': th_attention_bwd, 'blocked': th_core_bwd,
        'xla': th_core_bwd_plain}


class _THSublayer(torch.autograd.Function):
    """``_th_sublayer_fwd``/``_th_sublayer_bwd`` of the JAX package."""

    @staticmethod
    def forward(ctx, x, scale, bias, wq, wk, wv, wo, m_pre, m_post,
                num_heads, route, eps, residual):
        out, res = _forward(x, scale, bias, wq, wk, wv, wo, m_pre, m_post,
                            num_heads, route, eps, residual, True)
        ctx.save_for_backward(x, scale, bias, wq, wk, wv, wo, m_pre, m_post,
                              *res)
        ctx.config = (num_heads, route, eps, residual)
        return out

    @staticmethod
    def backward(ctx, g):
        (x, scale, bias, wq, wk, wv, wo, m_pre, m_post,
         qs, k, v, attn, lse) = ctx.saved_tensors
        num_heads, route, eps, residual = ctx.config
        b, l, dim = x.shape
        head_d = wq.shape[2]
        hd = num_heads * head_d
        cdt = x.dtype
        sc = torch.full((), 1.0 / math.sqrt(head_d), dtype=cdt,
                        device=x.device)
        g_c = g.to(cdt)

        d_attn = (g_c @ wo.reshape(hd, dim).to(cdt).t()).contiguous()
        dwo = _wgrad(attn, g_c)
        dqs, dk, dv, dm_pre, dm_post = _BWD[route](
            qs, k, v, d_attn, lse, m_pre, m_post, num_heads)
        dq = dqs * sc                           # undo the q pre-scaling

        y, xhat, inv = _layernorm(x, scale, bias, eps)
        dwq, dwk, dwv = (_wgrad(y, t) for t in (dq, dk, dv))
        w2 = [w.reshape(dim, hd).to(cdt) for w in (wq, wk, wv)]
        dy = dq @ w2[0].t() + dk @ w2[1].t() + dv @ w2[2].t()
        dx_ln, dscale, dbias = _layernorm_bwd(dy, xhat, inv, scale)
        dx = (dx_ln + g.float()).to(cdt) if residual else dx_ln.to(cdt)
        shape_w = (dim, num_heads, head_d)
        return (dx, dscale.to(scale.dtype), dbias.to(bias.dtype),
                dwq.reshape(shape_w).to(wq.dtype),
                dwk.reshape(shape_w).to(wk.dtype),
                dwv.reshape(shape_w).to(wv.dtype),
                dwo.reshape(num_heads, head_d, dim).to(wo.dtype),
                dm_pre.to(m_pre.dtype), dm_post.to(m_post.dtype),
                None, None, None, None)


def th_attention_sublayer(x, scale, bias, wq, wk, wv, wo, m_pre, m_post,
                          num_heads: int, eps: float = LN_EPS,
                          residual: bool = False, route: str = 'fused'):
    """``W_o @ TalkingHeadsMHA(LN(x))`` (+x if ``residual``),
    differentiable in all nine tensors.

    x ``[B, L, D]``; scale, bias ``[D]``; wq/wk/wv ``[D, H, d]``; wo ``[H,
    d, D]``; m_pre/m_post ``[H, H]`` (the checkpoint layout of
    ``AttentionBlock(talking_heads=True)``). ``route`` in ``ROUTES``; the
    model picks it with ``th_route``. A call with grad off runs the
    forward that writes no residuals.
    """
    if route not in ROUTES:
        raise ValueError(f'route must be one of {ROUTES}, got {route!r}')
    args = (x, scale, bias, wq, wk, wv, wo, m_pre, m_post)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _THSublayer.apply(*args, num_heads, route, eps, residual)
    return _forward(*args, num_heads, route, eps, residual, False)[0]


# ------------------------- int8 serving forward (K11): projections in int8

# the JAX package's geometry test of its unrolled TH kernels (lane band and
# the cap on one f32 logit list); copied, not imported
BAND = 64
_MAX_LIST_BYTES = int(3.5 * 1024 * 1024)
SERVING_ONLY = (
    "CaiT quantized='all' runs the talking-heads span on K11, a serving-only "
    'forward with no backward (as in the JAX package); call it under '
    'torch.no_grad() or torch.inference_mode(), and train with '
    "quantized='ff' or 'ff_sb'")


def th_supported(l: int, num_heads: int, head_ch: int) -> bool:
    """The JAX package's ``th_supported``: head_ch <= 64 and one f32 list
    of H lane-padded logit tiles within 3.5 MB. Under ``quantized='all'``
    it decides WHAT is computed, as in the JAX package: the int8 span (K11)
    where it holds, the bf16 span where it does not (CaiT @384). It is not
    a speed threshold and says nothing about the card: the port's K11 takes
    any length (K6a's two sweeps over the keys)."""
    lp = max(-(-l // 16) * 16, 64)
    lanes = -(-l // 128) * 128
    return head_ch <= BAND and num_heads * lp * lanes * 4 <= _MAX_LIST_BYTES


def th_q8_reference(x, scale, bias, wq_q, sq, wk_q, sk, wv_q, sv, wo_q, so,
                    m_pre, m_post, heads: int, eps: float = LN_EPS,
                    residual: bool = False):
    """Plain twin of ``th_attention_q8``, following ``_th_q8_kernel``: LN in
    f32, never rounded to x's dtype, one per-row quantisation of it for q,
    k and v; q = (f32(acc) * (ys * sq)) * (1 / sqrt(d)) and k, v rounded to
    x's dtype; the core of ``th_core_fwd_plain`` (f32 logits and mixes, a
    whole-row softmax p / sum p, the post-mixed probabilities rounded to
    x's dtype for the PV product); the bands in x's dtype quantised per row
    over H*d; f32(aq Wo) * (as * so), + x with ``residual``."""
    b, l, dim = x.shape
    hd = wq_q.shape[1]
    dt = x.dtype
    xf, y = _ln_f32(x.reshape(b * l, dim), scale, bias, eps)
    yq, ys = _quantize_tile(y)

    def proj(w_q, s):
        return int_matmul(yq, w_q).float() * (ys * s)

    q = (proj(wq_q, sq) * (1.0 / (hd // heads) ** 0.5)).to(dt)
    bands = [t.reshape(b, l, hd) for t in
             (q, proj(wk_q, sk).to(dt), proj(wv_q, sv).to(dt))]
    attn, _ = th_core_fwd_plain(*bands, m_pre, m_post, heads)
    aq, a_s = _quantize_tile(attn.reshape(b * l, hd))
    out = int_matmul(aq, wo_q).float() * (a_s * so)
    if residual:
        out = xf + out
    return out.to(dt).reshape(b, l, dim)


def _k11_lib():
    fn = _build.library('th_attention_q8').sav_th_attention_q8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


# K11's projections (csrc/q8_gemm_sm90.cuh): 128 x 64 units, their ring
# slots' depth and count
Q8_ROWS, Q8_TILE, Q8_SLOT_K, Q8_SLOTS = 128, 64, 64, 6
Q8_REGIONS = ('yq', 'ys', 'wqkv', 'wo', 'q', 'k', 'v', 'aq', 'as')


def th_q8_plan(b: int, l: int, dim: int, heads: int) -> dict:
    """Launch plan of K11, mirrored from ``sav_th_q8_plan`` in
    ``csrc/th_attention_q8.cu``: ``tile`` (the column tile of the QKV and
    the OUT GEMMs, 64), ``row_tiles`` (128 rows of B*L), ``units`` of the two GEMMs
    (QKV: each of q, k and v its own column tiles, so none straddles two
    outputs), ``slots`` (64-deep ring slots a unit: over D, over H*48),
    ``smem`` of the two GEMMs (six slots of a 128-row A box and a
    tile-row B box, a 64 x tile bf16 staging tile for each of the two
    consumer warpgroups, OUT's two 128 x tile bf16 tiles of x, mbarriers,
    alignment slack) and of the core
    (``th_fwd_plan``'s and a staging tile of the bands' codes, 64 rows
    H*48 + 16 bytes apart), ``core_tiles`` (64 rows of one image) and the
    workspace the C entry carves: ``scratch`` (name -> (offset, bytes):
    y's codes and scales, the transposed codes of Wq|Wk|Wv [3 H*48, D] and
    of Wo [D, H*48], q, k, v [B*L, H*48] bf16, the bands' codes and
    scales, each at a 256-byte offset) and ``workspace`` (their total).
    Tiles and slots are ceilings: at cait_xs's H*48 = D = 288 each of q, k
    and v takes 5 column tiles (the last 32 columns wide: columns past 288
    are neither scaled nor stored) and each contraction 5 slots (the last
    half zeros, TMA's fill past the codes' width). Raises ValueError where
    the kernels do not take the geometry (H in ``KERNEL_HEADS``, D a
    multiple of 32 of at least 64: int8 rows 16-byte aligned for TMA)."""
    if b < 1 or l < 1 or dim < 64 or dim % 32 or heads not in KERNEL_HEADS:
        raise ValueError(f'th_attention_q8 takes H in {KERNEL_HEADS} heads of '
                         f'{HEAD_CH} and D a multiple of 32 (at least 64), got '
                         f'B={b}, L={l}, D={dim}, H={heads} ({UNBUILT})')
    m, hd = b * l, heads * HEAD_CH
    cdiv = lambda x, y: -(-x // y)
    tile = {'qkv': Q8_TILE, 'out': Q8_TILE}
    rows = cdiv(m, Q8_ROWS)

    def smem(t, out):
        # OUT: and two 128-row x tiles, and their four mbarriers
        return (Q8_SLOTS * (Q8_ROWS + t) * Q8_SLOT_K + 2 * 64 * t * 2
                + (2 * Q8_ROWS * t * 2 + 4 * 8 if out else 0)
                + 2 * Q8_SLOTS * 8 + 1024)

    # the core's, with the codes' staging rows (H*48 + 16 bytes apart)
    # after its mbarriers, or at H = 16 over its resident q
    core = th_fwd_plan(l, heads)['smem']
    if heads <= 8:
        core = cdiv(core - 1024, 16) * 16 + 64 * (hd + 16) + 1024
    regions, at = {}, 0
    for name, nbytes in zip(Q8_REGIONS, (m * dim, 4 * m, 3 * hd * dim,
                                         dim * hd, 2 * m * hd, 2 * m * hd,
                                         2 * m * hd, m * hd, 4 * m)):
        regions[name] = (at, nbytes)
        at += cdiv(nbytes, 256) * 256
    return dict(tile=tile, row_tiles=rows,
                units={'qkv': rows * 3 * cdiv(hd, tile['qkv']),
                       'out': rows * cdiv(dim, tile['out'])},
                slots={'qkv': cdiv(dim, Q8_SLOT_K), 'out': cdiv(hd, Q8_SLOT_K)},
                smem={'qkv': smem(tile['qkv'], False),
                      'out': smem(tile['out'], True),
                      'core': core},
                core_tiles=b * cdiv(l, 64), scratch=regions, workspace=at)


def _th_q8_into(x, scale, bias, codes, scales, m_pre, m_post, heads, eps,
                residual, out):
    """K11's five launches on checked operands, writing ``out`` (``[B, L,
    D]``, or the first B*L rows of a longer ``[*, D]`` buffer)."""
    b, l, dim = x.shape
    dev = x.device
    vec = lambda t, n: t.reshape(n).to(dev, torch.float32).contiguous()
    hd = heads * HEAD_CH
    ws = torch.empty(th_q8_plan(b, l, dim, heads)['workspace'],
                     dtype=torch.uint8, device=dev)
    # every buffer is held by a name until the launches are queued; the
    # kernels transpose the weight codes into the workspace
    bufs = [x, vec(scale, dim), vec(bias, dim),
            *[w.contiguous() for w in codes],
            *[vec(s, n) for s, n in zip(scales, (hd, hd, hd, dim))],
            _mix_bank(m_pre, m_post, heads, dev), ws, out]
    with torch.cuda.device(dev):
        err = _k11_lib()(*[t.data_ptr() for t in bufs], b, l, dim, heads,
                         int(residual), eps, 1.0 / HEAD_CH ** 0.5,
                         fa.stream_of(dev))
    _build.check(err, 'th_attention_q8')


def th_attention_q8(x, scale, bias, wq_q, sq, wk_q, sk, wv_q, sv, wo_q, so,
                    m_pre, m_post, heads: int, eps: float = LN_EPS,
                    residual: bool = False):
    """Port of K11: ``W_o @ TalkingHeadsMHA(LN(x))`` (+x with
    ``residual``) with int8 projections, serving only (raises under
    autograd).

    x ``[B, L, D]``; wq_q, wk_q, wv_q ``[D, H*48]`` and wo_q ``[H*48, D]``
    int8 codes with per-column f32 scales ``[1, H*48]`` / ``[1, D]``;
    m_pre, m_post ``[H, H]``. On a CUDA tensor: five launches
    (``csrc/th_attention_q8.cu``: the codes transposed in the workspace,
    LN(x)'s codes, the QKV and OUT GEMMs on s8 ``wgmma`` + TMA around K6a's
    core taking the bands' codes), bf16 x, H in ``KERNEL_HEADS``, D a
    multiple of 32 (at least 64), any L. On a CPU tensor: the plain twin.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias, m_pre, m_post)):
        raise RuntimeError(SERVING_ONLY)
    if x.device.type == 'cpu':
        return th_q8_reference(x, scale, bias, wq_q, sq, wk_q, sk, wv_q, sv,
                               wo_q, so, m_pre, m_post, heads, eps, residual)
    if x.device.type != 'cuda':
        raise ValueError(f'th_attention_q8 runs on cuda or cpu, not {x.device}')
    fa.check_cuda_bf16('x', x, x.device)
    b, l, dim = x.shape
    hd = heads * HEAD_CH
    if (not kernel_supported(heads, wq_q.shape[1] // heads) or dim % 32
            or dim < 64):
        raise ValueError(f'th_attention_q8 takes H in {KERNEL_HEADS} heads of '
                         f'{HEAD_CH} and D a multiple of 32 (at least 64), got '
                         f'H*d={wq_q.shape[1]} over {heads} heads, D={dim}')
    for name, t, shape in (('wq_q', wq_q, (dim, hd)), ('wk_q', wk_q, (dim, hd)),
                           ('wv_q', wv_q, (dim, hd)), ('wo_q', wo_q, (hd, dim))):
        if t.dtype != torch.int8 or tuple(t.shape) != shape:
            raise ValueError(f'{name} must be int8 {shape}, got {t.dtype} '
                             f'{tuple(t.shape)}')
    out = torch.empty_like(x)
    _th_q8_into(x, scale, bias, (wq_q, wk_q, wv_q, wo_q), (sq, sk, sv, so),
                m_pre, m_post, heads, eps, residual, out)
    _build.count('th_attention_q8')
    return out


def th_attention_sublayer_q8(x, scale, bias, wq, wk, wv, wo, m_pre, m_post,
                             num_heads: int, eps: float = LN_EPS,
                             residual: bool = False, route: str = 'fused',
                             core: str = 'kernel'):
    """Serving-only ``W_o @ TalkingHeadsMHA(LN(x))`` (+x if ``residual``)
    with int8 projections: the JAX package's ``th_attention_sublayer_q8``.

    Same parameters as ``th_attention_sublayer``. Where ``th_supported``
    holds: K11 (``th_attention_q8``; the twin on a CPU tensor, or on any
    device with ``core='plain'`` or the plain ``route='xla'``). Where it
    does not: the bf16 span on ``route``, as the JAX package falls back to
    its bf16 span. Raises under autograd on either route.
    """
    if core not in ('kernel', 'plain'):
        raise ValueError(f"core must be 'kernel' or 'plain', got {core!r}")
    if torch.is_grad_enabled() and any(
            t.requires_grad
            for t in (x, scale, bias, wq, wk, wv, wo, m_pre, m_post)):
        raise RuntimeError(SERVING_ONLY)
    b, l, dim = x.shape
    head_d = wq.shape[2]
    if not th_supported(l, num_heads, head_d):
        return th_attention_sublayer(x, scale, bias, wq, wk, wv, wo, m_pre,
                                     m_post, num_heads, eps, residual, route)
    codes = _q8_weights(wq, wk, wv, wo, dim, num_heads * head_d)
    fwd = (th_attention_q8 if core == 'kernel' and route != 'xla'
           else th_q8_reference)
    return fwd(x, scale, bias, *[t for pair in codes for t in pair], m_pre,
               m_post, num_heads, eps, residual)
