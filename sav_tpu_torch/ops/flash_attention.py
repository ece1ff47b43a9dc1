"""Flash attention on the head-band layout (counterpart of
``sav_tpu/ops/flash_attention.py``).

``flash_fwd`` is the port of the K4 kernel ``_fwd_kernel``
(``csrc/flash_fwd.cu`` on the Hopper kernel of ``csrc/flash_fwd_sm90.cuh``:
wgmma fed by TMA, persistent, launch plan in ``fwd_plan``): q, k, v as
``[B, L, H*d]`` (a free view of the projection output, q pre-scaled), out
in the same layout, lse ``[B, H, Lq]`` f32. ``flash_bwd`` is the port of the backward: K2
``_fused_bwd_kernel`` (one launch for dq, dk, dv, ``csrc/flash_bwd.cu``, a
whole head in shared memory, plan in ``fused_bwd_plan``) where
``fused_bwd_fits`` (up to 208 rows), else K3 ``_dq_kernel`` + ``_dkv_kernel``
(``csrc/flash_bwd_split.cu``, plan in ``split_plan``); all three on wgmma
and TMA. On a CUDA tensor each launches its hand-written kernel or raises;
on a CPU tensor it runs its plain twin. No padding is needed: the kernels
mask the ragged query and key tails themselves. ``mha`` (K4 forward +
kernel backward) and ``mha_hybrid`` (plain forward + kernel backward) are
the differentiable ``[B, L, heads, d]`` entry points.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sav_tpu_torch import _build

BAND = 64               # the kernels' head width
SMEM_LIMIT = 232448     # dynamic shared memory one H100 block may use
THREADS = 384           # two consumer warpgroups and a producer warpgroup
TILE_ROWS = 64          # rows of a TMA tile, the wgmma M and N
# K4's launch plan (csrc/flash_fwd_sm90.cuh, k4::)
FWD_BLOCK_ROWS = 128    # query rows of a work tile: two warpgroups of 64
FWD_STAGES = 4          # ring slots of the K/V tiles
# K2's (csrc/flash_bwd.cu, k2::): a whole head of up to 208 rows resident
K2_MAX_ROWS = 208
K2_STAT_ROWS = 256      # lse and delta slots: four 64-query chunks
# K3's launch plan (csrc/flash_bwd_split.cu, k3::)
SPLIT_BLOCK_ROWS = 128  # rows of a work tile: two consumer warpgroups of 64
SPLIT_STAGES = 3        # ring slots of the streamed tiles


def _ceil(n: int, m: int) -> int:
    return -(-n // m)


def wide_tiles(rows: int) -> int:
    """Tiles of ``rows`` rows run 64 wide, a last tile of 1-16 rows 16 wide
    (``flash::wide_tiles``): the count of 64-wide tiles."""
    rem = rows % TILE_ROWS
    if rem == 0 or rem > 16:
        return _ceil(rows, TILE_ROWS)
    return rows // TILE_ROWS


def cover_rows(rows: int) -> int:
    """Rows those tiles cover (``flash::cover_rows``)."""
    wide = wide_tiles(rows) * TILE_ROWS
    return wide + (16 if wide < rows else 0)


def _check_lengths(batch, q_len, kv_rows, kv_len, heads):
    if min(batch, q_len, kv_rows, heads) < 1:
        raise ValueError(f'empty attention: batch {batch}, q_len {q_len}, '
                         f'kv_rows {kv_rows}, heads {heads}')
    if not 1 <= kv_len <= kv_rows:
        raise ValueError(f'kv_len {kv_len} outside [1, {kv_rows}]')


def fwd_plan(batch: int, q_len: int, kv_rows: int, kv_len: int,
             heads: int) -> dict:
    """K4's launch plan, mirroring ``csrc/flash_fwd_sm90.cuh``: a persistent
    kernel (one block per SM, or one per work tile if fewer) walking
    ``work`` = (query tiles, heads, batch) work tiles of ``rows`` query
    rows; each streams ``steps`` key/value tiles (``wide`` of them 64 rows,
    the rest one of 16) through a ring of ``stages`` slots; ``smem`` is the
    dynamic shared memory (the kernel's struct plus 1024 bytes to align the
    swizzled tiles). Raises ValueError on lengths the kernel does not
    take."""
    _check_lengths(batch, q_len, kv_rows, kv_len, heads)
    work = (_ceil(q_len, FWD_BLOCK_ROWS), heads, batch)
    if math.prod(work) >= 2 ** 31:
        raise ValueError(f'{math.prod(work)} work tiles overflow the '
                         f'kernel\'s int tile index')
    tile = TILE_ROWS * BAND * 2
    q_slots = 2 * (FWD_BLOCK_ROWS // TILE_ROWS) * tile
    ring = 2 * FWD_STAGES * tile                # K and V per slot
    barriers = (4 + 2 * FWD_STAGES) * 8
    return dict(work=work, rows=FWD_BLOCK_ROWS,
                steps=_ceil(kv_len, TILE_ROWS), wide=wide_tiles(kv_len),
                stages=FWD_STAGES, threads=THREADS, tile_rows=TILE_ROWS,
                smem=q_slots + ring + barriers + 1024)


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
    """A raw forward kernel has no autograd formula of its own; its
    differentiable callers (``mha``, ``fused_layer.attention_sublayer``)
    call it inside their ``autograd.Function``, where grad is off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            'this raw CUDA kernel is forward-only; differentiate through '
            'mha/mha_hybrid or fused_layer.attention_sublayer')


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
    q, lse ``[B, H, Lq]`` float32. K4 (``fwd_kernel``) on the card, the
    plain twin on the CPU.
    """
    if q.device.type == 'cpu':
        return flash_fwd_plain(q, k, v, heads, kv_len)
    if q.device.type != 'cuda':
        raise ValueError(f'flash_fwd runs on cuda or cpu, not {q.device}')
    return fwd_kernel(q, k, v, heads, kv_len)


def fwd_kernel(q, k, v, heads: int, kv_len: int):
    """K4's launch. Raises ValueError, before anything is launched, on what
    the kernel does not take: bf16 ``[B, L, H*64]`` head bands, contiguous
    and 16-byte aligned, k like v, lengths ``fwd_plan`` takes, all on one
    card."""
    check_no_grad(q, k, v)
    for name, t in (('q', q), ('k', k), ('v', v)):
        check_cuda_bf16(name, t, q.device)
    b, q_len, hd = q.shape
    if hd != heads * BAND:
        raise ValueError(f'flash_fwd needs head_dim {BAND}, got {hd}/{heads}')
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != hd:
        raise ValueError(f'k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do '
                         f'not match q {tuple(q.shape)}')
    fwd_plan(b, q_len, k.shape[1], kv_len, heads)
    if q.device.type != 'cuda':
        raise ValueError(f'K4 runs on the card, got {q.device} tensors '
                         f'(flash_fwd runs the plain twin on the CPU)')
    out = torch.empty_like(q)
    lse = torch.empty(b, heads, q_len, dtype=torch.float32, device=q.device)
    fn = _lib()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, q_len, k.shape[1], kv_len, heads,
                 stream_of(q.device))
    _build.check(err, 'flash_fwd')
    _build.count('flash_fwd')
    return out, lse


def flash_bwd_plain(q, k, v, out, lse, do, heads: int, kv_len: int):
    """Plain twin of ``flash_bwd``, rounding where the TPU kernels round:
    p = exp(s - lse) and delta = rowsum(o * do) in f32 (from o, do in
    their dtype); p rounded to do's dtype before p^T do; ds = p * (dp -
    delta) rounded to q's dtype before ds k and ds^T q; f32 accumulation.
    Key rows at or past ``kv_len`` get zero dk and dv."""
    b, q_len, hd = q.shape
    kv_rows = k.shape[1]
    d = hd // heads
    q4 = q.reshape(b, q_len, heads, d).float()
    k4 = k[:, :kv_len].reshape(b, kv_len, heads, d).float()
    v4 = v[:, :kv_len].reshape(b, kv_len, heads, d).float()
    do4 = do.reshape(b, q_len, heads, d)
    s = torch.einsum('bqhd,bkhd->bhqk', q4, k4)
    p = torch.exp(s - lse[..., None])
    delta = (out.float() * do.float()).reshape(b, q_len, heads, d).sum(-1)
    dv = torch.einsum('bhqk,bqhd->bkhd', p.to(do.dtype).float(), do4.float())
    dp = torch.einsum('bqhd,bkhd->bhqk', do4.float(), v4)
    ds = (p * (dp - delta.transpose(1, 2)[..., None])).to(q.dtype).float()
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, k4)
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, q4)

    def rows(a, like):
        a = a.reshape(b, kv_len, hd).to(like.dtype)
        if kv_rows == kv_len:
            return a
        return torch.cat([a, a.new_zeros(b, kv_rows - kv_len, hd)], dim=1)

    return dq.reshape(b, q_len, hd).to(q.dtype), rows(dk, k), rows(dv, v)


def fused_bwd_plan(batch: int, q_len: int, kv_rows: int, kv_len: int,
                   heads: int) -> dict:
    """K2's launch plan, mirroring ``csrc/flash_bwd.cu``: a persistent
    kernel walking the ``items`` (head, image) pairs, each with its whole
    head resident. Phase A runs ``key_tiles`` 64-row key tiles against
    ``q_wide`` 64-wide query chunks and a 16-wide last one if ``q_chunks``
    is larger; phase B forms dq over ``q_chunks`` chunks in 16-key steps
    up to ``ds_rows``. Q and dO load ``q_cover`` rows, K and V ``kv_cover``;
    ``smem`` is fixed: four resident bands and ds^T as four 64-query column
    tiles (the last holds o until delta is formed), each over 208 rows, lse
    and delta, the barriers, and 1024 bytes of alignment slack. Raises
    ValueError on lengths the kernel does not take (past 208 rows: K3's)."""
    _check_lengths(batch, q_len, kv_rows, kv_len, heads)
    if not fused_bwd_fits(q_len, kv_rows):
        raise ValueError(f'K2 holds at most {K2_MAX_ROWS} rows a head, got '
                         f'q_len {q_len}, kv_rows {kv_rows}')
    band = K2_MAX_ROWS * BAND * 2
    smem = 8 * band + 2 * K2_STAT_ROWS * 4 + 4 * 8 + 1024
    return dict(items=heads * batch, q_wide=wide_tiles(q_len),
                q_chunks=_ceil(q_len, TILE_ROWS),
                key_tiles=_ceil(kv_rows, TILE_ROWS),
                ds_rows=_ceil(kv_len, 16) * 16, q_cover=cover_rows(q_len),
                kv_cover=cover_rows(kv_rows), threads=THREADS, smem=smem)


# flash_bwd's route: K2 wherever it holds the head, K3 past it. Measured
# in one call of chip_smoke.py (H100 80GB HBM3, 700 W; B=192, H=12): K2
# 0.3361 ms against the K3 pair's 0.3865 at L = 197, and K2 0.3309
# against 0.3718 at 200 rows over 190 keys, so no shorter threshold.
def fused_bwd_fits(q_len: int, kv_rows: int) -> bool:
    """Whether ``flash_bwd`` runs K2 (else K3) at these lengths: one block
    holds a whole head of up to ``K2_MAX_ROWS`` = 208 query and key rows
    (ViT @224, L = 197) with its ds^T in shared memory
    (``fused_bwd_plan``); from 209 on only K3 does."""
    return max(q_len, kv_rows) <= K2_MAX_ROWS


def _check_bwd(q, k, v, lse, do, heads: int, kv_len: int, out=None,
               delta=None):
    """Raises ValueError on what the backward kernels do not take: bf16
    ``[B, L, H*64]`` head bands, contiguous and 16-byte aligned, k like v,
    out and do shaped as q; lse (and K3b's delta) contiguous f32 ``[B, H,
    Lq]``; 1 <= kv_len <= kv_rows; all on q's device."""
    bands = [('q', q), ('k', k), ('v', v), ('do', do)]
    for name, t in bands + ([('out', out)] if out is not None else []):
        check_cuda_bf16(name, t, q.device)
    b, q_len, hd = q.shape
    kv_rows = k.shape[1]
    if hd != heads * BAND:
        raise ValueError(f'flash_bwd needs head_dim {BAND}, got {hd}/{heads}')
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != hd:
        raise ValueError(f'k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do '
                         f'not match q {tuple(q.shape)}')
    if do.shape != q.shape or (out is not None and out.shape != q.shape):
        raise ValueError(f'out/do shapes must equal q {tuple(q.shape)}, got '
                         f'{tuple(do.shape)}')
    for name, t in [('lse', lse)] + ([('delta', delta)]
                                     if delta is not None else []):
        if (t.device != q.device or t.dtype != torch.float32
                or not t.is_contiguous()
                or tuple(t.shape) != (b, heads, q_len)):
            raise ValueError(f'{name} must be contiguous float32 '
                             f'{(b, heads, q_len)} on {q.device}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')
    if not 1 <= kv_len <= kv_rows:
        raise ValueError(f'kv_len {kv_len} outside [1, {kv_rows}]')


def split_plan(batch: int, q_len: int, kv_rows: int, kv_len: int,
               heads: int) -> dict:
    """K3's launch plan, mirroring ``csrc/flash_bwd_split.cu``. Each kernel
    is persistent (one block per SM, or one per work tile if fewer) and
    walks work tiles of ``rows`` rows of one (head, image): ``work`` is
    their count along (rows, heads, batch), ``steps`` the 64-row tiles its
    producer streams per work tile, ``smem`` the dynamic shared memory (the
    kernel's struct plus 1024 bytes to align the swizzled tiles). K3a
    (``'dq'``) owns query rows and streams keys, K3b (``'dkv'``) the
    reverse. Raises ValueError on lengths the kernels do not take."""
    _check_lengths(batch, q_len, kv_rows, kv_len, heads)
    rows, tile_rows = SPLIT_BLOCK_ROWS, TILE_ROWS
    work_dq = (_ceil(q_len, rows), heads, batch)
    work_dkv = (_ceil(kv_rows, rows), heads, batch)
    if max(math.prod(work_dq), math.prod(work_dkv)) >= 2 ** 31:
        raise ValueError(f'{math.prod(work_dq)} work tiles overflow the '
                         f'kernels\' int tile index')
    tile = tile_rows * BAND * 2
    slots = 2 * (rows // tile_rows) * tile      # both slots of one tensor
    ring = 2 * SPLIT_STAGES * tile              # two tensors per ring slot
    barriers = (4 + 2 * SPLIT_STAGES) * 8
    # K3a: q, do, o resident; the K/V ring; delta of the block's rows
    dq_smem = 3 * slots + ring + rows * 4 + barriers + 1024
    # K3b: k, v resident; the Q/dO ring with each tile's lse and delta
    dkv_smem = (2 * slots + ring + 2 * SPLIT_STAGES * tile_rows * 4
                + barriers + 1024)
    return {
        'dq': dict(work=work_dq, rows=rows, steps=_ceil(kv_len, tile_rows),
                   smem=dq_smem),
        'dkv': dict(work=work_dkv, rows=rows, steps=_ceil(q_len, tile_rows),
                    smem=dkv_smem),
        'tile_rows': tile_rows, 'stages': SPLIT_STAGES,
        'threads': THREADS}


def _launch_checks(plan, name, q, k, v, lse, do, heads, kv_len, out=None,
                   delta=None):
    """The checks of a K2 or K3 launch: ``_check_bwd``, the kernel's plan,
    and the card."""
    _check_bwd(q, k, v, lse, do, heads, kv_len, out=out, delta=delta)
    plan(q.shape[0], q.shape[1], k.shape[1], kv_len, heads)
    if q.device.type != 'cuda':
        raise ValueError(f'{name} runs on the card, got {q.device} tensors '
                         f'(flash_bwd runs the plain twin on the CPU)')


def _bwd_fn(name):
    lib = 'flash_bwd' if name == 'sav_flash_bwd_fused' else 'flash_bwd_split'
    fn = getattr(_build.library(lib), name)
    if fn.argtypes is None:
        pointers = {'sav_flash_bwd_fused': 9, 'sav_flash_bwd_dq': 8,
                    'sav_flash_bwd_dkv': 8}[name]
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_bwd(q, k, v, out, lse, do, heads: int, kv_len: int):
    """Gradients (dq, dk, dv) of ``flash_fwd`` on the ``[B, L, H*d]`` layout
    (q pre-scaled, so dq is the gradient of the pre-scaled q): ``out`` and
    ``lse`` are the forward's, ``do`` the cotangent of ``out``. Keys at or
    past ``kv_len`` are masked; their dk and dv rows are zero.

    On the card: K2 (``bwd_fused``, one launch) where ``fused_bwd_fits``,
    else K3 (``bwd_split``: K3a then K3b). bf16 only, d = 64.
    """
    if q.device.type == 'cpu':
        return flash_bwd_plain(q, k, v, out, lse, do, heads, kv_len)
    if q.device.type != 'cuda':
        raise ValueError(f'flash_bwd runs on cuda or cpu, not {q.device}')
    route = bwd_fused if fused_bwd_fits(q.shape[1], k.shape[1]) else bwd_split
    return route(q, k, v, out, lse, do, heads, kv_len)


# The kernel launches behind flash_bwd (chip_smoke.py calls both routes
# directly to time them at one shape); each checks its own inputs and
# raises off the card or on lengths its kernel does not take.

def _dims(q, k, heads, kv_len):
    return (q.shape[0], q.shape[1], k.shape[1], kv_len, heads,
            stream_of(q.device))


def bwd_fused(q, k, v, out, lse, do, heads: int, kv_len: int):
    """K2: (dq, dk, dv) in one launch."""
    _launch_checks(fused_bwd_plan, 'K2', q, k, v, lse, do, heads, kv_len,
                   out=out)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _bwd_fn('sav_flash_bwd_fused')(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *_dims(q, k, heads, kv_len))
    _build.check(err, 'flash_bwd_fused')
    _build.count('flash_bwd_fused')
    return dq, dk, dv


def bwd_dq(q, k, v, out, lse, do, heads: int, kv_len: int):
    """K3a: (dq, delta), delta = rowsum(out * do) ``[B, H, Lq]`` f32."""
    _launch_checks(split_plan, 'K3', q, k, v, lse, do, heads, kv_len,
                   out=out)
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    with torch.cuda.device(q.device):
        err = _bwd_fn('sav_flash_bwd_dq')(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_dims(q, k, heads, kv_len))
    _build.check(err, 'flash_bwd_dq')
    _build.count('flash_bwd_dq')
    return dq, delta


def bwd_dkv(q, k, v, do, lse, delta, heads: int, kv_len: int):
    """K3b: (dk, dv) from K3a's delta."""
    _launch_checks(split_plan, 'K3', q, k, v, lse, do, heads, kv_len,
                   delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _bwd_fn('sav_flash_bwd_dkv')(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_dims(q, k, heads, kv_len))
    _build.check(err, 'flash_bwd_dkv')
    _build.count('flash_bwd_dkv')
    return dk, dv


def bwd_split(q, k, v, out, lse, do, heads: int, kv_len: int):
    """K3: (dq, dk, dv) from K3a then K3b."""
    dq, delta = bwd_dq(q, k, v, out, lse, do, heads, kv_len)
    return (dq, *bwd_dkv(q, k, v, do, lse, delta, heads, kv_len))


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


def _bands(*tensors):
    """[B, L, H, d] -> contiguous [B, L, H*d] head bands."""
    return [t.reshape(t.shape[0], t.shape[1], -1).contiguous() for t in tensors]


def attention_plain(qs, k, v):
    """Plain attention on ``[B, L, H, d]`` (q pre-scaled) -> (out ``[B, Lq,
    H, d]``, lse ``[B, H, Lq]`` f32): f32 logits, probabilities rounded to
    v's dtype before the value product. The forward of ``mha_hybrid`` and
    of the sublayer's ``'xla'`` core."""
    logits = torch.einsum('bqhd,bkhd->bhqk', qs.float(), k.float())
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None]).to(v.dtype)
    return torch.einsum('bhqk,bkhd->bqhd', p, v), lse


# what ``mha`` runs: the kernels (K4 forward, K2/K3 backward; the twins on
# a CPU tensor) or their plain twins on any device
CORES = ('kernel', 'plain')


class _MHA(torch.autograd.Function):
    """Attention on [B, L, heads, d] with the flash residuals (q, k, v, out,
    lse; no [B, H, Lq, Lkv] tensor) and the kernel backward. ``hybrid``
    picks the plain forward instead of K4 (``_hybrid`` in the JAX package);
    ``core='plain'`` runs K4's and the backward's twins at the same
    boundary."""

    @staticmethod
    def forward(ctx, query, key, value, hybrid, core):
        b, q_len, heads, d = query.shape
        q, k, v = _bands(query, key, value)
        if hybrid:
            out, lse = attention_plain(query, key, value)
            out = _bands(out)[0]
        else:
            fwd = flash_fwd if core == 'kernel' else flash_fwd_plain
            out, lse = fwd(q, k, v, heads, k.shape[1])
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads, ctx.core = heads, core
        return out.reshape(b, q_len, heads, d)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_bwd if ctx.core == 'kernel' else flash_bwd_plain
        dq, dk, dv = bwd(q, k, v, out, lse, *_bands(dout), ctx.heads,
                         k.shape[1])
        shape = lambda a: a.reshape(a.shape[0], a.shape[1], ctx.heads, -1)
        return shape(dq), shape(dk), shape(dv), None, None


def mha(query, key, value, core: str = 'kernel'):
    """Flash attention on ``[B, L, heads, d]`` (query pre-scaled), returning
    ``[B, Lq, heads, d]`` like ``sav_tpu_torch.ops.attention``'s plain path;
    forward on K4, backward on K2/K3. ``core='plain'`` runs the same
    Function on their twins, on any device (the card's gradient reference
    for the kernels at this boundary)."""
    if core not in CORES:
        raise ValueError(f'core must be one of {CORES}, got {core!r}')
    return _MHA.apply(query, key, value, False, core)


def mha_hybrid(query, key, value):
    """As ``mha`` with the plain forward and the kernel backward."""
    return _MHA.apply(query, key, value, True, 'kernel')
