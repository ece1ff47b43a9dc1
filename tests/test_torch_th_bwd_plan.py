"""Torch port: the talking-heads backward's launch plan and algebra on the
CPU (``csrc/th_bwd.cu``, K5b and K6b; the kernels themselves run only on
the card, ``tests/test_torch_cuda.py``).

* ``th_bwd_plan``, the Python mirror of the kernels' ``Plan``: each of the
  three kernels fits a block's 232,448 bytes of shared memory, its work
  tiles and streamed tiles cover every row, and the dM partials it counts
  are the ones ``_core_bwd`` allocates and sums. At H = 16 (the staged
  backward of ``csrc/th_bwd_staged.cuh``) the same for its products, mix
  and GEMM launches, and ``th_bwd_staged_plan``'s workspace regions lie
  apart and hold S, DA, DS and PT.
* The wrappers' checks raise ValueError (never assert) on what the kernels
  do not take.
* ``kernel_algebra``, a test-only torch mirror of the kernels' arithmetic:
  64-row work tiles against 16-row streamed tiles, pn = 2^(s M_pre log2 e -
  lse log2 e), delta summed tile by tile in DQ's first sweep, ds and
  pt rounded to bf16 before their products, keys past L zeroed after the
  pre-mix. Held against ``th_core_bwd_plain`` (dq, dk, dv within 2^-8 of
  max: both are bf16, and the same f32 sums taken in another order may
  round an output to the neighbouring bf16 value, one step of 2^-8 at the
  largest magnitude; dM_pre, dM_post within 1e-5 of max: f32 sums in
  another order), and at one ragged shape against the JAX package's
  ``_th_blk_bwd_kernel`` (K6b) in Pallas interpret mode, at the same
  bounds.
* ``staged_algebra``, the staged backward's arithmetic at H = 16: s and da
  per head, delta summed over each query row's keys, ds and pt rounded to
  bf16, dq, dk and dv as 64-deep steps over the length, dM as one partial
  a block of 4 query rows summed in block order. Held against
  ``th_core_bwd_plain`` at the same bounds (the JAX kernel at 16 heads is
  held against the twin through the span, ``test_torch_cait_m.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import th_attention as jax_th
from sav_tpu_torch.ops import th_attention as th

import torch_parity  # noqa: F401  (pins torch to one thread)

SMEM_LIMIT = 232448
GRAD_TOL = 2.0 ** -8
DM_TOL = 1e-5
LENGTHS = (1, 17, 196, 197, 576, 577)


@pytest.mark.parametrize('heads', th.KERNEL_HEADS)
@pytest.mark.parametrize('l', LENGTHS)
def test_plan_fits_a_block(l, heads):
    plan = th.th_bwd_plan(l, heads)
    launches = {'dq', 'dk', 'dv'}
    if plan['design'] == 'staged':
        launches |= {'products', 'mix'}
    assert plan['design'] == ('staged' if heads == 16 else 'fused')
    assert set(plan['smem']) == launches
    for mode, nbytes in plan['smem'].items():
        assert 0 < nbytes <= SMEM_LIMIT, (mode, nbytes)


@pytest.mark.parametrize('heads', th.KERNEL_HEADS)
@pytest.mark.parametrize('l', LENGTHS)
def test_plan_covers_every_row(l, heads):
    """Work tiles of 64 resident rows and streamed tiles of 16 rows reach
    past the last row and start before it: no row is dropped, no tile is
    wholly padding."""
    plan = th.th_bwd_plan(l, heads)
    rows, cols = plan['rows'], plan['cols']
    assert (plan['tiles'] - 1) * rows < l <= plan['tiles'] * rows
    per_sweep = plan['steps']['dk']
    assert (per_sweep - 1) * cols < l <= per_sweep * cols
    if plan['design'] == 'staged':
        # each GEMM steps 64 rows of depth over the length; the mix takes
        # mix_rows query rows a block
        assert plan['steps'] == {'dq': per_sweep, 'dk': per_sweep,
                                 'dv': per_sweep}
        per = plan['dm_post']
        assert (per - 1) * plan['mix_rows'] < l <= per * plan['mix_rows']
        return
    assert plan['steps'] == {'dq': 2 * per_sweep, 'dk': per_sweep,
                             'dv': per_sweep}


@pytest.mark.parametrize('b,l,heads', [(1, 1, 4), (3, 197, 8), (2, 577, 8),
                                       (2, 197, 16), (1, 1, 16)])
def test_dm_partials_match_the_allocation(b, l, heads):
    """The kernels write the partial of (work tile, warp) of entry e at
    [0, e, tile * 4 + warp] (DV, dM_post) and [1, e, tile * 4 + warp] (DK,
    dM_pre), or at H = 16 the partial of mix block n at [0, e, n] and [1,
    e, n]: the buffer ``_core_bwd`` allocates holds every one of them once,
    and ``_sum_dm`` sums each kind into its own [H, H]."""
    plan = th.th_bwd_plan(l, heads)
    tiles = b * plan['tiles']
    dm = th._dm_partials(b, l, heads, 'cpu')
    assert dm.numel() == b * plan['dm_partials'] * heads * heads
    if plan['design'] == 'staged':
        per = b * -(-l // plan['mix_rows'])        # mix blocks
        assert plan['dm_post'] == plan['dm_pre'] == per // b
        assert per == th.th_bwd_staged_plan(b, l)['blocks']['mix']
        writes = [(kind, n) for kind in range(2) for n in range(per)]
    else:
        per = tiles * 4
        assert plan['dm_post'] == plan['dm_pre'] == 4 * plan['tiles']
        writes = [(kind, tile * 4 + w) for kind in range(2)
                  for tile in range(tiles) for w in range(4)]
    assert dm.shape == (2, heads * heads, per)
    written = torch.zeros_like(dm)
    for kind, n in writes:
        written[kind, :, n] += 1
    assert torch.equal(written, torch.ones_like(dm))
    dm[0] = 1.0
    dm[1] = torch.arange(heads * heads, dtype=torch.float32)[:, None]
    dm_pre, dm_post = th._sum_dm(dm, b, l, heads)
    assert torch.equal(dm_post, torch.full((heads, heads), float(per)))
    assert torch.equal(dm_pre, per * torch.arange(
        heads * heads, dtype=torch.float32).view(heads, heads))


@pytest.mark.parametrize('b,l', [(1, 1), (2, 197), (16, 196), (1, 577)])
def test_staged_workspace_regions(b, l):
    """``th_bwd_staged_plan`` (mirror of ``sav_th_bwd_staged_plan``): S
    and DA f32 [B, 16, L, L], DS and PT bf16 [B, 16, L, lp] with lp = L
    rounded up to 8 (16-byte rows for TMA), 256-byte aligned and apart;
    the products' 64 x 64 tiles, the mix's 4-row blocks and the GEMMs'
    64-row tiles of every (image, head) cover the length."""
    plan = th.th_bwd_staged_plan(b, l)
    lp = plan['lp']
    assert lp % 8 == 0 and l <= lp < l + 8
    assert {k: v[1] for k, v in plan['regions'].items()} == {
        's': 4 * b * 16 * l * l, 'da': 4 * b * 16 * l * l,
        'ds': 2 * b * 16 * l * lp, 'pt': 2 * b * 16 * l * lp}
    spans = sorted(plan['regions'].values())
    for (a, na), (c, _) in zip(spans, spans[1:]):
        assert a % 256 == 0 and a + na <= c
    assert spans[-1][0] + spans[-1][1] <= plan['workspace']
    nt = -(-l // 64)
    assert plan['blocks'] == {'products': b * 16 * nt * nt,
                              'mix': b * -(-l // 4), 'gemm': b * 16 * nt}


def _bands(b, l, heads, seed, head_ch=48, dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    mk = lambda std: torch.from_numpy((rng.standard_normal(
        (b, l, heads * head_ch)) * std).astype(np.float32)).to(dtype)
    q, k, v, do = mk(0.4), mk(1.0), mk(1.0), mk(1.0)
    mixes = [torch.from_numpy((np.eye(heads) + 0.3 * rng.standard_normal(
        (heads, heads))).astype(np.float32)) for _ in range(2)]
    return q, k, v, do, mixes


def _refusals():
    q, k, v, do, m = _bands(1, 20, 8, 0)
    _, lse = th.th_core_fwd_plain(q, k, v, *m, 8)
    q12, k12, v12, do12, m12 = _bands(1, 20, 12, 0)
    _, lse12 = th.th_core_fwd_plain(q12, k12, v12, *m12, 12)
    q64, k64, v64, do64, _ = _bands(1, 20, 8, 0, head_ch=64)
    return {
        'twelve heads': (q12, k12, v12, do12, lse12, 12),
        'head_ch 64': (q64, k64, v64, do64, lse, 8),
        'float32 bands': (q.float(), k.float(), v.float(), do.float(), lse, 8),
        'lse shape': (q, k, v, do, lse[:, :, :19].contiguous(), 8),
        'lse device': (q, k, v, do, lse.to('meta'), 8),
    }


@pytest.mark.parametrize('case', ['twelve heads', 'head_ch 64', 'float32 bands',
                                  'lse shape', 'lse device'])
def test_backward_checks_raise(case):
    with pytest.raises(ValueError):
        th._check_bwd(*_refusals()[case])


def kernel_algebra(q, k, v, do, lse, m_pre, m_post, heads):
    """The kernels' arithmetic in torch (test only): returns (dq, dk, dv,
    dm_pre, dm_post) like ``th_core_bwd_plain``."""
    b, l, hd = q.shape
    rows, cols = 64, 16
    split = lambda a: a.reshape(b, l, heads, hd // heads).float()
    q4, k4, v4, do4 = split(q), split(k), split(v), split(do)
    pre = m_pre.float()
    pre2 = pre * th.LOG2E
    post = m_post.float()
    lse2 = lse.float() * th.LOG2E                       # [B, H, L]

    def tile(qs, ks):
        """s, da, pn of queries ``qs`` against keys ``ks`` (slices), each
        [B, H, queries, keys]."""
        s = torch.einsum('bqhd,bkhd->bhqk', q4[:, qs], k4[:, ks])
        da = torch.einsum('bqhd,bkhd->bhqk', do4[:, qs], v4[:, ks])
        x = torch.einsum('ji,bjqk->biqk', pre2, s) - lse2[:, :, qs, None]
        return s, da, torch.exp2(x)

    dq = torch.zeros(b, l, heads, hd // heads)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    delta = torch.zeros(b, heads, l)
    dm_post = torch.zeros(heads, heads)
    dm_pre = torch.zeros(heads, heads)
    # DQ: sweep 1 (delta), then sweep 2 (ds, dq)
    span = lambda r0, n: slice(r0, min(r0 + n, l))
    for r0 in range(0, l, rows):
        rr = span(r0, rows)
        for c0 in range(0, l, cols):
            _, da, pn = tile(rr, span(c0, cols))
            dpn = torch.einsum('ji,biqk->bjqk', post, da)
            delta[:, :, rr] += (dpn * pn).sum(dim=-1)
        for c0 in range(0, l, cols):
            cc = span(c0, cols)
            _, da, pn = tile(rr, cc)
            dpn = torch.einsum('ji,biqk->bjqk', post, da)
            dst = pn * (dpn - delta[:, :, rr, None])
            ds = torch.einsum('ji,biqk->bjqk', pre, dst).bfloat16().float()
            dq[:, rr] += torch.einsum('bhqk,bkhd->bqhd', ds, k4[:, cc])
    # DK and DV (with dM_pre and dM_post): 64 key rows against 16-query
    # tiles
    for r0 in range(0, l, rows):
        rr = span(r0, rows)
        for c0 in range(0, l, cols):
            cc = span(c0, cols)
            s, da, pn = tile(cc, rr)                    # queries cc, keys rr
            dpn = torch.einsum('ji,biqk->bjqk', post, da)
            dst = pn * (dpn - delta[:, :, cc, None])
            ds = torch.einsum('ji,biqk->bjqk', pre, dst).bfloat16().float()
            dk[:, rr] += torch.einsum('bhqk,bqhd->bkhd', ds, q4[:, cc])
            dm_pre += torch.einsum('biqk,bjqk->ji', dst, s)
            pt = torch.einsum('hi,bhqk->biqk', post, pn).bfloat16().float()
            dv[:, rr] += torch.einsum('bhqk,bqhd->bkhd', pt, do4[:, cc])
            dm_post += torch.einsum('biqk,bjqk->ji', da, pn)
    flat = lambda a: a.reshape(b, l, hd).to(q.dtype)
    return flat(dq), flat(dk), flat(dv), dm_pre, dm_post


def staged_algebra(q, k, v, do, lse, m_pre, m_post, heads):
    """The staged backward's arithmetic at H = 16 in torch (test only):
    returns (dq, dk, dv, dm_pre, dm_post) like ``th_core_bwd_plain``."""
    b, l, hd = q.shape
    d = hd // heads
    split = lambda a: a.reshape(b, l, heads, d).float()
    q4, k4, v4, do4 = split(q), split(k), split(v), split(do)
    pre, post = m_pre.float(), m_post.float()
    pre2 = pre * th.LOG2E
    # 1. s and da per head, f32 (one 48-deep product a position)
    s = torch.einsum('bqhd,bkhd->bhqk', q4, k4)
    da = torch.einsum('bqhd,bkhd->bhqk', do4, v4)
    # 2. the mix, a block of 4 query rows: pn, dpn, delta over the row's
    # keys, dst, ds and pt in bf16, dM partials summed in block order
    pn = torch.exp2(torch.einsum('ji,bjqk->biqk', pre2, s)
                    - (lse.float() * th.LOG2E)[..., None])
    dpn = torch.einsum('ji,biqk->bjqk', post, da)
    delta = (dpn * pn).sum(dim=-1, keepdim=True)
    dst = pn * (dpn - delta)
    ds = torch.einsum('ji,biqk->bjqk', pre, dst).bfloat16().float()
    pt = torch.einsum('ij,biqk->bjqk', post, pn).bfloat16().float()
    dm_pre = torch.zeros(heads, heads)
    dm_post = torch.zeros(heads, heads)
    for bi in range(b):
        for r0 in range(0, l, th.STAGED_MIX_ROWS):
            rr = slice(r0, min(r0 + th.STAGED_MIX_ROWS, l))
            dm_pre += torch.einsum('iqk,jqk->ji', dst[bi, :, rr], s[bi, :, rr])
            dm_post += torch.einsum('iqk,jqk->ji', da[bi, :, rr], pn[bi, :, rr])
    # 3. dq = ds k, dk = ds^T q, dv = pt^T do: 64 rows of depth a step
    dq, dk, dv = (torch.zeros(b, l, heads, d) for _ in range(3))
    for c0 in range(0, l, 64):
        cc = slice(c0, min(c0 + 64, l))
        dq += torch.einsum('bhqk,bkhd->bqhd', ds[..., cc], k4[:, cc])
        dk += torch.einsum('bhqk,bqhd->bkhd', ds[:, :, cc], q4[:, cc])
        dv += torch.einsum('bhqk,bqhd->bkhd', pt[:, :, cc], do4[:, cc])
    flat = lambda a: a.reshape(b, l, hd).to(q.dtype)
    return flat(dq), flat(dk), flat(dv), dm_pre, dm_post


def _rel(a, b):
    a, b = torch.as_tensor(np.asarray(a, np.float32)), torch.as_tensor(
        np.asarray(b, np.float32))
    return float((a - b).abs().max() / b.abs().max())


def _hold(got, want):
    names = ('dq', 'dk', 'dv', 'dm_pre', 'dm_post')
    for name, g, w, tol in zip(names, got, want, (GRAD_TOL,) * 3 + (DM_TOL,) * 2):
        g = g.float() if isinstance(g, torch.Tensor) else g
        w = w.float() if isinstance(w, torch.Tensor) else w
        assert _rel(g, w) <= tol, (name, _rel(g, w))


@pytest.mark.parametrize('b,l,heads', [(2, 5, 4), (2, 17, 8), (1, 80, 4),
                                       (1, 130, 8), (2, 37, 6), (1, 80, 6)])
def test_kernel_algebra_matches_twin(b, l, heads):
    q, k, v, do, m = _bands(b, l, heads, l + heads)
    _, lse = th.th_core_fwd_plain(q, k, v, *m, heads)
    _hold(kernel_algebra(q, k, v, do, lse, *m, heads),
          th.th_core_bwd_plain(q, k, v, do, lse, *m, heads))


@pytest.mark.parametrize('b,l', [(2, 21), (1, 70)])
def test_staged_algebra_matches_twin(b, l):
    q, k, v, do, m = _bands(b, l, 16, l)
    _, lse = th.th_core_fwd_plain(q, k, v, *m, 16)
    _hold(staged_algebra(q, k, v, do, lse, *m, 16),
          th.th_core_bwd_plain(q, k, v, do, lse, *m, 16))


def test_kernel_algebra_matches_jax_blocked_kernel():
    """At L = 40 (a ragged 64-row work tile and 16-row streamed tile), H = 4:
    the JAX package's q-blocked backward kernel (K6b) run in interpret mode
    on the same bf16 bands, zero-padded to its 128-row blocks."""
    b, l, heads = 1, 40, 4
    q, k, v, do, m = _bands(b, l, heads, 11)
    _, lse = th.th_core_fwd_plain(q, k, v, *m, heads)
    lp = 128
    pad = lambda t: jnp.asarray(np.pad(t.float().numpy(), (
        (0, 0), (0, lp - l), (0, 0)))).astype(jnp.bfloat16)
    lse_p = np.zeros((b, heads, lp, jax_th.STAT_LANES), np.float32)
    lse_p[:, :, :l] = lse.numpy()[..., None]
    dq, dk, dv, dm_pre, dm_post = jax_th.th_blocked_bwd(
        pad(q), pad(k), pad(v), jnp.asarray(lse_p), pad(do),
        jnp.asarray(m[0].numpy()), jnp.asarray(m[1].numpy()), l=l,
        heads=heads, dp=48)
    jax_out = [np.asarray(t[:, :l], np.float32) for t in (dq, dk, dv)]
    jax_out += [np.asarray(dm_pre), np.asarray(dm_post)]
    ours = kernel_algebra(q, k, v, do, lse, *m, heads)
    _hold(ours, [torch.from_numpy(np.array(t)) for t in jax_out])
