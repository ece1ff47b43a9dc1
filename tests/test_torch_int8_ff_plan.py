"""Torch port: the int8 FF forward's launch plan and algebra on the CPU
(``csrc/int8_ff.cu`` + ``csrc/int8_ff_sm90.cuh``, K12 and K13; the kernels
run only on the card, ``tests/test_torch_cuda.py``).

* ``int8_ff_plan``, the Python mirror of the C entry ``sav_int8_ff_plan``:
  the 128 x 128 tiles of each product cover every row and column once, and
  the persistent blocks' two teams take every unit once (at M = 37,824,
  ViT-B/16 @224 bs192's rows, 37,632, Mixer-B/16 bs192's, 25,088, CaiT-S/24
  bs128's, 6,304, ViT-B/16 bs32's, a ragged 1003 and 1); at every width the
  int8 factory routes use, the shared memory fits a block and the workspace
  regions lie apart at 256-byte offsets.
* The geometry the kernels do not take raises ValueError (never asserts).
* ``kernel_algebra``, a test-only torch mirror of the kernels' tile order:
  x's codes (LN first for K13), the first product per 128 x 128 tile with
  the hpre epilogue and gelu, each (row, tile)'s absmax partial, the row
  scale from the max of the partials, the first product again for the
  hidden codes (the kernels' fast quantiser: the multiply by the IEEE
  reciprocal where that cannot move a code), the second product with
  dequant + b2 (+ x). Held against the twins ``int8_ff_reference`` and
  ``int8_ff_ln_reference``: the max of the partials is the whole row's
  absmax exactly, and the hidden codes, hpre and out are bit-identical
  (the same IEEE operations in the same order; a max is exact in any
  order). Held against the JAX package's kernels ``_ff_kernel`` and
  ``_ff_ln_kernel`` in interpret mode at ``test_torch_int8_ff``'s
  tolerance (most values identical, the rest within KERNEL_TOL).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import int8_ff as jff
from sav_tpu_torch.ops import int8_ff as tff
from sav_tpu_torch.ops.fused_layer import _ln_f32
from sav_tpu_torch.ops.int8_matmul_kernel import _quantize_tile
from test_torch_int8_dx_plan import SMS, _quantize_by, _units_of_blocks
from test_torch_quantized import assert_near_kernel

import torch_parity  # noqa: F401  (pins torch to one thread)

SMEM_LIMIT = 232448
CASES = [(37824, 768, 3072), (37632, 768, 3072), (25088, 384, 1536),
         (6304, 768, 3072), (1003, 768, 3072), (1, 768, 3072)]
# (D, F) of the int8 factory routes: cait_xxs, CaiT-S, ViT-B and Mixer-B,
# ViT-L
WIDTHS = [(192, 768), (384, 1536), (768, 3072), (1024, 4096)]


def _cdiv(a, b):
    return -(-a // b)


def _pairs_of_blocks(units, nt, sms=SMS):
    """OUT's (row tile, column tile) units taken in pair units, in the
    order the kernel's blocks take them: block i takes pair units i + j
    grid, a row tile's column tiles 2c (team 0) and 2c + 1 (team 1)."""
    grid = min(_cdiv(units, 2), sms)
    return [(p // (nt // 2), 2 * (p % (nt // 2)) + team)
            for i in range(grid) for p in range(i, units // 2, grid)
            for team in range(2)]


@pytest.mark.parametrize('m,dim,hidden', CASES)
def test_plan_tiles_cover_every_row_and_column_once(m, dim, hidden):
    plan = tff.int8_ff_plan(m, dim, hidden)
    tile = tff.DX_TILE
    rows = plan['row_tiles']
    assert (rows - 1) * tile < m <= rows * tile
    for key, n in (('hidden', hidden), ('out', dim)):
        cols = plan['col_tiles'][key]
        assert (cols - 1) * tile < n <= cols * tile
    assert plan['units'] == {'absmax': rows * plan['col_tiles']['hidden'],
                             'codes': rows * plan['col_tiles']['hidden'],
                             'out': rows * plan['col_tiles']['out']}
    for units, n, pairs in ((plan['units']['absmax'], hidden, False),
                            (plan['units']['out'], dim, plan['out_pairs'])):
        nt = _cdiv(n, tile)
        taken = _pairs_of_blocks(units, nt) if pairs else [
            (u // nt, u % nt) for u in _units_of_blocks(units)]
        cells = set(taken)
        assert len(taken) == len(cells) == units
        covered = np.zeros((rows * tile, nt * tile), np.int32)
        for r, c in cells:
            covered[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] += 1
        assert (covered[:m, :n] == 1).all()
    assert plan['out_pairs'] == (dim == 768)      # D / 128: 6, or 3
    assert plan['parts'] == plan['col_tiles']['hidden']
    assert plan['stages'] == {'hidden': _cdiv(dim, tff.DX_STAGE),
                              'out': _cdiv(hidden, tff.DX_STAGE_DY)}


@pytest.mark.parametrize('dim,hidden', WIDTHS)
@pytest.mark.parametrize('m', [37824, 1003, 1])
def test_plan_fits_and_workspace_regions_lie_apart(m, dim, hidden):
    plan = tff.int8_ff_plan(m, dim, hidden)
    want = {'xq': m * dim, 'xs': 4 * m, 'amax': 4 * m * plan['parts'],
            'hs': 4 * m, 'hq': m * hidden, 'w1t': dim * hidden,
            'w2t': dim * hidden}
    assert {k: v[1] for k, v in plan['scratch'].items()} == want
    spans = sorted(plan['scratch'].values())
    for (a, na), (b, _) in zip(spans, spans[1:]):
        assert a % 256 == 0 and a + na <= b
    last, nlast = spans[-1]
    assert last % 256 == 0 and last + nlast <= plan['workspace']
    assert 0 < plan['smem'] <= SMEM_LIMIT


@pytest.mark.parametrize('m,dim,hidden', [(0, 768, 3072), (-5, 768, 3072),
                                          (16, 80, 3072), (16, 768, 3000),
                                          (16, 0, 256), (16, 768, 32)])
def test_plan_refuses_what_the_kernels_do_not_take(m, dim, hidden):
    with pytest.raises(ValueError, match='multiples of 32'):
        tff.int8_ff_plan(m, dim, hidden)


def _case(m, dim, hidden, seed):
    rng = np.random.RandomState(seed)
    f32 = lambda shape, std=1.0, mean=0.0: torch.from_numpy(
        (mean + std * rng.standard_normal(shape)).astype(np.float32))
    x = f32((m, dim)).bfloat16()
    ln = (f32(dim, 0.1, 1.0), f32(dim, 0.1))
    w1_q, s1, w2_q, s2 = tff._quantized_weights(
        f32((dim, hidden), dim ** -0.5), f32((hidden, dim), hidden ** -0.5))
    return x, ln, (w1_q, s1, f32(hidden, 0.1), w2_q, s2, f32(dim, 0.1))


def kernel_algebra(x, ln, w1_q, s1, b1, w2_q, s2, b2, eps=1e-6):
    """The kernels' arithmetic in torch (test only): (out, hpre in bf16,
    the hidden codes, the absmax partials, the rows' absmax). ``ln`` is
    (scale, bias) for K13, None for K12."""
    m, dim = x.shape
    hidden = w1_q.shape[1]
    tile = tff.DX_TILE
    plan = tff.int8_ff_plan(m, dim, hidden)
    if ln is None:
        xq, xs = _quantize_tile(x)
    else:
        xq, xs = _quantize_tile(_ln_f32(x, *ln, eps)[1])
    w1t = w1_q.t().contiguous()                     # [F, D], as the kernel

    def hpre_tile(r0, c0):                          # ABSMAX and CODES
        rows, cols = slice(r0, r0 + tile), slice(c0, c0 + tile)
        acc = torch._int_mm(xq[rows].contiguous(), w1t[cols].t().contiguous())
        return acc.float() * (xs[rows] * s1[:, cols]) + b1[cols]

    amax = torch.zeros(m, plan['parts'])
    hpre = torch.empty(m, hidden, dtype=torch.bfloat16)
    for r in range(plan['row_tiles']):              # ABSMAX (HPRE)
        rows = slice(r * tile, (r + 1) * tile)
        for c in range(plan['col_tiles']['hidden']):
            h = hpre_tile(r * tile, c * tile)
            hpre[rows, c * tile:(c + 1) * tile] = h.to(torch.bfloat16)
            amax[rows, c] = tff.gelu(h).abs().amax(dim=1)
    row_max = amax.amax(dim=1, keepdim=True)
    hs = torch.clamp(row_max, min=1e-8) / torch.full_like(row_max, 127.0)
    hq = torch.empty(m, hidden, dtype=torch.int8)
    for r in range(plan['row_tiles']):              # CODES
        rows = slice(r * tile, (r + 1) * tile)
        for c in range(plan['col_tiles']['hidden']):
            hq[rows, c * tile:(c + 1) * tile] = _quantize_by(
                tff.gelu(hpre_tile(r * tile, c * tile)), hs[rows])
    out = torch.empty(m, dim, dtype=x.dtype)
    for c in range(plan['col_tiles']['out']):       # OUT (OUT_RES)
        cols = slice(c * tile, (c + 1) * tile)
        acc = torch._int_mm(hq, w2_q[:, cols].contiguous())
        y = acc.float() * (hs * s2[:, cols]) + b2[cols]
        out[:, cols] = (y if ln is None else x[:, cols].float() + y).to(x.dtype)
    return out, hpre, hq, amax, row_max


@pytest.mark.parametrize('ln', [False, True])
@pytest.mark.parametrize('m', [50, 129])
def test_kernel_algebra_is_the_twin_bit_for_bit(m, ln):
    dim, hidden = 128, 320                          # a ragged last F tile
    x, lnp, w = _case(m, dim, hidden, m + ln)
    lnp = lnp if ln else None
    out, hpre, hq, amax, row_max = kernel_algebra(x, lnp, *w)
    w1_q, s1, b1 = w[:3]
    y = x if lnp is None else _ln_f32(x, *lnp, 1e-6)[1]
    xq, xs = _quantize_tile(y)
    h32 = torch._int_mm(xq, w1_q).float() * (xs * s1) + b1
    g = tff.gelu(h32)
    # the max of the per-tile partials is the row's absmax, exactly
    assert torch.equal(row_max, g.abs().amax(dim=1, keepdim=True))
    assert amax.shape == (m, _cdiv(hidden, tff.DX_TILE))
    assert torch.equal(hq, _quantize_tile(g)[0])
    if lnp is None:
        want = tff.int8_ff_reference(x, *w, save_hpre=True)
    else:
        want = tff.int8_ff_ln_reference(x, *lnp, *w, save_hpre=True)
    assert torch.equal(hpre, want[1])
    assert torch.equal(out, want[0])


@pytest.mark.parametrize('ln', [False, True])
def test_kernel_algebra_matches_jax_kernels(ln):
    """At M = 50, D = 128, F = 384 against the JAX package's ``_ff_kernel``
    / ``_ff_ln_kernel`` (interpret mode) on the same bf16 x and codes."""
    m, dim, hidden = 50, 128, 384
    x, lnp, w = _case(m, dim, hidden, 7 + ln)
    out, hpre = kernel_algebra(x, lnp if ln else None, *w)[:2]
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jw = [jnp.asarray(t.numpy()) for t in w]
    if ln:
        jl = [jnp.asarray(t.numpy()) for t in lnp]
        want = jff.int8_ff_ln_raw(jx, *jl, *jw, save_hpre=True)
    else:
        want = jff.int8_ff_raw(jx, *jw, save_hpre=True)
    assert_near_kernel(out, want[0])
    assert_near_kernel(hpre, want[1])
