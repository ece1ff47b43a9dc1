"""Torch port: the SwitchBack int8 dx backward's launch plan and algebra on the
CPU (``csrc/int8_ff.cu`` + ``csrc/int8_dx_sm90.cuh``, K14; the kernels run
only on the card, ``tests/test_torch_cuda.py``).

* ``int8_dx_plan``, the Python mirror of the C entry ``sav_int8_ff_dx_plan``:
  the 128 x 128 tiles of each product cover every row and column once, and
  the persistent blocks' two teams take every unit once (at M = 37,824, the
  rows of ViT-B/16 @224 bs192, 25,088, CaiT-S/24 @224 bs128's, a ragged
  1003 and 1); the shared memory fits a block and the workspace it sizes
  holds what the kernels write, each region apart from the others.
* The geometry the kernels do not take raises ValueError (never asserts).
* ``kernel_algebra``, a test-only torch mirror of the three products' tile
  order: g's codes, the first product per 128 x 128 tile with the gelu'
  epilogue, each (row, tile)'s absmax partial, the row scale from the max of
  the partials, the first product again for dh's codes (the kernels' fast
  quantiser: the multiply by the IEEE reciprocal where that cannot move a
  code), the second product. Held against the twin
  ``int8_ff_dx_reference``: the max of the partials equals the whole row's
  absmax exactly, and dh's codes, dh and dy are bit-identical (the same
  IEEE operations in the same order; a max is exact in any order). Held
  against the JAX package's ``int8_ff_dx_reference`` at
  ``test_torch_switchback``'s tolerance (most values identical, the rest
  within KERNEL_TOL: XLA's CPU tanh differs from torch's in the last bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import int8_ff as jff
from sav_tpu_torch.ops import int8_ff as tff
from sav_tpu_torch.ops.int8_matmul_kernel import _quantize_tile
from test_torch_quantized import assert_near_kernel

import torch_parity  # noqa: F401  (pins torch to one thread)

SMEM_LIMIT = 232448
SMS = 132
CASES = [(37824, 768, 3072), (25088, 384, 1536), (1003, 768, 3072),
         (1, 768, 3072)]


def _cdiv(a, b):
    return -(-a // b)


def _units_of_blocks(units, sms=SMS):
    """Unit indices in the order the kernel's blocks and teams take them:
    block i's team r takes 2 (i + j grid) + r."""
    grid = min(_cdiv(units, 2), sms)
    taken = []
    for i in range(grid):
        for r in range(2):
            taken += range(2 * i + r, units, 2 * grid)
    return taken


@pytest.mark.parametrize('m,dim,hidden', CASES)
def test_plan_tiles_cover_every_row_and_column_once(m, dim, hidden):
    plan = tff.int8_dx_plan(m, dim, hidden)
    tile = tff.DX_TILE
    rows = plan['row_tiles']
    assert (rows - 1) * tile < m <= rows * tile
    for key, n in (('dh', hidden), ('dy', dim)):
        cols = plan['col_tiles'][key]
        assert (cols - 1) * tile < n <= cols * tile
    assert plan['units'] == {'absmax': rows * plan['col_tiles']['dh'],
                             'codes': rows * plan['col_tiles']['dh'],
                             'dy': rows * plan['col_tiles']['dy']}
    for units, n in ((plan['units']['absmax'], hidden),
                     (plan['units']['dy'], dim)):
        nt = _cdiv(n, tile)
        taken = _units_of_blocks(units)
        assert sorted(taken) == list(range(units))
        cells = {(u // nt, u % nt) for u in taken}
        assert len(cells) == units
        # every (row, column) of the output in exactly one tile
        covered = np.zeros((rows * tile, nt * tile), np.int32)
        for r, c in cells:
            covered[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] += 1
        assert (covered[:m, :n] == 1).all()
    assert plan['parts'] == plan['col_tiles']['dh']
    assert plan['stages'] == {'dh': _cdiv(dim, tff.DX_STAGE),
                              'dy': _cdiv(hidden, tff.DX_STAGE_DY)}


@pytest.mark.parametrize('m,dim,hidden', CASES)
def test_plan_workspace_holds_what_the_kernels_write(m, dim, hidden):
    plan = tff.int8_dx_plan(m, dim, hidden)
    want = {'gq': m * dim, 'gs': 4 * m, 'amax': 4 * m * plan['parts'],
            'dhs': 4 * m, 'dhq': m * hidden}
    assert {k: v[1] for k, v in plan['scratch'].items()} == want
    spans = sorted(plan['scratch'].values())
    for (a, na), (b, _) in zip(spans, spans[1:]):
        assert a % 256 == 0 and a + na <= b
    last, nlast = spans[-1]
    assert last + nlast <= plan['workspace']
    assert 0 < plan['smem'] <= SMEM_LIMIT


@pytest.mark.parametrize('m,dim,hidden', [(0, 768, 3072), (16, 80, 3072),
                                          (16, 768, 3000), (16, 0, 256),
                                          (16, 768, 32)])
def test_plan_refuses_what_the_kernels_do_not_take(m, dim, hidden):
    with pytest.raises(ValueError):
        tff.int8_dx_plan(m, dim, hidden)


def test_plan_takes_every_band_geometry():
    """Every D and F multiple of 64 whose 16-row band fitted a block (the
    condition of K12's and K13's earlier band kernel) plans: the kernels
    need no band."""
    for dim in (64, 128, 320, 384, 768, 1024):
        for hidden in (256, 512, 704, 1536, 3072, 4096):
            tff.int8_dx_plan(129, dim, hidden)


def _case(m, dim, hidden, seed):
    rng = np.random.RandomState(seed)
    g = torch.from_numpy((0.02 * rng.standard_normal((m, dim))).astype(
        np.float32)).bfloat16()
    hpre = torch.from_numpy(rng.standard_normal((m, hidden)).astype(
        np.float32)).bfloat16()
    w = lambda shape, std: torch.from_numpy(
        (std * rng.standard_normal(shape)).astype(np.float32))
    return (g, hpre, *tff._dx_quantized(w((dim, hidden), dim ** -0.5)),
            *tff._dx_quantized(w((hidden, dim), hidden ** -0.5)))


def _quantize_by(v, scale):
    """The kernels' ``quantize_by``: v times the IEEE reciprocal of the row
    scale, rounded half to even, the IEEE division where the product lies
    within 1e-4 of a half-integer."""
    q = v * torch.reciprocal(scale)
    r = torch.round(q)
    near = ((q - r).abs() - 0.5).abs() < 1e-4
    exact = torch.round(v / scale)
    return torch.clamp(torch.where(near, exact, r), -127, 127).to(torch.int8)


def kernel_algebra(g, hpre, w1t_q, s1t, w2t_q, s2t):
    """The kernels' arithmetic in torch (test only): (dy2, dh, dhq, the
    absmax partials, the rows' absmax)."""
    m, dim = g.shape
    hidden = hpre.shape[1]
    tile = tff.DX_TILE
    plan = tff.int8_dx_plan(m, dim, hidden)
    gq, gs = _quantize_tile(g)
    w2c = w2t_q.t().contiguous()                    # [F, D], as the kernel
    hp = hpre.float()

    def dh_tile(r0, c0):                            # ABSMAX and CODES
        rows, cols = slice(r0, r0 + tile), slice(c0, c0 + tile)
        acc = torch._int_mm(gq[rows].contiguous(), w2c[cols].t().contiguous())
        dgact = acc.float() * (gs[rows] * s2t[:, cols])
        return tff.gelu_vjp_f32(hp[rows, cols], dgact)

    amax = torch.zeros(m, plan['parts'])
    dh = torch.empty(m, hidden, dtype=torch.bfloat16)
    for r in range(plan['row_tiles']):              # ABSMAX
        for c in range(plan['col_tiles']['dh']):
            d = dh_tile(r * tile, c * tile)
            dh[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = \
                d.to(torch.bfloat16)
            amax[r * tile:(r + 1) * tile, c] = d.abs().amax(dim=1)
    row_max = amax.amax(dim=1, keepdim=True)
    dhs = torch.clamp(row_max, min=1e-8) / torch.full_like(row_max, 127.0)
    dhq = torch.empty(m, hidden, dtype=torch.int8)
    for r in range(plan['row_tiles']):              # CODES
        rows = slice(r * tile, (r + 1) * tile)
        for c in range(plan['col_tiles']['dh']):
            cols = slice(c * tile, (c + 1) * tile)
            dhq[rows, cols] = _quantize_by(dh_tile(r * tile, c * tile),
                                           dhs[rows])
    acc = torch._int_mm(dhq, w1t_q.contiguous())    # DY
    dy2 = (acc.float() * (dhs * s1t)).to(g.dtype)
    return dy2, dh, dhq, amax, row_max


@pytest.mark.parametrize('m', [50, 129])
def test_kernel_algebra_is_the_twin_bit_for_bit(m):
    dim, hidden = 128, 512
    args = _case(m, dim, hidden, m)
    dy2, dh, dhq, amax, row_max = kernel_algebra(*args)
    g, hpre, w1t_q, s1t, w2t_q, s2t = args
    gq, gs = _quantize_tile(g)
    dgact = torch._int_mm(gq, w2t_q).float() * (gs * s2t)
    dh32 = tff.gelu_vjp_f32(hpre.float(), dgact)
    # the max of the per-tile partials is the row's absmax, exactly
    assert torch.equal(row_max, dh32.abs().amax(dim=1, keepdim=True))
    assert amax.shape == (m, hidden // tff.DX_TILE)
    twin_q, _ = _quantize_tile(dh32)
    assert torch.equal(dhq, twin_q)
    want_dy2, want_dh = tff.int8_ff_dx_reference(*args)
    assert torch.equal(dh, want_dh)
    assert torch.equal(dy2, want_dy2)


def test_fast_quantiser_matches_the_division_at_half_integers():
    """Values a few ulps either side of every half-integer code boundary,
    and the boundaries themselves: the multiply-then-check quantiser gives
    the IEEE division's codes."""
    scale = torch.tensor([[0.0123456789], [3.3e-5], [1.0 / 127.0]])
    k = torch.arange(-127, 128, dtype=torch.float32) + 0.5
    v = k[None, :] * scale
    vals = [v]
    for ulps in (1, 2, 3, 8):
        up, down = v, v
        for _ in range(ulps):
            up = torch.nextafter(up, torch.full_like(up, np.inf))
            down = torch.nextafter(down, torch.full_like(down, -np.inf))
        vals += [up, down]
    v = torch.cat(vals, dim=1)
    exact = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    assert torch.equal(_quantize_by(v, scale), exact)


def test_kernel_algebra_matches_jax_reference():
    """At M = 50, D = 128, F = 512 against the JAX package's twin on the
    same bf16 operands and codes."""
    m, dim, hidden = 50, 128, 512
    args = _case(m, dim, hidden, 7)
    dy2, dh = kernel_algebra(*args)[:2]
    jargs = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
             for t in args[:2]]
    jargs += [jnp.asarray(t.numpy()) for t in args[2:]]
    want = jff.int8_ff_dx_reference(*jargs)
    assert_near_kernel(dy2, want[0])
    assert_near_kernel(dh, want[1])
