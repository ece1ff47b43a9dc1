"""Torch port: the block-wise int8 matmul's launch plan and fold on the CPU
(``csrc/int8_matmul.cu`` + ``csrc/q8_gemm_sm90.cuh``, K15; the kernel runs
only on the card, ``tests/test_torch_cuda.py``).

* ``int8_matmul_plan``, the Python mirror of the C entry
  ``sav_int8_matmul_plan``: the 128 x 128 tiles cover every row and column
  once and the persistent blocks take every unit once (at M = 6304,
  ViT-B/16 @224 bs32's rows, 6272, 1003 and 1, at the two FF products and
  at a ragged K = 700); the shared memory fits a block and the workspace
  regions lie apart at 256-byte offsets.
* The geometry the kernel does not take raises ValueError (never asserts).
* ``kernel_fold``, a test-only torch mirror of the kernel's order: a's
  codes per (row, 256-wide k-block) in [M, ldk] (zeros past K), each
  128 x 128 unit's int32 sums per k-block as two 128-deep slots (the
  boxes past K read as zeros), the fold ``acc = acc + f32(part) * scale``
  in k order, then ``bf16(acc * b_scale)``. Bit-identical to the twin
  ``blockwise_int8_matmul_reference`` (int32 sums are exact in any order,
  and the f32 operations are the same, in the same order) and to the JAX
  package's ``blockwise_int8_matmul_reference`` at K = 700 (a ragged last
  k-block) and K = 3 x 256.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import int8_matmul_kernel as jmk
from sav_tpu.ops import quantized as jq
from sav_tpu_torch.ops import int8_matmul_kernel as tmk
from sav_tpu_torch.ops import quantized as tq
from test_torch_quantized import _np, _pair

import torch_parity  # noqa: F401  (pins torch to one thread)

SMEM_LIMIT = 232448
SMS = 132
ROWS = [6304, 6272, 1003, 1]
# (K, N): ViT-B/16's FF1 and FF2, a ragged last k-block
SHAPES = [(768, 3072), (3072, 768), (700, 256)]


def _cdiv(a, b):
    return -(-a // b)


def _units_of_blocks(units, sms=SMS):
    """Unit indices in the order the persistent blocks take them: block i
    takes i + j grid."""
    grid = min(units, sms)
    return [u for i in range(grid) for u in range(i, units, grid)]


@pytest.mark.parametrize('k,n', SHAPES)
@pytest.mark.parametrize('m', ROWS)
def test_plan_tiles_cover_every_row_and_column_once(m, k, n):
    plan = tmk.int8_matmul_plan(m, k, n)
    tile = tmk.TILE
    rows, cols = plan['row_tiles'], plan['col_tiles']
    assert (rows - 1) * tile < m <= rows * tile
    assert (cols - 1) * tile < n <= cols * tile
    assert plan['units'] == rows * cols
    taken = _units_of_blocks(plan['units'])
    assert sorted(taken) == list(range(plan['units']))
    covered = np.zeros((rows * tile, cols * tile), np.int32)
    for u in taken:
        r, c = u // cols, u % cols              # column tiles fastest
        covered[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] += 1
    assert (covered[:m, :n] == 1).all()
    assert plan['k_blocks'] == _cdiv(k, tmk.BLOCK_K)
    assert plan['slots'] == 2 * plan['k_blocks']
    # the slots reach past K by less than one k-block
    assert k <= plan['slots'] * tmk.SLOT_K < k + tmk.BLOCK_K
    assert plan['ldk'] % 16 == 0 and k <= plan['ldk'] < k + 16
    assert plan['ldo'] % 8 == 0 and n <= plan['ldo'] < n + 8


@pytest.mark.parametrize('k,n', SHAPES)
@pytest.mark.parametrize('m', [6304, 1003, 1])
def test_plan_fits_and_workspace_regions_lie_apart(m, k, n):
    plan = tmk.int8_matmul_plan(m, k, n)
    ldk, kb = plan['ldk'], plan['k_blocks']
    assert {name: v[1] for name, v in plan['scratch'].items()} == {
        'bt': n * ldk, 'aq': m * ldk, 'as': 4 * m * kb}
    spans = sorted(plan['scratch'].values())
    for (a, na), (b, _) in zip(spans, spans[1:]):
        assert a % 256 == 0 and a + na <= b
    last, nlast = spans[-1]
    assert last % 256 == 0 and last + nlast <= plan['workspace']
    assert 0 < plan['smem'] <= SMEM_LIMIT


@pytest.mark.parametrize('m,k,n', [(0, 768, 3072), (-3, 768, 3072),
                                   (16, 0, 256), (16, 768, 255),
                                   (16, 768, 0), (16, 768, 1)])
def test_plan_refuses_what_the_kernel_does_not_take(m, k, n):
    with pytest.raises(ValueError, match='even N'):
        tmk.int8_matmul_plan(m, k, n)


def _case(m, k, n, seed):
    rng = np.random.RandomState(seed)
    a = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    kern = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return a, kern


def kernel_fold(a, b_q, b_scale):
    """The kernel's order in torch (test only): a's codes per (row, k-block)
    into [M, ldk], then per 128 x 128 unit, per k-block, the int32 sums of
    its two 128-deep slots, folded into f32 in k order; bf16(acc *
    b_scale)."""
    m, k = a.shape
    n = b_q.shape[1]
    plan = tmk.int8_matmul_plan(m, k, n)
    ldk, kb, tile = plan['ldk'], plan['k_blocks'], tmk.TILE
    depth = plan['slots'] * tmk.SLOT_K           # what the boxes cover
    aq = torch.zeros(m, depth, dtype=torch.int8)
    a_scale = torch.zeros(m, kb)
    a_p = torch.nn.functional.pad(a, (0, kb * tmk.BLOCK_K - k))
    for j in range(kb):                           # quantize_blocks_kernel
        q, s = tmk._quantize_tile(a_p[:, j * tmk.BLOCK_K:(j + 1) * tmk.BLOCK_K])
        aq[:, j * tmk.BLOCK_K:(j + 1) * tmk.BLOCK_K] = q
        a_scale[:, j] = s[:, 0]
    assert not aq[:, k:].any()                    # zeros past K
    aq = aq[:, :ldk]                              # the workspace's rows
    # the tensor maps' extent is K: every box reads zeros past it
    aq_box = torch.nn.functional.pad(aq[:, :k], (0, depth - k))
    bt = torch.nn.functional.pad(b_q.t(), (0, depth - k))   # [N, depth]
    out = torch.empty(m, n, dtype=torch.bfloat16)
    for r0 in range(0, m, tile):
        for c0 in range(0, n, tile):
            rows, cols = slice(r0, r0 + tile), slice(c0, c0 + tile)
            acc = torch.zeros(len(range(m)[rows]), len(range(n)[cols]))
            for j in range(kb):
                part = 0
                for h in range(2):                # the k-block's two slots
                    ks = slice((2 * j + h) * tmk.SLOT_K,
                               (2 * j + h + 1) * tmk.SLOT_K)
                    part = part + (aq_box[rows, ks].long()
                                   @ bt[cols, ks].long().t())
                acc = acc + part.to(torch.int32).float() * a_scale[rows, j:j + 1]
            out[rows, cols] = (acc * b_scale[:, cols]).bfloat16()
    return out


@pytest.mark.parametrize('m,k,n', [(130, 700, 256), (67, 768, 192),
                                   (5, 300, 64)])
def test_kernel_fold_is_the_twin_and_the_jax_twin(m, k, n):
    a, kern = _case(m, k, n, m + k)
    ja, ta = _pair(a, 'bfloat16')
    jk, tk = _pair(kern, 'bfloat16')
    tbq, tbs = tq.quantize_symmetric(tk, axis=0)
    jbq, jbs = jq.quantize_symmetric(jk, axis=0)
    np.testing.assert_array_equal(tbq.numpy(), np.asarray(jbq))
    ours = kernel_fold(ta, tbq, tbs)
    twin = tmk.blockwise_int8_matmul_reference(ta, tbq, tbs)
    assert torch.equal(ours, twin)
    np.testing.assert_array_equal(
        _np(ours), _np(jmk.blockwise_int8_matmul_reference(ja, jbq, jbs)))


def test_wrapper_refuses_before_any_launch():
    """Off-contract operands raise on a CUDA-typed check path without a
    card: the checks run on the CPU twin's operands here."""
    a = torch.zeros(4, 300, dtype=torch.bfloat16)
    bq = torch.zeros(300, 63, dtype=torch.int8)
    with pytest.raises(ValueError, match='even N'):
        tmk._check(a, bq, torch.ones(1, 63))
    with pytest.raises(ValueError, match='b_q must be int8'):
        tmk._check(a, bq.float(), torch.ones(1, 63))
    with pytest.raises(ValueError, match='b_scale must be'):
        tmk._check(a, torch.zeros(300, 64, dtype=torch.int8), torch.ones(64))
