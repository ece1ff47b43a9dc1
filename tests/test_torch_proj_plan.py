"""Torch port: the projection GEMM's launch plan on the CPU
(``csrc/proj_sm90.cuh``, the QKV and out products of K1 and K5a; the kernel
runs only on the card, ``tests/test_torch_cuda.py``).

``proj_plan`` is the Python mirror of the kernel's ``plan_bn`` and ``Plan``
(the card test ``test_proj_plan_matches_the_kernel`` holds it against the C
entry ``sav_proj_plan``):
* the tile width it picks at the paths' rows and widths (ViT-B/16, CaiT-S/24,
  TNT-S/16 and TNT-B/16, training and serving, 132 SMs);
* its units, laid out as the kernel walks them (column tiles fastest, a tile
  never across two weights), cover every row and column of the output once;
* its shared memory fits a block's 232,448 bytes;
* D = 192 (ceit_t, vit_ti): one 192-wide tile a row tile and weight,
  three 64-deep steps, as ``proj_takes`` (the C ``proj::takes``) says;
* widths no tile divides but multiples of 32 (cait_xs's 288, K5a's) take
  ceil(N / bn) tiles a weight, the last ragged, and ceil(K / 64) steps,
  as ``proj_takes_ragged`` (the C ``proj::takes_ragged``) says; the tiles
  that divide N are the only ones where any does;
* widths or depths that are not multiples of 32 and weight counts other
  than 1 and 3 raise ValueError.
"""

import numpy as np
import pytest

from sav_tpu_torch.ops import fused_layer as fl

SMEM_LIMIT = 232448
SMS = 132
# (rows, width of one weight, depth) of each path's projections
VIT_B_TRAIN, VIT_B_SERVE = 192 * 197, 32 * 197
CAIT_S_TRAIN, CAIT_S_SERVE = 128 * 196, 32 * 196
TNT_S_TRAIN, TNT_B_TRAIN = 64 * 197, 32 * 197
CEIT_T_SERVE, CEIT_T_TRAIN = 32 * 197, 64 * 197


@pytest.mark.parametrize('m,n,parts,want', [
    (VIT_B_TRAIN, 768, 3, 256), (VIT_B_TRAIN, 768, 1, 256),
    # 50 row tiles: 150 units of 256 columns would be 1.14 rounds on 132
    # SMs; 200 of 192 fill two
    (VIT_B_SERVE, 768, 3, 192), (VIT_B_SERVE, 768, 1, 192),
    (CAIT_S_TRAIN, 384, 3, 192), (CAIT_S_TRAIN, 384, 1, 192),
    (CAIT_S_SERVE, 384, 3, 128), (CAIT_S_SERVE, 384, 1, 192),
    (TNT_S_TRAIN, 384, 3, 192), (TNT_B_TRAIN, 640, 3, 128),
    (TNT_B_TRAIN, 640, 1, 128),
    # D = 192: no other tile divides it
    (CEIT_T_SERVE, 192, 3, 192), (CEIT_T_SERVE, 192, 1, 192),
    (CEIT_T_TRAIN, 192, 3, 192), (CEIT_T_TRAIN, 576, 3, 192),
    # cait_xxs's D = 192 under K5a at CaiT-S/24's rows
    (CAIT_S_SERVE, 192, 3, 192), (CAIT_S_TRAIN, 192, 1, 192)])
def test_plan_picks_the_tile(m, n, parts, want):
    plan = fl.proj_plan(m, n, parts, n if parts == 1 else 768, SMS)
    assert plan['bn'] == want
    assert n % plan['bn'] == 0


def _units(m, n, parts, bn):
    """The kernel's walk: unit u -> (first row, weight, first column)."""
    per = n // bn
    nt = parts * per
    return [((u // nt) * 128, (u % nt) // per, (u % nt) % per * bn)
            for u in range(-(-m // 128) * nt)]


@pytest.mark.parametrize('m', [1, 129, 591, VIT_B_SERVE, CAIT_S_TRAIN,
                               VIT_B_TRAIN])
@pytest.mark.parametrize('n,parts', [(384, 3), (384, 1), (640, 3), (768, 3),
                                     (768, 1), (192, 3), (192, 1), (576, 3)])
def test_units_cover_every_row_and_column_once(m, n, parts):
    plan = fl.proj_plan(m, n, parts, 384, SMS)
    bn = plan['bn']
    units = _units(m, n, parts, bn)
    assert len(units) == plan['units']
    assert plan['rounds'] == -(-plan['units'] // SMS)
    row_tiles = -(-m // 128)
    assert (row_tiles - 1) * 128 < m <= row_tiles * 128
    # in 64-column strips: each (row tile, weight, strip) exactly once
    seen = np.zeros((row_tiles, parts, n // 64), dtype=np.int64)
    for row0, which, col0 in units:
        assert col0 + bn <= n                  # never across two weights
        seen[row0 // 128, which, col0 // 64:(col0 + bn) // 64] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize('n', [128, 256, 384, 640, 768, 1024])
@pytest.mark.parametrize('m', [1, 6304, 37824])
def test_plan_fits_a_block(m, n):
    for parts in (1, 3):
        plan = fl.proj_plan(m, n, parts, 768, SMS)
        assert plan['bn'] in (128, 192, 256)
        assert 0 < plan['smem'] <= SMEM_LIMIT
        assert plan['steps'] == 768 // 64


@pytest.mark.parametrize('n,k,parts', [(304, 384, 3), (384, 144, 3),
                                       (304, 768, 1), (384, 384, 2),
                                       (384, 384, 0)])
def test_plan_refuses_what_the_kernel_does_not_take(n, k, parts):
    with pytest.raises(ValueError):
        fl.proj_plan(591, n, parts, k, SMS)


@pytest.mark.parametrize('n,k', [(192, 192), (192, 384), (384, 192),
                                 (576, 192), (128, 64)])
def test_plan_takes_192_wide_outputs_and_64_deep_steps(n, k):
    """The widths proj_takes admits since the GEMM's 192-wide tile takes a
    whole output (D = 192): the plan's tile divides N, its steps cover K."""
    assert fl.proj_takes(n, k)
    for m in (1, CEIT_T_SERVE, CEIT_T_TRAIN):
        plan = fl.proj_plan(m, n, 3, k, SMS)
        assert n % plan['bn'] == 0 and plan['steps'] * 64 == k
        assert plan['units'] == -(-m // 128) * 3 * (n // plan['bn'])
    assert not fl.proj_takes(n, k + 32)


def test_plan_refuses_no_rows():
    with pytest.raises(ValueError):
        fl.proj_plan(0, 384, 3, 384, SMS)


@pytest.mark.parametrize('m', [1, 129, 591, 6272, 25088])
@pytest.mark.parametrize('n,k,parts', [(288, 288, 3), (288, 288, 1),
                                       (320, 384, 3), (384, 160, 3),
                                       (96, 288, 3), (288, 96, 1)])
def test_ragged_widths_take_ceiling_tiles(m, n, k, parts):
    """cait_xs's D = H*48 = 288 (and the CPU tests' 96) is no whole tile:
    every tile width is a candidate, a weight takes ceil(N / bn) tiles
    whose last one is ragged and never reaches the next weight, and the
    depth ceil(K / 64) steps, the last one ragged."""
    assert not fl.proj_takes(n, k) and fl.proj_takes_ragged(n, k)
    plan = fl.proj_plan(m, n, parts, k, SMS)
    bn = plan['bn']
    per = -(-n // bn)
    assert plan['units'] == -(-m // 128) * parts * per
    assert plan['steps'] == -(-k // 64) and (plan['steps'] - 1) * 64 < k
    assert 0 < plan['smem'] <= SMEM_LIMIT
    seen = np.zeros((-(-m // 128), parts, n // 32), dtype=np.int64)
    nt = parts * per
    for u in range(plan['units']):
        row0, which, col0 = (u // nt) * 128, (u % nt) // per, (u % nt) % per * bn
        assert col0 < n                        # no unit wholly past the edge
        seen[row0 // 128, which, col0 // 32:min(col0 + bn, n) // 32] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize('m,n,parts,want', [
    (CAIT_S_SERVE, 288, 3, 128), (CAIT_S_SERVE, 288, 1, 192),
    (CAIT_S_TRAIN, 288, 3, 192), (CAIT_S_TRAIN, 288, 1, 192)])
def test_plan_at_cait_xs_rows(m, n, parts, want):
    """The tile K5a's GEMMs take at cait_xs_24 @224 (serving B = 32,
    training B = 128; 288 wide, so every tile is a candidate): at 6272
    rows nine 128-wide tiles a row tile fill 4 rounds (704 column-costs)
    against six 192-wide ones' 3 (720)."""
    assert fl.proj_plan(m, n, parts, 288, SMS)['bn'] == want
