"""Torch port: K4 (the flash forward, ``csrc/flash_fwd_sm90.cuh``, also K1's
attention launch) and K2 (the one-launch flash backward,
``csrc/flash_bwd.cu``) on wgmma and TMA, off the card.

The kernels run only on the card; here they are held by what surrounds
them: ``fwd_plan`` and ``fused_bwd_plan`` (the Python mirrors of the
kernels' launch plans: work tiles, streamed tiles, resident rows, dynamic
shared memory) fit a block and cover every query and key row at the
lengths the models use, and the launches ``fwd_kernel`` and ``bwd_fused``
refuse what the kernels do not take, with ValueError before anything is
launched. The twins they are held against on the card are compared with
the JAX package's kernels in ``test_torch_flash_attention.py`` and
``test_torch_flash_backward.py``.
"""

import pytest
import torch

from sav_tpu_torch.ops import flash_attention as fa

SMEM_LIMIT = 232448         # dynamic shared memory one H100 block may use
DH = 64

# CvT's cross-length attention, queries over the stride-2 key grid:
# cvt-13 @224 (3136/784, 784/196, 225/64) and cvt-w24 @384 (9216/2304,
# 2304/576, 625/169); stage 3's query grid is the padded 15 x 15 or 25 x 25
CVT_LENGTHS = [(3136, 784, 784), (784, 196, 196), (225, 64, 64),
               (9216, 2304, 2304), (2304, 576, 576), (625, 169, 169)]
# (q_len, kv_rows, kv_len): ViT-Ti..L at 32..384 px (17, 65, 197, 577), a
# 1-row tail past two tiles (129), a masked key tail (200 over 190 keys),
# and CvT's
LENGTHS = [(17, 17, 17), (65, 65, 65), (129, 129, 129), (197, 197, 197),
           (200, 200, 190), (577, 577, 577)] + CVT_LENGTHS


def _covers(starts_sizes, rows):
    """The tiles [start, start + size) hold every row below ``rows`` once,
    and none starts at or past it."""
    owned = [r for s, n in starts_sizes for r in range(s, min(s + n, rows))]
    return owned == list(range(rows)) and all(s < rows
                                              for s, _ in starts_sizes)


def _streamed(rows, wide):
    """The tiles a kernel streams over ``rows``: ``wide`` of 64, then one of
    16 if rows remain."""
    tiles = [(64 * i, 64) for i in range(wide)]
    if 64 * wide < rows:
        tiles.append((64 * wide, 16))
    return tiles


@pytest.mark.parametrize('q_len,kv_rows,kv_len', LENGTHS)
def test_fwd_plan_fits_a_block(q_len, kv_rows, kv_len):
    plan = fa.fwd_plan(48, q_len, kv_rows, kv_len, 12)
    assert 0 < plan['smem'] <= SMEM_LIMIT
    assert plan['threads'] == 384 and plan['stages'] >= 2


@pytest.mark.parametrize('q_len,kv_rows,kv_len', LENGTHS)
def test_fwd_plan_covers_every_row(q_len, kv_rows, kv_len):
    """Work tiles own every query row once; the key tiles each streams (64
    rows, a last one of 16) hold every unmasked key once."""
    plan = fa.fwd_plan(3, q_len, kv_rows, kv_len, 12)
    assert plan['work'][1:] == (12, 3)
    rows = plan['rows']
    assert _covers([(rows * i, rows) for i in range(plan['work'][0])], q_len)
    tiles = _streamed(kv_len, plan['wide'])
    assert len(tiles) == plan['steps']
    assert _covers(tiles, kv_len)
    assert all(n == 64 for _, n in tiles[:-1])      # only the last is short


@pytest.mark.parametrize('q_len,kv_rows,kv_len', CVT_LENGTHS)
def test_fwd_plan_at_one_head(q_len, kv_rows, kv_len):
    """One 64-wide head band (cvt-13's stage 1, H = 1): the work tiles walk
    the query tiles of each image, every row covered, in the same
    footprint."""
    plan = fa.fwd_plan(32, q_len, kv_rows, kv_len, 1)
    assert plan['work'] == (-(-q_len // plan['rows']), 1, 32)
    assert plan['smem'] == fa.fwd_plan(32, q_len, kv_rows, kv_len, 12)['smem']
    assert _covers([(plan['rows'] * i, plan['rows'])
                    for i in range(plan['work'][0])], q_len)
    assert _covers(_streamed(kv_len, plan['wide']), kv_len)


@pytest.mark.parametrize('q_len,kv_rows,kv_len', LENGTHS)
def test_fused_bwd_plan_fits_or_refuses(q_len, kv_rows, kv_len):
    """K2 takes every head of up to 208 rows in one fixed footprint under
    the block's limit, and refuses longer ones (K3's)."""
    if max(q_len, kv_rows) <= fa.K2_MAX_ROWS:
        plan = fa.fused_bwd_plan(192, q_len, kv_rows, kv_len, 12)
        assert 0 < plan['smem'] <= SMEM_LIMIT
        assert plan['items'] == 192 * 12 and plan['threads'] == 384
        assert fa.fused_bwd_fits(q_len, kv_rows)
    else:
        with pytest.raises(ValueError, match='208'):
            fa.fused_bwd_plan(192, q_len, kv_rows, kv_len, 12)
        assert not fa.fused_bwd_fits(q_len, kv_rows)


@pytest.mark.parametrize('q_len,kv_rows,kv_len',
                         [c for c in LENGTHS if max(c[:2]) <= 208])
def test_fused_bwd_plan_covers_every_row(q_len, kv_rows, kv_len):
    """Phase A's key tiles own every dk/dv row once and its query chunks (64
    wide, a last one of 16) hold every query once, within the rows Q and dO
    load; phase B's 64-query chunks own every dq row once and its 16-key
    steps cover every unmasked key, within the rows K loads; the resident
    rows fit the 208 the kernel's shared memory holds."""
    plan = fa.fused_bwd_plan(2, q_len, kv_rows, kv_len, 12)
    chunks = _streamed(q_len, plan['q_wide'])
    assert len(chunks) == plan['q_chunks']
    assert _covers(chunks, q_len)
    assert chunks[-1][0] + chunks[-1][1] <= plan['q_cover'] <= fa.K2_MAX_ROWS
    assert _covers([(64 * i, 64) for i in range(plan['key_tiles'])], kv_rows)
    assert _covers([(64 * i, 64) for i in range(plan['q_chunks'])], q_len)
    assert _covers([(16 * i, 16) for i in range(plan['ds_rows'] // 16)],
                   kv_len)
    assert plan['ds_rows'] <= plan['kv_cover'] <= fa.K2_MAX_ROWS
    assert plan['kv_cover'] >= kv_rows and plan['q_cover'] >= q_len


@pytest.mark.parametrize('args', [(0, 1, 1, 1, 1), (1, 5, 4, 5, 1),
                                  (1, 5, 5, 0, 1), (1, 5, 5, 5, 0),
                                  (2 ** 16, 5, 5, 5, 2 ** 15)])
def test_fwd_plan_refuses_lengths_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        fa.fwd_plan(*args)


def _bands(q_len, kv_rows, heads=2, dtype=torch.bfloat16):
    q = torch.zeros(1, q_len, heads * DH, dtype=dtype)
    k = torch.zeros(1, kv_rows, heads * DH, dtype=dtype)
    return q, k, torch.zeros(1, heads, q_len)


def _refusals():
    """(q, k, v, heads, kv_len) of each launch the kernels refuse, and the
    message; the backward adds out = do = q and lse."""
    q, k, _ = _bands(130, 130)
    q32, k32, _ = _bands(130, 130, dtype=torch.float32)
    odd = torch.zeros(1, 130, 2 * DH + 8, dtype=torch.bfloat16)
    strided = torch.zeros(1, 130, 4 * DH, dtype=torch.bfloat16)[..., ::2]
    meta = torch.empty(1, 130, 2 * DH, dtype=torch.bfloat16, device='meta')
    return {
        'float32': ((q32, k32, k32, 2, 130), 'bfloat16'),
        'head_dim': ((odd, odd, odd, 2, 130), 'head_dim'),
        'strided': ((strided, k, k, 2, 130), 'contiguous'),
        'kv_len_0': ((q, k, k, 2, 0), 'kv_len'),
        'kv_len_past': ((q, k, k, 2, 131), 'kv_len'),
        'kv_shape': ((q, k, k[:, :, :DH].contiguous(), 2, 130), 'k/v'),
        'other_device': ((q, meta, meta, 2, 130), 'meta'),
        'cpu': ((q, k, k, 2, 130), 'card'),
    }


@pytest.mark.parametrize('case', sorted(_refusals()))
def test_fwd_kernel_refuses(case):
    (q, k, v, heads, kv_len), match = _refusals()[case]
    with pytest.raises(ValueError, match=match):
        fa.fwd_kernel(q, k, v, heads, kv_len)


@pytest.mark.parametrize('case', sorted(_refusals()))
def test_bwd_fused_refuses(case):
    (q, k, v, heads, kv_len), match = _refusals()[case]
    lse = torch.zeros(1, heads, q.shape[1])
    with pytest.raises(ValueError, match=match):
        fa.bwd_fused(q, k, v, q, lse, q, heads, kv_len)


def test_bwd_fused_refuses_a_head_past_208_rows():
    """Past 208 rows K2 raises; it never hands the launch to K3."""
    q, k, lse = _bands(209, 209)
    with pytest.raises(ValueError, match='208'):
        fa.bwd_fused(q, k, k, q, lse, q, 2, 209)


def test_flash_bwd_routes_by_the_threshold():
    """flash_bwd's rule: K2 up to K2_MAX_ROWS query and key rows (all it
    holds, the measured threshold), K3 past them."""
    limit = fa.K2_MAX_ROWS
    assert fa.fused_bwd_fits(limit, limit)
    assert not fa.fused_bwd_fits(limit + 1, limit)
    assert not fa.fused_bwd_fits(limit, limit + 1)
    assert fa.fused_bwd_fits(17, 17)
    assert not fa.fused_bwd_fits(577, 577) and not fa.fused_bwd_fits(3136, 784)
