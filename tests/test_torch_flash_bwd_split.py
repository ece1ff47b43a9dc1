"""Torch port: K3, the flash backward past one block (``bwd_split``: K3a +
K3b, ``csrc/flash_bwd_split.cu``), off the card.

The kernels run only on the card; here they are held by what surrounds
them: ``split_plan`` (the Python mirror of the kernels' launch plan, the
way ``fused_bwd_fits`` mirrors K2's shared memory: grid, streamed tiles,
dynamic shared memory) fits a block and covers every row at the lengths
the models use, the wrappers refuse what the kernels do not take, and the
twin ``flash_bwd_plain`` (the function the kernels compute) matches the
JAX package's multi-block ``_dq_kernel``/``_dkv_kernel`` in Pallas
interpret mode at a 1-row ragged tail and with q_len != kv_len.

float32 for the JAX comparisons. Tolerance: max |port - jax| <= 1e-5 *
max(1, max |jax|), i.e. atol 1e-5 on O(1) gradients - the same f32 math
summed in another order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import flash_attention as jax_fa
from sav_tpu_torch.ops import flash_attention

import torch_parity  # noqa: F401  (pins torch to one thread)

TOL = 1e-5
DH = 64
SMEM_LIMIT = 232448         # dynamic shared memory one H100 block may use

# CvT's cross-length attention, queries over the stride-2 key grid:
# cvt-13 @224 (3136/784, 784/196, 225/64) and cvt-w24 @384 (9216/2304,
# 2304/576, 625/169); every one is past K2's 208 rows, so K3's
CVT_LENGTHS = [(3136, 784), (784, 196), (225, 64), (9216, 2304), (2304, 576),
               (625, 169)]
# (q_len, kv_rows): ViT-Ti..L at 32..384 px and CvT's
LENGTHS = [(17, 17), (65, 65), (129, 129), (197, 197),
           (577, 577)] + CVT_LENGTHS


@pytest.mark.parametrize('q_len,kv_rows', LENGTHS)
def test_plan_fits_a_block(q_len, kv_rows):
    plan = flash_attention.split_plan(48, q_len, kv_rows, kv_rows, 12)
    for kernel in ('dq', 'dkv'):
        assert 0 < plan[kernel]['smem'] <= SMEM_LIMIT
    assert plan['threads'] == 384 and plan['stages'] >= 2


@pytest.mark.parametrize('q_len,kv_rows', LENGTHS)
def test_plan_tiles_cover_every_row(q_len, kv_rows):
    """The work tiles over the rows each kernel owns and the 64-row tiles
    each work tile streams are ceilings: every row is in exactly one work
    tile and one streamed tile, and none lies wholly past the rows."""
    batch, heads = 3, 12
    kv_len = kv_rows - 1 if kv_rows > 1 else 1
    plan = flash_attention.split_plan(batch, q_len, kv_rows, kv_len, heads)
    tile = plan['tile_rows']

    def covers(blocks, size, rows):
        starts = [i * size for i in range(blocks)]
        owned = [r for s in starts for r in range(s, min(s + size, rows))]
        return owned == list(range(rows)) and starts[-1] < rows

    dq, dkv = plan['dq'], plan['dkv']
    assert dq['work'][1:] == dkv['work'][1:] == (heads, batch)
    assert covers(dq['work'][0], dq['rows'], q_len)        # dq rows
    assert covers(dq['steps'], tile, kv_len)               # keys K3a reads
    assert covers(dkv['work'][0], dkv['rows'], kv_rows)    # dk/dv rows
    assert covers(dkv['steps'], tile, q_len)               # queries K3b reads


@pytest.mark.parametrize('q_len,kv_rows', CVT_LENGTHS)
def test_plan_at_one_head(q_len, kv_rows):
    """One 64-wide head band (cvt-13's stage 1, H = 1): both kernels walk
    the row tiles of each image in the footprint of any head count, and
    flash_bwd routes every CvT length to K3."""
    plan = flash_attention.split_plan(64, q_len, kv_rows, kv_rows, 1)
    wide = flash_attention.split_plan(64, q_len, kv_rows, kv_rows, 12)
    rows = plan['dq']['rows']
    assert plan['dq']['work'] == (-(-q_len // rows), 1, 64)
    assert plan['dkv']['work'] == (-(-kv_rows // rows), 1, 64)
    for kernel in ('dq', 'dkv'):
        assert plan[kernel]['smem'] == wide[kernel]['smem']
    assert not flash_attention.fused_bwd_fits(q_len, kv_rows)


def _bands(q_len, kv_rows, heads=2, batch=1, dtype=torch.bfloat16):
    q = torch.zeros(batch, q_len, heads * DH, dtype=dtype)
    k = torch.zeros(batch, kv_rows, heads * DH, dtype=dtype)
    lse = torch.zeros(batch, heads, q_len)
    return q, k, lse


def _refusals():
    q, k, lse = _bands(130, 130)
    q32, k32, _ = _bands(130, 130, dtype=torch.float32)
    odd = torch.zeros(1, 130, 2 * DH + 8, dtype=torch.bfloat16)
    strided = torch.zeros(1, 130, 4 * DH, dtype=torch.bfloat16)[..., ::2]
    return {
        'float32': ((q32, k32, k32, q32, lse, q32, 2, 130), 'bfloat16'),
        'head_dim': ((odd, odd, odd, odd, lse, odd, 2, 130), 'head_dim'),
        'strided': ((strided, k, k, q, lse, q, 2, 130), 'contiguous'),
        'kv_len_0': ((q, k, k, q, lse, q, 2, 0), 'kv_len'),
        'kv_len_past': ((q, k, k, q, lse, q, 2, 131), 'kv_len'),
        'lse_shape': ((q, k, k, q, lse[:, :, :-1].contiguous(), q, 2, 130),
                      'lse'),
        'lse_dtype': ((q, k, k, q, lse.double(), q, 2, 130), 'lse'),
        'kv_shape': ((q, k, k[:, :, :DH].contiguous(), q, lse, q, 2, 130),
                     'k/v'),
        'cpu': ((q, k, k, q, lse, q, 2, 130), 'card'),
    }


@pytest.mark.parametrize('case', sorted(_refusals()))
def test_split_wrappers_refuse(case):
    """bwd_split, bwd_dq and bwd_dkv raise before anything is launched on
    what K3 does not take, and on CPU tensors (flash_bwd runs the twin
    there; a CPU tensor never reaches a kernel)."""
    (q, k, v, out, lse, do, heads, kv_len), match = _refusals()[case]
    with pytest.raises(ValueError, match=match):
        flash_attention.bwd_split(q, k, v, out, lse, do, heads, kv_len)
    with pytest.raises(ValueError, match=match):
        flash_attention.bwd_dq(q, k, v, out, lse, do, heads, kv_len)
    with pytest.raises(ValueError, match=match):
        flash_attention.bwd_dkv(q, k, v, do, lse, lse.clone(), heads, kv_len)


@pytest.mark.parametrize('bad', ['shape', 'dtype'])
def test_dkv_refuses_a_delta_it_cannot_read(bad):
    q, k, lse = _bands(130, 130)
    delta = (lse[:, :1].contiguous() if bad == 'shape'
             else lse.to(torch.float16))
    with pytest.raises(ValueError, match='delta'):
        flash_attention.bwd_dkv(q, k, k, q, lse, delta, 2, 130)


@pytest.mark.parametrize('args', [(0, 1, 1, 1, 1), (1, 5, 4, 5, 1),
                                  (1, 5, 5, 0, 1), (2 ** 16, 5, 5, 5, 2 ** 15)])
def test_plan_refuses_lengths_the_kernels_do_not_take(args):
    with pytest.raises(ValueError):
        flash_attention.split_plan(*args)


def _inputs(b, q_len, kv_rows, heads, seed):
    rng = np.random.RandomState(seed)
    q = (rng.standard_normal((b, q_len, heads * DH)) * 0.5).astype(np.float32)
    k, v = (rng.standard_normal((b, kv_rows, heads * DH)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, q_len, heads * DH)).astype(np.float32)
    return q, k, v, do


def _pad(a, rows):
    return np.pad(a, ((0, 0), (0, rows - a.shape[1]), (0, 0)))


@functools.lru_cache(maxsize=None)
def _jax_split(b, q_len, kv_rows, kv_len, heads, q_pad, kv_pad, seed):
    """(out, lse, dq, dk, dv) of the JAX kernels on rows zero-padded to
    ``q_pad``/``kv_pad`` in 64 x 64 blocks (the cotangent is zero on the
    padded query rows, as ``_flash_bwd`` makes it), cut back; asserts the
    multi-block route (K3) was taken."""
    q, k, v, do = _inputs(b, q_len, kv_rows, heads, seed)
    q, do = (jnp.asarray(_pad(a, q_pad)) for a in (q, do))
    k, v = (jnp.asarray(_pad(a, kv_pad)) for a in (k, v))
    bq, bk = jax_fa._bwd_blocks(q_pad, kv_pad, 64, 64, heads, DH)
    assert (q_pad // bq) * (kv_pad // bk) > 1       # _dq_kernel/_dkv_kernel
    out, lse = jax_fa._fwd(q, k, v, heads=heads, block_q=64, block_k=64,
                           kv_len=kv_len)
    dq, dk, dv = jax_fa._bwd(q, k, v, out, lse, do, heads=heads, block_q=64,
                             block_k=64, kv_len=kv_len)
    cut = lambda a, n: np.asarray(a)[:, :n]
    return (cut(out, q_len), np.asarray(lse)[:, :, :q_len, 0],
            cut(dq, q_len), cut(dk, kv_len), cut(dv, kv_len))


def assert_close(ours, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(ours), want, atol=TOL * scale,
                               rtol=0)


@pytest.mark.parametrize('b,q_len,kv_rows,kv_len,heads,q_pad,kv_pad', [
    # L = 129 = 2 x 64 + 1: a 1-row last tile on both sides
    (1, 129, 129, 129, 2, 192, 192),
    # q_len != kv_len: 300 queries over 100 key rows, the last 10 masked
    (1, 300, 100, 90, 2, 320, 128),
])
def test_twin_matches_jax_split_kernels(b, q_len, kv_rows, kv_len, heads,
                                        q_pad, kv_pad):
    out, lse, dq, dk, dv = _jax_split(b, q_len, kv_rows, kv_len, heads, q_pad,
                                      kv_pad, 7)
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(b, q_len, kv_rows, heads, 7))
    ours = flash_attention.flash_bwd(
        q, k, v, torch.from_numpy(out.copy()), torch.from_numpy(lse.copy()),
        do, heads, kv_len)
    assert [tuple(g.shape) for g in ours] == [
        tuple(q.shape), tuple(k.shape), tuple(v.shape)]
    assert_close(ours[0].numpy(), dq)
    for o, ref in zip(ours[1:], (dk, dv)):
        assert_close(o[:, :kv_len].numpy(), ref)
        assert not o[:, kv_len:].any()         # masked keys get exact zeros
