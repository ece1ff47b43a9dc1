"""Torch port: the TNT inner layer's backward (K7b, ``csrc/tnt_inner.cu``)
on the CPU: its launch plan and the order of its weight-gradient sums (the
kernel runs only on the card, ``tests/test_torch_cuda.py``).

* ``tnt_bwd_plan``, the Python mirror of ``plan_bwd`` /
  ``sav_tnt_bwd_plan``: the weights, the block's f32 partial of the four
  weight gradients and the warps' working sets fit a block's 232,448 bytes
  at TNT-S's and TNT-B's inner widths; the rounds take every patch once;
  the partial's layout covers each gradient and the column sums once, in
  the output's order; the workspace is one partial a block, so it stops
  growing with the patches once every SM has a block; the refusals hold.
* ``inner_layer_bwd_blocked``, the torch mirror of K7b's accumulation
  order (per-block partials over rounds of patches, then the partials in
  block order), against ``inner_layer_bwd_plain`` at 1e-5 of each
  gradient's max (the same f32 products summed in another order), on the
  SM counts 1, 3 and 132 (one block, several, more blocks than rounds),
  and against the JAX package's jnp twin ``inner_layer_reference`` at 16
  pixel tokens a patch (the K7 port's only length) at the JAX module's
  own test's 5e-4 of each gradient's max. float32, TNT-S's and TNT-B's
  inner widths (D = 24 and 40, H = 4, F = 4 D).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import tnt_inner as jax_ti
from sav_tpu_torch.ops import tnt_inner

import torch_parity  # noqa: F401  (pins torch to one thread)

SMEM_LIMIT = 232448
H = 4
WIDTHS = [24, 40]                       # TNT-S's and TNT-B's inner D
TRAIN = [(64 * 196, 24), (32 * 196, 40)]
NAMES = ('dx', 'dln1s', 'dln1b', 'dwq', 'dwk', 'dwv', 'dwo', 'dln2s',
         'dln2b', 'dw1', 'db1', 'dw2', 'db2')


@pytest.mark.parametrize('n', [1, 5, 1001, 32 * 196, 64 * 196, 256 * 196])
@pytest.mark.parametrize('d', WIDTHS)
def test_plan_fits_a_block(n, d):
    plan = tnt_inner.tnt_bwd_plan(n, d, 4 * d, H)
    assert 1 <= plan['warps'] <= tnt_inner.BWD_MAX_WARPS
    assert plan['smem'] <= SMEM_LIMIT
    assert plan['blocks'] == min(-(-n // plan['warps']), 132)


def test_plan_takes_the_resident_layout_where_it_leaves_enough_warps():
    """TNT-S's inner width keeps all of F's FF operands and the softmax
    rows a patch at 8 warps a block; at TNT-B's that layout leaves 3, so
    the F-tiled one takes it at 4; a shape past the tiled layout's
    accumulator (Dp > 64) takes the resident one or none."""
    s = tnt_inner.tnt_bwd_plan(64 * 196, 24, 96, H)
    b = tnt_inner.tnt_bwd_plan(32 * 196, 40, 160, H)
    assert (s['tiled'], s['warps']) == (False, 8)
    assert (b['tiled'], b['warps']) == (True, 4)
    assert not tnt_inner.tnt_bwd_plan(5, 16, 64, 2)['tiled']
    assert tnt_inner.tnt_bwd_plan(5, 48, 192, H)['tiled']


@pytest.mark.parametrize('n', [1, 7, 1001, 32 * 196])
@pytest.mark.parametrize('sms', [1, 3, 132])
def test_rounds_take_every_patch_once(n, sms):
    """Block i's warp w takes patch (r blocks + i) warps + w in round r,
    while that is below n."""
    plan = tnt_inner.tnt_bwd_plan(n, 24, 96, H, sms)
    warps, blocks = plan['warps'], plan['blocks']
    taken = []
    for i in range(blocks):
        base = i * warps
        while base < n:
            taken += [base + w for w in range(min(warps, n - base))]
            base += blocks * warps
    assert sorted(taken) == list(range(n))


@pytest.mark.parametrize('d', WIDTHS)
def test_partial_layout_covers_each_gradient_once(d):
    f = 4 * d
    plan = tnt_inner.tnt_bwd_plan(1000, d, f, H)
    lay = plan['layout']
    sizes = dict(dwqkv=3 * d * d, dwo=d * d, dw1=d * f, dw2=f * d,
                 vec=5 * d + f)
    at = 0
    for name in ('dwqkv', 'dwo', 'dw1', 'dw2', 'vec'):
        assert lay[name] == (at, sizes[name]), name
        at += sizes[name]
    assert at == plan['part_floats']


@pytest.mark.parametrize('d', WIDTHS)
def test_workspace_grows_with_blocks_not_rows(d):
    f = 4 * d
    plans = [tnt_inner.tnt_bwd_plan(n, d, f, H) for n in
             (32 * 196, 64 * 196, 256 * 196, 1024 * 196)]
    assert len({p['workspace'] for p in plans}) == 1
    for p in plans:
        assert p['workspace'] == p['blocks'] * p['part_floats'] * 4
    # a tenth of the operand rows the parent wrote at the training
    # shapes, 2 (7 D + 2 F) bytes a row: 144.5 MB at TNT-S bs64
    rows = 64 * 196 * 16
    assert plans[1]['workspace'] < rows * 2 * (7 * d + 2 * f) / 10


@pytest.mark.parametrize('n,d,f,h,sms', [(0, 24, 96, 4, 132),
                                         (5, 12, 48, 4, 132),
                                         (5, 24, 100, 4, 132),
                                         (5, 24, 96, 5, 132),
                                         (5, 24, 96, 4, 0),
                                         (5, 256, 1024, 4, 132)])
def test_plan_refuses_what_the_kernel_does_not_take(n, d, f, h, sms):
    with pytest.raises(ValueError):
        tnt_inner.tnt_bwd_plan(n, d, f, h, sms)


def _args(n, d, seed):
    rng = np.random.RandomState(seed)
    hd, f = d // H, 4 * d
    mk = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    return [0.5 * rng.standard_normal((n, 16, d)).astype(np.float32),
            1 + 0.1 * mk(d), 0.1 * mk(d), mk(d, H, hd), mk(d, H, hd),
            mk(d, H, hd), mk(H, hd, d), 1 + 0.05 * mk(d), 0.05 * mk(d),
            0.5 * mk(d, f), 0.1 * mk(f), 0.5 * mk(f, d), 0.1 * mk(d)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


@pytest.mark.parametrize('sms', [1, 3, 132])
@pytest.mark.parametrize('d', WIDTHS)
def test_blocked_order_matches_twin(d, sms):
    n = 29
    args = [torch.from_numpy(a) for a in _args(n, d, d + sms)]
    g = torch.from_numpy(np.random.RandomState(sms).standard_normal(
        (n, 16, d)).astype(np.float32))
    got = tnt_inner.inner_layer_bwd_blocked(*args, g, H, sms=sms)
    want = tnt_inner.inner_layer_bwd_plain(*args, g, H)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        assert _rel(a.numpy(), b.numpy()) <= 1e-5, (name, _rel(a, b))


@pytest.mark.parametrize('d', WIDTHS)
def test_blocked_order_matches_jax_twin(d):
    n = 10
    args = _args(n, d, 7)
    f = lambda *a: jax_ti.inner_layer_reference(*a, num_heads=H)
    out, vjp = jax.vjp(f, *map(jnp.asarray, args))
    want = jax.jit(vjp)(2 * out)
    targs = [torch.from_numpy(a) for a in args]
    g = torch.from_numpy(2 * np.asarray(out))
    got = tnt_inner.inner_layer_bwd_blocked(*targs, g, H, sms=2)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == tuple(b.shape), name
        assert _rel(a.numpy(), b) <= 5e-4, (name, _rel(a.numpy(), b))
