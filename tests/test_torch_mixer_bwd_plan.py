"""Torch port: the token-mixing backward's launch plan and algebra on the CPU
(``csrc/mixer_token.cu`` + ``csrc/mixer_bwd_sm90.cuh``, K8b; the kernels run
only on the card, ``tests/test_torch_cuda.py``).

* ``mixer_bwd_plan``, the Python mirror of the C entry
  ``sav_mixer_bwd_plan``: every (image, 64-channel band) unit is taken by
  exactly one warpgroup of the persistent blocks; the Hopper band kernel's
  shared memory fits a block for every ``mixer_*`` factory config at 224;
  the workspace holds what the kernels write, each region apart from the
  others (at B = 192, 65 and 1); shapes past the Hopper widths (L > 200, K
  > 112, D > 1024) take the ``mma.sync`` band kernel.
* ``kernel_algebra``, a test-only torch mirror of the Hopper route's
  channel-major chain: per (image, band) unit hp^T, dgact^T, gelu', dhp,
  db1's partial a warp (16 channels), dy^T, the image's dscale and dbias
  over the band's tokens, db2's partial a band; the LN row pass (the row
  sums over all D, dx); the weight gradients as one partial a chunk of
  images; every partial summed in a fixed order. float32, at B = 5, L = 24
  and 13, K = 12 and 6, D = 128 (the second shape odd, neither a multiple
  of 8). Held against ``token_mix_bwd_plain`` at 1e-5 of each gradient's
  max (the same f32 arithmetic summed in another order) and against the
  JAX package's ``_bwd_kernel`` in Pallas interpret mode (images per block
  2, so its padding path runs, as ``tests/test_torch_mixer_token.py``
  sets it) at that test's 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import mixer_token as jax_mt
from sav_tpu_torch.ops import mixer_token as mt
from sav_tpu_torch.ops.fused_layer import (LN_EPS, _gelu_bwd_from_t,
                                           _gelu_fwd_t, _layernorm)

import torch_parity  # noqa: F401  (pins torch to one thread)

SMEM_LIMIT = 232448
TWIN_TOL = 1e-5
JAX_TOL = 5e-5
B = 5
SHAPES = [(24, 12, 128), (13, 6, 128)]
FACTORY = [(l, k, d) for l, k in ((49, 24), (196, 98))
           for d in (512, 768, 1024)]


def _units_of_warpgroups(plan):
    """Units in the order the blocks' warpgroups take them: warpgroup w of
    block i takes 2 i + w, + 2 ctas, ..."""
    taken = []
    for i in range(plan['ctas']):
        for w in range(2):
            taken.append(list(range(2 * i + w, plan['units'], 2 * plan['ctas'])))
    return taken


@pytest.mark.parametrize('l,k,d', FACTORY)
@pytest.mark.parametrize('batch', [192, 65, 1])
def test_plan_takes_every_unit_once(batch, l, k, d):
    plan = mt.mixer_bwd_plan(batch, l, k, d)
    assert plan['route'] in (1, 2)
    assert plan['units'] == batch * d // mt.BWD_BAND
    taken = _units_of_warpgroups(plan)
    flat = sorted(u for wg in taken for u in wg)
    assert flat == list(range(plan['units']))
    assert max(len(wg) for wg in taken) == plan['units_per_wg']
    assert plan['ctas'] <= 132
    ln, kp = plan['widths']
    assert l <= ln and k <= kp
    assert 0 < plan['smem'] <= SMEM_LIMIT


@pytest.mark.parametrize('batch', [192, 65, 1])
def test_plan_workspace_holds_what_the_kernels_write(batch):
    l, k, d = 196, 98, 768
    plan = mt.mixer_bwd_plan(batch, l, k, d)
    bands, bl, bk = d // mt.BWD_BAND, batch * l, batch * k
    chunks = plan['chunks']
    assert (chunks - 1) * plan['per_chunk'] < batch <= chunks * plan['per_chunk']
    want = {'stats': bl * 2 * 4, 'y': bl * d * 2, 'gact': bk * d * 2,
            'dh': bk * d * 2, 'dy': bl * d * 4, 'rows': bl * bands * 2 * 4,
            'db1': bk * bands * 4 * 4, 'db2': bl * bands * 4,
            'dls': batch * d * 4, 'dlb': batch * d * 4,
            'w1': chunks * l * k * 4, 'w2': chunks * k * l * 4}
    assert {n: v[1] for n, v in plan['scratch'].items()} == want
    spans = sorted(plan['scratch'].values())
    for (a, na), (b, _) in zip(spans, spans[1:]):
        assert a % 256 == 0 and a + na <= b
    assert spans[-1][0] + spans[-1][1] <= plan['workspace']


def test_plan_routes_past_the_hopper_widths_to_the_mma_kernel():
    assert mt.mixer_bwd_plan(2, 208, 16, 128)['route'] == 0
    assert mt.mixer_bwd_plan(2, 196, 120, 128)['route'] == 0
    assert mt.mixer_bwd_plan(2, 196, 98, 1152)['route'] == 0
    assert mt.mixer_bwd_plan(2, 56, 32, 128)['route'] == 1
    assert mt.mixer_bwd_plan(2, 57, 32, 128)['route'] == 2
    mma = mt.mixer_bwd_plan(2, 208, 16, 128)
    assert mma['ctas'] == mma['units'] and mma['units_per_wg'] == 1
    assert mma['smem'] == mt._band_bwd_smem(208, 16) <= SMEM_LIMIT


@pytest.mark.parametrize('batch,l,k,d', [(0, 196, 98, 768), (2, 0, 98, 768),
                                         (2, 196, 0, 768), (2, 196, 98, 200)])
def test_plan_refuses_what_the_kernels_do_not_take(batch, l, k, d):
    with pytest.raises(ValueError):
        mt.mixer_bwd_plan(batch, l, k, d)


def _tree_sum(parts):
    """sum_columns' order: 256 strided running sums, then a halving tree."""
    lanes = torch.zeros(256, *parts.shape[1:])
    for q in range(parts.shape[0]):
        lanes[q % 256] += parts[q]
    w = 128
    while w:
        lanes[:w] += lanes[w:2 * w]
        w //= 2
    return lanes[0]


def kernel_algebra(x, ls, lb, w1, b1, w2, b2, g, eps=LN_EPS):
    """The Hopper route's arithmetic in torch (test only): (dx, dls, dlb,
    dw1, db1, dw2, db2) like ``token_mix_bwd_plain``; float32."""
    batch, l, d = x.shape
    k = w1.shape[1]
    plan = mt.mixer_bwd_plan(batch, l, k, d)
    band = mt.BWD_BAND
    bands = d // band
    y, xhat, inv = _layernorm(x, ls, lb, eps)
    db1p = torch.zeros(batch, bands, 4, k)
    db2p = torch.zeros(batch, bands, l)
    dlsp, dlbp = torch.zeros(batch, d), torch.zeros(batch, d)
    dy = torch.zeros(batch, l, d)
    gact = torch.zeros(batch, k, d)
    dhb = torch.zeros(batch, k, d)
    for b in range(batch):
        for j in range(bands):                       # one warpgroup's unit
            cs = slice(j * band, (j + 1) * band)
            hp = y[b, :, cs].t() @ w1 + b1           # [64, K]
            dg = g[b, :, cs].t() @ w2.t()
            ga, t = _gelu_fwd_t(hp)
            dhp = dg * _gelu_bwd_from_t(hp, t)
            gact[b, :, cs], dhb[b, :, cs] = ga.t(), dhp.t()
            db1p[b, j] = dhp.reshape(4, 16, k).sum(dim=1)   # a warp's 16
            dyt = dhp @ w1.t()                       # [64, L]
            dy[b, :, cs] = dyt.t()
            dlsp[b, cs] = (dyt * xhat[b, :, cs].t()).sum(dim=1)
            dlbp[b, cs] = dyt.sum(dim=1)
            db2p[b, j] = g[b, :, cs].sum(dim=1)
    dxhat = dy * ls                                  # the LN row pass
    m1 = dxhat.sum(dim=-1, keepdim=True) / d
    m2 = (dxhat * xhat).sum(dim=-1, keepdim=True) / d
    dx = g + inv * (dxhat - m1 - xhat * m2)
    per = plan['per_chunk']                          # the dW GEMM's chunks
    dw1 = torch.zeros(l, k)
    dw2 = torch.zeros(k, l)
    for c in range(plan['chunks']):
        imgs = slice(c * per, min((c + 1) * per, batch))
        dw1 += torch.einsum('bld,bkd->lk', y[imgs], dhb[imgs])
        dw2 += torch.einsum('bkd,bld->kl', gact[imgs], g[imgs])
    return (dx, dlsp.sum(dim=0), dlbp.sum(dim=0), dw1,
            _tree_sum(db1p.reshape(-1, k)), dw2,
            _tree_sum(db2p.reshape(-1, l)))


def _args(l, k, d, seed):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [mk(B, l, d), 1 + 0.1 * mk(d), 0.1 * mk(d), 0.05 * mk(l, k),
            0.1 * mk(k), 0.05 * mk(k, l), 0.1 * mk(l)], mk(B, l, d)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


@pytest.mark.parametrize('l,k,d', SHAPES)
def test_kernel_algebra_matches_twin(l, k, d):
    args, g = _args(l, k, d, l)
    targs = [torch.from_numpy(a) for a in args]
    got = kernel_algebra(*targs, torch.from_numpy(g))
    want = mt.token_mix_bwd_plain(*targs, torch.from_numpy(g))
    for name, a, b in zip(('dx', 'dls', 'dlb', 'dw1', 'db1', 'dw2', 'db2'),
                          got, want):
        assert a.shape == b.shape, name
        assert _rel(a.numpy(), b.numpy()) <= TWIN_TOL, (name, _rel(a, b))


@pytest.fixture
def ni2(monkeypatch):
    monkeypatch.setattr(jax_mt, '_NI', 2)


@pytest.mark.parametrize('l,k,d', SHAPES)
def test_kernel_algebra_matches_jax_kernel(ni2, l, k, d):
    args, g = _args(l, k, d, l + 1)
    _, vjp = jax.vjp(jax_mt.token_mix_sublayer, *map(jnp.asarray, args))
    want = jax.jit(vjp)(jnp.asarray(g))
    targs = [torch.from_numpy(a) for a in args]
    got = kernel_algebra(*targs, torch.from_numpy(g))
    for name, a, b in zip(('dx', 'dls', 'dlb', 'dw1', 'db1', 'dw2', 'db2'),
                          got, want):
        assert _rel(a.numpy(), np.asarray(b)) <= JAX_TOL, name
