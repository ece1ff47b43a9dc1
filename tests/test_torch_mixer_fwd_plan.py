"""Torch port: the token-mixing forward's launch plan and algebra on the CPU
(``csrc/mixer_token.cu`` + ``csrc/mixer_bwd_sm90.cuh``, K8a; the kernels
run only on the card, ``tests/test_torch_cuda.py``).

* ``mixer_fwd_plan``, the Python mirror of the C entry
  ``sav_mixer_fwd_plan``: every (image, 64-channel band) unit is taken by
  exactly one warpgroup of the persistent blocks; the route follows the
  Hopper kernel's widths ((200, 112) and (56, 32); past them, or past 1024
  channels, an ``mma.sync`` block per (128-channel band, image)); the
  Hopper kernel's shared memory fits a block at every ``mixer_*`` factory
  config at 224 and matches its layout (W1 and W2 resident, two x tiles a
  warpgroup); the refusals of ``sav_mixer_fwd`` hold.
* ``kernel_algebra``, a test-only torch mirror of the Hopper route's
  channel-major chain: per (image, band) unit y^T normalised with the row
  statistics by token and the LN parameters by channel, hp^T = y^T W1 +
  b1, bf16(gelu), out^T = gact^T W2, + b2, + x. float32, at B = 5, L = 24
  and 13, K = 12 and 6, D = 128. Held against ``token_mix_fwd_plain`` at
  1e-5 of the sublayer's own part (the same f32 arithmetic in another
  order) and against the JAX package's ``_fwd_kernel`` in Pallas interpret
  mode (images per block 2, so its padding path runs) at 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import mixer_token as jax_mt
from sav_tpu_torch.ops import mixer_token as mt
from sav_tpu_torch.ops.fused_layer import LN_EPS, _gelu_fwd_t

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
    return [list(range(2 * i + w, plan['units'], 2 * plan['ctas']))
            for i in range(plan['ctas']) for w in range(2)]


@pytest.mark.parametrize('l,k,d', FACTORY)
@pytest.mark.parametrize('batch', [192, 65, 32, 1])
def test_plan_takes_every_unit_once(batch, l, k, d):
    plan = mt.mixer_fwd_plan(batch, l, k, d)
    assert plan['route'] in (1, 2)
    assert plan['units'] == batch * d // mt.BWD_BAND
    taken = _units_of_warpgroups(plan)
    flat = sorted(u for units in taken for u in units)
    assert flat == list(range(plan['units']))
    assert max(len(units) for units in taken) == plan['units_per_wg']
    assert plan['ctas'] <= 132


@pytest.mark.parametrize('l,k,d', FACTORY)
def test_plan_shared_memory_fits_and_matches_the_layout(l, k, d):
    plan = mt.mixer_fwd_plan(192, l, k, d)
    ln, kp = plan['widths']
    assert ln >= l and kp >= k and ln % 8 == 0 and kp % 16 == 0
    lp = -(-ln // 16) * 16
    chunks = -(-lp // 64)
    weights = 2 * chunks * kp * 128             # W1 and W2, 64-token chunks
    tiles = 2 * 2 * lp * 128                    # two x tiles a warpgroup
    assert plan['smem'] == (weights + tiles + 2 * 2 * lp * 4 + lp * 4
                            + kp * 4 + 4 * 8 + 1024)
    assert plan['smem'] <= SMEM_LIMIT


def test_plan_routes_by_the_hopper_widths():
    assert mt.mixer_fwd_plan(2, 196, 98, 768)['widths'] == (200, 112)
    assert mt.mixer_fwd_plan(2, 49, 24, 512)['widths'] == (56, 32)
    assert mt.mixer_fwd_plan(2, 56, 32, 128)['route'] == 1
    assert mt.mixer_fwd_plan(2, 57, 32, 128)['route'] == 2
    assert mt.mixer_fwd_plan(2, 200, 112, 128)['route'] == 2
    for l, k, d in ((208, 16, 128), (196, 120, 128), (196, 98, 1152)):
        mma = mt.mixer_fwd_plan(2, l, k, d)
        assert mma['route'] == 0 and mma['widths'] == (0, 0)
        assert mma['units'] == mma['ctas'] == 2 * d // mt.FWD_BAND
        assert mma['units_per_wg'] == 1
        assert mma['smem'] == mt._fwd_band_smem(l, k)
    assert mt.mixer_fwd_plan(2, 208, 16, 128)['smem'] <= SMEM_LIMIT


@pytest.mark.parametrize('batch,l,k,d', [(0, 196, 98, 768), (2, 0, 98, 768),
                                         (2, 196, 0, 768), (2, 196, 98, 200)])
def test_plan_refuses_what_the_kernels_do_not_take(batch, l, k, d):
    with pytest.raises(ValueError):
        mt.mixer_fwd_plan(batch, l, k, d)


def test_plan_matches_the_backward_route():
    """K8a and K8b take the same route at every factory shape, so a Mixer
    never mixes the Hopper forward with the mma.sync backward."""
    for l, k, d in FACTORY + [(208, 16, 128), (13, 6, 128)]:
        assert mt.mixer_fwd_plan(3, l, k, d)['route'] == \
            mt.mixer_bwd_plan(3, l, k, d)['route']


def kernel_algebra(x, ls, lb, w1, b1, w2, b2, eps=LN_EPS):
    """The Hopper route's forward arithmetic in torch (test only), unit by
    unit; float32."""
    batch, l, d = x.shape
    band = mt.BWD_BAND
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) - mu * mu + eps)
    out = torch.empty_like(xf)
    for b in range(batch):
        for j in range(d // band):                 # one warpgroup's unit
            cs = slice(j * band, (j + 1) * band)
            yt = ((xf[b, :, cs] - mu[b]) * inv[b] * ls[cs] + lb[cs]).t()
            hp = yt @ w1 + b1                      # [64, K]
            gact = _gelu_fwd_t(hp)[0]
            ot = gact @ w2                         # [64, L]
            out[b, :, cs] = xf[b, :, cs] + (ot + b2).t()
    return out


def _args(l, k, d, seed):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [mk(B, l, d), 1 + 0.1 * mk(d), 0.1 * mk(d), 0.05 * mk(l, k),
            0.1 * mk(k), 0.05 * mk(k, l), 0.1 * mk(l)]


def _rel_own(got, want, x):
    """max |got - want| over max |want - x|: the sublayer's own part."""
    got, want, x = (np.asarray(a, np.float64) for a in (got, want, x))
    return np.abs(got - want).max() / (np.abs(want - x).max() + 1e-12)


@pytest.mark.parametrize('l,k,d', SHAPES)
def test_kernel_algebra_matches_twin(l, k, d):
    args = [torch.from_numpy(a) for a in _args(l, k, d, l)]
    got = kernel_algebra(*args)
    want = mt.token_mix_fwd_plain(*args)
    assert got.shape == want.shape
    assert _rel_own(got, want, args[0]) <= TWIN_TOL


@pytest.fixture
def ni2(monkeypatch):
    monkeypatch.setattr(jax_mt, '_NI', 2)


@pytest.mark.parametrize('l,k,d', SHAPES)
def test_kernel_algebra_matches_jax_kernel(ni2, l, k, d):
    args = _args(l, k, d, l + 1)
    want = jax.jit(jax_mt.token_mix_sublayer)(*map(jnp.asarray, args))
    got = kernel_algebra(*[torch.from_numpy(a) for a in args])
    assert _rel_own(got.numpy(), np.asarray(want), args[0]) <= JAX_TOL
