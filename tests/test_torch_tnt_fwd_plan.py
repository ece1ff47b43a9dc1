"""Torch port: the TNT inner layer's forward (K7a, ``csrc/tnt_inner.cu``) on
the CPU: its launch plan and the algebra of its 4-patch units (the kernel
runs only on the card, ``tests/test_torch_cuda.py``).

* ``tnt_fwd_plan``, the Python mirror of ``plan_fwd`` /
  ``sav_tnt_fwd_plan``: at TNT-S's and TNT-B's inner widths the Hopper
  kernel (route 1) with 4 and 3 warpgroups a block within 232,448 bytes,
  its layout's regions 1024-byte aligned, units of 4 patches that the
  warpgroups take once each; every other width the parent's ``supported``
  took runs the warp-a-patch kernel (route 0) with the parent's shared
  memory, and nothing the parent took is refused.
* ``_unit_mirror``, a test-only torch mirror of one unit's algebra: 4
  patches (64 rows) a unit, the last unit zero-filled past B*P (TMA's
  fill) and its extra rows dropped; both LayerNorms' statistics summed in
  the kernel's order (lane t of a row's quad over its columns 8i + 2t,
  8i + 2t + 1, then the quad by xor 1 and xor 2); y, o, y2 and gelu(hp)
  rounded to x's dtype where the kernel rounds them (gelu as W2's A
  operand); the softmax by exp2. Held against ``inner_layer_fwd_plain``
  in float32 at 1e-5 of max |twin - x| (the same arithmetic summed in
  another order) and in bfloat16 at 2e-2 of it (the card's tolerance,
  chip_smoke.OUT_TOL: f32 ulps flip single bf16 roundings), and against
  the JAX package's ``_fwd_kernel`` in interpret mode (``inner_layer``)
  in float32 at the JAX module's own test's 3e-5. D = 24 and 40 (TNT-S,
  TNT-B), H = 4, F = 4 D, B*P = 5 and 9 (a last unit of 1 patch), inputs
  from a fixed numpy seed.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sav_tpu.ops import tnt_inner as jax_ti
from sav_tpu_torch.ops import tnt_inner
from sav_tpu_torch.ops.fused_layer import LN_EPS

import torch_parity  # noqa: F401  (pins torch to one thread)

SMEM_LIMIT = 232448
H = 4
UNIT = 4                                # patches a unit: 64 rows
LOG2E = 1.4426950408889634


@pytest.mark.parametrize('n', [1, 5, 1001, 32 * 196, 64 * 196])
@pytest.mark.parametrize('d,wgs', [(24, 4), (40, 3)])
def test_plan_takes_the_hopper_kernel_at_tnt_widths(n, d, wgs):
    plan = tnt_inner.tnt_fwd_plan(n, d, 4 * d, H)
    lay = tnt_inner.hop_layout(d, 4 * d)
    assert plan['route'] == 1 and plan['wgs'] == wgs
    assert plan['units'] == -(-n // UNIT)
    assert plan['blocks'] == min(-(-plan['units'] // wgs), 132)
    assert plan['smem'] == (lay['weights'] + wgs * lay['per_wg']
                            + wgs * 2 * 8 + 1024)
    assert plan['smem'] <= SMEM_LIMIT
    # a fourth warpgroup at TNT-B would not fit
    if d == 40:
        assert plan['smem'] + lay['per_wg'] + 16 > SMEM_LIMIT


@pytest.mark.parametrize('d', [24, 40])
def test_layout_regions(d):
    """The weights as K-major 128-byte-swizzled tiles (Wqkv^T 3 Dp rows,
    Wo^T Dp, W1^T F, W2^T ceil(F / 64) boxes of Dp rows, 128 bytes a row),
    every wgmma tile and per-warpgroup region 1024-byte aligned."""
    f, dp = 4 * d, -(-d // 16) * 16
    lay = tnt_inner.hop_layout(d, f)
    assert lay['dp'] == dp
    assert (lay['wo'], lay['w1'], lay['w2']) == (
        3 * dp * 128, 4 * dp * 128, 4 * dp * 128 + f * 128)
    assert lay['vec'] == lay['w2'] + -(-f // 64) * dp * 128
    assert lay['weights'] >= lay['vec'] + (5 * dp + f) * 4
    for key in ('wo', 'w1', 'w2', 'weights', 'xtile', 'qkv', 'otile',
                'per_wg'):
        assert lay[key] % 1024 == 0, key
    assert lay['xtile'] >= 64 * d * 2                    # an x tile
    assert lay['qkv'] >= 4 * 3 * 16 * (d + 2) * 4        # q, k, v a warp
    assert lay['qkv'] >= 64 * d * 2                      # out staged there
    assert lay['otile'] >= 4 * 16 * (dp + 8) * 2


@pytest.mark.parametrize('n', [1, 2, 3, 4, 6273, 12546, 6275])
@pytest.mark.parametrize('d', [24, 40])
def test_units_take_every_patch_once(n, d):
    """Warpgroup w of block b takes units b wgs + w, + blocks wgs, ...;
    unit u holds patches 4u .. 4u + 3 below B*P (the last one 1-4)."""
    plan = tnt_inner.tnt_fwd_plan(n, d, 4 * d, H)
    stride = plan['blocks'] * plan['wgs']
    taken = []
    for first in range(stride):
        for u in range(first, plan['units'], stride):
            taken += [p for p in range(UNIT * u, UNIT * u + UNIT) if p < n]
    assert sorted(taken) == list(range(n))
    assert n - UNIT * (plan['units'] - 1) == (n - 1) % UNIT + 1


def _parent_fwd_warps(d, f, h):
    """The parent's warp-a-patch K7a at every width: its warps a block
    (``fwd_warps``, at most 8), 0 where one warp does not fit."""
    dp = -(-d // 16) * 16
    up16 = lambda v: -(-v // 16) * 16
    ldy, ldq, ldf = dp + 8, 3 * dp + 8, f + 8
    weights = (up16(2 * (dp * ldq + dp * ldy + dp * ldf + f * ldy))
               + up16(4 * (5 * d + f)))
    per = (up16(16 * d * 4) + 2 * up16(16 * ldy * 2) + 128
           + up16(max(3 * 16 * dp * 4, 16 * ldf * 2)))
    if d // h > 128 or weights + per > SMEM_LIMIT:
        return 0, weights, per
    return min(8, (SMEM_LIMIT - weights) // per), weights, per


def _parent_takes(d, f, h):
    """The parent's ``supported`` on the card: the structural rules, its
    forward's warps and its backward's plan (unchanged)."""
    if d % 8 or d % h or f % 16:
        return False
    try:
        tnt_inner.tnt_bwd_plan(1, d, f, h)
    except ValueError:
        return False
    return _parent_fwd_warps(d, f, h)[0] > 0


SWEEP = [(d, f, h) for d in range(8, 161, 8) for h in (1, 2, 4, 8)
         for f in sorted({2 * d, 4 * d, 16, 96, 160}) if d % h == 0
         and f % 16 == 0]


def test_every_width_the_parent_took_has_a_route():
    taken = 0
    for d, f, h in SWEEP:
        parent = _parent_takes(d, f, h)
        assert tnt_inner.supported(16, d, h, f, device='cuda') == parent, \
            (d, f, h)
        if not parent:
            continue
        taken += 1
        plan = tnt_inner.tnt_fwd_plan(1000, d, f, h)
        assert plan['smem'] <= SMEM_LIMIT
        if (d, f, h) in tnt_inner.HOP_WGS:
            assert plan['route'] == 1
        else:
            warps, weights, per = _parent_fwd_warps(d, f, h)
            assert (plan['route'], plan['wgs'], plan['blocks']) == (0, warps, 0)
            assert plan['smem'] == weights + warps * per
    assert taken > 100


@pytest.mark.parametrize('n,d,f,h', [(0, 24, 96, 4), (5, 12, 48, 4),
                                     (5, 24, 100, 4), (5, 24, 96, 5)])
def test_plan_refuses_what_the_kernel_does_not_take(n, d, f, h):
    with pytest.raises(ValueError):
        tnt_inner.tnt_fwd_plan(n, d, f, h)


# ---- the unit's algebra

def _quad_sums(v, dp):
    """Row sums of v [rows, Dp] in the kernel's order: lane t of the row's
    quad adds its columns 8i + 2t, 8i + 2t + 1 (i < Dp / 8) in turn, the
    quad adds by xor 1 and then xor 2: (s0 + s1) + (s2 + s3)."""
    parts = []
    for t in range(4):
        s = torch.zeros(v.shape[0], dtype=torch.float32)
        for i in range(dp // 8):
            for j in range(2):
                s = s + v[:, 8 * i + 2 * t + j]
        parts.append(s)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _ln(v, scale, bias, d, eps, cdt):
    """y = LN(v) rounded to cdt, the statistics as the kernel forms them
    (the fast variance, f32)."""
    dp = -(-d // 16) * 16
    vp = F.pad(v, (0, dp - d))
    mu = _quad_sums(vp, dp) / d
    inv = torch.rsqrt(torch.clamp(_quad_sums(vp * vp, dp) / d - mu * mu,
                                  min=0.0) + eps)
    return ((v - mu[:, None]) * inv[:, None] * scale + bias).to(cdt).float()


def _unit_mirror(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2, b2,
                 num_heads, eps=LN_EPS):
    """The Hopper K7a's algebra on [B*P, 16, D]: units of 4 patches (64
    rows), the last one zero-filled past B*P, its rows past B*P dropped."""
    n, l, d = x.shape
    cdt = x.dtype
    hd = d // num_heads
    units = -(-n // UNIT)
    xu = torch.zeros(units * UNIT, l, d, dtype=cdt)
    xu[:n] = x
    rows = xu.reshape(-1, d).float()
    cast = lambda w, *s: w.reshape(*s).to(cdt).float()
    y = _ln(rows, ln1s, ln1b, d, eps, cdt)
    heads = lambda t: t.reshape(units * UNIT, l, num_heads, hd)
    q = heads((y @ cast(wq, d, d)) * (1.0 / math.sqrt(hd)))
    k, v = heads(y @ cast(wk, d, d)), heads(y @ cast(wv, d, d))
    s = torch.einsum('nqhc,nphc->nhqp', q, k)
    e = torch.exp2(s * LOG2E - s.amax(-1, keepdim=True) * LOG2E)
    o = torch.einsum('nhqp,nphc->nqhc', e, v) * (1.0 / e.sum(-1)).permute(
        0, 2, 1)[..., None]
    ob = o.reshape(-1, d).to(cdt).float()
    x2 = rows + ob @ cast(wo, d, d)
    y2 = _ln(x2, ln2s, ln2b, d, eps, cdt)
    hp = y2 @ cast(w1, d, -1) + b1
    gact = (0.5 * hp * (1.0 + torch.tanh(
        0.7978845608028654 * (hp + 0.044715 * hp * hp * hp)))).to(cdt).float()
    out = ((x2 + gact @ cast(w2, -1, d)) + b2).to(cdt)
    return out.reshape(units * UNIT, l, d)[:n]


def _args(n, d, seed):
    rng = np.random.RandomState(seed)
    hd, f = d // H, 4 * d
    mk = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    return [0.5 * rng.standard_normal((n, 16, d)).astype(np.float32),
            1 + 0.1 * mk(d), 0.1 * mk(d), 2 * mk(d, H, hd), mk(d, H, hd),
            mk(d, H, hd), mk(H, hd, d), 1 + 0.05 * mk(d), 0.05 * mk(d),
            0.5 * mk(d, f), 0.1 * mk(f), 0.5 * mk(f, d), 0.1 * mk(d)]


def _rel_to_layer(got, want, x):
    """max |got - want| over max |want - x|: the layer's own part."""
    got, want, x = (np.asarray(t, np.float64) for t in (got, want, x))
    return np.abs(got - want).max() / np.abs(want - x).max()


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('n', [5, 9])
@pytest.mark.parametrize('d', [24, 40])
def test_unit_mirror_matches_twin(d, n, dtype, tol):
    args = [torch.from_numpy(a) for a in _args(n, d, n + d)]
    args[0] = args[0].to(dtype)
    got = _unit_mirror(*args, H)
    want = tnt_inner.inner_layer_fwd_plain(*args, H)
    assert got.shape == want.shape and got.dtype == want.dtype
    x = args[0].float().numpy()
    assert _rel_to_layer(got.float().numpy(), want.float().numpy(), x) <= tol


@pytest.mark.parametrize('d', [24, 40])
def test_last_unit_zero_fill_leaves_the_patches(d):
    """Units are independent: the patches of a ragged last unit come out
    as they do in a full one."""
    args = [torch.from_numpy(a) for a in _args(8, d, d)]
    full = _unit_mirror(*args, H)
    ragged = _unit_mirror(args[0][:5], *args[1:], H)
    assert torch.isfinite(full).all()
    assert torch.equal(full[:5], ragged)


@pytest.mark.parametrize('n,d', [(5, 24), (9, 40)])
def test_unit_mirror_matches_jax_kernel(n, d):
    """Against the JAX package's K7a (``_fwd_kernel`` in interpret mode,
    through ``inner_layer``) at its own test's float32 tolerance."""
    args = _args(n, d, 11 * d + n)
    want = np.asarray(jax_ti.inner_layer(*map(jnp.asarray, args), H))
    got = _unit_mirror(*map(torch.from_numpy, args), H).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)
