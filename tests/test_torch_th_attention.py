"""Torch port: ``ops.th_attention.th_attention_sublayer`` (the talking-heads
span) against ``sav_tpu.ops.th_attention`` from the same numpy inputs, in
float32: the JAX span in Pallas interpret mode (the fused kernel K5 at
L = 37, the q-blocked kernel K6 at ``TestBlockedCore``'s L = 400) and its
jnp twin ``th_sublayer_reference``, for each of the port's routes (on the
CPU each route runs its kernels' plain twins), forward and all nine
gradients; identity mixes against plain attention; the router.

Tolerances, the JAX package's own kernel-vs-twin bounds
(tests/test_th_attention.py): forward atol 2e-5; each gradient within
5e-4 of its max |grad|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import th_attention as jax_th
from sav_tpu_torch.ops import attention as attention_ops
from sav_tpu_torch.ops import th_attention as th

import torch_parity  # noqa: F401  (pins torch to one thread)

FWD_TOL = 2e-5
GRAD_TOL = 5e-4
NAMES = ('x', 'scale', 'bias', 'wq', 'wk', 'wv', 'wo', 'm_pre', 'm_post')
SMALL = (2, 37, 64, 4)          # B, L, D, H: d = 16, off the kernels' 48
BLOCKED = (2, 400, 64, 8)       # the JAX package's blocked-core shape, d = 8


def _inputs(shape, seed):
    b, l, dim, heads = shape
    d = dim // heads
    rng = np.random.RandomState(seed)
    mk = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    ins = (mk(b, l, dim), 1.0 + 0.1 * mk(dim), 0.1 * mk(dim),
           mk(dim, heads, d, std=dim ** -0.5), mk(dim, heads, d, std=dim ** -0.5),
           mk(dim, heads, d, std=dim ** -0.5), mk(heads, d, dim, std=dim ** -0.5),
           np.eye(heads, dtype=np.float32) + 0.2 * mk(heads, heads),
           np.eye(heads, dtype=np.float32) + 0.2 * mk(heads, heads))
    return ins, mk(b, l, dim, std=1.0 / np.sqrt(l))        # cotangent


@functools.lru_cache(maxsize=None)
def _jax(shape, fn, residual=False, seed=0):
    """(out, nine gradients) of the JAX span ('kernel') or its twin."""
    ins, g = _inputs(shape, seed)
    heads = shape[3]
    if fn == 'kernel':
        f = lambda *a: jax_th.th_attention_sublayer(*a, heads, jax_th.LN_EPS,
                                                    residual)
    else:
        f = lambda *a: jax_th.th_sublayer_reference(*a, residual=residual)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in ins))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]


@functools.lru_cache(maxsize=None)
def _port(shape, route, residual=False, seed=0):
    ins, g = _inputs(shape, seed)
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    out = th.th_attention_sublayer(*ts, shape[3], th.LN_EPS, residual, route)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    return out.detach().numpy(), [t.numpy() for t in grads]


def _check(port, want):
    np.testing.assert_allclose(port[0], want[0], atol=FWD_TOL, rtol=0)
    for name, ours, ref in zip(NAMES, port[1], want[1]):
        assert ours.shape == ref.shape, name
        err = np.abs(ours.astype(np.float64) - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_jax_routes_at_these_shapes():
    """The JAX side of each comparison: K5 at L = 37, K6 at L = 400."""
    assert jax_th.th_mode(37, 4, 16) == 'fused'
    assert jax_th.th_mode(400, 8, 8) == 'blocked'


@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('jax_fn', ['kernel', 'reference'])
@pytest.mark.parametrize('route', th.ROUTES)
def test_span_matches_jax(route, jax_fn, residual):
    _check(_port(SMALL, route, residual), _jax(SMALL, jax_fn, residual))


@pytest.mark.parametrize('jax_fn', ['kernel', 'reference'])
@pytest.mark.parametrize('route', th.ROUTES)
def test_span_matches_jax_blocked_shape(route, jax_fn):
    _check(_port(BLOCKED, route, seed=3), _jax(BLOCKED, jax_fn, seed=3))


def test_reference_twin_matches_jax_reference():
    ins, _ = _inputs(SMALL, 1)
    want = jax_th.th_sublayer_reference(*(jnp.asarray(a) for a in ins))
    ours = th.th_sublayer_reference(*(torch.from_numpy(a) for a in ins))
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=0)


@pytest.mark.parametrize('route', th.ROUTES)
def test_identity_mixes_reduce_to_plain_attention(route):
    """With identity transforms the span is plain multi-head attention."""
    ins, _ = _inputs(SMALL, 2)
    x, scale, bias, wq, wk, wv, wo = (torch.from_numpy(a) for a in ins[:7])
    eye = torch.eye(SMALL[3])
    with torch.no_grad():
        got = th.th_attention_sublayer(x, scale, bias, wq, wk, wv, wo, eye,
                                       eye, SMALL[3], th.LN_EPS, False, route)
        y = th._layernorm(x, scale, bias, th.LN_EPS)[0]
        proj = lambda w: torch.einsum('bld,dhc->blhc', y, w)
        o = attention_ops.multi_head_attention(proj(wq), proj(wk), proj(wv),
                                               use_kernel=False)
        want = torch.einsum('bqhc,hcd->bqd', o, wo)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_TOL, rtol=0)


def test_grad_off_call_matches_the_differentiable_one():
    ins, _ = _inputs(SMALL, 0)
    with torch.no_grad():
        out = th.th_attention_sublayer(*(torch.from_numpy(a) for a in ins),
                                       SMALL[3], th.LN_EPS, False, 'fused')
    np.testing.assert_array_equal(out.numpy(), _port(SMALL, 'fused')[0])


def test_core_twins_agree_with_each_other():
    """K5a's twin is LN + projections + K6a's twin + out-projection, and the
    residuals it returns feed the backward twin."""
    rng = np.random.RandomState(5)
    b, l, dim, heads = 2, 21, 32, 4
    x = torch.from_numpy(rng.standard_normal((b, l, dim)).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal(s) / np.sqrt(dim)).astype(
        np.float32)) for s in ((dim, dim),) * 4]
    m = [torch.eye(heads) + 0.1 * torch.from_numpy(
        rng.standard_normal((heads, heads)).astype(np.float32)) for _ in range(2)]
    scale, bias = torch.ones(dim), torch.zeros(dim)
    out, (q, k, v, attn, lse) = th.th_attention_fwd(
        x, scale, bias, *ws, *m, heads, save_residuals=True)
    attn2, lse2 = th.th_core_fwd(q, k, v, *m, heads)
    torch.testing.assert_close(attn, attn2, atol=0, rtol=0)
    torch.testing.assert_close(lse, lse2, atol=0, rtol=0)
    torch.testing.assert_close(out, attn @ ws[3], atol=1e-6, rtol=0)
    do = torch.ones_like(q)
    for a, c in zip(th.th_attention_bwd(q, k, v, do, lse, *m, heads),
                    th.th_core_bwd(q, k, v, do, lse, *m, heads)):
        torch.testing.assert_close(a, c, atol=0, rtol=0)


@pytest.mark.parametrize('l,heads,dim,want', [
    (196, 4, 192, 'fused'),         # cait_xxs: D = 192, one 192-wide tile
    (576, 4, 192, 'fused'),
    (196, 6, 288, 'fused'),         # cait_xs: D = 288, a ragged last tile
    (576, 6, 288, 'fused'),
    (196, 4, 194, 'blocked'),       # D not a multiple of 32: K5a's GEMMs
    (196, 16, 768, 'fused'),        # cait_m: K5 (D = 768 is K1's tile)
    (196, 8, 512, None),            # head_ch 64, not 48
])
def test_router_on_the_card(l, heads, dim, want):
    """The card's routes, decided by the plans' Python mirrors without a
    kernel library (the card tests hold the mirrors equal to the kernels);
    a head geometry the kernels are not built for raises there."""
    assert th.th_route(l, heads, dim // heads, dim, 'cpu') is None
    if want is None:
        with pytest.raises(NotImplementedError, match='use_kernel=False'):
            th.th_route(l, heads, dim // heads, dim, 'cuda')
    else:
        assert th.th_route(l, heads, dim // heads, dim, 'cuda') == want


@pytest.mark.parametrize('l,heads,dim,want', [
    (196, 8, 384, True), (576, 8, 384, True), (196, 4, 192, True),
    (196, 6, 288, True), (196, 16, 768, True), (196, 4, 194, False),
    (196, 12, 576, False)])
def test_fused_fits_off_the_card(l, heads, dim, want):
    """Off the card K5a's twin has no shared-memory budget: only the
    projection GEMM's widths (multiples of 32) and the built head counts
    decide."""
    assert th.fused_fits(l, heads, dim, 'cpu') is want


def test_routes_and_devices_are_checked():
    ins, _ = _inputs(SMALL, 0)
    ts = [torch.from_numpy(a) for a in ins]
    with pytest.raises(ValueError, match='route'):
        th.th_attention_sublayer(*ts, 4, th.LN_EPS, False, 'flash')
    meta = [t.to('meta') for t in ts]
    flat = [w.reshape(64, 64) for w in meta[3:7]]
    with pytest.raises(ValueError, match='cuda or cpu'):
        th.th_attention_fwd(*meta[:3], *flat, *meta[7:], 4)
    bands = [torch.zeros(1, 8, 96, device='meta')] * 3
    with pytest.raises(ValueError, match='cuda or cpu'):
        th.th_core_fwd(*bands, meta[7], meta[8], 2)
