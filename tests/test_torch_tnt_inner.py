"""Torch port: the TNT inner layer (``ops.tnt_inner``) against
``sav_tpu.ops.tnt_inner``. The JAX kernel runs as its own tests run it, in
interpret mode with 128 patches a block (``_NB``), so B*P = 10 takes its
zero-patch padding path; its unrolled per-token loops grow with L^2, so it
runs at 8 and 4 pixel tokens (seconds), and the 16-token shape of both TNT
configs is held against the JAX jnp twin ``inner_layer_reference``. The port
runs its plain twins of K7a/K7b here (CPU tensors). Also K1's twin without
the residual (the 'fused' core of TNT's outer sublayer) against the JAX
sublayer in interpret mode, forward and its seven gradients.

float32. Tolerances, the JAX module's own test's (tests/test_tnt_inner.py):
the forward 3e-5, each of the 13 gradients 5e-4 of its max; the sublayer
1e-5 * max(1, max |jax|) as in test_torch_sublayer_grad.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import fused_layer as jax_fl
from sav_tpu.ops import tnt_inner as jax_ti
from sav_tpu_torch.ops import fused_layer, tnt_inner

import torch_parity  # noqa: F401  (pins torch to one thread)

H = 4
NAMES = ('x', 'ln1s', 'ln1b', 'wq', 'wk', 'wv', 'wo', 'ln2s', 'ln2b', 'w1',
         'b1', 'w2', 'b2')


def _args(bp, l, d, seed=0):
    rng = np.random.RandomState(seed)
    hd, ff = d // H, 4 * d
    mk = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    return [0.5 * rng.standard_normal((bp, l, d)).astype(np.float32),
            1 + 0.1 * mk(d), 0.1 * mk(d), mk(d, H, hd), mk(d, H, hd),
            mk(d, H, hd), mk(H, hd, d), 1 + 0.05 * mk(d), 0.05 * mk(d),
            0.5 * mk(d, ff), 0.1 * mk(ff), 0.5 * mk(ff, d), 0.1 * mk(d)]


@functools.lru_cache(maxsize=None)
def _jax(fn_name, bp, l, d):
    """(out, 13 gradients of sum(out^2)) of the JAX function ``fn_name``;
    the kernel in interpret mode with 128 patches a block."""
    old, jax_ti._NB = jax_ti._NB, 128
    try:
        fn = getattr(jax_ti, fn_name)
        args = [jnp.asarray(a) for a in _args(bp, l, d)]
        f = lambda *a: fn(*a, num_heads=H) if fn_name.endswith(
            'reference') else fn(*a, H)
        out, vjp = jax.vjp(f, *args)
        grads = jax.jit(vjp)(2 * out)
        return np.asarray(out), [np.asarray(g) for g in grads]
    finally:
        jax_ti._NB = old


def _port(fn, bp, l, d):
    ts = [torch.from_numpy(a).requires_grad_() for a in _args(bp, l, d)]
    out = fn(*ts, H)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _check(port, want):
    np.testing.assert_allclose(port[0], want[0], atol=3e-5, rtol=3e-5)
    for name, got, ref in zip(NAMES, port[1], want[1]):
        assert got.shape == ref.shape, name
        got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
        err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12)
        assert err < 5e-4, (name, err)


@pytest.mark.parametrize('fn', [tnt_inner.inner_layer,
                                tnt_inner.inner_layer_reference])
@pytest.mark.parametrize('bp,l,d', [(10, 8, 24), (10, 4, 40)])
def test_matches_the_jax_kernel(fn, bp, l, d):
    """The Function on the twins (forward and closed-form backward) and
    the port's reference (autograd) against the Pallas kernel's
    custom_vjp, B*P = 10 not a multiple of its 128-patch block."""
    _check(_port(fn, bp, l, d), _jax('inner_layer', bp, l, d))


@pytest.mark.parametrize('fn', [tnt_inner.inner_layer,
                                tnt_inner.inner_layer_reference])
@pytest.mark.parametrize('bp,d', [(10, 24), (3, 40)])
def test_matches_the_jax_reference_at_16_tokens(fn, bp, d):
    _check(_port(fn, bp, 16, d), _jax('inner_layer_reference', bp, 16, d))


def test_backward_twin_returns_the_13_gradients():
    ts = [torch.from_numpy(a) for a in _args(3, 16, 24, seed=1)]
    g = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (3, 16, 24)).astype(np.float32))
    grads = tnt_inner.inner_layer_bwd(*ts, g, H)
    assert [tuple(t.shape) for t in grads] == [tuple(t.shape) for t in ts]
    assert all(t.dtype == torch.float32 for t in grads)
    with torch.no_grad():
        out = tnt_inner.inner_layer(*ts, H)
    assert out.grad_fn is None and out.shape == ts[0].shape


def test_supported_shapes():
    # off the card the structural rules bind; the shared-memory budget, read
    # from the kernel's own formula, is held on the card (test_torch_cuda)
    assert tnt_inner.supported(16, 24, 4, device='cpu')        # TNT-S inner
    assert tnt_inner.supported(16, 40, 4, device='cpu')        # TNT-B inner
    assert tnt_inner.supported(16, 128, 4, device='cpu')       # no d <= 64
    assert not tnt_inner.supported(8, 24, 4, device='cpu')     # one m16 tile
    assert not tnt_inner.supported(16, 25, 5, device='cpu')    # D % 8
    assert not tnt_inner.supported(16, 24, 5, device='cpu')    # D % H
    assert not tnt_inner.supported(16, 24, 4, hidden=100, device='cpu')


def test_auto_route_refuses_on_the_card(monkeypatch):
    """'auto' takes the kernels on the card and the per-op path off it; on
    the card a shape the kernels do not take raises and points to
    use_kernel=False. The forward's launch plan (the kernel's shared-memory
    formula) is stood in for by one that D = 40 exceeds."""
    real = tnt_inner.tnt_fwd_plan

    def plan(n, d, hidden, heads, sms=132):
        if d >= 32:
            raise ValueError('past shared memory')
        return real(n, d, hidden, heads, sms)

    monkeypatch.setattr(tnt_inner, 'tnt_fwd_plan', plan)
    assert tnt_inner.auto_route(16, 24, 4, 96, 'cuda')
    assert not tnt_inner.auto_route(16, 40, 4, 160, 'cpu')
    with pytest.raises(NotImplementedError,
                       match='shared memory.*use_kernel=False'):
        tnt_inner.auto_route(16, 40, 4, 160, 'cuda')
    with pytest.raises(NotImplementedError, match='16 pixel tokens'):
        tnt_inner.auto_route(4, 24, 4, 96, 'cuda')


def test_cpu_wrappers_take_the_plain_twins_only_for_cpu_tensors():
    meta = [torch.from_numpy(a).to('meta') for a in _args(2, 16, 24)]
    with pytest.raises(ValueError, match='cuda or cpu'):
        tnt_inner.inner_layer_fwd(*meta, H)
    with pytest.raises(ValueError, match='cuda or cpu'):
        tnt_inner.inner_layer_bwd(*meta, meta[0], H)


# ------------------------------------------- K1 without the residual

B, D, HO = 2, 128, 2


@pytest.mark.parametrize('l', [17, 197])
def test_fused_core_without_residual_matches_jax(l):
    """``attention_sublayer(core='fused', residual=False)``: the port's K1
    twin and its Function's backward against the JAX sublayer on its
    'fused' core (K1, then K2, in interpret mode), out and the gradients
    of x, LN scale/bias and the four kernels."""
    rng = np.random.RandomState(l)
    mk = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    dh = D // HO
    ins = (mk(B, l, D), 1.0 + 0.1 * mk(D), 0.1 * mk(D),
           mk(D, HO, dh, std=D ** -0.5), mk(D, HO, dh, std=D ** -0.5),
           mk(D, HO, dh, std=D ** -0.5), mk(HO, dh, D, std=D ** -0.5))
    g = mk(B, l, D, std=1.0 / np.sqrt(l))
    fn = lambda *a: jax_fl.attention_sublayer(*a, HO, 'fused', jax_fl.LN_EPS,
                                              False)
    want, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in ins))
    want_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    out = fused_layer.attention_sublayer(*ts, HO, 'fused', fused_layer.LN_EPS,
                                         False)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    pairs = [('out', out.detach(), want)] + list(zip(
        ('dx', 'dscale', 'dbias', 'dwq', 'dwk', 'dwv', 'dwo'), grads,
        want_grads))
    for name, ours, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   err_msg=name)
    # the twin itself: the residual-free output plus x is the residual one
    x = ts[0].detach()
    ws = [t.detach().reshape(D, D) for t in ts[3:]]
    with torch.no_grad():
        no_res = fused_layer.fused_attention_fwd(
            x, ts[1].detach(), ts[2].detach(), *ws, HO, residual=False)
        res = fused_layer.fused_attention_fwd(x, ts[1].detach(),
                                              ts[2].detach(), *ws, HO)
    np.testing.assert_allclose((no_res + x).numpy(), res.numpy(), atol=1e-5,
                               rtol=0)
