"""Torch port: gradients of ``ops.fused_layer.attention_sublayer`` in all
seven inputs, for each core, against ``jax.vjp`` of
``sav_tpu.ops.fused_layer.attention_sublayer`` with core 'fused' (Pallas
interpret mode: K1 with residuals, then K2) and 'xla'; rotary and
``residual=False`` on the cores that take them; and the K1 training
variant's residuals against the Pallas kernel's.

float32. Tolerance: max |port - jax| <= 1e-5 * max(1, max |jax|) per
tensor (atol 1e-5 on O(1) gradients; the weight gradients sum B*L rows).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import fused_layer as jax_fl
from sav_tpu_torch.ops import fused_layer

import torch_parity  # noqa: F401  (pins torch to one thread)

B, D, H = 2, 128, 2
DH = D // H
TOL = 1e-5
NAMES = ('x', 'scale', 'bias', 'wq', 'wk', 'wv', 'wo')


def assert_close(ours, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(ours), want, atol=TOL * scale,
                               rtol=0, err_msg=what)


def _inputs(l, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    ins = (mk(B, l, D), 1.0 + 0.1 * mk(D), 0.1 * mk(D),
           mk(D, H, DH, std=D ** -0.5), mk(D, H, DH, std=D ** -0.5),
           mk(D, H, DH, std=D ** -0.5), mk(H, DH, D, std=D ** -0.5))
    return ins, mk(B, l, D, std=1.0 / np.sqrt(l))      # cotangent


@functools.lru_cache(maxsize=None)
def _jax_grads(l, core, rotary=False, residual=True):
    ins, g = _inputs(l)
    fn = lambda *a: jax_fl.attention_sublayer(*a, H, core, jax_fl.LN_EPS,
                                              residual, rotary)
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in ins))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]


@functools.lru_cache(maxsize=None)
def _port_grads(l, core, rotary=False, residual=True):
    ins, g = _inputs(l)
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    out = fused_layer.attention_sublayer(*ts, H, core, fused_layer.LN_EPS,
                                         residual, rotary)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    return out.detach().numpy(), [t.numpy() for t in grads]


def _check(port, want):
    assert_close(port[0], want[0], 'out')
    for name, ours, ref in zip(NAMES, port[1], want[1]):
        assert ours.shape == ref.shape, name
        assert_close(ours, ref, f'd{name}')


@pytest.mark.parametrize('l', [17, 65, 197])
@pytest.mark.parametrize('jax_core', ['fused', 'xla'])
@pytest.mark.parametrize('core', fused_layer.CORES)
def test_sublayer_gradients_match_jax(core, jax_core, l):
    _check(_port_grads(l, core), _jax_grads(l, jax_core))


@pytest.mark.parametrize('core', ['xla', 'flash'])
def test_rotary_gradients_match_jax(core):
    _check(_port_grads(65, core, rotary=True),
           _jax_grads(65, 'xla', rotary=True))


@pytest.mark.parametrize('core', ['xla', 'flash'])
def test_no_residual_gradients_match_jax(core):
    _check(_port_grads(17, core, residual=False),
           _jax_grads(17, 'xla', residual=False))


def test_training_variant_residuals_match_pallas():
    """K1's twin with ``save_residuals``: out, q, k, v, attn and lse
    against ``_fused_fwd``'s residual outputs (interpret mode)."""
    ins, _ = _inputs(65)
    hd = H * DH
    out, res = jax_fl._fused_fwd(*(jnp.asarray(a) for a in ins), H, DH,
                                 jax_fl.LN_EPS, True, save_residuals=True)
    qp, kp, vp, attn_p, lse_p = (np.asarray(a) for a in res[:5])
    t = [torch.from_numpy(a) for a in ins]
    ours, (q, k, v, attn, lse) = fused_layer.fused_attention_fwd(
        t[0], t[1], t[2], t[3].reshape(D, hd), t[4].reshape(D, hd),
        t[5].reshape(D, hd), t[6].reshape(hd, D), H, save_residuals=True)
    assert q.shape == k.shape == v.shape == attn.shape == (B, 65, hd)
    assert lse.shape == (B, H, 65) and lse.dtype == torch.float32
    for name, a, ref in (('out', ours, np.asarray(out)), ('q', q, qp),
                         ('k', k, kp), ('v', v, vp), ('attn', attn, attn_p)):
        assert_close(a.numpy(), ref[:, :65], name)
    assert_close(lse.numpy(), lse_p[:, :, :65, 0], 'lse')


def test_grad_off_keeps_the_inference_variant():
    """With grad off the sublayer returns the primal only (no residuals
    are kept); with grad on it returns an autograd node."""
    ins, _ = _inputs(17)
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    with torch.no_grad():
        out = fused_layer.attention_sublayer(*ts, H, 'fused')
    assert out.grad_fn is None
    out = fused_layer.attention_sublayer(*ts, H, 'fused')
    assert type(out.grad_fn).__name__ == '_AttentionSublayerBackward'
