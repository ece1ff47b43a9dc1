"""Torch port, K12 and K13 (``ops/int8_ff.py``) against the JAX package:
the plain twins, with and without ``save_hpre``, against the JAX twin
(``int8_ff_reference``, and for K13 the JAX LayerNorm composed with it)
and against the JAX kernels ``int8_ff_raw`` / ``int8_ff_ln_raw`` in
interpret mode, at M = 300 rows (not a multiple of the TPU kernel's 256,
nor of the card kernel's 48- or 16-row bands); then every gradient of the
bare core (``int8_ff``, backward ``_ff_bwd``) and of ``int8_ff_sublayer``
(``_sublayer_bwd``) against ``jax.vjp`` of the JAX functions.

Tolerances. Against the JAX twin of K12: identical outputs and hidden
codes (the same f32 operations in the same order). K13's LayerNorm sums
in another order than XLA's reduction and its rsqrt differs by an ulp, so
its f32 input moves by ~1e-6: at least 99.9% of its input codes
identical, and the outputs held as against the kernels. Against the JAX
kernels in interpret mode, which XLA compiles as one fused body so that a
few values a hair from a .5 code boundary take the other code: at least
90% of outputs (and of the bf16 hpre) identical, the rest within 1e-2 of
max |out| (one flipped hidden code moves an output by ~0.3% of max).
Gradients: the bare core's backward is f32 on the saved bf16 hpre, its
results rounded to the operands' bf16, 1e-2 of max (one bf16 ulp is 2^-8);
the sublayer's runs its [M, 4D] elementwise work in bf16, where XLA's CPU
backend and torch round the chain at other points (the largest reading
is 5.9e-3 of max), 2e-2 of max (a wrong term is off by O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import int8_ff as jff
from sav_tpu.ops import int8_matmul_kernel as jmk
from sav_tpu_torch.ops import int8_ff as tff
from sav_tpu_torch.ops import int8_matmul_kernel as tmk
from sav_tpu_torch.ops.quantized import int_matmul
from test_torch_quantized import _np, _pair, _rel, assert_near_kernel

M, D, F = 300, 128, 512
CORE_GRAD_TOL = 1e-2
SUBLAYER_GRAD_TOL = 2e-2


def _case(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.standard_normal((M, D)).astype(np.float32),
        w1=(rng.standard_normal((D, F)) / np.sqrt(D)).astype(np.float32),
        b1=(0.1 * rng.standard_normal(F)).astype(np.float32),
        w2=(rng.standard_normal((F, D)) / np.sqrt(F)).astype(np.float32),
        b2=(0.1 * rng.standard_normal(D)).astype(np.float32),
        scale=rng.uniform(0.5, 1.5, D).astype(np.float32),
        bias=(0.1 * rng.standard_normal(D)).astype(np.float32))


def _weights(c):
    jw = jff._quantized_weights(jnp.asarray(c['w1']), jnp.asarray(c['w2']))
    tw = tff._quantized_weights(torch.from_numpy(c['w1']),
                                torch.from_numpy(c['w2']))
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    return jw, tw


def _hidden_codes_torch(xq, xs, tw, b1):
    hpre = int_matmul(xq, tw[0]).float() * (xs * tw[1]) + b1
    return tmk._quantize_tile(tff.gelu(hpre))[0]


def _hidden_codes_jax(xq, xs, jw, b1):
    h = jax.lax.dot_general(xq, jw[0], (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    hpre = h.astype(jnp.float32) * (xs * jw[1]) + b1
    return jmk._quantize_tile(jax.nn.gelu(hpre))[0]


@pytest.mark.parametrize('save_hpre', [False, True])
def test_k12_twin_matches_jax(save_hpre):
    c = _case(1)
    jw, tw = _weights(c)
    jx, tx = _pair(c['x'], 'bfloat16')
    jb1, jb2 = jnp.asarray(c['b1']), jnp.asarray(c['b2'])
    tb1, tb2 = torch.from_numpy(c['b1']), torch.from_numpy(c['b2'])
    ours = tff.int8_ff_raw(tx, tw[0], tw[1], tb1, tw[2], tw[3], tb2,
                           save_hpre=save_hpre)
    kernel = jff.int8_ff_raw(jx, jw[0], jw[1], jb1, jw[2], jw[3], jb2,
                             save_hpre=save_hpre)
    if save_hpre:
        (ours, hpre), (kernel, khpre) = ours, kernel
        assert hpre.dtype == torch.bfloat16 and hpre.shape == (M, F)
        assert_near_kernel(hpre, khpre)
    assert ours.dtype == torch.bfloat16 and ours.shape == (M, D)
    np.testing.assert_array_equal(
        _np(ours), _np(jff.int8_ff_reference(jx, jw[0], jw[1], jb1, jw[2],
                                             jw[3], jb2)))
    assert_near_kernel(ours, kernel)
    # the hidden codes, from each package's own pieces
    xq, xs = tmk._quantize_tile(tx)
    jxq, jxs = jmk._quantize_tile(jx)
    np.testing.assert_array_equal(
        _hidden_codes_torch(xq, xs, tw, tb1).numpy(),
        np.asarray(_hidden_codes_jax(jxq, jxs, jw, jb1)))


@pytest.mark.parametrize('save_hpre', [False, True])
def test_k13_twin_matches_jax(save_hpre):
    c = _case(2)
    jw, tw = _weights(c)
    jx, tx = _pair(c['x'], 'bfloat16')
    vecs = [c[k] for k in ('scale', 'bias', 'b1', 'b2')]
    js, jb, jb1, jb2 = map(jnp.asarray, vecs)
    ts, tb, tb1, tb2 = map(torch.from_numpy, vecs)
    ours = tff.int8_ff_ln_raw(tx, ts, tb, tw[0], tw[1], tb1, tw[2], tw[3],
                              tb2, save_hpre=save_hpre)
    kernel = jff.int8_ff_ln_raw(jx, js, jb, jw[0], jw[1], jb1, jw[2], jw[3],
                                jb2, save_hpre=save_hpre)
    if save_hpre:
        (ours, hpre), (kernel, khpre) = ours, kernel
        assert hpre.dtype == torch.bfloat16 and hpre.shape == (M, F)
        assert_near_kernel(hpre, khpre)
    assert ours.dtype == torch.bfloat16
    # the JAX package's LayerNorm in the kernel's order, then its FF twin
    a = jx.astype(jnp.float32)
    mu = jnp.mean(a, axis=1, keepdims=True)
    var = jnp.maximum(jnp.mean(a * a, axis=1, keepdims=True) - mu * mu, 0.0)
    y2 = ((a - mu) * jax.lax.rsqrt(var + 1e-6)) * js + jb
    f = jff.int8_ff_reference(y2, jw[0], jw[1], jb1, jw[2], jw[3], jb2)
    assert_near_kernel(ours, (a + f).astype(jnp.bfloat16))
    assert_near_kernel(ours, kernel)
    ty2 = tff._ln_f32(tx, ts, tb, 1e-6)[1]
    codes = tmk._quantize_tile(ty2)[0].numpy()
    assert (codes == np.asarray(jmk._quantize_tile(y2)[0])).mean() >= 0.999


def test_int8_ff_core_gradients_match_jax():
    c = _case(3)
    x = c['x'].reshape(4, 75, D)
    g = np.random.RandomState(30).standard_normal((4, 75, D)).astype(np.float32)
    jx, tx = _pair(x, 'bfloat16')
    jw1, tw1 = _pair(c['w1'], 'bfloat16')
    jw2, tw2 = _pair(c['w2'], 'bfloat16')
    jb1, jb2 = jnp.asarray(c['b1']), jnp.asarray(c['b2'])
    want, vjp = jax.vjp(jff.int8_ff, jx, jw1, jb1, jw2, jb2)
    want_grads = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    leaves = [t.clone().requires_grad_() for t in
              (tx, tw1, torch.from_numpy(c['b1']), tw2,
               torch.from_numpy(c['b2']))]
    out = tff.int8_ff(*leaves)
    out.backward(torch.from_numpy(g).bfloat16())
    assert_near_kernel(out, want)
    for name, leaf, w in zip(('dx', 'dw1', 'db1', 'dw2', 'db2'), leaves,
                             want_grads):
        assert leaf.grad.dtype == leaf.dtype, name
        assert _rel(leaf.grad, w) <= CORE_GRAD_TOL, (name, _rel(leaf.grad, w))


def test_int8_ff_sublayer_gradients_match_jax():
    c = _case(4)
    x = c['x'].reshape(4, 75, D)
    g = np.random.RandomState(40).standard_normal((4, 75, D)).astype(np.float32)
    jx, tx = _pair(x, 'bfloat16')
    names = ('scale', 'bias', 'w1', 'b1', 'w2', 'b2')
    jparams = [jnp.asarray(c[k]) for k in names]
    want, vjp = jax.vjp(jff.int8_ff_sublayer, jx, *jparams)
    want_grads = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    leaves = [tx.clone().requires_grad_()] + [
        torch.from_numpy(c[k]).requires_grad_() for k in names]
    out = tff.int8_ff_sublayer(*leaves)
    out.backward(torch.from_numpy(g).bfloat16())
    assert out.shape == (4, 75, D)
    assert_near_kernel(out, want)
    for name, leaf, w in zip(('dx',) + names, leaves, want_grads):
        assert leaf.grad.dtype == leaf.dtype, name
        assert _rel(leaf.grad, w) <= SUBLAYER_GRAD_TOL, (name, _rel(leaf.grad, w))


def test_switchback_refuses():
    """SwitchBack (K14, ported: test_torch_switchback.py holds it against
    the JAX package) refuses only what it does not take: an unknown core,
    and a device that is neither the card nor the CPU. Under no_grad it is
    the 'ff' forward."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.standard_normal((2, D)).astype(np.float32))
    w1 = torch.from_numpy((rng.standard_normal((D, F)) / np.sqrt(D)).astype(
        np.float32))
    w2 = torch.from_numpy((rng.standard_normal((F, D)) / np.sqrt(F)).astype(
        np.float32))
    b1, b2 = torch.zeros(F), torch.zeros(D)
    with torch.no_grad():
        assert torch.equal(tff.int8_ff(x, w1, b1, w2, b2, switchback=True),
                           tff.int8_ff(x, w1, b1, w2, b2))
    with pytest.raises(ValueError, match='core'):
        tff.int8_ff(x, w1.requires_grad_(), b1, w2, b2, switchback=True,
                    core='library').sum().backward()
    g = torch.zeros(2, D, dtype=torch.bfloat16, device='meta')
    codes = (*tff._dx_quantized(w1.detach()), *tff._dx_quantized(w2))
    with pytest.raises(ValueError, match='cuda or cpu'):
        tff.int8_ff_dx_raw(g, torch.zeros(2, F, device='meta'), *codes)
