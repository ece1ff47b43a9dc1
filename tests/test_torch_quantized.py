"""Torch port, the int8 building blocks against the JAX package:
``quantize_symmetric`` (f32 and bf16 arithmetic), ``int8_matmul`` /
``quantized_dense`` with their straight-through gradients, the K15 twin
(``blockwise_int8_matmul_reference``) against the JAX twin and the JAX
kernel in interpret mode, ``int8_dense_fused`` and ``QuantizedDense`` on
both routes.

Tolerances. Codes and scales: identical (the same IEEE division and
half-to-even rounding in both frameworks). Products of identical codes:
identical (int32 sums are exact; the f32 rescale is the same two
multiplies), so the port's twin equals the JAX twin bit for bit. The JAX
kernel run in interpret mode on the CPU is not bit-identical to its own
twin: XLA compiles its body as one fused computation, and a few
activations a hair from a .5 code boundary take the other code (one
activation quantum, 1/127 of the row's absmax, times one weight column).
Against it: at least 90% of outputs identical and the rest within
KERNEL_TOL = 1e-2 of max |out|, where one flipped code moves an output by
~0.1-0.3% of max and a wrong block or scale by O(1). Straight-through
gradients: f32 products summed in other orders, 1e-5 of max; where the
gradient is rounded to bf16 afterwards, one bf16 ulp (2^-8 relative) can
flip on those f32 differences, so 1e-2 of max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.nn.quantized_dense import QuantizedDense as JaxQuantizedDense
from sav_tpu.ops import int8_matmul_kernel as jmk
from sav_tpu.ops import quantized as jq
from sav_tpu_torch.nn.quantized_dense import QuantizedDense
from sav_tpu_torch.ops import int8_matmul_kernel as tmk
from sav_tpu_torch.ops import quantized as tq
import torch_parity  # noqa: F401  (one torch thread)

GRAD_TOL = 1e-5
BF16_GRAD_TOL = 1e-2
KERNEL_TOL = 1e-2
KERNEL_SHARE = 0.9


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32)))
    return j, t.to(getattr(torch, dtype))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def assert_near_kernel(ours, want):
    """``ours`` against a JAX kernel in interpret mode (see the module
    docstring): most outputs identical, the rest within KERNEL_TOL."""
    same = float((_np(ours) == _np(want)).mean())
    assert same >= KERNEL_SHARE and _rel(ours, want) <= KERNEL_TOL, \
        (same, _rel(ours, want))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('axis', [0, 1])
def test_quantize_symmetric_codes_match_jax(dtype, axis):
    rng = np.random.RandomState(axis)
    for scale in (1e-3, 0.7, 40.0):
        a = (rng.standard_normal((48, 130)) * scale).astype(np.float32)
        a[3] = 0.0                      # an all-zero slice: scale 1e-8 / 127
        a[:, 5] = 0.0
        ja, ta = _pair(a, dtype)
        jcodes, jscale = jq.quantize_symmetric(ja, axis)
        tcodes, tscale = tq.quantize_symmetric(ta, axis)
        assert tcodes.dtype == torch.int8 and tscale.dtype == torch.float32
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))


def test_int8_matmul_values_and_ste_gradients_match_jax():
    rng = np.random.RandomState(1)
    a = rng.standard_normal((37, 96)).astype(np.float32)
    b = (rng.standard_normal((96, 40)) / 10).astype(np.float32)
    g = rng.standard_normal((37, 40)).astype(np.float32)
    want, vjp = jax.vjp(jq.int8_matmul, jnp.asarray(a), jnp.asarray(b))
    want_ga, want_gb = vjp(jnp.asarray(g))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = tq.int8_matmul(ta, tb)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    assert _rel(ta.grad, want_ga) <= GRAD_TOL
    assert _rel(tb.grad, want_gb) <= GRAD_TOL


def test_quantized_dense_bf16_values_and_gradients_match_jax():
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    kern = (rng.standard_normal((64, 48)) / 8).astype(np.float32)
    bias = (0.1 * rng.standard_normal(48)).astype(np.float32)
    g = rng.standard_normal((2, 9, 48)).astype(np.float32)
    jx, tx = _pair(x, 'bfloat16')
    jb, tb = _pair(bias, 'bfloat16')

    def jfn(x_, k_):
        return jq.quantized_dense(x_, k_, jb)

    want, vjp = jax.vjp(jfn, jx, jnp.asarray(kern))
    want_gx, want_gk = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    tx = tx.requires_grad_()
    tk = torch.from_numpy(kern).requires_grad_()
    out = tq.quantized_dense(tx, tk, tb)
    out.backward(torch.from_numpy(g).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out), _np(want))
    assert _rel(tx.grad, want_gx) <= BF16_GRAD_TOL
    assert _rel(tk.grad, want_gk) <= GRAD_TOL


def test_k15_twin_codes_and_values_match_jax():
    """K not a multiple of 256: the last block is zero-padded in both."""
    rng = np.random.RandomState(3)
    a = (rng.standard_normal((70, 300)) * 3).astype(np.float32)
    kern = (rng.standard_normal((300, 64)) / 17).astype(np.float32)
    ja, ta = _pair(a, 'bfloat16')
    jk, tk = _pair(kern, 'bfloat16')
    jbq, jbs = jq.quantize_symmetric(jk, axis=0)
    tbq, tbs = tq.quantize_symmetric(tk, axis=0)
    np.testing.assert_array_equal(tbq.numpy(), np.asarray(jbq))
    padded = np.pad(np.asarray(ja.astype(jnp.float32)), ((0, 0), (0, 212)))
    for kk in range(2):
        tile = padded[:, kk * 256:(kk + 1) * 256]
        jcodes, jscale = jmk._quantize_tile(jnp.asarray(tile).astype(jnp.bfloat16))
        tcodes, tscale = tmk._quantize_tile(torch.from_numpy(tile).bfloat16())
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    ours = tmk.int8_matmul_fused(ta, tbq, tbs)     # the twin on the CPU
    assert ours.dtype == torch.bfloat16 and ours.shape == (70, 64)
    np.testing.assert_array_equal(
        _np(ours), _np(jmk.blockwise_int8_matmul_reference(ja, jbq, jbs)))
    # the JAX kernel itself, in interpret mode
    assert_near_kernel(ours, jmk.int8_matmul_fused_raw(ja, jbq, jbs))


def test_int8_dense_fused_values_and_gradients_match_jax():
    rng = np.random.RandomState(4)
    x = rng.standard_normal((3, 11, 320)).astype(np.float32)
    kern = (rng.standard_normal((320, 32)) / 18).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32)).astype(np.float32)
    g = rng.standard_normal((3, 11, 32)).astype(np.float32)
    jx, tx = _pair(x, 'bfloat16')
    jb, tb = _pair(bias, 'bfloat16')
    want, vjp = jax.vjp(lambda x_, k_: jmk.int8_dense_fused(x_, k_, jb), jx,
                        jnp.asarray(kern))
    want_gx, want_gk = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    tx = tx.requires_grad_()
    tk = torch.from_numpy(kern).requires_grad_()
    out = tmk.int8_dense_fused(tx, tk, tb)
    out.backward(torch.from_numpy(g).bfloat16())
    assert_near_kernel(out, want)
    # both gradients pass through bf16 (the kernel is cast to x's dtype)
    assert _rel(tx.grad, want_gx) <= BF16_GRAD_TOL
    assert _rel(tk.grad, want_gk) <= BF16_GRAD_TOL


@pytest.mark.parametrize('fused', [False, True])
def test_quantized_dense_module_matches_flax(fused):
    rng = np.random.RandomState(5 + fused)
    x = rng.standard_normal((4, 7, 256)).astype(np.float32)
    flax_mod = JaxQuantizedDense(features=64, dtype=jnp.bfloat16, fused=fused)
    params = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    params = jax.tree_util.tree_map(np.asarray, params)
    params['bias'] = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = flax_mod.apply({'params': params}, jnp.asarray(x))
    ours = QuantizedDense(256, 64, dtype=torch.bfloat16, fused=fused)
    ours.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in params.items()})
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    if fused:
        assert_near_kernel(out, want)
    else:
        np.testing.assert_array_equal(_np(out), _np(want))
