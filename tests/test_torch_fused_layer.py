"""Torch port: the attention sublayer and the K1 twin against
``sav_tpu.ops.fused_layer`` (core='fused' in Pallas interpret mode, as
tests/test_fused_layer.py runs it, and core='xla'), in float32.

Tolerance: atol 1e-5 on outputs of magnitude ~1 - the same f32 math summed
in another order by another framework."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import fused_layer as jax_fl
from sav_tpu_torch.ops import fused_layer

import torch_parity  # noqa: F401  (pins torch to one thread)

B, D, H = 2, 128, 2
DH = D // H
ATOL = 1e-5


def _params(l, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    return dict(x=mk(B, l, D), scale=1.0 + 0.1 * mk(D), bias=0.1 * mk(D),
                wq=mk(D, H, DH, std=D ** -0.5), wk=mk(D, H, DH, std=D ** -0.5),
                wv=mk(D, H, DH, std=D ** -0.5), wo=mk(H, DH, D, std=D ** -0.5))


@functools.lru_cache(maxsize=None)
def _jax_out(l, core, rotary=False, residual=True):
    p = {k: jnp.asarray(v) for k, v in _params(l).items()}
    out = jax_fl.attention_sublayer(p['x'], p['scale'], p['bias'], p['wq'],
                                    p['wk'], p['wv'], p['wo'], H, core,
                                    jax_fl.LN_EPS, residual, rotary)
    return np.asarray(out)


def _port_out(l, core, rotary=False, residual=True):
    p = {k: torch.from_numpy(v) for k, v in _params(l).items()}
    out = fused_layer.attention_sublayer(p['x'], p['scale'], p['bias'],
                                         p['wq'], p['wk'], p['wv'], p['wo'],
                                         H, core, fused_layer.LN_EPS,
                                         residual, rotary)
    return out.numpy()


@pytest.mark.parametrize('l', [17, 65, 197])
@pytest.mark.parametrize('jax_core', ['fused', 'xla'])
@pytest.mark.parametrize('core', fused_layer.CORES)
def test_sublayer_matches_jax(core, jax_core, l):
    np.testing.assert_allclose(_port_out(l, core), _jax_out(l, jax_core),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize('core', ['xla', 'flash'])
def test_rotary_matches_jax(core):
    np.testing.assert_allclose(_port_out(65, core, rotary=True),
                               _jax_out(65, 'xla', rotary=True),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize('core', ['xla', 'flash'])
def test_no_residual_matches_jax(core):
    np.testing.assert_allclose(_port_out(17, core, residual=False),
                               _jax_out(17, 'xla', residual=False),
                               atol=ATOL, rtol=0)


def test_fused_core_refuses_no_residual():
    """The 'fused' core no longer refuses residual=False (TNT's outer
    sublayer, K1 without its add): it is taken and matches the JAX
    package's fused core (interpret mode) and its xla core."""
    got = _port_out(17, 'fused', residual=False)
    np.testing.assert_allclose(got, _jax_out(17, 'fused', residual=False),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _jax_out(17, 'xla', residual=False),
                               atol=ATOL, rtol=0)


def test_fused_twin_matches_jax_kernel_directly():
    """The K1 twin on 2-D kernels against the Pallas kernel's own launcher
    (interpret mode), without the sublayer around either."""
    p = _params(65)
    hd = H * DH
    out, _ = jax_fl._fused_fwd(
        jnp.asarray(p['x']), jnp.asarray(p['scale']), jnp.asarray(p['bias']),
        jnp.asarray(p['wq']), jnp.asarray(p['wk']), jnp.asarray(p['wv']),
        jnp.asarray(p['wo']), H, DH, jax_fl.LN_EPS, True,
        save_residuals=False)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    twin = fused_layer.fused_attention_fwd(
        t['x'], t['scale'], t['bias'], t['wq'].reshape(D, hd),
        t['wk'].reshape(D, hd), t['wv'].reshape(D, hd),
        t['wo'].reshape(hd, D), H)
    np.testing.assert_allclose(twin.numpy(), np.asarray(out), atol=ATOL, rtol=0)


def test_layernorm_matches_jax():
    p = _params(17)
    y, _, _ = jax_fl._layernorm(jnp.asarray(p['x']), jnp.asarray(p['scale']),
                                jnp.asarray(p['bias']), jax_fl.LN_EPS)
    ours, _, _ = fused_layer._layernorm(torch.from_numpy(p['x']),
                                        torch.from_numpy(p['scale']),
                                        torch.from_numpy(p['bias']),
                                        fused_layer.LN_EPS)
    np.testing.assert_allclose(ours.numpy(), np.asarray(y), atol=ATOL, rtol=0)


@pytest.mark.parametrize('l,heads,d,want', [
    (197, 12, 64, 'fused'), (577, 12, 64, 'fused'), (197, 3, 64, 'fused'),
    (17, 3, 64, 'fused'), (197, 5, 64, 'flash'), (17, 5, 64, None),
    (197, 6, 32, None)])
def test_auto_core_on_the_card(l, heads, d, want):
    """K1 wherever its GEMM takes H*64 (since the 192-wide tile, H = 3:
    vit_ti, ceit_t), else K4 from 64 rows; H = 5 (320) no GEMM tile
    divides."""
    assert fused_layer.auto_core(l, heads, d, 'cuda') == want


def test_auto_core_off_the_card():
    assert fused_layer.auto_core(197, 12, 64, 'cpu') is None


def test_kernel_wrapper_raises_off_cpu_and_cuda():
    x = torch.empty(1, 4, D, device='meta')
    w = torch.empty(D, D, device='meta')
    s = torch.empty(D, device='meta')
    with pytest.raises(ValueError, match='cuda or cpu'):
        fused_layer.fused_attention_fwd(x, s, s, w, w, w, w, H)
