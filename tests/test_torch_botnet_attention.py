"""Torch port: BoTNet's relative-position attention core
(``ops.botnet_attention``) against ``sav_tpu.ops.botnet_attention``. The
JAX kernels run as its own tests run them, in interpret mode; the port
runs its plain twins of K9a/K9b here (CPU tensors). Two shapes: B=2, a
5 x 5 grid (L = 25, ragged against every tile), 4 heads of d = 64; and a
4 x 4 grid with 2 heads of d = 128 (botnet_t3's head width).

float32. Tolerances, the JAX module's own test's
(tests/test_botnet_attention.py): outputs 2e-5 absolute (values O(1)), lse
2e-5, every gradient 5e-5 of its max |jax|; ``relative_shift`` and the
decomposed logits are the same arithmetic, 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import botnet_attention as jax_ba
from sav_tpu_torch.ops import botnet_attention as ba

import torch_parity  # noqa: F401  (pins torch to one thread)

SHAPES = [(2, 5, 4, 64), (2, 4, 2, 128)]     # (B, g, h, d)
GRAD_NAMES = ('qs', 'k', 'v', 'emb_h', 'emb_w')


def _args(b, g, h, d, seed=0):
    """qs, k, v [B, L, h*d] and emb_h, emb_w [2g-1, d], as the JAX test
    draws them (scale 0.3, embeddings a third of that)."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)
    length = g * g
    return (mk(b, length, h * d), mk(b, length, h * d), mk(b, length, h * d),
            mk(2 * g - 1, d) / 3, mk(2 * g - 1, d) / 3)


def _cotangent(b, g, h, d):
    return np.random.RandomState(9).standard_normal(
        (b, g * g, h * d)).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= tol, f'{what}: {err:.3g} > {tol:.3g}'


@functools.lru_cache(maxsize=None)
def _jax_mhsa(fn_name, b, g, h, d):
    """(out, the five gradients of <out, cotangent>) of the JAX
    ``botnet_mhsa`` (kernel, interpret mode) or ``bot_mhsa_reference``."""
    fn = getattr(jax_ba, fn_name)
    args = [jnp.asarray(a) for a in _args(b, g, h, d)]
    out, vjp = jax.vjp(lambda *a: fn(*a, h, g), *args)
    grads = jax.jit(vjp)(jnp.asarray(_cotangent(b, g, h, d)))
    return np.asarray(out), [np.asarray(x) for x in grads]


@functools.lru_cache(maxsize=None)
def _jax_core(b, g, h, d):
    """The JAX K9a's (out, lse) and the VJP of ``bot_core`` (K9b) at the
    same rel logits and cotangent; returns numpy (inputs, out, lse,
    grads)."""
    qs, k, v, emb_h, emb_w = (jnp.asarray(a) for a in _args(b, g, h, d))
    rel_h, rel_w = jax_ba.decomposed_rel_logits(qs, emb_h, emb_w, h, g)
    out, res = jax_ba._bot_fwd_impl(qs, k, v, rel_h, rel_w, h, g)
    lse = res[-1][:, :, :g * g, 0]
    _, vjp = jax.vjp(lambda *a: jax_ba.bot_core(*a, h, g), qs, k, v, rel_h,
                     rel_w)
    grads = vjp(jnp.asarray(_cotangent(b, g, h, d)))
    to_np = lambda xs: [np.asarray(x) for x in xs]
    return (to_np((qs, k, v, rel_h, rel_w)), np.asarray(out), np.asarray(lse),
            to_np(grads))


@pytest.mark.parametrize('b,g,h,d', SHAPES)
def test_relative_shift_and_rel_logits_match_jax(b, g, h, d):
    x = np.random.RandomState(1).standard_normal(
        (b, h, g * g, 2 * g * g - 1)).astype(np.float32)
    _close(ba.relative_shift(_t(x)),
           jax_ba.relative_shift(jnp.asarray(x)), 1e-6, 'relative_shift')
    qs, _, _, emb_h, emb_w = _args(b, g, h, d)
    want = jax_ba.decomposed_rel_logits(*map(jnp.asarray, (qs, emb_h, emb_w)),
                                        h, g)
    got = ba.decomposed_rel_logits(_t(qs), _t(emb_h), _t(emb_w), h, g)
    for ours, theirs, name in zip(got, want, ('rel_h', 'rel_w')):
        assert ours.dtype == torch.float32 and ours.is_contiguous()
        _close(ours, theirs, 1e-6, name)


@pytest.mark.parametrize('b,g,h,d', SHAPES)
def test_core_twins_match_the_jax_kernels(b, g, h, d):
    """bot_fwd_plain's out and lse against K9a, bot_bwd_plain's five
    gradients against the VJP of bot_core (K9b), at the same rel logits."""
    ins, want_out, want_lse, want_grads = _jax_core(b, g, h, d)
    t = [_t(a) for a in ins]
    out, lse = ba.bot_fwd_plain(*t, h, g)
    _close(out, want_out, 2e-5, 'out')
    _close(lse, want_lse, 2e-5, 'lse')
    # the raw wrappers run the same twins on CPU tensors
    got_out, got_lse = ba.bot_fwd(*t, h, g, save_lse=True)
    assert torch.equal(got_out, out) and torch.equal(got_lse, lse)
    assert ba.bot_fwd(*t, h, g)[1] is None
    grads = ba.bot_bwd(*t, out, lse, _t(_cotangent(b, g, h, d)), h, g)
    names = ('dq', 'dk', 'dv', 'drel_h', 'drel_w')
    for ours, theirs, name in zip(grads, want_grads, names):
        _close(ours, theirs, 5e-5 * np.abs(theirs).max(), name)


@pytest.mark.parametrize('b,g,h,d', SHAPES)
@pytest.mark.parametrize('fn_name', ['botnet_mhsa', 'bot_mhsa_reference'])
def test_mhsa_and_its_gradients_match_jax(fn_name, b, g, h, d):
    """The port's botnet_mhsa (bot_core on the twins, the rel logits by
    autograd) and bot_mhsa_reference against the JAX function of the same
    name: out and the gradients of qs, k, v, emb_h and emb_w."""
    want_out, want_grads = _jax_mhsa(fn_name, b, g, h, d)
    leaves = [_t(a, grad=True) for a in _args(b, g, h, d)]
    out = getattr(ba, fn_name)(*leaves, h, g)
    _close(out, want_out, 2e-5, 'out')
    grads = torch.autograd.grad(out, leaves, _t(_cotangent(b, g, h, d)))
    for ours, theirs, name in zip(grads, want_grads, GRAD_NAMES):
        _close(ours, theirs, 5e-5 * np.abs(theirs).max(), name)


def test_plain_core_is_the_same_function():
    """core='plain' (the card's gradient reference) runs the same Function
    on the twins; on CPU tensors it equals core='kernel' bit for bit."""
    b, g, h, d = SHAPES[0]
    grads = {}
    for core in ba.CORES:
        leaves = [_t(a, grad=True) for a in _args(b, g, h, d)]
        out = ba.botnet_mhsa(*leaves, h, g, core=core)
        grads[core] = (out, *torch.autograd.grad(out.square().sum(), leaves))
    for a, b_ in zip(grads['kernel'], grads['plain']):
        assert torch.equal(a, b_)
    with pytest.raises(ValueError, match='core'):
        ba.bot_core(*[_t(a) for a in _args(b, g, h, d)[:3]],
                    torch.zeros(b, h, g * g, g), torch.zeros(b, h, g * g, g),
                    h, g, core='xla')


def test_supported_off_the_card():
    """Off the card only the kernels' head widths are checked (the twins
    have no shared-memory budget); the TPU caps are gone."""
    assert ba.supported(14, 4, 128, device='cpu')      # botnet_t3 @224
    assert ba.supported(30, 4, 128, device='cpu')      # past the TPU's g <= 28
    assert ba.supported(14, 32, 64, device='cpu')      # past its 16 heads
    assert not ba.supported(14, 4, 96, device='cpu')
    assert not ba.supported(0, 4, 128, device='cpu')
