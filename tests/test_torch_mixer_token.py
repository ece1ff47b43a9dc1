"""Torch port: the Mixer token-mixing sublayer (``ops.mixer_token``) against
``sav_tpu.ops.mixer_token.token_mix_sublayer``, whose Pallas kernels run in
interpret mode off the TPU (images per block monkeypatched to 2 with B = 5,
so its zero-image padding path runs), and against the per-op twin
``token_mix_reference`` of both packages. The port runs its plain twins of
K8a/K8b here (CPU tensors).

float32. Tolerances, the JAX module's own test's (tests/test_mixer_token.py):
the forward 2e-5, each of the seven gradients 5e-5 of its max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import mixer_token as jax_mt
from sav_tpu_torch.ops import mixer_token

B = 5
SHAPES = [(24, 12, 128), (13, 6, 128)]      # (L, K, D); the second odd


def _args(l, k, d, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [mk(B, l, d), 1 + 0.1 * mk(d), 0.1 * mk(d), 0.05 * mk(l, k),
            0.1 * mk(k), 0.05 * mk(k, l), 0.1 * mk(l)]


def _jax_grads(fn, args):
    loss = lambda *a: jnp.sum(jnp.square(fn(*a)))
    return jax.grad(loss, argnums=tuple(range(7)))(*map(jnp.asarray, args))


def _torch_grads(fn, args):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*ts)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close_rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() / (np.abs(want).max() + 1e-12) < tol


@pytest.fixture
def ni2(monkeypatch):
    monkeypatch.setattr(jax_mt, '_NI', 2)


@pytest.mark.parametrize('l,k,d', SHAPES)
def test_forward_matches_jax_kernel_and_reference(ni2, l, k, d):
    args = _args(l, k, d)
    want = np.asarray(jax_mt.token_mix_sublayer(*map(jnp.asarray, args)))
    with torch.no_grad():
        got = mixer_token.token_mix_sublayer(*map(torch.from_numpy, args))
        ref = mixer_token.token_mix_reference(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ref.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize('l,k,d', SHAPES)
def test_gradients_match_jax_kernel(ni2, l, k, d):
    args = _args(l, k, d, seed=1)
    want = _jax_grads(jax_mt.token_mix_sublayer, args)
    _, got = _torch_grads(mixer_token.token_mix_sublayer, args)
    for g, w in zip(got, want):
        _close_rel(g, w, 5e-5)


@pytest.mark.parametrize('l,k,d', SHAPES)
def test_gradients_match_reference(l, k, d):
    """The Function's closed-form backward against autograd through the
    port's per-op twin and JAX's own twin."""
    args = _args(l, k, d, seed=2)
    _, got = _torch_grads(mixer_token.token_mix_sublayer, args)
    _, ref = _torch_grads(mixer_token.token_mix_reference, args)
    want = _jax_grads(jax_mt.token_mix_reference, args)
    for g, r, w in zip(got, ref, want):
        _close_rel(g, r, 5e-5)
        _close_rel(r, w, 5e-5)


def test_backward_twin_returns_the_seven_gradients():
    l, k, d = SHAPES[1]
    args = [torch.from_numpy(a) for a in _args(l, k, d, seed=3)]
    g = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (B, l, d)).astype(np.float32))
    grads = mixer_token.token_mix_bwd(*args, g)
    assert [tuple(t.shape) for t in grads] == [
        (B, l, d), (d,), (d,), (l, k), (k,), (k, l), (l,)]
    assert all(t.dtype == torch.float32 for t in grads)


def test_supported_takes_every_mixer_config_at_224():
    # off the card only the bands bind; the shared-memory budget, read
    # from the kernel's own formulas, is held on the card (test_torch_cuda)
    for l, k in ((49, 24), (196, 98)):
        for d in (512, 768, 1024):
            assert mixer_token.supported(l, k, d, 'cpu')
    assert not mixer_token.supported(196, 98, 384 + 64, 'cpu')  # partial band
    assert not mixer_token.supported(196, 0, 768, 'cpu')
    assert mixer_token.supported(5, 2, 128, 'cpu')              # no TPU floor


def test_auto_route_refuses_on_the_card(monkeypatch):
    """'auto' takes the kernels on the card and the per-op path off it; on
    the card a shape the kernels do not take raises and points to
    use_kernel=False. The kernel's shared-memory formulas are stood in for
    by one that L = 576 (Mixer @384) exceeds."""
    monkeypatch.setattr(mixer_token, '_smem', lambda which, l, k: 1000 * l)
    assert mixer_token.auto_route(196, 98, 768, 'cuda')
    assert not mixer_token.auto_route(576, 288, 768, 'cpu')
    with pytest.raises(NotImplementedError,
                       match='shared memory.*use_kernel=False'):
        mixer_token.auto_route(576, 288, 768, 'cuda')
    with pytest.raises(NotImplementedError, match='bands.*use_kernel=False'):
        mixer_token.auto_route(196, 98, 384 + 64, 'cuda')


def test_cpu_wrappers_take_the_plain_twins_only_for_cpu_tensors():
    args = [torch.from_numpy(a) for a in _args(13, 6, 128)]
    meta = [a.to('meta') for a in args]
    with pytest.raises(ValueError, match='cuda or cpu'):
        mixer_token.token_mix_fwd(*meta)
    with pytest.raises(ValueError, match='cuda or cpu'):
        mixer_token.token_mix_bwd(*meta, meta[0])
