"""Torch port: the FF sublayer under one autograd boundary
(``ops.fused_layer.ff_sublayer``, library forward, K16 backward; its plain
twin here) against ``sav_tpu.ops.fused_layer.ff_sublayer``, whose Pallas
backward runs in interpret mode off the TPU: forward, the seven gradients,
a 1 x 3-row tail and ``residual=False``. ViT under ``use_kernel='fused_ff'``
(per-op attention dispatched as 'auto', the FF span) from one flax tree
against the JAX model: logits and every parameter's gradient, at D = 128
and at vit_ti's D = 192 (which the card's K16 refuses, ``ff_refusal``).
And the
attention dispatch: a ``use_kernel`` string that is not a flash mode goes
to ``dispatch_mode`` as 'auto' does, as in the JAX package.

float32. Tolerances of the JAX module's own tests
(tests/test_fused_layer.py:368-405): forward atol/rtol 2e-5; gradients 5e-4
of each one's max. ViT logits atol 1e-4 (as test_torch_vit.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import fused_layer as jax_fl
from sav_tpu_torch.models import set_use_kernel
from sav_tpu_torch.ops import attention as attention_ops
from sav_tpu_torch.ops import fused_layer
from sav_tpu_torch.utils.flax_bridge import flatten_tree
from torch_parity import jax_vit, images, torch_vit

D, F = 128, 256
NAMES = ['x', 'scale2', 'bias2', 'w1', 'b1', 'w2', 'b2']
IMG = 32


def _args(b, l, seed):
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return [mk(b, l, D), 1.0 + 0.1 * mk(D), 0.1 * mk(D), mk(D, F),
            0.1 * mk(F), mk(F, D), 0.1 * mk(D)]


def _close_rel(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
    assert err < tol, (name, err)


@pytest.mark.parametrize('b,l,residual', [(2, 19, True), (1, 3, True),
                                          (2, 19, False)])
def test_forward_matches_jax(b, l, residual):
    args = _args(b, l, seed=7)
    want = jax_fl.ff_sublayer(*map(jnp.asarray, args), jax_fl.LN_EPS, residual)
    with torch.no_grad():
        got = fused_layer.ff_sublayer(*map(torch.from_numpy, args),
                                      residual=residual)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize('b,l,residual', [(2, 19, True), (1, 3, True),
                                          (2, 19, False)])
def test_gradients_match_jax(b, l, residual):
    args = _args(b, l, seed=8)
    want = jax.grad(lambda *a: jnp.sum(jnp.square(jax_fl.ff_sublayer(
        *a, jax_fl.LN_EPS, residual))), argnums=tuple(range(7)))(
            *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    fused_layer.ff_sublayer(*ts, residual=residual).square().sum().backward()
    for name, t, w in zip(NAMES, ts, want):
        _close_rel(t.grad.numpy(), w, 5e-4, name)


def test_backward_twin_matches_autograd_of_the_forward():
    """``ff_bwd_plain`` (the K16 twin) against autograd through the library
    forward, on flattened rows."""
    rng = np.random.RandomState(9)
    m = 37
    g, y = (torch.from_numpy(rng.standard_normal((m, D)).astype(np.float32))
            for _ in range(2))
    w1 = torch.from_numpy((rng.standard_normal((D, F)) * 0.1).astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((F, D)) * 0.1).astype(np.float32))
    b1 = torch.from_numpy((rng.standard_normal(F) * 0.1).astype(np.float32))
    hpre = (y @ w1 + b1).detach()
    leaves = [t.clone().requires_grad_() for t in (y, w1, w2, hpre)]
    y_, w1_, w2_, hp_ = leaves
    out = torch.nn.functional.gelu(hp_, approximate='tanh') @ w2_
    (out * g).sum().backward()
    dy2, dw1, dw2, db1 = fused_layer.ff_bwd(g, hpre, y, w1, w2)
    dh = hp_.grad
    _close_rel(dw2, w2_.grad, 1e-5, 'dw2')
    _close_rel(db1, dh.sum(0), 1e-5, 'db1')
    _close_rel(dw1, y.t() @ dh, 1e-5, 'dw1')
    _close_rel(dy2, dh @ w1.t(), 1e-5, 'dy2')


def test_ff_kernel_supported_geometry():
    assert fused_layer.ff_kernel_supported(768, 3072)        # ViT-B
    assert fused_layer.ff_kernel_supported(1024, 4096)       # ViT-L
    assert not fused_layer.ff_kernel_supported(192, 768)     # ViT-Ti: D % 128
    assert not fused_layer.ff_kernel_supported(768, 3000)


def test_vit_fused_ff_logits_and_gradients_match_jax():
    model_j, params = jax_vit(IMG, use_kernel='fused_ff')
    x = images(2, IMG, seed=3)
    want = np.asarray(model_j.apply({'params': params}, jnp.asarray(x),
                                    is_training=False))
    want_g = jax.grad(lambda p: jnp.sum(jnp.square(model_j.apply(
        {'params': p}, jnp.asarray(x), is_training=False))))(params)
    want_g = {k.replace('/', '.'): v for k, v in flatten_tree(want_g).items()}
    model = torch_vit(params, IMG, use_kernel='fused_ff')
    logits = model(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=1e-4,
                               rtol=0)
    logits.square().sum().backward()
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(want_g)
    for name, p in names.items():
        _close_rel(p.grad.numpy(), want_g[name], 5e-4, name)


def test_vit_fused_ff_routes_the_ff_through_the_function(monkeypatch):
    _, params = jax_vit(IMG, use_kernel=False)
    model = torch_vit(params, IMG, use_kernel=False)
    calls = []
    real = fused_layer.ff_sublayer
    monkeypatch.setattr(fused_layer, 'ff_sublayer',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.from_numpy(images(2, IMG))
    with torch.no_grad():
        plain = model(x)
        set_use_kernel(model, 'fused_ff')
        assert model.Encoder_0.EncoderBlock_0.SelfAttentionBlock_0.use_kernel \
            == 'fused_ff'
        fused = model(x)
    assert len(calls) == 2                     # one per encoder block
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=1e-4, rtol=0)


def test_vit_fused_ff_refuses_what_k16_does_not_tile():
    """The card's refusal, asked on the CPU with ``device='cuda'``: K16
    tiles D and F in 128-wide tiles, so ViT-Ti's 192/768 is refused there
    (naming the roadmap item) and taken off the card."""
    why = fused_layer.ff_refusal(192, 768, 'cuda')
    assert why is not None and 'Queue 2 item 12' in why
    assert fused_layer.ff_refusal(768, 3000, 'cuda') is not None
    assert fused_layer.ff_refusal(768, 3072, 'cuda') is None
    assert fused_layer.ff_refusal(192, 768, 'cpu') is None
    assert fused_layer.ff_refusal(0, 768, 'cpu') is not None


@pytest.mark.parametrize('dim,hidden', [(192, 768), (128, 200), (768, 3072)])
def test_ff_refusal_off_the_card_takes_any_width(dim, hidden):
    assert fused_layer.ff_refusal(dim, hidden, 'cpu') is None
    assert (fused_layer.ff_refusal(dim, hidden, 'cuda') is None) == \
        fused_layer.ff_kernel_supported(dim, hidden)


def test_vit_ti_fused_ff_logits_and_gradients_match_jax():
    """ViT-Ti's widths (2 layers, D = 192, H = 3, FF 768) under
    ``use_kernel='fused_ff'``, which K16's tiling refuses on the card: on
    the CPU the Function runs its plain twins, as the JAX package runs its
    kernel at 192/768. Tolerances of the D = 128 test above."""
    ti = dict(num_layers=2)
    model_j, params = jax_vit(IMG, overrides=ti, use_kernel='fused_ff')
    x = images(2, IMG, seed=4)
    want = np.asarray(model_j.apply({'params': params}, jnp.asarray(x),
                                    is_training=False))
    want_g = jax.grad(lambda p: jnp.sum(jnp.square(model_j.apply(
        {'params': p}, jnp.asarray(x), is_training=False))))(params)
    want_g = {k.replace('/', '.'): v for k, v in flatten_tree(want_g).items()}
    model = torch_vit(params, IMG, overrides=ti, use_kernel='fused_ff')
    assert model.Encoder_0.EncoderBlock_0.FFBlock_0.Dense_0.kernel.shape == \
        (192, 768)
    logits = model(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=1e-4,
                               rtol=0)
    logits.square().sum().backward()
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(want_g)
    for name, p in names.items():
        _close_rel(p.grad.numpy(), want_g[name], 5e-4, name)


@pytest.mark.parametrize('mode', ['fused_ff', 'fused_layer', 'anything'])
def test_other_use_kernel_strings_dispatch_as_auto(monkeypatch, mode):
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 9, 2, 16)).astype(
        np.float32)) for _ in range(3))
    seen = []
    real = attention_ops.dispatch_mode
    monkeypatch.setattr(attention_ops, 'dispatch_mode',
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    got = attention_ops.multi_head_attention(q, k, v, use_kernel=mode)
    want = attention_ops.multi_head_attention(q, k, v, use_kernel=False)
    assert seen == [1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
