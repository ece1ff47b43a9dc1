"""Torch port: CaiT (``models/cait.py``) against sav_tpu's from the same flax
tree, float32: logits in eval and in training mode at stochastic-depth
rate 0, for every ``use_kernel`` the port takes (the talking-heads span's
routes run their kernels' plain twins on the CPU); one body block's
gradients on the span against the per-op path; stochastic depth against
the JAX formula with an injected mask, its keep rate, seeding and eval
identity; LayerScale and talking heads; the factory's ten names, tree
keys and seeded init.

Tolerance: logits atol 1e-4 (as the ViT parity tests: 2 + 1 layers of f32
math in another summation order, logits ~14 from the filled head; the
tree's LayerScale and LayerNorms are filled too (``fill_body``), so every
block moves the logits by O(1) and a miswired one fails; the error is
~5e-6);
gradients of the span vs the per-op path within 5e-4 of max |grad| (the
JAX package's own bound for the same comparison).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import cait as jax_cait_lib
from sav_tpu.nn import regularization as jax_reg
from sav_tpu_torch.models import available_models, create_model, set_use_kernel
from sav_tpu_torch.models import cait
from sav_tpu_torch.nn.normalization import LayerScaleBlock
from sav_tpu_torch.nn.regularization import (StochasticDepthBlock, drop_path,
                                             set_stochastic_depth_generator)
from sav_tpu_torch.utils.flax_bridge import flatten_tree, torch_to_flax
from torch_parity import images, jax_cait, torch_cait

IMG = 32
ATOL = 1e-4
CAIT_NAMES = ['cait_xxs_24', 'cait_xxs_36', 'cait_xs_24', 'cait_xs_36',
              'cait_s_24', 'cait_s_36', 'cait_s_48', 'cait_m_24', 'cait_m_36',
              'cait_m_48']


@functools.lru_cache(maxsize=None)
def _jax(use_kernel, is_training):
    model, params = jax_cait(IMG, use_kernel=use_kernel)
    logits = model.apply({'params': params}, jnp.asarray(images(2, IMG)),
                         is_training=is_training)
    return params, np.asarray(logits)


@pytest.mark.parametrize('is_training', [False, True])
@pytest.mark.parametrize('jax_kernel', [False, 'fused_th'])
@pytest.mark.parametrize('use_kernel', cait.USE_KERNEL)
def test_logits_match_jax(use_kernel, jax_kernel, is_training):
    params, expect = _jax(jax_kernel, is_training)
    model = torch_cait(params, IMG, use_kernel=use_kernel)
    model.train(is_training)
    with torch.no_grad():
        logits = model(torch.from_numpy(images(2, IMG)))
    assert logits.shape == (2, 10)
    np.testing.assert_allclose(logits.numpy(), expect, atol=ATOL, rtol=0)


def test_set_use_kernel_reroutes_the_same_weights():
    params, expect = _jax(False, False)
    model = torch_cait(params, IMG, use_kernel=False)
    set_use_kernel(model, 'fused_th_xla')
    assert model.Encoder_0.EncoderBlock_1.use_kernel == 'fused_th_xla'
    with torch.no_grad():
        logits = model(torch.from_numpy(images(2, IMG)))
    np.testing.assert_allclose(logits.numpy(), expect, atol=ATOL, rtol=0)
    with pytest.raises(NotImplementedError, match='CaiT'):
        set_use_kernel(model, 'fused_layer')


@pytest.mark.parametrize('use_kernel', ['fused_th', 'fused_th_xla'])
def test_block_span_gradients_match_per_op(use_kernel):
    """One body block on the span vs the per-op path, same weights: output
    and every parameter's gradient (JAX's fused-route block test)."""
    torch.manual_seed(0)
    base = cait.EncoderBlock(64, 4, 0.0, 0.5, use_kernel=False)
    from sav_tpu_torch.nn.layers import init_all
    init_all(base, torch.Generator().manual_seed(1))
    span = cait.EncoderBlock(64, 4, 0.0, 0.5, use_kernel=use_kernel)
    span.load_state_dict(base.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (2, 20, 64)).astype(np.float32))
    outs, grads = [], []
    for block in (base, span):
        out = block(x)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out.square().sum(),
                                         list(block.parameters())))
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=2e-5,
                               rtol=0)
    for (name, _), a, b in zip(base.named_parameters(), grads[1], grads[0]):
        err = (a - b).abs().max().item()
        assert err <= 5e-4 * b.abs().max().item() + 1e-12, (name, err)


def test_stochastic_depth_matches_the_jax_formula():
    """The JAX block's output gives its mask (per-sample 0 or x/keep);
    the port's drop_path with that mask reproduces the output."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((16, 5, 3)).astype(np.float32) + 3.0
    block = jax_reg.StochasticDepthBlock(drop_rate=0.3)
    y = np.asarray(block.apply({}, jnp.asarray(x), is_training=True,
                               rngs={'stochastic_depth': jax.random.PRNGKey(4)}))
    mask = np.abs(y).reshape(16, -1).max(axis=1) > 0
    assert 0 < mask.sum() < 16
    ours = drop_path(torch.from_numpy(x), 0.3, torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), y, rtol=1e-6, atol=0)


def test_stochastic_depth_keep_rate_seeding_and_eval():
    block = StochasticDepthBlock(0.1)
    x = torch.ones(20000, 2)
    with pytest.raises(RuntimeError, match='Generator'):
        block(x)
    block.generator = torch.Generator().manual_seed(7)
    y = block(x)
    kept = (y[:, 0] > 0).float().mean().item()
    assert abs(kept - 0.9) < 4 * (0.9 * 0.1 / 20000) ** 0.5
    np.testing.assert_allclose(y[y > 0].numpy(), 1 / 0.9, rtol=1e-6)
    block.generator.manual_seed(3)
    a = block(x)
    block.generator.manual_seed(3)
    assert torch.equal(a, block(x))
    block.eval()
    assert block(x) is x
    assert StochasticDepthBlock(0.0)(x) is x


def test_generator_reaches_every_stochastic_depth_block():
    model = create_model('cait_xxs_24', device='cpu', num_layers=2,
                         num_layers_token_only=1, img_size=32)
    gen = torch.Generator()
    set_stochastic_depth_generator(model, gen)
    blocks = [m for m in model.modules() if isinstance(m, StochasticDepthBlock)]
    assert len(blocks) == 6 and all(b.generator is gen for b in blocks)
    assert all(b.drop_rate == 0.05 for b in blocks)      # cait_xxs_24's rate


def test_layerscale_and_talking_heads_init():
    ls = LayerScaleBlock(6, 1e-5)
    ls.init_params(torch.Generator())
    assert torch.equal(ls.layerscale, torch.full((6,), 1e-5))
    model = create_model('cait_s_24', device='cpu', num_layers=1,
                         num_layers_token_only=1, img_size=32)
    m = model.Encoder_0.EncoderBlock_0.SelfAttentionBlock_0
    for th in (m.TalkingHeadsBlock_0, m.TalkingHeadsBlock_1):
        t = th.talking_heads_transform.detach()
        torch.testing.assert_close(t @ t.T, torch.eye(8), atol=1e-5, rtol=0)
    assert torch.equal(model.Encoder_0.EncoderBlock_0.LayerScaleBlock_1.layerscale,
                       torch.full((384,), 1e-6))


def test_factory_names_and_tree_keys():
    assert set(CAIT_NAMES) <= set(available_models())
    _, params = jax_cait(IMG)
    want = sorted(flatten_tree(jax.tree_util.tree_map(np.asarray, params)))
    model = create_model('cait_xxs_24', num_classes=10, device='cpu',
                         img_size=IMG, num_layers=2, num_layers_token_only=1,
                         embed_dim=64, num_heads=4)
    assert sorted(flatten_tree(torch_to_flax(model.state_dict()))) == want


@pytest.mark.parametrize('name', CAIT_NAMES)
def test_every_name_builds_at_its_width(name):
    from sav_tpu.models.factory import MODEL_CONFIGS
    _, config = MODEL_CONFIGS[name]
    model = create_model(name, device='cpu', img_size=32, num_layers=1,
                         num_layers_token_only=1)
    block = model.Encoder_0.EncoderBlock_0
    assert model.cls.shape == (1, 1, config['embed_dim'])
    assert block.num_heads == config['num_heads']
    assert block.StochasticDepthBlock_0.drop_rate == config['stoch_depth_rate']
    assert block.LayerScaleBlock_0.layerscale[0].item() == pytest.approx(
        config['layerscale_eps'])


def test_init_is_seeded_and_refusals():
    kw = dict(device='cpu', num_layers=1, num_layers_token_only=1, img_size=32)
    a = create_model('cait_xxs_24', seed=3, **kw)
    b = create_model('cait_xxs_24', seed=3, **kw)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    assert torch.count_nonzero(a.state_dict()['Dense_0.kernel']) == 0
    with pytest.raises(NotImplementedError, match='scan'):
        create_model('cait_xxs_24', scan_layers=True, **kw)
    with pytest.raises(NotImplementedError, match='dropout'):
        create_model('cait_xxs_24', dropout_rate=0.1, **kw)
    with pytest.raises(ValueError, match='quantized'):
        create_model('cait_xxs_24', quantized='int4', **kw)
    # 'all' (K11) is ported: the body blocks take it, their FFs run 'ff'
    quantized = create_model('cait_xxs_24', quantized='all', **kw)
    assert quantized.Encoder_0.EncoderBlock_0.FFBlock_0.quantized == 'ff'


def test_class_attention_block_matches_jax():
    x = np.random.RandomState(1).standard_normal((2, 7, 64)).astype(np.float32)
    block = jax_cait_lib.ClassSelfAttentionBlock(num_heads=4, use_kernel=False)
    v = block.init(jax.random.PRNGKey(2), jnp.asarray(x), is_training=False)
    want = np.asarray(block.apply(v, jnp.asarray(x), is_training=False))
    ours = cait.ClassSelfAttentionBlock(64, 4, use_kernel=False)
    from sav_tpu_torch.utils.flax_bridge import flax_to_torch
    ours.load_state_dict(flax_to_torch(v['params']))
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    assert got.shape == (2, 1, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
