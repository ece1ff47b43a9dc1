"""Torch port: the attention and FF options an imported ViT needs, against
the flax modules of ``sav_tpu``: ``AttentionBlock(use_bias=True)`` with and
without ``fused_qkv``, self- and cross-attention, with rotary embeddings
and talking heads; CvT's biased attention block; the rotary module;
``FFBlock``'s activations; ViT's routing of these options; and three
``train_step``s of an imported ViT (biases, erf gelu) against the JAX
package's.

float32 on the CPU, every bias filled away from its zero init. Outputs
within 1e-5 of max(1, max |flax|); input and parameter gradients within
1e-5 of max(1, max |flax grad|) per tensor (test_torch_sublayer_grad.py's
rule: the weight gradients sum B*L rows in another order). CvT's block as
test_torch_cvt.py holds its modules (1e-5 of max |out|, gradients 5e-4 of
max |grad|: BatchNorm and two convolutions in another order). The train
steps at test_torch_train.py's tolerances: losses and metrics atol 1e-5,
parameters after 3 steps atol 1e-5, Adam eps 1e-3 (that file says why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models.factory import _spec_activation as jax_activation
from sav_tpu.models.vit import ViT as JaxViT
from sav_tpu.nn.attention import AttentionBlock as JaxAttention
from sav_tpu.nn.attention import SelfAttentionBlock as JaxSelfAttention
from sav_tpu.nn.cvt_attention import CvTSelfAttentionBlock as JaxCvTAttention
from sav_tpu.nn.feedforward import FFBlock as JaxFFBlock
from sav_tpu.nn.posembed import RotaryPositionalEmbedding as JaxRotary
from sav_tpu.nn.posembed import apply_rotary_pos_emb as jax_rotary_pos_emb
from sav_tpu.nn.posembed import sincos_frequencies as jax_frequencies
from sav_tpu.train import state as jax_state
from sav_tpu.train import steps as jax_steps
from sav_tpu.utils.timm_import import convert_timm_vit as jax_convert_timm
from sav_tpu_torch.models import create_model, set_use_kernel
from sav_tpu_torch.models.vit import ViT
from sav_tpu_torch.nn.attention import AttentionBlock, SelfAttentionBlock
from sav_tpu_torch.nn.cvt_attention import CvTSelfAttentionBlock
from sav_tpu_torch.nn.feedforward import FFBlock
from sav_tpu_torch.nn.posembed import (RotaryPositionalEmbedding,
                                       apply_rotary_pos_emb,
                                       sincos_frequencies)
from sav_tpu_torch.train import state, steps
from sav_tpu_torch.utils.flax_bridge import (flatten_tree, flax_to_torch,
                                             torch_to_flax, variables_of)
from sav_tpu_torch.utils.timm_import import convert_timm_vit
from torch_parity import fill_batchnorm, fill_biases, fill_body
import test_timm_import

TOL = 1e-5
CVT_TOL, CVT_GRAD_TOL = 1e-5, 5e-4
ZERO_GRADS = ('ConvProjectionBlock_1/BatchNorm_0/bias',
              'ConvProjectionBlock_1/Conv_1/bias')
B, D, H = 2, 64, 4


def assert_close(ours, want, what, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(ours), want, atol=tol * scale,
                               rtol=0, err_msg=what)


def _array(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _port_grads(module, inputs, cotangent):
    """Output and the gradients of sum(out * cotangent) by input and by
    flax parameter path."""
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = module(*xs)
    (out * torch.from_numpy(cotangent)).sum().backward()
    grads = torch_to_flax({n: p.grad for n, p in module.named_parameters()})
    return out.detach().numpy(), [x.grad.numpy() for x in xs], grads


def _jax_grads(apply, params, inputs, cotangent):
    out, vjp = jax.vjp(apply, params, *(jnp.asarray(x) for x in inputs))
    g_params, *g_inputs = vjp(jnp.asarray(cotangent))
    return (np.asarray(out), [np.asarray(g) for g in g_inputs],
            jax.tree_util.tree_map(np.asarray, g_params))


def _compare(ours, want, tol=TOL):
    (out, g_in, g_params), (w_out, w_in, w_params) = ours, want
    assert_close(out, w_out, 'out')
    for i, (g, w) in enumerate(zip(g_in, w_in)):
        assert_close(g, w, f'd input {i}', tol)
    flat, want_flat = flatten_tree(g_params), flatten_tree(w_params)
    assert sorted(flat) == sorted(want_flat)
    for key in want_flat:
        assert_close(flat[key], want_flat[key], f'd {key}', tol)


# ---- AttentionBlock

@pytest.mark.parametrize('extra', ['plain', 'rotary', 'talking_heads'])
@pytest.mark.parametrize('kind', ['self', 'cross'])
@pytest.mark.parametrize('use_bias,fused_qkv', [
    (True, False), (True, True), (False, True)])
def test_attention_block_matches_flax(use_bias, fused_qkv, kind, extra):
    """q/k/v (and out) biases on their flax leaves, the projections as one
    wide product (two across attention) on the same three leaves, under
    rotary embeddings and talking heads: outputs and every gradient."""
    rng = np.random.RandomState(0)
    options = dict(rotary=extra == 'rotary',
                   talking_heads=extra == 'talking_heads')
    x_q = _array(rng, B, 9, D)
    inputs = [x_q] if kind == 'self' else [x_q, _array(rng, B, 13, D)]
    cotangent = _array(rng, B, 9, D)
    flax_cls = JaxSelfAttention if kind == 'self' else JaxAttention
    flax_block = flax_cls(num_heads=H, use_bias=use_bias, fused_qkv=fused_qkv,
                          use_kernel=False, **options)
    params = flax_block.init(jax.random.PRNGKey(0),
                             *(jnp.asarray(x) for x in inputs),
                             is_training=False)['params']
    params = fill_biases(jax.tree_util.tree_map(np.array, dict(params)))
    if use_bias:
        assert params['queries']['bias'].shape == (H, D // H)
        assert params['DenseGeneral_0']['bias'].shape == (D,)
    port_cls = SelfAttentionBlock if kind == 'self' else AttentionBlock
    ours = port_cls(D, H, use_bias=use_bias, fused_qkv=fused_qkv,
                    use_kernel=False, **options)
    ours.load_state_dict(flax_to_torch(params), strict=True)
    want = _jax_grads(lambda p, *xs: flax_block.apply(
        {'params': p}, *xs, is_training=False), params, inputs, cotangent)
    _compare(_port_grads(ours, inputs, cotangent), want)


def test_biases_are_zero_at_init_and_fused_qkv_keeps_the_leaves():
    a = create_model('vit_ti_patch16', device='cpu', num_layers=1,
                     img_size=32, attn_bias=True)
    b = create_model('vit_ti_patch16', device='cpu', num_layers=1,
                     img_size=32, attn_bias=True, fused_qkv=True)
    plain = create_model('vit_ti_patch16', device='cpu', num_layers=1,
                         img_size=32)
    sa, sb, sp = a.state_dict(), b.state_dict(), plain.state_dict()
    assert sa.keys() == sb.keys()
    biases = [k for k in sa if 'SelfAttentionBlock_0' in k
              and k.endswith('bias')]
    assert len(biases) == 4 and all(not sa[k].any() for k in biases)
    # the biases draw nothing: every other leaf is the unbiased model's
    for key, value in sp.items():
        assert torch.equal(sa[key], value), key


# ---- CvT

@pytest.mark.parametrize('train', [False, True])
def test_cvt_biased_attention_matches_flax(train):
    """CvT's attention with ``use_bias``: the pointwise projections'
    biases and ``DenseGeneral_0``'s, 8 x 8 queries over 4 x 4 keys in 2
    heads of d = 64; outputs, running statistics and every gradient."""
    rng = np.random.RandomState(5)
    x = _array(rng, 2, 8, 8, 128)
    cotangent = _array(rng, 2, 64, 128)
    flax_block = JaxCvTAttention(num_heads=2, use_bias=True, use_kernel=False)
    variables = jax.jit(functools.partial(flax_block.init, is_training=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    variables = fill_batchnorm(jax.tree_util.tree_map(np.array,
                                                      dict(variables)))
    variables['params'] = fill_biases(fill_body(variables['params']))
    assert variables['params']['ConvProjectionBlock_0']['Conv_1'][
        'bias'].shape == (128,)
    assert variables['params']['DenseGeneral_0']['bias'].shape == (128,)
    ours = CvTSelfAttentionBlock(128, 2, use_bias=True, use_kernel=False)
    ours.load_state_dict(flax_to_torch(variables), strict=True)
    ours.train(train)

    def apply(p, xs):
        out, updated = flax_block.apply(
            {'params': p, 'batch_stats': variables['batch_stats']}, xs,
            is_training=train, mutable=['batch_stats'])
        return out, updated['batch_stats']

    (want, stats), vjp_fn = jax.vjp(apply, variables['params'],
                                    jnp.asarray(x))
    g_params, g_x = vjp_fn((jnp.asarray(cotangent),
                            jax.tree_util.tree_map(jnp.zeros_like, stats)))
    got, (g_in,), grads = _port_grads(ours, [x], cotangent)
    scale = float(np.abs(want).max())
    assert np.abs(got - np.asarray(want)).max() <= CVT_TOL * scale
    ours_stats = flatten_tree(variables_of(ours)['batch_stats'])
    for key, value in flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                          stats)).items():
        assert np.abs(ours_stats[key] - value).max() <= CVT_TOL * max(
            1.0, np.abs(value).max()), key
    want_grads = flatten_tree(jax.tree_util.tree_map(np.asarray, g_params))
    flat = flatten_tree(grads)
    assert sorted(flat) == sorted(want_grads)
    for key, w in {'x': np.asarray(g_x), **want_grads}.items():
        g = g_in if key == 'x' else flat[key]
        # the key projection's biases (its BatchNorm's and its pointwise
        # conv's) shift every key of an image by one vector, which the
        # softmax cancels: their true gradient is 0, f32 noise on both
        # sides (test_torch_cvt.py's ZERO_GRAD)
        if key in ZERO_GRADS:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-4, key
            continue
        assert np.abs(g - w).max() <= CVT_GRAD_TOL * np.abs(w).max(), key


# ---- rotary

def test_rotary_module_matches_flax():
    rng = np.random.RandomState(1)
    x = _array(rng, 2, 3, 11, 16)
    cotangent = _array(rng, 2, 3, 11, 16)
    freqs = sincos_frequencies(11, 16).numpy()
    np.testing.assert_allclose(freqs, np.asarray(jax_frequencies(11, 16)),
                               atol=1e-6, rtol=1e-6)
    module = RotaryPositionalEmbedding()
    flax_module = JaxRotary()
    want = _jax_grads(lambda p, xs: flax_module.apply({}, xs), {}, [x],
                      cotangent)
    xt = torch.from_numpy(x).requires_grad_()
    out = module(xt)
    (out * torch.from_numpy(cotangent)).sum().backward()
    assert_close(out.detach().numpy(), want[0], 'out')
    assert_close(xt.grad.numpy(), want[1][0], 'dx')
    out = apply_rotary_pos_emb(torch.from_numpy(x), torch.from_numpy(freqs))
    assert_close(out.numpy(), jax_rotary_pos_emb(jnp.asarray(x),
                                                 jnp.asarray(freqs)), 'fn')


# ---- FFBlock

@pytest.mark.parametrize('activation', ['gelu', 'gelu_exact', 'relu'])
def test_ff_block_activations_match_flax(activation):
    rng = np.random.RandomState(2)
    x = _array(rng, B, 7, D)
    cotangent = _array(rng, B, 7, D)
    flax_block = JaxFFBlock(expand_ratio=4,
                            activation_fn=jax_activation(activation))
    params = flax_block.init(jax.random.PRNGKey(0), jnp.asarray(x),
                             is_training=False)['params']
    params = fill_biases(jax.tree_util.tree_map(np.array, dict(params)))
    ours = FFBlock(D, 4, activation_fn=activation)
    ours.load_state_dict(flax_to_torch(params), strict=True)
    want = _jax_grads(lambda p, xs: flax_block.apply(
        {'params': p}, xs, is_training=False), params, [x], cotangent)
    _compare(_port_grads(ours, [x], cotangent), want)


def test_ff_block_refusals():
    with pytest.raises(ValueError, match='known: gelu, gelu_exact, relu'):
        FFBlock(D, 4, activation_fn='swish')
    for quantized in ('ff', 'ff_sb'):
        with pytest.raises(ValueError, match='tanh'):
            FFBlock(D, 4, quantized=quantized, activation_fn='gelu_exact')


# ---- ViT's routing of the options

def _vit(**kwargs):
    return create_model('vit_ti_patch16', device='cpu', num_layers=1,
                        img_size=32, **kwargs)


@pytest.mark.parametrize('option', ['attn_bias', 'fused_qkv'])
def test_vit_routes_the_options_as_jax(option, monkeypatch):
    """Under 'auto' a block with biases or fused projections takes the
    per-op attention (``_fused_core`` None, as the JAX model's
    ``_auto_fused_core``) where the fused core applies (as on the card,
    here by ``auto_core`` patched to pick it); a forced fused-sublayer mode
    raises naming the option, before and after the model is built."""
    from sav_tpu_torch.ops import fused_layer
    monkeypatch.setattr(fused_layer, 'auto_core', lambda *a: 'fused')
    x = torch.zeros(1, 5, 192)
    assert _vit().Encoder_0.EncoderBlock_0._fused_core(x) == 'fused'
    block = _vit(**{option: True}).Encoder_0.EncoderBlock_0
    assert block._fused_core(x) is None
    for mode in ('fused_layer', 'fused_layer_xla', 'fused_layer_full'):
        with pytest.raises(ValueError, match=option):
            _vit(use_kernel=mode, **{option: True})
    with pytest.raises(ValueError, match=option):
        set_use_kernel(_vit(**{option: True}), 'fused_layer')
    _vit(use_kernel='fused_ff', **{option: True})       # per-op attention


def test_vit_activation_routes():
    with pytest.raises(ValueError, match='fused_ff'):
        _vit(use_kernel='fused_ff', activation_fn='gelu_exact')
    with pytest.raises(ValueError, match='fused_ff'):
        set_use_kernel(_vit(activation_fn='relu'), 'fused_ff')
    for quantized in ('ff', 'ff_sb'):
        with pytest.raises(ValueError, match='tanh'):
            _vit(quantized=quantized, activation_fn='gelu_exact')
    # 'all' with the erf gelu: the FF products on the library int8 path
    block = _vit(quantized='all', activation_fn='gelu_exact'
                 ).Encoder_0.EncoderBlock_0
    assert block.FFBlock_0.quantized is True
    assert _vit(quantized='all').Encoder_0.EncoderBlock_0.FFBlock_0.quantized \
        is False
    with pytest.raises(ValueError, match='unknown activation'):
        _vit(activation_fn='gelu_tanh')


@pytest.mark.parametrize('quantized', ['all', True])
def test_vit_int8_with_erf_gelu_matches_jax(quantized):
    """``quantized`` 'all' and True with the erf gelu: the FF products on
    the library int8 path with the activation between them, as the JAX
    model's FFBlock runs them (the attention per-op: biases)."""
    model = _vit(attn_bias=True, activation_fn='gelu_exact', num_classes=10,
                 quantized=quantized, use_kernel=False)
    jax_model = JaxViT(num_classes=10, num_layers=1, num_heads=3,
                       embed_dim=192, patch_shape=(16, 16), attn_bias=True,
                       activation_fn=jax_activation('gelu_exact'),
                       quantized=quantized, use_kernel=False)
    x = np.random.RandomState(4).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            is_training=False)['params']
    params = fill_biases(fill_body(jax.tree_util.tree_map(
        np.array, dict(params))))
    rng = np.random.RandomState(1)
    params['Dense_0']['kernel'] = _array(rng, 192, 10, std=0.1)
    params['cls'] = _array(rng, 1, 1, 192)
    model.load_state_dict(flax_to_torch(params), strict=True)
    want = jax_model.apply({'params': params}, jnp.asarray(x),
                           is_training=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert_close(got, want, 'logits', 1e-4)


# ---- three train steps of an imported ViT

STEP_EPS = 1e-3
IMG = test_timm_import.IMG
CLASSES = test_timm_import.CLASSES


def _batch(i, n=4):
    rng = np.random.RandomState(20 + i)
    return {'images': rng.standard_normal((n, IMG, IMG, 3)).astype(np.float32),
            'labels': rng.randint(0, CLASSES, (n,)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _imported():
    """A timm-layout ViT (biases, erf gelu; D = 64 in 4 heads, 3 layers,
    8-px patches at 32 px, 13 classes), every parameter seeded, through
    both converters (the trees are equal bit for bit,
    test_torch_import.py)."""
    torch.manual_seed(0)
    model = test_timm_import._TimmViT()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return sd


@functools.lru_cache(maxsize=None)
def _jax_train(fused_qkv):
    params, kwargs = jax_convert_timm(_imported(), num_heads=4)
    model = JaxViT(**kwargs, fused_qkv=fused_qkv, use_kernel=False)
    tx = jax_state.build_optimizer(1e-3, eps=STEP_EPS)
    jstate = jax_state.TrainState.create({'params': params}, tx)
    step = jax.jit(functools.partial(
        jax_steps.train_step, model=model, tx=tx, num_classes=CLASSES,
        label_smoothing=0.1))
    metrics = []
    for i in range(3):
        batch = {k: jnp.asarray(v) for k, v in _batch(i).items()}
        jstate, m = step(jstate, batch, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                        jstate.params))


@pytest.mark.parametrize('fused_qkv', [False, True])
def test_imported_vit_train_steps_match_jax(fused_qkv):
    want_metrics, want_params = _jax_train(fused_qkv)
    params, kwargs = convert_timm_vit(_imported(), num_heads=4)
    assert kwargs['activation_fn'] == 'gelu_exact' and kwargs['attn_bias']
    model = ViT(**kwargs, img_size=IMG, fused_qkv=fused_qkv, use_kernel=False)
    model.load_state_dict(flax_to_torch(params), strict=True)
    ts = state.TrainState(model, state.build_optimizer(
        model.parameters(), 1e-3, eps=STEP_EPS))
    for i in range(3):
        batch = {k: torch.from_numpy(v.astype(np.int64) if k == 'labels'
                                     else v) for k, v in _batch(i).items()}
        m = steps.train_step(ts, batch, num_classes=CLASSES,
                             label_smoothing=0.1)
        assert sorted(m) == sorted(want_metrics[i])
        for k, v in m.items():
            np.testing.assert_allclose(float(v), want_metrics[i][k],
                                       atol=1e-5, rtol=0, err_msg=f'{i} {k}')
    ours = flatten_tree(torch_to_flax(model.state_dict()))
    assert sorted(ours) == sorted(want_params)
    for k in ours:
        np.testing.assert_allclose(ours[k], want_params[k], atol=1e-5, rtol=0,
                                   err_msg=k)
