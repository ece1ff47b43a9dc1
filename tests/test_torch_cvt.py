"""Torch port: CvT. A small CvT (``torch_parity.CVT_SMALL``: cvt-13's block
types at 32 px, stage sizes (1, 1, 2), widths 64/128/256 in heads of
d = 64, so stage 3's 5 tokens zero-pad to a 3 x 3 grid) from one flax
``{'params', 'batch_stats'}`` tree with the head, cls, LayerNorms,
BatchNorms and biases filled, against ``sav_tpu.models.CvT``: the
depthwise ``Conv`` at strides 1 and 2 (even and odd grids: 'SAME' pads
unevenly at stride 2), ``ConvProjectionBlock``, ``CvTSelfAttentionBlock``
(per-op, on the flash route, with talking heads) and ``StageBlock`` on a
grid that needs padding, each in eval and train mode with the running
statistics; logits and running statistics per ``use_kernel`` (off the
card 'auto' is per-op and 'kernel' runs the flash kernels' twins; the JAX
side's Pallas kernel in interpret mode); every gradient; the int8 FF
(``quantized='ff'`` and ``'all'``) at the 256-wide stage, its logits and
gradients; the state-dict
keys and shapes against the flax trees of cvt-13/-21/-w24 at 224
(``jax.eval_shape``) and a cvt-13 tree through the bridge and back;
flax's init; the refusals.

float32. Tolerances as in test_torch_ceit.py: modules and running
statistics within 1e-5 of max |out| (f32 reductions and convolutions in
another order); logits within 1e-4 of max |logit| and gradients within
5e-4 of each parameter's max |grad| (three stages of f32 math summed in
other orders). The int8 routes are held as test_torch_int8_models.py
holds them: 1e-4 of max |logit|, and each must move the logits by at
least 10x that from the unquantized model of the same tree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.models.cvt import StageBlock as JaxStageBlock
from sav_tpu.nn.cvt_attention import ConvProjectionBlock as JaxConvProjection
from sav_tpu.nn.cvt_attention import CvTSelfAttentionBlock as JaxCvTSelfAttention
from sav_tpu_torch.models import create_model, set_int8_core, set_use_kernel
from sav_tpu_torch.models import cvt
from sav_tpu_torch.models.factory import MODEL_CONFIGS
from sav_tpu_torch.nn.cvt_attention import (ConvProjectionBlock,
                                            CvTAttentionBlock,
                                            CvTSelfAttentionBlock)
from sav_tpu_torch.nn.layers import Conv
from sav_tpu_torch.utils.flax_bridge import (flatten_tree, flax_to_torch,
                                             torch_to_flax, unflatten_tree,
                                             variables_of)
from torch_parity import (CVT_IMG, CVT_SMALL, NUM_CLASSES, fill_batchnorm,
                          fill_biases, fill_body, images, jax_cvt, torch_cvt)

MODES = (False, 'auto', 'kernel')
NAMES = ('cvt-13', 'cvt-21', 'cvt-w24')
MODULE_TOL = 1e-5
LOGIT_TOL = 1e-4
GRAD_TOL = 5e-4
# the key projection's BatchNorm bias moves every key of an image by one
# vector, so every logit of a query by one constant, which the softmax
# cancels: its true gradient is 0 (f32 noise in both frameworks)
ZERO_GRAD = 'ConvProjectionBlock_1/BatchNorm_0/bias'
# one bf16 ulp: the int8 FF's W2 gradient reads the bf16-stored
# pre-activation (test_int8_ff_gradients_match_jax says what it measured)
HPRE_TOL = 2.0 ** -8


def _close(got, want, tol, what=''):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * scale, (what, err, scale)


def _stats_close(model, want_tree):
    stats = flatten_tree(variables_of(model)['batch_stats'])
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, want_tree))
    assert sorted(stats) == sorted(want)
    for key, value in stats.items():
        _close(value, want[key], MODULE_TOL, key)


def _grid(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# ---- the depthwise (grouped) convolution

@pytest.mark.parametrize('stride,side,groups', [
    (1, 8, 16), (2, 8, 16), (2, 15, 16), (2, 56, 16), (2, 8, 4)])
def test_grouped_conv_matches_flax(stride, side, groups):
    """flax ``nn.Conv`` with ``feature_group_count``: a 3 x 3 'SAME' conv,
    no bias, at stride 1 and 2 (an even grid pads (0, 1), an odd one
    (1, 1)); 16 groups of 16 channels is the depthwise case."""
    x = _grid((2, side, side, 16), seed=1)
    flax_conv = fnn.Conv(features=16, kernel_size=(3, 3),
                         strides=(stride, stride), padding='SAME',
                         feature_group_count=groups, use_bias=False)
    kernel = 0.3 * _grid((3, 3, 16 // groups, 16), seed=2)
    want = flax_conv.apply({'params': {'kernel': kernel}}, jnp.asarray(x))
    ours = Conv(16, 16, (3, 3), (stride, stride), feature_group_count=groups)
    ours.load_state_dict({'kernel': torch.from_numpy(kernel)})
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    assert got.shape == want.shape == (2, -(-side // stride),
                                       -(-side // stride), 16)
    _close(got.numpy(), want, MODULE_TOL)


def test_ungrouped_conv_is_unchanged():
    """``feature_group_count=1`` (every caller before CvT) is the same
    ``F.conv2d`` call as without groups, bit for bit, and a 1 x 1 kernel
    keeps its matmul; groups that do not divide the features raise."""
    x = torch.from_numpy(_grid((2, 9, 9, 8), seed=3))
    conv = Conv(8, 12, (3, 3), (2, 2), use_bias=True)
    conv.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = conv(x)
        want = torch.nn.functional.conv2d(
            torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1)),
            conv.kernel.permute(3, 2, 0, 1), conv.bias, stride=(2, 2))
    assert torch.equal(got, want.permute(0, 2, 3, 1))
    with pytest.raises(ValueError, match='groups'):
        Conv(8, 12, (3, 3), feature_group_count=3)


# ---- the modules

def _module_variables(module, x, **kwargs):
    """The flax module's own init (jitted), its BatchNorms, LayerNorms and
    biases filled away from their inits, as numpy."""
    variables = jax.jit(functools.partial(module.init, is_training=False,
                                          **kwargs))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    variables = fill_batchnorm(jax.tree_util.tree_map(np.array,
                                                      dict(variables)))
    variables['params'] = fill_biases(fill_body(variables['params']))
    return variables


def _module_case(flax_module, torch_module, x, train):
    variables = _module_variables(flax_module, x)
    want, updated = jax.jit(functools.partial(
        flax_module.apply, is_training=train, mutable=['batch_stats']))(
            variables, jnp.asarray(x))
    torch_module.load_state_dict(flax_to_torch(variables), strict=True)
    with torch.no_grad():
        got = torch_module.train(train)(torch.from_numpy(x))
    _close(got.numpy(), want, MODULE_TOL)
    _stats_close(torch_module, updated['batch_stats'])


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('stride,side', [(1, 8), (2, 8), (2, 15)])
def test_conv_projection_block_matches_flax(stride, side, train):
    x = _grid((2, side, side, 64), seed=4)
    flax_block = JaxConvProjection(out_ch=64, strides=stride, use_bias=False)
    ours = ConvProjectionBlock(64, 64, strides=stride, use_bias=False)
    _module_case(flax_block, ours, x, train)


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('use_kernel,talking_heads', [
    (False, False), ('kernel', False), ('auto', True)])
def test_self_attention_block_matches_flax(use_kernel, talking_heads, train):
    """8 x 8 queries over 4 x 4 keys in 2 heads of d = 64; 'kernel' runs
    the flash route (K4's and K2/K3's twins here, the Pallas kernel in
    interpret mode on the JAX side); talking heads run per-op."""
    x = _grid((2, 8, 8, 128), seed=5)
    flax_block = JaxCvTSelfAttention(num_heads=2, use_kernel=use_kernel,
                                     talking_heads=talking_heads)
    ours = CvTSelfAttentionBlock(128, 2, use_kernel=use_kernel,
                                 talking_heads=talking_heads)
    _module_case(flax_block, ours, x, train)


@pytest.mark.parametrize('train', [False, True])
def test_stage_block_pads_like_flax(train):
    """Five tokens (a cls row and a 2 x 2 grid) zero-pad to 3 x 3: the
    block returns 9 tokens, the padded rows carried in the residual."""
    x = _grid((2, 5, 256), seed=6)
    flax_block = JaxStageBlock(num_heads=4, embed_dim=256)
    ours = cvt.StageBlock(4, 256)
    variables = _module_variables(flax_block, x)
    want, updated = jax.jit(functools.partial(
        flax_block.apply, is_training=train, mutable=['batch_stats']))(
            variables, jnp.asarray(x))
    ours.load_state_dict(flax_to_torch(variables), strict=True)
    with torch.no_grad():
        got = ours.train(train)(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 9, 256)
    _close(got.numpy(), want, MODULE_TOL)
    _stats_close(ours, updated['batch_stats'])


def test_zero_pad_and_reshape():
    x = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    grid = cvt.zero_pad_and_reshape(x)
    assert grid.shape == (2, 3, 3, 3)
    assert torch.equal(grid.reshape(2, 9, 3)[:, :5], x)
    assert torch.count_nonzero(grid.reshape(2, 9, 3)[:, 5:]) == 0
    square = torch.ones(1, 16, 4)
    assert cvt.zero_pad_and_reshape(square).shape == (1, 4, 4, 4)


# ---- the model

@functools.lru_cache(maxsize=None)
def _jax_logits(use_kernel, train):
    model, variables = jax_cvt(use_kernel=use_kernel)
    logits, updated = jax.jit(functools.partial(
        model.apply, is_training=train, mutable=['batch_stats']))(
            variables, jnp.asarray(images(3, CVT_IMG, seed=5)))
    return np.asarray(logits), updated['batch_stats']


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('use_kernel', MODES)
def test_logits_and_running_stats_match_jax(use_kernel, train):
    want, want_stats = _jax_logits(use_kernel, train)
    _, variables = jax_cvt()
    model = torch_cvt(variables, use_kernel=use_kernel).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(images(3, CVT_IMG, seed=5)))
    assert got.shape == (3, NUM_CLASSES)
    _close(got.numpy(), want, LOGIT_TOL)
    _stats_close(model, want_stats)


@functools.lru_cache(maxsize=None)
def _jax_grads(use_kernel, quantized=False, train=True):
    model, variables = jax_cvt(use_kernel=use_kernel, quantized=quantized)
    x = jnp.asarray(images(3, CVT_IMG, seed=6))
    cot = np.random.RandomState(7).standard_normal(
        (3, NUM_CLASSES)).astype(np.float32)

    def loss(params):
        logits, _ = model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']}, x,
            is_training=train, mutable=['batch_stats'])
        return jnp.sum(logits * cot)

    grads = jax.jit(jax.grad(loss))(variables['params'])
    return flatten_tree(jax.tree_util.tree_map(np.asarray, grads)), cot


def _torch_grads(cot, train=True, **kwargs):
    _, variables = jax_cvt()
    model = torch_cvt(variables, **kwargs).train(train)
    logits = model(torch.from_numpy(images(3, CVT_IMG, seed=6)))
    (logits * torch.from_numpy(cot)).sum().backward()
    return flatten_tree(torch_to_flax(
        {n: p.grad for n, p in model.named_parameters()}))


def _grads_close(got, want, tols=()):
    """Each gradient within GRAD_TOL of its own max (or the tolerance of
    the first ``tols`` (suffix, tolerance) its key ends with); the key
    projections' BatchNorm biases (``ZERO_GRAD``) below 1e-6 of the largest
    gradient, in both frameworks."""
    assert sorted(got) == sorted(want)
    largest = max(float(np.abs(g).max()) for g in want.values())
    for key in got:
        if key.endswith(ZERO_GRAD):
            for g in (got[key], want[key]):
                assert float(np.abs(g).max()) <= 1e-6 * largest, key
        else:
            tol = next((t for end, t in tols if key.endswith(end)), GRAD_TOL)
            _close(got[key], want[key], tol, key)


@pytest.mark.parametrize('use_kernel', MODES)
def test_gradients_match_jax(use_kernel):
    """Every parameter's gradient in training mode."""
    want, cot = _jax_grads(use_kernel)
    _grads_close(_torch_grads(cot, use_kernel=use_kernel), want)


def test_int8_ff_gradients_match_jax():
    """Every parameter's gradient through the int8 FF sublayer (K13's
    training variant's twin: its bf16-stored hpre feeds the straight-through
    backward), with the BatchNorms on their running statistics. In training
    mode the batch statistics' f32 rounding flips int8 codes that sit at .5:
    there the port against itself moves by 3.5e-3 to 4.3e-3 of max |logit|
    for a one-ulp change of the input (batches of 4 at 32 px; 1e-6 without
    the int8 FF), so the int8 route is held where the two packages' codes
    agree. The backward reads the pre-activation from the kernel's bf16
    store in both packages, and an f32 ulp of the f32 value before it
    moves some elements by one bf16 ulp (2^-8): W2's gradient, gelu(hpre)^T
    g over the 27 rows of 3 images, is read 1.3e-3 of max from the JAX
    package's, every other gradient within 8.2e-5; W2's is held at
    ``HPRE_TOL`` = 2^-8, the rest at GRAD_TOL. The route must move the
    256-wide stage's FF gradients by at least 10x GRAD_TOL from the
    unquantized model's."""
    want, cot = _jax_grads('auto', 'ff', train=False)
    got = _torch_grads(cot, train=False, quantized='ff')
    _grads_close(got, want, [('FFBlock_0/Dense_1/kernel', HPRE_TOL)])
    plain = _torch_grads(cot, train=False)
    ff = [k for k in got if k.startswith('Stage_2/') and '/FFBlock_0/' in k]
    moved = max(np.abs(got[k] - plain[k]).max() / np.abs(got[k]).max()
                for k in ff)
    assert len(ff) == 8 and moved >= 10 * GRAD_TOL, moved


@pytest.mark.parametrize('quantized', ['ff', 'all'])
def test_int8_ff_logits_match_jax(quantized):
    """The int8 FF sublayer (K13's twin here, the JAX kernel in interpret
    mode) at the 256-wide stage only: the 64- and 128-wide stages keep
    their bf16 FF, as the JAX model routes them."""
    jmodel, variables = jax_cvt(quantized=quantized)
    x = images(2, CVT_IMG, seed=7)
    want = np.asarray(jax.jit(functools.partial(
        jmodel.apply, is_training=False))(variables, jnp.asarray(x)))
    model = torch_cvt(variables, quantized=quantized).eval()
    plain = torch_cvt(variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        unquantized = plain(torch.from_numpy(x))
        set_int8_core(model, 'plain')       # the twin: K13's reference
        twin = model(torch.from_numpy(x))
    quantized_blocks = [m.quantize_ff for m in model.modules()
                        if isinstance(m, cvt.StageBlock)]
    assert quantized_blocks == [False, False, True, True]
    scale = np.abs(want).max()
    err = np.abs(got.numpy() - want).max() / scale
    moved = np.abs(unquantized.numpy() - want).max() / scale
    assert err <= LOGIT_TOL and moved >= 10 * LOGIT_TOL, (err, moved)
    assert torch.equal(twin, got)             # off the card: the same twin


def test_routes_agree_and_auto_is_per_op_off_the_card():
    """'auto' off the card is the per-op path, bit for bit; the flash
    route ('kernel', its twins here) and its plain core (the card's
    gradient reference) agree with it to f32 rounding; re-routing keeps
    the weights."""
    x = torch.from_numpy(images(2, CVT_IMG, seed=8))
    _, variables = jax_cvt()
    model = torch_cvt(variables, use_kernel='auto').eval()
    with torch.no_grad():
        auto = model(x)
        set_use_kernel(model, False)
        plain = model(x)
        set_use_kernel(model, 'kernel')
        kernel = model(x)
        cvt.set_attention_core(model, 'plain')
        twin = model(x)
    assert torch.equal(auto, plain)
    _close(kernel.numpy(), plain.numpy(), LOGIT_TOL)
    assert torch.equal(twin, kernel)
    with pytest.raises(ValueError, match='core'):
        cvt.set_attention_core(model, 'flash')


def _tree_shapes(name):
    shapes = jax.eval_shape(
        lambda: jax_create_model(name, num_classes=1000).init(
            jax.random.PRNGKey(0), jnp.ones((1, 224, 224, 3)),
            is_training=False))
    return {k: tuple(v.shape) for k, v in flatten_tree(
        jax.tree_util.tree_map(lambda a: np.broadcast_to(np.float32(0),
                                                         a.shape),
                               {c: shapes[c] for c in ('params',
                                                       'batch_stats')})
    ).items()}


@pytest.mark.parametrize('name', NAMES)
def test_state_dict_matches_the_flax_tree(name):
    """Every parameter and running statistic of cvt-13/-21/-w24 @224 under
    the flax path and shape (``jax.eval_shape``, no weights made)."""
    want = _tree_shapes(name)
    model_cls, config = MODEL_CONFIGS[name]
    with torch.device('meta'):         # shapes only: cvt-w24 is 2.8e8 values
        model = model_cls(num_classes=1000, img_size=224, **config)
    buffers = {n for n, _ in model.named_buffers()}
    got = {('batch_stats/' if k in buffers else 'params/')
           + k.replace('.', '/'): tuple(v.shape)
           for k, v in model.state_dict().items()}
    assert got == want


def test_cvt13_tree_round_trips_through_the_bridge():
    """A cvt-13 flax ``{'params', 'batch_stats'}`` tree of random values
    loads into the port (strict) and comes back out key for key, value for
    value: the stage embeddings, ``Stage_2/cls``, each projection's
    ``Conv_0``/``BatchNorm_0``/``Conv_1``, ``DenseGeneral_0``, the head."""
    shapes = _tree_shapes('cvt-13')
    rng = np.random.RandomState(9)
    flat = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    variables = unflatten_tree(flat)
    for key in ('params/Stage_2/cls', 'params/Stage_0/ConvTokenEmbedBlock_0/'
                'Conv_0/bias', 'params/Dense_0/kernel',
                'params/Stage_2/StageBlock_9/CvTSelfAttentionBlock_0/'
                'DenseGeneral_0/kernel',
                'batch_stats/Stage_1/StageBlock_1/CvTSelfAttentionBlock_0/'
                'ConvProjectionBlock_2/BatchNorm_0/var'):
        assert key in flat, key
    model = create_model('cvt-13', num_classes=1000, device='cpu')
    model.load_state_dict(flax_to_torch(variables), strict=True)
    back = variables_of(model)
    assert sorted(back) == ['batch_stats', 'params']
    got = {f'{c}/{k}': v for c in back
           for k, v in flatten_tree(back[c]).items()}
    assert sorted(got) == sorted(flat)
    assert all(np.array_equal(got[k], flat[k]) for k in flat)


def test_init_follows_flax():
    """flax's initialisers: the convs lecun-normal over kh * kw * in /
    groups (the depthwise kernel's fan-in is 9), the token embeddings'
    biases zero, the head and cls zero, the BatchNorms (1, 0) with
    statistics (0, 1)."""
    model = create_model('cvt-13', num_classes=NUM_CLASSES, device='cpu',
                         seed=3)
    sd = model.state_dict()
    block = 'Stage_2.StageBlock_0.CvTSelfAttentionBlock_0'
    depthwise = sd[f'{block}.ConvProjectionBlock_1.Conv_0.kernel']
    assert depthwise.shape == (3, 3, 1, 384)
    for w, fan_in in ((depthwise, 9),
                      (sd[f'{block}.ConvProjectionBlock_1.Conv_1.kernel'],
                       384),
                      (sd['Stage_0.ConvTokenEmbedBlock_0.Conv_0.kernel'],
                       49 * 3)):
        std = fan_in ** -0.5
        assert abs(float(w.std()) - std) < 0.1 * std, fan_in
        assert float(w.abs().max()) <= 2.0 * std / 0.8796 + 1e-6
    assert f'{block}.ConvProjectionBlock_1.Conv_1.bias' not in sd
    assert torch.count_nonzero(
        sd['Stage_1.ConvTokenEmbedBlock_0.Conv_0.bias']) == 0
    for key in ('Dense_0.kernel', 'Dense_0.bias', 'Stage_2.cls'):
        assert torch.count_nonzero(sd[key]) == 0
    assert 'Stage_0.cls' not in sd and 'Stage_1.cls' not in sd
    bn = f'{block}.ConvProjectionBlock_0.BatchNorm_0'
    assert torch.equal(sd[f'{bn}.scale'], torch.ones(384))
    assert torch.equal(sd[f'{bn}.mean'], torch.zeros(384))
    assert torch.equal(sd[f'{bn}.var'], torch.ones(384))


def test_refusals():
    kw = dict(device='cpu', img_size=CVT_IMG, **CVT_SMALL)
    with pytest.raises(NotImplementedError, match='Queue 1 item 1'):
        create_model('cvt-13', scan_layers=True, **kw)
    for quantized in ('ff_sb', True):
        with pytest.raises(ValueError, match='quantized'):
            create_model('cvt-13', quantized=quantized, **kw)
    with pytest.raises(NotImplementedError, match='CvT mode'):
        create_model('cvt-13', use_kernel='fused_layer', **kw)
    model = create_model('cvt-13', **kw)
    with pytest.raises(NotImplementedError, match='CvT mode'):
        set_use_kernel(model, 'botnet_fused')
    for rate in ('attn_dropout_rate', 'out_dropout_rate'):
        with pytest.raises(NotImplementedError, match='dropout'):
            CvTAttentionBlock(128, 2, **{rate: 0.1})
    # the projection biases build (on the pointwise convs and the out
    # projection; test_torch_attention_options.py holds them to flax)
    block = CvTAttentionBlock(128, 2, use_bias=True)
    assert block.ConvProjectionBlock_2.Conv_1.bias.shape == (128,)
    assert block.DenseGeneral_0.bias.shape == (128,)
    assert CvTAttentionBlock(128, 2).DenseGeneral_0.bias is None
    # the flash route takes no head mixing
    block = CvTSelfAttentionBlock(128, 2, use_kernel='kernel',
                                  talking_heads=True)
    with pytest.raises(ValueError, match='head mixing'):
        block(torch.zeros(1, 8, 8, 128))
    # a scan-stacked CvT tree (its stage blocks past the first under
    # 'StageBlock') is refused by the bridge
    with pytest.raises(NotImplementedError, match='scan-stacked'):
        flax_to_torch({'params': {'Stage_2': {'StageBlock': {
            'LayerNorm_0': {'scale': np.ones((9, 4), np.float32)}}}}})
