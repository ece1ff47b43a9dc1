"""Torch port: CeiT. A small CeiT (``torch_parity.CEIT_SMALL``: 2 post-LN
blocks, D = 128, H = 2, d = 64, at 64 px, so L = 17 and each LeFF conv runs
on a 4 x 4 grid) from one flax ``{'params', 'batch_stats'}`` tree with the
head, cls, LayerNorms, BatchNorms and biases filled, against
``sav_tpu.models.CeiT``: its modules alone (the Image2Token stem, the LeFF
block, the LCA encoder block), the post-LN attention sublayer
``attention_sublayer_noln`` per core against the JAX function (its Pallas
cores in interpret mode, as ``tests/test_fused_layer.py`` runs them),
K1's plain twin against the JAX kernel's own launcher (interpret mode) with
and without the LN and at D = 192, logits and running statistics per
``use_kernel`` in eval and train mode, gradients; the port's state-dict
keys and shapes against the flax trees of ceit_t/s/b at 224
(``jax.eval_shape``); the refusals.

float32. Tolerances: modules and running statistics within 1e-5 of max |out|
(f32 reductions and convolutions in another order); the sublayer forward
2e-5 and its five gradients 5e-4 rel / 5e-5 abs (``test_fused_layer.py``'s
own); logits within 1e-4 of max |logit| and gradients within 5e-4 of each
parameter's max |grad| (two post-LN blocks of f32 math summed in other
orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.models.ceit import LCAEncoderBlock as JaxLCA
from sav_tpu.nn import Image2TokenBlock as JaxI2T
from sav_tpu.nn import LeFFBlock as JaxLeFF
from sav_tpu.ops import fused_layer as jax_fl
from sav_tpu_torch.models import create_model, set_use_kernel
from sav_tpu_torch.models import ceit
from sav_tpu_torch.models.factory import MODEL_CONFIGS
from sav_tpu_torch.nn.feedforward import LeFFBlock
from sav_tpu_torch.nn.stems import Image2TokenBlock
from sav_tpu_torch.ops import fused_layer
from sav_tpu_torch.utils.flax_bridge import (flatten_tree, flax_to_torch,
                                             torch_to_flax, variables_of)
from torch_parity import (CEIT_IMG, NUM_CLASSES, fill_batchnorm, fill_biases,
                          images, jax_ceit, torch_ceit)

MODES = (False, 'auto', 'fused_layer', 'fused_layer_xla', 'fused_layer_full')
NAMES = ('ceit_t', 'ceit_s', 'ceit_b')
MODULE_TOL = 1e-5
LOGIT_TOL = 1e-4
GRAD_TOL = 5e-4
# the LeFF biases a train-mode BatchNorm follows (zero true gradient)
BN_FED_BIASES = tuple(f'LeFFBlock_0/{m}/bias'
                      for m in ('Dense_0', 'Conv_0', 'Dense_1'))


def _flax_variables(module, *inputs, seed=0, **kwargs):
    """A flax module's variables, every parameter and statistic drawn from
    the seed (BatchNorm scales and variances positive), as numpy."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *inputs, **kwargs))
    rng = np.random.RandomState(seed)
    draw = lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    variables = jax.tree_util.tree_map(draw, dict(shapes))
    if 'batch_stats' in variables:
        variables = fill_batchnorm(variables, seed)
    variables['params'] = fill_biases(variables['params'], seed)
    return variables


def _close(got, want, tol, what=''):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * scale, (what, err, scale)


def _module_case(flax_module, torch_module, x, train):
    variables = _flax_variables(flax_module, jnp.asarray(x), is_training=False)
    want, updated = jax.jit(functools.partial(
        flax_module.apply, is_training=train, mutable=['batch_stats']))(
            variables, jnp.asarray(x))
    torch_module.load_state_dict(flax_to_torch(variables), strict=True)
    with torch.no_grad():
        got = torch_module.train(train)(torch.from_numpy(x))
    _close(got.numpy(), want, MODULE_TOL)
    stats = flatten_tree(variables_of(torch_module)['batch_stats'])
    want_stats = flatten_tree(jax.tree_util.tree_map(
        np.asarray, updated['batch_stats']))
    assert sorted(stats) == sorted(want_stats)
    for key, value in stats.items():
        _close(value, want_stats[key], MODULE_TOL, key)


@pytest.mark.parametrize('train', [False, True])
def test_image2token_matches_flax(train):
    x = images(2, CEIT_IMG, seed=3)
    flax_i2t = JaxI2T(patch_shape=(4, 4), num_ch=32, conv_kernel_size=7,
                      conv_stride=2, pool_window_size=3, pool_stride=2,
                      embed_dim=128)
    ours = Image2TokenBlock((4, 4), 32, 7, 2, 3, 2, 128)
    _module_case(flax_i2t, ours, x, train)


@pytest.mark.parametrize('train', [False, True])
def test_leff_matches_flax(train):
    x = np.random.RandomState(4).standard_normal((2, 17, 128)).astype(
        np.float32)
    flax_leff = JaxLeFF(expand_ratio=4, kernel_size=3)
    ours = LeFFBlock(128, 4, kernel_size=3)
    _module_case(flax_leff, ours, x, train)


def test_lca_encoder_block_matches_flax():
    x = np.random.RandomState(5).standard_normal((2, 6, 128)).astype(
        np.float32)
    flax_lca = JaxLCA(num_heads=2, use_kernel=False)
    params = _flax_variables(flax_lca, jnp.asarray(x), is_training=False)
    want = flax_lca.apply(params, jnp.asarray(x), is_training=False)
    ours = ceit.LCAEncoderBlock(128, 2, use_kernel=False)
    ours.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    _close(got.numpy(), want, MODULE_TOL)


# ---- the post-LN attention sublayer

B, L, D, H = 2, 17, 128, 2
SUBLAYER_ARGS = ('x', 'wq', 'wk', 'wv', 'wo')


def _sublayer_inputs(dim=D, heads=H, l=L, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    d = dim // heads
    return dict(x=mk(B, l, dim), scale=1.0 + 0.1 * mk(dim), bias=0.1 * mk(dim),
                wq=mk(dim, heads, d, std=dim ** -0.5),
                wk=mk(dim, heads, d, std=dim ** -0.5),
                wv=mk(dim, heads, d, std=dim ** -0.5),
                wo=mk(heads, d, dim, std=dim ** -0.5),
                cot=mk(B, l, dim))


@functools.lru_cache(maxsize=None)
def _jax_noln(core):
    p = _sublayer_inputs()
    args = [jnp.asarray(p[k]) for k in SUBLAYER_ARGS]
    fn = lambda *a: jax_fl.attention_sublayer_noln(*a, H, core)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * p['cot']),
                     argnums=tuple(range(5)))(*args)
    return np.asarray(fn(*args)), [np.asarray(g) for g in grads]


@pytest.mark.parametrize('core', fused_layer.CORES)
def test_noln_sublayer_matches_jax(core):
    p = _sublayer_inputs()
    want, want_grads = _jax_noln(core)
    args = [torch.from_numpy(p[k]).requires_grad_() for k in SUBLAYER_ARGS]
    out = fused_layer.attention_sublayer_noln(*args, H, core)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=2e-5,
                               rtol=2e-5)
    (out * torch.from_numpy(p['cot'])).sum().backward()
    for t, g, name in zip(args, want_grads, SUBLAYER_ARGS):
        np.testing.assert_allclose(t.grad.numpy(), g, atol=5e-5, rtol=5e-4,
                                   err_msg=f'{core}: {name}')
    with torch.no_grad():          # the forward that keeps no residuals
        again = fused_layer.attention_sublayer_noln(
            *[torch.from_numpy(p[k]) for k in SUBLAYER_ARGS], H, core)
    np.testing.assert_allclose(again.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize('dim,heads,pre_ln', [(128, 2, False), (192, 3, True),
                                              (192, 3, False)])
def test_k1_twin_matches_jax_kernel(dim, heads, pre_ln):
    """K1's plain twin, the post-LN route and the pre-LN one at D = 192
    (the projection GEMM's 192-wide tile on the card), against the Pallas
    kernel's own launcher (interpret mode), both variants."""
    p = _sublayer_inputs(dim, heads, l=65)
    hd = dim
    j = {k: jnp.asarray(v) for k, v in p.items()}
    want_out, want_res = jax_fl._fused_fwd(
        j['x'], j['scale'], j['bias'], j['wq'], j['wk'], j['wv'], j['wo'],
        heads, 64, jax_fl.LN_EPS, True, pre_ln, save_residuals=True)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    out, res = fused_layer.fused_attention_fwd(
        t['x'], t['scale'] if pre_ln else None, t['bias'] if pre_ln else None,
        t['wq'].reshape(dim, hd), t['wk'].reshape(dim, hd),
        t['wv'].reshape(dim, hd), t['wo'].reshape(hd, dim), heads,
        save_residuals=True, pre_ln=pre_ln)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-5,
                               rtol=0)
    for ours, theirs in zip(res[:4], want_res[:4]):       # q, k, v, attn
        np.testing.assert_allclose(ours.numpy(),
                                   np.asarray(theirs)[:, :65], atol=2e-5,
                                   rtol=0)
    np.testing.assert_allclose(res[4].numpy(),
                               np.asarray(want_res[4])[:, :, :65, 0],
                               atol=2e-5, rtol=0)


# ---- the model

@functools.lru_cache(maxsize=None)
def _jax_logits(use_kernel, train):
    model, variables = jax_ceit(use_kernel=use_kernel)
    logits, updated = jax.jit(functools.partial(
        model.apply, is_training=train, mutable=['batch_stats']))(
            variables, jnp.asarray(images(3, CEIT_IMG, seed=5)))
    return np.asarray(logits), flatten_tree(jax.tree_util.tree_map(
        np.asarray, updated['batch_stats']))


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('use_kernel', MODES)
def test_logits_and_running_stats_match_jax(use_kernel, train):
    want, want_stats = _jax_logits(use_kernel, train)
    _, variables = jax_ceit()
    model = torch_ceit(variables, use_kernel=use_kernel).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(images(3, CEIT_IMG, seed=5)))
    assert got.shape == (3, NUM_CLASSES)
    _close(got.numpy(), want, LOGIT_TOL)
    stats = flatten_tree(variables_of(model)['batch_stats'])
    assert sorted(stats) == sorted(want_stats)
    for key, value in stats.items():
        _close(value, want_stats[key], MODULE_TOL, key)


@functools.lru_cache(maxsize=None)
def _jax_grads(use_kernel):
    model, variables = jax_ceit(use_kernel=use_kernel)
    x = jnp.asarray(images(3, CEIT_IMG, seed=6))
    cot = np.random.RandomState(7).standard_normal(
        (3, NUM_CLASSES)).astype(np.float32)

    def loss(params):
        logits, _ = model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']}, x,
            is_training=True, mutable=['batch_stats'])
        return jnp.sum(logits * cot)

    grads = jax.jit(jax.grad(loss))(variables['params'])
    return flatten_tree(jax.tree_util.tree_map(np.asarray, grads)), cot


@pytest.mark.parametrize('use_kernel', MODES)
def test_gradients_match_jax(use_kernel):
    """Every parameter's gradient in training mode. The biases of the LeFF
    Dense and conv layers each feed a BatchNorm on batch statistics, which
    subtracts their channel's mean again: their gradient is 0 in exact
    arithmetic and f32 noise in both frameworks, so they are held below
    1e-6 of the largest gradient, the rest within GRAD_TOL of their own
    max."""
    want, cot = _jax_grads(use_kernel)
    _, variables = jax_ceit()
    model = torch_ceit(variables, use_kernel=use_kernel).train()
    logits = model(torch.from_numpy(images(3, CEIT_IMG, seed=6)))
    (logits * torch.from_numpy(cot)).sum().backward()
    got = flatten_tree(torch_to_flax(
        {n: p.grad for n, p in model.named_parameters()}))
    assert sorted(got) == sorted(want)
    largest = max(float(np.abs(g).max()) for g in want.values())
    for key in got:
        if key.endswith(BN_FED_BIASES):
            for g in (got[key], want[key]):
                assert float(np.abs(g).max()) <= 1e-6 * largest, key
        else:
            _close(got[key], want[key], GRAD_TOL, key)


def test_routes_agree_and_auto_is_per_op_off_the_card():
    """'auto' off the card is the per-op path, bit for bit; the fused
    routes read the same parameters and agree to f32 rounding; the LCA
    under use_kernel=True runs K4's twin off the card."""
    x = torch.from_numpy(images(2, CEIT_IMG, seed=8))
    _, variables = jax_ceit()
    model = torch_ceit(variables, use_kernel='auto').eval()
    with torch.no_grad():
        auto = model(x)
        set_use_kernel(model, False)
        plain = model(x)
        for mode, lca in (('fused_layer_full', 'auto'), (True, True),
                          ('kernel', 'auto')):
            set_use_kernel(model, mode)
            assert model.LCSelfAttentionBlock_0.use_kernel == lca
            _close(model(x).numpy(), plain.numpy(), LOGIT_TOL, mode)
    assert torch.equal(auto, plain)


@pytest.mark.parametrize('name', NAMES)
def test_state_dict_matches_the_flax_tree(name):
    """Every parameter and running statistic of ceit_t/s/b @224 under the
    flax path and shape (``jax.eval_shape``, no weights made)."""
    shapes = jax.eval_shape(
        lambda: jax_create_model(name, num_classes=1000).init(
            jax.random.PRNGKey(0), jnp.ones((1, 224, 224, 3)),
            is_training=False))
    want = {k: tuple(v.shape) for k, v in flatten_tree(
        jax.tree_util.tree_map(lambda a: np.broadcast_to(np.float32(0), a.shape),
                               {c: shapes[c] for c in ('params', 'batch_stats')})
    ).items()}
    model_cls, config = MODEL_CONFIGS[name]
    with torch.device('meta'):         # shapes only: ceit_b is 1.1e9 values
        model = model_cls(num_classes=1000, img_size=224, **config)
    buffers = {n for n, _ in model.named_buffers()}
    got = {('batch_stats/' if k in buffers else 'params/')
           + k.replace('.', '/'): tuple(v.shape)
           for k, v in model.state_dict().items()}
    assert got == want


def test_init_follows_flax():
    """flax's initialisers: the convs lecun-normal with zero biases, the
    head and cls zero, the BatchNorms (1, 0) with statistics (0, 1)."""
    model = create_model('ceit_t', num_classes=NUM_CLASSES, device='cpu',
                         num_layers=1, seed=3)
    sd = model.state_dict()
    conv = sd['Encoder_0.EncoderBlock_0.LeFFBlock_0.Conv_0.kernel']
    fan_in = 9 * conv.shape[2]
    assert abs(float(conv.std()) - fan_in ** -0.5) < 0.05 * fan_in ** -0.5
    assert float(conv.abs().max()) <= 2.0 * fan_in ** -0.5 / 0.8796 + 1e-6
    assert torch.count_nonzero(
        sd['Encoder_0.EncoderBlock_0.LeFFBlock_0.Conv_0.bias']) == 0
    stem = sd['Image2TokenBlock_0.Conv_0.kernel']
    assert abs(float(stem.std()) - (49 * 3) ** -0.5) < 0.1 * (49 * 3) ** -0.5
    assert 'Image2TokenBlock_0.Conv_0.bias' not in sd
    for key in ('Dense_0.kernel', 'Dense_0.bias', 'cls'):
        assert torch.count_nonzero(sd[key]) == 0
    bn = 'Encoder_0.EncoderBlock_0.LeFFBlock_0.BatchNorm_1'
    assert torch.equal(sd[f'{bn}.scale'], torch.ones(768))
    assert torch.equal(sd[f'{bn}.var'], torch.ones(768))


def test_refusals_and_names():
    assert set(NAMES) <= set(MODEL_CONFIGS)
    with pytest.raises(NotImplementedError, match='Queue 1 item 1'):
        create_model('ceit_t', device='cpu', num_layers=1, scan_layers=True)
    with pytest.raises(RuntimeError, match='quantized'):
        create_model('ceit_t', device='cpu', num_layers=1, quantized='ff')
    with pytest.raises(NotImplementedError, match='CeiT mode'):
        create_model('ceit_t', device='cpu', num_layers=1,
                     use_kernel='fused_th')
    model = create_model('ceit_t', device='cpu', num_layers=1)
    with pytest.raises(NotImplementedError, match='CeiT mode'):
        set_use_kernel(model, 'botnet_fused')
    with pytest.raises(ValueError, match='core'):
        fused_layer.attention_sublayer_noln(
            *[torch.zeros(1, 4, 128)] + [torch.zeros(128, 2, 64)] * 3
            + [torch.zeros(2, 64, 128)], 2, 'blocked')
