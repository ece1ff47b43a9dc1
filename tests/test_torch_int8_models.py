"""Torch port, the int8 routes of the models against the JAX package, from
one flax tree: ViT ``quantized='ff'`` (K13), ``'all'`` through
``use_kernel='fused_layer'`` (K10 + K13), ``True`` (``--quantized int8``,
the library int8 path); the Mixer's ``'ff'`` (K12 on the channel-mix FF);
CaiT's ``'ff'`` (K12 behind LayerScale). The quantized models keep the
unquantized tree's keys; the refusals name their ROADMAP items, and the
routes that replaced the last two (ViT ``'ff_sb'``, CaiT ``'all'``) build; the
predict CLI serves ``--quantized ff`` on the CPU over JPEGs made by
``scripts/make_jpeg_dataset.py``.

float32, 2 layers, D = 128 (CaiT D = 64), 32 px; the JAX kernels run in
interpret mode. In f32 the int8 routes are visible in the logits: each
moves them by 1.5e-3 (CaiT) to 2.3e-2 (ViT 'all') of max |logit| from the
unquantized model of the same tree, while the two packages agree to ~1e-6
(the same codes, sums in other orders). Tolerance: 1e-4 of max |logit|,
and each route must move the logits by at least 10x that from the
unquantized model (so a route that silently ran unquantized fails). In
bf16 a logit ulp (2^-8) is as large as those moves, so the bf16 weight
casts of FFBlock(quantized='ff') are held on the block itself, against
the flax FFBlock, as the kernels are (test_torch_quantized.py).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu_torch import predict
from sav_tpu_torch.models import create_model
from sav_tpu_torch.train import TrainConfig, Trainer
from sav_tpu_torch.utils.flax_bridge import (flatten_tree, flax_to_torch,
                                             torch_to_flax)
from torch_parity import CAIT_SMALL, NUM_CLASSES, SMALL, fill_body, fill_head, images

IMG = 32
LOGIT_TOL = 1e-4
MIXER_SMALL = dict(num_layers=2, embed_dim=128, patch_shape=(8, 8))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (registry name, overrides, quantized, use_kernel)
ROUTES = {
    'vit_ff': ('vit_ti_patch16', SMALL, 'ff', 'auto'),
    'vit_all': ('vit_ti_patch16', SMALL, 'all', 'fused_layer'),
    'vit_int8': ('vit_ti_patch16', SMALL, True, 'auto'),
    'mixer_ff': ('mixer_s_patch32', MIXER_SMALL, 'ff', False),
    'cait_ff': ('cait_xxs_24', dict(CAIT_SMALL), 'ff', False),
}


def _tree(name, overrides):
    """The unquantized JAX model's tree with its head, LayerNorms and
    LayerScale filled (their inits would hide a swapped LN or an FF)."""
    model = jax_create_model(name, num_classes=NUM_CLASSES, **overrides)
    variables = model.init(jax.random.PRNGKey(0), jnp.ones((1, IMG, IMG, 3)),
                           is_training=False)
    params = jax.tree_util.tree_map(np.array, variables['params'])
    if 'cls' in params:
        params = fill_head(params)
    return fill_body(params)


def _torch_model(route, params, quantized):
    name, overrides, _, use_kernel = ROUTES[route]
    model = create_model(name, num_classes=NUM_CLASSES, img_size=IMG,
                         device='cpu', quantized=quantized,
                         use_kernel=use_kernel, **overrides)
    model.load_state_dict(flax_to_torch(params), strict=True)
    return model.eval()


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_int8_logits_match_jax(route):
    name, overrides, quantized, use_kernel = ROUTES[route]
    jmodel = jax_create_model(name, num_classes=NUM_CLASSES,
                              quantized=quantized, use_kernel=use_kernel,
                              **overrides)
    params = _tree(name, overrides)
    x = images(2, IMG, seed=7)
    want = np.asarray(jmodel.apply({'params': params}, jnp.asarray(x),
                                   is_training=False))
    with torch.no_grad():
        got = _torch_model(route, params, quantized)(torch.from_numpy(x))
        plain = _torch_model(route, params, False)(torch.from_numpy(x))
    scale = np.abs(want).max()
    err = np.abs(got.numpy() - want).max() / scale
    moved = np.abs(plain.numpy() - want).max() / scale
    assert err <= LOGIT_TOL and moved >= 10 * LOGIT_TOL, (err, moved)


def test_ff_block_bf16_casts_match_flax():
    """FFBlock(quantized='ff') in bf16: W1/W2 cast to bf16, then quantised
    in f32 arithmetic (K12's convention), the f32 biases kept."""
    from sav_tpu.nn.feedforward import FFBlock as JaxFFBlock
    from sav_tpu_torch.nn.feedforward import FFBlock
    from test_torch_quantized import assert_near_kernel
    rng = np.random.RandomState(8)
    x = rng.standard_normal((2, 50, 128)).astype(np.float32)
    block = JaxFFBlock(expand_ratio=4, dtype=jnp.bfloat16, quantized='ff')
    params = jax.tree_util.tree_map(np.array, block.init(
        jax.random.PRNGKey(1), jnp.asarray(x), is_training=False)['params'])
    for dense in ('Dense_0', 'Dense_1'):
        params[dense]['bias'] = 0.1 * rng.standard_normal(
            params[dense]['bias'].shape).astype(np.float32)
    want = block.apply({'params': params}, jnp.asarray(x), is_training=False)
    ours = FFBlock(128, 4, dtype=torch.bfloat16, quantized='ff')
    ours.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert_near_kernel(got, want)


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_quantized_models_keep_the_tree(route):
    name, overrides, quantized, use_kernel = ROUTES[route]
    jmodel = jax_create_model(name, num_classes=NUM_CLASSES,
                              quantized=quantized, use_kernel=use_kernel,
                              **overrides)
    jtree = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, IMG, IMG, 3)),
                        is_training=False)['params']
    want = sorted(flatten_tree(_tree(name, overrides)))
    assert sorted(flatten_tree(jtree)) == want
    tmodel = create_model(name, num_classes=NUM_CLASSES, img_size=IMG,
                          device='cpu', quantized=quantized,
                          use_kernel=use_kernel, **overrides)
    assert sorted(flatten_tree(torch_to_flax(tmodel.state_dict()))) == want


def test_int8_refusals_name_their_roadmap_items(tmp_path):
    kw = dict(device='cpu', num_layers=1, img_size=IMG)
    # 'ff_sb' (K14) and CaiT 'all' (K11) are ported: they build, on the
    # JAX package's blocks, and refuse nothing
    vit_sb = create_model('vit_ti_patch16', quantized='ff_sb', **kw)
    assert vit_sb.Encoder_0.EncoderBlock_0.quantized == 'ff_sb'
    cait_all = create_model('cait_xxs_24', quantized='all',
                            num_layers_token_only=1, **kw)
    assert cait_all.Encoder_0.EncoderBlock_0.quantized == 'all'
    assert cait_all.Encoder_0.EncoderBlock_0.FFBlock_0.quantized == 'ff'
    for name in ('vit_ti_patch16', 'cait_xxs_24'):
        with pytest.raises(ValueError, match='quantized'):
            create_model(name, quantized='int4', **kw)
    for name in ('tnt_s_patch16', 'botnet_t3'):
        with pytest.raises(RuntimeError, match='no int8 path'):
            create_model(name, quantized='ff', device='cpu')
    with pytest.raises(ValueError, match='fused_ff'):
        create_model('vit_ti_patch16', quantized=True, use_kernel='fused_ff',
                     **kw)
    with pytest.raises(ValueError, match='quantized'):
        create_model('mixer_s_patch32', quantized=True, **kw)
    with pytest.raises(ValueError, match='K10'):
        Trainer(TrainConfig(model_name='vit_ti_patch16', img_size=IMG,
                            batch_size=2, quantized='all',
                            checkpoint_dir=str(tmp_path)), device='cpu')
    sb = Trainer(TrainConfig(model_name='vit_ti_patch16', img_size=IMG,
                             batch_size=2, quantized='ff_sb',
                             checkpoint_dir=str(tmp_path)), device='cpu')
    assert sb.model.Encoder_0.EncoderBlock_0.quantized == 'ff_sb'
    # K10 has no backward: the 'all' route refuses under autograd
    model = create_model('vit_ti_patch16', quantized='all',
                         use_kernel='fused_layer', **kw)
    with pytest.raises(RuntimeError, match='serving-only'):
        model(torch.zeros(1, IMG, IMG, 3))


def test_predict_cli_serves_quantized_ff(tmp_path, capsys):
    img_dir = tmp_path / 'jpegs'
    subprocess.run([sys.executable, os.path.join(REPO, 'scripts',
                                                 'make_jpeg_dataset.py'),
                    '--out', str(img_dir), '--classes', '2', '--per-class',
                    '2', '--min-size', '40', '--max-size', '64'],
                   check=True, capture_output=True, timeout=120)
    model = create_model('vit_ti_patch16', num_classes=NUM_CLASSES,
                         img_size=IMG, device='cpu', seed=1)
    with torch.no_grad():
        model.Dense_0.kernel.normal_(generator=torch.Generator().manual_seed(2))
    ckpt = tmp_path / 'ckpt'
    ckpt.mkdir()
    np.savez(ckpt / 'params.npz',
             **flatten_tree(torch_to_flax(model.state_dict())))
    predict.main(['-m', 'vit_ti_patch16', '-c', str(ckpt), '--images',
                  str(img_dir), '-s', str(IMG), '--num_classes',
                  str(NUM_CLASSES), '--top_k', '3', '--quantized', 'ff',
                  '--device', 'cpu'])
    captured = capsys.readouterr()
    lines = [__import__('json').loads(line)
             for line in captured.out.splitlines()]
    assert 'loaded' in captured.err and len(lines) == 4
    quantized = create_model('vit_ti_patch16', num_classes=NUM_CLASSES,
                             img_size=IMG, dtype=torch.bfloat16, device='cpu',
                             quantized='ff')
    quantized.load_state_dict(model.state_dict())
    frames = np.stack([predict.decode_jpeg_fixed(line['path'],
                                                 predict.decode_size_for(IMG))
                       for line in lines])
    probs, idx = predict.serve(quantized.eval(), frames, IMG, 3)
    for line, want_i, want_p in zip(lines, idx.numpy(), probs.numpy()):
        assert [c['class'] for c in line['top_k']] == want_i.tolist()
        np.testing.assert_allclose([c['prob'] for c in line['top_k']],
                                   want_p, atol=1e-5)
