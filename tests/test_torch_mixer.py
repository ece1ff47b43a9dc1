"""Torch port: MLP-Mixer. Logits from one flax tree against
``sav_tpu.models.MLPMixer`` on both routes (per-op, and the token-mixing
span ``'fused_token'``, whose JAX kernels run in interpret mode with 2
images per block); both routes keep the flax tree's keys; the six factory
names; the bridge's refusal of a scan-stacked Mixer tree; three
``train_step``s against ``sav_tpu.train.steps``; and the CLIs end to end on
a Mixer name on the CPU.

float32, 2 layers, D = 128, patch 8 at 32 px (L = 16 tokens, K = 8). The
LayerNorms and the biases are filled (their init, (1, 0) and 0, would let a
swapped LayerNorm or bias pass unseen). Tolerances: logits atol 1e-4 (as the
ViT and CaiT tests); losses, metrics and parameters after 3 steps atol 1e-5
with Adam eps 1e-3 (test_torch_train.py says why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.ops import mixer_token as jax_mt
from sav_tpu.train import state as jax_state
from sav_tpu.train import steps as jax_steps
from sav_tpu_torch import predict
from sav_tpu_torch.models import available_models, create_model, set_use_kernel
from sav_tpu_torch.models.mlp_mixer import MixerBlock
from sav_tpu_torch.train import __main__ as train_cli
from sav_tpu_torch.train import state, steps
from sav_tpu_torch.utils.flax_bridge import (flatten_tree, flax_to_torch,
                                             torch_to_flax)
from torch_parity import NUM_CLASSES, fill_body, images

IMG = 32
SMALL = dict(num_layers=2, embed_dim=128, patch_shape=(8, 8))
ATOL = 1e-4
STEP_EPS = 1e-3
MIXER_NAMES = ['mixer_s_patch32', 'mixer_s_patch16', 'mixer_b_patch32',
               'mixer_b_patch16', 'mixer_l_patch32', 'mixer_l_patch16']


@pytest.fixture(autouse=True)
def ni2(monkeypatch):
    """Two images per JAX kernel block: B = 2 or 4 needs no 48-image pad."""
    monkeypatch.setattr(jax_mt, '_NI', 2)


def _fill_biases(params, seed=3):
    rng = np.random.RandomState(seed)

    def fill(tree):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                fill(tree[key])
            elif key == 'bias':
                tree[key] = 0.1 * rng.standard_normal(
                    np.shape(tree[key])).astype(np.float32)

    fill(params)
    return params


@functools.lru_cache(maxsize=None)
def _jax_params():
    model = jax_create_model('mixer_s_patch32', num_classes=NUM_CLASSES,
                             use_kernel=False, **SMALL)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.ones((1, IMG, IMG, 3)), is_training=False)
    params = jax.tree_util.tree_map(np.asarray, variables['params'])
    params = jax.tree_util.tree_map(np.array, params)
    return _fill_biases(fill_body(params))


def _jax_logits(use_kernel, params, x):
    model = jax_create_model('mixer_s_patch32', num_classes=NUM_CLASSES,
                             use_kernel=use_kernel, **SMALL)
    return np.asarray(model.apply({'params': params}, jnp.asarray(x),
                                  is_training=False))


def _torch_mixer(params, use_kernel):
    model = create_model('mixer_s_patch32', num_classes=NUM_CLASSES,
                         img_size=IMG, device='cpu', use_kernel=use_kernel,
                         **SMALL)
    model.load_state_dict(flax_to_torch(params), strict=True)
    return model.eval()


@pytest.mark.parametrize('use_kernel', [False, 'fused_token'])
def test_logits_match_jax(use_kernel):
    params = _jax_params()
    x = images(2, IMG)
    want = _jax_logits(use_kernel, params, x)
    model = _torch_mixer(params, use_kernel)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize('use_kernel', [False, 'fused_token', 'auto'])
def test_both_routes_keep_the_flax_keys(use_kernel):
    want = sorted(flatten_tree(_jax_params()))
    model = _torch_mixer(_jax_params(), use_kernel)
    assert sorted(flatten_tree(torch_to_flax(model.state_dict()))) == want
    assert 'MixerBlock_1/FFBlock_0/Dense_0/kernel' in want


def test_set_use_kernel_reroutes_the_same_weights():
    params = _jax_params()
    x = images(2, IMG, seed=5)
    want = _jax_logits(False, params, x)
    model = _torch_mixer(params, False)
    set_use_kernel(model, 'fused_token')
    assert all(m.use_kernel == 'fused_token' for m in model.modules()
               if isinstance(m, MixerBlock))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    with pytest.raises(NotImplementedError, match='Mixer'):
        set_use_kernel(model, 'fused_layer')


def test_factory_names_and_refusals():
    assert set(MIXER_NAMES) <= set(available_models())
    model = create_model('mixer_b_patch16', device='cpu', num_layers=1)
    block = model.MixerBlock_0
    assert block.FFBlock_0.Dense_0.kernel.shape == (196, 98)
    assert block.FFBlock_1.Dense_0.kernel.shape == (768, 3072)
    assert model.PatchEmbedBlock_0.Dense_0.bias is not None
    with pytest.raises(NotImplementedError, match='scan'):
        create_model('mixer_s_patch32', device='cpu', scan_layers=True)
    quantized = create_model('mixer_s_patch32', device='cpu', num_layers=1,
                             quantized='ff')
    assert quantized.MixerBlock_0.FFBlock_1.quantized == 'ff'
    assert quantized.MixerBlock_0.FFBlock_0.quantized is False
    for refused in ('ff_sb', True):
        with pytest.raises(ValueError, match='quantized'):
            create_model('mixer_s_patch32', device='cpu', quantized=refused)


def test_layer_counts_and_widths_of_the_six_names():
    want = {'mixer_s_patch32': (8, 512, 32), 'mixer_s_patch16': (8, 512, 16),
            'mixer_b_patch32': (12, 768, 32), 'mixer_b_patch16': (12, 768, 16),
            'mixer_l_patch32': (24, 1024, 32),
            'mixer_l_patch16': (32, 1024, 16)}
    from sav_tpu_torch.models.factory import MODEL_CONFIGS
    for name, (layers, dim, patch) in want.items():
        cls, config = MODEL_CONFIGS[name]
        assert cls.__name__ == 'MLPMixer'
        assert (config['num_layers'], config['embed_dim'],
                config['patch_shape']) == (layers, dim, (patch, patch))


def test_bridge_refuses_a_scan_stacked_mixer_tree():
    stacked = {'MixerBlock': {'LayerNorm_0': {
        'scale': np.ones((2, 4), np.float32)}}}
    with pytest.raises(NotImplementedError, match='scan-stacked'):
        flax_to_torch(stacked)


def _batch(i, n=4):
    rng = np.random.RandomState(30 + i)
    return {'images': rng.standard_normal((n, IMG, IMG, 3)).astype(np.float32),
            'labels': rng.randint(0, NUM_CLASSES, (n,)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == 'labels' else v)
            for k, v in batch.items()}


def _jax_train(use_kernel, grad_accum):
    model = jax_create_model('mixer_s_patch32', num_classes=NUM_CLASSES,
                             use_kernel=use_kernel, **SMALL)
    tx = jax_state.build_optimizer(1e-3, eps=STEP_EPS)
    jstate = jax_state.TrainState.create({'params': _jax_params()}, tx)
    step = jax.jit(functools.partial(
        jax_steps.train_step, model=model, tx=tx, num_classes=NUM_CLASSES,
        label_smoothing=0.1, grad_accum=grad_accum))
    metrics = []
    for i in range(3):
        batch = {k: jnp.asarray(v) for k, v in _batch(i).items()}
        jstate, m = step(jstate, batch, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                        jstate.params))


@pytest.mark.parametrize('use_kernel,grad_accum', [
    (False, 1), ('fused_token', 1), ('fused_token', 2)])
def test_train_step_matches_jax(use_kernel, grad_accum):
    want_metrics, want_params = _jax_train(use_kernel, grad_accum)
    model = _torch_mixer(_jax_params(), use_kernel)
    ts = state.TrainState(model, state.build_optimizer(
        model.parameters(), 1e-3, eps=STEP_EPS))
    for i in range(3):
        m = steps.train_step(ts, _torch_batch(_batch(i)),
                             num_classes=NUM_CLASSES, label_smoothing=0.1,
                             grad_accum=grad_accum)
        assert sorted(m) == sorted(want_metrics[i])
        for k, v in m.items():
            np.testing.assert_allclose(float(v), want_metrics[i][k],
                                       atol=1e-5, rtol=0, err_msg=f'{i} {k}')
    ours = flatten_tree(torch_to_flax(model.state_dict()))
    assert sorted(ours) == sorted(want_params)
    for k in ours:
        np.testing.assert_allclose(ours[k], want_params[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def test_cli_trains_mixer_and_predict_reads_its_checkpoint(tmp_path, capsys):
    ckpt = tmp_path / 'ck'
    metrics = train_cli.main(['--device', 'cpu', '--data_dir', 'synthetic',
                              '-m', 'mixer_s_patch32', '-s', '64', '-b', '2',
                              '--total_steps', '2', '--eval_batches', '1',
                              '--num_classes', '10', '-c', str(ckpt)])
    assert np.isfinite(metrics['loss']) and 'eval_loss' in metrics
    assert (ckpt / 'params.npz').exists()
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    from PIL import Image
    Image.fromarray(np.random.RandomState(0).randint(
        0, 256, (70, 80, 3), dtype=np.uint8)).save(img_dir / 'a.jpg')
    capsys.readouterr()
    predict.main(['-m', 'mixer_s_patch32', '-c', str(ckpt), '--images',
                  str(img_dir), '-s', '64', '--device', 'cpu', '--top_k', '2',
                  '--num_classes', '10'])
    captured = capsys.readouterr()
    assert 'loaded' in captured.err and len(captured.out.splitlines()) == 1
