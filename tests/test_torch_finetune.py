"""Torch port: fine-tuning (``train/finetune.py``) against
``sav_tpu.train.finetune``: the pos-embed and rel-pos interpolations,
``adapt_tree`` on ViT, CvT (with ``batch_stats``) and BoTNet trees, its
refusals, the inference-time adaptation, and the Trainer's
``finetune_from`` a converted JAX checkpoint at the JAX test's shapes
(``tests/test_finetune.py``: pretrain @32 8-way, fine-tune @64 5-way).

float32. Tolerance: atol 1e-6 on every interpolated value (both resize in
f32 with the same antialiased bilinear weights, summed in another order);
carried leaves and report lines exactly.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.train import finetune as jax_ft
from sav_tpu_torch.train import finetune, loop
from sav_tpu_torch.utils.flax_bridge import flatten_tree
from torch_parity import BOTNET_SMALL, SMALL

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'scripts'))
import convert_orbax_to_torch as converter  # noqa: E402

ATOL = 1e-6


@pytest.mark.parametrize('src,dst,dim', [
    (5, 17, 16),        # cls + 2x2 -> cls + 4x4 (grow)
    (17, 5, 16),        # shrink (antialiased)
    (16, 36, 8),        # bare 4x4 -> 6x6 (CaiT's layout)
    (36, 16, 8),
    (197, 577, 8),      # ViT-B/16 @224 -> @384
    (197, 145, 8),      # 14x14 -> 12x12
])
def test_interpolate_pos_embed_matches_jax(src, dst, dim):
    x = np.random.RandomState(src).standard_normal((1, src, dim)).astype(
        np.float32)
    want = np.asarray(jax_ft.interpolate_pos_embed(jnp.asarray(x), dst))
    got = finetune.interpolate_pos_embed(x, dst)
    assert got.shape == want.shape == (1, dst, dim) and got.dtype == x.dtype
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if src % 2:         # the cls prefix is carried verbatim
        np.testing.assert_array_equal(got[:, 0], x[:, 0])


def test_interpolate_pos_embed_identity_and_refusal():
    x = np.zeros((1, 5, 4), np.float32)
    assert finetune.interpolate_pos_embed(x, 5) is x
    with pytest.raises(ValueError, match='square token grids'):
        finetune.interpolate_pos_embed(x, 7)


@pytest.mark.parametrize('src,dst', [(7, 13), (13, 7), (27, 47), (47, 27),
                                     (7, 3)])
def test_interpolate_rel_pos_embed_matches_jax(src, dst):
    x = np.random.RandomState(src).standard_normal((src, 16)).astype(
        np.float32)
    want = np.asarray(jax_ft.interpolate_rel_pos_embed(jnp.asarray(x), dst))
    got = finetune.interpolate_rel_pos_embed(x, dst)
    assert got.shape == want.shape == (dst, 16)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _init(model, img, training=False):
    variables = jax.jit(model.init, static_argnames='is_training')(
        jax.random.PRNGKey(0), jnp.ones((1, img, img, 3)),
        is_training=training)
    return jax.tree_util.tree_map(np.array, dict(variables))


def _vit(img, num_classes, overrides=SMALL):
    return _init(jax_create_model('vit_ti_patch16', num_classes=num_classes,
                                  dtype=jnp.float32, **overrides),
                 img)['params']


def _compare(port, want):
    (got, got_report), (tree, report) = port, want
    assert got_report == report
    want_flat = flatten_tree(jax.tree_util.tree_map(np.asarray, tree))
    got_flat = flatten_tree(got)
    assert sorted(got_flat) == sorted(want_flat)
    for key in want_flat:
        np.testing.assert_allclose(got_flat[key], want_flat[key], atol=ATOL,
                                   rtol=0, err_msg=key)


def test_adapt_tree_vit_resolution_and_head():
    src, tgt = _vit(32, 8), _vit(64, 5)
    port = finetune.adapt_tree(src, tgt)
    _compare(port, jax_ft.adapt_tree(src, tgt))
    assert any('pos-embed interpolated 5 -> 17' in r for r in port[1])
    assert any('head re-initialised for 5 classes' in r for r in port[1])
    assert not port[0]['Dense_0']['kernel'].any()


def _cvt(num_classes):
    from sav_tpu.models.cvt import CvT
    return _init(CvT(num_classes=num_classes, stage_sizes=(1, 1, 1),
                     num_heads=(1, 1, 2), embed_dim=(8, 8, 16),
                     dtype=jnp.float32), 32, training=True)


def test_adapt_tree_cvt_batch_stats_and_head():
    src, tgt = _cvt(6), _cvt(3)
    port = finetune.adapt_tree(src['params'], tgt['params'])
    _compare(port, jax_ft.adapt_tree(src['params'], tgt['params']))
    assert sorted(port[1]) == [
        'Dense_0/bias: head re-initialised for 3 classes',
        'Dense_0/kernel: head re-initialised for 3 classes']
    stats = finetune.adapt_tree(src['batch_stats'], tgt['batch_stats'],
                                'batch_stats')
    _compare(stats, jax_ft.adapt_tree(src['batch_stats'],
                                      tgt['batch_stats'], 'batch_stats'))
    assert stats[1] == []


def test_adapt_tree_botnet_resolution_transfer():
    def variables(img):
        return _init(jax_create_model('botnet_t3', num_classes=4,
                                      dtype=jnp.float32, **BOTNET_SMALL), img)

    src, tgt = variables(64), variables(128)
    port = finetune.adapt_tree(src['params'], tgt['params'])
    _compare(port, jax_ft.adapt_tree(src['params'], tgt['params']))
    resampled = [r for r in port[1] if 'rel-pos table resampled' in r]
    assert len(resampled) == 2 and all('7 -> 15' in r for r in resampled)


def test_adapt_tree_refusals():
    from sav_tpu.models.mlp_mixer import MLPMixer

    def mixer(img):
        return _init(MLPMixer(num_classes=4, num_layers=1, embed_dim=32,
                              patch_shape=(16, 16), dtype=jnp.float32),
                     img)['params']

    # the Mixer's token-mixing Dense is resolution-bound
    with pytest.raises(ValueError, match='cannot adapt') as port:
        finetune.adapt_tree(mixer(32), mixer(64))
    with pytest.raises(ValueError) as want:
        jax_ft.adapt_tree(mixer(32), mixer(64))
    assert str(port.value) == str(want.value)
    # another width: an unadaptable leaf
    with pytest.raises(ValueError, match='cannot adapt'):
        finetune.adapt_tree(_vit(32, 8), _vit(32, 8, dict(SMALL,
                                                          embed_dim=64)))
    # another structure
    src = _vit(32, 8)
    src.pop('cls')
    with pytest.raises(ValueError, match='does not match the model'):
        finetune.adapt_tree(src, _vit(32, 8))
    # serving cannot re-initialise a head
    with pytest.raises(ValueError, match='--num_classes'):
        finetune.adapt_tree(_vit(32, 8), _vit(32, 5), allow_head_reinit=False)


def test_adapt_restored_for_inference_matches_jax():
    src = _vit(32, 8)
    restored = {'params': src, 'ema_params': src, 'batch_stats': {},
                'step': 7}
    same, report = finetune.adapt_restored_for_inference(
        'vit_ti_patch16', restored, 32, num_classes=8, **SMALL)
    assert report == [] and same['params'] is src
    model = jax_create_model('vit_ti_patch16', num_classes=8,
                             dtype=jnp.float32, **SMALL)
    want, want_report = jax_ft.adapt_restored_for_inference(model, restored,
                                                            48)
    got, got_report = finetune.adapt_restored_for_inference(
        'vit_ti_patch16', restored, 48, num_classes=8, **SMALL)
    assert got_report == want_report
    assert sum('pos-embed interpolated 5 -> 10' in r for r in got_report) == 2
    for key in ('params', 'ema_params'):
        _compare((got[key], []), (want[key], []))
    with pytest.raises(ValueError, match='--num_classes'):
        finetune.adapt_restored_for_inference('vit_ti_patch16', restored, 32,
                                              num_classes=5, **SMALL)


def test_trainer_finetune_from_a_converted_checkpoint(tmp_path):
    """Pretrain 2 steps @32/8-way in the JAX package, convert, fine-tune
    @64/5-way in the port: the pos-embed is the JAX package's own
    interpolation of the pretrained one, the head zero, the optimizer and
    the EMA fresh; it trains, and a checkpoint in its own directory then
    takes precedence over finetune_from."""
    from sav_tpu.train import TrainConfig, Trainer

    pre_dir, port_dir = str(tmp_path / 'pretrain'), str(tmp_path / 'port')
    pre = Trainer(TrainConfig(
        model_name='vit_ti_patch16', img_size=32, batch_size=8,
        total_steps=2, dtype='float32', num_classes=8, dataset='synthetic',
        checkpoint_dir=pre_dir, log_every=1, eval_every_epochs=10**6,
        checkpoint_every_epochs=10**6, eval_batches=1, ema_decay=0.9))
    pre.run()
    converter.convert(pre_dir, port_dir, model_name='vit_ti_patch16',
                      img_size=32, num_classes=8, ema=True)
    pre_pos = np.asarray(
        pre.state.params['Encoder_0']['AddAbsPosEmbed_0']['pos_embed'])
    ema_pos = np.asarray(
        pre.state.ema_params['Encoder_0']['AddAbsPosEmbed_0']['pos_embed'])

    def config(use_ema=False):
        return loop.TrainConfig(
            model_name='vit_ti_patch16', img_size=64, batch_size=2,
            total_steps=1, dtype='float32', num_classes=5,
            checkpoint_dir=str(tmp_path / f'ft{int(use_ema)}'),
            finetune_from=port_dir, finetune_use_ema=use_ema, log_every=1,
            eval_every_epochs=10**6, eval_batches=1, ema_decay=0.9)

    for use_ema, source in ((False, pre_pos), (True, ema_pos)):
        ft = loop.Trainer(config(use_ema), device='cpu')
        pos = ft.model.Encoder_0.AddAbsPosEmbed_0.pos_embed.detach().numpy()
        want = np.asarray(jax_ft.interpolate_pos_embed(jnp.asarray(source),
                                                       17))
        np.testing.assert_allclose(pos, want, atol=ATOL, rtol=0)
        np.testing.assert_array_equal(pos[0, 0], source[0, 0])
        assert not ft.model.Dense_0.kernel.detach().numpy().any()
        assert ft.state.step == 0 and ft.optimizer.count == 0
        assert not ft.optimizer.state
        for name, p in ft.model.named_parameters():
            assert ft.state.ema_params[name].data_ptr() != p.data_ptr()
            assert bool((ft.state.ema_params[name] == p).all()), name
    metrics = ft.run()
    assert np.isfinite(metrics['loss'])
    resumed = loop.Trainer(config(True), device='cpu')
    assert resumed.state.step == 1
