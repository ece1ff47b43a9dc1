"""Torch port: ``python -m sav_tpu_torch.evaluate`` and ``predict --ema``
on a JAX Trainer's checkpoint carried over by
``scripts/convert_orbax_to_torch.py``, against the JAX package's
``evaluate.run_eval`` on the same ``.npz`` holdout (the fixture of
``tests/test_evaluate.py``: a 2-step ViT-Ti run at 16 px with a 25%
holdout and an EMA).

float32. Tolerance: eval loss and top-k accuracies atol 1e-5 (the same
weights and images through two frameworks' f32 forwards); image counts and
the step exactly.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from evaluate import run_eval as jax_run_eval
from sav_tpu_torch import evaluate, predict
from sav_tpu_torch.data.loader import write_npz_shards
from sav_tpu_torch.data.preprocess import eval_preprocess
from sav_tpu_torch.models import create_model
from sav_tpu_torch.utils.flax_bridge import flax_to_torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'scripts'))
import convert_orbax_to_torch as converter  # noqa: E402

ATOL = 1e-5
KEYS = ('eval_loss', 'eval_top_1_acc', 'eval_top_5_acc')
COMMON = dict(batch_size=8, num_classes=8, dtype='float32',
              holdout_fraction=0.25)


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """A 2-step JAX ViT-Ti run on an npz source with a 25% holdout and an
    EMA, and its checkpoint converted for the port."""
    from sav_tpu.train import TrainConfig, Trainer

    tmp = tmp_path_factory.mktemp('eval_ckpt')
    rng = np.random.RandomState(0)
    data_dir = str(tmp / 'npz')
    write_npz_shards(rng.randint(0, 256, (64, 16, 16, 3), dtype=np.uint8),
                     rng.randint(0, 8, (64,)), data_dir, shard_size=32)
    orbax_dir, port_dir = str(tmp / 'orbax'), str(tmp / 'port')
    # a short warmup and lr 0.5, so the EMA after 2 steps differs from the
    # params (tests/test_evaluate.py says why)
    Trainer(TrainConfig(model_name='vit_ti_patch16', img_size=16,
                        batch_size=8, total_steps=2, dtype='float32',
                        num_classes=8, dataset=data_dir, lr=0.5,
                        images_per_epoch=64, holdout_fraction=0.25,
                        ema_decay=0.9, checkpoint_dir=orbax_dir, log_every=1,
                        eval_every_epochs=10**6,
                        checkpoint_every_epochs=10**6)).run()
    converter.convert(orbax_dir, port_dir, model_name='vit_ti_patch16',
                      img_size=16, num_classes=8, ema=True)
    return data_dir, orbax_dir, port_dir


def _port(trained, **kwargs):
    data_dir, _, port_dir = trained
    return evaluate.run_eval('vit_ti_patch16', port_dir, data_dir,
                             **{'img_size': 16, **COMMON, **kwargs},
                             device='cpu')


def _jax(trained, **kwargs):
    data_dir, orbax_dir, _ = trained
    return jax_run_eval('vit_ti_patch16', orbax_dir, data_dir,
                        **{'img_size': 16, **COMMON, **kwargs})


@pytest.mark.parametrize('use_ema', [True, False])
def test_run_eval_matches_jax(trained, use_ema):
    got, want = _port(trained, use_ema=use_ema), _jax(trained,
                                                      use_ema=use_ema)
    assert got['eval_images'] == want['eval_images'] == 16.0
    assert got['eval_step'] == want['eval_step'] == 2
    assert got['images_per_sec'] > 0
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=0,
                                   err_msg=key)


def test_ema_toggle_and_batch_cap(trained):
    # the EMA after 2 steps is another parameter set: another loss
    assert (_port(trained, use_ema=True)['eval_loss']
            != _port(trained, use_ema=False)['eval_loss'])
    assert _port(trained, eval_batches=1)['eval_images'] == 8.0


def test_missing_checkpoint_raises(trained, tmp_path):
    data_dir, _, _ = trained
    with pytest.raises(FileNotFoundError, match='no checkpoint'):
        evaluate.run_eval('vit_ti_patch16', str(tmp_path / 'nowhere'),
                          data_dir, img_size=16, device='cpu', **COMMON)


def test_eval_at_another_resolution_matches_jax(trained, capsys):
    """The @16 checkpoint scored at -s 32: the pos-embed interpolated 2 ->
    5 tokens in both packages, the same numbers."""
    got, want = _port(trained, img_size=32), _jax(trained, img_size=32)
    assert 'pos-embed interpolated 2 -> 5 tokens' in capsys.readouterr().err
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=0,
                                   err_msg=key)


def test_cli_prints_one_json_line(trained, capsys):
    data_dir, _, port_dir = trained
    evaluate.main(['-m', 'vit_ti_patch16', '-c', port_dir, '--data_dir',
                   data_dir, '-s', '16', '-b', '8', '--num_classes', '8',
                   '--dtype', 'float32', '--holdout_fraction', '0.25',
                   '--device', 'cpu'])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row['eval_images'] == 16 and row['eval_step'] == 2


def test_predict_ema_takes_the_ema_tree(trained, tmp_path, capsys):
    _, _, port_dir = trained
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (20, 24, 3), dtype=np.uint8)).save(
            img_dir / f'im{i}.jpg', quality=95)
    restored = predict.CheckpointManager(port_dir).restore_for_inference()
    outputs = {}
    for flag, tree in (('--ema', 'ema_params'), ('--no-ema', 'params')):
        predict.main(['-m', 'vit_ti_patch16', '-c', port_dir, '--images',
                      str(img_dir), '-s', '16', '--num_classes', '8',
                      '--dtype', 'float32', '--device', 'cpu', '--top_k',
                      '3', flag])
        captured = capsys.readouterr()
        assert 'loaded the checkpoint at step 2' in captured.err
        assert ('EMA params' in captured.err) == (flag == '--ema')
        lines = [json.loads(line) for line in captured.out.splitlines()]
        # the same forward on the chosen tree, loaded by hand
        model = create_model('vit_ti_patch16', num_classes=8, img_size=16,
                             device='cpu').eval()
        model.load_state_dict(flax_to_torch(restored[tree]), strict=True)
        frames = np.stack([predict.decode_jpeg_fixed(line['path'],
                                                     predict.decode_size_for(16))
                           for line in lines])
        with torch.no_grad():
            logits = model(eval_preprocess(torch.from_numpy(frames).float(),
                                           16))
        probs, idx = torch.topk(torch.softmax(logits, -1), 3)
        for line, p, i in zip(lines, probs.numpy(), idx.numpy()):
            assert [c['class'] for c in line['top_k']] == i.tolist()
            np.testing.assert_allclose([c['prob'] for c in line['top_k']], p,
                                       atol=1e-5)
        outputs[flag] = lines
    assert outputs['--ema'] != outputs['--no-ema']


def test_simple_train_configs_and_a_cpu_run(monkeypatch, capsys):
    import dataclasses

    from sav_tpu_torch import simple_train
    card, cpu = simple_train.config_for(True), simple_train.config_for(False)
    assert (card.model_name, card.img_size, card.batch_size, card.total_steps,
            card.dtype) == ('vit_s_patch16', 224, 256, 50, 'bfloat16')
    assert (cpu.model_name, cpu.img_size, cpu.batch_size, cpu.total_steps,
            cpu.dtype) == ('vit_s_patch16', 224, 8, 3, 'float32')
    assert card.steps_per_dispatch == cpu.steps_per_dispatch == 1
    config_for = simple_train.config_for
    monkeypatch.setattr(simple_train, 'config_for', lambda on_card: (
        dataclasses.replace(config_for(on_card), model_name='vit_ti_patch16',
                            img_size=32, batch_size=2, total_steps=2)))
    metrics = simple_train.main(['--device', 'cpu'])
    assert np.isfinite(metrics['loss']) and 'eval_loss' in metrics
    assert 'final metrics' in capsys.readouterr().out
