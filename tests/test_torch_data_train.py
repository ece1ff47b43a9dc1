"""Torch port, the slice as a whole: real-data training and holdout
evaluation through ``sav_tpu_torch.train`` on a tiny JPEG folder, held
against ``sav_tpu.train.Trainer`` from one flax tree (vit_ti_patch16 at
32 px, float32), and ``Trainer.evaluate`` on finite sources.

Tolerances: ``eval_count`` exact (the same holdout, its padded rows
masked); eval loss 1e-4 and top-1 exact (the same frames, the eval crop's
weights applied in another order, logits ~1e-6 apart); the port's losses
with 0 and 2 loader workers exact (the same batches, bit for bit).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sav_tpu.train import TrainConfig as JaxTrainConfig
from sav_tpu.train import Trainer as JaxTrainer
from sav_tpu_torch.train import __main__ as train_cli
from sav_tpu_torch.train import loop, steps
from sav_tpu_torch.utils.flax_bridge import flax_to_torch
from torch_parity import fill_head

torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'scripts'))
from make_jpeg_dataset import synth_image  # noqa: E402

CLASSES, PER_CLASS, IMG, BATCH = 4, 6, 32, 8


@pytest.fixture(scope='module')
def jpeg_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('jpegs')
    rng = np.random.RandomState(0)
    for cls in range(CLASSES):
        cdir = root / f'class_{cls:04d}'
        cdir.mkdir()
        for i in range(PER_CLASS):
            h, w = rng.randint(40, 80, 2)
            Image.fromarray(synth_image(rng, cls, CLASSES, h, w)).save(
                cdir / f'img_{i:05d}.jpg', quality=85)
    return str(root)


def _config(cls, root, **kwargs):
    return cls(model_name='vit_ti_patch16', img_size=IMG, batch_size=BATCH,
               total_steps=2, dtype='float32', num_classes=CLASSES,
               dataset=root, holdout_fraction=0.25, log_every=1,
               eval_every_epochs=10 ** 6, checkpoint_every_epochs=10 ** 6,
               **kwargs)


def test_holdout_eval_matches_jax(jpeg_root):
    """Both Trainers hold out the same 6 of 24 images (one batch of 8 with
    two padded rows) and score them alike from one parameter tree."""
    jax_trainer = JaxTrainer(_config(JaxTrainConfig, jpeg_root))
    params = fill_head(jax.device_get(jax_trainer.state.params))
    jax_trainer.state = jax_trainer.state.replace(
        params=jax.tree_util.tree_map(jax.numpy.asarray, params))
    want = jax_trainer.evaluate(jax_trainer._dataset(seed_offset=1,
                                                     training=False))

    trainer = loop.Trainer(_config(loop.TrainConfig, jpeg_root),
                           device='cpu')
    trainer.model.load_state_dict(flax_to_torch(params), strict=True)
    eval_data = trainer.dataset(seed_offset=1, training=False)
    assert eval_data.num_batches == 1
    batch = eval_data.batch(0)
    assert batch['mask'].tolist() == [1.0] * 6 + [0.0] * 2
    sums = steps.eval_step(trainer.state, batch, num_classes=CLASSES)
    assert float(sums['eval_count']) == 6
    got = trainer.evaluate(eval_data)
    assert got['eval_top_1_acc'] == pytest.approx(want['eval_top_1_acc'],
                                                  abs=1e-7)
    assert got['eval_loss'] == pytest.approx(want['eval_loss'], abs=1e-4)
    assert 0.0 < got['eval_loss'] < 50.0


class _Finite:
    """A finite eval source whose last batch is ragged and masked."""

    def __init__(self, sizes, num_batches):
        self.sizes = sizes
        self.num_batches = num_batches
        self.calls = 0

    def batch(self, step):
        if step >= len(self.sizes):
            raise StopIteration
        self.calls += 1
        g = torch.Generator().manual_seed(step)
        valid = self.sizes[step]
        return {'images': torch.rand(BATCH, IMG, IMG, 3, generator=g),
                'labels': torch.randint(0, CLASSES, (BATCH,), generator=g),
                'mask': (torch.arange(BATCH) < valid).float()}


def _tiny_trainer():
    return loop.Trainer(loop.TrainConfig(
        model_name='vit_ti_patch16', img_size=IMG, batch_size=BATCH,
        dtype='float32', num_classes=CLASSES, total_steps=1), device='cpu')


def test_evaluate_walks_a_finite_source_once():
    """``evaluate`` takes a finite source's ``num_batches`` (not 16), and
    its count is the holdout's size, not a multiple of the batch."""
    trainer = _tiny_trainer()
    data = _Finite([8, 8, 3], num_batches=3)
    metrics = trainer.evaluate(data)
    assert data.calls == 3
    assert set(metrics) == {'eval_loss', 'eval_top_1_acc', 'eval_top_5_acc'}
    assert np.isfinite(metrics['eval_loss'])


def test_evaluate_stops_at_stop_iteration():
    trainer = _tiny_trainer()
    data = _Finite([8, 5], num_batches=4)
    assert np.isfinite(trainer.evaluate(data)['eval_loss'])
    assert data.calls == 2
    assert trainer.evaluate(_Finite([], num_batches=2)) == {}


def _losses(root, workers):
    trainer = loop.Trainer(_config(loop.TrainConfig, root,
                                   data_workers=workers), device='cpu')
    data = trainer.dataset()
    try:
        return [float(trainer.train_step(data.batch(s))['loss'])
                for s in range(2)]
    finally:
        data.close()


def test_train_steps_are_the_same_with_loader_workers(jpeg_root):
    assert _losses(jpeg_root, 0) == _losses(jpeg_root, 2)


def test_cli_trains_on_a_jpeg_folder(jpeg_root, tmp_path, capsys):
    metrics = train_cli.main(['--device', 'cpu', '--data_dir', jpeg_root,
                              '-m', 'vit_ti_patch16', '-s', str(IMG), '-b',
                              '4', '--total_steps', '2', '--num_classes',
                              str(CLASSES), '-c', str(tmp_path / 'ck')])
    out = capsys.readouterr().out
    assert 'holding out the last 5.0%' in out and 'final metrics' in out
    assert np.isfinite(metrics['loss']) and np.isfinite(metrics['eval_loss'])
    assert (tmp_path / 'ck' / 'params.npz').exists()


def test_data_fields_are_no_longer_refused():
    for field in ('dataset', 'eval_dataset', 'holdout_fraction',
                  'data_workers'):
        assert field not in loop.UNPORTED
