"""Torch port: checkpoints of the whole train state (``train/checkpoint.py``)
and resume, against itself and against the JAX package's Orbax checkpoints
carried over by ``scripts/convert_orbax_to_torch.py``.

float32 models. Tolerances: a state round trip, a resume on the port's own
checkpoints and the converter's moments and count are exact (the same
bits; a bf16 first moment is carried widened to f32, which is exact); one
train step of the JAX package and of the port from the same converted
state, on one explicit batch: loss and parameters atol 1e-5, as
``test_torch_train.py``'s train-step comparison. That step runs at the
Trainer's warmup learning rate (~4e-7), so an update moves a parameter by
~1e-6 at most: the parameters show the restored state and the step's
arithmetic, not a difference in Adam's direction on near-zero gradients
(see ``test_torch_train.py`` on eps).
"""

import json
import os
import signal
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from sav_tpu_torch.data.loader import write_npz_shards
from sav_tpu_torch.models import create_model
from sav_tpu_torch.train import loop, state, steps
from sav_tpu_torch.train.checkpoint import (CheckpointManager,
                                            write_params_npz)
from sav_tpu_torch.utils.flax_bridge import flatten_tree, torch_to_flax
from torch_parity import BOTNET_IMG, BOTNET_SMALL, NUM_CLASSES, SMALL

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'scripts'))
import convert_orbax_to_torch as converter  # noqa: E402

MODELS = {
    # (factory name, image size, overrides, mu_dtype)
    'vit_mu_bf16': ('vit_ti_patch16', 32, SMALL, 'bfloat16'),
    'botnet': ('botnet_t3', BOTNET_IMG, BOTNET_SMALL, None),
}


def _state(case, seed=0):
    name, img, overrides, mu_dtype = MODELS[case]
    model = create_model(name, num_classes=NUM_CLASSES, img_size=img,
                         device='cpu', seed=seed, **overrides)
    opt = state.build_optimizer(model.parameters(), 1e-3, clip_grad=1.0,
                                mu_dtype=mu_dtype)
    return state.TrainState(model, opt, ema=True), img


def _batch(i, img, n=2):
    gen = torch.Generator().manual_seed(100 + i)
    return {'images': torch.randn((n, img, img, 3), generator=gen),
            'labels': torch.randint(0, NUM_CLASSES, (n,), generator=gen)}


def _step(ts, img, i):
    return steps.train_step(ts, _batch(i, img), num_classes=NUM_CLASSES,
                            label_smoothing=0.1, ema_decay=0.9)


def _assert_same_state(a, b):
    flat_a, flat_b = flatten_tree(a), flatten_tree(b)
    assert sorted(flat_a) == sorted(flat_b)
    for key in flat_a:
        assert flat_a[key].dtype == flat_b[key].dtype, key
        np.testing.assert_array_equal(flat_a[key], flat_b[key], err_msg=key)


@pytest.mark.parametrize('case', sorted(MODELS))
def test_state_round_trips_every_field(tmp_path, case):
    ts, img = _state(case)
    for i in range(2):
        _step(ts, img, i)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(ts.step, ts, data_state=b'{"next_step": 2}')
    mgr.wait()
    fresh, _ = _state(case, seed=1)
    assert mgr.restore(fresh) is fresh
    want = ts.state_tree()
    _assert_same_state(fresh.state_tree(), want)
    assert int(want['step']) == 2 and int(want['opt_state']['count']) == 2
    assert want['batch_stats'] or case != 'botnet'
    mu_dtype = MODELS[case][3]
    for p in fresh.model.parameters():
        assert fresh.optimizer.state[p]['mu'].dtype == (
            torch.bfloat16 if mu_dtype else torch.float32)
    inference = mgr.restore_for_inference()
    assert inference['step'] == 2
    _assert_same_state({k: inference[k] for k in
                        ('params', 'batch_stats', 'ema_params')},
                       {k: want[k] for k in
                        ('params', 'batch_stats', 'ema_params')})
    assert mgr.restore_data_state() == b'{"next_step": 2}'
    # the restored state trains on to the same bits
    _step(ts, img, 2)
    _step(fresh, img, 2)
    _assert_same_state(fresh.state_tree(), ts.state_tree())
    mgr.close()


def test_state_before_the_first_step_has_zero_moments():
    ts, _ = _state('vit_mu_bf16')
    tree = ts.state_tree()
    assert int(tree['opt_state']['count']) == 0 and int(tree['step']) == 0
    for key in ('mu', 'nu'):
        flat = flatten_tree(tree['opt_state'][key])
        assert sorted(flat) == sorted(flatten_tree(tree['params']))
        assert all(not v.any() for v in flat.values())


def test_restore_refuses_an_ema_mismatch(tmp_path):
    ts, _ = _state('vit_mu_bf16')
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, ts)
    mgr.wait()
    plain = state.TrainState(ts.model, ts.optimizer, ema=False)
    with pytest.raises(ValueError, match='ema_params'):
        mgr.restore(plain)
    mgr.close()


def _tiny_tree(step):
    value = np.full((2, 3), step, np.float32)
    return {'step': np.asarray(step), 'params': {'w': value},
            'batch_stats': {}, 'ema_params': None,
            'opt_state': {'count': np.asarray(step), 'mu': {'w': value},
                          'nu': {'w': value}}}


def test_retention_latest_step_and_temporary_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    assert mgr.latest_step() is None and mgr.restore_for_inference() is None
    for step in range(1, 6):
        mgr.write(step, _tiny_tree(step))
    mgr.wait()
    assert mgr.steps() == [3, 4, 5] and mgr.latest_step() == 5
    # a save killed mid-write leaves its temporary directory: never read
    leftover = tmp_path / '.tmp-9-1234'
    leftover.mkdir()
    (leftover / 'state.npz').write_bytes(b'not a checkpoint')
    (tmp_path / 'notes').mkdir()
    assert mgr.latest_step() == 5
    restored = mgr.restore_for_inference()
    assert restored['step'] == 5 and restored['ema_params'] is None
    np.testing.assert_array_equal(restored['params']['w'],
                                  np.full((2, 3), 5, np.float32))
    assert mgr.restore_data_state() is None
    # a step directory without its state raises; it is not skipped
    (tmp_path / '7').mkdir()
    with pytest.raises(FileNotFoundError):
        mgr.restore_for_inference()
    mgr.close()


def test_legacy_params_npz_reads_for_inference(tmp_path):
    params = {'Dense_0': {'kernel': np.ones((3, 2), np.float32)}}
    stats = {'BatchNorm_0': {'mean': np.zeros(3, np.float32)}}
    write_params_npz(str(tmp_path / 'params.npz'),
                     {'params': params, 'batch_stats': stats})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    restored = mgr.restore_for_inference()
    assert restored['step'] is None and restored['ema_params'] is None
    np.testing.assert_array_equal(restored['params']['Dense_0']['kernel'],
                                  params['Dense_0']['kernel'])
    np.testing.assert_array_equal(
        restored['batch_stats']['BatchNorm_0']['mean'],
        stats['BatchNorm_0']['mean'])
    # a params.npz alone carries no optimizer state: training refuses it
    config = loop.TrainConfig(model_name='vit_ti_patch16', img_size=32,
                              batch_size=4, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match='params.npz'):
        loop.Trainer(config, device='cpu')


class Record(loop.MetricLogger):
    """Keeps every logged row."""

    def __init__(self, on_log=None):
        super().__init__()
        self.rows, self._on_log = [], on_log

    def log(self, metrics, step):
        self.rows.append((step, dict(metrics)))
        if self._on_log is not None:
            self._on_log(step)


def _npz_source(tmp_path, n=48, size=16):
    rng = np.random.RandomState(0)
    directory = str(tmp_path / 'npz')
    write_npz_shards(rng.randint(0, 256, (n, size, size, 3), dtype=np.uint8),
                     rng.randint(0, NUM_CLASSES, (n,)), directory,
                     shard_size=16)
    return directory


def _port_trainer(directory, data, total, **kwargs):
    config = loop.TrainConfig(
        model_name='vit_ti_patch16', img_size=32, batch_size=4,
        total_steps=total, dtype='float32', num_classes=NUM_CLASSES,
        dataset=data, checkpoint_dir=directory, images_per_epoch=4,
        checkpoint_every_epochs=2, eval_every_epochs=10**6, eval_batches=1,
        log_every=1, ema_decay=0.9, mu_dtype='bfloat16', lr=0.5, **kwargs)
    trainer = loop.Trainer(config, device='cpu')
    trainer.logger = Record()
    return trainer


def _losses(trainer):
    return {step: row['loss'] for step, row in trainer.logger.rows
            if 'loss' in row}


def test_trainer_resume_equals_a_straight_run(tmp_path):
    """4 steps straight == 2 steps, a new Trainer on the same directory
    (restoring the state and the loader's position), 2 more: the losses of
    steps 3-4 and the whole state, bit for bit."""
    data = _npz_source(tmp_path)
    straight = _port_trainer(str(tmp_path / 'a'), data, 4)
    straight.run()
    first = _port_trainer(str(tmp_path / 'b'), data, 2)
    first.run()
    assert CheckpointManager(str(tmp_path / 'b')).latest_step() == 2
    assert (tmp_path / 'b' / '2' / 'data.bin').exists()
    resumed = _port_trainer(str(tmp_path / 'b'), data, 4)
    assert resumed.state.step == 2
    resumed.run()
    assert sorted(_losses(resumed)) == [2, 3]
    assert _losses(resumed) == {k: v for k, v in _losses(straight).items()
                                if k >= 2}
    _assert_same_state(resumed.state.state_tree(),
                       straight.state.state_tree())
    assert CheckpointManager(str(tmp_path / 'b')).steps() == [2, 4]


def test_sigterm_checkpoints_at_the_next_step_and_returns(tmp_path):
    trainer = None
    before = signal.getsignal(signal.SIGTERM)

    def preempt(step):
        if step == 2:       # what a SIGTERM delivered during step 2 does
            handler = signal.getsignal(signal.SIGTERM)
            assert handler is not before
            handler(signal.SIGTERM, None)

    trainer = _port_trainer(str(tmp_path / 'ck'), 'synthetic', 6)
    trainer.logger = Record(preempt)
    trainer.run()
    assert signal.getsignal(signal.SIGTERM) is before
    # step 3 is off the cadence (every 2 steps): the signal's checkpoint
    assert trainer.state.step == 3
    assert CheckpointManager(str(tmp_path / 'ck')).steps() == [2, 3]
    assert _port_trainer(str(tmp_path / 'ck'), 'synthetic', 6).state.step == 3


def test_profile_steps_write_a_trace(tmp_path):
    trainer = _port_trainer(None, 'synthetic', 2, profile_steps=(0, 1),
                            profile_dir=str(tmp_path / 'prof'))
    trainer.run()
    assert os.listdir(tmp_path / 'prof') == ['trace_steps_0_1.json']


# ------------------------------------------- Orbax -> the port (converter)

JAX_SETTINGS = dict(clip_grad=1.0, mu_dtype='bfloat16', ema_decay=0.9)


def _jax_config(directory, **kwargs):
    from sav_tpu.train import TrainConfig
    return TrainConfig(model_name='vit_ti_patch16', img_size=32,
                       batch_size=8, total_steps=2, dtype='float32',
                       num_classes=NUM_CLASSES, dataset='synthetic',
                       checkpoint_dir=directory, images_per_epoch=64,
                       log_every=1, eval_every_epochs=10**6,
                       checkpoint_every_epochs=10**6, eval_batches=1,
                       **kwargs)


def test_converted_orbax_checkpoint_resumes_in_the_port(tmp_path):
    from sav_tpu.train import Trainer as JaxTrainer

    src, dst = str(tmp_path / 'orbax'), str(tmp_path / 'torch')
    jt = JaxTrainer(_jax_config(src, **JAX_SETTINGS))
    jt.run()
    step = converter.convert(src, dst, model_name='vit_ti_patch16',
                             img_size=32, num_classes=NUM_CLASSES,
                             clip_grad=1.0, mu_dtype='bfloat16', ema=True)
    assert step == 2

    config = loop.TrainConfig(
        model_name='vit_ti_patch16', img_size=32, batch_size=8,
        total_steps=3, dtype='float32', num_classes=NUM_CLASSES,
        checkpoint_dir=dst, images_per_epoch=64, **JAX_SETTINGS)
    pt = loop.Trainer(config, device='cpu')
    assert pt.state.step == 2
    tree = pt.state.state_tree()
    # Adam's state sits after the clip in the chain: found by its type
    adam = next(s for s in jt.state.opt_state
                if isinstance(s, optax.ScaleByAdamState))
    assert int(tree['opt_state']['count']) == int(adam.count) == 2
    for key in ('mu', 'nu'):
        want = flatten_tree(jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float32), getattr(adam, key)))
        got = flatten_tree(tree['opt_state'][key])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for key in ('params', 'ema_params'):
        want = flatten_tree(jax.tree_util.tree_map(
            np.asarray, getattr(jt.state, key)))
        got = flatten_tree(tree[key])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # one explicit batch through both train steps: the JAX Trainer's own
    # compiled sav_tpu.train.steps.train_step, on a batch of its synthetic
    # source (sharded as the step was compiled for; no stochastic depth in
    # vit_ti, so the key is unused), and the same numbers in the port
    batch = jt._dataset().batch(99)
    jstate, jm = jt.train_step(jt.state, batch, jt.step_rng)
    pm = pt.train_step({
        'images': torch.from_numpy(np.array(batch['images'])),
        'labels': torch.from_numpy(np.asarray(batch['labels'], np.int64))})
    np.testing.assert_allclose(float(pm['loss']), float(jm['loss']),
                               atol=1e-5, rtol=0)
    for key in ('params', 'ema_params'):
        want = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                   getattr(jstate, key)))
        got = flatten_tree(torch_to_flax(
            pt.model.state_dict() if key == 'params' else pt.state.ema_params))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                       err_msg=f'{key}/{k}')
    assert pt.state.step == 3 and pt.optimizer.count == 3


def test_converter_finds_adam_by_type_and_checks_the_counts():
    params = {'w': np.zeros(2, np.float32)}
    for clip, wd in ((None, 0.0), (1.0, 1e-4)):
        tx = converter.build_optimizer(lambda c: 0.0, weight_decay=wd,
                                       clip_grad=clip)
        st = converter.TrainState.create({'params': params}, tx)
        tree = converter.torch_tree(st)
        assert int(tree['opt_state']['count']) == 0
        assert tree['ema_params'] is None
    chain = list(st.opt_state)
    index = next(i for i, s in enumerate(chain)
                 if isinstance(s, optax.ScaleByScheduleState))
    chain[index] = optax.ScaleByScheduleState(count=np.asarray(5, np.int32))
    with pytest.raises(ValueError, match="schedule's count"):
        converter.torch_tree(st.replace(opt_state=tuple(chain)))


def test_loader_state_seeks_and_refuses_another_source(tmp_path):
    from sav_tpu_torch.data.pipeline import create_dataset
    data = _npz_source(tmp_path)

    def loader(batch_size=4):
        return create_dataset(data, batch_size=batch_size, image_size=16,
                              num_classes=NUM_CLASSES, seed=3,
                              augmentation='none')

    a = loader()
    for step in range(3):
        a.batch(step)
    saved = a.get_state()
    assert json.loads(saved)['next_step'] == 3
    b = loader()
    b.set_state(saved)
    assert b._next_step == 3
    assert torch.equal(a.batch(3)['images'], b.batch(3)['images'])
    with pytest.raises(ValueError, match='batch size'):
        loader(batch_size=8).set_state(saved)
    for d in (a, b):
        d.close()
