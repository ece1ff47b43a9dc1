"""Torch port: CvT training. Three ``train_step``s from one flax
``{'params', 'batch_stats'}`` tree against ``sav_tpu.train.steps.
train_step`` on the small CvT (``torch_parity.CVT_SMALL``): the per-op
path, and the flash route (``'kernel'``: K4's and K2/K3's twins here,
the JAX kernel in interpret mode) with ``grad_accum=2``, where the
BatchNorm statistics thread through the microbatches in order; then
``eval_step`` on the running statistics, with and without the EMA
parameters; the ``Trainer.save_checkpoint`` -> ``predict.load_params_npz``
round trip of ``batch_stats``; and the CLIs, ``train`` then ``predict`` on
cvt-13 at 32 px, then ``--quantized ff`` both ways (``int8`` refused, as
the JAX model refuses it; ``all`` refused by ``train``, serving-only). The
int8 FF's training step is not held against the JAX trainer: upstream
BatchNorms on batch statistics flip its codes on f32 rounding
(test_torch_cvt.py's ``test_int8_ff_gradients_match_jax`` measures it and
holds its gradients on the running statistics).

float32. Tolerances as in test_torch_ceit_train.py: losses, metrics,
parameters and running statistics after 3 steps atol 1e-5, Adam eps 1e-3
for the comparison (test_torch_train.py says why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sav_tpu.train import state as jax_state
from sav_tpu.train import steps as jax_steps
from sav_tpu_torch import predict
from sav_tpu_torch.models import create_model
from sav_tpu_torch.train import __main__ as train_cli
from sav_tpu_torch.train import loop, state, steps
from sav_tpu_torch.utils.flax_bridge import flatten_tree, variables_of
from torch_parity import CVT_IMG, NUM_CLASSES, jax_cvt, torch_cvt

STEP_EPS = 1e-3


def _batch(i, n=4):
    rng = np.random.RandomState(90 + i)
    return {'images': rng.standard_normal(
                (n, CVT_IMG, CVT_IMG, 3)).astype(np.float32),
            'labels': rng.randint(0, NUM_CLASSES, (n,)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == 'labels' else v)
            for k, v in batch.items()}


def _flat(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


@functools.lru_cache(maxsize=None)
def _jax_train(use_kernel, grad_accum):
    model, variables = jax_cvt(use_kernel=use_kernel)
    tx = jax_state.build_optimizer(1e-3, eps=STEP_EPS)
    jstate = jax_state.TrainState.create(variables, tx, ema=True)
    step = jax.jit(functools.partial(
        jax_steps.train_step, model=model, tx=tx, num_classes=NUM_CLASSES,
        label_smoothing=0.1, grad_accum=grad_accum, ema_decay=0.5))
    metrics = []
    for i in range(3):
        batch = {k: jnp.asarray(v) for k, v in _batch(i).items()}
        jstate, m = step(jstate, batch, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    evals = {}
    for use_ema in (False, True):
        ev = jax.jit(functools.partial(
            jax_steps.eval_step, model=model, num_classes=NUM_CLASSES,
            use_ema=use_ema))(jstate, {k: jnp.asarray(v)
                                       for k, v in _batch(9).items()})
        evals[use_ema] = {k: float(v) for k, v in ev.items()}
    return (variables, metrics, _flat(jstate.params),
            _flat(jstate.batch_stats), evals)


@pytest.mark.parametrize('use_kernel,grad_accum', [(False, 1), ('kernel', 2)])
def test_train_steps_match_jax(use_kernel, grad_accum):
    variables, want_metrics, want_params, want_stats, want_evals = _jax_train(
        use_kernel, grad_accum)
    model = torch_cvt(variables, use_kernel=use_kernel)
    ts = state.TrainState(model, state.build_optimizer(
        model.parameters(), 1e-3, eps=STEP_EPS), ema=True)
    for i in range(3):
        m = steps.train_step(ts, _torch_batch(_batch(i)),
                             num_classes=NUM_CLASSES, label_smoothing=0.1,
                             grad_accum=grad_accum, ema_decay=0.5)
        assert sorted(m) == sorted(want_metrics[i])
        for k, v in m.items():
            np.testing.assert_allclose(float(v), want_metrics[i][k],
                                       atol=1e-5, rtol=0, err_msg=f'{i} {k}')
    ours = variables_of(model)
    for got, want in ((flatten_tree(ours['params']), want_params),
                      (flatten_tree(ours['batch_stats']), want_stats)):
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                       err_msg=k)
    # eval on the running statistics; under EMA only the parameters swap
    for use_ema, want in want_evals.items():
        ev = steps.eval_step(ts, _torch_batch(_batch(9)),
                             num_classes=NUM_CLASSES, use_ema=use_ema)
        assert sorted(ev) == sorted(want)
        for k, v in ev.items():
            np.testing.assert_allclose(float(v), want[k], atol=1e-4, rtol=0,
                                       err_msg=f'ema={use_ema} {k}')
    assert not model.training and ts.step == 3


def test_checkpoint_round_trips_batch_stats(tmp_path):
    config = loop.TrainConfig(model_name='cvt-13', img_size=32, batch_size=2,
                              num_classes=NUM_CLASSES, dtype='float32',
                              total_steps=1, checkpoint_dir=str(tmp_path))
    trainer = loop.Trainer(config, device='cpu')
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for buf in trainer.model.buffers():
            buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    trainer.save_checkpoint()
    with np.load(trainer.checkpoint_path) as npz:
        keys = set(npz.files)
    proj = 'Stage_2/StageBlock_9/CvTSelfAttentionBlock_0/ConvProjectionBlock_2'
    assert f'batch_stats/{proj}/BatchNorm_0/var' in keys
    assert f'{proj}/BatchNorm_0/scale' in keys and f'{proj}/Conv_0/kernel' in keys
    assert f'{proj}/BatchNorm_0/mean' not in keys
    assert 'Stage_2/cls' in keys and 'Stage_0/cls' not in keys
    fresh = create_model('cvt-13', num_classes=NUM_CLASSES, img_size=32,
                         device='cpu', seed=1)
    predict.load_params_npz(fresh, trainer.checkpoint_path)
    want = trainer.model.state_dict()
    got = fresh.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize('quantized', ['none', 'ff'])
def test_cli_trains_and_predict_reads_its_checkpoint(tmp_path, capsys,
                                                     quantized):
    ckpt = tmp_path / 'ck'
    metrics = train_cli.main(['--device', 'cpu', '--data_dir', 'synthetic',
                              '-m', 'cvt-13', '-s', '32', '-b', '2',
                              '--total_steps', '2', '--num_classes',
                              str(NUM_CLASSES), '-c', str(ckpt),
                              '--quantized', quantized])
    assert 'final metrics' in capsys.readouterr().out
    assert np.isfinite(metrics['loss']) and np.isfinite(metrics['eval_loss'])
    with np.load(ckpt / 'params.npz') as npz:
        assert any(k.startswith('batch_stats/') for k in npz.files)
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (40, 48, 3), dtype=np.uint8)).save(
            img_dir / f'im{i}.jpg', quality=95)
    predict.main(['-m', 'cvt-13', '-c', str(ckpt), '--images', str(img_dir),
                  '-s', '32', '--num_classes', str(NUM_CLASSES), '--device',
                  'cpu', '--top_k', '2', '--quantized', quantized])
    captured = capsys.readouterr()
    assert 'loaded' in captured.err
    assert len(captured.out.splitlines()) == 2
    with pytest.raises(ValueError, match='quantized'):
        predict.main(['-m', 'cvt-13', '-c', str(ckpt), '--images',
                      str(img_dir), '-s', '32', '--device', 'cpu',
                      '--quantized', 'int8'])
    with pytest.raises(ValueError, match='serving-only'):
        loop.Trainer(loop.TrainConfig(model_name='cvt-13', img_size=32,
                                      batch_size=2, quantized='all'),
                     device='cpu')
