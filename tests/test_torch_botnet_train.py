"""Torch port: BoTNet training with BatchNorm running statistics. Three
``train_step``s from one flax ``{'params', 'batch_stats'}`` tree against
``sav_tpu.train.steps.train_step`` on the small BoTNet
(``torch_parity.BOTNET_SMALL``): the per-op path and ``'botnet_fused'``
(the JAX kernels in interpret mode against the port's K9 twins), and
``grad_accum=2``, where the statistics thread through the microbatches in
order as the JAX ``lax.scan`` threads them. Then ``eval_step`` on the
running statistics, with and without the EMA parameters; and the
``Trainer.save_checkpoint`` -> ``predict.load_params_npz`` round trip of
``batch_stats``, and its refusal of a file without them.

float32. Tolerances as in test_torch_train.py (slice 2): losses, metrics,
parameters and running statistics after 3 steps atol 1e-5, Adam eps 1e-3
for the comparison (see there why).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.train import state as jax_state
from sav_tpu.train import steps as jax_steps
from sav_tpu_torch import predict
from sav_tpu_torch.models import create_model
from sav_tpu_torch.train import loop, state, steps
from sav_tpu_torch.utils.flax_bridge import flatten_tree, variables_of
from torch_parity import BOTNET_IMG, NUM_CLASSES, jax_botnet, torch_botnet

STEP_EPS = 1e-3


def _batch(i, n=4):
    rng = np.random.RandomState(60 + i)
    return {'images': rng.standard_normal(
                (n, BOTNET_IMG, BOTNET_IMG, 3)).astype(np.float32),
            'labels': rng.randint(0, NUM_CLASSES, (n,)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == 'labels' else v)
            for k, v in batch.items()}


def _flat(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


@functools.lru_cache(maxsize=None)
def _jax_train(use_kernel, grad_accum):
    model, variables = jax_botnet(use_kernel=use_kernel)
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


@pytest.mark.parametrize('use_kernel,grad_accum', [
    (False, 1), ('botnet_fused', 1), ('botnet_fused', 2)])
def test_train_steps_match_jax(use_kernel, grad_accum):
    variables, want_metrics, want_params, want_stats, want_evals = _jax_train(
        use_kernel, grad_accum)
    model = torch_botnet(variables, use_kernel=use_kernel)
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
    assert not model.training


def _trainer(tmp_path):
    config = loop.TrainConfig(model_name='botnet_t3', img_size=32,
                              batch_size=2, num_classes=NUM_CLASSES,
                              dtype='float32', total_steps=1,
                              checkpoint_dir=str(tmp_path))
    return loop.Trainer(config, device='cpu')


def test_checkpoint_round_trips_batch_stats(tmp_path):
    trainer = _trainer(tmp_path)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for buf in trainer.model.buffers():
            buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    trainer.save_checkpoint()
    with np.load(trainer.checkpoint_path) as npz:
        keys = set(npz.files)
    assert 'batch_stats/BatchNorm_0/mean' in keys
    assert 'BoTBlock_5/BoTMHSA_0/RelativeLogits_0/rel_pos_emb_h' in keys
    assert 'BatchNorm_0/mean' not in keys and 'BatchNorm_0/scale' in keys
    fresh = create_model('botnet_t3', num_classes=NUM_CLASSES, img_size=32,
                         device='cpu', seed=1)
    predict.load_params_npz(fresh, trainer.checkpoint_path)
    want = trainer.model.state_dict()
    got = fresh.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_load_refuses_a_file_without_batch_stats(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.save_checkpoint()
    path = os.path.join(tmp_path, 'stripped.npz')
    with np.load(trainer.checkpoint_path) as npz:
        np.savez(path, **{k: npz[k] for k in npz.files
                          if not k.startswith('batch_stats/')})
    with pytest.raises(ValueError, match='batch_stats'):
        predict.load_params_npz(trainer.model, path)
