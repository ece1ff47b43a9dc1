"""Torch port: TNT training. Three ``train_step``s from one flax tree
against ``sav_tpu.train.steps``: the port's per-op path, its inner-layer
span (``'fused_inner'``: the Function with the K7 twins' closed-form
backward) and both spans (``'fused_inner_outer'``, the outer sublayer on
K1's twin without the residual and the flash backward's twin) against the
JAX package in the same mode (its Pallas kernels in interpret mode), and
with gradient accumulation.

float32, ``torch_parity.TNT_SMALL``. Tolerances as in test_torch_train.py
(slice 2): losses, metrics and parameters after 3 steps atol 1e-5, Adam
eps 1e-3 for the comparison (see there why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import tnt_inner as jax_ti
from sav_tpu.train import state as jax_state
from sav_tpu.train import steps as jax_steps
from sav_tpu_torch.train import state, steps
from sav_tpu_torch.utils.flax_bridge import flatten_tree, torch_to_flax
from torch_parity import NUM_CLASSES, jax_tnt, torch_tnt

IMG = 32
STEP_EPS = 1e-3


def _batch(i, n=4):
    rng = np.random.RandomState(40 + i)
    return {'images': rng.standard_normal((n, IMG, IMG, 3)).astype(np.float32),
            'labels': rng.randint(0, NUM_CLASSES, (n,)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == 'labels' else v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_train(use_kernel, grad_accum):
    old, jax_ti._NB = jax_ti._NB, 128
    try:
        model, params = jax_tnt(use_kernel=use_kernel)
        tx = jax_state.build_optimizer(1e-3, eps=STEP_EPS)
        jstate = jax_state.TrainState.create({'params': params}, tx)
        step = jax.jit(functools.partial(
            jax_steps.train_step, model=model, tx=tx, num_classes=NUM_CLASSES,
            label_smoothing=0.1, grad_accum=grad_accum))
        metrics = []
        for i in range(3):
            batch = {k: jnp.asarray(v) for k, v in _batch(i).items()}
            jstate, m = step(jstate, batch, jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jax_ti._NB = old
    return params, metrics, flatten_tree(jax.tree_util.tree_map(
        np.asarray, jstate.params))


@pytest.mark.parametrize('use_kernel,grad_accum', [
    (False, 1), ('fused_inner', 1), ('fused_inner_outer', 1),
    ('fused_inner', 2)])
def test_train_step_matches_jax(use_kernel, grad_accum):
    params, want_metrics, want_params = _jax_train(use_kernel, grad_accum)
    model = torch_tnt(params, use_kernel=use_kernel)
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
