"""Torch port, quantization-aware training: three ``train_step``s of a small
ViT with ``quantized='ff'`` (K13's training variant, whose stored bf16
hpre feeds ``_sublayer_bwd``) and with ``quantized=True`` (the library
int8 path with its straight-through backward), against
``sav_tpu.train.steps.train_step`` from one flax tree: losses, metrics and
every parameter.

float32, 2 layers, D = 128, 32 px, batch 4, Adam eps 1e-3 (as
test_torch_train.py, which says why). Tolerances: parameters after 3
steps atol 1e-5; losses and metrics atol 1e-5 plus rtol 1e-5. The int8
codes start out the same in both packages, so the first step agrees to f32
rounding; after two Adam steps the parameters differ by ~1e-7, and an
activation a hair from a .5 code boundary may then take the other code in
one package: the third 'ff' loss (12.9 at this filled head) moves by
3.8e-5, 3e-6 of itself. The straight-through backwards are f32 (True) and
f32 around the bf16-stored hpre ('ff'). Each route must also end at least
10x the tolerance away from the unquantized run of the same steps, so a
route that trained unquantized fails.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.train import state as jax_state
from sav_tpu.train import steps as jax_steps
from sav_tpu_torch.train import state, steps
from sav_tpu_torch.utils.flax_bridge import flatten_tree, torch_to_flax
from test_torch_train import IMG, STEP_EPS, _batch, _torch_batch
from torch_parity import NUM_CLASSES, jax_vit, torch_vit

ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_train(quantized):
    model, params = jax_vit(IMG, use_kernel=False, quantized=quantized)
    tx = jax_state.build_optimizer(1e-3, eps=STEP_EPS)
    jstate = jax_state.TrainState.create({'params': params}, tx)
    step = jax.jit(functools.partial(
        jax_steps.train_step, model=model, tx=tx, num_classes=NUM_CLASSES,
        label_smoothing=0.1))
    metrics = []
    for i in range(3):
        batch = {k: jnp.asarray(v) for k, v in _batch(i).items()}
        jstate, m = step(jstate, batch, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, metrics, flatten_tree(jax.tree_util.tree_map(
        np.asarray, jstate.params))


def _torch_train(params, quantized):
    model = torch_vit(params, IMG, use_kernel=False, quantized=quantized)
    ts = state.TrainState(model, state.build_optimizer(
        model.parameters(), 1e-3, eps=STEP_EPS))
    metrics = [steps.train_step(ts, _torch_batch(_batch(i)),
                                num_classes=NUM_CLASSES, label_smoothing=0.1)
               for i in range(3)]
    return metrics, flatten_tree(torch_to_flax(model.state_dict()))


@pytest.mark.parametrize('quantized', ['ff', True])
def test_int8_train_steps_match_jax(quantized):
    params, want_metrics, want_params = _jax_train(quantized)
    metrics, ours = _torch_train(params, quantized)
    for i, m in enumerate(metrics):
        assert sorted(m) == sorted(want_metrics[i])
        for k, v in m.items():
            np.testing.assert_allclose(float(v), want_metrics[i][k], atol=ATOL,
                                       rtol=ATOL, err_msg=f'{i} {k}')
    assert sorted(ours) == sorted(want_params)
    for k in ours:
        np.testing.assert_allclose(ours[k], want_params[k], atol=ATOL, rtol=0,
                                   err_msg=k)
    _, plain = _torch_train(params, False)
    moved = max(np.abs(plain[k] - want_params[k]).max() for k in plain)
    assert moved >= 10 * ATOL, moved
