"""Torch port, the SwitchBack backward (K14, ``ops/int8_ff.py``) against the
JAX package: the per-IN-row weight codes of ``_dx_quantized``; the twin
``int8_ff_dx_reference`` (which ``int8_ff_dx_raw`` runs on a CPU tensor)
against the JAX twin and the JAX kernel ``int8_ff_dx_raw`` in interpret
mode at M = 50 (not a multiple of the TPU kernel's 256-row blocks, nor of
the card kernel's 48- or 16-row bands), D = 128, F = 512, dy2 and dh; every
gradient of ``int8_ff_sublayer_sb`` (7) and of ``int8_ff(switchback=True)``
(5) against ``jax.vjp`` of the JAX ``custom_vjp``s; three ``train_step``s
of a small ViT and a small CaiT under ``quantized='ff_sb'`` against
``sav_tpu.train.steps.train_step`` from one flax tree.

Tolerances. Weight codes and scales: identical. K14's outputs: as every
int8 kernel against the JAX kernel in interpret mode (test_torch_quantized:
at least 90% of the values identical, the rest within 1e-2 of max); the
readings here are dy2 bit-identical and dh 0.9998 identical (an f32 ulp of
tanh in gelu' moves a bf16 dh by one ulp). Gradients: the backwards run
their [M, 4D] elementwise work and weight products in the operands'
dtype, bf16 here, where XLA's CPU backend and torch round the chain at
other points: 2e-2 of max, as test_torch_int8_ff.py holds the sublayer's
(a wrong term is off by O(1)). Train steps: float32, Adam eps 1e-3 (test_torch_train.py says why). The
first step at the tolerances of test_torch_int8_train.py: losses and
metrics atol 1e-5 plus rtol 1e-5, every parameter atol 1e-5 (read: 6e-6 at
CaiT's FF). After it the two packages' parameters differ by those few
1e-6, and int8 codes sit in the forward (K12, K13) and now also in the
backward (g's and dh's codes): a value a hair from a .5 code boundary
takes the other code in one package, and a flipped code of g or dh moves
every gradient upstream of it. So steps 2 and 3 are held to STEP_TOL =
2.5e-4 on every parameter and LOSS_RTOL = 1e-3 on the losses and metrics,
3x the readings (CaiT: parameters 8.2e-5, the third loss 3.3e-4 of
itself; ViT: 1.6e-5). SwitchBack and the straight-through backward ('ff')
put the parameters 1.2e-3 to 3.3e-3 apart from the first step on, and the
first step must end at least 10x ATOL from the port's own 'ff' and
unquantized runs, so a model that trained on another backward fails.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import int8_ff as jff
from sav_tpu.train import state as jax_state
from sav_tpu.train import steps as jax_steps
from sav_tpu_torch.ops import int8_ff as tff
from sav_tpu_torch.train import state, steps
from sav_tpu_torch.utils.flax_bridge import flatten_tree, torch_to_flax
from test_torch_quantized import _np, _pair, _rel, assert_near_kernel
from torch_parity import (NUM_CLASSES, jax_cait, jax_vit, torch_cait,
                          torch_vit)

M, D, F = 50, 128, 512
GRAD_TOL = 2e-2
ATOL = 1e-5
STEP_TOL = 2.5e-4
LOSS_RTOL = 1e-3
IMG = 32
STEP_EPS = 1e-3


def _case(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.standard_normal((M, D)).astype(np.float32),
        g=rng.standard_normal((M, D)).astype(np.float32),
        hpre=rng.standard_normal((M, F)).astype(np.float32),
        w1=(rng.standard_normal((D, F)) / np.sqrt(D)).astype(np.float32),
        b1=(0.1 * rng.standard_normal(F)).astype(np.float32),
        w2=(rng.standard_normal((F, D)) / np.sqrt(F)).astype(np.float32),
        b2=(0.1 * rng.standard_normal(D)).astype(np.float32),
        scale=rng.uniform(0.5, 1.5, D).astype(np.float32),
        bias=(0.1 * rng.standard_normal(D)).astype(np.float32))


def test_dx_codes_match_jax():
    c = _case(1)
    for name in ('w1', 'w2'):
        jq, js = jff._dx_quantized(jnp.asarray(c[name]))
        tq, ts = tff._dx_quantized(torch.from_numpy(c[name]))
        assert tq.shape == jq.shape and ts.shape == js.shape, name
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_k14_twin_matches_jax():
    c = _case(2)
    jg, tg = _pair(c['g'], 'bfloat16')
    jh, th = _pair(c['hpre'], 'bfloat16')
    jw = [*jff._dx_quantized(jnp.asarray(c['w1'])),
          *jff._dx_quantized(jnp.asarray(c['w2']))]
    tw = [*tff._dx_quantized(torch.from_numpy(c['w1'])),
          *tff._dx_quantized(torch.from_numpy(c['w2']))]
    dy2, dh = tff.int8_ff_dx_raw(tg, th, *tw)
    assert dy2.dtype == torch.bfloat16 and dy2.shape == (M, D)
    assert dh.dtype == torch.bfloat16 and dh.shape == (M, F)
    kernel = jff.int8_ff_dx_raw(jg, jh, *jw)
    twin = jff.int8_ff_dx_reference(jg, jh, *jw)
    for ours, k, t in zip((dy2, dh), kernel, twin):
        assert_near_kernel(ours, k)
        assert_near_kernel(ours, t)


def _leaves(c, names, x):
    return [x.clone().requires_grad_()] + [
        torch.from_numpy(c[k]).requires_grad_() for k in names]


def test_int8_ff_sublayer_sb_gradients_match_jax():
    c = _case(3)
    x = c['x'].reshape(2, 25, D)
    g = c['g'].reshape(2, 25, D)
    jx, tx = _pair(x, 'bfloat16')
    names = ('scale', 'bias', 'w1', 'b1', 'w2', 'b2')
    want, vjp = jax.vjp(jff.int8_ff_sublayer_sb, jx,
                        *[jnp.asarray(c[k]) for k in names])
    want_grads = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    leaves = _leaves(c, names, tx)
    out = tff.int8_ff_sublayer_sb(*leaves)
    out.backward(torch.from_numpy(g).bfloat16())
    assert out.shape == (2, 25, D)
    assert_near_kernel(out, want)
    for name, leaf, w in zip(('dx',) + names, leaves, want_grads):
        assert leaf.grad.dtype == leaf.dtype, name
        assert _rel(leaf.grad, w) <= GRAD_TOL, (name, _rel(leaf.grad, w))


def test_int8_ff_switchback_gradients_match_jax():
    c = _case(4)
    x, g = c['x'].reshape(2, 25, D), c['g'].reshape(2, 25, D)
    jx, tx = _pair(x, 'bfloat16')
    jw1, tw1 = _pair(c['w1'], 'bfloat16')
    jw2, tw2 = _pair(c['w2'], 'bfloat16')
    jb1, jb2 = jnp.asarray(c['b1']), jnp.asarray(c['b2'])
    want, vjp = jax.vjp(functools.partial(jff.int8_ff, switchback=True),
                        jx, jw1, jb1, jw2, jb2)
    want_grads = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    leaves = [t.clone().requires_grad_() for t in
              (tx, tw1, torch.from_numpy(c['b1']), tw2,
               torch.from_numpy(c['b2']))]
    out = tff.int8_ff(*leaves, switchback=True)
    out.backward(torch.from_numpy(g).bfloat16())
    assert_near_kernel(out, want)
    for name, leaf, w in zip(('dx', 'dw1', 'db1', 'dw2', 'db2'), leaves,
                             want_grads):
        assert leaf.grad.dtype == leaf.dtype, name
        assert _rel(leaf.grad, w) <= GRAD_TOL, (name, _rel(leaf.grad, w))


def test_switchback_cores_agree_on_the_cpu():
    """``core='plain'`` (the card's reference) and ``'kernel'`` (the twin
    on a CPU tensor) run the same function: identical gradients."""
    c = _case(5)
    x = torch.from_numpy(c['x'].reshape(2, 25, D)).bfloat16()
    names = ('scale', 'bias', 'w1', 'b1', 'w2', 'b2')
    grads = []
    for core in ('kernel', 'plain'):
        leaves = _leaves(c, names, x)
        out = tff.int8_ff_sublayer_sb(*leaves, core=core)
        out.float().square().sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ------------------------------------------------------ three train steps

def _batch(i, n=4):
    rng = np.random.RandomState(20 + i)
    return {'images': rng.standard_normal((n, IMG, IMG, 3)).astype(np.float32),
            'labels': rng.randint(0, NUM_CLASSES, (n,)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == 'labels' else v)
            for k, v in batch.items()}


_JAX = {'vit': lambda **kw: jax_vit(IMG, use_kernel=False, **kw),
        'cait': lambda **kw: jax_cait(IMG, use_kernel=False, **kw)}
_TORCH = {'vit': lambda p, **kw: torch_vit(p, IMG, use_kernel=False, **kw),
          'cait': lambda p, **kw: torch_cait(p, IMG, use_kernel=False, **kw)}


@functools.lru_cache(maxsize=None)
def _jax_train(family):
    model, params = _JAX[family](quantized='ff_sb')
    tx = jax_state.build_optimizer(1e-3, eps=STEP_EPS)
    jstate = jax_state.TrainState.create({'params': params}, tx)
    step = jax.jit(functools.partial(
        jax_steps.train_step, model=model, tx=tx, num_classes=NUM_CLASSES,
        label_smoothing=0.1))
    metrics, trees = [], []
    for i in range(3):
        batch = {k: jnp.asarray(v) for k, v in _batch(i).items()}
        jstate, m = step(jstate, batch, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
        trees.append(flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                         jstate.params)))
    return params, metrics, trees


def _torch_train(family, params, quantized):
    model = _TORCH[family](params, quantized=quantized)
    ts = state.TrainState(model, state.build_optimizer(
        model.parameters(), 1e-3, eps=STEP_EPS))
    metrics, trees = [], []
    for i in range(3):
        metrics.append(steps.train_step(
            ts, _torch_batch(_batch(i)), num_classes=NUM_CLASSES,
            label_smoothing=0.1, generator=torch.Generator().manual_seed(i)))
        trees.append({k: np.array(v) for k, v in flatten_tree(
            torch_to_flax(model.state_dict())).items()})
    return metrics, trees


def _dist(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in b)


@pytest.mark.parametrize('family', ['vit', 'cait'])
def test_switchback_train_steps_match_jax(family):
    params, want_metrics, want_trees = _jax_train(family)
    metrics, trees = _torch_train(family, params, 'ff_sb')
    for i, (m, tree) in enumerate(zip(metrics, trees)):
        assert sorted(m) == sorted(want_metrics[i])
        assert sorted(tree) == sorted(want_trees[i])
        atol, rtol = (ATOL, ATOL) if i == 0 else (STEP_TOL, LOSS_RTOL)
        for k, v in m.items():
            np.testing.assert_allclose(float(v), want_metrics[i][k], atol=atol,
                                       rtol=rtol, err_msg=f'{i} {k}')
        assert _dist(tree, want_trees[i]) <= (ATOL if i == 0 else STEP_TOL), \
            (i, _dist(tree, want_trees[i]))
    # the first step tells the SwitchBack backward from the straight-through
    # one ('ff', the same forward) and from the unquantized model
    for other in ('ff', False):
        _, trees_other = _torch_train(family, params, other)
        assert _dist(trees_other[0], want_trees[0]) >= 10 * ATOL, other
