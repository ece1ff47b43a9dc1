"""Torch port at CaiT-M's head geometry (16 heads of 48, ``cait_m_*``)
against sav_tpu from the same numpy inputs, float32:

* the talking-heads span ``th_attention_sublayer`` at B = 2, L = 37, D =
  128, H = 16 (d = 48), forward and all nine gradients, on each of the
  port's routes (on the CPU each route runs its kernels' plain twins):
  against the JAX span in Pallas interpret mode (its fused kernel K5,
  ``_th_fwd_kernel`` and ``_th_bwd_kernel``, once, shared by the three
  routes: one interpret-mode vjp at 16 unrolled heads takes ~20 s on one
  CPU) and against its jnp twin ``th_sublayer_reference`` with and without
  the residual;
* a cait_m-shaped CaiT (D = 768, 16 heads, 2 body + 1 class-attention
  layers, 64 px: 16 patches) from one flax tree: logits for every
  ``use_kernel`` the port takes against the JAX model's per-op path and
  its 'fused_th' route (interpret mode), and three ``train_step``s against
  ``sav_tpu.train.steps`` on the per-op path and the span.

Tolerances as the files they extend: the span's forward atol 2e-5 and
each gradient within 5e-4 of its max |grad| (``test_torch_th_attention.py``,
the JAX package's own kernel-vs-twin bounds); logits atol 1e-4
(``test_torch_cait.py``'s bound; f32 sums of 768 in another order);
losses, metrics and parameters after 3
steps atol 1e-5 with Adam eps 1e-3 (``test_torch_cait_train.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import th_attention as jax_th
from sav_tpu.train import state as jax_state
from sav_tpu.train import steps as jax_steps
from sav_tpu_torch.models import cait
from sav_tpu_torch.ops import th_attention as th
from sav_tpu_torch.train import state, steps
from sav_tpu_torch.utils.flax_bridge import flatten_tree, torch_to_flax
from torch_parity import NUM_CLASSES, fill_body, images, jax_vit, torch_vit

FWD_TOL = 2e-5
GRAD_TOL = 5e-4
LOGIT_TOL = 1e-4
STEP_EPS = 1e-3
NAMES = ('x', 'scale', 'bias', 'wq', 'wk', 'wv', 'wo', 'm_pre', 'm_post')
SPAN = (2, 37, 128, 16)         # B, L, D, H: d = 48, cait_m's heads
IMG = 64
CAIT_M = dict(num_layers=2, num_layers_token_only=1, stoch_depth_rate=0.0)


def _inputs(seed):
    b, l, dim, heads = SPAN
    d = th.HEAD_CH
    rng = np.random.RandomState(seed)
    mk = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    ins = (mk(b, l, dim), 1.0 + 0.1 * mk(dim), 0.1 * mk(dim),
           mk(dim, heads, d, std=dim ** -0.5), mk(dim, heads, d, std=dim ** -0.5),
           mk(dim, heads, d, std=dim ** -0.5),
           mk(heads, d, dim, std=(heads * d) ** -0.5),
           np.eye(heads, dtype=np.float32) + 0.2 * mk(heads, heads),
           np.eye(heads, dtype=np.float32) + 0.2 * mk(heads, heads))
    return ins, mk(b, l, dim, std=1.0 / np.sqrt(l))        # cotangent


@functools.lru_cache(maxsize=None)
def _jax(fn, residual=False, seed=0):
    """(out, nine gradients) of the JAX span ('kernel') or its twin."""
    ins, g = _inputs(seed)
    heads = SPAN[3]
    if fn == 'kernel':
        f = lambda *a: jax_th.th_attention_sublayer(*a, heads, jax_th.LN_EPS,
                                                    residual)
    else:
        f = lambda *a: jax_th.th_sublayer_reference(*a, residual=residual)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in ins))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _port(route, residual=False, seed=0):
    ins, g = _inputs(seed)
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    out = th.th_attention_sublayer(*ts, SPAN[3], th.LN_EPS, residual, route)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    return out.detach().numpy(), [t.numpy() for t in grads]


def _check(port, want):
    np.testing.assert_allclose(port[0], want[0], atol=FWD_TOL, rtol=0)
    for name, ours, ref in zip(NAMES, port[1], want[1]):
        assert ours.shape == ref.shape, name
        err = np.abs(ours.astype(np.float64) - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_the_span_shape_is_a_kernel_shape_on_both_sides():
    """The JAX side runs its fused kernel K5 here; the port's kernels are
    built for these heads, and on the card the span takes K5."""
    b, l, dim, heads = SPAN
    assert jax_th.th_mode(l, heads, th.HEAD_CH) == 'fused'
    assert th.kernel_supported(heads, th.HEAD_CH)
    assert th.th_route(l, heads, th.HEAD_CH, 768, 'cuda') == 'fused'
    assert th.th_route(l, heads, th.HEAD_CH, dim, 'cuda') == 'fused'


@pytest.mark.parametrize('route', th.ROUTES)
def test_span_matches_jax_kernel(route):
    _check(_port(route), _jax('kernel'))


@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('route', th.ROUTES)
def test_span_matches_jax_reference(route, residual):
    _check(_port(route, residual, seed=1), _jax('reference', residual, 1))


# ---- a cait_m-shaped CaiT at depth 2

@functools.lru_cache(maxsize=None)
def _jax_model(use_kernel=False):
    """The flax model and its tree: head, LayerScale and LayerNorms filled
    (``fill_body``), the head then scaled by 1/20 so that the logits are
    O(1) and the loss near ln 10, as in training (the filled head alone
    gives |logit| ~75 at D = 768 and a loss of ~80, whose f32 rounding is
    1e-5 by itself)."""
    model, params = jax_vit(IMG, name='cait_m_24', overrides=CAIT_M,
                            use_kernel=use_kernel)
    params = fill_body(params)
    params['Dense_0']['kernel'] = params['Dense_0']['kernel'] / 20
    params['Dense_0']['bias'] = params['Dense_0']['bias'] / 20
    return model, params


@functools.lru_cache(maxsize=None)
def _jax_logits(use_kernel):
    model, _ = _jax_model(use_kernel)
    _, params = _jax_model(False)                  # one tree for both
    return np.asarray(model.apply({'params': params},
                                  jnp.asarray(images(2, IMG)),
                                  is_training=False))


def test_the_model_is_cait_m_shaped():
    _, params = _jax_model()
    model = torch_vit(params, IMG, name='cait_m_24', overrides=CAIT_M)
    block = model.Encoder_0.EncoderBlock_0
    assert block.num_heads == 16 and model.cls.shape == (1, 1, 768)
    attn = block.SelfAttentionBlock_0
    assert tuple(attn.queries.kernel.shape) == (768, 16, th.HEAD_CH)
    assert tuple(attn.TalkingHeadsBlock_0.talking_heads_transform.shape) == (
        16, 16)


@pytest.mark.parametrize('jax_kernel', [False, 'fused_th'])
@pytest.mark.parametrize('use_kernel', cait.USE_KERNEL)
def test_logits_match_jax(use_kernel, jax_kernel):
    _, params = _jax_model()
    model = torch_vit(params, IMG, name='cait_m_24', overrides=CAIT_M,
                      use_kernel=use_kernel)
    with torch.no_grad():
        logits = model(torch.from_numpy(images(2, IMG)))
    assert logits.shape == (2, NUM_CLASSES)
    np.testing.assert_allclose(logits.numpy(), _jax_logits(jax_kernel),
                               atol=LOGIT_TOL, rtol=0)


def _batch(i, n=4):
    rng = np.random.RandomState(30 + i)
    return {'images': rng.standard_normal((n, IMG, IMG, 3)).astype(np.float32),
            'labels': rng.randint(0, NUM_CLASSES, (n,)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_train():
    model, params = _jax_model()
    tx = jax_state.build_optimizer(1e-3, eps=STEP_EPS)
    jstate = jax_state.TrainState.create({'params': params}, tx)
    step = jax.jit(functools.partial(
        jax_steps.train_step, model=model, tx=tx, num_classes=NUM_CLASSES,
        label_smoothing=0.1, grad_accum=1))
    metrics = []
    for i in range(3):
        batch = {k: jnp.asarray(v) for k, v in _batch(i).items()}
        jstate, m = step(jstate, batch, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                        jstate.params))


@pytest.mark.parametrize('use_kernel', [False, 'fused_th'])
def test_train_step_matches_jax(use_kernel):
    want_metrics, want_params = _jax_train()
    _, params = _jax_model()
    model = torch_vit(params, IMG, name='cait_m_24', overrides=CAIT_M,
                      use_kernel=use_kernel)
    ts = state.TrainState(model, state.build_optimizer(
        model.parameters(), 1e-3, eps=STEP_EPS))
    for i in range(3):
        batch = {k: torch.from_numpy(v.astype(np.int64) if k == 'labels'
                                     else v) for k, v in _batch(i).items()}
        m = steps.train_step(ts, batch, num_classes=NUM_CLASSES,
                             label_smoothing=0.1,
                             generator=torch.Generator().manual_seed(i))
        assert sorted(m) == sorted(want_metrics[i])
        for k, v in m.items():
            np.testing.assert_allclose(float(v), want_metrics[i][k],
                                       atol=1e-5, rtol=0, err_msg=f'{i} {k}')
    ours = flatten_tree(torch_to_flax(model.state_dict()))
    assert sorted(ours) == sorted(want_params)
    for k in ours:
        np.testing.assert_allclose(ours[k], want_params[k], atol=1e-5, rtol=0,
                                   err_msg=k)
