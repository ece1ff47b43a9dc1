"""Torch port: BoTNet. A small BoTNet (``torch_parity.BOTNET_SMALL``:
botnet_t3's blocks, one a stage, 16 filters, 64 px, so the BoT stage is a
4 x 4 grid of 2 heads of d = 64) from one flax ``{'params',
'batch_stats'}`` tree with filled BatchNorms and running statistics
against ``sav_tpu.models.BoTNet``: logits in train mode (batch statistics)
and eval mode (running statistics) on both routes (``False``, the per-op
path, and ``'botnet_fused'``, the JAX kernel in interpret mode against the
port's twins), and the running statistics after the train-mode forward;
the port's state-dict keys and shapes against the flax tree of
botnet_t3/t4/t5 at 224 (``jax.eval_shape``); ``SqueezeExciteBlock`` alone;
the routes' refusals.

float32. Tolerances: logits atol 1e-4, as the ViT, CaiT, Mixer and TNT
tests; running statistics and the SE block 1e-5 (f32 reductions in
another order).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.nn import SqueezeExciteBlock as JaxSE
from sav_tpu_torch.models import create_model, set_use_kernel
from sav_tpu_torch.models import botnet
from sav_tpu_torch.models.factory import MODEL_CONFIGS
from sav_tpu_torch.nn.squeeze_excite import SqueezeExciteBlock
from sav_tpu_torch.utils.flax_bridge import (flatten_tree, torch_to_flax,
                                             variables_of)
from torch_parity import (BOTNET_IMG, NUM_CLASSES, images, jax_botnet,
                          torch_botnet)

ATOL = 1e-4
ROUTES = (False, 'botnet_fused')
NAMES = ('botnet_t3', 'botnet_t4', 'botnet_t5')


@pytest.mark.parametrize('train', [True, False])
@pytest.mark.parametrize('use_kernel', ROUTES)
def test_logits_and_running_stats_match_jax(use_kernel, train):
    x = images(3, BOTNET_IMG, seed=5)
    model, variables = jax_botnet(use_kernel=use_kernel)
    want, updated = jax.jit(functools.partial(
        model.apply, is_training=train, mutable=['batch_stats']))(
            variables, jnp.asarray(x))
    ours = torch_botnet(variables, use_kernel=use_kernel).train(train)
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    assert got.shape == (3, NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    stats = variables_of(ours)['batch_stats']
    want_stats = flatten_tree(jax.tree_util.tree_map(
        np.asarray, updated['batch_stats']))
    got_stats = flatten_tree(stats)
    assert sorted(got_stats) == sorted(want_stats)
    for key, value in got_stats.items():
        np.testing.assert_allclose(value, want_stats[key], atol=1e-5, rtol=0,
                                   err_msg=key)
    if not train:       # eval leaves the running statistics as they were
        before = flatten_tree(variables['batch_stats'])
        assert all(np.array_equal(got_stats[k], before[k]) for k in before)


def test_routes_agree_and_auto_is_per_op_off_the_card():
    """'auto' off the card is the per-op path, bit for bit; the fused route
    reads the same parameters and agrees to f32 rounding."""
    x = torch.from_numpy(images(2, BOTNET_IMG, seed=6))
    _, variables = jax_botnet()
    model = torch_botnet(variables, use_kernel='auto').eval()
    with torch.no_grad():
        auto = model(x)
        set_use_kernel(model, False)
        plain = model(x)
        set_use_kernel(model, 'botnet_fused')
        fused = model(x)
    assert torch.equal(auto, plain)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize('name', NAMES)
def test_state_dict_matches_the_flax_tree(name):
    """Every parameter and running statistic of botnet_t3/t4/t5 @224 under
    the flax path and shape (``jax.eval_shape``, no weights made)."""
    shapes = jax.eval_shape(
        lambda: jax_create_model(name, num_classes=1000).init(
            jax.random.PRNGKey(0), jnp.ones((1, 224, 224, 3)),
            is_training=False))
    want = {k: tuple(v.shape) for k, v in flatten_tree(
        jax.tree_util.tree_map(lambda a: np.broadcast_to(np.float32(0), a.shape),
                               {c: shapes[c] for c in ('params', 'batch_stats')})
    ).items()}
    model_cls, config = MODEL_CONFIGS[name]
    model = model_cls(num_classes=1000, img_size=224, **config)
    state = model.state_dict()
    buffers = [n for n, _ in model.named_buffers()]
    got = {k: tuple(v.shape) for k, v in flatten_tree(
        torch_to_flax(state, buffers)).items()}
    assert got == want
    grids = {m.grid for m in model.modules() if isinstance(m, botnet.BoTMHSA)}
    assert grids == {14}


def test_squeeze_excite_matches_flax():
    rng = np.random.RandomState(8)
    x = rng.standard_normal((2, 5, 5, 32)).astype(np.float32)
    flax_se = JaxSE(se_ratio=0.0625, activation_fn=fnn.swish)
    params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.3,
        flax_se.init(jax.random.PRNGKey(0), jnp.asarray(x))['params'])
    want = flax_se.apply({'params': params}, jnp.asarray(x))
    se = SqueezeExciteBlock(32, 0.0625, botnet.swish)
    assert se.Dense_0.kernel.shape == (32, 2)        # max(1, int(32 * 0.0625))
    se.load_state_dict({f'{k}.{n}': torch.from_numpy(np.asarray(v))
                        for k, d in params.items() for n, v in d.items()})
    with torch.no_grad():
        got = se(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert SqueezeExciteBlock(8, 0.0625, botnet.swish).Dense_0.kernel.shape[1] == 1


def test_refusals_and_names():
    assert {'botnet_t3', 'botnet_t4', 'botnet_t5'} <= set(MODEL_CONFIGS)
    with pytest.raises(NotImplementedError, match='BoTNet mode'):
        create_model('botnet_t3', device='cpu', img_size=64,
                     use_kernel='fused_layer')
    model = create_model('botnet_t3', device='cpu', img_size=BOTNET_IMG,
                         num_classes=NUM_CLASSES, stage_sizes=(1, 1, 1, 1),
                         initial_filters=16, num_heads=2)
    with pytest.raises(NotImplementedError, match='BoTNet mode'):
        set_use_kernel(model, True)
    with pytest.raises(ValueError, match='core'):
        botnet.set_attention_core(model, 'xla')
    with pytest.raises(ValueError, match='4 x 4 grid'):
        model(torch.zeros(1, 96, 96, 3))
    with pytest.raises(TypeError):
        create_model('botnet_t3', device='cpu', img_size=64, scan_layers=True)
