"""Torch port, K11 (``ops/th_attention.py``: ``th_attention_sublayer_q8``,
the kernel wrapper ``th_attention_q8`` and its plain twin
``th_q8_reference``) against the JAX package's ``th_attention_sublayer_q8``
(its kernel ``_th_q8_kernel`` in interpret mode on the CPU) at B = 2, H = 4,
d = 48, D = 192 (cait_xxs's heads), H = 8 and 16 at D = 128, and L = 17 (a
ragged 16-row tile); the
geometry test ``th_supported`` against the JAX one; a shape where it does
not hold (d = 72) is the bf16 span on both sides; CaiT
``quantized='all'`` under ``use_kernel='fused_th'`` from one flax tree (2
body + 1 class-attention layers, D = 192, H = 4, 32 px): the tree and the
logits; the route decision of ``'all'`` on the card; the serving-only
refusals.

Tolerances. The weight codes and scales: identical. K11's output: at
least 90% of the bf16 values identical to the JAX kernel's and the rest
within 2e-2 of max |out| (the JAX kernel is compiled by XLA as one fused
body whose LayerNorm and softmax sums run in other orders, so a value a
hair from a .5 code boundary may take the other code; one flipped code
moves an output by ~1/127 of its row's scale, a wrong band, scale or mix
by O(1)); the reading at this shape is every value identical. The bf16
fallback: 1e-2 of max |out| (bf16 rounding of q/k/v/p at the same points,
f32 sums in other orders). CaiT logits, float32: 1e-4 of max |logit|
(test_torch_int8_models.py's tolerance), and the 'all' route must move
them by at least 10x that from the unquantized model of the same tree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu.ops import th_attention as jth
from sav_tpu_torch.models import create_model
from sav_tpu_torch.ops import fused_layer as tfl
from sav_tpu_torch.ops import th_attention as tth
from sav_tpu_torch.utils.flax_bridge import (flatten_tree, flax_to_torch,
                                             torch_to_flax)
from test_torch_quantized import KERNEL_SHARE, _np, _pair, _rel
from torch_parity import NUM_CLASSES, fill_body, fill_head, images

OUT_TOL = 2e-2
BF16_TOL = 1e-2
LOGIT_TOL = 1e-4
NAMES = ('scale', 'bias', 'wq', 'wk', 'wv', 'wo', 'm_pre', 'm_post')
IMG = 32
CAIT = dict(num_layers=2, num_layers_token_only=1, embed_dim=192,
            num_heads=4, stoch_depth_rate=0.0)


def _case(seq, heads=4, head_d=48, seed=0, dim=None):
    rng = np.random.RandomState(seed + seq)
    dim = heads * head_d if dim is None else dim
    w = lambda *s, std=1.0: (std * rng.standard_normal(s)
                             / np.sqrt(dim)).astype(np.float32)
    mix = lambda: (np.eye(heads) + 0.3 * rng.standard_normal(
        (heads, heads))).astype(np.float32)
    return dict(
        x=rng.standard_normal((2, seq, dim)).astype(np.float32),
        scale=rng.uniform(0.5, 1.5, dim).astype(np.float32),
        bias=(0.1 * rng.standard_normal(dim)).astype(np.float32),
        # wq 4x wider than lecun: a peaked softmax, not a near-uniform mean
        wq=w(dim, heads, head_d, std=4.0), wk=w(dim, heads, head_d),
        wv=w(dim, heads, head_d), wo=w(heads, head_d, dim),
        m_pre=mix(), m_post=mix())


def _run(c, heads=4):
    jx, tx = _pair(c['x'], 'bfloat16')
    want = jth.th_attention_sublayer_q8(
        jx, *[jnp.asarray(c[k]) for k in NAMES], heads)
    with torch.no_grad():
        ours = tth.th_attention_sublayer_q8(
            tx, *[torch.from_numpy(c[k]) for k in NAMES], heads)
    return ours, want, tx


@pytest.mark.parametrize('l,heads,head_ch', [
    (17, 4, 48), (196, 4, 48), (196, 8, 48), (196, 6, 48), (196, 16, 48),
    (288, 8, 48), (289, 8, 48), (448, 4, 48), (576, 8, 48), (17, 2, 72)])
def test_th_supported_matches_jax(l, heads, head_ch):
    assert tth.th_supported(l, heads, head_ch) == jth.th_supported(
        l, heads, head_ch)


@pytest.mark.parametrize('heads,dim,seed', [(4, 192, 0), (8, 128, 1),
                                            (16, 128, 4)])
def test_k11_twin_matches_jax(heads, dim, seed):
    """cait_xxs's four heads at D = H*48, and eight heads (CaiT-S's) and
    sixteen (cait_m's) at a D narrower than H*48, each its own draw: at
    seed 0 the eight-head int8 span lies 0.0398 of max |out| from the bf16
    one, and the sixteen-head one 0.0387 at seed 2 and 0.0394 at seed 3, a
    hair inside the 2 x OUT_TOL this test asks of a draw to tell the two
    routes apart."""
    c = _case(17, heads, seed=seed, dim=dim)
    assert tth.th_supported(17, heads, 48)
    jw = tfl._q8_weights(*[torch.from_numpy(c[k])
                           for k in ('wq', 'wk', 'wv', 'wo')], dim,
                         heads * 48)
    # the JAX launcher's codes of the 64-lane padded weights, unpadded
    pad = jth._pad_weights(*[jnp.asarray(c[k]) for k in ('wq', 'wk', 'wv',
                                                           'wo')],
                           heads, 48, 64, jnp.float32)
    from sav_tpu.ops.quantized import quantize_symmetric
    keep = np.concatenate([np.arange(h * 64, h * 64 + 48)
                           for h in range(heads)])
    for i, ((tc, ts), jw_f) in enumerate(zip(jw, pad)):
        jc, js = quantize_symmetric(jw_f, axis=0)
        jc, js = np.asarray(jc), np.asarray(js)
        if i < 3:
            jc, js = jc[:, keep], js[:, keep]
        else:
            jc = jc[keep]
        np.testing.assert_array_equal(tc.numpy(), jc)
        np.testing.assert_array_equal(ts.numpy(), js)
    ours, want, tx = _run(c, heads)
    assert ours.dtype == torch.bfloat16 and ours.shape == tx.shape
    same = float((_np(ours) == _np(want)).mean())
    assert same >= KERNEL_SHARE and _rel(ours, want) <= OUT_TOL, \
        (same, _rel(ours, want))
    # the wrapper on a CPU tensor is the twin, and so is core='plain'
    with torch.no_grad():
        plain = tth.th_attention_sublayer_q8(
            tx, *[torch.from_numpy(c[k]) for k in NAMES], heads, core='plain')
    assert torch.equal(plain, ours)
    # the int8 projections move the span away from the bf16 one by more
    # than the tolerance, so a route that ran the bf16 span would fail
    with torch.no_grad():
        bf16 = tth.th_attention_sublayer(
            tx, *[torch.from_numpy(c[k]) for k in NAMES], heads)
    assert _rel(ours, bf16) >= 2 * OUT_TOL, _rel(ours, bf16)


def test_k11_off_geometry_is_the_bf16_span_on_both_sides():
    c = _case(17, heads=2, head_d=72)
    assert not tth.th_supported(17, 2, 72)
    assert not jth.th_supported(17, 2, 72)
    ours, want, tx = _run(c, heads=2)
    assert _rel(ours, want) <= BF16_TOL, _rel(ours, want)
    with torch.no_grad():
        bf16_span = tth.th_attention_sublayer(
            tx, *[torch.from_numpy(c[k]) for k in NAMES], 2)
    np.testing.assert_array_equal(_np(ours), _np(bf16_span))


def test_k11_raises_under_autograd():
    c = _case(17)
    args = [torch.from_numpy(c[k]).requires_grad_() for k in NAMES]
    x = torch.from_numpy(c['x']).bfloat16()
    with pytest.raises(RuntimeError, match='serving-only'):
        tth.th_attention_sublayer_q8(x, *args, 4)
    codes = tfl._q8_weights(*args[2:6], 192, 192)
    with pytest.raises(RuntimeError, match='serving-only'):
        tth.th_attention_q8(x.requires_grad_(), args[0], args[1],
                            *[t for pair in codes for t in pair], args[6],
                            args[7], 4)


def _cait_tree():
    model = jax_create_model('cait_xxs_24', num_classes=NUM_CLASSES, **CAIT)
    # jitted: the eager init dispatches op by op (~5x slower on this host)
    variables = jax.jit(model.init, static_argnames='is_training')(
        jax.random.PRNGKey(0), jnp.ones((1, IMG, IMG, 3)), is_training=False)
    return fill_body(fill_head(variables['params']))


def test_cait_quantized_all_matches_jax():
    params = _cait_tree()
    jmodel = jax_create_model('cait_xxs_24', num_classes=NUM_CLASSES,
                              quantized='all', use_kernel='fused_th', **CAIT)
    jtree = jax.eval_shape(functools.partial(
        jmodel.init, is_training=False), jax.random.PRNGKey(0),
        jnp.ones((1, IMG, IMG, 3)))['params']
    want_keys = sorted(flatten_tree(params))
    assert sorted(flatten_tree(jtree)) == want_keys
    x = images(2, IMG, seed=7)
    want = np.asarray(jax.jit(jmodel.apply, static_argnames='is_training')(
        {'params': params}, jnp.asarray(x), is_training=False))

    def ours(**kw):
        model = create_model('cait_xxs_24', num_classes=NUM_CLASSES,
                             img_size=IMG, device='cpu',
                             use_kernel='fused_th', **CAIT, **kw)
        model.load_state_dict(flax_to_torch(params), strict=True)
        with torch.no_grad():
            return model.eval(), model.eval()(torch.from_numpy(x)).numpy()

    model, got = ours(quantized='all')
    assert sorted(flatten_tree(torch_to_flax(model.state_dict()))) == want_keys
    assert model.Encoder_0.EncoderBlock_0.FFBlock_0.quantized == 'ff'
    assert model.CAEncoderBlock_0.FFBlock_0.quantized is False
    _, plain = ours()
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    moved = np.abs(plain - want).max() / scale
    assert err <= LOGIT_TOL and moved >= 10 * LOGIT_TOL, (err, moved)


def test_cait_all_routes(tmp_path):
    """Off the card 'auto' is the per-op path (bf16 attention, FF on K12's
    twin), as the JAX package off the TPU; on the card cait_xs (6 heads,
    D = 288) and cait_m take K5 (the decision, taken without a card),
    a head count the TH kernels are not built for raises under 'auto';
    the Trainer refuses 'all'."""
    model = create_model('cait_xxs_24', num_classes=NUM_CLASSES, img_size=IMG,
                         device='cpu', quantized='all', **CAIT)
    block = model.Encoder_0.EncoderBlock_0
    tokens = torch.zeros(1, (IMG // 16) ** 2, 192)
    assert block.th_route(tokens) is None
    for l, heads in ((196, 6), (196, 16)):
        assert tth.th_supported(l, heads, 48)
    assert tth.th_route(196, 6, 48, 288, 'cuda') == 'fused'
    with pytest.raises(NotImplementedError, match='use_kernel=False'):
        tth.th_route(196, 12, 48, 576, 'cuda')
    assert tth.th_route(196, 16, 48, 768, 'cuda') == 'fused'
    # @384 (L = 576) th_supported fails: 'all' is the bf16 span there
    assert not tth.th_supported(576, 8, 48)
    from sav_tpu_torch.train import TrainConfig, Trainer
    with pytest.raises(ValueError, match='K11'):
        Trainer(TrainConfig(model_name='cait_xxs_24', img_size=IMG,
                            batch_size=2, quantized='all',
                            checkpoint_dir=str(tmp_path)), device='cpu')
