"""Torch port, K10 (``ops/fused_layer.py``: ``attention_sublayer_q8`` and
its plain twin ``fused_attention_q8_plain``) against the JAX package's
``attention_sublayer_q8`` (its kernel ``_fused_infer_q8_kernel`` in
interpret mode on the CPU) at L = 17 and L = 64 (B = 2, D = 128, H = 2,
d = 64); the route off the kernel's geometry (d = 32, which neither the
JAX package's nor the port's ``fused_supported`` takes) is the bf16
sublayer on the 'flash' core on both sides; the port raises under
autograd.

Tolerances. The weight codes and scales: identical. The sublayer's
output: at least 90% of the bf16 values identical, the rest within 1e-2
of max |out - x| (the attention's own contribution, so the residual cannot
hide an error in it): the JAX kernel is compiled by XLA as one fused body,
so a few activations a hair from a .5 code boundary may take the other
code, and the LayerNorm's sums run in another order; one flipped code
moves an output by ~1/127 of its row's scale. The bf16 fallback: 1e-2 of
max |out - x| (bf16 rounding of q/k/v/p at the same points, f32 sums in
other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import fused_layer as jfl
from sav_tpu_torch.ops import fused_layer as tfl
from test_torch_quantized import KERNEL_SHARE, _np, _pair

TOL = 1e-2


def _case(seq, head_d=64, heads=2, seed=0):
    rng = np.random.RandomState(seed + seq)
    dim = heads * head_d
    w = lambda *s, std=1.0: (std * rng.standard_normal(s)
                             / np.sqrt(dim)).astype(np.float32)
    return dict(
        x=rng.standard_normal((2, seq, dim)).astype(np.float32),
        scale=rng.uniform(0.5, 1.5, dim).astype(np.float32),
        bias=(0.1 * rng.standard_normal(dim)).astype(np.float32),
        # wq 4x wider than lecun: a peaked softmax, not a near-uniform mean
        wq=w(dim, heads, head_d, std=4.0), wk=w(dim, heads, head_d),
        wv=w(dim, heads, head_d), wo=w(heads, head_d, dim)), heads


def _run(c, heads):
    jx, tx = _pair(c['x'], 'bfloat16')
    names = ('scale', 'bias', 'wq', 'wk', 'wv', 'wo')
    want = jfl.attention_sublayer_q8(jx, *[jnp.asarray(c[k]) for k in names],
                                     heads)
    with torch.no_grad():
        ours = tfl.attention_sublayer_q8(
            tx, *[torch.from_numpy(c[k]) for k in names], heads)
    return ours, want, tx


def _err(ours, want, x):
    delta = np.abs(_np(want) - _np(x)).max()
    return np.abs(_np(ours) - _np(want)).max() / delta


@pytest.mark.parametrize('seq', [17, 64])
def test_k10_twin_matches_jax(seq):
    c, heads = _case(seq)
    dim = c['x'].shape[-1]
    assert jfl.fused_supported(seq, heads, 64)
    assert tfl.fused_supported(seq, heads, 64)
    jw = jfl._q8_weights(*[jnp.asarray(c[k]) for k in ('wq', 'wk', 'wv', 'wo')],
                         dim, dim)
    tw = tfl._q8_weights(*[torch.from_numpy(c[k])
                           for k in ('wq', 'wk', 'wv', 'wo')], dim, dim)
    for (jc, js), (tc, ts) in zip(jw, tw):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    ours, want, tx = _run(c, heads)
    assert ours.dtype == torch.bfloat16 and ours.shape == tx.shape
    same = float((_np(ours) == _np(want)).mean())
    assert same >= KERNEL_SHARE and _err(ours, want, tx) <= TOL, \
        (same, _err(ours, want, tx))


def test_k10_off_geometry_is_the_bf16_span_on_both_sides():
    c, heads = _case(17, head_d=32, heads=4)
    assert not jfl.fused_supported(17, heads, 32)
    assert not tfl.fused_supported(17, heads, 32)
    ours, want, tx = _run(c, heads)
    assert _err(ours, want, tx) <= TOL
    with torch.no_grad():
        bf16_span = tfl.attention_sublayer(
            tx, *[torch.from_numpy(c[k]) for k in
                  ('scale', 'bias', 'wq', 'wk', 'wv', 'wo')], heads, 'flash')
    np.testing.assert_array_equal(_np(ours), _np(bf16_span))


def test_k10_at_d192_is_the_bf16_span():
    """ViT-Ti's width (D = H*64 = 192) is K1's but not K10's: the port's
    int8 sublayer serves it on the bf16 'flash' core, where K10 would
    raise on the card."""
    c, heads = _case(17, heads=3)
    assert tfl.fused_supported(17, heads, 64)
    assert not tfl.q8_supported(17, 192, heads, 64)
    assert tfl.q8_supported(17, 128, 2, 64)
    tx = torch.from_numpy(c['x']).to(torch.bfloat16)
    args = [torch.from_numpy(c[k]) for k in
            ('scale', 'bias', 'wq', 'wk', 'wv', 'wo')]
    with torch.no_grad():
        ours = tfl.attention_sublayer_q8(tx, *args, heads)
        bf16_span = tfl.attention_sublayer(tx, *args, heads, 'flash')
    np.testing.assert_array_equal(_np(ours), _np(bf16_span))


def test_k10_raises_under_autograd():
    c, heads = _case(17)
    args = [torch.from_numpy(c[k]).requires_grad_()
            for k in ('scale', 'bias', 'wq', 'wk', 'wv', 'wo')]
    x = torch.from_numpy(c['x']).bfloat16()
    with pytest.raises(RuntimeError, match='serving-only'):
        tfl.attention_sublayer_q8(x, *args, heads)
    codes = tfl._q8_weights(*args[2:], 128, 128)
    with pytest.raises(RuntimeError, match='serving-only'):
        tfl.fused_attention_q8(x.requires_grad_(), args[0], args[1],
                               *[t for pair in codes for t in pair], heads)
