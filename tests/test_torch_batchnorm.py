"""Torch port: BatchNorm, Conv and pooling (``nn.normalization``,
``nn.layers``) against flax's ``nn.BatchNorm``, ``nn.Conv``, ``max_pool``
and ``avg_pool`` as the BoTNet builds them.

BatchNorm at BoTNet's momentum 0.9 and eps 1e-5 on NHWC input, in train
mode (batch statistics, then the running-average update: flax's momentum
weighs the old value, the variance is the biased one) and eval mode (the
running statistics), f32 and bf16, with a non-trivial scale, bias and
running statistics; the running mean and var after two updates.
Tolerances: f32 outputs and statistics 1e-5 absolute (the f32 reductions
sum in another order); bf16 outputs two bf16 ulps of max |y| (2^-7: the
same f32 arithmetic rounded once to bf16, where a sum order can flip one
ulp). Conv and pooling at stride 2 on even and odd sizes, where flax's
'SAME' pads (0, 1) and torch's symmetric padding would shift the window:
1e-5.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu_torch.nn.layers import Conv, avg_pool, max_pool, same_pads
from sav_tpu_torch.nn.normalization import BatchNorm

import torch_parity  # noqa: F401  (pins torch to one thread)

C = 8


def _bn_case(seed=0):
    rng = np.random.RandomState(seed)
    params = {'scale': rng.uniform(0.5, 1.5, C).astype(np.float32),
              'bias': (0.3 * rng.standard_normal(C)).astype(np.float32)}
    stats = {'mean': (0.5 * rng.standard_normal(C)).astype(np.float32),
             'var': rng.uniform(0.5, 2.0, C).astype(np.float32)}
    xs = [(2.0 + 3.0 * rng.standard_normal((4, 5, 6, C))).astype(np.float32)
          for _ in range(2)]
    return params, stats, xs


def _torch_bn(params, stats, dtype):
    bn = BatchNorm(C, momentum=0.9, epsilon=1e-5, dtype=dtype)
    state = {k: torch.from_numpy(v) for k, v in {**params, **stats}.items()}
    bn.load_state_dict(state, strict=True)
    return bn


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('train', [True, False])
def test_batchnorm_matches_flax(train, dtype):
    params, stats, xs = _bn_case()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    flax_bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                            epsilon=1e-5, dtype=jdt)
    variables = {'params': params, 'batch_stats': stats}
    bn = _torch_bn(params, stats, tdt).train(train)
    for x in xs:
        xj = jnp.asarray(x).astype(jdt)
        want, updated = flax_bn.apply(variables, xj, mutable=['batch_stats'])
        variables = {'params': params, 'batch_stats': updated['batch_stats']}
        got = bn(torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        want = np.asarray(want.astype(jnp.float32))
        tol = 1e-5 if dtype == 'float32' else 2 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(got.float().detach().numpy(), want,
                                   atol=tol, rtol=0)
    # after two batches: updated twice in train mode, untouched in eval
    for name in ('mean', 'var'):
        np.testing.assert_allclose(
            getattr(bn, name).numpy(),
            np.asarray(variables['batch_stats'][name]), atol=1e-5, rtol=0,
            err_msg=name)
    if not train:
        assert np.array_equal(bn.mean.numpy(), stats['mean'])


def test_batchnorm_running_update_is_flax_momentum_and_biased_var():
    """One train step from mean 0 / var 1: ra = 0.9 * ra + 0.1 * batch with
    the biased variance (BatchNorm2d would store 0.1 * mean + 0.9 * ra and
    the unbiased variance)."""
    x = np.random.RandomState(3).standard_normal((2, 3, 3, C)).astype(
        np.float32)
    bn = BatchNorm(C, momentum=0.9)
    bn.init_params(torch.Generator().manual_seed(0))
    bn.train()
    with torch.no_grad():
        bn(torch.from_numpy(x))
    flat = x.reshape(-1, C)
    np.testing.assert_allclose(bn.mean.numpy(), 0.1 * flat.mean(0),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.var.numpy(), 0.9 + 0.1 * flat.var(0),
                               atol=1e-6, rtol=0)
    assert not bn.mean.requires_grad and not bn.var.requires_grad


def test_batchnorm_zero_scale_init_and_state_names():
    bn = BatchNorm(C, zero_scale=True)
    bn.init_params(torch.Generator().manual_seed(0))
    assert sorted(bn.state_dict()) == ['bias', 'mean', 'scale', 'var']
    assert [n for n, _ in bn.named_parameters()] == ['scale', 'bias']
    assert bn.scale.abs().sum() == 0 and bn.var.eq(1).all()


def _flax_conv(x, kernel, strides, padding):
    conv = fnn.Conv(kernel.shape[-1], kernel.shape[:2], strides=strides,
                    padding=padding, use_bias=False)
    return np.asarray(conv.apply({'params': {'kernel': kernel}},
                                 jnp.asarray(x)))


@pytest.mark.parametrize('size', [8, 7])
@pytest.mark.parametrize('kernel,strides,padding', [
    ((3, 3), (2, 2), 'SAME'), ((1, 1), (2, 2), 'SAME'),
    ((3, 3), (1, 1), 'SAME'), ((7, 7), (2, 2), ((3, 3), (3, 3)))])
def test_conv_matches_flax(size, kernel, strides, padding):
    rng = np.random.RandomState(size)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((*kernel, 5, 6)).astype(np.float32)
    conv = Conv(5, 6, kernel, strides, padding)
    conv.load_state_dict({'kernel': torch.from_numpy(w)})
    got = conv(torch.from_numpy(x)).detach().numpy()
    want = _flax_conv(x, w, strides, padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_same_padding_is_asymmetric_at_stride_2():
    """A 3 x 3 stride-2 'SAME' conv on 8 x 8 pads (0, 1): its first output
    is the sum of x[0:3, 0:3], not of x[-1:2, -1:2] as with padding=1."""
    assert same_pads(8, 3, 2) == (0, 1) and same_pads(7, 3, 2) == (1, 1)
    x = np.arange(64, dtype=np.float32).reshape(1, 8, 8, 1)
    conv = Conv(1, 1, (3, 3), (2, 2))
    conv.load_state_dict({'kernel': torch.ones(3, 3, 1, 1)})
    got = conv(torch.from_numpy(x)).detach().numpy()
    assert got[0, 0, 0, 0] == x[0, 0:3, 0:3, 0].sum()


@pytest.mark.parametrize('size', [8, 7])
def test_pooling_matches_flax(size):
    x = np.random.RandomState(size).standard_normal(
        (2, size, size, 4)).astype(np.float32) - 3.0     # all-negative corners
    t = torch.from_numpy(x)
    np.testing.assert_allclose(
        max_pool(t, (3, 3), (2, 2), 'SAME').numpy(),
        np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                padding='SAME')), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        avg_pool(t, (2, 2), (2, 2), 'SAME').numpy(),
        np.asarray(fnn.avg_pool(jnp.asarray(x), (2, 2), strides=(2, 2),
                                padding='SAME')), atol=1e-6, rtol=0)


def test_conv_he_uniform_init():
    """flax's he_uniform: U(-l, l), l = sqrt(6 / (kh * kw * in))."""
    conv = Conv(16, 32, (3, 3))
    conv.init_params(torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (3 * 3 * 16))
    w = conv.kernel.detach().numpy()
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.9 * limit
    key_w = jax.nn.initializers.he_uniform()(jax.random.PRNGKey(0),
                                             (3, 3, 16, 32))
    assert np.abs(np.asarray(key_w)).max() <= limit
