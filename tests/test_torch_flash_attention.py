"""Torch port: the K4 twin (``flash_fwd_plain``, which ``flash_fwd`` runs
on CPU tensors) against ``sav_tpu.ops.flash_attention._fwd`` in Pallas
interpret mode, out and lse, single- and multi-kv-block; and the
functional attention core against ``sav_tpu.ops.attention``. float32,
atol 1e-5 (same math, another summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import attention as jax_attention
from sav_tpu.ops import flash_attention as jax_fa
from sav_tpu_torch.ops import attention, flash_attention

import torch_parity  # noqa: F401  (pins torch to one thread)

B, H, DH = 2, 2, 64
ATOL = 1e-5


def _qkv(l, seed=0, kv_l=None):
    rng = np.random.RandomState(seed)
    kv_l = kv_l or l
    q = (rng.standard_normal((B, l, H * DH)) * 0.5).astype(np.float32)
    k = rng.standard_normal((B, kv_l, H * DH)).astype(np.float32)
    v = rng.standard_normal((B, kv_l, H * DH)).astype(np.float32)
    return q, k, v


def _pad(a, rows):
    return np.pad(a, ((0, 0), (0, rows - a.shape[1]), (0, 0)))


@pytest.mark.parametrize('l,block_q,block_k', [
    (65, 80, 128),          # one q block, one kv block
    (197, 208, 256),        # the ViT @224 single block
    (200, 208, 128),        # two kv blocks: online-softmax carry, key tail
    (200, 112, 128),        # two q blocks and two kv blocks
    (129, 144, 256),        # a 1-row tail past two 64-row tiles (K4's)
])
def test_flash_twin_matches_pallas_fwd(l, block_q, block_k):
    q, k, v = _qkv(l)
    q_pad = -(-l // block_q) * block_q
    kv_pad = -(-l // block_k) * block_k
    out, lse = jax_fa._fwd(jnp.asarray(_pad(q, q_pad)),
                           jnp.asarray(_pad(k, kv_pad)),
                           jnp.asarray(_pad(v, kv_pad)), heads=H,
                           block_q=block_q, block_k=block_k, kv_len=l)
    ours, ours_lse = flash_attention.flash_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H, l)
    assert ours.shape == (B, l, H * DH) and ours_lse.shape == (B, H, l)
    np.testing.assert_allclose(ours.numpy(), np.asarray(out)[:, :l],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours_lse.numpy(),
                               np.asarray(lse)[:, :, :l, 0], atol=ATOL, rtol=0)


def test_flash_twin_ignores_keys_past_kv_len():
    q, k, v = _qkv(65, kv_l=80)
    full, full_lse = flash_attention.flash_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k[:, :70]),
        torch.from_numpy(v[:, :70]), H, 70)
    k[:, 70:] = 1e4           # garbage past kv_len must not leak in
    v[:, 70:] = np.nan
    cut, cut_lse = flash_attention.flash_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H, 70)
    np.testing.assert_array_equal(cut.numpy(), full.numpy())
    np.testing.assert_array_equal(cut_lse.numpy(), full_lse.numpy())


@pytest.mark.parametrize('q_len,kv_len', [(65, 65), (64, 100)])
def test_mha_matches_jax_mha(q_len, kv_len):
    q, k, v = _qkv(q_len, kv_l=kv_len, seed=1)
    shape = lambda a: a.reshape(B, a.shape[1], H, DH)
    expect = jax_fa.mha(jnp.asarray(shape(q)), jnp.asarray(shape(k)),
                        jnp.asarray(shape(v)))
    ours = flash_attention.mha(torch.from_numpy(shape(q)),
                               torch.from_numpy(shape(k)),
                               torch.from_numpy(shape(v)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(expect), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize('q_len', [1, 17])
@pytest.mark.parametrize('talking_heads', [False, True])
def test_multi_head_attention_matches_jax(q_len, talking_heads):
    rng = np.random.RandomState(2)
    q = rng.standard_normal((B, q_len, H, DH)).astype(np.float32)
    k = rng.standard_normal((B, 19, H, DH)).astype(np.float32)
    v = rng.standard_normal((B, 19, H, DH)).astype(np.float32)
    mix = {}
    if talking_heads:
        mix = dict(pre_softmax_transform=rng.standard_normal((H, H)),
                   post_softmax_transform=rng.standard_normal((H, H)))
        mix = {n: m.astype(np.float32) for n, m in mix.items()}
    expect = jax_attention.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_kernel=False,
        **{n: jnp.asarray(m) for n, m in mix.items()})
    ours = attention.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        use_kernel=False, **{n: torch.from_numpy(m) for n, m in mix.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(expect), atol=ATOL,
                               rtol=0)


def test_auto_dispatch_stays_plain_off_the_card():
    q = torch.zeros(1, 128, H, DH)
    assert attention.dispatch_mode(q, q) is None


@pytest.mark.parametrize('kwargs,want', [
    ({}, True), ({'bias': 0}, False), ({'pre_softmax_transform': 0}, False)])
def test_shape_supported(kwargs, want):
    q = torch.zeros(1, 128, H, DH)
    assert flash_attention.shape_supported(q, q, **kwargs) is want


def test_short_queries_and_other_head_widths_are_unsupported():
    assert not flash_attention.shape_supported(torch.zeros(1, 32, H, DH),
                                               torch.zeros(1, 32, H, DH))
    assert not flash_attention.shape_supported(torch.zeros(1, 128, H, 32),
                                               torch.zeros(1, 128, H, 32))


def test_kernel_wrapper_raises_off_cpu_and_cuda():
    t = torch.empty(1, 64, H * DH, device='meta')
    with pytest.raises(ValueError, match='cuda or cpu'):
        flash_attention.flash_fwd(t, t, t, H, 64)
