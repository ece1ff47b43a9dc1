"""Torch port: the flash backward twin (``flash_bwd_plain``, which
``flash_bwd`` runs on CPU tensors) against ``sav_tpu.ops.flash_attention``'s
``_bwd`` in Pallas interpret mode, on its single-block branch (K2,
``_fused_bwd_kernel``) and forced multi-block (K3, ``_dq_kernel`` +
``_dkv_kernel``) with a ragged ``kv_len``; and the gradients of ``mha`` and
``mha_hybrid`` against ``jax.grad`` of the JAX package's.

float32. Tolerance: max |port - jax| <= 1e-5 * max(1, max |jax|), i.e.
atol 1e-5 on O(1) gradients - the same f32 math summed in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import flash_attention as jax_fa
from sav_tpu_torch.ops import attention, flash_attention

import torch_parity  # noqa: F401  (pins torch to one thread)

B, H, DH = 2, 2, 64
TOL = 1e-5


def assert_close(ours, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(ours), want, atol=TOL * scale,
                               rtol=0)


def _inputs(l, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.standard_normal((B, l, H * DH)) * 0.5).astype(np.float32)
    k, v, do = (rng.standard_normal((B, l, H * DH)).astype(np.float32)
                for _ in range(3))
    return q, k, v, do


def _pad(a, rows):
    return np.pad(a, ((0, 0), (0, rows - a.shape[1]), (0, 0)))


@functools.lru_cache(maxsize=None)
def _jax_bwd(l, kv_len, block_q, block_k, pad):
    """(out, lse, dq, dk, dv) of the JAX kernels on rows padded to ``pad``
    (the cotangent is zero on padded query rows, as ``_flash_bwd`` makes
    it), cut back to the true length."""
    q, k, v, do = (jnp.asarray(_pad(a, pad)) for a in _inputs(l))
    out, lse = jax_fa._fwd(q, k, v, heads=H, block_q=block_q,
                           block_k=block_k, kv_len=kv_len)
    bq, bk = jax_fa._bwd_blocks(pad, pad, block_q, block_k, H, DH)
    single = pad == bq == bk
    dq, dk, dv = jax_fa._bwd(q, k, v, out, lse, do, heads=H, block_q=block_q,
                             block_k=block_k, kv_len=kv_len)
    cut = lambda a: np.asarray(a)[:, :l]
    return (cut(out), np.asarray(lse)[:, :, :l, 0], cut(dq), cut(dk), cut(dv),
            single)


def _port_bwd(l, kv_len, out, lse):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(l))
    grads = flash_attention.flash_bwd(q, k, v, torch.from_numpy(out.copy()),
                                      torch.from_numpy(lse.copy()), do, H,
                                      kv_len)
    return [g.numpy() for g in grads]


@pytest.mark.parametrize('l,pad', [(17, 128), (65, 128), (129, 256)])
def test_twin_matches_single_block_kernel(l, pad):
    """K2's function: one q block and one kv block (129: a 1-row tail past
    two of K2's 64-row tiles)."""
    out, lse, *want, single = _jax_bwd(l, l, pad, pad, pad)
    assert single
    for ours, ref in zip(_port_bwd(l, l, out, lse), want):
        assert_close(ours, ref)


@pytest.mark.parametrize('kv_len', [200, 190])
def test_twin_matches_multi_block_kernels(kv_len):
    """K3's function: L = 200 padded to 256 in 64 x 128 blocks (4 q blocks,
    2 kv blocks), keys past ``kv_len`` masked."""
    out, lse, dq, dk, dv, single = _jax_bwd(200, kv_len, 64, 128, 256)
    assert not single
    ours = _port_bwd(200, kv_len, out, lse)
    assert_close(ours[0], dq)
    for o, ref in zip(ours[1:], (dk, dv)):
        assert_close(o[:, :kv_len], ref[:, :kv_len])
        assert not o[:, kv_len:].any()      # masked keys get no gradient


def test_padded_query_rows_add_nothing():
    """Extra query rows with a zero cotangent (what the kernels load past
    q_len) leave dk and dv unchanged, whatever their (finite) q, out and
    lse."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(65))
    out, lse = flash_attention.flash_fwd(q, k, v, H, 65)
    ref = flash_attention.flash_bwd(q, k, v, out, lse, do, H, 65)
    extra = lambda a, fill: torch.cat([a, torch.full_like(a[:, :15], fill)], 1)
    lse_pad = torch.cat([lse, torch.full_like(lse[:, :, :15], 3.0)], 2)
    dq, dk, dv = flash_attention.flash_bwd(
        extra(q, 0.3), k, v, extra(out, -5.0), lse_pad, extra(do, 0.0), H, 65)
    np.testing.assert_array_equal(dq[:, :65].numpy(), ref[0].numpy())
    np.testing.assert_allclose(dk.numpy(), ref[1].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(dv.numpy(), ref[2].numpy(), atol=1e-6, rtol=0)


def test_keys_past_kv_len_do_not_leak():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(80))
    out, lse = flash_attention.flash_fwd(q, k, v, H, 70)
    ref = flash_attention.flash_bwd(q, k[:, :70], v[:, :70], out, lse, do, H,
                                    70)
    k[:, 70:] = 1e4
    v[:, 70:] = float('nan')
    dq, dk, dv = flash_attention.flash_bwd(q, k, v, out, lse, do, H, 70)
    np.testing.assert_array_equal(dq.numpy(), ref[0].numpy())
    np.testing.assert_array_equal(dk[:, :70].numpy(), ref[1].numpy())
    np.testing.assert_array_equal(dv[:, :70].numpy(), ref[2].numpy())
    assert not dk[:, 70:].any() and not dv[:, 70:].any()


@pytest.mark.parametrize('l,want', [(1, True), (197, True), (208, True),
                                    (209, False), (577, False)])
def test_k2_threshold_is_shared_memory(l, want):
    """K2 holds a whole head in one block's 227 KB: up to 208 rows."""
    assert flash_attention.fused_bwd_fits(l, l) is want


@pytest.mark.parametrize('name', ['mha', 'mha_hybrid'])
def test_mha_gradients_match_jax(name):
    q, k, v, do = (a.reshape(B, 65, H, DH) for a in _inputs(65, seed=3))

    def jax_loss(q, k, v):
        return jnp.sum(getattr(jax_fa, name)(q, k, v) * do)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = getattr(flash_attention, name)(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for ours, ref in zip(grads, want):
        assert_close(ours.numpy(), ref)


@pytest.mark.parametrize('use_kernel', ['kernel', 'hybrid'])
def test_multi_head_attention_routes_differentiate(use_kernel):
    """The per-op route through the flash port has the gradients of the
    plain path (use_kernel=False)."""
    q, k, v, do = (torch.from_numpy(a.reshape(B, 65, H, DH))
                   for a in _inputs(65, seed=4))
    grads = {}
    for mode in (use_kernel, False):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attention.multi_head_attention(*ins, use_kernel=mode)
        grads[mode] = torch.autograd.grad(out, ins, do)
    for ours, ref in zip(grads[use_kernel], grads[False]):
        assert_close(ours.numpy(), ref.numpy())


def test_wrapper_raises_off_cpu_and_cuda():
    t = torch.empty(1, 64, H * DH, device='meta')
    lse = torch.empty(1, H, 64, device='meta')
    with pytest.raises(ValueError, match='cuda or cpu'):
        flash_attention.flash_bwd(t, t, t, t, lse, t, H, 64)
