"""Torch port on the card: each hand-written kernel against its plain twin
at small shapes, bf16, plus the wrappers' refusals and the sublayer's
gradients on the kernels against the plain core. A CUDA kernel has no CPU
mode, so without a card every test here skips (marker ``cuda``).

Run on a machine with the card:  python -m pytest tests/test_torch_cuda.py -q
Tolerances as in chip_smoke.py: outputs and gradients 2e-2 of max |twin|
(K1: of the sublayer's own contribution), lse 1e-3 absolute (K1's against
the logsumexp of its own q and k).
"""

import math

import numpy as np
import pytest
import torch

from sav_tpu_torch.ops import flash_attention, fused_layer
from sav_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the CUDA kernels have no CPU mode')
    return torch.device('cuda')


def _bf16(rng, shape, std, device):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(
        np.float32)).to(device).bfloat16()


@pytest.mark.parametrize('seq', [1, 63, 197, 200])
def test_flash_fwd_matches_twin(card, seq):
    rng = np.random.RandomState(seq)
    q, k, v = (_bf16(rng, (3, seq, 4 * 64), s, card) for s in (0.5, 1, 1))
    out, lse = flash_fwd(q, k, v, 4, seq)
    p_out, p_lse = flash_fwd_plain(q, k, v, 4, seq)
    err = (out.float() - p_out.float()).abs().max() / p_out.float().abs().max()
    assert err <= 2e-2
    assert (lse - p_lse).abs().max() <= 1e-3


def test_flash_fwd_masks_keys_past_kv_len(card):
    rng = np.random.RandomState(0)
    q, k, v = (_bf16(rng, (2, 130, 128), 1, card) for _ in range(3))
    k[:, 100:] = 1e4
    out, lse = flash_fwd(q, k, v, 2, 100)
    p_out, p_lse = flash_fwd_plain(q, k[:, :100], v[:, :100], 2, 100)
    assert (out.float() - p_out.float()).abs().max() <= 2e-2 * p_out.float().abs().max()
    assert (lse - p_lse).abs().max() <= 1e-3


@pytest.mark.parametrize('seq', [5, 65, 197])
def test_fused_attention_matches_twin(card, seq):
    rng = np.random.RandomState(seq)
    dim, heads = 256, 4
    x = _bf16(rng, (2, seq, dim), 1, card)
    scale = (1 + _bf16(rng, (dim,), 0.1, card)).float()
    bias = _bf16(rng, (dim,), 0.1, card).float()
    wq, wk, wv = (_bf16(rng, (dim, dim), s / math.sqrt(dim), card)
                  for s in (4, 1, 1))
    wo = _bf16(rng, (dim, dim), 1 / math.sqrt(dim), card)
    args = (x, scale, bias, wq, wk, wv, wo, heads)
    out = fused_layer.fused_attention_fwd(*args)
    plain = fused_layer.fused_attention_fwd_plain(*args, fused_layer.LN_EPS)
    delta = (plain.float() - x.float()).abs().max()
    assert (out.float() - plain.float()).abs().max() <= 2e-2 * delta


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.zeros(1, 64, 128, device=card)
    with pytest.raises(ValueError, match='bfloat16'):
        flash_fwd(x, x, x, 2, 64)
    xb = x.bfloat16()
    with pytest.raises(ValueError, match='head_dim'):
        flash_fwd(xb, xb, xb, 4, 64)
    w = torch.zeros(128, 128, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match='forward-only'):
        fused_layer.fused_attention_fwd(xb, w[0], w[0], w, w, w, w, 2)
    wb = torch.zeros(96, 96, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='multiples of 128'):
        fused_layer.fused_attention_fwd(
            torch.zeros(1, 8, 96, device=card, dtype=torch.bfloat16),
            wb[0].float(), wb[0].float(), wb, wb, wb, wb, 1)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@pytest.mark.parametrize('seq,kv_len,route', [
    (17, 17, 'auto'), (197, 197, 'auto'), (200, 150, 'auto'),
    (65, 65, 'split'), (197, 197, 'split'), (577, 500, 'split')])
def test_flash_bwd_matches_twin(card, seq, kv_len, route):
    rng = np.random.RandomState(seq)
    q, k, v, do = (_bf16(rng, (2, seq, 4 * 64), s, card) for s in (0.5, 1, 1, 1))
    out, lse = flash_fwd(q, k, v, 4, kv_len)
    bwd = {'auto': flash_attention.flash_bwd,
           'split': flash_attention.bwd_split}[route]
    grads = bwd(q, k, v, out, lse, do, 4, kv_len)
    twin = flash_attention.flash_bwd_plain(q, k, v, out, lse, do, 4, kv_len)
    for g, t in zip(grads, twin):
        assert _rel(g, t) <= 2e-2
    assert not grads[1][:, kv_len:].any() and not grads[2][:, kv_len:].any()


def test_flash_bwd_counts_its_kernels(card):
    from sav_tpu_torch import _build
    rng = np.random.RandomState(0)
    for seq, want in ((197, {'flash_bwd_fused': 1}),
                      (300, {'flash_bwd_dq': 1, 'flash_bwd_dkv': 1})):
        q, k, v, do = (_bf16(rng, (1, seq, 128), 1, card) for _ in range(4))
        out, lse = flash_fwd(q, k, v, 2, seq)
        _build.reset_launches()
        flash_attention.flash_bwd(q, k, v, out, lse, do, 2, seq)
        assert _build.launches == want


@pytest.mark.parametrize('seq', [5, 197, 577])
def test_fused_attention_training_variant(card, seq):
    rng = np.random.RandomState(seq)
    dim, heads = 256, 4
    x = _bf16(rng, (2, seq, dim), 1, card)
    scale = (1 + _bf16(rng, (dim,), 0.1, card)).float()
    bias = _bf16(rng, (dim,), 0.1, card).float()
    wq, wk, wv, wo = (_bf16(rng, (dim, dim), s / math.sqrt(dim), card)
                      for s in (4, 1, 1, 1))
    args = (x, scale, bias, wq, wk, wv, wo, heads)
    out, (q, k, v, attn, lse) = fused_layer.fused_attention_fwd(
        *args, save_residuals=True)
    plain, res = fused_layer.fused_attention_fwd_plain(
        *args, fused_layer.LN_EPS, save_residuals=True)
    delta = (plain.float() - x.float()).abs().max()
    assert (out.float() - plain.float()).abs().max() <= 2e-2 * delta
    for ours, twin in zip((q, k, v, attn), res[:4]):
        assert _rel(ours, twin) <= 2e-2
    split = lambda a: a.float().reshape(2, seq, heads, 64)
    own = torch.logsumexp(torch.einsum('bqhd,bkhd->bhqk', split(q), split(k)),
                          dim=-1)
    assert (lse - own).abs().max() <= 1e-3


@pytest.mark.parametrize('core,seq', [('fused', 197), ('flash', 197),
                                      ('fused', 300)])
def test_sublayer_gradients_match_plain_core(card, core, seq):
    rng = np.random.RandomState(1)
    dim, heads = 256, 4
    ins = [_bf16(rng, (2, seq, dim), 1, card),
           (1 + _bf16(rng, (dim,), 0.1, card)).float(),
           _bf16(rng, (dim,), 0.1, card).float()]
    ins += [_bf16(rng, (dim, heads, 64), 1 / math.sqrt(dim), card).float()
            for _ in range(3)]
    ins.append(_bf16(rng, (heads, 64, dim), 1 / math.sqrt(dim), card).float())
    g = _bf16(rng, (2, seq, dim), 1, card)
    grads = {}
    for c in (core, 'xla'):
        ts = [t.clone().requires_grad_() for t in ins]
        out = fused_layer.attention_sublayer(*ts, heads, c)
        grads[c] = torch.autograd.grad(out, ts, g)
    for ours, plain in zip(grads[core], grads['xla']):
        assert _rel(ours, plain) <= 2e-2
