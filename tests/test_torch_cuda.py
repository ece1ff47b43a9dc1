"""Torch port on the card: each hand-written kernel against its plain twin
at small shapes, bf16, plus the wrappers' refusals. A CUDA kernel has no
CPU mode, so without a card every test here skips (marker ``cuda``).

Run on a machine with the card:  python -m pytest tests/test_torch_cuda.py -q
Tolerances as in chip_smoke.py: outputs 2e-2 of max |twin| (K1: of the
sublayer's own contribution), lse 1e-3 absolute.
"""

import math

import numpy as np
import pytest
import torch

from sav_tpu_torch.ops import fused_layer
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
