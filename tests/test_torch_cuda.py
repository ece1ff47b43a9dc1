"""Torch port on the card: each hand-written kernel against its plain twin
at small shapes, bf16, plus the wrappers' refusals and the sublayer's
gradients on the kernels against the plain core. A CUDA kernel has no CPU
mode, so without a card every test here skips (marker ``cuda``).

Run on a machine with the card:  python -m pytest tests/test_torch_cuda.py -q
Tolerances as in chip_smoke.py: outputs and gradients 2e-2 of max |twin|
(K1: of the sublayer's own contribution), the TH backward's dM_pre and
dM_post 1e-4 of max, the weight, bias and LN-parameter gradients of K8b and
K16 2e-3 of max (WGRAD_TOL), lse 1e-3 absolute (K1's against the
logsumexp of its own q and k). K7 (the TNT inner layer): out - x and dx at
2e-2 of max, its 12 parameter gradients at K7_WGRAD_TOL; K1 without the
residual over max |twin| (there is no x to subtract).
"""

import math

import numpy as np
import pytest
import torch

from sav_tpu_torch.ops import flash_attention, fused_layer, th_attention
from sav_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain

pytestmark = pytest.mark.cuda

# K8b's and K16's weight gradients: fixed-order sums of per-block partials,
# as close to the twin's as chip_smoke.WGRAD_TOL says; dx/dy stay at 2e-2
WGRAD_TOL = 2e-3


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


@pytest.mark.parametrize('seq,kv_len,route,heads,q_len', [
    (17, 17, 'auto', 4, None), (197, 197, 'auto', 4, None),
    (200, 150, 'auto', 4, None), (65, 65, 'split', 4, None),
    (197, 197, 'split', 4, None), (577, 500, 'split', 4, None),
    # K3's tile edges: 577 = 4 x 128 + 65 = 9 x 64 + 1, a 1-row last
    # 128-row tile at 129, queries != keys (CvT's cross-length attention),
    # H = 16 at d = 64; cvt-13's stage 1 (3136 queries over 784 keys in one
    # head) and stage 3 (the padded 225 over 64 keys, 6 heads), both K3's
    (577, 577, 'split', 4, None), (129, 129, 'split', 4, None),
    (100, 90, 'split', 4, 300), (577, 577, 'split', 16, None),
    (784, 784, 'auto', 1, 3136), (64, 64, 'auto', 6, 225)])
def test_flash_bwd_matches_twin(card, seq, kv_len, route, heads, q_len):
    """seq key rows (the first kv_len unmasked) and q_len query rows
    (default seq)."""
    rng = np.random.RandomState(seq)
    q_len = q_len or seq
    hd = heads * 64
    q = _bf16(rng, (2, q_len, hd), 0.5, card)
    k, v = (_bf16(rng, (2, seq, hd), 1, card) for _ in range(2))
    do = _bf16(rng, (2, q_len, hd), 1, card)
    out, lse = flash_fwd(q, k, v, heads, kv_len)
    bwd = {'auto': flash_attention.flash_bwd,
           'split': flash_attention.bwd_split}[route]
    grads = bwd(q, k, v, out, lse, do, heads, kv_len)
    twin = flash_attention.flash_bwd_plain(q, k, v, out, lse, do, heads, kv_len)
    for g, t in zip(grads, twin):
        assert g.shape == t.shape
        assert _rel(g, t) <= 2e-2
    assert not grads[1][:, kv_len:].any() and not grads[2][:, kv_len:].any()


@pytest.mark.parametrize('q_len,seq,kv_len', [(577, 577, 577), (300, 100, 90)])
def test_flash_bwd_split_repeats_bitwise(card, q_len, seq, kv_len):
    """K3 owns each dq row in one work tile and each dk/dv row in one (no
    float atomics): two calls give bit-identical gradients."""
    rng = np.random.RandomState(q_len)
    q, do = (_bf16(rng, (3, q_len, 12 * 64), s, card) for s in (0.5, 1))
    k, v = (_bf16(rng, (3, seq, 12 * 64), 1, card) for _ in range(2))
    out, lse = flash_fwd(q, k, v, 12, kv_len)
    first = flash_attention.bwd_split(q, k, v, out, lse, do, 12, kv_len)
    again = flash_attention.bwd_split(q, k, v, out, lse, do, 12, kv_len)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize('b,q_len,kv_rows,kv_len', [
    (3, 197, 197, 197), (3, 200, 200, 190), (2, 577, 577, 577),
    (3, 129, 129, 129), (2, 300, 100, 90), (1, 3136, 784, 784)])
def test_flash_fwd_writes_every_row_and_no_more(card, b, q_len, kv_rows,
                                                kv_len):
    """K4 through its C entry into NaN-filled out and lse one image longer
    than the call: every row of the call's images written and as the
    twin's, none past them; masked keys (1e4 logits, NaN values) do not
    leak in."""
    rng = np.random.RandomState(q_len)
    q = _bf16(rng, (b, q_len, 128), 0.5, card)
    k, v = (_bf16(rng, (b, kv_rows, 128), 1, card) for _ in range(2))
    k[:, kv_len:] = 1e4
    v[:, kv_len:] = float('nan')
    out = torch.full((b + 1, q_len, 128), float('nan'), device=card,
                     dtype=torch.bfloat16)
    lse = torch.full((b + 1, 2, q_len), float('nan'), device=card)
    err = flash_attention._lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, q_len, kv_rows, kv_len, 2,
        flash_attention.stream_of(card))
    torch.cuda.synchronize()
    assert err == 0
    p_out, p_lse = flash_fwd_plain(q, k, v, 2, kv_len)
    assert _rel(out[:b], p_out) <= 2e-2
    assert (lse[:b] - p_lse).abs().max() <= 1e-3
    assert bool(torch.isnan(out[b]).all() and torch.isnan(lse[b]).all())


@pytest.mark.parametrize('q_len,seq,kv_len', [(197, 197, 197), (200, 200, 190),
                                              (150, 100, 90), (1, 1, 1)])
def test_flash_bwd_fused_repeats_bitwise(card, q_len, seq, kv_len):
    """K2 owns each dq row in one warpgroup's phase B and each dk/dv row in
    one key tile (no atomics): two calls give bit-identical gradients."""
    rng = np.random.RandomState(q_len)
    q, do = (_bf16(rng, (3, q_len, 12 * 64), s, card) for s in (0.5, 1))
    k, v = (_bf16(rng, (3, seq, 12 * 64), 1, card) for _ in range(2))
    out, lse = flash_fwd(q, k, v, 12, kv_len)
    first = flash_attention.bwd_fused(q, k, v, out, lse, do, 12, kv_len)
    again = flash_attention.bwd_fused(q, k, v, out, lse, do, 12, kv_len)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    twin = flash_attention.flash_bwd_plain(q, k, v, out, lse, do, 12, kv_len)
    for g, t in zip(first, twin):           # L = 1: dq = dk = 0 exactly
        scale = max(float(t.float().abs().max()), 1e-3)
        assert float((g.float() - t.float()).abs().max()) <= 2e-2 * scale


def test_flash_plans_match_the_kernels(card):
    """fwd_plan's and fused_bwd_plan's shared memory is the kernels' own
    (their structs plus the alignment slack), as the CPU tests read it;
    K2 refuses a head past 208 rows on the card as well."""
    from sav_tpu_torch import _build
    fwd = _build.library('flash_fwd').sav_flash_fwd_smem()
    assert fwd == flash_attention.fwd_plan(1, 577, 577, 577, 12)['smem']
    k2 = _build.library('flash_bwd').sav_flash_bwd_fused_smem
    assert k2(197, 197) == flash_attention.fused_bwd_plan(
        1, 197, 197, 197, 12)['smem']
    assert k2(209, 209) == 0
    x = torch.zeros(1, 209, 128, device=card, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 209, device=card)
    with pytest.raises(ValueError, match='208'):
        flash_attention.bwd_fused(x, x, x, x, lse, x, 2, 209)


def test_split_plan_matches_the_kernel(card):
    """split_plan's shared memory is the kernels' own (their structs plus
    the alignment slack), as the CPU tests read it."""
    from sav_tpu_torch import _build
    lib = _build.library('flash_bwd_split')
    plan = flash_attention.split_plan(1, 577, 577, 577, 12)
    assert lib.sav_flash_bwd_split_smem(0) == plan['dq']['smem']
    assert lib.sav_flash_bwd_split_smem(1) == plan['dkv']['smem']


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


# the projection GEMM (csrc/proj_sm90.cuh) at every width its plan tiles
# differently (D = 384: 192-wide tiles; 640: 128; 768: 256), at ragged M
# (3 x 197 and 5 x 131 rows), inference and training, with and without +x
@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('dim,b,seq', [(384, 3, 197), (640, 5, 131),
                                       (768, 3, 197), (192, 3, 197)])
def test_projection_gemm_widths(card, dim, b, seq, residual, train):
    rng = np.random.RandomState(dim + seq + 2 * residual + train)
    heads = dim // 64
    x = _bf16(rng, (b, seq, dim), 1, card)
    scale = (1 + _bf16(rng, (dim,), 0.1, card)).float()
    bias = _bf16(rng, (dim,), 0.1, card).float()
    wq, wk, wv, wo = (_bf16(rng, (dim, dim), s / math.sqrt(dim), card)
                      for s in (4, 1, 1, 1))
    args = (x, scale, bias, wq, wk, wv, wo, heads, fused_layer.LN_EPS, train)
    out = fused_layer.fused_attention_fwd(*args, residual=residual)
    plain = fused_layer.fused_attention_fwd_plain(*args, residual=residual)
    if train:
        (out, res), (plain, p_res) = out, plain
        for ours, twin in zip(res[:4], p_res[:4]):
            assert _rel(ours, twin) <= 2e-2
    contrib = (plain.float() - (x.float() if residual else 0)).abs().max()
    assert (out.float() - plain.float()).abs().max() <= 2e-2 * contrib


def test_proj_plan_matches_the_kernel(card):
    """proj_plan mirrors the GEMM's plan_bn and Plan (sav_proj_plan) at the
    paths' rows and widths (cait_xs's 288 and 96 with a ragged last tile)
    and at ragged and tiny M."""
    import ctypes

    from sav_tpu_torch import _build
    fn = _build.library('fused_attention').sav_proj_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * 3)()
    for m in (1, 129, 591, 6272, 6304, 12608, 25088, 37824):
        for n, parts in ((384, 3), (384, 1), (640, 3), (640, 1), (768, 3),
                         (768, 1), (256, 3), (192, 3), (192, 1), (576, 3),
                         (288, 3), (288, 1), (96, 3), (96, 1), (320, 1)):
            for sms in (132, 114):
                fn(m, n, parts, sms, ctypes.addressof(out))
                plan = fused_layer.proj_plan(m, n, parts, 128, sms)
                assert (out[0], out[1], out[2]) == (
                    plan['bn'], plan['smem'], plan['units']), (m, n, parts)


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


# ---- talking-heads kernels (K5a, K5b, K6a, K6b; csrc/th_attention.cu)

def _th_core_case(rng, b, seq, heads, card):
    """q (pre-scaled, a peaked softmax), k, v, do as [B, L, H*48] bf16 and
    two mixes near the identity."""
    q, k, v, do = (_bf16(rng, (b, seq, heads * 48), s, card)
                   for s in (0.4, 1, 1, 1))
    m = [(torch.eye(heads) + 0.3 * torch.from_numpy(rng.standard_normal(
        (heads, heads)).astype(np.float32))).to(card) for _ in range(2)]
    return q, k, v, do, m


@pytest.mark.parametrize('seq,heads', [(1, 8), (37, 4), (196, 8), (200, 8),
                                       (576, 8), (37, 16), (197, 16), (1, 6),
                                       (37, 6), (197, 6)])
def test_th_core_fwd_matches_twin(card, seq, heads):
    rng = np.random.RandomState(seq)
    q, k, v, _, m = _th_core_case(rng, 2, seq, heads, card)
    attn, lse = th_attention.th_core_fwd(q, k, v, *m, heads)
    p_attn, p_lse = th_attention.th_core_fwd_plain(q, k, v, *m, heads)
    assert _rel(attn, p_attn) <= 2e-2
    assert (lse - p_lse).abs().max() <= 1e-3


@pytest.mark.parametrize('seq,residual', [(5, False), (196, False),
                                          (224, True), (577, False)])
def test_th_attention_fwd_matches_twin(card, seq, residual):
    rng = np.random.RandomState(seq)
    dim, heads = 384, 8
    x = _bf16(rng, (2, seq, dim), 1, card)
    scale = (1 + _bf16(rng, (dim,), 0.1, card)).float()
    bias = _bf16(rng, (dim,), 0.1, card).float()
    ws = [_bf16(rng, (dim, dim), s / math.sqrt(dim), card) for s in (4, 1, 1, 1)]
    m = _th_mixes(heads, seq, card)
    args = (x, scale, bias, *ws, *m, heads, th_attention.LN_EPS, residual)
    out = th_attention.th_attention_fwd(*args)
    out_t, (q, k, v, attn, lse) = th_attention.th_attention_fwd(
        *args, save_residuals=True)
    plain, res = th_attention.th_attention_fwd_plain(*args, save_residuals=True)
    contrib = (plain.float() - (x.float() if residual else 0)).abs().max()
    assert (out.float() - plain.float()).abs().max() <= 2e-2 * contrib
    assert torch.equal(out, out_t)
    for ours, twin in zip((q, k, v), res[:3]):
        assert _rel(ours, twin) <= 2e-2
    own_attn, own_lse = th_attention.th_core_fwd_plain(q, k, v, *m, heads)
    assert _rel(attn, own_attn) <= 2e-2
    assert (lse - own_lse).abs().max() <= 1e-3


@pytest.mark.parametrize('entry', ['th_attention_bwd', 'th_core_bwd'])
@pytest.mark.parametrize('seq,heads', [(37, 4), (196, 8), (577, 8), (37, 16),
                                       (197, 16), (37, 6), (197, 6)])
def test_th_bwd_matches_twin(card, entry, seq, heads):
    rng = np.random.RandomState(seq + heads)
    q, k, v, do, m = _th_core_case(rng, 2, seq, heads, card)
    _, lse = th_attention.th_core_fwd_plain(q, k, v, *m, heads)
    grads = getattr(th_attention, entry)(q, k, v, do, lse, *m, heads)
    twin = th_attention.th_core_bwd_plain(q, k, v, do, lse, *m, heads)
    for g, t in zip(grads[:3], twin[:3]):
        assert g.shape == t.shape and _rel(g, t) <= 2e-2
    # dM_pre, dM_post: the same f32 products summed in another order; one
    # dropped or mis-masked per-warp partial of the B x ceil(L / 64) x 4 (or
    # x 8) moves them by far more (~1/(that count) of max)
    for g, t in zip(grads[3:], twin[3:]):
        assert g.shape == t.shape and _rel(g, t) <= 1e-4


@pytest.mark.parametrize('entry', ['th_attention_bwd', 'th_core_bwd'])
@pytest.mark.parametrize('seq,heads', [(197, 8), (577, 4), (197, 16), (197, 6)])
def test_th_bwd_repeats_bitwise(card, entry, seq, heads):
    """No float atomics: dq, dk, dv and the dM sums repeat bit for bit."""
    rng = np.random.RandomState(seq)
    q, k, v, do, m = _th_core_case(rng, 3, seq, heads, card)
    _, lse = th_attention.th_core_fwd_plain(q, k, v, *m, heads)
    fn = getattr(th_attention, entry)
    first = fn(q, k, v, do, lse, *m, heads)
    second = fn(q, k, v, do, lse, *m, heads)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_th_bwd_survives_back_to_back_calls(card):
    """Many calls queued without a synchronize between them (CaiT-S/24's
    K5b shape; a deadlock in the kernels' barrier protocol shows as a
    launch failure here) give the first call's result every time."""
    rng = np.random.RandomState(11)
    q, k, v, do, m = _th_core_case(rng, 128, 196, 8, card)
    _, lse = th_attention.th_core_fwd_plain(q, k, v, *m, 8)
    first = th_attention.th_attention_bwd(q, k, v, do, lse, *m, 8)
    for _ in range(20):
        outs = [th_attention.th_attention_bwd(q, k, v, do, lse, *m, 8)
                for _ in range(10)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for g in outs for a, b in zip(g, first))


@pytest.mark.parametrize('b', [32, 48])
@pytest.mark.parametrize('heads', [4, 6, 8, 16])
@pytest.mark.parametrize('seq', [196, 197, 576, 577])
def test_th_core_fwd_at_cait_shapes(card, seq, heads, b):
    """K6a at CaiT's lengths (@224 and @384, each with a one-row tail) and
    batches, with lse, against the twin at chip_smoke.py's tolerances
    (OUT_TOL, LSE_TOL); two calls identical."""
    rng = np.random.RandomState(seq + heads + b)
    q, k, v, _, m = _th_core_case(rng, b, seq, heads, card)
    attn, lse = th_attention.th_core_fwd(q, k, v, *m, heads)
    again = th_attention.th_core_fwd(q, k, v, *m, heads)
    p_attn, p_lse = th_attention.th_core_fwd_plain(q, k, v, *m, heads)
    assert _rel(attn, p_attn) <= 2e-2
    assert (lse - p_lse).abs().max() <= 1e-3
    assert torch.equal(attn, again[0]) and torch.equal(lse, again[1])


def test_th_core_fwd_survives_back_to_back_calls(card):
    """200 K6a calls queued without a synchronize (CaiT-S/24 @384 bs48)
    give the first call's result every time."""
    rng = np.random.RandomState(12)
    q, k, v, _, m = _th_core_case(rng, 48, 576, 8, card)
    first = th_attention.th_core_fwd(q, k, v, *m, 8)
    for _ in range(20):
        outs = [th_attention.th_core_fwd(q, k, v, *m, 8) for _ in range(10)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for g in outs for a, b in zip(g, first))


def _th_core_fwd_smem(heads):
    """The built library's shared memory of the K5a/K6a core."""
    import ctypes
    from sav_tpu_torch import _build
    fn = _build.library('th_attention').sav_th_core_fwd_smem
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(heads)


def test_th_fwd_plan_matches_the_kernel(card):
    """th_fwd_plan mirrors K6a's shared memory (sav_th_core_fwd_smem); an
    unbuilt head count reads 0."""
    for heads in th_attention.KERNEL_HEADS:
        assert _th_core_fwd_smem(heads) == th_attention.th_fwd_plan(
            577, heads)['smem']
    assert _th_core_fwd_smem(12) == 0 and _th_core_fwd_smem(16) == 214096
    assert _th_core_fwd_smem(6) == 156784


def test_th_bwd_plan_matches_the_kernel(card):
    """th_bwd_plan mirrors the kernels' shared memory (sav_th_bwd_smem);
    at H = 16, th_bwd_plan and th_bwd_staged_plan mirror the staged
    backward's (sav_th_bwd_staged_plan: row pitch, workspace regions,
    shared memory and blocks of its launches)."""
    import ctypes
    from sav_tpu_torch import _build
    lib = _build.library('th_bwd')
    fn = lib.sav_th_bwd_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    for heads in (4, 6, 8):
        plan = th_attention.th_bwd_plan(577, heads)['smem']
        assert [fn(heads, mode) for mode in range(3)] == [
            plan['dq'], plan['dk'], plan['dv']]
    assert [fn(6, mode) for mode in range(3)] == [178272, 177504, 177504]
    assert [fn(16, mode) for mode in range(3)] == [0, 0, 0]
    assert [fn(12, mode) for mode in range(3)] == [0, 0, 0]
    staged = lib.sav_th_bwd_staged_plan
    staged.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for b, l in ((1, 1), (2, 197), (16, 196), (1, 577)):
        out = (ctypes.c_longlong * 12)()
        assert staged(b, l, 16, out) == 0
        p = th_attention.th_bwd_staged_plan(b, l)
        smem = p['smem']
        assert list(out) == (
            [p['lp']] + [p['regions'][r][0] for r in ('s', 'da', 'ds', 'pt')]
            + [p['workspace'], smem['products'], smem['mix'], smem['dq'],
               p['blocks']['products'], p['blocks']['mix'],
               p['blocks']['gemm']])
    assert staged(2, 197, 8, (ctypes.c_longlong * 12)()) != 0


def test_th_kernels_write_no_row_past_the_length(card):
    """Outputs hold exactly L rows (nothing is padded); rows the kernels
    compute past L in their last tile are never stored: a buffer of 64 rows
    keeps its NaN sentinel past L = 37."""
    from sav_tpu_torch.ops.flash_attention import stream_of
    rng = np.random.RandomState(0)
    seq, heads = 37, 8
    q, k, v, do, m = _th_core_case(rng, 1, seq, heads, card)
    big = lambda: torch.full((1, 64, heads * 48), float('nan'), device=card,
                             dtype=torch.bfloat16)
    attn, dq, dk, dv = big(), big(), big(), big()
    lse = torch.empty(1, heads, seq, device=card)
    delta = torch.empty_like(lse)
    dm = th_attention._dm_partials(1, seq, heads, card)
    mix = torch.stack((m[0], m[0] * th_attention.LOG2E, m[1])).contiguous()
    fwd = th_attention._fn('sav_th_core_fwd', 6, 3)
    assert fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), mix.data_ptr(),
               attn.data_ptr(), lse.data_ptr(), 1, seq, heads,
               stream_of(card)) == 0
    bwd = th_attention._fn('sav_th_core_bwd', 11, 3, lib='th_bwd')
    assert bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               lse.data_ptr(), mix.data_ptr(), delta.data_ptr(),
               dm.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1,
               seq, heads, stream_of(card)) == 0
    torch.cuda.synchronize()
    for t in (attn, dq, dk, dv):
        assert torch.isfinite(t[:, :seq]).all()
        assert torch.isnan(t[:, seq:]).all()


TH_GRADS = ('x', 'scale', 'bias', 'wq', 'wk', 'wv', 'wo', 'm_pre', 'm_post')
# The draws of the head mixes (seeds of _th_mixes) that put a gradient of
# the fused route more than 2e-2 from the plain core's, found by
# test_th_sublayer_gradients_over_seeds over seeds 0-63 on an H100: dx on
# seeds 2, 12, 17 and 26 (0.0208-0.0238), dscale on 57 (0.0211). On each,
# the plain core is as far from the f32 reference (0.0170-0.0289) as the
# kernels are from it: the bf16 floor of the sublayer boundary, not K5b.
# So each gradient is held to 2e-2 or 3x the plain core's distance from
# f32, whichever is larger (_th_tol, the rule of chip_smoke.py).
TH_SEEDS = (2, 12, 17, 26, 57)
TH_SWEEP = range(64)


def _th_mixes(heads, seed, card):
    """The two [H, H] head mixes, I + 0.3 N(0, 1), from a generator seeded
    with ``seed``: each run checks the same draws."""
    gen = torch.Generator().manual_seed(seed)
    return [(torch.eye(heads) + 0.3 * torch.randn(heads, heads, generator=gen))
            .to(card) for _ in range(2)]


def _th_sublayer_errors(card, route, seq, seed):
    """[(gradient, kernel route vs the plain core, the plain core vs f32,
    the kernel route vs f32)] of the nine gradients of the TH sublayer, each as max |a - b| over max
    |b|: the kernel route and the plain core ('xla') in bf16 on the same
    inputs and cotangent, the plain core in f32 as the reference."""
    rng = np.random.RandomState(2)
    dim, heads = 384, 8
    ins = [_bf16(rng, (2, seq, dim), 1, card),
           (1 + _bf16(rng, (dim,), 0.1, card)).float(),
           _bf16(rng, (dim,), 0.1, card).float()]
    ins += [_bf16(rng, (dim, heads, 48), s / math.sqrt(dim), card).float()
            for s in (4, 1, 1)]
    ins.append(_bf16(rng, (heads, 48, dim), 1 / math.sqrt(dim), card).float())
    ins += _th_mixes(heads, seed, card)
    g = _bf16(rng, (2, seq, dim), 1, card)
    grads = {}
    for r, cast in ((route, None), ('xla', None), ('f32', torch.float32)):
        ts = [(t if cast is None else t.to(cast)).clone().requires_grad_()
              for t in ins]
        out = th_attention.th_attention_sublayer(
            *ts, heads, route='xla' if r == 'f32' else r)
        grads[r] = torch.autograd.grad(out, ts, g if cast is None else g.to(cast))
    return [(name, _rel(k, p), _rel(p, f), _rel(k, f)) for name, k, p, f in
            zip(TH_GRADS, grads[route], grads['xla'], grads['f32'])]


def _th_tol(noise):
    """2e-2, or 3x the plain core's own distance from f32 where that is
    larger (the rule of chip_smoke.py's gradient checks)."""
    return max(2e-2, 3.0 * noise)


@pytest.mark.parametrize('seed', TH_SEEDS)
@pytest.mark.parametrize('route,seq', [('fused', 196), ('blocked', 196),
                                       ('blocked', 300)])
def test_th_sublayer_gradients_match_plain_core(card, route, seq, seed):
    for name, err, noise, _ in _th_sublayer_errors(card, route, seq, seed):
        assert err <= _th_tol(noise), (name, err, noise)


def test_th_sublayer_gradients_over_seeds(card):
    """The fused route at L = 196 over 64 draws of the head mixes: prints
    every gradient more than 2e-2 from the plain core with its plain core vs
    f32 distance, and holds each to ``_th_tol``."""
    worst = []
    for seed in TH_SWEEP:
        for name, err, noise, far in _th_sublayer_errors(card, 'fused', 196,
                                                         seed):
            if err > 2e-2:
                print(f'seed {seed}: {name} kernel vs plain {err:.4g}, plain '
                      f'vs f32 {noise:.4g}, kernel vs f32 {far:.4g}')
            worst.append((err / _th_tol(noise), seed, name, err, noise))
    worst.sort(reverse=True)
    print('worst by err/tol:', worst[:5])
    assert worst[0][0] <= 1.0, worst[:5]


def test_th_smem_formula_matches_the_kernel(card):
    """The kernel's own shared-memory formula decides K5 vs K6 on the card:
    K5a's core is the two-sweep core, whose shared memory fits at every
    length, so K5 takes every L where its projection GEMMs take D
    (multiples of 32: cait_xxs's D = 192 too)."""
    assert _th_core_fwd_smem(8) == th_attention.th_fwd_plan(
        196, 8)['smem'] <= 232448
    for l, want in ((196, 'fused'), (224, 'fused'), (225, 'fused'),
                    (576, 'fused')):
        assert th_attention.th_route(l, 8, 48, 384, card) == want
    assert th_attention.th_route(196, 4, 48, 192, card) == 'fused'
    assert th_attention.th_route(196, 4, 48, 194, card) == 'blocked'


def test_th_route_at_16_heads_reads_the_kernel(card):
    """cait_m (16 heads, D = 768): the built library's shared memory of
    the core (sav_th_core_fwd_smem(16), two groups of 8 output heads) is
    the plan th_route decides on, and fits: K5 at @224 and @384."""
    assert _th_core_fwd_smem(16) == th_attention.th_fwd_plan(
        196, 16)['smem'] <= 232448
    for l in (196, 197, 576, 577):
        assert th_attention.th_route(l, 16, 48, 768, card) == 'fused'
        # cait_xs: D = 288, K5a's GEMMs with a ragged last tile and step
        assert th_attention.th_route(l, 6, 48, 288, card) == 'fused'
    with pytest.raises(NotImplementedError, match='use_kernel=False'):
        th_attention.th_route(196, 12, 48, 576, card)


@pytest.mark.parametrize('seq,residual', [(37, False), (196, False),
                                          (197, True)])
def test_th_attention_fwd_matches_twin_at_16_heads(card, seq, residual):
    """K5a at cait_m's widths (D = 768, 16 heads of 48), with and without
    its residuals, against the twin; two calls identical."""
    rng = np.random.RandomState(seq + 16)
    dim, heads = 768, 16
    x = _bf16(rng, (2, seq, dim), 1, card)
    scale = (1 + _bf16(rng, (dim,), 0.1, card)).float()
    bias = _bf16(rng, (dim,), 0.1, card).float()
    ws = [_bf16(rng, (dim, dim), s / math.sqrt(dim), card) for s in (4, 1, 1, 1)]
    m = _th_mixes(heads, seq, card)
    args = (x, scale, bias, *ws, *m, heads, th_attention.LN_EPS, residual)
    out = th_attention.th_attention_fwd(*args)
    out_t, (q, k, v, attn, lse) = th_attention.th_attention_fwd(
        *args, save_residuals=True)
    again = th_attention.th_attention_fwd(*args)
    plain = th_attention.th_attention_fwd_plain(*args)
    contrib = (plain.float() - (x.float() if residual else 0)).abs().max()
    assert (out.float() - plain.float()).abs().max() <= 2e-2 * contrib
    assert torch.equal(out, out_t) and torch.equal(out, again)
    own_attn, own_lse = th_attention.th_core_fwd_plain(q, k, v, *m, heads)
    assert _rel(attn, own_attn) <= 2e-2
    assert (lse - own_lse).abs().max() <= 1e-3


@pytest.mark.parametrize('dim,heads,seq,residual', [
    (288, 6, 37, False), (288, 6, 196, False), (288, 6, 197, True),
    (192, 4, 196, False), (192, 4, 197, True), (96, 6, 37, True)])
def test_th_attention_fwd_matches_twin_at_ragged_widths(card, dim, heads, seq,
                                                        residual):
    """K5a at cait_xs's widths (D = H*48 = 288: the projection GEMMs' last
    column tile and 64-deep step ragged), cait_xxs's (D = 192, one whole
    192-wide tile) and D = 96 under six heads (a ragged depth in QKV, a
    ragged out tile under the residual), with and without its residuals,
    against the twin; each output's ragged last columns also on their own;
    two calls identical."""
    rng = np.random.RandomState(seq + dim)
    hd = heads * 48
    x = _bf16(rng, (2, seq, dim), 1, card)
    scale = (1 + _bf16(rng, (dim,), 0.1, card)).float()
    bias = _bf16(rng, (dim,), 0.1, card).float()
    ws = [_bf16(rng, (dim, hd), s / math.sqrt(dim), card) for s in (4, 1, 1)]
    ws.append(_bf16(rng, (hd, dim), 1 / math.sqrt(hd), card))
    m = _th_mixes(heads, seq, card)
    args = (x, scale, bias, *ws, *m, heads, th_attention.LN_EPS, residual)
    out = th_attention.th_attention_fwd(*args)
    out_t, res = th_attention.th_attention_fwd(*args, save_residuals=True)
    again = th_attention.th_attention_fwd(*args)
    plain, p_res = th_attention.th_attention_fwd_plain(*args,
                                                       save_residuals=True)
    contrib = (plain.float() - (x.float() if residual else 0)).abs().max()
    assert (out.float() - plain.float()).abs().max() <= 2e-2 * contrib
    assert torch.equal(out, out_t) and torch.equal(out, again)
    for ours, twin in zip(res[:3], p_res[:3]):
        assert _rel(ours, twin) <= 2e-2
    q, k, v, attn, lse = res
    own_attn, own_lse = th_attention.th_core_fwd_plain(q, k, v, *m, heads)
    assert _rel(attn, own_attn) <= 2e-2
    assert (lse - own_lse).abs().max() <= 1e-3
    for ours, twin in zip((q, k, v, attn), (*p_res[:3], own_attn)):
        ragged = ours.shape[-1] % 64
        if ragged:
            assert _rel(ours[..., -ragged:], twin[..., -ragged:]) <= 2e-2
    ragged = dim % 64
    if ragged:
        tail = lambda t: t[..., -ragged:].float() - (
            x[..., -ragged:].float() if residual else 0)
        assert (tail(out) - tail(plain)).abs().max() <= 2e-2 * tail(
            plain).abs().max()


def test_th_staged_bwd_survives_back_to_back_calls(card):
    """50 calls of the staged backward (cait_m_48 @224 bs16's K5b shape)
    queued without a synchronize give the first call's result every
    time."""
    rng = np.random.RandomState(13)
    q, k, v, do, m = _th_core_case(rng, 16, 196, 16, card)
    _, lse = th_attention.th_core_fwd_plain(q, k, v, *m, 16)
    first = th_attention.th_attention_bwd(q, k, v, do, lse, *m, 16)
    for _ in range(5):
        outs = [th_attention.th_attention_bwd(q, k, v, do, lse, *m, 16)
                for _ in range(10)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for g in outs for a, b in zip(g, first))


def test_cait_m_launch_counts(card):
    """cait_m_24 at depth 2 @224 under 'auto': a forward launches K5a once
    a body block, a gradient step K5a-train + K5b, and quantized='all'
    serving K11 + K12; logits finite."""
    from sav_tpu_torch import _build
    from sav_tpu_torch.models import create_model
    from sav_tpu_torch.nn.regularization import set_stochastic_depth_generator
    kw = dict(num_layers=2, num_layers_token_only=1, dtype=torch.bfloat16,
              device=card)
    x = torch.randn(2, 224, 224, 3, generator=torch.Generator().manual_seed(0)
                    ).to(card, torch.bfloat16)
    model = create_model('cait_m_24', **kw)
    model.eval()
    _build.reset_launches()
    with torch.no_grad():
        logits = model(x)
    assert _build.launches == {'th_attention_fwd': 2}
    assert bool(torch.isfinite(logits).all())
    model.train()
    set_stochastic_depth_generator(
        model, torch.Generator(device=card).manual_seed(1))
    _build.reset_launches()
    model(x).float().square().mean().backward()
    assert _build.launches == {'th_attention_fwd_train': 2,
                               'th_attention_bwd': 2}
    quantized = create_model('cait_m_24', quantized='all', **kw)
    quantized.eval()
    _build.reset_launches()
    with torch.no_grad():
        assert bool(torch.isfinite(quantized(x)).all())
    assert _build.launches == {'th_attention_q8': 2, 'int8_ff': 2}


def test_th_wrappers_refuse_and_count(card):
    from sav_tpu_torch import _build
    rng = np.random.RandomState(1)
    q, k, v, do, m = _th_core_case(rng, 1, 40, 8, card)
    with pytest.raises(ValueError, match='heads'):
        th_attention.th_core_fwd(*(t[..., :240].contiguous() for t in (q, k, v)),
                                 torch.eye(5, device=card),
                                 torch.eye(5, device=card), 5)
    with pytest.raises(ValueError, match='bfloat16'):
        th_attention.th_core_fwd(q.float(), k.float(), v.float(), *m, 8)
    with pytest.raises(RuntimeError, match='forward-only'):
        th_attention.th_core_fwd(q.float().requires_grad_().bfloat16(), k, v,
                                 *m, 8)
    # D = 200: K5a's projection GEMMs take multiples of 32
    x = torch.zeros(1, 40, 200, device=card, dtype=torch.bfloat16)
    w = torch.zeros(200, 192, device=card, dtype=torch.bfloat16)
    m4 = [torch.eye(4, device=card)] * 2
    with pytest.raises(ValueError, match='fused_fits'):
        th_attention.th_attention_fwd(x, w[0].float(), w[0].float(), w, w, w,
                                      w, *m4, 4)
    _build.reset_launches()
    attn, lse = th_attention.th_core_fwd(q, k, v, *m, 8)
    th_attention.th_core_bwd(q, k, v, do, lse, *m, 8)
    th_attention.th_attention_bwd(q, k, v, do, lse, *m, 8)
    assert _build.launches == {'th_core_fwd': 1, 'th_core_bwd': 1,
                               'th_attention_bwd': 1}


# ---- slice 4: K8a/K8b (csrc/mixer_token.cu) and K16 (csrc/ff_bwd.cu)

def _k8_args(rng, batch, l, k, d, card):
    return (_bf16(rng, (batch, l, d), 1, card),
            (1 + _bf16(rng, (d,), 0.1, card)).float(),
            _bf16(rng, (d,), 0.1, card).float(),
            _bf16(rng, (l, k), 1 / math.sqrt(l), card),
            _bf16(rng, (k,), 0.1, card).float(),
            _bf16(rng, (k, l), 1 / math.sqrt(k), card),
            _bf16(rng, (l,), 0.1, card).float())


@pytest.mark.parametrize('batch,l,k,d', [(3, 196, 98, 768), (5, 49, 24, 512),
                                         (2, 13, 6, 128), (1, 196, 98, 1024)])
def test_token_mix_fwd_matches_twin(card, batch, l, k, d):
    from sav_tpu_torch.ops import mixer_token
    args = _k8_args(np.random.RandomState(l), batch, l, k, d, card)
    out = mixer_token.token_mix_fwd(*args)
    plain = mixer_token.token_mix_fwd_plain(*args)
    x = args[0]
    assert _rel(out.float() - x.float(), plain.float() - x.float()) <= 2e-2


@pytest.mark.parametrize('batch,l,k,d', [(3, 196, 98, 768), (65, 49, 24, 512),
                                         (2, 13, 6, 128)])
def test_token_mix_bwd_matches_twin_and_repeats(card, batch, l, k, d):
    from sav_tpu_torch.ops import mixer_token
    rng = np.random.RandomState(l + 1)
    args = _k8_args(rng, batch, l, k, d, card)
    g = _bf16(rng, (batch, l, d), 1, card)
    grads = mixer_token.token_mix_bwd(*args, g)
    twin = mixer_token.token_mix_bwd_plain(*args, g)
    assert all(a.shape == b.shape for a, b in zip(grads, twin))
    assert _rel(grads[0], twin[0]) <= 2e-2
    assert max(_rel(a, b) for a, b in zip(grads[1:], twin[1:])) <= WGRAD_TOL
    again = mixer_token.token_mix_bwd(*args, g)      # no float atomics
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize('m', [1, 130, 1003, 4 * 197])
def test_ff_bwd_matches_twin_and_repeats(card, m):
    rng = np.random.RandomState(m)
    d, f = 256, 512
    args = (_bf16(rng, (m, d), 1, card), _bf16(rng, (m, f), 1, card),
            _bf16(rng, (m, d), 1, card),
            _bf16(rng, (d, f), 1 / math.sqrt(d), card),
            _bf16(rng, (f, d), 1 / math.sqrt(f), card))
    got = fused_layer.ff_bwd(*args)
    twin = fused_layer.ff_bwd_plain(*args)
    assert all(a.shape == b.shape for a, b in zip(got, twin))
    assert _rel(got[0], twin[0]) <= 2e-2
    assert max(_rel(a, b) for a, b in zip(got[1:], twin[1:])) <= WGRAD_TOL
    assert all(torch.equal(a, b)
               for a, b in zip(got, fused_layer.ff_bwd(*args)))


@pytest.mark.parametrize('m', [37824, 1003, 129])
def test_ff_bwd_at_vit_b_widths(card, m):
    """K16 at ViT-B/16's widths: the rows of @224 bs192 (split-K over 8
    chunks) and two ragged counts, against the twin, two calls identical."""
    rng = np.random.RandomState(m)
    d, f = 768, 3072
    args = (_bf16(rng, (m, d), 1, card), _bf16(rng, (m, f), 1, card),
            _bf16(rng, (m, d), 1, card),
            _bf16(rng, (d, f), 1 / math.sqrt(d), card),
            _bf16(rng, (f, d), 1 / math.sqrt(f), card))
    got = fused_layer.ff_bwd(*args)
    again = fused_layer.ff_bwd(*args)
    twin = fused_layer.ff_bwd_plain(*args)
    assert _rel(got[0], twin[0]) <= 2e-2
    assert max(_rel(a, b) for a, b in zip(got[1:], twin[1:])) <= WGRAD_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize('m,d,f', [(300, 384, 640), (129, 128, 128)])
def test_ff_bwd_odd_column_tiles(card, m, d, f):
    """D and F an odd number of 128-wide tiles: the second half of a 128 x
    256 tile lies past the matrix (zeros in, nothing stored)."""
    rng = np.random.RandomState(m + d)
    args = (_bf16(rng, (m, d), 1, card), _bf16(rng, (m, f), 1, card),
            _bf16(rng, (m, d), 1, card),
            _bf16(rng, (d, f), 1 / math.sqrt(d), card),
            _bf16(rng, (f, d), 1 / math.sqrt(f), card))
    got = fused_layer.ff_bwd(*args)
    twin = fused_layer.ff_bwd_plain(*args)
    assert _rel(got[0], twin[0]) <= 2e-2
    assert max(_rel(a, b) for a, b in zip(got[1:], twin[1:])) <= WGRAD_TOL


def test_ff_bwd_plan_matches_the_kernel(card):
    """ff_bwd_plan mirrors sav_ff_bwd_plan on this card's SM count."""
    import ctypes
    from sav_tpu_torch import _build
    fn = _build.library('ff_bwd').sav_ff_bwd_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for m, d, f in ((1, 768, 3072), (129, 768, 3072), (1003, 768, 3072),
                    (37824, 768, 3072), (700, 128, 256), (50000, 1024, 4096)):
        out = (ctypes.c_int * 8)()
        assert fn(m, d, f, sms, out) == 0
        plan = fused_layer.ff_bwd_plan(m, d, f, sms)
        assert list(out) == [plan['row_tiles'], plan['steps'], plan['chunks'],
                             plan['steps_per_chunk'], plan['units']['dgact'],
                             plan['units']['dy'], plan['units']['dw'],
                             plan['smem']]
    assert fn(16, 100, 3072, sms, (ctypes.c_int * 8)()) != 0


def test_ff_bwd_survives_back_to_back_calls(card):
    """200 calls queued without a synchronize between them (a deadlock in
    the two consumers' rings shows as a launch failure) all give the first
    call's result."""
    rng = np.random.RandomState(5)
    m, d, f = 4 * 197, 768, 3072
    args = (_bf16(rng, (m, d), 1, card), _bf16(rng, (m, f), 1, card),
            _bf16(rng, (m, d), 1, card),
            _bf16(rng, (d, f), 1 / math.sqrt(d), card),
            _bf16(rng, (f, d), 1 / math.sqrt(f), card))
    first = fused_layer.ff_bwd(*args)
    for _ in range(20):
        outs = [fused_layer.ff_bwd(*args) for _ in range(10)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for g in outs for a, b in zip(g, first))


def test_ff_sublayer_gradients_match_the_library_backward(card):
    """The FF Function (K16 backward) against autograd through the same
    library forward, every gradient, bf16."""
    rng = np.random.RandomState(3)
    d, f = 256, 1024
    x = _bf16(rng, (2, 37, d), 1, card)
    params = [(1 + _bf16(rng, (d,), 0.1, card)).float(),
              _bf16(rng, (d,), 0.1, card).float(),
              _bf16(rng, (d, f), 1 / math.sqrt(d), card).float(),
              _bf16(rng, (f,), 0.1, card).float(),
              _bf16(rng, (f, d), 1 / math.sqrt(f), card).float(),
              _bf16(rng, (d,), 0.1, card).float()]
    grads = []
    for fn in (fused_layer.ff_sublayer,
               lambda *a: fused_layer._ff_fwd_res(*a, fused_layer.LN_EPS,
                                                  True)[0]):
        leaves = [t.clone().requires_grad_() for t in (x, *params)]
        fn(*leaves).float().square().sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) <= 2e-2


def test_slice4_wrappers_refuse_and_count(card):
    from sav_tpu_torch import _build
    from sav_tpu_torch.ops import mixer_token
    rng = np.random.RandomState(0)
    args = _k8_args(rng, 2, 16, 8, 128, card)
    with pytest.raises(ValueError, match='bfloat16'):
        mixer_token.token_mix_fwd(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match='do not take'):
        mixer_token.token_mix_fwd(args[0][..., :96].contiguous(),
                                  args[1][:96], args[2][:96], *args[3:])
    g, w = _bf16(rng, (64, 96), 1, card), _bf16(rng, (96, 96), 1, card)
    with pytest.raises(ValueError, match='multiples of 128'):
        fused_layer.ff_bwd(g, g, g, w, w)
    _build.reset_launches()
    out = mixer_token.token_mix_sublayer(*(t.requires_grad_() if t.dtype ==
                                           torch.float32 else t for t in args))
    out.float().sum().backward()
    assert _build.launches == {'token_mix_fwd': 1, 'token_mix_bwd': 1}


def test_mixer_smem_threshold_and_auto_refusal(card):
    """The K8 kernels' shared-memory budget on the card: every mixer_*
    config at 224 fits; @384 (L = 576, K = 288) does not, so 'auto' raises
    there and use_kernel=False runs the per-op path."""
    from sav_tpu_torch.models import create_model
    from sav_tpu_torch.ops import mixer_token
    for l, k in ((49, 24), (196, 98)):
        for d in (512, 768, 1024):
            assert mixer_token.supported(l, k, d, card)
    assert not mixer_token.supported(576, 288, 768, card)
    x = torch.zeros(1, 384, 384, 3, device=card)
    model = create_model('mixer_s_patch16', num_classes=10, img_size=384,
                         num_layers=1, dtype=torch.bfloat16, device=card)
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match='use_kernel=False'):
        model(x)
    per_op = create_model('mixer_s_patch16', num_classes=10,
                                   img_size=384, num_layers=1,
                                   dtype=torch.bfloat16, device=card,
                                   use_kernel=False)
    with torch.no_grad():
        assert per_op(x).shape == (1, 10)


# ---- slice 5: K1 with residual=False, K7a/K7b (csrc/tnt_inner.cu)

# K7b's 12 parameter gradients vs the twin, max |kernel - twin| over max
# |twin|. Both round dq, dk, dv, dhp and dx2 to bf16 at the same points
# from f32 values summed in other orders, so single one-ulp flips (2^-8
# relative) reach the weight gradients; at these small shapes a gradient
# sums 16 to ~6000 rows and one flip weighs most in the shortest sum. On an
# H100 80GB HBM3 (700 W) kernel vs twin read <= 1.1e-3 from 2 patches up
# and 2.5e-3 at one patch, each below the twin's own distance from an f32
# evaluation of the same bf16 inputs (3.0e-3 to 1.0e-2). One dropped row
# chunk (1 to 4 patches of hundreds at n = 395) moves a sum by several %.
K7_WGRAD_TOL = 5e-3

@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('dim,heads', [(384, 6), (640, 10)])
def test_fused_attention_without_residual(card, dim, heads, train):
    rng = np.random.RandomState(dim + train)
    x = _bf16(rng, (2, 197, dim), 1, card)
    scale = (1 + _bf16(rng, (dim,), 0.1, card)).float()
    bias = _bf16(rng, (dim,), 0.1, card).float()
    wq, wk, wv = (_bf16(rng, (dim, dim), s / math.sqrt(dim), card)
                  for s in (4, 1, 1))
    wo = _bf16(rng, (dim, dim), 1 / math.sqrt(dim), card)
    args = (x, scale, bias, wq, wk, wv, wo, heads, fused_layer.LN_EPS, train)
    out = fused_layer.fused_attention_fwd(*args, residual=False)
    plain = fused_layer.fused_attention_fwd_plain(*args, residual=False)
    with_x = fused_layer.fused_attention_fwd(*args)
    if train:
        out, plain, with_x = out[0], plain[0], with_x[0]
    assert _rel(out, plain) <= 2e-2
    # the same sublayer, x added in the epilogue or not
    assert _rel(with_x.float() - x.float(), out) <= 2e-2


def _k7_args(rng, n, d, heads, card, f=None):
    f = 4 * d if f is None else f
    hd = d // heads
    w = lambda *s: _bf16(rng, s, 1 / math.sqrt(s[0]), card).float()
    return (_bf16(rng, (n, 16, d), 1, card),
            (1 + _bf16(rng, (d,), 0.1, card)).float(),
            _bf16(rng, (d,), 0.1, card).float(),
            2 * w(d, heads, hd), w(d, heads, hd), w(d, heads, hd),
            w(heads, hd, d), (1 + _bf16(rng, (d,), 0.1, card)).float(),
            _bf16(rng, (d,), 0.1, card).float(), w(d, f),
            _bf16(rng, (f,), 0.1, card).float(), w(f, d),
            _bf16(rng, (d,), 0.1, card).float())


@pytest.mark.parametrize('n,d', [(1, 24), (7, 24), (2 * 196 + 3, 24),
                                 (5, 40), (196, 40)])
def test_tnt_inner_fwd_matches_twin(card, n, d):
    from sav_tpu_torch.ops import tnt_inner
    args = _k7_args(np.random.RandomState(n + d), n, d, 4, card)
    out = tnt_inner.inner_layer_fwd(*args, 4)
    plain = tnt_inner.inner_layer_fwd_plain(*args, 4)
    x = args[0]
    assert _rel(out.float() - x.float(), plain.float() - x.float()) <= 2e-2


@pytest.mark.parametrize('n,d', [(1, 24), (2 * 196 + 3, 24), (5, 40),
                                 (196, 40)])
def test_tnt_inner_bwd_matches_twin_and_repeats(card, n, d):
    from sav_tpu_torch.ops import tnt_inner
    rng = np.random.RandomState(n + d + 1)
    args = _k7_args(rng, n, d, 4, card)
    g = _bf16(rng, (n, 16, d), 1, card)
    grads = tnt_inner.inner_layer_bwd(*args, g, 4)
    twin = tnt_inner.inner_layer_bwd_plain(*args, g, 4)
    assert [a.shape for a in grads] == [b.shape for b in twin]
    assert _rel(grads[0], twin[0]) <= 2e-2
    assert max(_rel(a, b) for a, b in zip(grads[1:], twin[1:])) <= K7_WGRAD_TOL
    again = tnt_inner.inner_layer_bwd(*args, g, 4)      # no float atomics
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize('n,d', [(2 * 132 * 8 + 37, 24),
                                 (2 * 132 * 3 + 5, 40)])
def test_tnt_inner_bwd_over_rounds_matches_twin_and_repeats(card, n, d):
    """K7b with every block over several rounds of patches, the last one
    part-filled: the gradients against the twin and, from per-block
    partials summed in a fixed order, bit-identical over two calls."""
    from sav_tpu_torch.ops import tnt_inner
    rng = np.random.RandomState(n)
    args = _k7_args(rng, n, d, 4, card)
    g = _bf16(rng, (n, 16, d), 1, card)
    grads = tnt_inner.inner_layer_bwd(*args, g, 4)
    twin = tnt_inner.inner_layer_bwd_plain(*args, g, 4)
    assert _rel(grads[0], twin[0]) <= 2e-2
    assert max(_rel(a, b) for a, b in zip(grads[1:], twin[1:])) <= K7_WGRAD_TOL
    again = tnt_inner.inner_layer_bwd(*args, g, 4)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize('n,d,f,heads,tiled', [(37, 16, 64, 2, False),
                                               (29, 48, 192, 4, True)])
def test_tnt_inner_bwd_any_width_matches_twin(card, n, d, f, heads, tiled):
    """K7b's instantiation that reads the widths at run time, in both
    layouts (tnt_bwd_plan's choice), against the twin, and repeatable."""
    from sav_tpu_torch.ops import tnt_inner
    assert tnt_inner.tnt_bwd_plan(n, d, f, heads)['tiled'] == tiled
    rng = np.random.RandomState(d)
    args = _k7_args(rng, n, d, heads, card, f)
    g = _bf16(rng, (n, 16, d), 1, card)
    grads = tnt_inner.inner_layer_bwd(*args, g, heads)
    twin = tnt_inner.inner_layer_bwd_plain(*args, g, heads)
    assert _rel(grads[0], twin[0]) <= 2e-2
    assert max(_rel(a, b) for a, b in zip(grads[1:], twin[1:])) <= K7_WGRAD_TOL
    again = tnt_inner.inner_layer_bwd(*args, g, heads)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize('n,d,f,heads', [(4 * 37 + 1, 24, 96, 4),
                                         (4 * 37 + 2, 24, 96, 4),
                                         (4 * 37 + 3, 40, 160, 4),
                                         (4 * 400 + 2, 40, 160, 4),
                                         (37, 16, 64, 2), (29, 48, 192, 4),
                                         (21, 32, 128, 4)])
def test_tnt_inner_fwd_units_and_routes(card, n, d, f, heads):
    """K7a with the last 4-patch unit holding 1-3 patches (the Hopper
    kernel, route 1), and at widths outside its instantiations (route 0,
    the warp-a-patch kernel), into buffers 64 patches longer holding a NaN
    sentinel: the n patches against the twin, the rest untouched."""
    from sav_tpu_torch.ops import tnt_inner
    from sav_tpu_torch.ops.flash_attention import stream_of
    args = _k7_args(np.random.RandomState(n + d), n, d, heads, card, f)
    plan = tnt_inner.tnt_fwd_plan(n, d, f, heads)
    assert plan['route'] == (1 if (d, f, heads) in tnt_inner.HOP_WGS else 0)
    raw = tnt_inner._check(args[0], args[1:], heads)
    out = torch.full((n + 64, 16, d), float('nan'), device=card,
                     dtype=torch.bfloat16)
    err = tnt_inner._fn('sav_tnt_fwd', 14, 4, 2)(
        args[0].data_ptr(), *(t.data_ptr() for t in raw), out.data_ptr(), n,
        d, f, heads, fused_layer.LN_EPS, (d // heads) ** -0.5,
        stream_of(card))
    torch.cuda.synchronize()
    assert err == 0
    plain = tnt_inner.inner_layer_fwd_plain(*args, heads)
    x = args[0]
    assert _rel(out[:n].float() - x.float(), plain.float() - x.float()) <= 2e-2
    assert torch.isnan(out[n:]).all()


def test_tnt_fwd_plan_matches_the_kernel(card):
    """tnt_fwd_plan mirrors sav_tnt_fwd_plan on this card's SM count, both
    routes."""
    import ctypes
    from sav_tpu_torch.ops import tnt_inner
    fn = tnt_inner._fn('sav_tnt_fwd_plan', 0, 5)
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for n, d, f, h in ((32 * 196, 24, 96, 4), (64 * 196, 24, 96, 4),
                       (32 * 196, 40, 160, 4), (1, 24, 96, 4),
                       (7, 40, 160, 4), (1001, 16, 64, 2), (37, 32, 128, 4),
                       (5, 48, 192, 4), (5, 64, 256, 4), (3, 24, 192, 4)):
        out = (ctypes.c_longlong * 7)()
        plan = tnt_inner.tnt_fwd_plan(n, d, f, h, sms)
        assert fn(n, d, f, h, sms, out) == 0
        assert list(out) == [plan['route'], plan['wgs'], plan['blocks'],
                             plan['smem'], plan['units'], plan['per_wg'],
                             plan['weights']], (n, d, f, h)
    assert fn(5, 12, 48, 4, sms, (ctypes.c_longlong * 7)()) != 0


def test_tnt_inner_wrappers_refuse_and_count(card):
    from sav_tpu_torch import _build
    from sav_tpu_torch.ops import tnt_inner
    rng = np.random.RandomState(0)
    args = _k7_args(rng, 3, 24, 4, card)
    with pytest.raises(ValueError, match='bfloat16'):
        tnt_inner.inner_layer_fwd(args[0].float(), *args[1:], 4)
    with pytest.raises(ValueError, match='16 pixel tokens'):
        tnt_inner.inner_layer_fwd(args[0][:, :8].contiguous(), *args[1:], 4)
    leaves = [args[0]] + [t.clone().requires_grad_() for t in args[1:]]
    with pytest.raises(RuntimeError, match='forward-only'):
        tnt_inner.inner_layer_fwd(*leaves, 4)
    with pytest.raises(RuntimeError, match='forward-only'):
        tnt_inner.inner_layer_bwd(*leaves, args[0], 4)
    _build.reset_launches()
    tnt_inner.inner_layer(*leaves, 4).float().sum().backward()
    assert _build.launches == {'tnt_inner_fwd': 1, 'tnt_inner_bwd': 1}
    assert tnt_inner.supported(16, 24, 4, device=card)
    assert tnt_inner.supported(16, 40, 4, device=card)


# K9 (BoTNet's relative-position attention): out, dq, dk, dv at 2e-2 of max
# |twin| (bf16 outputs, single one-ulp flips of p or ds); drel_h and drel_w
# at BOT_REL_TOL of max: each is a row-local f32 sum of g values of the f32
# ds, from logits summed in another order than the twin's (and exp2 vs
# exp), so they agree to f32 rounding of p and dp; a dropped or mis-binned
# key column moves a bin by O(1/g) of max
BOT_REL_TOL = 1e-3


def _k9_args(rng, b, g, heads, d, card):
    """qs (pre-scaled, peaked softmax), k, v [B, g*g, h*d] bf16 and rel_h,
    rel_w [B, h, L, g] f32 at the size of the path's rel logits."""
    length, hd = g * g, heads * d
    qs = _bf16(rng, (b, length, hd), 2 / math.sqrt(d), card)
    k, v = (_bf16(rng, (b, length, hd), 1, card) for _ in range(2))
    rel = [_bf16(rng, (b, heads, length, g), 0.5, card).float()
           for _ in range(2)]
    return qs, k, v, *rel


@pytest.mark.parametrize('b,g,heads,d', [(1, 1, 1, 64), (2, 5, 4, 64),
                                         (3, 14, 4, 128), (2, 13, 2, 128),
                                         (1, 9, 3, 64)])
def test_bot_fwd_matches_twin(card, b, g, heads, d):
    from sav_tpu_torch.ops import botnet_attention as ba
    args = _k9_args(np.random.RandomState(g * heads + d), b, g, heads, d, card)
    out, lse = ba.bot_fwd(*args, heads, g, save_lse=True)
    serve, none = ba.bot_fwd(*args, heads, g)
    p_out, p_lse = ba.bot_fwd_plain(*args, heads, g)
    assert none is None and torch.equal(out, serve)
    assert _rel(out, p_out) <= 2e-2
    assert (lse - p_lse).abs().max() <= 1e-3


@pytest.mark.parametrize('b,g,heads,d', [(1, 2, 1, 64), (2, 5, 4, 64),
                                         (3, 14, 4, 128), (2, 13, 2, 128)])
def test_bot_bwd_matches_twin_and_repeats(card, b, g, heads, d):
    from sav_tpu_torch.ops import botnet_attention as ba
    rng = np.random.RandomState(g * heads + d + 1)
    args = _k9_args(rng, b, g, heads, d, card)
    out, lse = ba.bot_fwd_plain(*args, heads, g)
    do = _bf16(rng, out.shape, 1, card)
    grads = ba.bot_bwd(*args, out, lse, do, heads, g)
    twin = ba.bot_bwd_plain(*args, out, lse, do, heads, g)
    assert [a.shape for a in grads] == [t.shape for t in twin]
    assert max(_rel(a, t) for a, t in zip(grads[:3], twin[:3])) <= 2e-2
    assert max(_rel(a, t) for a, t in zip(grads[3:], twin[3:])) <= BOT_REL_TOL
    again = ba.bot_bwd(*args, out, lse, do, heads, g)     # no float atomics
    assert all(torch.equal(a, t) for a, t in zip(grads, again))


@pytest.mark.parametrize('b,g,heads,d', [(2, 13, 2, 128), (2, 20, 2, 128),
                                         (2, 9, 3, 64), (1, 15, 2, 64),
                                         (1, 24, 1, 128)])
def test_bot_fwd_ragged_key_tiles(card, b, g, heads, d):
    """K9a where L is ragged against the plan's key tile (g = 13: three
    64-key tiles, the last 41; 20: four 104-key steps, the last 88; 9: one
    104-key step of 81; 15: four 64-key tiles, the last 33; 24: nine full
    64-key tiles), out and lse against the twin."""
    from sav_tpu_torch.ops import botnet_attention as ba
    plan = ba.bot_fwd_plan(g, d)
    assert plan['tiles'] == -(-g * g // plan['width'])
    args = _k9_args(np.random.RandomState(g + d), b, g, heads, d, card)
    out, lse = ba.bot_fwd(*args, heads, g, save_lse=True)
    p_out, p_lse = ba.bot_fwd_plain(*args, heads, g)
    assert _rel(out, p_out) <= 2e-2
    assert (lse - p_lse).abs().max() <= 1e-3


def test_bot_fwd_plan_matches_the_kernel(card):
    """bot_fwd_plan mirrors sav_bot_fwd_plan (K9a) over g = 1..70 at d = 64
    and 128."""
    import ctypes
    from sav_tpu_torch import _build
    from sav_tpu_torch.ops import botnet_attention as ba
    fn = _build.library('botnet_attention').sav_bot_fwd_plan
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    for d in (64, 128):
        for g in range(1, 71):
            p = ba.bot_fwd_plan(g, d)
            out = (ctypes.c_longlong * 7)()
            rc = fn(g, d, out)
            assert list(out) == [p['width'], p['tiles'], p['qbufs'],
                                 p['stages'], p['res'], p['slot'],
                                 p['smem']], (g, d)
            assert (rc == 0) == (p['stages'] > 0)
    assert fn(14, 96, (ctypes.c_longlong * 7)()) != 0


def test_bot_kernels_write_no_row_past_the_length(card):
    """Outputs hold exactly L rows (nothing is padded); rows the kernels
    compute past L = 25 in their 64-row tiles are never stored: buffers 64
    rows longer keep their NaN sentinel past L, and the rel gradients past
    the last head's rows."""
    from sav_tpu_torch.ops import botnet_attention as ba
    from sav_tpu_torch.ops.flash_attention import stream_of
    rng = np.random.RandomState(5)
    g, heads, d = 5, 2, 128
    length = g * g
    qs, k, v, rh, rw = _k9_args(rng, 1, g, heads, d, card)
    p_out, p_lse = ba.bot_fwd_plain(qs, k, v, rh, rw, heads, g)
    do = _bf16(rng, p_out.shape, 1, card)
    band = lambda: torch.full((1, length + 64, heads * d), float('nan'),
                              device=card, dtype=torch.bfloat16)
    rel = lambda: torch.full((heads * length * g + 64 * g,), float('nan'),
                             device=card)
    out, dq, dk, dv = band(), band(), band(), band()
    drh, drw = rel(), rel()
    lse = torch.empty(1, heads, length, device=card)
    delta = torch.empty_like(lse)
    ptr = lambda *ts: [t.data_ptr() for t in ts]
    dims = (1, length, heads, g, d, stream_of(card))
    assert ba._fn('sav_bot_fwd', 7, 5)(*ptr(qs, k, v, rh, rw, out, lse),
                                       *dims) == 0
    assert ba._fn('sav_bot_bwd_dq', 12, 5)(
        *ptr(qs, k, v, p_out, do, rh, rw, p_lse, delta, dq, drh, drw),
        *dims) == 0
    assert ba._fn('sav_bot_bwd_dkv', 10, 5)(
        *ptr(qs, k, v, do, rh, rw, p_lse, delta, dk, dv), *dims) == 0
    torch.cuda.synchronize()
    twin = ba.bot_bwd_plain(qs, k, v, rh, rw, p_out, p_lse, do, heads, g)
    assert _rel(out[:, :length], p_out) <= 2e-2
    for ours, want in zip((dq, dk, dv), twin[:3]):
        assert _rel(ours[:, :length], want) <= 2e-2
    for ours, want in zip((drh, drw), twin[3:]):
        assert _rel(ours[:heads * length * g].view(want.shape), want) <= BOT_REL_TOL
        assert torch.isnan(ours[heads * length * g:]).all()
    for t in (out, dq, dk, dv):
        assert torch.isnan(t[:, length:]).all()


def test_bot_core_gradients_match_plain_core(card):
    """botnet_mhsa on the kernels against the same Function on the twins
    (core='plain'): out and the gradients of qs, k, v, emb_h and emb_w at
    botnet_t3's grid and head width."""
    from sav_tpu_torch.ops import botnet_attention as ba
    rng = np.random.RandomState(7)
    g, heads, d = 14, 4, 128
    qs, k, v, _, _ = _k9_args(rng, 2, g, heads, d, card)
    embs = [_bf16(rng, (2 * g - 1, d), 1 / math.sqrt(d), card).float()
            for _ in range(2)]
    do = _bf16(rng, qs.shape, 1, card)
    res = {}
    for core in ba.CORES:
        leaves = [t.clone().requires_grad_() for t in (qs, k, v, *embs)]
        out = ba.botnet_mhsa(*leaves, heads, g, core=core)
        res[core] = (out, *torch.autograd.grad(out, leaves, do))
    for ours, plain in zip(res['kernel'], res['plain']):
        assert _rel(ours, plain) <= 2e-2


def test_bot_wrappers_refuse_and_count(card):
    from sav_tpu_torch import _build
    from sav_tpu_torch.ops import botnet_attention as ba
    rng = np.random.RandomState(0)
    qs, k, v, rh, rw = _k9_args(rng, 2, 5, 2, 64, card)
    with pytest.raises(ValueError, match='bfloat16'):
        ba.bot_fwd(qs.float(), k, v, rh, rw, 2, 5)
    with pytest.raises(ValueError, match='grid'):
        ba.bot_fwd(qs, k, v, rh, rw, 2, 4)
    with pytest.raises(ValueError, match='float32'):
        ba.bot_fwd(qs, k, v, rh.bfloat16(), rw, 2, 5)
    with pytest.raises(ValueError, match='head widths'):
        ba.bot_fwd(*(t[..., :96].contiguous() for t in (qs, k, v)),
                   rh[:, :1].contiguous(), rw[:, :1].contiguous(), 1, 5)
    leaves = [t.clone().requires_grad_() for t in (qs, k, v, rh, rw)]
    with pytest.raises(RuntimeError, match='forward-only'):
        ba.bot_fwd(*leaves, 2, 5)
    assert ba.supported(14, 4, 128, device=card)        # botnet_t3 @224
    assert ba.supported(24, 4, 128, device=card)        # @384
    assert not ba.supported(14, 4, 96, device=card)
    _build.reset_launches()
    with torch.no_grad():
        ba.bot_core(qs, k, v, rh, rw, 2, 5)
    ba.bot_core(*leaves, 2, 5).float().sum().backward()
    assert _build.launches == {'bot_fwd': 1, 'bot_fwd_train': 1,
                               'bot_bwd_dq': 1, 'bot_bwd_dkv': 1}


# ---- int8 (slice 7): K15 (int8_matmul.cu), K12/K13 (int8_ff.cu), K10
# (fused_attention_q8.cu) against their twins on the card. The kernels and
# twins make the same codes by the same IEEE divisions and sum int32
# exactly; the twins' LayerNorm (K13, K10) and softmax sums (K10) run in
# another order, and an f32 ulp there can move a code that sits at .5 by
# one step (1/127 of its row's scale). Held: outputs within INT8_TOL of max
# |twin| (K13 and K10: of max |twin - x|), and at least INT8_SHARE of the
# bf16 outputs (and of K12/K13's bf16 hpre) bit-identical to the twin's. A
# wrong tile, scale or mask moves most outputs by O(1).
INT8_TOL = 2e-2
INT8_SHARE = 0.9


def _int8_check(got, want, base=None):
    got, want = got.float(), want.float()
    ref = want if base is None else want - base.float()
    err = float((got - want).abs().max() / ref.abs().max())
    same = float((got == want).float().mean())
    assert bool(torch.isfinite(got).all())
    assert err <= INT8_TOL and same >= INT8_SHARE, (err, same)


@pytest.mark.parametrize('m,k,n', [(1, 300, 64), (130, 768, 3072),
                                   (1003, 3072, 768), (6304, 768, 3072),
                                   (6304, 3072, 768), (40, 300, 100),
                                   (3, 1, 2)])
def test_int8_matmul_matches_twin(card, m, k, n):
    """K15 at ViT-B/16 bs32's two FF products (FF1, FF2), ragged M, K and
    N (N = 100: the output's rows 104 apart, returned as a view)."""
    from sav_tpu_torch.ops import int8_matmul_kernel as k15
    from sav_tpu_torch.ops.quantized import quantize_symmetric
    rng = np.random.RandomState(m)
    a = _bf16(rng, (m, k), 1.0, card)
    b_q, b_s = quantize_symmetric(_bf16(rng, (k, n), 1 / math.sqrt(k), card), 0)
    _int8_check(k15.int8_matmul_fused(a, b_q, b_s),
                k15.blockwise_int8_matmul_reference(a, b_q, b_s))


def _ff_case(rng, m, d, f, card):
    from sav_tpu_torch.ops import int8_ff
    x = _bf16(rng, (m, d), 1.0, card)
    vec = lambda n, std, mean=0.0: (mean + std * torch.from_numpy(
        rng.standard_normal(n).astype(np.float32))).to(card)
    w1 = vec((d, f), 1 / math.sqrt(d))
    w2 = vec((f, d), 1 / math.sqrt(f))
    w1_q, s1, w2_q, s2 = int8_ff._quantized_weights(w1, w2)
    return (x, (vec(d, 0.1, 1.0), vec(d, 0.1)),
            (w1_q, s1, vec(f, 0.1), w2_q, s2, vec(d, 0.1)))


@pytest.mark.parametrize('save_hpre', [False, True])
@pytest.mark.parametrize('m,d,f', [(1, 768, 3072), (47, 768, 3072),
                                   (1003, 768, 3072), (130, 1024, 4096),
                                   (1003, 288, 1152), (77, 224, 800)])
def test_int8_ff_matches_twin(card, m, d, f, save_hpre):
    """K12 and K13 at ragged M (not multiples of their 128-row tiles) and at
    the widest factory width (D = 1024, F = 4096)."""
    from sav_tpu_torch.ops import int8_ff
    x, ln, w = _ff_case(np.random.RandomState(m + d), m, d, f, card)
    for got, want, base in (
            (int8_ff.int8_ff_raw(x, *w, save_hpre=save_hpre),
             int8_ff.int8_ff_reference(x, *w, save_hpre=save_hpre), None),
            (int8_ff.int8_ff_ln_raw(x, *ln, *w, save_hpre=save_hpre),
             int8_ff.int8_ff_ln_reference(x, *ln, *w, save_hpre=save_hpre),
             x)):
        if save_hpre:
            assert got[1].shape == (m, f) and got[1].dtype == torch.bfloat16
            _int8_check(got[1], want[1])
            got, want = got[0], want[0]
        _int8_check(got, want, base)


def test_int8_kernels_write_no_row_past_m(card):
    """K12/K13 (with hpre) and K15 at M = 1003, K10 at B = 3, L = 197, into
    NaN-sentinel buffers 64 rows longer: the rows past M keep the sentinel,
    the rows in range match the twins."""
    from sav_tpu_torch.ops import int8_ff, int8_matmul_kernel as k15
    from sav_tpu_torch.ops.quantized import quantize_symmetric
    nan = lambda rows, w: torch.full((rows + 64, w), float('nan'), device=card,
                                     dtype=torch.bfloat16)
    m, d, f = 1003, 768, 3072
    x, (ls, lb), (w1_q, s1, b1, w2_q, s2, b2) = _ff_case(
        np.random.RandomState(5), m, d, f, card)
    for ln in (0, 1):
        out, hpre = nan(m, d), nan(m, f)
        # the C entry into the first M rows (it raises on a failed launch)
        int8_ff._int8_ff_into(x, (ls, lb) if ln else None, w1_q, s1, b1,
                              w2_q, s2, b2, 1e-6, out[:m], hpre[:m])
        torch.cuda.synchronize()
        want = (int8_ff.int8_ff_ln_reference(x, ls, lb, w1_q, s1, b1, w2_q, s2,
                                             b2, save_hpre=True) if ln else
                int8_ff.int8_ff_reference(x, w1_q, s1, b1, w2_q, s2, b2,
                                          save_hpre=True))
        _int8_check(out[:m], want[0], x if ln else None)
        _int8_check(hpre[:m], want[1])
        assert bool(torch.isnan(out[m:]).all() and torch.isnan(hpre[m:]).all())
    k = 700                           # K15's last k-block is ragged
    a = x[:, :k].contiguous()
    b_q, b_s = quantize_symmetric(
        _bf16(np.random.RandomState(6), (k, 256), 1 / math.sqrt(k), card), 0)
    out = nan(m, 256)
    # the C entry into the first M rows (it raises on a failed launch)
    k15._int8_matmul_into(a, b_q, b_s, out[:m])
    torch.cuda.synchronize()
    _int8_check(out[:m], k15.blockwise_int8_matmul_reference(a, b_q, b_s))
    assert bool(torch.isnan(out[m:]).all())


@pytest.mark.parametrize('b,seq,dim,heads', [(3, 5, 768, 12), (2, 17, 128, 2),
                                             (2, 64, 128, 2),
                                             (3, 197, 768, 12)])
def test_fused_attention_q8_matches_twin(card, b, seq, dim, heads):
    rng = np.random.RandomState(seq)
    x = _bf16(rng, (b, seq, dim), 1.0, card)
    w = lambda shape, std: torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32)).to(card)
    scale, bias = 1.0 + w((dim,), 0.1), w((dim,), 0.1)
    ws = [w((dim, heads, 64), 4 / math.sqrt(dim)),
          w((dim, heads, 64), 1 / math.sqrt(dim)),
          w((dim, heads, 64), 1 / math.sqrt(dim)),
          w((heads, 64, dim), 1 / math.sqrt(dim))]
    with torch.no_grad():
        got = fused_layer.attention_sublayer_q8(x, scale, bias, *ws, heads)
        want = fused_layer.attention_sublayer_q8(x, scale, bias, *ws, heads,
                                                 core='plain')
    _int8_check(got, want, x)


@pytest.mark.parametrize('b,seq,dim,heads', [(3, 197, 768, 12),
                                             (2, 50, 1024, 16),
                                             (2, 20, 1536, 24)])
def test_fused_attention_q8_writes_no_row_past_m(card, b, seq, dim, heads):
    """K10 through its C entry into a NaN-sentinel buffer 64 rows longer:
    ViT-B's widths (the bands staged in shared memory), ViT-L's and 24
    heads (staged in the workspace). The rows in range match the twin, the
    rows past them keep the sentinel."""
    rng = np.random.RandomState(seq + heads)
    x = _bf16(rng, (b, seq, dim), 1.0, card)
    w = lambda shape, std: torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32)).to(card)
    scale, bias = 1.0 + w((dim,), 0.1), w((dim,), 0.1)
    ws = [w((dim, heads, 64), 4 / math.sqrt(dim)),
          w((dim, heads, 64), 1 / math.sqrt(dim)),
          w((dim, heads, 64), 1 / math.sqrt(dim)),
          w((heads, 64, dim), 1 / math.sqrt(dim))]
    codes = fused_layer._q8_weights(*ws, dim, heads * 64)
    rows = b * seq
    out = torch.full((rows + 64, dim), float('nan'), device=card,
                     dtype=torch.bfloat16)
    fused_layer._fused_q8_into(x, scale, bias, [c for c, _ in codes],
                               [s for _, s in codes], heads,
                               fused_layer.LN_EPS, True, out[:rows])
    torch.cuda.synchronize()
    with torch.no_grad():
        want = fused_layer.fused_attention_q8_plain(
            x, scale, bias, *[t for pair in codes for t in pair], heads)
    _int8_check(out[:rows], want.reshape(rows, dim), x.reshape(rows, dim))
    assert bool(torch.isnan(out[rows:]).all())


def test_fused_q8_plan_matches_the_kernel(card):
    """fused_q8_plan mirrors sav_fused_q8_plan."""
    import ctypes
    from sav_tpu_torch import _build
    fn = _build.library('fused_attention_q8').sav_fused_q8_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for b, l, d, h in ((32, 197, 768, 12), (32, 577, 384, 6),
                       (3, 197, 768, 12), (2, 50, 1024, 16), (2, 17, 128, 2),
                       (2, 20, 1536, 24), (1, 1, 768, 12)):
        out = (ctypes.c_longlong * 24)()
        assert fn(b, l, d, h, out) == 0
        p = fused_layer.fused_q8_plan(b, l, d, h)
        assert list(out) == (
            [p['tile']['qkv'], p['tile']['out'], p['row_tiles'],
             p['units']['qkv'], p['units']['out'], p['slots']['qkv'],
             p['slots']['out'], p['smem']['qkv'], p['smem']['out'],
             p['smem']['core'], p['units']['core'], p['slots']['core'],
             int(p['staged']), p['workspace']]
            + [p['scratch'][r][0] for r in fused_layer.Q8_REGIONS])
    assert fn(2, 17, 192, 3, (ctypes.c_longlong * 24)()) != 0
    assert fn(2, 17, 640, 5, (ctypes.c_longlong * 24)()) != 0


def test_bot_bwd_plan_matches_the_kernel(card):
    """bot_bwd_plan and fwd_smem mirror sav_bot_bwd_plan and sav_bot_smem
    (K9b's dq and dkv kernels, K9a) over g = 1..60 at d = 64 and 128."""
    import ctypes
    from sav_tpu_torch import _build
    from sav_tpu_torch.ops import botnet_attention as ba
    fn = _build.library('botnet_attention').sav_bot_bwd_plan
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    for d in (64, 128):
        for g in range(1, 61):
            p = ba.bot_bwd_plan(g, d)
            out = (ctypes.c_longlong * 6)()
            rc = fn(g, d, out)
            assert list(out) == [p['dq']['smem'], p['dq']['stages'],
                                 p['dkv']['smem'], p['dkv']['stages'],
                                 p['dkv']['slot'], p['pitch']], (g, d)
            assert (rc == 0) == (p['dq']['stages'] > 0
                                 and p['dkv']['stages'] > 0)
            assert [ba._smem(w, g, d) for w in range(3)] == [
                ba.fwd_smem(g, d), p['dq']['smem'], p['dkv']['smem']]
    assert fn(14, 96, (ctypes.c_longlong * 6)()) != 0


def test_int8_wrappers_refuse_and_count(card):
    from sav_tpu_torch import _build
    from sav_tpu_torch.ops import int8_ff, int8_matmul_kernel as k15
    from sav_tpu_torch.ops.quantized import quantize_symmetric
    rng = np.random.RandomState(9)
    x, ln, w = _ff_case(rng, 64, 128, 512, card)
    _build.reset_launches()
    int8_ff.int8_ff_raw(x, *w)
    int8_ff.int8_ff_ln_raw(x, *ln, *w, save_hpre=True)
    b_q, b_s = quantize_symmetric(w[0].float(), 0)
    k15.int8_matmul_fused(x, b_q.to(torch.int8), b_s)
    assert _build.launches == {'int8_ff': 1, 'int8_ff_ln_train': 1,
                               'int8_matmul': 1}
    with pytest.raises(ValueError, match='bfloat16'):
        int8_ff.int8_ff_raw(x.float(), *w)
    with pytest.raises(ValueError, match='multiples of 32'):
        int8_ff.int8_ff_raw(x[:, :80].contiguous(), w[0][:80], *w[1:3],
                            w[3][:, :80], w[4][:, :80], w[5][:80])
    with pytest.raises(RuntimeError, match='forward-only'):
        int8_ff.int8_ff_raw(x.clone().requires_grad_(), *w)
    xs = _bf16(rng, (2, 5, 128), 1.0, card)
    ws = [torch.zeros(128, 2, 64, device=card, requires_grad=True)
          for _ in range(3)] + [torch.zeros(2, 64, 128, device=card)]
    with pytest.raises(RuntimeError, match='serving-only'):
        fused_layer.attention_sublayer_q8(xs, ln[0], ln[1], *ws, 2)


# ---- int8 slice 8: K11 (csrc/th_attention_q8.cu), K14 (csrc/int8_ff.cu)

def _k11_case(rng, b, seq, dim, heads, card):
    hd = heads * 48
    w = lambda shape, std: torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32)).to(card)
    x = _bf16(rng, (b, seq, dim), 1.0, card)
    ws = [w((dim, heads, 48), 4 / math.sqrt(dim)),
          w((dim, heads, 48), 1 / math.sqrt(dim)),
          w((dim, heads, 48), 1 / math.sqrt(dim)),
          w((heads, 48, dim), 1 / math.sqrt(hd))]
    mixes = [torch.eye(heads, device=card) + w((heads, heads), 0.3)
             for _ in range(2)]
    return x, 1.0 + w((dim,), 0.1), w((dim,), 0.1), ws, mixes


@pytest.mark.parametrize('b,seq,dim,heads,residual', [
    (2, 1, 384, 8, False), (2, 17, 192, 4, False), (3, 196, 384, 8, False),
    (2, 196, 192, 4, True), (2, 250, 384, 8, False), (1, 300, 192, 4, False),
    (3, 196, 768, 16, False), (2, 197, 768, 16, True),
    (3, 196, 288, 6, False), (2, 197, 288, 6, True), (2, 17, 224, 6, False)])
def test_th_attention_q8_matches_twin(card, b, seq, dim, heads, residual):
    """K11 against its twin, through th_attention_sublayer_q8: the resident
    core (L <= 224 at H = 8, <= 256 at H = 4) and the two-sweep one (L =
    250 at H = 8, 300 at H = 4)."""
    x, scale, bias, ws, mixes = _k11_case(np.random.RandomState(seq + dim), b,
                                          seq, dim, heads, card)
    assert th_attention.th_supported(seq, heads, 48)
    with torch.no_grad():
        got = th_attention.th_attention_sublayer_q8(
            x, scale, bias, *ws, *mixes, heads, residual=residual)
        want = th_attention.th_attention_sublayer_q8(
            x, scale, bias, *ws, *mixes, heads, residual=residual,
            core='plain')
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    _int8_check(got, want, x if residual else None)


def test_th_attention_q8_off_geometry_and_refusals(card):
    """Where th_supported fails (L = 576 at H = 8) 'all' is the bf16 span on
    the route given (K6a here, no K11); the wrapper refuses an unbuilt head
    count and autograd, and counts its launches."""
    from sav_tpu_torch import _build
    x, scale, bias, ws, mixes = _k11_case(np.random.RandomState(3), 1, 576,
                                          384, 8, card)
    _build.reset_launches()
    with torch.no_grad():
        th_attention.th_attention_sublayer_q8(x, scale, bias, *ws, *mixes, 8,
                                              route='blocked')
        assert _build.launches == {'th_core_fwd': 1}
        x17 = x[:, :17].contiguous()
        th_attention.th_attention_sublayer_q8(x17, scale, bias, *ws, *mixes, 8)
    assert _build.launches == {'th_core_fwd': 1, 'th_attention_q8': 1}
    codes = [t for pair in fused_layer._q8_weights(*ws, 384, 384)
             for t in pair]
    with pytest.raises(ValueError, match='heads'):
        th_attention.th_attention_q8(x17, scale, bias, *codes, *mixes, 6)
    with pytest.raises(ValueError, match='bfloat16'):
        th_attention.th_attention_q8(x17.float(), scale, bias, *codes, *mixes,
                                     8)
    with pytest.raises(RuntimeError, match='serving-only'):
        th_attention.th_attention_sublayer_q8(
            x17, scale, bias, ws[0].requires_grad_(), *ws[1:], *mixes, 8)


def test_cait_all_auto_raises_for_unbuilt_heads(card):
    """'all' under 'auto' on the card: cait_xs (H = 6, D = 288) at depth 1
    runs K11 and K12, one launch each; a head count the TH kernels are not
    built for (12 heads of 48) raises rather than run anything unasked."""
    from sav_tpu_torch import _build
    from sav_tpu_torch.models import create_model
    model = create_model('cait_xs_24', num_layers=1, num_layers_token_only=1,
                         quantized='all', dtype=torch.bfloat16,
                         device=card).eval()
    x = torch.zeros(1, 224, 224, 3, device=card, dtype=torch.bfloat16)
    _build.reset_launches()
    with torch.no_grad():
        logits = model(x)
    assert _build.launches == {'th_attention_q8': 1, 'int8_ff': 1}
    assert bool(torch.isfinite(logits).all())
    model = create_model('cait_xs_24', num_layers=1, num_layers_token_only=1,
                         embed_dim=576, num_heads=12, quantized='all',
                         dtype=torch.bfloat16, device=card).eval()
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match='12 heads of 48'):
            model(x)


@pytest.mark.parametrize('name', ['cait_xs_24', 'cait_xs_36'])
@pytest.mark.parametrize('quantized,want', [
    (False, {'th_attention_fwd': 1}),
    ('ff', {'th_attention_fwd': 1, 'int8_ff': 1}),
    ('ff_sb', {'th_attention_fwd': 1, 'int8_ff': 1}),
    ('all', {'th_attention_q8': 1, 'int8_ff': 1})])
def test_cait_xs_runs_every_mode_on_the_kernels(card, name, quantized, want):
    """Both cait_xs names at depth 1 on 'auto': a forward launches the H = 6
    and D = 288 kernels and nothing per-op unasked, and (but under 'all',
    serving only) one gradient step launches K5a-train and K5b, with K12's
    training variant and, under 'ff_sb', K14; logits within 5e-2 of max
    |logit| of the same model on the plain cores."""
    from sav_tpu_torch import _build
    from sav_tpu_torch.models import create_model, set_int8_core, set_use_kernel
    model = create_model(name, num_layers=1, num_layers_token_only=1,
                         stoch_depth_rate=0.0, quantized=quantized,
                         dtype=torch.bfloat16, device=card, seed=3)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 224, 224, 3, generator=gen).to(card).bfloat16()
    model.eval()
    _build.reset_launches()
    with torch.no_grad():
        logits = model(x).float()
    assert _build.launches == want
    set_use_kernel(model, 'fused_th_xla')
    set_int8_core(model, 'plain')
    with torch.no_grad():
        plain = model(x).float()
    assert bool(torch.isfinite(logits).all())
    assert (logits - plain).abs().max() <= 5e-2 * plain.abs().max()
    if quantized == 'all':
        return
    set_use_kernel(model, 'auto')
    set_int8_core(model, 'kernel')
    model.train()
    _build.reset_launches()
    model(x).float().square().mean().backward()
    step = {'th_attention_fwd_train': 1, 'th_attention_bwd': 1}
    if quantized:
        step['int8_ff_train'] = 1
    if quantized == 'ff_sb':
        step['int8_ff_dx'] = 1
    assert _build.launches == step
    assert all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters() if p.grad is not None)


def test_ragged_columns_match_the_twins_on_their_own(card):
    """At H*48 = D = 288 the last 32 columns of every band and output sit in
    a half box or a 32-wide last tile: K6a's attn, K6b's dq, dk and dv,
    K11's out, K12's and K13's out, K14's dy2, each compared on its columns
    256-287 alone against the twin (the whole outputs are held elsewhere;
    here a dropped or zero last half tile cannot hide in a max over the
    rest), at ragged lengths and rows."""
    from sav_tpu_torch.ops import int8_ff
    rng = np.random.RandomState(288)
    tail = lambda t: t[..., 256:]
    q, k, v, do, m = _th_core_case(rng, 2, 197, 6, card)
    attn, lse = th_attention.th_core_fwd(q, k, v, *m, 6)
    p_attn, p_lse = th_attention.th_core_fwd_plain(q, k, v, *m, 6)
    assert _rel(tail(attn), tail(p_attn)) <= 2e-2
    assert (lse - p_lse).abs().max() <= 1e-3
    grads = th_attention.th_core_bwd(q, k, v, do, p_lse, *m, 6)
    twin = th_attention.th_core_bwd_plain(q, k, v, do, p_lse, *m, 6)
    for g, t in zip(grads[:3], twin[:3]):
        assert _rel(tail(g), tail(t)) <= 2e-2
    x, scale, bias, ws, mixes = _k11_case(rng, 3, 197, 288, 6, card)
    flat = [t for pair in fused_layer._q8_weights(*ws, 288, 288)
            for t in pair]
    with torch.no_grad():
        got = th_attention.th_attention_q8(x, scale, bias, *flat, *mixes, 6)
        want = th_attention.th_q8_reference(x, scale, bias, *flat, *mixes, 6)
    _int8_check(tail(got), tail(want))
    xf, ln, w = _ff_case(rng, 1003, 288, 1152, card)
    for lnp in (None, ln):
        for save_hpre in (False, True):
            got, want = _ff_pair(xf, lnp, w, save_hpre)
            if save_hpre:
                got, want = got[0], want[0]
            _int8_check(tail(got), tail(want),
                        None if lnp is None else tail(xf))
    g, hpre, wd = _k14_case(rng, 1003, 288, 1152, card)
    dy2, dh = int8_ff.int8_ff_dx_raw(g, hpre, *wd)
    want = int8_ff.int8_ff_dx_reference(g, hpre, *wd)
    _int8_check(tail(dy2), tail(want[0]))
    _int8_check(dh, want[1])


def _k14_case(rng, m, d, f, card):
    from sav_tpu_torch.ops import int8_ff
    w = lambda shape, std: torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32)).to(card)
    g = _bf16(rng, (m, d), 0.02, card)
    hpre = _bf16(rng, (m, f), 1.0, card)
    return g, hpre, (*int8_ff._dx_quantized(w((d, f), 1 / math.sqrt(d))),
                     *int8_ff._dx_quantized(w((f, d), 1 / math.sqrt(f))))


@pytest.mark.parametrize('m,d,f', [(1, 768, 3072), (50, 128, 512),
                                   (1003, 768, 3072), (130, 1024, 4096),
                                   (200, 384, 1536), (1003, 288, 1152),
                                   (77, 224, 800)])
def test_int8_ff_dx_matches_twin(card, m, d, f):
    """K14 at ragged M (48-row bands) and at a width whose band is 16 rows
    (D = 1024, F = 4096): dy2 and dh."""
    from sav_tpu_torch.ops import int8_ff
    g, hpre, w = _k14_case(np.random.RandomState(m + d), m, d, f, card)
    dy2, dh = int8_ff.int8_ff_dx_raw(g, hpre, *w)
    want = int8_ff.int8_ff_dx_reference(g, hpre, *w)
    assert dy2.shape == (m, d) and dh.shape == (m, f)
    _int8_check(dy2, want[0])
    _int8_check(dh, want[1])


def test_int8_ff_dx_writes_no_row_past_m(card):
    from sav_tpu_torch.ops import int8_ff
    m, d, f = 1003, 768, 3072
    g, hpre, (w1t_q, s1t, w2t_q, s2t) = _k14_case(np.random.RandomState(7), m,
                                                  d, f, card)
    dy = torch.full((m + 64, d), float('nan'), device=card,
                    dtype=torch.bfloat16)
    dh = torch.full((m + 64, f), float('nan'), device=card,
                    dtype=torch.bfloat16)
    # the C entry into the first M rows (it raises on a failed launch)
    int8_ff._int8_dx_into(g, hpre, w1t_q, s1t, w2t_q, s2t, dy[:m], dh[:m])
    torch.cuda.synchronize()
    want = int8_ff.int8_ff_dx_reference(g, hpre, w1t_q, s1t, w2t_q, s2t)
    _int8_check(dy[:m], want[0])
    _int8_check(dh[:m], want[1])
    assert bool(torch.isnan(dy[m:]).all() and torch.isnan(dh[m:]).all())


@pytest.mark.parametrize('sublayer', [True, False])
def test_switchback_gradients_match_plain_core(card, sublayer):
    """int8_ff_sublayer_sb (K13 + K14) and int8_ff(switchback=True) (K12 +
    K14) against the same Functions on the twins: every gradient within
    2e-2 of max, as the other int8 checks."""
    from sav_tpu_torch import _build
    from sav_tpu_torch.ops import int8_ff
    rng = np.random.RandomState(11)
    d, f = 768, 3072
    x = _bf16(rng, (2, 197, d), 1.0, card)
    w = lambda shape, std: torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32)).to(card)
    params = ([1.0 + w((d,), 0.1), w((d,), 0.1)] if sublayer else []) + [
        w((d, f), 1 / math.sqrt(d)), w((f,), 0.1), w((f, d), 1 / math.sqrt(f)),
        w((d,), 0.1)]
    if not sublayer:
        params = [params[0].bfloat16(), params[1], params[2].bfloat16(),
                  params[3]]
    g = _bf16(rng, (2, 197, d), 0.02, card)
    grads = []
    for core in ('kernel', 'plain'):
        leaves = [x.clone().requires_grad_()] + [
            p.clone().requires_grad_() for p in params]
        _build.reset_launches()
        if sublayer:
            out = int8_ff.int8_ff_sublayer_sb(*leaves, core=core)
        else:
            out = int8_ff.int8_ff(*leaves, switchback=True, core=core)
        out.backward(g)
        if core == 'kernel':
            fwd = 'int8_ff_ln_train' if sublayer else 'int8_ff_train'
            assert _build.launches == {fwd: 1, 'int8_ff_dx': 1}
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all())
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert err <= 2e-2, err


def test_int8_ff_dx_refuses(card):
    from sav_tpu_torch.ops import int8_ff
    g, hpre, w = _k14_case(np.random.RandomState(2), 64, 128, 512, card)
    with pytest.raises(ValueError, match='bfloat16'):
        int8_ff.int8_ff_dx_raw(g.float(), hpre, *w)
    with pytest.raises(ValueError, match='rows'):
        int8_ff.int8_ff_dx_raw(g, hpre[:32].contiguous(), *w)
    with pytest.raises(ValueError, match='multiples of 32'):
        int8_ff.int8_ff_dx_raw(g[:, :80].contiguous(), hpre, w[0][:, :80],
                               w[1][:, :80], w[2][:80], w[3])
    with pytest.raises(RuntimeError, match='forward-only'):
        int8_ff.int8_ff_dx_raw(g.clone().requires_grad_(), hpre, *w)


# ---- the Hopper K8b (csrc/mixer_bwd_sm90.cuh) and K14 (csrc/int8_dx_sm90.cuh)

@pytest.mark.parametrize('batch,l,k,d', [(192, 196, 98, 768), (192, 49, 24, 512),
                                         (5, 13, 6, 128)])
def test_token_mix_bwd_at_mixer_widths(card, batch, l, k, d):
    """K8b on its Hopper route at Mixer-B/16 bs192, Mixer-S/32's widths and
    a small ragged shape: dx within 2e-2, the six others within WGRAD_TOL
    of max, two calls identical."""
    from sav_tpu_torch.ops import mixer_token
    assert mixer_token.mixer_bwd_plan(batch, l, k, d)['route'] != 0
    rng = np.random.RandomState(batch + l)
    args = _k8_args(rng, batch, l, k, d, card)
    g = _bf16(rng, (batch, l, d), 1, card)
    grads = mixer_token.token_mix_bwd(*args, g)
    again = mixer_token.token_mix_bwd(*args, g)
    twin = mixer_token.token_mix_bwd_plain(*args, g)
    assert _rel(grads[0], twin[0]) <= 2e-2
    assert max(_rel(a, b) for a, b in zip(grads[1:], twin[1:])) <= WGRAD_TOL
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize('m,d,f', [(37824, 768, 3072), (25088, 384, 1536),
                                   (1003, 768, 3072), (129, 768, 3072),
                                   (1, 768, 3072), (25088, 288, 1152)])
def test_int8_ff_dx_at_path_widths(card, m, d, f):
    """K14 at ViT-B/16 @224 bs192's and CaiT-S/24 @224 bs128's FF rows and
    ragged counts: dy2 and dh against the twin, two calls identical."""
    from sav_tpu_torch.ops import int8_ff
    g, hpre, w = _k14_case(np.random.RandomState(m), m, d, f, card)
    got = int8_ff.int8_ff_dx_raw(g, hpre, *w)
    again = int8_ff.int8_ff_dx_raw(g, hpre, *w)
    want = int8_ff.int8_ff_dx_reference(g, hpre, *w)
    _int8_check(got[0], want[0])
    _int8_check(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_k8b_and_k14_repeat_bitwise_over_queued_calls(card):
    """50 calls of each queued without a synchronize between them (a
    deadlock in a ring or a staging tile shows as a launch failure) all
    give the first call's bits."""
    from sav_tpu_torch.ops import int8_ff, mixer_token
    rng = np.random.RandomState(9)
    args = _k8_args(rng, 24, 196, 98, 768, card)
    g8 = _bf16(rng, (24, 196, 768), 1, card)
    first8 = mixer_token.token_mix_bwd(*args, g8)
    g, hpre, w = _k14_case(rng, 4 * 197, 768, 3072, card)
    first14 = int8_ff.int8_ff_dx_raw(g, hpre, *w)
    for _ in range(5):
        outs8 = [mixer_token.token_mix_bwd(*args, g8) for _ in range(10)]
        outs14 = [int8_ff.int8_ff_dx_raw(g, hpre, *w) for _ in range(10)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for o in outs8 for a, b in zip(o, first8))
        assert all(torch.equal(a, b) for o in outs14
                   for a, b in zip(o, first14))


def test_mixer_bwd_plan_matches_the_kernel(card):
    """mixer_bwd_plan mirrors sav_mixer_bwd_plan on this card's SM count,
    on both routes."""
    import ctypes
    from sav_tpu_torch.ops import mixer_token
    fn = mixer_token._fn('sav_mixer_bwd_plan', 0, 5)
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for b, l, k, d in ((192, 196, 98, 768), (65, 196, 98, 768),
                       (1, 196, 98, 768), (192, 49, 24, 512),
                       (5, 13, 6, 128), (2, 208, 16, 128),
                       (3, 196, 98, 1152)):
        out = (ctypes.c_longlong * 10)()
        assert fn(b, l, k, d, sms, out) == 0
        plan = mixer_token.mixer_bwd_plan(b, l, k, d, sms)
        assert list(out) == [plan['route'], *plan['widths'], plan['units'],
                             plan['ctas'], plan['units_per_wg'], plan['smem'],
                             plan['chunks'], plan['per_chunk'],
                             plan['workspace']]
        assert plan['workspace'] == mixer_token._fn(
            'sav_mixer_bwd_workspace', 0, 4,
            restype=ctypes.c_longlong)(b, l, k, d)


def test_mixer_fwd_plan_matches_the_kernel(card):
    """mixer_fwd_plan mirrors sav_mixer_fwd_plan on this card's SM count,
    on all three routes."""
    import ctypes
    from sav_tpu_torch.ops import mixer_token
    fn = mixer_token._fn('sav_mixer_fwd_plan', 0, 5)
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for b, l, k, d in ((192, 196, 98, 768), (32, 196, 98, 768),
                       (65, 196, 98, 768), (1, 196, 98, 1024),
                       (192, 49, 24, 512), (5, 13, 6, 128), (2, 208, 16, 128),
                       (3, 196, 98, 1152)):
        out = (ctypes.c_longlong * 7)()
        assert fn(b, l, k, d, sms, out) == 0
        plan = mixer_token.mixer_fwd_plan(b, l, k, d, sms)
        assert list(out) == [plan['route'], *plan['widths'], plan['units'],
                             plan['ctas'], plan['units_per_wg'], plan['smem']]


@pytest.mark.parametrize('batch,l,k,d,route', [(65, 196, 98, 768, 2),
                                               (33, 196, 98, 1024, 2),
                                               (133, 13, 6, 128, 1),
                                               (7, 49, 24, 512, 1),
                                               (2, 208, 16, 128, 0)])
def test_token_mix_fwd_routes_match_twin(card, batch, l, k, d, route):
    """K8a on each route, the Hopper band kernel's at a batch whose units do
    not fill its warpgroups evenly; out into a NaN-sentinel buffer longer
    than B x L rows, whose rows past it keep the sentinel."""
    from sav_tpu_torch.ops import mixer_token
    assert mixer_token.mixer_fwd_plan(batch, l, k, d)['route'] == route
    args = _k8_args(np.random.RandomState(batch + l), batch, l, k, d, card)
    out = torch.full((batch * l + 64, d), float('nan'), device=card,
                     dtype=torch.bfloat16)
    stats = torch.empty(batch * l, 2, device=card)
    ptr = lambda t: t.data_ptr()
    fn = mixer_token._fn('sav_mixer_fwd', 9, 4, 1)
    assert fn(*map(ptr, args), ptr(stats), ptr(out), batch, l, k, d,
              fused_layer.LN_EPS, flash_attention.stream_of(card)) == 0
    plain = mixer_token.token_mix_fwd_plain(*args)
    x = args[0]
    got = out[:batch * l].view(batch, l, d)
    assert _rel(got.float() - x.float(), plain.float() - x.float()) <= 2e-2
    assert torch.isnan(out[batch * l:]).all()


def test_tnt_bwd_plan_matches_the_kernel(card):
    """tnt_bwd_plan mirrors sav_tnt_bwd_plan on this card's SM count, and
    the workspace is the one sav_tnt_bwd_workspace asks for."""
    import ctypes
    from sav_tpu_torch.ops import tnt_inner
    fn = tnt_inner._fn('sav_tnt_bwd_plan', 0, 5)
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for n, d, f, h in ((64 * 196, 24, 96, 4), (32 * 196, 40, 160, 4),
                       (1, 24, 96, 4), (1001, 16, 64, 2), (37, 32, 128, 4),
                       (5, 48, 192, 4)):
        out = (ctypes.c_longlong * 7)()
        assert fn(n, d, f, h, sms, out) == 0
        plan = tnt_inner.tnt_bwd_plan(n, d, f, h, sms)
        assert list(out) == [plan['warps'], plan['blocks'], plan['smem'],
                             plan['part_floats'], plan['workspace'],
                             plan['warp_bytes'], int(plan['tiled'])]
        assert plan['workspace'] == tnt_inner._fn(
            'sav_tnt_bwd_workspace', 0, 4,
            restype=ctypes.c_longlong)(n, d, f, h)


def test_int8_dx_plan_matches_the_kernel(card):
    """int8_dx_plan mirrors sav_int8_ff_dx_plan."""
    import ctypes
    from sav_tpu_torch.ops import int8_ff
    fn = int8_ff._ff_lib('sav_int8_ff_dx_plan')
    for m, d, f in ((37824, 768, 3072), (25088, 384, 1536), (1003, 768, 3072),
                    (1, 768, 3072), (77, 320, 704), (25088, 288, 1152),
                    (77, 96, 160)):
        out = (ctypes.c_longlong * 10)()
        assert fn(m, d, f, out) == 0
        plan = int8_ff.int8_dx_plan(m, d, f)
        assert list(out) == [plan['row_tiles'], plan['col_tiles']['dh'],
                             plan['col_tiles']['dy'], plan['units']['absmax'],
                             plan['units']['dy'], plan['stages']['dh'],
                             plan['stages']['dy'], plan['parts'], plan['smem'],
                             plan['workspace']]
    assert fn(16, 80, 3072, (ctypes.c_longlong * 10)()) != 0


def _ff_pair(x, ln, w, save_hpre):
    """K12's (``ln`` None) or K13's kernel outputs and its twin's."""
    from sav_tpu_torch.ops import int8_ff
    if ln is None:
        return (int8_ff.int8_ff_raw(x, *w, save_hpre=save_hpre),
                int8_ff.int8_ff_reference(x, *w, save_hpre=save_hpre))
    return (int8_ff.int8_ff_ln_raw(x, *ln, *w, save_hpre=save_hpre),
            int8_ff.int8_ff_ln_reference(x, *ln, *w, save_hpre=save_hpre))


# K12's and K13's path shapes: ViT-B/16 @224 bs192 and bs32 (K13), Mixer-B/16
# bs192 and bs32 (K12), CaiT-S/24 bs128 and bs32 (K12)
FF_PATH_SHAPES = [(192 * 197, 768, 3072), (32 * 197, 768, 3072),
                  (192 * 196, 768, 3072), (32 * 196, 768, 3072),
                  (128 * 196, 384, 1536), (32 * 196, 384, 1536),
                  (128 * 196, 288, 1152), (32 * 196, 288, 1152)]


@pytest.mark.parametrize('m,d,f', FF_PATH_SHAPES)
def test_int8_ff_at_path_widths(card, m, d, f):
    """K12 and K13, serving and save_hpre, at the paths' rows and widths:
    out (and hpre) against the twins."""
    x, ln, w = _ff_case(np.random.RandomState(m + d), m, d, f, card)
    for lnp in (None, ln):
        for save_hpre in (False, True):
            got, want = _ff_pair(x, lnp, w, save_hpre)
            if save_hpre:
                _int8_check(got[1], want[1])
                got, want = got[0], want[0]
            _int8_check(got, want, None if lnp is None else x)


def test_int8_ff_repeats_bitwise_over_queued_calls(card):
    """50 calls each of K12 and K13 (save_hpre) queued without a
    synchronize between them (a deadlock in a ring, a turn or a staging
    tile shows as a launch failure) all give the first call's bits."""
    from sav_tpu_torch.ops import int8_ff
    x, ln, w = _ff_case(np.random.RandomState(11), 4 * 197, 768, 3072, card)
    calls = (lambda: int8_ff.int8_ff_raw(x, *w, save_hpre=True),
             lambda: int8_ff.int8_ff_ln_raw(x, *ln, *w, save_hpre=True))
    for call in calls:
        first = call()
        for _ in range(5):
            outs = [call() for _ in range(10)]
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for o in outs
                       for a, b in zip(o, first))


def test_int8_ff_plan_matches_the_kernel(card):
    """int8_ff_plan mirrors sav_int8_ff_plan."""
    import ctypes
    from sav_tpu_torch.ops import int8_ff
    fn = int8_ff._ff_lib('sav_int8_ff_plan')
    for m, d, f in ((37824, 768, 3072), (37632, 768, 3072),
                    (25088, 384, 1536), (6304, 768, 3072), (1003, 768, 3072),
                    (1, 768, 3072), (77, 192, 768), (130, 1024, 4096),
                    (100, 2048, 512), (6272, 288, 1152), (25088, 288, 1152),
                    (77, 96, 160), (77, 224, 800)):
        out = (ctypes.c_longlong * 12)()
        assert fn(m, d, f, out) == 0
        plan = int8_ff.int8_ff_plan(m, d, f)
        assert list(out) == [plan['row_tiles'], plan['col_tiles']['hidden'],
                             plan['col_tiles']['out'],
                             plan['units']['absmax'], plan['units']['out'],
                             plan['stages']['hidden'], plan['stages']['out'],
                             plan['parts'], plan['smem'], plan['workspace'],
                             int(plan['out_pairs']), plan['transposes']]
    assert fn(16, 80, 3072, (ctypes.c_longlong * 12)()) != 0
    assert fn(0, 768, 3072, (ctypes.c_longlong * 12)()) != 0


@pytest.mark.parametrize('m,d,f', [(1003, 768, 3072), (1003, 384, 1536),
                                   (1, 192, 768), (333, 2048, 512),
                                   (1003, 288, 1152), (77, 224, 800)])
def test_int8_ff_writes_no_row_past_m(card, m, d, f):
    """K12 and K13, with and without hpre, through ``_int8_ff_into`` into
    NaN-sentinel buffers 64 rows longer: the rows in range match the twins,
    the rows past M keep the sentinel (D = 2048: wider than any factory
    model, which the earlier band kernel took too)."""
    from sav_tpu_torch.ops import int8_ff
    nan = lambda rows, w: torch.full((rows + 64, w), float('nan'), device=card,
                                     dtype=torch.bfloat16)
    x, ln, w = _ff_case(np.random.RandomState(m + f), m, d, f, card)
    for lnp in (None, ln):
        for save_hpre in (False, True):
            out, hpre = nan(m, d), nan(m, f)
            int8_ff._int8_ff_into(x, lnp, *w, 1e-6, out[:m],
                                  hpre[:m] if save_hpre else None)
            torch.cuda.synchronize()
            want = _ff_pair(x, lnp, w, True)[1]
            _int8_check(out[:m], want[0], None if lnp is None else x)
            if save_hpre:
                _int8_check(hpre[:m], want[1])
            assert bool(torch.isnan(out[m:]).all())
            assert bool(torch.isnan(hpre).all() if not save_hpre
                        else torch.isnan(hpre[m:]).all())


# ---- K11 and K15 on s8 wgmma + TMA (q8_gemm_sm90.cuh; K11's codes in
# K6a's core)

def test_int8_matmul_plan_matches_the_kernel(card):
    """int8_matmul_plan mirrors sav_int8_matmul_plan."""
    import ctypes
    from sav_tpu_torch import _build
    from sav_tpu_torch.ops import int8_matmul_kernel as k15
    fn = _build.library('int8_matmul').sav_int8_matmul_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for m, k, n in ((6304, 768, 3072), (6304, 3072, 768), (6272, 768, 3072),
                    (1003, 700, 256), (1, 300, 64), (40, 300, 100)):
        out = (ctypes.c_longlong * 12)()
        assert fn(m, k, n, out) == 0
        p = k15.int8_matmul_plan(m, k, n)
        assert list(out) == [p['row_tiles'], p['col_tiles'], p['units'],
                             p['k_blocks'], p['slots'], p['ldk'], p['ldo'],
                             p['smem'], p['workspace'], p['scratch']['bt'][0],
                             p['scratch']['aq'][0], p['scratch']['as'][0]]
    assert fn(16, 768, 255, (ctypes.c_longlong * 12)()) != 0
    assert fn(0, 768, 256, (ctypes.c_longlong * 12)()) != 0


def test_th_q8_plan_matches_the_kernel(card):
    """th_q8_plan mirrors sav_th_q8_plan."""
    import ctypes
    from sav_tpu_torch import _build
    fn = _build.library('th_attention_q8').sav_th_q8_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for b, l, d, h in ((32, 196, 384, 8), (32, 196, 192, 4), (3, 250, 384, 8),
                       (2, 17, 128, 8), (1, 1, 768, 4), (32, 196, 768, 16),
                       (3, 250, 768, 16), (32, 196, 288, 6), (3, 197, 288, 6),
                       (2, 17, 96, 6)):
        out = (ctypes.c_longlong * 21)()
        assert fn(b, l, d, h, out) == 0
        p = th_attention.th_q8_plan(b, l, d, h)
        assert list(out) == (
            [p['tile']['qkv'], p['tile']['out'], p['row_tiles'],
             p['units']['qkv'], p['units']['out'], p['slots']['qkv'],
             p['slots']['out'], p['smem']['qkv'], p['smem']['out'],
             p['smem']['core'], p['core_tiles'], p['workspace']]
            + [p['scratch'][r][0] for r in th_attention.Q8_REGIONS])
    assert fn(2, 17, 80, 8, (ctypes.c_longlong * 21)()) != 0
    assert fn(2, 17, 384, 10, (ctypes.c_longlong * 21)()) != 0


@pytest.mark.parametrize('b,seq,dim,heads', [(2, 197, 768, 16),
                                            (3, 250, 768, 16),
                                            (2, 197, 384, 8),
                                            (2, 197, 288, 6)])
def test_k11_codes_match_the_quantiser_on_k6a_bands(card, b, seq, dim, heads):
    """K11's core takes the bands' codes in its store (at H = 16 over two
    passes of 8 heads, the row absmax combined first): the codes and row
    scales it leaves in the workspace equal, bit for bit, the twin's
    quantiser on the bands K6a's kernel computes from the same q, k, v."""
    from sav_tpu_torch.ops.int8_matmul_kernel import _quantize_tile
    x, scale, bias, ws, mixes = _k11_case(np.random.RandomState(seq), b, seq,
                                          dim, heads, card)
    hd, m = heads * 48, b * seq
    codes = fused_layer._q8_weights(*ws, dim, hd)
    plan = th_attention.th_q8_plan(b, seq, dim, heads)
    work = torch.empty(plan['workspace'], dtype=torch.uint8, device=card)
    vec = lambda t, n: t.reshape(n).float().contiguous()
    out = torch.empty_like(x)
    bufs = [x, vec(scale, dim), vec(bias, dim),
            *[c.contiguous() for c, _ in codes],
            *[vec(s, n) for (_, s), n in zip(codes, (hd, hd, hd, dim))],
            th_attention._mix_bank(*mixes, heads, card), work, out]
    assert th_attention._k11_lib()(
        *[t.data_ptr() for t in bufs], b, seq, dim, heads, 0,
        fused_layer.LN_EPS, 48 ** -0.5, flash_attention.stream_of(card)) == 0
    torch.cuda.synchronize()

    def region(name, dtype, shape):
        at, nbytes = plan['scratch'][name]
        return work[at:at + nbytes].view(dtype).view(shape)

    q, k, v = (region(n, torch.bfloat16, (b, seq, hd)) for n in 'qkv')
    attn, _ = th_attention.th_core_fwd(q, k, v, *mixes, heads)
    want_codes, want_scales = _quantize_tile(attn.reshape(m, hd))
    assert torch.equal(region('aq', torch.int8, (m, hd)), want_codes)
    assert torch.equal(region('as', torch.float32, (m,)),
                       want_scales.reshape(m))


def test_quantizer_matches_the_division(card):
    """q8::quantize_exact (K11's band codes, K15's a codes) gives the IEEE
    division's code for every bf16 value against every bf16 row absmax
    (sav_q8_quantizer_check: ~2.1e9 pairs), where the product with the
    reciprocal alone would differ: the count of the second is the check's
    own test that it reaches the ties."""
    import ctypes
    from sav_tpu_torch import _build
    fn = _build.library('int8_matmul').sav_q8_quantizer_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    counts = torch.zeros(2, dtype=torch.int64, device=card)
    assert fn(counts.data_ptr(), flash_attention.stream_of(card)) == 0
    torch.cuda.synchronize()
    exact, naive = counts.tolist()
    assert exact == 0 and naive > 0, (exact, naive)


@pytest.mark.parametrize('seq,dim,heads', [(197, 384, 8), (250, 384, 8),
                                           (197, 192, 4), (1, 192, 4),
                                           (197, 768, 16), (1, 768, 16),
                                           (197, 288, 6), (1, 288, 6)])
def test_th_attention_q8_writes_no_row_past_the_length(card, seq, dim,
                                                       heads):
    """K11 through ``_th_q8_into`` into a NaN-sentinel buffer 64 rows
    longer at B = 3: the rows in range match the twin, the rows past B*L
    keep the sentinel."""
    x, scale, bias, ws, mixes = _k11_case(np.random.RandomState(seq + dim), 3,
                                          seq, dim, heads, card)
    hd = heads * 48
    codes = fused_layer._q8_weights(*ws, dim, hd)
    rows = 3 * seq
    out = torch.full((rows + 64, dim), float('nan'), device=card,
                     dtype=torch.bfloat16)
    th_attention._th_q8_into(x, scale, bias, [c for c, _ in codes],
                             [s for _, s in codes], *mixes, heads,
                             fused_layer.LN_EPS, False, out[:rows])
    torch.cuda.synchronize()
    with torch.no_grad():
        want = th_attention.th_q8_reference(
            x, scale, bias, *[t for pair in codes for t in pair], *mixes,
            heads)
    _int8_check(out[:rows], want.reshape(rows, dim))
    assert bool(torch.isnan(out[rows:]).all())


def test_q8_kernels_repeat_bitwise_over_queued_calls(card):
    """50 calls each of K11 (CaiT-S/24 widths) and K15 (FF2) queued without
    a synchronize between them (a deadlock in a ring or a staging tile
    shows as a launch failure) all give the first call's bits."""
    from sav_tpu_torch.ops import int8_matmul_kernel as k15
    from sav_tpu_torch.ops.quantized import quantize_symmetric
    rng = np.random.RandomState(12)
    x, scale, bias, ws, mixes = _k11_case(rng, 4, 196, 384, 8, card)
    flat = [t for pair in fused_layer._q8_weights(*ws, 384, 384)
            for t in pair]
    a = _bf16(rng, (1003, 3072), 1.0, card)
    b_q, b_s = quantize_symmetric(_bf16(rng, (3072, 768), 1 / 55.4, card), 0)
    calls = (lambda: th_attention.th_attention_q8(x, scale, bias, *flat,
                                                  *mixes, 8),
             lambda: k15.int8_matmul_fused(a, b_q, b_s))
    with torch.no_grad():
        for call in calls:
            first = call()
            for _ in range(5):
                outs = [call() for _ in range(10)]
                torch.cuda.synchronize()
                assert all(torch.equal(o, first) for o in outs)


@pytest.mark.parametrize('name,quantized,dense_fused,want', [
    ('cait_s_24', 'all', False, {'th_attention_q8': 2, 'int8_ff': 2}),
    ('cait_xxs_24', 'all', False, {'th_attention_q8': 2, 'int8_ff': 2}),
    ('cait_xs_24', 'all', False, {'th_attention_q8': 2, 'int8_ff': 2}),
    ('vit_b_patch16', True, True, {'fused_attention_fwd': 2,
                                   'int8_matmul': 4}),
    ('vit_ti_patch16', 'all', False, {'flash_fwd': 2, 'int8_ff_ln': 2})])
def test_int8_serving_paths_at_depth_2(card, name, quantized, dense_fused,
                                       want):
    """CaiT-S/24 and cait_xxs_24 'all' (K11 + K12), ViT-B/16 'int8' with
    QuantizedDense(fused=True) (K1 + K15) and ViT-Ti/16 'all' (D = 192,
    which K1 takes and K10 does not: the bf16 sublayer on K4 + K13) at 224
    px, depth 2, batch 4: the launches of one forward, and logits within
    5e-2 of max |logit| of the same model on the int8 twins
    (set_int8_core)."""
    from sav_tpu_torch import _build
    from sav_tpu_torch.models import create_model, set_int8_core
    from sav_tpu_torch.nn.quantized_dense import QuantizedDense
    model = create_model(name, num_classes=1000, dtype=torch.bfloat16,
                         img_size=224, seed=3, device=card,
                         quantized=quantized, num_layers=2)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        head = model.Dense_0.kernel
        head.copy_(torch.randn(head.shape, generator=gen) / head.shape[0] ** 0.5)
        for pname, p in model.named_parameters():
            if pname.endswith('layerscale'):
                p.fill_(0.1)
    for sub in model.modules():
        if dense_fused and isinstance(sub, QuantizedDense):
            sub.fused = True
    model.eval()
    x = _bf16(np.random.RandomState(5), (4, 224, 224, 3), 1.0, card)
    with torch.inference_mode():
        _build.reset_launches()
        logits = model(x).float()
        torch.cuda.synchronize()
        assert dict(_build.launches) == want
        set_int8_core(model, 'plain')
        plain = model(x).float()
    err = float((logits - plain).abs().max() / plain.abs().max())
    assert bool(torch.isfinite(logits).all()) and err <= 5e-2, err


# ---- CeiT (slice 9): K1's post-LN route (pre_ln=False: no LN launch, the
# QKV GEMM reads x) and the projection GEMM's 192-wide outputs

def _k1_inputs(rng, b, seq, dim, heads, card):
    x = _bf16(rng, (b, seq, dim), 1, card)
    scale = (1 + _bf16(rng, (dim,), 0.1, card)).float()
    bias = _bf16(rng, (dim,), 0.1, card).float()
    hd = heads * 64
    wq, wk, wv = (_bf16(rng, (dim, hd), s / math.sqrt(dim), card)
                  for s in (4, 1, 1))
    wo = _bf16(rng, (hd, dim), 1 / math.sqrt(hd), card)
    return x, scale, bias, wq, wk, wv, wo, heads


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('pre_ln', [False, True])
@pytest.mark.parametrize('dim,heads,b,seq', [(384, 6, 2, 197), (192, 3, 3, 65),
                                             (256, 4, 1, 5)])
def test_fused_attention_routes_match_twin(card, dim, heads, b, seq, pre_ln,
                                           train):
    """K1 with and without its LN, both variants, at CeiT-S's width, at
    D = 192 (the GEMM's 192-wide tile) and at a 5-row sequence; the
    post-LN route counts under its own names."""
    from sav_tpu_torch import _build
    rng = np.random.RandomState(dim + seq + 2 * pre_ln + train)
    args = _k1_inputs(rng, b, seq, dim, heads, card)
    x = args[0]
    _build.reset_launches()
    out = fused_layer.fused_attention_fwd(*args, save_residuals=train,
                                          pre_ln=pre_ln)
    plain = fused_layer.fused_attention_fwd_plain(
        *args, fused_layer.LN_EPS, save_residuals=train, pre_ln=pre_ln)
    name = 'fused_attention_fwd' + ('' if pre_ln else '_noln') + (
        '_train' if train else '')
    assert _build.launches == {name: 1}
    if train:
        (out, res), (plain, p_res) = out, plain
        for ours, twin in zip(res[:4], p_res[:4]):
            assert _rel(ours, twin) <= 2e-2
        split = lambda a: a.float().view(b, seq, heads, 64)
        own = torch.logsumexp(torch.einsum('bqhd,bkhd->bhqk', split(res[0]),
                                           split(res[1])), dim=-1)
        assert (res[4] - own).abs().max() <= 1e-3
    delta = (plain.float() - x.float()).abs().max()
    assert (out.float() - plain.float()).abs().max() <= 2e-2 * delta


def test_noln_route_reads_no_ln_parameters(card):
    """The post-LN route takes None for the LN's scale and bias."""
    args = list(_k1_inputs(np.random.RandomState(7), 2, 65, 384, 6, card))
    want = fused_layer.fused_attention_fwd(*args, pre_ln=False)
    args[1] = args[2] = None
    assert torch.equal(fused_layer.fused_attention_fwd(*args, pre_ln=False),
                       want)


def test_vit_b_k1_outputs_match_the_pinned_digests(card):
    """ViT-B/16's K1 outputs (pre-LN, both variants) bit-identical to the
    digests the 128-multiple GEMM gave before it took D = 192
    (scripts/k1_digest.py's K1_VITB_DIGESTS, which says when the pin
    goes)."""
    import chip_smoke
    mod = chip_smoke.k1_digest_module()
    assert mod.k1_digests(fused_layer) == mod.K1_VITB_DIGESTS


@pytest.mark.parametrize('use_kernel', ['auto', 'fused_layer_full'])
def test_ceit_launch_counts(card, use_kernel):
    """CeiT-S's widths at depth 2: every encoder block's attention sublayer
    on K1's post-LN route (2 launches a forward, no pre-LN one), 2 of its
    train variant + 2 K2 a training forward and backward; the LCA's one
    query on the 1-query path, and under use_kernel=True it raises."""
    from sav_tpu_torch import _build
    from sav_tpu_torch.models import create_model, set_use_kernel
    model = create_model('ceit_s', num_classes=10, dtype=torch.bfloat16,
                         img_size=224, seed=3, device=card, num_layers=2,
                         use_kernel=use_kernel)
    x = _bf16(np.random.RandomState(5), (2, 224, 224, 3), 1.0, card)
    model.eval()
    with torch.no_grad():
        _build.reset_launches()
        assert bool(torch.isfinite(model(x)).all())
        assert _build.launches == {'fused_attention_fwd_noln': 2}
    model.train()
    _build.reset_launches()
    model(x).float().sum().backward()
    torch.cuda.synchronize()
    assert _build.launches == {'fused_attention_fwd_noln_train': 2,
                               'flash_bwd_fused': 2}
    set_use_kernel(model, True)
    with pytest.raises(ValueError, match='one query'):
        with torch.no_grad():
            model.eval()(x)


# ---- CvT (slice 10): per-op attention on K4 + K3 at CvT's cross lengths

def _cvt(card, use_kernel, img_size=224):
    """cvt-13 at full width, stage sizes (1, 1, 2), bf16, its head and cls
    token filled (zero-initialised, they would make every logit 0)."""
    from sav_tpu_torch.models import create_model
    model = create_model('cvt-13', num_classes=10, dtype=torch.bfloat16,
                         img_size=img_size, seed=3, device=card,
                         stage_sizes=(1, 1, 2), use_kernel=use_kernel)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        head = model.Dense_0.kernel
        head.copy_(torch.randn(head.shape, generator=gen) / 384 ** 0.5)
        model.Stage_2.cls.copy_(torch.randn(model.Stage_2.cls.shape,
                                            generator=gen))
    return model


def test_cvt_logits_and_launch_counts(card):
    """cvt-13's stages at @224 (3136 over 784 keys in one head, 784 over
    196 in three, the padded 225 over 64 in six): under 'auto' every
    block's attention is one K4 launch a forward (4 at stage sizes
    (1, 1, 2)) and K4 + K3a + K3b a training step (no K2: every query
    length is past 208 rows), logits within 5e-2 of max |logit| of
    use_kernel=False on the same weights."""
    from sav_tpu_torch import _build
    from sav_tpu_torch.models import set_use_kernel
    model = _cvt(card, 'auto')
    x = _bf16(np.random.RandomState(5), (2, 224, 224, 3), 1.0, card)
    model.eval()
    with torch.no_grad():
        _build.reset_launches()
        logits = model(x).float()
        assert _build.launches == {'flash_fwd': 4}
        set_use_kernel(model, False)
        plain = model(x).float()
    err = _rel(logits, plain)
    assert bool(torch.isfinite(logits).all()) and err <= 5e-2, err
    set_use_kernel(model, 'auto')
    model.train()
    _build.reset_launches()
    model(x).float().sum().backward()
    torch.cuda.synchronize()
    assert _build.launches == {'flash_fwd': 4, 'flash_bwd_dq': 4,
                               'flash_bwd_dkv': 4}


def test_cvt_auto_refuses_what_k4_does_not_take(card):
    """At 32 px stage 3's query grid is 3 x 3 (below K4's 64-row floor):
    'auto' raises on the card, and use_kernel=False runs it per-op."""
    from sav_tpu_torch.models import set_use_kernel
    model = _cvt(card, 'auto', img_size=32).eval()
    x = _bf16(np.random.RandomState(6), (2, 32, 32, 3), 1.0, card)
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match='use_kernel=False'):
            model(x)
        set_use_kernel(model, False)
        assert bool(torch.isfinite(model(x)).all())


def test_trainer_resume_matches_a_straight_run(card, tmp_path, monkeypatch):
    """ViT-B/16 @224 bs32 at depth 2 through the Trainer with an EMA and a
    bf16 first moment: 4 steps straight equal 2 steps, a new Trainer on the
    same checkpoint directory that restores step 2, and 2 more, bit for bit
    (the losses of steps 3-4, every parameter, both moments, the EMA, count
    and step); each resumed step launches 2 K1-train + 2 K2."""
    import functools
    from sav_tpu_torch import _build
    from sav_tpu_torch.models import create_model
    from sav_tpu_torch.train import loop
    from sav_tpu_torch.utils.flax_bridge import flatten_tree
    monkeypatch.setattr(loop, 'create_model',
                        functools.partial(create_model, num_layers=2))

    class Record(loop.MetricLogger):
        def __init__(self):
            super().__init__()
            self.losses = {}

        def log(self, metrics, step):
            if 'loss' in metrics:
                self.losses[step] = float(metrics['loss'])

    def trainer(directory, total):
        t = loop.Trainer(loop.TrainConfig(
            model_name='vit_b_patch16', img_size=224, batch_size=32, seed=1,
            total_steps=total, images_per_epoch=32,
            checkpoint_every_epochs=2, eval_every_epochs=10**6,
            eval_batches=1, log_every=1, ema_decay=0.999,
            mu_dtype='bfloat16', checkpoint_dir=directory), device=card)
        t.logger = Record()
        return t

    straight = trainer(None, 4)
    straight.run()
    trainer(str(tmp_path), 2).run()
    resumed = trainer(str(tmp_path), 4)
    assert resumed.state.step == 2
    _build.reset_launches()
    resumed.run()
    torch.cuda.synchronize()
    assert _build.launches == {'fused_attention_fwd_train': 4,
                               'flash_bwd_fused': 4, 'fused_attention_fwd': 2}
    assert resumed.logger.losses == {k: v for k, v in
                                     straight.logger.losses.items() if k >= 2}
    want = flatten_tree(straight.state.state_tree())
    got = flatten_tree(resumed.state.state_tree())
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
