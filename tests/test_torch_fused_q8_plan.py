"""Torch port: the int8 attention sublayer's launch plan and its core's
order on the CPU (``csrc/fused_attention_q8.cu`` + ``csrc/q8_gemm_sm90.cuh``,
K10; the kernels run only on the card, ``tests/test_torch_cuda.py``).

* ``fused_q8_plan``, the Python mirror of the C entry ``sav_fused_q8_plan``,
  at the widths of ViT-S, ViT-B and ViT-L (ViT-Ti's H*64 = 192 is not
  K10's) and L = 1, 50, 197, 577: every launch's shared memory fits a
  block, the workspace regions lie apart at 256-byte offsets, the GEMMs'
  units cover every row and column of each output once, and the core's
  64-row units cover each image's rows.
* ``k10_blocked``, a test-only torch mirror of the core's order: each
  row's final max over the key tiles first (sweep 1), p = exp(s - m) per
  64-key tile against that max and rounded to bf16, the p V products and
  the row sums taken tile by tile in f32, the rows divided by their sums
  and rounded to bf16 into a 64-row staging tile, each row's codes over
  its H*64 staged values (scale = max(absmax, 1e-8) / 127 by IEEE
  division). Held against the JAX ``attention_sublayer_q8`` (its kernel in
  interpret mode) at B = 2, L = 20, D = 128, H = 2, as
  ``tests/test_torch_int8_attention.py`` holds the twin: at least
  KERNEL_SHARE of the bf16 outputs identical, the rest within 1e-2 of max
  |out - x| (XLA compiles the JAX kernel as one fused body, so an
  activation a hair from a .5 code boundary may take the other code).
  Its bands' codes and scales are equal to those the port's twin takes of
  its own bands, and its output to the twin's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import fused_layer as jfl
from sav_tpu_torch.ops import fused_layer as tfl
from sav_tpu_torch.ops.int8_matmul_kernel import _quantize_tile
from sav_tpu_torch.ops.quantized import int_matmul
from test_torch_quantized import KERNEL_SHARE, _np, _pair
import torch_parity  # noqa: F401  (pins torch to one thread)

SMEM_LIMIT = 232448
SMS = 132
WIDTHS = [(384, 6), (768, 12), (1024, 16)]        # ViT-S, ViT-B, ViT-L
LENGTHS = [1, 50, 197, 577]
TOL = 1e-2


def _cdiv(a, b):
    return -(-a // b)


def _units_of_blocks(units, sms=SMS):
    grid = min(units, sms)
    return [u for i in range(grid) for u in range(i, units, grid)]


@pytest.mark.parametrize('dim,heads', WIDTHS)
@pytest.mark.parametrize('l', LENGTHS)
def test_plan_fits_and_covers_each_output_once(l, dim, heads):
    b = 3
    plan = tfl.fused_q8_plan(b, l, dim, heads)
    m, hd = b * l, heads * 64
    rows = plan['row_tiles']
    assert (rows - 1) * tfl.Q8_ROWS < m <= rows * tfl.Q8_ROWS
    for what in ('qkv', 'out', 'core'):
        assert 0 < plan['smem'][what] <= SMEM_LIMIT
    for what, width, parts in (('qkv', hd, 3), ('out', dim, 1)):
        tile = plan['tile'][what]
        assert width % tile == 0                 # no partial tile
        nt = parts * width // tile
        assert plan['units'][what] == rows * nt
        taken = _units_of_blocks(plan['units'][what])
        assert sorted(taken) == list(range(plan['units'][what]))
        covered = np.zeros((parts, rows * tfl.Q8_ROWS, width), np.int32)
        for u in taken:
            r, c0 = u // nt, (u % nt) * tile     # column tiles fastest
            which, col0 = c0 // width, c0 % width
            assert col0 + tile <= width          # never two outputs
            covered[which, r * tfl.Q8_ROWS:(r + 1) * tfl.Q8_ROWS,
                    col0:col0 + tile] += 1
        assert (covered[:, :m] == 1).all()
    # the GEMMs contract over D and H*64 in 128-code slots
    assert plan['slots']['qkv'] == dim // 128 and plan['slots']['out'] == hd // 128
    # the core: 64-row units of one image, the heads in turn over three
    # warpgroups, two to four K/V slots each
    units = plan['units']['core']
    assert units == b * _cdiv(l, 64)
    covered = np.zeros((b, units // b * 64), np.int32)
    for u in _units_of_blocks(units):
        img, x = u // (units // b), u % (units // b)
        covered[img, 64 * x:64 * (x + 1)] += 1
    assert (covered[:, :l] == 1).all()
    assert 2 <= plan['slots']['core'] <= 4


@pytest.mark.parametrize('dim,heads', WIDTHS + [(128, 2), (1536, 24)])
@pytest.mark.parametrize('b,l', [(32, 197), (3, 577), (1, 1)])
def test_workspace_regions_lie_apart(b, l, dim, heads):
    plan = tfl.fused_q8_plan(b, l, dim, heads)
    m, hd = b * l, heads * 64
    stage = 0 if plan['staged'] else (plan['units']['core'] * 64
                                       * (hd + 8) * 2)
    assert {k: v[1] for k, v in plan['scratch'].items()} == {
        'yq': m * dim, 'ys': 4 * m, 'wqkv': 3 * hd * dim, 'wo': dim * hd,
        'q': 2 * m * hd, 'k': 2 * m * hd, 'v': 2 * m * hd, 'aq': m * hd,
        'as': 4 * m, 'stage': stage}
    spans = sorted(plan['scratch'].values())
    for (a, na), (c, _) in zip(spans, spans[1:]):
        assert a % 256 == 0 and a + na <= c
    last, nlast = spans[-1]
    assert last % 256 == 0 and last + nlast <= plan['workspace']
    # the bands are staged in shared memory up to ViT-B's 12 heads, past
    # that in the workspace
    assert plan['staged'] == (heads <= 12)
    assert plan['smem']['core'] >= (
        3 * 8192 * (1 + 2 * plan['slots']['core'])
        + (64 * (hd + 8) * 2 if plan['staged'] else 0))


@pytest.mark.parametrize('b,l,dim,heads', [(0, 197, 768, 12), (2, 0, 768, 12),
                                           (2, 197, 192, 3), (2, 197, 640, 5),
                                           (2, 197, 768, 3)])
def test_plan_refuses_what_the_kernels_do_not_take(b, l, dim, heads):
    with pytest.raises(ValueError, match='multiples of 128'):
        tfl.fused_q8_plan(b, l, dim, heads)


def k10_blocked(x, scale, bias, wq, wk, wv, wo, heads, eps=tfl.LN_EPS,
                residual=True):
    """The K10 kernels' order in torch (test only): LN(x)'s codes, the QKV
    projections as the twin takes them, then the core over 64-row units of
    one image (sweep 1's final max, sweep 2's p per 64-key tile rounded to
    bf16, p V and the sums tile by tile, the bands staged as bf16 and
    quantised row by row over H*64), then the out projection with + x.
    Returns (out, bands' codes [B*L, H*64], scales [B*L, 1])."""
    b, l, dim = x.shape
    hd = heads * 64
    dt = x.dtype
    (wq_q, sq), (wk_q, sk), (wv_q, sv), (wo_q, so) = tfl._q8_weights(
        wq, wk, wv, wo, dim, hd)
    xf, y = tfl._ln_f32(x.reshape(b * l, dim), scale, bias, eps)
    yq, ys = _quantize_tile(y)
    proj = lambda w_q, s: int_matmul(yq, w_q).float() * (ys * s)
    q = (proj(wq_q, sq) * 0.125).to(dt).float().reshape(b, l, heads, 64)
    k = proj(wk_q, sk).to(dt).float().reshape(b, l, heads, 64)
    v = proj(wv_q, sv).to(dt).float().reshape(b, l, heads, 64)
    codes = torch.zeros(b * l, hd, dtype=torch.int8)
    scales = torch.zeros(b * l, 1)
    tiles = [(j, min(j + 64, l)) for j in range(0, l, 64)]
    for img in range(b):
        for r0 in range(0, l, 64):
            r1 = min(r0 + 64, l)
            stage = torch.zeros(r1 - r0, hd)
            for h in range(heads):
                qh = q[img, r0:r1, h]
                m = torch.full((r1 - r0, 1), -float('inf'))
                for k0, k1 in tiles:                      # sweep 1
                    s = qh @ k[img, k0:k1, h].T
                    m = torch.maximum(m, s.amax(1, keepdim=True))
                o = torch.zeros(r1 - r0, 64)
                lsum = torch.zeros(r1 - r0, 1)
                for k0, k1 in tiles:                      # sweep 2
                    p = torch.exp(qh @ k[img, k0:k1, h].T - m)
                    lsum = lsum + p.sum(1, keepdim=True)
                    o = o + p.to(dt).float() @ v[img, k0:k1, h]
                stage[:, 64 * h:64 * (h + 1)] = (o / lsum).to(dt).float()
            amax = stage.abs().amax(1, keepdim=True)
            sc = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
            rows = slice(img * l + r0, img * l + r1)
            codes[rows] = torch.clamp(torch.round(stage / sc), -127,
                                      127).to(torch.int8)
            scales[rows] = sc
    out = int_matmul(codes, wo_q).float() * (scales * so)
    if residual:
        out = xf + out
    return out.to(dt).reshape(b, l, dim), codes, scales


def _case(seq=20, heads=2, seed=3):
    rng = np.random.RandomState(seed + seq)
    dim = heads * 64
    w = lambda *s, std=1.0: (std * rng.standard_normal(s)
                             / np.sqrt(dim)).astype(np.float32)
    return dict(
        x=rng.standard_normal((2, seq, dim)).astype(np.float32),
        scale=rng.uniform(0.5, 1.5, dim).astype(np.float32),
        bias=(0.1 * rng.standard_normal(dim)).astype(np.float32),
        # wq 4x wider than lecun: a peaked softmax
        wq=w(dim, heads, 64, std=4.0), wk=w(dim, heads, 64),
        wv=w(dim, heads, 64), wo=w(heads, 64, dim)), heads


def _twin_bands(x, c, heads):
    """The port's twin's bf16 bands (fused_attention_q8_plain's attn)."""
    b, l, dim = x.shape
    hd = heads * 64
    (wq_q, sq), (wk_q, sk), (wv_q, sv), _ = tfl._q8_weights(
        *[torch.from_numpy(c[n]) for n in ('wq', 'wk', 'wv', 'wo')], dim, hd)
    _, y = tfl._ln_f32(x.reshape(b * l, dim), torch.from_numpy(c['scale']),
                       torch.from_numpy(c['bias']), tfl.LN_EPS)
    yq, ys = _quantize_tile(y)
    proj = lambda w_q, s: int_matmul(yq, w_q).float() * (ys * s)
    split = lambda t: t.reshape(b, l, heads, 64).float()
    q = split((proj(wq_q, sq) * (1.0 / 8)).to(x.dtype))
    k = split(proj(wk_q, sk).to(x.dtype))
    v = split(proj(wv_q, sv).to(x.dtype))
    s = torch.einsum('bqhd,bkhd->bhqk', q, k)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    band = torch.einsum('bhqk,bkhd->bhqd', p.to(x.dtype).float(), v) \
        / p.sum(dim=-1, keepdim=True)
    return band.to(x.dtype).permute(0, 2, 1, 3).reshape(b * l, hd)


def test_core_order_matches_jax_and_the_twins_codes():
    c, heads = _case()
    names = ('scale', 'bias', 'wq', 'wk', 'wv', 'wo')
    jx, tx = _pair(c['x'], 'bfloat16')
    assert jfl.fused_supported(20, heads, 64) and tfl.fused_supported(
        20, heads, 64)
    want = jfl.attention_sublayer_q8(jx, *[jnp.asarray(c[n]) for n in names],
                                     heads)
    ours, codes, scales = k10_blocked(
        tx, *[torch.from_numpy(c[n]) for n in names], heads)
    assert ours.dtype == torch.bfloat16 and ours.shape == tx.shape
    same = float((_np(ours) == _np(want)).mean())
    delta = np.abs(_np(want) - _np(tx)).max()
    err = np.abs(_np(ours) - _np(want)).max() / delta
    assert same >= KERNEL_SHARE and err <= TOL, (same, err)
    # the staged rows' codes are the twin's codes of its own bands
    want_codes, want_scales = _quantize_tile(_twin_bands(tx, c, heads))
    assert torch.equal(codes, want_codes)
    assert torch.equal(scales, want_scales)
    with torch.no_grad():
        twin = tfl.attention_sublayer_q8(
            tx, *[torch.from_numpy(c[n]) for n in names], heads)
    assert torch.equal(ours, twin)
