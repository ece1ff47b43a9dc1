"""Torch port: the int8 talking-heads span's launch plan and fused band codes
on the CPU (``csrc/th_attention_q8.cu`` + ``csrc/q8_gemm_sm90.cuh`` +
``csrc/th_fwd_sm90.cuh``, K11; the kernels run only on the card,
``tests/test_torch_cuda.py``).

* ``th_q8_plan``, the Python mirror of the C entry ``sav_th_q8_plan``: the
  QKV GEMM's column tiles cover every row and column of each of q, k and v
  once (no tile straddles two of them) and the OUT GEMM's those of out;
  the persistent blocks take every unit once (at B*L = 6304, 6272, 1003
  and 1, CaiT-S/24's, cait_xxs_24's and cait_m's widths); the shared memory of the
  three kernels fits a block, and the workspace regions lie apart at
  256-byte offsets.
* The geometry the kernels do not take raises ValueError (H = 6 and 12
  are not built; H = 16 is, since cait_m's slice).
* ``band_codes``, a test-only torch mirror of the core's Q8 store: each
  f32 output rounded to bf16 first, each lane's absmax over its columns
  of every head (at H = 16 the kernel takes it over two passes of 8 heads
  and their maximum: the same value), the max over the 4 lanes of a row,
  scale = max(absmax,
  1e-8) / 127 by IEEE division, the codes of the IEEE quotient (the
  kernel's ``q8::quantize_exact`` gives them without a division; the card
  holds it against the division for every bf16 value and row absmax,
  ``test_quantizer_matches_the_division`` in ``tests/test_torch_cuda.py``).
  Equal to ``_quantize_tile`` of the bf16 bands (the twin's step), on
  the twin's own bands and on f32 accumulators with values at bf16 and
  code ties.
"""

import numpy as np
import pytest
import torch

from sav_tpu_torch.ops import th_attention as tth
from sav_tpu_torch.ops.int8_matmul_kernel import _quantize_tile
import torch_parity  # noqa: F401  (pins torch to one thread)

SMEM_LIMIT = 232448
SMS = 132
# (B, L): B*L = 6304 (ViT-B/16 bs32's rows), 6272 (CaiT @224 bs32), a ragged
# 1003 and 1
BATCHES = [(32, 197), (32, 196), (17, 59), (1, 1)]
# (D, H): CaiT-S/24, cait_xxs_24 and cait_m
WIDTHS = [(384, 8), (192, 4), (768, 16)]


def _cdiv(a, b):
    return -(-a // b)


def _units_of_blocks(units, sms=SMS):
    grid = min(units, sms)
    return [u for i in range(grid) for u in range(i, units, grid)]


@pytest.mark.parametrize('dim,heads', WIDTHS)
@pytest.mark.parametrize('b,l', BATCHES)
def test_plan_units_cover_each_output_once(b, l, dim, heads):
    plan = tth.th_q8_plan(b, l, dim, heads)
    m, hd = b * l, heads * tth.HEAD_CH
    rows = plan['row_tiles']
    assert (rows - 1) * tth.Q8_ROWS < m <= rows * tth.Q8_ROWS
    for what, width, parts in (('qkv', hd, 3), ('out', dim, 1)):
        tile = plan['tile'][what]
        assert width % tile == 0                 # no partial tile
        nt = parts * width // tile
        assert plan['units'][what] == rows * nt
        taken = _units_of_blocks(plan['units'][what])
        assert sorted(taken) == list(range(plan['units'][what]))
        covered = np.zeros((parts, rows * tth.Q8_ROWS, width), np.int32)
        for u in taken:
            r, c0 = u // nt, (u % nt) * tile     # column tiles fastest
            which, col0 = c0 // width, c0 % width
            assert col0 + tile <= width          # never two outputs
            covered[which, r * tth.Q8_ROWS:(r + 1) * tth.Q8_ROWS,
                    col0:col0 + tile] += 1
        assert (covered[:, :m] == 1).all()
    assert plan['slots'] == {'qkv': dim // 64, 'out': hd // 64}
    assert plan['core_tiles'] == b * _cdiv(l, 64)


@pytest.mark.parametrize('dim,heads', WIDTHS + [(768, 8), (128, 8)])
@pytest.mark.parametrize('b,l', [(32, 196), (3, 250), (1, 1)])
def test_plan_fits_and_workspace_regions_lie_apart(b, l, dim, heads):
    plan = tth.th_q8_plan(b, l, dim, heads)
    m, hd = b * l, heads * tth.HEAD_CH
    assert {k: v[1] for k, v in plan['scratch'].items()} == {
        'yq': m * dim, 'ys': 4 * m, 'wqkv': 3 * hd * dim, 'wo': dim * hd,
        'q': 2 * m * hd, 'k': 2 * m * hd, 'v': 2 * m * hd, 'aq': m * hd,
        'as': 4 * m}
    spans = sorted(plan['scratch'].values())
    for (a, na), (c, _) in zip(spans, spans[1:]):
        assert a % 256 == 0 and a + na <= c
    last, nlast = spans[-1]
    assert last % 256 == 0 and last + nlast <= plan['workspace']
    for what in ('qkv', 'out', 'core'):
        assert 0 < plan['smem'][what] <= SMEM_LIMIT
    core = tth.th_fwd_plan(l, heads)['smem']
    if heads <= 8:
        # K6a's kernel and, after its mbarriers, the codes' staging rows
        assert plan['smem']['core'] >= core + 64 * (hd + 16)
    else:
        # at H = 16 the staging rows lie over the resident q (64 x H*48
        # bf16), free by the time the codes are taken
        assert plan['smem']['core'] == core
        assert 64 * (hd + 16) <= 64 * hd * 2


@pytest.mark.parametrize('b,l,dim,heads', [(0, 196, 384, 8), (2, 0, 384, 8),
                                           (2, 196, 80, 8), (2, 196, 0, 8),
                                           (2, 196, 384, 10),
                                           (2, 196, 768, 12)])
def test_plan_refuses_what_the_kernels_do_not_take(b, l, dim, heads):
    with pytest.raises(ValueError, match='multiple of 32'):
        tth.th_q8_plan(b, l, dim, heads)


def band_codes(acc, heads):
    """The core's Q8 store in torch (test only): rows of f32 accumulators
    [M, H*48] -> (codes int8 [M, H*48], scales [M, 1])."""
    v = acc.bfloat16().float()                   # the twin's bands
    col = torch.arange(heads * tth.HEAD_CH) % tth.HEAD_CH
    lane = (col % 8) // 2                        # columns 8 i + 2 t + j
    part = torch.stack([v[:, lane == t].abs().amax(1) for t in range(4)], 1)
    amax = part.amax(1, keepdim=True)            # the 4 lanes of a row
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    codes = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return codes, scale


def _bands(b, l, heads, seed):
    rng = np.random.RandomState(seed)
    hd = heads * tth.HEAD_CH
    t = lambda std: torch.from_numpy(
        (std * rng.standard_normal((b, l, hd))).astype(np.float32)).bfloat16()
    mix = lambda: torch.from_numpy((np.eye(heads) + 0.3 * rng.standard_normal(
        (heads, heads))).astype(np.float32))
    attn, _ = tth.th_core_fwd_plain(t(0.6), t(1.0), t(1.0), mix(), mix(),
                                    heads)
    return attn.reshape(b * l, hd)


@pytest.mark.parametrize('heads', [4, 8, 16])
def test_band_codes_equal_the_twins_codes_of_its_bands(heads):
    bands = _bands(2, 37, heads, heads)
    codes, scale = band_codes(bands.float(), heads)
    want_codes, want_scale = _quantize_tile(bands)
    assert torch.equal(codes, want_codes)
    assert torch.equal(scale, want_scale)


@pytest.mark.parametrize('heads', [4, 8, 16])
def test_band_codes_round_to_bf16_first(heads):
    """f32 accumulators a hair off bf16 values and rows whose codes sit at
    .5 after the bf16 rounding: the mirror's codes are the twin's codes of
    the rounded bands, and not those of the f32 values."""
    rng = np.random.RandomState(17 + heads)
    hd = heads * tth.HEAD_CH
    base = torch.from_numpy(rng.standard_normal((64, hd)).astype(np.float32))
    base = base.bfloat16().float()
    # row maxima of 127 bf16 steps, values at k + 0.5 code steps exactly
    base[:, 0] = 127.0
    base[:32, 1:9] = torch.tensor([0.5, 1.5, 2.5, 3.5, -0.5, -1.5, 10.5,
                                   -10.5])
    acc = base + torch.from_numpy(
        rng.uniform(-1, 1, (64, hd)).astype(np.float32)) * base.abs() * 2 ** -10
    codes, scale = band_codes(acc, heads)
    want_codes, want_scale = _quantize_tile(acc.bfloat16())
    assert torch.equal(codes, want_codes) and torch.equal(scale, want_scale)
    f32_codes, _ = _quantize_tile(acc)
    assert not torch.equal(codes, f32_codes)
