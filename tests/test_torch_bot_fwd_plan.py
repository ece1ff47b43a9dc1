"""Torch port: BoTNet's relative-position attention forward (K9a,
``csrc/botnet_attention.cu``) on the CPU: its launch plan and the order of
its tile-wise softmax (the kernel runs only on the card,
``tests/test_torch_cuda.py``).

* ``bot_fwd_plan``, the Python mirror of ``fwd_plan`` /
  ``sav_bot_fwd_plan``: the keys a tile by L (``fwd_width``: 104 where
  104-key steps cover L in no more columns than 64-key tiles, 208 columns
  at L = 196), the key tiles a 128-query unit, two Q + rel-row buffers and
  the most ring slots (2-4) that fit a block's 232,448 bytes; at d = 64
  and 128 for every grid side the parent's kernels took (g <= 69 and 49)
  and every one ``supported`` takes today (K9b's plans bind), with nothing
  the parent took refused. BoTNet-T3's units and waves on 132 SMs.
* ``_tile_mirror``, a test-only torch mirror of the kernel's softmax over
  the plan's key tiles: per tile the f32 logits with the bias in the TPU
  kernel's order (s + rel_h) + rel_w, keys past L at -inf, the running
  max, p = 2^(s log2 e - m log2 e), the sums and o rescaled by 2^(m_old
  log2 e - m log2 e), p rounded to v's dtype before p v; out = o / sum,
  lse = m + log sum. A ragged last tile at g = 5 (25 of 64 keys), 7 (49
  of 64) and 14 (two 104-key steps, 92 of the second). Held in float32
  against ``bot_fwd_plain`` (out and lse at 2e-6, the same arithmetic
  summed tile by tile) and against the JAX package's ``_fwd_kernel`` in
  interpret mode (``_bot_fwd_impl``) at the JAX module's own 2e-5; in
  bfloat16 against ``bot_fwd_plain`` at 2e-2 of max |twin| (out, the
  card's tolerance) and 1e-3 (lse). B = 2, h = 2, d = 64, inputs from a
  fixed numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import botnet_attention as jax_ba
from sav_tpu_torch.ops import botnet_attention as ba

import torch_parity  # noqa: F401  (pins torch to one thread)

SMEM_LIMIT = 232448
BOX = 64 * 64 * 2
LOG2E = 1.4426950408889634


def _parent_takes(g, d):
    """The parent's ``supported``: its mma.sync K9a's shared memory (five
    64-row tiles of d + 8 bf16 and a tile's rel rows) and K9b's plans."""
    plan = ba.bot_bwd_plan(g, d)
    fwd = 5 * 64 * (d + 8) * 2 + 2 * 64 * g * 4
    return (fwd <= SMEM_LIMIT and plan['dq']['smem'] > 0
            and plan['dkv']['smem'] > 0)


@pytest.mark.parametrize('d', [64, 128])
def test_plan_fits_every_grid_the_kernels_take(d):
    nb = d // 64
    took = [g for g in range(1, 200) if _parent_takes(g, d)]
    assert took[:5] == [1, 2, 3, 4, 5] and took[-1] >= (69 if d == 64 else 49)
    for g in took:
        plan = ba.bot_fwd_plan(g, d)
        length = g * g
        w = plan['width']
        assert w in (ba.fwd_width(length), 64)
        assert plan['tiles'] == -(-length // w)
        assert 2 <= plan['stages'] <= 4 and 1 <= plan['qbufs'] <= 2
        res = -(-(2 * nb * BOX + 2 * 128 * g * 4) // 1024) * 1024
        slot = nb * ba.box_rows(w) * 128
        assert (plan['res'], plan['slot']) == (res, slot)
        assert plan['smem'] == (plan['qbufs'] * res + plan['stages'] * slot
                                + (2 * plan['qbufs'] + 2 * plan['stages']) * 8
                                + 1024)
        assert 0 < plan['smem'] <= SMEM_LIMIT
        # the most slots that fit, at two buffers where any fits
        more = plan['smem'] + slot + 16
        assert plan['stages'] == 4 or more > SMEM_LIMIT
        assert ba.supported(g, 4, d, device='cuda'), g


def test_key_tiles_by_length():
    """The keys a tile cover L in the fewest columns of 64 or 104 (104 on
    a tie): one or two 104-key steps where they beat 64-key tiles."""
    for length, width, cols in ((25, 64, 64), (49, 64, 64), (81, 104, 104),
                                (169, 64, 192), (196, 104, 208),
                                (400, 104, 416), (576, 64, 576)):
        assert ba.fwd_width(length) == width
        assert -(-length // width) * width == cols
        assert cols <= -(-length // 64) * 64
    assert ba.box_rows(104) == 112 and ba.box_rows(64) == 64


def test_botnet_t3_units_and_waves():
    """BoTNet-T3 @224 (g = 14, 4 heads of 128): 128-query units pair the
    4-row tile (rows 192-195) with rows 128-191 in one unit, so 2 units
    an (image, head): 256 at B = 32, 512 at B = 64 on 132 SMs."""
    plan = ba.bot_fwd_plan(14, 128)
    assert (plan['width'], plan['tiles'], plan['qbufs'], plan['stages']) == (
        104, 2, 2, 4)
    for batch, units, waves in ((32, 256, 1.94), (64, 512, 3.88)):
        n = -(-196 // 128) * 4 * batch
        assert n == units and round(n / 132, 2) == waves


# ---- the tile-wise softmax

def _tile_mirror(qs, k, v, rel_h, rel_w, num_heads, g):
    """K9a's softmax over the plan's key tiles: (out, lse)."""
    b, length, hd = qs.shape
    d = hd // num_heads
    w = ba.fwd_width(length)
    heads = lambda a: a.reshape(b, length, num_heads, d).permute(0, 2, 1, 3)
    q, kh, vh = heads(qs).float(), heads(k).float(), heads(v)
    m = torch.full((b, num_heads, length, 1), float('-inf'))
    l = torch.zeros(b, num_heads, length, 1)
    o = torch.zeros(b, num_heads, length, d)
    for j0 in range(0, length, w):
        keys = torch.arange(j0, j0 + w)
        ok = keys < length
        kk = keys.clamp(max=length - 1)
        s = torch.einsum('bhqd,bhkd->bhqk', q, kh[:, :, kk])
        s = (s + rel_h[..., kk // g]) + rel_w[..., kk % g]
        s = torch.where(ok, s, torch.tensor(float('-inf')))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        a = torch.exp2(m * LOG2E - m_new * LOG2E)
        p = torch.exp2(s * LOG2E - m_new * LOG2E)
        l = l * a + p.sum(-1, keepdim=True)
        pv = torch.where(ok[:, None], vh[:, :, kk].float(), torch.tensor(0.0))
        o = o * a + p.to(v.dtype).float() @ pv
        m = m_new
    out = (o / l).permute(0, 2, 1, 3).reshape(b, length, hd).to(qs.dtype)
    return out, (m + torch.log(l))[..., 0]


def _args(b, g, h, d, seed):
    rng = np.random.RandomState(seed)
    length = g * g
    mk = lambda *s, std=1.0: (std * rng.standard_normal(s)).astype(np.float32)
    return (mk(b, length, h * d, std=2 / np.sqrt(d)), mk(b, length, h * d),
            mk(b, length, h * d), mk(b, h, length, g, std=0.5),
            mk(b, h, length, g, std=0.5))


@pytest.mark.parametrize('g', [5, 7, 14])
def test_tile_mirror_matches_twin(g):
    args = [torch.from_numpy(a) for a in _args(2, g, 2, 64, g)]
    out, lse = _tile_mirror(*args, 2, g)
    want, want_lse = ba.bot_fwd_plain(*args, 2, g)
    assert out.shape == want.shape and lse.shape == want_lse.shape
    assert (out - want).abs().max() <= 2e-6
    assert (lse - want_lse).abs().max() <= 2e-6


@pytest.mark.parametrize('g', [5, 7, 14])
def test_tile_mirror_matches_twin_in_bf16(g):
    args = [torch.from_numpy(a) for a in _args(2, g, 2, 64, g + 1)]
    for i in range(3):
        args[i] = args[i].bfloat16()
    out, lse = _tile_mirror(*args, 2, g)
    want, want_lse = ba.bot_fwd_plain(*args, 2, g)
    assert out.dtype == want.dtype == torch.bfloat16
    rel = (out.float() - want.float()).abs().max() / want.float().abs().max()
    assert rel <= 2e-2
    assert (lse - want_lse).abs().max() <= 1e-3


@pytest.mark.parametrize('g', [5, 7, 14])
def test_tile_mirror_matches_jax_kernel(g):
    """Against the JAX package's K9a (``_fwd_kernel`` in interpret mode) at
    its own test's float32 tolerance, out and lse."""
    args = _args(2, g, 2, 64, 3 * g)
    out, res = jax_ba._bot_fwd_impl(*map(jnp.asarray, args), 2, g)
    want_lse = np.asarray(res[-1])[:, :, :g * g, 0]
    got, lse = _tile_mirror(*map(torch.from_numpy, args), 2, g)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-5)
