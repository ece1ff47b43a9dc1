"""Torch port: BoTNet's relative-position attention backward's launch plan
and sum order on the CPU (``csrc/botnet_attention.cu``, K9b: the dq and the
dkv kernel; they run only on the card, ``tests/test_torch_cuda.py``).

* ``bot_bwd_plan``, the Python mirror of ``dq_plan``/``dkv_plan`` (C entry
  ``sav_bot_bwd_plan``), at d = 64 and 128 over g = 1..49: the layouts fit
  a block with the most ring slots that fit (at least one), and
  ``supported`` admits on the card every (g, d) the parent's kernels took
  (g <= 49 at d = 128, g <= 69 at d = 64).
* ``bot_bwd_blocked``, a test-only torch mirror of the two kernels' order:
  the dq kernel's 128-row units (two 64-row halves) over 64-key tiles (a
  last tile of 1-16 keys 16 wide), delta as two half-row sums, ds = (dp -
  delta) p, dq summed tile by tile, drel_h as the running sum of each
  grid row's runs of keys (a run's sum in key order, then added), drel_w
  bin by bin (the bin's keys of a tile summed in key order, then added);
  the dkv kernel's 64-key rows over the query tiles, dk and dv summed
  tile by tile. Held against the JAX ``bot_core``'s gradients (K9b's
  ``_bwd_kernel`` in interpret mode) at B = 2, g = 5 (L = 25, ragged
  against every tile), h = 2, d = 64, in float32 at the JAX module's own
  tolerance (5e-5 of each gradient's max |jax|: the sums run in another
  order), and against the port's twin ``bot_bwd_plain`` at 1e-5 of max.
"""

import numpy as np
import pytest
import torch

from sav_tpu_torch.ops import botnet_attention as ba
from test_torch_botnet_attention import _close, _cotangent, _jax_core, _t

SMEM_LIMIT = 232448


def _parent_takes(g, d):
    """Whether the parent's mma.sync K9a/K9b took (g, d): its three
    kernels' shared memory (64-row tiles of d + 8 bf16, the rel rows, the
    dq kernel's per-lane bins at pitch g | 1) within a block's."""
    ld = d + 8
    fwd = 5 * 64 * ld * 2 + 2 * 64 * g * 4
    dq = 6 * 64 * ld * 2 + 2 * 64 * g * 4 + 64 * 4 + 2 * 64 * 4 * (g | 1) * 4
    dkv = 6 * 64 * ld * 2 + 4 * 64 * g * 4 + 4 * 64 * 4
    return max(fwd, dq, dkv) <= SMEM_LIMIT


@pytest.mark.parametrize('d', [64, 128])
def test_plan_fits_with_the_most_slots(d):
    nb, box = d // 64, 64 * 64 * 2
    for g in range(1, 50):
        plan = ba.bot_bwd_plan(g, d)
        gp = plan['pitch']
        assert gp == g | 1 and gp % 2 == 1
        dq, dkv = plan['dq'], plan['dkv']
        for p in (dq, dkv):
            assert 1 <= p['stages'] <= 4 and 0 < p['smem'] <= SMEM_LIMIT
        # the dq kernel: Q, dO, the ring, O / the ds tiles, the rel rows
        # (g f32 each), the drel_w bins (pitch g | 1), delta, the
        # mbarriers, alignment slack
        fixed = (4 * nb * box + max(2 * nb * box, 2 * 64 * 65 * 4)
                 + 2 * 128 * g * 4 + 2 * 64 * gp * 4 + 128 * 4 + 1024)
        assert dq['smem'] == fixed + dq['stages'] * (2 * nb * box + 16) + 16
        # a dkv slot: Q and dO boxes, the rel rows, lse and delta, 1024-byte
        # aligned
        assert dkv['slot'] % 1024 == 0
        assert 0 <= dkv['slot'] - (2 * nb * box + 2 * 64 * g * 4 + 512) < 1024
        assert dkv['smem'] == (4 * nb * box + dkv['stages'] * (dkv['slot'] + 16)
                               + 16 + 1024)
        # the most slots that fit
        for p, per in ((dq, 2 * nb * box + 16), (dkv, dkv['slot'] + 16)):
            assert p['stages'] == 4 or p['smem'] + per > SMEM_LIMIT


@pytest.mark.parametrize('d,last', [(64, 69), (128, 49)])
def test_supported_keeps_every_grid_the_parent_took(d, last):
    took = [g for g in range(1, 100) if _parent_takes(g, d)]
    assert took == list(range(1, last + 1))
    for g in took:
        assert ba.supported(g, 4, d, device='cuda'), g
    # K9a at botnet_t3's grid: two buffers of Q's 128 rows and the rel
    # rows (1024-byte aligned), four ring slots of one 104-key step's K
    # or V box (112 rows), twelve mbarriers, alignment slack
    assert ba.fwd_smem(14, 128) == (2 * (4 * 64 * 64 * 2 + 2 * 128 * 14 * 4)
                                    + 4 * 2 * 112 * 128 + 12 * 8 + 1024)


def _grid_cells(length, g):
    j = np.arange(length)
    return j // g, j % g


def bot_bwd_blocked(qs, k, v, rel_h, rel_w, out, lse, grad, heads, g):
    """K9b's order in torch (test only; see the module docstring). Inputs
    as ``bot_bwd_plain``'s; returns (dq, dk, dv, drel_h, drel_w)."""
    b, length, hd = qs.shape
    d = hd // heads
    cdt = qs.dtype
    split = lambda a: a.reshape(b, length, heads, d).float()
    q4, k4, v4, o4, g4 = (split(a) for a in (qs, k, v, out, grad))
    hb, wb = _grid_cells(length, g)
    wide = length // 64 + (length % 64 > 16)
    tiles = [(j * 64, min(j * 64 + 64, length)) for j in range(wide)]
    if wide * 64 < length:
        tiles.append((wide * 64, length))
    dq = torch.zeros(b, length, heads, d)
    dk = torch.zeros(b, length, heads, d)
    dv = torch.zeros(b, length, heads, d)
    drh = torch.zeros(b, heads, length, g)
    drw = torch.zeros(b, heads, length, g)
    for img in range(b):
        for h in range(heads):
            qh, kh, vh, oh, gh = (a[img, :, h] for a in (q4, k4, v4, o4, g4))
            rh, rw = rel_h[img, h].float(), rel_w[img, h].float()
            lh = lse[img, h].float()[:, None]
            # delta: each row's two halves of d summed apart, then added
            half = d // 2
            part = lambda c0: (oh[:, c0:c0 + half] * gh[:, c0:c0 + half]).sum(1)
            delta = (part(0) + part(half))[:, None]

            def tile(rows, k0, k1):
                s = qh[rows] @ kh[k0:k1].T
                s = (s + rh[rows][:, hb[k0:k1]]) + rw[rows][:, wb[k0:k1]]
                p = torch.exp(s - lh[rows])
                dp = gh[rows] @ vh[k0:k1].T
                return p, (dp - delta[rows]) * p

            # the dq kernel: its rows over the key tiles
            for r0 in range(0, length, 64):
                rows = slice(r0, min(r0 + 64, length))
                acc = torch.zeros(rows.stop - rows.start, d)
                run_h = torch.zeros(rows.stop - rows.start, g)
                bins = torch.zeros(rows.stop - rows.start, g)
                for k0, k1 in tiles:
                    _, ds = tile(rows, k0, k1)
                    acc = acc + ds.to(cdt).float() @ kh[k0:k1]
                    c = k0
                    while c < k1:                  # runs in one grid row
                        n = min(g - wb[c], k1 - c)
                        run = ds[:, c - k0]
                        for i in range(1, n):
                            run = run + ds[:, c - k0 + i]
                        run_h[:, hb[c]] = run_h[:, hb[c]] + run
                        c += n
                    for i in range(min(g, k1 - k0)):   # bin by bin
                        cols = list(range(i, k1 - k0, g))
                        part_w = ds[:, cols[0]]
                        for col in cols[1:]:
                            part_w = part_w + ds[:, col]
                        bins[:, wb[k0 + i]] = bins[:, wb[k0 + i]] + part_w
                dq[img, rows, h] = acc
                drh[img, h, rows] = run_h
                drw[img, h, rows] = bins
            # the dkv kernel: its keys over the query tiles
            for k0 in range(0, length, 64):
                keys = slice(k0, min(k0 + 64, length))
                adk = torch.zeros(keys.stop - keys.start, d)
                adv = torch.zeros(keys.stop - keys.start, d)
                for q0, q1 in tiles:
                    p, ds = tile(slice(q0, q1), keys.start, keys.stop)
                    adv = adv + p.T.to(cdt).float() @ gh[q0:q1]
                    adk = adk + ds.T.to(cdt).float() @ qh[q0:q1]
                dk[img, keys, h] = adk
                dv[img, keys, h] = adv
    band = lambda a: a.reshape(b, length, hd).to(cdt)
    return band(dq), band(dk), band(dv), drh, drw


@pytest.mark.parametrize('b,g,h,d', [(2, 5, 2, 64)])
def test_blocked_order_matches_jax_and_the_twin(b, g, h, d):
    ins, out, lse, want = _jax_core(b, g, h, d)
    t = [_t(a) for a in ins]
    grad = _t(_cotangent(b, g, h, d))
    ours = bot_bwd_blocked(*t, _t(out), _t(lse), grad, h, g)
    names = ('dq', 'dk', 'dv', 'drel_h', 'drel_w')
    for a, w, name in zip(ours, want, names):
        _close(a, w, 5e-5 * np.abs(w).max(), name)
    twin = ba.bot_bwd_plain(*t, _t(out), _t(lse), grad, h, g)
    for a, w, name in zip(ours, twin, names):
        _close(a, w.detach().numpy(), 1e-5 * float(w.abs().max()), name)


def test_blocked_order_covers_tiles_past_the_first():
    """A grid of 12 x 12 (L = 144: two full key tiles and a 16-key tail,
    grid rows straddling the tiles) against the twin: the runs, bins and
    tile sums reach every key once."""
    rng = np.random.RandomState(4)
    b, g, h, d = 1, 12, 1, 64
    length = g * g
    mk = lambda *s, std=0.3: torch.from_numpy(
        (std * rng.standard_normal(s)).astype(np.float32))
    qs, k, v, grad = (mk(b, length, h * d) for _ in range(4))
    rel_h, rel_w = mk(b, h, length, g), mk(b, h, length, g)
    out, lse = ba.bot_fwd_plain(qs, k, v, rel_h, rel_w, h, g)
    ours = bot_bwd_blocked(qs, k, v, rel_h, rel_w, out, lse, grad, h, g)
    twin = ba.bot_bwd_plain(qs, k, v, rel_h, rel_w, out, lse, grad, h, g)
    for a, w, name in zip(ours, twin, ('dq', 'dk', 'dv', 'drel_h',
                                       'drel_w')):
        _close(a, w.numpy(), 1e-5 * float(w.abs().max()), name)
