"""Torch port: the talking-heads forward's launch plan and algebra on the
CPU (``csrc/th_fwd_sm90.cuh``, K6a; the kernel runs only on the card,
``tests/test_torch_cuda.py``).

* ``th_fwd_plan``, the Python mirror of the kernel's ``Plan`` (read on the
  card through ``sav_th_core_fwd_smem``): the shared memory fits a block's
  232,448 bytes at H = 4 and 8, the 64-row work tiles and 16-key tiles
  cover every row and key, and a head count the kernel is not built for
  raises ValueError naming ROADMAP.md Queue 2 item 9.
* ``kernel_algebra``, a test-only torch mirror of the kernel's arithmetic:
  64 query rows against 16-key tiles, the logits pre-mixed with M_pre log2
  e, keys past L set to -inf after the mix, a running max and sum of 2^x
  per mixed head over the first sweep, pn = 2^(x - lse log2 e) in the
  second, the post-mix rounded to bf16 before P V. Held against
  ``th_core_fwd_plain`` (attn within 2^-8 of max: both are bf16, and f32
  sums in another order may round to the neighbouring value; lse within
  1e-5: f32 sums in another order) and, at one ragged shape, against the
  JAX package's ``_th_blk_fwd_kernel`` (K6a) in Pallas interpret mode at
  the same bounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sav_tpu.ops import th_attention as jax_th
from sav_tpu_torch.ops import th_attention as th

import torch_parity  # noqa: F401  (pins torch to one thread)

SMEM_LIMIT = 232448
ATTN_TOL = 2.0 ** -8
LSE_TOL = 1e-5
LENGTHS = (1, 17, 196, 197, 576, 577)


@pytest.mark.parametrize('heads', th.KERNEL_HEADS)
def test_plan_fits_a_block(heads):
    plan = th.th_fwd_plan(576, heads)
    assert 0 < plan['smem'] <= SMEM_LIMIT
    # the smem does not grow with the length: the keys stream
    assert all(th.th_fwd_plan(l, heads)['smem'] == plan['smem']
               for l in LENGTHS)


@pytest.mark.parametrize('heads', th.KERNEL_HEADS)
@pytest.mark.parametrize('l', LENGTHS)
def test_plan_covers_every_row_and_key(l, heads):
    plan = th.th_fwd_plan(l, heads)
    rows, cols = plan['rows'], plan['cols']
    assert (plan['tiles'] - 1) * rows < l <= plan['tiles'] * rows
    per_sweep = plan['steps'] // 2
    assert plan['steps'] == 2 * per_sweep
    assert (per_sweep - 1) * cols < l <= per_sweep * cols


@pytest.mark.parametrize('heads', [6, 16])
def test_plan_refuses_unbuilt_heads(heads):
    with pytest.raises(ValueError, match='Queue 2 item 9'):
        th.th_fwd_plan(576, heads)


def _bands(b, l, heads, seed):
    rng = np.random.RandomState(seed)
    mk = lambda std: torch.from_numpy((rng.standard_normal(
        (b, l, heads * 48)) * std).astype(np.float32)).bfloat16()
    q, k, v = mk(0.4), mk(1.0), mk(1.0)
    mixes = [torch.from_numpy((np.eye(heads) + 0.3 * rng.standard_normal(
        (heads, heads))).astype(np.float32)) for _ in range(2)]
    return q, k, v, mixes


def test_forward_checks_raise():
    """Six heads, head width 64 and f32 bands raise ValueError before any
    launch (on the CPU ``th_core_fwd`` is the twin)."""
    q6, k6, v6, _ = _bands(1, 20, 6, 0)
    q, k, v, _ = _bands(1, 20, 8, 0)
    wide = torch.zeros(1, 20, 8 * 64, dtype=torch.bfloat16)
    for *bands, heads in ((q6, k6, v6, 6), (wide, wide, wide, 8),
                          (q.float(), k.float(), v.float(), 8)):
        with pytest.raises(ValueError):
            th._check_core(*(t.to('meta') for t in bands), heads)


def kernel_algebra(q, k, v, m_pre, m_post, heads):
    """The kernel's arithmetic in torch (test only): (attn, lse) like
    ``th_core_fwd_plain``."""
    b, l, hd = q.shape
    rows, cols = 64, 16
    split = lambda a: a.reshape(b, l, heads, hd // heads).float()
    q4, k4, v4 = split(q), split(k), split(v)
    pre2 = m_pre.float() * th.LOG2E
    post = m_post.float()
    attn = torch.zeros(b, l, heads, hd // heads)
    lse2 = torch.zeros(b, heads, l)
    span = lambda r0, n: slice(r0, min(r0 + n, l))

    def logits(rr, c0):
        """x = the pre-mixed logits times log2 e, -inf past L (the tile's
        keys run to c0 + 16 whatever L is: zeros past it, then masked)."""
        keys = torch.zeros(b, cols, heads, hd // heads)
        cc = span(c0, cols)
        keys[:, :cc.stop - c0] = k4[:, cc]
        s = torch.einsum('bqhd,bkhd->bhqk', q4[:, rr], keys)
        x = torch.einsum('ji,bjqk->biqk', pre2, s)
        x[..., cc.stop - c0:] = -torch.inf
        return x

    for r0 in range(0, l, rows):
        rr = span(r0, rows)
        mx = torch.full((b, heads, rr.stop - r0), -torch.inf)
        sm = torch.zeros_like(mx)
        for c0 in range(0, l, cols):                # sweep 1
            x = logits(rr, c0)
            m_new = torch.maximum(mx, x.amax(dim=-1))
            sm = sm * torch.exp2(mx - m_new) + torch.exp2(
                x - m_new[..., None]).sum(dim=-1)
            mx = m_new
        l2 = mx + torch.log2(sm)
        lse2[:, :, rr] = l2
        for c0 in range(0, l, cols):                # sweep 2
            cc = span(c0, cols)
            pn = torch.exp2(logits(rr, c0) - l2[..., None])[..., :cc.stop - c0]
            pt = torch.einsum('ji,bjqk->biqk', post, pn).bfloat16().float()
            attn[:, rr] += torch.einsum('bhqk,bkhd->bqhd', pt, v4[:, cc])
    return attn.reshape(b, l, hd).to(q.dtype), lse2 / th.LOG2E


def _hold(got, want):
    (attn, lse), (w_attn, w_lse) = got, want
    attn_err = float((attn.float() - w_attn.float()).abs().max()
                     / w_attn.float().abs().max())
    lse_err = float((lse - w_lse).abs().max())
    assert attn_err <= ATTN_TOL, attn_err
    assert lse_err <= LSE_TOL, lse_err


@pytest.mark.parametrize('b,l,heads', [(2, 5, 4), (2, 17, 8), (1, 80, 4),
                                       (1, 130, 8)])
def test_kernel_algebra_matches_twin(b, l, heads):
    q, k, v, m = _bands(b, l, heads, l + heads)
    _hold(kernel_algebra(q, k, v, *m, heads),
          th.th_core_fwd_plain(q, k, v, *m, heads))


def test_kernel_algebra_matches_jax_blocked_kernel():
    """At L = 40 (a ragged 64-row work tile and 16-key tile), H = 4: the JAX
    package's q-blocked forward kernel (K6a) in interpret mode on the same
    bf16 bands, zero-padded to its 128-row blocks."""
    b, l, heads = 1, 40, 4
    q, k, v, m = _bands(b, l, heads, 11)
    lp, hd = 128, heads * 48
    pad = lambda t: jnp.asarray(np.pad(t.float().numpy(), (
        (0, 0), (0, lp - l), (0, 0)))).astype(jnp.bfloat16)
    spec = pl.BlockSpec((1, lp, hd), lambda bi, qi: (bi, qi, 0))
    attn_p, lse_p = pl.pallas_call(
        functools.partial(jax_th._th_blk_fwd_kernel, l=l, heads=heads,
                          dp=48),
        grid=(b, 1),
        in_specs=[spec, spec, spec, pl.BlockSpec(), pl.BlockSpec()],
        out_specs=[spec, pl.BlockSpec((1, heads, lp, jax_th.STAT_LANES),
                                      lambda bi, qi: (bi, 0, qi, 0))],
        out_shape=[jax.ShapeDtypeStruct((b, lp, hd), jnp.bfloat16),
                   jax.ShapeDtypeStruct((b, heads, lp, jax_th.STAT_LANES),
                                        jnp.float32)],
        interpret=True,
    )(pad(q), pad(k), pad(v), jnp.asarray(m[0].numpy()),
      jnp.asarray(m[1].numpy()))
    want = (torch.from_numpy(np.array(attn_p[:, :l], np.float32)),
            torch.from_numpy(np.array(lse_p[:, :, :l, 0], np.float32)))
    _hold(kernel_algebra(q, k, v, *m, heads), want)
