"""Torch port: the talking-heads forward's launch plan and algebra on the
CPU (``csrc/th_fwd_sm90.cuh``, K6a; the kernel runs only on the card,
``tests/test_torch_cuda.py``).

* ``th_fwd_plan``, the Python mirror of the kernel's ``Plan`` (read on the
  card through ``sav_th_core_fwd_smem``): the shared memory fits a block's
  232,448 bytes at H = 4, 6, 8 and 16, the 64-row work tiles and 16-key
  tiles cover every row and key in every sweep (at H = 16 the lse sweep
  and one sweep a group of 8 output heads), H = 6's 288 columns are read
  as 5 boxes of 64 (a ceiling), and a head count the kernel is not built
  for raises ValueError.
* ``kernel_algebra``, a test-only torch mirror of the kernel's arithmetic:
  64 query rows against 16-key tiles, the logits pre-mixed with M_pre log2
  e, keys past L set to -inf after the mix, a running max and sum of 2^x
  per mixed head over the first sweep, pn = 2^(x - lse log2 e) in the
  second, the post-mix rounded to bf16 before P V; at H = 16 the first
  sweep's running max and sum step over 8-key halves (the mix
  warpgroup's m64n8k16 products) and the second sweep runs once a group of
  8 output heads. Held against
  ``th_core_fwd_plain`` (attn within 2^-8 of max: both are bf16, and f32
  sums in another order may round to the neighbouring value; lse within
  1e-5: f32 sums in another order) and, at one ragged shape, against the
  JAX package's ``_th_blk_fwd_kernel`` (K6a) in Pallas interpret mode at
  the same bounds.
* ``k5a_algebra``, K5a's whole span as the card runs it: the LayerNorm, the
  projection GEMM's one rounding of an f32 sum (q scaled first), the core
  of ``kernel_algebra`` (K6a's kernel is K5a's core), the out GEMM. Held at the same bounds (lse 1e-5, the rest 2^-8 of max) against
  ``th_attention_fwd_plain`` and, at the ragged L = 68 = 64 + 4 (the tail
  of CaiT-S/24 @224's 196 = 3 x 64 + 4), against the JAX package's
  ``_th_fwd_kernel`` (K5a) in Pallas interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sav_tpu.ops import th_attention as jax_th
from sav_tpu_torch.ops import fused_layer as fl
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
    sweeps = 1 + plan['groups']          # the lse, then one a head group
    per_sweep = plan['steps'] // sweeps
    assert plan['steps'] == sweeps * per_sweep
    assert (per_sweep - 1) * cols < l <= per_sweep * cols
    assert plan['groups'] * plan['group'] == heads
    assert plan['group'] <= 8
    assert plan['halves'] == (1 if heads <= 8 else 2)


@pytest.mark.parametrize('heads', [6, 16])
def test_plan_refuses_unbuilt_heads(heads):
    """A head count is refused exactly where the kernel is not built for
    it (H = 12 is in no factory config); H = 6 (cait_xs) is built, its 288
    columns read as 5 boxes of 64 in one group of 6 output heads; H = 16
    (cait_m) as two groups of 8 output heads in a block's shared memory."""
    with pytest.raises(ValueError, match='heads of 48'):
        th.th_fwd_plan(576, 12)
    plan = th.th_fwd_plan(576, heads)
    assert plan['smem'] <= SMEM_LIMIT
    if heads == 6:
        assert (plan['group'], plan['groups'], plan['stages'],
                plan['boxes']) == (6, 1, 4, 5)
        # q 5 boxes (40 KB), 4 slots of k's 5 boxes and v's 6 (88 KB), the
        # exchange 24 KB: 156,784 bytes
        assert plan['smem'] == 156784
        return
    assert (plan['group'], plan['groups'], plan['stages']) == (8, 2, 2)
    # q of every head stays resident (96 KB), the ring carries k and the
    # group's v: 214,096 bytes
    assert plan['smem'] == 214096


@pytest.mark.parametrize('b,l,heads,want', [
    (16, 196, 16, 2),          # cait_m_48 @224 bs16: 64 tiles, 128 units
    (33, 196, 16, 1),          # 132 tiles: already a wave
    (32, 196, 16, 1),          # 128 tiles: split would take two waves
    (1, 577, 16, 2), (16, 196, 8, 1), (1, 17, 4, 1)])
def test_split_takes_head_groups_apart_within_one_wave(b, l, heads, want):
    """Work units a tile: H = 16's two head groups apart only where the
    tiles fill less than a wave of the H100's 132 SMs and the groups at
    most one."""
    split = th.th_fwd_split(b, l, heads)
    assert split == want
    tiles = b * th.th_fwd_plan(l, heads)['tiles']
    assert tiles * split <= 132 or split == 1


def _bands(b, l, heads, seed):
    rng = np.random.RandomState(seed)
    mk = lambda std: torch.from_numpy((rng.standard_normal(
        (b, l, heads * 48)) * std).astype(np.float32)).bfloat16()
    q, k, v = mk(0.4), mk(1.0), mk(1.0)
    mixes = [torch.from_numpy((np.eye(heads) + 0.3 * rng.standard_normal(
        (heads, heads))).astype(np.float32)) for _ in range(2)]
    return q, k, v, mixes


def test_forward_checks_raise():
    """Twelve heads (no factory config has them), head width 64 and f32
    bands raise ValueError before any launch (on the CPU ``th_core_fwd`` is
    the twin)."""
    q12, k12, v12, _ = _bands(1, 20, 12, 0)
    q, k, v, _ = _bands(1, 20, 8, 0)
    wide = torch.zeros(1, 20, 8 * 64, dtype=torch.bfloat16)
    for *bands, heads in ((q12, k12, v12, 12), (wide, wide, wide, 8),
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

    step = cols if heads <= 8 else cols // 2        # keys a product takes
    group = min(heads, 8)                           # heads a second sweep
    for r0 in range(0, l, rows):
        rr = span(r0, rows)
        mx = torch.full((b, heads, rr.stop - r0), -torch.inf)
        sm = torch.zeros_like(mx)
        for c0 in range(0, l, cols):                # sweep 1
            x = logits(rr, c0)
            for h0 in range(0, cols, step):
                xh = x[..., h0:h0 + step]
                m_new = torch.maximum(mx, xh.amax(dim=-1))
                base = torch.where(m_new == -torch.inf, 0.0, m_new)
                sm = sm * torch.exp2(mx - base) + torch.exp2(
                    xh - base[..., None]).sum(dim=-1)
                mx = m_new
        l2 = mx + torch.log2(sm)
        lse2[:, :, rr] = l2
        for g0 in range(0, heads, group):           # sweep 2, a pass a group
            for c0 in range(0, l, cols):
                cc = span(c0, cols)
                pn = torch.exp2(logits(rr, c0)
                                - l2[..., None])[..., :cc.stop - c0]
                pt = torch.einsum('ji,bjqk->biqk', post[:, g0:g0 + group],
                                  pn).bfloat16().float()
                attn[:, rr, g0:g0 + group] += torch.einsum(
                    'bhqk,bkhd->bqhd', pt, v4[:, cc, g0:g0 + group])
    return attn.reshape(b, l, hd).to(q.dtype), lse2 / th.LOG2E


def _hold(got, want):
    (attn, lse), (w_attn, w_lse) = got, want
    attn_err = float((attn.float() - w_attn.float()).abs().max()
                     / w_attn.float().abs().max())
    lse_err = float((lse - w_lse).abs().max())
    assert attn_err <= ATTN_TOL, attn_err
    assert lse_err <= LSE_TOL, lse_err


@pytest.mark.parametrize('b,l,heads', [(2, 5, 4), (2, 17, 8), (1, 80, 4),
                                       (1, 130, 8), (2, 21, 16), (1, 70, 16),
                                       (2, 37, 6), (1, 80, 6)])
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


def _span_inputs(b, l, dim, heads, seed):
    rng = np.random.RandomState(seed)
    hd = heads * 48
    mk = lambda shape, std: torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32))
    x = mk((b, l, dim), 1.0).bfloat16()
    scale, bias = 1.0 + mk((dim,), 0.1), mk((dim,), 0.1)
    ws = [mk((dim, hd), s / np.sqrt(dim)).bfloat16() for s in (4, 1, 1)]
    ws.append(mk((hd, dim), 1 / np.sqrt(hd)).bfloat16())
    mixes = [torch.from_numpy((np.eye(heads) + 0.3 * rng.standard_normal(
        (heads, heads))).astype(np.float32)) for _ in range(2)]
    return x, scale, bias, ws, mixes


def _gemm(a, w, sc=1.0):
    """The projection GEMM's arithmetic: bf16 operands, one f32 sum, q's
    scale on the f32 result, one rounding."""
    return ((a.float() @ w.float()) * sc).to(a.dtype)


def k5a_algebra(x, scale, bias, wq, wk, wv, wo, m_pre, m_post, heads):
    """K5a on the card in torch (test only): (out, (q, k, v, attn, lse))
    like ``th_attention_fwd_plain`` with ``save_residuals``."""
    y = fl._layernorm(x, scale, bias, fl.LN_EPS)[0]
    q, k, v = _gemm(y, wq, 48 ** -0.5), _gemm(y, wk), _gemm(y, wv)
    attn, lse = kernel_algebra(q, k, v, m_pre, m_post, heads)
    return _gemm(attn, wo), (q, k, v, attn, lse)


def _rel_ok(ours, ref):
    err = float((ours.float() - ref.float()).abs().max()
                / ref.float().abs().max())
    assert err <= ATTN_TOL, err


def _hold_span(got, want):
    (out, res), (w_out, w_res) = got, want
    for ours, ref in zip((out, *res[:4]), (w_out, *w_res[:4])):
        _rel_ok(ours, ref)
    lse_err = float((res[4] - w_res[4]).abs().max())
    assert lse_err <= LSE_TOL, lse_err


@pytest.mark.parametrize('b,l', [(2, 68), (1, 130)])
def test_k5a_algebra_matches_twin(b, l):
    x, scale, bias, ws, m = _span_inputs(b, l, 128, 8, l)
    _hold_span(k5a_algebra(x, scale, bias, *ws, *m, 8),
               th.th_attention_fwd_plain(x, scale, bias, *ws, *m, 8,
                                         save_residuals=True))


def test_k5a_algebra_matches_twin_at_16_heads():
    """cait_m's head geometry (16 heads of 48) at D = 128, L = 68."""
    x, scale, bias, ws, m = _span_inputs(1, 68, 128, 16, 3)
    _hold_span(k5a_algebra(x, scale, bias, *ws, *m, 16),
               th.th_attention_fwd_plain(x, scale, bias, *ws, *m, 16,
                                         save_residuals=True))


def test_k5a_algebra_matches_jax_fused_kernel():
    """At L = 68, H = 8, D = 128: the JAX package's K5a (``_th_fwd_kernel``
    through its launcher, Pallas interpret mode on the CPU) on the same
    bf16 inputs, stage by stage so that each stage sees the same bf16
    operands (one q element rounded to its neighbour moves attn by more
    than a rounding): q, k, v from x; the core from the JAX q, k, v; out
    from the JAX attn. Its rows past L are padding."""
    b, l, dim, heads = 1, 68, 128, 8
    x, scale, bias, ws, m = _span_inputs(b, l, dim, heads, 5)
    j = lambda t: jnp.asarray(t.float().numpy())
    fwd = jax.jit(functools.partial(
        jax_th._th_fused_fwd, heads=heads, dp=48, d_logical=48,
        eps=fl.LN_EPS, residual=False, save_residuals=True))
    out, res = fwd(j(x).astype(jnp.bfloat16), j(scale), j(bias),
                   *[j(w).astype(jnp.bfloat16) for w in ws], j(m[0]),
                   j(m[1]))
    back = lambda a: torch.from_numpy(
        np.array(a[:, :l].astype(jnp.float32))).bfloat16()
    jq, jk, jv, jattn = (back(t) for t in res[:4])
    jlse = torch.from_numpy(np.array(res[4][:, :, :l, 0], np.float32))
    _, (q, k, v, _, _) = k5a_algebra(x, scale, bias, *ws, *m, heads)
    for ours, ref in zip((q, k, v), (jq, jk, jv)):
        _rel_ok(ours, ref)
    _hold(kernel_algebra(jq, jk, jv, *m, heads), (jattn, jlse))
    _rel_ok(_gemm(jattn, ws[3]), back(out))
