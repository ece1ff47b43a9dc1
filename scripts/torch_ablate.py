"""Where a kernel's time goes: the kernel timed beside copies of its source
with parts taken out, through the same C entries, on one card.

    python scripts/torch_ablate.py k2      # csrc/flash_bwd.cu, ViT @224 bs192
    python scripts/torch_ablate.py k3      # csrc/flash_bwd_split.cu, @384 bs48
    python scripts/torch_ablate.py th      # csrc/th_bwd.cu, CaiT-S/24 @384
                                           # bs48, @224 bs128
    python scripts/torch_ablate.py th_fwd  # csrc/th_fwd_sm90.cuh (K6a),
                                           # CaiT-S/24 @384 bs48 and bs32
    python scripts/torch_ablate.py k16     # csrc/ff_bwd_sm90.cuh (K16),
                                           # ViT-B/16 @224 bs192's rows
    python scripts/torch_ablate.py k8b     # csrc/mixer_bwd_sm90.cuh (K8b),
                                           # Mixer-B/16 bs192
    python scripts/torch_ablate.py k14     # csrc/int8_dx_sm90.cuh (K14),
                                           # ViT-B/16 bs192's and CaiT-S/24
                                           # bs128's FF rows
    python scripts/torch_ablate.py k13     # csrc/int8_ff_sm90.cuh (K13 with
                                           # hpre), ViT-B/16 bs192's rows
    python scripts/torch_ablate.py k12     # (K12 with hpre) Mixer-B/16
                                           # bs192's, CaiT-S/24 bs128's
    python scripts/torch_ablate.py k13s    # serving: ViT-B/16 bs32's rows
    python scripts/torch_ablate.py k12s    # Mixer-B/16's, CaiT-S/24's bs32
    python scripts/torch_ablate.py k1      # csrc/fused_attention.cu (K1),
                                           # ViT-B/16 @224 bs192 and bs32,
                                           # TNT-S bs64 and TNT-B bs32
    python scripts/torch_ablate.py k5a     # csrc/th_attention.cu (K5a),
                                           # CaiT-S/24 @224 bs128 and bs32
    python scripts/torch_ablate.py k8a     # csrc/mixer_bwd_sm90.cuh (K8a),
                                           # Mixer-B/16 bs192 and bs32
    python scripts/torch_ablate.py k7b     # csrc/tnt_inner.cu (K7b), TNT-S
                                           # bs64 and TNT-B bs32
    python scripts/torch_ablate.py k11     # csrc/th_attention_q8.cu (K11),
                                           # CaiT-S/24 and cait_xxs_24 bs32
    python scripts/torch_ablate.py k15     # csrc/int8_matmul.cu (K15),
                                           # ViT-B/16 bs32's FF products
    python scripts/torch_ablate.py k10     # csrc/fused_attention_q8.cu
                                           # (K10), ViT-B/16 bs32, ViT-S/16
                                           # @384 bs32
    python scripts/torch_ablate.py k9b     # csrc/botnet_attention.cu (K9b),
                                           # BoTNet-T3 @224 bs64
    python scripts/torch_ablate.py k9a     # (K9a) BoTNet-T3 bs32, the
                                           # training forward bs64
    python scripts/torch_ablate.py k7a     # csrc/tnt_inner.cu (K7a), TNT-S
                                           # bs32 and bs64, TNT-B bs32
    python scripts/torch_ablate.py k1_mma --csrc OLD/sav_tpu_torch/csrc
    python scripts/torch_ablate.py k5a_mma --csrc OLD/sav_tpu_torch/csrc
    python scripts/torch_ablate.py k16_mma --csrc OLD/sav_tpu_torch/csrc
    python scripts/torch_ablate.py th_fwd_mma --csrc OLD/sav_tpu_torch/csrc
    python scripts/torch_ablate.py k8b_mma --csrc OLD/sav_tpu_torch/csrc
    python scripts/torch_ablate.py k14_mma --csrc OLD/sav_tpu_torch/csrc
    python scripts/torch_ablate.py k8a_mma --csrc OLD/sav_tpu_torch/csrc
    python scripts/torch_ablate.py k7b_mma --csrc OLD/sav_tpu_torch/csrc
    python scripts/torch_ablate.py k12_mma --csrc OLD/sav_tpu_torch/csrc
    python scripts/torch_ablate.py k13_mma --csrc OLD/sav_tpu_torch/csrc
    python scripts/torch_ablate.py k7a_mma --csrc OLD/sav_tpu_torch/csrc
    python scripts/torch_ablate.py k9a_mma --csrc OLD/sav_tpu_torch/csrc
    python scripts/torch_ablate.py k13 --same-as k13_mma \\
        --other-csrc OLD/sav_tpu_torch/csrc   # outputs bit for bit

Each variant of the kernel's table (``KERNELS``) is the source with the
headers it names (the shared pieces, the exp among them) inlined and its
edits applied, built into its own library under ``--build`` (all ``nvcc``
runs at once). ``--csrc`` reads the sources of another checkout (the
``*_mma`` entries ablate the ``mma.sync`` K16 and K6a that
``csrc/ff_bwd.cu`` and ``csrc/th_attention.cu`` ran before their Hopper
kernels: point it at an older checkout's ``csrc/``). K2's variants:
  full     the source as it is;
  short_b  phase B (dq = ds K) runs one 16-key step instead of all of them;
  no_ds    phase A stores no ds^T to shared memory (phase B then reads
           whatever the tiles hold);
  no_exp   2^x replaced by x (no special-function unit work).
K3's (K3a and K3b):
  full, no_exp as above;
  no_math  p and ds not formed: the products run on the raw s and dp, so
           what is left is the products, the packing, the TMA ring, the
           barriers and the epilogues.
The talking-heads backward's (csrc/th_bwd.cu, K5b and K6b: one C entry
for its three kernels), at K6b's shape and K5b's:
  full, no_exp as above;
  no_mix   every [H, H] mix is the identity (each head's value passes
           through; the compiler folds the zero weights away);
  no_dm    the dM_pre and dM_post sums are not accumulated;
  no_acc   the accumulate warpgroup issues no products (dq, dk, dv stay
           zero): what its wgmmas cost beside the mixes;
  no_products  the mix warpgroup issues no products (s and da are made
           from the descriptors): what its own wgmmas cost.
K6a's (``th_fwd``): full, no_exp, no_mix and no_acc as above; no_qk, the
mix warpgroup's q k^T products made from the descriptors. The older
``mma.sync`` K6a's (``th_fwd_mma``): full, no_exp, no_mix; no_f32_tile,
the per-head logits neither stored to nor reloaded from f32 shared memory.
K16's (``k16``, and ``k16_mma`` for the older five launches): full;
no_epi, dgact stored as bf16 with no gelu', no h and no column sums;
no_dw, the weight-gradient products and their sum not launched (``k16``
also no_tanh, the gelu's tanh replaced by a multiply).
K8b's (``k8b``): full; no_y, no_gact, no_dy (the band kernel stores no y,
no gact and bf16(dhp), no f32 dy); no_ln (the LN row pass not launched);
no_dw (the dW GEMM and its sums not launched). The older ``mma.sync`` K8b's
(``k8b_mma``): full; no_wload (the band blocks' W1/W2 loads skipped),
no_sums (their db2, db1, row-sum and dscale/dbias loops skipped), no_dw.
K8a's (``k8a``, the forward band kernel of ``csrc/mixer_bwd_sm90.cuh``):
full; no_epi (the epilogue skipped: the x tile stored as loaded);
fetch_at_start (the next unit's x and statistics fetched at the unit's
start instead of as its products start); no_ln (the first product's A
not normalised). The parent's ``mma.sync`` K8a (``k8a_mma``): full;
no_wload. K7b's (``k7b``, ``csrc/tnt_inner.cu``): full; no_points (the
weight-gradient product points multiply nothing; their barriers stay);
no_attn (the attention backward's two passes skipped); no_attn_fwd (its
forward recompute skipped); no_ff (the FF products and gelu skipped);
no_ln_sums (the LayerNorm backwards' column sums skipped). The parent's
K7b (``k7b_mma``: a warp a patch writing the dW operand rows, four tiled
GEMMs over them): full; no_rows (no operand rows stored); no_dw (the
GEMMs and their sum not launched).
K14's (``k14``): full; no_epi (the dh passes' elementwise work skipped),
no_tanh, no_quant (the codes by a cast), no_hload, no_store (the staging
tiles neither loaded nor stored), no_turn (the teams multiply at once).
The older 48-row-band K14's (``k14_mma``): full; no_sweep1 (one pass of
the first product, its row scale fixed), w_once (each warp's weight
fragments loaded once), no_hpre (a constant for hpre).
K12's and K13's (``k12``, ``k13``, serving ``k12s``, ``k13s``): full;
no_epi (the first product's elementwise work skipped), no_tanh (the
gelu's tanh by a multiply), no_store (no staging tile stored), no_out (the
second product not launched). The older 48-row-band K12's and K13's
(``k12_mma``, ``k13_mma``, with hpre): full; no_sweep1 (the first sweep
not run, the hidden scale fixed), w_once, no_gelu (the identity for the
gelu), no_hpre (no hpre stored), no_second (the second product skipped).
K1's and K5a's (``k1``, ``k5a``; ``k1_mma`` and ``k5a_mma`` for an older
checkout's entries on the mma.sync GEMMs and resident core): full;
no_core, the attention launch (K4's kernel, or the talking-heads core)
not run; the Hopper GEMM's (``k1``, ``k5a``) no_epi, its epilogue (the
staging tile and its TMA stores) skipped, and no_mma, its products skipped (the TMA ring alone); their
yardsticks
are the library chain (LN, matmuls, SDPA) and, for K5a, K6a's core
(``th_core_fwd``) on the same q, k, v and the blocked route's forward (K5a
also at CaiT @384's L = 576, B = 48, where the router takes that route).
K11's, K15's, K10's, K9b's, K7a's and K9a's variants are listed beside
their tables (``K11_VARIANTS``, ``K15_VARIANTS``, ``K10_VARIANTS``,
``K9B_VARIANTS``, ``K7A_VARIANTS``, ``K9A_VARIANTS``; the parent's
``mma.sync`` K7a and K9a, ``k7a_mma`` and ``k9a_mma``, in
``K7A_MMA_VARIANTS`` and ``K9A_MMA_VARIANTS``: point ``--csrc`` at an
older checkout, whose C entries took the bf16 weights prepared).
The outputs of the ablated variants are wrong by design; only their times
mean something. Each launch of the full variant is also timed on its own
(torch.profiler). Every variant is timed twice, the variants in order and
then in reverse, with ``sav_tpu_torch.utils.timing.time_ms`` (mean of 20
calls after 3, CUDA events); then the yardsticks on the same inputs: the other backward route and
SDPA's backward (K2's other route is the K3 pair; K3's at L = 577 has
none), the per-op torch chains (TH), the autograd chain (K16).

Needs an NVIDIA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sav_tpu_torch import _build  # noqa: E402
from sav_tpu_torch.ops import flash_attention as fa  # noqa: E402
from sav_tpu_torch.ops import fused_layer as fl  # noqa: E402
from sav_tpu_torch.ops import th_attention as th  # noqa: E402
from sav_tpu_torch.utils.timing import launch_ms, time_ms  # noqa: E402

NO_EXP = ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
          '  y = x;')

def _flash_inputs(b, seq, heads):
    gen = torch.Generator(device='cuda').manual_seed(0)
    band = lambda s: (torch.randn(b, seq, heads * 64, device='cuda',
                                  generator=gen) * s).bfloat16()
    t = dict(q=band(0.5), k=band(1.0), v=band(1.0), do=band(1.0))
    t['out'], t['lse'] = fa.flash_fwd(t['q'], t['k'], t['v'], heads, seq)
    _, t['delta'] = fa.bwd_dq(t['q'], t['k'], t['v'], t['out'], t['lse'],
                              t['do'], heads, seq)
    t.update(dq=torch.empty_like(t['q']), dk=torch.empty_like(t['k']),
             dv=torch.empty_like(t['v']), dl=torch.empty_like(t['lse']))
    return t


def _th_inputs(b, seq, heads):
    """CaiT's core backward inputs (q pre-scaled, mixes near the identity,
    lse from K6a) and its scratch, as th_attention._core_bwd makes them."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    band = lambda s: (torch.randn(b, seq, heads * th.HEAD_CH, device='cuda',
                                  generator=gen) * s).bfloat16()
    t = dict(q=band(0.4), k=band(1.0), v=band(1.0), do=band(1.0))
    t['mpre'], t['mpost'] = (
        torch.eye(heads, device='cuda')
        + 0.3 * torch.randn(heads, heads, device='cuda', generator=gen)
        for _ in range(2))
    _, t['lse'] = th.th_core_fwd(t['q'], t['k'], t['v'], t['mpre'],
                                 t['mpost'], heads)
    t.update(dq=torch.empty_like(t['q']), dk=torch.empty_like(t['k']),
             dv=torch.empty_like(t['v']), delta=torch.empty_like(t['lse']),
             dm=th._dm_partials(b, seq, heads, 'cuda'),
             mix=torch.stack((t['mpre'], t['mpre'] * th.LOG2E,
                              t['mpost'])).contiguous())
    return t


def _k16_inputs(m, dim, hidden):
    """The FF backward's operands at ViT-B/16 @224 bs192 (M = 192 x 197)
    and the outputs and scratch of its C entry (``part``, ``dw``: the
    split-K partials and the weight gradients of ``csrc/ff_bwd.cu``;
    ``dw1``, ``dw2``: the parent's)."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    mk = lambda *s, std=1.0: (torch.randn(*s, device='cuda', generator=gen)
                              * std).bfloat16()
    f32 = lambda *s: torch.empty(*s, device='cuda')
    plan = fl.ff_bwd_plan(m, dim, hidden, torch.cuda.get_device_properties(
        0).multi_processor_count)
    return dict(g=mk(m, dim), hpre=mk(m, hidden), y=mk(m, dim),
                w1=mk(dim, hidden, std=dim ** -0.5),
                w2=mk(hidden, dim, std=hidden ** -0.5),
                dh=mk(m, hidden), h=mk(m, hidden), dy=mk(m, dim),
                dw1=f32(dim, hidden), dw2=f32(hidden, dim), db1=f32(hidden),
                colsum=f32(-(-m // 128), hidden),
                part=f32(plan['part_floats']), dw=f32(2 * dim * hidden),
                chunks=plan['chunks'])


def _k16_library(t, m, dim, hidden):
    """The same function through autograd (timed only)."""
    leaves = [t[n].detach().requires_grad_() for n in ('hpre', 'y', 'w1',
                                                       'w2')]

    def fwd():
        hp, y, w1, w2 = leaves
        return F.gelu(hp, approximate='tanh') @ w2, y @ w1

    def both():
        out, z = fwd()
        dh, _ = torch.autograd.grad(out, (leaves[0], leaves[3]), t['g'])
        return torch.autograd.grad(z, (leaves[1], leaves[2]), dh)

    return (f'autograd chain backward {time_ms(both) - time_ms(fwd):.4f} ms '
            f'at M={m} D={dim} F={hidden}')


def _th_fwd_inputs(b, seq, heads):
    """K6a's inputs (q pre-scaled, mixes near the identity) and outputs."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    band = lambda s: (torch.randn(b, seq, heads * th.HEAD_CH, device='cuda',
                                  generator=gen) * s).bfloat16()
    t = dict(q=band(0.4), k=band(1.0), v=band(1.0))
    t['mpre'], t['mpost'] = (
        torch.eye(heads, device='cuda')
        + 0.3 * torch.randn(heads, heads, device='cuda', generator=gen)
        for _ in range(2))
    t.update(attn=torch.empty_like(t['q']),
             lse=torch.empty(b, heads, seq, device='cuda'),
             mix=th._mix_bank(t['mpre'], t['mpost'], heads, 'cuda'))
    return t


def _th_chain_fwd(t, b, seq, heads):
    """The per-op torch chain of the forward on the same inputs (timed
    only)."""
    split = lambda a: a.view(b, seq, heads, th.HEAD_CH).transpose(1, 2)

    def chain():
        s = split(t['q']) @ split(t['k']).transpose(-1, -2)
        s = torch.einsum('hi,bhqk->biqk', t['mpre'].bfloat16(), s)
        p = torch.einsum('hi,bhqk->biqk', t['mpost'].bfloat16(),
                         s.softmax(-1))
        return p @ split(t['v'])

    plain = time_ms(lambda: th.th_core_fwd_plain(
        t['q'], t['k'], t['v'], t['mpre'], t['mpost'], heads), iters=3)
    return (f'per-op chain forward {time_ms(chain):.4f} ms, plain twin '
            f'{plain:.4f} ms at B={b} L={seq} H={heads}')


def _sdpa_bwd(t, b, seq, heads):
    """SDPA's backward on the same inputs (fwd+bwd minus fwd)."""
    head_major = lambda a: a.view(b, seq, heads, 64).transpose(1, 2)
    qs, ks, vs = (head_major(t[n]).detach().requires_grad_()
                  for n in ('q', 'k', 'v'))
    fwd = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                         scale=1.0))
    both = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qs, ks, vs, scale=1.0), (qs, ks, vs),
        head_major(t['do'])))
    return (f'SDPA backward {both - fwd:.4f} ms (fwd+bwd {both:.4f} - fwd '
            f'{fwd:.4f}) at B={b} L={seq} H={heads}')


def _th_chain_bwd(t, b, seq, heads):
    """The per-op torch chain's backward on the same inputs (timed only)."""
    split = lambda a: a.view(b, seq, heads, th.HEAD_CH).transpose(1, 2)
    leaves = [t[n].detach().requires_grad_() for n in ('q', 'k', 'v')]

    def chain():
        s = split(leaves[0]) @ split(leaves[1]).transpose(-1, -2)
        s = torch.einsum('hi,bhqk->biqk', t['mpre'].bfloat16(), s)
        p = torch.einsum('hi,bhqk->biqk', t['mpost'].bfloat16(),
                         s.softmax(-1))
        return (p @ split(leaves[2])).transpose(1, 2).reshape(b, seq, -1)

    fwd = time_ms(chain)
    both = time_ms(lambda: torch.autograd.grad(chain(), leaves, t['do']))
    plain = time_ms(lambda: th.th_core_bwd_plain(
        t['q'], t['k'], t['v'], t['do'], t['lse'], t['mpre'], t['mpost'],
        heads), iters=3)
    return (f'per-op chain backward {both - fwd:.4f} ms, plain twin '
            f'{plain:.4f} ms at B={b} L={seq} H={heads}')


def _k8b_inputs(b, l, k, d):
    """The token-mixing backward's operands at Mixer-B/16 bs192 (x, the
    cotangent g, the LN and FF parameters as the kernels read them) and
    the outputs and workspace of its C entry."""
    from sav_tpu_torch.ops import mixer_token as mt
    gen = torch.Generator(device='cuda').manual_seed(0)
    mk = lambda *s, std=1.0: (torch.randn(*s, device='cuda', generator=gen)
                              * std).bfloat16()
    f32 = lambda *s: torch.empty(*s, device='cuda')
    ws = mt._fn('sav_mixer_bwd_workspace', 0, 4,
                restype=ctypes.c_longlong)(b, l, k, d)
    return dict(x=mk(b, l, d), g=mk(b, l, d),
                ls=(1 + 0.1 * mk(d)).float(), lb=(0.1 * mk(d)).float(),
                w1=mk(l, k, std=l ** -0.5), b1=(0.1 * mk(k)).float(),
                w2=mk(k, l, std=k ** -0.5), b2=(0.1 * mk(l)).float(),
                dx=mk(b, l, d), dls=f32(d), dlb=f32(d), dw1=f32(l, k),
                db1=f32(k), dw2=f32(k, l), db2=f32(l),
                ws=torch.empty(ws, dtype=torch.uint8, device='cuda'))


def _k8b_library(t, b, l, k, d):
    """The per-op bf16 chain's autograd backward on the same inputs (timed
    only), as chip_smoke.py's K8b yardstick."""
    leaves = [t[n].detach().requires_grad_()
              for n in ('x', 'ls', 'lb', 'w1', 'b1', 'w2', 'b2')]

    def fwd():
        x, ls, lb, w1, b1, w2, b2 = leaves
        y = F.layer_norm(x, (d,), ls.bfloat16(), lb.bfloat16(), 1e-6)
        h = F.gelu(y.transpose(1, 2) @ w1 + b1.bfloat16(), approximate='tanh')
        return x + (h @ w2 + b2.bfloat16()).transpose(1, 2)

    both = time_ms(lambda: torch.autograd.grad(fwd(), leaves, t['g']))
    return (f'per-op chain backward {both - time_ms(fwd):.4f} ms at B={b} '
            f'L={l} K={k} D={d}')


def _k8a_inputs(b, l, k, d):
    """The token-mixing forward's operands at Mixer-B/16 (``_k8b_inputs``'s
    x and parameters), its row-statistics scratch and its output."""
    t = _k8b_inputs(b, l, k, d)
    return dict(t, stats=torch.empty(b * l, 2, device='cuda'),
                out=torch.empty_like(t['x']))


def _k8a_library(t, b, l, k, d):
    """The per-op bf16 chain on the same inputs (timed only), as
    chip_smoke.py's K8a yardstick."""
    def fwd():
        y = F.layer_norm(t['x'], (d,), t['ls'].bfloat16(), t['lb'].bfloat16(),
                         1e-6)
        h = F.gelu(y.transpose(1, 2) @ t['w1'] + t['b1'].bfloat16(),
                   approximate='tanh')
        return t['x'] + (h @ t['w2'] + t['b2'].bfloat16()).transpose(1, 2)

    return f'per-op chain {time_ms(fwd):.4f} ms at B={b} L={l} K={k} D={d}'


def _k7b_inputs(n, d, f, h):
    """The TNT inner layer's backward operands at n patches of width d (x,
    the cotangent g, the parameters as the model holds them and, for the
    parent's entry, as it prepared them), its outputs and the workspace
    its C entry asks for."""
    from sav_tpu_torch.ops import tnt_inner
    x, p = _k7_params(n, d, f, h)
    ws = tnt_inner._fn('sav_tnt_bwd_workspace', 0, 4,
                       restype=ctypes.c_longlong)(n, d, f, h)
    gen = torch.Generator(device='cuda').manual_seed(1)
    return dict(x=x, g=torch.randn(n, 16, d, device='cuda',
                                   generator=gen).bfloat16(),
                **p, **_k7_prepared(x, p, d), dx=torch.empty_like(x),
                gw=torch.empty(4 * d * d + 2 * d * f, device='cuda'),
                gvec=torch.empty(5 * d + f, device='cuda'),
                ws=torch.empty(ws, dtype=torch.uint8, device='cuda'))


def _k7b_library(t, n, d, f, h):
    """The per-op bf16 chain's autograd backward on the same inputs (LN,
    matmuls, SDPA, gelu; timed only), as chip_smoke.py's K7b yardstick."""
    leaves = [t[k].detach().requires_grad_() for k in ('x', 'wqkv', 'wo',
                                                      'w1', 'w2')]
    par = t['par'].bfloat16()
    ln1s, ln1b, ln2s, ln2b, b2 = par[:5 * d].view(5, d)
    b1 = par[5 * d:]
    split = lambda a: a.view(n, 16, h, d // h).transpose(1, 2)

    def fwd():
        x, wqkv, wo, w1, w2 = leaves
        y = F.layer_norm(x, (d,), ln1s, ln1b, 1e-6)
        a = F.scaled_dot_product_attention(*(split(y @ w) for w in
                                             wqkv.split(d, dim=1)))
        x2 = x + a.transpose(1, 2).reshape(n, 16, d) @ wo
        hh = F.gelu(F.layer_norm(x2, (d,), ln2s, ln2b, 1e-6) @ w1 + b1,
                    approximate='tanh')
        return x2 + hh @ w2 + b2

    both = time_ms(lambda: torch.autograd.grad(fwd(), leaves, t['g']))
    return (f'per-op chain backward {both - time_ms(fwd):.4f} ms at B*P={n} '
            f'D={d} F={f} H={h}')


def _k7_params(n, d, f, h):
    """x [n, 16, d] bf16 and the inner layer's twelve parameters in
    checkpoint layout, f32 as the model holds them (seed 0)."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    mk = lambda *s, std=1.0: (torch.randn(*s, device='cuda', generator=gen)
                              * std)
    hd = d // h
    x = mk(n, 16, d).bfloat16()
    params = dict(
        ln1s=1 + mk(d, std=0.1), ln1b=mk(d, std=0.1),
        wq=mk(d, h, hd, std=2 * d ** -0.5), wk=mk(d, h, hd, std=d ** -0.5),
        wv=mk(d, h, hd, std=d ** -0.5), wo=mk(h, hd, d, std=d ** -0.5),
        ln2s=1 + mk(d, std=0.1), ln2b=mk(d, std=0.1),
        w1=mk(d, f, std=d ** -0.5), b1=mk(f, std=0.1),
        w2=mk(f, d, std=f ** -0.5), b2=mk(d, std=0.1))
    return x, params


def _k7_prepared(x, p, d):
    """The bf16 weights and the f32 vector that the parent's K7 C entries
    took (wqkv [D, 3D], wo, w1, w2 in bf16; ln1 scale, ln1 bias, ln2 scale,
    ln2 bias, b2, b1 as one f32 vector), prepared here once."""
    cast = lambda t: t.to(torch.bfloat16).contiguous()
    wqkv = torch.cat([p[k].reshape(d, d) for k in ('wq', 'wk', 'wv')], 1)
    par = torch.cat([p[k] for k in ('ln1s', 'ln1b', 'ln2s', 'ln2b', 'b2',
                                    'b1')]).float().contiguous()
    return dict(wqkv=cast(wqkv), wo=cast(p['wo'].reshape(d, d)),
                w1=cast(p['w1']), w2=cast(p['w2']), par=par)


def _k7a_mma_inputs(n, d, f, h):
    """The parent's K7a operands (its prepared weights) and its output."""
    x, p = _k7_params(n, d, f, h)
    return dict(x=x, out=torch.empty_like(x), **_k7_prepared(x, p, d))


def _k9a_inputs(b, g, heads, d, train):
    """K9a's operands at a g x g grid (qs pre-scaled, k, v, rel_h, rel_w)
    and its outputs (out; lse for the training forward, else None)."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    mk = lambda *s, std=1.0: torch.randn(*s, device='cuda', generator=gen) * std
    length, hd = g * g, heads * d
    t = dict(qs=mk(b, length, hd, std=2 / d ** 0.5).bfloat16(),
             k=mk(b, length, hd).bfloat16(), v=mk(b, length, hd).bfloat16(),
             rh=mk(b, heads, length, g, std=0.5),
             rw=mk(b, heads, length, g, std=0.5))
    t['out'] = torch.empty_like(t['qs'])
    t['lse'] = (torch.empty(b, heads, length, device='cuda') if train
                else None)
    return t


def _k9a_library(t, b, g, heads, d, train):
    """One SDPA call with the bias expanded to [B, h, L, L] (the expansion
    included), as chip_smoke.py's K9a yardstick."""
    from sav_tpu_torch.ops import botnet_attention as bot
    length = g * g
    split = lambda a: a.view(b, length, heads, d).transpose(1, 2)

    def run():
        bias_h, bias_w = bot.expand_bias(t['rh'], t['rw'], g)
        return F.scaled_dot_product_attention(
            split(t['qs']), split(t['k']), split(t['v']),
            attn_mask=(bias_h + bias_w).to(torch.bfloat16), scale=1.0)

    return f'SDPA with the expanded bias {time_ms(run):.4f} ms'


K9A_ARGS = ('qs', 'k', 'v', 'rh', 'rw', 'out', 'lse')
K7A_ARGS = ('x', 'ln1s', 'ln1b', 'wq', 'wk', 'wv', 'wo', 'ln2s', 'ln2b',
            'w1', 'b1', 'w2', 'b2', 'out')


def _k7a_inputs(n, d, f, h):
    """K7a's operands as the model holds them (x bf16, the parameters f32
    in checkpoint layout) and its output."""
    x, p = _k7_params(n, d, f, h)
    return dict(x=x, out=torch.empty_like(x), **p)


# the Hopper K7a (4-patch units on wgmma): no_stage, the block's weights
# not converted from the fetched f32 parameters (the products read
# whatever shared memory holds); no_attn, the attention skipped; no_ln,
# both LayerNorms' statistics not formed (mu 0, 1/sigma 1); no_gelu, the
# identity for the gelu; tanhf, the gelu's tanh by tanhf; no_products, no
# wgmma issued (the accumulators stay zero); no_store, out not stored;
# wgs5, wgs6, 5 or 6 warpgroups a block at TNT-S's widths
K7A_VARIANTS = {
    'full': [],
    'no_stage': [('  stage_weights<C>(params, base, l);\n', '')],
    'no_attn': [('    attention<C>(sq, so, lane);\n', '')],
    'no_ln': [('  const float mu0 = s0 / C::D, mu1 = s1 / C::D;\n'
               '  const float in0 = rsqrtf(fmaxf(q0 / C::D - mu0 * mu0, 0.f) '
               '+ eps);\n  const float in1 = rsqrtf(fmaxf(q1 / C::D - mu1 * '
               'mu1, 0.f) + eps);',
               '  const float mu0 = 0.f, mu1 = 0.f, in0 = 1.f, in1 = 1.f;')],
    'no_gelu': [('          hp[4 * i + e] = gelu_approx(h);',
                 '          hp[4 * i + e] = h;')],
    # the gelu's tanh by tanhf, as the twin (not the special-function unit)
    'tanhf': [('  asm("tanh.approx.f32 %0, %1;" : "=f"(t)\n'
               '      : "f"(ff::GELU_C * (h + ff::GELU_A * h * h * h)));',
               '  t = tanhf(ff::GELU_C * (h + ff::GELU_A * h * h * h));')],
    'no_products': [('    wgmma_rs_kn<N>(acc, a[kk],',
                     '    if (kk < 0) wgmma_rs_kn<N>(acc, a[kk],')],
    'no_store': [('      tma_store_3d(&tout, qkv, 0, u * UNIT, 0);\n', '')],
    # 5 and 6 warpgroups a block at TNT-S's widths (4 built)
    'wgs5': [('constexpr int MAX_WGS = 4;', 'constexpr int MAX_WGS = 5;')],
    'wgs6': [('constexpr int MAX_WGS = 4;', 'constexpr int MAX_WGS = 6;')],
}
# the Hopper K9a (104-key steps on wgmma + TMA): no_bias, the rel bias not
# added; no_pv, the p V products not issued; no_store, out not stored
K9A_VARIANTS = {
    'full': [],
    'no_bias': [('      const float x0 = (sc[4 * i + e] + r.rh0[hb]) + '
                 'r.rw0[wb];\n      const float x1 = (sc[4 * i + 2 + e] + '
                 'r.rh1[hb]) + r.rw1[wb];',
                 '      const float x0 = sc[4 * i + e];\n      const float '
                 'x1 = sc[4 * i + 2 + e];')],
    'no_pv': [('      wgmma_rs_mn(o[c], pa[kk], vd + kk * MN_STEP);',
               '      if (kk < 0) wgmma_rs_mn(o[c], pa[kk], vd + kk * '
               'MN_STEP);')],
    'no_store': [('          tma_store_3d(&to, sq + c * TILE_ELEMS, w.h * D '
                  '+ 64 * c, r0, w.b);\n', '')],
}
# BoTNet-T3 @224's BoT stage, serving bs32 and the training forward bs64
K9A_SHAPES = [(32, 14, 4, 128, False), (64, 14, 4, 128, True)]
# TNT-S/16 serving bs32 and training bs64, TNT-B/16 bs32: B*P, D, F, H
K7A_SHAPES = [(32 * 196, 24, 96, 4), (64 * 196, 24, 96, 4),
              (32 * 196, 40, 160, 4)]
# the parent's mma.sync K7a (a warp a patch): no_attn, the attention
# skipped (o as the tile held it); no_ff, the FF products and the gelu
# skipped (the epilogues still run); no_ln, both LayerNorm row passes
# skipped; stride, q, k and v at the f32 row stride D + 2 (K7b's) instead
# of Dp
K7A_MMA_VARIANTS = {
    'full': [],
    'no_attn': [('    attention_fwd<head_regs<kD, kH>(), row_unroll<kD>()>'
                 '(sQ, sK, sV, sO, g,\n', '    if (false) attention_fwd<'
                 'head_regs<kD, kH>(), row_unroll<kD>()>(sQ, sK, sV, sO, '
                 'g,\n')],
    'no_ff': [('    warp_mma<false>(sY, g.ldy, S.w1, g.ldf, f, g.dp, lane,',
               '    warp_mma<false>(sY, g.ldy, S.w1, g.ldf, f, 0, lane,'),
              ('          pack_bf16(0.5f * h0 * (1.f + gelu_t(h0)),\n'
               '                    0.5f * h1 * (1.f + gelu_t(h1)));',
               '          pack_bf16(h0, h1);'),
              ('    warp_mma<false>(sG, g.ldf, S.w2, g.ldy, g.dp, f, lane,',
               '    warp_mma<false>(sG, g.ldf, S.w2, g.ldy, g.dp, 0, lane,')],
    'no_ln': [('    ln_rows(sX, d, ln1s, ln1b, sY, sStat, g, eps, lane);\n'
               '    __syncwarp();\n    warp_mma<false>(sY, g.ldy, S.wqkv',
               '    __syncwarp();\n    warp_mma<false>(sY, g.ldy, S.wqkv'),
              ('    ln_rows(sX, d, ln2s, ln2b, sY, sStat, g, eps, lane);', '')],
    'stride': [('  float* sK = sQ + L * g.dp;\n  float* sV = sK + L * g.dp;',
                '  float* sK = sQ + L * g.lf;\n  float* sV = sK + L * g.lf;'),
               ('      dst[r * g.dp + cc] = v0 * m;\n'
                '      dst[r * g.dp + cc + 1] = v1 * m;',
                '      if (cc < d) {\n        dst[r * g.lf + cc] = v0 * m;\n'
                '        dst[r * g.lf + cc + 1] = v1 * m;\n      }'),
               ('(sQ, sK, sV, sO, g,\n                                      '
                '                   g.dp, lane);',
                '(sQ, sK, sV, sO, g,\n                                      '
                '                   g.lf, lane);')],
}
# the parent's mma.sync K9a (a 128-thread block per 64-query tile, head
# and image): no_bias, the rel bias not added; no_q4, the fourth (4-row)
# query tile's blocks not launched; no_k4, the fourth (4-key) key tile
# not swept (its rows still loaded)
K9A_MMA_VARIANTS = {
    'full': [],
    'no_bias': [('            s[nt][e] = s[nt][e] + rh0[hb] + rw0[wb];\n'
                 '            s[nt][2 + e] = s[nt][2 + e] + rh1[hb] + '
                 'rw1[wb];', '')],
    'no_q4': [('bot_fwd_kernel<D><<<dim3((L + BT - 1) / BT, heads, batch)',
               'bot_fwd_kernel<D><<<dim3(L / BT, heads, batch)')],
    'no_k4': [('  for (int it = 0, k0 = 0; k0 < L; ++it, k0 += BT) {',
               '  for (int it = 0, k0 = 0; k0 + BT <= L; ++it, k0 += BT) {')],
}


K7B_ARGS = ('x', 'g', 'ln1s', 'ln1b', 'wq', 'wk', 'wv', 'wo', 'ln2s', 'ln2b',
            'w1', 'b1', 'w2', 'b2', 'dx', 'gw', 'gvec', 'ws')
# the parent's K7b entry: the bf16 weights and the f32 vector prepared
K7B_MMA_ARGS = ('x', 'g', 'wqkv', 'wo', 'w1', 'w2', 'par', 'dx', 'gw',
                'gvec', 'ws')
# TNT-S/16 bs64's and TNT-B/16 bs32's inner layers: B*P patches, D, F, H
K7B_SHAPES = [(64 * 196, 24, 96, 4), (32 * 196, 40, 160, 4)]


def _k14_inputs(m, dim, hidden):
    """K14's operands (g at the SwitchBack scale, hpre, the weights' codes
    per IN row with their scales, as int8_ff._dx_quantized makes them) and
    its outputs."""
    from sav_tpu_torch.ops import int8_ff
    gen = torch.Generator(device='cuda').manual_seed(0)
    mk = lambda *s, std=1.0: torch.randn(*s, device='cuda', generator=gen) * std
    w1t_q, s1t = int8_ff._dx_quantized(mk(dim, hidden, std=dim ** -0.5))
    w2t_q, s2t = int8_ff._dx_quantized(mk(hidden, dim, std=hidden ** -0.5))
    return dict(g=mk(m, dim, std=0.02).bfloat16(), hpre=mk(m, hidden).bfloat16(),
                w2c=w2t_q.t().contiguous(), s2=s2t.reshape(-1).contiguous(),
                w1c=w1t_q.t().contiguous(), s1=s1t.reshape(-1).contiguous(),
                w1t_q=w1t_q, s1t=s1t, w2t_q=w2t_q, s2t=s2t,
                dy=torch.empty(m, dim, device='cuda', dtype=torch.bfloat16),
                dh=torch.empty(m, hidden, device='cuda', dtype=torch.bfloat16))


def _k14_library(t, m, dim, hidden):
    """The int8 chain of torch codes and ``torch._int_mm`` (timed only), as
    chip_smoke.py's K14 yardstick."""
    from sav_tpu_torch.ops import int8_matmul_kernel as k15
    w1c, w2c = t['w1t_q'].contiguous(), t['w2t_q'].contiguous()

    def chain():
        q, s = k15._quantize_tile(t['g'])
        dgact = torch._int_mm(q, w2c).float() * (s * t['s2t'])
        dh = torch.ops.aten.gelu_backward(dgact, t['hpre'].float(),
                                          approximate='tanh')
        hq, hs = k15._quantize_tile(dh)
        return (torch._int_mm(hq, w1c).float() * (hs * t['s1t'])).bfloat16()

    return f'int8 torch chain {time_ms(chain):.4f} ms at M={m} D={dim} F={hidden}'


def _k8b_sm90_inputs(b, l, k, d):
    """``_k8b_inputs`` with the workspace sized by ``mixer_bwd_plan``."""
    from sav_tpu_torch.ops import mixer_token as mt
    t = _k8b_inputs(b, l, k, d)
    t['ws'] = torch.empty(mt.mixer_bwd_plan(b, l, k, d)['workspace'],
                          dtype=torch.uint8, device='cuda')
    return t


def _k14_sm90_inputs(m, dim, hidden):
    """``_k14_inputs`` and the workspace of ``int8_dx_plan``."""
    from sav_tpu_torch.ops import int8_ff
    t = _k14_inputs(m, dim, hidden)
    t['ws'] = torch.empty(int8_ff.int8_dx_plan(m, dim, hidden)['workspace'],
                          dtype=torch.uint8, device='cuda')
    return t


def _ff_inputs(m, dim, hidden):
    """K12's and K13's operands (x, the LayerNorm's scale and bias, the
    weights' codes per column transposed as the kernels read them, their
    scales and the biases) and the outputs with hpre (the training
    variant)."""
    from sav_tpu_torch.ops import int8_ff
    gen = torch.Generator(device='cuda').manual_seed(0)
    mk = lambda *s, std=1.0: torch.randn(*s, device='cuda', generator=gen) * std
    w1_q, s1, w2_q, s2 = int8_ff._quantized_weights(
        mk(dim, hidden, std=dim ** -0.5), mk(hidden, dim, std=hidden ** -0.5))
    return dict(x=mk(m, dim).bfloat16(), ls=1 + mk(dim, std=0.1),
                lb=mk(dim, std=0.1), w1_q=w1_q, w2_q=w2_q,
                w1t=w1_q.t().contiguous(), s1=s1.reshape(-1).contiguous(),
                b1=mk(hidden, std=0.1), w2t=w2_q.t().contiguous(),
                s2=s2.reshape(-1).contiguous(), b2=mk(dim, std=0.1),
                out=torch.empty(m, dim, device='cuda', dtype=torch.bfloat16),
                hpre=torch.empty(m, hidden, device='cuda',
                                 dtype=torch.bfloat16))


def _ff_sm90_inputs(m, dim, hidden):
    """``_ff_inputs`` and the workspace of ``int8_ff_plan``."""
    from sav_tpu_torch.ops import int8_ff
    t = _ff_inputs(m, dim, hidden)
    t['ws'] = torch.empty(int8_ff.int8_ff_plan(m, dim, hidden)['workspace'],
                          dtype=torch.uint8, device='cuda')
    return t


class _Null:
    """A null pointer among the C entry's buffers."""

    @staticmethod
    def data_ptr():
        return None


def _ff_serve_inputs(m, dim, hidden):
    """``_ff_sm90_inputs`` without hpre (the serving variant)."""
    return dict(_ff_sm90_inputs(m, dim, hidden), hpre=_Null())


def _k1_inputs(b, seq, heads, dim, train, residual):
    """K1's operands (x, the LayerNorm's f32 scale and bias, wq/wk/wv [D,
    H*64] and wo [H*64, D] bf16), its scratch and its outputs; lse only for
    the training variant."""
    return _sublayer_inputs(b, seq, heads * 64, dim, train, heads)


def _k5a_inputs(b, seq, heads, dim, train, residual):
    """K5a's operands (as K1's at head width 48, and the [H, H] mixes near
    the identity), scratch and outputs."""
    t = _sublayer_inputs(b, seq, heads * th.HEAD_CH, dim, train, heads)
    gen = torch.Generator(device='cuda').manual_seed(1)
    t['mpre'], t['mpost'] = (
        torch.eye(heads, device='cuda')
        + 0.3 * torch.randn(heads, heads, device='cuda', generator=gen)
        for _ in range(2))
    t['mix'] = th._mix_bank(t['mpre'], t['mpost'], heads, 'cuda')
    return t


def _th_blocked(t, b, seq, heads, dim, train, residual):
    """The blocked route's forward on the same inputs (torch LN and
    projections around K6a's ``th_core_fwd``, the out matmul; grad off, so
    no residuals; timed only)."""
    w3 = [t[n].view(dim, heads, th.HEAD_CH) for n in ('wq', 'wk', 'wv')]
    wo = t['wo'].view(heads, th.HEAD_CH, dim)
    with torch.no_grad():
        ms = time_ms(lambda: th.th_attention_sublayer(
            t['x'], t['ls'], t['lb'], *w3, wo, t['mpre'], t['mpost'], heads,
            route='blocked'))
    return f'blocked route forward {ms:.4f} ms'


def _sublayer_inputs(b, seq, hd, dim, train, heads):
    gen = torch.Generator(device='cuda').manual_seed(0)
    mk = lambda *s, std=1.0: torch.randn(*s, device='cuda', generator=gen) * std
    bf = lambda *s: torch.empty(*s, device='cuda', dtype=torch.bfloat16)
    return dict(x=mk(b, seq, dim).bfloat16(), ls=1 + mk(dim, std=0.1),
                lb=mk(dim, std=0.1),
                wq=mk(dim, hd, std=4 * dim ** -0.5).bfloat16(),
                wk=mk(dim, hd, std=dim ** -0.5).bfloat16(),
                wv=mk(dim, hd, std=dim ** -0.5).bfloat16(),
                wo=mk(hd, dim, std=hd ** -0.5).bfloat16(),
                y=bf(b * seq, dim), qs=bf(b, seq, hd), ks=bf(b, seq, hd),
                vs=bf(b, seq, hd), attn=bf(b, seq, hd), out=bf(b, seq, dim),
                lse=(torch.empty(b, heads, seq, device='cuda') if train
                     else _Null()))


def _sublayer_chain(d):
    """The library chain of the sublayer on the same inputs (timed only):
    F.layer_norm, three matmuls (q scaled), the attention (SDPA at d = 64,
    the per-op talking-heads chain at d = 48), the out matmul, + x."""
    def other(t, b, seq, heads, dim, train, residual):
        split = lambda a: a.view(b, seq, heads, d).transpose(1, 2)

        def chain():
            y = F.layer_norm(t['x'], (dim,), t['ls'].bfloat16(),
                             t['lb'].bfloat16(), 1e-6)
            q = (y @ t['wq']) * d ** -0.5
            k, v = y @ t['wk'], y @ t['wv']
            if d == 64:
                a = F.scaled_dot_product_attention(split(q), split(k),
                                                   split(v), scale=1.0)
            else:
                s = split(q) @ split(k).transpose(-1, -2)
                s = torch.einsum('hi,bhqk->biqk', t['mpre'].bfloat16(), s)
                a = torch.einsum('hi,bhqk->biqk', t['mpost'].bfloat16(),
                                 s.softmax(-1)) @ split(v)
            out = a.transpose(1, 2).reshape(b, seq, -1) @ t['wo']
            return t['x'] + out if residual else out

        return f'library chain {time_ms(chain):.4f} ms'
    return other


def _k6a_core(t, b, seq, heads, dim, train, residual):
    """K6a's core (this checkout's ``th_core_fwd``) on the q, k, v the full
    variant left in the scratch (timed only)."""
    return 'K6a core th_core_fwd %.4f ms' % time_ms(lambda: th.th_core_fwd(
        t['qs'], t['ks'], t['vs'], t['mpre'], t['mpost'], heads))


def _ff_library(ln):
    """The int8 chain of torch codes and ``torch._int_mm`` (timed only), as
    chip_smoke.py's K12/K13 yardstick, with hpre."""
    def other(t, m, dim, hidden):
        from sav_tpu_torch.ops import int8_matmul_kernel as k15
        s1, s2 = t['s1'].reshape(1, -1), t['s2'].reshape(1, -1)

        def chain():
            y = (F.layer_norm(t['x'].float(), (dim,), t['ls'], t['lb'], 1e-6)
                 if ln else t['x'])
            q, s = k15._quantize_tile(y)
            hp = torch._int_mm(q, t['w1_q']).float() * (s * s1) + t['b1']
            hq, hs = k15._quantize_tile(F.gelu(hp, approximate='tanh'))
            out = torch._int_mm(hq, t['w2_q']).float() * (hs * s2) + t['b2']
            return (t['x'].float() + out if ln else out).bfloat16(), \
                hp.bfloat16()

        return (f'int8 torch chain {time_ms(chain):.4f} ms at M={m} D={dim} '
                f'F={hidden}')
    return other


# the int8 GEMMs' headers (K12/K13 and K14 on Hopper), each inlined once
Q8_HEADERS = ('int8_dx_sm90.cuh', 'int8_ff_sm90.cuh', 'int8_sm90.cuh')
FF_ARGS = ('x', 'ls', 'lb', 'w1_q', 's1', 'b1', 'w2_q', 's2', 'b2', 'out',
           'hpre', 'ws')
# the older band kernel's entry: the weights' codes transposed, no workspace
FF_MMA_ARGS = ('x', 'ls', 'lb', 'w1t', 's1', 'b1', 'w2t', 's2', 'b2', 'out',
               'hpre')
K12_SHAPES = [(192 * 196, 768, 3072), (128 * 196, 384, 1536)]
K13_SHAPES = [(192 * 197, 768, 3072)]
# K12's and K13's Hopper kernels with parts taken out
FF_VARIANTS = {
    'full': [],
    # the first product's elementwise work skipped (hpre, gelu, the codes,
    # the absmax; the staging tiles still stored)
    'no_epi': [('      for (int i = 0; i < 16; ++i) {\n        const int c = '
                '8 * i + 2 * t;\n        // columns past N',
                '      for (int i = 0; i < (args.m < 0 ? 16 : 0); ++i) {\n'
                '        const int c = 8 * i + 2 * t;\n        // columns '
                'past N')],
    # the gelu's tanh replaced by a multiply
    'no_tanh': [('__fadd_rn(1.f, tanhf(inner))',
                 '__fadd_rn(1.f, 0.5f * inner)')],
    # no staging tile stores (the tile is freed at once)
    'no_store': [('          tma_store_3d(&mo, stg, col0, row0, 0);\n'
                  '          if (MODE == HPRE)\n'
                  '            tma_store_3d(&mo, stg + BM * 128, col0 + 64, '
                  'row0, 0);\n', '')],
    # the second product (OUT) not launched
    'no_out': [('  if (e == cudaSuccess)\n    e = ln ? launch_out<OUT_RES>',
                '  if (e == cudaSuccess && M < 0)\n    e = ln ? '
                'launch_out<OUT_RES>')],
}


# the older 48-row-band K12/K13 (``ff_q8_kernel``) with parts taken out
FF_MMA_VARIANTS = {
    'full': [],
    # sweep 1 not run (each row's hidden scale fixed)
    'no_sweep1': [('  band_gemm<MT, 4>(xq, ldx, p.w1t, F, D,\n'
                   '                   [&](int mi, int half, int r, int '
                   'col, int v0, int v1) {\n    amax[mi][half]',
                   '  if (false) band_gemm<MT, 4>(xq, ldx, p.w1t, F, D,\n'
                   '                   [&](int mi, int half, int r, int '
                   'col, int v0, int v1) {\n    amax[mi][half]'),
                  ('    hs[r] = row_scale(m);', '    hs[r] = 0.01f;')],
    # each warp's weight fragments loaded once, reused every step
    'w_once': [('        nb[j] = more ? __ldg(reinterpret_cast<const '
                'uint4*>(brow[j] + k0 + 64))\n                     : '
                'b[j];', '        nb[j] = b[j];')],
    # the gelu replaced by the identity
    'no_gelu': [('  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, '
                 'tanhf(inner))));', '  return x;')],
    # no hpre stores
    'no_hpre': [('    if (p.hpre != nullptr && row < p.M)',
                 '    if (p.hpre != nullptr && row < 0)')],
    # the second product skipped
    'no_second': [('  band_gemm<MT, 2>(hq, ldh, p.w2t, D, F,',
                   '  if (false) band_gemm<MT, 2>(hq, ldh, p.w2t, D, F,')],
}


# K1's attention launch not run
K1_VARIANTS = {
    'full': [],
    'no_core': [('  const int att = k4::flash_fwd(',
                 '  const int att = M >= 0 ? 0 : k4::flash_fwd(')],
}
# the projection GEMM (csrc/proj_sm90.cuh) without its epilogue's stores,
# or without its products (what the TMA ring alone costs)
PROJ_VARIANTS = {
    'no_epi': [('    if (leader) bulk_wait_read();',
                '    if (args.m >= 0) continue;\n    if (leader) '
                'bulk_wait_read();')],
    'no_mma': [('        wgmma_kmn<BN>(acc, da + kk * K_STEP, db + kk * '
                'MN_STEP);', '        ;')],
}
K5A_SHAPES = [(128, 196, 8, 384, True, False),
              (32, 196, 8, 384, False, False)]
# K5a's core launch not run
K5A_NO_CORE = [('  err = heads == 4\n',
                '  err = M >= 0 ? cudaSuccess : heads == 4\n')]


def _k11_inputs(b, seq, heads, dim):
    """K11's operands (x, the LayerNorm's f32 scale and bias, the weight
    codes [D, H*48] x 3 and [H*48, D] with their f32 column scales, the
    [3, H, H] mix bank), its workspace and its output."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    mk = lambda *s, std=1.0: torch.randn(*s, device='cuda', generator=gen) * std
    hd = heads * th.HEAD_CH
    ws = [mk(dim, heads, th.HEAD_CH, std=s / dim ** 0.5) for s in (4, 1, 1)]
    ws.append(mk(heads, th.HEAD_CH, dim, std=hd ** -0.5))
    codes = fl._q8_weights(*ws, dim, hd)
    t = dict(x=mk(b, seq, dim).bfloat16(), ls=1 + 0.1 * mk(dim),
             lb=0.1 * mk(dim), out=torch.empty(b, seq, dim, device='cuda',
                                               dtype=torch.bfloat16))
    for name, (c, sc), n in zip(('q', 'k', 'v', 'o'), codes,
                                (hd, hd, hd, dim)):
        t['w' + name], t['s' + name] = c, sc.reshape(n).contiguous()
    mixes = [torch.eye(heads, device='cuda') + 0.3 * mk(heads, heads)
             for _ in range(2)]
    t['mix'] = th._mix_bank(*mixes, heads, 'cuda')
    t['ws'] = torch.empty(th.th_q8_plan(b, seq, dim, heads)['workspace'],
                          dtype=torch.uint8, device='cuda')
    return t


def _k15_inputs(m, k, n):
    """K15's operands (a bf16, the weight codes [K, N] with their f32
    column scales), its workspace and its output."""
    from sav_tpu_torch.ops import int8_matmul_kernel as k15
    from sav_tpu_torch.ops.quantized import quantize_symmetric
    gen = torch.Generator(device='cuda').manual_seed(0)
    mk = lambda *s, std=1.0: torch.randn(*s, device='cuda', generator=gen) * std
    bq, bs = quantize_symmetric(mk(k, n, std=k ** -0.5).bfloat16(), 0)
    return dict(a=mk(m, k).bfloat16(), bq=bq, bs=bs.reshape(n).contiguous(),
                ws=torch.empty(k15.int8_matmul_plan(m, k, n)['workspace'],
                               dtype=torch.uint8, device='cuda'),
                out=torch.empty(m, n, device='cuda', dtype=torch.bfloat16))


# K15's GEMM (q8_gemm_sm90.cuh, inlined), BLOCK: no_mma, the products not
# issued (the ring, the folds and the epilogue on garbage); no_fold, only
# the first k-block's int32 sums kept; no_epi, no epilogue or store;
# six_slots, a ring of six 128-deep slots (three k-blocks); staggered, the
# second consumer warpgroup a k-block behind the first from the start (six
# slots), so that one's fold and epilogue run under the other's products;
# two_acc, k-blocks in pairs on two int32 accumulators, the second's
# products under the first's fold (six slots).
K15_FOLD = ('              f = __fadd_rn(f, __fmul_rn(__int2float_rn('
            'acc[4 * i + 2 * rh + j]),\n'
            '                                         s[rh]));')
K15_SIX = ('static constexpr int STAGES = BK == 128 ? 4 : 6;',
           'static constexpr int STAGES = 6;')
K15_TWO_ACC = r"""      int acc2[BN / 2];
      auto scales = [&](int kb, float (&sc)[2]) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int row = row0 + 16 * wi + g + 8 * rh;
          sc[rh] = row < args.m ? args.rs[(size_t)row * args.kb + kb] : 0.f;
        }
      };
      auto fold = [&](const int (&p)[BN / 2], const float (&sc)[2]) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float& f = facc[4 * i + 2 * rh + j];
              f = __fadd_rn(f, __fmul_rn(__int2float_rn(p[4 * i + 2 * rh + j]),
                                         sc[rh]));
            }
      };
      auto issue = [&](int (&p)[BN / 2]) {
#pragma unroll
        for (int h = 0; h < 2; ++h, ++step) {
          const int sl = step % STAGES;
          wait(&full[sl], (step / STAGES) & 1);
          slot_products<MODE, BN, BK>(p, base + sl * P::STAGE_BYTES, wg,
                                      h == 0);
        }
      };
      int kb = 0;
      for (; kb + 1 < args.kb; kb += 2) {
        float s0[2], s1[2];
        scales(kb, s0);
        scales(kb + 1, s1);
        issue(acc);
        issue(acc2);
        wgmma_wait<2>();
        fence_regs(acc);
        release((step - 4) % STAGES);
        release((step - 3) % STAGES);
        fold(acc, s0);
        wgmma_wait<0>();
        fence_regs(acc2);
        release((step - 2) % STAGES);
        release((step - 1) % STAGES);
        fold(acc2, s1);
      }
      if (kb < args.kb) {
        float s0[2];
        scales(kb, s0);
        issue(acc);
        wgmma_wait<0>();
        fence_regs(acc);
        release((step - 2) % STAGES);
        release((step - 1) % STAGES);
        fold(acc, s0);
      }
    } else {"""
K15_BLOCK_LOOP = ('      for (int kb = 0; kb < args.kb; ++kb) {\n'
                  '        // the block\'s row scales, fetched under its '
                  'products')
K15_VARIANTS = {
    'full': [],
    'no_mma': [('          slot_products<MODE, BN, BK>(acc, base + sl * '
                'P::STAGE_BYTES, wg,\n                                      '
                'h == 0);', '')],
    'no_fold': [(K15_FOLD, '              if (kb == 0) f = (float)acc[4 * i '
                           '+ 2 * rh + j];')],
    'no_epi': [("    if (leader) bulk_wait_read();          // the last "
                "tile's store read it",
                "    if (MODE == BLOCK) continue;\n"
                "    if (leader) bulk_wait_read();")],
    'six_slots': [K15_SIX],
    'staggered': [K15_SIX,
                  ('  int step = 0;\n  for (int u = blockIdx.x, n = 0; u < '
                   'units; u += gridDim.x, ++n) {\n    const int row0 = (u '
                   '/ nt) * BM + 64 * wg;',
                   '  int step = 0;\n  if (MODE == BLOCK && wg == 1) '
                   'named_sync(3, 256);\n  bool lead = MODE == BLOCK && wg '
                   '== 0;\n  for (int u = blockIdx.x, n = 0; u < units; '
                   'u += gridDim.x, ++n) {\n    const int row0 = (u / nt) '
                   '* BM + 64 * wg;'),
                  ('        release((step - 1) % STAGES);\n        // thread',
                   '        release((step - 1) % STAGES);\n        if (lead) '
                   '{\n          asm volatile("bar.arrive 3, 256;\\n" ::: '
                   '"memory");\n          lead = false;\n        }\n'
                   '        // thread')],
    'two_acc': [K15_SIX],                      # + the loop, below
}


def _k15_two_acc():
    """two_acc's loop in place of the k-block loop of the BLOCK epilogue's
    products (the text of this tree's q8_gemm_sm90.cuh)."""
    src = open(os.path.join(_build.CSRC, 'q8_gemm_sm90.cuh')).read()
    a = src.index(K15_BLOCK_LOOP)
    b = src.index('    } else {', a) + len('    } else {')
    return src[a:b], K15_TWO_ACC


K15_VARIANTS['two_acc'].append(_k15_two_acc())
# K11's core store (th_fwd_sm90.cuh, inlined): tie_test, the codes by
# quantize_by (the IEEE division where the product lies near a .5 tie)
# instead of quantize_exact; no_copy, the staged codes not copied out;
# no_quant, every code a plain conversion (no quantiser at all). Its
# GEMMs: tiles128, 128-column tiles (QKV 441 units at CaiT-S bs32 instead
# of 882; at D = 192 it leaves columns out: read its time at CaiT-S only).
K11_VARIANTS = {
    'full': [],
    'tiles128': [('constexpr int TILE = 64;', 'constexpr int TILE = 128;')],
    'tie_test': [('q8::quantize_exact(acc[h][4 * i + 2 * rh], scale,',
                  'q8::quantize_by(acc[h][4 * i + 2 * rh], scale,'),
                 ('q8::quantize_exact(acc[h][4 * i + 2 * rh + 1],',
                  'q8::quantize_by(acc[h][4 * i + 2 * rh + 1],')],
    'no_copy': [('  for (int c = wt; c < ROWS * CH; c += 128) {',
                 '  for (int c = wt; c < ROWS * CH && L < 0; c += 128) {')],
    'no_quant': [('        c.x = (signed char)q8::quantize_exact(acc[h][4 * i '
                  '+ 2 * rh], scale,\n                                       '
                  '       inv);',
                  '        c.x = (signed char)(int)acc[h][4 * i + 2 * rh];'),
                 ('        c.y = (signed char)q8::quantize_exact(acc[h][4 * i '
                  '+ 2 * rh + 1],\n                                         '
                  '     scale, inv);',
                  '        c.y = (signed char)(int)acc[h][4 * i + 2 * rh + '
                  '1];')],
}


def _k10_inputs(b, seq, heads, dim):
    """K10's operands (x, the LayerNorm's f32 scale and bias, the weight
    codes [D, H*64] x 3 and [H*64, D] with their f32 column scales), its
    workspace and its output."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    mk = lambda *s, std=1.0: torch.randn(*s, device='cuda', generator=gen) * std
    hd = heads * 64
    ws = [mk(dim, heads, 64, std=s / dim ** 0.5) for s in (4, 1, 1)]
    ws.append(mk(heads, 64, dim, std=hd ** -0.5))
    codes = fl._q8_weights(*ws, dim, hd)
    t = dict(x=mk(b, seq, dim).bfloat16(), ls=1 + 0.1 * mk(dim),
             lb=0.1 * mk(dim), out=torch.empty(b, seq, dim, device='cuda',
                                               dtype=torch.bfloat16))
    for name, (c, sc), n in zip(('q', 'k', 'v', 'o'), codes,
                                (hd, hd, hd, dim)):
        t['w' + name], t['s' + name] = c, sc.reshape(n).contiguous()
    t['ws'] = torch.empty(fl.fused_q8_plan(b, seq, dim, heads)['workspace'],
                          dtype=torch.uint8, device='cuda')
    return t


# K10 (fused_attention_q8.cu; q8_gemm_sm90.cuh inlined): no_core, the
# attention core not launched; no_codes, the core's codes pass skipped (the
# bands staged, nothing quantised or stored); no_sweep1, sweep 1's products
# not issued (the max from whatever the registers hold: timing only);
# expf, p by expf(s - m) instead of one FFMA and ex2.approx; tiles64, the
# GEMMs' 64-column tiles; shallow, the GEMMs' ring slots 64 codes deep (six
# of them, the 64-byte swizzle: K11's) instead of 128 (four); no_transpose,
# the codes launch without the weight codes' transposes; no_x, the out
# projection without + x; ln_reload, LN(x)'s rows read three times from
# memory instead of held in registers.
K10_VARIANTS = {
    'full': [],
    'no_core': [('  err = sav::k10::core_launch(',
                 '  if (batch < 0) err = sav::k10::core_launch(')],
    'no_codes': [('    for (int c = tid; c < ROWS * ch; c += CONS) {',
                  '    for (int c = tid; c < ROWS * ch && L < 0; '
                  'c += CONS) {')],
    'no_sweep1': [('  mma_xy<W0>(a, q_a, k + s0 * (SLOT / 2));\n'
                   '  mma_xy<W1>(c, q_a, k + s1 * (SLOT / 2));',
                   '  wgmma_commit();\n  wgmma_commit();'),
                  ('  mma_xy<W>(sc, q_a, k + st * (SLOT / 2));\n'
                   '  wgmma_wait<0>();',
                   '  wgmma_wait<0>();')],
    'expf': [('      sc[4 * i + j] = exp2_approx(in ? fmaf(sc[4 * i + j], '
              'kLog2e, -r.n0)\n                                     : '
              '-INFINITY);\n      sc[4 * i + 2 + j] = exp2_approx(\n'
              '          in ? fmaf(sc[4 * i + 2 + j], kLog2e, -r.n1) : '
              '-INFINITY);',
              '      sc[4 * i + j] = in ? expf(sc[4 * i + j] - r.m0) : 0.f;\n'
              '      sc[4 * i + 2 + j] = in ? expf(sc[4 * i + 2 + j] - r.m1)'
              ' : 0.f;')],
    'tiles64': [('constexpr int TILE = 128;', 'constexpr int TILE = 64;')],
    'shallow': [('constexpr int DEPTH = 128;', 'constexpr int DEPTH = 64;')],
    'no_transpose': [('  ln_codes_kernel<<<4 * per + (m + 7) / 8, 256, 0, st>>>(\n'
                      '      tr, 4, per,',
                      '  ln_codes_kernel<<<(m + 7) / 8, 256, 0, st>>>(\n'
                      '      tr, 0, per,')],
    'no_x': [('  o.x = residual ? (const sav::bf16*)x : nullptr;',
              '  o.x = nullptr;')],
    'ln_reload': [('  if (K <= 64 * ROW_PAIRS) {', '  if (K < 0) {')],
    'ln_occ4': [('__global__ void __launch_bounds__(256)\nln_codes_kernel(',
                 '__global__ void __launch_bounds__(256, 4)\nln_codes_kernel(')],
}


def _k9b_inputs(b, g, heads, d):
    """K9b's operands at a g x g grid (qs, k, v, the forward's out and lse
    from the plain twin, the cotangent, rel_h and rel_w) and its outputs
    (delta, dq, dk, dv, drel_h, drel_w)."""
    from sav_tpu_torch.ops import botnet_attention as bot
    gen = torch.Generator(device='cuda').manual_seed(0)
    mk = lambda *s, std=1.0: torch.randn(*s, device='cuda', generator=gen) * std
    length, hd = g * g, heads * d
    t = dict(qs=mk(b, length, hd, std=2 / d ** 0.5).bfloat16(),
             k=mk(b, length, hd).bfloat16(), v=mk(b, length, hd).bfloat16(),
             do=mk(b, length, hd).bfloat16(),
             rh=mk(b, heads, length, g, std=0.5), rw=mk(b, heads, length, g,
                                                        std=0.5))
    t['o'], t['lse'] = bot.bot_fwd_plain(t['qs'], t['k'], t['v'], t['rh'],
                                         t['rw'], heads, g)
    t['delta'] = torch.empty_like(t['lse'])
    for name in ('dq', 'dk', 'dv'):
        t[name] = torch.empty_like(t['qs'])
    t['drh'], t['drw'] = torch.empty_like(t['rh']), torch.empty_like(t['rw'])
    return t


# K9b (botnet_attention.cu; flash_sm90.cuh inlined): no_bins, the dq
# kernel's drel sums of each tile's ds skipped (the ds tile still stored);
# no_bias, the rel bias not added to the logits in either kernel; no_exp,
# 2^x replaced by x; no_copy, the producers' copies of the rel rows (and
# the dkv kernel's lse and delta: bulk copies at even g, cp.async at odd g)
# not issued.
K9B_VARIANTS = {
    'full': [],
    'no_bins': [('                                         int wt, bool '
                 'row_ok) {\n  const int r = wt & 63;',
                 '                                         int wt, bool '
                 'row_ok) {\n  if (n >= 0) return;\n  const int r = wt & '
                 '63;')],
    'no_bias': [('      const float x0 = (sc[4 * i + e] + rr.rh0[hb]) + '
                 'rr.rw0[wb];\n      const float x1 = (sc[4 * i + 2 + e] '
                 '+ rr.rh1[hb]) + rr.rw1[wb];',
                 '      const float x0 = sc[4 * i + e];\n      const float '
                 'x1 = sc[4 * i + 2 + e];'),
                ('      const float x0 = (sc[4 * i + e] + rh[q * g + hb0]) + '
                 'rw[q * g + wb0];\n      const float x1 = (sc[4 * i + 2 + '
                 'e] + rh[q * g + hb1]) + rw[q * g + wb1];',
                 '      const float x0 = sc[4 * i + e];\n      const float '
                 'x1 = sc[4 * i + 2 + e];')],
    'no_exp': [NO_EXP],
    'no_copy': [("      if (!bulk) {       // the unit's rel rows (zeros past L), "
                 "at once", '      if (false) {'),
                ('        copy_rel(reinterpret_cast<float*>(slot + '
                 'plan.s_rh)', '        if (false) copy_rel('
                 'reinterpret_cast<float*>(slot + plan.s_rh)'),
                ('        copy_rel(reinterpret_cast<float*>(slot + '
                 'plan.s_rw)', '        if (false) copy_rel('
                 'reinterpret_cast<float*>(slot + plan.s_rw)'),
                ('const uint32_t rel = bulk ? rows * g * 4 : 0;',
                 'const uint32_t rel = 0;'),
                ('const uint32_t stat = bulk ? rows * 4 : 0;',
                 'const uint32_t stat = 0;'),
                ('                                          uint32_t bytes, '
                 'uint64_t* bar) {\n  asm volatile(',
                 '                                          uint32_t bytes, '
                 'uint64_t* bar) {\n  if (bytes) asm volatile(')],
}


KERNELS = {
    # K1 and K5a: LN, QKV GEMM, attention core, out GEMM (four launches)
    'k1': dict(
        source='fused_attention.cu', inline='proj_sm90.cuh',
        shapes=[(192, 197, 12, 768, True, True),
                (32, 197, 12, 768, False, True),
                (64, 197, 6, 384, True, False),
                (32, 197, 10, 640, True, False)],
        inputs=_k1_inputs, label='B={} L={} H={} D={} train={} residual={}',
        entries={'sav_fused_attention_fwd': (
            'x', 'ls', 'lb', 'wq', 'wk', 'wv', 'wo', 'y', 'qs', 'ks', 'vs',
            'attn', 'out', 'lse')},
        # the 1 after the residual flag: pre_ln (0 is the post-LN route)
        dims=lambda b, seq, heads, dim, train, res, t: (
            b, seq, dim, heads, int(res), 1, 1e-6, 0.125),
        others=[_sublayer_chain(64)],
        variants=dict(K1_VARIANTS, **PROJ_VARIANTS)),
    # the mma.sync K1 of an older checkout (with --csrc on its csrc/)
    'k1_mma': dict(
        source='fused_attention.cu', inline=(),
        shapes=[(192, 197, 12, 768, True, True),
                (32, 197, 12, 768, False, True),
                (64, 197, 6, 384, True, False),
                (32, 197, 10, 640, True, False)],
        inputs=_k1_inputs, label='B={} L={} H={} D={} train={} residual={}',
        entries={'sav_fused_attention_fwd': (
            'x', 'ls', 'lb', 'wq', 'wk', 'wv', 'wo', 'y', 'qs', 'ks', 'vs',
            'attn', 'out', 'lse')},
        dims=lambda b, seq, heads, dim, train, res, t: (
            b, seq, dim, heads, int(res), 1e-6, 0.125),
        others=[_sublayer_chain(64)],
        variants=K1_VARIANTS),
    'k5a': dict(
        source='th_attention.cu', inline='proj_sm90.cuh', shapes=K5A_SHAPES + [(48, 576, 8, 384, False, False)],
        inputs=_k5a_inputs, label='B={} L={} H={} D={} train={} residual={}',
        entries={'sav_th_attention_fwd': (
            'x', 'ls', 'lb', 'wq', 'wk', 'wv', 'wo', 'mix', 'y', 'qs', 'ks',
            'vs', 'attn', 'out', 'lse')},
        dims=lambda b, seq, heads, dim, train, res, t: (
            b, seq, dim, heads, int(res), 1e-6, 48 ** -0.5),
        others=[_sublayer_chain(48), _k6a_core, _th_blocked],
        variants=dict({'full': [], 'no_core': K5A_NO_CORE}, **PROJ_VARIANTS)),
    # the mma.sync K5a of an older checkout (with --csrc on its csrc/; its
    # C entry takes M_pre and M_post apart)
    'k5a_mma': dict(
        source='th_attention.cu', inline=(), shapes=K5A_SHAPES,
        inputs=_k5a_inputs, label='B={} L={} H={} D={} train={} residual={}',
        entries={'sav_th_attention_fwd': (
            'x', 'ls', 'lb', 'wq', 'wk', 'wv', 'wo', 'mpre', 'mpost', 'y',
            'qs', 'ks', 'vs', 'attn', 'out', 'lse')},
        dims=lambda b, seq, heads, dim, train, res, t: (
            b, seq, dim, heads, int(res), 1e-6, 48 ** -0.5),
        others=[_sublayer_chain(48), _k6a_core],
        variants={'full': [], 'no_core': K5A_NO_CORE}),
    'k2': dict(
        source='flash_bwd.cu', inline='flash_sm90.cuh',
        shapes=[(192, 197, 12)], inputs=_flash_inputs,
        entries={'sav_flash_bwd_fused': ('q', 'k', 'v', 'out', 'do', 'lse',
                                         'dq', 'dk', 'dv')},
        dims=lambda b, seq, heads, t: (b, seq, seq, seq, heads),
        others=[lambda t, b, seq, heads: 'K3 pair %.4f ms' % time_ms(
                    lambda: fa.bwd_split(t['q'], t['k'], t['v'], t['out'],
                                         t['lse'], t['do'], heads, seq)),
                _sdpa_bwd],
        variants={
            'full': [],
            'short_b': [('for (int kk = 0; kk < ds_rows / 16; ++kk)',
                         'for (int kk = 0; kk < 1; ++kk)')],
            'no_ds': [('  store_dst<W>(s.dst[c], dp, tile0, r0, ds_rows, '
                       't);\n', '')],
            'no_exp': [NO_EXP],
        }),
    'k3': dict(
        source='flash_bwd_split.cu', inline='flash_sm90.cuh',
        shapes=[(48, 577, 12)], inputs=_flash_inputs,
        entries={'sav_flash_bwd_dq': ('q', 'k', 'v', 'out', 'do', 'lse',
                                      'dl', 'dq'),
                 'sav_flash_bwd_dkv': ('q', 'k', 'v', 'do', 'lse', 'delta',
                                       'dk', 'dv')},
        dims=lambda b, seq, heads, t: (b, seq, seq, seq, heads),
        others=[_sdpa_bwd],
        variants={
            'full': [],
            'no_exp': [NO_EXP],
            'no_math': [(f'  {call};', '') for call in (
                'dq_p<W>(sc, j * TILE + 2 * t, kv_len, l2a, l2b, (j + 1) * '
                'TILE <= kv_len)',
                'dq_ds<W>(sc, dp, da, db)',
                'keyrow_p<W>(sc, s.lse[st], ok0, ok1, t)',
                'keyrow_ds<W>(sc, dp, s.delta[st], t)')],
        }),
    'th': dict(
        source='th_bwd.cu', inline=('th_sm90.cuh', 'flash_sm90.cuh'),
        shapes=[(48, 576, 8), (128, 196, 8)], inputs=_th_inputs,
        entries={'sav_th_core_bwd': ('q', 'k', 'v', 'do', 'lse', 'mix',
                                     'delta', 'dm', 'dq', 'dk', 'dv')},
        dims=lambda b, seq, heads, t: (b, seq, heads),
        others=[_th_chain_bwd],
        variants={
            'full': [],
            'no_exp': [NO_EXP],
            'no_mix': [(f'  return c_mix[{at}j * H + i];',
                        '  return j == i ? 1.f : 0.f;')
                       for at in ('', 'H * H + ', '2 * H * H + ')],
            'no_dm': [('dm[j][i] = fmaf(da[i][p], pn[j][p], dm[j][i]);', ';'),
                      ('dm[j][i] = fmaf(da[i][p], s[j][p], dm[j][i]);', ';')],
            'no_products': [
                (f'          wgmma_ss_n{n}(t == 0 ? s[h] : da[h], a, b, kk);',
                 f'          if (kk == 0)\n'
                 f'            for (int e = 0; e < {n // 2}; ++e)\n'
                 f'              (t == 0 ? s[h] : da[h])[e] = '
                 f'__int_as_float(e + h + (int)(a ^ b));')
                for n in (16, 8)],
            'no_acc': [('      wgmma_rs_n48(acc[2 * hg + hh], a[hh],\n'
                        '                   str1 + (2 * hg + hh) * '
                        '(BOX_STR * 2 / 16));', '      ;')],
        }),
    'k16': dict(
        source='ff_bwd.cu', inline='ff_bwd_sm90.cuh',
        shapes=[(192 * 197, 768, 3072)], inputs=_k16_inputs,
        label='M={} D={} F={}',
        entries={'sav_ff_bwd': ('g', 'hpre', 'y', 'w1', 'w2', 'dh', 'h', 'dy',
                                'part', 'colsum', 'dw', 'db1')},
        dims=lambda m, dim, hidden, t: (m, dim, hidden, t['chunks']),
        others=[_k16_library],
        variants={
            'full': [],
            # dgact stored as bf16 into dh: no gelu', no h, no column sums
            'no_epi': [
                ('          const size_t off = (size_t)row * args.hidden + col0 '
                 '+ 2 * t;\n',
                 '          const size_t off = (size_t)row * args.hidden + col0 '
                 '+ 2 * t;\n'
                 '          for (int i = 0; i < 16; ++i)\n'
                 '            *reinterpret_cast<uint32_t*>(args.dh + off + 8 * i)'
                 ' = pack_bf16x2(\n'
                 '                acc[hh][4 * i + 2 * rh], acc[hh][4 * i + 2 * rh '
                 '+ 1]);\n'
                 '          if (true) continue;\n'),
                ('      args.colsum[(size_t)(w.row0 / BM)',
                 '      if (false) args.colsum[(size_t)(w.row0 / BM)')],
            'no_tanh': [('              const float th = ff::gelu_t(hp);',
                         '              const float th = 0.5f * hp;')],
            'no_dw': [
                ('  if (e == cudaSuccess) e = launch<WGRAD>(yn, dhn, hn, gn, '
                 'a, st);\n', ''),
                ('  if (e == cudaSuccess)\n    e = ff::sum_launch(part, chunks, '
                 'planes, (int)planes, dw, st);\n', '')],
        }),
    'th_fwd': dict(
        source='th_attention.cu',
        inline=('th_fwd_sm90.cuh', 'th_sm90.cuh', 'flash_sm90.cuh'),
        shapes=[(48, 576, 8), (32, 576, 8)], inputs=_th_fwd_inputs,
        entries={'sav_th_core_fwd': ('q', 'k', 'v', 'mix', 'attn', 'lse')},
        dims=lambda b, seq, heads, t: (b, seq, heads),
        others=[_th_chain_fwd],
        variants={
            'full': [],
            'no_exp': [NO_EXP],
            'no_mix': [(f'  return c_mix[{at}j * H + i];',
                        '  return j == i ? 1.f : 0.f;')
                       for at in ('', 'H * H + ', '2 * H * H + ')],
            'no_qk': [('      wgmma_ss_n16(s[h],\n'
                       '                   res + ((c >> 6) * BOX_RES * 2 + '
                       '(c & 63) * 2) / 16,\n'
                       '                   str + ((c >> 6) * BOX_STR * 2 + '
                       '(c & 63) * 2) / 16, kk);',
                       '      if (kk == 0)\n'
                       '        for (int e = 0; e < 8; ++e)\n'
                       '          s[h][e] = __int_as_float(0x3f000000 + e + h '
                       '+ (int)(res ^ str));')],
            'no_acc': [('      wgmma_rs_n48(acc[2 * hg + hh], a[hh],\n'
                        '                   str1 + (2 * hg + hh) * '
                        '(BOX_STR * 2 / 16));', '      ;')],
        }),
    # the parents' mma.sync kernels (run with --csrc on a parent checkout's
    # csrc/): K16's five launches and K6a's two-sweep core
    'k16_mma': dict(
        source='ff_bwd.cu', inline='ff_common.cuh',
        shapes=[(192 * 197, 768, 3072)], inputs=_k16_inputs,
        label='M={} D={} F={}',
        entries={'sav_ff_bwd': ('g', 'hpre', 'y', 'w1', 'w2', 'dh', 'h', 'dy',
                                'dw1', 'dw2', 'db1', 'colsum')},
        dims=lambda m, dim, hidden, t: (m, dim, hidden),
        others=[_k16_library],
        variants={
            'full': [],
            'no_epi': [(
                '            const float hp = __bfloat162float(p.hpre[off]);\n'
                '            const float th = gelu_t(hp);\n'
                '            const float dh = v * gelu_bwd(hp, th);\n'
                '            p.cb[off] = __float2bfloat16(dh);\n'
                '            p.h[off] = __float2bfloat16(0.5f * hp * (1.f + th));\n'
                '            csum[ni][e] += dh;\n',
                '            p.cb[off] = __float2bfloat16(v);\n'),
                ('  if (kEpi == kGeluBwd) {\n    // fixed order',
                 '  if (false) {\n    // fixed order')],
            'no_dw': [('  if ((err = gemm_launch<true, false, kF32>(c, 1, st)) '
                       '!= cudaSuccess)\n    return (int)err;\n', '')],
        }),
    'th_fwd_mma': dict(
        source='th_attention.cu', inline='th_core.cuh',
        shapes=[(48, 576, 8), (32, 576, 8)], inputs=_th_fwd_inputs,
        entries={'sav_th_core_fwd': ('q', 'k', 'v', 'mpre', 'mpost', 'attn',
                                     'lse')},
        dims=lambda b, seq, heads, t: (b, seq, heads),
        others=[_th_chain_fwd],
        variants={
            'full': [],
            'no_exp': [('expf(', '(')],
            'no_mix': [('    for (int j = 0; j < H; ++j) acc = fmaf(m[j * H '
                        '+ i], in[j], acc);', '    acc = in[i];')],
            'no_f32_tile': [
                ('      th_store_tile(sS + (h * BQ + mt * 16) * sld + col0, '
                 'sld, acc, lane);',
                 '      if (acc[0][0] == 12345.f)\n'
                 '        th_store_tile(sS + (h * BQ + mt * 16) * sld + col0, '
                 'sld, acc, lane);'),
                ('s[j] = sS[(j * BQ + r) * sld + c];',
                 's[j] = __int_as_float(0x3f000000 + j + c);')],
        }),
    # the Hopper K8b (csrc/mixer_bwd_sm90.cuh) and K14 (csrc/int8_dx_sm90.cuh)
    'k8b': dict(
        source='mixer_token.cu', inline='mixer_bwd_sm90.cuh',
        shapes=[(192, 196, 98, 768)], inputs=_k8b_sm90_inputs,
        label='B={} L={} K={} D={}',
        entries={'sav_mixer_bwd': ('x', 'g', 'ls', 'lb', 'w1', 'b1', 'w2',
                                   'dx', 'dls', 'dlb', 'dw1', 'db1', 'dw2',
                                   'db2', 'ws')},
        dims=lambda b, l, k, d, t: (b, l, k, d, 1e-6),
        others=[_k8b_library],
        variants={
            'full': [],
            # the band kernel stores no y (for the dW1 GEMM)
            'no_y': [('        *reinterpret_cast<uint4*>(a.y + img',
                      '        if (v.x == 0x12345u) '
                      '*reinterpret_cast<uint4*>(a.y + img')],
            # no gact and bf16(dhp) stores (for the dW GEMMs)
            'no_gact': [('          if (kc < k) {\n            const size_t '
                         'off', '          if (kc < 0) {\n            const '
                         'size_t off')],
            # no f32 dy store (for the LN pass)
            'no_dy': [('          a.dy[img + (size_t)lc * d + c0 + c] = v;',
                       '          if (v == 1234.5f) a.dy[img + (size_t)lc * d + '
                       'c0 + c] = v;')],
            # the LN pass not launched
            'no_ln': [('    if (err == cudaSuccess)\n      err = sav::mixb::'
                       'ln_bwd(', '    if (err == cudaSuccess && l < 0)\n'
                       '      err = sav::mixb::ln_bwd(')],
            # the dW GEMM and its sums not launched
            'no_dw': [('    if ((err = sav::mixb::dw_launch(o.y, o.dh, (const '
                       'bf16*)dout, o.gact, da,\n                                 '
                       '   st)) != cudaSuccess)\n      return (int)err;\n', ''),
                      ('  if ((err = ff::sum_launch(pw1, lay.chunks, lk, l * k, '
                       'dw1, st)) != cudaSuccess ||\n      (err = ff::sum_launch('
                       'pw2, lay.chunks, lk, l * k, dw2, st)) != cudaSuccess ||\n'
                       '      (err = mb::sum_columns_launch(',
                       '  if ((err = mb::sum_columns_launch(')],
        }),
    'k14': dict(
        source='int8_ff.cu', inline=Q8_HEADERS + ('int8_gemm.cuh',),
        shapes=[(192 * 197, 768, 3072), (128 * 196, 384, 1536)],
        inputs=_k14_sm90_inputs, label='M={} D={} F={}',
        entries={'sav_int8_ff_dx': ('g', 'hpre', 'w2c', 's2', 'w1c', 's1',
                                    'dy', 'dh', 'ws')},
        dims=lambda m, dim, hidden, t: (m, dim, hidden),
        others=[_k14_library],
        variants={
            'full': [],
            # the dh passes' elementwise work skipped (the staging tile's
            # loads and stores kept)
            'no_epi': [('      for (int i = 0; i < 16; ++i) {\n        const int '
                        'c = 8 * i + 2 * t;',
                        '      for (int i = 0; i < (args.m < 0 ? 16 : 0); ++i) '
                        '{\n        const int c = 8 * i + 2 * t;')],
            # gelu'(hpre)'s tanh replaced by a multiply
            'no_tanh': [('  const float i = tanhf(__fmul_rn(0.7978845608028654f,',
                         '  const float i = 0.5f * (__fmul_rn('
                         '0.7978845608028654f,')],
            # the teams multiply at once (no turns)
            'no_turn': [('    if (STAGED) wait(&turn[team], team == 0 ? (j & 1) '
                         '^ 1 : j & 1);', ''),
                        ('      if (STAGED) mbar_arrive(&turn[team ^ 1]);', '')],
            # no hpre tile loads (the staging tile's stale contents are used)
            'no_hload': [('    mbar_arrive_expect_tx(stg_full, STG_BYTES);\n'
                          '    tma_load_3d(stg, pmh, stg_full, col0, row0, 0);\n'
                          '    tma_load_3d(stg + BM * 128, pmh, stg_full, col0 + '
                          '64, row0, 0);', '    mbar_arrive(stg_full);')],
            # no staging tile stores
            'no_store': [('        tma_store_3d(&mo, stg, col0, row0, 0);\n'
                          '        if (MODE == ABSMAX)\n'
                          '          tma_store_3d(&mo, stg + BM * 128, col0 + '
                          '64, row0, 0);\n', '')],
            # dh's codes without the quantiser (a float to int cast)
            'no_quant': [('  const float q = __fmul_rn(v, inv);\n'
                          '  const float r = rintf(q);\n'
                          '  if (fabsf(fabsf(__fsub_rn(q, r)) - 0.5f) < 1e-4f) '
                          'return quantize(v, scale);\n'
                          '  return (int)fminf(fmaxf(r, -127.f), 127.f);',
                          '  return (int)v;')],
        }),
    # the Hopper K12 and K13 (csrc/int8_ff_sm90.cuh), with hpre
    'k12': dict(
        source='int8_ff.cu', inline=Q8_HEADERS, shapes=K12_SHAPES,
        inputs=_ff_sm90_inputs, label='M={} D={} F={}',
        entries={'sav_int8_ff': FF_ARGS}, outputs=('out', 'hpre'),
        dims=lambda m, dim, hidden, t: (m, dim, hidden, 0, 1e-6),
        others=[_ff_library(False)], variants=FF_VARIANTS),
    'k13': dict(
        source='int8_ff.cu', inline=Q8_HEADERS, shapes=K13_SHAPES,
        inputs=_ff_sm90_inputs, label='M={} D={} F={}',
        entries={'sav_int8_ff': FF_ARGS}, outputs=('out', 'hpre'),
        dims=lambda m, dim, hidden, t: (m, dim, hidden, 1, 1e-6),
        others=[_ff_library(True)], variants=FF_VARIANTS),
    # the mma.sync K8b (11 launches) and K14 (48-row bands) of an older
    # checkout, with --csrc on its csrc/
    'k8b_mma': dict(
        source='mixer_token.cu', inline='ff_common.cuh',
        shapes=[(192, 196, 98, 768)], inputs=_k8b_inputs,
        label='B={} L={} K={} D={}',
        entries={'sav_mixer_bwd': ('x', 'g', 'ls', 'lb', 'w1', 'b1', 'w2',
                                   'dx', 'dls', 'dlb', 'dw1', 'db1', 'dw2',
                                   'db2', 'ws')},
        dims=lambda b, l, k, d, t: (b, l, k, d, 1e-6),
        others=[_k8b_library],
        variants={
            'full': [],
            # the band blocks' W1/W2 loads skipped (garbage weights)
            'no_wload': [('  load_weights(w1, w2, sW1, sW2, l, k);\n'
                          '  for (int i = threadIdx.x; i < kp; i += '
                          'blockDim.x) sB1[i] = i < k ? b1[i] : 0.f;\n'
                          '  for (int i = threadIdx.x; i < NB;',
                          '  for (int i = threadIdx.x; i < kp; i += '
                          'blockDim.x) sB1[i] = i < k ? b1[i] : 0.f;\n'
                          '  for (int i = threadIdx.x; i < NB;')],
            # the db2, db1, LN row-sum and dscale/dbias loops skipped
            'no_sums': [(f'{decl}\n  for (', f'{decl}\n  if (false) for (')
                        for decl in (
                '  float* db2 = o.db2 + ((size_t)b * bands + band) * l;',
                '  float* db1 = o.db1 + ((size_t)b * bands + band) * k;',
                '  float* rows = o.rows + ((size_t)b * bands + band) * l * 2;',
                '  // per channel of the band: this image\'s dscale and dbias')],
            # the two dW GEMMs and their sums not launched
            'no_dw': [('  if ((err = ff::gemm_launch<false, true, ff::kF32>'
                       '(g, lay.chunks, st))\n      != cudaSuccess)\n'
                       '    return (int)err;\n', ''),
                      ('(err = ff::sum_launch(pw1, lay.chunks, lk, l * k, '
                       'dw1, st)) != cudaSuccess ||\n      (err = '
                       'ff::sum_launch(pw2, lay.chunks, lk, l * k, dw2, st)) '
                       '!= cudaSuccess ||\n      ', '')],
        }),
    # K8a's Hopper band kernel (csrc/mixer_bwd_sm90.cuh) and K7b's
    # per-block partials (csrc/tnt_inner.cu)
    'k8a': dict(
        source='mixer_token.cu', inline='mixer_bwd_sm90.cuh',
        shapes=[(192, 196, 98, 768), (32, 196, 98, 768)],
        inputs=_k8a_inputs, label='B={} L={} K={} D={}',
        entries={'sav_mixer_fwd': ('x', 'ls', 'lb', 'w1', 'b1', 'w2', 'b2',
                                   'stats', 'out')},
        dims=lambda b, l, k, d, t: (b, l, k, d, 1e-6),
        others=[_k8a_library],
        variants={
            'full': [],
            # the epilogue (+ b2 + x over the tile) skipped: the tile is
            # stored as loaded
            'no_epi': [('    for (int s = 0; s < LP / 16; ++s) {\n'
                        '      uint32_t xr[4];',
                        '    for (int s = 0; s < 0; ++s) {\n'
                        '      uint32_t xr[4];')],
            # the next unit's x and statistics fetched at the unit's start
            # (the next x once the other tile's store is read) instead of
            # after its normalisation, as its products start
            'fetch_at_start': [
                ('    if (u + stride < units) {\n      fetch(u + stride);\n'
                 '      if (wt == 0) {\n        bulk_wait_read();\n'
                 '        load_x(u + stride, cur ^ 1);\n      }\n    }\n'
                 '    __syncwarp();\n    // hp^T', '    // hp^T'),
                ('    const int b = u / bands, c0 = (u % bands) * BAND;\n'
                 '    // 1. the unit\'s row statistics and LN parameters, '
                 'fetched a unit ahead\n',
                 '    const int b = u / bands, c0 = (u % bands) * BAND;\n'
                 '    if (wt == 0 && u + stride < units) {\n'
                 '      bulk_wait_read();\n      load_x(u + stride, cur ^ 1);\n'
                 '    }\n    fetch(u);\n')],
            # the LayerNorm of the first product's A skipped (x as it is)
            'no_ln': [('      yf[s][0] = ln_pair(yf[s][0], mu0, in0, sc0, '
                       'bi0);\n      yf[s][1] = ln_pair(yf[s][1], mu0, in0, '
                       'sc1, bi1);\n      yf[s][2] = ln_pair(yf[s][2], mu1, '
                       'in1, sc0, bi0);\n      yf[s][3] = ln_pair(yf[s][3], '
                       'mu1, in1, sc1, bi1);', '')],
        }),
    'k7b': dict(
        source='tnt_inner.cu', inline=(), shapes=K7B_SHAPES,
        inputs=_k7b_inputs, label='B*P={} D={} F={} H={}',
        entries={'sav_tnt_bwd': K7B_ARGS},
        dims=lambda n, d, f, h, t: (n, d, f, h, 1e-6, (d // h) ** -0.5),
        others=[_k7b_library],
        variants={
            'full': [],
            # the product points multiply nothing (the barriers stay)
            'no_points': [('  for (int tile = ((warp - first) % nwarps + '
                           'nwarps) % nwarps; tile < tiles;',
                           '  for (int tile = tiles; tile < tiles;')],
            # the attention backward's two passes skipped
            'no_attn': [('      for (int pr = lane; pr < L * h; pr += 32) {\n'
                         '        const int r = pr & (L - 1), hh = pr / L, '
                         'c0 = hh * g.hd;\n        float a[L], ds[L], m, l;',
                         '      for (int pr = lane + 32 * L * h; pr < L * h; '
                         'pr += 32) {\n        const int r = pr & (L - 1), '
                         'hh = pr / L, c0 = hh * g.hd;\n        float a[L], '
                         'ds[L], m, l;'),
                        ('      for (int pr = lane; pr < L * h; pr += 32) {\n'
                         '        const int kr = pr & (L - 1)',
                         '      for (int pr = lane + 32 * L * h; pr < L * h; '
                         'pr += 32) {\n        const int kr = pr & (L - 1)')],
            # the attention forward's recompute skipped (o as it was)
            'no_attn_fwd': [('      attention_fwd<HD, U>(sQ, sK, sV, sO, g, '
                             'lf, lane);', '')],
            # the FF products and their gelu/gelu' epilogue skipped
            'no_ff': [('    for (int k0 = 0; k0 < g.dp; k0 += 16) {\n'
                       '      uint32_t af[4], bfr[4];\n'
                       '      load_a(af, sY, g.ldy, 0, k0, lane);',
                       '    for (int k0 = 0; k0 < 0; k0 += 16) {\n'
                       '      uint32_t af[4], bfr[4];\n'
                       '      load_a(af, sY, g.ldy, 0, k0, lane);'),
                      ('        const float t0 = gelu_t(h0), t1 = gelu_t(h1);',
                       '        const float t0 = h0, t1 = h1;')],
            # the two LayerNorm backwards' column sums skipped
            'no_ln_sums': [('  for (int c = lane; c < g.d; c += 32) {\n'
                            '    float ds = 0.f, db = 0.f;',
                            '  for (int c = lane + g.d; c < g.d; c += 32) {\n'
                            '    float ds = 0.f, db = 0.f;')],
        }),
    # the parent's K8a (one mma.sync block per 128-channel band and image)
    # and K7b (a warp a patch writing the dW operand rows, four tiled GEMMs
    # over them), with --csrc on an older checkout's csrc/
    'k8a_mma': dict(
        source='mixer_token.cu', inline=(),
        shapes=[(192, 196, 98, 768), (32, 196, 98, 768)],
        inputs=_k8a_inputs, label='B={} L={} K={} D={}',
        entries={'sav_mixer_fwd': ('x', 'ls', 'lb', 'w1', 'b1', 'w2', 'b2',
                                   'stats', 'out')},
        dims=lambda b, l, k, d, t: (b, l, k, d, 1e-6),
        others=[_k8a_library],
        variants={
            'full': [],
            # the band blocks' W1/W2 loads skipped (garbage weights)
            'no_wload': [('  load_weights(w1, w2, sW1, sW2, l, k);\n'
                          '  for (int i = threadIdx.x; i < kp; i += '
                          'blockDim.x) sB1[i] = i < k ? b1[i] : 0.f;\n'
                          '  for (int i = threadIdx.x; i < lp;',
                          '  for (int i = threadIdx.x; i < kp; i += '
                          'blockDim.x) sB1[i] = i < k ? b1[i] : 0.f;\n'
                          '  for (int i = threadIdx.x; i < lp;')],
        }),
    'k7b_mma': dict(
        source='tnt_inner.cu', inline=(), shapes=K7B_SHAPES,
        inputs=_k7b_inputs, label='B*P={} D={} F={} H={}',
        entries={'sav_tnt_bwd': K7B_MMA_ARGS},
        dims=lambda n, d, f, h, t: (n, d, f, h, 1e-6, (d // h) ** -0.5),
        others=[_k7b_library],
        variants={
            'full': [],
            # the rows kernel writes no operand rows (y, o, dx2, y2, dq|dk|dv,
            # bf16(dhp), gelu) to the workspace
            'no_rows': [('    store_rows(', '    if (false) store_rows('),
                        ('      dqg[i] = sDqkv', '      if (i < 0) dqg[i] = '
                         'sDqkv'),
                        ('      *reinterpret_cast<uint32_t*>(gact + r * f + c) '
                         '=', '      if (r < 0) *reinterpret_cast<uint32_t*>'
                         '(gact + r * f + c) ='),
                        ('      *reinterpret_cast<uint32_t*>(dhg + r * f + c) '
                         '= pk;', '      if (r < 0) *reinterpret_cast<uint32_t*>'
                         '(dhg + r * f + c) = pk;')],
            # the four dW GEMMs and their sum not launched
            'no_dw': [('  for (const Product& pr : prods) {',
                       '  for (const Product& pr : prods) {\n    if (n > 0) '
                       'break;'),
                      ('  return (int)sum_launch(part, pl.chunks, pl.total, '
                       '(int)pl.total, gw, st);', '  return 0;')],
        }),
    'k7a': dict(
        source='tnt_inner.cu', inline=(), shapes=K7A_SHAPES,
        inputs=_k7a_inputs, label='B*P={} D={} F={} H={}',
        entries={'sav_tnt_fwd': K7A_ARGS},
        dims=lambda n, d, f, h, t: (n, d, f, h, 1e-6, (d // h) ** -0.5),
        others=[], variants=K7A_VARIANTS),
    'k9a': dict(
        source='botnet_attention.cu', inline=('flash_sm90.cuh',),
        shapes=K9A_SHAPES, inputs=_k9a_inputs,
        label='B={} g={} h={} d={} lse={}',
        entries={'sav_bot_fwd': K9A_ARGS},
        dims=lambda b, g, heads, d, train, t: (b, g * g, heads, g, d),
        others=[_k9a_library], variants=K9A_VARIANTS),
    # the parent's mma.sync K7a and K9a, with --csrc on its csrc/
    'k7a_mma': dict(
        source='tnt_inner.cu', inline=(), shapes=K7A_SHAPES,
        inputs=_k7a_mma_inputs, label='B*P={} D={} F={} H={}',
        entries={'sav_tnt_fwd': ('x', 'wqkv', 'wo', 'w1', 'w2', 'par',
                                 'out')},
        dims=lambda n, d, f, h, t: (n, d, f, h, 1e-6, (d // h) ** -0.5),
        others=[], variants=K7A_MMA_VARIANTS),
    'k9a_mma': dict(
        source='botnet_attention.cu', inline=(), shapes=K9A_SHAPES,
        inputs=_k9a_inputs, label='B={} g={} h={} d={} lse={}',
        entries={'sav_bot_fwd': K9A_ARGS},
        dims=lambda b, g, heads, d, train, t: (b, g * g, heads, g, d),
        others=[_k9a_library], variants=K9A_MMA_VARIANTS),
    'k14_mma': dict(
        source='int8_ff.cu', inline='int8_gemm.cuh',
        shapes=[(192 * 197, 768, 3072), (128 * 196, 384, 1536)],
        inputs=_k14_inputs, label='M={} D={} F={}',
        entries={'sav_int8_ff_dx': ('g', 'hpre', 'w2c', 's2', 'w1c', 's1',
                                    'dy', 'dh')},
        dims=lambda m, dim, hidden, t: (m, dim, hidden),
        others=[_k14_library],
        variants={
            'full': [],
            # sweep 1 not run (each row's dh scale fixed); sweep 2 writes dh
            'no_sweep1': [
                ('  band_gemm<MT, 4>(gq, ldg, p.w2c, F, D,\n'
                 '                   [&](int mi, int half, int r, int col, '
                 'int v0, int v1) {\n    const float2 d = dh_of(r, col, v0, '
                 'v1);\n    const int row = m0 + r;',
                 '  if (false) band_gemm<MT, 4>(gq, ldg, p.w2c, F, D,\n'
                 '                   [&](int mi, int half, int r, int col, '
                 'int v0, int v1) {\n    const float2 d = dh_of(r, col, v0, '
                 'v1);\n    const int row = m0 + r;'),
                ('    const float2 d = dh_of(r, col, v0, v1);\n'
                 '    *reinterpret_cast<char2*>(hq + r * ldh + col) =',
                 '    const float2 d = dh_of(r, col, v0, v1);\n'
                 '    if (m0 + r < p.M)\n'
                 '      *reinterpret_cast<uint32_t*>(p.dh + (size_t)(m0 + r) '
                 '* F + col) = pack_bf16(d.x, d.y);\n'
                 '    *reinterpret_cast<char2*>(hq + r * ldh + col) =')],
            # each warp's weight fragments loaded once, reused every step
            'w_once': [('        nb[j] = more ? __ldg(reinterpret_cast<const '
                        'uint4*>(brow[j] + k0 + 64))\n                     : '
                        'b[j];', '        nb[j] = b[j];')],
            # hpre not read: a constant instead
            'no_hpre': [('      h = __bfloat1622float2(*reinterpret_cast<const '
                         '__nv_bfloat162*>(\n          p.hpre + (size_t)row * '
                         'F + col));', '      h = make_float2(0.5f, -0.25f);')],
        }),
    # the same, serving (no hpre) at ViT-B/16's and Mixer-B/16's bs32 rows
    # and CaiT-S/24's
    # K11 and K15: both on q8_gemm_sm90.cuh
    'k11': dict(
        source='th_attention_q8.cu',
        inline=('th_fwd_sm90.cuh', 'q8_gemm_sm90.cuh'),
        shapes=[(32, 196, 8, 384), (32, 196, 4, 192)],
        inputs=_k11_inputs, label='B={} L={} H={} D={}',
        entries={'sav_th_attention_q8': (
            'x', 'ls', 'lb', 'wq', 'wk', 'wv', 'wo', 'sq', 'sk', 'sv', 'so',
            'mix', 'ws', 'out')},
        dims=lambda b, seq, heads, dim, t: (
            b, seq, dim, heads, 0, 1e-6, 48 ** -0.5),
        others=[], variants=K11_VARIANTS),
    'k10': dict(
        source='fused_attention_q8.cu',
        inline=('q8_gemm_sm90.cuh', 'int8_sm90.cuh', 'int8_gemm.cuh'),
        shapes=[(32, 197, 12, 768), (32, 577, 6, 384)],
        inputs=_k10_inputs, label='B={} L={} H={} D={}',
        entries={'sav_fused_attention_q8': (
            'x', 'ls', 'lb', 'wq', 'wk', 'wv', 'wo', 'sq', 'sk', 'sv', 'so',
            'ws', 'out')},
        dims=lambda b, seq, heads, dim, t: (
            b, seq, dim, heads, 1, 1e-6, 0.125),
        others=[], variants=K10_VARIANTS),
    'k9b': dict(
        source='botnet_attention.cu', inline=('flash_sm90.cuh',),
        shapes=[(64, 14, 4, 128)], inputs=_k9b_inputs,
        label='B={} g={} h={} d={}',
        entries={'sav_bot_bwd_dq': ('qs', 'k', 'v', 'o', 'do', 'rh', 'rw',
                                    'lse', 'delta', 'dq', 'drh', 'drw'),
                 'sav_bot_bwd_dkv': ('qs', 'k', 'v', 'do', 'rh', 'rw', 'lse',
                                     'delta', 'dk', 'dv')},
        dims=lambda b, g, heads, d, t: (b, g * g, heads, g, d),
        others=[], variants=K9B_VARIANTS),
    'k15': dict(
        source='int8_matmul.cu', inline=('q8_gemm_sm90.cuh',),
        shapes=[(6304, 768, 3072), (6304, 3072, 768)],
        inputs=_k15_inputs, label='M={} K={} N={}',
        entries={'sav_int8_matmul': ('a', 'bq', 'bs', 'ws', 'out')},
        dims=lambda m, k, n, t: (m, k, n),
        others=[], variants=K15_VARIANTS),
    'k13s': dict(
        source='int8_ff.cu', inline=Q8_HEADERS, shapes=[(32 * 197, 768, 3072)],
        inputs=_ff_serve_inputs, label='M={} D={} F={}',
        entries={'sav_int8_ff': FF_ARGS},
        dims=lambda m, dim, hidden, t: (m, dim, hidden, 1, 1e-6),
        others=[], variants=FF_VARIANTS),
    'k12s': dict(
        source='int8_ff.cu', inline=Q8_HEADERS,
        shapes=[(32 * 196, 768, 3072), (32 * 196, 384, 1536)],
        inputs=_ff_serve_inputs, label='M={} D={} F={}',
        entries={'sav_int8_ff': FF_ARGS},
        dims=lambda m, dim, hidden, t: (m, dim, hidden, 0, 1e-6),
        others=[], variants=FF_VARIANTS),
    # the mma.sync 48-row-band K12 and K13 of an older checkout (with
    # --csrc on its csrc/), with hpre
    'k12_mma': dict(
        source='int8_ff.cu', inline=(), shapes=K12_SHAPES,
        inputs=_ff_inputs, label='M={} D={} F={}',
        entries={'sav_int8_ff': FF_MMA_ARGS},
        dims=lambda m, dim, hidden, t: (m, dim, hidden, 0, 1e-6),
        others=[_ff_library(False)], variants=FF_MMA_VARIANTS),
    'k13_mma': dict(
        source='int8_ff.cu', inline=(), shapes=K13_SHAPES,
        inputs=_ff_inputs, label='M={} D={} F={}',
        entries={'sav_int8_ff': FF_MMA_ARGS},
        dims=lambda m, dim, hidden, t: (m, dim, hidden, 1, 1e-6),
        others=[_ff_library(True)], variants=FF_MMA_VARIANTS),
}


def build(kernel: str, name: str, edits, out_dir: str,
          csrc: str) -> subprocess.Popen:
    spec = KERNELS[kernel]
    src = open(os.path.join(csrc, spec['source'])).read()
    inline = spec['inline']
    for header in (inline,) if isinstance(inline, str) else inline:
        # once, where it is first included (a later header may include it
        # again)
        inc = f'#include "{header}"'
        src = src.replace(inc, open(os.path.join(csrc, header)).read(),
                          1).replace(inc, '')
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f'{name}: the source no longer has {old!r}')
        src = src.replace(old, new)
    path = os.path.join(csrc, f'_ablate_{kernel}_{name}.cu')
    with open(path, 'w') as f:                  # in csrc/: finds its headers
        f.write(src)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-o',
         os.path.join(out_dir, f'lib_{kernel}_{name}.so'), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def launches(kernel: str, lib, t: dict, shape) -> list:
    """The variant's C entries as calls on the inputs ``t``."""
    spec = KERNELS[kernel]
    dims = spec['dims'](*shape, t)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    runs = []
    for entry, names in spec['entries'].items():
        fn = getattr(lib, entry)
        fn.argtypes = ([ctypes.c_void_p] * len(names)
                       + [ctypes.c_float if isinstance(v, float)
                          else ctypes.c_int for v in dims]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        runs.append(lambda fn=fn, names=names: fn(
            *[None if t[n] is None else t[n].data_ptr() for n in names],
            *dims, stream()))
    return runs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('kernel', choices=sorted(KERNELS))
    parser.add_argument('--build', default=os.path.join(_build.BUILD_DIR,
                                                        'ablate'))
    parser.add_argument('--csrc', default=_build.CSRC,
                        help="the csrc/ whose kernel is ablated (a parent "
                             "checkout's for the *_mma entries)")
    parser.add_argument('--same-as', dest='same_as', choices=sorted(KERNELS),
                        help='also run this entry\'s full variant (from '
                             '--other-csrc) on the same inputs and print '
                             'whether the outputs are bit-identical')
    parser.add_argument('--other-csrc', dest='other_csrc',
                        default=_build.CSRC)
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('torch_ablate: no CUDA device', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    spec = KERNELS[opts.kernel]
    os.makedirs(opts.build, exist_ok=True)
    jobs = [(opts.kernel, name, edits, opts.csrc)
            for name, edits in spec['variants'].items()]
    if opts.same_as:
        jobs.append((opts.same_as, 'full', [], opts.other_csrc))
    procs = {(k, name): build(k, name, edits, opts.build, csrc)
             for k, name, edits, csrc in jobs}
    libs = {}
    for (k, name, _, csrc), proc in zip(jobs, procs.values()):
        log, _ = proc.communicate()
        os.remove(os.path.join(csrc, f'_ablate_{k}_{name}.cu'))
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {k} {name}:\n{log}')
        libs[(k, name)] = ctypes.CDLL(
            os.path.join(opts.build, f'lib_{k}_{name}.so'))
    same_lib = libs.pop((opts.same_as, 'full'), None)
    libs = {name: lib for (_, name), lib in libs.items()}

    for shape in spec['shapes']:
        print(spec.get('label', 'B={} L={} H={}').format(*shape) + ':',
              flush=True)
        t = spec['inputs'](*shape)
        runs = {name: launches(opts.kernel, lib, t, shape)
                for name, lib in libs.items()}
        for name, fns in runs.items():
            if any(fn() for fn in fns):
                raise RuntimeError(f'{name}: launch failed')
        torch.cuda.synchronize()
        times = {name: [] for name in runs}
        for name in list(runs) + list(reversed(list(runs))):   # both orders
            times[name].append([time_ms(fn) for fn in runs[name]])
        for name, rounds in times.items():
            print(f'{name:8s} ' + ', then '.join(
                ' + '.join(f'{ms:.4f}' for ms in r) + f' = {sum(r):.4f} ms'
                for r in rounds), flush=True)
        for other in spec['others']:
            print(other(t, *shape), flush=True)
        print(per_kernel(runs['full']), flush=True)
        if same_lib is not None:
            for fn in runs['full']:
                fn()
            mine = {n: t[n].clone() for n in spec['outputs']}
            for fn in launches(opts.same_as, same_lib, t, shape):
                fn()
            torch.cuda.synchronize()
            same = {n: torch.equal(mine[n], t[n]) for n in spec['outputs']}
            print(f'full against {opts.same_as} (full, {opts.other_csrc}): '
                  f'bit-identical {same}', flush=True)
    return 0


def per_kernel(fns, calls: int = 10) -> str:
    """Device time of each kernel of the full variant's C entries a call
    (``timing.launch_ms``)."""
    return 'full, by launch: ' + '; '.join(
        f'{name[:48]} {ms:.4f} ms' for name, ms in launch_ms(fns, calls))


if __name__ == '__main__':
    sys.exit(main())
