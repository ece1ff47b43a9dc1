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
    python scripts/torch_ablate.py k16_mma --csrc OLD/sav_tpu_torch/csrc
    python scripts/torch_ablate.py th_fwd_mma --csrc OLD/sav_tpu_torch/csrc

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
from sav_tpu_torch.utils.timing import time_ms  # noqa: E402

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


KERNELS = {
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
        }),    'k16': dict(
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
}


def build(kernel: str, name: str, edits, out_dir: str,
          csrc: str) -> subprocess.Popen:
    spec = KERNELS[kernel]
    src = open(os.path.join(csrc, spec['source'])).read()
    inline = spec['inline']
    for header in (inline,) if isinstance(inline, str) else inline:
        src = src.replace(f'#include "{header}"',
                          open(os.path.join(csrc, header)).read())
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
                       + [ctypes.c_int] * len(dims) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        runs.append(lambda fn=fn, names=names: fn(
            *[t[n].data_ptr() for n in names], *dims, stream()))
    return runs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('kernel', choices=sorted(KERNELS))
    parser.add_argument('--build', default=os.path.join(_build.BUILD_DIR,
                                                        'ablate'))
    parser.add_argument('--csrc', default=_build.CSRC,
                        help="the csrc/ whose kernel is ablated (a parent "
                             "checkout's for the *_mma entries)")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('torch_ablate: no CUDA device', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    spec = KERNELS[opts.kernel]
    os.makedirs(opts.build, exist_ok=True)
    procs = {name: build(opts.kernel, name, edits, opts.build, opts.csrc)
             for name, edits in spec['variants'].items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        os.remove(os.path.join(opts.csrc, f'_ablate_{opts.kernel}_{name}.cu'))
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        libs[name] = ctypes.CDLL(
            os.path.join(opts.build, f'lib_{opts.kernel}_{name}.so'))

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
    return 0


def per_kernel(fns, calls: int = 10) -> str:
    """Device time of each launch of the full variant's C entries, in
    launch order (torch.profiler, mean over ``calls`` calls): two launches
    of one kernel are two entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not e.name.startswith(('Memcpy', 'Memset'))),
                     key=lambda e: e.time_range.start)
    per = len(kernels) // calls
    rows = [(kernels[i].name, sum(kernels[i + c * per].time_range.elapsed_us()
                                  for c in range(calls)) / calls / 1e3)
            for i in range(per)]
    return 'full, by launch: ' + '; '.join(
        f'{name[:48]} {ms:.4f} ms' for name, ms in rows)


if __name__ == '__main__':
    sys.exit(main())
