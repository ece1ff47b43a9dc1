"""Where a flash kernel's time goes: the kernel timed beside copies of its
source with parts taken out, through the same C entries, on one card.

    python scripts/torch_ablate.py k2    # csrc/flash_bwd.cu, ViT @224 bs192
    python scripts/torch_ablate.py k3    # csrc/flash_bwd_split.cu, @384 bs48
    python scripts/torch_ablate.py th    # csrc/th_attention.cu backward,
                                         # CaiT-S/24 @384 bs48, @224 bs128

Each variant of the kernel's table (``KERNELS``) is the source with the
shared flash pieces (``csrc/flash_sm90.cuh``, the exp among them) inlined
and its edits applied, built into its own library under ``--build`` (all
``nvcc`` runs at once). K2's variants:
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
The outputs of the ablated variants are wrong by design; only their times
mean something. The full variant's kernels are also timed one by one
(torch.profiler). Every variant is timed twice, the variants in order and
then in reverse, with ``sav_tpu_torch.utils.timing.time_ms`` (mean of 20
calls after 3, CUDA events); then the other backward route and SDPA's
backward on the same inputs (K2's other route is the K3 pair; K3's at
L = 577 has none).

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
        dims=lambda b, seq, heads: (b, seq, seq, seq, heads),
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
        dims=lambda b, seq, heads: (b, seq, seq, seq, heads),
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
        source='th_bwd.cu', inline='flash_sm90.cuh',
        shapes=[(48, 576, 8), (128, 196, 8)], inputs=_th_inputs,
        entries={'sav_th_core_bwd': ('q', 'k', 'v', 'do', 'lse', 'mix',
                                     'delta', 'dm', 'dq', 'dk', 'dv')},
        dims=lambda b, seq, heads: (b, seq, heads),
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
}


def build(kernel: str, name: str, edits, out_dir: str) -> subprocess.Popen:
    spec = KERNELS[kernel]
    src = open(os.path.join(_build.CSRC, spec['source'])).read()
    if spec['inline']:
        header = open(os.path.join(_build.CSRC, spec['inline'])).read()
        src = src.replace(f'#include "{spec["inline"]}"', header)
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f'{name}: the source no longer has {old!r}')
        src = src.replace(old, new)
    path = os.path.join(_build.CSRC, f'_ablate_{kernel}_{name}.cu')
    with open(path, 'w') as f:                  # in csrc/: finds its headers
        f.write(src)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-o',
         os.path.join(out_dir, f'lib_{kernel}_{name}.so'), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def launches(kernel: str, lib, t: dict, shape) -> list:
    """The variant's C entries as calls on the inputs ``t``."""
    spec = KERNELS[kernel]
    dims = spec['dims'](*shape)
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
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('torch_ablate: no CUDA device', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    spec = KERNELS[opts.kernel]
    os.makedirs(opts.build, exist_ok=True)
    procs = {name: build(opts.kernel, name, edits, opts.build)
             for name, edits in spec['variants'].items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        os.remove(os.path.join(_build.CSRC, f'_ablate_{opts.kernel}_{name}.cu'))
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        libs[name] = ctypes.CDLL(
            os.path.join(opts.build, f'lib_{opts.kernel}_{name}.so'))

    for shape in spec['shapes']:
        b, seq, heads = shape
        print(f'B={b} L={seq} H={heads}:', flush=True)
        t = spec['inputs'](b, seq, heads)
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
            print(other(t, b, seq, heads), flush=True)
        print(per_kernel(runs['full']), flush=True)
    return 0


def per_kernel(fns, calls: int = 10) -> str:
    """Device time of each kernel the full variant's C entries launch
    (torch.profiler, mean over ``calls`` calls)."""
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / calls / 1e3)
            for e in prof.key_averages() if e.device_time_total > 0]
    return 'full, by kernel: ' + '; '.join(
        f'{name[:48]} {ms:.4f} ms' for name, ms in sorted(rows))


if __name__ == '__main__':
    sys.exit(main())
