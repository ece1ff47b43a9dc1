"""Where a flash kernel's time goes: the kernel timed beside copies of its
source with parts taken out, through the same C entries, on one card.

    python scripts/torch_ablate.py k2    # csrc/flash_bwd.cu, ViT @224 bs192
    python scripts/torch_ablate.py k3    # csrc/flash_bwd_split.cu, @384 bs48

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
The outputs of the ablated variants are wrong by design; only their times
mean something. Every variant is timed twice, the variants in order and
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
from sav_tpu_torch.utils.timing import time_ms  # noqa: E402

NO_EXP = ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
          '  y = x;')
KERNELS = {
    'k2': dict(
        source='flash_bwd.cu', shape=(192, 197, 12),
        entries=('sav_flash_bwd_fused',), other=('K3 pair', fa.bwd_split),
        variants={
            'full': [],
            'short_b': [('for (int kk = 0; kk < ds_rows / 16; ++kk)',
                         'for (int kk = 0; kk < 1; ++kk)')],
            'no_ds': [('  store_dst<W>(s.dst[c], dp, tile0, r0, ds_rows, '
                       't);\n', '')],
            'no_exp': [NO_EXP],
        }),
    'k3': dict(
        source='flash_bwd_split.cu', shape=(48, 577, 12),
        entries=('sav_flash_bwd_dq', 'sav_flash_bwd_dkv'), other=None,
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
}


def build(kernel: str, name: str, edits, out_dir: str) -> subprocess.Popen:
    src = open(os.path.join(_build.CSRC, KERNELS[kernel]['source'])).read()
    header = open(os.path.join(_build.CSRC, 'flash_sm90.cuh')).read()
    src = src.replace('#include "flash_sm90.cuh"', header)
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f'{name}: the source no longer has {old!r}')
        src = src.replace(old, new)
    path = os.path.join(_build.CSRC, f'_ablate_{kernel}_{name}.cu')
    with open(path, 'w') as f:                  # in csrc/: finds sm90.cuh
        f.write(src)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-o',
         os.path.join(out_dir, f'lib_{kernel}_{name}.so'), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def launches(kernel: str, lib, t: dict) -> list:
    """The variant's C entries as calls on the inputs ``t``."""
    b, seq, heads = KERNELS[kernel]['shape']
    dims = (b, seq, seq, seq, heads)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr = lambda *names: [t[n].data_ptr() for n in names]
    args = {'sav_flash_bwd_fused': ('q', 'k', 'v', 'out', 'do', 'lse', 'dq',
                                    'dk', 'dv'),
            'sav_flash_bwd_dq': ('q', 'k', 'v', 'out', 'do', 'lse', 'dl',
                                 'dq'),
            'sav_flash_bwd_dkv': ('q', 'k', 'v', 'do', 'lse', 'delta', 'dk',
                                  'dv')}
    runs = []
    for entry in KERNELS[kernel]['entries']:
        fn = getattr(lib, entry)
        fn.argtypes = ([ctypes.c_void_p] * len(args[entry])
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        runs.append(lambda fn=fn, names=args[entry]: fn(*ptr(*names), *dims,
                                                        stream()))
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

    b, seq, heads = spec['shape']
    gen = torch.Generator(device='cuda').manual_seed(0)
    band = lambda s: (torch.randn(b, seq, heads * 64, device='cuda',
                                  generator=gen) * s).bfloat16()
    t = dict(q=band(0.5), k=band(1.0), v=band(1.0), do=band(1.0))
    t['out'], t['lse'] = fa.flash_fwd(t['q'], t['k'], t['v'], heads, seq)
    _, t['delta'] = fa.bwd_dq(t['q'], t['k'], t['v'], t['out'], t['lse'],
                              t['do'], heads, seq)
    t.update(dq=torch.empty_like(t['q']), dk=torch.empty_like(t['k']),
             dv=torch.empty_like(t['v']), dl=torch.empty_like(t['lse']))
    runs = {name: launches(opts.kernel, lib, t) for name, lib in libs.items()}
    for name, fns in runs.items():
        if any(fn() for fn in fns):
            raise RuntimeError(f'{name}: launch failed')
    times = {name: [] for name in runs}
    for name in list(runs) + list(reversed(list(runs))):    # both orders
        times[name].append([time_ms(fn) for fn in runs[name]])
    for name, rounds in times.items():
        print(f'{name:8s} ' + ', then '.join(
            ' + '.join(f'{ms:.4f}' for ms in r) + f' = {sum(r):.4f} ms'
            for r in rounds), flush=True)

    grads = (t['q'], t['k'], t['v'], t['out'], t['lse'], t['do'], heads, seq)
    if spec['other']:
        label, other = spec['other']
        print(f'{label} {time_ms(lambda: other(*grads)):.4f} ms', flush=True)
    head_major = lambda a: a.view(b, seq, heads, 64).transpose(1, 2)
    qs, ks, vs = (head_major(t[n]).detach().requires_grad_()
                  for n in ('q', 'k', 'v'))
    fwd = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                         scale=1.0))
    both = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qs, ks, vs, scale=1.0), (qs, ks, vs),
        head_major(t['do'])))
    print(f'SDPA backward {both - fwd:.4f} ms (fwd+bwd {both:.4f} - fwd '
          f'{fwd:.4f}) at B={b} L={seq} H={heads}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
