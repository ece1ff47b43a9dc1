"""Where K3's time goes: the flash backward kernels of
``sav_tpu_torch/csrc/flash_bwd_split.cu`` timed beside copies with parts
taken out, through the same C entries, on one card.

Variants (each built into its own library under ``--build``):
  full     the source as it is;
  noexp    2^x replaced by x (no special-function unit work);
  nomath   p and ds not formed: the products run on the raw s and dp, so
           what is left is the products, the packing, the TMA ring, the
           barriers and the epilogues.
The outputs of the ablated variants are wrong by design; only their times
mean something. Prints each kernel's mean time over 30 calls (CUDA events)
at ViT-B/16 @384 bs48 (B = 48, L = 577, H = 12) and SDPA's backward on the
same inputs.

    python scripts/torch_k3_ablate.py

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

SOURCE = os.path.join(_build.CSRC, 'flash_bwd_split.cu')
EDITS = {
    'full': [],
    'noexp': [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
               '  y = x;')],
    'nomath': [(f'  {call};', '') for call in (
        'dq_p<W>(sc, j * TILE + 2 * t, kv_len, l2a, l2b, (j + 1) * TILE '
        '<= kv_len)',
        'dq_ds<W>(sc, dp, da, db)',
        'dkv_p<W>(sc, s.lse[st], ok0, ok1, t)',
        'dkv_ds<W>(sc, dp, s.delta[st], t)')],
}


def build(name: str, edits, out_dir: str) -> subprocess.Popen:
    src = open(SOURCE).read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f'{name}: the source no longer has {old!r}')
        src = src.replace(old, new)
    path = os.path.join(_build.CSRC, f'_ablate_{name}.cu')   # finds sm90.cuh
    with open(path, 'w') as f:
        f.write(src)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-o',
         os.path.join(out_dir, f'lib_{name}.so'), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def time_ms(fn, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--build', default=os.path.join(_build.BUILD_DIR,
                                                        'ablate'))
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('torch_k3_ablate: no CUDA device', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(opts.build, exist_ok=True)
    procs = {name: build(name, edits, opts.build)
             for name, edits in EDITS.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        os.remove(os.path.join(_build.CSRC, f'_ablate_{name}.cu'))
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        libs[name] = ctypes.CDLL(os.path.join(opts.build, f'lib_{name}.so'))

    b, seq, heads = 48, 577, 12
    gen = torch.Generator(device='cuda').manual_seed(0)
    band = lambda s: (torch.randn(b, seq, heads * 64, device='cuda',
                                  generator=gen) * s).bfloat16()
    q, k, v, do = band(0.5), band(1.0), band(1.0), band(1.0)
    out, lse = fa.flash_fwd(q, k, v, heads, seq)
    _, delta = fa.bwd_dq(q, k, v, out, lse, do, heads, seq)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    dims = (b, seq, seq, seq, heads)
    for name, lib in libs.items():
        fdq, fdkv = lib.sav_flash_bwd_dq, lib.sav_flash_bwd_dkv
        for fn in (fdq, fdkv):
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        dq, dl = torch.empty_like(q), torch.empty_like(lse)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        run_dq = lambda: fdq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                             dl.data_ptr(), dq.data_ptr(), *dims, stream())
        run_dkv = lambda: fdkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(), *dims, stream())
        if run_dq() or run_dkv():
            raise RuntimeError(f'{name}: launch failed')
        t_dq, t_dkv = time_ms(run_dq), time_ms(run_dkv)
        print(f'{name:7s} K3a {t_dq:.4f} ms  K3b {t_dkv:.4f} ms  pair '
              f'{t_dq + t_dkv:.4f} ms', flush=True)

    head_major = lambda a: a.view(b, seq, heads, 64).transpose(1, 2)
    qs, ks, vs = (head_major(a).detach().requires_grad_() for a in (q, k, v))
    fwd = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                         scale=1.0))
    both = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qs, ks, vs, scale=1.0), (qs, ks, vs),
        head_major(do)))
    print(f'SDPA backward {both - fwd:.4f} ms (fwd+bwd {both:.4f} - fwd '
          f'{fwd:.4f}) at B={b} L={seq} H={heads}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
