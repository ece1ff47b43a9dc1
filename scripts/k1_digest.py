"""Digests of K1's outputs at ViT-B/16's widths, so that two versions of
the kernel can be held bit for bit in one call.

``k1_digests`` gives the sha256 of the serving variant's output at B = 32,
L = 197 and 577, and of the training variant's out, q, k, v, attn and lse
at B = 32, L = 197, on inputs made from a fixed seed. Run as a script, it
prints them for each checkout given (a directory holding
``sav_tpu_torch/``), each in a process of its own that builds its own
kernels, and whether they are equal:

    python scripts/k1_digest.py PARENT_DIR .

``K1_VITB_DIGESTS`` pins what this printed for the projection GEMM as it
was before it took D = 192 (N and K multiples of 128 only), so that the
widening is seen to leave the 128-multiple path alone (``chip_smoke.py``'s
``check_k1_bits`` and ``test_vit_b_k1_outputs_match_the_pinned_digests``
read it). The pin guards that one change: a later change to K1's GEMM or its
attention core that rightly reorders a sum removes the pin and both of its
readers, and holds its own outputs to its parent's with this script.

Needs an NVIDIA card; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# k1_digests on an H100 80GB HBM3 (700 W) from the tree whose projection
# GEMM took N and K multiples of 128 only
K1_VITB_DIGESTS = {'B=32 L=197': 'f9ee81d1dad68855',
                   'B=32 L=577': '2160dc228a0ec088',
                   'B=32 L=197 save_residuals': '0757175dd287298c'}

RUN = '''
import importlib.util, json, sys
sys.path.insert(0, {root!r})
from sav_tpu_torch.ops import fused_layer
spec = importlib.util.spec_from_file_location('k1_digest', {script!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(json.dumps(mod.k1_digests(fused_layer)))
'''


def k1_digests(fused_layer) -> dict:
    """The first 16 hex digits of the sha256 of K1's outputs (pre-LN, with
    the residual) at D = 768, H = 12 on inputs made from a fixed seed with
    numpy. ``fused_layer`` is a checkout's ``sav_tpu_torch.ops.fused_layer``;
    the call uses only the positional arguments every checkout's
    ``fused_attention_fwd`` takes."""
    import hashlib
    import math

    import numpy as np
    import torch
    rng = np.random.RandomState(20)
    bf16 = lambda shape, std=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32)
    ).cuda().bfloat16()
    dim, heads, out = 768, 12, {}
    for seq, train in ((197, False), (577, False), (197, True)):
        x = bf16((32, seq, dim))
        scale = (1 + 0.1 * bf16((dim,))).float()
        bias = (0.1 * bf16((dim,))).float()
        w = [bf16((dim, dim), s / math.sqrt(dim)) for s in (4, 1, 1, 1)]
        got = fused_layer.fused_attention_fwd(x, scale, bias, *w, heads, 1e-6,
                                              train)
        torch.cuda.synchronize()
        sha = hashlib.sha256()
        for t in ((got[0], *got[1]) if train else (got,)):
            sha.update(t.contiguous().view(torch.uint8).cpu().numpy()
                       .tobytes())
        out[f'B=32 L={seq}' + (' save_residuals' if train else '')] = \
            sha.hexdigest()[:16]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('roots', nargs='+', help='checkout directories')
    args = parser.parse_args(argv)
    script = os.path.abspath(__file__)
    seen = {}
    for root in args.roots:
        root = os.path.abspath(root)
        run = subprocess.run(
            [sys.executable, '-c', RUN.format(root=root, script=script)],
            cwd=root, capture_output=True, text=True)
        if run.returncode:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        seen[root] = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({'root': root, 'digests': seen[root]}), flush=True)
    same = len({json.dumps(d, sort_keys=True) for d in seen.values()}) == 1
    print(f'digests equal across {len(seen)} checkouts: {same}')
    return 0 if same else 1


if __name__ == '__main__':
    sys.exit(main())
