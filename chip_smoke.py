#!/usr/bin/env python3
"""Smoke run of the torch port (sav_tpu_torch) on one NVIDIA card.

  python3 chip_smoke.py [--seed 0] [--batch 32] [--profile]

1. Refuses to run without a CUDA device; prints the card's name and power
   limit (nvidia-smi) and builds every kernel from csrc/ with nvcc.
2. Holds each hand-written kernel against its plain PyTorch twin on the
   card, in bf16, at the serving shapes, and times kernel, twin and one
   library call computing the same function (timed only; the port never
   calls it). For K1 it also times the sublayer on the 'flash' core, the
   route ``fused_layer.auto_core`` weighs it against.
3. Serves ViT-B/16 bf16 through ``sav_tpu_torch.predict.serve``: @224 with
   use_kernel='auto' (the K1 port, 12 launches per forward), @384 with
   use_kernel='fused_layer' (the K4 port, 12 launches) and @384 with 'auto'
   (K1 again), with launch counts set to 0 just before each forward and
   read just after, logits checked against the plain cores
   (use_kernel=False) on the same weights, img/s.
4. Prints one JSON line of every ported kernel, then the result line
   ``{"ok": true, "device": {...}}``. Any failed check exits non-zero and
   prints no result line.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from sav_tpu_torch import _build
from sav_tpu_torch.data.preprocess import eval_preprocess
from sav_tpu_torch.models import create_model
from sav_tpu_torch.models.vit import set_use_kernel
from sav_tpu_torch.ops import fused_layer
from sav_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
from sav_tpu_torch.predict import decode_size_for, serve

# Published dense peaks of one H100 SXM (NVIDIA data sheet), for bound_ms.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Tolerances. Outputs: max |kernel - twin| over max |twin| (K1: over max
# |twin - x|, the sublayer's own contribution, so the residual cannot hide
# an error in it). Kernel and twin round to bf16 at the same points but
# sum in other orders, so a few one-ulp bf16 flips (2^-8 relative) in
# q/k/v/attn are expected, each moving the result by well under 1%; a
# wrong tile, mask or fragment layout moves it by O(1).
OUT_TOL = 2e-2
# lse is f32 from the same bf16 logits in both: only summation order and
# exp2 vs exp differ (~1e-6 at lse ~ 6); 1e-3 absolute leaves room for that
# and still catches a masked-key or max error (>= 1e-2).
LSE_TOL = 1e-3
# Logits of the kernel path vs the plain per-op path (use_kernel=False) of
# the same weights: the per-op path keeps the residual stream in f32 (flax's
# promotion of the f32 cls token), the fused sublayer rounds it to bf16 at
# each of 12 layers, so they differ by bf16 rounding compounded over the
# depth; 5e-2 of max |logit| bounds that and still catches a broken layer.
LOGIT_TOL = 5e-2


def nvidia_smi() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
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


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


class Checks:
    def __init__(self):
        self.failed = []

    def expect(self, ok: bool, what: str) -> None:
        print(f'{"PASS" if ok else "FAIL"} {what}', flush=True)
        if not ok:
            self.failed.append(what)


def _bf16(rng, shape, std=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32)).cuda().bfloat16()


def check_k1(rng, checks, batch, seq, dim=768, heads=12):
    """K1 port vs its twin at [batch, seq, dim]; returns the kernel record."""
    hd = heads * 64
    x = _bf16(rng, (batch, seq, dim))
    scale = (1.0 + 0.1 * _bf16(rng, (dim,))).float()
    bias = (0.1 * _bf16(rng, (dim,))).float()
    # wq 4x wider than lecun so the softmax is peaked and the attention term
    # is not a near-uniform average of v
    wq = _bf16(rng, (dim, hd), 4.0 / math.sqrt(dim))
    wk, wv = (_bf16(rng, (dim, hd), 1.0 / math.sqrt(dim)) for _ in range(2))
    wo = _bf16(rng, (hd, dim), 1.0 / math.sqrt(hd))
    args = (x, scale, bias, wq, wk, wv, wo, heads)
    out = fused_layer.fused_attention_fwd(*args)
    plain = fused_layer.fused_attention_fwd_plain(*args, fused_layer.LN_EPS)
    torch.cuda.synchronize()
    delta = (plain.float() - x.float()).abs().max().item()
    err = (out.float() - plain.float()).abs().max().item()
    rel = err / delta
    finite = bool(torch.isfinite(out).all())
    checks.expect(finite and rel <= OUT_TOL,
                  f'K1 fused_attention_fwd B={batch} L={seq}: max err {err:.4g} '
                  f'= {rel:.3g} of max|out-x| (tol {OUT_TOL})')

    def library():
        y = F.layer_norm(x, (dim,), scale.bfloat16(), bias.bfloat16(), 1e-6)
        split = lambda a: a.view(batch, seq, heads, 64).transpose(1, 2)
        q, k, v = (split(y @ w) for w in (wq, wk, wv))
        a = F.scaled_dot_product_attention(q, k, v)
        return x + a.transpose(1, 2).reshape(batch, seq, hd) @ wo

    def flash_core():
        """The same sublayer on the port's other route (auto_core's choice)."""
        heads3 = lambda w: w.view(dim, heads, 64)
        return fused_layer.attention_sublayer(
            x, scale, bias, heads3(wq), heads3(wk), heads3(wv),
            wo.view(heads, 64, dim), heads, 'flash')

    m = batch * seq
    flops = 2 * m * dim * 3 * hd + 4 * batch * heads * seq * seq * 64 \
        + 2 * m * hd * dim
    nbytes = 2 * m * dim * 2 + 4 * dim * hd * 2 + 2 * dim * 4
    b_ms, b_by = bound_ms(flops, nbytes)
    rec = dict(ms=time_ms(lambda: fused_layer.fused_attention_fwd(*args)),
               plain_ms=time_ms(lambda: fused_layer.fused_attention_fwd_plain(
                   *args, fused_layer.LN_EPS), iters=5),
               library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
               max_abs_err=err)
    print(f'  K1 L={seq}: kernel {rec["ms"]:.4f} ms  plain {rec["plain_ms"]:.4f} '
          f'ms  library {rec["library_ms"]:.4f} ms  bound {b_ms:.4f} ms ({b_by}, '
          f'{flops / 1e9:.2f} GFLOP)  flash core {time_ms(flash_core):.4f} ms',
          flush=True)
    return rec


def check_k4(rng, checks, batch, seq, heads=12):
    """K4 port vs its twin on [batch, seq, heads*64]; returns the record."""
    hd = heads * 64
    q = _bf16(rng, (batch, seq, hd), 0.5)      # pre-scaled, peaked softmax
    k = _bf16(rng, (batch, seq, hd))
    v = _bf16(rng, (batch, seq, hd))
    out, lse = flash_fwd(q, k, v, heads, seq)
    p_out, p_lse = flash_fwd_plain(q, k, v, heads, seq)
    torch.cuda.synchronize()
    err = (out.float() - p_out.float()).abs().max().item()
    rel = err / p_out.float().abs().max().item()
    lse_err = (lse - p_lse).abs().max().item()
    finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
    checks.expect(finite and rel <= OUT_TOL and lse_err <= LSE_TOL,
                  f'K4 flash_fwd B={batch} L={seq}: out err {rel:.3g} of max '
                  f'(tol {OUT_TOL}), lse abs err {lse_err:.3g} (tol {LSE_TOL})')

    def library():
        split = lambda a: a.view(batch, seq, heads, 64).transpose(1, 2)
        return F.scaled_dot_product_attention(split(q), split(k), split(v),
                                              scale=1.0)

    flops = 4 * batch * heads * seq * seq * 64
    nbytes = 4 * batch * seq * hd * 2 + batch * heads * seq * 4
    b_ms, b_by = bound_ms(flops, nbytes)
    rec = dict(ms=time_ms(lambda: flash_fwd(q, k, v, heads, seq)),
               plain_ms=time_ms(lambda: flash_fwd_plain(q, k, v, heads, seq),
                                iters=5),
               library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(err, lse_err))
    print(f'  K4 L={seq}: kernel {rec["ms"]:.4f} ms  plain {rec["plain_ms"]:.4f} '
          f'ms  library {rec["library_ms"]:.4f} ms  bound {b_ms:.4f} ms ({b_by})',
          flush=True)
    return rec


def fill_head(model, seed: int) -> None:
    """The ViT head and cls token are zero-initialised, which makes every
    random-init logit 0; fill them from the seed so logits can be compared."""
    gen = torch.Generator().manual_seed(seed + 1)
    head = model.Dense_0.kernel
    with torch.no_grad():
        head.copy_(torch.randn(head.shape, generator=gen)
                   / math.sqrt(head.shape[0]))
        model.cls.copy_(torch.randn(model.cls.shape, generator=gen) * 0.02)


def serve_path(checks, name, img_size, use_kernel, counter, seed, batch,
               profile=False):
    """Drives ``serve`` once with the counts at 0, then compares logits
    with the plain cores and measures img/s. Returns the launch count."""
    model = create_model('vit_b_patch16', num_classes=1000,
                         dtype=torch.bfloat16, img_size=img_size, seed=seed,
                         device='cuda', use_kernel=use_kernel)
    fill_head(model, seed)
    model.eval()
    size = decode_size_for(img_size)
    frames = np.random.RandomState(seed).randint(
        0, 256, (batch, size, size, 3), dtype=np.uint8)

    fused_layer.fused_attention_fwd.launches = 0
    flash_fwd.launches = 0
    probs, idx = serve(model, frames, img_size, 5)
    torch.cuda.synchronize()
    counts = {'fused_attention_fwd': fused_layer.fused_attention_fwd.launches,
              'flash_fwd': flash_fwd.launches}
    checks.expect(counts[counter] == 12 and sum(counts.values()) == 12,
                  f'{name}: launches per forward {counts} (want 12 {counter})')
    checks.expect(tuple(idx.shape) == (batch, 5)
                  and bool(torch.isfinite(probs).all()),
                  f'{name}: top-5 of shape {tuple(idx.shape)}, finite')

    with torch.inference_mode():
        x = eval_preprocess(torch.from_numpy(frames).cuda().float(),
                            img_size).bfloat16()
        logits = model(x).float()
        set_use_kernel(model, False)
        plain = model(x).float()
        set_use_kernel(model, use_kernel)
    err = (logits - plain).abs().max().item() / plain.abs().max().item()
    top1 = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    checks.expect(tuple(logits.shape) == (batch, 1000)
                  and bool(torch.isfinite(logits).all()) and err <= LOGIT_TOL,
                  f'{name}: logits vs use_kernel=False: max err {err:.3g} of '
                  f'max|logit| (tol {LOGIT_TOL}), top-1 agreement {top1:.3f}')

    iters = 10
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        serve(model, frames, img_size, 5)
    torch.cuda.synchronize()
    ips = iters * batch / (time.perf_counter() - start)
    fwd_ms = time_ms(lambda: serve(model, frames, img_size, 5), iters=5)
    print(f'  {name}: {ips:.1f} img/s (serve incl. H2D of uint8 frames, '
          f'batch {batch}), {fwd_ms:.3f} ms/batch between CUDA events '
          f'(includes host waits)', flush=True)
    if profile:
        print_profile(lambda: serve(model, frames, img_size, 5))
    return counts[counter]


def print_profile(fn, iters: int = 5) -> None:
    """Device time by kernel over ``iters`` calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=15,
                                    max_name_column_width=60), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--batch', type=int, default=32)
    parser.add_argument('--profile', action='store_true',
                        help='also print device time by kernel of each serve')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi, flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'{torch.cuda.get_device_name(0)}', flush=True)
    secs = _build.build_all()
    print(f'kernels built in {secs:.1f} s', flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}', flush=True)

    checks = Checks()
    rng = np.random.RandomState(args.seed)
    k1 = {seq: check_k1(rng, checks, args.batch, seq) for seq in (197, 577)}
    k4 = {seq: check_k4(rng, checks, args.batch, seq) for seq in (197, 577, 200)}

    k1_launches = serve_path(checks, 'ViT-B/16 @224 auto', 224, 'auto',
                             'fused_attention_fwd', args.seed, args.batch,
                             args.profile)
    k4_launches = serve_path(checks, 'ViT-B/16 @384 fused_layer', 384,
                             'fused_layer', 'flash_fwd', args.seed, args.batch,
                             args.profile)
    serve_path(checks, 'ViT-B/16 @384 auto', 384, 'auto', 'fused_attention_fwd',
               args.seed, args.batch, args.profile)

    kernels = [
        dict(name='fused_attention_fwd', route='cuda',
             source='sav_tpu_torch/csrc/fused_attention.cu',
             replaces='sav_tpu/ops/fused_layer.py:127',
             launches=k1_launches,
             max_abs_err=max(r['max_abs_err'] for r in k1.values()),
             **{k: v for k, v in k1[197].items() if k != 'max_abs_err'}),
        dict(name='flash_fwd', route='cuda',
             source='sav_tpu_torch/csrc/flash_fwd.cu',
             replaces='sav_tpu/ops/flash_attention.py:228',
             launches=k4_launches,
             max_abs_err=max(r['max_abs_err'] for r in k4.values()),
             **{k: v for k, v in k4[577].items() if k != 'max_abs_err'}),
    ]
    if checks.failed:
        print(f'chip_smoke: {len(checks.failed)} check(s) failed:',
              file=sys.stderr)
        for what in checks.failed:
            print(f'  {what}', file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
