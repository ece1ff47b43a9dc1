"""Times the port's training step (or, with ``--serve``, its serving; with
``--kernels``, its attention kernels) for two or more checkouts on
one card.

Each checkout (a directory holding ``sav_tpu_torch/``) runs in a process of
its own, in turns (a, b, ..., then the reverse, ``--rounds`` times), so two
versions are compared within one call and in both orders. Each run builds
the checkout's kernels, makes the Trainer on the synthetic source, takes 3
warm-up steps, then prints the train img/s over ``--steps`` steps (host
clock around work that ends in a synchronize). With ``--profile`` it also
prints torch.profiler's device time by kernel over 2 steps, the device
time per step and the idle share (1 - device / wall). ``--use_kernel``
re-routes the Trainer's model (``models.set_use_kernel``) before the first
step, for the modes the Trainer has no flag for, as ``fused_ff``;
``--quantized ff|ff_sb`` trains the int8 mode. With
``--serve`` each run builds the model instead (random weights from seed 0,
``use_kernel`` as given, ``--quantized ff|all|int8`` its int8 route, and
with ``--dense_fused`` every QuantizedDense of 'int8' on K15) and prints
the img/s of ``predict.serve`` on uint8 frames over ``--steps`` batches
after 3 (host clock, H2D included); ``--profile`` adds the device time a
batch over 2 batches, by kernel.
With ``--kernels`` each run times, through the checkout's own wrappers on
inputs made from seed 0 with numpy, K1 (the attention sublayer forward,
whose attention launch is K4's kernel) at its four timed shapes, K4 at
ViT-B/16's serving and ``fused_ff`` training shapes, K2 at the @224
training shape and at 200 rows over 190 keys, the talking-heads backward
at CaiT-S/24's training shapes (K5b B=128 L=196, K6b B=48 L=576), K6a at
CaiT-S/24 @384's serving and training shapes (B=32 and 48, L=576) and at
cait_xxs_24 @224's (H=4, B=32 and 128, L=196), K5a at
B=32 and 128 L=196 (and, in a tree whose K5a takes them, at cait_xxs_24's
and cait_xs_24's widths), K1 without the residual at TNT-S/16's and TNT-B/16's
widths (serving bs32, training bs64 and bs32), K8b at Mixer-B/16 bs192,
K8a at Mixer-B/16 bs192 and bs32 and K7b at TNT-S/16 bs64's and TNT-B/16
bs32's inner layers (each through its wrapper and its C entry alone), K13
and K12 at their paths' rows (ViT-B/16 and Mixer-B/16 bs192 with
save_hpre and bs32 serving, CaiT-S/24 bs128 with save_hpre), and as
controls K16 (37,824 rows) and K14 at ViT-B/16 @224 bs192's and CaiT-S/24
@224 bs128's FF rows, and K11 (CaiT-S/24's and cait_xxs_24's widths, B=32
L=196), K15 (ViT-B/16 bs32's two FF products), K10 (ViT-B/16 bs32), K9b
(BoTNet-T3 bs64, each of its two C entries), K9a (BoTNet-T3 serving bs32,
training bs64) and K7a (TNT-S/16 serving bs32 and training bs64, TNT-B/16
bs32), each through its wrapper and its C entry alone (the parent's and
this tree's K7, K10, K11 and K15 C entries differ in their arguments: each
run calls its own), and digests of K1's, K7b's, K5a's, K5b's, K6a's, K6b's,
K11's, K12's, K13's and K14's outputs at those shapes (each equal in two
trees where that kernel's outputs are bit-identical), each with
this checkout's
``sav_tpu_torch.utils.timing.time_ms`` (the definition ``chip_smoke.py``
uses, handed to every run as source).

    python scripts/torch_train_ab.py PARENT_DIR . --model vit_b_patch16 \\
        --img 384 --batch 48 --profile
    python scripts/torch_train_ab.py PARENT_DIR . --img 224 --batch 192 \\
        --use_kernel fused_ff
    python scripts/torch_train_ab.py PARENT_DIR . --serve --img 384 \\
        --batch 32 --use_kernel fused_layer
    python scripts/torch_train_ab.py PARENT_DIR . --kernels
    python scripts/torch_train_ab.py PARENT_DIR . --model mixer_b_patch16 \\
        --img 224 --batch 192
    python scripts/torch_train_ab.py PARENT_DIR . --img 224 --batch 192 \\
        --quantized ff_sb
    python scripts/torch_train_ab.py PARENT_DIR . --model cait_s_24 \\
        --img 384 --batch 48
    python scripts/torch_train_ab.py PARENT_DIR . --serve --img 224 \\
        --batch 32 --model cait_s_24 --quantized all --profile
    python scripts/torch_train_ab.py PARENT_DIR . --serve --img 224 \\
        --batch 32 --quantized int8 --dense_fused --profile

Needs an NVIDIA card; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sav_tpu_torch.utils import timing  # noqa: E402

CHILD = r'''
import json, sys, time
import torch
sys.path.insert(0, {root!r})
from sav_tpu_torch import _build
from sav_tpu_torch.models import set_use_kernel
from sav_tpu_torch.train import TrainConfig, Trainer
assert _build.__file__.startswith({root!r}), _build.__file__
args = {args!r}
_build.build_all()


def profile_steps(step, iters=2):
    """Device time by kernel over ``iters`` calls of ``step(i)``, the
    device time a call and the idle share (1 - device / wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for i in range(iters):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    by_name = {{}}
    for e in prof.events():                 # kernels only: no double count
        if e.device_type == DeviceType.CUDA:
            ms, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    rows = sorted(((ms / iters, calls // iters, name)
                   for name, (ms, calls) in by_name.items()), reverse=True)
    device = sum(r[0] for r in rows)
    return dict(device_ms_step=device, wall_ms_step=1e3 * wall / iters,
                idle_share=1 - device / (1e3 * wall / iters),
                top=[dict(ms=r[0], calls=r[1], name=r[2][:90])
                     for r in rows[:15]])


if args['kernels']:
    import hashlib
    import math
    import numpy as np
    from sav_tpu_torch.ops import flash_attention as fa
    from sav_tpu_torch.ops import fused_layer
    rng = np.random.RandomState(0)

    def digest(result):
        """48 bits of the SHA-256 of every tensor in ``result`` (nested
        tuples), exact in a float: equal in two trees where the outputs
        are bit-identical."""
        torch.cuda.synchronize()
        sha = hashlib.sha256()
        stack = [result]
        while stack:
            t = stack.pop(0)
            if isinstance(t, (tuple, list)):
                stack = list(t) + stack
            elif t is not None:
                sha.update(t.contiguous().view(torch.uint8).cpu().numpy()
                           .tobytes())
        return float(int(sha.hexdigest()[:12], 16))

    bf16 = lambda shape, std=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32)).cuda().bfloat16()
    out = {{}}
    dim, heads = 768, 12
    for b, seq, train in ((32, 197, False), (32, 577, False),
                          (192, 197, True), (48, 577, True)):
        x = bf16((b, seq, dim))
        scale = (1 + 0.1 * bf16((dim,))).float()
        bias = (0.1 * bf16((dim,))).float()
        w = [bf16((dim, dim), s / math.sqrt(dim)) for s in (4, 1, 1, 1)]
        name = f'K1 B={{b}} L={{seq}}' + (' save_residuals' if train else '')
        out[name] = time_ms(lambda: fused_layer.fused_attention_fwd(
            x, scale, bias, *w, heads, save_residuals=train))
        out[f'{{name}} outputs digest'] = digest(
            fused_layer.fused_attention_fwd(x, scale, bias, *w, heads,
                                            save_residuals=train))
    for b, seq in ((32, 577), (192, 197)):
        q, k, v = (bf16((b, seq, dim), s) for s in (0.5, 1, 1))
        out[f'K4 B={{b}} L={{seq}}'] = time_ms(
            lambda: fa.flash_fwd(q, k, v, heads, seq))
    for b, seq, kv_len in ((192, 197, 197), (192, 200, 190)):
        q, k, v, do = (bf16((b, seq, dim), s) for s in (0.5, 1, 1, 1))
        o, lse = fa.flash_fwd(q, k, v, heads, kv_len)
        out[f'K2 B={{b}} L={{seq}} kv_len={{kv_len}}'] = time_ms(
            lambda: fa.bwd_fused(q, k, v, o, lse, do, heads, kv_len))
    # the talking-heads kernels at CaiT-S/24's shapes: the backward (K5b,
    # K6b) at the training shapes, K6a at the serving (B=32) and training
    # (B=48) shapes @384
    from sav_tpu_torch.ops import th_attention as th
    heads = 8
    hd = heads * th.HEAD_CH
    mixes = lambda: [(torch.eye(heads) + 0.3 * torch.from_numpy(
        rng.standard_normal((heads, heads)).astype(np.float32))).cuda()
        for _ in range(2)]
    for name, b, seq, fn in (('K5b', 128, 196, th.th_attention_bwd),
                             ('K6b', 48, 576, th.th_core_bwd)):
        q = bf16((b, seq, hd), 0.4)
        k, v, do = (bf16((b, seq, hd)) for _ in range(3))
        m = mixes()
        _, lse = th.th_core_fwd_plain(q, k, v, *m, heads)
        out[f'{{name}} B={{b}} L={{seq}}'] = time_ms(
            lambda: fn(q, k, v, do, lse, *m, heads))
        out[f'{{name}} outputs digest B={{b}} L={{seq}}'] = digest(
            fn(q, k, v, do, lse, *m, heads))
    for b in (32, 48):
        q = bf16((b, 576, hd), 0.4)
        k, v = (bf16((b, 576, hd)) for _ in range(2))
        m = mixes()
        out[f'K6a B={{b}} L=576'] = time_ms(
            lambda: th.th_core_fwd(q, k, v, *m, heads))
        out[f'K6a outputs digest B={{b}} L=576'] = digest(
            th.th_core_fwd(q, k, v, *m, heads))
    # K6a at cait_xxs_24 @224's serving (B=32) and training (B=128) shapes
    # (H = 4, L = 196)
    m4 = [(torch.eye(4) + 0.3 * torch.from_numpy(
        rng.standard_normal((4, 4)).astype(np.float32))).cuda()
        for _ in range(2)]
    for b in (32, 128):
        q = bf16((b, 196, 4 * th.HEAD_CH), 0.4)
        k, v = (bf16((b, 196, 4 * th.HEAD_CH)) for _ in range(2))
        out[f'K6a H=4 B={{b}} L=196'] = time_ms(
            lambda: th.th_core_fwd(q, k, v, *m4, 4))
        out[f'K6a H=4 outputs digest B={{b}} L=196'] = digest(
            th.th_core_fwd(q, k, v, *m4, 4))
    # K5a at CaiT-S/24 @224's serving (B=32) and training (B=128) shapes
    dim = 384
    w = [bf16((dim, hd), 1 / math.sqrt(dim)) for _ in range(3)]
    wo = bf16((hd, dim), 1 / math.sqrt(hd))
    ones, zeros = torch.ones(dim, device='cuda'), torch.zeros(dim, device='cuda')
    m = mixes()
    for b, train in ((32, False), (128, True)):
        x = bf16((b, 196, dim))
        out[f'K5a B={{b}} L=196' + (' save_residuals' if train else '')] = \
            time_ms(lambda: th.th_attention_fwd(
                x, ones, zeros, *w, wo, *m, heads, save_residuals=train))
        out[f'K5a outputs digest B={{b}} L=196'] = digest(th.th_attention_fwd(
            x, ones, zeros, *w, wo, *m, heads, save_residuals=train))
    # K5a at cait_xxs_24's (H = 4, D = 192) and cait_xs_24's (H = 6, D =
    # 288) @224 serving and training shapes, in a tree whose K5a takes them
    # (inputs from a generator of their own: the later kernels' inputs are
    # the same in a tree that skips these)
    rx = np.random.RandomState(1)
    bfx = lambda shape, std=1.0: torch.from_numpy(
        (rx.standard_normal(shape) * std).astype(np.float32)).cuda().bfloat16()
    for heads_x in (4, 6):
        dim_x = hd_x = heads_x * th.HEAD_CH
        if not th.fused_fits(196, heads_x, dim_x):
            continue
        wx = [bfx((dim_x, hd_x), 1 / math.sqrt(dim_x)) for _ in range(4)]
        mx = [(torch.eye(heads_x) + 0.3 * torch.from_numpy(
            rx.standard_normal((heads_x, heads_x)).astype(np.float32))).cuda()
            for _ in range(2)]
        lnx = torch.ones(dim_x, device='cuda'), torch.zeros(dim_x, device='cuda')
        for b, train in ((32, False), (128, True)):
            x = bfx((b, 196, dim_x))
            out[f'K5a H={{heads_x}} D={{dim_x}} B={{b}} L=196'
                + (' save_residuals' if train else '')] = time_ms(
                lambda: th.th_attention_fwd(x, *lnx, *wx, *mx, heads_x,
                                            save_residuals=train))
    # K1 without the residual at TNT's outer widths (TNT-S D=384 H=6,
    # TNT-B D=640 H=10, L=197): serving bs32, training bs64 and bs32
    for name, b, dim, heads1, train in (('TNT-S', 32, 384, 6, False),
                                        ('TNT-B', 32, 640, 10, False),
                                        ('TNT-S', 64, 384, 6, True),
                                        ('TNT-B', 32, 640, 10, True)):
        x = bf16((b, 197, dim))
        scale = (1 + 0.1 * bf16((dim,))).float()
        bias = (0.1 * bf16((dim,))).float()
        w1 = [bf16((dim, dim), s / math.sqrt(dim)) for s in (4, 1, 1, 1)]
        key = f'K1 residual=False {{name}} B={{b}}' + (
            ' save_residuals' if train else '')
        out[key] = time_ms(lambda: fused_layer.fused_attention_fwd(
            x, scale, bias, *w1, heads1, save_residuals=train,
            residual=False))
    # K8b at Mixer-B/16 bs192; the controls, whose code does not change:
    # K16 (ViT-B/16 @224 bs192's rows), K14 at ViT-B/16 @224 bs192's and
    # CaiT-S/24 @224 bs128's FF rows
    from sav_tpu_torch.ops import int8_ff
    from sav_tpu_torch.ops import mixer_token as mt
    mrows, d, f = 192 * 197, 768, 3072
    args16 = (bf16((mrows, d)), bf16((mrows, f)), bf16((mrows, d)),
              bf16((d, f), 1 / math.sqrt(d)), bf16((f, d), 1 / math.sqrt(f)))
    out[f'K16 (control) M={{mrows}}'] = time_ms(
        lambda: fused_layer.ff_bwd(*args16))
    del args16
    lt, kt = 196, 98
    x8 = bf16((192, lt, d))
    args8 = (x8, (1 + 0.1 * bf16((d,))).float(), (0.1 * bf16((d,))).float(),
             bf16((lt, kt), 1 / math.sqrt(lt)), (0.1 * bf16((kt,))).float(),
             bf16((kt, lt), 1 / math.sqrt(kt)), (0.1 * bf16((lt,))).float())
    g8 = bf16((192, lt, d))
    out['K8b B=192'] = time_ms(lambda: mt.token_mix_bwd(*args8, g8))
    del g8
    # K8a at Mixer-B/16's training (B=192) and serving (B=32) shapes,
    # through the wrapper and through its C entry alone (the wrapper's
    # host work is most of a B=32 call)
    import ctypes
    for b8 in (192, 32):
        a8 = (args8[0][:b8].contiguous(),) + args8[1:]
        out[f'K8a B={{b8}}'] = time_ms(lambda: mt.token_mix_fwd(*a8))
        st8 = torch.empty(b8 * lt, 2, device='cuda')
        o8 = torch.empty_like(a8[0])
        fn8 = mt._fn('sav_mixer_fwd', 9, 4, 1)
        p8 = [t.data_ptr() for t in a8] + [st8.data_ptr(), o8.data_ptr()]
        s8 = fa.stream_of(torch.device('cuda'))
        out[f'K8a C entry B={{b8}}'] = time_ms(
            lambda: fn8(*p8, b8, lt, kt, d, 1e-6, s8))
    del x8, args8
    # K7a at TNT-S/16 serving bs32 and training bs64 and TNT-B/16 bs32, K7b
    # at TNT-S/16 bs64's and TNT-B/16 bs32's inner layers (B*P = 196 B
    # patches, D = 24 and 40, H = 4, F = 4 D), each through its wrapper and
    # its C entry alone (the parameters prepared and the workspace
    # allocated once); the trees' C entries differ: since the Hopper K7a
    # both take the f32 parameters as the model holds them, before it the
    # bf16 weights concatenated and cast. Then a digest of K7b's 13
    # outputs (48 bits of their bytes' SHA-256, exact in a float), equal in
    # two trees where they are bit-identical.
    import hashlib
    from sav_tpu_torch.ops import tnt_inner
    raw_abi = hasattr(tnt_inner, 'tnt_fwd_plan')
    s7 = fa.stream_of(torch.device('cuda'))

    def k7_case(n7, d7):
        f7, h7 = 4 * d7, 4
        w7 = lambda *s, std=1.0: (bf16(s, std / math.sqrt(s[0]))).float()
        return (bf16((n7, 16, d7)), (1 + 0.1 * bf16((d7,))).float(),
                (0.1 * bf16((d7,))).float(), w7(d7, h7, d7 // h7, std=2.0),
                w7(d7, h7, d7 // h7), w7(d7, h7, d7 // h7),
                w7(h7, d7 // h7, d7), (1 + 0.1 * bf16((d7,))).float(),
                (0.1 * bf16((d7,))).float(), w7(d7, f7),
                (0.1 * bf16((f7,))).float(), w7(f7, d7),
                (0.1 * bf16((d7,))).float())

    def k7_params(a7):
        if raw_abi:
            return tnt_inner._check(a7[0], a7[1:], 4)
        return list(tnt_inner._check(a7[0], *a7[1:], 4))

    for name, n7, d7 in (('TNT-S serve', 32 * 196, 24),
                         ('TNT-S train', 64 * 196, 24),
                         ('TNT-B', 32 * 196, 40)):
        a7 = k7_case(n7, d7)
        out[f'K7a {{name}} B*P={{n7}}'] = time_ms(
            lambda: tnt_inner.inner_layer_fwd(*a7, 4))
        o7 = torch.empty_like(a7[0])
        p7 = ([a7[0].data_ptr()] + [t.data_ptr() for t in k7_params(a7)]
              + [o7.data_ptr()])
        fn7 = tnt_inner._fn('sav_tnt_fwd', len(p7), 4, 2)
        out[f'K7a C entry {{name}} B*P={{n7}}'] = time_ms(
            lambda: fn7(*p7, n7, d7, 4 * d7, 4, 1e-6, (d7 // 4) ** -0.5, s7))
        del a7
    for name, n7, d7 in (('TNT-S', 64 * 196, 24), ('TNT-B', 32 * 196, 40)):
        f7, h7 = 4 * d7, 4
        a7 = k7_case(n7, d7)
        g7 = bf16((n7, 16, d7))
        out[f'K7b {{name}} B*P={{n7}}'] = time_ms(
            lambda: tnt_inner.inner_layer_bwd(*a7, g7, h7))
        grads7 = tnt_inner.inner_layer_bwd(*a7, g7, h7)
        torch.cuda.synchronize()
        sha7 = hashlib.sha256()
        for t in grads7:
            sha7.update(t.contiguous().view(torch.uint8).cpu().numpy()
                        .tobytes())
        out[f'K7b outputs digest {{name}}'] = float(
            int(sha7.hexdigest()[:12], 16))
        gw7 = torch.empty(4 * d7 * d7 + 2 * d7 * f7, device='cuda')
        gv7 = torch.empty(5 * d7 + f7, device='cuda')
        dx7 = torch.empty_like(a7[0])
        ws7 = torch.empty(tnt_inner._fn(
            'sav_tnt_bwd_workspace', 0, 4, restype=ctypes.c_longlong)(
                n7, d7, f7, h7), dtype=torch.uint8, device='cuda')
        p7 = ([a7[0].data_ptr(), g7.data_ptr()]
              + [t.data_ptr() for t in k7_params(a7)]
              + [t.data_ptr() for t in (dx7, gw7, gv7, ws7)])
        fn7 = tnt_inner._fn('sav_tnt_bwd', len(p7), 4, 2)
        out[f'K7b C entry {{name}} B*P={{n7}}'] = time_ms(
            lambda: fn7(*p7, n7, d7, f7, h7, 1e-6, (d7 // h7) ** -0.5, s7))
        del a7, g7, grads7
    wf = lambda shape, std: torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32)).cuda()
    for rows, dd, ff in ((192 * 197, 768, 3072), (128 * 196, 384, 1536)):
        g14 = bf16((rows, dd), 0.02)
        h14 = bf16((rows, ff))
        w14 = (*int8_ff._dx_quantized(wf((dd, ff), 1 / math.sqrt(dd))),
               *int8_ff._dx_quantized(wf((ff, dd), 1 / math.sqrt(ff))))
        out[f'K14 (control) M={{rows}} D={{dd}}'] = time_ms(
            lambda: int8_ff.int8_ff_dx_raw(g14, h14, *w14))
        out[f'K14 outputs digest M={{rows}} D={{dd}}'] = digest(
            int8_ff.int8_ff_dx_raw(g14, h14, *w14))
        del g14, h14
    # the kernels under test: K13 at ViT-B/16 'ff' bs192 (save_hpre) and
    # bs32 (serving), K12 at Mixer-B/16 'ff' bs192 and bs32, and save_hpre
    # at CaiT-S/24 'ff'/'ff_sb' bs128 (D = 384, F = 1536)
    for name, rows, dd, ff, train in (
            ('K13', 192 * 197, 768, 3072, True),
            ('K13', 32 * 197, 768, 3072, False),
            ('K12', 192 * 196, 768, 3072, True),
            ('K12', 32 * 196, 768, 3072, False),
            ('K12', 128 * 196, 384, 1536, True)):
        raw = int8_ff.int8_ff_ln_raw if name == 'K13' else int8_ff.int8_ff_raw
        xq = bf16((rows, dd))
        w1q, s1, w2q, s2 = int8_ff._quantized_weights(
            wf((dd, ff), 1 / math.sqrt(dd)), wf((ff, dd), 1 / math.sqrt(ff)))
        b1, b2 = 0.1 * wf((ff,), 1), 0.1 * wf((dd,), 1)
        lnp = ((1 + 0.1 * wf((dd,), 1), 0.1 * wf((dd,), 1))
               if name == 'K13' else ())
        key = f'{{name}} {{"train" if train else "serve"}} M={{rows}} D={{dd}}'
        out[key] = time_ms(
            lambda: raw(xq, *lnp, w1q, s1, b1, w2q, s2, b2, save_hpre=train))
        out[key.replace(' ', ' outputs digest ', 1)] = digest(
            raw(xq, *lnp, w1q, s1, b1, w2q, s2, b2, save_hpre=train))
        del xq
    # K11 at CaiT-S/24's and cait_xxs_24's widths @224 bs32 ('all'
    # serving) and K15 at ViT-B/16 bs32's two FF products ('int8' with
    # QuantizedDense(fused=True)), each through its wrapper and its C entry
    # alone on buffers made once (this tree's entries take the codes as
    # they are and one workspace; the parent's took them transposed and
    # its scratch buffer by buffer)
    from sav_tpu_torch.ops import int8_matmul_kernel as k15
    from sav_tpu_torch.ops.quantized import quantize_symmetric
    st = fa.stream_of(torch.device('cuda'))
    vec = lambda t, n: t.reshape(n).float().contiguous()
    for dd, hh in ((384, 8), (192, 4)):
        hd, m11 = hh * th.HEAD_CH, 32 * 196
        xq = bf16((32, 196, dd))
        scq, biq = 1 + 0.1 * wf((dd,), 1), 0.1 * wf((dd,), 1)
        w11 = [wf((dd, hh, 48), 4 / math.sqrt(dd))] + [
            wf((dd, hh, 48), 1 / math.sqrt(dd)) for _ in range(2)] + [
            wf((hh, 48, dd), 1 / math.sqrt(hd))]
        flat = [t for p in fused_layer._q8_weights(*w11, dd, hd) for t in p]
        mq = [torch.eye(hh, device='cuda') + 0.3 * wf((hh, hh), 1)
              for _ in range(2)]
        key = f'B=32 L=196 D={{dd}} H={{hh}}'
        with torch.no_grad():
            out['K11 ' + key] = time_ms(
                lambda: th.th_attention_q8(xq, scq, biq, *flat, *mq, hh))
            out['K11 outputs digest ' + key] = digest(
                th.th_attention_q8(xq, scq, biq, *flat, *mq, hh))
        scales = [vec(t, n) for t, n in zip(flat[1::2], (hd, hd, hd, dd))]
        o11 = torch.empty_like(xq)
        if hasattr(th, 'th_q8_plan'):
            ws11 = torch.empty(th.th_q8_plan(32, 196, dd, hh)['workspace'],
                               dtype=torch.uint8, device='cuda')
            b11 = [xq, scq, biq, *flat[0::2], *scales,
                   th._mix_bank(*mq, hh, xq.device), ws11, o11]
        else:
            i8 = lambda w: torch.empty(m11, w, dtype=torch.int8, device='cuda')
            bfb = lambda: torch.empty(m11, hd, dtype=torch.bfloat16,
                                      device='cuda')
            b11 = ([xq, scq, biq] + [t.t().contiguous() for t in flat[0::2]]
                   + scales + [t.float().contiguous() for t in mq]
                   + [i8(dd), torch.empty(m11, device='cuda')]
                   + [bfb() for _ in range(4)]
                   + [i8(hd), torch.empty(m11, device='cuda'), o11])
        p11, fn11 = [t.data_ptr() for t in b11], th._k11_lib()
        out['K11 C entry ' + key] = time_ms(
            lambda: fn11(*p11, 32, 196, dd, hh, 0, 1e-6, 1 / math.sqrt(48), st))
        del xq, b11
    for k5, n5 in ((768, 3072), (3072, 768)):
        a5 = bf16((6304, k5))
        bq5, bs5 = quantize_symmetric(bf16((k5, n5), 1 / math.sqrt(k5)), 0)
        key = f'M=6304 K={{k5}} N={{n5}}'
        out['K15 ' + key] = time_ms(
            lambda: k15.int8_matmul_fused(a5, bq5, bs5))
        o5 = torch.empty(6304, n5, dtype=torch.bfloat16, device='cuda')
        if hasattr(k15, 'int8_matmul_plan'):
            ws5 = torch.empty(k15.int8_matmul_plan(6304, k5, n5)['workspace'],
                              dtype=torch.uint8, device='cuda')
            b5 = [a5, bq5, bs5.reshape(n5).contiguous(), ws5, o5]
        else:
            kp = -(-k5 // 256) * 256
            b5 = [a5, torch.nn.functional.pad(bq5.t(), (0, kp - k5)).contiguous(),
                  bs5.reshape(n5).contiguous(),
                  torch.empty(6304, kp, dtype=torch.int8, device='cuda'),
                  torch.empty(6304, kp // 256, device='cuda'), o5]
        p5, fn15 = [t.data_ptr() for t in b5], k15._k15_lib()
        out['K15 C entry ' + key] = time_ms(
            lambda: fn15(*p5, 6304, k5, n5, st))
        del a5, b5
    # K10 at ViT-B/16 @224 bs32 ('all' serving), through its wrapper and its
    # C entry alone on buffers made once (this tree's entry takes the codes
    # as they are and one workspace; the parent's took them transposed and
    # its scratch buffer by buffer)
    dd, hh = 768, 12
    hd, m10 = hh * 64, 32 * 197
    x10 = bf16((32, 197, dd))
    sc10, bi10 = 1 + 0.1 * wf((dd,), 1), 0.1 * wf((dd,), 1)
    w10 = [wf((dd, hh, 64), 4 / math.sqrt(dd))] + [
        wf((dd, hh, 64), 1 / math.sqrt(dd)) for _ in range(2)] + [
        wf((hh, 64, dd), 1 / math.sqrt(hd))]
    flat10 = [t for p in fused_layer._q8_weights(*w10, dd, hd) for t in p]
    with torch.no_grad():
        out['K10 B=32 L=197'] = time_ms(
            lambda: fused_layer.fused_attention_q8(x10, sc10, bi10, *flat10,
                                                   hh))
    scales10 = [vec(t, n) for t, n in zip(flat10[1::2], (hd, hd, hd, dd))]
    o10 = torch.empty_like(x10)
    if hasattr(fused_layer, 'fused_q8_plan'):
        ws10 = torch.empty(fused_layer.fused_q8_plan(32, 197, dd, hh)[
            'workspace'], dtype=torch.uint8, device='cuda')
        b10 = [x10, sc10, bi10, *flat10[0::2], *scales10, ws10, o10]
    else:
        i8 = lambda w: torch.empty(m10, w, dtype=torch.int8, device='cuda')
        bfb = lambda: torch.empty(m10, hd, dtype=torch.bfloat16,
                                  device='cuda')
        b10 = ([x10, sc10, bi10] + [t.t().contiguous() for t in flat10[0::2]]
               + scales10 + [i8(dd), torch.empty(m10, device='cuda')]
               + [bfb() for _ in range(4)]
               + [i8(hd), torch.empty(m10, device='cuda'), o10])
    p10, fn10 = [t.data_ptr() for t in b10], fused_layer._k10_lib()
    out['K10 C entry B=32 L=197'] = time_ms(
        lambda: fn10(*p10, 32, 197, dd, hh, 1, 1e-6, 0.125, st))
    del x10, b10
    # K9b at BoTNet-T3 @224 bs64 (g = 14, 4 heads of d = 128), through its
    # wrapper and each of its two C entries alone (the same arguments in
    # either tree)
    from sav_tpu_torch.ops import botnet_attention as bot
    g9, h9, d9, b9 = 14, 4, 128, 64
    l9 = g9 * g9
    qs9 = bf16((b9, l9, h9 * d9), 2 / math.sqrt(d9))
    k9, v9, do9 = (bf16((b9, l9, h9 * d9)) for _ in range(3))
    rh9, rw9 = (bf16((b9, h9, l9, g9), 0.5).float() for _ in range(2))
    o9, lse9 = bot.bot_fwd_plain(qs9, k9, v9, rh9, rw9, h9, g9)
    out['K9b B=64 g=14'] = time_ms(lambda: bot.bot_bwd(
        qs9, k9, v9, rh9, rw9, o9, lse9, do9, h9, g9))
    delta9 = torch.empty_like(lse9)
    dq9, dk9, dv9 = (torch.empty_like(qs9) for _ in range(3))
    drh9, drw9 = torch.empty_like(rh9), torch.empty_like(rw9)
    dims9 = (b9, l9, h9, g9, d9, st)
    f_dq, f_dkv = bot._fn('sav_bot_bwd_dq', 12, 5), bot._fn(
        'sav_bot_bwd_dkv', 10, 5)
    p_dq = [t.data_ptr() for t in (qs9, k9, v9, o9, do9, rh9, rw9, lse9,
                                   delta9, dq9, drh9, drw9)]
    p_dkv = [t.data_ptr() for t in (qs9, k9, v9, do9, rh9, rw9, lse9, delta9,
                                    dk9, dv9)]
    out['K9b dq C entry B=64 g=14'] = time_ms(lambda: f_dq(*p_dq, *dims9))
    out['K9b dkv C entry B=64 g=14'] = time_ms(lambda: f_dkv(*p_dkv, *dims9))
    # K9a at BoTNet-T3 serving bs32 and the training forward (lse) bs64,
    # through its wrapper and its C entry alone (the same arguments in
    # either tree)
    f_fwd = bot._fn('sav_bot_fwd', 7, 5)
    for b9a, train in ((32, False), (64, True)):
        a9 = (qs9[:b9a].contiguous(), k9[:b9a].contiguous(),
              v9[:b9a].contiguous(), rh9[:b9a].contiguous(),
              rw9[:b9a].contiguous())
        tag = 'train' if train else 'serve'
        out[f'K9a {{tag}} B={{b9a}} g=14'] = time_ms(
            lambda: bot.bot_fwd(*a9, h9, g9, save_lse=train))
        o9a = torch.empty_like(a9[0])
        l9a = torch.empty(b9a, h9, l9, device='cuda') if train else None
        p9a = [t.data_ptr() for t in (*a9, o9a)] + [
            l9a.data_ptr() if train else None]
        out[f'K9a C entry {{tag}} B={{b9a}} g=14'] = time_ms(
            lambda: f_fwd(*p9a, b9a, l9, h9, g9, d9, st))
    print('RESULT ' + json.dumps(out), flush=True)
    sys.exit(0)
if args['serve']:
    import numpy as np
    from sav_tpu_torch.models import create_model
    from sav_tpu_torch.predict import decode_size_for, serve
    quant = True if args['quantized'] == 'int8' else args['quantized']
    q = {{'quantized': quant}} if quant else {{}}
    model = create_model(args['model'], num_classes=1000,
                         dtype=torch.bfloat16, img_size=args['img'], seed=0,
                         device='cuda', use_kernel=args['use_kernel'],
                         **q).eval()
    if args['dense_fused']:
        from sav_tpu_torch.nn.quantized_dense import QuantizedDense
        for sub in model.modules():
            if isinstance(sub, QuantizedDense):
                sub.fused = True
    size = decode_size_for(args['img'])
    frames = np.random.RandomState(0).randint(
        0, 256, (args['batch'], size, size, 3), dtype=np.uint8)
    for _ in range(3):
        serve(model, frames, args['img'], 5)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(args['steps']):
        serve(model, frames, args['img'], 5)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    res = dict(img_s=args['steps'] * args['batch'] / secs,
               ms_step=1e3 * secs / args['steps'])
    if args['profile']:
        res.update(profile_steps(lambda i: serve(model, frames, args['img'],
                                                 5)))
    print('RESULT ' + json.dumps(res), flush=True)
    sys.exit(0)
trainer = Trainer(TrainConfig(model_name=args['model'], img_size=args['img'],
                              batch_size=args['batch'], seed=0,
                              dtype='bfloat16', quantized=args['quantized']),
                  device='cuda')
if args['use_kernel'] != 'auto':
    set_use_kernel(trainer.model, args['use_kernel'])
data = trainer.dataset()
for i in range(3):
    trainer.train_step(data.batch(i))
torch.cuda.synchronize()
start = time.perf_counter()
for i in range(args['steps']):
    metrics = trainer.train_step(data.batch(3 + i))
loss = float(metrics['loss'])
secs = time.perf_counter() - start
out = dict(img_s=args['steps'] * args['batch'] / secs,
           ms_step=1e3 * secs / args['steps'], loss=loss)
if args['profile']:
    out.update(profile_steps(lambda i: trainer.train_step(data.batch(i))))
print('RESULT ' + json.dumps(out), flush=True)
'''


def run(root: str, args: dict) -> dict:
    code = (inspect.getsource(timing)
            + CHILD.format(root=os.path.abspath(root), args=args))
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, cwd=os.path.abspath(root))
    for line in proc.stdout.splitlines():
        if line.startswith('RESULT '):
            return json.loads(line[len('RESULT '):])
    raise RuntimeError(f'{root}: no result (rc {proc.returncode})\n'
                       f'{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('roots', nargs='+', help='checkout directories')
    parser.add_argument('--model', default='vit_b_patch16')
    parser.add_argument('--img', type=int, default=384)
    parser.add_argument('--batch', type=int, default=48)
    parser.add_argument('--steps', type=int, default=10)
    parser.add_argument('--rounds', type=int, default=1,
                        help='each round runs the roots forward, then back')
    parser.add_argument('--use_kernel', default='auto',
                        help="the model's use_kernel mode, e.g. fused_ff")
    parser.add_argument('--quantized', default='none',
                        choices=('none', 'ff', 'ff_sb', 'all', 'int8'),
                        help="the int8 route: the Trainer's ff or ff_sb, "
                             "or with --serve the model's ff, all or int8")
    parser.add_argument('--dense_fused', action='store_true',
                        help="with --serve --quantized int8: every "
                             "QuantizedDense on K15 (fused=True)")
    parser.add_argument('--profile', action='store_true')
    parser.add_argument('--serve', action='store_true',
                        help='time predict.serve instead of a train step')
    parser.add_argument('--kernels', action='store_true',
                        help='time the flash, TH, FF-backward, token-mixing '
                             'and int8 kernels instead of a step')
    opts = parser.parse_args(argv)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    args = dict(model=opts.model, img=opts.img, batch=opts.batch,
                steps=opts.steps, profile=opts.profile,
                use_kernel=opts.use_kernel, serve=opts.serve,
                kernels=opts.kernels, dense_fused=opts.dense_fused,
                quantized=False if opts.quantized == 'none' else opts.quantized)
    order = []
    for _ in range(opts.rounds):
        order += list(opts.roots) + list(reversed(opts.roots))
    for root in order:
        res = run(root, args)
        if opts.kernels:
            print(f'{root}: ' + '  '.join(f'{k} {v:.4f}' for k, v in
                                          res.items()) + ' (ms)', flush=True)
            continue
        mode = opts.use_kernel + ('' if opts.quantized == 'none'
                                  else f', quantized={opts.quantized}')
        mode += ', dense_fused' if opts.dense_fused else ''
        what = (f'{root}: {opts.model} ({mode}) @{opts.img} '
                f'bs{opts.batch}: {res["img_s"]:.1f}')
        if opts.serve:
            print(f'{what} serve img/s ({res["ms_step"]:.2f} ms/batch incl. '
                  f'host)', flush=True)
        else:
            print(f'{what} train img/s ({res["ms_step"]:.2f} ms/step incl. '
                  f'host), loss {res["loss"]:.4f}', flush=True)
        if 'device_ms_step' in res:
            print(f'  device {res["device_ms_step"]:.2f} ms of '
                  f'{res["wall_ms_step"]:.2f} ms a '
                  f'{"batch" if opts.serve else "step"} (idle '
                  f'{100 * res["idle_share"]:.1f}%), by kernel:', flush=True)
            for row in res['top']:
                print(f'    {row["ms"]:8.3f} ms  x{row["calls"]:<4d} '
                      f'{row["name"]}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
