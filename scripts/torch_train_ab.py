"""Times the port's training step for two or more checkouts on one card.

Each checkout (a directory holding ``sav_tpu_torch/``) runs in a process of
its own, in turns (a, b, ..., then the reverse, ``--rounds`` times), so two
versions are compared within one call and in both orders. Each run builds
the checkout's kernels, makes the Trainer on the synthetic source, takes 3
warm-up steps, then prints the train img/s over ``--steps`` steps (host
clock around work that ends in a synchronize). With ``--profile`` it also
prints torch.profiler's device time by kernel over 2 steps, the device
time per step and the idle share (1 - device / wall).

    python scripts/torch_train_ab.py PARENT_DIR . --model vit_b_patch16 \\
        --img 384 --batch 48 --profile

Needs an NVIDIA card; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys, time
import torch
sys.path.insert(0, {root!r})
from sav_tpu_torch import _build
from sav_tpu_torch.train import TrainConfig, Trainer
assert _build.__file__.startswith({root!r}), _build.__file__
args = {args!r}
_build.build_all()
trainer = Trainer(TrainConfig(model_name=args['model'], img_size=args['img'],
                              batch_size=args['batch'], seed=0,
                              dtype='bfloat16'), device='cuda')
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
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    iters = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for i in range(iters):
            trainer.train_step(data.batch(i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    from torch.autograd import DeviceType
    by_name = {{}}
    for e in prof.events():                 # kernels only: no double count
        if e.device_type == DeviceType.CUDA:
            ms, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    rows = sorted(((ms / iters, calls // iters, name)
                   for name, (ms, calls) in by_name.items()), reverse=True)
    device = sum(r[0] for r in rows)
    out.update(device_ms_step=device, wall_ms_step=1e3 * wall / iters,
               idle_share=1 - device / (1e3 * wall / iters),
               top=[dict(ms=r[0], calls=r[1], name=r[2][:90])
                    for r in rows[:15]])
print('RESULT ' + json.dumps(out), flush=True)
'''


def run(root: str, args: dict) -> dict:
    code = CHILD.format(root=os.path.abspath(root), args=args)
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
    parser.add_argument('--profile', action='store_true')
    opts = parser.parse_args(argv)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    args = dict(model=opts.model, img=opts.img, batch=opts.batch,
                steps=opts.steps, profile=opts.profile)
    order = []
    for _ in range(opts.rounds):
        order += list(opts.roots) + list(reversed(opts.roots))
    for root in order:
        res = run(root, args)
        print(f'{root}: {opts.model} @{opts.img} bs{opts.batch}: '
              f'{res["img_s"]:.1f} train img/s ({res["ms_step"]:.2f} ms/step '
              f'incl. host), loss {res["loss"]:.4f}', flush=True)
        if 'device_ms_step' in res:
            print(f'  device {res["device_ms_step"]:.2f} ms of '
                  f'{res["wall_ms_step"]:.2f} ms a step (idle '
                  f'{100 * res["idle_share"]:.1f}%), by kernel:', flush=True)
            for row in res['top']:
                print(f'    {row["ms"]:8.3f} ms  x{row["calls"]:<4d} '
                      f'{row["name"]}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
