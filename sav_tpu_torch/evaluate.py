"""Standalone evaluation CLI of the torch port (counterpart of
``evaluate.py``, the same flags plus ``--device``): checkpoint -> loss,
top-1 and top-5 on an eval source.

Restores a Trainer checkpoint (``train/checkpoint.py``: the latest step,
or ``--step``, else the directory's ``params.npz``), its EMA with
``--ema`` where it keeps one, adapted to ``-s`` (pos-embed grids and
BoTNet's rel-pos tables interpolate; another head width raises), and
scores it on any source ``create_dataset`` reads — a JPEG tree, a tar, an
``.npz`` file or shards, or ``synthetic`` — with the Trainer's
mask-aware full-split eval: the clean resize-small -> central-crop ->
normalize transform, no augmentation, the padded tail masked.
``--holdout_fraction`` selects the same tail of a single source that a
Trainer with that fraction held out, and the data is seeded with
``--seed`` + 1 as the Trainer's eval data is, so a run's eval numbers are
reproducible after the fact:

    python -m sav_tpu_torch.evaluate -m vit_s_patch16 -c /ckpts \\
        --data_dir /data/train --holdout_fraction 0.05

Prints one JSON line: the metrics, ``eval_images``, ``eval_step`` and
``images_per_sec`` (host decode and the device included).
"""

from __future__ import annotations

import argparse
import json
import time

from sav_tpu_torch import resolve_device
from sav_tpu_torch.data.pipeline import create_dataset, parse_dataset_spec
from sav_tpu_torch.models import create_model
from sav_tpu_torch.models.factory import resolve_num_classes
from sav_tpu_torch.predict import DTYPES, restore_weights
from sav_tpu_torch.train import steps as steps_lib


def run_eval(model_name: str, checkpoint_dir: str, data_dir: str,
             img_size: int = 224, batch_size: int = 32,
             num_classes=None, dtype: str = 'bfloat16',
             use_ema: bool = True, eval_batches=None,
             holdout_fraction: float = 0.0, seed: int = 42,
             data_workers: int = 0, quantized=False,
             pos_embed: str = 'learned', step=None, device=None):
    """Returns per-example-mean eval metrics (+ ``eval_images``,
    ``eval_step``, ``images_per_sec``); ``{}`` where the source gave no
    batch. Raises FileNotFoundError where ``checkpoint_dir`` holds no
    checkpoint. ``num_classes`` None is a ``model.json`` spec's own head
    width, else 1000. Runs on the card unless ``device='cpu'``."""
    device = resolve_device(device)
    num_classes = resolve_num_classes(model_name, num_classes)
    model_kwargs = {'num_classes': num_classes}
    if pos_embed != 'learned':
        model_kwargs['pos_embed'] = pos_embed
    if quantized:
        model_kwargs['quantized'] = quantized
    model = create_model(model_name, dtype=DTYPES[dtype], img_size=img_size,
                         device=device, **model_kwargs)
    restored = restore_weights(model, model_name, checkpoint_dir, img_size,
                               use_ema, step=step, **model_kwargs)
    if restored is None:
        raise FileNotFoundError(f'no checkpoint in {checkpoint_dir}')

    split = None
    base, inline = parse_dataset_spec(data_dir)
    if (inline is None and holdout_fraction
            and not base.startswith('tfds:')):
        split = ('holdout', 1.0 - holdout_fraction, 1.0)
    # seed + 1 matches the Trainer's eval dataset (seed_offset=1)
    dataset = create_dataset(data_dir, batch_size=batch_size,
                             image_size=img_size, num_classes=num_classes,
                             seed=seed + 1, device=device, training=False,
                             num_workers=data_workers, split=split)
    start = time.perf_counter()
    try:
        metrics, count = steps_lib.mean_over_batches(
            lambda batch: steps_lib.eval_sums(model, batch, num_classes),
            dataset, eval_batches)
    finally:
        if hasattr(dataset, 'close'):
            dataset.close()
    elapsed = time.perf_counter() - start      # the means' reads waited
    if not metrics:
        return {}
    metrics['eval_images'] = count
    metrics['eval_step'] = restored['step']
    metrics['images_per_sec'] = count / max(elapsed, 1e-9)
    return metrics


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('-m', '--model_name', required=True,
                   help='registry name, or a model.json spec (its path or '
                        'its directory)')
    p.add_argument('-c', '--checkpoint_dir', required=True,
                   help='Trainer checkpoint directory')
    p.add_argument('--data_dir', required=True,
                   help="eval source: JPEG tree / tar / .npz / 'synthetic'; "
                        'may carry a ?split= suffix')
    p.add_argument('-s', '--img_size', type=int, default=224)
    p.add_argument('-b', '--batch_size', type=int, default=32)
    p.add_argument('--num_classes', type=int, default=None,
                   help='head width (default: a model.json spec\'s own, else '
                        '1000)')
    p.add_argument('--dtype', default='bfloat16', choices=sorted(DTYPES))
    p.add_argument('--ema', dest='use_ema', action='store_true', default=True,
                   help='use the EMA params when the checkpoint carries them')
    p.add_argument('--no-ema', dest='use_ema', action='store_false')
    p.add_argument('--eval_batches', type=int, default=None,
                   help='batches to score; default: the full split')
    p.add_argument('--holdout_fraction', type=float, default=0.0,
                   help='score the tail slice a Trainer with the same '
                        'fraction held out of training')
    p.add_argument('--seed', type=int, default=42,
                   help='must match the training --seed for holdout parity')
    p.add_argument('--data_workers', type=int, default=0)
    p.add_argument('--quantized', default='none',
                   choices=['none', 'int8', 'ff', 'all'],
                   help='int8 serving kernels (see predict)')
    p.add_argument('--pos_embed', default='learned',
                   choices=['learned', 'fixed', 'rotary'],
                   help='must match the training --pos_embed')
    p.add_argument('--step', type=int, default=None,
                   help='checkpoint step to restore (default: latest)')
    p.add_argument('--device', default=None, help='cuda (default) or cpu')
    return p


def main(argv=None):
    a = _parser().parse_args(argv)
    q = False if a.quantized == 'none' else (
        True if a.quantized == 'int8' else a.quantized)
    metrics = run_eval(a.model_name, a.checkpoint_dir, a.data_dir,
                       img_size=a.img_size, batch_size=a.batch_size,
                       num_classes=a.num_classes, dtype=a.dtype,
                       use_ema=a.use_ema, eval_batches=a.eval_batches,
                       holdout_fraction=a.holdout_fraction, seed=a.seed,
                       data_workers=a.data_workers, quantized=q,
                       pos_embed=a.pos_embed, step=a.step, device=a.device)
    if not metrics:
        raise SystemExit('error: eval source produced no batches')
    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in metrics.items()}))
    return metrics


if __name__ == '__main__':
    main()
