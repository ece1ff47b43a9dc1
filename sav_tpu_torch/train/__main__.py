"""Training CLI of the torch port (counterpart of ``train.py``, same flag
names, plus ``--device``).

Example:
    python -m sav_tpu_torch.train --data_dir synthetic -m vit_b_patch16 \\
        -c /tmp/ckpt -b 192 --total_steps 100

    python -m sav_tpu_torch.train --data_dir /data/jpegs -m vit_b_patch16 \\
        -c /tmp/ckpt -b 192 --data_workers 8

``-m`` takes a registry name or a ``model.json`` spec (its path, or a
directory holding it, such as ``import_checkpoint``'s output); with
``--finetune_from`` that directory, an imported checkpoint is fine-tuned
at ``-s`` (its pos-embed resampled) to ``--num_classes``. Runs on the card
unless ``--device cpu``. ``--data_dir`` names the source:
``synthetic``, ``synthetic_augmented``, an ``.npz`` file, an npz-shard
glob or directory, a ``.tar`` of ``<class>/<file>.jpg`` (or a directory of
them) or an ImageFolder tree of JPEGs, each with an optional
``?split=train[:90%]``. Real sources are augmented on the device
(``--augmentation``, unused on the synthetic source, as in the JAX
package); eval runs on ``--eval_data_dir`` or the last
``--holdout_fraction`` of the source, without augmentation. Flags of
features the port does not run yet are accepted at their defaults only;
any other value raises NotImplementedError naming the ROADMAP.md item.
"""

from __future__ import annotations

import argparse

from sav_tpu_torch.train.loop import IMAGENET_TRAIN_IMAGES, TrainConfig, Trainer


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--data_dir', required=True,
                   help="dataset: 'synthetic', 'synthetic_augmented', an "
                        '.npz file, an npz-shard glob or directory, a .tar '
                        'of <class>/<file>.jpg or a directory of them, or '
                        'an ImageFolder tree of JPEGs; optional '
                        '?split=train[:90%%]')
    p.add_argument('-s', '--img_size', type=int, default=224)
    p.add_argument('-e', '--num_epochs', type=int, default=300)
    p.add_argument('-b', '--batch_size', type=int, default=32)
    p.add_argument('--label_smoothing', type=float, default=0.1)
    p.add_argument('--augmentation', default='cutmix_mixup_randaugment_405')
    p.add_argument('-m', '--model_name', required=True)
    p.add_argument('-l', '--lr', type=float, default=5e-4)
    p.add_argument('--weight_decay', type=float, default=1e-4)
    p.add_argument('--clip_grad', type=float, default=None)
    p.add_argument('-c', '--checkpoint_dir', required=True)
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--dtype', default='bfloat16')
    p.add_argument('--model_parallelism', type=int, default=1)
    p.add_argument('--pipeline_parallelism', type=int, default=1)
    p.add_argument('--pipeline_microbatches', type=int, default=4)
    p.add_argument('--total_steps', type=int, default=None)
    p.add_argument('--scan_layers', dest='scan_layers', action='store_true',
                   default=False)
    p.add_argument('--no-scan_layers', dest='scan_layers',
                   action='store_false')
    p.add_argument('--remat', default='none',
                   choices=['none', 'full', 'dots', 'dots_no_batch'])
    p.add_argument('--mu_dtype', default=None)
    p.add_argument('--ema_decay', type=float, default=None)
    p.add_argument('--schedule', default='cosine', choices=['cosine', 'wsd'])
    p.add_argument('--pos_embed', default='learned',
                   choices=['learned', 'fixed', 'rotary', 'none'])
    p.add_argument('--quantized', default='none',
                   choices=['none', 'int8', 'ff', 'ff_sb'])
    p.add_argument('--grad_accum', type=int, default=1)
    p.add_argument('--steps_per_dispatch', type=int, default=1)
    p.add_argument('--prefetch_chunks', type=int, default=2)
    p.add_argument('--images_per_epoch', type=int, default=None)
    p.add_argument('--data_workers', type=int, default=0)
    p.add_argument('--eval_data_dir', default=None)
    p.add_argument('--holdout_fraction', type=float, default=0.05)
    p.add_argument('--eval_batches', type=int, default=None)
    p.add_argument('--eval_every_epochs', type=int, default=5)
    p.add_argument('--finetune_from', default=None)
    p.add_argument('--finetune_use_ema', dest='finetune_use_ema',
                   action='store_true', default=False)
    p.add_argument('--no-finetune_use_ema', dest='finetune_use_ema',
                   action='store_false')
    p.add_argument('--num_classes', type=int, default=None,
                   help='head width (default: a model.json spec\'s own, else '
                        '1000); with --finetune_from a new width re-initialises '
                        'the head')
    p.add_argument('--wandb', dest='use_wandb', action='store_true',
                   default=False)
    p.add_argument('--no-wandb', dest='use_wandb', action='store_false')
    p.add_argument('--device', default=None, help='cuda (default) or cpu')
    return p


def main(argv=None):
    a = _parser().parse_args(argv)
    if a.grad_accum < 1 or (a.images_per_epoch is not None
                            and a.images_per_epoch < 1):
        raise SystemExit('error: --grad_accum and --images_per_epoch must '
                         'be >= 1')
    config = TrainConfig(
        model_name=a.model_name, img_size=a.img_size,
        num_epochs=a.num_epochs, batch_size=a.batch_size,
        label_smoothing=a.label_smoothing, augmentation=a.augmentation,
        lr=a.lr, weight_decay=a.weight_decay, clip_grad=a.clip_grad,
        checkpoint_dir=a.checkpoint_dir, seed=a.seed, dtype=a.dtype,
        dataset=a.data_dir, model_parallelism=a.model_parallelism,
        pipeline_parallelism=a.pipeline_parallelism,
        pipeline_microbatches=a.pipeline_microbatches,
        total_steps=a.total_steps, scan_layers=a.scan_layers,
        remat=False if a.remat == 'none' else a.remat,
        mu_dtype=a.mu_dtype, ema_decay=a.ema_decay, schedule=a.schedule,
        pos_embed=a.pos_embed,
        quantized=False if a.quantized == 'none' else (
            True if a.quantized == 'int8' else a.quantized),
        grad_accum=a.grad_accum, steps_per_dispatch=a.steps_per_dispatch,
        prefetch_chunks=a.prefetch_chunks, data_workers=a.data_workers,
        eval_dataset=a.eval_data_dir, holdout_fraction=a.holdout_fraction,
        eval_batches=a.eval_batches, eval_every_epochs=a.eval_every_epochs,
        finetune_from=a.finetune_from, finetune_use_ema=a.finetune_use_ema,
        num_classes=a.num_classes,
        images_per_epoch=a.images_per_epoch or IMAGENET_TRAIN_IMAGES)
    metrics = Trainer(config, use_wandb=a.use_wandb, device=a.device).run()
    print(f'final metrics: {metrics}', flush=True)
    return metrics


if __name__ == '__main__':
    main()
