"""Minimal hard-coded training entry point of the torch port (counterpart
of ``simple_train.py``).

A short ViT-S/16 @224 training on the synthetic source with no other
arguments: on the card bf16, batch 256, 50 steps; with ``--device cpu``
f32, batch 8, 3 steps, the CPU-runnable end-to-end smoke run. One step a
dispatch (chained dispatch is not ported: ROADMAP.md Queue 1).

    python -m sav_tpu_torch.simple_train [--device cpu]
"""

from __future__ import annotations

import argparse

from sav_tpu_torch import resolve_device
from sav_tpu_torch.train.loop import TrainConfig, Trainer


def config_for(on_card: bool) -> TrainConfig:
    """The run's configuration on the card or on the CPU."""
    return TrainConfig(
        model_name='vit_s_patch16',
        img_size=224,
        batch_size=256 if on_card else 8,
        total_steps=50 if on_card else 3,
        dtype='bfloat16' if on_card else 'float32',
        label_smoothing=0.1,
        lr=3e-3,
        weight_decay=1e-4,
        clip_grad=1.0,
        log_every=1,
        eval_every_epochs=10**6,        # skip eval in the smoke loop
        checkpoint_every_epochs=10**6,
        seed=42,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    metrics = Trainer(config_for(device.type == 'cuda'), device=device).run()
    print('final metrics:', metrics, flush=True)
    return metrics


if __name__ == '__main__':
    main()
