"""Deterministic synthetic data source (counterpart of
``sav_tpu/data/synthetic.py``).

Batches are made on the device from a ``torch.Generator`` seeded with the
dataset seed and the step, so the stream is reproducible and costs no
host-to-device copy. The numbers differ from the JAX package's (another
generator); the shapes, dtypes and ranges are the same.
"""

from __future__ import annotations

import torch


class SyntheticDataset:
    """``batch(step)``: the step's ``{'images': [B, S, S, 3] f32 uniform in
    [0, 1), 'labels': [B] int64 in [0, num_classes)}`` on ``device``."""

    def __init__(self, batch_size: int, image_size: int,
                 num_classes: int = 1000, seed: int = 0, device='cpu'):
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed
        self.device = torch.device(device)

    def batch(self, step: int):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((self.seed & 0x7fffffff) << 32) | (step & 0xffffffff))
        size = self.image_size
        images = torch.rand((self.batch_size, size, size, 3), generator=gen,
                            device=self.device)
        labels = torch.randint(0, self.num_classes, (self.batch_size,),
                               generator=gen, device=self.device)
        return {'images': images, 'labels': labels}
