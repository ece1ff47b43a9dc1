"""Batched mixup / cutmix (counterpart of ``sav_tpu/data/mix.py``).

Per-example Beta-distributed mix weights, a permuted partner for mixup and
a box pasted from the reversed batch for cutmix, one Bernoulli per batch
picking the branch and one gating ``prob_to_apply``. Outputs use the
trainer's batch schema: ``labels`` stays integer, plus ``mix_labels``
(partner labels) and ``ratio`` (per-example weight of the original label).

``draw_mix`` makes the random parameters; the Beta weights come from a
numpy ``Generator`` seeded from the given ``torch.Generator`` (torch's
``Beta.sample`` draws from the global stream). ``mixup``, ``cutmix`` and
``mix_augment`` are deterministic.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sav_tpu_torch.data.image_ops import on_device, xla_mean


def _beta(generator: torch.Generator, alpha: float, batch: int):
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    rng = np.random.Generator(np.random.PCG64(seed))
    return torch.from_numpy(rng.beta(alpha, alpha, batch).astype(np.float32))


def draw_mixup(generator: torch.Generator, batch: int, alpha: float = 0.8):
    """``ratio [N]`` (the Beta weight folded to >= 0.5) and the partner
    permutation ``perm [N]``."""
    mix = _beta(generator, alpha, batch)
    return {'ratio': torch.maximum(mix, 1.0 - mix),
            'perm': torch.randperm(batch, generator=generator)}


def draw_cutmix(generator: torch.Generator, batch: int, height: int,
                width: int, alpha: float = 1.0):
    """``box [N, 4]`` int64 ``(y0, x0, box_h, box_w)``: the partner's area
    share ``min(b, 1 - b)`` of a Beta draw sets the side, the corner is
    uniform and pulled back inside the frame."""
    cut = _beta(generator, alpha, batch)
    cut = torch.minimum(cut, 1.0 - cut)
    side = torch.sqrt(cut)
    box_h = (side * height).to(torch.int64)
    box_w = (side * width).to(torch.int64)
    y0 = torch.randint(0, height, (batch,), generator=generator)
    x0 = torch.randint(0, width, (batch,), generator=generator)
    y0 = torch.minimum(y0, height - box_h)
    x0 = torch.minimum(x0, width - box_w)
    return {'box': torch.stack([y0, x0, box_h, box_w], dim=1)}


def mixup(images: torch.Tensor, labels: torch.Tensor, ratio, perm
          ) -> Dict[str, torch.Tensor]:
    """Per-example convex blend with the partner ``images[perm]``."""
    device = images.device
    ratio = on_device(ratio, device)
    perm = on_device(perm, device)
    mix = ratio.reshape(-1, 1, 1, 1)
    mixed = images * mix + images.index_select(0, perm) * (1.0 - mix)
    return {'images': mixed, 'labels': labels,
            'mix_labels': labels.index_select(0, perm), 'ratio': ratio}


def cutmix(images: torch.Tensor, labels: torch.Tensor, box
           ) -> Dict[str, torch.Tensor]:
    """Pastes each example's box from the reversed batch; ratio = the kept
    area fraction, recomputed from the mask."""
    n, height, width = images.shape[:3]
    device = images.device
    box = on_device(box, device)
    y0, x0, box_h, box_w = (box[:, i].reshape(-1, 1, 1) for i in range(4))
    yy = torch.arange(height, device=device).reshape(1, height, 1)
    xx = torch.arange(width, device=device).reshape(1, 1, width)
    in_box = ((yy >= y0) & (yy < y0 + box_h) &
              (xx >= x0) & (xx < x0 + box_w))
    mixed = torch.where(in_box[..., None], images.flip(0), images)
    ratio = 1.0 - xla_mean(in_box.to(torch.float32), (1, 2))
    return {'images': mixed, 'labels': labels,
            'mix_labels': labels.flip(0), 'ratio': ratio}


def draw_mix(generator: torch.Generator, batch: int, height: int, width: int,
             mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
             prob_to_apply: float = 1.0):
    """Everything ``mix_augment`` needs: ``use_first`` (mixup where both
    branches are on: one Bernoulli of 1/branches a batch), ``take`` (the
    ``prob_to_apply`` gate, one a batch) and each branch's draws."""
    branches = int(bool(mixup_alpha)) + int(bool(cutmix_alpha))
    use_first = bool(torch.rand(1, generator=generator)
                     < 1.0 / max(branches, 1))
    take = bool(torch.rand(1, generator=generator) < prob_to_apply)
    draws = {'use_first': use_first, 'take': take}
    if mixup_alpha:
        draws['mixup'] = draw_mixup(generator, batch, mixup_alpha)
    if cutmix_alpha:
        draws['cutmix'] = draw_cutmix(generator, batch, height, width,
                                      cutmix_alpha)
    return draws


def mix_augment(images: torch.Tensor, labels: torch.Tensor, draws,
                mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                prob_to_apply: float = 1.0) -> Dict[str, torch.Tensor]:
    """Applies mixup OR cutmix (the branch ``draws['use_first']`` picks),
    or neither where the ``prob_to_apply`` gate is closed (then ``ratio``
    is 1 and ``mix_labels`` the labels)."""
    branches = []
    if mixup_alpha:
        branches.append(lambda: mixup(images, labels, **draws['mixup']))
    if cutmix_alpha:
        branches.append(lambda: cutmix(images, labels, **draws['cutmix']))
    if not branches:
        return {'images': images, 'labels': labels}
    if prob_to_apply < 1.0 and not draws['take']:
        return {'images': images, 'labels': labels, 'mix_labels': labels,
                'ratio': torch.ones(labels.shape[0], device=images.device)}
    if len(branches) == 1 or draws['use_first']:
        return branches[0]()
    return branches[1]()
