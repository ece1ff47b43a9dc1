"""Stochastic depth (counterpart of ``sav_tpu/nn/regularization.py``).

The JAX block draws its per-sample mask from the ``'stochastic_depth'``
stream of the step key. Here the caller hands the module a
``torch.Generator`` on the activations' device (``train.steps`` sets it
for each microbatch); the draws are torch's, so they cannot match
``jax.random.bernoulli``, and the parity tests inject the mask instead.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def drop_path(inputs: torch.Tensor, drop_rate: float, mask: torch.Tensor,
              scale_by_keep: bool = True) -> torch.Tensor:
    """``inputs / keep * mask`` with a per-sample 0/1 ``mask [B]`` (the JAX
    formula; without ``scale_by_keep`` no division)."""
    keep = 1.0 - drop_rate
    x = inputs / keep if scale_by_keep else inputs
    return x * mask.to(x.dtype).reshape((-1,) + (1,) * (inputs.ndim - 1))


class StochasticDepthBlock(nn.Module):
    """Drops the whole residual branch per sample with probability
    ``drop_rate`` in training, scaled by 1/keep; the identity in eval or at
    rate 0. ``generator`` (set by the train step, on the device) is where
    the draws come from; training at a non-zero rate without one raises,
    so no draw comes from torch's global stream unasked."""

    def __init__(self, drop_rate: float, scale_by_keep: bool = True):
        super().__init__()
        self.drop_rate, self.scale_by_keep = drop_rate, scale_by_keep
        self.generator: Optional[torch.Generator] = None

    def forward(self, inputs):
        if not self.training or self.drop_rate == 0.0:
            return inputs
        if self.generator is None:
            raise RuntimeError(
                'StochasticDepthBlock in training needs a torch.Generator: '
                'pass one to train_step (or set_stochastic_depth_generator)')
        keep = 1.0 - self.drop_rate
        u = torch.rand(inputs.shape[0], device=inputs.device,
                       generator=self.generator)
        return drop_path(inputs, self.drop_rate, u < keep, self.scale_by_keep)


def set_stochastic_depth_generator(model: nn.Module,
                                   generator: Optional[torch.Generator]) -> None:
    """Points every StochasticDepthBlock of ``model`` at ``generator``."""
    for sub in model.modules():
        if isinstance(sub, StochasticDepthBlock):
            sub.generator = generator
