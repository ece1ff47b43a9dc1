"""Squeeze-and-excite gating block (counterpart of
``sav_tpu/nn/squeeze_excite.py``), with the flax names ``Dense_0`` and
``Dense_1``."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from sav_tpu_torch.nn.layers import Dense


class SqueezeExciteBlock(nn.Module):
    """Global mean over (H, W) of NHWC input (f32 sum, in ``dtype``, as
    ``jnp.mean(..., dtype=dtype)``) -> ``Dense_0`` to ``max(1, int(C *
    se_ratio))`` -> ``activation_fn`` -> ``Dense_1`` back to C -> the
    input gated by the sigmoid."""

    def __init__(self, channels: int, se_ratio: float,
                 activation_fn: Callable, dtype=torch.float32):
        super().__init__()
        self.activation_fn, self.dtype = activation_fn, dtype
        hidden = max(1, int(channels * se_ratio))
        self.Dense_0 = Dense(channels, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, channels, dtype=dtype)

    def forward(self, inputs):
        pooled = inputs.float().mean(dim=(1, 2), keepdim=True).to(self.dtype)
        gate = self.Dense_1(self.activation_fn(self.Dense_0(pooled)))
        return inputs * torch.sigmoid(gate)
