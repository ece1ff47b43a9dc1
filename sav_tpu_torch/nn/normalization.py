"""Normalization-adjacent blocks (counterpart of
``sav_tpu/nn/normalization.py``): CaiT's LayerScale."""

from __future__ import annotations

import torch
from torch import nn


class LayerScaleBlock(nn.Module):
    """Per-channel learned scale ``layerscale [D]``, filled with ``eps``."""

    def __init__(self, dim: int, eps: float, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.layerscale = nn.Parameter(torch.empty(dim))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.layerscale, self.eps)

    def forward(self, inputs):
        return inputs * self.layerscale.to(self.dtype)
