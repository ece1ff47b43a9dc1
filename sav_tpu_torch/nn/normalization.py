"""Normalization blocks: CaiT's LayerScale (counterpart of
``sav_tpu/nn/normalization.py``) and flax's ``nn.BatchNorm`` as the
BoTNet builds it (``sav_tpu/models/botnet.py:283-287``)."""

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


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis of ``[..., C]`` input
    (NHWC: statistics over N, H and W), not ``torch.nn.BatchNorm2d``:

    * parameters ``scale`` and ``bias``; the running statistics ``mean``
      and ``var`` (flax's ``batch_stats``) are buffers, initialised to 0
      and 1;
    * ``model.train()`` normalises by the batch's statistics and then
      updates the buffers, ``ra = momentum * ra + (1 - momentum) * batch``
      (flax's momentum weighs the old value; torch's is the other way
      round), with the biased batch variance, under ``no_grad``;
      ``model.eval()`` normalises by the buffers;
    * statistics are f32 reductions with the fast variance E[x^2] - E[x]^2
      clipped at 0; ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
      f32, cast to ``dtype``.

    ``zero_scale`` is flax's ``scale_init=zeros`` (the last BN of each
    BoTNet bottleneck)."""

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype=torch.float32,
                 zero_scale: bool = False):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.dtype, self.zero_scale = dtype, zero_scale
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.scale, 0.0 if self.zero_scale else 1.0)
        nn.init.zeros_(self.bias)
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x):
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=axes)
            var = torch.clamp_min(xf.square().mean(dim=axes) - mean.square(),
                                  0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)
