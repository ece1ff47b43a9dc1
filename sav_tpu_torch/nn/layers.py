"""Parameter-holding building blocks shared by the port's modules.

Counterparts of flax's ``nn.Dense``, ``nn.DenseGeneral`` kernels and
``nn.LayerNorm`` with the flax parameter names (``kernel``, ``bias``,
``scale``) and layouts, so a flax tree loads as a state dict. Parameters
stay float32 and are cast to the compute dtype at use, as flax does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sav_tpu_torch.ops.fused_layer import LN_EPS, _layernorm


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax ``variance_scaling(1.0, 'fan_in', 'truncated_normal')``: a
    normal truncated at +-2 std, std corrected for the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def init_all(module: nn.Module, generator: torch.Generator) -> None:
    """Calls ``init_params(generator)`` on ``module`` and every submodule
    that defines it, in registration order (deterministic for a given
    generator state)."""
    for sub in module.modules():
        init = getattr(sub, 'init_params', None)
        if init is not None:
            init(generator)


class Dense(nn.Module):
    """``y = x @ kernel (+ bias)`` with ``kernel [in, out]``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=torch.float32, zero_init: bool = False):
        super().__init__()
        self.dtype = dtype
        self.zero_init = zero_init
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = (nn.Parameter(torch.empty(features)) if use_bias
                     else None)

    def init_params(self, generator: torch.Generator) -> None:
        if self.zero_init:
            nn.init.zeros_(self.kernel)
        else:
            lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics with the fast variance
    E[x^2] - mu^2, eps 1e-6, output in ``dtype``."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return _layernorm(x, self.scale, self.bias, LN_EPS)[0].to(self.dtype)
