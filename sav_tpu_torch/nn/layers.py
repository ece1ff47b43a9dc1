"""Parameter-holding building blocks shared by the port's modules.

Counterparts of flax's ``nn.Dense``, ``nn.DenseGeneral`` kernels,
``nn.LayerNorm`` and ``nn.Conv`` with the flax parameter names
(``kernel``, ``bias``, ``scale``) and layouts (conv kernels HWIO on NHWC
images), so a flax tree loads as a state dict, and flax's ``max_pool`` and
``avg_pool``. Parameters stay float32 and are cast to the compute dtype at
use, as flax does. Convolutions and pooling are library ops, as XLA ran
them.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.ops.fused_layer import LN_EPS, _layernorm


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax ``variance_scaling(1.0, 'fan_in', 'truncated_normal')``: a
    normal truncated at +-2 std, std corrected for the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def he_uniform_(tensor: torch.Tensor, fan_in: int,
                generator: torch.Generator) -> None:
    """flax ``he_uniform()``, ``variance_scaling(2.0, 'fan_in',
    'uniform')``: U(-l, l) with l = sqrt(6 / fan_in)."""
    limit = math.sqrt(6.0 / fan_in)
    nn.init.uniform_(tensor, -limit, limit, generator=generator)


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


# 'SAME', 'VALID' or explicit ((lo, hi), (lo, hi))
Padding = Union[str, Sequence[Tuple[int, int]]]


def same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``'SAME'`` padding of one spatial axis: the output has
    ceil(size / stride) positions, the total pad max((out - 1) * stride +
    window - size, 0), its smaller half before. A 3 x 3 stride-2 window on
    an even size pads (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, window, strides, padding: Padding):
    """((top, bottom), (left, right)) of an NHWC ``x``."""
    if padding == 'SAME':
        return tuple(same_pads(x.shape[1 + i], window[i], strides[i])
                     for i in range(2))
    if padding == 'VALID':
        return ((0, 0), (0, 0))
    return tuple(tuple(p) for p in padding)


def _pad_nchw(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    (top, bottom), (left, right) = pads
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


CONV_INITS = {'he_uniform': he_uniform_, 'lecun_normal': lecun_normal_}


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC images: ``kernel [kh, kw, in / groups,
    out]`` and, with ``use_bias``, ``bias [out]`` (zero init), ``padding``
    'SAME' (flax's asymmetric rule, ``same_pads``) or explicit ((lo, hi),
    (lo, hi)). ``feature_group_count`` is flax's: the channels split into
    that many groups, each convolved with its own slice of the kernel
    (``in_features`` groups: a depthwise conv, CvT's projections). ``init``
    is the kernel's, over its fan-in kh * kw * in / groups:
    ``'he_uniform'`` (BoTNet's, the default) or ``'lecun_normal'`` (flax's
    own default, CeiT's and CvT's convs). An ungrouped 1 x 1 kernel is a
    matmul over the strided grid; any other runs ``F.conv2d`` on the NCHW
    view (channels-last in memory)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int] = (1, 1),
                 strides: Tuple[int, int] = (1, 1), padding: Padding = 'SAME',
                 dtype=torch.float32, use_bias: bool = False,
                 init: str = 'he_uniform', feature_group_count: int = 1):
        super().__init__()
        if init not in CONV_INITS:
            raise ValueError(f'init must be one of {sorted(CONV_INITS)}, got '
                             f'{init!r}')
        groups = feature_group_count
        if in_features % groups or features % groups:
            raise ValueError(f'{in_features} input and {features} output '
                             f'features are not divisible into {groups} '
                             'groups')
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.padding, self.dtype, self.init = padding, dtype, init
        self.groups = groups
        self.kernel = nn.Parameter(
            torch.empty(*kernel_size, in_features // groups, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def init_params(self, generator: torch.Generator) -> None:
        kh, kw, cin, _ = self.kernel.shape
        CONV_INITS[self.init](self.kernel, kh * kw * cin, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        x = x.to(self.dtype)
        w = self.kernel.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        pads = _pads(x, self.kernel_size, self.strides, self.padding)
        sh, sw = self.strides
        if (self.kernel_size == (1, 1) and pads == ((0, 0), (0, 0))
                and self.groups == 1):
            y = x[:, ::sh, ::sw] @ w[0, 0]
            return y if b is None else y + b
        y = F.conv2d(_pad_nchw(x.permute(0, 3, 1, 2), pads),
                     w.permute(3, 2, 0, 1), b, stride=self.strides,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, window: Tuple[int, int],
             strides: Tuple[int, int], padding: Padding):
    """flax ``nn.max_pool`` on NHWC (``padding`` 'VALID', flax's
    default, 'SAME' or explicit): padded positions are -inf, so they never
    win."""
    pads = _pads(x, window, strides, padding)
    y = F.max_pool2d(_pad_nchw(x.permute(0, 3, 1, 2), pads, -math.inf),
                     window, strides)
    return y.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, window: Tuple[int, int],
             strides: Tuple[int, int], padding: Padding):
    """flax ``nn.avg_pool`` on NHWC with its default
    ``count_include_pad=True``: padded zeros count in the window's mean."""
    pads = _pads(x, window, strides, padding)
    y = F.avg_pool2d(_pad_nchw(x.permute(0, 3, 1, 2), pads), window, strides)
    return y.permute(0, 2, 3, 1)
