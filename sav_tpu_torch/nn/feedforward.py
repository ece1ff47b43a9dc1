"""Feed-forward blocks (counterpart of ``sav_tpu/nn/feedforward.py``): the
transformer MLP and CeiT's locally-enhanced FF."""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.nn.layers import Conv, Dense
from sav_tpu_torch.nn.normalization import BatchNorm
from sav_tpu_torch.nn.quantized_dense import QuantizedDense
from sav_tpu_torch.ops import int8_ff

QUANTIZED = (False, True, 'ff', 'ff_sb')


def _hidden_width(in_ch: int, expand_ratio: Optional[float],
                  hidden_ch: Optional[int]) -> int:
    if expand_ratio is None:
        if hidden_ch is None:
            raise ValueError('Must provide one of expand_ratio or hidden_ch')
        return hidden_ch
    return max(1, int(expand_ratio * in_ch))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's default gelu, the tanh approximation (``F.gelu``'s default is
    the erf form)."""
    return F.gelu(x, approximate='tanh')


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The erf gelu (flax's ``gelu(approximate=False)``; HF's and timm's
    ``gelu``)."""
    return F.gelu(x, approximate='none')


# the activations a model spec names (sav_tpu/models/factory.py's table);
# 'gelu' is every factory config's, and the only one the FF kernels (K12,
# K13, K14, K16) compute
ACTIVATIONS = {'gelu': gelu, 'gelu_exact': gelu_exact, 'relu': F.relu}


def check_activation(name: str) -> None:
    if name not in ACTIVATIONS:
        raise ValueError(f'unknown activation {name!r}; known: '
                         f'{", ".join(sorted(ACTIVATIONS))}')


class FFBlock(nn.Module):
    """Dense -> activation -> Dense. ``activation_fn`` names an entry of
    ``ACTIVATIONS``: 'gelu' (the default) is the tanh approximation,
    flax's default (``F.gelu``'s default is the erf form), 'gelu_exact'
    the erf form, 'relu'.

    ``quantized=True`` runs both products through the library int8 path
    (``QuantizedDense``); ``quantized='ff'`` runs the whole block as one
    int8 kernel (K12, ``ops.int8_ff.int8_ff``) on W1 and W2 cast to
    ``dtype``; ``'ff_sb'`` is the same forward with the SwitchBack
    backward (both dx products int8 on K14); the kernels compute the tanh
    gelu, so both raise on another activation, as the JAX block does. The
    parameters are ``Dense_0``/``Dense_1`` on every route. ``int8_core``
    ('kernel' or 'plain', ``models.set_int8_core``) picks the kernels or
    their twins."""

    def __init__(self, in_ch: int, expand_ratio: float = 4,
                 dtype=torch.float32, quantized: Union[bool, str] = False,
                 activation_fn: str = 'gelu'):
        super().__init__()
        if quantized not in QUANTIZED:
            raise ValueError(f'FFBlock quantized must be one of {QUANTIZED}, '
                             f'got {quantized!r}')
        check_activation(activation_fn)
        if quantized in ('ff', 'ff_sb') and activation_fn != 'gelu':
            raise ValueError(f"quantized={quantized!r} hardcodes the tanh "
                             f"gelu between the GEMMs, not {activation_fn!r}")
        hidden = _hidden_width(in_ch, expand_ratio, None)
        self.dtype, self.quantized = dtype, quantized
        self.activation_fn = activation_fn
        self.int8_core = 'kernel'
        dense = QuantizedDense if quantized is True else Dense
        self.Dense_0 = dense(in_ch, hidden, dtype=dtype)
        self.Dense_1 = dense(hidden, in_ch, dtype=dtype)

    def forward(self, inputs):
        if self.quantized in ('ff', 'ff_sb'):
            d0, d1 = self.Dense_0, self.Dense_1
            return int8_ff.int8_ff(inputs.to(self.dtype),
                                   d0.kernel.to(self.dtype), d0.bias,
                                   d1.kernel.to(self.dtype), d1.bias,
                                   switchback=self.quantized == 'ff_sb',
                                   core=self.int8_core)
        return self.Dense_1(ACTIVATIONS[self.activation_fn](
            self.Dense_0(inputs)))


class LeFFBlock(nn.Module):
    """CeiT's locally-enhanced FF: the cls token (row 0) passes through; the
    patch tokens go Dense (to the hidden width) -> BatchNorm -> gelu, fold
    onto their square grid for a full (not depthwise) ``kernel_size``
    'SAME' conv with bias -> BatchNorm -> gelu, unfold, Dense back ->
    BatchNorm -> gelu. Each BatchNorm reduces over every axis but the
    channels (B and L of the tokens, B, H and W of the grid), as flax's.
    The conv is a library call, as XLA ran it (no TPU kernel computes it).
    """

    def __init__(self, in_ch: int, expand_ratio: Optional[float] = None,
                 hidden_ch: Optional[int] = None, kernel_size: int = 5,
                 bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        hidden = _hidden_width(in_ch, expand_ratio, hidden_ch)
        norm = lambda width: BatchNorm(width, bn_momentum, bn_epsilon, dtype)
        self.Dense_0 = Dense(in_ch, hidden, dtype=dtype)
        self.BatchNorm_0 = norm(hidden)
        self.Conv_0 = Conv(hidden, hidden, (kernel_size, kernel_size),
                           dtype=dtype, use_bias=True, init='lecun_normal')
        self.BatchNorm_1 = norm(hidden)
        self.Dense_1 = Dense(hidden, in_ch, dtype=dtype)
        self.BatchNorm_2 = norm(in_ch)

    def forward(self, inputs):
        cls_token, tokens = inputs[:, :1], inputs[:, 1:]
        b, n, _ = tokens.shape
        side = int(n ** 0.5)
        x = gelu(self.BatchNorm_0(self.Dense_0(tokens)))
        x = x.reshape(b, side, side, -1)
        x = gelu(self.BatchNorm_1(self.Conv_0(x)))
        x = gelu(self.BatchNorm_2(self.Dense_1(x.reshape(b, n, -1))))
        return torch.cat([cls_token, x], dim=1)
