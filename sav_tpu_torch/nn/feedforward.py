"""Transformer MLP (counterpart of ``FFBlock`` in
``sav_tpu/nn/feedforward.py``)."""

from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.nn.layers import Dense
from sav_tpu_torch.nn.quantized_dense import QuantizedDense
from sav_tpu_torch.ops import int8_ff

QUANTIZED = (False, True, 'ff', 'ff_sb')


class FFBlock(nn.Module):
    """Dense -> gelu -> Dense. gelu is the tanh approximation, flax's
    default (``F.gelu``'s default is the erf form).

    ``quantized=True`` runs both products through the library int8 path
    (``QuantizedDense``); ``quantized='ff'`` runs the whole block as one
    int8 kernel (K12, ``ops.int8_ff.int8_ff``) on W1 and W2 cast to
    ``dtype``; ``'ff_sb'`` is the same forward with the SwitchBack
    backward (both dx products int8 on K14). The parameters are
    ``Dense_0``/``Dense_1`` on every route. ``int8_core`` ('kernel' or
    'plain', ``models.set_int8_core``) picks the kernels or their twins."""

    def __init__(self, in_ch: int, expand_ratio: float = 4,
                 dtype=torch.float32, quantized: Union[bool, str] = False):
        super().__init__()
        if quantized not in QUANTIZED:
            raise ValueError(f'FFBlock quantized must be one of {QUANTIZED}, '
                             f'got {quantized!r}')
        hidden = max(1, int(expand_ratio * in_ch))
        self.dtype, self.quantized = dtype, quantized
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
        return self.Dense_1(F.gelu(self.Dense_0(inputs), approximate='tanh'))
