"""Transformer MLP (counterpart of ``FFBlock`` in
``sav_tpu/nn/feedforward.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.nn.layers import Dense


class FFBlock(nn.Module):
    """Dense -> gelu -> Dense. gelu is the tanh approximation, flax's
    default (``F.gelu``'s default is the erf form)."""

    def __init__(self, in_ch: int, expand_ratio: float = 4,
                 dtype=torch.float32):
        super().__init__()
        hidden = max(1, int(expand_ratio * in_ch))
        self.Dense_0 = Dense(in_ch, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, in_ch, dtype=dtype)

    def forward(self, inputs):
        return self.Dense_1(F.gelu(self.Dense_0(inputs), approximate='tanh'))
