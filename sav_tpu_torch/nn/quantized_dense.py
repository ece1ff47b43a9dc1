"""Dense layer with an int8 forward path (counterpart of
``sav_tpu/nn/quantized_dense.py``).

Parameter-compatible with ``nn.layers.Dense`` (the flax leaves ``kernel`` and
``bias``, the same initialisers), so quantization toggles on an existing
tree. ``fused=False`` (the default, ``--quantized int8``) runs the library
int8 path of ``ops.quantized``; ``fused=True`` runs the K15 port
(``ops.int8_matmul_kernel.int8_dense_fused``), reached only by direct use,
as in the JAX package; ``int8_core = 'plain'`` (``models.set_int8_core``)
runs it on K15's twin. Both backwards are straight-through.
"""

from __future__ import annotations

import torch

from sav_tpu_torch.nn.layers import Dense
from sav_tpu_torch.ops import quantized as quantized_ops
from sav_tpu_torch.ops.int8_matmul_kernel import int8_dense_fused


class QuantizedDense(Dense):
    """Drop-in ``Dense`` with an int8 forward when ``quantized``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=torch.float32, quantized: bool = True,
                 fused: bool = False):
        super().__init__(in_features, features, use_bias, dtype)
        self.quantized, self.fused = quantized, fused
        self.int8_core = 'kernel'

    def forward(self, x):
        if not self.quantized:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        if self.fused:
            return int8_dense_fused(x.to(self.dtype), self.kernel, bias,
                                    self.int8_core)
        return quantized_ops.quantized_dense(x.to(self.dtype),
                                             self.kernel.float(), bias)
