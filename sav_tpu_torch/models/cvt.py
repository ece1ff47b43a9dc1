"""CvT: Convolutional vision Transformer (counterpart of
``sav_tpu/models/cvt.py``).

A three-stage pyramid: each stage embeds its input grid by a strided
'SAME' conv + LayerNorm (``ConvTokenEmbedBlock``) and runs blocks of
convolutional-projection attention (``nn.cvt_attention``) + FF, with the
residuals over the token sequence; the cls token exists only in the last
stage, whose ``side * side + 1`` tokens every block zero-pads to the next
square grid (197 -> 15 x 15 = 225 @224), so the residual stream carries
the padded tokens from the first block on and the BatchNorms' training
statistics count them. The zero-initialised head reads token 0. The module
tree carries the flax names and the BatchNorms' running statistics are
buffers, so a flax ``{'params', 'batch_stats'}`` tree loads through
``utils.flax_bridge``.

``use_kernel`` is the per-op attention's (``nn.cvt_attention.USE_KERNEL``):
on the card ``'auto'`` runs every block's attention on K4 forward and the
K2/K3 backward (``flash_attention.flash_bwd`` routes by length: at @224
every CvT-13 stage is past K2's 208 rows, so K3a + K3b) and raises where
K4 does not take the shape; off the card it is the per-op path, as the
JAX package off the TPU. ``quantized='ff'`` (and ``'all'``, which
quantizes nothing more in CvT) runs each FF sublayer of a stage at least
256 wide as one int8 span on K13 (``ops.int8_ff.int8_ff_sublayer``), as
the JAX model routes it; other values raise, as there.
``set_attention_core`` puts the flash route on its twins at the same
autograd boundary (the card's gradient reference). ``scan_layers`` (the
scan-stacked layout) is not ported.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.nn.cvt_attention import (CvTAttentionBlock,
                                            CvTSelfAttentionBlock,
                                            check_use_kernel)
from sav_tpu_torch.nn.feedforward import FFBlock
from sav_tpu_torch.nn.layers import Conv, Dense, LayerNorm
from sav_tpu_torch.ops import flash_attention, fused_layer, int8_ff

QUANTIZED = (False, 'ff', 'all')
# the narrowest stage whose FF runs int8 under quantized='ff'/'all'
# (sav_tpu/models/cvt.py's rule, measured on the JAX side)
INT8_FF_MIN_DIM = 256


def zero_pad_and_reshape(inputs: torch.Tensor) -> torch.Tensor:
    """``[B, L, C]`` -> ``[B, side, side, C]``, zero-padding the sequence
    to the next square (the last stage's cls token makes L one past one)."""
    b, length, c = inputs.shape
    side = math.isqrt(length)
    if side * side != length:
        side += 1
        inputs = F.pad(inputs, (0, 0, 0, side * side - length))
    return inputs.reshape(b, side, side, c)


class ConvTokenEmbedBlock(nn.Module):
    """Strided 'SAME' conv (with bias) + flatten + LayerNorm."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 strides: int, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_ch, out_ch, (kernel_size,) * 2, (strides,) * 2,
                           dtype=dtype, use_bias=True, init='lecun_normal')
        self.LayerNorm_0 = LayerNorm(out_ch, dtype)

    def forward(self, inputs):
        x = self.Conv_0(inputs)
        return self.LayerNorm_0(x.reshape(x.shape[0], -1, x.shape[-1]))


class StageBlock(nn.Module):
    """Conv-projection self-attention + FF over the zero-padded grid, with
    the residuals over the (padded) token sequence. With ``quantized``
    'ff'/'all' at a width of at least ``INT8_FF_MIN_DIM`` the FF sublayer
    (LayerNorm_0 -> FFBlock_0 -> + x) is one int8 span on K13 over the same
    parameters; ``int8_core`` ('kernel' or 'plain', ``models.
    set_int8_core``) picks the kernel or its twin."""

    def __init__(self, num_heads: int, embed_dim: int, kernel_size: int = 3,
                 use_bias: bool = False, bn_momentum: float = 0.9,
                 bn_epsilon: float = 1e-5, expand_ratio: float = 4,
                 dtype=torch.float32, use_kernel: Union[str, bool] = 'auto',
                 quantized: Union[bool, str] = False):
        super().__init__()
        self.dtype = dtype
        self.quantize_ff = (quantized in ('ff', 'all')
                            and embed_dim >= INT8_FF_MIN_DIM)
        self.int8_core = 'kernel'
        self.CvTSelfAttentionBlock_0 = CvTSelfAttentionBlock(
            embed_dim, num_heads, kernel_size=kernel_size, use_bias=use_bias,
            bn_momentum=bn_momentum, bn_epsilon=bn_epsilon, dtype=dtype,
            use_kernel=use_kernel)
        self.LayerNorm_0 = LayerNorm(embed_dim, dtype)
        self.FFBlock_0 = FFBlock(embed_dim, expand_ratio, dtype)

    def forward(self, inputs):
        grid = zero_pad_and_reshape(inputs)
        x = self.CvTSelfAttentionBlock_0(grid) + grid.reshape(
            grid.shape[0], -1, grid.shape[-1])
        if self.quantize_ff:
            ln, ff = self.LayerNorm_0, self.FFBlock_0
            return int8_ff.int8_ff_sublayer(
                x.to(self.dtype), ln.scale, ln.bias, ff.Dense_0.kernel,
                ff.Dense_0.bias, ff.Dense_1.kernel, ff.Dense_1.bias,
                fused_layer.LN_EPS, self.int8_core)
        return x + self.FFBlock_0(self.LayerNorm_0(x))


class Stage(nn.Module):
    """Conv token embedding, the cls token in front where ``insert_cls``,
    then ``size`` stage blocks."""

    def __init__(self, in_ch: int, size: int, num_heads: int, embed_dim: int,
                 embed_kernel_size: int, embed_strides: int,
                 insert_cls: bool = False, dtype=torch.float32, **block):
        super().__init__()
        self.size, self.insert_cls = size, insert_cls
        self.ConvTokenEmbedBlock_0 = ConvTokenEmbedBlock(
            in_ch, embed_dim, embed_kernel_size, embed_strides, dtype)
        if insert_cls:
            self.cls = nn.Parameter(torch.empty(1, 1, embed_dim))
        for i in range(size):
            self.add_module(f'StageBlock_{i}', StageBlock(
                num_heads, embed_dim, dtype=dtype, **block))

    def init_params(self, generator: torch.Generator) -> None:
        if self.insert_cls:
            nn.init.zeros_(self.cls)

    def forward(self, inputs):
        x = self.ConvTokenEmbedBlock_0(inputs)
        if self.insert_cls:
            # the f32 cls token promotes the stream to f32, as in flax
            x = torch.cat([self.cls.expand(x.shape[0], -1, -1), x], dim=1)
        for i in range(self.size):
            x = getattr(self, f'StageBlock_{i}')(x)
        return x


class CvT(nn.Module):
    """CvT classifier over NHWC images of ``img_size``."""

    def __init__(self, num_classes: int, stage_sizes: Tuple[int, ...],
                 num_heads: Tuple[int, ...], embed_dim: Tuple[int, ...],
                 embed_kernel_size: Tuple[int, ...] = (7, 3, 3),
                 embed_strides: Tuple[int, ...] = (4, 2, 2),
                 sa_kernel_size: Tuple[int, ...] = (3, 3, 3),
                 use_bias: bool = False, expand_ratio: float = 4,
                 bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                 img_size: int = 224, dtype=torch.float32,
                 use_kernel: Union[str, bool] = 'auto',
                 scan_layers: bool = False,
                 quantized: Union[bool, str] = False):
        super().__init__()
        if scan_layers:
            raise NotImplementedError(
                'scan_layers=True is not ported yet (the scan-stacked layout: '
                'ROADMAP.md Queue 1 item 1)')
        if quantized not in QUANTIZED:
            raise ValueError(
                f'CvT quantized={quantized!r} is not supported: only '
                "'ff'/'all' (the int8 FF sublayer on stages at least "
                f'{INT8_FF_MIN_DIM} wide), as in the JAX package')
        check_use_kernel(use_kernel)
        self.dtype, self.img_size = dtype, img_size
        self.num_stages = len(stage_sizes)
        in_ch = 3
        for i in range(self.num_stages):
            self.add_module(f'Stage_{i}', Stage(
                in_ch, stage_sizes[i], num_heads[i], embed_dim[i],
                embed_kernel_size[i], embed_strides[i],
                insert_cls=i == self.num_stages - 1, dtype=dtype,
                kernel_size=sa_kernel_size[i], use_bias=use_bias,
                bn_momentum=bn_momentum, bn_epsilon=bn_epsilon,
                expand_ratio=expand_ratio, use_kernel=use_kernel,
                quantized=quantized))
            in_ch = embed_dim[i]
        self.Dense_0 = Dense(embed_dim[-1], num_classes, dtype=dtype,
                             zero_init=True)

    def forward(self, inputs):
        x = inputs
        for i in range(self.num_stages):
            x = getattr(self, f'Stage_{i}')(x)
            if i < self.num_stages - 1:
                side = math.isqrt(x.shape[1])
                x = x.reshape(x.shape[0], side, side, x.shape[-1])
        return self.Dense_0(x[:, 0])


def set_use_kernel(model: nn.Module, use_kernel: Union[str, bool]) -> None:
    """Re-routes every attention block of a built CvT (same weights)."""
    check_use_kernel(use_kernel)
    for sub in model.modules():
        if isinstance(sub, CvTAttentionBlock):
            sub.use_kernel = use_kernel


def set_attention_core(model: nn.Module, core: str) -> None:
    """``'kernel'`` or ``'plain'``: what the flash route of every attention
    block runs, K4 and K2/K3 or their twins at the same autograd boundary
    (the reference of the card's gradient check)."""
    if core not in flash_attention.CORES:
        raise ValueError(f'core must be one of {flash_attention.CORES}, got '
                         f'{core!r}')
    for sub in model.modules():
        if isinstance(sub, CvTAttentionBlock):
            sub.core = core
