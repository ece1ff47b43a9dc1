"""Tokenization stems (counterpart of ``sav_tpu/nn/stems.py``): the linear
patch embedding, a patchify rearrange + Dense, not a conv, so the kernel
keeps the checkpoint layout ``[ph*pw*C, embed_dim]``; and CeiT's
Image2Token stem (conv, BatchNorm, max-pool, then the same patchify +
Dense)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from sav_tpu_torch.nn.layers import Conv, Dense, max_pool
from sav_tpu_torch.nn.normalization import BatchNorm


def patchify(images: torch.Tensor, patch_shape: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] -> [B, num_patches, ph*pw*C] (row-major patch order)."""
    ph, pw = patch_shape
    b, h, w, c = images.shape
    x = images.reshape(b, h // ph, ph, w // pw, pw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // ph) * (w // pw), ph * pw * c)


class PatchEmbedBlock(nn.Module):
    """Non-overlapping patch extraction followed by a linear embedding."""

    def __init__(self, patch_shape: Tuple[int, int], embed_dim: int,
                 in_ch: int = 3, use_bias: bool = False, dtype=torch.float32):
        super().__init__()
        self.patch_shape = tuple(patch_shape)
        self.Dense_0 = Dense(patch_shape[0] * patch_shape[1] * in_ch,
                             embed_dim, use_bias=use_bias, dtype=dtype)

    def forward(self, inputs):
        return self.Dense_0(patchify(inputs, self.patch_shape))


class Image2TokenBlock(nn.Module):
    """CeiT's I2T stem: a ``conv_kernel_size`` conv of stride
    ``conv_stride`` (no bias, flax's lecun-normal init, padded by the patch
    shape on each side as the reference pads), BatchNorm, a
    ``pool_window_size`` max-pool of stride ``pool_stride`` with flax's
    default ``'VALID'`` padding, then patchify + Dense (no bias). At 224 px
    with CeiT's (7, 2, 3, 2, 4 x 4): 113 x 113 x 32, 56 x 56, 196 tokens."""

    def __init__(self, patch_shape: Tuple[int, int], num_ch: int,
                 conv_kernel_size: int, conv_stride: int,
                 pool_window_size: int, pool_stride: int, embed_dim: int,
                 in_ch: int = 3, use_bias: bool = False,
                 bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        ph, pw = patch_shape
        self.patch_shape = (ph, pw)
        self.pool = ((pool_window_size,) * 2, (pool_stride,) * 2)
        self.Conv_0 = Conv(in_ch, num_ch, (conv_kernel_size,) * 2,
                           (conv_stride,) * 2, padding=((ph, ph), (pw, pw)),
                           dtype=dtype, use_bias=use_bias,
                           init='lecun_normal')
        self.BatchNorm_0 = BatchNorm(num_ch, bn_momentum, bn_epsilon, dtype)
        self.Dense_0 = Dense(ph * pw * num_ch, embed_dim, use_bias=use_bias,
                             dtype=dtype)

    def forward(self, inputs):
        x = self.BatchNorm_0(self.Conv_0(inputs))
        x = max_pool(x, *self.pool, 'VALID')
        return self.Dense_0(patchify(x, self.patch_shape))
