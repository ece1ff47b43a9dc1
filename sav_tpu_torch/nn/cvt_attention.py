"""CvT's convolutional-projection attention (counterpart of
``sav_tpu/nn/cvt_attention.py``).

Queries, keys and values come from depthwise-conv + BatchNorm + pointwise
conv projections of the ``[B, H, W, C]`` token grid, k and v at stride 2
(a quarter of the keys); the attention core is the port's
``ops.attention.multi_head_attention``, so on the card ``use_kernel='auto'``
runs K4 forward and the K2/K3 backward at CvT's cross lengths (query grid
over the strided key grid). The module tree carries the flax names
(``ConvProjectionBlock_{0,1,2}.{Conv_0, BatchNorm_0, Conv_1}``,
``DenseGeneral_0``; with ``talking_heads`` ``TalkingHeadsBlock_{0,1}``) and
the BatchNorms' running statistics are buffers, so a flax
``{'params', 'batch_stats'}`` tree loads through ``utils.flax_bridge``.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from sav_tpu_torch.nn.attention import ProjectionParams, TalkingHeadsBlock
from sav_tpu_torch.nn.layers import Conv
from sav_tpu_torch.nn.normalization import BatchNorm
from sav_tpu_torch.ops import attention as attention_ops
from sav_tpu_torch.ops import flash_attention

# the per-op attention modes multi_head_attention takes
USE_KERNEL = (False, True, 'kernel', 'hybrid', 'auto')


def check_use_kernel(use_kernel) -> None:
    if use_kernel not in USE_KERNEL:
        raise NotImplementedError(
            f'use_kernel={use_kernel!r} is not a CvT mode (the port takes '
            f'{USE_KERNEL}; ROADMAP.md)')


class ConvProjectionBlock(nn.Module):
    """Depthwise k x k 'SAME' conv (no bias) -> BatchNorm -> 1 x 1 conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 strides: int = 1, use_bias: bool = True,
                 bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_ch, in_ch, (kernel_size,) * 2, (strides,) * 2,
                           dtype=dtype, init='lecun_normal',
                           feature_group_count=in_ch)
        self.BatchNorm_0 = BatchNorm(in_ch, bn_momentum, bn_epsilon, dtype)
        self.Conv_1 = Conv(in_ch, out_ch, dtype=dtype, use_bias=use_bias,
                           init='lecun_normal')

    def forward(self, inputs):
        return self.Conv_1(self.BatchNorm_0(self.Conv_0(inputs)))


class CvTAttentionBlock(nn.Module):
    """Multi-head attention from a ``[B, H, W, C]`` query grid to a key/value
    grid, with conv projections at ``strides`` (q, k, v) and the merged
    output projection ``DenseGeneral_0`` ``kernel [heads, C / heads, C]``
    (the JAX block's ``head_ch`` and ``out_ch`` at their defaults, which
    every CvT config keeps).

    On the card under ``use_kernel='auto'`` the core is K4 + K2/K3 where
    ``flash_attention.shape_supported`` takes the shape; any other shape
    raises (``use_kernel=False`` runs it per-op). Talking heads mix the
    logits across heads, which no flash kernel does: with them every mode
    but ``True``, ``'kernel'`` and ``'hybrid'`` (which raise) runs per-op.
    ``core`` ('kernel' or 'plain', ``models.cvt.set_attention_core``) puts
    the flash route on its twins at the same autograd boundary (the card's
    gradient reference); it is not a ``use_kernel`` mode. Dropout and the
    biases are not ported (no CvT config sets them): a non-zero rate or
    ``use_bias=True`` raises."""

    def __init__(self, in_ch: int, num_heads: int,
                 talking_heads: bool = False, attn_dropout_rate: float = 0.0,
                 out_dropout_rate: float = 0.0, kernel_size: int = 3,
                 strides: Tuple[int, int, int] = (1, 2, 2),
                 use_bias: bool = False, bn_momentum: float = 0.9,
                 bn_epsilon: float = 1e-5, dtype=torch.float32,
                 use_kernel: Union[str, bool] = 'auto'):
        super().__init__()
        if attn_dropout_rate or out_dropout_rate:
            raise NotImplementedError(
                'attn_dropout_rate/out_dropout_rate are not ported yet (no '
                'CvT config sets them; ROADMAP.md Queue 1 item 2)')
        if use_bias:
            raise NotImplementedError(
                'CvT attention biases (the projections\' and DenseGeneral_0\'s) '
                'are not ported yet (no CvT config sets them; ROADMAP.md '
                'Queue 1 item 4)')
        if in_ch % num_heads:
            raise ValueError(f'in_ch {in_ch} is not divisible by {num_heads} '
                             'heads')
        check_use_kernel(use_kernel)
        self.num_heads, self.strides = num_heads, tuple(strides)
        self.dtype, self.use_kernel = dtype, use_kernel
        self.core = 'kernel'
        for i, stride in enumerate(self.strides):
            self.add_module(f'ConvProjectionBlock_{i}', ConvProjectionBlock(
                in_ch, in_ch, kernel_size, stride, False, bn_momentum,
                bn_epsilon, dtype))
        self.talking_heads = talking_heads
        if talking_heads:
            self.TalkingHeadsBlock_0 = TalkingHeadsBlock(num_heads)
            self.TalkingHeadsBlock_1 = TalkingHeadsBlock(num_heads)
        self.DenseGeneral_0 = ProjectionParams(
            (num_heads, in_ch // num_heads, in_ch), in_ch)

    def _split(self, grid):
        """``b H W (h d) -> b (H W) h d``."""
        b, gh, gw, c = grid.shape
        return grid.reshape(b, gh * gw, self.num_heads, c // self.num_heads)

    def forward(self, inputs_q, inputs_kv):
        query = self._split(self.ConvProjectionBlock_0(inputs_q))
        key = self._split(self.ConvProjectionBlock_1(inputs_kv))
        value = self._split(self.ConvProjectionBlock_2(inputs_kv))
        pre = post = None
        if self.talking_heads:
            pre = self.TalkingHeadsBlock_0.talking_heads_transform
            post = self.TalkingHeadsBlock_1.talking_heads_transform
        elif (self.use_kernel == 'auto' and query.device.type == 'cuda'
              and not flash_attention.shape_supported(query, key)):
            raise NotImplementedError(
                f'no attention kernel of the port takes {query.shape[1]} '
                f'queries over {key.shape[1]} keys, {self.num_heads} heads of '
                f'{query.shape[-1]} (K4 needs d = 64 and at least 64 query '
                'rows); use_kernel=False runs the per-op path')
        x = attention_ops.multi_head_attention(
            query, key, value, pre_softmax_transform=pre,
            post_softmax_transform=post, use_kernel=self.use_kernel,
            core=self.core)
        # the f32 mixes promote x to f32 (as in flax); the projection runs
        # in the module's dtype
        return torch.einsum('...hc,hco->...o', x.to(self.dtype),
                            self.DenseGeneral_0.kernel.to(self.dtype))


class CvTSelfAttentionBlock(CvTAttentionBlock):
    """Self-attention variant: queries, keys and values from one grid."""

    def forward(self, inputs):
        return super().forward(inputs, inputs)
