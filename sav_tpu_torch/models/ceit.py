"""CeiT: Convolution-enhanced image Transformer (counterpart of
``sav_tpu/models/ceit.py``).

The Image2Token stem (conv, BatchNorm, max-pool, patchify + Dense), a cls
token, post-LN encoder blocks (self-attention -> residual -> LN, LeFF ->
residual -> LN) that collect the cls token after every layer, and one
layer-wise class attention (LCA) over the stack of per-layer cls tokens,
its last row into a zero-init head. The module tree carries the flax names
and the BatchNorms' running statistics are buffers, so a flax
``{'params', 'batch_stats'}`` tree loads through ``utils.flax_bridge``.

``use_kernel`` takes the JAX package's values:
  * ``'fused_layer'``, ``'fused_layer_xla'``, ``'fused_layer_full'``: each
    block's attention sublayer as one ``ops.fused_layer.
    attention_sublayer_noln`` call on the K4 core, the plain core or the K1
    port's post-LN route (which falls back to the K4 core where K1's GEMMs
    do not take the width, as the JAX package falls back where
    ``fused_supported`` fails);
  * ``'auto'``: on the card the core ``fused_layer.auto_core`` picks, as
    ViT's ``auto`` does (K1's post-LN route at every CeiT config; a shape
    no kernel takes raises, and ``use_kernel=False`` runs it per-op); off
    the card the per-op path, as the JAX package off the TPU. CeiT-S @224
    on an H100 (80GB HBM3, 700 W), ``'auto'`` (K1 post-LN + K2) against
    ``'kernel'`` (per-op: library projections, K4, K2), in turns in one
    call of ``scripts/torch_train_ab.py`` with ``--profile``: serving bs32
    16.29-16.33 against 16.51-16.59 device ms a batch (1306-1676 against
    926-1441 img/s, host-bound), training bs64 538.2-539.5 against
    504.8-538.8 img/s (118.6-118.9 against 118.8-126.8 ms a step);
  * ``False``, ``True``, ``'kernel'``, ``'hybrid'``: the per-op attention
    with that mode.
The LCA's one query sits below K4's 64-row floor
(``flash_attention.shape_supported``): under every mode but ``False`` and
``True`` it takes the 1-query einsum path; ``True`` forces K4 there and
raises on the card. ``scan_layers`` (the scan-stacked layout) is not
ported.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from sav_tpu_torch.models.vit import FUSED_LAYER_MODES
from sav_tpu_torch.nn.attention import AttentionBlock, SelfAttentionBlock
from sav_tpu_torch.nn.feedforward import FFBlock, LeFFBlock
from sav_tpu_torch.nn.layers import Dense, LayerNorm
from sav_tpu_torch.nn.stems import Image2TokenBlock
from sav_tpu_torch.ops import fused_layer

USE_KERNEL = (False, True, 'kernel', 'hybrid', 'auto', *FUSED_LAYER_MODES)


def _check_use_kernel(use_kernel) -> None:
    if use_kernel not in USE_KERNEL:
        raise NotImplementedError(
            f'use_kernel={use_kernel!r} is not a CeiT mode (the port takes '
            f'{USE_KERNEL}; ROADMAP.md)')


def _lca_kernel(use_kernel):
    """The LCA's own attention mode: ``False`` and ``True`` as given, any
    other mode the 1-query path that ``'auto'`` takes."""
    return use_kernel if use_kernel in (False, True) else 'auto'


class LCSelfAttentionBlock(AttentionBlock):
    """Attention where only the last token forms the query (LCA)."""

    def forward(self, inputs):
        if self.use_kernel is True and inputs.device.type == 'cuda':
            raise ValueError(
                'use_kernel=True forces the K4 port, which takes at least one '
                'full 64-row query tile (flash_attention.shape_supported); '
                "CeiT's layer-wise class attention has one query. Any other "
                'use_kernel runs it on the 1-query path')
        return super().forward(inputs[:, -1:], inputs)


class EncoderBlock(nn.Module):
    """Post-LN block: SA -> residual -> LN, LeFF -> residual -> LN."""

    def __init__(self, dim: int, num_heads: int, expand_ratio: float = 4,
                 leff_kernel_size: int = 3, bn_momentum: float = 0.9,
                 bn_epsilon: float = 1e-5, dtype=torch.float32,
                 use_kernel: Union[str, bool] = 'auto'):
        super().__init__()
        _check_use_kernel(use_kernel)
        self.num_heads, self.dtype, self.use_kernel = num_heads, dtype, use_kernel
        self.SelfAttentionBlock_0 = SelfAttentionBlock(
            dim, num_heads, dtype=dtype, use_kernel=use_kernel)
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.LeFFBlock_0 = LeFFBlock(dim, expand_ratio,
                                     kernel_size=leff_kernel_size,
                                     bn_momentum=bn_momentum,
                                     bn_epsilon=bn_epsilon, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype)

    def fused_core(self, inputs) -> Union[str, None]:
        """The core of ``attention_sublayer_noln`` this block takes, or
        None for the per-op path."""
        l, dim = inputs.shape[-2], inputs.shape[-1]
        head_ch = dim // self.num_heads
        if self.use_kernel in FUSED_LAYER_MODES:
            core = FUSED_LAYER_MODES[self.use_kernel]
            if core == 'fused' and not fused_layer.fused_supported(
                    l, self.num_heads, head_ch):
                core = 'flash'
            return core
        if self.use_kernel != 'auto' or inputs.device.type != 'cuda':
            return None
        core = fused_layer.auto_core(l, self.num_heads, head_ch,
                                     inputs.device)
        if core is None:
            raise NotImplementedError(
                f'no attention kernel of the port takes L={l}, {self.num_heads} '
                f'heads of {head_ch} (K1 and K4 need d = 64; K4 at least 64 '
                'rows); use_kernel=False runs the per-op path')
        return core

    def forward(self, inputs):
        core = self.fused_core(inputs)
        if core is not None:
            attn = self.SelfAttentionBlock_0
            x = fused_layer.attention_sublayer_noln(
                inputs.to(self.dtype), attn.queries.kernel, attn.keys.kernel,
                attn.values.kernel, attn.DenseGeneral_0.kernel,
                self.num_heads, core, True)
        else:
            x = self.SelfAttentionBlock_0(inputs) + inputs
        x = self.LayerNorm_0(x)
        return self.LayerNorm_1(x + self.LeFFBlock_0(x))


class Encoder(nn.Module):
    """N post-LN blocks; returns the per-layer cls tokens ``[B, N, D]``."""

    def __init__(self, num_layers: int, dim: int, **block):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f'EncoderBlock_{i}', EncoderBlock(dim, **block))

    def forward(self, inputs):
        x, cls_tokens = inputs, []
        for i in range(self.num_layers):
            x = getattr(self, f'EncoderBlock_{i}')(x)
            cls_tokens.append(x[:, :1])
        return torch.cat(cls_tokens, dim=1)


class LCAEncoderBlock(nn.Module):
    """Layer-wise class-attention block with its own FF, as the JAX package
    defines it for completeness; ``CeiT`` applies a bare
    ``LCSelfAttentionBlock``, as the reference does."""

    def __init__(self, dim: int, num_heads: int, expand_ratio: float = 4,
                 dtype=torch.float32, use_kernel: Union[str, bool] = 'auto'):
        super().__init__()
        _check_use_kernel(use_kernel)
        self.LCSelfAttentionBlock_0 = LCSelfAttentionBlock(
            dim, num_heads, dtype=dtype, use_kernel=_lca_kernel(use_kernel))
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.FFBlock_0 = FFBlock(dim, expand_ratio, dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype)

    def forward(self, inputs):
        x = self.LayerNorm_0(self.LCSelfAttentionBlock_0(inputs) + inputs)
        return self.LayerNorm_1(x + self.FFBlock_0(x))


class CeiT(nn.Module):
    """CeiT classifier over NHWC images of ``img_size``."""

    def __init__(self, num_classes: int, num_layers: int, num_heads: int,
                 embed_dim: int, patch_shape: Tuple[int, int] = (4, 4),
                 num_ch: int = 32, conv_kernel_size: int = 7,
                 conv_stride: int = 2, pool_window_size: int = 3,
                 pool_stride: int = 2, expand_ratio: float = 4,
                 leff_kernel_size: int = 3, bn_momentum: float = 0.9,
                 bn_epsilon: float = 1e-5, img_size: int = 224,
                 dtype=torch.float32, use_kernel: Union[str, bool] = 'auto',
                 scan_layers: bool = False):
        super().__init__()
        if scan_layers:
            raise NotImplementedError(
                'scan_layers=True is not ported yet (the scan-stacked layout: '
                'ROADMAP.md Queue 1 item 1)')
        if embed_dim % num_heads:
            raise ValueError(f'embed_dim {embed_dim} is not divisible by '
                             f'{num_heads} heads')
        _check_use_kernel(use_kernel)
        self.dtype, self.img_size = dtype, img_size
        self.Image2TokenBlock_0 = Image2TokenBlock(
            patch_shape, num_ch, conv_kernel_size, conv_stride,
            pool_window_size, pool_stride, embed_dim,
            bn_momentum=bn_momentum, bn_epsilon=bn_epsilon, dtype=dtype)
        self.cls = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.Encoder_0 = Encoder(num_layers, embed_dim, num_heads=num_heads,
                                 expand_ratio=expand_ratio,
                                 leff_kernel_size=leff_kernel_size,
                                 bn_momentum=bn_momentum,
                                 bn_epsilon=bn_epsilon, dtype=dtype,
                                 use_kernel=use_kernel)
        self.LCSelfAttentionBlock_0 = LCSelfAttentionBlock(
            embed_dim, num_heads, dtype=dtype,
            use_kernel=_lca_kernel(use_kernel))
        self.Dense_0 = Dense(embed_dim, num_classes, dtype=dtype,
                             zero_init=True)

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.cls)

    def forward(self, inputs):
        x = self.Image2TokenBlock_0(inputs)
        # the f32 cls token promotes the stream to f32, as in flax
        x = torch.cat([self.cls.expand(x.shape[0], -1, -1), x], dim=1)
        cls_tokens = self.LCSelfAttentionBlock_0(self.Encoder_0(x))
        return self.Dense_0(cls_tokens[:, -1])


def set_use_kernel(model: nn.Module, use_kernel: Union[str, bool]) -> None:
    """Re-routes every attention block of a built CeiT (same weights)."""
    _check_use_kernel(use_kernel)
    for sub in model.modules():
        if isinstance(sub, LCSelfAttentionBlock):
            sub.use_kernel = _lca_kernel(use_kernel)
        elif isinstance(sub, (EncoderBlock, SelfAttentionBlock)):
            sub.use_kernel = use_kernel
