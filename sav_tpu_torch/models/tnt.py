"""TNT: Transformer in Transformer (counterpart of ``sav_tpu/models/tnt.py``).

An inner transformer over each patch's pixel tokens feeds an outer
transformer over the patch tokens through a fold-and-project bridge. The
module tree carries the flax names (``PixelEmbedBlock_0``,
``PatchEmbedBlock_0``, ``cls``, ``AddAbsPosEmbed_0`` for the pixels and
``AddAbsPosEmbed_1`` for the patches, ``Encoder_0.EncoderBlock_i`` with
``LayerNorm_0..3``, ``SelfAttentionBlock_0/1``, ``FFBlock_0/1`` and
``Inner2OuterBlock_0``, the head ``Dense_0``), so a ``sav_tpu`` TNT tree
loads through ``utils.flax_bridge``. Shapes flax infers at init (token
counts) come from ``img_size``.

``use_kernel`` takes the JAX package's values:
  * ``'auto'``: on the card the whole inner layer on the K7 port
    (``ops.tnt_inner.inner_layer``; a shape it does not take raises rather
    than run per-op unasked) and the outer attention sublayer on the core
    ``fused_layer.auto_core`` picks (K1 with ``residual=False`` at TNT's
    shapes); off the card per-op everywhere, as the JAX package off the
    TPU. The TPU's 20000-row threshold for the fused outer sublayer is a
    TPU measurement and has no counterpart here.
  * ``'fused_inner'``: the inner layer as one span (the kernels on the
    card, the plain twins on the CPU), the outer sublayer per-op.
  * ``'fused_inner_outer'``: both spans, the outer on the ``'fused'`` core.
  * ``'fused_layer'``, ``'fused_layer_xla'``, ``'fused_layer_full'``: the
    outer sublayer as one span on the 'flash', 'xla' or 'fused' core.
  * ``False``, ``True``, ``'kernel'``, ``'hybrid'``: per-op, the attention
    blocks dispatching the value as ``ops.attention`` does.
Every route reads the same parameters.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from sav_tpu_torch.models.vit import FUSED_LAYER_MODES, PER_OP_MODES
from sav_tpu_torch.nn.attention import AttentionBlock, SelfAttentionBlock
from sav_tpu_torch.nn.feedforward import FFBlock
from sav_tpu_torch.nn.layers import Dense, LayerNorm
from sav_tpu_torch.nn.posembed import AddAbsPosEmbed
from sav_tpu_torch.nn.stems import PatchEmbedBlock
from sav_tpu_torch.ops import fused_layer, tnt_inner

INNER_MODES = ('fused_inner', 'fused_inner_outer')
USE_KERNEL = (*PER_OP_MODES, *INNER_MODES, *FUSED_LAYER_MODES)


def _check_use_kernel(use_kernel) -> None:
    if use_kernel not in USE_KERNEL:
        raise NotImplementedError(
            f'use_kernel={use_kernel!r} is not a TNT mode (the port takes '
            f'{USE_KERNEL}; ROADMAP.md)')


def pixel_tokens(images: torch.Tensor, patch_shape: Tuple[int, int],
                 transformed_patch_shape: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] -> [B*P, (ph/t1)*(pw/t2), C*t1*t2]: the patches in row
    order, each as its t1 x t2 pixel blocks flattened channel-major, ``(c
    t1 t2)``, as the JAX package's rearranges do."""
    ph, pw = patch_shape
    t1, t2 = transformed_patch_shape
    b, h, w, c = images.shape
    x = images.reshape(b, h // ph, ph // t1, t1, w // pw, pw // t2, t2, c)
    # -> (b, h, w, p1, p2, c, t1, t2)
    x = x.permute(0, 1, 4, 2, 5, 7, 3, 6)
    return x.reshape(b * (h // ph) * (w // pw), (ph // t1) * (pw // t2),
                     c * t1 * t2)


class PixelEmbedBlock(nn.Module):
    """Each patch as a sequence of transformed-pixel tokens, embedded by a
    Dense: ``[B*P, inner_len, embed_dim]``."""

    def __init__(self, patch_shape: Tuple[int, int],
                 transformed_patch_shape: Tuple[int, int], embed_dim: int,
                 in_ch: int = 3, dtype=torch.float32):
        super().__init__()
        ph, pw = patch_shape
        t1, t2 = transformed_patch_shape
        if ph % t1 or pw % t2:
            raise ValueError(f'patch {patch_shape} is not a multiple of the '
                             f'transformed patch {transformed_patch_shape}')
        self.patch_shape = tuple(patch_shape)
        self.transformed_patch_shape = tuple(transformed_patch_shape)
        self.Dense_0 = Dense(in_ch * t1 * t2, embed_dim, dtype=dtype)

    def forward(self, inputs):
        return self.Dense_0(pixel_tokens(inputs, self.patch_shape,
                                         self.transformed_patch_shape))


class Inner2OuterBlock(nn.Module):
    """Folds each patch's pixel tokens flat, projects them to the outer
    width and adds them to the patch tokens; the cls row gets zeros."""

    def __init__(self, in_features: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(in_features, out_ch, dtype=dtype)

    def forward(self, patch_inputs, pixel_inputs):
        batch = patch_inputs.shape[0]
        x = self.Dense_0(pixel_inputs.reshape(pixel_inputs.shape[0], -1))
        x = F.pad(x.reshape(batch, -1, x.shape[-1]), (0, 0, 1, 0))
        return x + patch_inputs


class EncoderBlock(nn.Module):
    """One TNT layer: the inner block, the bridge, the outer block."""

    def __init__(self, inner_len: int, inner_dim: int, outer_dim: int,
                 inner_num_heads: int, outer_num_heads: int,
                 inner_expand_ratio: float = 4, outer_expand_ratio: float = 4,
                 dtype=torch.float32, use_kernel: Union[str, bool] = 'auto'):
        super().__init__()
        _check_use_kernel(use_kernel)
        self.inner_num_heads, self.outer_num_heads = (inner_num_heads,
                                                      outer_num_heads)
        self.dtype, self.use_kernel = dtype, use_kernel
        self.LayerNorm_0 = LayerNorm(inner_dim, dtype)
        self.SelfAttentionBlock_0 = SelfAttentionBlock(
            inner_dim, inner_num_heads, dtype=dtype, use_kernel=use_kernel)
        self.LayerNorm_1 = LayerNorm(inner_dim, dtype)
        self.FFBlock_0 = FFBlock(inner_dim, inner_expand_ratio, dtype)
        self.Inner2OuterBlock_0 = Inner2OuterBlock(inner_len * inner_dim,
                                                   outer_dim, dtype)
        self.LayerNorm_2 = LayerNorm(outer_dim, dtype)
        self.SelfAttentionBlock_1 = SelfAttentionBlock(
            outer_dim, outer_num_heads, dtype=dtype, use_kernel=use_kernel)
        self.LayerNorm_3 = LayerNorm(outer_dim, dtype)
        self.FFBlock_1 = FFBlock(outer_dim, outer_expand_ratio, dtype)

    def inner_route(self, pixel_inputs) -> bool:
        """Whether the inner layer runs as one ``tnt_inner`` span."""
        if self.use_kernel in INNER_MODES:
            return True
        if self.use_kernel != 'auto':
            return False
        l, d = pixel_inputs.shape[-2], pixel_inputs.shape[-1]
        return tnt_inner.auto_route(l, d, self.inner_num_heads,
                                    self.FFBlock_0.Dense_0.kernel.shape[1],
                                    pixel_inputs.device)

    def outer_core(self, bridged) -> Union[str, None]:
        """The ``attention_sublayer`` core of the outer sublayer, or None
        for the per-op path."""
        if self.use_kernel == 'fused_inner_outer':
            core = 'fused'
        elif self.use_kernel == 'auto':
            dim = bridged.shape[-1]
            return fused_layer.auto_core(bridged.shape[-2],
                                         self.outer_num_heads,
                                         dim // self.outer_num_heads,
                                         bridged.device)
        else:
            core = FUSED_LAYER_MODES.get(self.use_kernel)
        dim = bridged.shape[-1]
        if core == 'fused' and not fused_layer.fused_supported(
                bridged.shape[-2], self.outer_num_heads,
                dim // self.outer_num_heads):
            core = 'flash'
        return core

    def forward(self, patch_inputs, pixel_inputs):
        if self.inner_route(pixel_inputs):
            attn, ff = self.SelfAttentionBlock_0, self.FFBlock_0
            inner_output = tnt_inner.inner_layer(
                pixel_inputs.to(self.dtype), self.LayerNorm_0.scale,
                self.LayerNorm_0.bias, attn.queries.kernel, attn.keys.kernel,
                attn.values.kernel, attn.DenseGeneral_0.kernel,
                self.LayerNorm_1.scale, self.LayerNorm_1.bias,
                ff.Dense_0.kernel, ff.Dense_0.bias, ff.Dense_1.kernel,
                ff.Dense_1.bias, self.inner_num_heads)
        else:
            inner_x = self.SelfAttentionBlock_0(
                self.LayerNorm_0(pixel_inputs)) + pixel_inputs
            inner_output = inner_x + self.FFBlock_0(self.LayerNorm_1(inner_x))

        bridged = self.Inner2OuterBlock_0(patch_inputs, inner_output)
        core = self.outer_core(bridged)
        if core is not None:
            # residual=False: the skip adds the PRE-bridge patch tokens
            attn = self.SelfAttentionBlock_1
            outer_x = patch_inputs + fused_layer.attention_sublayer(
                bridged.to(self.dtype), self.LayerNorm_2.scale,
                self.LayerNorm_2.bias, attn.queries.kernel, attn.keys.kernel,
                attn.values.kernel, attn.DenseGeneral_0.kernel,
                self.outer_num_heads, core, fused_layer.LN_EPS, False)
        else:
            outer_x = self.SelfAttentionBlock_1(
                self.LayerNorm_2(bridged)) + patch_inputs
        return (outer_x + self.FFBlock_1(self.LayerNorm_3(outer_x)),
                inner_output)


class Encoder(nn.Module):
    """N TNT layers threading the (patch, pixel) pair; returns the patch
    tokens (no final LayerNorm, as in the JAX package)."""

    def __init__(self, num_layers: int, **block):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f'EncoderBlock_{i}', EncoderBlock(**block))

    def forward(self, patch_embeddings, pixel_embeddings):
        for i in range(self.num_layers):
            patch_embeddings, pixel_embeddings = getattr(
                self, f'EncoderBlock_{i}')(patch_embeddings, pixel_embeddings)
        return patch_embeddings


class TNT(nn.Module):
    """TNT classifier over NHWC images of ``img_size``."""

    def __init__(self, num_classes: int, num_layers: int,
                 inner_num_heads: int, outer_num_heads: int,
                 inner_embed_dim: int, outer_embed_dim: int,
                 patch_shape: Tuple[int, int] = (16, 16),
                 transformed_patch_shape: Tuple[int, int] = (4, 4),
                 img_size: int = 224, inner_expand_ratio: float = 4,
                 outer_expand_ratio: float = 4, dtype=torch.float32,
                 use_kernel: Union[str, bool] = 'auto',
                 attn_dropout_rate: float = 0.0, dropout_rate: float = 0.0,
                 scan_layers: bool = False):
        super().__init__()
        if dropout_rate or attn_dropout_rate:
            raise NotImplementedError(
                'dropout_rate/attn_dropout_rate are not ported yet (no tnt_* '
                'config sets them; ROADMAP.md Queue 1 item 2)')
        if scan_layers:
            raise NotImplementedError(
                'scan_layers=True is not ported yet (the scan-stacked layout: '
                'ROADMAP.md Queue 1 item 1)')
        for dim, heads in ((inner_embed_dim, inner_num_heads),
                           (outer_embed_dim, outer_num_heads)):
            if dim % heads:
                raise ValueError(f'embed_dim {dim} is not divisible by '
                                 f'{heads} heads')
        _check_use_kernel(use_kernel)
        self.dtype = dtype
        self.img_size = img_size
        ph, pw = patch_shape
        t1, t2 = transformed_patch_shape
        num_patches = (img_size // ph) * (img_size // pw)
        inner_len = (ph // t1) * (pw // t2)
        self.PixelEmbedBlock_0 = PixelEmbedBlock(
            patch_shape, transformed_patch_shape, inner_embed_dim, dtype=dtype)
        self.PatchEmbedBlock_0 = PatchEmbedBlock(patch_shape, outer_embed_dim,
                                                 use_bias=True, dtype=dtype)
        self.cls = nn.Parameter(torch.empty(1, 1, outer_embed_dim))
        self.AddAbsPosEmbed_0 = AddAbsPosEmbed(inner_len, inner_embed_dim)
        self.AddAbsPosEmbed_1 = AddAbsPosEmbed(num_patches + 1,
                                               outer_embed_dim)
        self.Encoder_0 = Encoder(
            num_layers, inner_len=inner_len, inner_dim=inner_embed_dim,
            outer_dim=outer_embed_dim, inner_num_heads=inner_num_heads,
            outer_num_heads=outer_num_heads,
            inner_expand_ratio=inner_expand_ratio,
            outer_expand_ratio=outer_expand_ratio, dtype=dtype,
            use_kernel=use_kernel)
        self.Dense_0 = Dense(outer_embed_dim, num_classes, dtype=dtype,
                             zero_init=True)

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.cls)

    def forward(self, inputs):
        pixels = self.PixelEmbedBlock_0(inputs)
        patches = self.PatchEmbedBlock_0(inputs)
        # the f32 cls token and position embeddings promote both streams to
        # f32, as in flax
        patches = torch.cat([self.cls.expand(patches.shape[0], -1, -1),
                             patches], dim=1)
        pixels = self.AddAbsPosEmbed_0(pixels)
        patches = self.AddAbsPosEmbed_1(patches)
        patches = self.Encoder_0(patches, pixels)
        return self.Dense_0(patches[:, 0])


def set_use_kernel(model: nn.Module, use_kernel: Union[str, bool]) -> None:
    """Re-routes every block of a built TNT (same weights)."""
    _check_use_kernel(use_kernel)
    for sub in model.modules():
        if isinstance(sub, (EncoderBlock, AttentionBlock)):
            sub.use_kernel = use_kernel
