"""CaiT: Class-Attention in Image Transformers (counterpart of
``sav_tpu/models/cait.py``).

A self-attention body with talking heads, LayerScale and stochastic depth
(no cls token: it runs at L = (img/16)^2), then class-attention blocks in
which only the cls token is updated, LayerNorm and a zero-init head. The
module tree carries the flax names, so a ``sav_tpu`` CaiT tree loads
through ``utils.flax_bridge``. As in the JAX package, the body runs in the
model's dtype (the reference's forgotten ``dtype`` is forwarded) and the
f32 position embedding promotes the residual stream to f32.

``use_kernel``: ``'auto'`` sends each body block's LN + talking-heads
attention through ``ops.th_attention.th_attention_sublayer`` on the route
``th_route`` picks on the card (K5 where its projection GEMMs take D,
multiples of 32: every factory CaiT, cait_xs's 288 with a ragged last
tile; else K6; every factory CaiT's head count, 4, 6, 8 or 16, is built,
and another one raises there), and through the per-op path elsewhere;
``'fused_th'`` forces the span (K5 where it fits, else K6);
``'fused_th_xla'`` is the span with the plain core (the yardstick of the
kernels); ``False`` the per-op path. The 1-query class attention always
takes the plain path, as in the JAX package.

``quantized`` (the JAX package's int8 routes of the body; the class-attention
blocks stay unquantized): ``'ff'`` runs each body FF on K12, ``'ff_sb'``
the same with the SwitchBack backward (K14), ``True`` the library int8 FF
path, and ``'all'`` (serving only) adds int8 projections to every body
block that takes the talking-heads span (``th_attention_sublayer_q8``: K11
where the JAX package's ``th_supported`` holds, else the bf16 span), with
its FF on K12.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from sav_tpu_torch.nn.attention import AttentionBlock, SelfAttentionBlock
from sav_tpu_torch.nn.feedforward import FFBlock
from sav_tpu_torch.nn.layers import Dense, LayerNorm
from sav_tpu_torch.nn.normalization import LayerScaleBlock
from sav_tpu_torch.nn.posembed import AddAbsPosEmbed
from sav_tpu_torch.nn.regularization import StochasticDepthBlock
from sav_tpu_torch.nn.stems import PatchEmbedBlock
from sav_tpu_torch.ops import th_attention
from sav_tpu_torch.ops.fused_layer import LN_EPS

USE_KERNEL = (False, 'auto', 'fused_th', 'fused_th_xla')
QUANTIZED = (False, True, 'ff', 'ff_sb', 'all')


def _check_use_kernel(use_kernel) -> None:
    if use_kernel not in USE_KERNEL:
        raise NotImplementedError(
            f'use_kernel={use_kernel!r} is not ported for CaiT (the port '
            f'takes {USE_KERNEL}; ROADMAP.md)')


def _attention_kernel(use_kernel):
    """The per-op attention's own use_kernel: plain when the model is."""
    return False if use_kernel is False else 'auto'


class ClassSelfAttentionBlock(AttentionBlock):
    """Attention where only the first (cls) token forms the query."""

    def forward(self, inputs):
        return super().forward(inputs[:, :1], inputs)


class EncoderBlock(nn.Module):
    """CaiT body block: talking-heads self-attention and MLP, each behind
    LayerScale and stochastic depth."""

    def __init__(self, dim: int, num_heads: int, stoch_depth_rate: float,
                 layerscale_eps: float, expand_ratio: float = 4,
                 dtype=torch.float32, use_kernel: Union[str, bool] = 'auto',
                 quantized: Union[bool, str] = False):
        super().__init__()
        _check_use_kernel(use_kernel)
        self.num_heads, self.dtype, self.use_kernel = num_heads, dtype, use_kernel
        self.quantized = quantized
        self.int8_core = 'kernel'         # or 'plain': models.set_int8_core
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.SelfAttentionBlock_0 = SelfAttentionBlock(
            dim, num_heads, dtype=dtype,
            use_kernel=_attention_kernel(use_kernel), talking_heads=True)
        self.LayerScaleBlock_0 = LayerScaleBlock(dim, layerscale_eps, dtype)
        self.StochasticDepthBlock_0 = StochasticDepthBlock(stoch_depth_rate)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        # 'ff' (and 'all') run the bare int8 FF kernel (K12): LayerScale
        # sits between the FF and the residual, so the LN-fused span (K13)
        # does not apply
        self.FFBlock_0 = FFBlock(dim, expand_ratio, dtype,
                                 quantized='ff' if quantized == 'all'
                                 else quantized)
        self.LayerScaleBlock_1 = LayerScaleBlock(dim, layerscale_eps, dtype)
        self.StochasticDepthBlock_1 = StochasticDepthBlock(stoch_depth_rate)

    def th_route(self, inputs) -> Union[str, None]:
        """The route of ``th_attention_sublayer`` this block takes, or None
        for the per-op path."""
        l, dim = inputs.shape[-2], inputs.shape[-1]
        if self.use_kernel == 'fused_th_xla':
            return 'xla'
        if self.use_kernel == 'fused_th':
            return ('fused' if th_attention.fused_fits(l, self.num_heads, dim,
                                                       inputs.device)
                    else 'blocked')
        if self.use_kernel == 'auto':
            return th_attention.th_route(l, self.num_heads,
                                         dim // self.num_heads, dim,
                                         inputs.device)
        return None

    def forward(self, inputs):
        route = self.th_route(inputs)
        if route is not None:
            attn = self.SelfAttentionBlock_0
            # residual=False: LayerScale and stochastic depth sit between
            # the sublayer and the skip connection
            args = (inputs.to(self.dtype), self.LayerNorm_0.scale,
                    self.LayerNorm_0.bias, attn.queries.kernel,
                    attn.keys.kernel, attn.values.kernel,
                    attn.DenseGeneral_0.kernel,
                    attn.TalkingHeadsBlock_0.talking_heads_transform,
                    attn.TalkingHeadsBlock_1.talking_heads_transform,
                    self.num_heads, LN_EPS, False, route)
            if self.quantized == 'all':
                x = th_attention.th_attention_sublayer_q8(
                    *args, core=self.int8_core)
            else:
                x = th_attention.th_attention_sublayer(*args)
        else:
            x = self.SelfAttentionBlock_0(self.LayerNorm_0(inputs))
        x = self.StochasticDepthBlock_0(self.LayerScaleBlock_0(x)) + inputs
        y = self.FFBlock_0(self.LayerNorm_1(x))
        return x + self.StochasticDepthBlock_1(self.LayerScaleBlock_1(y))


class Encoder(nn.Module):
    """Absolute position embedding + N CaiT body blocks (no final LN)."""

    def __init__(self, seq_len: int, dim: int, num_layers: int, **block):
        super().__init__()
        self.AddAbsPosEmbed_0 = AddAbsPosEmbed(seq_len, dim)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f'EncoderBlock_{i}', EncoderBlock(dim, **block))

    def forward(self, inputs):
        x = self.AddAbsPosEmbed_0(inputs)
        for i in range(self.num_layers):
            x = getattr(self, f'EncoderBlock_{i}')(x)
        return x


class CAEncoderBlock(nn.Module):
    """Class-attention block: the cls query attends over [cls; patches] and
    only the cls token is updated."""

    def __init__(self, dim: int, num_heads: int, stoch_depth_rate: float,
                 layerscale_eps: float, expand_ratio: float = 4,
                 dtype=torch.float32, use_kernel: Union[str, bool] = 'auto'):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.ClassSelfAttentionBlock_0 = ClassSelfAttentionBlock(
            dim, num_heads, dtype=dtype,
            use_kernel=_attention_kernel(use_kernel))
        self.LayerScaleBlock_0 = LayerScaleBlock(dim, layerscale_eps, dtype)
        self.StochasticDepthBlock_0 = StochasticDepthBlock(stoch_depth_rate)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        self.FFBlock_0 = FFBlock(dim, expand_ratio, dtype)
        self.LayerScaleBlock_1 = LayerScaleBlock(dim, layerscale_eps, dtype)
        self.StochasticDepthBlock_1 = StochasticDepthBlock(stoch_depth_rate)

    def forward(self, inputs, cls_token):
        x = self.LayerNorm_0(torch.cat([cls_token, inputs], dim=1))
        x = self.ClassSelfAttentionBlock_0(x)
        cls_token = cls_token + self.StochasticDepthBlock_0(
            self.LayerScaleBlock_0(x))
        y = self.FFBlock_0(self.LayerNorm_1(cls_token))
        return cls_token + self.StochasticDepthBlock_1(self.LayerScaleBlock_1(y))


class CaiT(nn.Module):
    """CaiT classifier over NHWC images of ``img_size``."""

    def __init__(self, num_classes: int, num_layers: int,
                 num_layers_token_only: int, num_heads: int, embed_dim: int,
                 patch_shape: Tuple[int, int], stoch_depth_rate: float,
                 layerscale_eps: float, img_size: int = 224,
                 expand_ratio: float = 4, dtype=torch.float32,
                 use_kernel: Union[str, bool] = 'auto',
                 dropout_rate: float = 0.0, attn_dropout_rate: float = 0.0,
                 quantized: Union[bool, str] = False,
                 scan_layers: bool = False):
        super().__init__()
        if dropout_rate or attn_dropout_rate:
            raise NotImplementedError(
                'dropout_rate/attn_dropout_rate are not ported yet (no cait_* '
                'config sets them; ROADMAP.md Queue 1 item 2)')
        if scan_layers:
            raise NotImplementedError(
                'scan_layers=True is not ported yet (the scan-stacked layout: '
                'ROADMAP.md Queue 1 item 1)')
        if quantized not in QUANTIZED:
            raise ValueError(f'CaiT quantized must be one of {QUANTIZED}, '
                             f'got {quantized!r}')
        if embed_dim % num_heads:
            raise ValueError(f'embed_dim {embed_dim} is not divisible by '
                             f'{num_heads} heads')
        self.dtype = dtype
        self.img_size = img_size
        seq_len = (img_size // patch_shape[0]) * (img_size // patch_shape[1])
        block = dict(num_heads=num_heads, stoch_depth_rate=stoch_depth_rate,
                     layerscale_eps=layerscale_eps, expand_ratio=expand_ratio,
                     dtype=dtype, use_kernel=use_kernel)
        self.PatchEmbedBlock_0 = PatchEmbedBlock(patch_shape, embed_dim,
                                                 dtype=dtype)
        self.Encoder_0 = Encoder(seq_len, embed_dim, num_layers,
                                 quantized=quantized, **block)
        self.cls = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.num_layers_token_only = num_layers_token_only
        for i in range(num_layers_token_only):
            self.add_module(f'CAEncoderBlock_{i}',
                            CAEncoderBlock(embed_dim, **block))
        self.LayerNorm_0 = LayerNorm(embed_dim, dtype)
        self.Dense_0 = Dense(embed_dim, num_classes, dtype=dtype,
                             zero_init=True)

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.cls)

    def forward(self, inputs):
        x = self.Encoder_0(self.PatchEmbedBlock_0(inputs))
        cls_token = self.cls.expand(x.shape[0], -1, -1)
        for i in range(self.num_layers_token_only):
            cls_token = getattr(self, f'CAEncoderBlock_{i}')(x, cls_token)
        # LayerNorm is per token: normalizing [cls; x] and keeping row 0 is
        # normalizing cls alone
        return self.Dense_0(self.LayerNorm_0(cls_token[:, 0]))


def set_use_kernel(model: nn.Module, use_kernel: Union[str, bool]) -> None:
    """Re-routes every attention block of a built CaiT (same weights)."""
    _check_use_kernel(use_kernel)
    for sub in model.modules():
        if isinstance(sub, EncoderBlock):
            sub.use_kernel = use_kernel
        elif isinstance(sub, AttentionBlock):
            sub.use_kernel = _attention_kernel(use_kernel)
