"""ViT: Vision Transformer (counterpart of ``sav_tpu/models/vit.py``).

Pre-LN encoder blocks, learned absolute position embedding, zero-init cls
token and classifier head. The module tree carries the flax names, so a
``sav_tpu`` parameter tree loads through ``utils.flax_bridge``. Shapes that
flax infers at init (the token count) come from ``img_size``.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from sav_tpu_torch.nn.attention import SelfAttentionBlock
from sav_tpu_torch.nn.feedforward import FFBlock
from sav_tpu_torch.nn.layers import Dense, LayerNorm
from sav_tpu_torch.nn.posembed import AddAbsPosEmbed, FixedPositionalEmbedding
from sav_tpu_torch.nn.stems import PatchEmbedBlock
from sav_tpu_torch.ops import fused_layer, int8_ff

# use_kernel values that route the attention sublayer through
# ops.fused_layer.attention_sublayer; the value picks the core.
FUSED_LAYER_MODES = {
    'fused_layer': 'flash',         # K4 core, library projections
    'fused_layer_xla': 'xla',       # plain torch core
    'fused_layer_full': 'fused',    # the K1 port for the whole span
}
PER_OP_MODES = (False, True, 'kernel', 'hybrid', 'auto')
# per-op attention (dispatched as 'auto'), the FF sublayer as one autograd
# Function with the K16 backward (ops.fused_layer.ff_sublayer)
FUSED_FF = 'fused_ff'
# int8 routes (JAX's ``quantized``): 'ff' runs LN_1 -> FF -> residual on
# K13 (ops.int8_ff.int8_ff_sublayer); 'ff_sb' is the same forward with the
# SwitchBack backward on K14 (int8_ff_sublayer_sb); 'all' adds K10 for the
# attention sublayer wherever a fused core is chosen (serving only); True
# runs both FF products through the library int8 path (QuantizedDense)
QUANTIZED = (False, True, 'ff', 'ff_sb', 'all')
INT8_FF_SUBLAYER = {'ff': int8_ff.int8_ff_sublayer,
                    'ff_sb': int8_ff.int8_ff_sublayer_sb,
                    'all': int8_ff.int8_ff_sublayer}


def _check_use_kernel(use_kernel) -> None:
    if (use_kernel not in PER_OP_MODES and use_kernel not in FUSED_LAYER_MODES
            and use_kernel != FUSED_FF):
        raise NotImplementedError(
            f'use_kernel={use_kernel!r} is not ported yet (ROADMAP.md)')


def _check_quantized(quantized, use_kernel) -> None:
    if quantized not in QUANTIZED:
        raise ValueError(f'quantized must be one of {QUANTIZED}, got '
                         f'{quantized!r}')
    if quantized is True and use_kernel == FUSED_FF:
        raise ValueError("use_kernel='fused_ff' is unquantized: its FF "
                         'backward kernel (K16) assumes the bf16 forward')


class EncoderBlock(nn.Module):
    """Pre-LN transformer block: LN->MHA->residual, LN->MLP->residual."""

    def __init__(self, dim: int, num_heads: int, expand_ratio: float = 4,
                 dtype=torch.float32, use_kernel: Union[str, bool] = 'auto',
                 fused_qkv: bool = False, attn_bias: bool = False,
                 rotary: bool = False, quantized: Union[bool, str] = False):
        super().__init__()
        _check_use_kernel(use_kernel)
        _check_quantized(quantized, use_kernel)
        self.num_heads, self.dtype = num_heads, dtype
        self.use_kernel, self.rotary = use_kernel, rotary
        self.quantized = quantized
        self.int8_core = 'kernel'         # or 'plain': models.set_int8_core
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.SelfAttentionBlock_0 = SelfAttentionBlock(
            dim, num_heads, dtype=dtype, use_kernel=use_kernel,
            fused_qkv=fused_qkv, use_bias=attn_bias, rotary=rotary)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        self.FFBlock_0 = FFBlock(dim, expand_ratio, dtype,
                                 quantized=quantized is True)

    def _fused_core(self, inputs) -> Union[str, None]:
        if self.use_kernel in FUSED_LAYER_MODES:
            return FUSED_LAYER_MODES[self.use_kernel]
        if self.use_kernel == 'auto':
            dim = inputs.shape[-1]
            return fused_layer.auto_core(inputs.shape[-2], self.num_heads,
                                         dim // self.num_heads, inputs.device)
        return None

    def forward(self, inputs):
        core = self._fused_core(inputs)
        if core is not None:
            x = self._fused_attention_sublayer(inputs, core)
        else:
            x = self.SelfAttentionBlock_0(self.LayerNorm_0(inputs)) + inputs
        if self.quantized in INT8_FF_SUBLAYER:
            return self._int8_ff_sublayer(x)
        if self.use_kernel == FUSED_FF:
            return self._ff_sublayer(x)
        return x + self.FFBlock_0(self.LayerNorm_1(x))

    def _ff_sublayer(self, x):
        """LN_1 -> FFBlock_0 -> residual as one autograd Function (library
        forward, K16 backward), on the same parameters as the per-op path.
        The port's FFBlock is dropout-free, unquantized and tanh-gelu, the
        three things the kernel's closed-form backward assumes."""
        ff = self.FFBlock_0
        dim, hidden = ff.Dense_0.kernel.shape
        why = fused_layer.ff_refusal(dim, hidden, x.device)
        if why is not None:
            raise ValueError(f"use_kernel='fused_ff' does not take D={dim}, "
                             f'F={hidden} on {x.device}: {why}')
        return fused_layer.ff_sublayer(
            x.to(self.dtype), self.LayerNorm_1.scale, self.LayerNorm_1.bias,
            ff.Dense_0.kernel, ff.Dense_0.bias, ff.Dense_1.kernel,
            ff.Dense_1.bias, fused_layer.LN_EPS)

    def _int8_ff_sublayer(self, x):
        """LN_1 -> int8 FF -> residual as one autograd Function on K13
        (``ops.int8_ff.int8_ff_sublayer``; with 'ff_sb'
        ``int8_ff_sublayer_sb``, whose backward runs K14), on the same
        parameters as the per-op path."""
        ff = self.FFBlock_0
        return INT8_FF_SUBLAYER[self.quantized](
            x.to(self.dtype), self.LayerNorm_1.scale, self.LayerNorm_1.bias,
            ff.Dense_0.kernel, ff.Dense_0.bias, ff.Dense_1.kernel,
            ff.Dense_1.bias, fused_layer.LN_EPS, self.int8_core)

    def _fused_attention_sublayer(self, inputs, core: str):
        """LN -> self-attention -> out-proj -> residual as one call, on the
        same parameters as the per-op path. With quantized='all' (and no
        rotary embedding) the serving-only int8 sublayer (K10) runs
        whatever the core, as in the JAX package."""
        dim = inputs.shape[-1]
        attn = self.SelfAttentionBlock_0
        if self.quantized == 'all' and not self.rotary:
            return fused_layer.attention_sublayer_q8(
                inputs.to(self.dtype), self.LayerNorm_0.scale,
                self.LayerNorm_0.bias, attn.queries.kernel, attn.keys.kernel,
                attn.values.kernel, attn.DenseGeneral_0.kernel,
                self.num_heads, fused_layer.LN_EPS, True, self.int8_core)
        if core == 'fused' and not fused_layer.fused_supported(
                inputs.shape[-2], self.num_heads, dim // self.num_heads):
            core = 'flash'
        return fused_layer.attention_sublayer(
            inputs.to(self.dtype), self.LayerNorm_0.scale,
            self.LayerNorm_0.bias, attn.queries.kernel, attn.keys.kernel,
            attn.values.kernel, attn.DenseGeneral_0.kernel, self.num_heads,
            core, fused_layer.LN_EPS, True, self.rotary)


def set_use_kernel(model: nn.Module, use_kernel: Union[str, bool]) -> None:
    """Re-routes every encoder block of a built model (same weights)."""
    _check_use_kernel(use_kernel)
    for sub in model.modules():
        if isinstance(sub, EncoderBlock):
            _check_quantized(sub.quantized, use_kernel)
        if isinstance(sub, (EncoderBlock, SelfAttentionBlock)):
            sub.use_kernel = use_kernel


class Encoder(nn.Module):
    """Position embedding + N encoder blocks + final LayerNorm."""

    def __init__(self, seq_len: int, dim: int, num_layers: int,
                 num_heads: int, expand_ratio: float = 4, dtype=torch.float32,
                 use_kernel: Union[str, bool] = 'auto',
                 pos_embed: str = 'learned', fused_qkv: bool = False,
                 attn_bias: bool = False,
                 quantized: Union[bool, str] = False):
        super().__init__()
        if pos_embed == 'learned':
            self.AddAbsPosEmbed_0 = AddAbsPosEmbed(seq_len, dim)
        elif pos_embed == 'fixed':
            self.fixed = FixedPositionalEmbedding(dtype)
        elif pos_embed not in ('rotary', 'none'):
            raise ValueError(f'pos_embed must be learned|fixed|rotary|none, '
                             f'got {pos_embed!r}')
        self.pos_embed = pos_embed
        for i in range(num_layers):
            self.add_module(f'EncoderBlock_{i}', EncoderBlock(
                dim, num_heads, expand_ratio, dtype, use_kernel, fused_qkv,
                attn_bias, rotary=pos_embed == 'rotary', quantized=quantized))
        self.num_layers = num_layers
        self.LayerNorm_0 = LayerNorm(dim, dtype)

    def forward(self, inputs):
        if self.pos_embed == 'learned':
            x = self.AddAbsPosEmbed_0(inputs)
        elif self.pos_embed == 'fixed':
            x = self.fixed(inputs)
        else:
            x = inputs
        for i in range(self.num_layers):
            x = getattr(self, f'EncoderBlock_{i}')(x)
        return self.LayerNorm_0(x)


class ViT(nn.Module):
    """Vision Transformer classifier over NHWC images of ``img_size``."""

    def __init__(self, num_classes: int, num_layers: int, num_heads: int,
                 embed_dim: int, patch_shape: Tuple[int, int],
                 img_size: int = 224, expand_ratio: float = 4,
                 dtype=torch.float32, use_kernel: Union[str, bool] = 'auto',
                 pos_embed: str = 'learned', fused_qkv: bool = False,
                 attn_bias: bool = False, dropout_rate: float = 0.0,
                 attn_dropout_rate: float = 0.0,
                 quantized: Union[bool, str] = False):
        super().__init__()
        if dropout_rate or attn_dropout_rate:
            raise NotImplementedError(
                'dropout_rate/attn_dropout_rate are not ported yet (no vit_* '
                'config sets them; ROADMAP.md Queue 1)')
        if embed_dim % num_heads:
            raise ValueError(f'embed_dim {embed_dim} is not divisible by '
                             f'{num_heads} heads')
        self.dtype = dtype
        self.img_size = img_size
        seq_len = (img_size // patch_shape[0]) * (img_size // patch_shape[1]) + 1
        self.PatchEmbedBlock_0 = PatchEmbedBlock(patch_shape, embed_dim,
                                                 dtype=dtype)
        self.cls = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.Encoder_0 = Encoder(seq_len, embed_dim, num_layers, num_heads,
                                 expand_ratio, dtype, use_kernel, pos_embed,
                                 fused_qkv, attn_bias, quantized)
        self.Dense_0 = Dense(embed_dim, num_classes, dtype=dtype,
                             zero_init=True)

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.cls)

    def forward(self, inputs):
        x = self.PatchEmbedBlock_0(inputs)
        # the f32 cls token promotes the stream to f32, as in flax
        x = torch.cat([self.cls.expand(x.shape[0], -1, -1), x], dim=1)
        x = self.Encoder_0(x)
        return self.Dense_0(x[:, 0])
