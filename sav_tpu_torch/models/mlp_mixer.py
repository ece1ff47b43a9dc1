"""MLP-Mixer (counterpart of ``sav_tpu/models/mlp_mixer.py``): attention-free
token and channel mixing.

The module tree carries the flax names (``PatchEmbedBlock_0``,
``MixerBlock_N`` with ``LayerNorm_0``, ``FFBlock_0``, ``LayerNorm_1``,
``FFBlock_1``; the final ``LayerNorm_0`` and ``Dense_0``), so a ``sav_tpu``
Mixer tree loads through ``utils.flax_bridge``. Shapes that flax infers at
init (the token count of the token-mixing FFBlock) come from ``img_size``.

``use_kernel``: ``'auto'`` sends each token-mixing sublayer (LN -> Dense
over tokens -> gelu -> Dense -> +x) through
``ops.mixer_token.token_mix_sublayer`` on the card, and through the per-op
path (transpose, FFBlock over tokens, transpose) off the card, as the JAX
package takes it off the TPU; on the card a shape the K8 port does not
take raises (``mixer_token.auto_route``) rather than run the per-op path
unasked. ``'fused_token'`` always takes the span (the kernels on the card,
the plain twins on the CPU); ``False`` the per-op path. Both routes read
the same parameters.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from sav_tpu_torch.nn.feedforward import FFBlock
from sav_tpu_torch.nn.layers import Dense, LayerNorm
from sav_tpu_torch.nn.stems import PatchEmbedBlock
from sav_tpu_torch.ops import mixer_token

USE_KERNEL = (False, 'auto', 'fused_token')


def _check_use_kernel(use_kernel) -> None:
    if use_kernel not in USE_KERNEL:
        raise NotImplementedError(
            f'use_kernel={use_kernel!r}: the Mixer takes {USE_KERNEL} '
            '(ROADMAP.md)')


class MixerBlock(nn.Module):
    """LN -> token-mixing MLP -> residual; LN -> channel-mixing MLP ->
    residual."""

    def __init__(self, num_tokens: int, dim: int, tokens_expand_ratio: float,
                 channels_expand_ratio: float, dtype=torch.float32,
                 use_kernel: Union[str, bool] = 'auto',
                 quantized: Union[bool, str] = False):
        super().__init__()
        _check_use_kernel(use_kernel)
        self.dtype, self.use_kernel = dtype, use_kernel
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.FFBlock_0 = FFBlock(num_tokens, tokens_expand_ratio, dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        # int8 serving quantizes the channel-mix FF only (K12); the
        # token-mix products ([L, L/2]-sized) stay bf16, as in the JAX package
        self.FFBlock_1 = FFBlock(dim, channels_expand_ratio, dtype,
                                 quantized='ff' if quantized else False)

    def _token_kernel_route(self, inputs) -> bool:
        if self.use_kernel != 'auto':
            return self.use_kernel == 'fused_token'
        l, d = inputs.shape[-2], inputs.shape[-1]
        return mixer_token.auto_route(
            l, self.FFBlock_0.Dense_0.kernel.shape[1], d, inputs.device)

    def forward(self, inputs):
        if self._token_kernel_route(inputs):
            ff = self.FFBlock_0
            tokens = mixer_token.token_mix_sublayer(
                inputs.to(self.dtype), self.LayerNorm_0.scale,
                self.LayerNorm_0.bias, ff.Dense_0.kernel, ff.Dense_0.bias,
                ff.Dense_1.kernel, ff.Dense_1.bias)
        else:
            # token mixing: transpose so the MLP contracts over the tokens,
            # then transpose back before the residual
            mixed = self.FFBlock_0(self.LayerNorm_0(inputs).transpose(-1, -2))
            tokens = inputs + mixed.transpose(-1, -2)
        return tokens + self.FFBlock_1(self.LayerNorm_1(tokens))


def set_use_kernel(model: nn.Module, use_kernel: Union[str, bool]) -> None:
    """Re-routes every block of a built Mixer (same weights)."""
    _check_use_kernel(use_kernel)
    for sub in model.modules():
        if isinstance(sub, MixerBlock):
            sub.use_kernel = use_kernel


class MLPMixer(nn.Module):
    """MLP-Mixer classifier over NHWC images of ``img_size``."""

    def __init__(self, num_classes: int, num_layers: int, embed_dim: int,
                 patch_shape: Tuple[int, int], img_size: int = 224,
                 tokens_expand_ratio: float = 0.5,
                 channels_expand_ratio: float = 4, dtype=torch.float32,
                 use_kernel: Union[str, bool] = 'auto',
                 scan_layers: bool = False,
                 quantized: Union[bool, str] = False):
        super().__init__()
        if quantized and quantized not in ('ff', 'all'):
            raise ValueError(
                f'MLPMixer quantized={quantized!r} is not supported: only '
                "'ff'/'all' (channel-mix FFs int8; token-mix GEMMs are too "
                'narrow to beat the quantize passes), as in the JAX package. '
                'Use --quantized ff for int8 serving.')
        if scan_layers:
            raise NotImplementedError(
                'scan_layers=True is not ported yet (the scan-stacked layout: '
                'ROADMAP.md Queue 1 item 1)')
        _check_use_kernel(use_kernel)
        self.dtype = dtype
        self.img_size = img_size
        num_tokens = (img_size // patch_shape[0]) * (img_size // patch_shape[1])
        self.PatchEmbedBlock_0 = PatchEmbedBlock(patch_shape, embed_dim,
                                                 use_bias=True, dtype=dtype)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f'MixerBlock_{i}', MixerBlock(
                num_tokens, embed_dim, tokens_expand_ratio,
                channels_expand_ratio, dtype, use_kernel, quantized))
        self.LayerNorm_0 = LayerNorm(embed_dim, dtype)
        self.Dense_0 = Dense(embed_dim, num_classes, dtype=dtype)

    def forward(self, inputs):
        x = self.PatchEmbedBlock_0(inputs)
        for i in range(self.num_layers):
            x = getattr(self, f'MixerBlock_{i}')(x)
        x = self.LayerNorm_0(x).mean(dim=1)
        return self.Dense_0(x)
