"""Attention layer modules (counterpart of ``sav_tpu/nn/attention.py``).

Parameter names and layouts follow the flax tree: ``queries``/``keys``/
``values`` hold ``kernel [in, heads, head_dim]`` and ``DenseGeneral_0`` the
merged output ``kernel [heads, head_dim, in]``. With ``talking_heads``
(CaiT) ``TalkingHeadsBlock_0`` and ``TalkingHeadsBlock_1`` hold the pre- and
post-softmax head mixes ``talking_heads_transform [H, H]``.
"""

from __future__ import annotations

import torch
from torch import nn

from sav_tpu_torch.nn.layers import lecun_normal_
from sav_tpu_torch.nn.posembed import apply_rotary_heads, sincos_frequencies
from sav_tpu_torch.ops import attention as attention_ops


class ProjectionParams(nn.Module):
    """A DenseGeneral kernel ``[*in_shape, *out_shape]`` with lecun-normal
    init over the flattened fans."""

    def __init__(self, shape, fan_in: int):
        super().__init__()
        self.fan_in = fan_in
        self.kernel = nn.Parameter(torch.empty(*shape))

    def init_params(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.fan_in, generator)


class TalkingHeadsBlock(nn.Module):
    """Learned head-mixing transform ``talking_heads_transform [H, H]``
    (orthogonal init, as flax's ``nn.initializers.orthogonal()``)."""

    def __init__(self, num_heads: int):
        super().__init__()
        self.talking_heads_transform = nn.Parameter(
            torch.empty(num_heads, num_heads))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.orthogonal_(self.talking_heads_transform, generator=generator)


class AttentionBlock(nn.Module):
    """Multi-head (cross-)attention: q/k/v projections, scaled-dot softmax
    (with talking heads: mixed across heads before and after it), merged
    output projection."""

    def __init__(self, in_ch: int, num_heads: int, use_bias: bool = False,
                 dtype=torch.float32, use_kernel='auto',
                 fused_qkv: bool = False, rotary: bool = False,
                 talking_heads: bool = False):
        super().__init__()
        if fused_qkv:
            raise NotImplementedError('fused_qkv is not ported yet (ROADMAP.md)')
        if use_bias:
            raise NotImplementedError(
                'attention projection biases (attn_bias) are not ported yet '
                '(ROADMAP.md)')
        if in_ch % num_heads:
            raise ValueError(f'in_ch {in_ch} is not divisible by {num_heads} heads')
        head_ch = in_ch // num_heads
        self.num_heads, self.head_ch = num_heads, head_ch
        self.dtype, self.use_kernel, self.rotary = dtype, use_kernel, rotary
        proj = (in_ch, num_heads, head_ch)
        self.queries = ProjectionParams(proj, in_ch)
        self.keys = ProjectionParams(proj, in_ch)
        self.values = ProjectionParams(proj, in_ch)
        self.DenseGeneral_0 = ProjectionParams((num_heads, head_ch, in_ch),
                                               num_heads * head_ch)
        self.talking_heads = talking_heads
        if talking_heads:
            self.TalkingHeadsBlock_0 = TalkingHeadsBlock(num_heads)
            self.TalkingHeadsBlock_1 = TalkingHeadsBlock(num_heads)

    def _project(self, x, params: ProjectionParams):
        return torch.einsum('...d,dhc->...hc', x.to(self.dtype),
                            params.kernel.to(self.dtype))

    def forward(self, inputs_q, inputs_kv):
        query = self._project(inputs_q, self.queries)
        key = self._project(inputs_kv, self.keys)
        value = self._project(inputs_kv, self.values)
        if self.rotary:
            query = apply_rotary_heads(query, sincos_frequencies(
                query.shape[-3], self.head_ch, device=query.device))
            key = apply_rotary_heads(key, sincos_frequencies(
                key.shape[-3], self.head_ch, device=key.device))
        pre = post = None
        if self.talking_heads:
            pre = self.TalkingHeadsBlock_0.talking_heads_transform
            post = self.TalkingHeadsBlock_1.talking_heads_transform
        x = attention_ops.multi_head_attention(
            query, key, value, pre_softmax_transform=pre,
            post_softmax_transform=post, use_kernel=self.use_kernel)
        # the f32 mixes promote x to f32 (as in flax); the projection runs
        # in the module's dtype
        return torch.einsum('...hc,hco->...o', x.to(self.dtype),
                            self.DenseGeneral_0.kernel.to(self.dtype))


class SelfAttentionBlock(AttentionBlock):
    """Self-attention: queries, keys and values from the same sequence."""

    def forward(self, inputs):
        return super().forward(inputs, inputs)
