"""Attention layer modules (counterpart of ``sav_tpu/nn/attention.py``).

Parameter names and layouts follow the flax tree: ``queries``/``keys``/
``values`` hold ``kernel [in, heads, head_dim]`` and ``DenseGeneral_0`` the
merged output ``kernel [heads, head_dim, in]``. Talking heads (CaiT) wait
for the CaiT slice.
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


class AttentionBlock(nn.Module):
    """Multi-head (cross-)attention: q/k/v projections, scaled-dot softmax,
    merged output projection."""

    def __init__(self, in_ch: int, num_heads: int, use_bias: bool = False,
                 dtype=torch.float32, use_kernel='auto',
                 fused_qkv: bool = False, rotary: bool = False):
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
        x = attention_ops.multi_head_attention(query, key, value,
                                               use_kernel=self.use_kernel)
        return torch.einsum('...hc,hco->...o', x,
                            self.DenseGeneral_0.kernel.to(self.dtype))


class SelfAttentionBlock(AttentionBlock):
    """Self-attention: queries, keys and values from the same sequence."""

    def forward(self, inputs):
        return super().forward(inputs, inputs)
