"""Attention layer modules (counterpart of ``sav_tpu/nn/attention.py``).

Parameter names and layouts follow the flax tree: ``queries``/``keys``/
``values`` hold ``kernel [in, heads, head_dim]`` and ``DenseGeneral_0`` the
merged output ``kernel [heads, head_dim, in]``; with ``use_bias`` also
``bias [heads, head_dim]`` and ``bias [in]``, zero-initialised as flax
does. With ``talking_heads`` (CaiT) ``TalkingHeadsBlock_0`` and
``TalkingHeadsBlock_1`` hold the pre- and post-softmax head mixes
``talking_heads_transform [H, H]``.
"""

from __future__ import annotations

import torch
from torch import nn

from sav_tpu_torch.nn.layers import lecun_normal_
from sav_tpu_torch.nn.posembed import apply_rotary_heads, sincos_frequencies
from sav_tpu_torch.ops import attention as attention_ops


class ProjectionParams(nn.Module):
    """A DenseGeneral kernel ``[*in_shape, *out_shape]`` with lecun-normal
    init over the flattened fans, and with ``bias_shape`` (the output
    shape) a zero-initialised ``bias``."""

    def __init__(self, shape, fan_in: int, bias_shape=None):
        super().__init__()
        self.fan_in = fan_in
        self.kernel = nn.Parameter(torch.empty(*shape))
        self.bias = (nn.Parameter(torch.empty(*bias_shape))
                     if bias_shape is not None else None)

    def init_params(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.fan_in, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` plus the bias cast to ``y``'s dtype (flax's DenseGeneral
        adds it in the module's dtype)."""
        return y if self.bias is None else y + self.bias.to(y.dtype)


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
    output projection.

    ``use_bias`` adds the four projections' biases (the trees of imported
    HF, timm and AugReg checkpoints carry them). ``fused_qkv`` issues the
    three ``[D, H*d]`` projections as one ``[D, 3*H*d]`` product (two for
    cross-attention: q alone, k and v together) on the same three
    parameter leaves, so checkpoints do not change; the product is a
    library matmul, as XLA computes it. ``core`` ('kernel' or 'plain',
    ``models.vit.set_attention_core``) puts the flash route on its twins
    at the same autograd boundary (the card's gradient reference); it is
    not a ``use_kernel`` mode."""

    def __init__(self, in_ch: int, num_heads: int, use_bias: bool = False,
                 dtype=torch.float32, use_kernel='auto',
                 fused_qkv: bool = False, rotary: bool = False,
                 talking_heads: bool = False):
        super().__init__()
        if in_ch % num_heads:
            raise ValueError(f'in_ch {in_ch} is not divisible by {num_heads} heads')
        head_ch = in_ch // num_heads
        self.num_heads, self.head_ch = num_heads, head_ch
        self.dtype, self.use_kernel, self.rotary = dtype, use_kernel, rotary
        self.use_bias, self.fused_qkv = use_bias, fused_qkv
        self.core = 'kernel'
        proj = (in_ch, num_heads, head_ch)
        heads_bias = (num_heads, head_ch) if use_bias else None
        self.queries = ProjectionParams(proj, in_ch, heads_bias)
        self.keys = ProjectionParams(proj, in_ch, heads_bias)
        self.values = ProjectionParams(proj, in_ch, heads_bias)
        self.DenseGeneral_0 = ProjectionParams(
            (num_heads, head_ch, in_ch), num_heads * head_ch,
            (in_ch,) if use_bias else None)
        self.talking_heads = talking_heads
        if talking_heads:
            self.TalkingHeadsBlock_0 = TalkingHeadsBlock(num_heads)
            self.TalkingHeadsBlock_1 = TalkingHeadsBlock(num_heads)

    def _project(self, x, params: ProjectionParams):
        return params.add_bias(torch.einsum(
            '...d,dhc->...hc', x.to(self.dtype), params.kernel.to(self.dtype)))

    def _project_wide(self, x, blocks):
        """``blocks``' projections of ``x`` as one product with their
        kernels side by side, split back into ``[..., H, d]`` each."""
        wide = torch.cat([p.kernel.reshape(p.kernel.shape[0], -1)
                          for p in blocks], dim=-1)
        out = x.to(self.dtype) @ wide.to(self.dtype)
        return [p.add_bias(o.reshape(*o.shape[:-1], self.num_heads,
                                     self.head_ch))
                for p, o in zip(blocks, out.chunk(len(blocks), dim=-1))]

    def _projections(self, inputs_q, inputs_kv):
        if not self.fused_qkv:
            return (self._project(inputs_q, self.queries),
                    self._project(inputs_kv, self.keys),
                    self._project(inputs_kv, self.values))
        if inputs_q is inputs_kv:
            return self._project_wide(inputs_q, (self.queries, self.keys,
                                                 self.values))
        (query,) = self._project_wide(inputs_q, (self.queries,))
        key, value = self._project_wide(inputs_kv, (self.keys, self.values))
        return query, key, value

    def forward(self, inputs_q, inputs_kv):
        query, key, value = self._projections(inputs_q, inputs_kv)
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
            post_softmax_transform=post, use_kernel=self.use_kernel,
            core=self.core)
        # the f32 mixes promote x to f32 (as in flax); the projection runs
        # in the module's dtype
        return self.DenseGeneral_0.add_bias(torch.einsum(
            '...hc,hco->...o', x.to(self.dtype),
            self.DenseGeneral_0.kernel.to(self.dtype)))


class SelfAttentionBlock(AttentionBlock):
    """Self-attention: queries, keys and values from the same sequence."""

    def forward(self, inputs):
        return super().forward(inputs, inputs)
