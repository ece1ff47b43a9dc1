"""Functional multi-head attention core (counterpart of
``sav_tpu/ops/attention.py``).

Queries are pre-scaled by ``1/sqrt(head_dim)``; logits =
einsum('...qhd,...khd->...hqk'); optional pre-softmax head mixing (talking
heads), softmax, optional post-softmax mixing, additive bias, then the
value product back to '...qhd'. The flash port plugs in behind
``use_kernel``: 'kernel' is K4's forward with the K2/K3 backward,
'hybrid' the plain forward with the same backward. Attention dropout
waits for a later slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from sav_tpu_torch.ops import flash_attention


def head_mix(weights: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Output head i is ``sum_h transform[h, i] * weights[:, h]``, in the
    promoted dtype of the two (f32 for bf16 logits and an f32 transform,
    as jnp.einsum promotes)."""
    dt = torch.promote_types(weights.dtype, transform.dtype)
    return torch.einsum('hi,bh...->bi...', transform.to(dt), weights.to(dt))


def attention_weights(query, key, *, bias=None, pre_softmax_transform=None,
                      post_softmax_transform=None) -> torch.Tensor:
    """Normalized weights ``[..., heads, q_len, kv_len]`` (query pre-scaled)."""
    weights = torch.einsum('...qhd,...khd->...hqk', query, key)
    if bias is not None:
        weights = weights + bias
    if pre_softmax_transform is not None:
        weights = head_mix(weights, pre_softmax_transform)
    weights = torch.softmax(weights, dim=-1)
    if post_softmax_transform is not None:
        weights = head_mix(weights, post_softmax_transform)
    return weights


def dispatch_mode(query, key, *, bias=None, pre_softmax_transform=None,
                  post_softmax_transform=None):
    """'kernel' or None for ``use_kernel='auto'``: the K4 port wherever it
    takes the shape on the card (logits never reach device memory); the
    plain path off the card."""
    if query.device.type != 'cuda':
        return None
    if flash_attention.shape_supported(
            query, key, bias=bias,
            pre_softmax_transform=pre_softmax_transform,
            post_softmax_transform=post_softmax_transform):
        return 'kernel'
    return None


def multi_head_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    pre_softmax_transform: Optional[torch.Tensor] = None,
    post_softmax_transform: Optional[torch.Tensor] = None,
    use_kernel='auto',
    core: str = 'kernel',
) -> torch.Tensor:
    """Scaled-dot-product multi-head attention on ``[..., len, heads, d]``
    (query unscaled). ``use_kernel``: 'auto' (and any other string) picks
    the flash port where it applies, True/'kernel' forces it, 'hybrid'
    forces the plain forward with the kernel backward, False forces the
    plain path. ``core`` is ``flash_attention.mha``'s where the flash port
    runs ('plain': its twins at the same autograd boundary)."""
    head_dim = query.shape[-1]
    # sqrt(d) rounded to the query dtype, as the JAX package divides
    sqrt_d = torch.tensor(float(head_dim)).sqrt().to(query.dtype).item()
    query = query / sqrt_d

    if use_kernel is not False:
        if use_kernel in (True, 'kernel', 'hybrid'):
            mode = 'kernel' if use_kernel is True else use_kernel
        else:
            # 'auto', and every other mode (a model-level one such as
            # 'fused_ff' or 'fused_layer'), dispatches as 'auto', as in the
            # JAX package; the models refuse modes that are not ported
            mode = dispatch_mode(
                query, key, bias=bias,
                pre_softmax_transform=pre_softmax_transform,
                post_softmax_transform=post_softmax_transform)
        if mode is not None and (bias is not None
                                 or pre_softmax_transform is not None
                                 or post_softmax_transform is not None):
            raise ValueError('the flash kernels take no bias or head mixing')
        if mode == 'kernel':
            return flash_attention.mha(query, key, value, core)
        if mode == 'hybrid':
            return flash_attention.mha_hybrid(query, key, value)

    if (query.shape[-3] == 1 and bias is None
            and pre_softmax_transform is None
            and post_softmax_transform is None):
        # 1-query class attention (CaiT/CeiT heads): two [..., H, L]-shaped
        # contractions around the softmax
        q = query[..., 0, :, :]
        logits = torch.einsum('...hd,...khd->...hk', q, key)
        p = torch.softmax(logits, dim=-1).to(value.dtype)
        out = torch.einsum('...hk,...khd->...hd', p, value)
        return out[..., None, :, :]

    weights = attention_weights(
        query, key, bias=bias,
        pre_softmax_transform=pre_softmax_transform,
        post_softmax_transform=post_softmax_transform)
    dt = torch.promote_types(weights.dtype, value.dtype)
    return torch.einsum('...hqk,...khd->...qhd', weights.to(dt), value.to(dt))
