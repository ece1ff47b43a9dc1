"""timm (pytorch-image-models) VisionTransformer state dicts into the
port's ViT (counterpart of ``sav_tpu/utils/timm_import.py``: the same
tree, leaf for leaf and bit for bit).

timm's ViT state dict differs from HF's in two ways that matter here:

- q/k/v live fused in one ``blocks.{i}.attn.qkv.weight`` ``[3*D, D]``
  (rows q, k, v; heads-major within each): split, then the torch
  ``[out, in]`` transpose and the ``(D, H, d)`` reshape.
- it carries no config: the head count is not recoverable from a fused
  qkv, so callers pass ``num_heads`` (default ``D // 64``, the ratio every
  standard ViT and DeiT uses).

As in the other importers, the conv patch projection flattens row-major
onto the patchify Dense kernel, its bias folds exactly into
``pos_embed[:, 1:, :]``, and the result is a ``ViT(attn_bias=True)`` tree.
timm's ``nn.GELU`` is the erf gelu (``activation_fn='gelu_exact'``); its
LayerNorms use eps 1e-6, flax's. A ``module.`` (DDP) prefix is stripped.
Distilled DeiT checkpoints (``dist_token``) are refused: the two
prefix-token architecture has no counterpart in the zoo.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np


def convert_timm_vit(state_dict: Mapping[str, Any],
                     num_heads: Optional[int] = None,
                     num_classes: int = 1000) -> Tuple[Dict[str, Any],
                                                       Dict[str, Any]]:
    """timm VisionTransformer state dict -> (params, model_kwargs).

    Args:
      state_dict: tensor name -> numpy array (``np.load``-style mappings
        work as they are).
      num_heads: head count; defaults to ``embed_dim // 64``.
      num_classes: head width when the checkpoint has no classifier
        (ignored otherwise).

    Returns:
      params: the per-layer flax params tree of ``ViT(attn_bias=True)``.
      model_kwargs: ViT constructor kwargs of the matching architecture.
    """
    sd = {(k[len('module.'):] if k.startswith('module.') else k):
          np.asarray(v) for k, v in state_dict.items()}
    if 'dist_token' in sd:
        raise ValueError(
            'distilled DeiT checkpoint (dist_token present): the two-'
            'prefix-token architecture is not in this model zoo; import '
            'the non-distilled variant instead')
    missing = [k for k in ('cls_token', 'pos_embed',
                           'patch_embed.proj.weight', 'norm.weight')
               if k not in sd]
    if missing:
        raise ValueError('not a timm VisionTransformer state dict; '
                         'missing keys: ' + ', '.join(missing))

    proj = sd['patch_embed.proj.weight']            # [D, C, ph, pw]
    dim, _, ph, pw = proj.shape
    heads = num_heads or dim // 64
    if dim % heads:
        raise ValueError(f'num_heads={heads} does not divide '
                         f'embed_dim={dim}')
    head = dim // heads
    patch_kernel = proj.transpose(2, 3, 1, 0).reshape(-1, dim)
    pos = sd['pos_embed'].copy()
    pos[:, 1:, :] += sd['patch_embed.proj.bias']

    num_layers = 1 + max(int(k.split('.')[1]) for k in sd
                         if k.startswith('blocks.'))
    encoder: Dict[str, Any] = {
        'AddAbsPosEmbed_0': {'pos_embed': pos},
        'LayerNorm_0': {'scale': sd['norm.weight'],
                        'bias': sd['norm.bias']},
    }
    for i in range(num_layers):
        p = f'blocks.{i}.'
        qkv_w = sd[p + 'attn.qkv.weight']           # [3D, D], rows q|k|v
        qkv_b = sd[p + 'attn.qkv.bias']
        third = {}
        for j, name in enumerate(('queries', 'keys', 'values')):
            third[name] = {
                'kernel': qkv_w[j * dim:(j + 1) * dim].T.reshape(
                    dim, heads, head),
                'bias': qkv_b[j * dim:(j + 1) * dim].reshape(heads, head)}
        encoder[f'EncoderBlock_{i}'] = {
            'LayerNorm_0': {'scale': sd[p + 'norm1.weight'],
                            'bias': sd[p + 'norm1.bias']},
            'SelfAttentionBlock_0': {
                **third,
                'DenseGeneral_0': {
                    'kernel': sd[p + 'attn.proj.weight'].T.reshape(
                        heads, head, dim),
                    'bias': sd[p + 'attn.proj.bias']},
            },
            'LayerNorm_1': {'scale': sd[p + 'norm2.weight'],
                            'bias': sd[p + 'norm2.bias']},
            'FFBlock_0': {
                'Dense_0': {'kernel': sd[p + 'mlp.fc1.weight'].T,
                            'bias': sd[p + 'mlp.fc1.bias']},
                'Dense_1': {'kernel': sd[p + 'mlp.fc2.weight'].T,
                            'bias': sd[p + 'mlp.fc2.bias']},
            },
        }

    if 'head.weight' in sd:
        head_params = {'kernel': sd['head.weight'].T,
                       'bias': sd['head.bias']}
        num_classes = sd['head.weight'].shape[0]
    else:                                      # trunk-only checkpoint
        head_params = {'kernel': np.zeros((dim, num_classes), np.float32),
                       'bias': np.zeros((num_classes,), np.float32)}
    params: Dict[str, Any] = {
        'PatchEmbedBlock_0': {'Dense_0': {'kernel': patch_kernel}},
        'cls': sd['cls_token'],
        'Encoder_0': encoder,
        'Dense_0': head_params,
    }
    model_kwargs = dict(
        num_classes=num_classes,
        num_layers=num_layers,
        num_heads=heads,
        embed_dim=dim,
        patch_shape=(ph, pw),
        expand_ratio=sd['blocks.0.mlp.fc1.weight'].shape[0] / dim,
        attn_bias=True,
        activation_fn='gelu_exact',
    )
    return params, model_kwargs


def read_timm_file(path: str) -> Dict[str, np.ndarray]:
    """A timm ``.pth``/``.bin`` as a state dict of numpy arrays, out of a
    ``model``/``state_dict``/``model_state_dict`` envelope where it has
    one (torch-hub DeiT checkpoints do); ``torch.load`` with
    ``weights_only=True``, bf16 widened to f32."""
    import torch
    blob = torch.load(path, map_location='cpu', weights_only=True)
    for envelope in ('model', 'state_dict', 'model_state_dict'):
        if envelope in blob and isinstance(blob[envelope], dict):
            blob = blob[envelope]
            break
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in blob.items() if isinstance(v, torch.Tensor)}
