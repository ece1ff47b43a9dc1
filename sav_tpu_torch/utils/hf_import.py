"""HuggingFace-transformers ViT checkpoints into the port's ViT
(counterpart of ``sav_tpu/utils/hf_import.py``: the same tree, leaf for
leaf and bit for bit, and the same ``model.json`` spec).

The conversion is exact: per-tensor transposes and reshapes, plus one
fold.

- HF's conv patch projection ``[D, C, ph, pw]`` becomes the patchify
  Dense kernel ``[ph*pw*C, D]`` (the same linear map: the patch flatten
  order is the transpose ``(ph, pw, C, D)``).
- Its *bias* has no slot in the bias-free ``PatchEmbedBlock``; a
  per-channel constant added to every patch token is an additive offset
  of the learned position embedding, so it folds into
  ``pos_embed[:, 1:, :]`` exactly.
- q/k/v/out projection biases map onto ``ViT(attn_bias=True)``.
- torch ``Linear`` stores ``[out, in]``: every kernel is transposed, q/k/v
  reshaped to ``(D, H, d)`` and the out projection to ``(H, d, D)``,
  heads-major on both sides as HF's ``transpose_for_scores`` is.

HF's ``hidden_act='gelu'`` is the erf gelu, so the model kwargs carry
``activation_fn='gelu_exact'``. Its ``layer_norm_eps`` (1e-12) is not
carried: the model's LayerNorms keep flax's 1e-6, as the JAX import does.

``read_hf_dir`` reads a ``save_pretrained`` directory without
``transformers``: ``config.json`` and the weights (``model.safetensors``,
its sharded index, or ``pytorch_model.bin``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

from sav_tpu_torch.utils import safetensors

# transformers' ViTConfig defaults, for a config.json that leaves a field
# at its default out
VIT_CONFIG_DEFAULTS = {
    'hidden_size': 768, 'num_hidden_layers': 12, 'num_attention_heads': 12,
    'intermediate_size': 3072, 'hidden_act': 'gelu', 'patch_size': 16,
    'image_size': 224, 'num_channels': 3, 'qkv_bias': True,
    'layer_norm_eps': 1e-12,
}
_CONFIG_KEYS = ('hidden_size', 'num_hidden_layers', 'num_attention_heads',
                'intermediate_size', 'patch_size', 'hidden_act')


def _act_fn(hidden_act: str) -> str:
    """HF's activation name -> the spec table's (``ACTIVATIONS``)."""
    if hidden_act == 'gelu':                       # transformers: erf gelu
        return 'gelu_exact'
    if hidden_act in ('gelu_new', 'gelu_fast', 'gelu_pytorch_tanh'):
        return 'gelu'                              # tanh approximation
    raise ValueError(f'unsupported hidden_act {hidden_act!r} for ViT import')


def model_spec(model_kwargs: Dict[str, Any],
               scan_layers: bool = False) -> Dict[str, Any]:
    """JSON-serializable spec for ``create_model('<dir>/model.json')``,
    equal to the JAX package's for the same kwargs: ``activation_fn``
    becomes the ``activation`` key, ``patch_shape`` a list."""
    kw = dict(model_kwargs)
    kw['activation'] = kw.pop('activation_fn')
    kw['patch_shape'] = list(kw['patch_shape'])
    if scan_layers:
        kw['scan_layers'] = True
    return {'model': 'vit', 'kwargs': kw}


def read_hf_dir(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """``(state_dict, config)`` of a local HF checkpoint directory: the
    weights as f32 numpy arrays (as ``from_pretrained`` loads them), and
    ``config.json`` with ViTConfig's defaults for the fields it leaves out.

    A directory whose ``architectures`` do not name
    ``ViTForImageClassification`` reads as the headless trunk (its
    ``classifier.*`` and ``pooler.*`` tensors dropped), as the JAX import
    loads it through ``ViTModel(add_pooling_layer=False)``: a fresh head,
    not one of another task."""
    with open(os.path.join(path, 'config.json')) as f:
        config = {**VIT_CONFIG_DEFAULTS, **json.load(f)}
    for name, read in (('model.safetensors', safetensors.load_file),
                       ('model.safetensors.index.json',
                        safetensors.load_sharded),
                       ('pytorch_model.bin', safetensors.load_torch_bin)):
        if os.path.exists(os.path.join(path, name)):
            state = read(os.path.join(path, name))
            break
    else:
        raise FileNotFoundError(
            f'{path} holds no model.safetensors, model.safetensors.index.json '
            'or pytorch_model.bin')
    if 'ViTForImageClassification' not in (config.get('architectures') or []):
        state = {k: v for k, v in state.items()
                 if not k.removeprefix('vit.').startswith(('classifier.',
                                                           'pooler.'))}
    state = {k: v.astype(np.float32) if np.issubdtype(v.dtype, np.floating)
             else v for k, v in state.items()}
    return state, config


def convert_hf_vit(state_dict: Dict[str, np.ndarray], config: Any,
                   num_classes: int = 1000) -> Tuple[Dict[str, Any],
                                                     Dict[str, Any]]:
    """HF ViT weights -> (params, model_kwargs).

    Takes ``ViTForImageClassification`` checkpoints and headless
    ``ViTModel`` ones (whose tensor names carry no ``vit.`` prefix and
    which have no classifier): a missing classifier becomes a
    zero-initialised head of ``num_classes`` outputs, the fresh-head start
    of a fine-tune. A config with ``qkv_bias=False`` has no q/k/v biases,
    and raises ``KeyError`` naming the first, as the JAX converter does.

    Args:
      state_dict: tensor name -> numpy array.
      config: the HF config as a dict (``read_hf_dir``'s) or an object with
        the same attribute names.
      num_classes: head width when the checkpoint has no classifier
        (ignored otherwise: the checkpoint's head width wins).

    Returns:
      params: the per-layer flax params tree of ``models.vit.ViT``.
      model_kwargs: ViT constructor kwargs (num_classes, num_layers,
        num_heads, embed_dim, patch_shape, expand_ratio, attn_bias,
        activation_fn) of the HF architecture.
    """
    cfg = config if isinstance(config, dict) else {
        k: getattr(config, k) for k in _CONFIG_KEYS}
    dim = cfg['hidden_size']
    num_layers = cfg['num_hidden_layers']
    heads = cfg['num_attention_heads']
    head = dim // heads
    patch = cfg['patch_size']

    prefix = 'vit.' if any(k.startswith('vit.') for k in state_dict) else ''
    sd = {(k[len(prefix):] if k.startswith(prefix) else k): np.asarray(v)
          for k, v in state_dict.items()}

    def t(key):                       # torch Linear [out, in] -> [in, out]
        return sd[key].T

    proj = sd['embeddings.patch_embeddings.projection.weight']
    patch_kernel = proj.transpose(2, 3, 1, 0).reshape(-1, dim)
    pos = sd['embeddings.position_embeddings'].copy()
    # fold the conv bias into the patch slots of the position embedding
    pos[:, 1:, :] += sd['embeddings.patch_embeddings.projection.bias']

    encoder: Dict[str, Any] = {
        'AddAbsPosEmbed_0': {'pos_embed': pos},
        'LayerNorm_0': {'scale': sd['layernorm.weight'],
                        'bias': sd['layernorm.bias']},
    }
    for i in range(num_layers):
        p = f'encoder.layer.{i}.'
        encoder[f'EncoderBlock_{i}'] = {
            'LayerNorm_0': {'scale': sd[p + 'layernorm_before.weight'],
                            'bias': sd[p + 'layernorm_before.bias']},
            'SelfAttentionBlock_0': {
                **{ours: {
                    'kernel': t(p + f'attention.attention.{theirs}.weight'
                                ).reshape(dim, heads, head),
                    'bias': sd[p + f'attention.attention.{theirs}.bias'
                               ].reshape(heads, head)}
                   for ours, theirs in (('queries', 'query'),
                                        ('keys', 'key'),
                                        ('values', 'value'))},
                'DenseGeneral_0': {
                    'kernel': t(p + 'attention.output.dense.weight'
                                ).reshape(heads, head, dim),
                    'bias': sd[p + 'attention.output.dense.bias']},
            },
            'LayerNorm_1': {'scale': sd[p + 'layernorm_after.weight'],
                            'bias': sd[p + 'layernorm_after.bias']},
            'FFBlock_0': {
                'Dense_0': {'kernel': t(p + 'intermediate.dense.weight'),
                            'bias': sd[p + 'intermediate.dense.bias']},
                'Dense_1': {'kernel': t(p + 'output.dense.weight'),
                            'bias': sd[p + 'output.dense.bias']},
            },
        }

    if 'classifier.weight' in sd:
        head_params = {'kernel': t('classifier.weight'),
                       'bias': sd['classifier.bias']}
        num_classes = sd['classifier.weight'].shape[0]
    else:                                   # headless (ViTModel) checkpoint
        head_params = {'kernel': np.zeros((dim, num_classes), np.float32),
                       'bias': np.zeros((num_classes,), np.float32)}
    params: Dict[str, Any] = {
        'PatchEmbedBlock_0': {'Dense_0': {'kernel': patch_kernel}},
        'cls': sd['embeddings.cls_token'],
        'Encoder_0': encoder,
        'Dense_0': head_params,
    }
    model_kwargs = dict(
        num_classes=num_classes,
        num_layers=num_layers,
        num_heads=heads,
        embed_dim=dim,
        patch_shape=(patch, patch),
        expand_ratio=cfg['intermediate_size'] / dim,
        attn_bias=True,
        activation_fn=_act_fn(cfg['hidden_act']),
    )
    return params, model_kwargs
