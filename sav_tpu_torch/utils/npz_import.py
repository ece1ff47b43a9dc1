"""google-research ``vision_transformer`` (AugReg) npz ViT checkpoints into
the port's ViT (counterpart of ``sav_tpu/utils/npz_import.py``: the same
tree, leaf for leaf and bit for bit).

The original ViT and "How to train your ViT" releases ship flat ``.npz``
files keyed like ``Transformer/encoderblock_0/
MultiHeadDotProductAttention_1/query/kernel``. Their tensors are
flax-native, so the conversion is mostly re-nesting:

- q/k/v kernels are already ``[D, H, d]`` and the out projection
  ``[H, d, D]``: no transposes.
- the conv patch embedding ``[ph, pw, C, D]`` reshapes row-major to the
  patchify Dense kernel ``[ph*pw*C, D]``; its bias folds into
  ``pos_embed[:, 1:, :]``.
- their ``LayerNorm_0``/``LayerNorm_2`` are ``LayerNorm_0``/
  ``LayerNorm_1``; eps 1e-6 on both sides.
- their activation is flax's tanh gelu, the port's default.

in21k pretrains carry a ``pre_logits`` bottleneck (Dense D -> D + tanh)
before the 21k head, which the ViT has not; the transfer recipe discards it
with the head, so such checkpoints import as trunks with a zero
``num_classes`` head.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np


def convert_vit_npz(npz: Mapping[str, np.ndarray],
                    num_classes: int = 1000) -> Tuple[Dict[str, Any],
                                                      Dict[str, Any]]:
    """AugReg/vision_transformer npz -> (params, model_kwargs).

    Args:
      npz: flat ``a/b/c`` tensor names -> arrays (an ``np.load`` handle
        works as it is).
      num_classes: head width where the checkpoint's own head is unusable
        (``pre_logits`` present); ignored otherwise.

    Returns:
      params: the per-layer flax params tree of ``ViT(attn_bias=True)``.
      model_kwargs: ViT constructor kwargs of the architecture.
    """
    sd = {k: np.asarray(v) for k, v in npz.items()}
    missing = [k for k in ('embedding/kernel', 'cls', 'head/kernel',
                           'Transformer/posembed_input/pos_embedding',
                           'Transformer/encoder_norm/scale')
               if k not in sd]
    if missing:
        raise ValueError(
            'not a vision_transformer ViT npz checkpoint; missing keys: '
            + ', '.join(missing))

    proj = sd['embedding/kernel']                     # [ph, pw, C, D]
    ph, pw, _, dim = proj.shape
    patch_kernel = proj.reshape(-1, dim)
    pos = sd['Transformer/posembed_input/pos_embedding'].copy()
    pos[:, 1:, :] += sd['embedding/bias']

    blocks = sorted(
        {int(k.split('/')[1].rsplit('_', 1)[1])
         for k in sd if k.startswith('Transformer/encoderblock_')})
    if blocks != list(range(len(blocks))):
        raise ValueError(f'non-contiguous encoder blocks in npz: {blocks}')
    q = sd['Transformer/encoderblock_0/'
           'MultiHeadDotProductAttention_1/query/kernel']
    heads, head = q.shape[1], q.shape[2]
    if heads * head != dim:
        raise ValueError(f'{heads} heads of {head} do not make the '
                         f'embedding width {dim}')

    def ln(key):
        return {'scale': sd[key + '/scale'], 'bias': sd[key + '/bias']}

    encoder: Dict[str, Any] = {
        'AddAbsPosEmbed_0': {'pos_embed': pos},
        'LayerNorm_0': ln('Transformer/encoder_norm'),
    }
    for i in blocks:
        p = f'Transformer/encoderblock_{i}/'
        a = p + 'MultiHeadDotProductAttention_1/'
        encoder[f'EncoderBlock_{i}'] = {
            'LayerNorm_0': ln(p + 'LayerNorm_0'),
            'SelfAttentionBlock_0': {
                'queries': {'kernel': sd[a + 'query/kernel'],
                            'bias': sd[a + 'query/bias']},
                'keys': {'kernel': sd[a + 'key/kernel'],
                         'bias': sd[a + 'key/bias']},
                'values': {'kernel': sd[a + 'value/kernel'],
                           'bias': sd[a + 'value/bias']},
                'DenseGeneral_0': {'kernel': sd[a + 'out/kernel'],
                                   'bias': sd[a + 'out/bias']},
            },
            'LayerNorm_1': ln(p + 'LayerNorm_2'),
            'FFBlock_0': {
                'Dense_0': {'kernel': sd[p + 'MlpBlock_3/Dense_0/kernel'],
                            'bias': sd[p + 'MlpBlock_3/Dense_0/bias']},
                'Dense_1': {'kernel': sd[p + 'MlpBlock_3/Dense_1/kernel'],
                            'bias': sd[p + 'MlpBlock_3/Dense_1/bias']},
            },
        }

    if 'pre_logits/kernel' in sd:       # in21k pretrain: discard bottleneck
        head_params = {'kernel': np.zeros((dim, num_classes), np.float32),
                       'bias': np.zeros((num_classes,), np.float32)}
    else:
        head_params = {'kernel': sd['head/kernel'],
                       'bias': sd['head/bias']}
        num_classes = sd['head/kernel'].shape[1]
    params: Dict[str, Any] = {
        'PatchEmbedBlock_0': {'Dense_0': {'kernel': patch_kernel}},
        'cls': sd['cls'],
        'Encoder_0': encoder,
        'Dense_0': head_params,
    }
    hidden = sd['Transformer/encoderblock_0/MlpBlock_3/Dense_0/kernel'
                ].shape[1]
    model_kwargs = dict(
        num_classes=num_classes,
        num_layers=len(blocks),
        num_heads=heads,
        embed_dim=dim,
        patch_shape=(ph, pw),
        expand_ratio=hidden / dim,
        attn_bias=True,
        activation_fn='gelu',               # their nn.gelu default (tanh)
    )
    return params, model_kwargs
