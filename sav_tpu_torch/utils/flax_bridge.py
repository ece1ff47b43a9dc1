"""Flax parameter trees <-> torch state dicts.

The port's modules carry the flax names and layouts, so the bridge only
re-spells paths: the flax path ``Encoder_0/EncoderBlock_3/
SelfAttentionBlock_0/queries/kernel`` is the state-dict key
``Encoder_0.EncoderBlock_3.SelfAttentionBlock_0.queries.kernel``, with the
array unchanged (Dense kernels ``[in, out]``; q/k/v kernels ``[D, H, d]``,
the out kernel ``[H, d, D]``; ``pos_embed`` ``[1, L, D]``; ``cls``
``[1, 1, D]``). Covers the per-layer layout; the scan-stacked layout
(``sav_tpu/utils/stacking.py``) is refused.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


# the names of nn.scan-stacked block stacks (no _N suffix): ViT/CaiT's
# encoder and the Mixer's blocks (sav_tpu/models/mlp_mixer.py:148)
SCAN_NAMES = ('EncoderBlock', 'MixerBlock')


def _reject_scan_layout(path: str) -> None:
    for part in path.split('/'):
        if part in SCAN_NAMES:
            raise NotImplementedError(
                f'{path!r} is a scan-stacked (scan_layers=True) tree; only the '
                'per-layer layout is bridged so far (see ROADMAP.md, trainer '
                'slice)')


def flatten_tree(tree: Mapping, prefix: str = '') -> 'OrderedDict[str, np.ndarray]':
    """Nested dict -> ``{'a/b/c': array}`` in sorted key order."""
    flat = OrderedDict()
    for key in sorted(tree):
        value = tree[key]
        path = f'{prefix}/{key}' if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    """``{'a/b/c': array}`` -> nested dict."""
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split('/')
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def flax_to_torch(tree: Mapping) -> 'OrderedDict[str, torch.Tensor]':
    """A flax ``params`` tree (nested dict of arrays) -> torch state dict.

    A full variables dict ``{'params': ...}`` is accepted too. Arrays are
    copied, so the result owns its memory.
    """
    if set(tree) == {'params'}:
        tree = tree['params']
    state = OrderedDict()
    for path, array in flatten_tree(tree).items():
        _reject_scan_layout(path)
        state[path.replace('/', '.')] = torch.from_numpy(np.array(array))
    return state


def torch_to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """A torch state dict -> flax ``params`` tree of numpy arrays."""
    return unflatten_tree({key.replace('.', '/'): t.detach().cpu().numpy()
                           for key, t in state.items()})
