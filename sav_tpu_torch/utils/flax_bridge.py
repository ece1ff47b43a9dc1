"""Flax parameter trees <-> torch state dicts.

The port's modules carry the flax names and layouts, so the bridge only
re-spells paths: the flax path ``Encoder_0/EncoderBlock_3/
SelfAttentionBlock_0/queries/kernel`` is the state-dict key
``Encoder_0.EncoderBlock_3.SelfAttentionBlock_0.queries.kernel``, with the
array unchanged (Dense kernels ``[in, out]``; q/k/v kernels ``[D, H, d]``,
the out kernel ``[H, d, D]``; ``pos_embed`` ``[1, L, D]``; ``cls``
``[1, 1, D]``; conv kernels HWIO). The ``batch_stats`` collection (the
BatchNorms' running ``mean`` and ``var``) maps to the modules' buffers of
the same path, beside their ``scale`` and ``bias`` parameters (BoTNet's,
CeiT's and CvT's). Trees keyed by parameter name, the EMA of the
parameters and the Adam moments ``mu`` and ``nu``, take the parameters'
flax paths, as optax's and the JAX TrainState's do. Covers the per-layer
layout; the scan-stacked layout (``sav_tpu/utils/stacking.py``) is
refused.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


# the names of nn.scan-stacked block stacks (no _N suffix): ViT/CaiT's
# encoder, the Mixer's blocks (sav_tpu/models/mlp_mixer.py:148) and CvT's
# stage blocks past the first (sav_tpu/models/cvt.py:171-181)
SCAN_NAMES = ('EncoderBlock', 'MixerBlock', 'StageBlock')


def _reject_scan_layout(path: str) -> None:
    for part in path.split('/'):
        if part in SCAN_NAMES:
            raise NotImplementedError(
                f'{path!r} is a scan-stacked (scan_layers=True) tree; only the '
                'per-layer layout is bridged so far (ROADMAP.md Queue 1 item '
                '1)')


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


COLLECTIONS = ('params', 'batch_stats')


def flax_to_torch(tree: Mapping) -> 'OrderedDict[str, torch.Tensor]':
    """A flax ``params`` tree (nested dict of arrays) -> torch state dict.

    A full variables dict, ``{'params': ...}`` or ``{'params': ...,
    'batch_stats': ...}``, is accepted too: the two collections merge into
    one state dict (their leaves, ``kernel``/``scale``/``bias`` against
    ``mean``/``var``, never share a path). Arrays are copied, so the result
    owns its memory.
    """
    trees = ([tree[c] for c in COLLECTIONS if c in tree]
             if 'params' in tree and set(tree) <= set(COLLECTIONS) else [tree])
    state = OrderedDict()
    for part in trees:
        for path, array in flatten_tree(part).items():
            _reject_scan_layout(path)
            key = path.replace('/', '.')
            if key in state:
                raise ValueError(f'{path!r} is both a parameter and a '
                                 'running statistic')
            state[key] = torch.from_numpy(np.array(array))
    return state


def host_array(tensor: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``tensor`` that later in-place updates of the
    tensor do not reach; bf16 (which numpy lacks) widened to f32, exactly.
    A ``meta`` tensor (shapes only) gives a zero-stride f32 array of its
    shape, which holds no memory."""
    if tensor.is_meta:
        return np.broadcast_to(np.zeros((), np.float32), tuple(tensor.shape))
    tensor = tensor.detach()
    if tensor.dtype == torch.bfloat16:
        tensor = tensor.float()
    return tensor.to('cpu', copy=True).numpy()


def torch_to_flax(state: Mapping[str, torch.Tensor], buffers=()) -> dict:
    """A torch state dict (or any ``{torch name: tensor}``, such as the
    EMA or an Adam moment keyed by parameter name) -> flax tree of numpy
    arrays (``host_array`` copies).

    With ``buffers`` (the state's keys that are running statistics, e.g.
    ``variables_of``'s ``model.named_buffers()``) non-empty, the result is
    the variables dict ``{'params': ..., 'batch_stats': ...}`` with those
    keys split off into ``batch_stats``."""
    to_tree = lambda keys: unflatten_tree(
        {key.replace('.', '/'): host_array(state[key]) for key in keys})
    buffers = set(buffers)
    if not buffers:
        return to_tree(state)
    return {'params': to_tree(k for k in state if k not in buffers),
            'batch_stats': to_tree(k for k in state if k in buffers)}


def variables_of(model: torch.nn.Module) -> dict:
    """The flax variables of a port model: ``{'params': ...}``, plus
    ``'batch_stats'`` where it has running statistics (BatchNorm)."""
    buffers = [name for name, _ in model.named_buffers()]
    variables = torch_to_flax(model.state_dict(), buffers)
    return variables if buffers else {'params': variables}
