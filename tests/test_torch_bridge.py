"""Torch port: flax tree <-> torch state dict bridge."""

import jax
import numpy as np
import pytest
import torch

from sav_tpu_torch.utils.flax_bridge import (flatten_tree, flax_to_torch,
                                             torch_to_flax, unflatten_tree)
from torch_parity import jax_vit, torch_vit

IMG = 32


@pytest.fixture(scope='module')
def tree():
    return jax_vit(IMG)[1]


def test_round_trip_is_exact(tree):
    state = flax_to_torch(tree)
    back = torch_to_flax(state)
    flat_a, flat_b = flatten_tree(tree), flatten_tree(back)
    assert list(flat_a) == list(flat_b)
    for path, a in flat_a.items():
        assert flat_b[path].dtype == a.dtype
        np.testing.assert_array_equal(flat_b[path], a, err_msg=path)


def test_keys_follow_flax_paths(tree):
    state = flax_to_torch({'params': tree})
    assert ('Encoder_0.EncoderBlock_1.SelfAttentionBlock_0.queries.kernel'
            in state)
    assert tuple(state['Encoder_0.EncoderBlock_0.SelfAttentionBlock_0.'
                       'DenseGeneral_0.kernel'].shape) == (2, 64, 128)
    assert tuple(state['Encoder_0.AddAbsPosEmbed_0.pos_embed'].shape) == \
        (1, (IMG // 16) ** 2 + 1, 128)


def test_port_model_loads_and_exports_the_tree(tree):
    model = torch_vit(tree, IMG)
    exported = flatten_tree(torch_to_flax(model.state_dict()))
    for path, a in flatten_tree(tree).items():
        np.testing.assert_array_equal(exported[path], a, err_msg=path)


def test_unflatten_inverts_flatten(tree):
    flat = flatten_tree(tree)
    again = flatten_tree(unflatten_tree(flat))
    assert list(again) == list(flat)


def test_scan_stacked_tree_is_refused():
    stacked = {'Encoder_0': {'EncoderBlock': {'LayerNorm_0': {
        'scale': np.ones((2, 4), np.float32)}}}}
    with pytest.raises(NotImplementedError, match='scan-stacked'):
        flax_to_torch(stacked)


def test_jax_arrays_are_copied(tree):
    leaf = jax.numpy.asarray(tree['cls'])
    state = flax_to_torch({'cls': leaf})
    state['cls'].add_(1.0)
    np.testing.assert_array_equal(np.asarray(leaf), tree['cls'])
    assert isinstance(state['cls'], torch.Tensor)
